"""Distribution for the port: a virtual ring of shards on one card."""
from .ring import VirtualRing, resolve_device

__all__ = ["VirtualRing", "resolve_device"]
