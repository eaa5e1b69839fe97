"""Tracing and metrics for the port (copies of the reference's leaf
modules ``repro/obs/tracer.py`` and ``repro/obs/metrics.py``)."""
from .tracer import NULL_TRACER, Tracer, merge_traces
from .metrics import MetricsRegistry

__all__ = ["Tracer", "NULL_TRACER", "MetricsRegistry", "merge_traces"]
