"""LM-architecture substrate of the port (counterpart of ``repro/models``):
the layer library and the dense/vlm assembly.  The moe, hybrid, xlstm and
encdec families wait for their slices (ROADMAP)."""
from . import layers, transformer
from .transformer import (DistCtx, decode_step, forward, init_cache,
                          init_params, prefill)

__all__ = ["layers", "transformer", "DistCtx", "decode_step", "forward",
           "init_cache", "init_params", "prefill"]
