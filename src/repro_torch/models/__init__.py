"""LM-architecture substrate of the port (counterpart of ``repro/models``):
the layer library, the xLSTM mixers and the dense/vlm/xlstm assembly.  The
moe, hybrid and encdec families wait for their slices (ROADMAP)."""
from . import layers, transformer, xlstm
from .transformer import (DistCtx, decode_step, forward, init_cache,
                          init_params, prefill)

__all__ = ["layers", "transformer", "xlstm", "DistCtx", "decode_step",
           "forward", "init_cache", "init_params", "prefill"]
