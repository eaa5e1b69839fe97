"""LM-architecture substrate of the port (counterpart of ``repro/models``):
the layer library, the MoE, Mamba2 (SSD) and xLSTM mixers and the
dense/vlm/moe/hybrid/xlstm assembly.  The encdec family waits for its
slice (ROADMAP item 10.5)."""
from . import layers, moe, ssm, transformer, xlstm
from .transformer import (DistCtx, decode_step, forward, init_cache,
                          init_params, prefill)

__all__ = ["layers", "moe", "ssm", "transformer", "xlstm", "DistCtx",
           "decode_step", "forward", "init_cache", "init_params", "prefill"]
