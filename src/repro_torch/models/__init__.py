"""LM-architecture substrate of the port (counterpart of ``repro/models``):
the layer library, the MoE, Mamba2 (SSD) and xLSTM mixers, the
dense/vlm/moe/hybrid/xlstm assembly (``transformer``) and whisper's
encoder-decoder (``encdec``)."""
from . import encdec, layers, moe, ssm, transformer, xlstm
from .transformer import (DistCtx, decode_step, forward, init_cache,
                          init_params, prefill)

__all__ = ["encdec", "layers", "moe", "ssm", "transformer", "xlstm",
           "DistCtx", "decode_step", "forward", "init_cache",
           "init_params", "prefill"]
