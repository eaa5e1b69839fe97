"""whisper-base — encoder-decoder; conv/mel frontend is a STUB (input_specs
provides precomputed frame embeddings, n_frames=1500).
[arXiv:2212.04356; unverified] 6L(+6 enc) d_model=512 8H d_ff=2048
vocab=51865; GELU MLP, LayerNorm, sinusoidal positions.

vocab 51865 is not divisible by 16 — padded embedding rows (DESIGN.md).
The 32k decode cell is mechanical (real Whisper decodes ≤448 tokens)."""
import dataclasses
from .base import ModelConfig

N_FRAMES = 1500

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab=51865, rope_theta=0.0, mlp_type="gelu",
    norm="ln", tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=96, vocab=128)
