"""xlstm-125m — alternating mLSTM/sLSTM blocks.
[arXiv:2405.04517; unverified] 12L d_model=768 4H d_ff=0 (blocks carry their
own projections) vocab=50304."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="xlstm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab=50304, rope_theta=0.0, xlstm_pattern=("m", "s"),
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        vocab=128, ssm_chunk=8)
