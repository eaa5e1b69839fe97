"""qwen3-32b — dense GQA transformer with per-head qk RMSNorm.
[hf:Qwen/Qwen3-8B (family); hf] 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936; qk_norm."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936, rope_theta=1e6, qk_norm=True,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=128)
