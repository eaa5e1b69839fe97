"""starcoder2-15b — dense GQA transformer (GELU MLP, LayerNorm, RoPE).
[arXiv:2402.19173; hf] 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152, rope_theta=1e5, mlp_type="gelu", norm="ln",
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=128)
