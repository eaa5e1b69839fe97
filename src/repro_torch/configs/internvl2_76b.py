"""internvl2-76b — VLM: InternViT frontend (STUB per the brief; input_specs
provides projected patch embeddings) + 76B LM backbone.
[arXiv:2404.16821; unverified] 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, rope_theta=5e5, n_vis_tokens=256,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=128, n_vis_tokens=8)
