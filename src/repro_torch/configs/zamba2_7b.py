"""zamba2-7b — hybrid: Mamba2 backbone + ONE shared attention+MLP block
applied every ``attn_every`` layers (the Zamba2 weight-sharing trick).
[arXiv:2411.15242; unverified] 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64.

Adaptation noted in DESIGN.md: the shared attention carries a 4096-token
sliding window so the decode_32k / long_500k cells keep an O(window) KV
cache — the hybrid family's long-context selling point."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, rope_theta=1e4, sliding_window=4096,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, attn_every=6,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=128, ssm_state=16, ssm_headdim=16, attn_every=3,
        ssm_chunk=8)
