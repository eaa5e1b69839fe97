"""mixtral-8x7b — MoE (8 experts, top-2) with sliding-window attention.
[arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000.

8 experts < the 16-way model axis ⇒ expert_mode="tp": experts replicated,
d_ff sharded inside each expert (DESIGN.md §Arch-applicability)."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, rope_theta=1e6, sliding_window=4096,
    n_experts=8, top_k=2, expert_mode="tp", tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=128, n_experts=4, top_k=2, sliding_window=16)
