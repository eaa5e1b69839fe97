"""granite-moe-1b-a400m — fine-grained MoE (32 experts, top-8).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 24L d_model=1024 16H
(GQA kv=8) d_ff=512 vocab=49155.

32 experts / 16-way model axis ⇒ expert_mode="ep": 2 experts per chip,
dispatch via the MGG-pipelined all_to_all (models/moe.py).  vocab 49155 is
not divisible by 16 — padded embedding rows (DESIGN.md)."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155, rope_theta=1e4,
    n_experts=32, top_k=8, expert_mode="ep", tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=130, n_experts=8, top_k=2)
