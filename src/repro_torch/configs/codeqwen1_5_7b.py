"""codeqwen1.5-7b — dense Qwen1.5-arch GQA transformer.
[hf:Qwen/CodeQwen1.5-7B; hf] 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab=92416, rope_theta=1e6, tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=128)
