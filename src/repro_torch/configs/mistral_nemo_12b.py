"""mistral-nemo-12b — dense GQA transformer, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407; hf] 40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072; head_dim=128 (explicit, != d_model/heads)."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1e6, tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=128)
