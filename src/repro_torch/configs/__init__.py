"""Architecture registry: the 10 assigned configs (the port's copy of
``repro/configs``; the paper's own GNN settings live in
repro_torch.core.gnn / repro_torch.core.graph)."""
import importlib
from typing import Dict, List

from .base import ModelConfig, ShapeSpec, SHAPES, shape_applicable

ARCH_IDS: List[str] = [
    "codeqwen1.5-7b",
    "mistral-nemo-12b",
    "qwen3-32b",
    "starcoder2-15b",
    "zamba2-7b",
    "internvl2-76b",
    "mixtral-8x7b",
    "granite-moe-1b-a400m",
    "xlstm-125m",
    "whisper-base",
]

_MODULES: Dict[str, str] = {
    a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "shape_applicable",
           "ARCH_IDS", "get_config", "get_smoke_config"]
