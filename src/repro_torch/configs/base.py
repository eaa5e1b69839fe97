"""Config system: architecture + input-shape declarations (the port's copy
of ``repro/configs/base.py``; ``pdtype``/``cdtype`` give torch dtypes).

Every assigned architecture is a :class:`ModelConfig` in its own module
(``repro_torch/configs/<id>.py``), exactly matching the published numbers,
plus a ``smoke()`` reduction of the same family for CPU tests.  Input shapes
are the four assigned cells (train_4k / prefill_32k / decode_32k / long_500k)
with per-family applicability rules (DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 ⇒ d_model // n_heads
    rope_theta: float = 1e4          # 0 ⇒ no RoPE
    qk_norm: bool = False
    sliding_window: int = 0          # 0 ⇒ full causal attention
    mlp_type: str = "swiglu"         # swiglu | gelu
    norm: str = "rms"                # rms | ln
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_mode: str = "ep"          # ep (experts sharded) | tp (d_ff sharded)
    moe_capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: shared attn block every k layers
    # xLSTM
    xlstm_pattern: Tuple[str, ...] = ()   # e.g. ("m", "s") repeated
    # encoder-decoder
    n_enc_layers: int = 0
    # VLM stub frontend
    n_vis_tokens: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # distribution hints
    remat: bool = True
    # opt-in flash attention (K7 on the card) for the cache-less forward
    # only (contiguous positions); prefill and decode keep the chunked
    # ring-cache path, as the reference routes them
    use_flash_attention: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve a 500k-token context? (DESIGN.md rules)."""
        if self.family in ("hybrid", "xlstm"):
            return True
        return self.sliding_window > 0  # SWA bounds the KV cache

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "moe":
            per_e = 3 * d * f if self.mlp_type == "swiglu" else 2 * d * f
            mlp = self.n_experts * per_e + d * self.n_experts  # + router
        elif self.family == "hybrid":
            d_in = d * self.ssm_expand
            heads = d_in // self.ssm_headdim
            mlp = 3 * d * f if f else 0
            attn = (d * d_in * 2 + d_in * 4 + d_in * d  # in/out proj
                    + heads * self.ssm_state * 2) + (
                attn // max(1, self.attn_every) if self.attn_every else 0)
        elif self.family == "xlstm":
            dk = d
            mlp = 0
            attn = 4 * d * dk + 2 * d * d  # qkv/gates + in/out proj (approx)
        else:
            mlp = 3 * d * f if self.mlp_type == "swiglu" else 2 * d * f
        blocks = self.n_layers * (attn + mlp + 2 * d)
        if self.family == "encdec":
            blocks += self.n_enc_layers * (attn + mlp + 2 * d)
        return blocks + self.vocab * d * (1 if self.tie_embeddings else 2)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason) per the assignment rules."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full-attention arch: 500k-token decode needs "
                       "sub-quadratic attention (skip per brief)")
    return True, ""
