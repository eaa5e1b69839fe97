"""Thin wrapper around the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention.py``: :func:`flash_attention`
is K7, for ``flash_attention_call`` — causal and sliding-window softmax
attention with GQA, forward only, in the model's ``(B, S, H, hd)`` layout
(the kernel reads q, k and v through their strides: no transpose).  bf16
runs on the tensor cores and reads q, k and v with TMA, which needs a
16-byte-aligned base and (b, s, h) strides that are multiples of 16 bytes:
anything else is refused, never copied.  fp32 runs on the CUDA cores.  It
takes CUDA tensors only, checks them, allocates the output, launches on
PyTorch's current stream, raises if the launch failed and adds one to its
``launches`` count.  A tensor that needs a gradient is refused: the kernel
has no backward, as the reference's has none.  The front door that routes
a CPU tensor to the plain version is ``kernels/ops.py``.
"""
from __future__ import annotations

import torch

from . import _build
from .neighbor_agg import _raise_on, _stream

__all__ = ["flash_attention", "HEAD_DIMS", "reset_launch_counts",
           "launch_counts"]

# the head_dims the kernel is instantiated for: every head_dim of the
# configs and their smoke() reductions that runs attention
HEAD_DIMS = (16, 64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TMA_ALIGN = 16


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {like.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         "(B, S, heads, head_dim)")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous head_dim")
    if t.requires_grad:
        raise ValueError(f"{name} requires a gradient: the flash-attention "
                         "kernel is forward only")
    if t.dtype == torch.bfloat16:     # TMA's addressing rules
        if t.data_ptr() % _TMA_ALIGN:
            raise ValueError(f"{name}'s base is not {_TMA_ALIGN}-byte "
                             "aligned, which TMA needs")
        if any(st <= 0 or st * t.element_size() % _TMA_ALIGN
               for st in t.stride()[:3]):
            raise ValueError(f"{name} has strides {t.stride()[:3]}: TMA "
                             f"needs positive multiples of {_TMA_ALIGN} "
                             "bytes")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """K7: softmax attention of q ``(B, S, H, hd)`` over k, v ``(B, S, KV,
    hd)`` (query head ``h`` reads KV head ``h // (H // KV)``), causal and/or
    within ``window`` positions (0: no window) → ``(B, S, H, hd)`` in q's
    dtype (float32 or bfloat16)."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {q.device} tensor")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes "
                        "float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (positions 0..S-1 on "
                         "both sides)")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not split over {kv} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError("window must be >= 0")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    rc = _build.library("flash_attention").mgg_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, kv,
        hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
        int(window), _DTYPES[q.dtype], _stream(q.device))
    _raise_on(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reset_launch_counts() -> None:
    flash_attention.launches = 0


def launch_counts() -> dict:
    return {"flash_attention": flash_attention.launches}
