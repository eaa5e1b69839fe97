"""Thin wrapper around the CUDA sLSTM scan kernel (``csrc/slstm_scan.cu``).

Counterpart of ``repro/kernels/slstm_scan.py``: :func:`slstm_scan` is K8,
for ``slstm_scan_call`` — the sLSTM recurrence over a whole sequence with
the four states kept on chip, in the model's head-major layout with the
per-head ``wr (H, hd, 4·hd)`` (the TPU kernel's gate-major permutation and
block-diagonal ``expand_blockdiag`` are not carried over).  It takes CUDA
tensors only, checks them, allocates the outputs, launches on PyTorch's
current stream, raises if the launch failed and adds one to its
``launches`` count.  A tensor that needs a gradient is refused: the kernel
has no backward, as the reference's has none.  The front door that routes
a CPU tensor to the plain version is ``kernels/ops.py``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build
from .neighbor_agg import _raise_on, _stream

__all__ = ["slstm_scan", "MAX_HEAD_DIM", "MAX_BT", "reset_launch_counts",
           "launch_counts"]

MAX_HEAD_DIM = 256    # one thread a gate column: 4·hd <= 1024
MAX_BT = 8            # batch rows a block


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad:
        raise ValueError(f"{name} requires a gradient: the sLSTM scan "
                         "kernel is forward only")


def slstm_scan(xp: torch.Tensor, wr: torch.Tensor,
               state: Dict[str, torch.Tensor], *, bt: int = MAX_BT
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K8: the sLSTM recurrence over xp ``(B, S, 4·D)`` fp32 (head-major:
    ``reshape(B, S, H, 4·hd)``, each head ``[z | i | f | o]``) with the
    recurrent weights wr ``(H, hd, 4·hd)`` fp32, from ``state`` h/c/n/m
    ``(B, H, hd)`` fp32 → (hs ``(B, S, H, hd)`` fp32, the states after the
    last step).  ``bt`` batch rows share a block (and its reads of wr); the
    result does not depend on it."""
    if xp.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {xp.device} tensor")
    if wr.dim() != 3 or xp.dim() != 3:
        raise ValueError(f"xp {tuple(xp.shape)} and wr {tuple(wr.shape)}: "
                         "expected (B, S, 4·D) and (H, hd, 4·hd)")
    heads, hd = wr.shape[0], wr.shape[1]
    b, s = xp.shape[0], xp.shape[1]
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} not in 1..{MAX_HEAD_DIM}")
    if not 1 <= bt <= MAX_BT:
        raise ValueError(f"bt {bt} not in 1..{MAX_BT}")
    dev = xp.device
    _check("xp", xp, (b, s, heads * 4 * hd), dev)
    _check("wr", wr, (heads, hd, 4 * hd), dev)
    for k in ("h", "c", "n", "m"):
        _check(f"state[{k!r}]", state[k], (b, heads, hd), dev)
    hs = torch.empty((b, s, heads, hd), dtype=torch.float32, device=dev)
    new = {k: torch.empty((b, heads, hd), dtype=torch.float32, device=dev)
           for k in ("h", "c", "n", "m")}
    rc = _build.library("slstm_scan").mgg_slstm_scan(
        xp.data_ptr(), wr.data_ptr(), *(state[k].data_ptr() for k in "hcnm"),
        hs.data_ptr(), *(new[k].data_ptr() for k in "hcnm"), b, s, heads, hd,
        min(bt, max(b, 1)), _stream(dev))
    _raise_on(rc, "slstm_scan")
    slstm_scan.launches += 1
    return hs, new


slstm_scan.launches = 0


def reset_launch_counts() -> None:
    slstm_scan.launches = 0


def launch_counts() -> dict:
    return {"slstm_scan": slstm_scan.launches}
