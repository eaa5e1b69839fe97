"""Thin wrapper around the CUDA row-gather kernel (``csrc/rows.cu``).

Counterpart of ``repro/kernels/rows.py``: :func:`gather_rows` is K5, for
``gather_rows_call`` — ``out[i] = src[idx[i]]``, the tiered store's row
assembly (``store/tiered.py``).  It takes CUDA tensors only, checks them,
allocates the output, launches on PyTorch's current stream, raises if the
launch failed and adds one to its ``launches`` count.  The front door that
routes a CPU tensor to the plain version is ``kernels/ops.py``.
"""
from __future__ import annotations

import torch

from . import _build
from .neighbor_agg import _check, _raise_on, _stream

__all__ = ["gather_rows", "reset_launch_counts", "launch_counts"]


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5: ``out[i] = src[idx[i]]`` → (B, D) float32; an id outside
    ``[0, T)`` gives a zero row."""
    if src.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {src.device} tensor")
    _check("src", src, torch.float32, 2, src.device)
    _check("idx", idx, torch.int32, 1, src.device)
    out = torch.empty((idx.shape[0], src.shape[1]), dtype=torch.float32,
                      device=src.device)
    rc = _build.library("rows").mgg_gather_rows(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        src.shape[0], src.shape[1], _stream(src.device))
    _raise_on(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def reset_launch_counts() -> None:
    gather_rows.launches = 0


def launch_counts() -> dict:
    return {"gather_rows": gather_rows.launches}
