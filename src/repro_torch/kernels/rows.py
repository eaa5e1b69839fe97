"""Thin wrapper around the CUDA row-gather kernel (``csrc/rows.cu``).

Counterpart of ``repro/kernels/rows.py``: :func:`gather_rows` is K5, for
``gather_rows_call`` — ``out[i] = src[idx[i]]``, the tiered store's row
assembly (``store/tiered.py``).  It takes CUDA tensors only, checks them,
allocates the output, launches on PyTorch's current stream with the
geometry of :func:`plan`, raises if the launch failed and adds one to its
``launches`` count (and its work to the active counters, ``kernels/
cost.py``).  The front door that routes a CPU tensor to the plain
version is ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build, cost
from .neighbor_agg import _check, _raise_on, _stream

__all__ = ["gather_rows", "plan", "Plan", "blocks_per_sm", "UNROLL",
           "THREADS", "reset_launch_counts", "launch_counts"]

# vectors in flight a thread and threads a block: csrc/rows.cu's kUnroll
# and kThreads (tools/k5_variants.py times other values)
UNROLL = 4
THREADS = 256


class Plan(NamedTuple):
    """K5's launch geometry: ``width`` floats a vector (4: 16 bytes, 1: a
    word) and a persistent ``grid`` of blocks of THREADS threads, each
    thread UNROLL vectors a chunk."""
    width: int
    grid: int


def _grid(vectors: int, resident: int, chunk: int) -> int:
    """Blocks walking ``vectors`` in chunks of ``chunk``: the ``resident``
    blocks the card holds at once, or fewer where the chunks are fewer, and
    few enough that the kernel's first vector of a thread and its stride
    fit 31 bits."""
    return max(1, min(resident, -(-vectors // chunk), (2 ** 31 - 1) // chunk))


def plan(B: int, D: int, sms: int, blocks_per_sm: int, *,
         width: Optional[int] = None) -> Plan:
    """The geometry of one K5 launch over ``B`` rows of ``D`` floats on a
    card of ``sms`` SMs holding ``blocks_per_sm`` blocks each.  The output's
    ``B · D / width`` vectors are walked in chunks of ``UNROLL · THREADS``
    by a grid-stride loop.  ``width`` defaults to 4 where ``D % 4 == 0``
    (the wrapper passes 1 for a table off 16 bytes)."""
    if width is None:
        width = 4 if D % 4 == 0 else 1
    if width not in (1, 4) or D % width:
        raise ValueError(f"width {width} does not divide D = {D}")
    return Plan(width, _grid(B * (D // width), sms * max(1, blocks_per_sm),
                             UNROLL * THREADS))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def blocks_per_sm(index: int, width: int) -> int:
    """Blocks of the ``width`` instance one SM of card ``index`` holds at
    once (the occupancy calculator), queried once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = _build.library("rows").mgg_gather_rows_occupancy(
            ctypes.addressof(n), width)
    _raise_on(rc, "gather_rows occupancy")
    return n.value


@functools.lru_cache(maxsize=256)
def _plan_on(index: int, B: int, D: int, width: int) -> Plan:
    """The plan of a launch on card ``index``, kept: a sampled step's
    launches repeat a few shapes, and the host paces them."""
    return plan(B, D, _sms(index), blocks_per_sm(index, width), width=width)


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5: ``out[i] = src[idx[i]]`` → (B, D) float32; an id outside
    ``[0, T)`` gives a zero row."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {dev} tensor")
    _check("src", src, torch.float32, 2, dev)
    _check("idx", idx, torch.int32, 1, dev)
    b, d = idx.shape[0], src.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    s_ptr = src.data_ptr()
    # out, fresh from the allocator, is on 16 bytes
    width = 4 if d % 4 == 0 and s_ptr % 16 == 0 else 1
    # (width, grid): the C entry point's order
    p = _plan_on(dev.index, b, d, width)
    rc = _build.library("rows").mgg_gather_rows(
        s_ptr, idx.data_ptr(), out.data_ptr(), b, src.shape[0], d, *p,
        _stream(dev))
    _raise_on(rc, "gather_rows")
    gather_rows.launches += 1
    cost.record("gather_rows", lambda: cost.gather_rows(cost.host(idx), d))
    return out


gather_rows.launches = 0


def reset_launch_counts() -> None:
    gather_rows.launches = 0


def launch_counts() -> dict:
    return {"gather_rows": gather_rows.launches}
