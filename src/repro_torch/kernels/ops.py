"""Front door to the gather-sum kernels (counterpart of ``repro/kernels/ops.py``).

A CPU tensor takes the plain version (kernels/ref.py); a CUDA tensor takes
a kernel, with no fallback; any other device raises.  The TPU wrapper's
128-lane column padding and ``db ≤ 1024`` block choice were layout rules
of the TPU: the CUDA kernels take any width ``D`` as it is.  Its VMEM rule
(``ops.py:192``: a blocked stripe that does not fit runs pipelined) becomes
the shared-memory and block-size rule of :func:`neighbor_agg.blocked_fits`.

There is no ``autograd.Function`` yet: the masked scatter-add backward
(``repro/kernels/ops.py:76-82``) arrives with training.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import neighbor_agg, ref

__all__ = ["neighbor_gather_sum", "segment_add_ordered"]


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no gather-sum for device {t.device}")
    return t.device.type


def neighbor_gather_sum(buf: torch.Tensor, nbrs: torch.Tensor,
                        mask: torch.Tensor, *,
                        pb: Optional[int] = None) -> torch.Tensor:
    """``out[p] = Σ_j mask[p, j] · buf[nbrs[p, j]]`` → (P, D) float32.

    ``pb=None`` selects the pipelined kernel (K1); an integer selects the
    partition-blocked kernel (K2) with that many warps per block, unless
    the block would not fit (then K1, as the reference falls back when
    its VMEM stripe does not fit).
    """
    if _route(buf) == "cpu":
        return ref.neighbor_gather_sum_ref(buf, nbrs, mask)
    if pb is not None and not neighbor_agg.blocked_fits(pb, nbrs.shape[1]):
        pb = None
    if pb is None:
        return neighbor_agg.gather_sum_pipelined(buf, nbrs, mask)
    return neighbor_agg.gather_sum_blocked(buf, nbrs, mask, pb=pb)


def segment_add_ordered(out: torch.Tensor, partial: torch.Tensor,
                        order: torch.Tensor, seg_rows: torch.Tensor,
                        seg_start: torch.Tensor) -> torch.Tensor:
    """In place ``out[tgt] += partial``, deterministic: each destination
    row adds its partials in partition order (K3 on the card)."""
    if _route(out) == "cpu":
        return ref.segment_add_ordered_ref(out, partial, order, seg_rows,
                                           seg_start)
    return neighbor_agg.segment_add_ordered(out, partial, order, seg_rows,
                                            seg_start)
