"""Plain PyTorch versions of the port's kernels.

The CPU path and the tests run these; ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  They repeat the kernels' arithmetic
(same summation order), not their speed.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["neighbor_gather_sum_ref", "segment_add_ordered_ref",
           "scatter_sum_ordered_ref", "gather_rows_ref"]


def neighbor_gather_sum_ref(buf: torch.Tensor, nbrs: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """``out[p] = Σ_j mask[p, j] · buf[nbrs[p, j]]`` → (P, D) float32.

    Slots are summed in order ``j = 0 .. ps-1``, as the kernels do.
    """
    p, ps = nbrs.shape
    out = torch.zeros((p, buf.shape[1]), dtype=torch.float32,
                      device=buf.device)
    for j in range(ps):
        row = buf.index_select(0, nbrs[:, j].long()).float()
        out = out + row * mask[:, j, None].float()
    return out


def segment_add_ordered_ref(out: torch.Tensor, partial: torch.Tensor,
                            order: torch.Tensor, seg_rows: torch.Tensor,
                            seg_start: torch.Tensor) -> torch.Tensor:
    """In place: ``out[seg_rows[s]] += Σ_k partial[order[k]]`` for ``k`` in
    segment ``s``, added in segment order (the order of ``order``).

    ``order`` is a stable argsort of the partitions' targets and
    ``seg_start`` its segment offsets, so each destination row receives its
    partials in partition order: bitwise what a sequential loop
    ``for i: out[tgt[i]] += partial[i]`` gives.  The loop runs over the
    rank inside a segment, vectorised across segments; the segments are
    taken longest first, so the live ones at rank ``k`` are a prefix whose
    lengths are read from the device once.
    """
    if seg_rows.numel() == 0:
        return out
    start = seg_start[:-1].long()
    lens = seg_start[1:].long() - start
    by_len = torch.argsort(lens, descending=True, stable=True)
    lens_desc = lens[by_len].cpu().numpy()
    # live[k] = segments longer than k
    live = np.searchsorted(-lens_desc, -np.arange(int(lens_desc[0])),
                           side="left")
    start = start[by_len]
    rows = seg_rows.long()[by_len]
    srt = partial.index_select(0, order.long())
    acc = out.index_select(0, rows)
    for k, n in enumerate(live.tolist()):
        acc[:n] += srt.index_select(0, start[:n] + k)
    out[rows] = acc
    return out


def scatter_sum_ordered_ref(dbuf: torch.Tensor, g: torch.Tensor,
                            index) -> torch.Tensor:
    """In place: ``dbuf[rows[s]] += Σ_k g[src[k]]`` over the masked slots
    ``k`` of segment ``s`` of ``index`` (a
    :class:`~repro_torch.kernels.ops.GradIndex`) — the gather-sum's
    backward (the reference's ``zeros.at[nbrs].add(g · mask)``) with the
    order of its adds fixed: slot order, or, for an index cut into chunks,
    each chunk in slot order and then each row's chunk sums in order."""
    if index.chunk_start is None:
        return segment_add_ordered_ref(dbuf, g, index.src, index.rows,
                                       index.start)
    n = index.chunk_start.shape[0] - 1
    ids = torch.arange(n, dtype=torch.int32, device=dbuf.device)
    sums = torch.zeros((n, dbuf.shape[1]), dtype=torch.float32,
                       device=dbuf.device)
    segment_add_ordered_ref(sums, g, index.src, ids, index.chunk_start)
    return segment_add_ordered_ref(dbuf, sums, ids, index.rows,
                                   index.row_chunks)


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` → (B, D) float32, bitwise a copy of the
    rows; an id outside ``[0, T)`` gives a zero row, as the kernel does."""
    idx = idx.long()
    ok = (idx >= 0) & (idx < src.shape[0])
    out = src.index_select(0, torch.where(ok, idx, 0)) if src.shape[0] \
        else src.new_zeros((idx.shape[0], src.shape[1]))
    out[~ok] = 0.0
    return out.float()
