"""Plain PyTorch versions of the port's kernels.

The CPU path and the tests run these; ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  They repeat the kernels' arithmetic
(same summation order), not their speed.
"""
from __future__ import annotations

import torch

__all__ = ["neighbor_gather_sum_ref", "segment_add_ordered_ref"]


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
    rank inside a segment, vectorised across segments.
    """
    if seg_rows.numel() == 0:
        return out
    start = seg_start[:-1].long()
    lens = seg_start[1:].long() - start
    srt = partial.index_select(0, order.long())
    rows = seg_rows.long()
    acc = out.index_select(0, rows)
    for k in range(int(lens.max())):
        live = torch.nonzero(lens > k).squeeze(1)
        acc[live] += srt.index_select(0, start[live] + k)
    out[rows] = acc
    return out
