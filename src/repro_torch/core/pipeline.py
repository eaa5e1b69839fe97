"""MGG pipelined ring aggregation over a virtual ring on one card
(counterpart of ``repro/core/pipeline.py``).

Per virtual shard, neighbor aggregation splits into a **local** pass over
the shard's own rows and ``(n-1) · dist`` **ring steps**, each aggregating
the remote tile that just arrived while the next rotation is in flight
(dist/ring.py: a side-stream copy ordered by CUDA events, the port's
``ppermute``).  ``interleave`` spreads the local partitions across the ring
steps (paper §3.3); ``update_w`` fuses the dense ``·W`` update into every
step.  The step order, the chunk-major ``dist`` rings (prologue, loop,
epilogue) and the ``n_dev == 1`` early return follow the reference.

All shards live in one tensor, so one ring step is ONE gather-sum launch
and ONE ordered segment add over every shard's partitions at once: the
host flattens the per-shard plan arrays, offset into the stacked buffers,
when the plan is bound (:func:`plan_device_arrays`).  That is also where
each step's segment order is built (a stable argsort of its targets plus
segment offsets), so the hot path never sorts.  The reference pads every
shard and step to one partition count for SPMD; the flattened arrays drop
those all-masked partitions, which only ever added zero rows.

The bulk, fetch, sparse (top-k) and streamed variants come in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..dist.ring import VirtualRing
from ..kernels import ops, ref
from .placement import AggregationPlan

__all__ = ["WorkGroup", "RingArrays", "plan_device_arrays", "mgg_aggregate",
           "reference_aggregate"]


@dataclasses.dataclass(frozen=True)
class WorkGroup:
    """One launch's partitions across every shard, plus their segment order.

    ``nbrs`` index rows of the flat buffer the group gathers from (the
    stacked ring tiles or the whole table); ``order``/``seg_rows``/
    ``seg_start`` drive the ordered segment add into the flat output.
    """

    nbrs: torch.Tensor       # (P, ps) int32
    mask: torch.Tensor       # (P, ps) bool
    order: torch.Tensor      # (P,) int32: partitions sorted stably by target
    seg_rows: torch.Tensor   # (S,) int32: distinct target rows, ascending
    seg_start: torch.Tensor  # (S + 1,) int32: segment offsets into order

    @property
    def num_partitions(self) -> int:
        return int(self.nbrs.shape[0])

    @staticmethod
    def build(nbrs: np.ndarray, mask: np.ndarray, targets: np.ndarray,
              device) -> "WorkGroup":
        order = np.argsort(targets, kind="stable")
        seg_rows, counts = np.unique(targets[order], return_counts=True)
        seg_start = np.zeros(seg_rows.shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=seg_start[1:])

        def t(a, dtype=torch.int32):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        return WorkGroup(nbrs=t(nbrs), mask=t(mask, torch.bool),
                         order=t(order), seg_rows=t(seg_rows),
                         seg_start=t(seg_start))


@dataclasses.dataclass(frozen=True)
class RingArrays:
    """The device-resident form of one plan under one ``interleave`` flag."""

    interleave: bool
    local: Optional[WorkGroup]           # local work up front (or n_dev == 1)
    local_steps: Tuple[WorkGroup, ...]   # interleaved local slice per step
    remote_steps: Tuple[WorkGroup, ...]  # remote tile work per ring step


def plan_device_arrays(plan: AggregationPlan, *, interleave: bool = True,
                       device="cpu") -> RingArrays:
    """Flatten ``plan``'s per-shard arrays into per-step :class:`WorkGroup`\\ s
    on ``device`` (host-side, once per plan)."""
    n_dev, rows, tile_rows = plan.n_dev, plan.rows_per_dev, plan.tile_rows
    n_steps = plan.num_steps if n_dev > 1 else 0
    dev = np.arange(n_dev, dtype=np.int64)

    def group(nbrs, mask, tgt, nbr_rows) -> WorkGroup:
        keep = mask.any(-1)  # (n_dev, P): SPMD padding carries no slot
        flat_nbrs = (nbrs.astype(np.int64)
                     + dev[:, None, None] * nbr_rows)[keep]
        flat_tgt = (tgt.astype(np.int64) + dev[:, None] * rows)[keep]
        return WorkGroup.build(flat_nbrs, mask[keep], flat_tgt, device)

    local, local_steps = None, ()
    if interleave and n_steps > 0:
        # the reference's slicing: ceil(PL / steps) local partitions a step
        ls = -(-plan.local_nbrs.shape[1] // n_steps)
        local_steps = tuple(
            group(plan.local_nbrs[:, s * ls:(s + 1) * ls],
                  plan.local_mask[:, s * ls:(s + 1) * ls],
                  plan.local_targets[:, s * ls:(s + 1) * ls], rows)
            for s in range(n_steps))
    else:
        local = group(plan.local_nbrs, plan.local_mask, plan.local_targets,
                      rows)
    remote_steps = tuple(
        group(plan.remote_nbrs[:, s], plan.remote_mask[:, s],
              plan.remote_targets[:, s], tile_rows)
        for s in range(n_steps))
    return RingArrays(interleave=bool(interleave), local=local,
                      local_steps=local_steps, remote_steps=remote_steps)


def _gather_sum(buf, grp: WorkGroup, use_kernel: bool,
                pb: Optional[int]) -> torch.Tensor:
    """The paper's warp-level gather+reduce; ``use_kernel=False`` runs the
    plain version on any device (the reference's jnp oracle path)."""
    if use_kernel:
        return ops.neighbor_gather_sum(buf, grp.nbrs, grp.mask, pb=pb)
    return ref.neighbor_gather_sum_ref(buf, grp.nbrs, grp.mask)


def _segment_add(out, partial, grp: WorkGroup, use_kernel: bool) -> None:
    fn = ops.segment_add_ordered if use_kernel else ref.segment_add_ordered_ref
    fn(out, partial, grp.order, grp.seg_rows, grp.seg_start)


def mgg_aggregate(
    x: torch.Tensor,
    plan: AggregationPlan,
    ring: VirtualRing,
    *,
    interleave: bool = True,
    use_kernel: bool = True,
    pb: Optional[int] = None,
    update_w: Optional[torch.Tensor] = None,
    arrays: Optional[RingArrays] = None,
) -> torch.Tensor:
    """Pipelined sum-aggregation: ``out[v] = Σ_{u ∈ N(v)} x[u]``.

    ``x`` is the padded PGAS table ``(n_dev · rows_per_dev, D)``; the
    output has the same layout.  ``pb`` selects the partition-blocked
    kernel.  ``update_w`` (``(D, D_out)``) fuses the update: the output
    becomes ``(A x) @ W`` with one partial matmul per step, in full fp32.
    ``arrays`` is the plan's :func:`plan_device_arrays` (built here when
    not given; engines build it once).
    """
    if ring.n_dev != plan.n_dev:
        raise ValueError(f"ring of {ring.n_dev} shards, plan for "
                         f"{plan.n_dev}")
    if x.shape[0] != plan.padded_nodes:
        raise ValueError(f"x has {x.shape[0]} rows, plan pads to "
                         f"{plan.padded_nodes}")
    if arrays is None:
        arrays = plan_device_arrays(plan, interleave=interleave,
                                    device=x.device)
    elif arrays.interleave != bool(interleave):
        raise ValueError("arrays were built for another interleave flag")
    x = x.contiguous()
    n_dev, dist, tile_rows = plan.n_dev, plan.dist, plan.tile_rows
    rows, d_feat = x.shape
    update: Callable[[torch.Tensor], torch.Tensor]
    if update_w is not None:
        w = update_w.to(torch.float32)
        d_out = w.shape[1]
        update = lambda partial: partial @ w
    else:
        d_out = d_feat
        update = lambda partial: partial
    out = torch.zeros((rows, d_out), dtype=torch.float32, device=x.device)

    def work(buf: torch.Tensor, grp: WorkGroup) -> None:
        if grp.num_partitions:
            _segment_add(out, update(_gather_sum(buf, grp, use_kernel, pb)),
                         grp, use_kernel)

    if arrays.local is not None:
        # paper Fig. 9(b) baseline (or a single shard): local work up front
        work(x, arrays.local)
    if n_dev == 1:
        return out.to(x.dtype)

    tiles = x.view(n_dev, dist, tile_rows, d_feat)
    cur = torch.empty((n_dev, tile_rows, d_feat), dtype=x.dtype,
                      device=x.device)
    nxt = torch.empty_like(cur)
    # One double-buffered ring per tile chunk (chunk-major: every chunk
    # makes exactly n_dev - 1 rotations).
    for c in range(dist):
        ring.wait(ring.rotate(tiles[:, c], cur))  # rotation 1 (prologue)
        for k in range(n_dev - 1):
            step = k * dist + c
            # rotation k+2 is in flight while this step aggregates `cur`;
            # the last step (epilogue) has nothing left to rotate
            last = k == n_dev - 2
            token = None if last else ring.rotate(cur, nxt)
            work(cur.view(-1, d_feat), arrays.remote_steps[step])
            if arrays.local_steps:
                work(x, arrays.local_steps[step])
            if not last:
                ring.wait(token)
                cur, nxt = nxt, cur
    return out.to(x.dtype)


def reference_aggregate(indptr: np.ndarray, indices: np.ndarray,
                        x: np.ndarray) -> np.ndarray:
    """Dense oracle: ``out[v] = Σ_{u ∈ N(v)} x[u]`` (float64 accumulation)."""
    out = np.zeros_like(x, dtype=np.float64)
    deg = np.diff(indptr)
    row_ids = np.repeat(np.arange(x.shape[0]), deg)
    np.add.at(out, row_ids, x[indices].astype(np.float64))
    return out.astype(x.dtype)
