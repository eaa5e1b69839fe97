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
segment offsets, and its hub segments cut into fixed-order chunks), so
the hot path never sorts.  The reference pads every
shard and step to one partition count for SPMD; the flattened arrays drop
those all-masked partitions, which only ever added zero rows.

Autograd sees the ring as one ``autograd.Function``: the forward writes
its output in place and rotates with copies, which autograd cannot follow.
Its backward is the reference's transposed ring: chunks and steps in
reverse, each step's ordered scatter-sum (K4) adding into the gradient of
the rotated tile, which then rotates one shard back; the local work
scatters straight into ``dx``.  Each group's transposed index
(:class:`~repro_torch.kernels.ops.GradIndex`, composed with the
partitions' targets) is built with its forward arrays.  A fused ``·W``
update differentiates as ``dx = Aᵀ (g Wᵀ)`` and ``dW = (A x)ᵀ g``, with
``A x`` from one unfused ring.  :func:`block_neighbor_sum` runs a sampled
block's masked sum on the same gather-sum and its K4 backward.

:func:`mgg_aggregate_sparse` is the top-k compressed ring (the reference's
MaxK-GNN direction): each row is compressed once to its ``k`` largest
entries, the ring rotates the ``(values, ids)`` pair — ``k · (4 + 2)``
bytes a row with int16 ids instead of ``D · 4`` — and each step's K6
gather-sum reads the compressed rows directly.  Its backward is the same
transposed ring over ``k``-wide value gradients (a ppermute of the values
transposes to a ppermute of their cotangent), and ``dx`` is the scatter of
the value gradients at the ids.

:func:`mgg_aggregate_streamed` (and its top-k twin) runs the same
chunk rings over features that are only partly on the card: each chunk
is fetched from a tiered store while the previous chunk's ring is in
flight, the local pass runs last over the assembled table, and the
partial sums are added in a fixed order.  It is forward only, as in the
reference.

:func:`bulk_aggregate` and :func:`fetch_rows_aggregate` are the paper's
baselines, forward only as in the reference: the whole table gathered
first, then aggregated (DGCL / NCCL), and each shard's referenced rows
fetched first, exactly or a page at a time (Direct / UVM).  Neither
overlaps its communication with its computation.  They run the ring's
K1 and K3 (and K5 for the fetch) on one :class:`WorkGroup` a shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..dist.ring import VirtualRing
from ..kernels import ops, ref
from ..kernels.ops import GradIndex, SegmentChunks
from .placement import AggregationPlan

__all__ = ["WorkGroup", "RingArrays", "host_groups", "plan_device_arrays",
           "mgg_aggregate", "mgg_aggregate_sparse", "mgg_aggregate_streamed",
           "mgg_aggregate_sparse_streamed", "block_neighbor_sum",
           "bulk_groups", "bulk_aggregate", "fetch_groups",
           "fetch_rows_aggregate", "reference_aggregate",
           "topk_activation", "wire_index_dtype", "topk_decompress",
           "collective_bytes", "sparse_collective_bytes"]

topk_decompress = ref.topk_decompress


def topk_activation(x: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the ``k`` largest entries per row: ``x → (values, col_idx)``,
    both ``(N, k)``, ``values[n, s] = x[n, col_idx[n, s]]``, ids int32 in
    descending order of value as ``lax.top_k`` gives them.  The ids of a
    row are distinct, so :func:`topk_decompress` is an exact inverse at
    ``k == D``.  Among tied values ``torch.topk`` may pick other columns
    than ``lax.top_k``: the decompressed rows agree whenever the only ties
    at the ``k`` boundary are zeros."""
    values, idx = torch.topk(x, k, dim=1, sorted=True)
    return values, idx.to(torch.int32)


def wire_index_dtype(d_feat: int) -> torch.dtype:
    """Narrowest integer dtype that addresses a column of width ``d_feat``:
    int16 up to 32767 columns, so a ``(value, id)`` pair is 6 bytes."""
    return torch.int16 if d_feat <= np.iinfo(np.int16).max else torch.int32


def collective_bytes(plan: AggregationPlan, d_feat: int,
                     itemsize: int = 4) -> int:
    """Ring bytes per shard per aggregation: (n-1) full shard rotations."""
    if plan.n_dev <= 1:
        return 0
    return (plan.n_dev - 1) * plan.rows_per_dev * d_feat * itemsize


def sparse_collective_bytes(plan: AggregationPlan, d_feat: int, k: int,
                            itemsize: int = 4) -> int:
    """Ring bytes of the compressed payload: (n-1) rotations of the
    ``(values, col_idx)`` pair — ``k`` values plus ``k`` ids in the wire
    index dtype per row."""
    if plan.n_dev <= 1:
        return 0
    idx_itemsize = torch.empty((), dtype=wire_index_dtype(d_feat)).itemsize
    k = min(int(k), int(d_feat))
    return (plan.n_dev - 1) * plan.rows_per_dev * k * (itemsize
                                                       + idx_itemsize)


@dataclasses.dataclass(frozen=True)
class WorkGroup:
    """One launch's partitions across every shard, plus their segment order.

    ``nbrs`` index rows of the flat buffer the group gathers from (the
    stacked ring tiles or the whole table); ``order``/``seg_rows``/
    ``seg_start`` drive the ordered segment add into the flat output, and
    ``chunks`` cuts its hub segments into fixed-order chunks (None when no
    segment is longer than ``ops.chunk_length`` of the longest); ``grad``
    is the transposed index, with hub chunks of its own, whose K4
    scatter-sum carries the output's gradient back to the rows gathered
    from.
    """

    nbrs: torch.Tensor       # (P, ps) int32
    mask: torch.Tensor       # (P, ps) bool
    order: torch.Tensor      # (P,) int32: partitions sorted stably by target
    seg_rows: torch.Tensor   # (S,) int32: distinct target rows, ascending
    seg_start: torch.Tensor  # (S + 1,) int32: segment offsets into order
    chunks: Optional[SegmentChunks]  # hub segments cut into chunks
    grad: GradIndex          # masked slots by neighbor row → target rows

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
                         seg_start=t(seg_start),
                         chunks=SegmentChunks.build(seg_start, device),
                         grad=GradIndex.build(nbrs, mask, targets, device))


@dataclasses.dataclass(frozen=True)
class RingArrays:
    """The device-resident form of one plan under one ``interleave`` flag."""

    interleave: bool
    local: Optional[WorkGroup]           # local work up front (or n_dev == 1)
    local_steps: Tuple[WorkGroup, ...]   # interleaved local slice per step
    remote_steps: Tuple[WorkGroup, ...]  # remote tile work per ring step


def host_groups(plan: AggregationPlan, *, interleave: bool = True,
                remote: bool = True):
    """The host arrays ``(nbrs, mask, targets)`` of each launch group of
    ``plan`` — every shard's partitions flattened into one launch, rows
    offset into the flat buffer and output, SPMD padding dropped — as
    ``(local, local_steps, remote_steps)``: the local work up front (or
    None), the interleaved local slice of each ring step, the remote tile
    work of each step (``()`` without ``remote``)."""
    n_dev, rows, tile_rows = plan.n_dev, plan.rows_per_dev, plan.tile_rows
    n_steps = plan.num_steps if n_dev > 1 else 0
    dev = np.arange(n_dev, dtype=np.int64)

    def group(nbrs, mask, tgt, nbr_rows):
        keep = mask.any(-1)  # (n_dev, P): SPMD padding carries no slot
        flat_nbrs = (nbrs.astype(np.int64)
                     + dev[:, None, None] * nbr_rows)[keep]
        flat_tgt = (tgt.astype(np.int64) + dev[:, None] * rows)[keep]
        return flat_nbrs, mask[keep], flat_tgt

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
        for s in range(n_steps)) if remote else ()
    return local, local_steps, remote_steps


def plan_device_arrays(plan: AggregationPlan, *, interleave: bool = True,
                       device="cpu",
                       remote_steps: Optional[Tuple[WorkGroup, ...]] = None
                       ) -> RingArrays:
    """Flatten ``plan``'s per-shard arrays into per-step :class:`WorkGroup`\\ s
    on ``device`` (host-side, once per plan; :func:`host_groups`).
    ``remote_steps`` reuses the remote groups of the same plan's arrays
    under the other ``interleave`` flag (they do not depend on it), so only
    the local work is built."""
    n_steps = plan.num_steps if plan.n_dev > 1 else 0
    local, local_steps, remote = host_groups(
        plan, interleave=interleave, remote=remote_steps is None)
    build = lambda g: WorkGroup.build(*g, device)
    if remote_steps is None:
        remote_steps = tuple(build(g) for g in remote)
    elif len(remote_steps) != n_steps:
        raise ValueError(f"{len(remote_steps)} remote steps given, the plan "
                         f"has {n_steps}")
    return RingArrays(interleave=bool(interleave),
                      local=None if local is None else build(local),
                      local_steps=tuple(build(g) for g in local_steps),
                      remote_steps=remote_steps)


def _gather_sum(buf, grp: WorkGroup, use_kernel: bool,
                pb: Optional[int]) -> torch.Tensor:
    """The paper's warp-level gather+reduce; ``use_kernel=False`` runs the
    plain version on any device (the reference's jnp oracle path)."""
    return ops.neighbor_gather_sum(buf, grp.nbrs, grp.mask, pb=pb,
                                   use_kernel=use_kernel)


def _segment_add(out, partial, grp: WorkGroup, use_kernel: bool) -> None:
    fn = ops.segment_add_ordered if use_kernel else ref.segment_add_ordered_ref
    fn(out, partial, grp.order, grp.seg_rows, grp.seg_start, grp.chunks)


def _scatter_sum(dbuf, g, grp: WorkGroup, use_kernel: bool) -> None:
    if grp.grad.num_slots:
        fn = ops.scatter_sum_ordered if use_kernel \
            else ref.scatter_sum_ordered_ref
        fn(dbuf, g, grp.grad)


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
    not given; engines build it once).  Differentiable in ``x`` and
    ``update_w`` (the transposed ring, module docstring).
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
    return _RingAggregate.apply(x, update_w, plan, ring, arrays, use_kernel,
                                pb)


class _RingAggregate(torch.autograd.Function):
    """The ring as one differentiable op: forward :func:`_ring_forward`,
    backward :func:`_ring_backward` (the transposed ring)."""

    @staticmethod
    def forward(ctx, x, w, plan, ring, arrays, use_kernel, pb):
        ctx.save_for_backward(None if w is None else x, w)  # x: for dW
        ctx.ring_args = (plan, ring, arrays, use_kernel, pb)
        ctx.x_dtype = x.dtype
        return _ring_forward(x, w, *ctx.ring_args)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        plan, ring, arrays, use_kernel, pb = ctx.ring_args
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            gx = g if w is None else (g @ w.to(torch.float32).t())
            dx = _ring_backward(gx.contiguous(), plan, ring, arrays,
                                use_kernel).to(ctx.x_dtype)
        if w is not None and ctx.needs_input_grad[1]:
            ax = _ring_forward(x, None, *ctx.ring_args)
            dw = (ax.to(torch.float32).t() @ g).to(w.dtype)
        return dx, dw, None, None, None, None, None


def _ring_forward(x, update_w, plan, ring, arrays, use_kernel, pb):
    x = x.contiguous()
    gather = lambda bufs, grp: _gather_sum(bufs[0], grp, use_kernel, pb)
    return _ring_walk((x,), gather, x.shape[1], update_w, plan, ring, arrays,
                      use_kernel).to(x.dtype)


def _updater(update_w: Optional[torch.Tensor], d_feat: int):
    """(the per-partial update, the output width): ``partial @ W`` in full
    fp32 when an update is fused, else the identity."""
    if update_w is None:
        return (lambda partial: partial), d_feat
    w = update_w.to(torch.float32)
    return (lambda partial: partial @ w), int(w.shape[1])


def _work(out, bufs, grp: WorkGroup, gather, update, use_kernel) -> None:
    """One group's gather-sum (updated) added into ``out`` in order."""
    if grp.num_partitions:
        _segment_add(out, update(gather(bufs, grp)), grp, use_kernel)


def _ring_walk(tables, gather, d_feat, update_w, plan, ring, arrays,
               use_kernel) -> torch.Tensor:
    """The forward schedule over the row tables ``tables`` — ``(x,)``, or
    the compressed ``(values, ids)`` pair, which rotate together — with
    ``gather(bufs, grp)`` the group's gather-sum → ``(rows, d_out)``
    float32."""
    n_dev, dist, tile_rows = plan.n_dev, plan.dist, plan.tile_rows
    update, d_out = _updater(update_w, d_feat)
    out = torch.zeros((tables[0].shape[0], d_out), dtype=torch.float32,
                      device=tables[0].device)
    work = lambda bufs, grp: _work(out, bufs, grp, gather, update,
                                   use_kernel)
    if arrays.local is not None:
        # paper Fig. 9(b) baseline (or a single shard): local work up front
        work(tables, arrays.local)
    if n_dev == 1:
        return out

    tiles = tuple(t.view(n_dev, dist, tile_rows, t.shape[1]) for t in tables)
    bufs = _tile_buffers(tables, n_dev, tile_rows)
    # One double-buffered ring per tile chunk (chunk-major: every chunk
    # makes exactly n_dev - 1 rotations).
    for c in range(dist):
        _chunk_ring(tuple(t[:, c] for t in tiles), c, work, plan, ring,
                    arrays, bufs, tables)
    return out


def _tile_buffers(tables, n_dev, tile_rows):
    """The double buffer a ring rotates its tiles through."""
    cur = tuple(t.new_empty((n_dev, tile_rows, t.shape[1])) for t in tables)
    return cur, tuple(torch.empty_like(t) for t in cur)


def _chunk_ring(chunk, c, work, plan, ring, arrays, bufs,
                tables=None) -> None:
    """Chunk ``c``'s ring: its stacked tiles ``chunk`` (a tuple of
    ``(n_dev, tile_rows, ·)`` tensors that rotate together) make
    ``n_dev - 1`` rotations through the double buffer ``bufs``, and step
    ``k · dist + c`` runs ``work`` on the tile that just arrived, with the
    step's interleaved local slice of ``tables`` when the arrays have
    one."""
    n_dev, dist = plan.n_dev, plan.dist
    cur, nxt = bufs
    # rotation 1 (prologue)
    ring.wait(ring.rotate(chunk, cur))
    for k in range(n_dev - 1):
        step = k * dist + c
        # rotation k+2 is in flight while this step aggregates `cur`; the
        # last step (epilogue) has nothing left to rotate
        last = k == n_dev - 2
        token = None if last else ring.rotate(cur, nxt)
        work(tuple(t.view(-1, t.shape[2]) for t in cur),
             arrays.remote_steps[step])
        if arrays.local_steps:
            work(tables, arrays.local_steps[step])
        if not last:
            ring.wait(token)
            cur, nxt = nxt, cur


def _ring_backward(g, plan, ring, arrays, use_kernel) -> torch.Tensor:
    """``dx = Aᵀ g`` over the transposed ring.

    Step ``k`` of chunk ``c`` gathered from the chunk's tiles rotated
    ``k + 1`` shards forward, so its tile gradient goes ``k + 1`` shards
    back.  Walking the steps in reverse, each step's scatter-sum adds into
    one accumulator, which then rotates one shard back: after step 0 it
    holds ``Σ_k roll(d cur_k, -(k + 1))``, the chunk's gradient, with the
    same ``n_dev - 1`` rotations as the forward.  A rotation is in flight
    while the step's interleaved local slice scatters into ``dx``.
    """
    n_dev, dist, tile_rows = plan.n_dev, plan.dist, plan.tile_rows
    rows, d = g.shape
    dx = torch.zeros((rows, d), dtype=torch.float32, device=g.device)
    if arrays.local is not None:
        _scatter_sum(dx, g, arrays.local, use_kernel)
    if n_dev == 1:
        return dx

    dtiles = dx.view(n_dev, dist, tile_rows, d)
    acc = torch.empty((n_dev, tile_rows, d), dtype=torch.float32,
                      device=g.device)
    nxt = torch.empty_like(acc)
    for c in reversed(range(dist)):
        acc.zero_()
        for k in reversed(range(n_dev - 1)):
            step = k * dist + c
            _scatter_sum(acc.view(-1, d), g, arrays.remote_steps[step],
                         use_kernel)
            token = ring.rotate_back(acc, nxt)
            if arrays.local_steps:
                _scatter_sum(dx, g, arrays.local_steps[step], use_kernel)
            ring.wait(token)
            acc, nxt = nxt, acc
        dtiles[:, c] += acc
    return dx


def mgg_aggregate_sparse(
    x: torch.Tensor,
    plan: AggregationPlan,
    ring: VirtualRing,
    *,
    k: int,
    interleave: bool = True,
    use_kernel: bool = True,
    update_w: Optional[torch.Tensor] = None,
    arrays: Optional[RingArrays] = None,
) -> torch.Tensor:
    """Top-k compressed variant of :func:`mgg_aggregate`.

    ``x`` is compressed row-wise once (:func:`topk_activation`, ``k``
    clamped to ``D``; ids in :func:`wire_index_dtype`); the ring then
    rotates the ``(values, ids)`` pair, and every step runs the sparse
    gather-sum (K6) on the arriving tile before the same ordered segment
    add.  The schedule (chunk-major rings, interleaved local slices, fused
    ``·W``) is the dense one's, so at ``k == D`` the output is bitwise
    equal to :func:`mgg_aggregate`, and at ``k < D`` bitwise equal to it
    on ``topk_decompress(topk_activation(x, k))``.  There is no blocked
    (``pb``) variant.  Differentiable in ``x`` and ``update_w``: the
    backward ring carries ``k``-wide value gradients.
    """
    if ring.n_dev != plan.n_dev:
        raise ValueError(f"ring of {ring.n_dev} shards, plan for "
                         f"{plan.n_dev}")
    if x.shape[0] != plan.padded_nodes:
        raise ValueError(f"x has {x.shape[0]} rows, plan pads to "
                         f"{plan.padded_nodes}")
    if int(k) < 1:
        raise ValueError(f"k must be positive, got {k}")
    if arrays is None:
        arrays = plan_device_arrays(plan, interleave=interleave,
                                    device=x.device)
    elif arrays.interleave != bool(interleave):
        raise ValueError("arrays were built for another interleave flag")
    k = min(int(k), int(x.shape[1]))
    return _SparseRingAggregate.apply(x, update_w, k, plan, ring, arrays,
                                      use_kernel)


class _SparseRingAggregate(torch.autograd.Function):
    """The compressed ring as one differentiable op: compress, then
    :func:`_sparse_ring_forward`; backward :func:`_sparse_ring_backward`
    (the transposed ring over value gradients), then the scatter at the
    ids (the ids get no gradient)."""

    @staticmethod
    def forward(ctx, x, w, k, plan, ring, arrays, use_kernel):
        d_feat = x.shape[1]
        values, idx = topk_activation(x.contiguous(), k)
        idx = idx.to(wire_index_dtype(d_feat))
        ctx.save_for_backward(None if w is None else values, idx, w)
        ctx.ring_args = (plan, ring, arrays, use_kernel)
        ctx.x_dtype, ctx.d_feat = x.dtype, d_feat
        return _sparse_ring_forward(values, idx, d_feat, w,
                                    *ctx.ring_args).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        values, idx, w = ctx.saved_tensors
        d_feat = ctx.d_feat
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            gx = g if w is None else (g @ w.to(torch.float32).t())
            dv = _sparse_ring_backward(gx.contiguous(), idx, *ctx.ring_args)
            dx = torch.zeros((idx.shape[0], d_feat), dtype=torch.float32,
                             device=g.device)
            dx = dx.scatter_(1, idx.long(), dv).to(ctx.x_dtype)
        if w is not None and ctx.needs_input_grad[1]:
            ax = _sparse_ring_forward(values, idx, d_feat, None,
                                      *ctx.ring_args)
            dw = (ax.t() @ g).to(w.dtype)
        return dx, dw, None, None, None, None, None


def _sparse_ring_forward(values, idx, d_feat, update_w, plan, ring, arrays,
                         use_kernel) -> torch.Tensor:
    """The ring walk over the compressed pair, K6 each step → float32."""
    gather = lambda bufs, grp: ops.sparse_neighbor_gather_sum(
        *bufs, grp.nbrs, grp.mask, d_feat=d_feat, use_kernel=use_kernel)
    return _ring_walk((values, idx), gather, d_feat, update_w, plan, ring,
                      arrays, use_kernel)


def _sparse_ring_backward(g, idx, plan, ring, arrays,
                          use_kernel) -> torch.Tensor:
    """``d values`` (``(rows, k)`` float32) of the compressed ring.

    The transposed ring of :func:`_ring_backward` with ``k``-wide
    accumulators: step ``kk`` of chunk ``c`` runs the sparse gather-sum's
    backward (:func:`ops.sparse_gather_sum_grad`: K4 into the step tile's
    dense gradient, gathered at the step's id tile, which is the chunk's
    ids rotated ``kk + 1`` shards forward) and adds that into the
    accumulator, which then rotates one shard back — together with
    the id tile, so the next step finds its ids in place.  The local work
    scatters into one dense table, gathered at ``idx`` at the end.
    """
    n_dev, dist, tile_rows = plan.n_dev, plan.dist, plan.tile_rows
    rows, d = g.shape
    k = idx.shape[1]
    dense = torch.zeros((rows, d), dtype=torch.float32, device=g.device)
    if arrays.local is not None:
        _scatter_sum(dense, g, arrays.local, use_kernel)
    if n_dev == 1:
        return torch.gather(dense, 1, idx.long())

    dv = torch.empty((rows, k), dtype=torch.float32, device=g.device)
    dv_tiles = dv.view(n_dev, dist, tile_rows, k)
    i_tiles = idx.view(n_dev, dist, tile_rows, k)
    d_tile = torch.empty((n_dev * tile_rows, d), dtype=torch.float32,
                         device=g.device)
    acc = (dv.new_empty((n_dev, tile_rows, k)),
           idx.new_empty((n_dev, tile_rows, k)))
    nxt = (torch.empty_like(acc[0]), torch.empty_like(acc[1]))
    for c in reversed(range(dist)):
        acc[0].zero_()
        # the ids of step n_dev - 2: the chunk's, rotated n_dev - 1 forward
        ring.wait(ring.rotate_back(i_tiles[:, c], acc[1]))
        for kk in reversed(range(n_dev - 1)):
            step = kk * dist + c
            acc[0].view(-1, k).add_(ops.sparse_gather_sum_grad(
                g, acc[1].view(-1, k), arrays.remote_steps[step].grad,
                out=d_tile, use_kernel=use_kernel))
            # after step 0 only the accumulator has somewhere to go
            token = ring.rotate_back(acc, nxt) if kk \
                else ring.rotate_back(acc[0], nxt[0])
            if arrays.local_steps:
                _scatter_sum(dense, g, arrays.local_steps[step], use_kernel)
            ring.wait(token)
            acc, nxt = nxt, acc
        dv_tiles[:, c] = acc[0]
    return dv.add_(torch.gather(dense, 1, idx.long()))


def mgg_aggregate_streamed(
    fetch_chunk: Callable[[int], torch.Tensor],
    plan: AggregationPlan,
    ring: VirtualRing,
    *,
    use_kernel: bool = True,
    pb: Optional[int] = None,
    update_w: Optional[torch.Tensor] = None,
    arrays: Optional[RingArrays] = None,
    stats: Optional[dict] = None,
    tracer=None,
) -> torch.Tensor:
    """Pipelined aggregation over *partly resident* features.

    ``fetch_chunk(c)`` supplies ring chunk ``c`` on demand — the
    ``(n_dev · tile_rows, D)`` table of every shard's chunk-``c`` tile
    (:meth:`repro_torch.store.TieredFeatures.device_chunk`, which sources
    rows from the device hot cache or a host gather).  The schedule is the
    reference's double-buffered prefetch:

    1. fetch chunk 0 (the pipeline fill, the one fetch nothing hides);
    2. for each chunk ``c``: enqueue chunk ``c``'s remote ring (K1, or K2
       with ``pb``, and K3 each step; nothing in it waits for the device),
       then fetch chunk ``c + 1`` — its host gather and upload run while
       that ring is in flight;
    3. assemble the whole table from the chunks, run the local pass over
       it, and sum ``out = local + Σ_c ring_c`` in that fixed order, each
       ``ring_c`` its own fp32 accumulator.

    The result is deterministic and independent of where the rows came
    from: at any capacity, all-resident included, the output is bitwise
    the same.  Against :func:`mgg_aggregate` it differs only by the
    association of the sums.  There is no ``interleave`` knob: the local
    pass cannot start before the last chunk lands, and ``arrays`` must be
    the plan's arrays with ``interleave=False``
    (:meth:`GNNEngine.stream_arrays
    <repro_torch.core.gnn.GNNEngine.stream_arrays>`).  Built here when
    not given, their upload waits for the card: pass them to keep the
    fetches in flight.

    Forward only, as in the reference: a fused ``update_w`` or a chunk
    that requires grad raises.  ``stats`` (a dict) gains
    ``prefetch_issued`` (fetches issued while the previous chunk's ring
    was enqueued, ``dist - 1`` a call) and ``prefetch_inflight`` (those
    that returned while that ring's completion event still reported
    unfinished: on the CPU a ring runs before its call returns, so
    never).  ``tracer`` records ``mgg.stream.fetch`` / ``ring`` /
    ``local`` / ``drain`` spans and an ``mgg.stream.aggregate`` span whose
    ``overlap_efficiency`` is ``1 − (fill + drain) / total``; with it on,
    the drain waits for the card, which only moves when the host sees the
    end (also written to ``stats["overlap_efficiency"]``).
    """
    gather = lambda d_feat: lambda bufs, grp: _gather_sum(
        bufs[0], grp, use_kernel, pb)
    return _streamed(fetch_chunk, lambda chunk: (chunk,), gather, plan, ring,
                     update_w, arrays, use_kernel, stats, tracer, {})


def mgg_aggregate_sparse_streamed(
    fetch_chunk: Callable[[int], torch.Tensor],
    plan: AggregationPlan,
    ring: VirtualRing,
    *,
    k: int,
    use_kernel: bool = True,
    update_w: Optional[torch.Tensor] = None,
    arrays: Optional[RingArrays] = None,
    stats: Optional[dict] = None,
    tracer=None,
) -> torch.Tensor:
    """Top-k compressed variant of :func:`mgg_aggregate_streamed`.

    ``fetch_chunk`` keeps the dense contract; each chunk is compressed
    (:func:`topk_activation`, ``k`` clamped to ``D``, ids in
    :func:`wire_index_dtype`) right after it lands, so the rings carry the
    ``(values, ids)`` pair and every step runs K6.  The local pass runs
    over the assembled compressed table.  The sum order is the dense
    streamed path's, so at ``k == D`` the output is bitwise
    :func:`mgg_aggregate_streamed`'s at any capacity.  Forward only.
    """
    if int(k) < 1:
        raise ValueError(f"k must be positive, got {k}")

    def land(chunk):
        kk = min(int(k), int(chunk.shape[1]))
        values, idx = topk_activation(chunk, kk)
        return values, idx.to(wire_index_dtype(chunk.shape[1]))

    gather = lambda d_feat: lambda bufs, grp: ops.sparse_neighbor_gather_sum(
        *bufs, grp.nbrs, grp.mask, d_feat=d_feat, use_kernel=use_kernel)

    return _streamed(fetch_chunk, land, gather, plan, ring, update_w, arrays,
                     use_kernel, stats, tracer, {"sparse_k": int(k)})


def _streamed(fetch_chunk, land, make_gather, plan, ring, update_w, arrays,
              use_kernel, stats, tracer, span_args) -> torch.Tensor:
    """The streamed schedule; ``land(chunk)`` turns a fetched chunk into
    the tables its ring rotates, ``make_gather(d_feat)(bufs, grp)`` is a
    group's gather-sum over them."""
    n_dev, dist, tile_rows = plan.n_dev, plan.dist, plan.tile_rows
    rows = plan.padded_nodes
    if ring.n_dev != n_dev:
        raise ValueError(f"ring of {ring.n_dev} shards, plan for {n_dev}")
    if update_w is not None and update_w.requires_grad:
        raise ValueError("the streamed ring is forward only: update_w "
                         "requires grad")
    if arrays is None:
        arrays = plan_device_arrays(plan, interleave=False,
                                    device=ring.device)
    elif arrays.interleave:
        raise ValueError("the streamed ring takes arrays built with "
                         "interleave=False")
    if stats is not None:
        stats.setdefault("prefetch_issued", 0)
        stats.setdefault("prefetch_inflight", 0)
    tracing = tracer is not None and tracer.enabled
    on_card = ring.device.type == "cuda"

    def fetch(c):
        chunk = fetch_chunk(c)
        if chunk.requires_grad:
            raise ValueError("the streamed ring is forward only: chunk "
                             f"{c} requires grad")
        if chunk.shape[0] != n_dev * tile_rows:
            raise ValueError(f"chunk {c} has {chunk.shape[0]} rows, the "
                             f"plan's chunks {n_dev * tile_rows}")
        return land(chunk.contiguous()), int(chunk.shape[1]), chunk.dtype

    if tracing:
        t_start = tracer.now()
    cur, d_feat, dtype = fetch(0)           # pipeline fill (not hidden)
    if tracing:
        t_fill = tracer.now() - t_start
        tracer.complete("mgg.stream.fetch", t_start, t_start + t_fill,
                        cat="mgg", args={"chunk": 0, "fill": True})
    gather = make_gather(d_feat)
    update, d_out = _updater(update_w, d_feat)
    chunks, partials, bufs = [], [], None
    for c in range(dist):
        chunks.append(cur)
        done = None
        if n_dev > 1:
            if bufs is None:
                bufs = _tile_buffers(cur, n_dev, tile_rows)
            with tracer.span("mgg.stream.ring", cat="mgg", chunk=c,
                             dist=dist, n_dev=n_dev, **span_args) \
                    if tracing else _NO_SPAN:
                part = torch.zeros((rows, d_out), dtype=torch.float32,
                                   device=ring.device)
                work = lambda bufs_, grp, part=part: _work(
                    part, bufs_, grp, gather, update, use_kernel)
                _chunk_ring(tuple(t.view(n_dev, tile_rows, t.shape[1])
                                  for t in cur), c, work, plan, ring, arrays,
                            bufs)
                partials.append(part)
            if on_card:
                done = torch.cuda.Event()
                done.record()
        if c + 1 < dist:
            # host gather + upload of chunk c+1 while ring c is in flight
            with tracer.span("mgg.stream.fetch", cat="mgg", chunk=c + 1,
                             fill=False) if tracing else _NO_SPAN:
                cur = fetch(c + 1)[0]
            if stats is not None:
                stats["prefetch_issued"] += 1
                if done is not None and not done.query():
                    stats["prefetch_inflight"] += 1

    # the whole table, chunk-minor → row-major per shard
    full = tuple(torch.stack([ch[i].view(n_dev, tile_rows, -1)
                              for ch in chunks], dim=1).view(rows, -1)
                 for i in range(len(chunks[0])))
    with tracer.span("mgg.stream.local", cat="mgg", dist=dist) \
            if tracing else _NO_SPAN:
        out = torch.zeros((rows, d_out), dtype=torch.float32,
                          device=ring.device)
        _work(out, full, arrays.local, gather, update, use_kernel)
        for part in partials:               # fixed order ⇒ deterministic
            out.add_(part)
        out = out.to(dtype)
    if tracing:
        # drain: the wait nothing overlaps; it changes when the host sees
        # the end, never the values
        t0 = tracer.now()
        if on_card:
            torch.cuda.synchronize(ring.device)
        t_drain = tracer.now() - t0
        tracer.complete("mgg.stream.drain", t0, t0 + t_drain, cat="mgg")
        total = tracer.now() - t_start
        exposed = t_fill + t_drain
        overlap = max(0.0, 1.0 - exposed / total) if total > 0 else 0.0
        tracer.complete("mgg.stream.aggregate", t_start, t_start + total,
                        cat="mgg",
                        args=dict(dist=dist, n_dev=n_dev,
                                  overlap_efficiency=overlap,
                                  exposed_s=exposed, total_s=total,
                                  **span_args))
        if stats is not None:
            stats["overlap_efficiency"] = overlap
    return out


_NO_SPAN = contextlib.nullcontext()


def block_neighbor_sum(h_src: torch.Tensor, nbr: torch.Tensor,
                       mask: torch.Tensor, *,
                       grad_index: Optional[GradIndex] = None,
                       use_kernel: bool = True) -> torch.Tensor:
    """Masked neighbor sum over one sampled block → ``(num_dst, D)``.

    ``h_src`` is the block's source table; ``nbr``/``mask`` are the
    ``(num_dst, fanout)`` tables of :mod:`repro_torch.sample`, whose
    padding slots point at local row ``num_src`` — a zero sentinel row
    appended here — so the sampled path rides the ring's gather-sum (K1)
    and its K4 backward (``grad_index``, from ``block_tree``).  No masked
    slot points at the sentinel, so it gets no gradient.
    """
    sentinel = h_src.new_zeros((1, h_src.shape[1]))
    buf = torch.cat([h_src, sentinel], dim=0)
    return ops.neighbor_gather_sum(buf, nbr, mask, grad_index=grad_index,
                                   use_kernel=use_kernel).to(h_src.dtype)


# ---------------------------------------------------------------------------
# Baseline 1: bulk all-gather + local aggregation (DGCL / NCCL pattern)
# ---------------------------------------------------------------------------

def _shard_group(nbrs: np.ndarray, mask: np.ndarray, targets: np.ndarray,
                 device) -> WorkGroup:
    """One shard's partitions of a baseline plan, without the SPMD padding
    (all-masked partitions, which only add zero rows)."""
    keep = np.asarray(mask, bool).any(-1)
    return WorkGroup.build(np.asarray(nbrs)[keep], np.asarray(mask)[keep],
                           np.asarray(targets)[keep], device)


def bulk_groups(bulk_nbrs: np.ndarray, bulk_mask: np.ndarray,
                bulk_targets: np.ndarray, device) -> Tuple[WorkGroup, ...]:
    """The per-shard :class:`WorkGroup`\\ s of a
    :func:`~repro_torch.core.placement.build_bulk_plan` (host-side, once
    per plan): each shard's partitions name rows of the whole padded
    table and target rows of its own shard."""
    return tuple(_shard_group(bulk_nbrs[d], bulk_mask[d], bulk_targets[d],
                              device) for d in range(bulk_nbrs.shape[0]))


def _aggregate_into(out, buf, grp: WorkGroup, use_kernel: bool) -> None:
    """One shard's gather-sum (K1) over ``buf`` added into its rows
    ``out`` in order (K3)."""
    if grp.num_partitions:
        _segment_add(out, _gather_sum(buf, grp, use_kernel, None), grp,
                     use_kernel)


def bulk_aggregate(
    x: torch.Tensor,
    bulk_nbrs: np.ndarray,     # (n_dev, P, ps) offsets into the padded table
    bulk_mask: np.ndarray,
    bulk_targets: np.ndarray,  # (n_dev, P)
    rows_per_dev: int,
    ring: VirtualRing,
    *,
    use_kernel: bool = True,
    groups: Optional[Tuple[WorkGroup, ...]] = None,
) -> torch.Tensor:
    """All-gather the entire table first, aggregate second (no overlap).

    On the virtual ring the stacked table ``x`` (``(n_dev · rows_per_dev,
    D)``) already is the all-gathered one, so shard ``d``'s gather-sum
    (K1) reads it directly and its ordered segment add (K3) writes its own
    rows.  Returns the padded table in ``x``'s dtype.  ``groups`` is
    :func:`bulk_groups` of the plan (built here when not given).
    """
    n_dev, rows = ring.n_dev, int(rows_per_dev)
    if bulk_nbrs.shape[0] != n_dev:
        raise ValueError(f"ring of {n_dev} shards, plan for "
                         f"{bulk_nbrs.shape[0]}")
    if x.shape[0] != n_dev * rows:
        raise ValueError(f"x has {x.shape[0]} rows, the plan pads to "
                         f"{n_dev * rows}")
    x = x.contiguous()
    if groups is None:
        groups = bulk_groups(bulk_nbrs, bulk_mask, bulk_targets, x.device)
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for d, grp in enumerate(groups):
        _aggregate_into(out[d * rows:(d + 1) * rows], x, grp, use_kernel)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Baseline 2: fetch-then-aggregate with a granularity knob (UVM / Direct)
# ---------------------------------------------------------------------------

def fetch_groups(fetch_rows: np.ndarray, nbrs: np.ndarray, mask: np.ndarray,
                 targets: np.ndarray, device
                 ) -> Tuple[Tuple[torch.Tensor, WorkGroup], ...]:
    """Each shard's row ids to fetch (int32, on ``device``) and the
    :class:`WorkGroup` over its fetched buffer, of a
    :func:`~repro_torch.core.placement.build_fetch_plan` (host-side, once
    per plan)."""
    return tuple(
        (torch.from_numpy(np.ascontiguousarray(fetch_rows[d], np.int32)).to(
            device), _shard_group(nbrs[d], mask[d], targets[d], device))
        for d in range(fetch_rows.shape[0]))


def fetch_rows_aggregate(
    x: torch.Tensor,
    fetch_rows: np.ndarray,   # (n_dev, F) padded-global row ids to fetch
    nbrs: np.ndarray,         # (n_dev, P, ps) offsets into the fetched buffer
    mask: np.ndarray,
    targets: np.ndarray,      # (n_dev, P)
    out_rows: int,
    *,
    use_kernel: bool = True,
    groups: Optional[Tuple[Tuple[torch.Tensor, WorkGroup], ...]] = None,
) -> torch.Tensor:
    """Gather ``fetch_rows`` from the global table, then aggregate locally.

    Per shard: the row gather (K5) of its ``F`` fetched rows from the
    padded table ``x``, the gather-sum (K1) over that buffer and the
    ordered segment add (K3) into its ``out_rows`` rows.  With exact rows
    this is the Direct-NVSHMEM pattern of the paper's Table 1; with
    page-expanded rows the UVM pattern of its §2.2 — the gather volume,
    not the aggregation, changes.  Returns ``(n_dev, out_rows, D)`` in
    ``x``'s dtype.  ``groups`` is :func:`fetch_groups` of the plan (built
    here when not given).
    """
    n_dev = fetch_rows.shape[0]
    x = x.contiguous()
    if groups is None:
        groups = fetch_groups(fetch_rows, nbrs, mask, targets, x.device)
    elif len(groups) != n_dev:
        raise ValueError(f"{len(groups)} groups given, the plan has "
                         f"{n_dev} shards")
    out = torch.zeros((n_dev, int(out_rows), x.shape[1]),
                      dtype=torch.float32, device=x.device)
    fetch = ops.gather_rows if use_kernel else ref.gather_rows_ref
    for d, (ids, grp) in enumerate(groups):
        _aggregate_into(out[d], fetch(x, ids), grp, use_kernel)
    return out.to(x.dtype)


def reference_aggregate(indptr: np.ndarray, indices: np.ndarray,
                        x: np.ndarray) -> np.ndarray:
    """Dense oracle: ``out[v] = Σ_{u ∈ N(v)} x[u]`` (float64 accumulation)."""
    out = np.zeros_like(x, dtype=np.float64)
    deg = np.diff(indptr)
    row_ids = np.repeat(np.arange(x.shape[0]), deg)
    np.add.at(out, row_ids, x[indices].astype(np.float64))
    return out.astype(x.dtype)
