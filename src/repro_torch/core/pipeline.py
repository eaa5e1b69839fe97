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

The bulk, fetch and streamed variants come in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..dist.ring import VirtualRing
from ..kernels import ops, ref
from ..kernels.ops import GradIndex, SegmentChunks
from .placement import AggregationPlan

__all__ = ["WorkGroup", "RingArrays", "plan_device_arrays", "mgg_aggregate",
           "mgg_aggregate_sparse", "block_neighbor_sum", "reference_aggregate",
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


def _ring_walk(tables, gather, d_feat, update_w, plan, ring, arrays,
               use_kernel) -> torch.Tensor:
    """The forward schedule over the row tables ``tables`` — ``(x,)``, or
    the compressed ``(values, ids)`` pair, which rotate together — with
    ``gather(bufs, grp)`` the group's gather-sum → ``(rows, d_out)``
    float32."""
    n_dev, dist, tile_rows = plan.n_dev, plan.dist, plan.tile_rows
    rows = tables[0].shape[0]
    update: Callable[[torch.Tensor], torch.Tensor]
    if update_w is not None:
        w = update_w.to(torch.float32)
        d_out = w.shape[1]
        update = lambda partial: partial @ w
    else:
        d_out = d_feat
        update = lambda partial: partial
    out = torch.zeros((rows, d_out), dtype=torch.float32,
                      device=tables[0].device)

    def work(bufs, grp: WorkGroup) -> None:
        if grp.num_partitions:
            _segment_add(out, update(gather(bufs, grp)), grp, use_kernel)

    if arrays.local is not None:
        # paper Fig. 9(b) baseline (or a single shard): local work up front
        work(tables, arrays.local)
    if n_dev == 1:
        return out

    tiles = tuple(t.view(n_dev, dist, tile_rows, t.shape[1]) for t in tables)
    cur = tuple(t.new_empty((n_dev, tile_rows, t.shape[1])) for t in tables)
    nxt = tuple(torch.empty_like(t) for t in cur)
    # One double-buffered ring per tile chunk (chunk-major: every chunk
    # makes exactly n_dev - 1 rotations).
    for c in range(dist):
        # rotation 1 (prologue)
        ring.wait(ring.rotate(tuple(t[:, c] for t in tiles), cur))
        for k in range(n_dev - 1):
            step = k * dist + c
            # rotation k+2 is in flight while this step aggregates `cur`;
            # the last step (epilogue) has nothing left to rotate
            last = k == n_dev - 2
            token = None if last else ring.rotate(cur, nxt)
            work(tuple(t.view(-1, t.shape[2]) for t in cur),
                 arrays.remote_steps[step])
            if arrays.local_steps:
                work(tables, arrays.local_steps[step])
            if not last:
                ring.wait(token)
                cur, nxt = nxt, cur
    return out


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


def reference_aggregate(indptr: np.ndarray, indices: np.ndarray,
                        x: np.ndarray) -> np.ndarray:
    """Dense oracle: ``out[v] = Σ_{u ∈ N(v)} x[u]`` (float64 accumulation)."""
    out = np.zeros_like(x, dtype=np.float64)
    deg = np.diff(indptr)
    row_ids = np.repeat(np.arange(x.shape[0]), deg)
    np.add.at(out, row_ids, x[indices].astype(np.float64))
    return out.astype(x.dtype)
