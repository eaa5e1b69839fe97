"""Ring-pipelined collectives over a :class:`~repro_torch.dist.mesh.VirtualMesh`
(counterpart of ``repro/dist/collectives.py``).

MGG's observation (§3.3–3.4): a bulk collective serializes communication
before computation, while cutting the transfer into ring steps lets each
step's copy overlap the previous step's compute.  These functions keep the
reference's schedule step for step: each ring step *issues the next
transfer before consuming the current block*, so on the card the copy (on
the mesh's side stream) and the product (on the current stream) run
together.

Every function takes the stacked blocks of all shards (leading dims the
mesh's, in ``axis_names`` order; see ``dist/mesh.py``) and the name of the
axis it runs along; a step's products over all shards are one batched
``torch.matmul``.  A 1-sized axis degenerates to the local computation (no
transfers), as in the reference.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = [
    "ring_allgather_matmul",
    "matmul_reducescatter",
    "pipelined_all_to_all",
]


def _stacked(rhs: torch.Tensor, lead) -> torch.Tensor:
    """``rhs`` broadcast to every shard and made contiguous once, so each
    step's batched product reads it without a copy."""
    return torch.broadcast_to(rhs, tuple(lead) + rhs.shape[-2:]).contiguous()


def _per_shard(t: torch.Tensor, a: int, lead: int, ar, pick):
    """Along mesh dim ``a`` shard ``i`` takes entry ``pick[i]`` of the dim
    just after the mesh dims: ``(*mesh, n, ...)`` → ``(*mesh, ...)``."""
    idx = (ar,) + (slice(None),) * (lead - 1) + (pick,)
    return t.movedim(a, 0)[idx].movedim(0, a)


def ring_allgather_matmul(lhs: torch.Tensor, rhs: torch.Tensor, mesh,
                          axis_name: str) -> torch.Tensor:
    """``concat_gather(lhs) @ rhs`` without materializing the gather.

    ``lhs``: every shard's ``(m, k)`` row block, ``(*mesh, m, k)``;
    ``rhs``: ``(k, n)`` blocks broadcastable to ``(*mesh, k, n)``.  Returns
    ``(*mesh, axis_size * m, n)``: every shard's full product along the
    axis.  Row block ``j`` is multiplied the moment it arrives while the
    next is in flight; block ``(idx - step) % n`` lands at its rows.
    """
    a, n_dev, lead = mesh.axis(axis_name), mesh.shape[axis_name], mesh.ndim
    if n_dev == 1:
        return torch.matmul(lhs, rhs)
    rhs = _stacked(rhs, lhs.shape[:lead])
    prods = []
    cur, token = lhs.contiguous(), None
    for step in range(n_dev):
        # issue rotation step+1 BEFORE the product on `cur`: no data
        # dependence between them, so the copy overlaps the product
        nxt = mesh.permute(cur, axis_name) if step < n_dev - 1 else None
        mesh.wait(token)
        with mesh.span("matmul"):
            prods.append(torch.matmul(cur, rhs))
        if nxt is not None:
            cur, token = nxt
    # at step s shard i held the block of shard (i - s) % n: row block b
    # of shard i is the product of step (i - b) % n
    ring = mesh.ring_index(axis_name)               # [off][i] = (i+off) % n
    step_of = ring[(n_dev - ring[0]) % n_dev]       # [b][i] = (i - b) % n
    shape = [1] * (lead + 3)
    shape[a], shape[lead] = n_dev, n_dev
    idx = step_of.t().reshape(shape)
    return torch.take_along_dim(torch.stack(prods, lead), idx,
                                dim=lead).flatten(lead, lead + 1)


def matmul_reducescatter(lhs: torch.Tensor, rhs: torch.Tensor, mesh,
                         axis_name: str) -> torch.Tensor:
    """``reduce_scatter(lhs @ rhs)`` fused into a pipelined ring.

    ``lhs``: ``(*mesh, m, k_local)``, every shard's full row range with its
    slice of the contraction dim; ``rhs``: ``(k_local, n)`` blocks
    broadcastable to ``(*mesh, k_local, n)``.  Shard ``i`` gets rows
    ``[i*c, (i+1)*c)`` of the summed product, ``c = ceil(m / axis_size)``
    (rows zero-padded up to ``axis_size * c``): ``(*mesh, c, n)``.  The
    accumulator for block ``b`` starts at shard ``b + 1`` and travels the
    ring while each shard computes its partial for the block it will add.
    """
    a, n_dev, lead = mesh.axis(axis_name), mesh.shape[axis_name], mesh.ndim
    if n_dev == 1:
        return torch.matmul(lhs, rhs)
    m = lhs.shape[-2]
    chunk = -(-m // n_dev)
    if chunk * n_dev != m:
        lhs = F.pad(lhs, (0, 0, 0, chunk * n_dev - m))
    rhs = _stacked(rhs, lhs.shape[:lead])
    blocks = lhs.unflatten(-2, (n_dev, chunk))
    ring = mesh.ring_index(axis_name)               # [off][i] = (i+off) % n

    def partial_block(off):
        rows = _per_shard(blocks, a, lead, ring[0], ring[off])
        with mesh.span("matmul"):
            return torch.matmul(rows, rhs)

    # at hop `step` shard `idx` holds the accumulator for block
    # (idx - 1 - step) and adds its own partial for it, computed while the
    # accumulator was in flight
    acc = partial_block(n_dev - 1)
    for step in range(1, n_dev):
        moved, token = mesh.permute(acc, axis_name)
        nxt_partial = partial_block(n_dev - 1 - step)
        mesh.wait(token)
        acc = moved + nxt_partial
    return acc


def pipelined_all_to_all(
    x: torch.Tensor,
    mesh,
    axis_name: str,
    fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    split_axis: int,
    concat_axis: int,
    chunk_axis: int,
    chunks: int,
) -> torch.Tensor:
    """all_to_all → ``fn`` → inverse all_to_all, pipelined chunkwise.

    ``x``: every shard's block stacked, ``(*mesh, ...)``; the axes count
    within a block, and ``fn`` maps stacked blocks to stacked blocks (every
    shard's at once).  ``x`` is cut into ``chunks`` pieces along
    ``chunk_axis`` at ``(i * size) // chunks``; while ``fn`` runs on piece
    *i*, piece *i+1*'s exchange is already enqueued.  ``chunks`` is clamped
    to the chunk axis's extent; a piece's ``split_axis`` extent must be
    divisible by the axis size.
    """
    n_dev, lead = mesh.shape[axis_name], mesh.ndim
    nb = x.dim() - lead
    split_axis, concat_axis, chunk_axis = (
        ax % nb for ax in (split_axis, concat_axis, chunk_axis))

    def dispatch(p):
        return mesh.all_to_all(p, axis_name, split_axis, concat_axis)

    def combine(p):
        return mesh.all_to_all(p, axis_name, concat_axis, split_axis)

    size = x.shape[lead + chunk_axis]
    if size == 0:  # empty block: un-pipelined path (zero pieces to overlap)
        if n_dev == 1:
            return fn(x)
        y, token = dispatch(x)
        mesh.wait(token)
        z, token = combine(fn(y))
        mesh.wait(token)
        return z
    chunks = max(1, min(int(chunks), size))
    bounds = [(i * size) // chunks for i in range(chunks + 1)]
    pieces = [x.narrow(lead + chunk_axis, lo, hi - lo)
              for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    if n_dev > 1:
        bad = [p.shape[lead + split_axis] for p in pieces
               if p.shape[lead + split_axis] % n_dev != 0]
        if bad:
            raise ValueError(
                f"pipelined_all_to_all: split_axis={split_axis} extents "
                f"{bad} not divisible by axis {axis_name!r} size {n_dev} "
                f"(chunk_axis={chunk_axis}, chunks={chunks} cut into the "
                f"split dim?)")
    if n_dev == 1:
        outs = [fn(p) for p in pieces]
        return outs[0] if len(outs) == 1 \
            else torch.cat(outs, lead + chunk_axis)

    outs = []
    in_flight = dispatch(pieces[0])
    for i in range(len(pieces)):
        cur, token = in_flight
        if i + 1 < len(pieces):
            # the next piece's dispatch is independent of fn(cur): it
            # overlaps it
            in_flight = dispatch(pieces[i + 1])
        mesh.wait(token)
        outs.append(combine(fn(cur)))
    for _, token in outs:
        mesh.wait(token)
    outs = [y for y, _ in outs]
    return outs[0] if len(outs) == 1 else torch.cat(outs, lead + chunk_axis)
