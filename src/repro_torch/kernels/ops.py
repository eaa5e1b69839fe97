"""Front door to the port's kernels (counterpart of ``repro/kernels/ops.py``).

A CPU tensor takes the plain version (kernels/ref.py); a CUDA tensor takes
a kernel, with no fallback; any other device raises.  The TPU wrapper's
128-lane column padding and ``db ≤ 1024`` block choice were layout rules
of the TPU: the CUDA kernels take any width ``D`` as it is.  Its VMEM rule
(``ops.py:192``: a blocked stripe that does not fit runs pipelined) becomes
the shared-memory and block-size rule of :func:`neighbor_agg.blocked_fits`.

The reference's ``jax.custom_vjp`` around the gather-sum
(``repro/kernels/ops.py:45-85``) is :class:`_GatherSum`, an
``autograd.Function``: K1/K2 forward, K4 backward.  Its backward is the
masked scatter-add ``dbuf[nbrs[p, j]] += g[p]``; to add without atomics,
it reads a :class:`GradIndex` built on the host once per plan or block.
The sparse gather-sum over top-k compressed rows (K6 forward) has the
same backward followed by a column gather at the ids
(:func:`sparse_gather_sum_grad`, the reference's ``ops.py:112-120``),
which :class:`_SparseGatherSum` and the compressed ring's backward share.
:func:`flash_attention` routes the LM's cache-less attention to K7, and
:func:`slstm_scan` the xLSTM's sLSTM recurrence to K8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import flash_attention as _flash
from . import neighbor_agg, ref, rows
from . import slstm_scan as _slstm

__all__ = ["GradIndex", "GRAD_CHUNK", "neighbor_gather_sum",
           "sparse_neighbor_gather_sum", "sparse_gather_sum_grad",
           "segment_add_ordered",
           "scatter_sum_ordered", "gather_rows", "flash_attention",
           "slstm_scan"]

# Longest run of slots one thread adds in a row: a longer segment (a hub
# neighbor) is cut into chunks of this many slots, summed in two passes.
GRAD_CHUNK = 256


def _route(t: torch.Tensor, what: str = "gather-sum") -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {t.device}")
    return t.device.type


def _segments(keys_sorted: np.ndarray):
    """Distinct values of a sorted key array and their offsets."""
    if keys_sorted.size == 0:
        return keys_sorted[:0], np.zeros(1, np.int64)
    head = np.ones(keys_sorted.size, bool)
    head[1:] = keys_sorted[1:] != keys_sorted[:-1]
    starts = np.nonzero(head)[0]
    return keys_sorted[starts], np.append(starts, keys_sorted.size)


@dataclasses.dataclass(frozen=True)
class GradIndex:
    """The transposed index of one gather-sum, for its backward (K4).

    The masked slots ``(p, j)`` sorted stably by neighbor row
    ``nbrs[p, j]``: ``rows`` are the distinct neighbor rows, ``start`` the
    segment offsets, and ``src[k]`` the row of the incoming gradient that
    slot ``k`` reads — ``p`` for a plain gather-sum, or the partition's
    target row when the sum feeds the ring's segment add (the host composes
    the two, so the backward never forms the per-partition gradient).
    Masked slots are not in it: they get and leak no gradient.

    When a segment is longer than :data:`GRAD_CHUNK` slots, every segment
    is cut into chunks of at most that many (``chunk_start``, offsets into
    ``src``; ``row_chunks``, each row's chunks): the backward sums each
    chunk in slot order, then adds each row's chunk sums in chunk order.
    That association is a function of the index alone, so the sums are
    the same bits from run to run, on the card and in the plain version.
    """

    src: torch.Tensor    # (K,) int32
    rows: torch.Tensor   # (S,) int32, ascending
    start: torch.Tensor  # (S + 1,) int32
    chunk_start: Optional[torch.Tensor] = None  # (C + 1,) int32
    row_chunks: Optional[torch.Tensor] = None   # (S + 1,) int32

    @property
    def num_slots(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_chunks(self) -> int:
        return 0 if self.chunk_start is None \
            else int(self.chunk_start.shape[0]) - 1

    @staticmethod
    def build(nbrs: np.ndarray, mask: np.ndarray,
              src_rows: Optional[np.ndarray] = None,
              device="cpu") -> "GradIndex":
        nbrs = np.asarray(nbrs)
        mask = np.asarray(mask, bool)
        p, ps = nbrs.shape
        slot = np.flatnonzero(mask.ravel())
        nb = nbrs.ravel()[slot].astype(np.int64)
        part = slot // max(ps, 1)
        src = part if src_rows is None else np.asarray(src_rows)[part]
        order = np.argsort(nb, kind="stable")
        seg_rows, seg_start = _segments(nb[order])

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                device)

        chunks = {}
        lens = np.diff(seg_start)
        if lens.size and lens.max() > GRAD_CHUNK:
            per_row = -(-lens // GRAD_CHUNK)
            row_chunks = np.zeros(lens.size + 1, np.int64)
            np.cumsum(per_row, out=row_chunks[1:])
            owner = np.repeat(np.arange(lens.size), per_row)
            j = np.arange(row_chunks[-1]) - row_chunks[owner]
            chunks = dict(
                chunk_start=t(np.append(seg_start[owner] + GRAD_CHUNK * j,
                                        seg_start[-1])),
                row_chunks=t(row_chunks))
        return GradIndex(src=t(src[order]), rows=t(seg_rows),
                         start=t(seg_start), **chunks)


class _GatherSum(torch.autograd.Function):
    """``out[p] = Σ_j mask[p, j] · buf[nbrs[p, j]]`` with a K4 backward."""

    @staticmethod
    def forward(ctx, buf, nbrs, mask, index, pb, use_kernel):
        ctx.index, ctx.rows, ctx.use_kernel = index, buf.shape[0], use_kernel
        return _gather_sum_fwd(buf, nbrs, mask, pb, use_kernel)

    @staticmethod
    def backward(ctx, g):
        idx = ctx.index
        dbuf = torch.zeros((ctx.rows, g.shape[1]), dtype=torch.float32,
                           device=g.device)
        scatter = scatter_sum_ordered if ctx.use_kernel \
            else ref.scatter_sum_ordered_ref
        scatter(dbuf, g.contiguous(), idx)
        return dbuf, None, None, None, None, None


def _gather_sum_fwd(buf, nbrs, mask, pb, use_kernel):
    if not use_kernel or _route(buf) == "cpu":
        return ref.neighbor_gather_sum_ref(buf, nbrs, mask)
    if pb is not None and not neighbor_agg.blocked_fits(pb, nbrs.shape[1]):
        pb = None
    if pb is None:
        return neighbor_agg.gather_sum_pipelined(buf, nbrs, mask)
    return neighbor_agg.gather_sum_blocked(buf, nbrs, mask, pb=pb)


def neighbor_gather_sum(buf: torch.Tensor, nbrs: torch.Tensor,
                        mask: torch.Tensor, *,
                        pb: Optional[int] = None,
                        grad_index: Optional[GradIndex] = None,
                        use_kernel: bool = True) -> torch.Tensor:
    """``out[p] = Σ_j mask[p, j] · buf[nbrs[p, j]]`` → (P, D) float32.

    ``pb=None`` selects the pipelined kernel (K1); an integer selects the
    partition-blocked kernel (K2) with that many warps per block, unless
    the block would not fit (then K1, as the reference falls back when
    its VMEM stripe does not fit).  A ``buf`` that needs a gradient needs
    ``grad_index`` (its backward runs K4).  ``use_kernel=False`` runs the
    plain versions on any device, forward and backward.
    """
    if grad_index is None:
        if buf.requires_grad and torch.is_grad_enabled():
            raise ValueError("a gather-sum whose input needs a gradient "
                             "needs its grad_index")
        return _gather_sum_fwd(buf, nbrs, mask, pb, use_kernel)
    return _GatherSum.apply(buf, nbrs, mask, grad_index, pb, use_kernel)


class _SparseGatherSum(torch.autograd.Function):
    """``out[p] = Σ_j mask[p, j] · decompress(values, idx)[nbrs[p, j]]``;
    backward: K4 into the dense ``(T, D)`` gradient, then each row's ``k``
    live columns gathered at ``idx``.  The ids get no gradient."""

    @staticmethod
    def forward(ctx, values, idx, nbrs, mask, d_feat, index, use_kernel):
        ctx.save_for_backward(idx)
        ctx.index, ctx.use_kernel = index, use_kernel
        return _sparse_gather_sum_fwd(values, idx, nbrs, mask, d_feat,
                                      use_kernel)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        dval = sparse_gather_sum_grad(g.contiguous(), idx, ctx.index,
                                      use_kernel=ctx.use_kernel)
        return dval, None, None, None, None, None, None


def sparse_gather_sum_grad(g: torch.Tensor, idx: torch.Tensor,
                           index: GradIndex, *,
                           out: Optional[torch.Tensor] = None,
                           use_kernel: bool = True) -> torch.Tensor:
    """``d values`` of the sparse gather-sum → ``(T, k)`` float32: K4
    scatter-sums ``g`` into the dense ``(T, D)`` gradient ``out`` (zeroed
    here; a new one when ``None``), whose ``k`` live columns of each row
    are then gathered at ``idx`` (the reference's ``ops.py:112-120``).
    The compressed ring's backward runs it once a step."""
    if out is None:
        out = torch.zeros((idx.shape[0], g.shape[1]), dtype=torch.float32,
                          device=g.device)
    else:
        out.zero_()
    if index.num_slots:
        scatter = scatter_sum_ordered if use_kernel \
            else ref.scatter_sum_ordered_ref
        scatter(out, g, index)
    return torch.gather(out, 1, idx.long())


def _sparse_gather_sum_fwd(values, idx, nbrs, mask, d_feat, use_kernel):
    if not use_kernel or _route(values) == "cpu":
        return ref.sparse_gather_sum_ref(values, idx, nbrs, mask, d_feat)
    return neighbor_agg.sparse_gather_sum(values, idx, nbrs, mask, d_feat)


def sparse_neighbor_gather_sum(values: torch.Tensor, idx: torch.Tensor,
                               nbrs: torch.Tensor, mask: torch.Tensor, *,
                               d_feat: int,
                               grad_index: Optional[GradIndex] = None,
                               use_kernel: bool = True) -> torch.Tensor:
    """``out[p] = Σ_j mask[p, j] · decompress(values, idx)[nbrs[p, j]]`` →
    (P, d_feat) float32, over ``(T, k)`` top-k compressed rows whose ids
    travel as int16 (or int32).  K6 on the card; the plain version
    decompresses and runs the dense gather-sum.  ``values`` that need a
    gradient need ``grad_index`` (the backward runs K4, then a column
    gather).  There is no blocked (``pb``) variant, as in the reference.
    """
    if grad_index is None:
        if values.requires_grad and torch.is_grad_enabled():
            raise ValueError("a sparse gather-sum whose values need a "
                             "gradient needs its grad_index")
        return _sparse_gather_sum_fwd(values, idx, nbrs, mask, d_feat,
                                      use_kernel)
    return _SparseGatherSum.apply(values, idx, nbrs, mask, d_feat,
                                  grad_index, use_kernel)


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


def scatter_sum_ordered(dbuf: torch.Tensor, g: torch.Tensor,
                        index: GradIndex) -> torch.Tensor:
    """In place ``dbuf[index.rows[s]] += Σ g[index.src[k]]`` over segment
    ``s`` in the index's fixed order, the gather-sum's backward (K4 on the
    card)."""
    if _route(dbuf) == "cpu":
        return ref.scatter_sum_ordered_ref(dbuf, g, index)
    return neighbor_agg.scatter_sum_ordered(dbuf, g, index)


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` (K5 on the card), bitwise the rows of
    ``src``; the tiered store's assembly."""
    if _route(src, "row gather") == "cpu":
        return ref.gather_rows_ref(src, idx)
    return rows.gather_rows(src, idx)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal / sliding-window GQA softmax attention in the model's
    ``(B, S, H, hd)`` layout (K7 on the card, forward only: a tensor that
    needs a gradient is refused there)."""
    if _route(q, "flash attention") == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def slstm_scan(xp: torch.Tensor, wr: torch.Tensor, state: dict):
    """The sLSTM recurrence over a sequence (``ref.slstm_scan_ref``'s
    contract): the plain loop on the CPU, K8 on the card."""
    if _route(xp, "sLSTM scan") == "cpu":
        return ref.slstm_scan_ref(xp, wr, state)
    return _slstm.slstm_scan(xp, wr, state)
