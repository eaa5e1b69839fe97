"""Thin wrappers around the CUDA gather-sum kernels (``csrc/gather_sum.cu``,
``csrc/sparse_gather_sum.cu``).

Counterpart of ``repro/kernels/neighbor_agg.py``:

* :func:`gather_sum_pipelined` — K1, for ``gather_sum_pipelined_call``;
* :func:`gather_sum_blocked` — K2, for ``gather_sum_blocked_call`` (the
  paper's warps-per-block knob ``pb``);
* :func:`segment_add_ordered` — K3, the deterministic per-step scatter-add
  (``out.at[tgt].add`` in the reference), which has no Pallas kernel; hub
  rows take two passes over fixed-order chunks;
* :func:`scatter_sum_ordered` — K4, the gather-sum's backward (the masked
  scatter-add of ``repro/kernels/ops.py::_gather_sum_bwd``), deterministic
  through a transposed index built on the host, on K3's kernels;
* :func:`sparse_gather_sum` — K6, for ``sparse_gather_sum_call``: the
  gather-sum over top-k compressed rows (``csrc/sparse_gather_sum.cu``).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on PyTorch's current stream,
raises if the launch failed, and adds one to its ``launches`` count;
where a counter is active (``kernels/cost.py``) it records the launch's
work there too, from host copies of its index arrays.  The library is
built on first use (kernels/_build.py), never at import.
"""
from __future__ import annotations

import torch

from . import _build, cost

__all__ = ["gather_sum_pipelined", "gather_sum_blocked",
           "segment_add_ordered", "scatter_sum_ordered", "sparse_gather_sum",
           "blocked_fits", "reset_launch_counts", "launch_counts",
           "BLOCKED_SMEM_BYTES"]

# K2 stages its partitions' ids and mask in static shared memory; above
# this the block would need the dynamic opt-in, and pb * 32 threads must
# fit one block.
BLOCKED_SMEM_BYTES = 48 * 1024
MAX_THREADS = 1024


def blocked_fits(pb: int, ps: int) -> bool:
    """Whether K2 can run ``pb`` partitions of ``ps`` slots in one block."""
    return (1 <= pb and pb * 32 <= MAX_THREADS
            and 2 * pb * ps * 4 <= BLOCKED_SMEM_BYTES)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_gather(buf, nbrs, mask):
    if buf.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {buf.device} tensor")
    _check("buf", buf, torch.float32, 2, buf.device)
    _check("nbrs", nbrs, torch.int32, 2, buf.device)
    _check("mask", mask, torch.bool, 2, buf.device)
    if mask.shape != nbrs.shape:
        raise ValueError(f"mask {tuple(mask.shape)} != nbrs "
                         f"{tuple(nbrs.shape)}")


def gather_sum_pipelined(buf: torch.Tensor, nbrs: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """K1: ``out[p] = Σ_j mask[p, j] · buf[nbrs[p, j]]`` → (P, D) float32."""
    _check_gather(buf, nbrs, mask)
    p, ps = nbrs.shape
    out = torch.empty((p, buf.shape[1]), dtype=torch.float32,
                      device=buf.device)
    rc = _build.library().mgg_gather_sum_pipelined(
        buf.data_ptr(), nbrs.data_ptr(), mask.data_ptr(), out.data_ptr(),
        p, ps, buf.shape[1], _stream(buf.device))
    _raise_on(rc, "gather_sum_pipelined")
    gather_sum_pipelined.launches += 1
    cost.record("gather_sum_pipelined", lambda: cost.gather_sum(
        cost.host(nbrs), cost.host(mask), buf.shape[1]))
    return out


def gather_sum_blocked(buf: torch.Tensor, nbrs: torch.Tensor,
                       mask: torch.Tensor, *, pb: int) -> torch.Tensor:
    """K2: the same sum, one block owning ``pb`` partitions (one warp each)."""
    _check_gather(buf, nbrs, mask)
    p, ps = nbrs.shape
    if not blocked_fits(pb, ps):
        raise ValueError(f"pb={pb} with ps={ps} does not fit one block")
    out = torch.empty((p, buf.shape[1]), dtype=torch.float32,
                      device=buf.device)
    rc = _build.library().mgg_gather_sum_blocked(
        buf.data_ptr(), nbrs.data_ptr(), mask.data_ptr(), out.data_ptr(),
        p, ps, buf.shape[1], pb, _stream(buf.device))
    _raise_on(rc, "gather_sum_blocked")
    gather_sum_blocked.launches += 1
    cost.record("gather_sum_blocked", lambda: cost.gather_sum(
        cost.host(nbrs), cost.host(mask), buf.shape[1]))
    return out


def _segment_add(out, vals, order, seg_rows, seg_start, chunks, name):
    """Launch ``mgg_segment_add_ordered`` (K3's pair, K4's too):
    ``out[seg_rows[s]] += Σ vals[order[k]]`` over segment ``s`` in order, a
    hub of ``chunks`` through a scratch of its chunk sums."""
    if out.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {out.device} tensor")
    dev, d = out.device, out.shape[1]
    _check("out", out, torch.float32, 2, dev)
    _check("vals", vals, torch.float32, 2, dev)
    for what, t in (("order", order), ("seg_rows", seg_rows),
                    ("seg_start", seg_start)):
        _check(what, t, torch.int32, 1, dev)
    if vals.shape[1] != d:
        raise ValueError(f"vals {tuple(vals.shape)} does not match out "
                         f"{tuple(out.shape)}")
    if seg_start.shape[0] != seg_rows.shape[0] + 1:
        raise ValueError("seg_start must have one more entry than seg_rows")
    hubs = hub_chunks = start = end = sums = None
    n_hubs = n_chunks = chunk_len = 0
    if chunks is not None:
        hubs, hub_chunks = chunks.hubs, chunks.hub_chunks
        start, end = chunks.chunk_start, chunks.chunk_end
        for what, t in (("hubs", hubs), ("hub_chunks", hub_chunks),
                        ("chunk_start", start), ("chunk_end", end)):
            _check(what, t, torch.int32, 1, dev)
        if hub_chunks.shape[0] != hubs.shape[0] + 1 \
                or end.shape != start.shape:
            raise ValueError("hub_chunks must have one entry per hub and one "
                             "more, chunk_end one per chunk_start")
        n_hubs, n_chunks, chunk_len = hubs.shape[0], start.shape[0], \
            chunks.chunk
        sums = torch.empty((n_chunks, d), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.library().mgg_segment_add_ordered(
        out.data_ptr(), vals.data_ptr(), order.data_ptr(),
        seg_rows.data_ptr(), seg_start.data_ptr(), seg_rows.shape[0], d,
        ptr(hubs), ptr(hub_chunks), n_hubs, ptr(start), ptr(end), n_chunks,
        chunk_len, ptr(sums), _stream(dev))
    _raise_on(rc, name)


def segment_add_ordered(out: torch.Tensor, partial: torch.Tensor,
                        order: torch.Tensor, seg_rows: torch.Tensor,
                        seg_start: torch.Tensor, chunks=None) -> torch.Tensor:
    """K3, in place: ``out[seg_rows[s]] += Σ partial[order[k]]`` over
    segment ``s``, in partition order — one owner per output word; with
    ``chunks`` (an ``ops.SegmentChunks``) a hub row adds its chunk sums in
    chunk order, summed first into a scratch the wrapper allocates."""
    if order.shape[0] != partial.shape[0]:
        raise ValueError(f"order {tuple(order.shape)} does not match "
                         f"partial {tuple(partial.shape)}")
    _segment_add(out, partial, order, seg_rows, seg_start, chunks,
                 "segment_add_ordered")
    segment_add_ordered.launches += 1
    cost.record("segment_add_ordered", lambda: cost.segment_add(
        partial.shape[0], seg_rows.shape[0], out.shape[1]))
    return out


def scatter_sum_ordered(dbuf: torch.Tensor, g: torch.Tensor,
                        index) -> torch.Tensor:
    """K4, in place: ``dbuf[rows[s]] += Σ g[src[k]]`` over the masked slots
    of segment ``s`` of ``index`` (a ``GradIndex``) in its fixed order —
    K3's kernels with ``src`` as the order and the index's hub chunks:
    one owner per output word, no atomics."""
    _segment_add(dbuf, g, index.src, index.rows, index.start, index.chunks,
                 "scatter_sum_ordered")
    scatter_sum_ordered.launches += 1
    cost.record("scatter_sum_ordered", lambda: cost.scatter_sum(
        cost.host(index.src), index.rows.shape[0], dbuf.shape[1]))
    return dbuf


# K6 keeps each D-wide fp32 accumulator in one block's shared memory,
# beside its list of 32 live slots (two words each)
SPARSE_MAX_WIDTH = 227 * 1024 // 4 - 64
ID_BYTES = {torch.int16: 2, torch.int32: 4}


def sparse_gather_sum(values: torch.Tensor, idx: torch.Tensor,
                      nbrs: torch.Tensor, mask: torch.Tensor,
                      d_feat: int) -> torch.Tensor:
    """K6: ``out[p] = Σ_j mask[p, j] · decompress(values, idx)[nbrs[p, j]]``
    → (P, d_feat) float32, reading the ``(T, k)`` compressed pairs with
    their int16 (or int32) ids as they are."""
    if values.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {values.device} tensor")
    dev = values.device
    _check("values", values, torch.float32, 2, dev)
    if idx.dtype not in ID_BYTES:
        raise TypeError(f"idx has dtype {idx.dtype}, expected int16 or int32")
    _check("idx", idx, idx.dtype, 2, dev)
    _check("nbrs", nbrs, torch.int32, 2, dev)
    _check("mask", mask, torch.bool, 2, dev)
    if idx.shape != values.shape:
        raise ValueError(f"idx {tuple(idx.shape)} != values "
                         f"{tuple(values.shape)}")
    if mask.shape != nbrs.shape:
        raise ValueError(f"mask {tuple(mask.shape)} != nbrs "
                         f"{tuple(nbrs.shape)}")
    k = values.shape[1]
    if not 1 <= k <= d_feat <= SPARSE_MAX_WIDTH:
        raise ValueError(f"need 1 <= k <= d_feat <= {SPARSE_MAX_WIDTH}, got "
                         f"k={k}, d_feat={d_feat}")
    p, ps = nbrs.shape
    out = torch.empty((p, d_feat), dtype=torch.float32, device=dev)
    rc = _build.library("sparse_gather_sum").mgg_sparse_gather_sum(
        values.data_ptr(), idx.data_ptr(), nbrs.data_ptr(), mask.data_ptr(),
        out.data_ptr(), p, ps, k, d_feat, ID_BYTES[idx.dtype], _stream(dev))
    _raise_on(rc, "sparse_gather_sum")
    sparse_gather_sum.launches += 1
    cost.record("sparse_gather_sum", lambda: cost.sparse_gather_sum(
        cost.host(nbrs), cost.host(mask), k, d_feat, ID_BYTES[idx.dtype]))
    return out


_WRAPPERS = (gather_sum_pipelined, gather_sum_blocked, segment_add_ordered,
             scatter_sum_ordered, sparse_gather_sum)
for _fn in _WRAPPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
