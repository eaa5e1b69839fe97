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
  through a transposed index built on the host;
* :func:`sparse_gather_sum` — K6, for ``sparse_gather_sum_call``: the
  gather-sum over top-k compressed rows (``csrc/sparse_gather_sum.cu``).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on PyTorch's current stream,
raises if the launch failed, and adds one to its ``launches`` count.  The
library is built on first use (kernels/_build.py), never at import.
"""
from __future__ import annotations

import torch

from . import _build

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
    return out


def _check_segments(out, vals, idx, seg_rows, seg_start, names):
    """Checks shared by K3 and K4: ``out[seg_rows[s]] += Σ vals[idx[k]]``."""
    if out.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {out.device} tensor")
    dev = out.device
    _check(names[0], out, torch.float32, 2, dev)
    _check(names[1], vals, torch.float32, 2, dev)
    for name, t in ((names[2], idx), ("seg_rows", seg_rows),
                    ("seg_start", seg_start)):
        _check(name, t, torch.int32, 1, dev)
    if vals.shape[1] != out.shape[1]:
        raise ValueError(f"{names[1]} {tuple(vals.shape)} does not match "
                         f"{names[0]} {tuple(out.shape)}")
    if seg_start.shape[0] != seg_rows.shape[0] + 1:
        raise ValueError("seg_start must have one more entry than seg_rows")


def segment_add_ordered(out: torch.Tensor, partial: torch.Tensor,
                        order: torch.Tensor, seg_rows: torch.Tensor,
                        seg_start: torch.Tensor, chunks=None) -> torch.Tensor:
    """K3, in place: ``out[seg_rows[s]] += Σ partial[order[k]]`` over
    segment ``s``, in partition order — one owner per output word; with
    ``chunks`` (an ``ops.SegmentChunks``) a hub row adds its chunk sums in
    chunk order, summed first into a scratch the wrapper allocates."""
    _check_segments(out, partial, order, seg_rows, seg_start,
                    ("out", "partial", "order"))
    if order.shape[0] != partial.shape[0]:
        raise ValueError(f"order {tuple(order.shape)} does not match "
                         f"partial {tuple(partial.shape)}")
    dev, d = out.device, out.shape[1]
    hubs = hub_chunks = start = end = sums = None
    n_hubs = n_chunks = chunk_len = 0
    if chunks is not None:
        hubs, hub_chunks = chunks.hubs, chunks.hub_chunks
        start, end = chunks.chunk_start, chunks.chunk_end
        for name, t in (("hubs", hubs), ("hub_chunks", hub_chunks),
                        ("chunk_start", start), ("chunk_end", end)):
            _check(name, t, torch.int32, 1, dev)
        if hub_chunks.shape[0] != hubs.shape[0] + 1 \
                or end.shape != start.shape:
            raise ValueError("hub_chunks must have one entry per hub and one "
                             "more, chunk_end one per chunk_start")
        n_hubs, n_chunks, chunk_len = hubs.shape[0], start.shape[0], \
            chunks.chunk
        sums = torch.empty((n_chunks, d), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.library().mgg_segment_add_ordered(
        out.data_ptr(), partial.data_ptr(), order.data_ptr(),
        seg_rows.data_ptr(), seg_start.data_ptr(), seg_rows.shape[0], d,
        ptr(hubs), ptr(hub_chunks), n_hubs, ptr(start), ptr(end), n_chunks,
        chunk_len, ptr(sums), _stream(dev))
    _raise_on(rc, "segment_add_ordered")
    segment_add_ordered.launches += 1
    return out


def scatter_sum_ordered(dbuf: torch.Tensor, g: torch.Tensor,
                        index) -> torch.Tensor:
    """K4, in place: ``dbuf[rows[s]] += Σ g[src[k]]`` over the masked slots
    of segment ``s`` of ``index`` (a ``GradIndex``) in its fixed order —
    one owner per output word, no atomics; an index cut into chunks runs
    the kernel's two passes through a zeroed scratch of chunk sums."""
    _check_segments(dbuf, g, index.src, index.rows, index.start,
                    ("dbuf", "g", "src"))
    dev, d = dbuf.device, dbuf.shape[1]
    chunked = index.chunk_start is not None
    if chunked:
        for name, t in (("chunk_start", index.chunk_start),
                        ("row_chunks", index.row_chunks)):
            _check(name, t, torch.int32, 1, dev)
        if index.row_chunks.shape != index.start.shape:
            raise ValueError("row_chunks must have one entry per segment "
                             "and one more")
    n_chunks = index.chunk_start.shape[0] - 1 if chunked else 0
    sums = torch.zeros((n_chunks, d), dtype=torch.float32, device=dev)
    ptr = lambda t: t.data_ptr() if chunked else None
    rc = _build.library().mgg_scatter_sum_ordered(
        dbuf.data_ptr(), g.data_ptr(), index.src.data_ptr(),
        index.rows.data_ptr(), index.start.data_ptr(), index.rows.shape[0],
        ptr(index.chunk_start), ptr(index.row_chunks), ptr(sums), n_chunks,
        d, _stream(dev))
    _raise_on(rc, "scatter_sum_ordered")
    scatter_sum_ordered.launches += 1
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
