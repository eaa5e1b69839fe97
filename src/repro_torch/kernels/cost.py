"""The work of one launch of each hand-written kernel, and the counters
that record it.

One function a kernel (K1–K9) gives the :class:`Work` of one launch,
``flops`` and ``bytes``.  The same function sets the kernel's bound in
``chip_smoke.py`` (``max(flops / peak, bytes / rate)``) and is what a
wrapper records in the active :class:`Counter`\\ s when it launches, which
``launch/op_cost.py`` adds to its trace: a roofline then reads the same
work whatever implements the kernel.  The reference has no counterpart:
its numerators come from the HLO (``repro/launch/hlo_cost.py``).

``flops`` counts products, 2 a multiply-add, as ``hlo_cost`` counts dots:
K7's two attention products, K8's and K9's recurrent products.  The
gather-sums and segment adds (K1–K6) multiply nothing (a masked slot is
skipped) and their adds are elementwise work, which ``hlo_cost`` leaves
out too: their ``flops`` are 0 and bytes bound them.

``bytes`` counts each input byte a launch needs read once and each output
byte written once (fp32 rows, int32 ids, bool masks):

* K1/K2 (gather-sum): the distinct rows named by a live slot, every
  slot's id and mask, every partition's output row;
* K3 (ordered segment add): every partial row and its order entry, each
  segment's row id and offset, each output row read and written;
* K4 (the gather-sum's backward, K3's kernels on a transposed index): the
  distinct gradient rows read, every slot's source id, the segments' row
  ids and offsets, each output row read and written;
* K5 (row gather): the distinct ids' rows, the ids, the output rows;
* K6 (top-k gather-sum): the distinct rows' ``k`` values and ids, every
  slot's id and mask, every partition's ``D``-wide output row;
* K7 (flash attention): q, k, v read and the output written;
* K8 (sLSTM scan): xp, wr and the initial states read, hs and the final
  states written (with ``save``, also the gates and states K9 reads);
* K9 (its backward): dhs, the saved gates and states, wr and the states
  read, dxp and the initial states' gradients written.

The data-dependent kernels (K1, K2, K4, K5, K6) take the host index
arrays they are launched with.  Their ``worst_*`` forms give the most the
shapes allow, for meta tensors, which hold no data, with ``exact=False``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np

__all__ = ["Work", "Counter", "counting", "hidden", "record",
           "record_transfer", "record_implied", "is_counting", "hlo_bytes",
           "host", "distinct", "gather_sum",
           "worst_gather_sum", "segment_add", "scatter_sum",
           "worst_scatter_sum", "gather_rows", "worst_gather_rows",
           "sparse_gather_sum", "worst_sparse_gather_sum",
           "flash_attention", "attention_pairs", "slstm_scan",
           "slstm_scan_backward"]

_F32, _I32, _BOOL = 4, 4, 1


class Work(NamedTuple):
    """One launch's products (2 a multiply-add) and bytes; ``exact`` is
    False where the bytes are the most the launch's shapes allow."""

    flops: int
    bytes: int
    exact: bool = True


# -- the formulas -------------------------------------------------------------

def distinct(a) -> int:
    """How many distinct values ``a`` holds: marks in a table as long as
    its largest value (row ids), the sort of ``np.unique`` otherwise."""
    a = np.asarray(a).ravel()
    if a.size == 0:
        return 0
    lo, hi = int(a.min()), int(a.max())
    if a.dtype.kind in "iu" and lo >= 0 and hi < 64 * a.size + 2 ** 20:
        seen = np.zeros(hi + 1, bool)
        seen[a] = True
        return int(np.count_nonzero(seen))
    return int(np.unique(a).size)


def gather_sum(nbrs, mask, d: int) -> Work:
    """K1 and K2: ``out[p] = Σ_j mask[p, j] · buf[nbrs[p, j]]``, ``nbrs``
    and ``mask`` ``(P, ps)`` host arrays, rows ``d`` wide."""
    nbrs, mask = np.asarray(nbrs), np.asarray(mask, bool)
    p, ps = nbrs.shape
    rows = distinct(nbrs[mask])
    return Work(0, rows * d * _F32 + p * ps * (_I32 + _BOOL) + p * d * _F32)


def worst_gather_sum(t: int, p: int, ps: int, d: int) -> Work:
    """K1/K2 over a ``(t, d)`` buffer without the index: every slot live
    and naming its own row, as far as ``t`` rows go."""
    rows = min(t, p * ps)
    return Work(0, rows * d * _F32 + p * ps * (_I32 + _BOOL) + p * d * _F32,
                False)


def segment_add(p: int, segments: int, d: int) -> Work:
    """K3: ``p`` partial rows added in order into ``segments`` output
    rows, ``d`` wide (a function of the shapes alone)."""
    return Work(0, p * d * _F32 + p * _I32 + segments * _I32 * 2
                + segments * d * _F32 * 2)


def scatter_sum(src, segments: int, d: int) -> Work:
    """K4: the slots' source rows ``src`` (a host array) of the incoming
    gradient added into ``segments`` output rows, ``d`` wide."""
    src = np.asarray(src)
    return _scatter(distinct(src), src.size, segments, d, True)


def worst_scatter_sum(g_rows: int, slots: int, segments: int,
                      d: int) -> Work:
    """K4 without the index: every slot reading its own gradient row, as
    far as ``g_rows`` go."""
    return _scatter(min(g_rows, slots), slots, segments, d, False)


def _scatter(rows: int, slots: int, segments: int, d: int,
             exact: bool) -> Work:
    return Work(0, rows * d * _F32 + slots * _I32
                + (2 * segments + 1) * _I32 + 2 * segments * d * _F32, exact)


def gather_rows(idx, d: int) -> Work:
    """K5: ``out[i] = src[idx[i]]``, ``idx`` a host array, rows ``d``
    wide."""
    idx = np.asarray(idx)
    return Work(0, distinct(idx) * d * _F32 + idx.size * _I32
                + idx.size * d * _F32)


def worst_gather_rows(t: int, b: int, d: int) -> Work:
    """K5 over ``t`` source rows without the ids: every id distinct."""
    return Work(0, min(t, b) * d * _F32 + b * _I32 + b * d * _F32, False)


def sparse_gather_sum(nbrs, mask, k: int, d: int, id_bytes: int) -> Work:
    """K6: the gather-sum over top-k compressed rows (``k`` fp32 values and
    ``k`` ids of ``id_bytes`` a row) into ``d``-wide output rows."""
    nbrs, mask = np.asarray(nbrs), np.asarray(mask, bool)
    p, ps = nbrs.shape
    return _sparse(distinct(nbrs[mask]), p, ps, k, d, id_bytes, True)


def worst_sparse_gather_sum(t: int, p: int, ps: int, k: int, d: int,
                            id_bytes: int) -> Work:
    """K6 over ``t`` compressed rows without the index."""
    return _sparse(min(t, p * ps), p, ps, k, d, id_bytes, False)


def _sparse(rows, p, ps, k, d, id_bytes, exact) -> Work:
    return Work(0, rows * k * (_F32 + id_bytes) + p * ps * (_I32 + _BOOL)
                + p * d * _F32, exact)


def attention_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a causal and/or windowed attention over ``s``
    positions keeps."""
    if not causal:
        return s * s
    if not window or window >= s:
        return s * (s + 1) // 2
    # row i keeps min(i + 1, window) keys
    return window * (window + 1) // 2 + (s - window) * window


def flash_attention(b: int, s: int, h: int, kv: int, hd: int, *,
                    causal: bool, window: int, itemsize: int) -> Work:
    """K7: q ``(b, s, h, hd)`` over k, v ``(b, s, kv, hd)``: the scores and
    the weighted values, 2 · 2 · hd flops a kept (query, key) pair a head;
    q, k, v and the output in ``itemsize``-byte elements."""
    flops = 4 * b * h * hd * attention_pairs(s, causal, window)
    return Work(flops, (2 * b * s * h * hd + 2 * b * s * kv * hd) * itemsize)


def slstm_scan(b: int, s: int, h: int, hd: int, *, save: bool = False
               ) -> Work:
    """K8 over xp ``(b, s, h·4·hd)`` with wr ``(h, hd, 4·hd)``, fp32: the
    recurrent product ``h_{t-1} · wr`` each step; with ``save`` the gates
    ``(b, s, h, hd, 4)`` and the states c, n, m each step are written
    too."""
    nbytes = _F32 * (b * s * h * 4 * hd + b * s * h * hd + h * hd * 4 * hd
                     + 8 * b * h * hd)
    if save:
        nbytes += _F32 * 7 * b * s * h * hd
    return Work(2 * b * s * h * hd * 4 * hd, nbytes)


def slstm_scan_backward(b: int, s: int, h: int, hd: int) -> Work:
    """K9: dhs and the saved gates and states ``(b, s, h, hd)`` (1 + 4 +
    3), wr, the states before the first step and the gradients after the
    last (7 ``(b, h, hd)``) read; dxp ``(b, s, h·4·hd)`` and the initial
    states' gradients (4) written; the step-to-step product each step."""
    return Work(2 * b * s * h * hd * 4 * hd,
                _F32 * (b * s * h * hd * (1 + 4 + 3) + h * hd * 4 * hd
                        + 7 * b * h * hd + b * s * h * 4 * hd
                        + 4 * b * h * hd))


# -- the counters -------------------------------------------------------------

class Counter:
    """What the kernels and transfers launched while it is active did:
    ``kernels[name]`` (launches, flops, bytes, exact: False once a record
    was a worst case), ``transfers[kind]`` (bytes, count, async: those
    issued on a side stream, or on meta as the card would issue them) and
    ``implied[kind]`` (bytes per device, count: the collectives a real
    mesh's partitioner would add, ``dist/implied.py``)."""

    def __init__(self):
        self.kernels: Dict[str, dict] = {}
        self.transfers: Dict[str, dict] = {}
        self.implied: Dict[str, dict] = {}

    def add_kernel(self, name: str, work: Work) -> None:
        k = self.kernels.setdefault(
            name, dict(launches=0, flops=0, bytes=0, exact=True))
        k["launches"] += 1
        k["flops"] += int(work.flops)
        k["bytes"] += int(work.bytes)
        k["exact"] = k["exact"] and bool(work.exact)

    def add_transfer(self, kind: str, nbytes: int, asynchronous: bool,
                     hlo_bytes: Optional[int] = None) -> None:
        t = self.transfers.setdefault(
            kind, dict(bytes=0, count=0, n_async=0, hlo_bytes=0))
        t["bytes"] += int(nbytes)
        t["count"] += 1
        t["n_async"] += int(bool(asynchronous))
        t["hlo_bytes"] += int(nbytes if hlo_bytes is None else hlo_bytes)

    def add_implied(self, kind: str, nbytes: int, count: int) -> None:
        t = self.implied.setdefault(kind, dict(bytes=0, count=0))
        t["bytes"] += int(nbytes)
        t["count"] += int(count)


# the counters recording now, innermost last; and how deep the calls are
# whose tensor operations a trace must not count (a record's host copies,
# a kernel's stand-in on meta)
_ACTIVE: List[Counter] = []
_HIDDEN = [0]


@contextlib.contextmanager
def counting(counter: Optional[Counter] = None):
    """Make ``counter`` (a new one by default) record every kernel launch
    and transfer until the block ends; yields it."""
    counter = Counter() if counter is None else counter
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.remove(counter)


@contextlib.contextmanager
def hidden():
    """Tensor operations made inside are not the traced program's own."""
    _HIDDEN[0] += 1
    try:
        yield
    finally:
        _HIDDEN[0] -= 1


def is_hidden() -> bool:
    return _HIDDEN[0] > 0


def record(name: str, work_of) -> None:
    """Record one launch of kernel ``name`` in every active counter;
    ``work_of()`` gives its :class:`Work` and is called only when a counter
    is active (it may copy index arrays to the host)."""
    if not _ACTIVE:
        return
    with hidden():
        work = work_of()
    for c in _ACTIVE:
        c.add_kernel(name, work)


def hlo_bytes(t) -> int:
    """``t``'s bytes as the reference's CPU-compiled HLO moves them: its
    backend carries bf16 and fp16 in fp32, so a floating element below 4
    bytes counts 4."""
    es = t.element_size()
    return t.numel() * (max(es, 4) if t.is_floating_point() else es)


def record_transfer(kind: str, sources_of, asynchronous: bool) -> None:
    """Record one transfer of the tensors ``sources_of()`` gives under
    ``kind`` (the reference's collective name) in every active counter:
    their bytes, and their bytes at the reference's width
    (:func:`hlo_bytes`)."""
    if not _ACTIVE:
        return
    srcs = sources_of()
    nbytes = sum(s.numel() * s.element_size() for s in srcs)
    wide = sum(hlo_bytes(s) for s in srcs)
    for c in _ACTIVE:
        c.add_transfer(kind, nbytes, asynchronous, wide)


def is_counting() -> bool:
    """True while a counter records (outside a record's own copies)."""
    return bool(_ACTIVE) and not is_hidden()


def record_implied(kind: str, nbytes: int, count: int = 1) -> None:
    """Record ``count`` implied collectives of ``kind`` moving ``nbytes``
    per device in all, in every active counter."""
    for c in _ACTIVE:
        c.add_implied(kind, nbytes, count)


def host(t) -> np.ndarray:
    """A tensor's values as a host array (a copy from the card)."""
    return t.detach().cpu().numpy()
