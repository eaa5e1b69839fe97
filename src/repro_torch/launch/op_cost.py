"""Dispatch-level cost analysis (counterpart of ``repro/launch/hlo_cost.py``).

The reference re-derives the three roofline numerators from the
partitioned HLO, because XLA's own analysis counts a ``while`` body once:
it multiplies each loop by its trip count.  The port's programs are eager
PyTorch, so every loop (layers, attention chunks, ring steps, microbatches)
is unrolled in Python and its iterations are dispatched one by one:
nothing needs multiplying, and ``while_trips`` is ``{}``.

:func:`analyze` runs a callable under a ``TorchDispatchMode`` and counts
the aten operations it dispatches (its backward too, when it runs
autograd, and a checkpointed block's recompute):

* ``dot_flops``: 2 · numel(result) · contraction of every ``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``mv``, ``dot`` and ``convolution``, plus the
  flops the hand-written kernels record (``kernels/cost.py``); elementwise
  flops are left out, as the reference leaves them out;
* ``bytes_accessed``: operand bytes + result bytes of every operation that
  is not a view or an allocation, the reference's upper bound at op
  boundaries (``hlo_cost.py:232-238``); a kernel counts by its record,
  which the operations its wrapper makes to compute it do not add to;
* ``collectives``: the transfers the port issues (``VirtualRing`` and
  ``VirtualMesh`` rotations and exchanges, the ef all-reduce) under the
  reference's names (``collective-permute``, ``all-to-all``,
  ``all-reduce``), as operand bytes, with ``total_bytes`` and ``n_async``
  (those issued on the ring's side stream, or on meta as the card would);
* ``kernels``: each hand-written kernel's launches, flops and bytes, which
  the reference cannot give (its Pallas calls are opaque custom calls).

On meta tensors (a dry run) nothing is allocated and the data-dependent
kernels record the most their shapes allow (``exact: False``); on the card
the same program gives the same operation counts and exact kernel
records.  ``peak_live_bytes`` is the largest sum of the storages the
callable's operations made that were alive at once (released when their
last Python tensor goes): an estimate of its temporaries.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import cost

__all__ = ["analyze", "OpCost"]

_aten = torch.ops.aten
# (op, index of the left operand): 2 · numel(result) · its last dim
_DOTS = {_aten.mm: 0, _aten.bmm: 0, _aten.mv: 0, _aten.addmm: 1,
         _aten.baddbmm: 1}
# operations that move no bytes: allocations and aliases
_FREE = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.detach,
         _aten.alias, _aten.lift_fresh}


@dataclasses.dataclass
class OpCost:
    dot_flops: int
    bytes_accessed: int
    collectives: Dict[str, Dict[str, int]]
    total_collective_bytes: int
    n_async: int
    while_trips: Dict[str, int]
    kernels: Dict[str, dict]
    peak_live_bytes: int
    output: Any = dataclasses.field(default=None, repr=False)

    def as_dict(self) -> Dict:
        """The reference's ``HLOCost.as_dict()`` keys, and ``kernels``."""
        return dict(dot_flops=self.dot_flops,
                    bytes_accessed=self.bytes_accessed,
                    per_op=self.collectives,
                    total_bytes=self.total_collective_bytes,
                    n_async=self.n_async, while_trips=self.while_trips,
                    kernels=self.kernels)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _dot_flops(func, args, out) -> int:
    packet = func.overloadpacket
    if packet in _DOTS:
        return 2 * out.numel() * args[_DOTS[packet]].shape[-1]
    if packet is _aten.dot:
        return 2 * args[0].numel()
    if packet is _aten.convolution:
        w, transposed, groups = args[1], args[6], args[8]
        taps = math.prod(w.shape[2:])
        per_out = (w.shape[0] // groups if transposed else w.shape[1]) * taps
        return 2 * out.numel() * per_out
    return 0


class _CostMode(TorchDispatchMode):
    """Counts every aten operation dispatched under it (outside a kernel's
    record, ``cost.hidden``) and tracks the storages they make."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if cost.is_hidden():
            return func(*args, **kwargs)
        # under inference mode composite operations (matmul, einsum, ...)
        # arrive whole: count what they decompose into, as with autograd
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        outs = _tensors(out)
        packet = func.overloadpacket
        if not func.is_view and packet not in _FREE:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
            self.flops += _dot_flops(func, args, out)
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [storage.nbytes(), 0]
            self.live += ref[0]
            self.peak = max(self.peak, self.live)
        ref[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]


def analyze(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatches,
    launches and transfers (module docstring); its return value is kept
    as ``OpCost.output``."""
    mode = _CostMode()
    with cost.counting() as counter, mode:
        out = fn(*args, **kwargs)
    kernels = {k: dict(v) for k, v in sorted(counter.kernels.items())}
    per_op = {k: dict(bytes=v["bytes"], count=v["count"])
              for k, v in sorted(counter.transfers.items())}
    return OpCost(
        dot_flops=mode.flops + sum(k["flops"] for k in kernels.values()),
        bytes_accessed=mode.bytes + sum(k["bytes"]
                                        for k in kernels.values()),
        collectives=per_op,
        total_collective_bytes=sum(v["bytes"] for v in per_op.values()),
        n_async=sum(v["n_async"] for v in counter.transfers.values()),
        while_trips={}, kernels=kernels, peak_live_bytes=mode.peak,
        output=out)
