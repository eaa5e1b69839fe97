"""A virtual device mesh on one card (counterpart of ``repro/dist/mesh.py``).

The reference lays a ``jax.sharding.Mesh`` over ring-ordered devices and
moves blocks between them with ``ppermute`` / ``all_to_all``.  The port
keeps every shard on one card, as :class:`~repro_torch.dist.ring.VirtualRing`
does for the GNN ring: a tensor's shards are stacked on leading dimensions,
one per mesh axis in ``axis_names`` order, so shard ``(d, j)`` of a
``(data, model)`` mesh is index ``[d, j]`` of the stack.  A transfer along
one axis is a copy into a second buffer, issued through the ring's
``_enqueue``: on the card it runs on the ring's side stream after
everything already queued on the current stream, and the returned event
marks its end (pass it to :meth:`VirtualMesh.wait` before reading the
result), so the copy that brings the next block overlaps the product on
the current one.  On the CPU the same calls run in order.

Under autograd a transfer is an ``autograd.Function`` whose backward is
the transposed transfer (a rotation back, the inverse ``all_to_all``) on
the same side stream, waited for before the gradient is returned.

``ring_order`` keeps device-id order: one card has no torus coordinates.
The reference's ``make_mesh`` refuses a mesh larger than the process's
devices; a virtual mesh has no device count to exceed, so that
``ValueError`` has no counterpart here (any shape fits, memory permitting).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from .ring import VirtualRing, _roll_back_into, _roll_into

__all__ = ["VirtualMesh", "make_mesh", "flat_ring_mesh", "ring_order"]


def ring_order(devices: Sequence) -> list:
    """``devices`` in device-id order (the reference's order for devices
    without torus coordinates)."""
    return sorted(devices, key=lambda d: getattr(d, "index", None) or 0)


class _Op:
    """A transfer: the shape it produces and the copy that fills it."""

    def __init__(self, shape: Callable, copy: Callable, kind: str):
        self.shape, self.copy, self.kind = shape, copy, kind


class VirtualMesh:
    """``prod(shape)`` virtual shards on ``device``, stacked on leading
    dimensions in ``axis_names`` order.

    ``.shape`` is the reference's axis → size mapping.  Setting ``log`` to
    a list records, on the card, each transfer's start and end events on
    the side stream and each :meth:`span` on the current stream (with the
    bytes a transfer moves), for timelines."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device="cuda"):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"shape {shape} vs axis_names {names}")
        if len(set(names)) != len(names) or any(s < 1 for s in shape):
            raise ValueError(f"mesh {dict(zip(names, shape))}: axis names "
                             "must differ and sizes be positive")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.size = math.prod(shape)
        self._ring = VirtualRing(self.size, device)
        self.device = self._ring.device
        self.log: Optional[list] = None
        self._index = {}

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    @property
    def devices_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)

    def ring_index(self, name: str) -> torch.Tensor:
        """``t[off][i] = (i + off) % n`` along axis ``name`` (n = its size),
        on the mesh's device, made once: the shard each ring step reads."""
        if name not in self._index:
            n = self.shape[name]
            # a normal tensor even when first asked for under inference
            # mode: autograd saves it for a later training step's backward
            with torch.inference_mode(False):
                ar = torch.arange(n, device=self.device)
                self._index[name] = (ar[None, :] + ar[:, None]) % n
        return self._index[name]

    def axis(self, name: str) -> int:
        """The stacked dimension of mesh axis ``name``."""
        if name not in self.shape:
            raise KeyError(f"no axis {name!r} in mesh {self.shape}")
        return self.axis_names.index(name)

    def __repr__(self) -> str:
        return f"VirtualMesh({self.shape}, device={self.device})"

    # -- transfers ---------------------------------------------------------

    def permute(self, x: torch.Tensor, axis: str, *, back: bool = False):
        """Enqueue the ring permutation along ``axis`` of the stacked
        blocks ``x``: shard ``i``'s block lands at shard ``i + 1`` (the
        reference's ``perm = (i, i+1)``), or at ``i - 1`` with ``back``.
        Returns ``(the permuted blocks, a token for wait)``."""
        a = self.axis(axis)
        fwd = _permute_op(a, back)
        return self._transfer(x, fwd, _permute_op(a, not back))

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int,
                   concat_axis: int):
        """Enqueue the tiled ``all_to_all`` along ``axis``: each shard's
        block (dims after the mesh dims; ``split_axis`` and ``concat_axis``
        count within the block) is cut into ``n`` pieces along
        ``split_axis``, piece ``j`` goes to shard ``j``, and the pieces a
        shard receives are concatenated along ``concat_axis`` in the order
        of the shards they came from (``lax.all_to_all(..., tiled=True)``).
        Returns ``(the exchanged blocks, a token for wait)``."""
        a, n, lead = self.axis(axis), self.shape[axis], self.ndim
        nb = x.dim() - lead
        sa, ca = split_axis % nb, concat_axis % nb
        if x.shape[lead + sa] % n:
            raise ValueError(
                f"all_to_all: split extent {x.shape[lead + sa]} not "
                f"divisible by axis {axis!r} size {n}")
        return self._transfer(x, _a2a_op(lead, a, n, sa, ca),
                              _a2a_op(lead, a, n, ca, sa))

    def wait(self, token) -> None:
        """Order the current stream after the transfer ``token``."""
        self._ring.wait(token)

    def _transfer(self, x, fwd: _Op, bwd: _Op):
        if torch.is_grad_enabled() and x.requires_grad:
            box = []
            y = _Transfer.apply(x, self, fwd, bwd, box)
            return y, box[0]
        return self._issue(fwd, x)

    def _issue(self, op: _Op, x: torch.Tensor):
        dst = torch.empty(op.shape(tuple(x.shape)), dtype=x.dtype,
                          device=x.device)
        copy = op.copy
        side = self._ring._side
        if side is not None:
            # both buffers are made on the current stream and used on the
            # side stream: their blocks are not reused until the copy ends
            x.record_stream(side)
            dst.record_stream(side)
            if self.log is not None:
                copy = self._logged(op, x.numel() * x.element_size())
        return dst, self._ring._enqueue(copy, x, dst, _WIRE[op.kind])

    def _logged(self, op: _Op, nbytes: int):
        def copy(src, dst):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            op.copy(src, dst)
            end.record()
            self.log.append(dict(kind=op.kind, stream="side", start=start,
                                 end=end, bytes=nbytes))
        return copy

    @contextlib.contextmanager
    def span(self, kind: str):
        """With ``log`` set on the card, record the block's start and end
        on the current stream under ``kind``; otherwise nothing."""
        if self.log is None or self._ring._side is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.log.append(dict(kind=kind, stream="current", start=start,
                             end=end, bytes=0))


class _Transfer(torch.autograd.Function):
    """A transfer under autograd: forward enqueues ``fwd`` (its token goes
    into ``box`` for the caller to wait on, so the copy still overlaps the
    caller's next product); backward enqueues ``bwd`` on the gradient and
    waits for it before handing the gradient on."""

    @staticmethod
    def forward(ctx, x, mesh, fwd, bwd, box):
        ctx.mesh, ctx.bwd = mesh, bwd
        y, token = mesh._issue(fwd, x)
        box.append(token)
        return y

    @staticmethod
    def backward(ctx, g):
        gx, token = ctx.mesh._issue(ctx.bwd, g)
        ctx.mesh.wait(token)
        return gx, None, None, None, None


# a transfer's kind under the reference's collective names (what the
# counters of kernels/cost.py record)
_WIRE = {"rotate": "collective-permute", "rotate_back": "collective-permute",
         "all_to_all": "all-to-all"}


def _permute_op(a: int, back: bool) -> _Op:
    roll = _roll_back_into if back else _roll_into
    return _Op(lambda shape: shape,
               lambda src, dst: roll(src.movedim(a, 0), dst.movedim(a, 0)),
               "rotate_back" if back else "rotate")


def _a2a_op(lead: int, a: int, n: int, sa: int, ca: int) -> _Op:
    """The tiled all_to_all along mesh dim ``a`` as one strided copy: the
    split dim is cut into (piece, rest), the piece dim swapped with the
    mesh dim (so a shard's pieces land on their destinations and the
    source shard takes the piece's place), and the source dim put just
    before the concat dim, whose (source, extent) pair is the output's
    concat dim."""
    def shape(s):
        s = list(s)
        s[lead + sa] //= n
        s[lead + ca] *= n
        return tuple(s)

    def copy(src, dst):
        v = src.unflatten(lead + sa, (n, src.shape[lead + sa] // n))
        v = v.transpose(a, lead + sa).movedim(lead + sa, lead + ca)
        dst.unflatten(lead + ca, (n, dst.shape[lead + ca] // n)).copy_(v)

    return _Op(shape, copy, "all_to_all")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device="cuda") -> VirtualMesh:
    """A :class:`VirtualMesh` of ``shape`` on ``device`` (the reference's
    ``make_mesh`` over fake host devices)."""
    return VirtualMesh(shape, axis_names, device)


def flat_ring_mesh(n: int, device="cuda") -> VirtualMesh:
    """The MGG aggregation mesh: ``n`` shards on a single ``"ring"`` axis."""
    return make_mesh((n,), ("ring",), device=device)
