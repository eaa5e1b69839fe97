"""A virtual ring of ``n_dev`` shards on one card (counterpart of
``repro/dist/mesh.py``).

The JAX package runs the MGG ring over a device mesh, and on one host it
fakes the devices with ``--xla_force_host_platform_device_count``.  The port
keeps all shards on one card: shard ``d`` is the row range
``[d · rows, (d+1) · rows)`` of one tensor, and a ring rotation is an
explicit copy of the stacked tiles ``(n_dev, tile_rows, D)`` into a second
buffer, shard ``i``'s tile landing at shard ``i + 1`` (the reference's
``perm = (i, i+1)``).

On the card the copy runs on a side stream ordered by CUDA events, so the
rotation that brings the next tile overlaps the gather-sum of the current
one, as the reference's ``ppermute`` does.  On the CPU the same calls run in
order.  The backward ring rotates the other way (:meth:`rotate_back`, the
transpose of ``perm = (i, i+1)``), ordered the same way.  NCCL across real
cards is a later slice.

On the meta device (passed explicitly: a dry run, ``launch/dryrun_gnn.py``)
a ring moves no data and allocates nothing.  On every device each transfer
reports its kind (the reference's collective name) and bytes to the active
counters (``kernels/cost.py``), as asynchronous where it runs on the side
stream: on the card, and on meta, which stands in for the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import cost

__all__ = ["VirtualRing", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU (or, for a dry run, for meta).  Raises when CUDA is asked
    for (or defaulted to) and is missing — the port never falls back to the
    CPU, or to meta, on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class VirtualRing:
    """``n_dev`` virtual shards on ``device``, rotated by explicit copies."""

    def __init__(self, n_dev: int, device="cuda"):
        if n_dev < 1:
            raise ValueError("n_dev must be positive")
        self.n_dev = int(n_dev)
        self.device = resolve_device(device)
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    def rotate(self, src, dst) -> Optional[torch.cuda.Event]:
        """Enqueue ``dst[(i + 1) % n] = src[i]`` for the stacked tiles.

        ``src`` and ``dst`` are tensors, or tuples of tensors that rotate
        together under one event (the top-k ring's ``(values, ids)``
        pair).  On the card the copy is issued on the side stream after
        everything already queued on the current stream (which wrote
        ``src`` and last read ``dst``); the returned event marks its end —
        pass it to :meth:`wait` before reading ``dst``.
        """
        return self._enqueue(_roll_into, src, dst)

    def rotate_back(self, src, dst) -> Optional[torch.cuda.Event]:
        """Enqueue ``dst[i] = src[(i + 1) % n]``, the transposed rotation
        that carries a tile's gradient one shard back; ordered as
        :meth:`rotate`."""
        return self._enqueue(_roll_back_into, src, dst)

    def _enqueue(self, copy, src, dst, kind: str = "collective-permute"
                 ) -> Optional[torch.cuda.Event]:
        """Issue ``copy`` of each (src, dst) pair; the counters record one
        ``kind`` transfer of the sources' bytes."""
        pairs = tuple(zip(src, dst)) if isinstance(src, tuple) \
            else ((src, dst),)
        cost.record_transfer(
            kind, lambda: sum(s.numel() * s.element_size() for s, _ in pairs),
            self._side is not None or self.device.type == "meta")
        if self._side is None:
            for s, d in pairs:
                copy(s, d)
            return None
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            for s, d in pairs:
                copy(s, d)
            done = torch.cuda.Event()
            done.record(self._side)
        return done

    def wait(self, token: Optional[torch.cuda.Event]) -> None:
        """Order the current stream after the rotation ``token``."""
        if token is not None:
            torch.cuda.current_stream(self.device).wait_event(token)


def _roll_into(src: torch.Tensor, dst: torch.Tensor) -> None:
    dst[1:].copy_(src[:-1])
    dst[0].copy_(src[-1])


def _roll_back_into(src: torch.Tensor, dst: torch.Tensor) -> None:
    dst[:-1].copy_(src[1:])
    dst[-1].copy_(src[0])
