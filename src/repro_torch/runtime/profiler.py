"""Measurement harness for the online tuning runtime (paper §4;
counterpart of ``repro/runtime/profiler.py``).

The paper's runtime exploits the iterative nature of GNN training: every
epoch executes the same aggregation, so each iteration is a *free*
measurement of the current ``(ps, dist, pb)`` configuration.  Two paths:

* :class:`LatencyWindow` — an *online* accumulator fed with per-iteration
  wall times by the training loop (a copy of the reference's).  It drops
  the first ``warmup`` samples after every config swap and reduces the
  rest to a percentile, which is what the tuner consumes.
* :class:`AggregateProfiler` — an *offline* ``measure(ps, dist, pb) ->
  seconds`` callable that builds the port's :class:`GNNEngine` on the
  ring's device and times ``eng.aggregate`` (:func:`time_device`).  With
  no ring, or ``mode="model"``, it falls back to the analytical
  :func:`repro_torch.core.autotune.estimate_latency`, as the reference
  does; a ring never falls back silently.

Both accept an injectable ``clock`` so tests drive them deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.autotune import (H100_SXM, HardwareSpec, WorkloadShape,
                             estimate_latency)

__all__ = ["ProfileConfig", "LatencyWindow", "time_device",
           "AggregateProfiler"]


@dataclasses.dataclass(frozen=True)
class ProfileConfig:
    """How many samples make one measurement, and how they reduce.

    ``warmup`` samples are dropped (first-call and cache-cold effects);
    the remaining ``iters`` reduce to the ``percentile``-th percentile (50
    ⇒ median — robust to straggler iterations, which the paper's measured
    search needs since one preempted step must not steer the descent).
    """

    warmup: int = 1
    iters: int = 3
    percentile: float = 50.0

    @property
    def samples_needed(self) -> int:
        return self.warmup + self.iters


class LatencyWindow:
    """Accumulates per-iteration step times for ONE candidate config."""

    def __init__(self, cfg: ProfileConfig = ProfileConfig()):
        self.cfg = cfg
        self.samples: List[float] = []

    def add(self, dt: float) -> bool:
        """Record one step time; True once the window is full."""
        self.samples.append(float(dt))
        return self.ready

    @property
    def ready(self) -> bool:
        return len(self.samples) >= self.cfg.samples_needed

    def value(self) -> float:
        """The reduced measurement (percentile over post-warmup samples)."""
        kept = self.samples[self.cfg.warmup:]
        if not kept:
            raise ValueError("LatencyWindow.value() before any sample")
        return float(np.percentile(np.asarray(kept), self.cfg.percentile))

    def reset(self) -> None:
        self.samples.clear()


def time_device(fn: Callable, *args, cfg: ProfileConfig = ProfileConfig(),
                clock: Callable[[], float] = time.perf_counter,
                device=None) -> float:
    """Time ``fn(*args)``: warm-up calls, then the percentile of ``iters``.

    On a CUDA ``device`` every timed call sits between two
    ``torch.cuda.synchronize`` calls, so the host clock reads cover the
    card's work and no queued work leaks past them; on the CPU the calls
    are timed as they run.
    """
    dev = torch.device(device) if device is not None else None
    on_card = dev is not None and dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    for _ in range(cfg.warmup):
        fn(*args)
    sync()
    times = []
    for _ in range(cfg.iters):
        t0 = clock()
        fn(*args)
        sync()
        times.append(clock() - t0)
    return float(np.percentile(np.asarray(times), cfg.percentile))


class AggregateProfiler:
    """``measure(ps, dist, pb)`` over real aggregations on ``ring``.

    ``mode``:
      * ``"measure"`` — always build + time the ring aggregation on
        ``ring`` (raises without one);
      * ``"model"`` — always use the analytical latency model;
      * ``"auto"`` — measure when there is a ring, model otherwise.

    ``pb = 0`` asks for no ``pb`` (K1); the plain versions ignore ``pb``.
    As every entry of the port, it runs the kernels (``use_kernel``) and
    models the H100 (``hw``) unless asked otherwise.
    The measured engine aggregates over ``graph`` with self-loops, as
    every engine of the port does (the reference's profiler drops them).
    Measurements are memoized per ``(ps, dist, pb)`` — re-probing a
    config the search already visited is free, mirroring the paper's
    lookup table.
    """

    def __init__(
        self,
        graph,
        ring,
        d_feat: int,
        *,
        interleave: bool = True,
        use_kernel: bool = True,
        profile: ProfileConfig = ProfileConfig(warmup=1, iters=3),
        hw: HardwareSpec = H100_SXM,
        mode: str = "auto",
        seed: int = 0,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if mode not in ("auto", "measure", "model"):
            raise ValueError(f"unknown profiler mode {mode!r}")
        self.graph = graph
        self.ring = ring
        self.d_feat = int(d_feat)
        self.interleave = interleave
        self.use_kernel = use_kernel
        self.profile = profile
        self.hw = hw
        self.mode = mode
        self.clock = clock
        self._x = np.random.default_rng(seed).normal(
            size=(graph.num_nodes, self.d_feat)).astype(np.float32)
        self._table: Dict[Tuple[int, int, int], float] = {}
        self._shape: Optional[WorkloadShape] = None

    # -- capability probing --------------------------------------------------

    def can_measure(self) -> bool:
        return self.ring is not None

    @property
    def measuring(self) -> bool:
        if self.mode == "measure":
            if not self.can_measure():
                raise RuntimeError(
                    "AggregateProfiler(mode='measure') but no ring — use "
                    "mode='auto' for the analytical fallback")
            return True
        return self.mode == "auto" and self.can_measure()

    def workload_shape(self) -> WorkloadShape:
        if self._shape is None:
            n_dev = self.ring.n_dev if self.ring is not None else 1
            self._shape = WorkloadShape.from_graph(
                self.graph, n_dev, self.d_feat)
        return self._shape

    # -- the measure callable ------------------------------------------------

    def __call__(self, ps: int, dist: int, pb: int) -> float:
        key = (int(ps), int(dist), int(pb))
        if key not in self._table:
            if self.measuring:
                self._table[key] = self._measure(*key)
            else:
                self._table[key] = float(estimate_latency(
                    self.workload_shape(), *key, hw=self.hw,
                    interleave=self.interleave))
        return self._table[key]

    def observations(self) -> List[Tuple[dict, float]]:
        """The memo table as ``(config, latency)`` pairs — calibration
        fodder for :func:`repro_torch.obs.calibrate.fit_spec`."""
        return [(dict(ps=ps, dist=dist, pb=pb), lat)
                for (ps, dist, pb), lat in self._table.items()
                if np.isfinite(lat) and lat > 0.0]

    def _measure(self, ps: int, dist: int, pb: int) -> float:
        from ..core.gnn import GNNEngine

        eng = GNNEngine.build(
            self.graph, self.ring, ps=ps, dist=dist,
            pb=(pb or None) if self.use_kernel else None,
            interleave=self.interleave)
        eng.use_kernel = self.use_kernel
        xb = eng.shard(eng.pad(self._x))
        with torch.inference_mode():
            return time_device(eng.aggregate, xb, cfg=self.profile,
                               clock=self.clock, device=eng.device)
