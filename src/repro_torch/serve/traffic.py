"""Synthetic request traffic for the GNN serving engine.

(Framework-free copy of ``repro/serve/traffic.py``: the port may not import the JAX
package.  tests/test_torch_planning.py holds the two copies equal.)

Zipfian node popularity with **phase shifts** — the traffic patterns the
paper's runtime must survive:

* **hot-set rotation** — each phase may re-permute the popularity ranking,
  so the nodes that were hot go cold and a disjoint set heats up (the
  drift signal :class:`repro.serve.stats.WorkloadStats` watches);
* **burst load** — per-phase arrival rate, so a phase can multiply the
  request rate without touching the node distribution;
* **feature updates** — a per-phase fraction of events are node-feature
  writes, which exercise the hot-node cache's explicit invalidation.

Arrival timestamps are *simulated* (exponential inter-arrivals at the
phase rate) and carried on each event, so stats and rate-drift detection
are deterministic given the seed — no wall-clock sleeping.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

__all__ = ["TrafficPhase", "TrafficEvent", "ZipfTraffic"]


@dataclasses.dataclass(frozen=True)
class TrafficPhase:
    """One homogeneous stretch of traffic."""

    requests: int                 # events generated in this phase
    alpha: float = 1.1            # Zipf exponent over the popularity ranking
    rate: float = 200.0           # mean arrivals per second (simulated)
    rotate: bool = False          # re-permute node popularity at phase entry
    seeds_min: int = 1
    seeds_max: int = 4
    update_frac: float = 0.0      # fraction of events that are feature writes


@dataclasses.dataclass(frozen=True)
class TrafficEvent:
    """Either a prediction request (``seeds``) or a feature update."""

    t: float                      # simulated arrival time (seconds)
    seeds: Optional[np.ndarray] = None       # request: node ids
    update_node: Optional[int] = None        # feature write: node id
    update_value: Optional[np.ndarray] = None  # new feature row (d_feat,)

    @property
    def is_update(self) -> bool:
        return self.update_node is not None


class ZipfTraffic:
    """Deterministic event stream over ``phases``."""

    def __init__(self, num_nodes: int, d_feat: int,
                 phases: Sequence[TrafficPhase], seed: int = 0):
        self.num_nodes = int(num_nodes)
        self.d_feat = int(d_feat)
        self.phases = list(phases)
        self.seed = int(seed)

    def _sample_nodes(self, rng, perm: np.ndarray, alpha: float,
                      n: int) -> np.ndarray:
        # Zipf over ranks: rank r is drawn with p ∝ r^-alpha; the permutation
        # maps ranks to node ids, so rotating the permutation rotates the
        # hot set without touching the distribution.
        ranks = (rng.zipf(alpha, size=n) - 1) % self.num_nodes
        return perm[ranks].astype(np.int64)

    def events(self) -> Iterator[TrafficEvent]:
        rng = np.random.default_rng(self.seed)
        perm = np.arange(self.num_nodes, dtype=np.int64)
        t = 0.0
        for phase in self.phases:
            if phase.rotate:
                perm = rng.permutation(self.num_nodes).astype(np.int64)
            for _ in range(phase.requests):
                t += float(rng.exponential(1.0 / max(phase.rate, 1e-9)))
                if phase.update_frac > 0 and rng.random() < phase.update_frac:
                    node = int(self._sample_nodes(rng, perm, phase.alpha, 1)[0])
                    value = rng.normal(size=self.d_feat).astype(np.float32)
                    yield TrafficEvent(t=t, update_node=node,
                                       update_value=value)
                    continue
                k = int(rng.integers(phase.seeds_min, phase.seeds_max + 1))
                # unique seeds within a request keep slot packing simple
                seeds = np.unique(
                    self._sample_nodes(rng, perm, phase.alpha, k))
                yield TrafficEvent(t=t, seeds=seeds)

    def __iter__(self) -> Iterator[TrafficEvent]:
        return self.events()

    @property
    def total_events(self) -> int:
        return sum(p.requests for p in self.phases)
