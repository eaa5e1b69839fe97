"""Sliding-window request statistics for the GNN serving engine.

(Framework-free copy of ``repro/serve/stats.py``: the port may not import the JAX
package.  tests/test_torch_planning.py holds the two copies equal.)

:class:`WorkloadStats` watches the live request stream — arrival rate,
seed counts, receptive-field (frontier) sizes, and a per-node touch
histogram — over a bounded window of recent micro-batches.  Its
:meth:`drift` score compares two :class:`TrafficSnapshot`\\ s and is the
signal that drives :meth:`repro.runtime.engine.DynamicGNNEngine.retune`
under live traffic shifts: a hot-set rotation collapses the hot-node
overlap, a burst moves the arrival rate, a workload-mix change moves the
frontier-size distribution.  Any of the three past the serving engine's
threshold re-opens the (ps, dist, pb) search.

Timestamps are supplied by the caller (the serving engine passes request
arrival times), so replayed traces and fake clocks drive the collector
deterministically in tests.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, deque
from typing import Deque, Optional, Tuple

import numpy as np

__all__ = ["TrafficSnapshot", "WorkloadStats"]


@dataclasses.dataclass(frozen=True)
class TrafficSnapshot:
    """Aggregate view of the stats window at one instant."""

    requests: int           # REQUESTS recorded in the window (not batches)
    rate: float             # requests / second over the window span
    mean_seeds: float       # seeds per micro-batch
    mean_frontier: float
    hot_nodes: Tuple[int, ...]  # top-k node ids by touch count, hottest first


def _rel(a: float, b: float) -> float:
    """Symmetric relative change in [0, 1] (0 ⇔ equal, → 1 as one side
    dwarfs the other) — normalizing by ``max`` keeps :meth:`drift`
    bounded so one threshold means the same thing for a 4× burst and a
    hot-set rotation."""
    return abs(a - b) / max(1e-12, abs(a), abs(b))


class WorkloadStats:
    """Bounded window over served micro-batches.

    ``record`` takes the arrival timestamp of the batch's newest request,
    the requested seed ids (these feed the hot-node histogram), and the
    size of the batch's k-hop receptive field.
    """

    def __init__(self, window: int = 128, top_k: int = 16):
        self.window = int(window)
        self.top_k = int(top_k)
        # (t, n_seeds, frontier_size, seed ids, n_requests) per micro-batch
        self._events: Deque[Tuple[float, int, int, np.ndarray, int]] = \
            deque()
        self._counts: Counter = Counter()
        self.total_batches = 0
        # last rate computed over a non-degenerate span: carried forward
        # when every window batch shares one timestamp (replayed shadow
        # traffic under a frozen clock), so a degenerate window cannot
        # collapse the rate to 0 and fake a full-drift rate change
        self._last_rate = 0.0

    def record(self, t: float, seeds: np.ndarray, frontier_size: int,
               n_requests: int = 1) -> None:
        """One micro-batch: newest arrival time, the REQUESTED node ids,
        its k-hop receptive-field size, and how many requests it packed.

        The hot-node histogram counts *seeds*, not the frontier: a k-hop
        frontier is dominated by high-degree hubs that appear in every
        receptive field regardless of what was asked for, so it cannot see
        a hot-set rotation — the request distribution can.
        """
        nodes = np.asarray(seeds, dtype=np.int64)
        self._events.append((float(t), int(nodes.size), int(frontier_size),
                             nodes, int(n_requests)))
        self._counts.update(nodes.tolist())
        self.total_batches += 1
        while len(self._events) > self.window:
            _, _, _, old, _ = self._events.popleft()
            self._counts.subtract(old.tolist())
        # Counter.subtract keeps zero/negative entries; prune so top-k and
        # memory stay honest.
        if len(self._counts) > 8 * self.window:
            self._counts = Counter(
                {k: v for k, v in self._counts.items() if v > 0})

    def __len__(self) -> int:
        return len(self._events)

    def top_nodes(self, k: int) -> Tuple[int, ...]:
        """Hottest-first node ids by window touch count, up to ``k``.

        ``snapshot().hot_nodes`` caps at ``top_k`` — sized for drift
        comparison, not for cache fills; the tiered feature path admits a
        *capacity*-sized hot list through here instead."""
        return tuple(n for n, v in self._counts.most_common(int(k))
                     if v > 0)

    def recent_seed_batches(self, limit: Optional[int] = None) -> list:
        """Seed-id arrays of the newest ``limit`` window batches (oldest
        first).  The serving cluster replays these as *shadow traffic*
        through a drained replica so its re-opened search measures the
        exact workload that triggered the drift — without holding any live
        request hostage to the re-jits."""
        events = list(self._events)
        if limit is not None:
            events = events[-int(limit):]
        return [e[3].copy() for e in events]

    def snapshot(self) -> TrafficSnapshot:
        n = len(self._events)
        if n == 0:
            return TrafficSnapshot(0, 0.0, 0.0, 0.0, ())
        t0 = self._events[0][0]
        t1 = self._events[-1][0]
        n_req = sum(e[4] for e in self._events)
        # requests/second: arrivals AFTER the window-opening batch over the
        # window span (the first batch anchors t0, its requests predate it).
        # A degenerate span (n == 1, or all timestamps equal — a frozen
        # clock) carries the last measured rate instead of reporting 0.0:
        # the request stream did not stop, the clock did.
        if n > 1 and t1 > t0:
            arrivals = n_req - self._events[0][4]
            rate = arrivals / (t1 - t0)
            self._last_rate = rate
        else:
            rate = self._last_rate
        seeds = float(np.mean([e[1] for e in self._events]))
        frontier = float(np.mean([e[2] for e in self._events]))
        hot = tuple(k for k, v in self._counts.most_common(self.top_k)
                    if v > 0)
        return TrafficSnapshot(n_req, rate, seeds, frontier, hot)

    @staticmethod
    def drift(baseline: TrafficSnapshot, current: TrafficSnapshot) -> float:
        """Relative traffic change in [0, 1]: max over rate change,
        frontier-size change (both symmetric-relative, so bounded) and
        hot-set turnover (1 − overlap with the baseline hot set).  0 for
        identical windows; monotone in hot-set turnover."""
        if baseline.requests == 0 or current.requests == 0:
            return 0.0
        score = max(_rel(baseline.rate, current.rate)
                    if baseline.rate > 0 else 0.0,
                    _rel(baseline.mean_frontier, current.mean_frontier))
        if baseline.hot_nodes:
            overlap = len(set(baseline.hot_nodes) & set(current.hot_nodes)) \
                / len(baseline.hot_nodes)
            score = max(score, 1.0 - overlap)
        return score
