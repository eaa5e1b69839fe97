"""Counter / gauge / histogram registry with labeled series.

(Framework-free copy of ``repro/obs/metrics.py``: the port may not import the JAX
package.  tests/test_torch_planning.py holds the two copies equal.)

One :class:`MetricsRegistry` per engine (or shared across a cluster's
replicas with distinguishing labels).  Series are keyed by
``(name, sorted(labels))`` so ``reg.counter("serve.requests",
replica=0)`` and ``replica=1`` are independent; ``snapshot()`` folds
everything into a plain JSON-ready dict.

Counters/gauges are exact.  Histograms keep exact count/sum/min/max and
a bounded reservoir for percentile summaries — a serve run recording
millions of latencies stays O(reservoir) in memory.  All mutation is
lock-guarded; reads take the same lock and copy.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, Optional, Tuple


def _series_key(name: str, labels: dict) -> Tuple[str, Tuple]:
    return name, tuple(sorted(labels.items()))


class Counter:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def set(self, n) -> None:
        """Absolute set — for adapters mirroring an externally-kept total."""
        with self._lock:
            self.value = n


class Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, d: float = 1.0) -> None:
        with self._lock:
            self.value += d

    def dec(self, d: float = 1.0) -> None:
        with self._lock:
            self.value -= d


class Histogram:
    """Exact count/sum/min/max + bounded reservoir for percentiles.

    The reservoir keeps the first ``reservoir`` observations then
    overwrites cyclically — recent-biased, deterministic (no RNG so
    replays are reproducible), and bounded.
    """

    __slots__ = ("_lock", "count", "sum", "min", "max", "_buf", "_cap",
                 "_i")

    def __init__(self, lock: threading.Lock, reservoir: int = 1024):
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._buf: list = []
        self._cap = int(reservoir)
        self._i = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self._buf) < self._cap:
                self._buf.append(v)
            else:
                self._buf[self._i] = v
                self._i = (self._i + 1) % self._cap

    def percentile(self, q: float) -> float:
        with self._lock:
            buf = sorted(self._buf)
        if not buf:
            return 0.0
        idx = min(len(buf) - 1, max(0, int(round(q / 100.0 * (len(buf) - 1)))))
        return buf[idx]

    def summary(self) -> dict:
        with self._lock:
            buf = sorted(self._buf)
            out = {"count": self.count, "sum": self.sum,
                   "min": self.min if self.count else 0.0,
                   "max": self.max if self.count else 0.0,
                   "mean": (self.sum / self.count) if self.count else 0.0}
        for q in (50, 90, 99):
            if buf:
                idx = min(len(buf) - 1,
                          max(0, int(round(q / 100.0 * (len(buf) - 1)))))
                out[f"p{q}"] = buf[idx]
            else:
                out[f"p{q}"] = 0.0
        return out


class MetricsRegistry:
    """Labeled counter/gauge/histogram factory with a JSON snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple, Counter] = {}
        self._gauges: Dict[Tuple, Gauge] = {}
        self._hists: Dict[Tuple, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        key = _series_key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter(self._lock)
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = _series_key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge(self._lock)
        return g

    def histogram(self, name: str, reservoir: int = 1024,
                  **labels) -> Histogram:
        key = _series_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(self._lock, reservoir)
        return h

    # -- aggregation -------------------------------------------------------

    def counter_total(self, name: str) -> int:
        """Sum a counter across every label combination (cluster rollup)."""
        with self._lock:
            return sum(c.value for (n, _), c in self._counters.items()
                       if n == name)

    def snapshot(self) -> dict:
        """JSON-ready view: {counters: {...}, gauges: {...}, histograms}."""
        def fmt(key):
            name, labels = key
            if not labels:
                return name
            return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"

        with self._lock:
            counters = {fmt(k): c.value for k, c in self._counters.items()}
            gauges = {fmt(k): g.value for k, g in self._gauges.items()}
            hists = list(self._hists.items())
        return {"counters": counters, "gauges": gauges,
                "histograms": {fmt(k): h.summary() for k, h in hists}}

    def dump_json(self, path: str, extra: Optional[dict] = None) -> None:
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, default=str)
