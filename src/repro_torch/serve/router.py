"""Request routing policies for the multi-replica GNN serving cluster.

(Framework-free copy of ``repro/serve/router.py``: the port may not import
the JAX package.  tests/test_torch_cluster.py holds the two copies' picks
equal.)

A :class:`Router` picks which :class:`~repro_torch.serve.gnn.GNNServeEngine`
replica answers a prediction request.  Two policies, per the GNNAdvisor
lesson that runtime decisions should follow observed workload properties:

* :class:`LeastLoadRouter` — the replica with the fewest pending seeds.
  Optimal for queue balance, blind to caches.
* :class:`LocalityRouter` — seed-locality hashing: the request's *anchor*
  seed (the min-hash seed of the set, so requests sharing a hot seed
  usually share the anchor) maps to a home replica, which therefore keeps
  seeing the same neighborhoods and keeps its layer-1 hot cache valid for
  them.  When the home replica is out of rotation (draining for a retune)
  or overloaded past ``load_slack`` micro-batches of backlog, the policy
  falls back to the least-loaded replica whose cache is ready for the
  seeds, then to plain least-load — locality is a preference, load is the
  guarantee.

Routers are deterministic (no RNG, no wall clock): the same request
stream over the same replica states routes identically, which is what
makes the cluster's single-replica mode bitwise-reproducible.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["Router", "LeastLoadRouter", "LocalityRouter", "make_router"]

_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer — a stable integer hash (``hash()`` would do,
    but its value is implementation-defined and we want routing to be
    reproducible across runs and machines)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & _M64


class Router:
    """Policy interface: pick a replica index for a request."""

    name = "base"

    def __init__(self):
        self._rr = 0    # round-robin tie-break cursor (see _least_load)

    def pick(self, seeds: np.ndarray, replicas: Sequence,
             available: Sequence[int]) -> int:
        """Return the index (into ``replicas``) that should serve
        ``seeds``.  ``available`` lists the replicas currently in rotation
        (a draining/retuning replica is excluded by the cluster); the
        returned index must come from it."""
        raise NotImplementedError

    def _least_load(self, replicas: Sequence,
                    available: Sequence[int]) -> int:
        """Fewest pending seeds; ties rotate round-robin.  Queues are
        usually empty in the eager serving loop, so a static tie-break
        would starve every replica but the first — the cursor keeps the
        policy deterministic (no RNG, no clock) while spreading ties."""
        floor = min(replicas[i].pending_seeds for i in available)
        cands = [i for i in available
                 if replicas[i].pending_seeds == floor]
        pick = cands[self._rr % len(cands)]
        self._rr += 1
        return pick


class LeastLoadRouter(Router):
    """Route to the replica with the fewest queued seeds (deterministic
    round-robin among ties)."""

    name = "load"

    def pick(self, seeds, replicas, available):
        if not available:
            raise ValueError("no replica in rotation")
        return self._least_load(replicas, available)


class LocalityRouter(Router):
    """Seed-locality hashing with a load fallback.

    ``anchor(seeds) = argmin_s mix(s)`` is stable under sub/supersets, so
    the requests that repeatedly touch a hot node share an anchor and
    land on one home replica — whose layer-1 cache then most likely holds
    their frontier already.  The home replica is overridden only when it
    is out of rotation or its backlog exceeds the least-loaded replica's
    by more than ``load_slack`` full micro-batches.
    """

    name = "locality"

    def __init__(self, load_slack: float = 2.0):
        super().__init__()
        self.load_slack = float(load_slack)

    def pick(self, seeds, replicas, available):
        if not available:
            raise ValueError("no replica in rotation")
        seeds = np.asarray(seeds).ravel()
        anchor = min((int(s) for s in seeds), key=_mix)
        home = _mix(anchor) % len(replicas)
        floor = min(replicas[i].pending_seeds for i in available)
        slack = self.load_slack * replicas[home].slots
        if (home in available
                and replicas[home].pending_seeds <= floor + slack):
            return home
        # home unavailable/backlogged: prefer a replica that can serve the
        # request from its cache, then fall back to pure load
        ready = [i for i in available if replicas[i].cache.ready(seeds)]
        if ready:
            return self._least_load(replicas, ready)
        return self._least_load(replicas, available)


def make_router(name: str, **kwargs) -> Router:
    """Factory for the launcher / benchmarks: ``load`` or ``locality``."""
    if name == "load":
        return LeastLoadRouter()
    if name == "locality":
        return LocalityRouter(**kwargs)
    raise ValueError(f"unknown router policy {name!r} "
                     f"(expected 'load' or 'locality')")
