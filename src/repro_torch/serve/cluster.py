"""Multi-replica GNN serving: N tuned engines behind a locality-aware router
(counterpart of ``repro/serve/cluster.py``).

MGG's intelligent runtime tunes one pipeline for one GPU group;
production traffic needs *many* tuned engines running concurrently and
sharing what the tuner learns.  :class:`ServeCluster` fronts N independent
:class:`~repro_torch.serve.gnn.GNNServeEngine` replicas (each with its
own :class:`~repro_torch.dist.VirtualRing`, feature table, layer-1 hot
cache, and per-replica :class:`~repro_torch.serve.stats.WorkloadStats`)
with a :class:`~repro_torch.serve.router.Router` and coordinates their drift-triggered
re-tunes so the cluster never stalls:

* **Routing** — least-pending-load or seed-locality hashing (see
  :mod:`repro_torch.serve.router`); a replica that is draining for a retune is
  out of rotation and its traffic is absorbed by the others.
* **Staggered retunes** — a replica whose drift crosses the threshold
  asks the cluster (via the engine's ``retune_gate`` hook) for the single
  cluster-wide *retune token*.  With the token it goes through
  **drain → retune → rejoin**: new requests route elsewhere, its queue is
  served to empty under the old (already built) config, then the
  search re-opens and is fed *shadow traffic* — a replay of the replica's
  own recent seed batches (``WorkloadStats.recent_seed_batches``) — so
  the tuner measures the drifted workload without holding any live
  request hostage to plan rebuilds.  At most one replica is ever re-searching;
  zero requests are dropped cluster-wide.
* **Shared ConfigCache** — replicas share one
  :class:`~repro_torch.runtime.cache.ConfigCache` (concurrency-safe; see that
  module).  The first replica to retune after a drift pays the full
  re-search and commits its optimum; a later replica whose drift signal
  *overlapped* that search (it was already waiting when the commit
  landed — same traffic shift, not a stale epoch) *adopts* the committed
  entry with a single validation measurement
  (``DynamicGNNEngine.retune(force=True, from_cache=True)``), so its
  search visits strictly fewer configs.  A drift that fires fresh after
  the commit re-searches honestly.

**Latency semantics** — replicas model concurrent GPU groups, but the
port runs them in one process on one card, so the cluster gives each
replica a virtual clock: real wall time minus the time other replicas
(or this replica's own shadow tuning) spent serving.  Work on replica A
therefore never inflates replica B's reported latencies, and with a
single replica every offset is zero —
``ServeCluster([srv]).run_trace(events)`` is *bitwise identical* to
``run_trace(srv, events)`` on a bare engine.  A charged call must end
with the card idle, or the next replica's clock would absorb its queued
device work: a replica's ``step`` ends in a synchronize and a copy of the
logits to the host, and ``force_retune`` in a synchronize.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import NULL_TRACER, MetricsRegistry
from .gnn import GNNServeEngine, ServeResult
from .router import LeastLoadRouter, Router
from .traffic import TrafficEvent

__all__ = ["ServeCluster"]

# replica lifecycle within the cluster
_SERVING, _DRAINING, _TUNING = "serving", "draining", "tuning"


class ServeCluster:
    """N serving replicas, one router, one retune token, zero drops."""

    def __init__(
        self,
        replicas: Sequence[GNNServeEngine],
        router: Optional[Router] = None,
        *,
        max_shadow_batches: int = 64,
        shadow_window: int = 8,
        log_fn=lambda _s: None,
        tracer=None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        if not replicas:
            raise ValueError("a cluster needs at least one replica")
        self.replicas: List[GNNServeEngine] = list(replicas)
        if any(r.batches or r.pending_requests for r in self.replicas):
            raise ValueError("replicas must join the cluster before "
                             "serving any traffic")
        self.router = router if router is not None else LeastLoadRouter()
        self.max_shadow_batches = int(max_shadow_batches)
        self.shadow_window = int(shadow_window)
        self.log = log_fn

        n = len(self.replicas)
        # virtual-parallelism clocks: replica i's timeline excludes time
        # the process spent serving on other replicas (offset[i] grows
        # whenever j != i runs).  n == 1 ⇒ offset stays 0 ⇒ bare-engine
        # clock, which is what makes the single-replica mode bitwise.
        self._offset = [0.0] * n
        for i, r in enumerate(self.replicas):
            r.clock = self._make_clock(i)
            if n > 1 and r.dynamic:
                r.retune_gate = self._make_gate(i)

        self._state = [_SERVING] * n
        self._token: Optional[int] = None      # replica holding the retune
        self._closing = False                  # drain(): no new retunes
        self._from_cache = [False] * n
        self._commit_seq = 0                   # committed coordinated retunes
        # commit_seq at the moment replica i's CURRENT drift signal first
        # fired (None ⇔ no retune pending).  A sibling entry is adopted
        # only when its commit landed AFTER that moment — i.e. the two
        # replicas' drift windows overlapped, so it was tuned under the
        # same traffic shift, not a stale epoch.  A live drift re-fires
        # the gate every check_every batches; a want whose last re-fire
        # is older than that (signal subsided without a retune) is a NEW
        # drift next time, not a continuation.
        self._want_seq: List[Optional[int]] = [None] * n
        self._want_batch = [0] * n             # srv.batches at last fire
        self._shadow_batches: List[np.ndarray] = []
        self._shadow_cursor = 0
        self._shadow_count = 0

        self._next_gid = 0
        self._gid: Dict[Tuple[int, int], int] = {}   # (replica, local) → gid
        self._gid_replica: Dict[int, int] = {}       # gid → replica
        self._last_routed = 0
        # cluster counters live in the registry (shared with the replicas
        # when the caller passes one everywhere); the legacy attributes
        # are read-through properties so report() stays a thin view.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_user = self.metrics.counter("cluster.user_served")
        self._c_shadow = self.metrics.counter("cluster.shadow_served")
        self._c_staggered = self.metrics.counter("cluster.staggered_retunes")
        self._c_deferred = self.metrics.counter("cluster.deferred_retunes")
        self.retune_log: List[Dict] = []

    @property
    def user_served(self) -> int:
        return self._c_user.value

    @property
    def shadow_served(self) -> int:
        return self._c_shadow.value

    @property
    def staggered_retunes(self) -> int:
        return self._c_staggered.value

    @property
    def deferred_retunes(self) -> int:
        return self._c_deferred.value

    # -- clocks / accounting -------------------------------------------------

    def _make_clock(self, i: int):
        return lambda: time.perf_counter() - self._offset[i]

    def _charge(self, i: int, fn):
        """Run ``fn`` on replica ``i``'s dime: the elapsed wall time is
        added to every *other* replica's offset (their virtual clocks do
        not advance while i computes — the replicas are concurrent)."""
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            dt = time.perf_counter() - t0
            for j in range(len(self.replicas)):
                if j != i:
                    self._offset[j] += dt

    # -- retune token --------------------------------------------------------

    def _make_gate(self, i: int):
        def gate(srv, score: float) -> bool:
            if self._token == i:
                return False                   # already scheduled
            stale = (self._want_seq[i] is not None
                     and srv.batches - self._want_batch[i]
                     > 2 * srv.check_every)
            fresh = self._want_seq[i] is None or stale
            if fresh:
                self._want_seq[i] = self._commit_seq
            self._want_batch[i] = srv.batches
            if self._token is not None or self._closing:
                if fresh:
                    # one deferral per wait (re-asks while the same token
                    # holder searches are not new deferrals)
                    self._c_deferred.inc()
                    self.tracer.instant("cluster.retune_deferred",
                                        cat="cluster", replica=i,
                                        drift=float(score))
                return False
            self._token = i
            self._state[i] = _DRAINING
            self._from_cache[i] = self._commit_seq > self._want_seq[i]
            self._c_staggered.inc()
            self.tracer.instant("cluster.drain_begin", cat="cluster",
                                replica=i, drift=float(score),
                                from_cache=self._from_cache[i])
            self.log(f"[serve.cluster] replica {i} drift {score:.2f} → "
                     f"token acquired (drain → retune"
                     f"{' [adopt from shared cache]' if self._from_cache[i] else ''}"
                     f" → rejoin)")
            return False                       # never retune inline
        return gate

    def _rejoin(self, i: int) -> None:
        srv = self.replicas[i]
        committed = not srv._tuning
        if committed and self._state[i] == _TUNING and self._shadow_batches:
            # run the committed config's first step (and refresh the
            # invalidated h₁ cache) on one more shadow batch, so the first
            # LIVE request after rejoin does not pay the rebuilt plan's
            # first launches — the point of retuning off-rotation
            seeds = self._shadow_batches[
                self._shadow_cursor % len(self._shadow_batches)]
            srv.submit(seeds)
            self._step_replica(i)
        srv.record_stats = True
        if committed:
            self._commit_seq += 1
        self._want_seq[i] = None
        self._state[i] = _SERVING
        self._token = None
        self.retune_log.append(dict(
            replica=i, from_cache=self._from_cache[i],
            committed=committed, shadow_batches=self._shadow_count,
            search_size=srv.search_sizes[-1] if committed
            and srv.search_sizes else None))
        self.tracer.instant("cluster.rejoin", cat="cluster", replica=i,
                            committed=committed,
                            shadow_batches=self._shadow_count)
        self.log(f"[serve.cluster] replica {i} rejoined "
                 f"(config {srv.config}, "
                 f"{self._shadow_count} shadow batches)")

    # -- admission -----------------------------------------------------------

    @property
    def available(self) -> List[int]:
        """Replica indices currently in rotation."""
        out = [i for i, s in enumerate(self._state) if s == _SERVING]
        # a lone replica mid-retune still takes traffic (nothing can
        # absorb it); the inline tuning path handles it like a bare engine
        return out or list(range(len(self.replicas)))

    def submit(self, seeds: np.ndarray, t: Optional[float] = None) -> int:
        """Route + enqueue one request; returns its cluster-wide id."""
        seeds = np.asarray(seeds)
        i = self.router.pick(seeds, self.replicas, self.available)
        lid = self.replicas[i].submit(seeds, t=t)
        gid = self._next_gid
        self._next_gid += 1
        self._gid[(i, lid)] = gid
        self._gid_replica[gid] = i
        self._last_routed = i
        return gid

    def replica_of(self, request_id: int) -> int:
        """Which replica served (or will serve) this request."""
        return self._gid_replica[request_id]

    def update_features(self, node: int, value: np.ndarray) -> int:
        """Apply a feature write on EVERY replica (each keeps its own
        table + cache); returns total rows invalidated across replicas."""
        return sum(r.update_features(node, value) for r in self.replicas)

    # -- serving -------------------------------------------------------------

    def _collect(self, i: int, results: List[ServeResult]) -> \
            List[ServeResult]:
        out = []
        for r in results:
            gid = self._gid.pop((i, r.request_id), None)
            if gid is None:                    # shadow replay: discard
                self._c_shadow.inc()
                continue
            out.append(dataclasses.replace(r, request_id=gid))
        self._c_user.inc(len(out))
        return out

    def _step_replica(self, i: int) -> List[ServeResult]:
        return self._collect(i, self._charge(i, self.replicas[i].step))

    def pump(self) -> List[ServeResult]:
        """Advance the in-flight coordinated retune by ONE unit of work
        (one drain micro-batch or one shadow measurement batch), so the
        retune interleaves with live routing instead of stalling it.
        Returns any user results the drain produced."""
        i = self._token
        if i is None:
            return []
        srv = self.replicas[i]
        out: List[ServeResult] = []
        if self._state[i] == _DRAINING:
            if srv.pending_requests:
                out = self._step_replica(i)
            if not srv.pending_requests:
                self._begin_tuning(i)
            return out
        # _TUNING: feed one replayed batch to the open search
        if not srv._tuning or self._shadow_count >= self.max_shadow_batches:
            self._rejoin(i)
            return out
        seeds = self._shadow_batches[
            self._shadow_cursor % len(self._shadow_batches)]
        self._shadow_cursor += 1
        self._shadow_count += 1
        srv.submit(seeds)
        self._step_replica(i)                  # results are shadow: dropped
        if not srv._tuning:
            self._rejoin(i)
        return out

    def _begin_tuning(self, i: int) -> None:
        srv = self.replicas[i]
        self.tracer.instant("cluster.shadow_begin", cat="cluster",
                            replica=i)
        self._shadow_batches = srv.stats.recent_seed_batches(
            limit=self.shadow_window)
        self._shadow_cursor = 0
        self._shadow_count = 0
        self._charge(i, lambda: srv.force_retune(
            from_cache=self._from_cache[i]))
        if not srv._tuning or not self._shadow_batches:
            # degenerate space (nothing to measure) or no replayable
            # traffic: rejoin immediately — inline tuning takes over
            self._rejoin(i)
            return
        srv.record_stats = False
        self._state[i] = _TUNING

    def step(self) -> List[ServeResult]:
        """One cluster scheduling round: a micro-batch on every replica
        with queued work, plus one unit of retune progress."""
        out: List[ServeResult] = []
        for i, r in enumerate(self.replicas):
            if self._state[i] == _SERVING and r.pending_requests:
                out.extend(self._step_replica(i))
        out.extend(self.pump())
        return out

    def run_trace(self, events) -> List[ServeResult]:
        """Cluster mirror of :func:`repro_torch.serve.gnn.run_trace`: updates
        fan out to every replica, requests route through the router, each
        replica serves whenever it can fill its slots, and the in-flight
        retune (if any) advances one unit per event.  Drains at the end —
        every request is answered."""
        results: List[ServeResult] = []
        for ev in events:
            if isinstance(ev, TrafficEvent) and ev.is_update:
                self.update_features(ev.update_node, ev.update_value)
                continue
            seeds = ev.seeds if isinstance(ev, TrafficEvent) else ev
            self.submit(seeds,
                        t=ev.t if isinstance(ev, TrafficEvent) else None)
            i = self._last_routed
            while self.replicas[i].pending_seeds >= self.replicas[i].slots:
                results.extend(self._step_replica(i))
            results.extend(self.pump())
        results.extend(self.drain())
        return results

    def drain(self) -> List[ServeResult]:
        """Finish the in-flight retune (bounded by ``max_shadow_batches``)
        and serve every queued request on every replica.  No NEW retune
        token is granted while draining — a drift that fires here has no
        live traffic for siblings to absorb, so it waits for the next
        serving phase (the un-reset baseline keeps the signal alive)."""
        out: List[ServeResult] = []
        self._closing = True
        try:
            guard = 4 * self.max_shadow_batches + 16
            while self._token is not None and guard > 0:
                out.extend(self.pump())
                guard -= 1
            for i, r in enumerate(self.replicas):
                while r.pending_requests:
                    out.extend(self._step_replica(i))
        finally:
            self._closing = False
        return out

    # -- reporting -----------------------------------------------------------

    def report(self) -> Dict[str, object]:
        """Thin view over the registry + per-replica reports (schema
        unchanged): every cluster counter is either its own registry
        series or the fold of the replicas' registry-backed series."""
        per = [r.report() for r in self.replicas]
        tiered = [p["tiers"] for p in per if p.get("tiers")]
        return dict(
            replicas=len(self.replicas),
            router=self.router.name,
            served=self._c_user.value,
            shadow_served=self._c_shadow.value,
            pending=sum(r.pending_requests for r in self.replicas),
            dropped=sum(p["dropped"] for p in per),
            staggered_retunes=self._c_staggered.value,
            deferred_retunes=self._c_deferred.value,
            retune_log=list(self.retune_log),
            # cluster-wide tiered-storage accounting (replicas each hold
            # their own hot cache over their own host store)
            host_rows_streamed=sum(t["host_rows_streamed"] for t in tiered),
            cache_rows_served=sum(t["cache_rows_served"] for t in tiered),
            per_replica=per,
        )
