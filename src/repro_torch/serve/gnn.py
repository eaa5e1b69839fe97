"""Online GNN inference serving on the port's MGG engine (counterpart of
``repro/serve/gnn.py``), static or re-tuned under traffic drift.

Request path (one micro-batch)::

    submit(seeds) ─► admission queue ─► fixed slots (≤ ``slots`` seeds)
        ─► k-hop frontier extraction (host, CSR)      → WorkloadStats
        ─► layer-1 cache lookup over the (k-1)-hop frontier
        ─► eager step through GNNEngine/mgg_aggregate (inference mode):
              · cache miss → FULL pass (all stages; refreshes the cache)
              · all hits   → CACHED pass (stages 1.. from the h₁ table)
        ─► gather seed rows from the padded PGAS logits → responses

Both passes fold the *same* stage functions over the *same* tables, and
every kernel on the path is deterministic (the scatter-add included), so
served logits are bitwise-identical to the offline ``gcn_apply`` forward.
Latencies end in ``torch.cuda.synchronize()`` so they include the
device's work.

Traffic-driven re-tuning (a :class:`~repro_torch.runtime.DynamicGNNEngine`):
every ``check_every`` micro-batches the engine snapshots
:class:`~repro_torch.serve.stats.WorkloadStats` and compares it to the
snapshot taken at the last tune.  Past ``drift_threshold`` (hot-set
rotation, burst, frontier shift) it calls ``retune(force=True)``; the
re-opened search is then fed per-micro-batch wall times via
``observe_step`` until it converges again — serving never stops and no
request is dropped.  Every tuner move re-pads the feature table for the
rebuilt plan and invalidates the h₁ cache (a ``dist`` move changes the
padded layout); while a search is open every batch takes the FULL pass,
so the tuner measures the whole aggregation pipeline.  Served logits stay
bitwise equal to the offline forward under the live config.

Tiered feature storage (``feature_store`` / ``feature_capacity``): the
features live in a host :class:`~repro_torch.store.FeatureStore` (pinned
on the card), the card holds a bounded hot-row cache refreshed from the
live hot set before each batch, and every full pass runs on a padded
table assembled for it (:meth:`TieredFeatures.padded_table`) and dropped
after it, so no resident padded table is held.  Each assembled row is
the store's row verbatim, so tiered logits are bitwise the resident
ones, feature updates included.  The admitted ids persist across
restarts in a JSON sidecar (``hotset_path``, or next to the tuner's
config cache).  ``frontier_fanout`` bounds the receptive field fed to
the traffic statistics with a sampled k-hop frontier
(:mod:`repro_torch.sample`); the cache gating stays exact.

A :class:`~repro_torch.serve.cluster.ServeCluster` coordinates replicas
through two hooks: ``retune_gate`` is asked before a drift retune and may
defer it (the cluster then drains the replica and calls
:meth:`GNNServeEngine.force_retune` itself), and ``record_stats = False``
marks replayed shadow batches, which stay out of the drift window and
count as ``serve.shadow_served`` instead of ``serve.served``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..core.gnn import apply_from_stage, apply_stage, num_stages
from ..core.graph import CSRGraph, khop_in_frontier, neighbors_of
from ..core.placement import pgas_rows
from ..obs import NULL_TRACER, MetricsRegistry
from ..runtime.engine import DynamicGNNEngine
from ..sample import sampled_khop_frontier
from ..store import FeatureStore, TieredFeatures
from .hotcache import HotNodeCache
from .stats import TrafficSnapshot, WorkloadStats
from .traffic import TrafficEvent

__all__ = ["GNNServeEngine", "ServeResult", "run_trace"]


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """Response for one request: logits per seed + latency accounting."""

    request_id: int
    seeds: np.ndarray
    logits: np.ndarray        # (len(seeds), num_classes)
    latency: float            # submit → response wall seconds (incl. queue)
    cached: bool              # served from the layer-1 cache


@dataclasses.dataclass
class _Pending:
    request_id: int
    seeds: np.ndarray
    t_arrival: float          # traffic timestamp (stats / rate drift)
    t_submit: float           # wall clock (latency accounting)
    t_trace: float = 0.0      # tracer clock at admission (span timelines)


class GNNServeEngine:
    """Admission queue + fixed micro-batch slots over a (Dynamic)GNNEngine."""

    def __init__(
        self,
        engine,                      # GNNEngine or DynamicGNNEngine
        params: Dict,
        model: str,
        x: np.ndarray,               # (num_nodes, d_feat) features
        graph: CSRGraph,             # the raw topology the engine was built on
        *,
        slots: int = 8,
        stats: Optional[WorkloadStats] = None,
        drift_threshold: float = 0.5,
        check_every: int = 8,
        min_records: int = 8,
        use_cache: bool = True,
        cache_capacity: Optional[int] = None,
        feature_store=None,
        feature_capacity: Optional[int] = None,
        hotset_path: Optional[str] = None,
        frontier_fanout: Optional[int] = None,
        frontier_seed: int = 0,
        retune_gate: Optional[
            Callable[["GNNServeEngine", float], bool]] = None,
        log_fn: Callable[[str], None] = lambda _s: None,
        clock: Callable[[], float] = time.perf_counter,
        tracer=None,
        metrics: Optional[MetricsRegistry] = None,
        obs_labels: Optional[dict] = None,
    ):
        self.eng = engine
        self.params = params
        self.model = model
        self.x = np.array(x, dtype=np.float32)
        self.graph = graph
        self.g_full = graph.with_self_loops()   # as the engine aggregates
        self.rev = self.g_full.transpose()   # invalidation fan-out
        self.slots = int(slots)
        self.k_hops = len(params["layers"])
        num_stages(model, params)        # refuses an unknown model
        self.stats = stats or WorkloadStats(window=32)
        self.drift_threshold = float(drift_threshold)
        self.check_every = int(check_every)
        self.min_records = int(min_records)
        self.use_cache = bool(use_cache)
        self.cache = HotNodeCache(graph.num_nodes, capacity=cache_capacity)
        # fanout-bounded frontier accounting: the receptive-field size fed
        # to WorkloadStats comes from a sampled k-hop frontier, bounded by
        # slots·(fanout+1)^k instead of the full BFS fan-out; the cache
        # gating stays exact (a sampled frontier may miss a dirty row)
        self.frontier_fanout = (None if frontier_fanout is None
                                else int(frontier_fanout))
        self._frontier_rng = np.random.default_rng(frontier_seed)
        self.log = log_fn
        self.clock = clock
        # coordinator hook: called with (self, drift score) when the drift
        # crosses the threshold; False defers the retune
        self.retune_gate = retune_gate
        # False while a coordinator replays shadow traffic through this
        # engine: replayed batches stay out of the drift window
        self.record_stats = True
        self.dynamic = isinstance(engine, DynamicGNNEngine)
        self._tuning = self.dynamic and not engine.tuner.converged
        self._baseline: Optional[TrafficSnapshot] = None
        self._queue: Deque[_Pending] = deque()
        self._next_id = 0
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.obs_labels = dict(obs_labels or {})
        _c = lambda name: self.metrics.counter(name, **self.obs_labels)
        self._c_served = _c("serve.served")
        self._c_shadow = _c("serve.shadow_served")   # record_stats off
        self._c_batches = _c("serve.batches")  # ALL batches (check_every)
        self._c_retunes = _c("serve.retunes")  # traffic-drift re-opens
        self._c_rebuilds = _c("serve.rebuilds")  # plan rebuilds
        self._g_queue = self.metrics.gauge("serve.queue_depth",
                                           **self.obs_labels)
        self._h_latency = self.metrics.histogram("serve.request_seconds",
                                                 **self.obs_labels)
        self._h_batch = self.metrics.histogram("serve.batch_seconds",
                                               **self.obs_labels)
        if self.dynamic:
            # thread the same sinks into the runtime so tuner audit events
            # land in this trace/registry (engine construction predates us)
            if tracer is not None:
                engine.tracer = self.tracer
            if engine.metrics is None:
                engine.metrics = self.metrics
        # measurements (≈ configs visited) per closed search, in order
        self.search_sizes: List[int] = []
        self._search_opened_at: Optional[int] = \
            engine.tuner.measured if self._tuning else None

        # tiered feature storage: selected by passing either knob
        self.tiers: Optional[TieredFeatures] = None
        if feature_store is not None or feature_capacity is not None:
            store = feature_store if feature_store is not None else \
                FeatureStore(self.x, pin=self.eng.device.type == "cuda")
            cap = feature_capacity
            if cap is None:   # adopt the tuner's cap knob when it has one
                cap = (engine.feature_capacity or 0) if self.dynamic else 0
            self.tiers = TieredFeatures(store, self.eng.plan, int(cap),
                                        device=self.eng.device,
                                        metrics=self.metrics,
                                        labels=self.obs_labels)
            self.x = store.x   # the store owns the bits; a shared view
        # hot-set persistence: the admitted ids (never the rows, which are
        # refetched from the store) survive restarts in a JSON sidecar —
        # ``hotset_path``, else next to the tuner's config cache
        self._hotset_path = hotset_path
        if self._hotset_path is None and self.dynamic \
                and engine.cache is not None:
            rep = self.obs_labels.get("replica")
            suffix = ".hotset.json" if rep is None \
                else f".hotset.r{rep}.json"
            self._hotset_path = engine.cache.path + suffix
        if self.tiers is not None:
            self._hotset_load()
        self.xp: Optional[torch.Tensor] = None
        self._refresh_tables()

    # -- registry-backed counters --------------------------------------------

    @property
    def served(self) -> int:
        return self._c_served.value

    @property
    def shadow_served(self) -> int:
        return self._c_shadow.value

    @property
    def batches(self) -> int:
        return self._c_batches.value

    @property
    def retunes(self) -> int:
        return self._c_retunes.value

    @property
    def rebuilds(self) -> int:
        return self._c_rebuilds.value

    # -- hot-set persistence --------------------------------------------------

    def _hotset_load(self) -> None:
        """Warm-admit the hot ids a previous serve process persisted.  The
        sidecar is a hint: a missing or corrupt file, or one recorded for
        another store shape, is ignored (the tier starts cold)."""
        if self._hotset_path is None or not self.tiers.capacity:
            return
        try:
            with open(self._hotset_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        store = self.tiers.store
        if not isinstance(doc, dict) \
                or doc.get("num_nodes") != store.num_nodes \
                or doc.get("d_feat") != store.d_feat \
                or not isinstance(doc.get("ids"), list):
            return
        ids = [int(i) for i in doc["ids"] if 0 <= int(i) < store.num_nodes]
        if ids:
            n = self.tiers.admit(ids)
            self.log(f"[serve.gnn] warm hot set from {self._hotset_path}: "
                     f"{n} rows admitted")

    def _hotset_dump(self) -> None:
        """Atomically persist the admitted ids (a temporary file, then
        ``os.replace``: a preempted writer never corrupts the sidecar)."""
        if self._hotset_path is None or self.tiers is None:
            return
        doc = dict(num_nodes=self.tiers.store.num_nodes,
                   d_feat=self.tiers.store.d_feat,
                   ids=[int(i) for i in self.tiers.cache.resident_ids()])
        d = os.path.dirname(os.path.abspath(self._hotset_path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".hotset-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self._hotset_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- layout ---------------------------------------------------------------

    def _refresh_tables(self) -> None:
        """(Re-)pad the feature table for the CURRENT plan layout; the
        tiered mode only rebinds the store to the plan and holds no
        table."""
        if self.tiers is not None:
            self.tiers.set_plan(self.eng.plan)
            self.xp = None
            return
        self.xp = self.eng.shard(self.eng.pad(self.x))

    def _on_rebuild(self) -> None:
        self._c_rebuilds.inc()
        self.tracer.instant("serve.rebuild", cat="serve",
                            config=self.eng.config)
        if self.tiers is not None and self.dynamic:
            # the tuner may have moved the cap knob: adopt it (the tier
            # restarts cold; the next admission refills it)
            cap = self.eng.feature_capacity
            if cap is not None and cap != self.tiers.capacity:
                self.tiers.resize(int(cap))
        self._refresh_tables()
        # the padded layout may have moved with dist — the cached table's
        # rows no longer line up; recompute on next batch
        self.cache.invalidate()

    # -- steps ----------------------------------------------------------------

    def _sync(self) -> None:
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize(self.eng.device)

    def _step_full(self, xp: torch.Tensor, rows: torch.Tensor):
        with torch.inference_mode():
            h1 = apply_stage(self.model, self.params, self.eng, xp, 0)
            out = apply_from_stage(self.model, self.params, self.eng, h1, 1)
            return out[rows], h1

    def _step_cached(self, rows: torch.Tensor):
        with torch.inference_mode():
            return apply_from_stage(self.model, self.params, self.eng,
                                    self.cache.table, 1)[rows]

    # -- admission -----------------------------------------------------------

    def submit(self, seeds: np.ndarray, t: Optional[float] = None) -> int:
        """Enqueue a prediction request; returns its id.  Never drops."""
        seeds = np.asarray(seeds, dtype=np.int64).ravel()
        if seeds.size == 0 or seeds.size > self.slots:
            raise ValueError(
                f"request must carry 1..{self.slots} seeds, got {seeds.size}")
        if seeds.min() < 0 or seeds.max() >= self.graph.num_nodes:
            raise ValueError("seed id out of range")
        rid = self._next_id
        self._next_id += 1
        now = self.clock()
        self._queue.append(_Pending(
            rid, seeds, now if t is None else float(t), now,
            t_trace=self.tracer.now() if self.tracer.enabled else 0.0))
        self._g_queue.set(len(self._queue))
        return rid

    @property
    def pending_requests(self) -> int:
        return len(self._queue)

    @property
    def pending_seeds(self) -> int:
        return sum(p.seeds.size for p in self._queue)

    def update_features(self, node: int, value: np.ndarray) -> int:
        """Feature write at ``node``: writes the one changed row into the
        device table in place (the reference rebuilds its immutable array
        with ``.at[row].set``), or in tiered mode into the store, which
        invalidates the row's hot copy, and explicitly invalidates the
        layer-1 rows that aggregate it (reverse edges, self-loop
        included).  Returns the number of rows invalidated."""
        value = np.asarray(value, dtype=np.float32)
        if self.tiers is not None:
            self.tiers.update(int(node), value)
        else:
            self.x[int(node)] = value
            row = int(pgas_rows(self.eng.plan, np.array([node]))[0])
            self.xp[row] = torch.from_numpy(value).to(self.xp.device)
        dirty = self.rev.row(int(node))
        return self.cache.invalidate(dirty)

    def sampled_frontier(self, seeds: np.ndarray) -> np.ndarray:
        """Fanout-bounded k-hop receptive field of ``seeds`` (sorted unique
        global ids): always a subset of the exact frontier, of at most
        ``len(seeds) · (frontier_fanout + 1) ** k_hops`` ids.  Duplicate
        seeds are deduped."""
        if self.frontier_fanout is None:
            raise ValueError("serve engine built without frontier_fanout")
        return sampled_khop_frontier(
            self.g_full, np.unique(np.asarray(seeds, dtype=np.int64)),
            [self.frontier_fanout] * self.k_hops, rng=self._frontier_rng)

    # -- the serving loop ----------------------------------------------------

    def step(self) -> List[ServeResult]:
        """Serve ONE micro-batch: pack whole requests into the slots, run
        the step, respond.  No-op (empty list) on an empty queue."""
        batch: List[_Pending] = []
        n_seeds = 0
        while self._queue and \
                n_seeds + self._queue[0].seeds.size <= self.slots:
            p = self._queue.popleft()
            batch.append(p)
            n_seeds += p.seeds.size
        if not batch:
            return []
        tracing = self.tracer.enabled
        if tracing:
            t_batch0 = self.tracer.now()
            for p in batch:
                self.tracer.complete("serve.queue_wait", p.t_trace,
                                     t_batch0, cat="serve",
                                     args={"request_id": p.request_id})
        self._g_queue.set(len(self._queue))

        seeds = np.concatenate([p.seeds for p in batch])
        padded = np.zeros(self.slots, dtype=np.int64)   # masked tail slots
        padded[:n_seeds] = seeds
        rows = torch.from_numpy(
            pgas_rows(self.eng.plan, padded).astype(np.int64)).to(
                self.eng.device)

        # Rows the CACHED pass reads: h₁ rows up to (k-1) hops out; one
        # more hop on top gives the receptive-field size for the stats.
        with self.tracer.span("serve.frontier", cat="serve",
                              n_seeds=int(n_seeds)):
            f_need = khop_in_frontier(self.g_full, seeds,
                                      max(0, self.k_hops - 1))
            if self.frontier_fanout is not None and self.k_hops > 0:
                fk_size = self.sampled_frontier(seeds).size
            elif self.k_hops > 0:
                fk_size = np.unique(np.concatenate(
                    [f_need,
                     neighbors_of(self.g_full, f_need).astype(np.int64)])
                ).size
            else:
                fk_size = f_need.size
            misses = self.cache.lookup(f_need)
        if self.record_stats:
            self.stats.record(batch[-1].t_arrival, seeds, fk_size,
                              n_requests=len(batch))
        if self.tiers is not None and self.tiers.capacity \
                and self.record_stats:
            # refresh the feature tier from the live hot set before this
            # batch's assembly (only newly hot rows are fetched); persist
            # the admitted set when it moved
            if self.tiers.admit(self.stats.top_nodes(self.tiers.capacity)):
                self._hotset_dump()

        use_cached = self.use_cache and not self._tuning and misses == 0
        t0 = self.clock()
        with self.tracer.span("serve.aggregate", cat="serve",
                              cached=bool(use_cached),
                              frontier=int(fk_size)):
            if use_cached:
                out = self._step_cached(rows)
                self._sync()
            else:
                # tiered mode assembles the padded table for this pass
                xp = self.xp if self.tiers is None \
                    else self.tiers.padded_table()
                out, h1 = self._step_full(xp, rows)
                del xp
                self._sync()
                if self.use_cache:
                    hot = self.stats.snapshot().hot_nodes \
                        if self.cache.capacity is not None else None
                    self.cache.store(h1, hot_nodes=hot)
        dt = self.clock() - t0
        self._h_batch.observe(dt)
        self._c_batches.inc()
        if self.dynamic and self._tuning:
            if self.eng.observe_step(dt):
                self._on_rebuild()
            self._tuning = not self.eng.tuner.converged
            if not self._tuning:
                if self._search_opened_at is not None:
                    self.search_sizes.append(
                        self.eng.tuner.measured - self._search_opened_at)
                    self._search_opened_at = None
                if len(self.stats) >= self.min_records:
                    # search just closed: the current window is the traffic
                    # the committed config was tuned under — that's the
                    # drift baseline
                    self._baseline = self.stats.snapshot()
        self._maybe_retune()

        logits = out.cpu().numpy()
        results, off = [], 0
        now = self.clock()
        t_emit = self.tracer.now() if tracing else 0.0
        for p in batch:
            k = p.seeds.size
            res = ServeResult(
                request_id=p.request_id, seeds=p.seeds,
                logits=logits[off:off + k], latency=now - p.t_submit,
                cached=use_cached)
            results.append(res)
            self._h_latency.observe(res.latency)
            if tracing:
                self.tracer.complete(
                    "serve.request", p.t_trace, t_emit, cat="serve",
                    args={"request_id": p.request_id, "n_seeds": int(k),
                          "cached": bool(use_cached),
                          "shadow": not self.record_stats})
            off += k
        if self.record_stats:
            self._c_served.inc(len(results))
        else:   # shadow replay answers no user
            self._c_shadow.inc(len(results))
        return results

    def drain(self) -> List[ServeResult]:
        """Serve until the queue is empty."""
        out: List[ServeResult] = []
        while self._queue:
            out.extend(self.step())
        return out

    # -- traffic-driven re-tuning --------------------------------------------

    def _maybe_retune(self) -> None:
        if not self.dynamic or self._tuning:
            return
        if self.batches % self.check_every != 0:
            return
        if len(self.stats) < self.min_records:
            return
        snap = self.stats.snapshot()
        if self._baseline is None:
            self._baseline = snap
            return
        score = WorkloadStats.drift(self._baseline, snap)
        if score <= self.drift_threshold:
            return
        hot_overlap = (len(set(self._baseline.hot_nodes)
                           & set(snap.hot_nodes))
                       / max(1, len(self._baseline.hot_nodes)))
        self.log(f"[serve.gnn] traffic drift {score:.2f} > "
                 f"{self.drift_threshold:.2f} → retune "
                 f"(rate {self._baseline.rate:.0f}→{snap.rate:.0f}/s, "
                 f"hot-set overlap {hot_overlap:.2f})")
        if self.retune_gate is not None and not self.retune_gate(self, score):
            # deferred: the coordinator drains this replica and calls
            # force_retune() itself (the un-reset baseline keeps the drift
            # signal alive, so a busy coordinator is asked again)
            return
        self.force_retune()

    def force_retune(self, from_cache: bool = False) -> None:
        """Re-open the tuning search under live traffic, immediately.

        The drift path above lands here; a ``ServeCluster`` calls it
        directly on a drained replica.  ``from_cache=True`` adopts the
        shared-ConfigCache entry a sibling replica committed (a single
        validation measurement instead of a re-search; see
        ``DynamicGNNEngine.retune``).  It returns with the card idle: the
        cluster charges its wall time to this replica alone.
        """
        if not self.dynamic or self._tuning:
            return
        self._c_retunes.inc()
        self.tracer.instant("serve.retune", cat="serve",
                            from_cache=bool(from_cache))
        self._baseline = self.stats.snapshot() if len(self.stats) else None
        cfg_before = dict(self.eng.config)
        measured_before = self.eng.tuner.measured
        self.eng.retune(force=True, from_cache=from_cache)
        self._tuning = not self.eng.tuner.converged
        self._search_opened_at = measured_before if self._tuning else None
        if self.eng.config != cfg_before:
            # the forced re-open moved the config immediately — later
            # moves arrive through observe_step; an unchanged config keeps
            # the live tables and the warm cache
            self._on_rebuild()
        self._sync()

    # -- reporting -----------------------------------------------------------

    @property
    def config(self) -> Dict[str, int]:
        return self.eng.config

    def report(self) -> Dict[str, object]:
        """Thin view over the metrics registry (the reference's schema)."""
        return dict(
            served=self._c_served.value, shadow_served=self._c_shadow.value,
            batches=self._c_batches.value,
            pending=self.pending_requests, dropped=0,
            retunes=self._c_retunes.value, rebuilds=self._c_rebuilds.value,
            search_sizes=list(self.search_sizes),
            cache_hit_rate=round(self.cache.hit_rate, 4),
            cache_stores=self.cache.stores,
            cache_invalidations=self.cache.invalidations,
            config=self.config,
            tiers=self.tiers.report() if self.tiers is not None else None,
        )


def run_trace(engine: GNNServeEngine, events) -> List[ServeResult]:
    """Feed a :class:`~repro_torch.serve.traffic.ZipfTraffic`-style event
    stream through the engine: updates apply immediately, requests queue,
    and a micro-batch is served whenever the slots can be filled.  Drains
    at the end — every request is answered."""
    results: List[ServeResult] = []
    for ev in events:
        if isinstance(ev, TrafficEvent) and ev.is_update:
            engine.update_features(ev.update_node, ev.update_value)
            continue
        seeds = ev.seeds if isinstance(ev, TrafficEvent) else ev
        engine.submit(seeds, t=ev.t if isinstance(ev, TrafficEvent) else None)
        while engine.pending_seeds >= engine.slots:
            results.extend(engine.step())
    results.extend(engine.drain())
    return results
