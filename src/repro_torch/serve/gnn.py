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

The tiered feature store, the fanout-bounded frontier and the cluster's
retune gate belong to later slices: asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
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


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} arrives with the {slice_name} slice "
                               f"of the port")


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
        retune_gate=None,
        log_fn: Callable[[str], None] = lambda _s: None,
        clock: Callable[[], float] = time.perf_counter,
        tracer=None,
        metrics: Optional[MetricsRegistry] = None,
        obs_labels: Optional[dict] = None,
    ):
        if feature_store is not None or feature_capacity is not None \
                or hotset_path is not None:
            raise _later("the tiered feature store", "tiered-store")
        if frontier_fanout is not None:
            raise _later("the fanout-bounded frontier", "sampled-blocks")
        if retune_gate is not None:
            raise _later("the cluster retune gate", "cluster")
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
        self.log = log_fn
        self.clock = clock
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
        self._refresh_tables()

    # -- registry-backed counters --------------------------------------------

    @property
    def served(self) -> int:
        return self._c_served.value

    @property
    def batches(self) -> int:
        return self._c_batches.value

    @property
    def retunes(self) -> int:
        return self._c_retunes.value

    @property
    def rebuilds(self) -> int:
        return self._c_rebuilds.value

    # -- layout ---------------------------------------------------------------

    def _refresh_tables(self) -> None:
        """(Re-)pad the feature table for the CURRENT plan layout."""
        self.xp = self.eng.shard(self.eng.pad(self.x))

    def _on_rebuild(self) -> None:
        self._c_rebuilds.inc()
        self.tracer.instant("serve.rebuild", cat="serve",
                            config=self.eng.config)
        self._refresh_tables()
        # the padded layout may have moved with dist — the cached table's
        # rows no longer line up; recompute on next batch
        self.cache.invalidate()

    # -- steps ----------------------------------------------------------------

    def _sync(self) -> None:
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize(self.eng.device)

    def _step_full(self, rows: torch.Tensor):
        with torch.inference_mode():
            h1 = apply_stage(self.model, self.params, self.eng, self.xp, 0)
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
        with ``.at[row].set``) and explicitly invalidates the layer-1 rows
        that aggregate it (reverse edges, self-loop included).  Returns the
        number of rows invalidated."""
        value = np.asarray(value, dtype=np.float32)
        self.x[int(node)] = value
        row = int(pgas_rows(self.eng.plan, np.array([node]))[0])
        self.xp[row] = torch.from_numpy(value).to(self.xp.device)
        dirty = self.rev.row(int(node))
        return self.cache.invalidate(dirty)

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
            if self.k_hops > 0:
                fk_size = np.unique(np.concatenate(
                    [f_need,
                     neighbors_of(self.g_full, f_need).astype(np.int64)])
                ).size
            else:
                fk_size = f_need.size
            misses = self.cache.lookup(f_need)
        self.stats.record(batch[-1].t_arrival, seeds, fk_size,
                          n_requests=len(batch))

        use_cached = self.use_cache and not self._tuning and misses == 0
        t0 = self.clock()
        with self.tracer.span("serve.aggregate", cat="serve",
                              cached=bool(use_cached),
                              frontier=int(fk_size)):
            if use_cached:
                out = self._step_cached(rows)
                self._sync()
            else:
                out, h1 = self._step_full(rows)
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
                          "cached": bool(use_cached)})
            off += k
        self._c_served.inc(len(results))
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
        self.force_retune()

    def force_retune(self, from_cache: bool = False) -> None:
        """Re-open the tuning search under live traffic, immediately.

        The drift path above lands here.  ``from_cache=True`` adopts the
        shared-ConfigCache entry another process committed (a single
        validation measurement instead of a re-search; see
        ``DynamicGNNEngine.retune``).
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

    # -- reporting -----------------------------------------------------------

    @property
    def config(self) -> Dict[str, int]:
        return self.eng.config

    def report(self) -> Dict[str, object]:
        """Thin view over the metrics registry (the reference's schema)."""
        return dict(
            served=self._c_served.value, shadow_served=0,
            batches=self._c_batches.value,
            pending=self.pending_requests, dropped=0,
            retunes=self._c_retunes.value, rebuilds=self._c_rebuilds.value,
            search_sizes=list(self.search_sizes),
            cache_hit_rate=round(self.cache.hit_rate, 4),
            cache_stores=self.cache.stores,
            cache_invalidations=self.cache.invalidations,
            config=self.config,
            tiers=None,
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
