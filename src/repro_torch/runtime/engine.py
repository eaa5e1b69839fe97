"""DynamicGNNEngine — the paper's intelligent runtime around the GNN engine
(counterpart of ``repro/runtime/engine.py``).

Wraps :class:`repro_torch.core.gnn.GNNEngine` so the aggregation
configuration ``(ps, dist, pb)`` can change *during* training without
touching model parameters: the training loop feeds each iteration's wall
time into :meth:`observe_step`; once a
:class:`~repro_torch.runtime.profiler.LatencyWindow` fills, the reduced
measurement goes to the :class:`~repro_torch.runtime.tuner.OnlineTuner`,
and whenever the tuner moves to a new candidate (or commits its final
answer) the engine rebuilds the aggregation plan and its device arrays
for the new knobs.

On the card ``pb`` selects the gather-sum kernel: ``pb = 0`` runs K1
(``gather_sum_pipelined``, no ``pb``), ``pb ≥ 1`` runs K2
(``gather_sum_blocked``) with that many partitions a block.  On every
ring the feasibility rule is K2's shared-memory fit
(:func:`~repro_torch.runtime.tuner.make_smem_check`).  A move that
changes only ``pb``, ``fanout`` or ``batch`` keeps the plan and its
device arrays; any other move releases the old ones before building the
new.  Where the plain versions
run (a CPU ring, or ``use_kernel=False``) every ``pb`` is the same
computation, so ``pb_space`` collapses to its minimum.

Only the *engine* state is rebuilt.  Model parameters never move; what
DOES change with ``dist`` is the padded layout (``rows_per_dev`` is padded
to a multiple of ``dist``), so ``observe_step`` returns ``True`` when a
rebuild happened and the caller must re-pad its node tables (see
``launch/train_gnn.py``'s ``--dynamic-tune``).  Padded rows are masked out
of both the loss and the aggregation, and every kernel is deterministic,
so the loss trajectory under any fixed config is bitwise identical to a
static :class:`GNNEngine` run with that config.

A :class:`~repro_torch.runtime.cache.ConfigCache` (optional) warm-starts
the search from the config a previous run converged to for the same
workload-shape + hardware fingerprint, and receives the committed config
when this run's search closes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.autotune import (H100_SXM, HardwareSpec, WorkloadShape,
                             layer_workload_shapes)
from ..core.gnn import GNNEngine
from ..core.graph import CSRGraph
from ..obs import NULL_TRACER
from .cache import ConfigCache, hardware_fingerprint
from .profiler import LatencyWindow, ProfileConfig
from .tuner import (DEFAULT_DIST, DEFAULT_PB, DEFAULT_PS, OnlineTuner,
                    PerLayerTuner, make_smem_check)

__all__ = ["DynamicGNNEngine"]


def _finite(obj):
    """JSON-safe copy: non-finite floats become None (Perfetto rejects
    the ``Infinity`` literal Python's json module would otherwise emit)."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def _as_config_dict(cfg) -> Dict:
    """Normalize a tuner proposal: a per-layer list becomes
    ``{"layers": [...]}`` so every config in histories/caches/logs is a
    plain dict."""
    if isinstance(cfg, list):
        return dict(layers=[dict(c) for c in cfg])
    return dict(cfg)


def _on_card(ring) -> bool:
    """Whether ``ring`` lives on a CUDA card (where pb picks a kernel and
    K2's shared-memory fit is the feasibility rule)."""
    return ring.device.type == "cuda"


# knobs that never reach the plan: ``pb`` picks the gather-sum kernel on
# the same plan, ``fanout``/``batch`` are read by the sampling loop
_OFF_PLAN = ("pb", "fanout", "batch")


def _schedule(cfg: Dict) -> Dict:
    """A config without the knobs off the plan: what the plan depends on."""
    if "layers" in cfg:
        return dict(layers=[{k: v for k, v in c.items() if k not in _OFF_PLAN}
                            for c in cfg["layers"]])
    return {k: v for k, v in cfg.items() if k not in _OFF_PLAN}


class DynamicGNNEngine:
    """A GNNEngine whose (ps, dist, pb) re-optimizes across iterations.

    Two tuning modes share one protocol:

    * **global** (an :class:`OnlineTuner`) — one (ps, dist, pb) for every
      layer; configs are ``{ps, dist, pb}`` dicts.
    * **per-layer** (a :class:`PerLayerTuner`, selected by passing
      ``layer_dims`` to :meth:`build`) — each layer runs its own plan over
      the shared partition; configs are ``{"layers": [{ps, dist, pb}, …]}``.
    """

    def __init__(
        self,
        graph: CSRGraph,
        ring,
        *,
        tuner,
        shape: WorkloadShape,
        window: ProfileConfig = ProfileConfig(warmup=1, iters=3),
        cache: Optional[ConfigCache] = None,
        interleave: bool = True,
        use_kernel: bool = True,
        fuse_update: bool = False,
        layer_dims: Optional[Sequence[int]] = None,
        hw: HardwareSpec = H100_SXM,
        log_fn: Callable[[str], None] = lambda _s: None,
        tracer=None,
        metrics=None,
    ):
        self.graph = graph
        self.ring = ring
        self.tuner = tuner
        # observability: tuner audit events flow through _on_audit into the
        # tracer (as tuner.* instants) and metrics registry
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        tuner.audit_sink = self._on_audit
        self.shape = shape
        self.cache = cache
        self.hw = hw
        self.interleave = interleave
        self.use_kernel = use_kernel
        self.fuse_update = fuse_update
        self.layer_dims = list(layer_dims) if layer_dims is not None else None
        self.log = log_fn
        self._window = LatencyWindow(window)
        self.step_count = 0
        self.committed = False
        self._layer_shapes: Optional[List[WorkloadShape]] = None
        # the MODEL's feature width as reported by the caller — in per-layer
        # mode self.shape holds the max aggregation width instead, so the
        # retune() unchanged-d_feat check needs this separately (build()
        # overwrites it with the true model width)
        self._model_d_feat = shape.d_feat
        self._partition = None   # SharedPartition, reused across tuner moves
        self.engine: Optional[GNNEngine] = None
        self.history: List[Tuple[int, Dict[str, int]]] = []
        cfg0 = tuner.propose()
        if cfg0 is None:  # empty search space ⇒ static engine at defaults
            cfg0 = dict(ps=DEFAULT_PS[0], dist=DEFAULT_DIST[0],
                        pb=DEFAULT_PB[0])
            if self.per_layer:
                cfg0 = [cfg0] * len(self.layer_dims)
            self.committed = True
        self._config = _as_config_dict(cfg0)
        self.engine = self._build_engine(self._config)
        self.history.append((0, dict(self._config)))

    @property
    def per_layer(self) -> bool:
        return self.layer_dims is not None

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        graph: CSRGraph,
        ring,
        *,
        d_feat: int,
        ps_space: Tuple[int, ...] = DEFAULT_PS,
        dist_space: Tuple[int, ...] = DEFAULT_DIST,
        pb_space: Tuple[int, ...] = DEFAULT_PB,
        cap_space: Tuple[int, ...] = (),
        k_space: Tuple[int, ...] = (),
        fanout_space: Tuple[int, ...] = (),
        batch_space: Tuple[int, ...] = (),
        tune_fuse: bool = False,
        window: ProfileConfig = ProfileConfig(warmup=1, iters=3),
        cache_path: Optional[str] = None,
        budget: Optional[int] = None,
        drift_threshold: float = 0.25,
        hw: HardwareSpec = H100_SXM,
        interleave: bool = True,
        use_kernel: bool = True,
        fuse_update: bool = False,
        layer_dims: Optional[Sequence[int]] = None,
        log_fn: Callable[[str], None] = lambda _s: None,
        tracer=None,
        metrics=None,
    ) -> "DynamicGNNEngine":
        """``layer_dims`` (one aggregation feature width per layer, e.g.
        ``aggregation_widths(model, params)``) selects per-layer tuning:
        a :class:`PerLayerTuner` searches each layer's (ps, dist, pb) over
        one shared partition, warm-started from the global search.

        ``pb_space`` may hold 0 (no ``pb``: K1) beside K2's block heights.
        ``k_space`` makes the top-k compression width of the hidden
        layers' ring payloads a tuned knob (configs carry ``k``; layer 0
        stays dense).  Offer only widths whose accuracy the caller has
        validated: the tuner's objective is latency.
        ``fanout_space`` / ``batch_space`` make the sampled mini-batch
        geometry tuned knobs (configs carry ``fanout``/``batch``, read
        through :attr:`sample_fanout` / :attr:`sample_batch` by the
        sampling loop; they never reach the ring plans).  Feed per-seed
        latencies (``dt / batch``) to ``observe_step`` if batch should
        optimize throughput.
        ``tune_fuse`` (per-layer mode only) probes flipping each layer's
        fused-update dataflow after its (ps, dist, pb) search settles;
        ``fuse_update`` remains the starting point for every layer.
        ``cap_space`` (the tiered feature cache's capacity) belongs to
        ROADMAP item 5 and raises."""
        if cap_space:
            raise NotImplementedError(
                "tuning the tiered feature-cache capacity arrives with the "
                "tiered-store slice of the port (ROADMAP item 5)")
        if tune_fuse and layer_dims is None:
            raise ValueError(
                "tune_fuse probes a per-layer dataflow knob — pass "
                "layer_dims to select per-layer tuning")
        n_dev = ring.n_dev
        g = graph.with_self_loops()
        if not use_kernel or not _on_card(ring):
            # pb only reaches the gather-sum kernels; where the plain
            # versions run every pb is the identical computation, so
            # probing it would spend real iterations measuring noise
            pb_space = (min(pb_space),)
        cache = ConfigCache(cache_path, hw=hardware_fingerprint(ring.device)) \
            if cache_path else None
        if layer_dims is not None:
            shapes = layer_workload_shapes(g, n_dev, list(layer_dims))
            shape = max(shapes, key=lambda s: s.d_feat)
            warm = cache.get_layers(shapes) if cache is not None else None
            if warm is None and cache is not None:
                # a previous GLOBAL run's entry still seeds phase 1 — look
                # it up under the key global mode writes (d_feat, not the
                # aggregation width, which differs e.g. for unfused GCN)
                warm = cache.get(shapes[0].with_d_feat(int(d_feat)))
            warm = cls._clamp_pb(warm, pb_space)
            tuner = PerLayerTuner(
                len(shapes), ps_space, dist_space, pb_space,
                k_space=k_space,
                fanout_space=fanout_space, batch_space=batch_space,
                fuse_space=((fuse_update, not fuse_update) if tune_fuse
                            else (fuse_update,)),
                vmem_checks=[make_smem_check()] * len(shapes),
                budget=budget, drift_threshold=drift_threshold,
                warm_start=warm,
            )
            tuner.observe_shape(shapes)
        else:
            shape = WorkloadShape.from_graph(g, n_dev, int(d_feat))
            warm = cache.get(shape) if cache is not None else None
            warm = cls._clamp_pb(warm, pb_space)
            tuner = OnlineTuner(
                ps_space, dist_space, pb_space,
                k_space=k_space,
                fanout_space=fanout_space, batch_space=batch_space,
                vmem_check=make_smem_check(),
                budget=budget, drift_threshold=drift_threshold,
                warm_start=warm,
            )
            tuner.observe_shape(shape)
        if warm is not None:
            log_fn(f"[runtime] warm start from cache: {warm}")
        eng = cls(graph, ring, tuner=tuner, shape=shape, window=window,
                  cache=cache, interleave=interleave, use_kernel=use_kernel,
                  fuse_update=fuse_update, layer_dims=layer_dims, hw=hw,
                  log_fn=log_fn, tracer=tracer, metrics=metrics)
        if layer_dims is not None:
            eng._layer_shapes = shapes
        eng._model_d_feat = int(d_feat)
        return eng

    @staticmethod
    def _clamp_pb(warm, pb_space):
        """Cached pb values outside the live space fall back to its floor."""
        if warm is None:
            return None
        if isinstance(warm, list):
            return [dict(c, pb=c["pb"] if c["pb"] in pb_space else pb_space[0])
                    for c in warm]
        if warm["pb"] not in pb_space:
            warm = dict(warm, pb=pb_space[0])
        return warm

    def _pb(self, c: Dict) -> Optional[int]:
        return (int(c["pb"]) or None) if self.use_kernel else None

    def _build_engine(self, cfg: Dict) -> GNNEngine:
        def _lc(c):
            # "fanout"/"batch" (sampling loop — see sample_fanout /
            # sample_batch) never reach the plan; "fuse" selects the
            # layer's dataflow; "k" is the sparse-payload width
            # (0/absent ⇒ dense ring)
            lc = dict(ps=int(c["ps"]), dist=int(c["dist"]), pb=self._pb(c))
            if "fuse" in c:
                lc["fuse_update"] = bool(c["fuse"])
            if c.get("k"):
                lc["topk"] = int(c["k"])
            return lc

        # The node split + locality split depend only on (graph, n_dev):
        # build them once and re-derive only the schedules on tuner moves
        # (invalidated in retune() when the topology changes).
        if "layers" in cfg:
            eng = GNNEngine.build(
                self.graph, self.ring,
                layer_configs=[_lc(c) for c in cfg["layers"]],
                interleave=self.interleave, fuse_update=self.fuse_update,
                partition=self._partition,
            )
        else:
            eng = GNNEngine.build(
                self.graph, self.ring,
                ps=int(cfg["ps"]), dist=int(cfg["dist"]), pb=self._pb(cfg),
                topk=int(cfg["k"]) if cfg.get("k") else None,
                interleave=self.interleave, fuse_update=self.fuse_update,
                partition=self._partition,
            )
        eng.use_kernel = self.use_kernel
        self._partition = eng.partition
        return eng

    def _repb(self, cfg: Dict) -> GNNEngine:
        """The live engine with the ``pb`` knobs of ``cfg``: same plans,
        same device arrays."""
        pbs = [c["pb"] for c in cfg["layers"]] if "layers" in cfg \
            else [cfg["pb"]] * len(self.engine.layer_plans)
        return dataclasses.replace(self.engine, layer_plans=[
            dataclasses.replace(lp, pb=self._pb(dict(pb=pb)))
            for lp, pb in zip(self.engine.layer_plans, pbs)])

    # -- GNNEngine surface (delegation: models take either engine) -----------

    @property
    def plan(self):
        return self.engine.plan

    @property
    def layer_plans(self):
        return self.engine.layer_plans

    def layer_plan(self, layer: int):
        return self.engine.layer_plan(layer)

    @property
    def layer_configs(self) -> List[Dict[str, int]]:
        return self.engine.layer_configs

    @property
    def ring_arrays(self):
        return self.engine.ring_arrays

    @property
    def partition(self):
        return self.engine.partition

    @property
    def deg(self):
        return self.engine.deg

    @property
    def device(self):
        return self.engine.device

    @property
    def config(self) -> Dict:
        return dict(self._config)

    def _global_knob(self, key: str) -> Optional[int]:
        """A globally-pinned optional knob's live value (per-layer configs
        pin one value across layers, so the first carrier is THE value)."""
        cfg = self._config
        if "layers" in cfg:
            for c in cfg["layers"]:
                if key in c:
                    return int(c[key])
            return None
        return int(cfg[key]) if key in cfg else None

    @property
    def sample_fanout(self) -> Optional[int]:
        """The live config's sampled-path per-hop neighbor bound
        (``fanout`` knob), or None when sampling is not being tuned."""
        return self._global_knob("fanout")

    @property
    def sample_batch(self) -> Optional[int]:
        """The live config's sampled-path seed-batch size (``batch``
        knob), or None when sampling is not being tuned."""
        return self._global_knob("batch")

    def pad(self, x: np.ndarray) -> np.ndarray:
        return self.engine.pad(x)

    def shard(self, x):
        return self.engine.shard(x)

    def aggregate(self, x, layer: int = 0, update_w=None, topk=None):
        return self.engine.aggregate(x, layer=layer, update_w=update_w,
                                     topk=topk)

    def aggregate_update(self, x, w, layer: int = 0, topk=None):
        return self.engine.aggregate_update(x, w, layer=layer, topk=topk)

    def stage_topk(self, layer: int):
        return self.engine.stage_topk(layer)

    def gcn_norm_aggregate(self, x, layer: int = 0, topk=None):
        return self.engine.gcn_norm_aggregate(x, layer=layer, topk=topk)

    def gcn_norm_aggregate_update(self, x, w, layer: int = 0, topk=None):
        return self.engine.gcn_norm_aggregate_update(x, w, layer=layer,
                                                     topk=topk)

    def mean_aggregate(self, x, layer: int = 0, topk=None):
        return self.engine.mean_aggregate(x, layer=layer, topk=topk)

    def mean_aggregate_update(self, x, w, layer: int = 0, topk=None):
        return self.engine.mean_aggregate_update(x, w, layer=layer, topk=topk)

    # -- observability -------------------------------------------------------

    @property
    def audit(self) -> List[dict]:
        """The tuner's audit trail (probe/reopen/retreat/adopt/commit
        events) — the machine-readable answer to "why this config"."""
        return self.tuner.audit

    def _on_audit(self, ev: dict) -> None:
        safe = _finite(ev)
        self.tracer.instant("tuner." + ev["event"], cat="tuner", **safe)
        if self.metrics is not None:
            self.metrics.counter("tuner.events", event=ev["event"]).inc()
            if ev["event"] == "probe":
                # model-vs-measured relative error for every probed config
                # (numpy only — no device work on the audit path)
                err = self._model_error(ev)
                if err is not None:
                    self.metrics.histogram("tuner.model_error").observe(err)

    def _model_error(self, ev: dict) -> Optional[float]:
        cfg = ev.get("config") or ev.get("configs")
        lat = ev.get("latency")
        if cfg is None or lat is None or not np.isfinite(lat) or lat <= 0:
            return None
        from ..obs.calibrate import model_latency
        shapes = self._layer_shapes if isinstance(cfg, list) else self.shape
        if shapes is None:
            return None
        try:
            model = model_latency(shapes, cfg, self.hw,
                                  interleave=self.interleave)
        except Exception:
            return None
        return abs(model - float(lat)) / float(lat)

    def calibrate(self, *, params=None, adopt: bool = True):
        """Fit ``self.hw`` to the latencies the search actually measured.

        Runs :func:`repro_torch.obs.calibrate.fit_spec` over the audit
        trail's probe observations; with ``adopt=True`` (default) the
        calibrated spec replaces ``self.hw``, so later model-error
        baselines use it.  Returns the
        :class:`~repro_torch.obs.calibrate.CalibrationResult` (None when
        the trail holds no usable measurements yet).
        """
        from ..obs import calibrate as cal

        obs = self.tuner.observations()
        shapes = self._layer_shapes if self.per_layer else self.shape
        if shapes is None:
            return None
        kw = {} if params is None else {"params": params}
        result = cal.fit_spec(shapes, obs, self.hw,
                              interleave=self.interleave, **kw)
        if result is None:
            return None
        if self.metrics is not None:
            self.metrics.gauge("tuner.calibration_error").set(result.error)
            self.metrics.gauge("tuner.calibration_error_base") \
                .set(result.base_error)
        self.tracer.instant("tuner.calibrate", cat="tuner",
                            error=result.error, base_error=result.base_error,
                            n=result.n_observations)
        self.log(f"[runtime] {result.summary()}")
        if adopt:
            self.hw = result.spec
        return result

    # -- the online tuning protocol ------------------------------------------

    def observe_step(self, dt: float) -> bool:
        """Feed one training iteration's wall time.

        Returns True when the engine was rebuilt for a new config — the
        caller must then re-pad its node tables (layout may have changed
        with ``dist``).
        """
        self.step_count += 1
        if self.metrics is not None:
            self.metrics.histogram("runtime.step_seconds").observe(dt)
        if self.tuner.converged:
            return False
        self._window.add(dt)
        if not self._window.ready:
            return False
        latency = self._window.value()
        self._window.reset()
        self.tuner.observe(latency)
        nxt = self.tuner.propose()
        if self.tuner.converged:
            return self._commit()
        return self._set_config(_as_config_dict(nxt))

    def retune(self, graph: Optional[CSRGraph] = None,
               d_feat: Optional[int] = None, *,
               layer_dims: Optional[Sequence[int]] = None,
               force: bool = False, from_cache: bool = False) -> bool:
        """Drift entry point: the workload changed (graph grew, features
        resized).  Recomputes the WorkloadShape; if it drifted past the
        tuner's threshold the search re-opens (warm-started from the old
        best) and the engine rebuilds against the new graph.

        Per-layer engines report width changes via ``layer_dims``; a
        changed lone ``d_feat`` there is an error.  ``force=True``
        re-opens the search even when the WorkloadShape is unchanged (the
        serving engine's traffic-drift path).  ``from_cache=True`` (with
        ``force``) warm-starts the re-opened search from the shared
        :class:`ConfigCache` entry in *adopt* mode: one validation
        measurement instead of a re-search (falls back to the normal warm
        re-search on a cache miss).
        """
        if graph is not None:
            self.graph = graph
            self._partition = None   # topology changed: re-partition
        if self.per_layer and d_feat is not None \
                and int(d_feat) != self._model_d_feat and layer_dims is None:
            raise ValueError(
                "per-layer engine: report feature-width changes via "
                "retune(layer_dims=[...]) — a lone d_feat cannot describe "
                "per-layer aggregation widths")
        if d_feat is None:
            d_feat = self._model_d_feat if self.per_layer \
                else self.shape.d_feat
        self._model_d_feat = int(d_feat)
        if layer_dims is not None:
            if not self.per_layer:
                raise ValueError("layer_dims on a global-mode engine")
            self.layer_dims = list(layer_dims)
        g = self.graph.with_self_loops()
        n_dev = self.ring.n_dev
        if self.per_layer:
            shapes = layer_workload_shapes(g, n_dev, self.layer_dims)
            shape = max(shapes, key=lambda s: s.d_feat)
            reopened = self.tuner.observe_shape(shapes)
        else:
            shapes = None
            shape = WorkloadShape.from_graph(g, n_dev, int(d_feat))
            reopened = self.tuner.observe_shape(shape)
        adopted = False
        if force and not reopened:
            warm = None
            if from_cache and self.cache is not None:
                warm = (self.cache.get_layers(shapes) if self.per_layer
                        else self.cache.get(shape))
                warm = self._clamp_pb(warm, self.tuner.pb_space)
            if warm is not None:
                self.tuner.reopen(warm_start=warm, mode="adopt",
                                  cause="cache_adopt")
                adopted = True
                self.log(f"[runtime] adopting shared-cache config: {warm}")
            else:
                self.tuner.reopen(cause="traffic_drift")
            reopened = True
        if reopened and self.per_layer and not adopted:
            # the layer count / per-layer widths may have moved: resize the
            # search and rebuild the feasibility predicates against the
            # LIVE shapes
            self.tuner.reconfigure(
                num_layers=len(shapes),
                vmem_checks=[make_smem_check()] * len(shapes))
        if reopened:
            self.shape = shape
            self._layer_shapes = shapes
            self.committed = False
            self._window.reset()
            self.log(f"[runtime] workload drift → search re-opened "
                     f"(reopen #{self.tuner.reopens})")
            nxt = self.tuner.propose()
            if nxt is not None:
                self._set_config(_as_config_dict(nxt),
                                 force_rebuild=graph is not None)
        elif graph is not None:
            # same shape class, new topology: rebuild the plan in place
            self.engine = None
            self.engine = self._build_engine(self._config)
        return reopened

    # -- internals -----------------------------------------------------------

    def _commit(self) -> bool:
        best = self.tuner.best
        self.committed = True
        if best is None:  # nothing measurable (every config infeasible)
            return False
        if self.cache is not None:
            if self.per_layer and self._layer_shapes is not None:
                self.cache.put_layers(self._layer_shapes, best,
                                      self.tuner.best_latency)
            elif not self.per_layer:
                self.cache.put(self.shape, best, self.tuner.best_latency)
        self.log(f"[runtime] tuning converged after "
                 f"{self.tuner.measured} measurements: {best} "
                 f"({self.tuner.best_latency * 1e3:.2f} ms)")
        self.tuner._emit("commit", config=_as_config_dict(best),
                         latency=self.tuner.best_latency,
                         step=self.step_count)
        return self._set_config(_as_config_dict(best))

    def _set_config(self, cfg: Dict,
                    force_rebuild: bool = False) -> bool:
        if cfg == self._config and not force_rebuild:
            return False
        same_plan = not force_rebuild \
            and _schedule(cfg) == _schedule(self._config)
        self._config = dict(cfg)
        if same_plan:
            self.engine = self._repb(self._config)
        else:
            # release the old plan's device arrays before building the new
            self.engine = None
            self.engine = self._build_engine(self._config)
        self.history.append((self.step_count, dict(self._config)))
        self.log(f"[runtime] step {self.step_count}: config → {self._config}")
        return True
