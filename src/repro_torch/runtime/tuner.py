"""Online cross-iteration tuning controller (paper §4, Fig. 10).

(Copy of ``repro/runtime/tuner.py``, which imports nothing of JAX; the port
may not import the JAX package.  tests/test_torch_tuner.py holds the two
copies equal.  The copy adds :func:`make_smem_check`, the feasibility rule
of the port's rings.)

:class:`OnlineTuner` runs the paper's heuristic search — greedy coordinate
descent in the order ``ps → dist → wpb`` with the *retreat* rule and the
*stop-at-top-3* criterion — over **measured** step times delivered one at a
time by the training loop.  The offline helper
:func:`repro.core.autotune.cross_iteration_optimize` pulls measurements
synchronously; training cannot block like that, so here the identical
control flow is expressed as a generator that *yields* the next config to
try and is *sent* the measured latency once the trainer has timed a few
iterations with it:

    tuner = OnlineTuner()
    while not tuner.converged:
        cfg = tuner.propose()          # (ps, dist, pb) to run next
        tuner.observe(measure(cfg))    # median step time under cfg

Extras over the offline search, per the paper's runtime:

* **stop-at-top-3** — after descent + retreat, single-knob neighbors of
  the incumbent are probed until one fails to land in the top-3 recorded
  latencies ("decrease ps... until the updated setting could not make it
  to the top-3 lowest latency performance").
* **warm start** — a cached config (see :mod:`repro.runtime.cache`) is
  measured first so a previously tuned workload starts from its optimum.
* **drift detection** — :meth:`observe_shape` compares the live
  :class:`~repro.core.autotune.WorkloadShape` against the one the search
  converged on; past ``drift_threshold`` relative change the search
  re-opens (warm-started from the old best), because the measured surface
  is stale.
* **budget** — a hard cap on measurements; the search reports the best
  config seen when the budget runs out.
* **audit trail** — every probe / reopen / retreat / adopt / convergence
  lands in ``tuner.audit`` as a structured event (and streams through an
  optional ``audit_sink`` callable), so *why* the runtime picked a config
  is machine-readable instead of buried in launcher prints.  See
  docs/observability.md for the event schema.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.autotune import (HardwareSpec, TPU_V5E, SearchResult,
                             WorkloadShape, vmem_bytes)
from ..kernels.neighbor_agg import blocked_fits

__all__ = ["OnlineTuner", "PerLayerTuner", "make_vmem_check",
           "make_smem_check", "shape_drift"]

_AUDIT_CAP = 10_000   # bounded like the tracer ring buffers


class _AuditMixin:
    """Shared audit-event plumbing for both tuners.

    Events are plain dicts with an ``event`` key (``probe`` / ``reopen``
    / ``retreat`` / ``adopt`` / ``converged`` / ``budget_exhausted``),
    appended to the bounded ``self.audit`` list and streamed through
    ``self.audit_sink`` when one is set (the engine forwards them to its
    tracer/metrics).  A sink that raises never breaks the search.
    """

    def _init_audit(self, audit_sink=None) -> None:
        self.audit: List[dict] = []
        self.audit_sink = audit_sink

    def _emit(self, event: str, **fields) -> None:
        ev = {"event": event, "measured": self.measured, **fields}
        if len(self.audit) >= _AUDIT_CAP:
            del self.audit[:_AUDIT_CAP // 2]
        self.audit.append(ev)
        if self.audit_sink is not None:
            try:
                self.audit_sink(ev)
            except Exception:
                pass

    def observations(self) -> List[Tuple[dict, float]]:
        """Measured ``(config, latency)`` pairs from the audit trail —
        the calibration fit's input (:mod:`repro.obs.calibrate`).
        OnlineTuner probes yield config dicts, PerLayerTuner probes
        per-layer config lists; finite positive latencies only.
        """
        out: List[Tuple[dict, float]] = []
        for ev in self.audit:
            if ev.get("event") != "probe":
                continue
            cfg = ev.get("config") or ev.get("configs")
            lat = ev.get("latency")
            if cfg is None or lat is None:
                continue
            lat = float(lat)
            if math.isfinite(lat) and lat > 0.0:
                out.append((cfg, lat))
        return out

# (ps, dist, pb) — extended with cap / k / fanout / batch when the
# corresponding spaces are configured:
# (ps, dist, pb[, cap][, k][, fanout][, batch])
Key = Tuple[int, ...]

DEFAULT_PS = (1, 2, 4, 8, 16, 32)
DEFAULT_DIST = (1, 2, 4, 8, 16)
DEFAULT_PB = (1, 2, 4, 8, 16)


def make_vmem_check(w: WorkloadShape, hw: HardwareSpec = TPU_V5E,
                    dim_block: int = 128) -> Callable[[int, int, int], bool]:
    """The §4 hardware constraint as a config predicate (VMEM budget)."""

    def check(ps: int, dist: int, pb: int) -> bool:
        tile_rows = -(-w.rows_per_dev // dist)
        return vmem_bytes(ps, pb, dim_block, tile_rows, w.d_feat,
                          w.itemsize) <= hw.vmem_bytes

    return check


def make_smem_check() -> Callable[[int, int, int], bool]:
    """The §4 hardware constraint of the port's rings: K2 must fit
    ``pb`` partitions of ``ps`` slots in one block
    (:func:`repro_torch.kernels.neighbor_agg.blocked_fits`), since a
    ``pb`` that does not fit runs K1 under another name.  ``pb = 0`` asks
    for no ``pb`` at all, which is K1 itself and always fits."""

    def check(ps: int, dist: int, pb: int) -> bool:
        return pb == 0 or blocked_fits(pb, ps)

    return check


def shape_drift(a: WorkloadShape, b: WorkloadShape) -> float:
    """Relative workload change; ``inf`` when shapes are incomparable."""
    if (a.n_dev, a.itemsize) != (b.n_dev, b.itemsize):
        return math.inf
    rel = 0.0
    for fa, fb in ((a.d_feat, b.d_feat), (a.rows_per_dev, b.rows_per_dev),
                   (a.local_edges_max, b.local_edges_max),
                   (a.remote_edges_max, b.remote_edges_max)):
        rel = max(rel, abs(fa - fb) / max(1.0, float(fa)))
    return rel


class OnlineTuner(_AuditMixin):
    """Incremental ps → dist → wpb search over externally-measured latencies.

    ``cap_space`` (optional, the tiered feature path's device-cache
    capacity in rows) adds a FOURTH climbed coordinate after ``pb``:
    larger caches stream fewer cold rows from the host store, so latency
    falls until the hit rate saturates — exactly the
    increase-until-no-improvement shape the paper's climb expects.  With
    a cap_space, config dicts carry a ``cap`` key and table keys are
    4-tuples; without one (the default) behavior is unchanged.

    ``k_space`` (optional, top-k activation-compression widths for the
    sparse ring payload — pipeline.mgg_aggregate_sparse) adds a further
    climbed coordinate after ``cap``.  NOTE the tuner minimizes latency
    alone, and smaller k is (almost) always faster — so the climb lands on
    the smallest candidate.  ``k_space`` is therefore the caller's
    *accuracy-approved* candidate set, not a free search dimension: every
    value in it must already be acceptable accuracy-wise (the fig9 sparsity
    row is the accuracy/speed evidence).  Config dicts carry a ``k`` key.

    ``fanout_space`` / ``batch_space`` (optional, the sampled mini-batch
    path's per-hop neighbor bound and seed-batch size — ``repro.sample``)
    climb after ``k``, in that order.  Both carry the same caveat as
    ``k``: fanout trades accuracy for work (the space must be
    accuracy-approved), and batch trades steps-per-epoch for step time —
    feed the tuner a *per-seed* latency (``dt / batch``) if you want the
    batch climb to optimize throughput rather than raw step time (the
    sampled training loop does).  Config dicts carry ``fanout`` /
    ``batch`` keys.
    """

    def __init__(
        self,
        ps_space: Tuple[int, ...] = DEFAULT_PS,
        dist_space: Tuple[int, ...] = DEFAULT_DIST,
        pb_space: Tuple[int, ...] = DEFAULT_PB,
        *,
        cap_space: Tuple[int, ...] = (),
        k_space: Tuple[int, ...] = (),
        fanout_space: Tuple[int, ...] = (),
        batch_space: Tuple[int, ...] = (),
        vmem_check: Optional[Callable[[int, int, int], bool]] = None,
        top_k: int = 3,
        budget: Optional[int] = None,
        drift_threshold: float = 0.25,
        warm_start: Optional[Dict[str, int]] = None,
        audit_sink: Optional[Callable[[dict], None]] = None,
    ):
        self.ps_space = tuple(sorted(ps_space))
        self.dist_space = tuple(sorted(dist_space))
        self.pb_space = tuple(sorted(pb_space))
        self.cap_space = tuple(sorted(cap_space))
        self.k_space = tuple(sorted(k_space))
        self.fanout_space = tuple(sorted(fanout_space))
        self.batch_space = tuple(sorted(batch_space))
        self.vmem_check = vmem_check
        self.top_k = int(top_k)
        self.budget = budget
        self.drift_threshold = float(drift_threshold)
        self.measured = 0          # total across re-opens (budget applies here)
        self.reopens = 0
        self._shape: Optional[WorkloadShape] = None
        self.table: Dict[Key, float] = {}
        self.trajectory: List[Tuple[Dict[str, int], float]] = []
        self._gen: Optional[Iterator[Key]] = None
        self._pending: Optional[Key] = None
        self._init_audit(audit_sink)
        self.reset(warm_start=warm_start)

    # -- knob/key mapping (3 knobs, + cap/k/fanout/batch when configured) ----

    @property
    def knobs(self) -> Tuple[str, ...]:
        return ("ps", "dist", "pb") \
            + (("cap",) if self.cap_space else ()) \
            + (("k",) if self.k_space else ()) \
            + (("fanout",) if self.fanout_space else ()) \
            + (("batch",) if self.batch_space else ())

    def _key(self, cfg: Dict[str, int]) -> Key:
        key = (int(cfg["ps"]), int(cfg["dist"]), int(cfg["pb"]))
        if self.cap_space:
            key += (int(cfg.get("cap", self.cap_space[0])),)
        if self.k_space:
            key += (int(cfg.get("k", self.k_space[0])),)
        if self.fanout_space:
            key += (int(cfg.get("fanout", self.fanout_space[0])),)
        if self.batch_space:
            key += (int(cfg.get("batch", self.batch_space[0])),)
        return key

    def _cfg(self, key: Key) -> Dict[str, int]:
        return dict(zip(self.knobs, key))

    # -- public protocol -----------------------------------------------------

    def reset(self, warm_start: Optional[Dict[str, int]] = None) -> None:
        """(Re-)open the search; stale measurements are discarded."""
        self.table = {}
        self.trajectory = []
        self._gen = self._search(warm_start)
        self._advance(None)

    @property
    def converged(self) -> bool:
        return self._pending is None

    def propose(self) -> Optional[Dict[str, int]]:
        """Config awaiting a measurement; the best config once converged."""
        if self._pending is None:
            return self.best
        return self._cfg(self._pending)

    def observe(self, latency: float) -> None:
        """Deliver the measured latency for the proposed config."""
        if self._pending is None:
            raise RuntimeError("observe() on a converged tuner — call "
                               "reset() or observe_shape() to re-open")
        self.measured += 1
        self._emit("probe", config=self._cfg(self._pending),
                   latency=float(latency))
        if self.budget is not None and self.measured >= self.budget:
            # budget exhausted: record this sample and stop the search
            key = self._pending
            self.table[key] = float(latency)
            self.trajectory.append((self._cfg(key), float(latency)))
            self._gen.close()
            self._pending = None
            self._emit("budget_exhausted", best=self.best,
                       best_latency=self.best_latency)
            return
        self._advance(float(latency))

    @property
    def best(self) -> Optional[Dict[str, int]]:
        finite = {k: v for k, v in self.table.items() if v < math.inf}
        if not finite:
            return None
        return self._cfg(min(finite, key=finite.get))

    @property
    def best_latency(self) -> float:
        best = self.best
        if best is None:
            return math.inf
        return self.table[self._key(best)]

    def result(self) -> SearchResult:
        """The search outcome in the offline optimizer's result type."""
        best = self.best
        if best is None:
            raise RuntimeError("result() before any finite measurement")
        return SearchResult(best=best, best_latency=self.best_latency,
                            trajectory=list(self.trajectory),
                            table=dict(self.table))

    def reopen(self, warm_start: Optional[Dict[str, int]] = None,
               mode: str = "search", cause: str = "drift") -> None:
        """Re-open the search, warm-started from ``warm_start`` (the best
        config seen so far by default).  ``cause`` tags the audit event
        (``shape_drift`` / ``traffic_drift`` / ``cache_adopt`` / ...).

        Owns the reopen bookkeeping for every drift path — shape drift
        (:meth:`observe_shape`) and caller-forced traffic drift
        (``DynamicGNNEngine.retune(force=True)``) alike.

        ``mode="adopt"`` trusts the warm config instead of re-searching:
        it is measured once (seeding the latency table) and the search
        converges immediately after.  This is the serving cluster's
        shared-cache path — a sibling replica on identical hardware just
        paid for the full re-search under the same traffic shift, so this
        replica validates the committed optimum with a single measurement
        rather than re-exploring.  Falls back to a full search when there
        is no warm config or it fails the VMEM check.
        """
        self.reopens += 1
        warm = warm_start if warm_start is not None else self.best
        self._emit("reopen", cause=cause, mode=mode, warm=warm,
                   reopens=self.reopens)
        if (mode == "adopt" and warm is not None
                and (self.vmem_check is None
                     or self.vmem_check(warm["ps"], warm["dist"],
                                        warm["pb"]))):
            self.table = {}
            self.trajectory = []
            self._gen = self._adopt(warm)
            self._advance(None)
            self._emit("adopt", config=dict(warm))
        else:
            self.reset(warm_start=warm)

    def _adopt(self, warm: Dict[str, int]):
        key = self._key(warm)
        lat = yield key
        self.table[key] = float(lat)
        self.trajectory.append((self._cfg(key), self.table[key]))

    def observe_shape(self, shape: WorkloadShape) -> bool:
        """Report the live workload shape; True ⇔ drift re-opened the search."""
        if self._shape is None:
            self._shape = shape
            return False
        if shape_drift(self._shape, shape) <= self.drift_threshold:
            return False
        self._shape = shape
        self.reopen(cause="shape_drift")
        return True

    # -- the search as a generator (identical control flow to the offline
    #    cross_iteration_optimize, plus warm start and top-3 refinement) -----

    def _advance(self, latency: Optional[float]) -> None:
        try:
            self._pending = self._gen.send(latency)
        except StopIteration:
            self._pending = None
            self._emit("converged", best=self.best,
                       best_latency=self.best_latency)

    def _search(self, warm: Optional[Dict[str, int]]):
        table, traj = self.table, self.trajectory
        caps = self.cap_space
        c0 = caps[0] if caps else None
        ks = self.k_space
        k0 = ks[0] if ks else None
        fos = self.fanout_space
        f0 = fos[0] if fos else None
        bts = self.batch_space
        bt0 = bts[0] if bts else None

        def mget(ps: int, dist: int, pb: int, cap: Optional[int] = c0,
                 k: Optional[int] = k0, fanout: Optional[int] = f0,
                 batch: Optional[int] = bt0):
            key = (int(ps), int(dist), int(pb)) \
                + ((int(cap),) if caps else ()) \
                + ((int(k),) if ks else ()) \
                + ((int(fanout),) if fos else ()) \
                + ((int(batch),) if bts else ())
            if key not in table:
                # cap (feature cache in HBM), k (ring payload width) and
                # fanout/batch (host-side sampling geometry) never touch
                # VMEM, so feasibility is checked on (ps, dist, pb) only
                if self.vmem_check is not None \
                        and not self.vmem_check(*key[:3]):
                    table[key] = math.inf
                    traj.append((self._cfg(key), math.inf))
                else:
                    lat = yield key
                    table[key] = float(lat)
                    traj.append((self._cfg(key), table[key]))
            return table[key]

        def mget_key(key: Key):
            # keys lay out as self.knobs (ps, dist, pb, then only the
            # CONFIGURED extras) — positional unpacking into mget's full
            # parameter list would misassign extras when some spaces are
            # absent (e.g. a fanout landing in the cap slot), probing a
            # cached key forever instead of the intended neighbor
            cfg = self._cfg(key)
            return (yield from mget(cfg["ps"], cfg["dist"], cfg["pb"],
                                    cfg.get("cap", c0), cfg.get("k", k0),
                                    cfg.get("fanout", f0),
                                    cfg.get("batch", bt0)))

        def climb(values, cur, f):
            best, best_lat = cur, (yield from f(cur))
            for v in values:
                if v <= cur:
                    continue
                lat = yield from f(v)
                if lat < best_lat:
                    best, best_lat = v, lat
                else:
                    break  # paper: stop the climb once latency increases
            return best

        p0, d0, b0 = self.ps_space[0], self.dist_space[0], self.pb_space[0]
        if warm is not None:
            # warm start: the cached optimum is measured first, so it seeds
            # the table (and is the committed answer if nothing beats it).
            yield from mget(warm["ps"], warm["dist"], warm["pb"],
                            warm.get("cap", c0), warm.get("k", k0),
                            warm.get("fanout", f0), warm.get("batch", bt0))

        ps = yield from climb(self.ps_space, p0,
                              lambda v: mget(v, d0, b0))
        dist = yield from climb(self.dist_space, d0,
                                lambda v: mget(ps, v, b0))
        pb = yield from climb(self.pb_space, b0,
                              lambda v: mget(ps, dist, v))
        cap = c0
        if caps:
            # capacity climbs LAST: it buys bandwidth with memory, so it
            # only moves once the schedule knobs have settled
            cap = yield from climb(caps, c0, lambda v: mget(ps, dist, pb, v))
        kk = k0
        if ks:
            # k climbs after the schedule knobs: it trades accuracy for
            # wire bytes, so it only moves on the settled schedule (and a
            # pure latency objective keeps it at the space's floor — see
            # the class docstring on k_space being accuracy-approved).
            kk = yield from climb(ks, k0,
                                  lambda v: mget(ps, dist, pb, cap, v))
        fo = f0
        if fos:
            # sampling geometry climbs last of all: fanout bounds per-hop
            # work (accuracy-approved space, like k) ...
            fo = yield from climb(fos, f0,
                                  lambda v: mget(ps, dist, pb, cap, kk, v))
        bt = bt0
        if bts:
            # ... and batch amortizes fixed per-step cost over more seeds —
            # it only climbs when the caller feeds per-seed latencies
            # (dt / batch), under which larger batches win until the
            # device saturates.
            bt = yield from climb(bts, bt0,
                                  lambda v: mget(ps, dist, pb, cap, kk, fo,
                                                 v))

        # Retreat rule: if pb never improved, drop ps one notch and retry pb
        # (on the climbed cap/k/fanout/batch, so the probes stay on the
        # incumbent's slice).
        if pb == b0 and ps != p0:
            ps_retreat = self.ps_space[max(0, self.ps_space.index(ps) - 1)]
            pb2 = yield from climb(self.pb_space, b0,
                                   lambda v: mget(ps_retreat, dist, v, cap,
                                                  kk, fo, bt))
            a = yield from mget(ps_retreat, dist, pb2, cap, kk, fo, bt)
            b = yield from mget(ps, dist, pb, cap, kk, fo, bt)
            if a < b:
                self._emit("retreat", ps_from=ps, ps_to=ps_retreat,
                           pb_from=pb, pb_to=pb2, latency=a)
                ps, pb = ps_retreat, pb2

        # Stop-at-top-3: probe unmeasured single-knob neighbors of the
        # incumbent until one cannot make it into the top-k latencies.
        while True:
            finite = {k: v for k, v in table.items() if v < math.inf}
            if not finite:
                return
            incumbent = min(finite, key=finite.get)
            cands = [k for k in self._neighbors(incumbent) if k not in table]
            if not cands:
                return
            cut = sorted(finite.values())[:self.top_k][-1]
            lat = yield from mget_key(cands[0])
            if lat > cut:
                return

    def _neighbors(self, key: Key) -> List[Key]:
        """Single-knob ±1-notch moves around ``key`` (deterministic order)."""
        out: List[Key] = []
        spaces = (self.ps_space, self.dist_space, self.pb_space) \
            + ((self.cap_space,) if self.cap_space else ()) \
            + ((self.k_space,) if self.k_space else ()) \
            + ((self.fanout_space,) if self.fanout_space else ()) \
            + ((self.batch_space,) if self.batch_space else ())
        for dim, space in enumerate(spaces):
            i = space.index(key[dim]) if key[dim] in space else None
            if i is None:
                continue
            for j in (i - 1, i + 1):
                if 0 <= j < len(space):
                    nk = list(key)
                    nk[dim] = space[j]
                    out.append(tuple(nk))
        return out


class PerLayerTuner(_AuditMixin):
    """Layer-wise (ps, dist, wpb) search over full-forward step times.

    GNN layers have radically different shapes (GCN: wide input layer vs a
    16-dim hidden layer), so one global config leaves latency on the table.
    This tuner lifts the paper's coordinate descent one level: the *layer*
    becomes the outer coordinate.

    Phases (one :class:`OnlineTuner` each, identical inner control flow):

    1. **global** — every layer shares the candidate config; warm-started
       from the cached config if one exists.  This is the pre-refactor
       search, kept as the cheap first approximation.
    2. **per-layer ℓ = 0..L-1** — layer ℓ's knobs move, every other layer
       is pinned (layers < ℓ at their committed optimum, layers > ℓ at the
       global optimum); each phase warm-starts from the global best, so
       its first measurement re-validates the incumbent under the current
       pinning.
    3. **fuse ℓ** (only with ``fuse_space=(False, True)``) — after layer
       ℓ's schedule commits, its ``fuse_update`` flag is probed with ONE
       measurement of the committed configs with layer ℓ's fuse flipped;
       the flip is kept iff it beats the phase's committed latency.  A
       boolean knob needs no climb — a single flip probe per layer is the
       entire dimension, so the fourth per-layer knob costs at most L
       extra measurements.

    ``cap_space`` makes the tiered feature-cache capacity a tuned knob.
    Capacity is a *global* resource (one device cache feeds every layer),
    so only the global phase's sub-tuner climbs it; the committed ``cap``
    is then pinned into every layer config for the per-layer phases.

    ``k_space`` does the same for the top-k sparse-ring payload width:
    the global phase climbs ``k`` (over the caller's accuracy-approved
    candidates — see :class:`OnlineTuner`) and the committed value is
    pinned into every layer config.  Model stages apply it to hidden
    layers only (layer 0 always rides the dense ring).

    ``fanout_space`` / ``batch_space`` make the sampled mini-batch
    geometry (``repro.sample``) tuned knobs.  One block pipeline feeds
    every layer — sampling geometry is global like capacity — so only
    the global phase's sub-tuner climbs them; the committed values are
    pinned into every layer config (see :class:`OnlineTuner` for the
    per-seed-latency caveat on ``batch``).

    Every ``observe`` is the latency of the FULL forward under the proposed
    per-layer configs, so each phase's table is a valid surface for its
    free layer.  The measurement ``budget`` is shared across all phases —
    when it runs out the search commits the best configs seen so far.
    The public protocol mirrors :class:`OnlineTuner` with per-layer lists
    in place of single config dicts.
    """

    def __init__(
        self,
        num_layers: int,
        ps_space: Tuple[int, ...] = DEFAULT_PS,
        dist_space: Tuple[int, ...] = DEFAULT_DIST,
        pb_space: Tuple[int, ...] = DEFAULT_PB,
        *,
        cap_space: Tuple[int, ...] = (),
        k_space: Tuple[int, ...] = (),
        fanout_space: Tuple[int, ...] = (),
        batch_space: Tuple[int, ...] = (),
        fuse_space: Tuple[bool, ...] = (False,),
        vmem_checks=None,   # None | callable | per-layer sequence of callables
        top_k: int = 3,
        budget: Optional[int] = None,
        drift_threshold: float = 0.25,
        warm_start=None,    # None | global dict | per-layer list of dicts
        tune_global_first: bool = True,
        audit_sink: Optional[Callable[[dict], None]] = None,
    ):
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        self.num_layers = int(num_layers)
        self.ps_space = tuple(sorted(ps_space))
        self.dist_space = tuple(sorted(dist_space))
        self.pb_space = tuple(sorted(pb_space))
        self.cap_space = tuple(sorted(cap_space))
        self.k_space = tuple(sorted(k_space))
        self.fanout_space = tuple(sorted(fanout_space))
        self.batch_space = tuple(sorted(batch_space))
        self.fuse_space = tuple(dict.fromkeys(bool(f) for f in fuse_space))
        if not self.fuse_space:
            self.fuse_space = (False,)
        if vmem_checks is None or callable(vmem_checks):
            vmem_checks = [vmem_checks] * self.num_layers
        if len(vmem_checks) != self.num_layers:
            raise ValueError("one vmem check per layer required")
        self.vmem_checks = list(vmem_checks)
        self.top_k = int(top_k)
        self.budget = budget
        self.drift_threshold = float(drift_threshold)
        self.tune_global_first = bool(tune_global_first)
        self.measured = 0
        self.reopens = 0
        self._shapes: Optional[List[WorkloadShape]] = None
        self.trajectory: List[Tuple[List[Dict[str, int]], float]] = []
        self._init_audit(audit_sink)
        self.reset(warm_start=warm_start)

    # -- public protocol -----------------------------------------------------

    @property
    def _tune_fuse(self) -> bool:
        return len(self.fuse_space) > 1

    def reset(self, warm_start=None) -> None:
        """(Re-)open the search; stale measurements are discarded."""
        self.trajectory = []
        self._best_lat = math.inf
        self._best_cfgs: Optional[List[Dict[str, int]]] = None
        default = dict(ps=self.ps_space[0], dist=self.dist_space[0],
                       pb=self.pb_space[0])
        if isinstance(warm_start, dict):
            global_warm, layer_warms = dict(warm_start), None
        elif warm_start is not None:          # per-layer warm start
            layer_warms = [dict(c) for c in warm_start]
            if len(layer_warms) != self.num_layers:
                raise ValueError("one warm config per layer required")
            global_warm = None
        else:
            global_warm, layer_warms = None, None
        self._configs = (list(layer_warms) if layer_warms is not None
                         else [dict(global_warm or default)
                               for _ in range(self.num_layers)])
        if self._tune_fuse:
            for c in self._configs:
                c.setdefault("fuse", bool(self.fuse_space[0]))
        self._phases: List[Tuple] = []
        if self.tune_global_first and layer_warms is None:
            self._phases.append(("global", global_warm))
        for i in range(self.num_layers):
            self._phases.append(("layer", i))
            if self._tune_fuse:
                self._phases.append(("fuse", i))
        self._sub: Optional[OnlineTuner] = None
        self._sub_layer: Optional[int] = None
        self._adopt_pending = False
        self._fuse_pending: Optional[int] = None
        self._phase_lat = math.inf
        self._done = False
        self._start_next_phase()

    @property
    def converged(self) -> bool:
        return self._done

    def propose(self) -> Optional[List[Dict[str, int]]]:
        """Per-layer configs awaiting a measurement (the best once done)."""
        if self._done:
            return self.best
        if self._adopt_pending:
            return [dict(c) for c in self._configs]
        if self._fuse_pending is not None:
            out = [dict(c) for c in self._configs]
            lf = self._fuse_pending
            out[lf]["fuse"] = not out[lf].get("fuse", False)
            return out
        cand = self._sub.propose()
        if self._sub_layer is None:           # global phase
            # merge keeps per-layer extras (fuse) while the shared
            # candidate moves every layer's (ps, dist, pb[, cap])
            return [{**dict(c), **dict(cand)} for c in self._configs]
        out = [dict(c) for c in self._configs]
        out[self._sub_layer] = {**out[self._sub_layer], **dict(cand)}
        return out

    def observe(self, latency: float) -> None:
        """Deliver the full-forward latency for the proposed configs."""
        if self._done:
            raise RuntimeError("observe() on a converged tuner — call "
                               "reset() or reopen() to re-open")
        latency = float(latency)
        cfgs = self.propose()
        self.measured += 1
        self.trajectory.append((cfgs, latency))
        self._emit("probe", phase=self._phase_name(), configs=cfgs,
                   latency=latency)
        if latency < self._best_lat:
            self._best_lat, self._best_cfgs = latency, cfgs
        if self._adopt_pending:
            # shared-cache adoption: the single validation measurement
            # closes the search (see OnlineTuner.reopen(mode="adopt"))
            self._adopt_pending = False
            self._done = True
            self._emit("adopt", configs=cfgs, latency=latency)
            return
        if self._fuse_pending is not None:
            # single flip probe: keep the flip iff it beats the latency the
            # layer phase committed at
            lf = self._fuse_pending
            self._fuse_pending = None
            if latency < self._phase_lat:
                self._configs[lf]["fuse"] = \
                    not self._configs[lf].get("fuse", False)
                self._phase_lat = latency
            self._start_next_phase()
        else:
            self._sub.observe(latency)
            while (not self._done and self._sub is not None
                   and self._sub.converged):
                self._commit_phase()
        if (self.budget is not None and self.measured >= self.budget
                and not self._done):
            self._commit_phase(exhausted=True)
            self._emit("budget_exhausted", best=self.best,
                       best_latency=self._best_lat)
        if self._done:
            self._emit("converged", best=self.best,
                       best_latency=self._best_lat)

    def _phase_name(self) -> str:
        if self._adopt_pending:
            return "adopt"
        if self._fuse_pending is not None:
            return f"fuse:{self._fuse_pending}"
        if self._sub_layer is None:
            return "global"
        return f"layer:{self._sub_layer}"

    @property
    def best(self) -> Optional[List[Dict[str, int]]]:
        """Best *measured* joint configs (never worse than any phase pick)."""
        if self._best_cfgs is None:
            return None
        return [dict(c) for c in self._best_cfgs]

    @property
    def best_latency(self) -> float:
        return self._best_lat

    def reopen(self, warm_start=None, mode: str = "search",
               cause: str = "drift") -> None:
        """Re-open per-layer phases, warm-started from ``warm_start`` (the
        best configs so far by default — traffic/shape drift made the
        measured surface stale).  ``cause`` tags the audit event.

        ``mode="adopt"`` with a per-layer warm list trusts it outright:
        the joint configs are measured once and the search converges (the
        serving cluster's shared-cache path; see
        :meth:`OnlineTuner.reopen`).  Falls back to the phase search when
        the warm list is missing, wrongly sized, or VMEM-infeasible.
        """
        self.reopens += 1
        warm = warm_start if warm_start is not None \
            else (self.best or self._configs)
        self._emit("reopen", cause=cause, mode=mode, warm=warm,
                   reopens=self.reopens)
        if mode == "adopt" and self._adoptable(warm):
            self.trajectory = []
            self._best_lat = math.inf
            self._best_cfgs = None
            self._configs = [dict(c) for c in warm]
            self._phases = []
            self._sub = None
            self._sub_layer = None
            self._adopt_pending = True
            self._done = False
        else:
            if isinstance(warm, list) and warm \
                    and len(warm) != self.num_layers:
                # unusably-sized warm list (layer count moved since it was
                # recorded): resize rather than raise
                warm = self._resize_warm(warm)
            self.reset(warm_start=warm)

    def _resize_warm(self, warm: List[Dict[str, int]]) \
            -> List[Dict[str, int]]:
        """Fit a per-layer warm list to the current layer count — extra
        layers seed from the last known config."""
        return ([dict(c) for c in warm]
                + [dict(warm[-1])] * self.num_layers)[:self.num_layers]

    def _adoptable(self, warm) -> bool:
        if not isinstance(warm, list) or len(warm) != self.num_layers:
            return False
        return all(
            check is None or check(c["ps"], c["dist"], c["pb"])
            for c, check in zip(warm, self.vmem_checks))

    def reconfigure(
        self,
        num_layers: Optional[int] = None,
        vmem_checks=None,
        warm_start=None,
    ) -> None:
        """Re-shape an already-reopened search: the layer count and/or the
        feasibility predicates changed (drift moved the per-layer widths or
        the model gained/lost layers).  The warm start — the previous best
        by default — is resized to the new layer count (extra layers seed
        from the last known config).  Does NOT count as another reopen;
        callers invoke it right after the reopen that detected the change.
        """
        if num_layers is not None:
            if num_layers < 1:
                raise ValueError("num_layers must be >= 1")
            self.num_layers = int(num_layers)
        if vmem_checks is not None:
            if callable(vmem_checks):
                vmem_checks = [vmem_checks] * self.num_layers
            if len(vmem_checks) != self.num_layers:
                raise ValueError("one vmem check per layer required")
            self.vmem_checks = list(vmem_checks)
        elif len(self.vmem_checks) != self.num_layers:
            self.vmem_checks = (self.vmem_checks
                                + [self.vmem_checks[-1]] * self.num_layers
                                )[:self.num_layers]
        if warm_start is None:
            warm_start = self.best or self._configs
        if isinstance(warm_start, list) and warm_start:
            warm_start = self._resize_warm(warm_start)
        self.reset(warm_start=warm_start)

    def observe_shape(self, shapes) -> bool:
        """Report live per-layer shapes; True ⇔ drift re-opened the search."""
        if isinstance(shapes, WorkloadShape):
            shapes = [shapes]
        shapes = list(shapes)
        if self._shapes is None:
            self._shapes = shapes
            return False
        drift = max(shape_drift(a, b)
                    for a, b in zip(self._shapes, shapes)) \
            if len(shapes) == len(self._shapes) else math.inf
        if drift <= self.drift_threshold:
            return False
        self._shapes = shapes
        self.reopen(cause="shape_drift")
        return True

    # -- internals -----------------------------------------------------------

    def _layer_check(self, layer: Optional[int]):
        if layer is not None:
            return self.vmem_checks[layer]
        checks = [c for c in self.vmem_checks if c is not None]
        if not checks:
            return None
        return lambda ps, dist, pb: all(c(ps, dist, pb) for c in checks)

    def _start_next_phase(self) -> None:
        while self._phases:
            phase = self._phases.pop(0)
            if phase[0] == "fuse":
                # one flip probe of the just-committed layer (no sub-tuner)
                self._fuse_pending = phase[1]
                self._sub = None
                self._sub_layer = None
                return
            if phase[0] == "global":
                self._sub_layer = None
                warm = phase[1]
            else:
                self._sub_layer = phase[1]
                warm = dict(self._configs[self._sub_layer])
            self._sub = OnlineTuner(
                self.ps_space, self.dist_space, self.pb_space,
                # capacity is a global resource: only the global phase's
                # sub-tuner climbs it (pinned for per-layer phases)
                cap_space=self.cap_space if self._sub_layer is None else (),
                # k is likewise climbed globally: the paper's accuracy
                # budget is end-to-end, so per-layer phases keep it pinned
                k_space=self.k_space if self._sub_layer is None else (),
                # sampling geometry (one block pipeline feeds all layers)
                # is global too
                fanout_space=(self.fanout_space
                              if self._sub_layer is None else ()),
                batch_space=(self.batch_space
                             if self._sub_layer is None else ()),
                vmem_check=self._layer_check(self._sub_layer),
                top_k=self.top_k, warm_start=warm,
            )
            if not self._sub.converged:
                return
            self._apply_sub_best()  # degenerate space: nothing to measure
        self._done = True
        self._sub = None

    def _apply_sub_best(self) -> None:
        if self._sub is None:
            return
        best = self._sub.best
        if best is None:
            return
        if self._sub_layer is None:
            # merge: the global winner (incl. any committed cap) lands in
            # every layer while per-layer extras (fuse) persist
            self._configs = [{**dict(c), **dict(best)}
                             for c in self._configs]
        else:
            self._configs[self._sub_layer] = \
                {**self._configs[self._sub_layer], **dict(best)}

    def _commit_phase(self, exhausted: bool = False) -> None:
        if self._sub is not None:
            self._phase_lat = self._sub.best_latency
        self._apply_sub_best()
        if exhausted:
            self._phases = []
            self._done = True
            self._sub = None
            self._fuse_pending = None
            return
        self._start_next_phase()
