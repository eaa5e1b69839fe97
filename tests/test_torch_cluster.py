"""repro_torch's serving cluster against the JAX reference's, on the CPU.

The same numpy inputs go through both packages in one process (the
reference on its one CPU device):

* the routers' copy picks the reference's replica for every request over
  the same replica states (the splitmix64 hash included);
* two static replicas behind either router route a trace with feature
  updates to the same replica, request by request, as the reference's
  cluster, with the same cached/full passes and logits within rtol 2e-4
  (weights carried by ``params_from_numpy``).

Inside the port, as the reference asserts inside itself: a cluster of one
is bitwise the bare engine, any routing serves the single engine's logits
bitwise, updates fan out, replicas with history are refused, the retune
token is exclusive and its deferrals counted, a replica whose drift
overlapped a sibling's search adopts its commit with one measurement
while a fresh drift re-searches, a drifting trace drops nothing and
serves each replica's offline forward bitwise, the report's counters
are the per-replica sums, and tracing leaves every served bit alone.
The serving property tests of ``tests/test_serve_properties.py`` run on
the port's copies through ``repro_torch.testing.hypo``.  The 4-device
reference cluster (two replicas on disjoint halves) is a case of
``tests/test_torch_serve.py``, whose dump holds it.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import repro.core as RC
from repro.dist import flat_ring_mesh
from repro.serve import GNNServeEngine as RServe
from repro.serve import ServeCluster as RCluster
from repro.serve import TrafficPhase as RPhase
from repro.serve import TrafficSnapshot as RSnapshot
from repro.serve import WorkloadStats as RStats
from repro.serve import ZipfTraffic as RTraffic
from repro.serve import make_router as r_make_router
from repro.serve.router import _mix as r_mix

import repro_torch.core as TC
from repro_torch.dist import VirtualRing
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.runtime import DynamicGNNEngine, ProfileConfig
from repro_torch.serve import (GNNServeEngine, HotNodeCache,
                               LeastLoadRouter, LocalityRouter,
                               ServeCluster, TrafficPhase, TrafficSnapshot,
                               WorkloadStats, ZipfTraffic, make_router,
                               run_trace)
from repro_torch.serve.router import _mix
from repro_torch.testing.hypo import given, settings, strategies as st

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

CPU = "cpu"
D, NCLS = 12, 5


def _graph_setup(seed=0, n=240):
    g = TC.power_law(n, avg_degree=6.0, locality=0.3, seed=seed)
    x = np.random.default_rng(seed).normal(
        size=(g.num_nodes, D)).astype(np.float32)
    params = TC.gcn_init(torch.Generator().manual_seed(seed), D, NCLS)
    return g, x, params


def _static_serve(g, x, params, slots=4, **kw):
    eng = TC.GNNEngine.build(g, VirtualRing(1, CPU), ps=8, dist=1)
    return GNNServeEngine(eng, params, "gcn", x, g, slots=slots, **kw)


def _dynamic_serve(g, x, params, cache_path, slots=4, drift_threshold=0.5,
                   **kw):
    """drift_threshold > 1 makes organic retunes impossible (drift lies in
    [0, 1]): the token and adoption tests drive the gate by hand."""
    eng = DynamicGNNEngine.build(
        g, VirtualRing(1, CPU), d_feat=x.shape[1], ps_space=(2, 4, 8),
        dist_space=(1, 2), pb_space=(0,),
        window=ProfileConfig(warmup=0, iters=1), cache_path=cache_path,
        metrics=kw.get("metrics"))
    return GNNServeEngine(eng, params, "gcn", x, g, slots=slots,
                          stats=WorkloadStats(window=8, top_k=8),
                          drift_threshold=drift_threshold, check_every=2,
                          min_records=4, **kw)


def _trace(P, g, seed=7, update_frac=0.1):
    phases = [P(requests=20, alpha=1.3, rate=150.0, seeds_max=3,
                update_frac=update_frac),
              P(requests=20, alpha=1.3, rate=500.0, rotate=True,
                seeds_max=3, update_frac=update_frac)]
    return list((RTraffic if P is RPhase else ZipfTraffic)(
        g.num_nodes, D, phases, seed=seed))


def _n_requests(events):
    return sum(not ev.is_update for ev in events)


def _offline(srv, apply=TC.gcn_apply):
    """The replica's offline forward over its live features, unpadded."""
    eng = srv.eng
    with torch.inference_mode():
        out = apply(srv.params, eng, eng.shard(eng.pad(srv.x)))
    return TC.unpad_embeddings(eng.plan, out.numpy())


# ---------------------------------------------------------------------------
# routers
# ---------------------------------------------------------------------------

class _FakeCache:
    def __init__(self, ready):
        self._ready = ready

    def ready(self, _seeds):
        return self._ready


class _Fake:
    def __init__(self, pending, ready=False, slots=4):
        self.pending_seeds = pending
        self.slots = slots
        self.cache = _FakeCache(ready)


def test_make_router_and_names():
    assert make_router("load").name == "load"
    assert make_router("locality").name == "locality"
    with pytest.raises(ValueError):
        make_router("random")


def test_mix_equals_reference():
    xs = np.random.default_rng(0).integers(0, 2 ** 62, 500).tolist()
    assert [_mix(v) for v in xs + list(range(64))] == \
        [r_mix(v) for v in xs + list(range(64))]


@pytest.mark.parametrize("name", ["load", "locality"])
def test_router_picks_equal_reference(name):
    """One stream of requests over changing replica states (loads, cache
    readiness, replicas out of rotation): the port's router and the
    reference's pick the same replica every time (their tie-break cursors
    advance together)."""
    rng = np.random.default_rng(1)
    ours, theirs = make_router(name), r_make_router(name)
    for _ in range(400):
        n = int(rng.integers(1, 5))
        reps = [_Fake(int(rng.integers(0, 12)), bool(rng.integers(0, 2)))
                for _ in range(n)]
        avail = [i for i in range(n) if rng.random() < 0.8] or [0]
        seeds = rng.integers(0, 10_000, int(rng.integers(1, 5)))
        assert ours.pick(seeds, reps, avail) == \
            theirs.pick(seeds, reps, avail)
    with pytest.raises(ValueError):
        ours.pick(np.array([1]), [_Fake(0)], [])


def test_least_load_router_picks_emptiest_available():
    reps = [_Fake(5), _Fake(1), _Fake(3)]
    r = LeastLoadRouter()
    assert r.pick(np.array([1]), reps, [0, 1, 2]) == 1
    assert r.pick(np.array([1]), reps, [0, 2]) == 2     # 1 out of rotation


def test_locality_router_is_affine_and_falls_back():
    reps = [_Fake(0), _Fake(0)]
    r = LocalityRouter(load_slack=1.0)
    seeds = np.array([7, 42])
    home = r.pick(seeds, reps, [0, 1])
    assert home == _mix(min((7, 42), key=_mix)) % 2
    assert all(r.pick(seeds, reps, [0, 1]) == home for _ in range(5))
    assert r.pick(seeds, reps, [1 - home]) == 1 - home  # home draining
    reps[home].pending_seeds = 100                      # home backlogged
    assert r.pick(seeds, reps, [0, 1]) == 1 - home
    # a backlogged home prefers a cache-ready replica over a cold idle one
    r = LocalityRouter(load_slack=0.0)
    home = _mix(5) % 3
    reps = [_Fake(0), _Fake(0), _Fake(0)]
    reps[home].pending_seeds = 50
    reps[(home + 1) % 3] = _Fake(10, ready=True)
    assert r.pick(np.array([5]), reps, [0, 1, 2]) == (home + 1) % 3


# ---------------------------------------------------------------------------
# static clusters against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router", ["load", "locality"])
def test_static_clusters_route_as_reference(router):
    """Two static replicas each side, one trace with feature updates and
    a hot-set rotation: every request goes to the reference's replica,
    takes its cached/full pass, and gets its logits within rtol 2e-4."""
    rg = RC.power_law(240, avg_degree=6.0, locality=0.3, seed=2)
    tg = TC.power_law(240, avg_degree=6.0, locality=0.3, seed=2)
    x = np.random.default_rng(2).normal(size=(rg.num_nodes, D)).astype(
        np.float32)
    params = RC.MODEL_ZOO["gcn"][0](jax.random.key(2), D, NCLS, hidden=16,
                                    num_layers=2)
    r_reps = [RServe(RC.GNNEngine.build(rg, flat_ring_mesh(1), ps=8,
                                        dist=1), params, "gcn", x, rg,
                     slots=4) for _ in range(2)]
    t_reps = [_static_serve(tg, x, TC.params_from_numpy(params, CPU))
              for _ in range(2)]
    r_cl = RCluster(r_reps, router=r_make_router(router))
    t_cl = ServeCluster(t_reps, router=make_router(router))
    events = _trace(TrafficPhase, tg, seed=3)
    r_res = r_cl.run_trace(_trace(RPhase, rg, seed=3))
    t_res = t_cl.run_trace(events)
    assert len(r_res) == len(t_res) == _n_requests(events) > 0
    r_by, t_by = ({r.request_id: r for r in res} for res in (r_res, t_res))
    assert sorted(r_by) == sorted(t_by)
    for rid, t in t_by.items():
        r = r_by[rid]
        assert t_cl.replica_of(rid) == r_cl.replica_of(rid)
        assert t.cached == r.cached
        np.testing.assert_array_equal(t.seeds, r.seeds)
        np.testing.assert_allclose(t.logits, r.logits, rtol=2e-4, atol=1e-5)
    assert {t_cl.replica_of(rid) for rid in t_by} == {0, 1}
    rr, tr = r_cl.report(), t_cl.report()
    for key in ("served", "dropped", "pending", "shadow_served"):
        assert rr[key] == tr[key], key
    for p, q in zip(rr["per_replica"], tr["per_replica"]):
        for key in ("served", "batches", "cache_hit_rate", "cache_stores",
                    "cache_invalidations"):
            assert p[key] == q[key], key


# ---------------------------------------------------------------------------
# single-replica equivalence + multi-replica permutation invariance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router", ["load", "locality"])
def test_cluster_of_one_is_bitwise_identical_to_bare_engine(router):
    g, x, params = _graph_setup()
    res_bare = run_trace(_static_serve(g, x, params),
                         _trace(TrafficPhase, g))
    cluster = ServeCluster([_static_serve(g, x, params)],
                           router=make_router(router))
    res_cluster = cluster.run_trace(_trace(TrafficPhase, g))
    assert len(res_bare) == len(res_cluster) > 0
    for ra, rb in zip(res_bare, res_cluster):
        assert ra.request_id == rb.request_id and ra.cached == rb.cached
        np.testing.assert_array_equal(ra.seeds, rb.seeds)
        np.testing.assert_array_equal(ra.logits, rb.logits)   # bitwise
    rep = cluster.report()
    assert rep["dropped"] == 0 and rep["served"] == len(res_bare)


@pytest.mark.parametrize("router", ["load", "locality"])
def test_cluster_results_permutation_invariant_vs_single_engine(router):
    """Any routing serves the single engine's answers bitwise (no
    updates: their order against queued requests is what routing may
    change)."""
    g, x, params = _graph_setup(seed=1)
    by_id = {r.request_id: r for r in run_trace(
        _static_serve(g, x, params),
        _trace(TrafficPhase, g, seed=5, update_frac=0.0))}
    cluster = ServeCluster([_static_serve(g, x, params) for _ in range(3)],
                           router=make_router(router))
    res = cluster.run_trace(_trace(TrafficPhase, g, seed=5, update_frac=0.0))
    assert sorted(r.request_id for r in res) == sorted(by_id)
    for r in res:
        np.testing.assert_array_equal(r.seeds, by_id[r.request_id].seeds)
        np.testing.assert_array_equal(r.logits, by_id[r.request_id].logits)
    assert len({cluster.replica_of(r.request_id) for r in res}) >= 2


def test_update_features_fans_out_to_every_replica():
    g, x, params = _graph_setup(seed=2)
    replicas = [_static_serve(g, x, params) for _ in range(2)]
    cluster = ServeCluster(replicas)
    value = 2.0 * np.ones(D, np.float32)
    assert cluster.update_features(5, value) == 0   # caches still cold
    for r in replicas:
        np.testing.assert_array_equal(r.x[5], value)
        row = TC.pgas_rows(r.eng.plan, np.array([5]))[0]
        np.testing.assert_array_equal(r.xp[row].numpy(), value)


def test_cluster_rejects_replicas_with_history():
    g, x, params = _graph_setup(seed=4, n=120)
    srv = _static_serve(g, x, params)
    srv.submit(np.array([1]))
    srv.step()
    with pytest.raises(ValueError):
        ServeCluster([srv])
    with pytest.raises(ValueError):
        ServeCluster([])


# ---------------------------------------------------------------------------
# staggered retunes + shared-cache warm start
# ---------------------------------------------------------------------------

def _pump_to_completion(cluster, limit=300):
    for _ in range(limit):
        cluster.pump()
        if cluster._token is None:
            return
    raise AssertionError("coordinated retune never completed")


def _converged_pair(tmp_path, seed, trace_seed):
    g, x, params = _graph_setup(seed=seed)
    cache_path = str(tmp_path / "tuned.json")
    r0 = _dynamic_serve(g, x, params, cache_path, drift_threshold=1.1)
    r1 = _dynamic_serve(g, x, params, cache_path, drift_threshold=1.1)
    cluster = ServeCluster([r0, r1], router=LeastLoadRouter())
    for rnd in range(6):
        if not (r0._tuning or r1._tuning):
            break
        cluster.run_trace(ZipfTraffic(g.num_nodes, D, [TrafficPhase(
            requests=40, alpha=1.3, rate=100.0, seeds_max=3)],
            seed=trace_seed + rnd))
    assert not (r0._tuning or r1._tuning)
    return cluster, r0, r1, cache_path


def test_shared_cache_adoption_visits_strictly_fewer_configs(tmp_path):
    """A retune paid for on one replica warm-starts the other from the
    shared ConfigCache when their drift signals overlapped: one
    validation measurement, strictly fewer than the first search."""
    cluster, r0, r1, cache_path = _converged_pair(tmp_path, 3, 20)
    assert r0.retune_gate(r0, 1.0) is False     # token acquired, not inline
    assert cluster._token == 0
    assert r1.retune_gate(r1, 1.0) is False     # deferred while 0 searches
    assert cluster._token == 0
    _pump_to_completion(cluster)
    first = cluster.retune_log[-1]
    assert first["replica"] == 0 and first["committed"]
    assert not first["from_cache"] and first["search_size"] >= 2
    assert r1.retune_gate(r1, 1.0) is False     # its wait overlapped: adopt
    assert cluster._token == 1
    _pump_to_completion(cluster)
    second = cluster.retune_log[-1]
    assert second["replica"] == 1 and second["committed"]
    assert second["from_cache"] and second["search_size"] == 1
    assert second["search_size"] < first["search_size"]
    assert r1.config == r0.config
    assert os.path.exists(cache_path)


def test_fresh_drift_after_commit_does_not_adopt_stale_entry(tmp_path):
    cluster, r0, r1, _ = _converged_pair(tmp_path, 8, 60)
    assert r0.retune_gate(r0, 1.0) is False
    _pump_to_completion(cluster)
    assert cluster.retune_log[-1]["committed"]
    assert r1.retune_gate(r1, 1.0) is False     # fires fresh: no overlap
    assert cluster._token == 1
    _pump_to_completion(cluster)
    last = cluster.retune_log[-1]
    assert last["replica"] == 1 and last["committed"]
    assert not last["from_cache"] and last["search_size"] >= 2


def test_retune_token_is_exclusive_and_deferred_counted(tmp_path):
    cluster, r0, r1, _ = _converged_pair(tmp_path, 6, 40)
    assert r0.retune_gate(r0, 1.0) is False
    assert cluster._token == 0
    assert r1.retune_gate(r1, 1.0) is False
    assert cluster._token == 0 and cluster.deferred_retunes == 1
    assert r0.retune_gate(r0, 1.0) is False     # re-asking: no new schedule
    assert cluster.staggered_retunes == 1
    assert cluster.available == [1]             # 0 drains out of rotation
    _pump_to_completion(cluster)
    assert cluster._token is None and cluster.available == [0, 1]


def test_cluster_trace_with_drift_zero_drops_and_staggered_retune(tmp_path):
    """Rotation + burst over 2 dynamic replicas: every request answered,
    at least one drain → retune → rejoin, the tail's answers within 1e-5
    of each replica's final offline forward (as the reference holds them:
    a tail answer may predate its replica's last move), and once every
    search has closed, served == offline bitwise on every replica."""
    g, x, params = _graph_setup(seed=5, n=300)
    cache_path = str(tmp_path / "tuned.json")
    replicas = [_dynamic_serve(g, x, params, cache_path) for _ in range(2)]
    cluster = ServeCluster(replicas, router=LocalityRouter())
    phases = [TrafficPhase(requests=50, alpha=1.4, rate=100.0, seeds_max=3),
              TrafficPhase(requests=50, alpha=1.4, rate=400.0, rotate=True,
                           seeds_max=3)]
    results = cluster.run_trace(ZipfTraffic(g.num_nodes, D, phases,
                                            seed=11))
    rep = cluster.report()
    assert rep["served"] == len(results) == 100 and rep["dropped"] == 0
    assert rep["staggered_retunes"] >= 1, rep
    assert all(e["shadow_batches"] > 0 or not e["committed"]
               for e in rep["retune_log"])
    assert rep["shadow_served"] > 0
    offline = {i: _offline(srv) for i, srv in enumerate(replicas)}
    for r in results[-8:]:
        np.testing.assert_allclose(
            r.logits, offline[cluster.replica_of(r.request_id)][r.seeds],
            rtol=1e-5, atol=1e-5)
    for rnd in range(10):                       # close the open searches
        if cluster._token is None and not any(r._tuning for r in replicas):
            break
        cluster.run_trace(ZipfTraffic(g.num_nodes, D, [TrafficPhase(
            requests=20, alpha=1.4, rate=100.0, seeds_max=3)],
            seed=30 + rnd))
    assert cluster._token is None and not any(r._tuning for r in replicas)
    for srv in replicas:
        srv.check_every = 10 ** 9
    gids = [cluster.submit(np.array([s])) for s in range(0, 40, 3)]
    served = {r.request_id: r for r in cluster.drain()}
    offline = {i: _offline(srv) for i, srv in enumerate(replicas)}
    assert sorted(served) == gids
    assert {cluster.replica_of(gid) for gid in gids} == {0, 1}
    for gid in gids:
        r = served[gid]
        np.testing.assert_array_equal(
            r.logits, offline[cluster.replica_of(gid)][r.seeds])


def test_cluster_report_counters_equal_per_replica_sums(tmp_path):
    """Every counter of the cluster's report equals the fold of the
    per-replica counters, and the shared registry agrees with both."""
    g, x, params = _graph_setup(seed=5, n=300)
    registry = MetricsRegistry()
    cache_path = str(tmp_path / "tuned.json")
    replicas = [_dynamic_serve(g, x, params, cache_path,
                               feature_capacity=32, metrics=registry,
                               obs_labels={"replica": i}) for i in range(2)]
    cluster = ServeCluster(replicas, router=LocalityRouter(),
                           metrics=registry)
    phases = [TrafficPhase(requests=40, alpha=1.4, rate=100.0, seeds_max=3),
              TrafficPhase(requests=40, alpha=1.4, rate=400.0, rotate=True,
                           seeds_max=3)]
    results = cluster.run_trace(ZipfTraffic(g.num_nodes, D, phases,
                                            seed=11))
    rep = cluster.report()
    per = rep["per_replica"]
    assert rep["served"] == len(results) == 80
    assert rep["served"] == sum(p["served"] for p in per)
    assert rep["shadow_served"] == sum(p["shadow_served"] for p in per)
    assert rep["dropped"] == sum(p["dropped"] for p in per) == 0
    tiers = [p["tiers"] for p in per if p.get("tiers")]
    assert len(tiers) == 2
    for key in ("host_rows_streamed", "cache_rows_served"):
        assert rep[key] == sum(t[key] for t in tiers)
        assert registry.counter_total(f"store.{key}") == rep[key]
    assert registry.counter_total("serve.served") == rep["served"]
    assert registry.counter_total("serve.shadow_served") == \
        rep["shadow_served"]
    assert registry.counter_total("cluster.user_served") == rep["served"]


def test_cluster_served_logits_bitwise_with_tracing():
    """The same trace through two 2-replica clusters, one with a tracer
    on the cluster and on each replica: every served bit equal, and the
    traced run recorded each request's lifecycle on its replica."""
    g, x, params = _graph_setup(seed=9)
    events = _trace(TrafficPhase, g, seed=4)
    n = _n_requests(events)
    runs = []
    for traced in (False, True):
        tracers = [Tracer(pid=i + 1) for i in range(2)] if traced \
            else [None, None]
        replicas = [_static_serve(g, x, params, tracer=t) for t in tracers]
        cluster = ServeCluster(replicas, router=LocalityRouter(),
                               tracer=Tracer() if traced else None)
        runs.append((cluster.run_trace(events), tracers))
    (base, _), (traced, tracers) = runs
    assert len(base) == len(traced) == n > 0
    for a, b in zip(base, traced):
        assert a.request_id == b.request_id and a.cached == b.cached
        np.testing.assert_array_equal(a.logits, b.logits)
    names = [e["name"] for t in tracers for e in t.events()]
    assert names.count("serve.request") == n
    assert all(not e["args"]["shadow"] for t in tracers
               for e in t.events() if e["name"] == "serve.request")


# ---------------------------------------------------------------------------
# the serving property tests, on the port's copies
# ---------------------------------------------------------------------------

def _snapshots(draw):
    n_hot = draw(st.integers(0, 12))
    hot = tuple(draw(st.lists(st.integers(0, 500), min_size=n_hot,
                              max_size=n_hot)))
    return dict(requests=draw(st.integers(1, 10_000)),
                rate=draw(st.floats(0.0, 5_000.0)),
                mean_seeds=draw(st.floats(1.0, 8.0)),
                mean_frontier=draw(st.floats(0.0, 4_000.0)),
                hot_nodes=tuple(dict.fromkeys(hot)))


snapshot_st = st.composite(_snapshots)()


@given(snapshot_st, snapshot_st)
@settings(max_examples=60, deadline=None)
def test_drift_equals_reference_and_is_bounded(a, b):
    d = WorkloadStats.drift(TrafficSnapshot(**a), TrafficSnapshot(**b))
    assert d == RStats.drift(RSnapshot(**a), RSnapshot(**b))
    assert 0.0 <= d <= 1.0
    assert WorkloadStats.drift(TrafficSnapshot(**a),
                               TrafficSnapshot(**a)) == 0.0


@given(st.integers(1, 16), st.integers(0, 16), st.integers(0, 16),
       st.floats(10.0, 500.0), st.floats(5.0, 300.0))
@settings(max_examples=60, deadline=None)
def test_drift_monotone_in_hot_set_turnover(k, o1, o2, rate, frontier):
    o1, o2 = sorted((min(o1, k), min(o2, k)))

    def snap(overlap):
        hot = tuple(range(overlap)) + tuple(range(1000, 1000 + k - overlap))
        return TrafficSnapshot(requests=100, rate=rate, mean_seeds=2.0,
                               mean_frontier=frontier, hot_nodes=hot)

    base = snap(k)
    assert WorkloadStats.drift(base, snap(o1)) >= \
        WorkloadStats.drift(base, snap(o2))
    assert WorkloadStats.drift(base, snap(o1)) == \
        pytest.approx(1.0 - o1 / k)


def _inv_cases(draw):
    n = draw(st.integers(12, 160))
    g = TC.power_law(n, draw(st.floats(1.0, 8.0)),
                     locality=draw(st.floats(0.0, 0.7)),
                     seed=draw(st.integers(0, 10_000))).with_self_loops()
    return g, draw(st.integers(0, n - 1))


@given(st.composite(_inv_cases)())
@settings(max_examples=25, deadline=None)
def test_reverse_edge_invalidation_covers_in_frontier(case):
    """cache.invalidate(g.transpose().row(v)) dirties exactly the nodes
    whose 1-hop in-frontier holds v."""
    g, v = case
    cache = HotNodeCache(g.num_nodes)
    cache.store(object())
    cache.invalidate(g.transpose().row(v))
    for u in range(g.num_nodes):
        assert cache.ready(np.array([u])) != (v in set(g.row(u).tolist()))


@given(st.integers(1, 40), st.integers(1, 6))
@settings(max_examples=40, deadline=None)
def test_invalidate_counts_unique_rows_only(n, dup):
    cache = HotNodeCache(n)
    cache.store(object())
    ids = np.repeat(np.arange(n, dtype=np.int64)[: max(1, n // 2)], dup)
    assert cache.invalidate(ids) == max(1, n // 2)
    assert cache.invalidate(ids) == 0


def test_store_capacity_policy():
    """A capacity-bounded cache given no hot list marks nothing valid;
    a longer hot list is truncated to the capacity."""
    cache = HotNodeCache(32, capacity=8)
    cache.store(object(), hot_nodes=None)
    assert not cache.valid.any() and cache.lookup(np.arange(32)) == 32
    cache = HotNodeCache(32, capacity=2)
    cache.store(object(), hot_nodes=[7, 9, 11, 13])
    assert cache.valid.sum() == 2 and cache.ready(np.array([7, 9]))
    assert not cache.ready(np.array([11]))


@given(st.integers(1, 12), st.floats(10.0, 1000.0))
@settings(max_examples=30, deadline=None)
def test_frozen_clock_window_carries_last_rate(n_frozen, rate):
    """Shadow replay under a frozen clock keeps the last measured rate,
    the same as the reference's stats on the same records."""
    ours, theirs = WorkloadStats(window=8), RStats(window=8)
    seeds = np.array([1, 2], dtype=np.int64)
    for i in range(9):                           # live phase: real spacing
        ours.record(i / rate, seeds, 10)
        theirs.record(i / rate, seeds, 10)
    live = ours.snapshot().rate
    assert live > 0 and live == theirs.snapshot().rate
    for _ in range(n_frozen):                    # frozen clock from here on
        ours.record(9.0 / rate, seeds, 10)
        theirs.record(9.0 / rate, seeds, 10)
    assert ours.snapshot().rate > 0
    assert dataclasses.astuple(ours.snapshot()) == \
        dataclasses.astuple(theirs.snapshot())


_SERVE_SETUP = {}


def _serve_setup():
    """Built once per module (not a fixture: drawn values fill the
    parameters)."""
    if not _SERVE_SETUP:
        g = TC.power_law(200, avg_degree=5.0, locality=0.3, seed=3)
        x = np.random.default_rng(3).normal(
            size=(g.num_nodes, 8)).astype(np.float32)
        eng = TC.GNNEngine.build(g, VirtualRing(1, CPU), ps=4, dist=1)
        params = TC.gcn_init(torch.Generator().manual_seed(3), 8, 4)
        _SERVE_SETUP["v"] = (g, x, eng, params)
    return _SERVE_SETUP["v"]


@given(st.integers(0, 199), st.integers(0, 10_000))
@settings(max_examples=8, deadline=None)
def test_update_features_never_serves_stale(v, seed_pick):
    """After update_features(v), a request whose cached pass would read a
    dirtied h₁ row takes the full pass, and its logits are bitwise the
    offline forward over the updated features."""
    g, x, eng, params = _serve_setup()
    srv = GNNServeEngine(eng, params, "gcn", x, g, slots=4)
    readers = srv.g_full.transpose().row(v)
    if readers.size == 0:
        return
    seed = int(readers[seed_pick % readers.size])
    srv.submit(np.array([seed]))
    srv.step()                                # warm the cache
    srv.update_features(int(v), 3.0 * np.ones(x.shape[1], np.float32))
    srv.submit(np.array([seed]))
    (r,) = srv.step()
    assert not r.cached
    np.testing.assert_array_equal(r.logits, _offline(srv)[[seed]])
