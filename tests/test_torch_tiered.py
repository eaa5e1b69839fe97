"""repro_torch's tiered serving and streamed ring: the port's own invariants.

In process on the CPU, no subprocess (the 4-shard reference outputs live in
``tests/test_torch_serve.py``'s dump):

* the streamed ring is bitwise equal across cache capacities (0 included),
  dense and top-k, and at ``k == D`` the top-k ring is bitwise the dense
  one; ``padded_table`` is bitwise the padded table; ``dist - 1`` prefetches
  are issued a call; tracing on == off, bitwise;
* tiered serving gives resident serving's logits bitwise, with live feature
  updates, on full and cached passes, and the tuner's ``cap`` knob reaches
  the store on a rebuild;
* the hot-set sidecar round-trips, and a bad one is ignored;
* ``DynamicGNNEngine`` with a ``cap_space`` walks the reference's config
  history under a fake latency feed, and a cap move keeps the plan;
* the sampled serving frontier is a subset of the exact one, within
  ``len(seeds) · (f + 1) ** k`` ids.
"""
import json

import numpy as np
import pytest
import torch

import repro.core as RC
from repro.dist import flat_ring_mesh
from repro.runtime import DynamicGNNEngine as RDynamic
from repro.runtime import ProfileConfig as RProfile

import repro_torch.core as TC
import repro_torch.core.autotune as TA
from repro_torch.dist import VirtualRing
from repro_torch.obs import Tracer
from repro_torch.runtime import DynamicGNNEngine, ProfileConfig
from repro_torch.serve import (GNNServeEngine, TrafficPhase, ZipfTraffic,
                               run_trace)
from repro_torch.store import FeatureStore, TieredFeatures

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

N, D, NCLS = 300, 12, 5
CPU = "cpu"


def _graph(C):
    return C.power_law(N, avg_degree=7.0, locality=0.35, seed=13)


def _features():
    return np.random.default_rng(4).normal(size=(N, D)).astype(np.float32)


def _tiers(g, plan, cap):
    tiers = TieredFeatures(FeatureStore(_features()), plan, cap, device=CPU)
    if cap:
        tiers.admit(np.argsort(-g.degrees)[:cap].tolist())
    return tiers


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("n_dev,dist,fused", [(4, 2, False), (4, 3, True),
                                              (1, 2, False), (3, 1, False)])
def test_streamed_ring_bitwise_across_capacities(n_dev, dist, fused):
    g = _graph(TC)
    plan = TC.build_plan(g, n_dev, ps=4, dist=dist)
    ring = VirtualRing(n_dev, CPU)
    w = torch.from_numpy(np.random.default_rng(6).normal(
        size=(D, 7)).astype(np.float32)) if fused else None
    padded = torch.from_numpy(TC.pad_embeddings(plan, _features()))
    resident = TC.mgg_aggregate(padded, plan, ring, update_w=w)
    outs = {}
    for cap in (0, N // 3, N):
        tiers = _tiers(g, plan, cap)
        stats = {}
        outs[cap] = TC.mgg_aggregate_streamed(tiers.chunk_fetcher(), plan,
                                              ring, update_w=w, stats=stats)
        assert stats["prefetch_issued"] == dist - 1
        assert stats["prefetch_inflight"] == 0     # the CPU runs in order
        assert torch.equal(_bits(tiers.padded_table()), _bits(padded))
        rep = tiers.report()
        assert (rep["cache_rows_served"] > 0) == (cap > 0)
        assert (rep["host_rows_streamed"] > 0) == (cap < N)
    assert torch.equal(_bits(outs[0]), _bits(outs[N // 3]))
    assert torch.equal(_bits(outs[0]), _bits(outs[N]))
    torch.testing.assert_close(outs[0], resident, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dist", [1, 2])
def test_sparse_streamed_ring_at_k_equal_d_is_the_dense_one(dist):
    g = _graph(TC)
    plan = TC.build_plan(g, 4, ps=8, dist=dist)
    ring = VirtualRing(4, CPU)
    dense = TC.mgg_aggregate_streamed(_tiers(g, plan, 0).chunk_fetcher(),
                                      plan, ring)
    sparse = {}
    for cap in (0, N // 3, N):
        fetch = _tiers(g, plan, cap).chunk_fetcher()
        assert torch.equal(_bits(TC.mgg_aggregate_sparse_streamed(
            fetch, plan, ring, k=D)), _bits(dense))
        sparse[cap] = TC.mgg_aggregate_sparse_streamed(fetch, plan, ring, k=4)
    assert torch.equal(_bits(sparse[0]), _bits(sparse[N]))
    # k < D: the dense streamed ring over the decompressed rows
    padded = torch.from_numpy(TC.pad_embeddings(plan, _features()))
    v, i = TC.topk_activation(padded, 4)
    torch.testing.assert_close(
        sparse[0], TC.mgg_aggregate(TC.topk_decompress(v, i, D), plan, ring),
        rtol=1e-5, atol=1e-5)


def test_streamed_ring_tracing_on_equals_off():
    g = _graph(TC)
    plan = TC.build_plan(g, 4, ps=4, dist=3)
    ring = VirtualRing(4, CPU)
    tiers = _tiers(g, plan, N // 3)
    off = TC.mgg_aggregate_streamed(tiers.chunk_fetcher(), plan, ring)
    tracer, stats = Tracer(), {}
    on = TC.mgg_aggregate_streamed(tiers.chunk_fetcher(), plan, ring,
                                   stats=stats, tracer=tracer)
    assert torch.equal(_bits(on), _bits(off))
    names = [ev["name"] for ev in tracer.events()]
    assert names.count("mgg.stream.fetch") == 3
    assert names.count("mgg.stream.ring") == 3
    for name in ("mgg.stream.local", "mgg.stream.drain",
                 "mgg.stream.aggregate"):
        assert names.count(name) == 1, name
    assert 0.0 <= stats["overlap_efficiency"] <= 1.0


def test_streamed_ring_is_forward_only_and_checks_its_arrays():
    g = _graph(TC)
    plan = TC.build_plan(g, 2, ps=4, dist=2)
    ring = VirtualRing(2, CPU)
    fetch = _tiers(g, plan, 0).chunk_fetcher()
    w = torch.ones((D, 3), requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        TC.mgg_aggregate_streamed(fetch, plan, ring, update_w=w)
    with pytest.raises(ValueError, match="forward only"):
        TC.mgg_aggregate_streamed(lambda c: fetch(c).requires_grad_(), plan,
                                  ring)
    with pytest.raises(ValueError, match="interleave=False"):
        TC.mgg_aggregate_streamed(fetch, plan, ring, arrays=TC.
                                  plan_device_arrays(plan, interleave=True))
    with pytest.raises(ValueError, match="without a plan"):
        TieredFeatures(FeatureStore(_features()), None, 0,
                       device=CPU).padded_table()


def test_engine_streams_on_its_own_arrays_and_rebinds_the_store():
    g = _graph(TC)
    eng = TC.GNNEngine.build(g, VirtualRing(4, CPU), ps=4, dist=2)
    other = TC.build_plan(g, 4, ps=8, dist=1)
    tiers = _tiers(g, other, N // 3)
    arrays = eng.stream_arrays(0)
    assert not arrays.interleave and arrays is eng.stream_arrays(0)
    assert arrays.remote_steps is eng.ring_arrays[0].remote_steps
    got = eng.aggregate_streamed(tiers, stats={})
    assert tiers.plan is eng.plan                 # rebound to the layer's
    x = eng.shard(eng.pad(_features()))
    torch.testing.assert_close(got, eng.aggregate(x), rtol=1e-5, atol=1e-5)
    assert torch.equal(_bits(eng.aggregate_streamed(tiers, topk=D)),
                       _bits(got))


def _serve(g, params, events, **kw):
    eng = kw.pop("engine", None) or TC.GNNEngine.build(
        g, VirtualRing(4, CPU), ps=4, dist=2)
    srv = GNNServeEngine(eng, params, "gcn", _features(), g, slots=6, **kw)
    return srv, run_trace(srv, events)


def _events(seed=5):
    return list(ZipfTraffic(N, D, [
        TrafficPhase(requests=40, alpha=1.2, seeds_max=3, update_frac=0.1),
        TrafficPhase(requests=40, alpha=1.2, seeds_max=3, rotate=True,
                     update_frac=0.1)], seed=seed))


def test_tiered_serving_equals_resident_serving_with_updates():
    g = _graph(TC)
    params = TC.gcn_init(torch.Generator().manual_seed(0), D, NCLS)
    events = _events()
    assert any(ev.is_update for ev in events)
    res, r_res = _serve(g, params, events)
    tier, t_res = _serve(g, params, events, feature_capacity=N // 4)
    assert tier.xp is None                        # no resident table
    assert [r.cached for r in r_res] == [r.cached for r in t_res]
    assert any(r.cached for r in t_res) and not all(r.cached for r in t_res)
    for a, b in zip(r_res, t_res):
        np.testing.assert_array_equal(a.logits, b.logits)
    rep = tier.report()["tiers"]
    assert rep["store_updates"] > 0 and rep["cache_rows_served"] > 0
    assert rep["host_rows_streamed"] > 0 and rep["capacity"] == N // 4
    assert res.report()["tiers"] is None
    np.testing.assert_array_equal(tier.x, res.x)  # the store took updates
    zero, z_res = _serve(g, params, events, feature_capacity=0)
    for a, b in zip(r_res, z_res):
        np.testing.assert_array_equal(a.logits, b.logits)
    assert zero.report()["tiers"]["cache_rows_served"] == 0


def test_cap_knob_reaches_the_store_on_a_rebuild():
    g = _graph(TC)
    params = TC.gcn_init(torch.Generator().manual_seed(0), D, NCLS)
    deng = DynamicGNNEngine.build(
        g, VirtualRing(4, CPU), d_feat=D, ps_space=(4, 8),
        dist_space=(1, 2), pb_space=(0,), cap_space=(0, N // 4, N),
        window=ProfileConfig(warmup=0, iters=1))
    srv = GNNServeEngine(deng, params, "gcn", _features(), g, slots=6,
                         feature_store=FeatureStore(_features()))
    assert srv.tiers is not None and srv.tiers.capacity == 0
    results = run_trace(srv, ZipfTraffic(N, D, [
        TrafficPhase(requests=80, seeds_max=3)], seed=13))
    assert deng.tuner.converged and len(results) == 80
    assert srv.tiers.capacity == deng.feature_capacity is not None
    assert any("cap" in cfg and cfg["cap"] > 0 for _, cfg in deng.history)
    # served == offline under the committed config
    srv.cache.invalidate()
    seeds = np.array([0, 1, 2])
    srv.submit(seeds)
    (full,) = srv.step()
    with torch.inference_mode():
        offline = TC.gcn_apply(params, deng, deng.shard(deng.pad(srv.x)))
    rows = TC.pgas_rows(deng.plan, seeds)
    np.testing.assert_array_equal(full.logits, offline.numpy()[rows])


def test_hot_set_sidecar_round_trip(tmp_path):
    g = _graph(TC)
    params = TC.gcn_init(torch.Generator().manual_seed(0), D, NCLS)
    path = str(tmp_path / "hot" / "set.json")
    srv, _ = _serve(g, params, _events(), feature_capacity=N // 4,
                    hotset_path=path)
    with open(path) as f:
        doc = json.load(f)
    ids = srv.tiers.cache.resident_ids()
    assert (doc["num_nodes"], doc["d_feat"]) == (N, D) and len(ids) > 0
    assert doc["ids"] == ids.tolist()
    assert not list((tmp_path / "hot").glob(".hotset-*"))    # no temp left
    warm = GNNServeEngine(TC.GNNEngine.build(g, VirtualRing(4, CPU), ps=4,
                                             dist=2),
                          params, "gcn", _features(), g, slots=6,
                          feature_capacity=N // 4, hotset_path=path)
    np.testing.assert_array_equal(warm.tiers.cache.resident_ids(), ids)
    # a sidecar of another store shape, or a corrupt one, is ignored
    for doc in ('{"num_nodes": 7, "d_feat": 12, "ids": [1]}', "{not json"):
        with open(path, "w") as f:
            f.write(doc)
        cold = GNNServeEngine(TC.GNNEngine.build(g, VirtualRing(4, CPU),
                                                 ps=4, dist=2),
                              params, "gcn", _features(), g, slots=6,
                              feature_capacity=N // 4, hotset_path=path)
        assert cold.tiers.cache.resident_rows == 0


def _lat(cfg):
    """A latency surface with a valley at ps 4, dist 2 and a cap of N."""
    return (1.0 + 0.3 * abs(np.log2(cfg["ps"]) - 2)
            + 0.2 * abs(cfg["dist"] - 2) + 0.05 * cfg["pb"]
            + 0.4 * (1.0 - cfg.get("cap", 0) / N))


def _feed(eng, log, limit=100):
    for _ in range(limit):
        if eng.tuner.converged:
            return
        log.append(eng.config)
        eng.observe_step(_lat(eng.config))


def test_cap_space_history_equals_reference(tmp_path):
    kw = dict(d_feat=D, ps_space=(2, 4, 8), dist_space=(1, 2),
              pb_space=(1, 2), cap_space=(0, N // 4, N), budget=14)
    rpath, tpath = str(tmp_path / "r.json"), str(tmp_path / "t.json")
    r = RDynamic.build(_graph(RC), flat_ring_mesh(1),
                       window=RProfile(warmup=0, iters=1), cache_path=rpath,
                       **kw)
    t = DynamicGNNEngine.build(_graph(TC), VirtualRing(1, CPU),
                               window=ProfileConfig(warmup=0, iters=1),
                               cache_path=tpath, hw=TA.TPU_V5E, **kw)
    rlog, tlog = [], []
    for eng, log in ((r, rlog), (t, tlog)):
        _feed(eng, log)
        assert eng.retune(force=True)
        _feed(eng, log)
    assert rlog == tlog and r.history == t.history
    assert r.audit == t.audit and r.config == t.config
    assert t.feature_capacity == r.feature_capacity == t.config["cap"]
    with open(rpath) as f, open(tpath) as g:
        assert json.load(f) == json.load(g)
    # a move of cap alone keeps the plan and its device arrays
    arrays = t.engine.ring_arrays[0]
    other = [c for c in kw["cap_space"] if c != t.config["cap"]][0]
    assert t._set_config(dict(t.config, cap=other))
    assert t.engine.ring_arrays[0] is arrays and t.feature_capacity == other


def test_sampled_frontier_is_bounded_and_inside_the_exact_one():
    g = _graph(TC)
    params = TC.gcn_init(torch.Generator().manual_seed(0), D, NCLS)
    for fanout in (1, 3):
        srv = GNNServeEngine(TC.GNNEngine.build(g, VirtualRing(2, CPU),
                                                ps=4, dist=1),
                             params, "gcn", _features(), g, slots=6,
                             frontier_fanout=fanout, frontier_seed=3)
        k = srv.k_hops
        for seeds in (np.array([0]), np.array([5, 9, 9, 40]),
                      np.arange(0, N, 50)):
            got = srv.sampled_frontier(seeds)
            exact = TC.khop_in_frontier(srv.g_full, seeds, k)
            assert set(got.tolist()) <= set(exact.tolist())
            assert set(np.unique(seeds).tolist()) <= set(got.tolist())
            assert got.size <= np.unique(seeds).size * (fanout + 1) ** k
            assert np.array_equal(got, np.unique(got))
        results = run_trace(srv, ZipfTraffic(N, D, [
            TrafficPhase(requests=20, seeds_max=3)], seed=2))
        assert len(results) == 20
    plain = GNNServeEngine(TC.GNNEngine.build(g, VirtualRing(2, CPU), ps=4,
                                              dist=1),
                           params, "gcn", _features(), g, slots=6)
    with pytest.raises(ValueError, match="frontier_fanout"):
        plain.sampled_frontier(np.array([0]))
