"""repro_torch ring, GCN and serving against the JAX reference.

The same inputs, made with numpy from fixed seeds, go through both
packages.  In-process the reference runs on its one CPU device; the
4-shard comparison reads one dump that this file writes when it runs as a
script in a subprocess with four fake XLA devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        PYTHONPATH=src python tests/test_torch_serve.py OUT.npz 4

Tolerances: the ring 1e-5 (fp32 sums in another order), GCN logits and
served logits rtol 2e-4 (the reference's own fused-vs-unfused tolerance).
The 4-shard dump also holds the streamed ring over a tiered store (dense
at capacities 0, N // 3 and N, dist 1 and 2; top-k at k = D and k < D),
the tiered store's padded table and a tiered serving trace with feature
updates, each held to the same tolerances; the bulk and fetch baselines
(1e-5; ``tests/test_torch_obs.py`` runs them on one shard); and a serving
cluster of two replicas on disjoint halves of the four devices behind the
locality router, whose routing the port's cluster of two 2-shard rings
repeats request by request (logits rtol 2e-4).  It also holds the
collectives of the reference's smoke serve cells compiled on (2, 2) and
(1, 4) meshes (``hlo_cost``), which the dry run's ``per_op`` must match
kind for kind within 1 % (``tests/test_torch_collectives.py`` holds the
train cells).
Inside the port, served == offline holds bitwise.  The top-k compressed
ring runs on random normal features (no ties at the ``k`` boundary, where
``lax.top_k`` and ``torch.topk`` may pick other columns).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

D, NCLS = 23, 5
# (ps, dist, interleave, fused update)
RING_CASES = [(4, 1, True, False), (8, 2, False, False), (8, 1, True, True),
              (16, 2, True, True), (1, 3, False, True)]
# top-k compressed ring: (ps, dist, interleave, fused update, k)
SPARSE_RING_CASES = [(4, 1, True, False, 6), (8, 2, False, True, 23),
                     (16, 2, True, True, 1)]
# the streamed ring over a tiered store, 4 shards: (ps, dist, fused update)
# at each capacity, and its top-k variant at dist 2 for each k
STREAM_CASES = [(8, 1, False), (4, 2, True)]
STREAM_KS = (D, 6)
# the smoke serve cells whose collectives the dump holds
SERVE_CELLS = [("codeqwen1.5-7b", "prefill_32k"),
               ("codeqwen1.5-7b", "decode_32k"),
               ("granite-moe-1b-a400m", "decode_32k"),
               ("whisper-base", "prefill_32k"), ("xlstm-125m", "decode_32k")]
SERVE_PHASES = [dict(requests=24, alpha=1.2, seeds_max=3, update_frac=0.1),
                dict(requests=24, alpha=1.2, seeds_max=3, rotate=True,
                     update_frac=0.1)]


def _capacities(n):
    return (0, n // 3, n)


def _hot(g, cap):
    return np.argsort(-g.degrees, kind="stable")[:cap]


def _graph(C):
    return C.power_law(360, avg_degree=7.0, locality=0.35, seed=11)


def _features(n):
    return np.random.default_rng(3).normal(size=(n, D)).astype(np.float32)


def _update_w():
    return np.random.default_rng(5).normal(size=(D, 9)).astype(np.float32)


def _reference_outputs(n_dev):
    """Reference ring outputs, GCN params and logits on ``n_dev`` devices."""
    import jax
    import jax.numpy as jnp
    import repro.core as C
    from repro.dist import flat_ring_mesh

    g = _graph(C)
    x = _features(g.num_nodes)
    mesh = flat_ring_mesh(n_dev)
    out = {}
    # jit each call: an eager shard_map compiles op by op, many times slower
    for i, (ps, dist, il, fused) in enumerate(RING_CASES):
        plan = C.build_plan(g, n_dev, ps=ps, dist=dist)
        ring = jax.jit(lambda xx, ww, plan=plan, il=il: C.mgg_aggregate(
            xx, plan, mesh, interleave=il, update_w=ww))
        w = jnp.asarray(_update_w()) if fused else None
        out[f"ring{i}"] = np.asarray(
            ring(jnp.asarray(C.pad_embeddings(plan, x)), w))
    for i, (ps, dist, il, fused, k) in enumerate(SPARSE_RING_CASES):
        plan = C.build_plan(g, n_dev, ps=ps, dist=dist)
        ring = jax.jit(lambda xx, ww, plan=plan, il=il, k=k:
                       C.mgg_aggregate_sparse(xx, plan, mesh, k=k,
                                              interleave=il, update_w=ww))
        w = jnp.asarray(_update_w()) if fused else None
        out[f"sparse{i}"] = np.asarray(
            ring(jnp.asarray(C.pad_embeddings(plan, x)), w))
    params = C.MODEL_ZOO["gcn"][0](jax.random.key(0), D, NCLS, hidden=16,
                                   num_layers=2)
    for i, layer in enumerate(params["layers"]):
        out[f"w{i}"], out[f"b{i}"] = np.asarray(layer["w"]), \
            np.asarray(layer["b"])
    for fuse in (False, True):
        eng = C.GNNEngine.build(g, mesh, ps=8, dist=1, fuse_update=fuse)
        fwd = jax.jit(lambda p, xx, eng=eng:
                      C.MODEL_ZOO["gcn"][1](p, eng, xx))
        out[f"gcn_fused{int(fuse)}"] = np.asarray(
            fwd(params, eng.shard(eng.pad(x))))
    if n_dev > 1:
        out.update(_reference_tiered(C, g, x, mesh, params))
        out.update(_reference_cluster(C, g, x, params))
        from test_torch_obs import reference_baselines
        out.update({f"baseline_{k}": v for k, v in
                    reference_baselines(n_dev, mesh).items()})
        from test_torch_collectives import MESHES, reference_collectives
        out.update(reference_collectives(SERVE_CELLS, MESHES))
    return out


def _reference_cluster(C, g, x, params):
    """Two static replicas, each on its own half of the devices, behind
    the locality router; one trace with feature updates."""
    import jax
    from repro.dist import make_mesh
    from repro.serve import (GNNServeEngine, LocalityRouter, ServeCluster,
                             TrafficPhase, ZipfTraffic)

    devs = jax.devices()
    half = len(devs) // 2
    replicas = [GNNServeEngine(C.GNNEngine.build(
        g, make_mesh((half,), ("ring",), devices=devs[h * half:
                                                         (h + 1) * half]),
        ps=8, dist=1), params, "gcn", x, g, slots=4) for h in range(2)]
    cluster = ServeCluster(replicas, router=LocalityRouter())
    results = cluster.run_trace(ZipfTraffic(
        g.num_nodes, D, [TrafficPhase(**p) for p in SERVE_PHASES], seed=6))
    return dict(
        cluster_ids=np.array([r.request_id for r in results]),
        cluster_replica=np.array([cluster.replica_of(r.request_id)
                                  for r in results]),
        cluster_cached=np.array([r.cached for r in results]),
        cluster_seeds=np.concatenate([r.seeds for r in results]),
        cluster_logits=np.concatenate([r.logits for r in results]))


def _reference_tiered(C, g, x, mesh, params):
    """The streamed ring, the padded table and tiered serving."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core.pipeline import (mgg_aggregate_sparse_streamed,
                                     mgg_aggregate_streamed)
    from repro.serve import GNNServeEngine, TrafficPhase, ZipfTraffic
    from repro.serve import run_trace
    from repro.store import FeatureStore, TieredFeatures

    shard = lambda a: jax.device_put(a, NamedSharding(mesh, P("ring", None)))

    def tiers(plan, cap):
        t = TieredFeatures(FeatureStore(x), plan, cap, shard=shard)
        if cap:
            t.admit(_hot(g, cap).tolist())
        return t

    out = {}
    for i, (ps, dist, fused) in enumerate(STREAM_CASES):
        plan = C.build_plan(g, mesh.size, ps=ps, dist=dist)
        w = _update_w() if fused else None
        for cap in _capacities(g.num_nodes):
            out[f"stream{i}_cap{cap}"] = np.asarray(mgg_aggregate_streamed(
                tiers(plan, cap).chunk_fetcher(), plan, mesh, update_w=w))
    plan = C.build_plan(g, mesh.size, ps=8, dist=2)
    for k in STREAM_KS:
        out[f"stream_sparse_k{k}"] = np.asarray(
            mgg_aggregate_sparse_streamed(
                tiers(plan, g.num_nodes // 3).chunk_fetcher(), plan, mesh,
                k=k))
    out["padded_table"] = np.asarray(
        tiers(plan, g.num_nodes // 3).padded_table())
    eng = C.GNNEngine.build(g, mesh, ps=8, dist=2)
    srv = GNNServeEngine(eng, params, "gcn", x, g, slots=4,
                         feature_capacity=g.num_nodes // 3)
    results = run_trace(srv, ZipfTraffic(
        g.num_nodes, D, [TrafficPhase(**p) for p in SERVE_PHASES], seed=5))
    out["tiered_seeds"] = np.concatenate([r.seeds for r in results])
    out["tiered_logits"] = np.concatenate([r.logits for r in results])
    out["tiered_cached"] = np.array([r.cached for r in results])
    return out


if __name__ == "__main__":
    np.savez(sys.argv[1], **_reference_outputs(int(sys.argv[2])))
    sys.exit(0)


import jax  # noqa: E402  (after the script entry: it sets no device count)
import torch  # noqa: E402

import repro.core as RC  # noqa: E402
from repro.dist import flat_ring_mesh  # noqa: E402
from repro.serve import GNNServeEngine as RServe  # noqa: E402
from repro.serve import TrafficPhase as RPhase  # noqa: E402
from repro.serve import ZipfTraffic as RTraffic  # noqa: E402
from repro.serve import run_trace as r_run_trace  # noqa: E402

import repro_torch.core as TC  # noqa: E402
from repro_torch.dist import VirtualRing  # noqa: E402
from test_torch_collectives import (MESHES, assert_matches,  # noqa: E402
                                    port_per_op)
from repro_torch.serve import GNNServeEngine as TServe  # noqa: E402
from repro_torch.serve import TrafficPhase as TPhase  # noqa: E402
from repro_torch.serve import ZipfTraffic as TTraffic  # noqa: E402
from repro_torch.serve import run_trace as t_run_trace  # noqa: E402
from repro_torch.store import FeatureStore  # noqa: E402
from repro_torch.store import TieredFeatures  # noqa: E402

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

CPU = "cpu"


@pytest.fixture(scope="module")
def dump4(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref4.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    r = subprocess.run([sys.executable, __file__, str(path), "4"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ref1():
    return _reference_outputs(1)


def _port_params(ref):
    return TC.params_from_numpy(
        {"layers": [{"w": ref[f"w{i}"], "b": ref[f"b{i}"]}
                    for i in range(2)]}, CPU)


def _port_ring(i, n_dev):
    ps, dist, il, fused = RING_CASES[i]
    g = _graph(TC)
    x = _features(g.num_nodes)
    plan = TC.build_plan(g, n_dev, ps=ps, dist=dist)
    w = torch.from_numpy(_update_w()) if fused else None
    out = TC.mgg_aggregate(torch.from_numpy(TC.pad_embeddings(plan, x)),
                           plan, VirtualRing(n_dev, CPU), interleave=il,
                           update_w=w)
    return g, x, plan, out.numpy()


@pytest.mark.parametrize("case", range(len(RING_CASES)))
def test_ring_matches_reference_one_device(ref1, case):
    _, _, _, got = _port_ring(case, 1)
    np.testing.assert_allclose(got, ref1[f"ring{case}"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", range(len(RING_CASES)))
def test_ring_matches_reference_four_shards(dump4, case):
    g, x, plan, got = _port_ring(case, 4)
    np.testing.assert_allclose(got, dump4[f"ring{case}"], rtol=1e-5,
                               atol=1e-5)
    want = TC.reference_aggregate(g.indptr, g.indices, x)
    if RING_CASES[case][3]:
        want = want @ _update_w()
    np.testing.assert_allclose(TC.unpad_embeddings(plan, got), want,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("case", range(len(SPARSE_RING_CASES)))
def test_sparse_ring_matches_reference(ref1, dump4, case, n_dev):
    ps, dist, il, fused, k = SPARSE_RING_CASES[case]
    g = _graph(TC)
    plan = TC.build_plan(g, n_dev, ps=ps, dist=dist)
    w = torch.from_numpy(_update_w()) if fused else None
    got = TC.mgg_aggregate_sparse(
        torch.from_numpy(TC.pad_embeddings(plan, _features(g.num_nodes))),
        plan, VirtualRing(n_dev, CPU), k=k, interleave=il, update_w=w)
    want = (ref1 if n_dev == 1 else dump4)[f"sparse{case}"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("n_dev", [1, 4])
def test_gcn_logits_match_reference(ref1, dump4, n_dev, fuse):
    ref = ref1 if n_dev == 1 else dump4
    g = _graph(TC)
    eng = TC.GNNEngine.build(g, VirtualRing(n_dev, CPU), ps=8, dist=1,
                             fuse_update=fuse)
    xp = eng.shard(eng.pad(_features(g.num_nodes)))
    got = TC.gcn_apply(_port_params(ref), eng, xp).numpy()
    np.testing.assert_allclose(got, ref[f"gcn_fused{int(fuse)}"], rtol=2e-4,
                               atol=1e-5)


def test_serving_matches_reference_engine():
    """One trace (with feature updates and a hot-set rotation) through both
    engines: the same cached/full decisions, allclose logits."""
    rg, tg = _graph(RC), _graph(TC)
    x = _features(rg.num_nodes)
    params = RC.MODEL_ZOO["gcn"][0](jax.random.key(1), D, NCLS, hidden=16,
                                    num_layers=2)
    r_eng = RC.GNNEngine.build(rg, flat_ring_mesh(1), ps=8, dist=1)
    t_eng = TC.GNNEngine.build(tg, VirtualRing(1, CPU), ps=8, dist=1)
    r_srv = RServe(r_eng, params, "gcn", x, rg, slots=4)
    t_srv = TServe(t_eng, TC.params_from_numpy(params, CPU), "gcn", x, tg,
                   slots=4)

    def phases(P):
        return [P(requests=24, alpha=1.2, seeds_max=3, update_frac=0.1),
                P(requests=24, alpha=1.2, seeds_max=3, rotate=True,
                  update_frac=0.1)]

    r_res = r_run_trace(r_srv, RTraffic(rg.num_nodes, D, phases(RPhase),
                                        seed=5))
    t_res = t_run_trace(t_srv, TTraffic(tg.num_nodes, D, phases(TPhase),
                                        seed=5))
    assert [r.cached for r in r_res] == [t.cached for t in t_res]
    assert any(t.cached for t in t_res) and not all(t.cached for t in t_res)
    for r, t in zip(r_res, t_res):
        np.testing.assert_array_equal(r.seeds, t.seeds)
        np.testing.assert_allclose(t.logits, r.logits, rtol=2e-4, atol=1e-5)
    rr, tr = r_srv.report(), t_srv.report()
    for key in ("served", "batches", "cache_hit_rate", "cache_stores",
                "cache_invalidations", "dropped"):
        assert rr[key] == tr[key], key


@pytest.mark.parametrize("n_dev,fuse", [(1, False), (4, False), (4, True)])
def test_served_logits_bitwise_match_offline(n_dev, fuse):
    g = _graph(TC)
    x = _features(g.num_nodes)
    eng = TC.GNNEngine.build(g, VirtualRing(n_dev, CPU), ps=8, dist=1,
                             fuse_update=fuse)
    params = TC.gcn_init(torch.Generator().manual_seed(0), D, NCLS)
    srv = TServe(eng, params, "gcn", x, g, slots=4)
    results = t_run_trace(srv, TTraffic(g.num_nodes, D, [
        TPhase(requests=20, alpha=1.2, seeds_max=3)], seed=7))
    assert len(results) == 20 and any(r.cached for r in results)
    with torch.inference_mode():
        offline = TC.unpad_embeddings(eng.plan, TC.gcn_apply(
            params, eng, eng.shard(eng.pad(srv.x))).numpy())
    for r in results:
        np.testing.assert_array_equal(r.logits, offline[r.seeds])


@pytest.mark.parametrize("model", ["gin", "sage", "gat"])
def test_served_logits_bitwise_match_offline_each_model(model):
    """The other three models serve through the same stages: served ==
    offline bitwise (full and cached passes), and the launcher takes
    ``--model``."""
    g = _graph(TC)
    x = _features(g.num_nodes)
    eng = TC.GNNEngine.build(g, VirtualRing(4, CPU), ps=8, dist=1)
    init, apply, _ = TC.MODEL_ZOO[model]
    kw = dict(heads=2) if model == "gat" else {}
    params = init(torch.Generator().manual_seed(0), D, NCLS, hidden=8,
                  num_layers=2, **kw)
    srv = TServe(eng, params, model, x, g, slots=4)
    results = t_run_trace(srv, TTraffic(g.num_nodes, D, [
        TPhase(requests=16, alpha=1.2, seeds_max=3)], seed=7))
    assert len(results) == 16 and any(r.cached for r in results)
    with torch.inference_mode():
        offline = TC.unpad_embeddings(eng.plan, apply(
            params, eng, eng.shard(eng.pad(srv.x))).numpy())
    for r in results:
        np.testing.assert_array_equal(r.logits, offline[r.seeds])
    from repro_torch.launch import serve_gnn
    rep = serve_gnn.main(["--device", "cpu", "--model", model, "--scale",
                          "0.02", "--requests", "6", "--devices", "2"])
    assert rep["served"] == 12


def test_update_features_writes_one_row_in_place():
    g = _graph(TC)
    eng = TC.GNNEngine.build(g, VirtualRing(2, CPU), ps=8, dist=1)
    params = TC.gcn_init(torch.Generator().manual_seed(0), D, NCLS)
    srv = TServe(eng, params, "gcn", _features(g.num_nodes), g, slots=4)
    table = srv.xp
    srv.update_features(17, np.full(D, 2.5, np.float32))
    assert srv.xp is table                       # no new table
    np.testing.assert_array_equal(srv.xp.numpy(), eng.pad(srv.x))


def _port_tiers(g, plan, cap):
    t = TieredFeatures(FeatureStore(_features(g.num_nodes)), plan, cap,
                       device=CPU)
    if cap:
        t.admit(_hot(g, cap).tolist())
    return t


@pytest.mark.parametrize("case", range(len(STREAM_CASES)))
def test_streamed_ring_matches_reference(dump4, case):
    ps, dist, fused = STREAM_CASES[case]
    g = _graph(TC)
    plan = TC.build_plan(g, 4, ps=ps, dist=dist)
    ring = VirtualRing(4, CPU)
    w = torch.from_numpy(_update_w()) if fused else None
    outs = []
    for cap in _capacities(g.num_nodes):
        stats = {}
        got = TC.mgg_aggregate_streamed(_port_tiers(g, plan, cap)
                                        .chunk_fetcher(), plan, ring,
                                        update_w=w, stats=stats)
        assert stats["prefetch_issued"] == dist - 1
        np.testing.assert_allclose(got.numpy(),
                                   dump4[f"stream{case}_cap{cap}"],
                                   rtol=1e-5, atol=1e-5)
        outs.append(got)
    assert all(torch.equal(outs[0].view(torch.int32), o.view(torch.int32))
               for o in outs[1:])


@pytest.mark.parametrize("k", STREAM_KS)
def test_sparse_streamed_ring_matches_reference(dump4, k):
    g = _graph(TC)
    plan = TC.build_plan(g, 4, ps=8, dist=2)
    got = TC.mgg_aggregate_sparse_streamed(
        _port_tiers(g, plan, g.num_nodes // 3).chunk_fetcher(), plan,
        VirtualRing(4, CPU), k=k)
    np.testing.assert_allclose(got.numpy(), dump4[f"stream_sparse_k{k}"],
                               rtol=1e-5, atol=1e-5)


def test_padded_table_matches_reference(dump4):
    g = _graph(TC)
    plan = TC.build_plan(g, 4, ps=8, dist=2)
    got = _port_tiers(g, plan, g.num_nodes // 3).padded_table().numpy()
    np.testing.assert_array_equal(got, dump4["padded_table"])
    np.testing.assert_array_equal(got, TC.pad_embeddings(
        plan, _features(g.num_nodes)))


def test_tiered_serving_matches_reference(dump4):
    """The reference's tiered serving trace (feature updates, a hot-set
    rotation) through the port's tiered engine: the same seeds and
    cached/full decisions, logits within rtol 2e-4, and bitwise the
    port's resident serving of the same trace."""
    g = _graph(TC)
    params = _port_params(dump4)
    events = list(TTraffic(g.num_nodes, D, [TPhase(**p)
                                            for p in SERVE_PHASES], seed=5))
    served = {}
    for cap in (g.num_nodes // 3, None):
        eng = TC.GNNEngine.build(g, VirtualRing(4, CPU), ps=8, dist=2)
        srv = TServe(eng, params, "gcn", _features(g.num_nodes), g, slots=4,
                     feature_capacity=cap)
        served[cap] = t_run_trace(srv, events)
    res = served[g.num_nodes // 3]
    np.testing.assert_array_equal(
        np.concatenate([r.seeds for r in res]), dump4["tiered_seeds"])
    np.testing.assert_array_equal([r.cached for r in res],
                                  dump4["tiered_cached"])
    got = np.concatenate([r.logits for r in res])
    np.testing.assert_allclose(got, dump4["tiered_logits"], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(
        got, np.concatenate([r.logits for r in served[None]]))


def test_cluster_on_disjoint_halves_matches_reference(dump4):
    """The reference's two replicas on disjoint halves of four devices
    against the port's two replicas on 2-shard virtual rings: the same
    replica for every request, the same passes, logits within rtol 2e-4;
    nothing dropped."""
    from repro_torch.serve import LocalityRouter, ServeCluster

    g = _graph(TC)
    params = _port_params(dump4)
    replicas = [TServe(TC.GNNEngine.build(g, VirtualRing(2, CPU), ps=8,
                                          dist=1), params, "gcn",
                       _features(g.num_nodes), g, slots=4)
                for _ in range(2)]
    cluster = ServeCluster(replicas, router=LocalityRouter())
    res = cluster.run_trace(TTraffic(
        g.num_nodes, D, [TPhase(**p) for p in SERVE_PHASES], seed=6))
    np.testing.assert_array_equal([r.request_id for r in res],
                                  dump4["cluster_ids"])
    np.testing.assert_array_equal(
        [cluster.replica_of(r.request_id) for r in res],
        dump4["cluster_replica"])
    assert set(dump4["cluster_replica"].tolist()) == {0, 1}
    np.testing.assert_array_equal([r.cached for r in res],
                                  dump4["cluster_cached"])
    np.testing.assert_array_equal(np.concatenate([r.seeds for r in res]),
                                  dump4["cluster_seeds"])
    np.testing.assert_allclose(np.concatenate([r.logits for r in res]),
                               dump4["cluster_logits"], rtol=2e-4,
                               atol=1e-5)
    rep = cluster.report()
    assert rep["dropped"] == 0 and rep["served"] == len(res)


def test_baselines_match_reference_four_shards(dump4):
    """``bulk_aggregate`` and ``fetch_rows_aggregate`` (pages of 1 and 16
    rows) on four shards within 1e-5 of the reference's, and of the dense
    oracle once unpadded."""
    from test_torch_obs import PAGES, port_baselines

    got, bounds, rows, dense = port_baselines(4)
    assert set(got) == {"bulk"} | {f"fetch{p}" for p in PAGES}
    for key, val in got.items():
        want = dump4[f"baseline_{key}"]
        assert val.shape == want.shape, key
        np.testing.assert_allclose(val, want, rtol=1e-5, atol=1e-5,
                                   err_msg=key)
        np.testing.assert_allclose(
            TC.unpad_table(bounds, rows, val.reshape(-1, D)), dense,
            rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("ms", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_serve_cell_collectives_match_reference_hlo(dump4, monkeypatch,
                                                    arch, shape, ms):
    """A serve cell over a model axis: the dry run's per-op collectives
    are the reference's partitioned HLO's, kind for kind within 1 %."""
    got = port_per_op(arch, shape, ms, monkeypatch)
    assert_matches(got, dump4, arch, shape, ms)
    assert all(v["bytes"] > 0 for v in got.values())
