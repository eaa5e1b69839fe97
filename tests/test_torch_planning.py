"""repro_torch: the copied framework-free modules give outputs equal to the
reference's, the port imports no JAX, and its entry points refuse to fall
back to the CPU on their own."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as RC
from repro.serve import HotNodeCache as RHotNodeCache
from repro.serve import TrafficPhase as RTrafficPhase
from repro.serve import WorkloadStats as RWorkloadStats
from repro.serve import ZipfTraffic as RZipfTraffic

import repro_torch.core as TC
from repro_torch.dist import VirtualRing, resolve_device
from repro_torch.serve import HotNodeCache as THotNodeCache
from repro_torch.serve import TrafficPhase as TTrafficPhase
from repro_torch.serve import WorkloadStats as TWorkloadStats
from repro_torch.serve import ZipfTraffic as TZipfTraffic

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _assert_same(a, b, path="plan"):
    """Recursive equality over dataclasses / arrays / tuples / scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _graphs(gen):
    if gen == "erdos_renyi":
        return (RC.erdos_renyi(300, 5.0, seed=4),
                TC.erdos_renyi(300, 5.0, seed=4))
    return (RC.power_law(300, 6.0, locality=0.3, seed=4),
            TC.power_law(300, 6.0, locality=0.3, seed=4))


@pytest.mark.parametrize("gen", ["erdos_renyi", "power_law"])
def test_graph_generators_equal(gen):
    rg, tg = _graphs(gen)
    _assert_same(rg, tg)
    _assert_same(rg.with_self_loops(), tg.with_self_loops())
    _assert_same(rg.transpose(), tg.transpose())
    seeds = np.array([0, 17, 123])
    np.testing.assert_array_equal(RC.khop_in_frontier(rg, seeds, 2),
                                  TC.khop_in_frontier(tg, seeds, 2))
    np.testing.assert_array_equal(RC.neighbors_of(rg, seeds),
                                  TC.neighbors_of(tg, seeds))
    rgd, rmeta = RC.paper_dataset("products", scale=0.02)
    tgd, tmeta = TC.paper_dataset("products", scale=0.02)
    _assert_same(rgd, tgd)
    assert rmeta == tmeta


@pytest.mark.parametrize("gen", ["erdos_renyi", "power_law"])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_plans_equal(gen, n_dev):
    rg, tg = _graphs(gen)
    rg, tg = rg.with_self_loops(), tg.with_self_loops()
    rpart, tpart = RC.build_partition(rg, n_dev), TC.build_partition(tg, n_dev)
    _assert_same(rpart, tpart, "partition")
    for ps in (1, 4, 8):
        for dist in (1, 2):
            _assert_same(RC.plan_from_partition(rpart, ps=ps, dist=dist),
                         TC.plan_from_partition(tpart, ps=ps, dist=dist),
                         f"plan(ps={ps}, dist={dist})")
    x = np.random.default_rng(1).normal(size=(rg.num_nodes, 5)).astype(
        np.float32)
    rplan = RC.build_plan(rg, n_dev, ps=4, dist=2)
    tplan = TC.build_plan(tg, n_dev, ps=4, dist=2)
    np.testing.assert_array_equal(RC.pad_embeddings(rplan, x),
                                  TC.pad_embeddings(tplan, x))
    ids = np.array([0, 5, rg.num_nodes - 1])
    np.testing.assert_array_equal(RC.pgas_rows(rplan, ids),
                                  TC.pgas_rows(tplan, ids))


def test_layer_plans_mixed_dist_lcm_padding_equal():
    rg, tg = _graphs("power_law")
    cfgs = [dict(ps=4, dist=2), dict(ps=8, dist=3, pb=2), dict(ps=4, dist=2)]
    rl = RC.build_layer_plans(rg, 4, cfgs)
    tl = TC.build_layer_plans(tg, 4, cfgs)
    _assert_same(rl, tl, "layer_plans")
    assert tl[0].plan is tl[2].plan          # shared (ps, dist) → one plan
    assert tl[0].plan.rows_per_dev == tl[1].plan.rows_per_dev  # lcm layout


def test_stats_traffic_hotcache_equal():
    phases = lambda P: [P(requests=60, alpha=1.2, seeds_max=3,
                          update_frac=0.1),
                        P(requests=60, rate=800.0, rotate=True,
                          update_frac=0.1)]
    rev = list(RZipfTraffic(500, 6, phases(RTrafficPhase), seed=3))
    tev = list(TZipfTraffic(500, 6, phases(TTrafficPhase), seed=3))
    assert len(rev) == len(tev)
    rs, ts = RWorkloadStats(window=16), TWorkloadStats(window=16)
    rc, tc = RHotNodeCache(500, capacity=40), THotNodeCache(500, capacity=40)
    rc.store("table", hot_nodes=range(0, 500, 3))
    tc.store("table", hot_nodes=range(0, 500, 3))
    for i, (a, b) in enumerate(zip(rev, tev)):
        assert a.t == b.t and a.update_node == b.update_node
        if a.is_update:
            np.testing.assert_array_equal(a.update_value, b.update_value)
            dirty = [a.update_node, (a.update_node + 1) % 500]
            assert rc.invalidate(dirty) == tc.invalidate(dirty)
            continue
        np.testing.assert_array_equal(a.seeds, b.seeds)
        rs.record(a.t, a.seeds, 10 + i)
        ts.record(b.t, b.seeds, 10 + i)
        assert rc.lookup(a.seeds) == tc.lookup(b.seeds)
    assert dataclasses.astuple(rs.snapshot()) == \
        dataclasses.astuple(ts.snapshot())
    assert rs.top_nodes(7) == ts.top_nodes(7)
    assert RWorkloadStats.drift(rs.snapshot(), rs.snapshot()) == \
        TWorkloadStats.drift(ts.snapshot(), ts.snapshot())
    assert (rc.hits, rc.misses, rc.invalidations) == \
        (tc.hits, tc.misses, tc.invalidations)
    np.testing.assert_array_equal(rc.valid, tc.valid)


def test_port_imports_no_jax():
    """Every module of repro_torch (found by walking the package, not a
    hand-kept list) imports, and none of them pulls in jax or repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "need = {'repro_torch.train.optimizer', 'repro_torch.sample.blocks',\n"
        "        'repro_torch.store.tiered', 'repro_torch.launch.train_gnn',\n"
        "        'repro_torch.kernels.rows', 'repro_torch.configs.base',\n"
        "        'repro_torch.configs.mistral_nemo_12b',\n"
        "        'repro_torch.models.transformer',\n"
        "        'repro_torch.serve.engine', 'repro_torch.launch.serve',\n"
        "        'repro_torch.kernels.flash_attention',\n"
        "        'repro_torch.kernels.slstm_scan',\n"
        "        'repro_torch.models.xlstm', 'repro_torch.core.autotune',\n"
        "        'repro_torch.models.moe', 'repro_torch.models.ssm',\n"
        "        'repro_torch.runtime.tuner', 'repro_torch.runtime.cache',\n"
        "        'repro_torch.runtime.profiler',\n"
        "        'repro_torch.runtime.engine', 'repro_torch.obs.calibrate',\n"
        "        'repro_torch.store.feature_store',\n"
        "        'repro_torch.store.hotfeatures', 'repro_torch.serve.gnn',\n"
        "        'repro_torch.serve.router', 'repro_torch.serve.cluster',\n"
        "        'repro_torch.testing.hypo', 'repro_torch.obs.validate',\n"
        "        'repro_torch.train.trainer', 'repro_torch.launch.train',\n"
        "        'repro_torch.launch.train_lm', 'repro_torch.models.encdec',\n"
        "        'repro_torch.dist.mesh', 'repro_torch.dist.collectives',\n"
        "        'repro_torch.dist.compress', 'repro_torch.dist.sharding',\n"
        "        'repro_torch.launch.mesh', 'repro_torch.kernels.cost',\n"
        "        'repro_torch.kernels.meta', 'repro_torch.launch.op_cost',\n"
        "        'repro_torch.launch.cells', 'repro_torch.launch.dryrun',\n"
        "        'repro_torch.launch.dryrun_gnn'}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VirtualRing(4)
    from repro_torch.launch import serve_gnn
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_gnn.main(["--scale", "0.01", "--requests", "2"])
    assert VirtualRing(4, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_gnn.main(["--scale", "0.01", "--requests", "2",
                        "--dynamic-tune"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_gnn.main(["--scale", "0.01", "--requests", "2",
                        "--feature-capacity", "0", "--frontier-fanout", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_gnn.main(["--scale", "0.01", "--requests", "2",
                        "--replicas", "2"])
    from repro_torch.launch import train_gnn
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gnn.main(["--scale", "0.01", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gnn.main(["--scale", "0.01", "--steps", "1", "--model", "sage",
                        "--sample-fanout", "2"])
    for flag in (["--dynamic-tune"], ["--per-layer-tune"], ["--tune-fuse"],
                 ["--tune-cache", "t.json"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_gnn.main(["--scale", "0.01", "--steps", "1", *flag])
