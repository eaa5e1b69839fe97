"""repro_torch's online tuner against the JAX reference's, on the CPU.

The same numpy inputs and latency surfaces go through both packages in
one process (the reference on its one CPU device, jitted,
``use_kernel=False``):

* the autotune copy gives the reference's estimates, workload shapes and
  offline search;
* ``OnlineTuner`` and ``PerLayerTuner`` fed one latency surface make the
  same proposals, audit events and best configs, through warm start,
  budget, drift reopen, adopt and resize;
* the config cache keeps the reference's file format (each package reads
  what the other wrote), and the profiler's window and model mode agree;
* the per-layer ``GNNEngine`` (mixed ps and dist) gives the reference's
  logits and gradients within rtol 2e-4 (fp32 sums in another order);
* ``DynamicGNNEngine`` under a fake latency feed walks the reference's
  config history.

Inside the port, bitwise: dynamic == static after commit, per-layer ==
single-plan, and served == offline after a drift retune.  Both launchers
run with the tuner flags at ``--device cpu`` on a tiny graph.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as RC
import repro.core.autotune as RA
from repro.dist import flat_ring_mesh
from repro.obs import calibrate as RCal
from repro.runtime import AggregateProfiler as RProfiler
from repro.runtime import ConfigCache as RCache
from repro.runtime import DynamicGNNEngine as RDynamic
from repro.runtime import LatencyWindow as RWindow
from repro.runtime import OnlineTuner as ROnline
from repro.runtime import PerLayerTuner as RPerLayer
from repro.runtime import ProfileConfig as RProfile
from repro.runtime import make_vmem_check as r_vmem_check
from repro.runtime import shape_drift as r_shape_drift
from repro.runtime import time_jitted
from repro.train.checkpoint import _flat_with_names

import repro_torch.core as TC
import repro_torch.core.autotune as TA
from repro_torch.dist import VirtualRing
from repro_torch.obs import calibrate as TCal
from repro_torch.runtime import (AggregateProfiler, ConfigCache,
                                 DynamicGNNEngine, LatencyWindow,
                                 OnlineTuner, PerLayerTuner, ProfileConfig,
                                 make_smem_check, make_vmem_check,
                                 shape_drift, time_device)
from repro_torch.serve import GNNServeEngine, TrafficPhase, ZipfTraffic
from repro_torch.serve import WorkloadStats, run_trace
from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                               graph_features, value_and_grad)
from repro_torch.train.tree import tree_flatten_with_names, tree_unflatten

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

N, D, NCLS = 240, 10, 4
CPU = "cpu"
SHAPE = dict(n_dev=4, d_feat=32, rows_per_dev=500, local_edges_max=3000,
             remote_edges_max=1800)


def _graph(C, n=N, seed=7):
    return C.power_law(n, avg_degree=6.0, locality=0.3, seed=seed)


def _h100(mod):
    """The port's H100 spec in either package's HardwareSpec."""
    return mod.HardwareSpec(**dataclasses.asdict(TA.H100_SXM))


# ---------------------------------------------------------------------------
# autotune: the copy against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["TPU_V5E", "A100_NVSWITCH", "H100_SXM"])
def test_autotune_estimates_equal_reference(spec):
    rhw = getattr(RA, spec) if spec != "H100_SXM" else _h100(RA)
    thw = getattr(TA, spec)
    assert dataclasses.asdict(rhw) == dataclasses.asdict(thw)
    for n_dev in (1, 4):
        rw = RA.WorkloadShape(**dict(SHAPE, n_dev=n_dev))
        tw = TA.WorkloadShape(**dict(SHAPE, n_dev=n_dev))
        for ps in (1, 8, 32):
            for dist in (1, 4):
                for pb in (1, 8):
                    for kw in (dict(), dict(interleave=False),
                               dict(d_out=16), dict(d_out=64, fuse=True),
                               dict(host_rows=700), dict(topk=8)):
                        assert RA.estimate_latency(
                            rw, ps, dist, pb, hw=rhw, **kw) == \
                            TA.estimate_latency(tw, ps, dist, pb, hw=thw,
                                                **kw)
                    assert RA.vmem_bytes(ps, pb, 128, 500 // dist, 32) == \
                        TA.vmem_bytes(ps, pb, 128, 500 // dist, 32)
    cfgs = [dict(ps=4, dist=2, pb=1), dict(ps=8, dist=1, pb=2, fuse=True,
                                           k=3)]
    rs = [RA.WorkloadShape(**SHAPE).with_d_feat(d) for d in (32, 16)]
    ts = [TA.WorkloadShape(**SHAPE).with_d_feat(d) for d in (32, 16)]
    assert RA.estimate_pipeline_latency(rs, cfgs, hw=rhw, d_outs=[16, 4]) \
        == TA.estimate_pipeline_latency(ts, cfgs, hw=thw, d_outs=[16, 4])
    assert dataclasses.asdict(rhw.scaled(hbm_bw=0.5)) == \
        dataclasses.asdict(thw.scaled(hbm_bw=0.5))


def test_layer_shapes_and_offline_search_equal_reference():
    rg, tg = _graph(RC, 400), _graph(TC, 400)
    for n_dev in (1, 3, 4):
        r = RA.layer_workload_shapes(rg, n_dev, [12, 5, 7])
        t = TA.layer_workload_shapes(tg, n_dev, [12, 5, 7])
        assert [dataclasses.asdict(a) for a in r] == \
            [dataclasses.asdict(b) for b in t]
    w = RA.WorkloadShape(**SHAPE)

    def surface(ps, dist, pb):
        return RA.estimate_latency(w, ps, dist, pb) * (1 + 0.03 * (ps % 3))

    chk = lambda ps, dist, pb: ps * pb <= 64
    r = RA.cross_iteration_optimize(surface, vmem_check=chk)
    t = TA.cross_iteration_optimize(surface, vmem_check=chk)
    assert (r.best, r.best_latency, r.trajectory, r.table) == \
        (t.best, t.best_latency, t.trajectory, t.table)


# ---------------------------------------------------------------------------
# tuners fed one latency surface
# ---------------------------------------------------------------------------

def _lat(cfg):
    """A deterministic latency surface with a valley at ps 4, dist 2."""
    if isinstance(cfg, list):
        return sum(_lat(dict(c, ps=c["ps"] * (i + 1)))
                   for i, c in enumerate(cfg))
    return (1.0 + 0.3 * abs(np.log2(cfg["ps"]) - 2)
            + 0.2 * abs(cfg["dist"] - 2) + 0.05 * cfg["pb"]
            + 0.01 * cfg.get("k", 0) - 0.02 * cfg.get("fanout", 0)
            + 0.5 / cfg.get("batch", 1) + 0.07 * bool(cfg.get("fuse")))


def _drive(tuner, log, limit=200):
    """Propose/observe to convergence, logging every proposal."""
    for _ in range(limit):
        if tuner.converged:
            return
        c = tuner.propose()
        log.append(c)
        tuner.observe(_lat(c))


def _same_run(rt, tt, steps):
    """Run ``steps`` on the reference and port tuners; compare all."""
    rlog, tlog = [], []
    for step in steps:
        for t, log in ((rt, rlog), (tt, tlog)):
            step(t, log)
    assert rlog == tlog
    assert rt.audit == tt.audit
    assert (rt.best, rt.best_latency, rt.measured, rt.converged) == \
        (tt.best, tt.best_latency, tt.measured, tt.converged)
    assert rt.observations() == tt.observations()
    return tlog


ONLINE = {
    "plain": (dict(), []),
    "budget": (dict(budget=5), []),
    "warm": (dict(warm_start=dict(ps=8, dist=1, pb=2)), []),
    "vmem": (dict(vmem="tpu"), []),
    "knobs": (dict(k_space=(2, 4), fanout_space=(3, 6),
                   batch_space=(16, 32)), []),
    "drift": (dict(), ["far"]),
    "adopt": (dict(), ["adopt"]),
    "adopt_infeasible": (dict(vmem="ps<16"), ["adopt16"]),
}


@pytest.mark.parametrize("case", sorted(ONLINE))
def test_online_tuner_equals_reference(case):
    kw, extra = ONLINE[case]
    kw = dict(kw)
    vmem = kw.pop("vmem", None)
    base, far = dict(SHAPE), dict(SHAPE, remote_edges_max=3000)

    def make(mod, shapes):
        check = None
        if vmem == "tpu":
            w = shapes.WorkloadShape(**dict(SHAPE, d_feat=4096))
            check = (r_vmem_check if mod is ROnline else make_vmem_check)(w)
        elif vmem == "ps<16":
            check = lambda ps, dist, pb: ps < 16
        t = mod((1, 2, 4, 8, 16, 32), (1, 2, 4), (1, 2, 4),
                vmem_check=check, **kw)
        t.observe_shape(shapes.WorkloadShape(**base))
        return t

    def step_for(name):
        def step(t, log):
            mod = RA if isinstance(t, ROnline) else TA
            if name == "far":
                assert t.observe_shape(mod.WorkloadShape(**far))
            elif name == "adopt":
                t.reopen(warm_start=dict(ps=2, dist=4, pb=1), mode="adopt")
            elif name == "adopt16":
                t.reopen(warm_start=dict(ps=16, dist=1, pb=1), mode="adopt")
            _drive(t, log)
        return step

    log = _same_run(make(ROnline, RA), make(OnlineTuner, TA),
                    [step_for(None)] + [step_for(e) for e in extra])
    assert log


PER_LAYER = {
    "plain": dict(),
    "budget": dict(budget=9),
    "fuse": dict(fuse_space=(False, True)),
    "warm_global": dict(warm_start=dict(ps=8, dist=1, pb=1)),
    "warm_layers": dict(warm_start=[dict(ps=2, dist=1, pb=1),
                                    dict(ps=4, dist=2, pb=1),
                                    dict(ps=8, dist=4, pb=1)]),
    "no_global_first": dict(tune_global_first=False),
}


@pytest.mark.parametrize("case", sorted(PER_LAYER))
def test_per_layer_tuner_equals_reference(case):
    kw = PER_LAYER[case]
    warm = [dict(ps=2, dist=1, pb=1), dict(ps=4, dist=2, pb=1),
            dict(ps=2, dist=2, pb=1)]

    def make(mod):
        t = mod(3, (1, 2, 4, 8), (1, 2, 4), (1, 2), **kw)
        t.observe_shape(_shapes(t, dict(SHAPE)))
        return t

    def _shapes(t, shape):
        mod = RA if isinstance(t, RPerLayer) else TA
        return [mod.WorkloadShape(**shape).with_d_feat(d)
                for d in (32, 16, 8)]

    def drift(t, log):
        # +60 % remote edges: the search re-opens, warm from the best
        assert t.observe_shape(_shapes(t, dict(SHAPE,
                                               remote_edges_max=2900)))
        _drive(t, log)

    def adopt(t, log):
        t.reopen(warm_start=warm, mode="adopt")
        _drive(t, log)

    def resize(t, log):
        # wrong layer count: resized and searched, not adopted
        t.reopen(warm_start=warm[:2], mode="adopt")
        _drive(t, log)
        t.reconfigure(num_layers=2)
        t.reopen()
        _drive(t, log)

    _same_run(make(RPerLayer), make(PerLayerTuner),
              [lambda t, log: _drive(t, log), drift, adopt, resize])


def test_shape_drift_and_feasibility_rules():
    ra = RA.WorkloadShape(**SHAPE)
    for other in (dict(SHAPE, d_feat=48), dict(SHAPE, n_dev=2),
                  dict(SHAPE, remote_edges_max=900)):
        assert r_shape_drift(ra, RA.WorkloadShape(**other)) == \
            shape_drift(TA.WorkloadShape(**SHAPE), TA.WorkloadShape(**other))
    rc = r_vmem_check(RA.WorkloadShape(**dict(SHAPE, d_feat=4096)))
    tc = make_vmem_check(TA.WorkloadShape(**dict(SHAPE, d_feat=4096)))
    grid = [(ps, dist, pb) for ps in (1, 8, 64, 512, 4096)
            for dist in (1, 4) for pb in (1, 16, 64)]
    assert [rc(*k) for k in grid] == [tc(*k) for k in grid]
    from repro_torch.kernels.neighbor_agg import blocked_fits
    smem = make_smem_check()
    assert all(smem(ps, dist, pb) == blocked_fits(pb, ps)
               for ps, dist, pb in grid)
    assert smem(4096, 1, 0)           # pb 0 is K1: always feasible


# ---------------------------------------------------------------------------
# cache, profiler, calibration
# ---------------------------------------------------------------------------

def test_cache_roundtrip_corruption_and_layers_keys(tmp_path):
    rw, tw = RA.WorkloadShape(**SHAPE), TA.WorkloadShape(**SHAPE)
    rws = [rw.with_d_feat(d) for d in (32, 8)]
    tws = [tw.with_d_feat(d) for d in (32, 8)]
    path = str(tmp_path / "tuned.json")
    t, r = ConfigCache(path, hw="hw0"), RCache(path, hw="hw0")
    assert t.key(tw) == r.key(rw) and t.layers_key(tws) == r.layers_key(rws)
    cfg = dict(ps=4, dist=2, pb=0, k=3, fanout=5, batch=64, fuse=True)
    t.put(tw, cfg, 1.5e-3)
    assert r.get(rw) == t.get(tw) == cfg
    layers = [dict(ps=2, dist=1, pb=1), dict(ps=8, dist=2, pb=2, fuse=False)]
    r.put_layers(rws, layers, 2e-3)
    assert t.get_layers(tws) == r.get_layers(rws) == layers
    assert len(t) == len(r) == 2
    assert t.get(tw, hw="other") is None
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == 5 and set(doc["entries"]) == {
        t.key(tw), t.layers_key(tws)}
    for bad in ("{not json", json.dumps(dict(version=4, entries={}))):
        with open(path, "w") as f:
            f.write(bad)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert t.get(tw) is None and len(t) == 0
    t.put(tw, dict(ps=1, dist=1, pb=1), 1.0)   # recovers: rewrites cleanly
    assert r.get(rw) == dict(ps=1, dist=1, pb=1)


def test_latency_window_and_timers_equal_reference():
    cfg = dict(warmup=2, iters=5, percentile=75.0)
    rwin, twin = RWindow(RProfile(**cfg)), LatencyWindow(ProfileConfig(**cfg))
    for dt in (9.0, 8.0, 1.0, 3.0, 2.0, 7.0, 4.0):
        assert rwin.add(dt) == twin.add(dt)
    assert rwin.value() == twin.value()
    ticks = lambda: iter(np.cumsum([0.0, 1.0, 0.5, 2.0, 0.25, 3.0, 1.0]))
    rt, tt = ticks(), ticks()
    pc = ProfileConfig(warmup=1, iters=3)
    assert time_jitted(lambda: 1.0, cfg=RProfile(warmup=1, iters=3),
                       clock=lambda: float(next(rt))) == \
        time_device(lambda: 1.0, cfg=pc, clock=lambda: float(next(tt)),
                    device=CPU)


def test_model_profiler_and_calibration_equal_reference():
    rg, tg = _graph(RC, 300), _graph(TC, 300)
    r = RProfiler(rg, None, 16, mode="model")
    t = AggregateProfiler(tg, None, 16, mode="model", hw=RA.TPU_V5E)
    for key in ((1, 1, 1), (4, 2, 1), (16, 1, 8), (4, 2, 1)):
        assert r(*key) == t(*key)
    assert r.observations() == t.observations()
    with pytest.raises(RuntimeError):
        AggregateProfiler(tg, None, 16, mode="measure")(1, 1, 1)
    # a ring measures (never the model), memoized; by default the kernels
    # and the card's spec, as every entry of the port
    ring = VirtualRing(2, CPU)
    m = AggregateProfiler(tg, ring, 16, profile=ProfileConfig(0, 1))
    assert m.measuring and m(4, 1, 0) > 0 and m(4, 1, 0) == m(4, 1, 0)
    assert m.use_kernel and m.hw is TA.H100_SXM
    # the calibration fit on one audit trail
    audit = [dict(event="probe", config=dict(ps=ps, dist=dist, pb=1),
                  latency=1e-4 * ps + 3e-4 * dist, measured=i)
             for i, (ps, dist) in enumerate([(1, 1), (4, 1), (4, 2),
                                             (16, 2), (8, 4)])]
    assert RCal.observations_from_audit(audit) == \
        TCal.observations_from_audit(audit)
    obs = TCal.observations_from_audit(audit)
    rw, tw = RA.WorkloadShape(**SHAPE), TA.WorkloadShape(**SHAPE)
    assert RCal.model_errors(rw, obs, RA.TPU_V5E) == \
        TCal.model_errors(tw, obs, TA.TPU_V5E)
    rf = RCal.fit_spec(rw, obs, RA.TPU_V5E, rounds=1)
    tf = TCal.fit_spec(tw, obs, TA.TPU_V5E, rounds=1)
    assert (rf.scales, rf.error, rf.base_error, rf.n_observations) == \
        (tf.scales, tf.error, tf.base_error, tf.n_observations)
    assert dataclasses.asdict(rf.spec) == dataclasses.asdict(tf.spec)
    # the probes (tests/test_torch_obs.py): the spec from one probe set
    probes = TCal.probe_hardware(ring)
    assert dataclasses.asdict(TCal.spec_from_probes(TA.TPU_V5E, probes)) \
        == dataclasses.asdict(RCal.spec_from_probes(RA.TPU_V5E, probes))


# ---------------------------------------------------------------------------
# per-layer engine against the reference
# ---------------------------------------------------------------------------

def _ref_params(model):
    kw = dict(hidden=8, num_layers=2)
    return RC.MODEL_ZOO[model][0](jax.random.key(1), D, NCLS, **kw)


def _port_params(model, rp):
    like = TC.MODEL_ZOO[model][0](torch.Generator().manual_seed(0), D, NCLS,
                                  hidden=8, num_layers=2)
    return tree_unflatten(like, [
        torch.tensor(np.asarray(v)) for _, v in _flat_with_names(rp)])


def _tables(C, eng, x, y, mask, to):
    pad1 = lambda a: C.pad_table(eng.plan.bounds, eng.plan.rows_per_dev,
                                 a[:, None])[:, 0]
    return (to(eng.pad(x)), to(pad1(y.astype(np.int32))),
            to(pad1(mask.astype(np.float32))))


LAYER_CONFIGS = [dict(ps=2, dist=1), dict(ps=4, dist=2, fuse_update=True)]


@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_per_layer_engine_equals_reference(model):
    x, y, mask = graph_features(N, D, NCLS, seed=0)
    rp = _ref_params(model)
    reng = RC.GNNEngine.build(_graph(RC), flat_ring_mesh(1),
                              layer_configs=LAYER_CONFIGS)
    rx, ry, rm = _tables(RC, reng, x, y, mask, jnp.asarray)
    apply = RC.MODEL_ZOO[model][1]

    @jax.jit
    def fwd_grad(p):
        def loss(p):
            logits = apply(p, reng, rx)
            return RC.masked_cross_entropy(logits, ry, rm), logits
        return jax.value_and_grad(loss, has_aux=True)(p)

    (_, r_logits), r_grads = fwd_grad(rp)
    teng = TC.GNNEngine.build(_graph(TC), VirtualRing(4, CPU),
                              layer_configs=LAYER_CONFIGS)
    assert teng.per_layer and teng.partition is not None
    assert teng.layer_configs == [dict(ps=2, dist=1, pb=1),
                                  dict(ps=4, dist=2, pb=1)]
    assert teng.ring_arrays[0] is not teng.ring_arrays[1]
    tx, ty, tm = _tables(TC, teng, x, y, mask, torch.from_numpy)
    tapply = TC.MODEL_ZOO[model][1]
    logits = []

    def loss(p):
        logits.append(tapply(p, teng, tx))
        return TC.masked_cross_entropy(logits[-1], ty, tm)

    _, grads = value_and_grad(loss, _port_params(model, rp))
    np.testing.assert_allclose(
        TC.unpad_embeddings(teng.plan, logits[0].detach().numpy()),
        RC.unpad_embeddings(reng.plan, np.asarray(r_logits)),
        rtol=2e-4, atol=1e-5)
    for (name, a), (_, b) in zip(tree_flatten_with_names(grads),
                                 _flat_with_names(r_grads)):
        assert np.abs(np.asarray(b)).max() > 0, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# DynamicGNNEngine against the reference's config history
# ---------------------------------------------------------------------------

def _feed(eng, log, until_commit=True, limit=100):
    for _ in range(limit):
        if eng.tuner.converged and until_commit:
            return
        log.append(eng.config)
        eng.observe_step(_lat(eng.config["layers"] if "layers" in eng.config
                              else eng.config))


@pytest.mark.parametrize("mode", ["global", "per_layer"])
def test_dynamic_engine_history_equals_reference(mode, tmp_path):
    kw = dict(d_feat=D, ps_space=(2, 4, 8), dist_space=(1, 2),
              pb_space=(1, 2), budget=14)
    if mode == "per_layer":
        kw["layer_dims"] = [D, 4]
    rpath, tpath = str(tmp_path / "r.json"), str(tmp_path / "t.json")
    r = RDynamic.build(_graph(RC), flat_ring_mesh(1),
                       window=RProfile(warmup=0, iters=1), cache_path=rpath,
                       **kw)
    t = DynamicGNNEngine.build(_graph(TC), VirtualRing(1, CPU),
                               window=ProfileConfig(warmup=0, iters=1),
                               cache_path=tpath, hw=TA.TPU_V5E, **kw)
    part = t.partition
    rlog, tlog = [], []
    for eng, log in ((r, rlog), (t, tlog)):
        _feed(eng, log)
        assert eng.retune(force=True)            # traffic drift: re-search
        _feed(eng, log)
        assert eng.retune(force=True, from_cache=True)   # adopt the cache
        _feed(eng, log)
    assert rlog == tlog and r.history == t.history
    assert len(t.history) > 3 and t.partition is part   # built once
    assert r.audit == t.audit and r.config == t.config
    with open(rpath) as f, open(tpath) as g:
        assert json.load(f) == json.load(g)
    # the port's cache file warm-starts the reference, and vice versa
    r2 = RDynamic.build(_graph(RC), flat_ring_mesh(1), cache_path=tpath,
                        **kw)
    t2 = DynamicGNNEngine.build(_graph(TC), VirtualRing(1, CPU),
                                cache_path=rpath, hw=TA.TPU_V5E, **kw)
    assert r2.config == t2.config == t.config


def test_cap_space_raises_naming_its_item():
    """ROADMAP item 5 landed: a ``cap_space`` is searched (its history
    against the reference's is in ``test_torch_tiered.py``).  Item 7
    landed too: the serving engine stores the cluster's retune gate and
    asks it before a drift retune, which a False answer defers."""
    e = DynamicGNNEngine.build(_graph(TC), VirtualRing(1, CPU), d_feat=D,
                               ps_space=(8,), dist_space=(1,), pb_space=(0,),
                               cap_space=(0, 64),
                               window=ProfileConfig(warmup=0, iters=1))
    assert e.feature_capacity in (0, 64) and e.config["cap"] == \
        e.feature_capacity
    _feed(e, [])
    assert e.committed and e.feature_capacity in (0, 64)
    asked = []

    def gate(srv, score):
        asked.append(score)
        return False                            # defer every retune

    srv = GNNServeEngine(e, TC.gcn_init(torch.Generator().manual_seed(0), D,
                                        NCLS), "gcn",
                         np.zeros((N, D), np.float32), _graph(TC),
                         slots=4, stats=WorkloadStats(window=8, top_k=8),
                         check_every=2, min_records=4, retune_gate=gate)
    assert srv.retune_gate is gate and not srv._tuning
    phases = [TrafficPhase(requests=40, alpha=1.4, rate=100.0, seeds_max=3),
              TrafficPhase(requests=40, alpha=1.4, rate=400.0, rotate=True,
                           seeds_max=3)]
    run_trace(srv, ZipfTraffic(N, D, phases, seed=11))
    assert asked and all(score > srv.drift_threshold for score in asked)
    assert srv.retunes == 0 and e.committed     # every retune deferred


def test_fanout_and_batch_roundtrip_through_the_cache(tmp_path):
    path = str(tmp_path / "tuned.json")
    kw = dict(d_feat=D, ps_space=(8,), dist_space=(1,), pb_space=(0,),
              fanout_space=(3, 6), batch_space=(16, 32),
              window=ProfileConfig(warmup=0, iters=1), cache_path=path)
    e = DynamicGNNEngine.build(_graph(TC), VirtualRing(2, CPU), **kw)
    arrays = e.engine.ring_arrays[0]
    _feed(e, [])
    assert e.committed and (e.sample_fanout, e.sample_batch) == (6, 32)
    assert len(e.history) > 1 and e.engine.ring_arrays[0] is arrays
    e2 = DynamicGNNEngine.build(_graph(TC), VirtualRing(2, CPU), **kw)
    assert e2.config == e.config                 # warm start: measured first
    cached = RCache(path, hw="cpu:cpu:1").get(RA.WorkloadShape(
        **dataclasses.asdict(e.shape)))
    assert cached == e.config


# ---------------------------------------------------------------------------
# bitwise inside the port
# ---------------------------------------------------------------------------

def _step(apply, eng, tables, ocfg):
    xp, yp, mp = tables

    def step(p, opt):
        loss, grads = value_and_grad(
            lambda q: TC.masked_cross_entropy(apply(q, eng, xp), yp, mp), p)
        p, opt, _ = adamw_update(grads, opt, p, ocfg)
        return p, opt, loss
    return step


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("layer_dims", [None, [D, 8]])
def test_dynamic_equals_static_bitwise_after_commit(layer_dims):
    g = _graph(TC)
    ring = VirtualRing(4, CPU)
    x, y, mask = graph_features(N, D, NCLS, seed=0)
    init, apply, _ = TC.MODEL_ZOO["gcn"]
    p = init(torch.Generator().manual_seed(0), D, NCLS, hidden=8)
    opt = adamw_init(p)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=20,
                       weight_decay=0.0)
    dyn = DynamicGNNEngine.build(
        g, ring, d_feat=D, ps_space=(2, 4, 8), dist_space=(1, 2),
        window=ProfileConfig(warmup=0, iters=1), layer_dims=layer_dims)
    tables = _tables(TC, dyn, x, y, mask, torch.from_numpy)
    for _ in range(40):
        p, opt, _ = _step(apply, dyn, tables, ocfg)(p, opt)
        cfg = dyn.config
        if dyn.observe_step(_lat(cfg["layers"] if layer_dims else cfg)):
            tables = _tables(TC, dyn, x, y, mask, torch.from_numpy)
        if dyn.committed:
            break
    assert dyn.committed and len(dyn.history) > 2
    cfg = dyn.config
    static = TC.GNNEngine.build(g, ring, **(
        dict(layer_configs=[dict(c, pb=None) for c in cfg["layers"]])
        if layer_dims else dict(ps=cfg["ps"], dist=cfg["dist"])))
    runs = []
    for eng in (dyn, static):
        q, o, tb = _clone(p), _clone(opt), _tables(TC, eng, x, y, mask,
                                                  torch.from_numpy)
        losses = []
        for _ in range(3):
            q, o, loss = _step(apply, eng, tb, ocfg)(q, o)
            losses.append(loss)
        runs.append((losses, q))
    (la, qa), (lb, qb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_flatten_with_names(qa), tree_flatten_with_names(qb)))


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_per_layer_equals_single_plan_bitwise(model):
    g = _graph(TC)
    ring = VirtualRing(4, CPU)
    x, y, mask = graph_features(N, D, NCLS, seed=0)
    init, apply, _ = TC.MODEL_ZOO[model]
    p = init(torch.Generator().manual_seed(0), D, NCLS, hidden=8,
             num_layers=2)
    single = TC.GNNEngine.build(g, ring, ps=4, dist=2)
    per = TC.GNNEngine.build(g, ring,
                             layer_configs=[dict(ps=4, dist=2)] * 2)
    assert per.layer_plans[0].plan is per.layer_plans[1].plan
    assert per.ring_arrays[0] is per.ring_arrays[1]
    out = []
    for eng in (single, per):
        xp, yp, mp = _tables(TC, eng, x, y, mask, torch.from_numpy)
        logits = apply(p, eng, xp)
        _, grads = value_and_grad(lambda q: TC.masked_cross_entropy(
            apply(q, eng, xp), yp, mp), p)
        out.append((logits, grads))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_flatten_with_names(out[0][1]),
        tree_flatten_with_names(out[1][1])))


def test_pb_only_move_keeps_the_plan_arrays():
    dyn = DynamicGNNEngine.build(_graph(TC), VirtualRing(4, CPU), d_feat=D,
                                 ps_space=(4,), dist_space=(2,),
                                 window=ProfileConfig(warmup=0, iters=1))
    before = dyn.engine.ring_arrays[0]
    assert dyn._set_config(dict(ps=4, dist=2, pb=4))
    assert dyn.engine.ring_arrays[0] is before and dyn.engine.pb == 4
    assert dyn._set_config(dict(ps=8, dist=2, pb=4))
    assert dyn.engine.ring_arrays[0] is not before


def test_served_equals_offline_after_a_drift_retune():
    g = _graph(TC, 400, seed=3)
    x = np.random.default_rng(0).normal(size=(400, D)).astype(np.float32)
    init, apply, _ = TC.MODEL_ZOO["gcn"]
    p = init(torch.Generator().manual_seed(0), D, NCLS, hidden=8)
    dyn = DynamicGNNEngine.build(g, VirtualRing(4, CPU), d_feat=D,
                                 ps_space=(2, 4, 8), dist_space=(1, 2),
                                 window=ProfileConfig(warmup=0, iters=1))
    srv = GNNServeEngine(dyn, p, "gcn", x, g, slots=8, check_every=4,
                         min_records=4, stats=WorkloadStats(window=16))
    phases = [TrafficPhase(requests=80, alpha=1.2, rate=200.0, seeds_max=4,
                           update_frac=0.05),
              TrafficPhase(requests=80, alpha=1.2, rate=200.0, rotate=True,
                           seeds_max=4, update_frac=0.05)]
    results = run_trace(srv, ZipfTraffic(400, D, phases, seed=1))
    rep = srv.report()
    assert rep["retunes"] >= 1 and rep["rebuilds"] >= 2
    assert rep["served"] == len(results) and not srv._tuning
    srv.check_every = 10 ** 9       # no further drift check: hold the config
    seeds = np.array([0, 5, 17, 99])
    srv.cache.invalidate()
    srv.submit(seeds)
    (full,) = srv.step()
    srv.submit(seeds)
    (cached,) = srv.step()
    assert not full.cached and cached.cached
    with torch.inference_mode():
        offline = apply(p, dyn, srv.xp)
    rows = torch.from_numpy(TC.pgas_rows(dyn.plan, seeds).astype(np.int64))
    np.testing.assert_array_equal(full.logits, offline[rows].numpy())
    np.testing.assert_array_equal(cached.logits, offline[rows].numpy())


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_train_launcher_tuner_flags_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train_gnn
    base = ["--device", "cpu", "--scale", "0.02", "--devices", "4",
            "--workdir", str(tmp_path / "ck")]
    cache = str(tmp_path / "tuned.json")
    metrics = str(tmp_path / "m.json")
    # 40 steps: the launcher's search (6 ps x 3 dist, a window of 3 steps)
    # measured at most 11 configs over 3000 random latency feeds, so it
    # commits whatever the host's timings
    rep = train_gnn.main(base + ["--steps", "40", "--dynamic-tune",
                                 "--tune-cache", cache,
                                 "--metrics-json", metrics])
    assert np.isfinite(rep["losses"]).all() and set(rep["config"]) == {
        "ps", "dist", "pb"}
    with open(metrics) as f:
        audit = json.load(f)["audit"]
    assert any(ev["event"] == "commit" for ev in audit)
    again = train_gnn.main(base + ["--steps", "2", "--dynamic-tune",
                                   "--tune-cache", cache])
    assert "warm start from cache" in capsys.readouterr().out
    assert again["config"] == rep["config"]
    per = train_gnn.main(base + ["--steps", "6", "--tune-fuse",
                                 "--model", "gin"])
    assert len(per["config"]["layers"]) == 5
    sampled = train_gnn.main(["--device", "cpu", "--scale", "0.02",
                              "--steps", "10", "--model", "sage",
                              "--sample-fanout", "3", "--sample-batch", "16",
                              "--dynamic-tune"])
    assert {sampled["fanout"], sampled["batch"]} <= {3, 6, 16, 32}
    assert (sampled["config"]["fanout"], sampled["config"]["batch"]) == \
        (sampled["fanout"], sampled["batch"])


def test_serve_launcher_tuner_flags_on_cpu(tmp_path):
    from repro_torch.launch import serve_gnn
    base = ["--device", "cpu", "--scale", "0.05", "--devices", "4"]
    rep = serve_gnn.main(base + [
        "--requests", "100", "--rotate", "--dynamic-tune", "--check-every",
        "4", "--min-records", "4", "--stats-window", "16", "--tune-cache",
        str(tmp_path / "t.json")])
    assert rep["retunes"] >= 1 and rep["served"] > 0
    per = serve_gnn.main(base + ["--requests", "20", "--per-layer-tune"])
    assert len(per["config"]["layers"]) == 2
    tiered = serve_gnn.main(base + ["--requests", "20", "--feature-capacity",
                                    "0", "--frontier-fanout", "3"])
    assert tiered["served"] == 40 and tiered["tiers"]["capacity"] == 0
    cluster = serve_gnn.main(base + [
        "--requests", "40", "--rotate", "--replicas", "2", "--router",
        "load", "--dynamic-tune", "--check-every", "4", "--min-records",
        "4", "--stats-window", "16"])
    assert cluster["replicas"] == 2 and cluster["router"] == "load"
    assert cluster["dropped"] == 0 and cluster["served"] == sum(
        p["served"] for p in cluster["per_replica"]) > 0
