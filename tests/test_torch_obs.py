"""repro_torch's observability tools and baselines against the JAX
reference's, on the CPU.

* ``obs/validate.py`` (a copy) finds the reference's problems in the same
  traces, and its CLI passes the serving launcher's merged cluster trace;
* the probes of ``obs/calibrate.py`` return their keys (the link None
  without a ring of two shards, any failing probe None) and
  ``spec_from_probes`` gives the reference's spec from the same probes;
* tracing leaves the training launcher's losses and parameters bitwise
  alone, full-graph and sampled;
* ``bulk_aggregate`` and ``fetch_rows_aggregate`` (pages of 1 and 16
  rows) give the reference's outputs within 1e-5 on one shard, here, and
  on four, in ``tests/test_torch_serve.py`` (whose 4-device dump holds
  the reference's).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as RC
import repro.core.autotune as RA
from repro.dist import flat_ring_mesh
from repro.obs import calibrate as RCal
from repro.obs.validate import validate as r_validate

import repro_torch.core as TC
import repro_torch.core.autotune as TA
from repro_torch.dist import VirtualRing
from repro_torch.obs import calibrate as TCal
from repro_torch.obs import validate as TV

torch.set_num_threads(2)

CPU = "cpu"
D = 23
PAGES = (1, 16)


# ---------------------------------------------------------------------------
# the validator
# ---------------------------------------------------------------------------

_GOOD = [{"ph": "X", "name": "mgg.stream.ring", "ts": 0, "dur": 5},
         {"ph": "X", "name": "mgg.stream.aggregate", "ts": 0, "dur": 9,
          "args": {"overlap_efficiency": 0.4}},
         {"ph": "i", "name": "tuner.probe", "ts": 1}]
TRACES = {
    "good": {"traceEvents": _GOOD},
    "missing_all": {"traceEvents": [{"ph": "i", "name": "serve.retune",
                                     "ts": 0}]},
    "never_positive": {"traceEvents": [
        _GOOD[0], dict(_GOOD[1], args={"overlap_efficiency": 0.0}),
        _GOOD[2]]},
    "no_tuner": {"traceEvents": _GOOD[:2]},
    "malformed": {"traceEvents": [{"name": "x"}]},
    "no_events": {"events": []},
    "empty": {"traceEvents": []},
}


@pytest.mark.parametrize("case", sorted(TRACES) + ["garbage"])
def test_validator_equals_reference(tmp_path, case):
    path = str(tmp_path / f"{case}.json")
    with open(path, "w") as f:
        if case == "garbage":
            f.write("not json {")
        else:
            json.dump(TRACES[case], f)
    got = TV.validate(path)
    want = r_validate(path)
    if case == "garbage":        # the parser's message names the position
        assert len(got) == len(want) == 1 and "JSON" in got[0]
    else:
        assert got == want
    assert (got == []) == (case == "good")
    assert TV.main([path]) == (0 if case == "good" else 1)


def test_validator_cli_usage():
    assert TV.main([]) == 2


def test_launcher_cluster_trace_validates(tmp_path, capsys):
    """The serving launcher with two replicas, the locality router, the
    tuner and the tiered store: one merged trace (the cluster and each
    replica a timeline) that the validator passes, every request
    answered, a metrics snapshot with each replica's audit trail."""
    from repro_torch.launch import serve_gnn

    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    rep = serve_gnn.main([
        "--device", "cpu", "--scale", "0.05", "--devices", "2",
        "--requests", "40", "--rotate", "--replicas", "2", "--router",
        "locality", "--dynamic-tune", "--check-every", "4",
        "--min-records", "4", "--stats-window", "16",
        "--feature-capacity", "64", "--trace", trace,
        "--metrics-json", metrics])
    n = sum(p["served"] for p in rep["per_replica"])
    assert rep["replicas"] == 2 and rep["router"] == "locality"
    assert rep["served"] == n > 0 and rep["dropped"] == 0
    assert all(p["served"] > 0 for p in rep["per_replica"])
    assert rep["pipeline_profile"]["prefetch_issued"] >= 0
    assert TV.validate(trace) == [] and TV.main([trace]) == 0
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    pids = {e["pid"] for e in events if e["ph"] != "M"}
    assert {1, 2} <= pids                       # a timeline each replica
    assert sum(e["name"] == "serve.request" for e in events) >= n
    for label in ("cluster", "replica0", "replica1"):
        assert (tmp_path / f"t.json.{label}.jsonl").exists()
    with open(metrics) as f:
        assert set(json.load(f)["audit"]) == {"replica0", "replica1"}
    assert "merged chrome trace" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------

def _h100(mod):
    return mod.HardwareSpec(**dataclasses.asdict(TA.H100_SXM))


@pytest.mark.parametrize("n_dev", [None, 1, 4])
def test_probes_return_their_keys(n_dev):
    ring = None if n_dev is None else VirtualRing(n_dev, CPU)
    probes = TCal.probe_hardware(ring, device=CPU)
    assert set(probes) == {"peak_flops", "host_bw", "link_bw"}
    assert probes["peak_flops"] > 0 and probes["host_bw"] > 0
    if n_dev == 4:
        assert probes["link_bw"] > 0
    else:
        assert probes["link_bw"] is None


def test_spec_from_probes_equals_reference():
    probes = TCal.probe_hardware(VirtualRing(4, CPU))
    for base, rbase in ((TA.H100_SXM, _h100(RA)), (TA.TPU_V5E, RA.TPU_V5E)):
        got = TCal.spec_from_probes(base, probes)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            RCal.spec_from_probes(rbase, probes))
        assert got.name == base.name + "+probed"
        assert (got.peak_flops, got.host_bw, got.link_bw) == (
            probes["peak_flops"], probes["host_bw"], probes["link_bw"])
        assert got.hbm_bw == base.hbm_bw
    none = dict.fromkeys(probes)
    assert TCal.spec_from_probes(TA.H100_SXM, none) is TA.H100_SXM
    assert TCal.spec_from_probes(TA.H100_SXM, ring=VirtualRing(
        1, CPU)).link_bw == TA.H100_SXM.link_bw


def test_failing_probe_is_none(monkeypatch):
    def boom(**_kw):
        raise RuntimeError("no device")
    monkeypatch.setattr(TCal, "probe_matmul_flops", boom)
    probes = TCal.probe_hardware(VirtualRing(2, CPU))
    assert probes["peak_flops"] is None and probes["host_bw"] > 0


def test_calibrate_cli(capsys):
    assert TCal.main(["--device", "cpu", "--devices", "2", "--base",
                      "h100_sxm", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert set(doc["probes"]) == {"peak_flops", "host_bw", "link_bw"}
    assert doc["spec"]["name"] == "h100_sxm+probed"


# ---------------------------------------------------------------------------
# tracing on == off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["full", "sampled"])
def test_training_losses_bitwise_with_tracing(tmp_path, branch):
    from repro_torch.launch import train_gnn
    from repro_torch.train.tree import tree_leaves

    argv = ["--device", "cpu", "--steps", "3", "--scale", "0.02",
            "--devices", "2", "--workdir", str(tmp_path / "ck")]
    if branch == "sampled":
        argv += ["--model", "sage", "--sample-fanout", "3",
                 "--sample-batch", "16"]
    base = train_gnn.main(argv)
    trace = str(tmp_path / "t.json")
    traced = train_gnn.main(argv + ["--trace", trace])
    assert base["losses"] == traced["losses"]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(base["params"]), tree_leaves(traced["params"])))
    with open(trace) as f:
        steps = [e for e in json.load(f)["traceEvents"]
                 if e["name"].startswith("train.")]
    assert len(steps) == 3


# ---------------------------------------------------------------------------
# the baselines on one shard
# ---------------------------------------------------------------------------

def _graph(C):
    return C.power_law(360, avg_degree=7.0, locality=0.35, seed=11)


def _features(n):
    return np.random.default_rng(3).normal(size=(n, D)).astype(np.float32)


def port_baselines(n_dev, ps=8):
    """The port's bulk output (padded table) and fetch outputs (one a
    page size) on ``n_dev`` shards, and the dense oracle."""
    g = _graph(TC)
    x = _features(g.num_nodes)
    nbrs, mask, tgt, rows = TC.build_bulk_plan(g, n_dev, ps)
    bounds = TC.edge_balanced_node_split(g.indptr, n_dev)
    xp = torch.from_numpy(TC.pad_table(bounds, rows, x))
    out = {"bulk": TC.bulk_aggregate(xp, nbrs, mask, tgt, rows,
                                     VirtualRing(n_dev, CPU)).numpy()}
    for page in PAGES:
        fp = TC.build_fetch_plan(g, n_dev, ps, page_rows=page)
        out[f"fetch{page}"] = TC.fetch_rows_aggregate(
            xp, fp["fetch_rows"], fp["nbrs"], fp["mask"], fp["targets"],
            fp["rows_per_dev"]).numpy()
    dense = TC.reference_aggregate(g.indptr, g.indices, x)
    return out, bounds, rows, dense


def reference_baselines(n_dev, mesh, ps=8):
    """The reference's outputs of :func:`port_baselines`, jitted."""
    g = _graph(RC)
    x = _features(g.num_nodes)
    nbrs, mask, tgt, rows = RC.build_bulk_plan(g, n_dev, ps)
    bounds = RC.edge_balanced_node_split(g.indptr, n_dev)
    xp = jnp.asarray(RC.pad_table(bounds, rows, x))
    bulk = jax.jit(lambda t: RC.bulk_aggregate(t, nbrs, mask, tgt, rows,
                                               mesh))
    out = {"bulk": np.asarray(bulk(xp))}
    for page in PAGES:
        fp = RC.build_fetch_plan(g, n_dev, ps, page_rows=page)
        fetch = jax.jit(lambda t, fp=fp: RC.fetch_rows_aggregate(
            t, fp["fetch_rows"], fp["nbrs"], fp["mask"], fp["targets"],
            fp["rows_per_dev"]))
        out[f"fetch{page}"] = np.asarray(fetch(xp))
    return out


def test_baselines_match_reference_one_shard():
    got, bounds, rows, dense = port_baselines(1)
    want = reference_baselines(1, flat_ring_mesh(1))
    assert set(got) == set(want)
    for key in got:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
        np.testing.assert_allclose(
            TC.unpad_table(bounds, rows, got[key].reshape(-1, D)), dense,
            rtol=1e-5, atol=1e-5, err_msg=key)


def test_baseline_groups_are_reused_and_checked():
    """Groups built once give the same bits as groups built per call, on
    the plain versions as on the kernels' route; a ring of the wrong size
    and a table of the wrong length are refused."""
    g = _graph(TC)
    x = _features(g.num_nodes)
    nbrs, mask, tgt, rows = TC.build_bulk_plan(g, 4, 8)
    bounds = TC.edge_balanced_node_split(g.indptr, 4)
    xp = torch.from_numpy(TC.pad_table(bounds, rows, x))
    ring = VirtualRing(4, CPU)
    groups = TC.pipeline.bulk_groups(nbrs, mask, tgt, CPU)
    assert len(groups) == 4
    assert all(int(grp.mask.any(-1).all()) for grp in groups)
    a = TC.bulk_aggregate(xp, nbrs, mask, tgt, rows, ring, groups=groups)
    b = TC.bulk_aggregate(xp, nbrs, mask, tgt, rows, ring, use_kernel=False)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TC.bulk_aggregate(xp, nbrs, mask, tgt, rows, VirtualRing(2, CPU))
    with pytest.raises(ValueError):
        TC.bulk_aggregate(xp[:-1], nbrs, mask, tgt, rows, ring)
    fp = TC.build_fetch_plan(g, 4, 8, page_rows=16)
    args = (fp["fetch_rows"], fp["nbrs"], fp["mask"], fp["targets"])
    fg = TC.pipeline.fetch_groups(*args, CPU)
    c = TC.fetch_rows_aggregate(xp, *args, fp["rows_per_dev"], groups=fg)
    d = TC.fetch_rows_aggregate(xp, *args, fp["rows_per_dev"],
                                use_kernel=False)
    assert torch.equal(c, d)
    with pytest.raises(ValueError):
        TC.fetch_rows_aggregate(xp, *args, fp["rows_per_dev"],
                                groups=fg[:2])
