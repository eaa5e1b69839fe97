"""repro_torch full-graph training against the JAX reference.

The same inputs (``graph_features`` from a seed, the reference's weights
carried over) go through both packages: logits and every parameter
gradient of GCN, GIN, SAGE and GAT, fused and unfused, on 1 and 4
shards, interleave on and off, ``dist`` 1 and 2; the loss over five AdamW
steps of the full-graph loop; AdamW itself; checkpoints read across; and
GCN, GIN and SAGE with ``topk`` (the hidden layer rides the top-k
compressed ring), whose inputs have no nonzero tie at the ``k`` boundary
(GCN's transform-first ``h W``, ReLU outputs whose ties are zeros: those
decompress alike and get no gradient past the ReLU).  The
reference runs jitted with ``use_kernel=False``, as its own CPU tests do;
every reference number comes from one dump that this file writes when it
runs as a script in a subprocess with four fake XLA devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/test_torch_train.py OUT.npz

Tolerances: logits and gradients rtol 2e-4 (the reference's own
fused-vs-unfused tolerance; fp32 sums in another order), the loss
trajectory rtol 1e-3, AdamW rtol 1e-6.  Inside the port, the same step
run twice gives bitwise-equal gradients.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

N, D, NCLS = 320, 12, 5
MODEL_KW = {"gcn": dict(hidden=8, num_layers=2),
            "gin": dict(hidden=8, num_layers=2),
            "sage": dict(hidden=8, num_layers=2),
            "gat": dict(hidden=4, num_layers=2, heads=2)}
# (model, shards, fused, interleave, dist): on 4 shards every model runs
# fused and unfused, and interleave/dist are crossed across the models
CASES = [(m, 1, f, True, 1) for m in MODEL_KW for f in (False, True)] + [
    ("gcn", 4, False, True, 1), ("gcn", 4, True, False, 2),
    ("gin", 4, False, False, 2), ("gin", 4, True, True, 1),
    ("sage", 4, False, True, 2), ("sage", 4, True, False, 1),
    ("gat", 4, False, True, 1), ("gat", 4, True, False, 1)]
# (model, shards, fused, interleave, dist, topk): layer 1 aggregates at
# width 5 (GCN, transform-first) or 8 (GIN, SAGE), so k = 3 bites
SPARSE_CASES = [("gcn", 4, False, True, 1, 3), ("gin", 4, True, False, 2, 3),
                ("sage", 4, False, True, 2, 3)]
PS = 4            # several partitions per row: the segments are exercised
TRAJ_STEPS = 5    # the full-graph loop: GCN, ps 16, dist 2, 4 shards


def _case_id(case):
    m, n, f, il, dist = case[:5]
    topk = f"-topk{case[5]}" if len(case) > 5 else ""
    return (f"{m}-{n}shard-{'fused' if f else 'unfused'}-il{int(il)}"
            f"-d{dist}{topk}")


def _graph(C):
    return C.power_law(N, avg_degree=7.0, locality=0.35, seed=11)


def _data(graph_features):
    return graph_features(N, D, NCLS, seed=0)


def _ocfg(AdamWConfig):
    return AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=TRAJ_STEPS,
                       weight_decay=0.0)


def _reference_dump():
    """Reference params, logits, gradients and loss trajectory."""
    import jax
    import jax.numpy as jnp
    import repro.core as C
    from repro.dist import flat_ring_mesh
    from repro.train.checkpoint import _flat_with_names
    from repro.train.data import graph_features
    from repro.train.optimizer import AdamWConfig, adamw_init, adamw_update

    g = _graph(C)
    x, y, train_mask = _data(graph_features)
    out = {}
    params = {}
    for m, kw in MODEL_KW.items():
        params[m] = C.MODEL_ZOO[m][0](jax.random.key(1), D, NCLS, **kw)
        for name, leaf in _flat_with_names(params[m]):
            out[f"p/{m}/{name}"] = np.asarray(leaf)

    def tables(eng):
        pad1 = lambda a: C.pad_table(eng.plan.bounds, eng.plan.rows_per_dev,
                                     a[:, None])[:, 0]
        return (eng.shard(eng.pad(x)), jnp.asarray(pad1(y)),
                jnp.asarray(pad1(train_mask.astype(np.float32))))

    for case in CASES + SPARSE_CASES:
        m, n_dev, fused, il, dist = case[:5]
        eng = C.GNNEngine.build(g, flat_ring_mesh(n_dev), ps=PS, dist=dist,
                                interleave=il, fuse_update=fused,
                                topk=case[5] if len(case) > 5 else None)
        apply = C.MODEL_ZOO[m][1]
        xp, yp, mp = tables(eng)

        @jax.jit
        def fwd_grad(p, apply=apply, eng=eng, xp=xp, yp=yp, mp=mp):
            def loss(p):
                logits = apply(p, eng, xp)
                return C.masked_cross_entropy(logits, yp, mp), logits
            return jax.value_and_grad(loss, has_aux=True)(p)

        (_, logits), grads = fwd_grad(params[m])
        key = _case_id(case)
        out[f"{key}/logits"] = np.asarray(logits)
        for name, leaf in _flat_with_names(grads):
            out[f"{key}/g/{name}"] = np.asarray(leaf)

    eng = C.GNNEngine.build(g, flat_ring_mesh(4), ps=16, dist=2)
    xp, yp, mp = tables(eng)
    ocfg = _ocfg(AdamWConfig)
    apply = C.MODEL_ZOO["gcn"][1]

    @jax.jit
    def step(p, opt):
        loss, grads = jax.value_and_grad(lambda p: C.masked_cross_entropy(
            apply(p, eng, xp), yp, mp))(p)
        p, opt, _ = adamw_update(grads, opt, p, ocfg)
        return p, opt, loss

    p, opt, losses = params["gcn"], adamw_init(params["gcn"]), []
    for _ in range(TRAJ_STEPS):
        p, opt, loss = step(p, opt)
        losses.append(float(loss))
    out["traj/losses"] = np.asarray(losses)
    return out


if __name__ == "__main__":
    np.savez(sys.argv[1], **_reference_dump())
    sys.exit(0)


import jax  # noqa: E402  (after the script entry: it sets no device count)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.train import checkpoint as rck  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402

import repro_torch.core as TC  # noqa: E402
from repro_torch.dist import VirtualRing  # noqa: E402
from repro_torch.train import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, graph_features, value_and_grad)
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train.tree import (tree_flatten_with_names,  # noqa: E402
                                    tree_unflatten)

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

CPU = "cpu"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "train4.npz"
    # the cheaper XLA passes cut the dump's compile time by a third
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    r = subprocess.run([sys.executable, __file__, str(path)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return dict(np.load(path))


def _port_params(ref, model):
    """The reference's weights in the port's tree (names checked)."""
    like = TC.MODEL_ZOO[model][0](torch.Generator().manual_seed(0), D, NCLS,
                                  **MODEL_KW[model])
    return tree_unflatten(like, [
        torch.from_numpy(ref[f"p/{model}/{name}"])
        for name, _ in tree_flatten_with_names(like)])


def _port_tables(eng):
    x, y, train_mask = _data(graph_features)
    pad1 = lambda a: TC.pad_table(eng.plan.bounds, eng.plan.rows_per_dev,
                                  a[:, None])[:, 0]
    return (eng.shard(eng.pad(x)), torch.from_numpy(pad1(y)),
            torch.from_numpy(pad1(train_mask.astype(np.float32))))


def _port_grads(case, params):
    m, n_dev, fused, il, dist = case[:5]
    eng = TC.GNNEngine.build(_graph(TC), VirtualRing(n_dev, CPU), ps=PS,
                             dist=dist, interleave=il, fuse_update=fused,
                             topk=case[5] if len(case) > 5 else None)
    apply = TC.MODEL_ZOO[m][1]
    xp, yp, mp = _port_tables(eng)
    logits = []

    def loss(p):
        logits.append(apply(p, eng, xp))
        return TC.masked_cross_entropy(logits[-1], yp, mp)

    _, grads = value_and_grad(loss, params)
    return logits[0].detach(), grads


@pytest.mark.parametrize("case", CASES + SPARSE_CASES, ids=_case_id)
def test_logits_and_gradients_match_reference(ref, case, request):
    """Every parameter gets a gradient through the ring, equal to the
    reference's (rtol 2e-4, atol 1e-6 for entries near zero).  The
    largest difference relative to each leaf's scale is recorded in the
    JUnit report (``grad_max_rel_diff``)."""
    key = _case_id(case)
    logits, grads = _port_grads(case, _port_params(ref, case[0]))
    np.testing.assert_allclose(logits.numpy(), ref[f"{key}/logits"],
                               rtol=2e-4, atol=1e-6)
    named = tree_flatten_with_names(grads)
    assert len(named) == sum(k.startswith(f"{key}/g/") for k in ref)
    worst = 0.0
    for name, gr in named:
        want = ref[f"{key}/g/{name}"]
        assert gr.shape == want.shape, name
        assert np.abs(want).max() > 0, name    # the ring carries gradient
        np.testing.assert_allclose(gr.numpy(), want, rtol=2e-4, atol=1e-6,
                                   err_msg=name)
        worst = max(worst, float(np.abs(gr.numpy() - want).max()
                                 / np.abs(want).max()))
    request.node.user_properties.append(("grad_max_rel_diff", worst))


def test_gat_fused_equals_unfused_bitwise(ref):
    params = _port_params(ref, "gat")
    a = _port_grads(("gat", 4, False, True, 2), params)
    b = _port_grads(("gat", 4, True, True, 2), params)
    assert torch.equal(a[0], b[0])
    for (_, ga), (_, gb) in zip(tree_flatten_with_names(a[1]),
                                tree_flatten_with_names(b[1])):
        assert torch.equal(ga, gb)


def test_same_step_twice_gives_bitwise_equal_gradients(ref):
    params = _port_params(ref, "gin")
    case = ("gin", 4, True, True, 2)
    _, first = _port_grads(case, params)
    _, again = _port_grads(case, params)
    for (name, a), (_, b) in zip(tree_flatten_with_names(first),
                                 tree_flatten_with_names(again)):
        assert torch.equal(a, b), name


def test_loss_trajectory_matches_reference(ref, request):
    """Five AdamW steps of the full-graph loop (GCN, ps 16, dist 2, four
    shards): the loss at every step within rtol 1e-3; the largest
    relative difference is recorded in the JUnit report."""
    eng = TC.GNNEngine.build(_graph(TC), VirtualRing(4, CPU), ps=16, dist=2)
    xp, yp, mp = _port_tables(eng)
    params = _port_params(ref, "gcn")
    opt, ocfg = adamw_init(params), _ocfg(AdamWConfig)
    losses = []
    for _ in range(TRAJ_STEPS):
        loss, grads = value_and_grad(lambda p: TC.masked_cross_entropy(
            TC.gcn_apply(p, eng, xp), yp, mp), params)
        params, opt, _ = adamw_update(grads, opt, params, ocfg)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["traj/losses"], rtol=1e-3)
    assert losses[-1] < losses[0]
    request.node.user_properties.append(("loss_max_rel_diff", float(np.max(
        np.abs(np.asarray(losses) - ref["traj/losses"])
        / np.abs(ref["traj/losses"])))))


def _tree_pair(seed):
    rng = np.random.default_rng(seed)
    tree = {"layers": [{"w": rng.normal(size=(6, 4)).astype(np.float32),
                        "b": rng.normal(size=4).astype(np.float32)},
                       {"eps": np.float32(0.3),
                        "w": rng.normal(size=(4, 3)).astype(np.float32)}]}
    to_j = lambda t: jax.tree.map(jnp.asarray, t)
    return tree, to_j(tree), TC.params_from_numpy(tree, CPU)


def test_adamw_update_matches_reference_with_clipping():
    """Three steps with large gradients (clipping active), decay on the
    matrices only, warmup then cosine: params and moments rtol 1e-6."""
    _, params_j, params_t = _tree_pair(0)
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=0.5, warmup_steps=2,
              total_steps=5)
    rcfg, tcfg = ropt.AdamWConfig(**kw), AdamWConfig(**kw)
    opt_j, opt_t = ropt.adamw_init(params_j), adamw_init(params_t)
    for step in range(3):
        grads, grads_j, grads_t = _tree_pair(10 + step)
        grads_j = jax.tree.map(lambda a: a * 50.0, grads_j)
        grads_t = TC.params_from_numpy(
            jax.tree.map(lambda a: a * np.float32(50.0), grads), CPU)
        params_j, opt_j, mj = ropt.adamw_update(grads_j, opt_j, params_j,
                                                rcfg)
        params_t, opt_t, mt = adamw_update(grads_t, opt_t, params_t, tcfg)
        assert float(mj["grad_norm"]) > rcfg.clip_norm
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
        assert int(opt_t["count"]) == int(opt_j["count"]) == step + 1
        for tree_t, tree_j in ((params_t, params_j), (opt_t["m"], opt_j["m"]),
                               (opt_t["v"], opt_j["v"])):
            for (name, a), b in zip(tree_flatten_with_names(tree_t),
                                    jax.tree.leaves(tree_j)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=name)


def test_port_checkpoint_is_read_by_reference_restore(tmp_path):
    tree, tree_j, tree_t = _tree_pair(3)
    state = dict(params=tree_t, opt=adamw_init(tree_t))
    for step in (50, 100, 150, 200):
        tck.save(str(tmp_path), step, state)
    assert tck.latest_step(str(tmp_path)) == rck.latest_step(
        str(tmp_path)) == 200
    assert sorted(os.listdir(tmp_path)) == [
        f"step-{s:09d}" for s in (100, 150, 200)]     # keep=3
    target = dict(params=tree_j, opt=ropt.adamw_init(tree_j))
    back = dict(rck._flat_with_names(rck.restore(str(tmp_path), 200,
                                                 target)))
    named = tree_flatten_with_names(state)
    assert sorted(back) == sorted(name for name, _ in named)
    for name, a in named:
        b = np.asarray(back[name])
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    again = tck.restore(str(tmp_path), 200, state)
    for (name, a), (_, b) in zip(tree_flatten_with_names(state),
                                 tree_flatten_with_names(again)):
        assert torch.equal(a, b), name


def test_reference_checkpoint_is_read_by_port_restore(tmp_path):
    tree, tree_j, tree_t = _tree_pair(4)
    rck.save(str(tmp_path), 7, dict(params=tree_j))
    back = tck.restore(str(tmp_path), 7, dict(params=tree_t))
    for (name, a), (_, b) in zip(
            tree_flatten_with_names(back),
            tree_flatten_with_names(dict(params=tree_t))):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_launcher_trains_on_cpu(tmp_path, model):
    from repro_torch.launch import train_gnn
    rep = train_gnn.main(["--device", "cpu", "--model", model, "--scale",
                          "0.05", "--steps", "3", "--devices", "4",
                          "--workdir", str(tmp_path),
                          "--metrics-json", str(tmp_path / "m.json")])
    assert rep["device"] == "cpu" and len(rep["losses"]) == 3
    assert np.isfinite(rep["losses"]).all() and 0 <= rep["test_acc"] <= 1
    assert (tmp_path / "m.json").exists()
