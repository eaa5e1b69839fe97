"""repro_torch's top-k compressed ring against the JAX reference, and its
bitwise invariants inside the port.

Against the reference, on the same numpy inputs: top-k compression and
its inverse, the wire's id dtype (the int16/int32 boundary), the plain
sparse gather-sum (K6's plain version) against ``sparse_gather_sum_call``
in interpret mode and against the reference's oracle, its backward
against ``jax.vjp`` of ``ops.sparse_neighbor_gather_sum``.  The sparse
ring on one and four shards and GCN/GIN/SAGE logits and gradients with
``topk`` are held against the reference in ``test_torch_serve.py`` and
``test_torch_train.py``, beside their reference dumps, so this file starts
no XLA subprocess.

``lax.top_k`` and ``torch.topk`` may choose other columns among tied
values, so the comparisons use continuous random data (no ties) and hold
decompressed tensors, not ids.  Inside the port the oracle is the port's
own decompress-then-dense path: bitwise at ``k == D`` and at ``k < D``.

Tolerances: kernels and the ring rtol 1e-5 (fp32 sums in another order;
the Pallas kernel decompresses through a one-hot matmul).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as RC
from repro.kernels import ops as rops
from repro.kernels import ref as rref

import repro_torch.core as TC
from repro_torch.dist import VirtualRing
from repro_torch.kernels import neighbor_agg, ops
from repro_torch.serve import (GNNServeEngine, TrafficPhase, ZipfTraffic,
                               run_trace)
from repro_torch.train import value_and_grad
from repro_torch.train.tree import tree_leaves

CPU = "cpu"


def _rows(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _sparse_inputs(t, d, k, p, ps, seed):
    """Compressed rows (the top k of random rows, by numpy) and a
    partition table with all-masked partitions and a hub row."""
    rng = np.random.default_rng(seed)
    x = _rows(t, d, seed)
    i = np.argsort(-x, axis=1, kind="stable")[:, :k].astype(np.int32)
    nbrs = rng.integers(0, t, (p, ps)).astype(np.int32)
    nbrs[: p // 3, 0] = 1
    mask = rng.random((p, ps)) < 0.7
    mask[1::5] = False
    return np.take_along_axis(x, i, axis=1), i, nbrs, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _reference_topk(x, k):
    """The reference's (values, ids) and their decompression through the
    wire's id dtype, in one jitted call."""
    d = x.shape[1]

    @jax.jit
    def run(xx):
        v, i = RC.topk_activation(xx, k)
        return v, i, RC.topk_decompress(v, i.astype(RC.wire_index_dtype(d)),
                                        d)

    return run(jnp.asarray(x))


@pytest.mark.parametrize("d,k", [(1, 1), (16, 4), (23, 23), (130, 32)])
def test_topk_and_decompress_match_reference(d, k):
    x = _rows(40, d, d + k)
    vj, ij, want = _reference_topk(x, k)
    vt, it = TC.topk_activation(torch.from_numpy(x), k)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    got = TC.topk_decompress(vt, it.to(TC.wire_index_dtype(d)), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if k == d:                       # an exact inverse at full width
        np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("d", [32767, 32768])
def test_wire_index_dtype_boundary_on_one_row(d):
    """int16 ids up to 32767 columns, int32 above; one row at each width
    round-trips through the wire dtype in both packages."""
    assert np.dtype(RC.wire_index_dtype(d)).itemsize == \
        torch.empty((), dtype=TC.wire_index_dtype(d)).itemsize == \
        (2 if d <= 32767 else 4)
    x = _rows(1, d, 0)
    x[0, -1] = 100.0                 # the last column survives
    _, _, want = _reference_topk(x, 8)
    vt, it = TC.topk_activation(torch.from_numpy(x), 8)
    got = TC.topk_decompress(vt, it.to(TC.wire_index_dtype(d)), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, -1] == 100.0


def test_collective_bytes_match_reference():
    g = TC.power_law(200, avg_degree=6.0, locality=0.3, seed=1)
    for n_dev in (1, 4):
        tp = TC.build_plan(g, n_dev, ps=8, dist=2)
        rp = RC.build_plan(RC.power_law(200, avg_degree=6.0, locality=0.3,
                                        seed=1), n_dev, ps=8, dist=2)
        assert TC.collective_bytes(tp, 96) == RC.collective_bytes(rp, 96)
        for d, k in ((96, 24), (96, 200), (40000, 10)):
            assert TC.sparse_collective_bytes(tp, d, k) == \
                RC.sparse_collective_bytes(rp, d, k)
    tp = TC.build_plan(g, 8, ps=8, dist=2)
    assert TC.sparse_collective_bytes(tp, 96, 24) / \
        TC.collective_bytes(tp, 96) == 0.375


# (T, D, k, P, ps): a quarter of the width, k == D, and k == 1 at a width
# of two lane blocks
KERNEL_CASES = [(30, 16, 4, 12, 4), (20, 23, 23, 7, 3), (25, 130, 1, 5, 2)]


@functools.lru_cache(maxsize=None)
def _reference_op(case):
    """Inputs, the reference's oracle, and its op in interpret mode: the
    forward and ``jax.vjp`` (d values) from one trace per case."""
    t, d, k, p, ps = case
    v, i, nbrs, mask = _sparse_inputs(t, d, k, p, ps, seed=d + k)
    g = _rows(p, d, 9)

    @jax.jit     # an eager interpret-mode kernel dispatches op by op
    def run(vv, ii, nb, mk, gg):
        oracle = rref.neighbor_gather_sum_ref(RC.topk_decompress(vv, ii, d),
                                              nb, mk)
        out, vjp = jax.vjp(lambda w: rops.sparse_neighbor_gather_sum(
            w, ii.astype(jnp.int16), nb, mk, d_feat=d, interpret=True), vv)
        return oracle, out, vjp(gg)[0]

    oracle, out, dval = (np.asarray(a) for a in run(*map(
        jnp.asarray, (v, i, nbrs, mask, g))))
    return (v, i.astype(np.int16), nbrs, mask, g), oracle, out, dval


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_plain_sparse_gather_sum_matches_pallas_interpret_and_oracle(case):
    (v, i, nbrs, mask, _), oracle, kernel, _ = _reference_op(case)
    got = ops.sparse_neighbor_gather_sum(*_t(v, i, nbrs, mask),
                                         d_feat=case[1]).numpy()
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
    assert not got[1::5].any()                 # all-masked partitions


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_sparse_gather_sum_backward_matches_reference_vjp(case):
    """d(values) through the autograd Function (K4's plain version, then a
    column gather) equals ``jax.vjp`` of the reference op; the ids get no
    gradient."""
    (v, i, nbrs, mask, g), _, _, want = _reference_op(case)
    tv, ti, tn, tm = _t(v, i, nbrs, mask)
    tv.requires_grad_(True)
    out = ops.sparse_neighbor_gather_sum(
        tv, ti, tn, tm, d_feat=case[1],
        grad_index=ops.GradIndex.build(nbrs, mask))
    (got,) = torch.autograd.grad(out, tv, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_sparse_gather_sum_grad_zeroes_the_tile_it_is_given():
    """The ring's backward hands the shared helper one tile gradient for
    every step: a dirty tile gives the bits of a fresh one, and a group
    with no masked slot gives zeros."""
    (v, i, nbrs, mask, g), _, _, _ = _reference_op(KERNEL_CASES[0])
    ti, tg = torch.from_numpy(i), torch.from_numpy(g)
    index = ops.GradIndex.build(nbrs, mask)
    fresh = ops.sparse_gather_sum_grad(tg, ti, index)
    dirty = torch.full((v.shape[0], g.shape[1]), 7.0)
    assert torch.equal(ops.sparse_gather_sum_grad(tg, ti, index, out=dirty),
                       fresh)
    empty = ops.GradIndex.build(nbrs, np.zeros_like(mask))
    assert not ops.sparse_gather_sum_grad(tg, ti, empty, out=dirty).any()


def test_sparse_kernel_refuses_cpu_tensors_and_counts_nothing_there():
    neighbor_agg.reset_launch_counts()
    v, i, nbrs, mask = _t(*_sparse_inputs(10, 8, 2, 4, 3, seed=0))
    ops.sparse_neighbor_gather_sum(v, i.to(torch.int16), nbrs, mask,
                                   d_feat=8)
    assert neighbor_agg.launch_counts()["sparse_gather_sum"] == 0
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu"):
        neighbor_agg.sparse_gather_sum(v, i, nbrs, mask, 8)
    with pytest.raises(ValueError, match="needs its grad_index"):
        ops.sparse_neighbor_gather_sum(v.requires_grad_(True), i, nbrs, mask,
                                       d_feat=8)


def _graph(C):
    return C.power_law(360, avg_degree=7.0, locality=0.35, seed=11)


# (shards, ps, dist, interleave): the ring's schedules, n_dev == 1 included
RINGS = [(1, 4, 1, True), (4, 4, 1, True), (4, 8, 2, False), (3, 2, 3, True)]


@pytest.mark.parametrize("n_dev,ps,dist,interleave", RINGS)
def test_sparse_ring_is_bitwise_dense_ring_of_decompressed_input(
        n_dev, ps, dist, interleave):
    """k == D: bitwise the dense ring on x, fused and unfused; k < D:
    bitwise the dense ring on decompress(compress(x)); and the backward,
    k-wide on the ring, equals autograd through torch.topk, a scatter and
    the dense ring (rtol 1e-5); two runs bitwise equal."""
    plan = TC.build_plan(_graph(TC), n_dev, ps=ps, dist=dist)
    ring = VirtualRing(n_dev, CPU)
    x = torch.from_numpy(TC.pad_embeddings(plan, _rows(360, 13, 1)))
    w = torch.from_numpy(_rows(13, 5, 2))
    gout = torch.from_numpy(_rows(x.shape[0], 5, 4))
    kw = dict(interleave=interleave)
    for upd in (None, w):
        assert torch.equal(
            TC.mgg_aggregate_sparse(x, plan, ring, k=13, update_w=upd, **kw),
            TC.mgg_aggregate(x, plan, ring, update_w=upd, **kw))
        v, i = TC.topk_activation(x, 4)
        xd = TC.topk_decompress(v, i, 13)
        assert torch.equal(
            TC.mgg_aggregate_sparse(x, plan, ring, k=4, update_w=upd, **kw),
            TC.mgg_aggregate(xd, plan, ring, update_w=upd, **kw))

    def grads(sparse):
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if sparse:
            out = TC.mgg_aggregate_sparse(xg, plan, ring, k=4, update_w=wg,
                                          **kw)
        else:
            vv, ii = torch.topk(xg, 4, dim=1)
            out = TC.mgg_aggregate(torch.zeros_like(xg).scatter(1, ii, vv),
                                   plan, ring, update_w=wg, **kw)
        return torch.autograd.grad((out * gout).sum(), [xg, wg])

    got, again, want = grads(True), grads(True), grads(False)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["gcn", "gin", "sage"])
def test_topk_engine_is_dense_at_full_k_and_repeatable(model):
    """An engine with ``topk`` compresses the hidden layers only (layer 0
    stays dense): at k == D its logits are bitwise the dense engine's; at
    k < D they differ, and two runs give bitwise-equal gradients."""
    g = _graph(TC)
    x = _rows(360, 12, 0)
    init, apply, _ = TC.MODEL_ZOO[model]
    params = init(torch.Generator().manual_seed(0), 12, 5, hidden=8,
                  num_layers=3)
    dense = TC.GNNEngine.build(g, VirtualRing(4, CPU), ps=4, dist=2)
    xp = dense.shard(dense.pad(x))
    full = TC.GNNEngine.build(g, VirtualRing(4, CPU), ps=4, dist=2, topk=8)
    assert full.stage_topk(0) is None and full.stage_topk(1) == 8
    with torch.no_grad():
        assert torch.equal(apply(params, full, xp), apply(params, dense, xp))
    eng = TC.GNNEngine.build(g, VirtualRing(4, CPU), ps=4, dist=2, topk=3)
    loss = lambda p: apply(p, eng, xp).square().mean()
    _, got = value_and_grad(loss, params)
    _, again = value_and_grad(loss, params)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(again)))
    with torch.no_grad():
        assert not torch.equal(apply(params, eng, xp),
                               apply(params, dense, xp))


def test_sparse_served_logits_bitwise_match_offline():
    """GCN 3 × 16 with ``topk=4`` (layer 1 at width 16, layer 2 at 5):
    full and cached passes serve the offline forward's bits."""
    g = TC.power_law(600, avg_degree=7.0, locality=0.3, seed=2)
    x = _rows(600, 12, 0)
    eng = TC.GNNEngine.build(g, VirtualRing(4, CPU), ps=8, dist=1, topk=4)
    params = TC.gcn_init(torch.Generator().manual_seed(0), 12, 5, hidden=16,
                         num_layers=3)
    srv = GNNServeEngine(eng, params, "gcn", x, g, slots=4)
    results = run_trace(srv, ZipfTraffic(g.num_nodes, 12, [
        TrafficPhase(requests=20, alpha=1.2, seeds_max=3)], seed=7))
    assert any(r.cached for r in results) and not all(r.cached
                                                      for r in results)
    with torch.inference_mode():
        offline = TC.unpad_embeddings(eng.plan, TC.gcn_apply(
            params, eng, srv.xp).numpy())
    for r in results:
        np.testing.assert_array_equal(r.logits, offline[r.seeds])
