"""repro_torch on the card: the CUDA kernels against their plain versions,
the ring (forward and backward) on the card against the ring on the CPU,
sampled GraphSAGE's gradients on the card against the CPU's, and served ==
offline.

These tests need an NVIDIA card and nvcc (a CUDA kernel has no CPU mode);
without them they skip.  On the card, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it also runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as TC
from repro_torch.dist import VirtualRing
from repro_torch.kernels import neighbor_agg, ops, ref, rows
from repro_torch.sample import block_tree, sample_blocks
from repro_torch.train import value_and_grad
from repro_torch.train.tree import tree_leaves, tree_map
from repro_torch.serve import GNNServeEngine, TrafficPhase, ZipfTraffic, \
    run_trace

pytestmark = pytest.mark.cuda

SHAPES = [(5, 1, 1), (32, 8, 16), (7, 4, 100), (9, 16, 130), (3, 2, 602),
          (1001, 8, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(p, ps, d, device, t=400, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
            .to(device),
            torch.from_numpy(rng.integers(0, t, (p, ps)).astype(np.int32))
            .to(device),
            torch.from_numpy(rng.random((p, ps)) < 0.7).to(device))


@pytest.mark.parametrize("p,ps,d", SHAPES)
@pytest.mark.parametrize("pb", [None, 1, 4, 8])
def test_gather_sum_matches_plain(cuda, p, ps, d, pb):
    buf, nbrs, mask = _inputs(p, ps, d, cuda, seed=d)
    want = ref.neighbor_gather_sum_ref(buf, nbrs, mask)
    got = ops.neighbor_gather_sum(buf, nbrs, mask, pb=pb)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ops.neighbor_gather_sum(buf, nbrs, mask, pb=pb))


def test_segment_add_matches_sequential_loop(cuda):
    rng = np.random.default_rng(5)
    tgt = np.concatenate([np.sort(rng.integers(0, 50, 400)),
                          np.zeros(7, np.int64)])
    partial = rng.normal(size=(tgt.size, 16)).astype(np.float32)
    want = np.zeros((50, 16), np.float32)
    for i in range(tgt.size):
        want[tgt[i]] += partial[i]
    grp = TC.WorkGroup.build(np.zeros((tgt.size, 1)),
                             np.ones((tgt.size, 1), bool), tgt, cuda)
    got = torch.zeros(50, 16, device=cuda)
    before = neighbor_agg.segment_add_ordered.launches
    ops.segment_add_ordered(got, torch.from_numpy(partial).to(cuda),
                            grp.order, grp.seg_rows, grp.seg_start)
    assert neighbor_agg.segment_add_ordered.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("ps,dist,interleave,fused",
                         [(4, 1, True, False), (8, 2, False, False),
                          (8, 1, True, True), (1, 3, False, True)])
def test_ring_on_card_matches_cpu_ring(cuda, ps, dist, interleave, fused):
    g = TC.power_law(360, avg_degree=7.0, locality=0.35, seed=11)
    x = np.random.default_rng(3).normal(size=(g.num_nodes, 23)).astype(
        np.float32)
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(23, 9))
                         .astype(np.float32)) if fused else None
    plan = TC.build_plan(g, 4, ps=ps, dist=dist)
    xp = torch.from_numpy(TC.pad_embeddings(plan, x))
    want = TC.mgg_aggregate(xp, plan, VirtualRing(4, "cpu"),
                            interleave=interleave, update_w=w)
    got = TC.mgg_aggregate(xp.to(cuda), plan, VirtualRing(4, cuda),
                           interleave=interleave,
                           update_w=None if w is None else w.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_served_logits_bitwise_match_offline_on_card(cuda):
    g = TC.power_law(2000, avg_degree=8.0, locality=0.3, seed=2)
    x = np.random.default_rng(0).normal(size=(g.num_nodes, 32)).astype(
        np.float32)
    eng = TC.GNNEngine.build(g, VirtualRing(4, cuda), ps=8, dist=1)
    params = TC.gcn_init(torch.Generator().manual_seed(0), 32, 7,
                         device=cuda)
    srv = GNNServeEngine(eng, params, "gcn", x, g, slots=4)
    results = run_trace(srv, ZipfTraffic(g.num_nodes, 32, [
        TrafficPhase(requests=30, alpha=1.2, seeds_max=3)], seed=7))
    assert any(r.cached for r in results)
    with torch.inference_mode():
        offline = TC.unpad_embeddings(eng.plan, TC.gcn_apply(
            params, eng, srv.xp).cpu().numpy())
    for r in results:
        np.testing.assert_array_equal(r.logits, offline[r.seeds])


@pytest.mark.parametrize("p,ps,d", SHAPES)
def test_scatter_sum_matches_plain_and_is_deterministic(cuda, p, ps, d):
    """Includes a hub row named by more than GRAD_CHUNK slots at P=1001
    (the two-pass path) and short segments elsewhere (one pass)."""
    rng = np.random.default_rng(p + d)
    nbrs = rng.integers(0, 400, (p, ps))
    nbrs[: p // 2, 0] = 3                            # a hub row
    mask = rng.random((p, ps)) < 0.7
    tgt = rng.integers(0, 60, p)
    idx = ops.GradIndex.build(nbrs, mask, tgt, cuda)
    assert (idx.chunk_start is not None) == (p == 1001)
    g = torch.from_numpy(rng.normal(size=(60, d)).astype(np.float32)).to(
        cuda)
    base = torch.from_numpy(rng.normal(size=(400, d)).astype(np.float32))
    args = (g, idx)
    want = ref.scatter_sum_ordered_ref(base.to(cuda), *args)
    before = neighbor_agg.scatter_sum_ordered.launches
    got = ops.scatter_sum_ordered(base.to(cuda), *args)
    assert neighbor_agg.scatter_sum_ordered.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ops.scatter_sum_ordered(base.to(cuda), *args))


@pytest.mark.parametrize("b,t,d", [(1, 1, 1), (37, 10, 16), (5000, 3000, 100),
                                   (999, 64, 130)])
def test_gather_rows_bitwise_equals_plain(cuda, b, t, d):
    rng = np.random.default_rng(b)
    src = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32)).to(
        cuda)
    ids = rng.integers(0, t, b)
    ids[::5] = -1                                    # zero rows
    idx = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    before = rows.gather_rows.launches
    got = ops.gather_rows(src, idx)
    assert rows.gather_rows.launches == before + 1
    assert torch.equal(got, ref.gather_rows_ref(src, idx))


@pytest.mark.parametrize("model,fused,interleave,dist",
                         [("gcn", False, True, 2), ("gcn", True, False, 1),
                          ("gin", True, True, 2), ("gat", False, False, 1)])
def test_ring_gradients_on_card_match_cpu(cuda, model, fused, interleave,
                                          dist):
    """Gradients through the ring on the card (K1, K3, K4 and the reverse
    rotations on the side stream) equal the CPU's (rtol 1e-4), and two
    runs on the card are bitwise equal."""
    g = TC.power_law(2000, avg_degree=8.0, locality=0.3, seed=2)
    x = np.random.default_rng(0).normal(size=(g.num_nodes, 24)).astype(
        np.float32)
    y = np.random.default_rng(1).integers(0, 5, g.num_nodes)
    init, apply, _ = TC.MODEL_ZOO[model]
    kw = dict(heads=2) if model == "gat" else {}
    params = init(torch.Generator().manual_seed(0), 24, 5, hidden=8,
                  num_layers=2, **kw)

    def run(device):
        eng = TC.GNNEngine.build(g, VirtualRing(4, device), ps=4, dist=dist,
                                 interleave=interleave, fuse_update=fused)
        xp = eng.shard(eng.pad(x))
        yp = torch.from_numpy(TC.pad_table(eng.plan.bounds,
                                           eng.plan.rows_per_dev,
                                           y[:, None])[:, 0]).to(device)
        p = tree_map(lambda t: t.to(device), params)
        mask = torch.ones(xp.shape[0], device=device)
        return value_and_grad(lambda q: TC.masked_cross_entropy(
            apply(q, eng, xp), yp, mask), p)[1]

    want = run("cpu")
    got, again = run(cuda), run(cuda)
    for a, b, c in zip(tree_leaves(got), tree_leaves(again),
                       tree_leaves(want)):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4,
                                   atol=1e-4 * c.abs().max().item())


def test_sampled_sage_gradients_on_card_match_cpu(cuda):
    g = TC.power_law(3000, avg_degree=8.0, locality=0.3, seed=4)
    x = np.random.default_rng(0).normal(size=(g.num_nodes, 20)).astype(
        np.float32)
    seeds = np.arange(0, 300, 3)
    blocks = sample_blocks(g, seeds, [6, 4], batch=128,
                           rng=np.random.default_rng(1))
    ids = blocks[0].src_ids
    h0 = np.where((ids >= 0)[:, None], x[np.maximum(ids, 0)], 0.0).astype(
        np.float32)
    params = TC.sage_init(torch.Generator().manual_seed(0), 20, 4, hidden=8)

    def run(device):
        p = tree_map(lambda t: t.to(device), params)
        h = torch.from_numpy(h0).to(device)
        bt = block_tree(blocks, device)
        return value_and_grad(lambda q: TC.apply_blocks(
            "sage", q, h, bt).square().mean(), p)[1]

    want = run("cpu")
    got, again = run(cuda), run(cuda)
    for a, b, c in zip(tree_leaves(got), tree_leaves(again),
                       tree_leaves(want)):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4,
                                   atol=1e-4 * c.abs().max().item())
