"""repro_torch on the card: the CUDA kernels against their plain versions,
the ring on the card against the ring on the CPU, and served == offline.

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
from repro_torch.kernels import neighbor_agg, ops, ref
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
