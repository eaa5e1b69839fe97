"""repro_torch on the card: the CUDA kernels against their plain versions,
the ring (forward and backward, dense and top-k compressed) on the card
against the ring on the CPU, sampled GraphSAGE's gradients on the card
against the CPU's, served == offline, the streamed ring over a tiered
store (bitwise across capacities, its fetches never waiting for the
card) and tiered serving == resident serving, a serving cluster of one
== the bare engine, the bulk and fetch baselines' K1/K3/K5 launches ==
their plain versions, the hardware probes, and the LM's flash attention
(K7) and its cache-less forward on the card against the CPU, and the
sLSTM scan's save (K8) and backward (K9) against their plain versions,
with K9's bitwise invariants and the xlstm's training on the card; the
moe and hybrid smoke models' forwards (K7) and prefill + decode on the
card against the CPU, the moe dispatch's backward and a moe loss's
gradients bitwise across runs, and the hybrid's training on the card;
K7 at whisper's encoder shape, and the smoke whisper's flag-on forward
and its loss and gradients on the card against the CPU; the virtual
mesh's collectives on the card against the CPU, its rotations and
exchanges ordered after their producer and their buffers kept until the
side stream is done with them, and ring TP and the expert-parallel MoE
(forwards and gradients) on the card against the CPU; and the dry-run
counter: a smoke model's flops counted on meta equal to those counted live
on the card, each kernel's record equal to the count its bound used, and
a ring's rotations and kernel work on the card equal to the meta ring's
and the host plan's.

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
from repro_torch import configs as LMC
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels import neighbor_agg, ops, ref, rows
from repro_torch.kernels import slstm_scan as k8
from repro_torch.models import transformer as LMT
from repro_torch.sample import block_tree, sample_blocks
from repro_torch.train import value_and_grad
from repro_torch.train.tree import tree_leaves, tree_map
from repro_torch.serve import GNNServeEngine, TrafficPhase, ZipfTraffic, \
    run_trace
from repro_torch.serve import LocalityRouter, ServeCluster

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

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


def _bits(t):
    return t.view(torch.int32)


def _k1_held_bitwise(buf, nbrs, mask):
    """K1 bitwise equal to K2 (``pb=4``) and to the plain version, one
    launch."""
    want = ref.neighbor_gather_sum_ref(buf, nbrs, mask)
    before = neighbor_agg.gather_sum_pipelined.launches
    got = neighbor_agg.gather_sum_pipelined(buf, nbrs, mask)
    assert neighbor_agg.gather_sum_pipelined.launches == before + 1
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(
        neighbor_agg.gather_sum_blocked(buf, nbrs, mask, pb=4)))
    return got


@pytest.mark.parametrize("d", [1, 13, 16, 96, 100, 130])
@pytest.mark.parametrize("ps", [1, 8, 16, 40])
def test_gather_sum_pipelined_bitwise_equals_blocked_and_plain(cuda, d, ps):
    """K1's slots added in order from +0, masked ones skipped: the bits of
    K2 and of the plain version, over one and several register batches of
    slots, V = 4 and V = 1 columns, one and several column chunks, and
    all-masked partitions (every fifth)."""
    buf, nbrs, mask = _inputs(1001, ps, d, cuda, seed=d * 41 + ps)
    mask[1::5] = False
    got = _k1_held_bitwise(buf, nbrs, mask)
    assert not got[1::5].any()


@pytest.mark.parametrize("d", [1, 16, 100, 130])
@pytest.mark.parametrize("pb", [1, 4, 32])
@pytest.mark.parametrize("ps", [1, 8, 40, 100])
def test_gather_sum_blocked_bitwise_equals_pipelined_and_plain(cuda, d, pb,
                                                               ps):
    """K2's warp keeps a batch of 8 of its partition's slots in flight,
    a lane a column, and adds them in slot order from +0, masked slots
    skipped: the bits of K1 and of the plain version, at P = 1001 (not a
    multiple of pb), with every fifth partition all masked; ps = 40 and
    100 take several batches, D = 100 and 130 several column chunks."""
    buf, nbrs, mask = _inputs(1001, ps, d, cuda, seed=d * 7 + ps + pb)
    mask[1::5] = False
    want = ref.neighbor_gather_sum_ref(buf, nbrs, mask)
    before = neighbor_agg.gather_sum_blocked.launches
    got = neighbor_agg.gather_sum_blocked(buf, nbrs, mask, pb=pb)
    assert neighbor_agg.gather_sum_blocked.launches == before + 1
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(
        neighbor_agg.gather_sum_pipelined(buf, nbrs, mask)))
    assert not got[1::5].any()


def test_gather_sum_blocked_at_the_largest_block_that_fits(cuda):
    """pb = 32 partitions of ps = 192 slots fill the 48 KB of index that
    ``blocked_fits`` allows (24 batches of slots a partition); then
    300,000 partitions at pb = 4, 75,000 blocks."""
    assert neighbor_agg.blocked_fits(32, 192)
    assert not neighbor_agg.blocked_fits(32, 193)
    buf, nbrs, mask = _inputs(20_000, 192, 16, cuda, t=5000, seed=4)
    mask[1::5] = False
    want = ref.neighbor_gather_sum_ref(buf, nbrs, mask)
    got = neighbor_agg.gather_sum_blocked(buf, nbrs, mask, pb=32)
    assert torch.equal(_bits(got), _bits(want))
    buf, nbrs, mask = _inputs(300_000, 8, 16, cuda, t=50_000, seed=5)
    got = neighbor_agg.gather_sum_blocked(buf, nbrs, mask, pb=4)
    assert torch.equal(_bits(got), _bits(
        neighbor_agg.gather_sum_pipelined(buf, nbrs, mask)))


def test_gather_sum_pipelined_walks_many_partitions(cuda):
    """300,000 partitions at D = 16: more than one grid of K1 holds, so
    every warp walks several."""
    buf, nbrs, mask = _inputs(300_000, 8, 16, cuda, t=50_000, seed=3)
    mask[1::5] = False
    _k1_held_bitwise(buf, nbrs, mask)


def test_gather_sum_pipelined_reads_an_unaligned_buffer(cuda):
    """A ``buf`` whose base is 4 bytes past a 16-byte boundary (a view one
    element into its storage) takes the one-column-a-thread path."""
    base, nbrs, mask = _inputs(5000, 8, 16, cuda, seed=9)
    flat = torch.empty(base.numel() + 1, device=cuda)
    buf = flat[1:].view_as(base)
    buf.copy_(base)
    assert buf.data_ptr() % 16 == 4 and buf.is_contiguous()
    got = _k1_held_bitwise(buf, nbrs, mask)
    assert torch.equal(got, neighbor_agg.gather_sum_pipelined(base, nbrs,
                                                              mask))


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


@pytest.mark.parametrize("d", [16, 96])
def test_segment_add_hub_chunks_bitwise_equal_plain(cuda, d):
    """K3's two passes over a 10,000-partial hub, mixed with short
    segments and a segment of exactly the chunk length: bitwise the plain
    version's, one launch."""
    rng = np.random.default_rng(d)
    tgt = np.concatenate([np.full(10_000, 3), np.full(ops.SEG_CHUNK, 5),
                          rng.integers(6, 3000, 20_000)])
    rng.shuffle(tgt)
    grp = TC.WorkGroup.build(np.zeros((tgt.size, 1)),
                             np.ones((tgt.size, 1), bool), tgt, cuda)
    assert grp.chunks is not None and grp.chunks.hubs.numel() == 1
    partial = torch.from_numpy(rng.normal(size=(tgt.size, d)).astype(
        np.float32)).to(cuda)
    out0 = torch.from_numpy(rng.normal(size=(3000, d)).astype(
        np.float32)).to(cuda)
    segs = (grp.order, grp.seg_rows, grp.seg_start, grp.chunks)
    want = ref.segment_add_ordered_ref(out0.clone(), partial, *segs)
    before = neighbor_agg.segment_add_ordered.launches
    got = ops.segment_add_ordered(out0.clone(), partial, *segs)
    assert neighbor_agg.segment_add_ordered.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, ops.segment_add_ordered(out0.clone(), partial,
                                                    *segs))


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
    """K4 runs K3's pair on the transposed index: bitwise its plain
    version, one launch.  At P=1001 a hub row named by more slots than
    the index's chunk length takes the two passes (chunk sums, then the
    sums in order), short rows one."""
    rng = np.random.default_rng(p + d)
    nbrs = rng.integers(0, 400, (p, ps))
    nbrs[: p // 2, 0] = 3                            # a hub row
    mask = rng.random((p, ps)) < 0.7
    tgt = rng.integers(0, 60, p)
    idx = ops.GradIndex.build(nbrs, mask, tgt, cuda)
    assert (idx.chunks is not None) == (p == 1001)
    if idx.chunks is not None:
        lens = (idx.start[1:] - idx.start[:-1]).cpu()
        assert int(lens.max()) > idx.chunks.chunk
    g = torch.from_numpy(rng.normal(size=(60, d)).astype(np.float32)).to(
        cuda)
    base = torch.from_numpy(rng.normal(size=(400, d)).astype(np.float32))
    args = (g, idx)
    want = ref.scatter_sum_ordered_ref(base.to(cuda), *args)
    before = neighbor_agg.scatter_sum_ordered.launches
    got = ops.scatter_sum_ordered(base.to(cuda), *args)
    assert neighbor_agg.scatter_sum_ordered.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, ops.scatter_sum_ordered(base.to(cuda), *args))


# K5's edge shapes: rows given as a count or as a place in its plan's
# schedule ("chunk" rows cover one chunk of UNROLL x THREADS vectors; "turns"
# rows make the grid-stride loop turn more than 4 times); the ids of a case:
# "sentinels" (random, repeated, -1, T and 2^31 - 1 among them), "equal"
# (all one id), "offset" (src 4 bytes off 16: the word path),
# "wrap" (B * D past 2^31 floats: rows near the end checked against src)
K5_D = (1, 3, 4, 100, 128, 130, 257)
K5_CASES = [(1, 1, 1, "sentinels"), (37, 10, 16, "sentinels"),
            (5000, 3000, 100, "sentinels"), (999, 64, 130, "sentinels"),
            *[(b, 500, d, "sentinels") for d in K5_D
              for b in (1, "chunk-1", "chunk", "chunk+1", "turns")],
            ("chunk+1", 500, 4, "equal"), (5000, 3000, 100, "equal"),
            ("chunk+1", 500, 4, "offset"), (5000, 3000, 100, "offset"),
            ("chunk+1", 500, 128, "offset"),
            (22_000_000, 1000, 100, "wrap")]


def _k5_rows(b, d, width, device):
    """Rows of a K5 case: ``b`` itself, or its place in the plan."""
    if isinstance(b, int):
        return b
    vpr = d // width
    chunk = -(-rows.UNROLL * rows.THREADS // vpr)     # rows a chunk
    if b == "turns":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        grid = sms * rows.blocks_per_sm(device.index or 0, width)
        return 5 * grid * rows.UNROLL * rows.THREADS // vpr + 3
    return chunk + {"chunk-1": -1, "chunk": 0, "chunk+1": 1}[b]


@pytest.mark.parametrize("b,t,d,case", K5_CASES)
def test_gather_rows_bitwise_equals_plain(cuda, b, t, d, case):
    """K5: one launch, bitwise its plain version and bitwise across two
    calls, over its plan's edge shapes (K5_CASES)."""
    width = 4 if d % 4 == 0 and case != "offset" else 1
    b = _k5_rows(b, d, width, cuda)
    rng = np.random.default_rng(b + d)
    src = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32)).to(
        cuda)
    ids = rng.integers(0, t, b)
    if case == "equal":
        ids[:] = t // 2
    else:
        ids[::5] = -1                                # zero rows
        ids[1::7] = t
        ids[2::11] = 2 ** 31 - 1
        ids[3::13] = ids[0]                          # repeated rows
    idx = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    if case == "offset":                             # 4 bytes off 16
        flat = torch.empty(t * d + 1, dtype=torch.float32, device=cuda)
        src = flat[1:].view(t, d).copy_(src)
        assert src.data_ptr() % 16 == 4
    before = rows.gather_rows.launches
    got = rows.gather_rows(src, idx)
    assert rows.gather_rows.launches == before + 1
    if case == "wrap":                               # 8.8 GB of output
        assert b * d > 2 ** 31
        for lo in (0, b // 2, b - 1000):
            sl = slice(lo, lo + 1000)
            want = ref.gather_rows_ref(src, idx[sl])
            assert torch.equal(got[sl], want), f"rows {lo}.. differ"
        return
    assert torch.equal(got, ref.gather_rows_ref(src, idx))
    first = got.clone()
    assert torch.equal(first, rows.gather_rows(src, idx))


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


def _sparse_case(rng, t, d, k, p, ps, id_dtype, device):
    """Top-k pairs of ``t`` random rows; partitions with a hub row (a third
    of them name row 5 in every slot) and all-masked partitions."""
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32)).to(
        device)
    values, idx = TC.topk_activation(x, k)
    nbrs = rng.integers(0, t, (p, ps))
    nbrs[: p // 3] = 5
    mask = rng.random((p, ps)) < 0.7
    mask[1::7] = False
    return (values, idx.to(id_dtype),
            torch.from_numpy(nbrs.astype(np.int32)).to(device),
            torch.from_numpy(mask).to(device))


@pytest.mark.parametrize("id_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("d", [1, 13, 96, 130, 256, 600])
@pytest.mark.parametrize("kind", ["one", "quarter", "all"])
def test_sparse_gather_sum_bitwise_equals_plain(cuda, id_dtype, d, kind):
    """K6 against decompress-then-gather-sum, bitwise (compared as int32
    words), at k = 1, D/4 and D: every register-batch path of the kernel
    (k <= 32, 64, 128 and wider), widths that are no multiple of 32."""
    k = {"one": 1, "quarter": max(1, d // 4), "all": d}[kind]
    rng = np.random.default_rng(d * 7 + k)
    values, idx, nbrs, mask = _sparse_case(rng, 400, d, k, 1001, 8,
                                           id_dtype, cuda)
    want = ref.sparse_gather_sum_ref(values, idx, nbrs, mask, d)
    before = neighbor_agg.sparse_gather_sum.launches
    got = ops.sparse_neighbor_gather_sum(values, idx, nbrs, mask, d_feat=d)
    assert neighbor_agg.sparse_gather_sum.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, ops.sparse_neighbor_gather_sum(
        values, idx, nbrs, mask, d_feat=d))
    assert not got[1::7].any()                  # all-masked partitions


@pytest.mark.parametrize("id_dtype", [torch.int16, torch.int32])
def test_sparse_gather_sum_at_many_partitions_of_40_slots(cuda, id_dtype):
    """300,000 partitions of 40 slots at the fig9e width (D = 96, k = 24):
    one partition a warp, in two windows of 32 slots."""
    rng = np.random.default_rng(40)
    values, idx, nbrs, mask = _sparse_case(rng, 50_000, 96, 24, 300_000,
                                           40, id_dtype, cuda)
    want = ref.sparse_gather_sum_ref(values, idx, nbrs, mask, 96)
    got = ops.sparse_neighbor_gather_sum(values, idx, nbrs, mask, d_feat=96)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("id_dtype,d", [(torch.int16, 20000),
                                        (torch.int32, 40000)])
def test_sparse_gather_sum_wide_rows_use_dynamic_shared_memory(cuda,
                                                               id_dtype, d):
    """An accumulator over 48 KB (one partition a block, the opt-in)."""
    rng = np.random.default_rng(d)
    values, idx, nbrs, mask = _sparse_case(rng, 20, d, d // 4, 37, 4,
                                           id_dtype, cuda)
    want = ref.sparse_gather_sum_ref(values, idx, nbrs, mask, d)
    got = ops.sparse_neighbor_gather_sum(values, idx, nbrs, mask, d_feat=d)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("ps,dist,interleave,fused",
                         [(4, 1, True, False), (8, 2, False, True)])
def test_sparse_ring_on_card_matches_cpu_and_dense_at_full_k(
        cuda, ps, dist, interleave, fused):
    g = TC.power_law(360, avg_degree=7.0, locality=0.35, seed=11)
    x = np.random.default_rng(3).normal(size=(g.num_nodes, 23)).astype(
        np.float32)
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(23, 9))
                         .astype(np.float32)) if fused else None
    plan = TC.build_plan(g, 4, ps=ps, dist=dist)
    xp = torch.from_numpy(TC.pad_embeddings(plan, x))
    kw = dict(interleave=interleave)
    want = TC.mgg_aggregate_sparse(xp, plan, VirtualRing(4, "cpu"), k=6,
                                   update_w=w, **kw)
    ring, xc = VirtualRing(4, cuda), xp.to(cuda)
    wc = None if w is None else w.to(cuda)
    got = TC.mgg_aggregate_sparse(xc, plan, ring, k=6, update_w=wc, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(
        TC.mgg_aggregate_sparse(xc, plan, ring, k=23, update_w=wc, **kw),
        TC.mgg_aggregate(xc, plan, ring, update_w=wc, **kw))


@pytest.mark.parametrize("model,fused", [("gcn", False), ("gin", True),
                                         ("sage", False)])
def test_sparse_ring_gradients_on_card_match_cpu(cuda, model, fused):
    """Top-k hidden layers: gradients on the card (K6 forward, K4 and the
    k-wide reverse rotations backward) equal the CPU's (rtol 1e-4), and
    two runs on the card are bitwise equal."""
    g = TC.power_law(2000, avg_degree=8.0, locality=0.3, seed=2)
    x = np.random.default_rng(0).normal(size=(g.num_nodes, 24)).astype(
        np.float32)
    y = np.random.default_rng(1).integers(0, 5, g.num_nodes)
    init, apply, _ = TC.MODEL_ZOO[model]
    params = init(torch.Generator().manual_seed(0), 24, 5, hidden=16,
                  num_layers=3)

    def run(device):
        eng = TC.GNNEngine.build(g, VirtualRing(4, device), ps=4, dist=2,
                                 fuse_update=fused, topk=4)
        xp = eng.shard(eng.pad(x))
        yp = torch.from_numpy(TC.pad_table(eng.plan.bounds,
                                           eng.plan.rows_per_dev,
                                           y[:, None])[:, 0]).to(device)
        p = tree_map(lambda t: t.to(device), params)
        mask = torch.ones(xp.shape[0], device=device)
        return value_and_grad(lambda q: TC.masked_cross_entropy(
            apply(q, eng, xp), yp, mask), p)[1]

    want = run("cpu")
    before = neighbor_agg.sparse_gather_sum.launches
    got = run(cuda)
    assert neighbor_agg.sparse_gather_sum.launches > before
    again = run(cuda)
    for a, b, c in zip(tree_leaves(got), tree_leaves(again),
                       tree_leaves(want)):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4,
                                   atol=1e-4 * c.abs().max().item())


def test_sparse_served_logits_bitwise_match_offline_on_card(cuda):
    g = TC.power_law(2000, avg_degree=8.0, locality=0.3, seed=2)
    x = np.random.default_rng(0).normal(size=(g.num_nodes, 32)).astype(
        np.float32)
    eng = TC.GNNEngine.build(g, VirtualRing(4, cuda), ps=8, dist=1, topk=4)
    params = TC.gcn_init(torch.Generator().manual_seed(0), 32, 7, hidden=16,
                         num_layers=3, device=cuda)
    srv = GNNServeEngine(eng, params, "gcn", x, g, slots=4)
    before = neighbor_agg.sparse_gather_sum.launches
    results = run_trace(srv, ZipfTraffic(g.num_nodes, 32, [
        TrafficPhase(requests=30, alpha=1.2, seeds_max=3)], seed=7))
    assert neighbor_agg.sparse_gather_sum.launches > before
    assert any(r.cached for r in results)
    with torch.inference_mode():
        offline = TC.unpad_embeddings(eng.plan, TC.gcn_apply(
            params, eng, srv.xp).cpu().numpy())
    for r in results:
        np.testing.assert_array_equal(r.logits, offline[r.seeds])


def _stream_case(device, n_dev=8, dist=2, pin=True):
    from repro_torch.store import FeatureStore, TieredFeatures
    g = TC.power_law(600, avg_degree=8.0, locality=0.4, seed=7)
    x = np.random.default_rng(7).normal(size=(g.num_nodes, 16)).astype(
        np.float32)
    plan = TC.build_plan(g, n_dev, ps=8, dist=dist)

    def tiers(cap):
        t = TieredFeatures(FeatureStore(x, pin=pin), plan, cap,
                           device=device)
        if cap:
            t.admit(np.argsort(-g.degrees)[:cap].tolist())
        return t

    return g, x, plan, tiers


@pytest.mark.parametrize("pin", [True, False])
def test_streamed_ring_on_card_bitwise_across_capacities(cuda, pin):
    """The streamed ring on the card: bitwise equal at capacities 0,
    N // 3 and N (K5 assembling every chunk), within 1e-5 of the resident
    ring and of the CPU's streamed ring; the top-k ring at k = D bitwise
    the dense one; ``padded_table`` bitwise the padded table."""
    g, x, plan, tiers = _stream_case(cuda, pin=pin)
    n = g.num_nodes
    ring = VirtualRing(8, cuda)
    padded = torch.from_numpy(TC.pad_embeddings(plan, x))
    resident = TC.mgg_aggregate(padded.to(cuda), plan, ring)
    cpu_plan_tiers = _stream_case("cpu")[3]
    want = TC.mgg_aggregate_streamed(cpu_plan_tiers(0).chunk_fetcher(), plan,
                                     VirtualRing(8, "cpu"))
    outs = []
    for cap in (0, n // 3, n):
        t = tiers(cap)
        before = rows.gather_rows.launches
        stats = {}
        got = TC.mgg_aggregate_streamed(t.chunk_fetcher(), plan, ring,
                                        stats=stats)
        assert rows.gather_rows.launches > before
        assert stats["prefetch_issued"] == 1
        outs.append(got)
        assert torch.equal(_bits(t.padded_table().cpu()), _bits(padded))
        assert torch.equal(_bits(TC.mgg_aggregate_sparse_streamed(
            t.chunk_fetcher(), plan, ring, k=16)), _bits(got))
    for o in outs[1:]:
        assert torch.equal(_bits(o), _bits(outs[0]))
    torch.testing.assert_close(outs[0], resident, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[0].cpu(), want, rtol=1e-5, atol=1e-5)


def test_streamed_fetch_never_waits_for_the_ring(cuda):
    """With the card held by a spin kernel enqueued first, every prefetch
    returns while the ring before it is still unfinished: no fetch (host
    gather, pinned upload on the copy stream, K5 assembly) waits for the
    device."""
    g, x, plan, tiers = _stream_case(cuda, n_dev=4, dist=3)
    t = tiers(g.num_nodes // 3)
    ring = VirtualRing(4, cuda)
    # the plan's arrays are uploaded once, as an engine holds them (their
    # upload waits for the card); the first call loads every kernel
    arrays = TC.plan_device_arrays(plan, interleave=False, device=cuda)
    want = TC.mgg_aggregate_streamed(t.chunk_fetcher(), plan, ring,
                                     arrays=arrays)
    torch.cuda.synchronize()
    stats = {}
    torch.cuda._sleep(1_000_000_000)
    got = TC.mgg_aggregate_streamed(t.chunk_fetcher(), plan, ring,
                                    arrays=arrays, stats=stats)
    assert stats == dict(prefetch_issued=2, prefetch_inflight=2)
    assert torch.equal(_bits(got), _bits(want))


def test_tiered_serving_bitwise_resident_serving_on_card(cuda):
    g = TC.power_law(2000, avg_degree=8.0, locality=0.3, seed=2)
    x = np.random.default_rng(0).normal(size=(g.num_nodes, 32)).astype(
        np.float32)
    params = TC.gcn_init(torch.Generator().manual_seed(0), 32, 7,
                         device=cuda)
    events = list(ZipfTraffic(g.num_nodes, 32, [
        TrafficPhase(requests=40, alpha=1.2, seeds_max=3, update_frac=0.1)],
        seed=7))
    served = []
    for cap in (None, g.num_nodes // 8):
        eng = TC.GNNEngine.build(g, VirtualRing(4, cuda), ps=8, dist=2)
        srv = GNNServeEngine(eng, params, "gcn", x, g, slots=4,
                             feature_capacity=cap)
        served.append(run_trace(srv, events))
    assert srv.xp is None and srv.report()["tiers"]["cache_rows_served"] > 0
    assert any(r.cached for r in served[1])
    for a, b in zip(*served):
        assert a.cached == b.cached
        np.testing.assert_array_equal(a.logits, b.logits)


def test_cluster_of_one_bitwise_bare_engine_on_card(cuda):
    """A cluster of one replica serves the bare engine's results bitwise
    (same ids, passes and logits, feature updates included), and a
    cluster of two serves each request of an update-free trace its
    replica's offline forward bitwise."""
    g = TC.power_law(2000, avg_degree=8.0, locality=0.3, seed=2)
    x = np.random.default_rng(0).normal(size=(g.num_nodes, 32)).astype(
        np.float32)
    params = TC.gcn_init(torch.Generator().manual_seed(0), 32, 7,
                         device=cuda)
    events = list(ZipfTraffic(g.num_nodes, 32, [
        TrafficPhase(requests=40, alpha=1.2, seeds_max=3, update_frac=0.1)],
        seed=7))

    def replica():
        eng = TC.GNNEngine.build(g, VirtualRing(4, cuda), ps=8, dist=1)
        return GNNServeEngine(eng, params, "gcn", x, g, slots=4)

    bare = run_trace(replica(), events)
    solo = ServeCluster([replica()], router=LocalityRouter())
    for a, b in zip(bare, solo.run_trace(events)):
        assert (a.request_id, a.cached) == (b.request_id, b.cached)
        np.testing.assert_array_equal(a.logits, b.logits)
    pair = [replica(), replica()]
    cluster = ServeCluster(pair, router=LocalityRouter())
    res = cluster.run_trace(ZipfTraffic(g.num_nodes, 32, [
        TrafficPhase(requests=40, alpha=1.2, seeds_max=3)], seed=8))
    assert len(res) == 40 and cluster.report()["dropped"] == 0
    assert {cluster.replica_of(r.request_id) for r in res} == {0, 1}
    with torch.inference_mode():
        offline = [TC.unpad_embeddings(r.eng.plan, TC.gcn_apply(
            params, r.eng, r.xp).cpu().numpy()) for r in pair]
    for r in res:
        np.testing.assert_array_equal(
            r.logits, offline[cluster.replica_of(r.request_id)][r.seeds])


@pytest.mark.parametrize("page", [None, 1, 16])
def test_baselines_bitwise_plain_on_card(cuda, page):
    """``bulk_aggregate`` (page None) and ``fetch_rows_aggregate`` on the
    card: every launch of K1, K3 (and K5) bitwise its plain version on
    each shard's group, the whole output bitwise the plain path's and
    within 1e-5 of the CPU's."""
    g = TC.power_law(3000, avg_degree=9.0, locality=0.3, seed=4)
    x = np.random.default_rng(4).normal(size=(g.num_nodes, 24)).astype(
        np.float32)
    nbrs, mask, tgt, rows_per = TC.build_bulk_plan(g, 4, 8)
    bounds = TC.edge_balanced_node_split(g.indptr, 4)
    xp = torch.from_numpy(TC.pad_table(bounds, rows_per, x))
    if page is None:
        groups = TC.pipeline.bulk_groups(nbrs, mask, tgt, cuda)
        run = lambda dev, gr, uk: TC.bulk_aggregate(
            xp.to(dev), nbrs, mask, tgt, rows_per, VirtualRing(4, dev),
            groups=gr, use_kernel=uk)
        bufs = [xp.to(cuda)] * 4
        grps = groups
    else:
        fp = TC.build_fetch_plan(g, 4, 8, page_rows=page)
        args = (fp["fetch_rows"], fp["nbrs"], fp["mask"], fp["targets"])
        groups = TC.pipeline.fetch_groups(*args, cuda)
        run = lambda dev, gr, uk: TC.fetch_rows_aggregate(
            xp.to(dev), *args, fp["rows_per_dev"], groups=gr,
            use_kernel=uk)
        bufs = []
        for ids, _ in groups:
            k5 = rows.gather_rows(xp.to(cuda), ids)
            assert torch.equal(k5, ref.gather_rows_ref(xp.to(cuda), ids))
            bufs.append(k5)
        grps = [grp for _, grp in groups]
    for buf, grp in zip(bufs, grps):
        k1 = neighbor_agg.gather_sum_pipelined(buf, grp.nbrs, grp.mask)
        assert torch.equal(_bits(k1), _bits(ref.neighbor_gather_sum_ref(
            buf, grp.nbrs, grp.mask)))
        segs = (grp.order, grp.seg_rows, grp.seg_start, grp.chunks)
        base = torch.zeros((rows_per, buf.shape[1]), device=cuda)
        assert torch.equal(
            _bits(ops.segment_add_ordered(base.clone(), k1, *segs)),
            _bits(ref.segment_add_ordered_ref(base.clone(), k1, *segs)))
    before = neighbor_agg.launch_counts()
    got = run(cuda, groups, True)
    after = neighbor_agg.launch_counts()
    assert after["gather_sum_pipelined"] - \
        before["gather_sum_pipelined"] == 4
    assert after["segment_add_ordered"] > before["segment_add_ordered"]
    assert torch.equal(_bits(got), _bits(run(cuda, groups, False)))
    torch.testing.assert_close(got.cpu(), run("cpu", None, True), rtol=1e-5,
                               atol=1e-5)


def test_probes_return_numbers_on_card(cuda):
    from repro_torch.core.autotune import H100_SXM
    from repro_torch.obs import calibrate as cal

    probes = cal.probe_hardware(VirtualRing(8, cuda))
    assert all(isinstance(v, float) and np.isfinite(v) and v > 0
               for v in probes.values()), probes
    spec = cal.spec_from_probes(H100_SXM, probes)
    assert spec.name == "h100_sxm+probed" and spec.link_bw == \
        probes["link_bw"]


# K7: (B, S, H, KV, hd, causal, window): GQA 1, 4 and 12; a window under
# the 64-key tile; S not a multiple of the tile; every head_dim K7 takes
FLASH_SHAPES = [(2, 64, 4, 4, 16, True, 0), (1, 200, 8, 2, 64, True, 0),
                (2, 77, 12, 1, 112, True, 0), (1, 300, 4, 1, 128, True, 16),
                (1, 130, 4, 2, 128, False, 0), (1, 129, 8, 2, 64, False, 5),
                (3, 1, 4, 4, 16, True, 0)]


def _bf16_held(got, want):
    """bf16 K7 against its plain version: rtol = atol 1e-2 elementwise, and
    each (b, s, h) row's rms difference within 2e-2 of the row's rms (on a
    long causal row a flat 1e-2 is a third of a typical output)."""
    g, w = got.float(), want.float()
    torch.testing.assert_close(g, w, rtol=1e-2, atol=1e-2)
    ratio = ((g - w).pow(2).mean(-1) / w.pow(2).mean(-1)).sqrt()
    assert ratio.max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", FLASH_SHAPES)
def test_flash_attention_matches_plain(cuda, b, s, h, kv, hd, causal, window,
                                       dtype):
    rng = np.random.default_rng(s * h + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(
        np.float32)).to(cuda, dtype) for n in (h, kv, kv))
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    before = k7.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert k7.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, s, h, hd)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        _bf16_held(got, want)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8])
def test_flash_attention_at_the_whisper_encoder_shape(cuda, b, dtype):
    """whisper-base's encoder: S 1500 (the last 64-key tile partial, read by
    every query row with causal off), H = KV = 8 (GQA group 1), hd 64;
    held to the plain version and bitwise across launches."""
    g = torch.Generator(device=cuda).manual_seed(b)
    q, k, v = (torch.randn((b, 1500, 8, 64), generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    want = ref.flash_attention(q, k, v, causal=False)
    got = ops.flash_attention(q, k, v, causal=False)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        _bf16_held(got, want)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=False))


def test_flash_attention_reads_strided_inputs(cuda):
    """q, k and v as slices of one packed projection (the model's layout
    before any copy): the kernel reads them through their strides."""
    rng = np.random.default_rng(9)
    b, s, h, kv, hd = 2, 100, 8, 2, 64
    qkv = torch.from_numpy(rng.normal(size=(b, s, h + 2 * kv, hd)).astype(
        np.float32)).to(cuda)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16_reads_packed_strided_inputs(cuda):
    """bf16 q, k and v as slices of one packed projection: TMA reads them
    through their strides, with no copy."""
    rng = np.random.default_rng(10)
    b, s, h, kv, hd = 2, 300, 8, 2, 128
    qkv = torch.from_numpy(rng.normal(size=(b, s, h + 2 * kv, hd)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True, window=100)
    want = ref.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True, window=100)
    _bf16_held(got, want)


@pytest.mark.parametrize("b,s,h,kv,hd,window", [(1, 4096, 32, 8, 128, 0),
                                                (2, 65, 4, 2, 112, 16),
                                                (1, 127, 6, 3, 112, 16)])
def test_flash_attention_bf16_at_the_lm_shapes_and_ragged_tails(
        cuda, b, s, h, kv, hd, window):
    """mistral-nemo's shapes at B = 1, and S one past a 64-key tile and
    one short of a 128-row q tile with a window, at the padded hd 112."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn((b, s, n, hd), generator=g, device=cuda)
               .to(torch.bfloat16) for n in (h, kv, kv))
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    _bf16_held(got, want)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True,
                                                window=window))


def test_flash_attention_bf16_refuses_what_tma_cannot_address(cuda):
    z = torch.zeros(1, 8, 2, 65, device=cuda, dtype=torch.bfloat16)
    q = z[..., 1:]                          # base off 16 bytes, hd 64
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, q, q)
    w = torch.zeros(1, 8, 3, 64, device=cuda, dtype=torch.bfloat16)
    packed = w.view(1, 8, 192)[:, :, 4:132].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(packed, packed, packed)
    x = torch.zeros(1, 8, 2, 68, device=cuda, dtype=torch.bfloat16)
    q = x[..., :64]                         # strides of 136 bytes
    with pytest.raises(ValueError, match="strides"):
        ops.flash_attention(q, q, q)


def test_flash_attention_refuses_a_tensor_that_needs_a_gradient(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        ops.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 8, 2, 24, device=cuda)
        ops.flash_attention(z, z, z)


def test_lm_forward_with_flash_on_card_matches_cpu(cuda):
    """The smoke mistral-nemo's cache-less forward, fp32, flag on: K7 on
    the card against the plain version on the CPU, one launch a layer."""
    import dataclasses
    cfg = dataclasses.replace(LMC.get_smoke_config("mistral-nemo-12b"),
                              compute_dtype="float32",
                              use_flash_attention=True)
    params = LMT.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 70)).astype(np.int32))
    want, _ = LMT.forward(params, cfg, toks)
    dev_params = tree_map(lambda t: t.to(cuda), params)
    before = k7.flash_attention.launches
    got, _ = LMT.forward(dev_params, cfg, toks.to(cuda))
    assert k7.flash_attention.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


# K8: (B, S, H, hd): one step, odd rows and steps; hd 1 (one unit: a
# cluster of one block), 3 (its last block short), 8, 16, 64 (a cluster of
# 4), 100 (of 8, not a multiple of it, the last warp of its last block with
# no unit), 192 and 256; B 9 at bt 8 (two row tiles); the decode shape
# (B 4, S 1)
SLSTM_SHAPES = [(1, 1, 1, 8), (3, 7, 2, 16), (8, 256, 4, 64),
                (2, 300, 4, 192), (9, 33, 1, 256), (2, 9, 2, 1),
                (2, 9, 3, 3), (3, 50, 2, 100), (4, 1, 4, 192)]


def _slstm_inputs(rng, b, s, h, hd, device):
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)
    shape = (b, h, hd)
    xp = t(rng.normal(size=(b, s, h * 4 * hd)))
    wr = t(rng.normal(size=(h, hd, 4 * hd)) * hd ** -0.5)
    st = dict(h=t(rng.normal(size=shape) * 0.5), c=t(rng.normal(size=shape)),
              n=t(rng.uniform(0.5, 2.0, shape)), m=t(rng.normal(size=shape)))
    return xp, wr, st


def _same(a, b):
    return torch.equal(a[0], b[0]) and all(torch.equal(a[1][k], b[1][k])
                                           for k in "hcnm")


@pytest.mark.parametrize("b,s,h,hd", SLSTM_SHAPES)
def test_slstm_scan_matches_plain(cuda, b, s, h, hd):
    xp, wr, st = _slstm_inputs(np.random.default_rng(s + hd), b, s, h, hd,
                               cuda)
    want_h, want_st = ref.slstm_scan_ref(xp, wr, st)
    before = k8.slstm_scan.launches
    got = ops.slstm_scan(xp, wr, st)
    assert k8.slstm_scan.launches == before + 1
    assert got[0].shape == (b, s, h, hd) and got[0].dtype == torch.float32
    torch.testing.assert_close(got[0], want_h, rtol=1e-4, atol=1e-4)
    for k in "hcnm":
        torch.testing.assert_close(got[1][k], want_st[k], rtol=1e-4,
                                   atol=1e-4)
    assert _same(got, ops.slstm_scan(xp, wr, st))        # two launches


@pytest.mark.parametrize("hd", [16, 100, 192, 256])
def test_slstm_scan_bitwise_invariants(cuda, hd):
    """A row's result does not depend on B, bt or the other rows; one
    launch over S equals two with the state carried."""
    b, s, h = 5, 40, 2
    xp, wr, st = _slstm_inputs(np.random.default_rng(hd), b, s, h, hd, cuda)
    whole = k8.slstm_scan(xp, wr, st)
    for bt in (1, 3, 8):
        assert _same(k8.slstm_scan(xp, wr, st, bt=bt), whole), bt
    for i in (0, 3):
        solo = k8.slstm_scan(xp[i:i + 1].contiguous(), wr,
                             {k: v[i:i + 1].contiguous()
                              for k, v in st.items()})
        assert _same(solo, (whole[0][i:i + 1],
                            {k: v[i:i + 1] for k, v in whole[1].items()}))
    for cut in (1, 17):
        h1, st1 = k8.slstm_scan(xp[:, :cut].contiguous(), wr, st)
        h2, st2 = k8.slstm_scan(xp[:, cut:].contiguous(), wr, st1)
        assert _same((torch.cat([h1, h2], dim=1), st2), whole), cut


@pytest.mark.parametrize("hd", [100, 192])
def test_slstm_scan_every_cluster_size_gives_the_same_bits(cuda, hd):
    """Each gate column's product runs in one block in a fixed order, so
    the result does not depend on the cluster size (at hd 100 a cluster of
    8 leaves its last block short)."""
    b, s, h = 3, 30, 2
    xp, wr, st = _slstm_inputs(np.random.default_rng(hd + 1), b, s, h, hd,
                               cuda)
    want = k8.slstm_scan(xp, wr, st)
    sizes = k8.cluster_sizes(hd, b)
    assert k8.plan(hd, b)[0] in sizes and len(sizes) >= 2
    for c in sizes:
        assert _same(k8._launch(xp, wr, st, b, c), want), c


def test_slstm_plan_is_the_kernels_layout(cuda):
    """The wrapper's shared memory a block is the kernel's own, for every
    shape and cluster size the kernel takes, and the kernel refuses the
    others (a block with no unit or more than MAX_UNITS; at these shapes
    the shared-memory limit excludes no size the units allow); the plan
    fits this card's opt-in limit."""
    from repro_torch.kernels import _build
    lib = _build.library("slstm_scan")
    optin = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    for hd in range(1, k8.MAX_HEAD_DIM + 1):
        for bt in range(1, k8.MAX_BT + 1):
            for c in k8.CLUSTER_SIZES:
                want = k8.smem_bytes(hd, bt, c) \
                    if c in k8.cluster_sizes(hd, bt) else -1
                assert lib.mgg_slstm_smem_bytes(hd, bt, c) == want, \
                    (hd, bt, c)
            assert k8.plan(hd, bt)[1] <= optin
    assert lib.mgg_slstm_smem_bytes(257, 1, 8) == -1
    assert lib.mgg_slstm_smem_bytes(8, 1, 3) == -1
    assert lib.mgg_slstm_smem_bytes(1, 1, 2) == -1     # an empty block
    assert lib.mgg_slstm_smem_bytes(49, 1, 8) == -1


def test_slstm_cluster_probe_carries_every_store(cuda):
    """The probe's exchange of h alone, by K8's st.async stores and
    mbarriers: after S steps every value is S, so no block read a buffer
    before its peers wrote it."""
    for b, s, h, hd, c in ((2, 64, 4, 192, 4), (2, 64, 4, 192, 8),
                           (9, 5, 1, 3, 2), (3, 1, 2, 100, 8),
                           (3, 300, 2, 100, 8), (2, 64, 2, 1, 1)):
        out = k8.cluster_probe(b, s, h, hd, min(b, 8), c, cuda)
        assert out.shape == (b, h, hd)
        assert bool((out == s).all()), (b, s, h, hd, c)


def test_slstm_scan_refuses_what_it_does_not_take(cuda):
    xp, wr, st = _slstm_inputs(np.random.default_rng(0), 1, 3, 1, 8, cuda)
    with pytest.raises(ValueError, match="forward only"):
        k8.slstm_scan(xp.clone().requires_grad_(True), wr, st)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k8.slstm_scan(xp.cpu(), wr.cpu(), {k: v.cpu() for k, v in st.items()})
    with pytest.raises(TypeError, match="float32"):
        k8.slstm_scan(xp.double(), wr, st)
    one = _slstm_inputs(np.random.default_rng(0), 2, 3, 1, 1, cuda)
    with pytest.raises(RuntimeError, match="a cluster of 2 blocks"):
        k8._launch(*one, 2, 2)          # its second block holds no unit
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 3, 4 * 260, device=cuda)
        k8.slstm_scan(z, torch.zeros(1, 260, 1040, device=cuda),
                      {k: torch.zeros(1, 1, 260, device=cuda)
                       for k in "hcnm"})


def _grads_close(got, want, what, rtol=1e-4):
    """K9 against its plain version: rtol 1e-4, atol 1e-4 × max |want|."""
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * want.abs().max().item(),
                               msg=what)


def _k9(xp, wr, st, dhs, dst, bt=k8.MAX_BT):
    _, _, saved = k8.slstm_scan(xp, wr, st, save=True)
    return k8.slstm_scan_backward(dhs, dst, wr, saved, st, bt=bt)


def _same_bwd(a, b):
    return torch.equal(a[0], b[0]) and all(torch.equal(a[1][k], b[1][k])
                                           for k in "hcnm")


@pytest.mark.parametrize("b,s,h,hd", SLSTM_SHAPES)
def test_slstm_save_leaves_k8_bitwise_and_holds_the_plain_states(
        cuda, b, s, h, hd):
    xp, wr, st = _slstm_inputs(np.random.default_rng(s + hd + 1), b, s, h,
                               hd, cuda)
    plain = k8.slstm_scan(xp, wr, st)
    hs, new, saved = k8.slstm_scan(xp, wr, st, save=True)
    assert _same(plain, (hs, new))
    want = ref.slstm_scan_save_ref(xp, wr, st)
    for k in "gcnm":
        torch.testing.assert_close(saved[k], want[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,s,h,hd", SLSTM_SHAPES)
def test_slstm_scan_backward_matches_plain(cuda, b, s, h, hd):
    rng = np.random.default_rng(s + hd + 2)
    xp, wr, st = _slstm_inputs(rng, b, s, h, hd, cuda)
    dhs = torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(
        np.float32)).to(cuda)
    dst = _slstm_inputs(rng, b, 1, h, hd, cuda)[2]
    want = ref.slstm_scan_grad_ref(xp, wr, st, dhs, dst)
    before = k8.slstm_scan_backward.launches
    x, w = xp.clone().requires_grad_(), wr.clone().requires_grad_()
    s0 = {k: v.clone().requires_grad_() for k, v in st.items()}
    hs, new = ops.slstm_scan(x, w, s0)
    got = torch.autograd.grad([hs] + [new[k] for k in "hcnm"],
                              [x, w] + [s0[k] for k in "hcnm"],
                              [dhs] + [dst[k] for k in "hcnm"])
    assert k8.slstm_scan_backward.launches == before + 1
    _grads_close(got[0], want[0], "dxp")
    _grads_close(got[1], want[1], "dwr")
    for i, k in enumerate("hcnm"):
        _grads_close(got[2 + i], want[2][k], f"d{k}0")


# K9's invariants at the plan (wr's rows in registers at every hd here)
# and at clusters whose blocks hold them in shared memory (hd 192 on 4
# blocks, hd 96 on 2: 384 threads a block)
@pytest.mark.parametrize("hd,cluster", [(16, None), (100, None), (192, None),
                                        (256, None), (192, 4), (96, 2)])
def test_slstm_scan_backward_bitwise_invariants(cuda, hd, cluster):
    """Two launches equal; a row's gradients do not depend on B, bt or the
    other rows; one launch over S equals the launch over the last steps
    then the one over the first with the gradients carried; every cluster
    size gives the same bits."""
    b, s, h = 5, 40, 2
    rng = np.random.default_rng(hd)
    xp, wr, st = _slstm_inputs(rng, b, s, h, hd, cuda)
    dhs = torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(
        np.float32)).to(cuda)
    dst = _slstm_inputs(rng, b, 1, h, hd, cuda)[2]
    _, _, saved = k8.slstm_scan(xp, wr, st, save=True)
    if cluster is None:
        k9 = k8.slstm_scan_backward
        assert k8.bwd_wr_in_registers(hd, k8.plan(hd, b, backward=True)[0])
    else:
        assert not k8.bwd_wr_in_registers(hd, cluster)

        def k9(*args, bt=k8.MAX_BT):
            return k8._launch_backward(*args, min(bt, args[0].shape[0]),
                                       cluster)
    whole = k9(dhs, dst, wr, saved, st)
    assert _same_bwd(whole, k9(dhs, dst, wr, saved, st))
    for bt in (1, 3, 8):
        assert _same_bwd(k9(dhs, dst, wr, saved, st, bt=bt), whole), bt
    for c in k8.cluster_sizes(hd, b, backward=True):
        assert _same_bwd(k8._launch_backward(dhs, dst, wr, saved, st, b, c),
                         whole), c
    for i in (0, 3):
        row = lambda d: {k: v[i:i + 1].contiguous()         # noqa: E731
                         for k, v in d.items()}
        solo = k9(dhs[i:i + 1].contiguous(), row(dst), wr, row(saved),
                  row(st))
        assert _same_bwd(solo, (whole[0][i:i + 1], row(whole[1])))
    for cut in (1, 17):
        part = lambda d, sl: {k: v[:, sl].contiguous()      # noqa: E731
                              for k, v in d.items()}
        mid = dict(c=saved["c"][:, cut - 1].contiguous(),
                   n=saved["n"][:, cut - 1].contiguous(),
                   m=saved["m"][:, cut - 1].contiguous())
        dx2, carried = k9(dhs[:, cut:].contiguous(), dst, wr,
                          part(saved, slice(cut, None)), mid)
        dx1, d0 = k9(dhs[:, :cut].contiguous(), carried, wr,
                     part(saved, slice(None, cut)), st)
        assert _same_bwd((torch.cat([dx1, dx2], dim=1), d0), whole), cut


# every padded hd K9 has an instance of (hdk 32, 64, ..., 256) at each
# bt instance it takes from 1, 2 and 8 rows
@pytest.mark.parametrize("bt", [1, 2, 8])
@pytest.mark.parametrize("hd", [8, 16, 64, 96, 128, 160, 192, 224, 256])
def test_slstm_backward_every_instance_matches_plain(cuda, hd, bt):
    """K9 at the plan, at each register instance (wr's rows in registers,
    one instance a padded hd) and bt instance, against
    ``ref.slstm_scan_grad_ref``: rtol 1e-4, atol 1e-4 × max |want|."""
    rng = np.random.default_rng(hd * 10 + bt)
    b, s, h = bt, 19, 2
    xp, wr, st = _slstm_inputs(rng, b, s, h, hd, cuda)
    dhs = torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(
        np.float32)).to(cuda)
    dst = _slstm_inputs(rng, b, 1, h, hd, cuda)[2]
    assert k8.bwd_wr_in_registers(hd, k8.plan(hd, bt, backward=True)[0])
    dxp, _, d0 = ref.slstm_scan_grad_ref(xp, wr, st, dhs, dst)
    got = _k9(xp, wr, st, dhs, dst, bt=bt)
    _grads_close(got[0], dxp, "dxp")
    for k in "hcnm":
        _grads_close(got[1][k], d0[k], f"d{k}0")


def test_slstm_backward_plan_is_the_kernels_layout(cuda):
    """K9's shared memory a block is the kernel's own (dg twice, wr's rows
    unless they are in registers, two mbarriers) for every shape and
    cluster size it takes, and it refuses the others; both placements of
    wr occur; the plan fits this card's opt-in limit."""
    from repro_torch.kernels import _build
    lib = _build.library("slstm_scan")
    optin = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    placed = set()
    for hd in range(1, k8.MAX_HEAD_DIM + 1):
        for bt in range(1, k8.MAX_BT + 1):
            for c in k8.CLUSTER_SIZES:
                want = k8.smem_bytes(hd, bt, c, backward=True) \
                    if c in k8.cluster_sizes(hd, bt, backward=True) else -1
                assert lib.mgg_slstm_bwd_smem_bytes(hd, bt, c) == want, \
                    (hd, bt, c)
                if want > 0:
                    placed.add(k8.bwd_wr_in_registers(hd, c))
            assert k8.plan(hd, bt, backward=True)[1] <= optin
    assert placed == {True, False}
    assert lib.mgg_slstm_bwd_smem_bytes(192, 8, 8) == 49_168
    assert lib.mgg_slstm_bwd_smem_bytes(257, 1, 8) == -1
    assert lib.mgg_slstm_bwd_smem_bytes(8, 1, 3) == -1
    assert lib.mgg_slstm_bwd_smem_bytes(1, 1, 2) == -1     # an empty block
    assert lib.mgg_slstm_bwd_smem_bytes(49, 1, 8) == -1


def test_slstm_bwd_cluster_probe_carries_every_store(cuda):
    """K9's exchange alone (a float4 a unit a row to every block, by
    st.async.v4 onto mbarriers, in K9's layout): after S steps every value
    is S, so no block read a buffer before its peers wrote it."""
    for b, s, h, hd, c in ((2, 64, 4, 192, 4), (2, 64, 4, 192, 8),
                           (9, 5, 1, 3, 2), (3, 1, 2, 100, 8),
                           (3, 300, 2, 100, 8), (2, 64, 2, 1, 1),
                           (8, 256, 4, 256, 8)):
        out = k8.cluster_probe(b, s, h, hd, min(b, 8), c, cuda,
                               backward=True)
        assert out.shape == (b, h, hd)
        assert bool((out == s).all()), (b, s, h, hd, c)


def test_slstm_function_gradcheck_and_card_gradients(cuda):
    """``_SLSTMScan``'s plain path passes gradcheck in fp64 on the card,
    and its kernel path (K8 with the save, K9, the dwr matmul) gives the
    plain path's fp32 gradients."""
    rng = np.random.default_rng(11)
    b, s, h, hd = 2, 5, 1, 3
    xp, wr, st = _slstm_inputs(rng, b, s, h, hd, cuda)
    args64 = [xp.double().requires_grad_(), wr.double().requires_grad_()] \
        + [st[k].double().requires_grad_() for k in "hcnm"]
    assert torch.autograd.gradcheck(
        lambda *a: ops._SLSTMScan.apply(*a, False), args64, eps=1e-6,
        atol=1e-6, rtol=1e-5)
    xp, wr, st = _slstm_inputs(rng, 3, 64, 2, 192, cuda)
    outs = []
    for use_kernel in (True, False):
        args = [xp.clone().requires_grad_(), wr.clone().requires_grad_()] \
            + [st[k].clone().requires_grad_() for k in "hcnm"]
        hs, *_ = ops._SLSTMScan.apply(*args, use_kernel)
        outs.append(torch.autograd.grad((hs * hs).sum(), args))
    for g, w in zip(*outs):
        _grads_close(g, w, "card against plain")


def test_xlstm_training_on_card_matches_cpu(cuda):
    """The smoke xlstm-125m's loss and gradients, fp32, remat on: K8 and
    K9 on the card (two K8 and one K9 launch an sLSTM layer) against the
    plain loop on the CPU; then the launcher's steps on the card."""
    import dataclasses
    from repro_torch.launch import train as ltrain
    from repro_torch.train import LMDataConfig, lm_batch, make_loss_fn
    from repro_torch.train.trainer import _grads_of
    cfg = dataclasses.replace(LMC.get_smoke_config("xlstm-125m"),
                              compute_dtype="float32", remat=True)
    params = LMT.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=40, global_batch=3, doc_len=16), 0).items()}
    loss_fn = make_loss_fn(cfg, LMT.DistCtx())
    want = _grads_of(loss_fn, params, batch)
    n_slstm = cfg.n_layers // 2
    k8.reset_launch_counts()
    got = _grads_of(loss_fn, tree_map(lambda t: t.to(cuda), params),
                    {k: v.to(cuda) for k, v in batch.items()})
    assert k8.launch_counts() == {"slstm_scan": 2 * n_slstm,
                                  "slstm_scan_backward": n_slstm}
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=2e-4, atol=2e-4)
    for g, w in zip(tree_leaves(got[2]), tree_leaves(want[2])):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4,
                                   atol=2e-4 * w.abs().max().item())
    k8.reset_launch_counts()
    out = ltrain.main(["--arch", "xlstm-125m", "--smoke", "--steps", "2",
                       "--seq", "32", "--batch", "2"])
    assert out["device"].startswith("cuda") and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert k8.launch_counts() == {"slstm_scan": 4 * n_slstm,
                                  "slstm_scan_backward": 2 * n_slstm}


def test_xlstm_forward_on_card_matches_cpu(cuda):
    """The smoke xlstm-125m's cache-less forward and a prefill + decode,
    fp32: K8 on the card against the plain loop on the CPU, one launch an
    sLSTM layer."""
    import dataclasses
    cfg = dataclasses.replace(LMC.get_smoke_config("xlstm-125m"),
                              compute_dtype="float32")
    params = LMT.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 70)).astype(np.int32))
    want, _ = LMT.forward(params, cfg, toks)
    dev_params = tree_map(lambda t: t.to(cuda), params)
    n_slstm = cfg.n_layers // 2
    before = k8.slstm_scan.launches
    got, _ = LMT.forward(dev_params, cfg, toks.to(cuda))
    assert k8.slstm_scan.launches == before + n_slstm
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    cache = LMT.init_cache(cfg, 2, 80, device=cuda)
    _, cache = LMT.prefill(dev_params, cfg, toks[:, :69].to(cuda), cache)
    step, _ = LMT.decode_step(dev_params, cfg, toks[:, 69].to(cuda),
                              torch.full((2,), 69, device=cuda), cache)
    assert k8.slstm_scan.launches == before + 3 * n_slstm
    torch.testing.assert_close(step.cpu(), want[:, 69], rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# the online tuner on the card
# ---------------------------------------------------------------------------

def test_profiler_on_card_times_are_finite_positive_and_memoized(cuda):
    from repro_torch.runtime import AggregateProfiler, ProfileConfig
    g = TC.power_law(3000, avg_degree=8.0, locality=0.3, seed=4)
    prof = AggregateProfiler(g, VirtualRing(4, cuda), 16, use_kernel=True,
                             profile=ProfileConfig(warmup=1, iters=3))
    assert prof.measuring
    before = neighbor_agg.gather_sum_blocked.launches
    for key in ((4, 1, 0), (8, 2, 4)):
        t = prof(*key)
        assert np.isfinite(t) and t > 0 and prof(*key) == t
    assert neighbor_agg.gather_sum_blocked.launches > before
    assert len(prof.observations()) == 2


@pytest.mark.parametrize("pb", [0, 1, 2, 4, 8, 16, 32, 64])
def test_smem_check_is_blocked_fits(cuda, pb):
    from repro_torch.runtime import make_smem_check
    check = make_smem_check()
    for ps in (1, 8, 16, 40, 100, 192, 384, 3072, 6144):
        assert check(ps, 1, pb) == (pb == 0 or neighbor_agg.blocked_fits(
            pb, ps))


def _gcn_tables(eng, x, y, mask, dev):
    pad1 = lambda a: TC.pad_table(eng.plan.bounds, eng.plan.rows_per_dev,
                                  a[:, None])[:, 0]
    return (eng.shard(eng.pad(x)), torch.from_numpy(pad1(y)).to(dev),
            torch.from_numpy(pad1(mask.astype(np.float32))).to(dev))


def test_dynamic_equals_static_bitwise_after_commit_on_card(cuda):
    """The tuner (kernels on, pb 0 = K1 and pb 4 = K2 in its space) moves
    and commits on a fake latency feed; from the commit step a static
    engine at the committed config gives the same losses and parameters,
    bit for bit, for 3 AdamW steps."""
    from repro_torch.runtime import DynamicGNNEngine, ProfileConfig
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features)
    g = TC.power_law(3000, avg_degree=8.0, locality=0.3, seed=4)
    ring = VirtualRing(4, cuda)
    x, y, mask = graph_features(g.num_nodes, 16, 5, seed=0)
    p = TC.gcn_init(torch.Generator().manual_seed(0), 16, 5, device=cuda)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=20,
                       weight_decay=0.0)
    dyn = DynamicGNNEngine.build(
        g, ring, d_feat=16, ps_space=(4, 8), dist_space=(1, 2),
        pb_space=(0, 4), window=ProfileConfig(warmup=0, iters=1))

    def step(eng, tables, p, opt):
        xp, yp, mp = tables
        loss, grads = value_and_grad(lambda q: TC.masked_cross_entropy(
            TC.gcn_apply(q, eng, xp), yp, mp), p)
        p, opt, _ = adamw_update(grads, opt, p, ocfg)
        return p, opt, loss

    fake = lambda c: 1.0 + abs(c["ps"] - 8) + 0.5 * (c["dist"] - 1) \
        + (0.1 if c["pb"] else 0.2)          # K2 "wins" on this surface
    opt, tables = adamw_init(p), _gcn_tables(dyn, x, y, mask, cuda)
    for _ in range(30):
        p, opt, _ = step(dyn, tables, p, opt)
        if dyn.observe_step(fake(dyn.config)):
            tables = _gcn_tables(dyn, x, y, mask, cuda)
        if dyn.committed:
            break
    assert dyn.committed and dyn.config == dict(ps=8, dist=1, pb=4)
    static = TC.GNNEngine.build(g, ring, ps=8, dist=1, pb=4)
    runs = []
    for eng in (dyn, static):
        q = tree_map(lambda t: t.clone(), p)
        o = tree_map(lambda t: t.clone(), opt)
        tb, losses = _gcn_tables(eng, x, y, mask, cuda), []
        k2 = neighbor_agg.gather_sum_blocked.launches
        for _ in range(3):
            q, o, loss = step(eng, tb, q, o)
            losses.append(loss)
        assert neighbor_agg.gather_sum_blocked.launches > k2
        runs.append((losses, q))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][1]),
                                                 tree_leaves(runs[1][1])))


def test_pb_only_move_keeps_the_logits_bitwise_on_card(cuda):
    """A move of pb alone (K1 → K2 at pb 4) keeps the plan's device arrays
    and the logits' bits: K2 adds in K1's order."""
    from repro_torch.runtime import DynamicGNNEngine, ProfileConfig
    g = TC.power_law(3000, avg_degree=8.0, locality=0.3, seed=4)
    x = np.random.default_rng(1).normal(size=(g.num_nodes, 16)).astype(
        np.float32)
    p = TC.gcn_init(torch.Generator().manual_seed(0), 16, 5, device=cuda)
    dyn = DynamicGNNEngine.build(
        g, VirtualRing(4, cuda), d_feat=16, ps_space=(8,), dist_space=(2,),
        pb_space=(0, 4), window=ProfileConfig(warmup=0, iters=1))
    assert dyn.config["pb"] == 0
    xp = dyn.shard(dyn.pad(x))
    arrays = dyn.ring_arrays[0]
    with torch.inference_mode():
        k1 = neighbor_agg.gather_sum_pipelined.launches
        a = TC.gcn_apply(p, dyn, xp)
        assert neighbor_agg.gather_sum_pipelined.launches > k1
        dyn.observe_step(2.0)                 # K1 measured slower: pb 4
        assert dyn.config["pb"] == 4 and dyn.ring_arrays[0] is arrays
        k2 = neighbor_agg.gather_sum_blocked.launches
        b = TC.gcn_apply(p, dyn, xp)
        assert neighbor_agg.gather_sum_blocked.launches > k2
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x7b",
                                  "zamba2-7b"])
def test_moe_and_hybrid_forward_on_card_matches_cpu(cuda, arch):
    """The smoke moe and hybrid models' cache-less forward, fp32, flag on:
    K7 on the card (one launch a moe layer, one a hybrid group) against
    the plain version on the CPU; then prefill + decode on the card
    against the CPU's forward (moe at no-drop capacity, whose routing does
    not depend on the tokens in a call)."""
    import dataclasses
    cfg = LMC.get_smoke_config(arch)
    kw = dict(compute_dtype="float32", use_flash_attention=True)
    if cfg.family == "moe":
        kw["moe_capacity_factor"] = float(cfg.n_experts)
    cfg = dataclasses.replace(cfg, **kw)
    params = LMT.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 24)).astype(np.int32))
    want, _ = LMT.forward(params, cfg, toks)
    dev_params = tree_map(lambda t: t.to(cuda), params)
    n_k7 = cfg.n_layers if cfg.family == "moe" \
        else cfg.n_layers // cfg.attn_every
    before = k7.flash_attention.launches
    got, _ = LMT.forward(dev_params, cfg, toks.to(cuda))
    assert k7.flash_attention.launches == before + n_k7
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    cache = LMT.init_cache(cfg, 2, 32, dtype=torch.float32, device=cuda)
    _, cache = LMT.prefill(dev_params, cfg, toks[:, :23].to(cuda), cache)
    step, _ = LMT.decode_step(dev_params, cfg, toks[:, 23].to(cuda),
                              torch.full((2,), 23, device=cuda), cache)
    torch.testing.assert_close(step.cpu(), want[:, 23], rtol=2e-3,
                               atol=2e-3)


def test_moe_dispatch_backward_bitwise_on_card(cuda):
    """The moe dispatch's backward (a gather summed over k in order) gives
    the same bits twice on the card and agrees with autograd of the plain
    gather (``index_add_``, atomics) within 1e-6; the smoke granite's loss
    and gradients (fp32, remat) are bitwise across two runs on the card
    and within 2e-4 of the CPU's."""
    import dataclasses
    from repro_torch.models import moe as LMM
    from repro_torch.train import LMDataConfig, lm_batch, make_loss_fn
    from repro_torch.train.trainer import _grads_of
    rng = np.random.default_rng(0)
    t, d, e, k, cap = 4096, 64, 8, 2, 900
    x2d = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32)).to(
        cuda)
    tope = torch.from_numpy(np.stack([rng.choice(e, k, replace=False)
                                      for _ in range(t)])).to(cuda)
    slot_token, slot_valid, pair_slot, pair_kept = LMM._dispatch_indices(
        tope, e, cap)
    pair_idx = tope * cap + pair_slot.clamp(0, cap - 1)
    g = torch.from_numpy(rng.normal(size=(e, cap, d)).astype(np.float32)).to(
        cuda)

    def grad(fn):
        xr = x2d.clone().requires_grad_(True)
        return torch.autograd.grad(fn(xr), xr, g)[0]

    ours = [grad(lambda xr: LMM._Dispatch.apply(
        xr, slot_token, slot_valid, pair_idx, pair_kept)) for _ in range(2)]
    plain = grad(lambda xr: torch.index_select(
        xr, 0, slot_token.reshape(-1)).reshape(e, cap, d)
        * slot_valid[..., None].float())
    assert torch.equal(ours[0], ours[1])
    torch.testing.assert_close(ours[0], plain, rtol=1e-6, atol=1e-6)

    cfg = dataclasses.replace(LMC.get_smoke_config("granite-moe-1b-a400m"),
                              compute_dtype="float32", remat=True)
    params = LMT.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k_: torch.from_numpy(v) for k_, v in lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=40, global_batch=3, doc_len=16), 0).items()}
    loss_fn = make_loss_fn(cfg, LMT.DistCtx())
    want = _grads_of(loss_fn, params, batch)
    dp = tree_map(lambda t_: t_.to(cuda), params)
    db = {k_: v.to(cuda) for k_, v in batch.items()}
    runs = [_grads_of(loss_fn, dp, db) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][2]), tree_leaves(runs[1][2])):
        assert torch.equal(a, b)
    torch.testing.assert_close(runs[0][0].cpu(), want[0], rtol=2e-4,
                               atol=2e-4)
    for a, w in zip(tree_leaves(runs[0][2]), tree_leaves(want[2])):
        torch.testing.assert_close(a.cpu(), w, rtol=2e-4,
                                   atol=2e-4 * w.abs().max().item())


def test_hybrid_training_on_card_matches_cpu(cuda):
    """The smoke zamba2's loss and gradients (fp32, remat, one chunk of
    40: the masked exp's gradient) on the card against the CPU, bitwise
    across two runs on the card; then the launcher's steps on the card."""
    import dataclasses
    from repro_torch.launch import train as ltrain
    from repro_torch.train import LMDataConfig, lm_batch, make_loss_fn
    from repro_torch.train.trainer import _grads_of
    cfg = dataclasses.replace(LMC.get_smoke_config("zamba2-7b"),
                              compute_dtype="float32", remat=True,
                              ssm_chunk=40)
    params = LMT.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=40, global_batch=3, doc_len=16), 0).items()}
    loss_fn = make_loss_fn(cfg, LMT.DistCtx())
    want = _grads_of(loss_fn, params, batch)
    dp = tree_map(lambda t: t.to(cuda), params)
    db = {k: v.to(cuda) for k, v in batch.items()}
    runs = [_grads_of(loss_fn, dp, db) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][2]), tree_leaves(runs[1][2])):
        assert torch.equal(a, b)
    torch.testing.assert_close(runs[0][0].cpu(), want[0], rtol=2e-4,
                               atol=2e-4)
    for g, w in zip(tree_leaves(runs[0][2]), tree_leaves(want[2])):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4,
                                   atol=2e-4 * w.abs().max().item())
    out = ltrain.main(["--arch", "zamba2-7b", "--smoke", "--steps", "2",
                       "--seq", "32", "--batch", "2"])
    assert out["device"].startswith("cuda") and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()


def _whisper(cuda, **kw):
    import dataclasses
    cfg = dataclasses.replace(LMC.get_smoke_config("whisper-base"),
                              compute_dtype="float32", **kw)
    from repro_torch.models import encdec
    params = encdec.init_params(torch.Generator().manual_seed(0), cfg,
                                vocab_multiple=4)
    rng = np.random.default_rng(0)
    batch = dict(frames=torch.from_numpy(rng.normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)),
        tokens=torch.from_numpy(rng.integers(1, cfg.vocab, (2, 24)).astype(
            np.int32)))
    return encdec, cfg, params, batch


def test_whisper_forward_with_flash_on_card_matches_cpu(cuda):
    """The smoke whisper's encoder and teacher-forced decoder, fp32, flag
    on: K7 on the card (causal off in each encoder layer, causal in each
    decoder self-attention) against the plain version on the CPU."""
    encdec, cfg, params, batch = _whisper(cuda, use_flash_attention=True)

    def forward(p, frames, toks):
        b, s = toks.shape
        t = frames.shape[1]
        ar = lambda n: torch.arange(n, dtype=torch.int32,
                                    device=toks.device).expand(b, n)
        with torch.no_grad():
            enc = encdec.encode(p, cfg, frames)
            return enc, encdec._decoder(p, cfg, toks, enc, ar(t),
                                        ctx=LMT.DistCtx(),
                                        positions=ar(s))[0]

    want = forward(params, batch["frames"], batch["tokens"])
    before = k7.flash_attention.launches
    got = forward(tree_map(lambda t: t.to(cuda), params),
                  batch["frames"].to(cuda), batch["tokens"].to(cuda))
    assert k7.flash_attention.launches == \
        before + cfg.n_enc_layers + cfg.n_layers
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4, atol=2e-4)


def test_whisper_loss_and_grads_on_card_match_cpu(cuda):
    """The smoke whisper's loss and gradients (fp32, remat, flag off) on
    the card against the CPU, bitwise across two runs on the card."""
    from repro_torch.train import make_loss_fn
    from repro_torch.train.trainer import _grads_of
    _, cfg, params, batch = _whisper(cuda, remat=True)
    loss_fn = make_loss_fn(cfg, LMT.DistCtx())
    want = _grads_of(loss_fn, params, batch)
    dp = tree_map(lambda t: t.to(cuda), params)
    db = {k: v.to(cuda) for k, v in batch.items()}
    runs = [_grads_of(loss_fn, dp, db) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][2]), tree_leaves(runs[1][2])):
        assert torch.equal(a, b)
    torch.testing.assert_close(runs[0][0].cpu(), want[0], rtol=2e-4,
                               atol=2e-4)
    for g, w in zip(tree_leaves(runs[0][2]), tree_leaves(want[2])):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4,
                                   atol=2e-4 * w.abs().max().item())


# ---------------------------------------------------------------------------
# the virtual mesh: collectives, ordering, ring TP and EP on the card

def _mesh_pair(cuda, shape=(2, 4), names=("data", "x")):
    from repro_torch.dist import VirtualMesh
    return VirtualMesh(shape, names, cuda), VirtualMesh(shape, names, "cpu")


def test_collectives_on_card_match_cpu(cuda):
    """The three collectives over a (2, 4) mesh on the card (copies on the
    side stream) against the same calls on the CPU, and the allgather's
    gradients (the backward's rotations on the side stream too)."""
    from repro_torch.dist import (matmul_reducescatter, pipelined_all_to_all,
                                  ring_allgather_matmul)
    dm, cm = _mesh_pair(cuda)
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(2, 4, 48, 64, generator=g), torch.randn(64, 40,
                                                               generator=g)
    want = ring_allgather_matmul(a, b, cm, "x")
    got = ring_allgather_matmul(a.to(cuda), b.to(cuda), dm, "x")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    lhs, rhs = torch.randn(2, 4, 50, 16, generator=g), torch.randn(
        2, 4, 16, 24, generator=g)
    want = matmul_reducescatter(lhs, rhs, cm, "x")
    got = matmul_reducescatter(lhs.to(cuda), rhs.to(cuda), dm, "x")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    z = torch.randn(2, 4, 32, 9, 3, generator=g)
    fn = lambda c: 2.0 * c + 1.0
    kw = dict(split_axis=0, concat_axis=1, chunk_axis=1, chunks=4)
    want = pipelined_all_to_all(z, cm, "x", fn, **kw)
    got = pipelined_all_to_all(z.to(cuda), dm, "x", fn, **kw)
    assert torch.equal(got.cpu(), want)
    grads = []
    for mesh, dev in ((cm, "cpu"), (dm, cuda)):
        x = a.to(dev).requires_grad_(True)
        w = b.to(dev).requires_grad_(True)
        out = ring_allgather_matmul(x, w, mesh, "x")
        grads.append(torch.autograd.grad(out.square().sum(), (x, w)))
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


def test_mesh_transfers_wait_for_their_producer(cuda):
    """A spin kernel holds the current stream, then writes the blocks: the
    rotation and the exchange on the side stream must still read what was
    written (they wait on the current stream).  Then the side stream is
    held and the source freed while its copy is queued: a tensor made in
    its place and written at once must not reach the copy (the buffers
    are recorded on the side stream)."""
    dm, _ = _mesh_pair(cuda)
    x = torch.zeros(2, 4, 256, 1024, device=cuda)
    want = torch.arange(8.0, device=cuda).reshape(2, 4, 1, 1).expand_as(x)
    torch.cuda._sleep(50_000_000)
    x.copy_(want)
    y, token = dm.permute(x, "x")
    z, t2 = dm.all_to_all(x, "x", 0, 1)
    dm.wait(token)
    dm.wait(t2)
    assert torch.equal(y.cpu(), torch.roll(want, 1, dims=1).cpu())
    assert torch.equal(z.cpu(), dm.all_to_all(want.contiguous(), "x", 0,
                                              1)[0].cpu())
    src = want.contiguous()
    with torch.cuda.stream(dm._ring._side):
        torch.cuda._sleep(50_000_000)
    y, token = dm.permute(src, "x")
    del src
    junk = torch.full((2, 4, 256, 1024), -1.0, device=cuda)
    dm.wait(token)
    assert torch.equal(y.cpu(), torch.roll(want, 1, dims=1).cpu())
    del junk


def test_ring_tp_and_ep_on_card_match_cpu(cuda):
    """The smoke codeqwen1.5-7b with ring TP over a (2, 2) mesh and the
    smoke granite-moe-1b-a400m with ring TP and EP over a (2, 4) mesh
    (pipeline chunks 2), fp32: the logits and the loss's gradients on the
    card against the same on the CPU (rtol 2e-4, atol 2e-4 × max|·|)."""
    import dataclasses
    from repro_torch.train import make_loss_fn
    from repro_torch.train.trainer import _grads_of
    for arch, shape in (("codeqwen1.5-7b", (2, 2)),
                        ("granite-moe-1b-a400m", (2, 4))):
        cfg = dataclasses.replace(LMC.get_smoke_config(arch),
                                  compute_dtype="float32", remat=False)
        params = LMT.init_params(torch.Generator().manual_seed(0), cfg)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            1, cfg.vocab, (4, 16)).astype(np.int32))
        dm, cm = _mesh_pair(cuda, shape, ("data", "model"))
        out = []
        for mesh, dev in ((cm, "cpu"), (dm, cuda)):
            ctx = LMT.DistCtx(mesh=mesh, use_ring_tp=True,
                              moe_pipeline_chunks=2)
            p = tree_map(lambda t: t.to(dev), params)
            batch = {"tokens": toks.to(dev)}
            logits, _ = LMT.forward(p, cfg, batch["tokens"], ctx=ctx)
            out.append((logits, _grads_of(make_loss_fn(cfg, ctx), p,
                                          batch)))
        (lw, (_, _, gw)), (lg, (_, _, gg)) = out
        torch.testing.assert_close(lg.cpu(), lw, rtol=2e-4, atol=2e-4)
        for g, w in zip(tree_leaves(gg), tree_leaves(gw)):
            torch.testing.assert_close(g.cpu(), w, rtol=2e-4,
                                       atol=2e-4 * w.abs().max().item())


# -- the dry-run counter (launch/op_cost.py, kernels/cost.py) on the card --

@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "granite-moe-1b-a400m",
                                  "zamba2-7b", "xlstm-125m",
                                  "whisper-base"])
def test_counted_flops_on_meta_equal_the_card(cuda, arch):
    """A smoke model's flag-on forward counted on meta (nothing allocated)
    and live on the card: the same dot flops, as integers, and the same
    K7/K8 records, whose work is a function of their shapes; for the
    xlstm, a training step too (K8 with its save, K9)."""
    import dataclasses
    from repro_torch.launch.op_cost import analyze
    from repro_torch.models import encdec
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    cfg = dataclasses.replace(LMC.get_smoke_config(arch),
                              compute_dtype="float32",
                              use_flash_attention=arch != "xlstm-125m")
    init = encdec.init_params if cfg.family == "encdec" \
        else LMT.init_params
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 32)).astype(np.int32))
    frames = torch.randn((2, 12, cfg.d_model))
    counts = {}
    for dev in (torch.device("meta"), cuda):
        # meta draws with a CPU generator: it allocates nothing
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        params = init(gen.manual_seed(0), cfg, device=dev)
        if cfg.family == "encdec":
            fwd = lambda: encdec.loss_fn(params, cfg, dict(
                frames=frames.to(dev), tokens=toks.to(dev)))
        else:
            fwd = lambda: LMT.forward(params, cfg, toks.to(dev))
        with torch.inference_mode():
            counts[dev.type] = [analyze(fwd)]
        if cfg.family == "xlstm":
            step = make_train_step(cfg, LMT.DistCtx(), AdamWConfig())
            counts[dev.type].append(analyze(step, params, adamw_init(params),
                                            dict(tokens=toks.to(dev))))
    for m, c in zip(counts["meta"], counts["cuda"]):
        assert m.dot_flops == c.dot_flops > 0
        assert m.kernels == c.kernels
    assert set(counts["cuda"][0].kernels) == (
        {"slstm_scan"} if cfg.family == "xlstm" else {"flash_attention"})


def test_kernel_records_are_the_inline_counts(cuda):
    """Each kernel launched on the card under a counter records the work
    ``chip_smoke.py`` computed inline for its bound: K1/K2 the distinct
    rows of its live slots, K3 its partials and segments, K4 its
    gradient's distinct rows, K5 its distinct ids, K6 its compressed
    rows, K7/K8/K9 their shapes."""
    from repro_torch.kernels import cost
    rng = np.random.default_rng(5)
    t, p, ps, d = 600, 500, 8, 16
    nbrs = rng.integers(0, t, (p, ps))
    mask = rng.random((p, ps)) < 0.7
    tgt = np.sort(rng.integers(0, 300, p))
    g = TC.WorkGroup.build(nbrs, mask, tgt, cuda)
    buf = torch.randn((t, d), device=cuda)
    distinct = int(g.grad.rows.numel())
    gather = distinct * d * 4 + p * ps * 5 + p * d * 4
    segs = int(g.seg_rows.numel())
    ix = g.grad
    src_rows = int(torch.unique(ix.src).numel())
    idx = torch.from_numpy(rng.integers(0, t, 77).astype(np.int32)).to(cuda)
    vals, ids = TC.topk_activation(buf, 4)
    ids = ids.to(torch.int16)
    q = torch.randn((2, 64, 4, 64), device=cuda, dtype=torch.bfloat16)
    kv = torch.randn((2, 64, 2, 64), device=cuda, dtype=torch.bfloat16)
    b, s, h, hd = 2, 9, 2, 16
    xp = torch.randn((b, s, h * 4 * hd), device=cuda)
    wr = torch.randn((h, hd, 4 * hd), device=cuda) * 0.1
    st = {k: torch.zeros((b, h, hd), device=cuda) for k in "hcnm"}
    with cost.counting() as c:
        part = neighbor_agg.gather_sum_pipelined(buf, g.nbrs, g.mask)
        neighbor_agg.gather_sum_blocked(buf, g.nbrs, g.mask, pb=4)
        neighbor_agg.segment_add_ordered(torch.zeros((300, d), device=cuda),
                                         part, g.order, g.seg_rows,
                                         g.seg_start, g.chunks)
        neighbor_agg.scatter_sum_ordered(torch.zeros((t, d), device=cuda),
                                         torch.randn((300, d), device=cuda),
                                         ix)
        rows.gather_rows(buf, idx)
        neighbor_agg.sparse_gather_sum(vals, ids, g.nbrs, g.mask, d)
        k7.flash_attention(q, kv, kv, causal=True, window=0)
        _, _, saved = k8.slstm_scan(xp, wr, st, save=True)
        k8.slstm_scan_backward(torch.randn((b, s, h, hd), device=cuda),
                               {k: torch.zeros_like(v) for k, v in
                                st.items()}, wr, saved, st)
    k = {name: (r["launches"], r["flops"], r["bytes"], r["exact"])
         for name, r in c.kernels.items()}
    assert k["gather_sum_pipelined"] == k["gather_sum_blocked"] == (
        1, 0, gather, True)
    assert k["segment_add_ordered"] == (
        1, 0, p * d * 4 + p * 4 + segs * 8 + segs * d * 8, True)
    assert k["scatter_sum_ordered"] == (
        1, 0, src_rows * d * 4 + ix.num_slots * 4
        + (2 * int(ix.rows.numel()) + 1) * 4
        + 2 * int(ix.rows.numel()) * d * 4, True)
    n_idx = int(torch.unique(idx).numel())
    assert k["gather_rows"] == (1, 0, n_idx * d * 4 + 77 * 4 + 77 * d * 4,
                                True)
    assert k["sparse_gather_sum"] == (
        1, 0, distinct * 4 * (4 + 2) + p * ps * 5 + p * d * 4, True)
    pairs = 64 * 65 // 2
    assert k["flash_attention"] == (
        1, 4 * 2 * 4 * 64 * pairs,
        sum(x.numel() for x in (q, kv, kv, q)) * 2, True)
    assert k["slstm_scan"][:2] == (1, 2 * b * s * h * hd * 4 * hd)
    assert k["slstm_scan"][2] == 4 * (xp.numel() + b * s * h * hd
                                      + wr.numel() + 8 * b * h * hd
                                      + 7 * b * s * h * hd)
    assert k["slstm_scan_backward"] == (
        1, 2 * b * s * h * hd * 4 * hd,
        4 * (b * s * h * hd * 8 + wr.numel() + 7 * b * h * hd
             + b * s * h * 4 * hd + 4 * b * h * hd), True)


def test_ring_counted_on_card_equals_meta_and_the_plan(cuda):
    """One aggregation on the card under the counter: its rotations are
    the meta ring's and ``collective_bytes``, its K1/K3 records the host
    plan's exact work (``launch/dryrun_gnn.plan_work``)."""
    from repro_torch.launch import dryrun_gnn
    from repro_torch.launch.op_cost import analyze
    g = TC.power_law(2000, avg_degree=8.0, locality=0.3, seed=3)
    plan = TC.build_plan(g, 4, ps=8, dist=2)
    x = torch.randn((plan.padded_nodes, 24), device=cuda)
    ring = VirtualRing(4, cuda)
    arrays = TC.plan_device_arrays(plan, device=cuda)
    with torch.inference_mode():
        live = analyze(TC.mgg_aggregate, x, plan, ring, arrays=arrays)
    meta = dryrun_gnn.count_ring(plan, 24, arrays)
    assert live.collectives == meta.collectives
    assert live.collectives["collective-permute"]["bytes"] == \
        TC.collective_bytes(plan, 24) * 4
    assert live.n_async == meta.n_async == 2 * 3
    assert live.kernels == dryrun_gnn.plan_work(plan, 24)
