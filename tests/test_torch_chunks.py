"""K3's fixed-order hub chunks on the CPU.

A segment of the ring's ordered segment add longer than ``ops.SEG_CHUNK``
partials (a hub row) is summed in two passes over fixed-order chunks.  The
plain version is held bitwise to an explicit numpy loop over that
association, and the other segments of the same call to the sequential
scatter; then a one-shard ring over a graph with a hub is held to the JAX
reference (1e-5: fp32 sums in another order), in process on the pytest
process's one CPU device.  The CUDA kernel is held bitwise to the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as RC
from repro.dist import flat_ring_mesh

import repro_torch.core as TC
from repro_torch.core.pipeline import WorkGroup, plan_device_arrays
from repro_torch.dist import VirtualRing
from repro_torch.kernels import ops, ref

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

C = ops.SEG_CHUNK


def _group(tgt):
    return WorkGroup.build(np.zeros((tgt.size, 1), np.int32),
                           np.ones((tgt.size, 1), bool), tgt, "cpu")


def _targets(rng, hub=5003):
    """Row 0 a hub of ``hub`` partials, row 7 exactly C (not a hub), row 9
    C + 1 (a hub whose last chunk holds one), rows 10.. short; shuffled."""
    tgt = np.concatenate([np.zeros(hub, np.int64), np.full(C, 7),
                          np.full(C + 1, 9), rng.integers(10, 400, 3000)])
    rng.shuffle(tgt)
    return tgt


def _chunk_index(kind, tgt):
    """K3's index of a group whose partitions target ``tgt``, or K4's
    transposed index of a gather-sum whose one slot a partition names
    ``tgt``: the same segments either way.  Returns (seg_rows, seg_start,
    chunks)."""
    if kind == "segment_add":
        grp = _group(tgt)
        return grp.seg_rows, grp.seg_start, grp.chunks
    idx = ops.GradIndex.build(tgt[:, None], np.ones((tgt.size, 1), bool))
    return idx.rows, idx.start, idx.chunks


@pytest.mark.parametrize("kind", ["segment_add", "scatter_sum"])
def test_chunk_index_cuts_exactly_the_segments_longer_than_the_chunk(kind):
    tgt = _targets(np.random.default_rng(0))
    seg_rows, seg_start, ch = _chunk_index(kind, tgt)
    seg_start = seg_start.numpy()
    lens = np.diff(seg_start)
    assert ch.chunk == ops.chunk_length(int(lens.max())) == C
    np.testing.assert_array_equal(ch.hubs.numpy(), np.flatnonzero(lens > C))
    assert set(seg_rows.numpy()[ch.hubs.numpy()]) == {0, 9}
    hc, start, end = (t.numpy() for t in (ch.hub_chunks, ch.chunk_start,
                                          ch.chunk_end))
    for h, s in enumerate(ch.hubs.numpy()):
        # chunks of C from the segment's start, in order, the last shorter
        want = np.arange(seg_start[s], seg_start[s + 1], C)
        np.testing.assert_array_equal(start[hc[h]:hc[h + 1]], want)
        np.testing.assert_array_equal(
            end[hc[h]:hc[h + 1]],
            np.minimum(want + C, seg_start[s + 1]))
    # the longest serial walk: a chunk, then a hub's chunk sums
    assert (end - start).max() <= C
    assert np.diff(hc).max() == -(-lens.max() // C)
    assert ops.SegmentChunks.build(np.arange(0, 10 * C + 1, C)) is None


@pytest.mark.parametrize("longest,chunk", [
    (0, C), (1, C), (C, C), (8123, 64), (131_071, 64), (131_072, 128),
    (173_973, 128), (1 << 19, 256), (1 << 23, 1024)])
def test_chunk_length_is_a_power_of_two_below_the_root_of_an_eighth(longest,
                                                                   chunk):
    """The chunk length is a function of the index's longest segment L
    alone: the largest power of two not above sqrt(L / 8), never below
    SEG_CHUNK; segments longer than it are hubs."""
    assert ops.chunk_length(longest) == chunk
    lens = np.array([longest, 3, 0])
    ch = ops.SegmentChunks.build(np.concatenate([[0], np.cumsum(lens)]))
    assert (ch is None) == (longest <= chunk)
    assert ch is None or ch.chunk == chunk


@pytest.mark.parametrize("d", [16, 5])
def test_plain_two_passes_bitwise_equal_an_explicit_loop(d):
    rng = np.random.default_rng(d)
    tgt = _targets(rng)
    partial = (rng.normal(size=(tgt.size, d)) * 1e3).astype(np.float32)
    out0 = rng.normal(size=(400, d)).astype(np.float32)
    grp = _group(tgt)
    order, seg_rows, seg_start = (t.numpy() for t in (
        grp.order, grp.seg_rows, grp.seg_start))
    hubs = set(np.flatnonzero(np.diff(seg_start) > C).tolist())
    want = out0.copy()
    for s, row in enumerate(seg_rows):
        ks = order[seg_start[s]:seg_start[s + 1]]
        if s in hubs:     # each chunk from zero in partition order, then
            for j in range(0, ks.size, C):        # the sums in chunk order
                chunk = np.zeros(d, np.float32)
                for i in ks[j:j + C]:
                    chunk += partial[i]
                want[row] += chunk
        else:
            for i in ks:
                want[row] += partial[i]
    seq = out0.copy()
    for i in range(tgt.size):      # the reference's scatter, in order
        seq[tgt[i]] += partial[i]
    assert not np.array_equal(want[[0, 9]], seq[[0, 9]])  # another order

    for fn in (ref.segment_add_ordered_ref, ops.segment_add_ordered):
        got = torch.from_numpy(out0.copy())
        fn(got, torch.from_numpy(partial), grp.order, grp.seg_rows,
           grp.seg_start, grp.chunks)
        np.testing.assert_array_equal(got.numpy(), want)
        short = np.setdiff1d(np.arange(400), [0, 9])
        np.testing.assert_array_equal(got.numpy()[short], seq[short])
    # without the index every segment is one pass: the sequential scatter
    got = torch.from_numpy(out0.copy())
    ops.segment_add_ordered(got, torch.from_numpy(partial), grp.order,
                            grp.seg_rows, grp.seg_start)
    np.testing.assert_array_equal(got.numpy(), seq)


def _hub_graph(n=2000, hub_degree=1200, seed=4):
    """A sparse random graph whose node 0 has ``hub_degree`` in-neighbors
    (at ``ps`` slots a partition it owns more than C partitions: a hub of
    the ring's segment add) and whose node 1 is an in-neighbor of
    ``hub_degree`` nodes (named by that many slots: a hub of the
    backward's scatter-sum)."""
    rng = np.random.default_rng(seed)
    fans = rng.choice(np.arange(2, n), hub_degree, replace=False)
    dst = np.concatenate([rng.integers(0, n, 4 * n),
                          np.zeros(hub_degree, np.int64), fans])
    src = np.concatenate([rng.integers(0, n, 4 * n),
                          rng.choice(np.arange(1, n), hub_degree,
                                     replace=False),
                          np.ones(hub_degree, np.int64)])
    key = np.unique(dst * n + src)
    dst, src = key // n, key % n
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    return indptr, src.astype(np.int32), n


@pytest.mark.parametrize("ps,d,fused", [(8, 16, False), (4, 23, False),
                                        (8, 16, True)])
def test_one_shard_ring_with_a_hub_matches_reference(ps, d, fused):
    """The ring's output, and its ``x`` gradient (the backward's K4 over a
    neighbor hub), against the reference's ring and its VJP."""
    indptr, indices, n = _hub_graph()
    assert np.diff(indptr)[0] > C * ps
    rg, tg = RC.CSRGraph(indptr, indices, n), TC.CSRGraph(indptr, indices, n)
    rng = np.random.default_rng(ps + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, 9)).astype(np.float32) if fused else None

    rplan = RC.build_plan(rg, 1, ps=ps, dist=1)

    def ring_and_vjp(xx, ww, gg):
        out, vjp = jax.vjp(lambda a: RC.mgg_aggregate(
            a, rplan, flat_ring_mesh(1), update_w=ww), xx)
        return out, vjp(gg)[0]

    xpad = RC.pad_embeddings(rplan, x)
    cot = rng.normal(size=(xpad.shape[0], d if w is None else 9)).astype(
        np.float32)
    want, want_dx = (np.asarray(a) for a in jax.jit(ring_and_vjp)(
        jnp.asarray(xpad), None if w is None else jnp.asarray(w),
        jnp.asarray(cot)))

    tplan = TC.build_plan(tg, 1, ps=ps, dist=1)
    arrays = plan_device_arrays(tplan, device="cpu")
    assert arrays.local.chunks is not None     # the hub takes two passes
    assert arrays.local.grad.chunks is not None    # so does the backward's
    xt = torch.from_numpy(TC.pad_embeddings(tplan, x)).requires_grad_(True)
    out = TC.mgg_aggregate(
        xt, tplan, VirtualRing(1, "cpu"), arrays=arrays,
        update_w=None if w is None else torch.from_numpy(w))
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    got = out.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-5)
    if not fused:
        oracle = TC.reference_aggregate(indptr, indices, x)
        np.testing.assert_allclose(TC.unpad_embeddings(tplan, got), oracle,
                                   rtol=1e-5, atol=1e-4)
