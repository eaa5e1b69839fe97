"""repro_torch kernels: the plain versions against the reference's oracle
and its Pallas kernels (interpret mode) — the gather-sum's backward against
the reference's custom VJP, the row gather against its Pallas kernel — the
ordered segment add and scatter-sum against sequential loops, and the
CPU/CUDA routing.  The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.core.pipeline import WorkGroup
from repro_torch.kernels import neighbor_agg, ops, ref, rows

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

# (P, ps, D): widths of the slice (16), products' input (100), a width
# that is no lane multiple (130), and degenerate ones
SHAPES = [(5, 1, 1), (32, 8, 16), (7, 4, 100), (9, 16, 130), (3, 2, 602)]


def _inputs(p, ps, d, t=40, seed=0, all_masked=False):
    rng = np.random.default_rng(seed)
    buf = rng.normal(size=(t, d)).astype(np.float32)
    nbrs = rng.integers(0, t, size=(p, ps)).astype(np.int32)
    mask = np.zeros((p, ps), bool) if all_masked \
        else rng.random((p, ps)) < 0.7
    return buf, nbrs, mask


def _torch(buf, nbrs, mask, device="cpu"):
    return (torch.from_numpy(buf).to(device),
            torch.from_numpy(nbrs).to(device),
            torch.from_numpy(mask).to(device))


@pytest.mark.parametrize("p,ps,d", SHAPES)
def test_plain_gather_sum_matches_reference_oracle(p, ps, d):
    buf, nbrs, mask = _inputs(p, ps, d, seed=p + d)
    want = np.asarray(rref.neighbor_gather_sum_ref(
        jnp.asarray(buf), jnp.asarray(nbrs), jnp.asarray(mask)))
    got = ops.neighbor_gather_sum(*_torch(buf, nbrs, mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pb", [None, 2])
@pytest.mark.parametrize("p,ps,d", [(32, 8, 16), (7, 4, 100), (5, 3, 1)])
def test_plain_gather_sum_matches_pallas_interpret(p, ps, d, pb):
    buf, nbrs, mask = _inputs(p, ps, d, seed=3 * p + ps)
    want = np.asarray(rops.neighbor_gather_sum(
        jnp.asarray(buf), jnp.asarray(nbrs), jnp.asarray(mask), pb=pb,
        interpret=True))
    got = ops.neighbor_gather_sum(*_torch(buf, nbrs, mask), pb=pb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_plain_gather_sum_all_masked_is_zero():
    buf, nbrs, mask = _inputs(6, 4, 16, all_masked=True)
    got = ops.neighbor_gather_sum(*_torch(buf, nbrs, mask)).numpy()
    assert got.shape == (6, 16) and not got.any()


def _segments(tgt):
    """The engine's per-step segment order for one target array."""
    grp = WorkGroup.build(np.zeros((tgt.size, 1), np.int32),
                          np.ones((tgt.size, 1), bool), tgt, "cpu")
    return grp.order, grp.seg_rows, grp.seg_start


@pytest.mark.parametrize("kind", ["padded_sorted", "shuffled", "empty"])
def test_segment_add_bitwise_equals_sequential_loop(kind):
    rng = np.random.default_rng(7)
    rows, d = 30, 5
    if kind == "padded_sorted":
        # a plan's targets: sorted, repeated for high-degree rows, then
        # padded with row 0 at the tail
        tgt = np.concatenate([np.sort(rng.integers(0, rows, 50)),
                              np.zeros(9, np.int64)])
    elif kind == "shuffled":
        tgt = rng.integers(0, rows, 80)
    else:
        tgt = np.zeros(0, np.int64)
    partial = rng.normal(size=(tgt.size, d)).astype(np.float32) * 1e3
    out0 = rng.normal(size=(rows, d)).astype(np.float32)
    want = out0.copy()
    for i in range(tgt.size):        # the reference's scatter, in order
        want[tgt[i]] += partial[i]
    got = torch.from_numpy(out0.copy())
    ops.segment_add_ordered(got, torch.from_numpy(partial), *_segments(tgt))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_plain_versions_and_kernels_refuse_them():
    buf, nbrs, mask = _torch(*_inputs(4, 2, 8))
    neighbor_agg.reset_launch_counts()
    ops.neighbor_gather_sum(buf, nbrs, mask, pb=4)
    assert set(neighbor_agg.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu"):
        neighbor_agg.gather_sum_pipelined(buf, nbrs, mask)
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu"):
        neighbor_agg.gather_sum_blocked(buf, nbrs, mask, pb=2)
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu"):
        neighbor_agg.segment_add_ordered(
            torch.zeros(3, 8), torch.zeros(4, 8), *_segments(np.arange(4) % 3))
    # a meta tensor (a dry run) takes the kernel's stand-in: an empty
    # result of its shape, no launch; any other device still raises
    out = ops.neighbor_gather_sum(buf.to("meta"), nbrs.to("meta"),
                                  mask.to("meta"))
    assert out.device.type == "meta" and out.shape == (4, 8)
    assert set(neighbor_agg.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="no gather-sum for device"):
        ops._route(types.SimpleNamespace(device=torch.device("xpu")))


def test_blocked_fits_is_the_shared_memory_rule():
    assert neighbor_agg.blocked_fits(1, 16)
    assert neighbor_agg.blocked_fits(32, 16)
    assert not neighbor_agg.blocked_fits(33, 1)      # > 1024 threads
    assert not neighbor_agg.blocked_fits(0, 8)
    assert not neighbor_agg.blocked_fits(32, 200)    # ids > 48 KB


@pytest.mark.parametrize("p,ps,d", SHAPES)
def test_gather_sum_backward_matches_reference_vjp(p, ps, d):
    """K4's plain version through the autograd Function equals the
    reference's custom VJP (its masked scatter-add), Pallas interpret."""
    buf, nbrs, mask = _inputs(p, ps, d, seed=7 * p + d)
    g = np.random.default_rng(d).normal(size=(p, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda b: rops.neighbor_gather_sum(
        b, jnp.asarray(nbrs), jnp.asarray(mask), interpret=True),
        jnp.asarray(buf))
    (want,) = vjp(jnp.asarray(g))
    tb, tn, tm = _torch(buf, nbrs, mask)
    tb.requires_grad_(True)
    out = ops.neighbor_gather_sum(tb, tn, tm, grad_index=ops.GradIndex.build(
        nbrs, mask))
    (got,) = torch.autograd.grad(out, tb, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_scatter_sum_bitwise_equals_sequential_loop():
    """The backward adds each row's slots in slot order: bitwise the loop
    ``for p, j: if mask: dbuf[nbrs[p, j]] += g[tgt[p]]``; masked slots
    (and rows only they name) get nothing."""
    buf, nbrs, mask = _inputs(60, 5, 7, t=30, seed=11)
    tgt = np.random.default_rng(1).integers(0, 20, 60)
    g = np.random.default_rng(2).normal(size=(20, 7)).astype(np.float32)
    want = np.zeros((30, 7), np.float32)
    for p in range(60):
        for j in range(5):
            if mask[p, j]:
                want[nbrs[p, j]] += g[tgt[p]]
    idx = ops.GradIndex.build(nbrs, mask, tgt)
    assert idx.num_slots == int(mask.sum())
    assert idx.chunks is None                 # no segment is cut
    got = torch.zeros(30, 7)
    ops.scatter_sum_ordered(got, torch.from_numpy(g), idx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_sum_cuts_hub_segments_into_fixed_chunks():
    """Only a hub row (a neighbor named by more slots than the index's
    chunk length C) is summed chunk by chunk, each chunk in slot order from
    zero, then the chunk sums in order onto the row; a row of exactly C
    slots, and every shorter one, adds its slots in slot order.  Bitwise
    that loop, and within fp32 rounding of the plain sum."""
    rng = np.random.default_rng(3)
    c = ops.chunk_length(3 * ops.SEG_CHUNK + 17)
    # row 4 a hub of 3C + 17 slots, row 6 exactly C, row 7 C + 1 (a hub
    # whose last chunk holds one slot), rows 0..3 and 8 short; shuffled
    nbrs = np.concatenate([np.full(3 * c + 17, 4), np.full(c, 6),
                           np.full(c + 1, 7), rng.integers(0, 4, 40),
                           np.full(5, 8)])
    rng.shuffle(nbrs)
    nbrs = nbrs[:, None]
    n_slots = nbrs.shape[0]
    mask = np.ones_like(nbrs, bool)
    g = (rng.normal(size=(n_slots, 5)) * 1e3).astype(np.float32)
    idx = ops.GradIndex.build(nbrs, mask)
    assert idx.chunks is not None and idx.chunks.chunk == c
    np.testing.assert_array_equal(idx.rows.numpy()[idx.chunks.hubs.numpy()],
                                  [4, 7])
    dbuf0 = rng.normal(size=(9, 5)).astype(np.float32)
    want = dbuf0.copy()
    for r in range(9):
        slots = np.flatnonzero(nbrs[:, 0] == r)
        if slots.size > c:          # a hub: chunk sums from zero, in order
            for lo in range(0, slots.size, c):
                part = np.zeros(5, np.float32)
                for k in slots[lo:lo + c]:
                    part += g[k]
                want[r] += part
        else:                       # slot by slot onto the row
            for k in slots:
                want[r] += g[k]
    got = torch.from_numpy(dbuf0.copy())
    ops.scatter_sum_ordered(got, torch.from_numpy(g), idx)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = dbuf0.astype(np.float64)
    np.add.at(plain, nbrs[:, 0], g)
    np.testing.assert_allclose(got.numpy(), plain, rtol=1e-4, atol=1e-1)


@pytest.mark.parametrize("b,t,d", [(9, 20, 1), (40, 17, 16), (5, 8, 100),
                                   (12, 30, 130)])
def test_plain_gather_rows_matches_pallas_interpret(b, t, d):
    rng = np.random.default_rng(b + d)
    src = rng.normal(size=(t, d)).astype(np.float32)
    idx = rng.integers(0, t, b).astype(np.int32)     # repeats included
    want = np.asarray(rops.gather_rows(jnp.asarray(src), jnp.asarray(idx),
                                       interpret=True))
    got = ops.gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), src[idx])


def test_gather_rows_out_of_range_ids_give_zero_rows():
    src = torch.arange(12, dtype=torch.float32).view(4, 3)
    idx = torch.tensor([3, -1, 4, 0], dtype=torch.int32)
    got = ref.gather_rows_ref(src, idx)
    np.testing.assert_array_equal(got.numpy(), [[9, 10, 11], [0, 0, 0],
                                                [0, 0, 0], [0, 1, 2]])


def _k5_visits(B, D, p, unroll=rows.UNROLL, threads=rows.THREADS):
    """How often K5's grid-stride schedule under plan ``p`` visits each of
    the output's ``B · D / width`` vectors, simulated with the kernel's own
    arithmetic (csrc/rows.cu: one divmod a thread, then (quotient,
    remainder) steps with one carry)."""
    vpr = D // p.width
    g0 = (np.arange(p.grid)[:, None] * unroll * threads
          + np.arange(threads)).ravel()
    assert int(g0.max()) < 2 ** 31 and p.grid * unroll * threads < 2 ** 31
    r, c = np.divmod(g0, vpr)
    lane = divmod(threads, vpr)
    stride = p.grid * unroll * threads
    chunk = divmod(stride - (unroll - 1) * threads, vpr)

    def advance(r, c, step):
        r, c = r + step[0], c + step[1]
        carry = c >= vpr
        return r + carry, c - carry * vpr

    seen = np.zeros(B * vpr, np.int64)
    while (r < B).any():
        for u in range(unroll):
            assert ((c >= 0) & (c < vpr)).all()
            live = r < B
            np.add.at(seen, r[live] * vpr + c[live], 1)
            if u + 1 < unroll:
                r, c = advance(r, c, lane)
        r, c = advance(r, c, chunk)
    return seen


@pytest.mark.parametrize("sms,bps", [(1, 1), (3, 2), (132, 8)])
@pytest.mark.parametrize("d", [1, 3, 4, 100, 130, 257])
def test_gather_rows_plan_visits_every_vector_once(d, sms, bps):
    """K5's schedule covers every vector of the output exactly once, over
    B at and around a chunk of vectors, a grid the chunks fill and one
    that walks many turns, on cards of 1, 3 and 132 SMs."""
    chunk_rows = -(-rows.UNROLL * rows.THREADS // (d // (4 if d % 4 == 0
                                                         else 1)))
    for b in (1, 7, chunk_rows - 1, chunk_rows, chunk_rows + 1,
              5 * chunk_rows + 3):
        for width in sorted({1, 4 if d % 4 == 0 else 1}):
            p = rows.plan(b, d, sms, bps, width=width)
            seen = _k5_visits(b, d, p)
            assert seen.size == b * d // width
            assert (seen == 1).all(), (b, d, sms, bps, p)


@pytest.mark.parametrize("b,d,sms,bps", [
    (1, 1, 132, 8), (1, 100, 132, 8), (42_000, 100, 132, 8),
    (2_450_000, 100, 132, 8), (22_000_000, 100, 132, 8),
    (5_000_000, 1, 132, 8), (1000, 257, 78, 4), (1000, 3, 132, 0)])
def test_gather_rows_plan_stays_in_range(b, d, sms, bps):
    """The plan's grid is at least 1 and at most the blocks the card holds
    at once (at least one a SM), and its span within 31 bits; the width is
    4 exactly where D % 4 == 0 unless 1 is asked for.  U (4-8 vectors a
    thread) and the block (a multiple of 32, at most 1024 threads) are the
    kernel's constants, the same in rows.cu."""
    assert 4 <= rows.UNROLL <= 8
    assert rows.THREADS % 32 == 0 and 32 <= rows.THREADS <= 1024
    cu = (Path(rows.__file__).parent / "csrc" / "rows.cu").read_text()
    assert f"constexpr int kUnroll = {rows.UNROLL};" in cu
    assert f"constexpr int kThreads = {rows.THREADS};" in cu
    p = rows.plan(b, d, sms, bps)
    assert 1 <= p.grid <= sms * max(1, bps)
    assert p.grid * rows.UNROLL * rows.THREADS < 2 ** 31
    assert p.width == (4 if d % 4 == 0 else 1)
    vectors = b * d // p.width
    assert p.grid == min(sms * max(1, bps),
                         -(-vectors // (rows.UNROLL * rows.THREADS)))
    assert rows.plan(b, d, sms, bps, width=1).width == 1


def test_gather_rows_plan_refuses_what_the_kernel_lacks():
    with pytest.raises(ValueError):
        rows.plan(10, 6, 132, 8, width=4)          # 4 does not divide 6
    with pytest.raises(ValueError):
        rows.plan(10, 8, 132, 8, width=2)


def test_new_kernels_refuse_cpu_tensors_and_count_nothing_there():
    rows.reset_launch_counts()
    neighbor_agg.reset_launch_counts()
    src = torch.zeros(4, 3)
    idx = torch.zeros(2, dtype=torch.int32)
    ops.gather_rows(src, idx)
    assert rows.launch_counts() == {"gather_rows": 0}
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu"):
        rows.gather_rows(src, idx)
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu"):
        neighbor_agg.scatter_sum_ordered(torch.zeros(3, 8),
                                         torch.zeros(4, 8),
                                         ops.GradIndex.build(
                                             np.arange(4)[:, None] % 3,
                                             np.ones((4, 1), bool)))
    # meta: the stand-in's empty result, no launch; other devices raise
    out = ops.gather_rows(src.to("meta"), idx.to("meta"))
    assert out.device.type == "meta" and out.shape == (2, 3)
    assert rows.launch_counts() == {"gather_rows": 0}
    with pytest.raises(ValueError, match="no row gather for device"):
        ops._route(types.SimpleNamespace(device=torch.device("xpu")),
                   "row gather")
    with pytest.raises(ValueError, match="needs its grad_index"):
        ops.neighbor_gather_sum(src.requires_grad_(True),
                                torch.zeros(2, 1, dtype=torch.int32),
                                torch.ones(2, 1, dtype=torch.bool))
    assert neighbor_agg.scatter_sum_ordered.launches == 0
