"""repro_torch's sampled path against the JAX reference: blocks, the
tiered store and sampled GraphSAGE.

The same numpy inputs and ``np.random.Generator`` states go through both
packages (the reference jitted, ``use_kernel=False``, on its one CPU
device).  Sampling and the tiered row gather must agree exactly (the same
draws; every assembled row the store's bits); sampled GraphSAGE's logits
and gradients within rtol 2e-4 (fp32 sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as RC
from repro.sample import block_tree as r_block_tree
from repro.sample import sample_blocks as r_sample_blocks
from repro.sample import sampled_khop_frontier as r_frontier
from repro.sample import seed_batches as r_seed_batches
from repro.store import FeatureStore as RStore
from repro.store import HotFeatureCache as RHot
from repro.store import TieredFeatures as RTiered
from repro.train.checkpoint import _flat_with_names

import repro_torch.core as TC
from repro_torch.sample import (Block, block_tree, sample_blocks,
                                sampled_khop_frontier, seed_batches)
from repro_torch.store import FeatureStore, HotFeatureCache, TieredFeatures
from repro_torch.train import value_and_grad
from repro_torch.train.tree import tree_flatten_with_names, tree_unflatten

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

N, D, NCLS = 360, 9, 4
CPU = "cpu"


def _graph(C):
    return C.power_law(N, avg_degree=7.0, locality=0.35, seed=11)


def _features():
    return np.random.default_rng(3).normal(size=(N, D)).astype(np.float32)


@pytest.mark.parametrize("fanouts,batch", [([3, 2], 16), ([5, 4, 2], 40),
                                           ([1], 7)])
def test_sample_blocks_equal_reference(fanouts, batch):
    rg, tg = _graph(RC), _graph(TC)
    r_rng, t_rng = np.random.default_rng(9), np.random.default_rng(9)
    ids = np.arange(0, N, 3)
    r_batches = list(r_seed_batches(ids, batch, rng=r_rng))
    t_batches = list(seed_batches(ids, batch, rng=t_rng))
    assert len(r_batches) == len(t_batches)
    for (rs, rv), (ts, tv) in zip(r_batches[:3], t_batches[:3]):
        np.testing.assert_array_equal(rs, ts)
        np.testing.assert_array_equal(rv, tv)
        r_blocks = r_sample_blocks(rg, rs, fanouts, batch=batch, rng=r_rng)
        t_blocks = sample_blocks(tg, ts, fanouts, batch=batch, rng=t_rng)
        for rb, tb in zip(r_blocks, t_blocks):
            for f in ("src_ids", "nbr", "mask"):
                a, b = getattr(rb, f), getattr(tb, f)
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(
        r_frontier(rg, ids[:5], fanouts, rng=np.random.default_rng(2)),
        sampled_khop_frontier(tg, ids[:5], fanouts,
                              rng=np.random.default_rng(2)))


def _tiered_pair(cap):
    x = _features()
    hot = np.argsort(-np.diff(_graph(TC).indptr))[:cap]
    rt = RTiered(RStore(x), None, capacity=cap)
    tt = TieredFeatures(FeatureStore(x), None, cap, device=CPU)
    if cap:
        rt.admit(hot)
        tt.admit(hot)
    return x, rt, tt


@pytest.mark.parametrize("cap", [0, N // 7, N])
def test_tiered_gather_rows_bitwise_equals_x_ids(cap):
    """``gather_rows`` is ``x[ids]`` bit for bit at any capacity (``-1``
    gives a zero row), in the port and in the reference, with the same
    hit/miss accounting."""
    x, rt, tt = _tiered_pair(cap)
    rng = np.random.default_rng(cap)
    for rows in (None, 700):
        ids = rng.integers(-1, N, 600)
        want = np.where((ids >= 0)[:, None], x[np.maximum(ids, 0)], 0.0)
        if rows:
            want = np.concatenate([want, np.zeros((rows - 600, D))])
        got = tt.gather_rows(ids, rows=rows)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(rt.gather_rows(ids, rows=rows)))
    tt.update(5, np.full(D, 7.0, np.float32))
    rt.update(5, np.full(D, 7.0, np.float32))
    np.testing.assert_array_equal(tt.gather_rows(np.array([5, 6])).numpy(),
                                  np.asarray(rt.gather_rows(
                                      np.array([5, 6]))))
    assert tt.report() == rt.report()


def test_hot_cache_admission_matches_reference():
    """The vectorised hottest-first admission keeps the reference's maps,
    counters and rows through re-admission, invalidation and eviction."""
    x = _features()
    rs, ts = RStore(x), FeatureStore(x)
    rc, tc = RHot(N, 50, D), HotFeatureCache(N, 50, D)
    rng = np.random.default_rng(4)
    for step in range(6):
        hot = rng.integers(0, N, 80)          # repeats: dedupe, first wins
        assert rc.admit(hot, rs) == tc.admit(hot, ts)
        dirty = rng.integers(0, N, 30)
        assert rc.invalidate(dirty) == tc.invalidate(dirty)
        if step == 4:
            assert rc.invalidate() == tc.invalidate()
        for name in ("_slot_of", "_node_at", "_valid"):
            np.testing.assert_array_equal(getattr(rc, name),
                                          getattr(tc, name), err_msg=name)
        for name in ("admissions", "evictions", "invalidations"):
            assert getattr(rc, name) == getattr(tc, name), name
        valid = np.flatnonzero(tc._valid)
        np.testing.assert_array_equal(tc.table.numpy()[valid],
                                      x[tc._node_at[valid]])
    assert rs.rows_gathered == ts.rows_gathered and rs.gathers == ts.gathers
    assert tc.evictions > 0


def _sage_params(in_dim, hidden, ncls):
    p = RC.MODEL_ZOO["sage"][0](jax.random.key(5), in_dim, ncls,
                                hidden=hidden, num_layers=2)
    like = TC.sage_init(torch.Generator().manual_seed(0), in_dim, ncls,
                        hidden=hidden, num_layers=2)
    named = {n: np.array(v) for n, v in _flat_with_names(p)}
    return p, tree_unflatten(like, [torch.from_numpy(named[n])
                                    for n, _ in tree_flatten_with_names(like)])


@pytest.mark.parametrize("fanout,batch", [(4, 24), (7, 10)])
def test_sampled_sage_logits_and_gradients_match_reference(fanout, batch):
    rg, tg = _graph(RC), _graph(TC)
    x = _features()
    labels = np.random.default_rng(1).integers(0, NCLS, N).astype(np.int32)
    seeds, valid = next(seed_batches(np.arange(N - 5), batch,
                                     rng=np.random.default_rng(0)))
    seeds[-2:], valid[-2:] = -1, 0.0           # padded seeds stay masked
    blocks = sample_blocks(tg, seeds, [fanout, fanout], batch=batch,
                           rng=np.random.default_rng(6))
    rblocks = r_sample_blocks(rg, seeds, [fanout, fanout], batch=batch,
                              rng=np.random.default_rng(6))
    rp, tp = _sage_params(D, 8, NCLS)
    h0 = np.where((blocks[0].src_ids >= 0)[:, None],
                  x[np.maximum(blocks[0].src_ids, 0)], 0.0).astype(np.float32)
    yb = labels[np.clip(seeds, 0, None)]

    @jax.jit
    def ref_fwd_grad(p, h, bt):
        def loss(p, h):
            logits = RC.apply_blocks("sage", p, h, bt)
            return RC.masked_cross_entropy(logits, jnp.asarray(yb),
                                           jnp.asarray(valid)), logits
        return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, h)

    (_, r_logits), (r_grads, r_dh) = ref_fwd_grad(
        rp, jnp.asarray(h0), r_block_tree(rblocks))
    bt = block_tree(blocks, CPU)
    logits = []

    def loss(p):
        h = p.pop("h0")
        logits.append(TC.apply_blocks("sage", p, h, bt))
        return TC.masked_cross_entropy(logits[-1], torch.from_numpy(yb),
                                       torch.from_numpy(valid))

    _, grads = value_and_grad(loss, dict(tp, h0=torch.from_numpy(h0)))
    np.testing.assert_allclose(logits[0].detach().numpy(),
                               np.asarray(r_logits), rtol=2e-4, atol=1e-6)
    for (name, a), b in zip(tree_flatten_with_names(grads["layers"]),
                            jax.tree.leaves(r_grads["layers"])):
        assert np.abs(np.asarray(b)).max() > 0, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-6, err_msg=name)
    dh = grads["h0"].numpy()
    np.testing.assert_allclose(dh, np.asarray(r_dh), rtol=2e-4, atol=1e-6)
    # padding rows of the source table (src_ids == -1) get no gradient
    assert not dh[blocks[0].src_ids < 0].any()


def test_block_neighbor_sum_sentinel_gets_no_gradient():
    """Slots padded to the sentinel row carry mask 0: the gradient of the
    source table is the masked scatter-add, with no leak to any row."""
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
    nbr = np.array([[0, 6, 2], [6, 6, 6], [5, 5, 1]], np.int32)
    mask = nbr < 6
    blk = Block(src_ids=np.arange(6), nbr=nbr, mask=mask.astype(np.float32))
    idx = block_tree([blk])[0]["grad"]
    h.requires_grad_(True)
    out = TC.block_neighbor_sum(h, torch.from_numpy(nbr),
                                torch.from_numpy(mask), grad_index=idx)
    g = torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32))
    (dh,) = torch.autograd.grad(out, h, g)
    want = np.zeros((6, 3), np.float32)
    for p in range(3):
        for j in range(3):
            if mask[p, j]:
                want[nbr[p, j]] += g[p].numpy()
    np.testing.assert_array_equal(dh.numpy(), want)
    assert out[1].abs().max() == 0


def test_launcher_sampled_branch_on_cpu():
    from repro_torch.launch import train_gnn
    rep = train_gnn.main(["--device", "cpu", "--model", "sage", "--scale",
                          "0.05", "--steps", "3", "--sample-fanout", "4",
                          "--sample-batch", "32"])
    assert rep["device"] == "cpu" and np.isfinite(rep["losses"]).all()
    n = TC.paper_dataset("products", scale=0.05)[0].num_nodes
    assert rep["store"]["capacity"] == n // 8
    assert rep["store"]["cache_rows_served"] > 0
    assert 0 <= rep["test_acc"] <= 1
