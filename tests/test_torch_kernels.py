"""repro_torch kernels: the plain versions against the reference's oracle
and its Pallas kernels (interpret mode), the ordered segment add against a
sequential loop, and the CPU/CUDA routing.  The CUDA kernels themselves
are held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.core.pipeline import WorkGroup
from repro_torch.kernels import neighbor_agg, ops

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
    with pytest.raises(ValueError, match="no gather-sum for device"):
        ops.neighbor_gather_sum(buf.to("meta"), nbrs.to("meta"),
                                mask.to("meta"))


def test_blocked_fits_is_the_shared_memory_rule():
    assert neighbor_agg.blocked_fits(1, 16)
    assert neighbor_agg.blocked_fits(32, 16)
    assert not neighbor_agg.blocked_fits(33, 1)      # > 1024 threads
    assert not neighbor_agg.blocked_fits(0, 8)
    assert not neighbor_agg.blocked_fits(32, 200)    # ids > 48 KB
