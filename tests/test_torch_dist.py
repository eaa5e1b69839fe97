"""repro_torch's distributed substrate against the JAX reference, in process.

The port's virtual mesh (``dist/mesh.py``), its ring-pipelined collectives
(``dist/collectives.py``), the error-feedback all-reduce
(``dist/compress.py``), the sharding rules (``dist/sharding.py``), the
production meshes (``launch/mesh.py``), the expert-parallel MoE at ep 1,
the error-feedback train step and the launcher's ``--devices``,
``--ring-tp`` and ``--ef-bits``.  This process keeps one JAX device, so
the reference runs here only on its one-device meshes, as its own
``tests/test_collectives.py`` does; the multi-shard cases are held to the
dense numpy product, as the reference's ``collectives_property.py`` holds
its own, and the reference's ring TP and EP on four devices are cases of
``tests/test_torch_train.py``'s dump.

Tolerances: the one-shard collectives rtol 1e-5, atol 1e-6 (the
reference's); the multi-shard sweeps rtol 2e-4, atol 2e-5, pad rows
exactly zero and chunk bounds covering the axis exactly (the reference's
multi-device script); ``quantize_dequantize`` bitwise; ``ef_allreduce_mean``
on a (1, 1) mesh rtol 1e-6, atol 1e-7; the sharding specs equal; EP at
ep 1 rtol 1e-5, atol 1e-5 × max|·| (``moe_apply``'s); the ef step's loss
bitwise the plain step's and its parameters within rtol 5e-3, atol 5e-4
(the reference's ``tests/test_train.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro import configs as RC
from repro.dist import compress as rcompress
from repro.dist import make_mesh as rmake_mesh
from repro.dist import sharding as rsharding
from repro.dist.collectives import (matmul_reducescatter as r_rs,
                                    pipelined_all_to_all as r_a2a,
                                    ring_allgather_matmul as r_ag)
from repro.launch import mesh as rlmesh
from repro.models import encdec as RE
from repro.models import moe as RM
from repro.models import transformer as RT

from repro_torch import configs as TC
from repro_torch.dist import (P, VirtualMesh, ef_allreduce_mean,
                              ef_state_init, flat_ring_mesh, make_mesh,
                              matmul_reducescatter, pipelined_all_to_all,
                              quantize_dequantize, ring_allgather_matmul,
                              ring_order)
from repro_torch.dist import sharding as tsharding
from repro_torch.dist.sharding import MeshSharding
from repro_torch.launch import mesh as tlmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.testing.hypo import given, settings, strategies as st
from repro_torch.train import AdamWConfig, adamw_init, make_train_step
from repro_torch.train.tree import tree_leaves

from test_torch_lm_train import _batch, _port_params, _ref_params

# six test workers share the host's cores: a few torch threads a worker
torch.set_num_threads(2)

CPU = "cpu"
N_DEVS = (2, 4, 8)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _r1(body, in_specs, out_specs=RP("ring")):
    """The reference's collective on its one-device ring, jitted."""
    return jax.jit(jax.shard_map(body, mesh=rmake_mesh((1,), ("ring",)),
                                 in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


# ---------------------------------------------------------------------------
# the mesh

def test_virtual_mesh_is_the_reference_meshs_shape_and_stacks_shards():
    mesh = make_mesh((2, 4), ("data", "model"), device=CPU)
    ref = rmake_mesh((1, 1), ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 4}
    assert tuple(mesh.shape) == ref.axis_names == mesh.axis_names
    assert mesh.devices_shape == (2, 4) and mesh.size == 8
    assert mesh.axis("model") == 1 and flat_ring_mesh(3, CPU).shape == \
        {"ring": 3}
    with pytest.raises(ValueError, match="axis_names"):
        VirtualMesh((2, 2), ("data",), CPU)
    # no oversubscription error: a virtual mesh has no device count
    assert VirtualMesh((64,), ("ring",), CPU).size == 64
    devs = [torch.device("cuda", i) for i in (2, 0, 1)]
    assert [d.index for d in ring_order(devs)] == [0, 1, 2]
    # a rotation along one axis: shard (d, j)'s block lands at (d, j + 1)
    x = torch.arange(8.0).reshape(2, 4, 1)
    y, tok = mesh.permute(x, "model")
    mesh.wait(tok)
    assert tok is None and torch.equal(y[:, 1:], x[:, :-1]) \
        and torch.equal(y[:, 0], x[:, -1])
    back, _ = mesh.permute(y, "model", back=True)
    assert torch.equal(back, x)


def test_virtual_mesh_on_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VirtualMesh((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlmesh.make_production_mesh()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_match_the_reference(multi_pod):
    mesh = tlmesh.make_production_mesh(multi_pod=multi_pod, device=CPU)
    shape = rlmesh.MULTI_POD_SHAPE if multi_pod else rlmesh.SINGLE_POD_SHAPE
    assert mesh.devices_shape == shape
    assert tlmesh.data_axes(multi_pod) == rlmesh.data_axes(multi_pod)
    assert set(tlmesh.data_axes(multi_pod)) | {"model"} == \
        set(mesh.axis_names)


def test_dist_ctx_has_the_references_fields():
    got = {f.name: f.default for f in dataclasses.fields(TT.DistCtx)}
    want = {f.name: f.default for f in dataclasses.fields(RT.DistCtx)}
    assert got == want
    for seq in (True, False):
        ctx = TT.DistCtx(seq_shard_acts=seq)
        assert tuple(ctx.act_spec()) == tuple(
            RT.DistCtx(seq_shard_acts=seq).act_spec())
        h = torch.ones(2, 3)
        assert ctx.constrain(h, ctx.act_spec()) is h


# ---------------------------------------------------------------------------
# the collectives on one shard, against the reference's

@given(st.integers(1, 48), st.integers(1, 33), st.integers(1, 17),
       st.integers(0, 999))
@settings(max_examples=25, deadline=None)
def test_allgather_matmul_degenerate_ring(m, k, p, seed):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=(m, k)), rng.normal(size=(k, p))
    got = ring_allgather_matmul(_t(a)[None], _t(b), flat_ring_mesh(1, CPU),
                                "ring")[0]
    np.testing.assert_allclose(got.numpy(), _t(a).numpy() @ _t(b).numpy(),
                               rtol=1e-5, atol=1e-6)


@given(st.integers(1, 48), st.integers(1, 33), st.integers(1, 17),
       st.integers(0, 999))
@settings(max_examples=25, deadline=None)
def test_reducescatter_degenerate_ring(m, k, p, seed):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=(m, k)), rng.normal(size=(k, p))
    got = matmul_reducescatter(_t(a)[None], _t(b)[None],
                               flat_ring_mesh(1, CPU), "ring")[0]
    np.testing.assert_allclose(got.numpy(), _t(a).numpy() @ _t(b).numpy(),
                               rtol=1e-5, atol=1e-6)


@given(st.integers(1, 24), st.integers(1, 19), st.integers(1, 10),
       st.integers(0, 999))
@settings(max_examples=25, deadline=None)
def test_all_to_all_degenerate_ring(rows, width, chunks, seed):
    """chunks > width and chunks ∤ width both reduce to chunked fn."""
    z = np.random.default_rng(seed).normal(size=(rows, width))
    got = pipelined_all_to_all(
        _t(z)[None], flat_ring_mesh(1, CPU), "ring", lambda c: c * c,
        split_axis=0, concat_axis=1, chunk_axis=1, chunks=chunks)[0]
    np.testing.assert_allclose(got.numpy(), _t(z).numpy() ** 2, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("m,k,p", [(7, 5, 3), (16, 33, 17)])
def test_one_shard_collectives_match_the_reference(m, k, p):
    rng = np.random.default_rng(m)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, p)).astype(np.float32)
    mesh = flat_ring_mesh(1, CPU)
    want = _r1(lambda x, w: r_ag(x, w, "ring"), (RP("ring"), RP()))(a, b)
    got = ring_allgather_matmul(_t(a)[None], _t(b), mesh, "ring")[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    want = _r1(lambda x, w: r_rs(x, w, "ring"),
               (RP(None, "ring"), RP("ring", None)))(a, b)
    got = matmul_reducescatter(_t(a)[None], _t(b)[None], mesh, "ring")[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    want = _r1(lambda x: r_a2a(x, "ring", lambda c: 2.0 * c + 1.0,
                               split_axis=0, concat_axis=1, chunk_axis=1,
                               chunks=3), (RP("ring"),))(a)
    got = pipelined_all_to_all(_t(a)[None], mesh, "ring",
                               lambda c: 2.0 * c + 1.0, split_axis=0,
                               concat_axis=1, chunk_axis=1, chunks=3)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_all_to_all_empty_chunk_axis():
    """Zero-extent chunk axis: no pieces to pipeline, fn still applies."""
    for n in (1, 2):
        got = pipelined_all_to_all(
            torch.zeros(n, 4, 0), flat_ring_mesh(n, CPU), "ring",
            lambda c: c + 1.0, split_axis=0, concat_axis=1, chunk_axis=1,
            chunks=3)
        assert got.shape == (n, 4, 0)


def test_all_to_all_chunk_boundaries_cover_axis():
    """Uneven chunking must partition the axis exactly (no drop/overlap),
    on one shard and on four."""
    z = torch.arange(21.0).reshape(1, 1, 21)
    got = pipelined_all_to_all(z, flat_ring_mesh(1, CPU), "ring",
                               lambda c: c + 1.0, split_axis=0,
                               concat_axis=1, chunk_axis=1, chunks=4)
    assert torch.equal(got, z + 1.0)
    z = torch.arange(4 * 4 * 21.0).reshape(4, 4, 21)
    seen = []
    got = pipelined_all_to_all(
        z, flat_ring_mesh(4, CPU), "ring",
        lambda c: seen.append(c.shape[-1]) or c + 1.0, split_axis=0,
        concat_axis=1, chunk_axis=1, chunks=4)
    assert torch.equal(got, z + 1.0) and seen == [5 * 4, 5 * 4, 5 * 4,
                                                  6 * 4]


def test_all_to_all_rejects_a_split_dim_the_axis_does_not_divide():
    with pytest.raises(ValueError, match="not divisible by axis 'ring'"):
        pipelined_all_to_all(torch.zeros(2, 3, 4), flat_ring_mesh(2, CPU),
                             "ring", lambda c: c, split_axis=0,
                             concat_axis=1, chunk_axis=1, chunks=2)


# ---------------------------------------------------------------------------
# the collectives over 2, 4 and 8 shards, against dense products

def _mesh(n, two_d):
    """A ring of ``n`` shards, alone or as the model axis of a (2, n)
    mesh (each data shard then runs its own ring)."""
    return (make_mesh((2, n), ("data", "x"), device=CPU) if two_d
            else make_mesh((n,), ("x",), device=CPU))


@given(st.sampled_from(N_DEVS), st.booleans(), st.integers(1, 6),
       st.integers(1, 37), st.integers(1, 19), st.integers(0, 99))
@settings(max_examples=30, deadline=None)
def test_allgather_matmul_property(n, two_d, m_local, k, p, seed):
    """Every shard holds gather(A) @ B of its ring (k, p arbitrary)."""
    mesh = _mesh(n, two_d)
    rng = np.random.default_rng(seed)
    lead = mesh.devices_shape
    a = rng.normal(size=lead + (m_local, k)).astype(np.float32)
    b = rng.normal(size=(k, p)).astype(np.float32)
    out = ring_allgather_matmul(_t(a), _t(b), mesh, "x").numpy()
    rings = a.reshape((-1, n, m_local, k))
    for r, ring in enumerate(rings):
        want = ring.reshape(n * m_local, k) @ b
        for dev in range(n):
            got = out.reshape((-1, n) + out.shape[-2:])[r, dev]
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@given(st.sampled_from(N_DEVS), st.booleans(), st.integers(1, 40),
       st.integers(1, 4), st.integers(1, 11), st.integers(0, 99))
@settings(max_examples=30, deadline=None)
def test_matmul_reducescatter_property(n, two_d, m, k_local, p, seed):
    """Scattered row blocks of sum_k(A_k @ B_k); m not necessarily
    divisible by n (rows zero-pad to n·ceil(m/n))."""
    mesh = _mesh(n, two_d)
    rng = np.random.default_rng(seed)
    lead = mesh.devices_shape
    a = rng.normal(size=lead + (m, k_local)).astype(np.float32)
    b = rng.normal(size=lead + (k_local, p)).astype(np.float32)
    out = matmul_reducescatter(_t(a), _t(b), mesh, "x").numpy()
    out = out.reshape((-1, n) + out.shape[-2:])
    a, b = a.reshape((-1, n, m, k_local)), b.reshape((-1, n, k_local, p))
    for r in range(a.shape[0]):
        want = np.concatenate(list(a[r]), 1) @ np.concatenate(list(b[r]), 0)
        got = np.concatenate(list(out[r]), 0)          # (n·ceil(m/n), p)
        np.testing.assert_allclose(got[:m], want, rtol=2e-4, atol=2e-5)
        assert np.abs(got[m:]).max(initial=0.0) == 0.0   # pad rows zero


@given(st.sampled_from(N_DEVS), st.integers(1, 3), st.integers(1, 23),
       st.integers(1, 8), st.integers(1, 3), st.integers(0, 99))
@settings(max_examples=30, deadline=None)
def test_pipelined_all_to_all_property(n, rows, width, chunks, depth, seed):
    """a2a → fn → inverse a2a == fn elementwise, any chunk count; and one
    exchange is the tiled ``all_to_all``: shard j's block i along the
    concat axis is shard i's piece j along the split axis."""
    mesh = _mesh(n, False)
    z = _t(np.random.default_rng(seed).normal(
        size=(n, n * rows, width, depth)))
    got = pipelined_all_to_all(z, mesh, "x", lambda c: 2.0 * c + 1.0,
                               split_axis=0, concat_axis=1, chunk_axis=1,
                               chunks=chunks)
    np.testing.assert_allclose(got.numpy(), 2.0 * z.numpy() + 1.0,
                               rtol=1e-6, atol=1e-6)
    y, _ = mesh.all_to_all(z, "x", 0, 1)
    for i in range(n):
        for j in range(n):
            assert torch.equal(y[j, :, i * width:(i + 1) * width],
                               z[i, j * rows:(j + 1) * rows])


def test_collectives_backward_is_the_transposed_transfer():
    """Gradients through the rotations and exchanges equal those of the
    dense products they compute (autograd of the plain function)."""
    mesh = make_mesh((2, 4), ("data", "x"), device=CPU)
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 4, 3, 5, generator=g, requires_grad=True)
    b = torch.randn(5, 6, generator=g, requires_grad=True)
    out = ring_allgather_matmul(a, b, mesh, "x")
    cot = torch.randn(out.shape, generator=g)
    ga, gb = torch.autograd.grad((out * cot).sum(), (a, b))
    dense = (a.reshape(2, 12, 5) @ b)[:, None].expand(2, 4, 12, 6)
    wa, wb = torch.autograd.grad((dense * cot).sum(), (a, b))
    torch.testing.assert_close(ga, wa, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gb, wb, rtol=1e-5, atol=1e-5)
    z = torch.randn(2, 4, 8, 3, generator=g, requires_grad=True)
    out = pipelined_all_to_all(z, mesh, "x", lambda c: c * c, split_axis=0,
                               concat_axis=1, chunk_axis=1, chunks=2)
    (gz,) = torch.autograd.grad((out * cot[..., :3, :3].sum()).sum(), z)
    torch.testing.assert_close(gz, 2 * z.detach() * cot[..., :3, :3].sum(),
                               rtol=1e-5, atol=1e-5)


def test_a_mesh_first_used_under_inference_mode_still_trains():
    """The mesh's ring indices are made once, on first use: made under
    ``inference_mode`` (a forward) they must still serve a later
    training step's backward."""
    mesh = make_mesh((2, 2), ("data", "x"), device=CPU)
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(2, 2, 3, 4, generator=g), torch.randn(4, 5,
                                                             generator=g)
    with torch.inference_mode():
        first = ring_allgather_matmul(a, b, mesh, "x")
        matmul_reducescatter(a, b[:, :4], mesh, "x")
    a.requires_grad_(True)
    out = ring_allgather_matmul(a, b, mesh, "x")
    (ga,) = torch.autograd.grad(out.sum(), a)
    assert torch.equal(out.detach(), first) and torch.isfinite(ga).all()
    out = matmul_reducescatter(a, b[:, :4], mesh, "x")
    (ga,) = torch.autograd.grad(out.sum(), a)
    assert torch.isfinite(ga).all()


# ---------------------------------------------------------------------------
# compression

@given(st.integers(1, 30), st.integers(1, 12), st.integers(2, 16),
       st.integers(0, 999))
@settings(max_examples=60, deadline=None)
def test_quantize_dequantize_is_the_references_bitwise(rows, cols, bits,
                                                       seed):
    v = np.random.default_rng(seed).normal(size=(rows, cols)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda x: rcompress.quantize_dequantize(
        x, bits=bits))(v))
    got = quantize_dequantize(torch.from_numpy(v), bits=bits).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    step = float(np.abs(v).max()) / (2 ** (bits - 1) - 1)
    assert float(np.abs(v - got).max()) <= 0.5 * step + 1e-7
    assert np.array_equal(quantize_dequantize(torch.zeros(3)).numpy(),
                          np.zeros(3, np.float32))


def test_ef_allreduce_mean_matches_the_reference_on_one_shard():
    """On a (1, 1) mesh the mean is the identity on the compressed value
    and the residual carries the quantization error; both equal the
    reference's, and the carry telescopes over 8 steps."""
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(8, 5)).astype(np.float32),
         "b": {"c": rng.normal(size=(16, 6)).astype(np.float32)}}
    rmesh = rmake_mesh((1, 1), ("data", "model"))
    tmesh = make_mesh((1, 1), ("data", "model"), device=CPU)
    rspecs = jax.tree.map(lambda _: RP(), g)
    tg = jax.tree.map(torch.from_numpy, g)
    rerr, terr = rcompress.ef_state_init(g), ef_state_init(tg)
    assert all(float(e.abs().max()) == 0.0 for e in tree_leaves(terr))
    acc = {k: 0.0 for k in ("a", "c")}
    for _ in range(8):
        rmean, rerr = rcompress.ef_allreduce_mean(g, rerr, rmesh, ("data",),
                                                  rspecs)
        tmean, terr = ef_allreduce_mean(tg, terr, tmesh, ("data",),
                                        {"a": P(), "b": {"c": P()}})
        for got, want in ((tmean, rmean), (terr, rerr)):
            for x, y in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=1e-6, atol=1e-7)
        acc["a"] = acc["a"] + tmean["a"].numpy()
        acc["c"] = acc["c"] + tmean["b"]["c"].numpy()
    for k, v in (("a", g["a"]), ("c", g["b"]["c"])):
        assert np.abs(acc[k] / 8 - v).max() / np.abs(v).max() < 0.02


@given(st.sampled_from(N_DEVS), st.integers(1, 16), st.integers(1, 9),
       st.integers(0, 99))
@settings(max_examples=10, deadline=None)
def test_ef_allreduce_telescopes(n, rows, cols, seed):
    """Error feedback over n data shards: accumulated compressed means
    converge to the accumulated true mean, as the reference's multi-device
    property; a leaf sharded over the axis averages its blocks."""
    mesh = make_mesh((n,), ("x",), device=CPU)
    g = {"w": _t(np.random.default_rng(seed).normal(size=(rows, cols)))}
    err = ef_state_init(g)
    acc = torch.zeros(rows, cols)
    for _ in range(8):
        mean, err = ef_allreduce_mean(g, err, mesh, ("x",), {"w": P()})
        acc += mean["w"]
    scale = max(float(g["w"].abs().max()), 1e-6)
    assert float((acc / 8 - g["w"]).abs().max()) / scale < 0.02
    v = _t(np.arange(n * 2 * 3).reshape(n * 2, 3))
    mean, _ = ef_allreduce_mean({"v": v}, ef_state_init({"v": v}), mesh,
                                ("x",), {"v": P("x")}, bits=16)
    blocks = quantize_dequantize(v, 16).reshape(n, 2, 3)
    want = (sum(blocks[i] for i in range(n)) / n).repeat(n, 1)
    assert torch.equal(mean["v"], want)


# ---------------------------------------------------------------------------
# sharding rules

def _specs(tree):
    """(path, spec) pairs of a spec tree, in JAX's leaf order, as tuples."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", s) for k in sorted(tree)
                for p, s in _specs(tree[k])]
    if isinstance(tree, (list,)) or (isinstance(tree, tuple)
                                     and not isinstance(tree, (P, RP))):
        return [(f"{i}/{p}", s) for i, v in enumerate(tree)
                for p, s in _specs(v)]
    if dataclasses.is_dataclass(tree):
        return [(f"{f.name}/{p}", s) for f in dataclasses.fields(tree)
                for p, s in _specs(getattr(tree, f.name))]
    return [("", tuple(tree))]


@pytest.fixture(scope="module")
def shape_trees():
    """Every arch's parameter tree as ``jax.eval_shape`` gives it (no
    allocation), and the decode cache of the non-encdec ones at B 128."""
    out = {}
    for arch in RC.ARCH_IDS:
        cfg = RC.get_config(arch)
        init = RE.init_params if cfg.family == "encdec" else RT.init_params
        params = jax.eval_shape(lambda k: init(k, cfg, vocab_multiple=16),
                                jax.random.key(0))
        cache = None if cfg.family == "encdec" else jax.eval_shape(
            lambda: RT.init_cache(cfg, 128, 4096))
        out[arch] = (cfg, params, cache)
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
def test_specs_equal_the_references_on_the_production_meshes(shape_trees,
                                                             multi_pod):
    """``param_specs`` (train and serve), ``cache_specs`` and
    ``batch_specs`` of every arch on the 16 x 16 and 2 x 16 x 16 meshes,
    fed the same shape trees (the mesh itself allocates nothing)."""
    mesh = tlmesh.make_production_mesh(multi_pod=multi_pod, device=CPU)
    axes = tlmesh.data_axes(multi_pod)
    for train in (True, False):
        rr = rsharding.ShardingRules(mesh, data_axes=axes, train=train)
        tr = tsharding.ShardingRules(mesh, data_axes=axes, train=train)
        for arch, (cfg, params, cache) in shape_trees.items():
            want = rsharding.param_specs(params, rr, cfg.expert_mode)
            got = tsharding.param_specs(params, tr, cfg.expert_mode)
            assert _specs(got) == _specs(want), (arch, train)
            if cache is not None and not train:
                assert _specs(tsharding.cache_specs(cache, tr, 128)) == \
                    _specs(rsharding.cache_specs(cache, rr, 128)), arch
        for b in (1, 16, 128):
            batch = {"tokens": jax.ShapeDtypeStruct((b, 64), jnp.int32),
                     "loss_mask": jax.ShapeDtypeStruct((b, 64), jnp.float32)}
            assert _specs(tsharding.batch_specs(batch, tr)) == \
                _specs(rsharding.batch_specs(batch, rr))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-125m",
                                  "zamba2-7b", "whisper-base"])
def test_param_specs_read_the_ports_own_tree(arch):
    """On the port's parameter tree (its leaf names are the reference's)
    and on its cache, the specs equal the reference's on its trees."""
    from repro_torch.models import encdec as TE
    cfg = TC.get_smoke_config(arch)
    rcfg = RC.get_smoke_config(arch)
    mesh = make_mesh((2, 4), ("data", "model"), device=CPU)
    tinit = TE.init_params if cfg.family == "encdec" else TT.init_params
    rinit = RE.init_params if cfg.family == "encdec" else RT.init_params
    params = tinit(torch.Generator().manual_seed(0), cfg, vocab_multiple=4)
    rparams = jax.eval_shape(lambda k: rinit(k, rcfg, vocab_multiple=4),
                             jax.random.key(0))
    for train in (True, False):
        tr = tsharding.ShardingRules(mesh, train=train)
        rr = rsharding.ShardingRules(mesh, train=train)
        assert _specs(tsharding.param_specs(params, tr, cfg.expert_mode)) \
            == _specs(rsharding.param_specs(rparams, rr, cfg.expert_mode))
    if cfg.family != "encdec":
        cache = TT.init_cache(cfg, 4, 16, device="meta")
        rcache = jax.eval_shape(lambda: RT.init_cache(rcfg, 4, 16))
        tr = tsharding.ShardingRules(mesh, train=False)
        rr = rsharding.ShardingRules(mesh, train=False)
        got = _specs(tsharding.cache_specs(cache, tr, 4))
        want = _specs(rsharding.cache_specs(rcache, rr, 4))
        assert [s for _, s in got] == [s for _, s in want]


def test_to_shardings_cut_and_join_the_mesh_blocks():
    """A spec's blocks: shard (d, j) of ``P("data", ("model",))`` holds rows
    block d and columns block j; an axis the spec does not name replicates
    (a stride-0 view); join inverts cut; an extent the axes do not divide
    raises."""
    mesh = make_mesh((2, 3), ("data", "model"), device=CPU)
    t = torch.arange(4 * 6.0).reshape(4, 6)
    specs = tsharding.to_shardings({"a": P("data", ("model",)),
                                    "b": P(None, "model"), "c": P()}, mesh)
    blocks = specs["a"].cut(t)
    assert blocks.shape == (2, 3, 2, 2)
    for d in range(2):
        for j in range(3):
            assert torch.equal(blocks[d, j], t[2 * d:2 * d + 2,
                                               2 * j:2 * j + 2])
    rep = specs["b"].cut(t)
    assert rep.shape == (2, 3, 4, 2) and rep.stride(0) == 0
    assert rep.data_ptr() == t.data_ptr()          # a view
    for sh in specs.values():
        assert torch.equal(sh.join(sh.cut(t)), t)
    with pytest.raises(ValueError, match="does not divide"):
        MeshSharding(mesh, P("model")).cut(torch.zeros(4, 2))


# ---------------------------------------------------------------------------
# the expert-parallel MoE at ep 1, the ef step and the launcher

def test_ep_shard_single_device_equals_tp_path():
    """EP on a (1, 1) mesh against ``moe_apply`` (the reference's
    ``tests/test_moe.py``) and against the reference's EP, chunks 1, 2,
    4."""
    from test_torch_moe import GRANITE, _assert_gap, _cfgs, _moe_params
    rcfg, tcfg = _cfgs(GRANITE)
    rp = _moe_params(rcfg, 2)
    tp = _port_params(rp)
    x = np.random.default_rng(4).normal(size=(2, 8, rcfg.d_model)).astype(
        np.float32)
    _assert_gap(x.reshape(16, -1), rp["router"]["w"], rcfg.top_k)
    rmesh = rmake_mesh((1, 1), ("data", "model"))
    tmesh = make_mesh((1, 1), ("data", "model"), device=CPU)
    want = TM.moe_apply(tp, _t(x), tcfg, capacity_factor=1.25).numpy()
    for chunks in (1, 2, 4):
        ref = np.asarray(jax.jit(lambda p, x, c=chunks: RM.moe_apply_ep_shard(
            p, x, rcfg, rmesh, pipeline_chunks=c))(rp, x))
        got = TM.moe_apply_ep_shard(tp, _t(x), tcfg, tmesh,
                                    pipeline_chunks=chunks).numpy()
        for other in (want, ref):
            np.testing.assert_allclose(
                got, other, rtol=1e-5,
                atol=1e-5 * float(np.abs(other).max()))


def test_ef_compressed_step_tracks_uncompressed():
    """ef_bits=8 on a (1, 1) mesh: the loss bitwise the plain step's (the
    forward is untouched), a live residual, the parameters within rtol
    5e-3, atol 5e-4 of the plain step's; and the loss the reference's."""
    from repro.train import AdamWConfig as RAdamWConfig
    from repro.train import adamw_init as radamw_init
    from repro.train import make_train_step as rmake_train_step

    rcfg = RC.get_smoke_config("codeqwen1.5-7b")
    cfg = TC.get_smoke_config("codeqwen1.5-7b")
    rparams = _ref_params(rcfg)
    params = _port_params(rparams)
    ctx = TT.DistCtx(mesh=make_mesh((1, 1), ("data", "model"), device=CPU))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 8, 24).items()}
    p1, _, m1 = make_train_step(cfg, ctx, AdamWConfig(lr=1e-3))(
        params, adamw_init(params), b)
    state = (adamw_init(params), ef_state_init(params))
    p2, (_, err), m2 = make_train_step(cfg, ctx, AdamWConfig(lr=1e-3),
                                       ef_bits=8)(params, state, b)
    assert torch.equal(m1["loss"], m2["loss"])
    assert max(float(e.abs().max()) for e in tree_leaves(err)) > 0
    for a, c in zip(tree_leaves(p2), tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=5e-3,
                                   atol=5e-4)
    rmesh = rmake_mesh((1, 1), ("data", "model"))
    rstep = jax.jit(rmake_train_step(rcfg, RT.DistCtx(mesh=rmesh),
                                     RAdamWConfig(lr=1e-3), ef_bits=8))
    rstate = (radamw_init(rparams), rcompress.ef_state_init(rparams))
    _, _, rm = rstep(rparams, rstate, {k: jnp.asarray(v.numpy())
                                       for k, v in b.items()})
    np.testing.assert_allclose(float(m2["loss"]), float(rm["loss"]),
                               rtol=2e-4)


def test_ef_requires_pure_dp_mesh():
    cfg = TC.get_smoke_config("codeqwen1.5-7b")
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(cfg, TT.DistCtx(), AdamWConfig(), ef_bits=8)
    with pytest.raises(ValueError, match="pure-DP"):
        make_train_step(cfg, TT.DistCtx(mesh=make_mesh(
            (1, 2), ("data", "model"), device=CPU)), AdamWConfig(),
            ef_bits=8)


def test_launcher_devices_ring_tp_and_ef_bits_on_cpu(capsys):
    """``--devices 4 --ef-bits 8 --ring-tp --moe-pipeline-chunks 4``: ef on
    a pure-DP mesh, EP at ep 1, ring TP falling back on a model axis of 1;
    its loss at step 0 bitwise the same launcher's without ``--ef-bits``,
    its residual live; ``--ef-bits`` without a mesh says it is ignored."""
    base = ["--device", CPU, "--arch", "granite-moe-1b-a400m", "--smoke",
            "--seq", "16", "--batch", "8", "--devices", "4", "--ring-tp",
            "--moe-pipeline-chunks", "4"]
    ef = ttrain.main(base + ["--steps", "3", "--ef-bits", "8"])
    plain = ttrain.main(base + ["--steps", "1"])
    assert ef["devices"] == 4 and ef["losses"][0] == plain["losses"][0]
    assert all(np.isfinite(ef["losses"]))
    _, err = ef["state"].opt_state
    assert max(float(e.abs().max()) for e in tree_leaves(err)) > 0
    one = ttrain.main(["--device", CPU, "--arch", "codeqwen1.5-7b",
                       "--smoke", "--steps", "1", "--seq", "16", "--batch",
                       "2", "--ef-bits", "8", "--devices", "1"])
    assert one["devices"] == 1
    assert "--ef-bits ignored: single-device run" in capsys.readouterr().out
