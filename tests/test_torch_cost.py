"""repro_torch's dry-run tooling against the reference's.

``launch/op_cost.py`` counts the aten operations a callable dispatches;
the reference's ``launch/hlo_cost.py`` counts the dots of a compiled HLO,
each loop multiplied by its trip count.  On ``tests/test_hlo_cost.py``'s
three functions (a scan, a nested scan, the gradient of a rematerialized
scan), written as the loops the port runs, the two dot-flop counts are
equal; so are they on three smoke-config cells on one shard (a dense train
step, an xlstm decode step, a whisper prefill), the reference's jitted
cell against the port's on a meta mesh.  ``launch/cells.py`` has the
reference's cells, skips and input shapes; each rule of
``dist/implied.py`` gives the bytes stated on a hand-built op; the GNN
dry run's rotations equal ``collective_bytes``; the kernels' work
functions (``kernels/cost.py``) equal the counts ``chip_smoke.py``
computed inline, and printed on an H100, before they existed; and the
meta route is reached from nothing but a meta tensor.  No XLA subprocess: the
reference compiles in process on one CPU device.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as rconfigs
from repro.dist import make_mesh as r_make_mesh
from repro.launch import cells as rcells
from repro.launch.hlo_cost import analyze as hlo_analyze

import repro_torch.core as TC
from repro_torch import configs as tconfigs
from repro_torch.dist import implied
from repro_torch.dist import VirtualRing, resolve_device
from repro_torch.dist.mesh import VirtualMesh
from repro_torch.kernels import cost, ops
from repro_torch.launch import cells as tcells
from repro_torch.launch import dryrun, dryrun_gnn
from repro_torch.launch.op_cost import analyze
from repro_torch.models import transformer as RT_port

# six test workers share the host's cores: a few torch threads a worker
torch.set_num_threads(2)

META = torch.device("meta")


def _hlo(fn, *args):
    return hlo_analyze(jax.jit(fn).lower(*args).compile().as_text())


# -- the oracle functions -----------------------------------------------------

def test_scan_counts_the_reference_dots():
    d, L = 64, 8
    ref = _hlo(lambda x, w: lax.scan(lambda h, wl: (h @ wl, None), x, w)[0],
               jnp.ones((d, d)), jnp.ones((L, d, d)))

    def loop(x, w):
        for i in range(L):
            x = x @ w[i]
        return x

    got = analyze(loop, torch.ones((d, d), device=META),
                  torch.ones((L, d, d), device=META))
    assert got.dot_flops == ref.dot_flops == L * 2 * d ** 3
    assert got.while_trips == {} and list(ref.while_trips.values()) == [L]


def test_nested_scan_counts_the_reference_dots():
    d, L1, L2 = 32, 3, 5

    def fn(x, w):
        def outer(h, wg):
            return lax.scan(lambda h, wl: (h @ wl, None), h, wg)[0], None
        return lax.scan(outer, x, w)[0]

    ref = _hlo(fn, jnp.ones((d, d)), jnp.ones((L1, L2, d, d)))

    def loop(x, w):
        for i in range(L1):
            for j in range(L2):
                x = x @ w[i, j]
        return x

    got = analyze(loop, torch.ones((d, d), device=META),
                  torch.ones((L1, L2, d, d), device=META))
    assert got.dot_flops == ref.dot_flops == L1 * L2 * 2 * d ** 3


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_remat_grad_counts_the_reference_dots(device):
    """The gradient of a checkpointed scan: the forward, and each layer's
    two backward products (XLA keeps the first layer's input gradient, as
    the loop computes it for an input that needs one); the recompute the
    checkpoint asks for is no product, since a product's backward reads
    only its inputs, which the checkpoint kept — 3 products a layer on
    both sides, on meta and live on the CPU alike."""
    from torch.utils.checkpoint import checkpoint

    d, L = 32, 4

    def loss(x, w):
        body = jax.checkpoint(lambda h, wl: (h @ wl, None))
        return lax.scan(body, x, w)[0].sum()

    ref = _hlo(lambda x, w: jax.grad(loss, argnums=1)(x, w),
               jnp.ones((d, d)), jnp.ones((L, d, d)))

    def grad(x, w):
        x = x.detach().requires_grad_(True)
        w = w.detach().requires_grad_(True)
        h = x
        for i in range(L):
            h = checkpoint(lambda h, wl: h @ wl, h, w[i],
                           use_reentrant=False)
        h.sum().backward()
        return w.grad

    got = analyze(grad, torch.ones((d, d), device=device),
                  torch.ones((L, d, d), device=device))
    assert got.dot_flops == ref.dot_flops == 3 * L * 2 * d ** 3


# -- the cells ----------------------------------------------------------------

def test_all_cells_are_the_reference_cells():
    r_run, r_skip = rcells.all_cells()
    t_run, t_skip = tcells.all_cells()
    assert t_run == r_run and t_skip == r_skip
    assert (len(t_run), len(t_skip)) == (33, 7)


def test_input_specs_have_the_reference_shapes_on_every_cell():
    n = 0
    for arch in tconfigs.ARCH_IDS:
        for name in tconfigs.SHAPES:
            want = rcells.input_specs(rconfigs.get_config(arch),
                                      rconfigs.SHAPES[name])
            got = tcells.input_specs(tconfigs.get_config(arch),
                                     tconfigs.SHAPES[name])
            assert sorted(got) == sorted(want), (arch, name)
            for k, w in want.items():
                assert tuple(got[k].shape) == tuple(w.shape), (arch, name, k)
                assert str(got[k].dtype) == f"torch.{w.dtype}", (arch, k)
                assert got[k].device == META
            n += 1
    assert n == 40


# -- smoke cells on one shard against the reference's HLO ---------------------

SMOKE_CELLS = [("codeqwen1.5-7b", "train_4k"), ("xlstm-125m", "decode_32k"),
               ("whisper-base", "prefill_32k")]


@pytest.fixture
def smoke_configs(monkeypatch):
    """Both packages' cell builders on the smoke configs."""
    monkeypatch.setattr(rcells.configs, "get_config",
                        rconfigs.get_smoke_config)
    monkeypatch.setattr(tcells.configs, "get_config",
                        tconfigs.get_smoke_config)


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS)
def test_smoke_cell_dot_flops_equal_the_reference(smoke_configs, arch,
                                                  shape):
    """The reference's trip-multiplied dot flops of its jitted cell and
    the port's counted flops (its products and K8's records) of the same
    cell on a one-shard meta mesh agree exactly."""
    mesh = r_make_mesh((1, 1), ("data", "model"))
    cell = rcells.build_cell(arch, shape, mesh)
    with mesh:
        compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                           donate_argnums=cell.donate_argnums).lower(
            *cell.args).compile()
    ref = hlo_analyze(compiled.as_text())
    got = dryrun.run_cell(arch, shape, False,
                          mesh=VirtualMesh((1, 1), ("data", "model"), META))
    assert ref.dot_flops > 0
    assert got["flops"] == ref.dot_flops
    assert got["n_chips"] == 1 and got["collectives"]["while_trips"] == {}


# -- implied collectives: the rules on hand-built ops -------------------------
#
# Each case runs one site of dist/implied.py on meta tensors under a
# counter, on a (data 2, model 2) meta mesh unless stated; the bytes are a
# device's, fp32 width (the reference's CPU HLO carries bf16 as fp32).
# tests/test_torch_collectives.py and tests/test_torch_serve.py hold whole
# cells against the reference's partitioned HLO.

def _ctx(shape=(2, 2), **kw):
    return RT_port.DistCtx(mesh=VirtualMesh(shape, ("data", "model"), META),
                           **kw)


def _implied(fn, *args, **kw):
    with cost.counting() as c:
        out = fn(*args, **kw)
    return c.implied, out


def _meta(*shape, grad=False):
    return torch.empty(shape, device=META, requires_grad=grad)


def test_implied_kv_gathered_over_the_sequence():
    """Keys and values (B 8, T 4096, KV 4, hd 16) cut on batch over data
    and on the sequence over model, scanned in 1024-row chunks: each is
    gathered whole, 4 batch rows · 2048 · 4 · 16 · 4 B = 2 MiB a device."""
    q, k, v = _meta(8, 4096, 4, 16), _meta(8, 4096, 4, 16), \
        _meta(8, 4096, 4, 16)
    got, _ = _implied(implied.attention, _ctx(), q, k, v, 1024)
    assert got == {"all-gather": dict(bytes=2 * 2 ** 21, count=2)}


def test_implied_halo_before_padding_to_whole_chunks():
    """T 1500 on model 2 (750 rows a device) padded to 2048 (1024 a
    device): each of K and V first takes a 274-row halo from its
    neighbour (4 · 274 · 4 · 16 · 4 B), then is gathered (4 · 1024 rows);
    on model 4 (375 rows, 512 padded) the 411-row halo takes two hops,
    375 and 36 rows, and the 2 chunks split the 4 shards 2 × 2, so every
    chunk is gathered again at both products (4 · 512 · 4 · 16 · 4 B)."""
    q, k = _meta(8, 1500, 4, 16), _meta(8, 1500, 4, 16)
    got, _ = _implied(implied.attention, _ctx(), q, k, k, 1024)
    row = 4 * 16 * 4
    assert got == {"collective-permute": dict(bytes=2 * 4 * 274 * row,
                                              count=2),
                   "all-gather": dict(bytes=2 * 4 * 1024 * row, count=2)}
    got, _ = _implied(implied.attention, _ctx((1, 4)), q, k, k, 1024)
    assert got == {
        "collective-permute": dict(bytes=2 * 8 * (375 + 36) * row, count=4),
        "all-gather": dict(bytes=2 * 8 * 512 * row * 3, count=6)}


def test_implied_partial_sums_over_the_cut_queries():
    """The backward of the products over a key chunk contracts the
    queries' sequence, cut on model: each chunk's key and value gradients
    (4 batch rows, H 2, 1024 keys, hd 8) are partial sums, reduced once a
    chunk, 2 · 4 · 2 · 1024 · 8 · 4 B; the forward gathered K and V."""
    q, k, v = _meta(8, 2048, 2, 8, grad=True), \
        _meta(8, 2048, 1, 8, grad=True), _meta(8, 2048, 1, 8, grad=True)
    with cost.counting() as c:
        k2, v2 = implied.attention(_ctx(), q, k, v, 1024)
        assert c.implied == {"all-gather": dict(bytes=2 * 4 * 1024 * 32,
                                                count=2)}
        k2.sum().backward()
    assert c.implied["all-reduce"] == dict(bytes=2 * 2 * 4 * 2 * 1024 * 8
                                           * 4, count=2)


def test_implied_labels_shift_across_the_sequence_cut():
    """The next-token loss on a sequence-cut stream: the labels and the
    mask shift one position across the cut, 4 batch rows · 4 B each; in
    the backward the gathered log-probabilities' int32 indices come back
    over data (4 · 64 · 4 B) and over model (4 · 32 · 4 B)."""
    tokens = torch.empty((8, 64), dtype=torch.int32, device=META)
    logits = _meta(8, 64, 128, grad=True)
    with cost.counting() as c:
        out = implied.loss(_ctx(), tokens, logits, True)
        assert c.implied == {"collective-permute": dict(bytes=2 * 4 * 4,
                                                        count=2)}
        out.sum().backward()
    assert c.implied["all-gather"] == dict(bytes=4 * 64 * 4 + 4 * 32 * 4,
                                           count=2)


def test_implied_cache_reshard_from_sequence_to_heads():
    """Prefill writes K and V (B 8, S 4096, KV 4, hd 16), cut on the
    sequence, into a cache cut on batch and KV heads: the new rows are
    gathered over data (4 · 2048 · 4 · 16 · 4 B each), re-cut from the
    sequence to the heads with all-to-all over the whole batch
    (8 · 2048 · 4 · 16 · 4 B each), and the scatter's (row, slot) int32
    pairs are gathered (8 · 2048 · 8 B; 4 · 2048 · 8 B) and permuted
    (4 · 2048 · 8 B)."""
    got, _ = _implied(implied.prefill_cache, _ctx(), _meta(8, 4096, 4, 16))
    row = 4 * 16 * 4
    assert got == {
        "all-gather": dict(bytes=2 * 4 * 2048 * row + 8 * 2048 * 8
                           + 4 * 2048 * 8, count=4),
        "all-to-all": dict(bytes=2 * 8 * 2048 * row, count=2),
        "collective-permute": dict(bytes=4 * 2048 * 8, count=1)}


@pytest.mark.parametrize("d", [64, 1024])
def test_implied_decode_moves_the_smaller_operand(d):
    """A decode layer (B 128: 64 rows a device; H = KV = 4): at d 64 a
    model shard of wq (64 · 32 · 4 B) is smaller than the 64 rows it
    would reduce (64 · 64 · 4 B), so the weights are gathered (wq, wk,
    wv: 8 KiB each; gate, up, down: 12 KiB each), q, k and v re-cut to
    the cache's heads (16 KiB each), wo's output and the two norms
    reduced; at d 1024 the shard (2 MiB) is the larger, so the weights
    stay cut and wo's and the MLP's outputs are reduced (256 KiB each).
    Both gather the new keys and values over data for the cache."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("codeqwen1.5-7b"),
                              d_model=d, head_dim=d // 4, d_ff=3 * d // 2)
    bp = RT_port._dense_block_init(torch.Generator(), cfg, None, META)
    got, _ = _implied(implied.decode_block, _ctx(), bp, _meta(128, 1, d),
                      cfg)
    cache = 2 * 64 * d // 2 * 4             # K and V, 2 of 4 heads a shard
    if d == 64:
        assert got == {
            "all-gather": dict(bytes=3 * 8192 + 3 * 12288 + cache + 512,
                               count=9),
            "all-to-all": dict(bytes=3 * 16384, count=3),
            "all-reduce": dict(bytes=16384 + 2 * 256, count=3)}
    else:
        assert got == {"all-gather": dict(bytes=cache, count=2),
                       "all-reduce": dict(bytes=2 * 64 * d * 4, count=2)}


def test_implied_fsdp_gathers_and_gradient_reductions():
    """A train step's parameters on (data 2, model 2): a stacked column-
    parallel weight (2 layers of 64 × 64, fp32, 32 KiB, cut (data, model))
    is gathered over the model axis (8 KiB) and then over data (16 KiB),
    in the forward and the backward's recompute; the embedding (128 × 64,
    cut (model, data)) once; each gradient (32 KiB) is all-reduced over
    the model axis and over data."""
    cfg = tconfigs.get_smoke_config("codeqwen1.5-7b")
    params = {"blocks": {"attn": {"wq": {"w": _meta(2, 64, 64)}}},
              "embed": {"w": _meta(128, 64)}}
    got, _ = _implied(implied.train_params, _ctx(), params, cfg)
    assert got == {"all-gather": dict(bytes=2 * (8192 + 16384) + 8192
                                      + 16384, count=6),
                   "all-reduce": dict(bytes=4 * 32768, count=4)}


def test_implied_nothing_off_a_count_or_a_mesh():
    """Outside a counter, or on one shard, a site records nothing and
    hands its tensors back unchanged."""
    q = _meta(8, 4096, 4, 16)
    k, v = implied.attention(_ctx(), q, q, q, 1024)
    assert k is q and v is q
    got, (k, v) = _implied(implied.attention, _ctx((1, 1)), q, q, q, 1024)
    assert got == {} and k is q


def test_mesh_transfer_counts_at_the_references_width():
    """An issued transfer of bf16 blocks: its bytes as moved, and as the
    reference's CPU HLO moves them (fp32) for the dry run's per_op."""
    mesh = VirtualMesh((1, 2), ("data", "model"), "cpu")
    x = torch.zeros((1, 2, 4, 6), dtype=torch.bfloat16)
    with cost.counting() as c:
        mesh.all_to_all(x, "model", 0, 1)
    assert c.transfers["all-to-all"] == dict(bytes=96, count=1, n_async=0,
                                             hlo_bytes=192)


def test_dryrun_cli_writes_the_reference_keys(tmp_path, capsys):
    dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    import json
    (f,) = tmp_path.iterdir()
    r = json.loads(f.read_text())
    assert f.name == "xlstm-125m_decode_32k_single_pod.json"
    assert set(r) == {"arch", "shape", "mesh", "n_chips", "kind",
                      "model_params", "trace_s", "flops", "bytes_accessed",
                      "collectives", "memory", "moe_pipeline_chunks", "tag"}
    assert r["n_chips"] == 256 and r["flops"] > 0
    assert set(r["collectives"]) >= {"dot_flops", "bytes_accessed",
                                     "per_op", "total_bytes", "n_async",
                                     "while_trips", "kernels"}
    assert r["collectives"]["kernels"]["slstm_scan"]["exact"]
    assert "trace_s" in capsys.readouterr().out


# -- the GNN ring -------------------------------------------------------------

def _small_plan(n_dev=4, dist=2):
    g = TC.power_law(320, avg_degree=7.0, locality=0.35, seed=11)
    return TC.build_plan(g, n_dev, ps=4, dist=dist)


@pytest.mark.parametrize("n_dev,dist", [(4, 1), (4, 2), (8, 2)])
def test_gnn_ring_rotations_equal_collective_bytes(n_dev, dist):
    """The meta ring's rotations per shard are ``collective_bytes``, the
    same as a live run on the CPU counts, and its K1/K3 launches are the
    host plan's (whose exact bytes the meta records bound)."""
    plan, d = _small_plan(n_dev, dist), 12
    meta = dryrun_gnn.count_ring(plan, d)
    rot = meta.collectives["collective-permute"]
    assert rot["bytes"] == TC.collective_bytes(plan, d) * n_dev
    assert rot["count"] == dist * (n_dev - 1) == meta.n_async
    exact = dryrun_gnn.plan_work(plan, d)
    for name, w in exact.items():
        k = meta.kernels[name]
        assert k["launches"] == w["launches"] > 0
        assert k["bytes"] >= w["bytes"]
    assert meta.kernels["gather_sum_pipelined"]["exact"] is False
    assert meta.kernels["segment_add_ordered"] == exact["segment_add_ordered"]
    x = torch.randn((plan.padded_nodes, d))
    live = analyze(TC.mgg_aggregate, x, plan, VirtualRing(n_dev, "cpu"))
    assert live.collectives == meta.collectives
    assert live.n_async == 0 and live.kernels == {}


def test_dryrun_gnn_cli(tmp_path):
    r = dryrun_gnn.main(["--chips", "256", "--scale", "0.125", "--dim", "8",
                         "--out", str(tmp_path)])
    assert r["counted_rotation_bytes"] == r["model_collective_bytes"] > 0
    assert r["terms"]["collective"] > 0 and r["flops"] == 0
    assert (tmp_path / "gnn_reddit_ring256.json").exists()


# -- kernels/cost.py against the counts it replaced ---------------------------

@pytest.mark.parametrize("kw,flops,nbytes", [
    # mistral-nemo-12b (phase 11 (a), bf16), granite, zamba2, whisper's
    # encoder: the K7 counts chip_smoke.py printed on the card
    (dict(b=2, s=4096, h=32, kv=8, hd=128, causal=True, window=0),
     274945015808, 167772160),
    (dict(b=2, s=4096, h=16, kv=8, hd=64, causal=True, window=0),
     68736253952, None),
    (dict(b=2, s=4096, h=32, kv=32, hd=112, causal=True, window=4096),
     240576888832, None),
    (dict(b=8, s=1500, h=8, kv=8, hd=64, causal=False, window=0),
     36864000000, None)])
def test_flash_attention_work_is_the_card_runs_count(kw, flops, nbytes):
    b, s, h, kv, hd = (kw[k] for k in ("b", "s", "h", "kv", "hd"))
    w = cost.flash_attention(b, s, h, kv, hd, causal=kw["causal"],
                             window=kw["window"], itemsize=2)
    # chip_smoke.py's inline count: a loop over the kept pairs
    win = kw["window"]
    pairs = sum(min(i + 1, win) if win else i + 1 for i in range(s)) \
        if kw["causal"] else s * s
    assert w.flops == 4 * b * h * hd * pairs == flops
    assert w.bytes == (2 * b * s * h * hd + 2 * b * s * kv * hd) * 2
    assert nbytes is None or w.bytes == nbytes


def test_slstm_work_is_the_card_runs_count():
    b, s, h, hd = 2, 4096, 4, 192
    assert cost.slstm_scan(b, s, h, hd) == (9663676416, 128237568, True)
    assert cost.slstm_scan_backward(b, s, h, hd) == (9663676416, 304416768,
                                                     True)
    saved = cost.slstm_scan(b, s, h, hd, save=True)
    assert saved.bytes - 128237568 == 4 * 7 * b * s * h * hd


def test_window_pairs_match_the_loop():
    for s, w in ((1, 0), (7, 3), (16, 16), (16, 40), (33, 1)):
        want = sum(min(i + 1, w) if w else i + 1 for i in range(s))
        assert cost.attention_pairs(s, True, w) == want


def _group(seed=0, p=300, ps=8, t=500):
    gen = np.random.default_rng(seed)
    nbrs = gen.integers(0, t, (p, ps))
    nbrs[: p // 3, 0] = 7                        # a hub row
    mask = gen.random((p, ps)) < 0.7
    tgt = np.sort(gen.integers(0, 200, p))
    return nbrs, mask, tgt, TC.WorkGroup.build(nbrs, mask, tgt, "cpu")


def test_gather_work_is_the_inline_count():
    """K1/K2, K3, K4 and K6 against ``chip_smoke.py``'s inline formulas on
    one launch group (distinct rows from its ``GradIndex``)."""
    nbrs, mask, tgt, g = _group()
    p, ps = nbrs.shape
    d, k, id_bytes = 16, 4, 2
    distinct = int(g.grad.rows.numel())
    assert cost.gather_sum(nbrs, mask, d) == (
        0, distinct * d * 4 + p * ps * 5 + p * d * 4, True)
    n_seg = int(g.seg_rows.numel())
    assert cost.segment_add(p, n_seg, d).bytes == \
        p * d * 4 + p * 4 + n_seg * 8 + n_seg * d * 8
    ix = g.grad
    segs, slots = int(ix.rows.numel()), ix.num_slots
    src_rows = int(torch.unique(ix.src).numel())
    assert cost.scatter_sum(ix.src.numpy(), segs, d).bytes == (
        src_rows * d * 4 + slots * 4 + (2 * segs + 1) * 4
        + 2 * segs * d * 4)
    assert cost.sparse_gather_sum(nbrs, mask, k, d, id_bytes).bytes == \
        distinct * k * (4 + id_bytes) + p * ps * 5 + p * d * 4
    idx = np.array([3, 3, 9, 0, 3], np.int32)
    assert cost.gather_rows(idx, 100).bytes == 3 * 400 + 5 * 4 + 5 * 400


def test_worst_cases_bound_the_exact_work():
    nbrs, mask, _, g = _group(1)
    p, ps = nbrs.shape
    assert cost.worst_gather_sum(500, p, ps, 16).bytes >= \
        cost.gather_sum(nbrs, mask, 16).bytes
    assert cost.worst_sparse_gather_sum(500, p, ps, 4, 16, 2).bytes >= \
        cost.sparse_gather_sum(nbrs, mask, 4, 16, 2).bytes
    ix = g.grad
    assert cost.worst_scatter_sum(200, ix.num_slots, int(ix.rows.numel()),
                                  16).bytes >= cost.scatter_sum(
        ix.src.numpy(), int(ix.rows.numel()), 16).bytes
    assert not cost.worst_gather_rows(10, 5, 3).exact


# -- the meta route -----------------------------------------------------------

def test_meta_route_only_for_meta_tensors():
    nbrs, mask, tgt, g = _group(2)
    buf = torch.randn((500, 16))
    with cost.counting() as c:
        cpu = ops.neighbor_gather_sum(buf, g.nbrs, g.mask)
        ops.segment_add_ordered(torch.zeros((200, 16)), cpu, g.order,
                                g.seg_rows, g.seg_start, g.chunks)
    assert cpu.device.type == "cpu" and c.kernels == {}
    m = lambda t: t.to(META)
    with cost.counting() as c:
        out = ops.neighbor_gather_sum(m(buf), m(g.nbrs), m(g.mask))
        ops.neighbor_gather_sum(m(buf), m(g.nbrs), m(g.mask), pb=4)
        ops.segment_add_ordered(torch.zeros((200, 16), device=META),
                                out, m(g.order), m(g.seg_rows),
                                m(g.seg_start))
        q = torch.empty((1, 8, 4, 16), device=META)
        ops.flash_attention(q, q, q, causal=True)
        ops.gather_rows(m(buf), torch.zeros(7, dtype=torch.int32,
                                            device=META))
    assert out.device == META and out.shape == (nbrs.shape[0], 16)
    assert c.kernels["gather_sum_pipelined"]["exact"] is False
    assert c.kernels["gather_sum_blocked"]["launches"] == 1
    assert c.kernels["segment_add_ordered"] == dict(
        launches=1, exact=True, flops=0, bytes=cost.segment_add(
            nbrs.shape[0], int(g.seg_rows.numel()), 16).bytes)
    assert c.kernels["flash_attention"]["flops"] == \
        cost.flash_attention(1, 8, 4, 4, 16, causal=True, window=0,
                             itemsize=4).flops
    assert c.kernels["gather_rows"]["exact"] is False
    assert ops._route(buf) == "cpu" and ops._route(m(buf)) == "meta"
    with pytest.raises(ValueError):
        ops._route(types.SimpleNamespace(device=torch.device("xpu")))


def test_rings_take_meta_only_when_asked():
    assert resolve_device("meta").type == "meta"
    assert VirtualRing(3, "meta").device.type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            VirtualRing(3)
        with pytest.raises(RuntimeError):
            resolve_device()
    with pytest.raises(ValueError):
        resolve_device("xpu")


def test_counters_nest_and_stop():
    nbrs, mask, tgt, g = _group(3)
    buf = torch.empty((500, 16), device=META)
    run = lambda: ops.neighbor_gather_sum(buf, g.nbrs.to(META),
                                          g.mask.to(META))
    with cost.counting() as outer:
        run()
        with cost.counting() as inner:
            run()
    with cost.counting() as after:
        pass
    run()        # no counter records it
    assert outer.kernels["gather_sum_pipelined"]["launches"] == 2
    assert inner.kernels["gather_sum_pipelined"]["launches"] == 1
    assert after.kernels == {}
