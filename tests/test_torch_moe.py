"""repro_torch's moe family against the JAX reference.

The same inputs, made with numpy from fixed seeds, and the same parameters
(the reference's, carried over with ``params_from_numpy``) go through both
packages at the smoke sizes of granite-moe-1b-a400m (8 experts, top-2,
d_ff 32) and mixtral-8x7b (4 experts, top-2, window 16): the routing
(top-k ids, with exact ties built from small integers, and gates), the
sort-based dispatch maps, ``moe_apply`` at the configs' capacity factor
1.25 (tokens dropped) and at no-drop (``capacity_factor = n_experts``),
its gradients against ``jax.vjp``, the smoke forwards with the flash flag
off and on and with a window, prefill + decode, ``loss_fn`` and its
gradients, and the serving engine's tokens.  Inside the port: the
dispatch's backward bitwise across runs and against autograd of the plain
gather, remat changing no bit, and both launchers on the CPU.  Every
reference call is jitted; the file starts no XLA subprocess.

Tolerances: the gates rtol 1e-6 and ``moe_apply`` rtol 1e-5 with atol
1e-5 × max|·| (fp32 in another order); its gradients, the logits, the
loss and the parameter gradients rtol 2e-4 with atol 2e-4 × max|·| (the
reference's flash on/off tolerance); prefill/decode against the port's own
forward 2e-3 (the reference's ``tests/test_models.py``), at no-drop
capacity as the reference's own test compares them (the capacity depends
on the tokens in a call).  Routing comparisons first assert that every
token's k-th and (k+1)-th router logits lie more than ``GAP`` apart, so
that fp32 rounding cannot swap an expert; token comparisons first assert
the top-2 margin of ``test_torch_lm``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.serve import ServeEngine as RServeEngine

from repro_torch import configs as TC
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.train import make_loss_fn
from repro_torch.train.trainer import _grads_of
from repro_torch.train.tree import (tree_flatten_with_names, tree_leaves,
                                    tree_unflatten)

from test_torch_lm import TOL, _margins_hold, _np, _Recorder, _t
from test_torch_lm_train import (_batch, _close, _port_params, _ref_names,
                                 _ref_params)

# six test workers share the host's cores: a few torch threads a worker
torch.set_num_threads(2)

GRANITE, MIXTRAL = "granite-moe-1b-a400m", "mixtral-8x7b"
GAP = 1e-4     # the least k-th / (k+1)-th router logit gap a test relies on


def _cfgs(arch, **kw):
    kw = dict(compute_dtype="float32", remat=False, **kw)
    return (dataclasses.replace(RC.get_smoke_config(arch), **kw),
            dataclasses.replace(TC.get_smoke_config(arch), **kw))


def _no_drop(arch, **kw):
    """The smoke configs at no-drop capacity (every pair kept)."""
    e = RC.get_smoke_config(arch).n_experts
    return _cfgs(arch, moe_capacity_factor=float(e), **kw)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (b, s)) \
        .astype(np.int32)


def _moe_params(cfg, seed):
    return jax.jit(lambda k: RM.moe_init(k, cfg))(jax.random.key(seed))


class _PadRecorder(_Recorder):
    """``_Recorder`` whose logit scale leaves out the padded vocab's
    -1e30 columns (granite's vocab 130 pads to 132)."""

    def __call__(self, logits, temperature, rng):
        out = super().__call__(logits, temperature, rng)
        z, _ = self.scores[-1]
        zmax = np.abs(logits[logits > -1e29]).max()
        self.scores[-1] = (z, zmax / temperature if temperature > 0
                           else zmax)
        return out


def _assert_gap(x2d, w, k):
    """Every row's k-th and (k+1)-th router logits (float64) lie more than
    ``GAP`` apart."""
    lg = np.sort(np.asarray(x2d, np.float64) @ np.asarray(w, np.float64),
                 axis=-1)[:, ::-1]
    gap = lg[:, k - 1] - lg[:, k]
    assert gap.min() > GAP, gap.min()


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GRANITE, MIXTRAL])
def test_route_matches_reference(arch):
    rcfg, tcfg = _cfgs(arch)
    p = _moe_params(rcfg, 0)
    x = np.random.default_rng(1).normal(size=(64, rcfg.d_model)) \
        .astype(np.float32)
    _assert_gap(x, p["router"]["w"], rcfg.top_k)
    gates, tope = jax.jit(lambda p, x: RM._route(p, x, rcfg))(p, x)
    tg, te = TM._route(_port_params(p), _t(x), tcfg)
    assert np.array_equal(te.numpy(), np.asarray(tope))
    np.testing.assert_allclose(_np(tg), _np(gates), rtol=1e-6, atol=1e-7)


def test_route_breaks_exact_ties_as_lax_top_k():
    """Small integers make every product and sum exact, so many logits tie
    bitwise in both packages: the lower expert id goes first, as
    ``lax.top_k`` puts it."""
    rcfg, tcfg = _cfgs(GRANITE)
    rng = np.random.default_rng(2)
    x = rng.integers(-1, 2, (256, rcfg.d_model)).astype(np.float32)
    w = rng.integers(-1, 2, (rcfg.d_model, rcfg.n_experts)).astype(np.float32)
    w[:, 5] = w[:, 2]           # two experts whose logits always tie
    p = dict(router=dict(w=w))
    lg = x @ w
    srt = np.sort(lg, axis=-1)[:, ::-1]
    assert (srt[:, rcfg.top_k - 1] == srt[:, rcfg.top_k]).sum() > 10
    _, tope = jax.jit(lambda p, x: RM._route(p, x, rcfg))(p, x)
    _, te = TM._route(_port_params(p), _t(x), tcfg)
    assert np.array_equal(te.numpy(), np.asarray(tope))


@pytest.mark.parametrize("t,k,e,capacity", [(16, 2, 8, 5), (16, 2, 8, 1),
                                            (33, 8, 32, 10), (40, 2, 4, 40),
                                            (1, 2, 8, 1)])
def test_dispatch_indices_match_reference(t, k, e, capacity):
    """The four maps equal the reference's, with pairs dropped (capacity
    under an expert's load) and without; the ids repeat experts often."""
    rng = np.random.default_rng(t + capacity)
    tope = np.stack([rng.choice(e, k, replace=False) for _ in range(t)]) \
        .astype(np.int32)
    want = jax.jit(lambda a: RM._dispatch_indices(a, e, capacity))(tope)
    got = TM._dispatch_indices(_t(tope).long(), e, capacity)
    for g, w, name in zip(got, want, ("slot_token", "slot_valid",
                                      "pair_rank", "pair_kept")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name


# ---------------------------------------------------------------------------
# moe_apply and its gradients
# ---------------------------------------------------------------------------

def _moe_case(arch, mlp_type, seed):
    rcfg, tcfg = _cfgs(arch, mlp_type=mlp_type)
    p = _moe_params(rcfg, seed)
    x = np.random.default_rng(seed + 10).normal(
        size=(2, 16, rcfg.d_model)).astype(np.float32)
    _assert_gap(x.reshape(-1, rcfg.d_model), p["router"]["w"], rcfg.top_k)
    return rcfg, tcfg, p, x


@pytest.mark.parametrize("arch,mlp_type", [(GRANITE, "swiglu"),
                                           (MIXTRAL, "swiglu"),
                                           (GRANITE, "gelu")])
@pytest.mark.parametrize("capacity_factor", [1.25, None])
def test_moe_apply_matches_reference(arch, mlp_type, capacity_factor):
    """At 1.25 the smoke shapes drop pairs (asserted); ``None`` is no-drop
    (``capacity_factor = n_experts``)."""
    rcfg, tcfg, p, x = _moe_case(arch, mlp_type, 3)
    cf = capacity_factor or float(rcfg.n_experts)
    want = jax.jit(lambda p, x: RM.moe_apply(p, x, rcfg,
                                             capacity_factor=cf))(p, x)
    got = TM.moe_apply(_port_params(p), _t(x), tcfg, capacity_factor=cf)
    _close(got, want, "moe_apply", rtol=1e-5)
    t = x.shape[0] * x.shape[1]
    cap = max(1, int(t * rcfg.top_k / rcfg.n_experts * cf))
    _, tope = TM._route(_port_params(p), _t(x.reshape(t, -1)), tcfg)
    kept = TM._dispatch_indices(tope, rcfg.n_experts, cap)[3]
    assert bool(kept.all()) == (capacity_factor is None)


@pytest.mark.parametrize("capacity_factor", [1.25, None])
def test_moe_apply_gradients_match_jax_vjp(capacity_factor):
    rcfg, tcfg, p, x = _moe_case(GRANITE, "swiglu", 4)
    cf = capacity_factor or float(rcfg.n_experts)
    cot = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    @jax.jit
    def ref_vjp(p, x, cot):
        _, vjp = jax.vjp(lambda p, x: RM.moe_apply(p, x, rcfg,
                                                   capacity_factor=cf), p, x)
        return vjp(cot)

    gp, gx = ref_vjp(p, x, cot)
    tp = _port_params(p)
    names = [n for n, _ in tree_flatten_with_names(tp)]
    leaves = [v.requires_grad_(True) for v in tree_leaves(tp)]
    xt = _t(x).requires_grad_(True)
    out = TM.moe_apply(tree_unflatten(tp, leaves), xt, tcfg,
                       capacity_factor=cf)
    grads = torch.autograd.grad(out, [xt] + leaves, _t(cot))
    _close(grads[0], gx, "d x")
    want = _ref_names(gp)
    for name, g in zip(names, grads[1:]):
        _close(g, want[name], name)


def test_dispatch_backward_is_deterministic_and_the_gathers():
    """The dispatch's backward (a gather over the pair → slot map, summed
    over k in order) gives the same bits twice and agrees with autograd
    of the plain gather (``index_select``, whose backward adds with
    ``index_add_``) within 1e-6."""
    _, tcfg = _cfgs(GRANITE)
    rng = np.random.default_rng(6)
    t, d = 48, tcfg.d_model
    x2d = _t(rng.normal(size=(t, d)).astype(np.float32))
    tope = torch.stack([torch.from_numpy(rng.choice(
        tcfg.n_experts, tcfg.top_k, replace=False)) for _ in range(t)])
    cap = 9                                       # some pairs dropped
    slot_token, slot_valid, pair_slot, pair_kept = TM._dispatch_indices(
        tope, tcfg.n_experts, cap)
    assert not pair_kept.all()
    pair_idx = tope * cap + pair_slot.clamp(0, cap - 1)
    g = _t(rng.normal(size=(tcfg.n_experts, cap, d)).astype(np.float32))

    def grad(fn):
        xr = x2d.clone().requires_grad_(True)
        return torch.autograd.grad(fn(xr), xr, g)[0]

    ours = [grad(lambda xr: TM._Dispatch.apply(
        xr, slot_token, slot_valid, pair_idx, pair_kept)) for _ in range(2)]
    plain = grad(lambda xr: torch.index_select(
        xr, 0, slot_token.reshape(-1)).reshape(tcfg.n_experts, cap, d)
        * slot_valid[..., None].float())
    assert torch.equal(ours[0], ours[1])
    torch.testing.assert_close(ours[0], plain, rtol=1e-6, atol=1e-6)
    assert torch.equal(TM._Dispatch.apply(x2d, slot_token, slot_valid,
                                          pair_idx, pair_kept),
                       x2d[slot_token] * slot_valid[..., None].float())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,flash,window", [
    (GRANITE, False, 0), (GRANITE, True, 0), (MIXTRAL, True, 4)])
def test_forward_matches_reference(arch, flash, window):
    """The cache-less forward at the configs' capacity 1.25 (the same
    tokens in one call in both), flash flag off and on (the reference's
    Pallas kernel in interpret mode; the port's plain flash on the CPU),
    granite without a window and mixtral with window 4 (its own 16 does
    not bite at S 16)."""
    kw = dict(use_flash_attention=flash)
    if window:
        kw["sliding_window"] = window
    rcfg, tcfg = _cfgs(arch, **kw)
    params = _ref_params(rcfg, seed=1)
    toks = _tokens(rcfg, 2, 16, 0)
    want, _ = jax.jit(lambda p, t: RT.forward(p, rcfg, t))(params, toks)
    got, _ = TT.forward(_port_params(params), tcfg, _t(toks))
    assert got.shape == want.shape
    _close(got, want, f"{arch} logits")


@pytest.mark.parametrize("arch", [GRANITE, MIXTRAL])
def test_prefill_decode_match_reference_and_forward_at_no_drop(arch):
    rcfg, tcfg = _no_drop(arch)
    params = _ref_params(rcfg, seed=1)
    tp = _port_params(params)
    toks = _tokens(rcfg, 2, 10, 3)
    k, b = 7, 2
    pos = np.full((b,), k, np.int32)

    @jax.jit
    def ref_run(p, toks):
        cache = RT.init_cache(rcfg, b, 32, dtype=jnp.float32)
        lg, cache = RT.prefill(p, rcfg, toks[:, :k], cache)
        lg2, _ = RT.decode_step(p, rcfg, toks[:, k], pos, cache)
        return lg, lg2

    want1, want2 = ref_run(params, toks)
    cache = TT.init_cache(tcfg, b, 32, dtype=torch.float32)
    got1, cache = TT.prefill(tp, tcfg, _t(toks[:, :k]), cache)
    got2, _ = TT.decode_step(tp, tcfg, _t(toks[:, k]), _t(pos), cache)
    _close(got1, want1, "prefill")
    _close(got2, want2, "decode")
    full, _ = TT.forward(tp, tcfg, _t(toks[:, :k + 1]))
    np.testing.assert_allclose(_np(got1), _np(full[:, k - 1]), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(_np(got2), _np(full[:, k]), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", [GRANITE, MIXTRAL])
def test_loss_and_grads_match_reference(arch):
    rcfg, tcfg = _cfgs(arch)
    rp = _ref_params(rcfg)
    batch = _batch(rcfg, 2, 16)
    (rl, raux), rg = jax.jit(jax.value_and_grad(
        lambda p, bt: RT.loss_fn(p, rcfg, bt), has_aux=True))(
        rp, jax.tree.map(jnp.asarray, batch))
    tl, taux, tg = _grads_of(make_loss_fn(tcfg, TT.DistCtx()),
                             _port_params(rp),
                             {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(rl), rtol=TOL)
    assert float(taux["ntokens"]) == float(raux["ntokens"])
    want = _ref_names(rg)
    got = dict(tree_flatten_with_names(tg))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        _close(g, want[name], name)


def test_remat_changes_no_bit():
    cfg = TC.get_smoke_config(GRANITE)
    params = TT.init_params(torch.Generator().manual_seed(1), cfg)
    batch = {k: _t(v) for k, v in _batch(cfg, 2, 16).items()}
    out = [_grads_of(make_loss_fn(dataclasses.replace(cfg, remat=r),
                                  TT.DistCtx()), params, batch)
           for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving and the launchers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_pair():
    """One reference engine and one port engine on the same parameters
    (smoke granite, fp32 compute, the configs' capacity 1.25: a decode
    step of 2 slots has capacity 1 an expert, so pairs drop there as in
    the reference): 4 prompts over 2 slots.  Parameter seed 1 is one
    whose every sampling step clears ``_margins_hold``'s margin."""
    rcfg, tcfg = _cfgs(GRANITE)
    params = _ref_params(rcfg, seed=1)
    r = RServeEngine(params, rcfg, batch_slots=2, max_seq=64)
    t = TServeEngine(_port_params(params), tcfg, batch_slots=2, max_seq=64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, rcfg.vocab, size=n).astype(np.int32)
               for n in (4, 6, 4, 6)]
    return r, t, prompts


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_served_tokens_match_reference(served_pair, temperature):
    r, t, prompts = served_pair
    r._sample = rec = _PadRecorder(r)
    want = r.generate(prompts, max_new=6, temperature=temperature, seed=0)
    _margins_hold(rec, temperature)
    got = t.generate(prompts, max_new=6, temperature=temperature, seed=0)
    assert [g.tokens for g in got] == [w.tokens for w in want]
    assert [(g.prompt_len, g.steps) for g in got] == \
        [(w.prompt_len, w.steps) for w in want]


@pytest.mark.parametrize("arch", [GRANITE, MIXTRAL])
def test_serve_launcher_on_cpu(arch, capsys):
    rep = tserve.main(["--device", "cpu", "--arch", arch, "--smoke",
                       "--requests", "4", "--max-new", "8"])
    assert rep["device"] == "cpu" and rep["requests"] == 4
    assert all(r.steps == 8 for r in rep["results"])
    assert "4 requests, 32 tokens" in capsys.readouterr().out


def test_train_launcher_on_cpu_takes_pipeline_chunks():
    """``--moe-pipeline-chunks`` acts only with a mesh (the reference's
    one-device ``DistCtx()``): above 1 it trains as at 1, bit for bit."""
    runs = [ttrain.main(["--device", "cpu", "--arch", GRANITE, "--smoke",
                         "--steps", "3", "--seq", "16", "--batch", "2",
                         "--moe-pipeline-chunks", c]) for c in ("1", "4")]
    assert runs[0]["losses"] == runs[1]["losses"]
    assert all(np.isfinite(runs[0]["losses"]))
    assert runs[0]["losses"][-1] < runs[0]["losses"][0]


def test_expert_parallel_over_a_mesh_raises_item_9():
    """The expert-parallel path over a mesh (the name is kept from when it
    refused it, ROADMAP item 9): over a (2, 4) virtual mesh, at chunks 1
    and 2, it equals ``moe_apply`` run on each shard's own token block at
    that block's capacity (rtol 1e-5, atol 1e-5 × max|·|), with tokens
    replicated over the model axis where S does not divide it; the
    forward takes it under ``DistCtx(mesh)`` only where the model axis
    divides the experts (the reference's condition), else ``moe_apply``
    bit for bit; and a model axis that does not divide the experts
    raises."""
    from repro_torch.dist import VirtualMesh

    _, cfg = _cfgs(GRANITE)
    assert cfg.expert_mode == "ep" and cfg.n_experts == 8
    params = TT.init_params(torch.Generator().manual_seed(0), cfg)
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()
         if k != "router"}
    p["router"] = {"w": params["blocks"]["moe"]["router"]["w"][0]}
    mesh = VirtualMesh((2, 4), ("data", "model"), "cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    for s, blk in ((8, 2), (3, 3)):       # S 3: replicated over "model"
        xs = x[:, :s]
        want = torch.cat([torch.cat([
            TM.moe_apply(p, xs[d:d + 1, j * blk:(j + 1) * blk], cfg)
            for j in range(s // blk)], 1) for d in range(2)])
        for chunks in (1, 2):
            got = TM.moe_apply_ep_shard(p, xs, cfg, mesh,
                                        pipeline_chunks=chunks)
            _close(got, _np(want), f"EP S {s} chunks {chunks}", rtol=1e-5)
    toks = torch.ones(2, 4, dtype=torch.int32)
    odd = VirtualMesh((1, 3), ("data", "model"), "cpu")
    assert torch.equal(TT.forward(params, cfg, toks,
                                  ctx=TT.DistCtx(mesh=odd))[0],
                       TT.forward(params, cfg, toks)[0])
    with pytest.raises(ValueError, match="experts over a model axis"):
        TM.moe_apply_ep_shard(p, x, cfg, odd)
