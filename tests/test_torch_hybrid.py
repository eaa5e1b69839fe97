"""repro_torch's hybrid family (zamba2) against the JAX reference.

The same inputs, made with numpy from fixed seeds, and the same parameters
(the reference's, carried over with ``params_from_numpy``) go through both
packages at the smoke size of zamba2-7b (7 layers: 2 groups of 3 mamba
blocks, each followed by the shared attention block, and a tail of 1;
d_model 64, SSM heads 8 of 16, state 16, chunk 8): the Mamba2 (SSD)
mixer with and without state and its single-token step, the cache tree,
the forward with the flash flag off and on, prefill + decode, ``loss_fn``
and its gradients, and the serving engine's tokens.  At the configs' own
chunk of 256 the reference's mixer has NaN gradients (its ``where(mask,
exp(decay), 0)`` multiplies an overflowed ``exp`` by 0); the port's are
finite and equal the reference's at chunk 64, where those are finite.
Inside the port: chunked == stepwise, chunk-size invariance, remat
changing no bit, batched == solo tokens, and both launchers on the CPU.
Every reference call is jitted; the file starts no XLA subprocess.

Tolerances: the mixer rtol 1e-5 with atol 1e-5 × max|·| (fp32 in another
order; ``torch``'s softplus returns ``x`` above 20, within 1e-8 relative
of ``jax.nn.softplus``'s ``logaddexp(x, 0)``); chunked against stepwise
2e-3 and chunk sizes against each other 2e-4 (the reference's
``tests/test_mixers.py``); logits, the loss and the gradients rtol 2e-4
with atol 2e-4 × max|·|; prefill/decode against the port's own forward
2e-3.  Token comparisons first assert ``test_torch_lm``'s top-2 margin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.serve import ServeEngine as RServeEngine

from repro_torch import configs as TC
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.layers import KVCache
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

ARCH = "zamba2-7b"


def _cfgs(**kw):
    kw = dict(compute_dtype="float32", remat=False, **kw)
    return (dataclasses.replace(RC.get_smoke_config(ARCH), **kw),
            dataclasses.replace(TC.get_smoke_config(ARCH), **kw))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (b, s)) \
        .astype(np.int32)


def _ssm_params(cfg, seed, rng=None):
    """The reference's mixer parameters; with ``rng``, ``a_log``,
    ``dt_bias`` and ``d_skip`` drawn too (their inits are constants)."""
    p = jax.tree.map(np.asarray, jax.jit(lambda k: RS.ssm_init(k, cfg))(
        jax.random.key(seed)))
    if rng is not None:
        h = p["a_log"].shape
        p["a_log"] = rng.normal(size=h).astype(np.float32) * 0.5
        p["dt_bias"] = rng.normal(size=h).astype(np.float32) * 0.5
        p["d_skip"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
    return p


def _state(cfg, b, rng):
    d_in = cfg.d_model * cfg.ssm_expand
    heads = d_in // cfg.ssm_headdim
    return dict(h=rng.normal(size=(b, heads, cfg.ssm_headdim,
                                   cfg.ssm_state)).astype(np.float32),
                conv=rng.normal(size=(b, 3, d_in + 2 * cfg.ssm_state))
                .astype(np.float32))


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state,s", [(False, 16), (True, 16),
                                          (True, 13)])
def test_ssm_apply_matches_reference(with_state, s):
    """S 16 runs two chunks of 8; S 13 one chunk of 13 (the reference's
    rule for a length the chunk does not divide)."""
    rcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    p = _ssm_params(rcfg, 0, rng)
    x = _x(rcfg, 2, s, 2)
    st = _state(rcfg, 2, rng) if with_state else None
    y, nst = jax.jit(lambda p, x, st: RS.ssm_apply(p, x, rcfg, st))(p, x, st)
    ty, tst = TS.ssm_apply(_port_params(p), _t(x), tcfg,
                           None if st is None else
                           {k: _t(v) for k, v in st.items()})
    _close(ty, y, "y", rtol=1e-5)
    assert (tst is None) == (nst is None)
    if with_state:
        for k in ("h", "conv"):
            _close(tst[k], nst[k], k, rtol=1e-5)


def test_ssm_step_matches_reference():
    rcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    p = _ssm_params(rcfg, 1, rng)
    x = _x(rcfg, 3, 1, 4)
    st = _state(rcfg, 3, rng)
    y, nst = jax.jit(lambda p, x, st: RS.ssm_step(p, x, rcfg, st))(p, x, st)
    ty, tst = TS.ssm_step(_port_params(p), _t(x), tcfg,
                          {k: _t(v) for k, v in st.items()})
    _close(ty, y, "y", rtol=1e-5)
    for k in ("h", "conv"):
        _close(tst[k], nst[k], k, rtol=1e-5)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_equals_stepwise(chunk):
    _, tcfg = _cfgs(ssm_chunk=chunk)
    p = _port_params(_ssm_params(tcfg, 0))
    b, s = 2, 16
    x = _t(_x(tcfg, b, s, 5))
    y_seq, st_seq = TS.ssm_apply(p, x, tcfg, TS.ssm_state_init(tcfg, b))
    st = TS.ssm_state_init(tcfg, b)
    ys = []
    for i in range(s):
        yt, st = TS.ssm_step(p, x[:, i:i + 1], tcfg, st)
        ys.append(yt)
    torch.testing.assert_close(y_seq, torch.cat(ys, dim=1), rtol=2e-3,
                               atol=2e-3)
    torch.testing.assert_close(st_seq["h"], st["h"], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(st_seq["conv"], st["conv"], rtol=2e-3,
                               atol=2e-3)


def test_ssd_chunk_size_invariance():
    b, s = 2, 24
    outs = []
    for chunk in (4, 8, 24):
        _, tcfg = _cfgs(ssm_chunk=chunk)
        p = _port_params(_ssm_params(tcfg, 1))
        y, _ = TS.ssm_apply(p, _t(_x(tcfg, b, s, 6)), tcfg,
                            TS.ssm_state_init(tcfg, b))
        outs.append(y)
    torch.testing.assert_close(outs[0], outs[1], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(outs[0], outs[2], rtol=2e-4, atol=2e-4)


def test_chunk_256_gradients_finite_where_the_reference_is_nan():
    """The configs' own chunk (256) at S 256: the forwards agree, the
    reference's gradients of ``a_log``, ``dt_bias`` and ``in_proj`` are
    NaN (its fault: ``where(mask, exp(decay), 0)`` with ``exp`` overflowed
    above the diagonal), the port's are finite and equal the reference's
    at chunk 64 (the same function; no overflow there)."""
    rcfg, tcfg = _cfgs(ssm_chunk=256)
    p = _ssm_params(rcfg, 2)
    x = _x(rcfg, 1, 256, 7)
    cot = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def ref_vjp(cfg):
        @jax.jit
        def run(p, x, cot):
            y, vjp = jax.vjp(lambda p: RS.ssm_apply(p, x, cfg)[0], p)
            return y, vjp(cot)[0]
        return run(p, x, cot)

    y256, g256 = ref_vjp(rcfg)
    y64, g64 = ref_vjp(dataclasses.replace(rcfg, ssm_chunk=64))
    nan = {k for k, v in _ref_names(g256).items() if np.isnan(v).any()}
    assert {"a_log", "dt_bias", "in_proj/w"} <= nan
    tp = _port_params(p)
    names = [n for n, _ in tree_flatten_with_names(tp)]
    leaves = [v.requires_grad_(True) for v in tree_leaves(tp)]
    y, _ = TS.ssm_apply(tree_unflatten(tp, leaves), _t(x), tcfg)
    _close(y, y256, "y at chunk 256", rtol=1e-5)
    grads = torch.autograd.grad(y, leaves, _t(cot))
    want = _ref_names(g64)
    for name, g in zip(names, grads):
        assert torch.isfinite(g).all(), name
        _close(g, want[name], name)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _cache_names(tree, prefix=""):
    """``{path: leaf}`` of a cache tree (dicts and ``KVCache``s), named as
    the reference's (its ``KVCache`` flattens to children 0, 1, 2: k, v,
    key_pos)."""
    if isinstance(tree, KVCache):
        tree = {"0": tree.k, "1": tree.v, "2": tree.key_pos}
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_cache_names(tree[k], f"{prefix}/{k}" if prefix
                                    else str(k)))
        return out
    return {prefix: tree}


def test_init_cache_tree_matches_reference():
    rcfg, tcfg = _cfgs()
    want = jax.eval_shape(lambda: RT.init_cache(rcfg, 3, 20,
                                                dtype=jnp.float32))
    paths, _ = jax.tree_util.tree_flatten_with_path(want)
    want = {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf for path, leaf in paths}
    got = _cache_names(TT.init_cache(tcfg, 3, 20, dtype=torch.float32))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype) == f"torch.{want[name].dtype}", name
        assert leaf.shape[1] == 3, name          # batch on axis 1


def test_forward_matches_reference():
    """The shared block's attention with the flash flag on (the
    reference's Pallas kernel in interpret mode, the port's plain flash;
    the flag-off forward is ``loss_fn``'s below) and a window of 4 that
    bites at S 16."""
    rcfg, tcfg = _cfgs(use_flash_attention=True, sliding_window=4)
    params = _ref_params(rcfg, seed=1)
    toks = _tokens(rcfg, 2, 16, 0)
    want, _ = jax.jit(lambda p, t: RT.forward(p, rcfg, t))(params, toks)
    got, _ = TT.forward(_port_params(params), tcfg, _t(toks))
    _close(got, want, "logits")


def test_prefill_decode_match_reference_and_forward():
    rcfg, tcfg = _cfgs()
    params = _ref_params(rcfg, seed=1)
    tp = _port_params(params)
    toks = _tokens(rcfg, 2, 12, 3)
    k, b = 11, 2
    pos = np.full((b,), k, np.int32)

    @jax.jit
    def ref_run(p, toks):
        cache = RT.init_cache(rcfg, b, 32, dtype=jnp.float32)
        lg, cache = RT.prefill(p, rcfg, toks[:, :k], cache)
        lg2, cache = RT.decode_step(p, rcfg, toks[:, k], pos, cache)
        return lg, lg2, cache

    want1, want2, wcache = ref_run(params, toks)
    cache = TT.init_cache(tcfg, b, 32, dtype=torch.float32)
    got1, cache = TT.prefill(tp, tcfg, _t(toks[:, :k]), cache)
    got2, cache = TT.decode_step(tp, tcfg, _t(toks[:, k]), _t(pos), cache)
    _close(got1, want1, "prefill")
    _close(got2, want2, "decode")
    for k_, w in (("h", wcache["ssm_main"]["h"]),
                  ("tail_h", wcache["ssm_tail"]["h"])):
        src = cache["ssm_main" if k_ == "h" else "ssm_tail"]["h"]
        _close(src, w, k_)
    full, _ = TT.forward(tp, tcfg, _t(toks[:, :k + 1]))
    np.testing.assert_allclose(_np(got1), _np(full[:, k - 1]), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(_np(got2), _np(full[:, k]), rtol=2e-3,
                               atol=2e-3)


def test_decode_takes_the_single_step_form(monkeypatch):
    """The hybrid's decode calls ``ssm_step`` on every mamba block (not
    ``ssm_apply`` at S = 1), and the prefill ``ssm_apply``."""
    _, tcfg = _cfgs()
    params = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    calls = {"ssm_apply": 0, "ssm_step": 0}
    for name in calls:
        orig = getattr(TS, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(TS, name, counted)
    cache = TT.init_cache(tcfg, 1, 16, dtype=torch.float32)
    TT.prefill(params, tcfg, torch.ones(1, 5, dtype=torch.int32), cache)
    assert calls == {"ssm_apply": tcfg.n_layers, "ssm_step": 0}
    TT.decode_step(params, tcfg, torch.ones(1, dtype=torch.int32),
                   torch.full((1,), 5, dtype=torch.int32), cache)
    assert calls == {"ssm_apply": tcfg.n_layers, "ssm_step": tcfg.n_layers}


def test_loss_and_grads_match_reference():
    rcfg, tcfg = _cfgs()
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
    """remat checkpoints each group (not the tail): same loss and
    gradients, bit for bit."""
    cfg = TC.get_smoke_config(ARCH)
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
    (smoke zamba2, fp32 compute): 4 prompts of three lengths over 2 slots,
    the admissions scattering the nested mamba states and the per-group
    KV caches.  Parameter seed 1 with prompt seed 4 is a pair whose every
    sampling step clears ``_margins_hold``'s margin (prompt seed 3 is
    not: a greedy step's top two logits lie 0.006 apart)."""
    rcfg, tcfg = _cfgs()
    params = _ref_params(rcfg, seed=1)
    r = RServeEngine(params, rcfg, batch_slots=2, max_seq=64)
    t = TServeEngine(_port_params(params), tcfg, batch_slots=2, max_seq=64)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, rcfg.vocab, size=n).astype(np.int32)
               for n in (4, 6, 4, 6)]
    return r, t, prompts


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_served_tokens_match_reference(served_pair, temperature):
    r, t, prompts = served_pair
    r._sample = rec = _Recorder(r)
    want = r.generate(prompts, max_new=6, temperature=temperature, seed=0)
    _margins_hold(rec, temperature)
    got = t.generate(prompts, max_new=6, temperature=temperature, seed=0)
    assert [g.tokens for g in got] == [w.tokens for w in want]


def test_batched_logits_equal_solo():
    """The slot scatter keeps slots isolated: 5 prompts through 2 slots
    give each prompt's solo logits step by step (fp32, 1e-5)."""
    _, tcfg = _cfgs()
    params = TT.init_params(torch.Generator().manual_seed(2), tcfg,
                            vocab_multiple=4)
    eng = TServeEngine(params, tcfg, batch_slots=2, max_seq=64)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, tcfg.vocab, size=rng.integers(2, 9))
               .astype(np.int32) for _ in range(5)]
    batched = eng.generate(prompts, max_new=5, keep_logits=True)
    for i, p in enumerate(prompts):
        solo = eng.generate([p], max_new=5, keep_logits=True)[0]
        assert batched[i].tokens == solo.tokens, i
        np.testing.assert_allclose(batched[i].logits, solo.logits,
                                   rtol=1e-5, atol=1e-5)


def test_launchers_on_cpu(capsys):
    rep = tserve.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                       "--requests", "4", "--max-new", "8"])
    assert rep["device"] == "cpu" and rep["requests"] == 4
    assert all(r.steps == 8 for r in rep["results"])
    out = ttrain.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                       "--steps", "3", "--seq", "16", "--batch", "2"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert "4 requests, 32 tokens" in capsys.readouterr().out
