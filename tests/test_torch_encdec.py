"""repro_torch's encdec family (whisper-base) against the JAX reference.

The same inputs, made with numpy from a seed as ``tests/test_models.py``
makes them (frames ``(2, 12, 64)``, tokens ``(2, 24)``), and the same
parameters (the reference's, carried over with ``params_from_numpy``) go
through both packages at the smoke whisper (2 + 2 layers, d 64, H = KV =
4, hd 16, vocab 128, ``vocab_multiple=4``): the parameter and cache trees,
``sinusoid``, the encoder and the decoder's logits with the flash flag off
and on (the reference's Pallas kernel in interpret mode, the port's plain
K7 on the CPU), ROADMAP §3 F3 pinned in both packages (with the flag off
the encoder is causal, with it on bidirectional), ``loss_fn`` and its
gradients through ``make_loss_fn``, prefill and four decode steps, and
five AdamW steps of both packages' ``Trainer``.  Inside the port: remat
changing no bit.  Every reference call is jitted; the file starts no XLA
subprocess.

Tolerances: logits, the loss and prefill/decode rtol = atol 2e-4 (the
reference's flash on/off tolerance); gradients rtol 2e-4 with atol 2e-4 ×
the leaf's max |·|; the AdamW losses 1e-3 (ROADMAP); ``sinusoid`` and F3's
unchanged frames bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import encdec as RE
from repro.models import transformer as RT
from repro.train import AdamWConfig as RAdamWConfig
from repro.train import Trainer as RTrainer
from repro.train import TrainState as RTrainState
from repro.train import adamw_init as radamw_init
from repro.train import make_train_step as rmake_train_step

from repro_torch import configs as TC
from repro_torch.core.gnn import params_from_numpy
from repro_torch.models import encdec as TE
from repro_torch.models import transformer as TT
from repro_torch.train import (AdamWConfig, Trainer, TrainState, adamw_init,
                               make_loss_fn, make_train_step)
from repro_torch.train.trainer import _grads_of
from repro_torch.train.tree import tree_flatten_with_names, tree_leaves

from test_torch_lm import TOL, _np, _t
from test_torch_lm import _ref_names as _leaves
from test_torch_lm_train import _close, _ref_names

# six test workers share the host's cores: a few torch threads a worker
torch.set_num_threads(2)

ARCH = "whisper-base"
B, S, T = 2, 24, 12            # batch, tokens, frames


def _cfgs(**kw):
    kw = dict(compute_dtype="float32", remat=False, **kw)
    return (dataclasses.replace(RC.get_smoke_config(ARCH), **kw),
            dataclasses.replace(TC.get_smoke_config(ARCH), **kw))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    frames = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    return frames, toks


_REF = {}


def _ref_params(seed=0):
    if seed not in _REF:
        cfg = _cfgs()[0]
        _REF[seed] = jax.jit(lambda k: RE.init_params(
            k, cfg, vocab_multiple=4))(jax.random.key(seed))
    return _REF[seed]


def _arange(n):
    return np.tile(np.arange(n, dtype=np.int32), (B, 1))


_FORWARD = {}


def _ref_forward(flash):
    """The reference's encoder and decoder logits, jitted once a flag."""
    if flash not in _FORWARD:
        cfg = _cfgs(use_flash_attention=flash)[0]

        def fwd(p, frames, toks):
            enc = RE.encode(p, cfg, frames)
            logits, _ = RE._decoder(p, cfg, toks, enc, _arange(T),
                                    ctx=RT.DistCtx(), positions=_arange(S))
            return enc, logits
        _FORWARD[flash] = jax.jit(fwd)
    return _FORWARD[flash]


def _port_forward(params, cfg, frames, toks):
    with torch.no_grad():
        enc = TE.encode(params, cfg, _t(frames))
        logits, _ = TE._decoder(params, cfg, _t(toks), enc,
                                _t(_arange(T)), ctx=TT.DistCtx(),
                                positions=_t(_arange(S)))
    return enc, logits


# ---------------------------------------------------------------------------
# the trees and the positions
# ---------------------------------------------------------------------------

def test_param_tree_matches_reference():
    """The port's init has the reference's leaf names, shapes and dtypes
    (also whisper-base's vocabulary, 51865 padded to 51872 at 16), and the
    reference's tree carried over by ``params_from_numpy`` is the same
    tree."""
    rcfg, tcfg = _cfgs()
    for vocab, mult in ((rcfg.vocab, 4), (51865, 16)):
        rc, tc = (dataclasses.replace(c, vocab=vocab) for c in (rcfg, tcfg))
        want = _leaves(jax.eval_shape(
            lambda k: RE.init_params(k, rc, vocab_multiple=mult),
            jax.random.key(0)))
        got = dict(tree_flatten_with_names(TE.init_params(
            torch.Generator().manual_seed(0), tc, vocab_multiple=mult)))
        assert sorted(got) == sorted(want)
        for name, leaf in got.items():
            assert tuple(leaf.shape) == want[name].shape, name
            assert str(leaf.dtype) == f"torch.{want[name].dtype}", name
    assert got["embed/w"].shape == (51872, tcfg.d_model)
    carried = dict(tree_flatten_with_names(
        params_from_numpy(_ref_params(), "cpu")))
    ref = _ref_names(_ref_params())
    assert sorted(carried) == sorted(ref)
    for name, leaf in carried.items():
        assert np.array_equal(leaf.numpy(), ref[name]), name


@pytest.mark.parametrize("t,d", [(12, 64), (7, 10), (1500, 512)])
def test_sinusoid_matches_reference_bitwise(t, d):
    got, want = TE.sinusoid(t, d), RE.sinusoid(t, d)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_cache_tree_matches_reference(dtype):
    rcfg, tcfg = _cfgs()
    kw = {} if dtype == "bfloat16" else dict(dtype=jnp.float32)
    want = jax.eval_shape(lambda: RE.init_cache(rcfg, B, 32, T, **kw))
    got = TE.init_cache(tcfg, B, 32, T,
                        **({} if not kw else dict(dtype=torch.float32)))
    pairs = [(got["kv"].k, want["kv"].k), (got["kv"].v, want["kv"].v),
             (got["kv"].key_pos, want["kv"].key_pos),
             (got["cross_k"], want["cross_k"]),
             (got["cross_v"], want["cross_v"]),
             (got["enc_pos"], want["enc_pos"])]
    for g, w in pairs:
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}"
    assert (got["kv"].key_pos == -1).all()
    assert got["cross_k"].shape == (tcfg.n_layers, B, T, tcfg.n_kv_heads,
                                    tcfg.head_dim)


# ---------------------------------------------------------------------------
# the forward, and F3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True])
def test_forward_matches_reference(flash):
    """The encoder's output and the teacher-forced decoder's logits, fp32,
    flag off (the chunked path) and on (the reference's Pallas kernel in
    interpret mode; the port's plain K7: the encoder's 2 causal-off
    launches and the decoder's 2 causal ones)."""
    rcfg, tcfg = _cfgs(use_flash_attention=flash)
    rp = _ref_params()
    frames, toks = _inputs(rcfg)
    want_enc, want = _ref_forward(flash)(rp, frames, toks)
    enc, got = _port_forward(params_from_numpy(rp, "cpu"), tcfg, frames,
                             toks)
    assert got.shape == want.shape == (B, S, 128)
    np.testing.assert_allclose(_np(enc), _np(want_enc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_f3_encoder_causal_with_the_flag_off_in_both_packages(flash):
    """ROADMAP §3 F3: a change to the last frame leaves every earlier
    frame's encoder output bitwise unchanged with the flag off (the
    chunked path masks k <= q), and moves them with it on (K7, causal
    off) -- in the reference and in the port alike."""
    rcfg, tcfg = _cfgs(use_flash_attention=flash)
    rp = _ref_params()
    tp = params_from_numpy(rp, "cpu")
    frames, toks = _inputs(rcfg)
    moved = frames.copy()    # not a constant shift, which LayerNorm drops
    moved[:, -1] += np.random.default_rng(1).normal(
        size=rcfg.d_model).astype(np.float32)
    outs = {}
    for name, run in (
            ("reference", lambda f: np.asarray(
                _ref_forward(flash)(rp, f, toks)[0])),
            ("port", lambda f: _np(_port_forward(tp, tcfg, f, toks)[0]))):
        a, b = run(frames), run(moved)
        assert not np.array_equal(a[:, -1], b[:, -1]), name
        earlier_same = np.array_equal(a[:, :-1], b[:, :-1])
        assert earlier_same == (not flash), (name, flash)
        if flash:
            assert np.abs(a[:, 0] - b[:, 0]).max() > 1e-3, name
        outs[name] = (a, b)
    for i in range(2):
        np.testing.assert_allclose(outs["port"][i], outs["reference"][i],
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0):
    frames, toks = _inputs(cfg, seed)
    return dict(frames=frames, tokens=toks)


def test_loss_and_grads_match_reference():
    """``make_loss_fn`` takes the encdec loss for whisper: its loss, token
    count and every gradient leaf against ``jax.value_and_grad`` of the
    reference's ``loss_fn``."""
    rcfg, tcfg = _cfgs()
    rp = _ref_params()
    batch = _batch(rcfg)
    (rl, raux), rg = jax.jit(jax.value_and_grad(
        lambda p, bt: RE.loss_fn(p, rcfg, bt), has_aux=True))(rp, batch)
    loss_fn = make_loss_fn(tcfg, TT.DistCtx())
    tbatch = {k: _t(v) for k, v in batch.items()}
    tl, taux, tg = _grads_of(loss_fn, params_from_numpy(rp, "cpu"), tbatch)
    direct, _ = TE.loss_fn(params_from_numpy(rp, "cpu"), tcfg, tbatch)
    assert torch.equal(tl, direct)
    np.testing.assert_allclose(float(tl), float(rl), rtol=TOL)
    assert float(taux["ntokens"]) == float(raux["ntokens"]) == B * (S - 1)
    want = _ref_names(rg)
    got = dict(tree_flatten_with_names(tg))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        _close(g, want[name], name)


def test_remat_changes_no_bit():
    """Each encoder and decoder block checkpointed: the same loss and
    gradients, bitwise."""
    tcfg = TC.get_smoke_config(ARCH)
    params = TE.init_params(torch.Generator().manual_seed(1), tcfg,
                            vocab_multiple=4)
    batch = {k: _t(v) for k, v in _batch(tcfg, 1).items()}
    out = [_grads_of(make_loss_fn(dataclasses.replace(tcfg, remat=r),
                                  TT.DistCtx()), params, batch)
           for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_reference():
    """Prefill of 12 frames and 6 tokens, then 4 decode steps (teacher
    forced), fp32 caches: every step's logits against the reference's,
    and against the port's own teacher-forced forward within 2e-3 (the
    reference's ``tests/test_models.py``)."""
    rcfg, tcfg = _cfgs()
    rp = _ref_params()
    tp = params_from_numpy(rp, "cpu")
    frames, toks = _inputs(rcfg)
    k = 6
    rcache = RE.init_cache(rcfg, B, 32, T, dtype=jnp.float32)
    rpre = jax.jit(lambda p, f, t, c: RE.prefill(p, rcfg, f, t, c))
    rdec = jax.jit(lambda p, t, pos, c: RE.decode_step(p, rcfg, t, pos, c))
    want, rcache = rpre(rp, frames, toks[:, :k], rcache)
    tcache = TE.init_cache(tcfg, B, 32, T, dtype=torch.float32)
    with torch.no_grad():
        got, tcache = TE.prefill(tp, tcfg, _t(frames), _t(toks[:, :k]),
                                 tcache)
        full = _port_forward(tp, tcfg, frames, toks)[1]
    steps = [(got, want, full[:, k - 1])]
    for i in range(k, k + 4):
        pos = np.full((B,), i, np.int32)
        want, rcache = rdec(rp, toks[:, i], pos, rcache)
        with torch.no_grad():
            got, tcache = TE.decode_step(tp, tcfg, _t(toks[:, i]), _t(pos),
                                         tcache)
        steps.append((got, want, full[:, i]))
    np.testing.assert_array_equal(tcache["enc_pos"].numpy(),
                                  np.asarray(rcache["enc_pos"]))
    for n, (g, w, f) in enumerate(steps):
        assert g.shape == (B, 128)
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL, atol=TOL,
                                   err_msg=f"step {n}")
        np.testing.assert_allclose(_np(g), _np(f), rtol=2e-3, atol=2e-3,
                                   err_msg=f"step {n} against the forward")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_trainer_steps_match_reference_trainer():
    """Five AdamW steps of both packages' ``Trainer`` on the same batches,
    the port with remat on, the reference with it off (it moves no
    value)."""
    rcfg, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, remat=True)
    rp = _ref_params()
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    batches = [_batch(rcfg, seed) for seed in range(5)]
    rtr = RTrainer(jax.jit(rmake_train_step(rcfg, RT.DistCtx(),
                                            RAdamWConfig(**ocfg))),
                   iter(batches), RTrainState(rp, radamw_init(rp)),
                   log_fn=lambda _s: None)
    tp = params_from_numpy(rp, "cpu")
    ttr = Trainer(make_train_step(tcfg, TT.DistCtx(), AdamWConfig(**ocfg)),
                  iter([{k: _t(v) for k, v in bt.items()}
                        for bt in batches]),
                  TrainState(tp, adamw_init(tp)), log_fn=lambda _s: None)
    rl, tl = rtr.run(5), ttr.run(5)
    np.testing.assert_allclose(tl, rl, rtol=1e-3)
    assert tl[-1] < tl[0]
    assert int(ttr.state.opt_state["count"]) == 5
