"""repro_torch's dense-LM inference against the JAX reference.

The same inputs, made with numpy from fixed seeds, and the same parameters
(the reference's, carried over with ``params_from_numpy``) go through both
packages: the ten configs and their ``smoke()`` reductions field for field,
the parameter tree's leaf names and shapes, the norms, rotary embeddings
and the chunked ring-cache attention, the plain flash attention (K7's plain
version) against ``flash_attention_call`` in interpret mode, the smoke
mistral-nemo forward with the flash flag off and on and with a sliding
window, prefill and decode, and the serving engine's tokens.  Inside the
port: batched == solo tokens, EOS refill, and the launcher on the CPU.
Every reference call is jitted; the file starts no XLA subprocess.

Tolerances: the layers rtol 1e-5 (fp32 in another order); the plain flash
against the Pallas kernel fp32 rtol = atol 2e-5 (the reference's own
kernel tolerance, ``tests/test_kernels_flash.py``), bf16 3e-2; forwards
and prefill/decode against the reference rtol = atol 2e-4 (the reference's
flash on/off tolerance), prefill/decode against the port's own forward
2e-3 (the reference's ``tests/test_models.py``).  Token comparisons first
assert that every sampling step's top-2 margin in the reference is over
ten times the logits' tolerance, so a mismatch is a real difference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.flash_attention import flash_attention_call
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve import ServeEngine as RServeEngine

from repro_torch import configs as TC
from repro_torch.core.gnn import params_from_numpy
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.train.tree import tree_flatten_with_names

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

TOL = 2e-4
DENSE = [a for a in RC.ARCH_IDS
         if RC.get_config(a).family in ("dense", "vlm")]
# the moe and hybrid families (their own files: tests/test_torch_moe.py,
# tests/test_torch_hybrid.py); the xlstm family has tests/test_torch_xlstm.py
MOE_HYBRID = [a for a in RC.ARCH_IDS
              if RC.get_config(a).family in ("moe", "hybrid")]
LATER = [a for a in RC.ARCH_IDS
         if RC.get_config(a).family not in ("dense", "vlm", "xlstm", "moe",
                                            "hybrid")]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _fp32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", remat=False,
                               **kw)


def _ref_params(cfg, seed=0):
    return jax.jit(lambda k: RT.init_params(k, cfg, vocab_multiple=4))(
        jax.random.key(seed))


def _ref_names(params):
    paths, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in paths}


# ---------------------------------------------------------------------------
# configs and the parameter tree
# ---------------------------------------------------------------------------

def test_arch_ids_and_shapes_match_reference():
    assert TC.ARCH_IDS == RC.ARCH_IDS
    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in RC.SHAPES.items()}


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_config_matches_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        r, t = getattr(RC, get)(arch), getattr(TC, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(r), (arch, get)
        assert t.param_count() == r.param_count()
        assert t.is_subquadratic == r.is_subquadratic
        assert str(t.pdtype) == f"torch.{r.pdtype}"
        assert str(t.cdtype) == f"torch.{r.cdtype}"
        for name, shape in TC.SHAPES.items():
            assert TC.shape_applicable(t, shape) == \
                RC.shape_applicable(r, RC.SHAPES[name])


@pytest.mark.parametrize("arch", DENSE + MOE_HYBRID)
def test_init_params_tree_matches_reference(arch):
    """The port's tree has the reference's leaf names, shapes and dtypes
    (at the smoke size: same family and layout)."""
    cfg = RC.get_smoke_config(arch)
    want = _ref_names(jax.eval_shape(
        lambda k: RT.init_params(k, cfg, vocab_multiple=16),
        jax.random.key(0)))
    got = dict(tree_flatten_with_names(TT.init_params(
        torch.Generator().manual_seed(0), TC.get_smoke_config(arch),
        vocab_multiple=16)))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype) == f"torch.{want[name].dtype}", name


def test_init_params_draws_the_reference_distributions():
    cfg = TC.get_config("mistral-nemo-12b")
    small = dataclasses.replace(cfg, n_layers=1, d_model=256, d_ff=384,
                                vocab=1024)
    p = TT.init_params(torch.Generator().manual_seed(0), small)
    w = p["blocks"]["mlp"]["gate"]["w"]
    assert w.shape == (1, 256, 384)
    assert abs(w.std().item() / (2.0 / (256 + 384)) ** 0.5 - 1) < 0.02
    assert abs(p["embed"]["w"].std().item() * 256 ** 0.5 - 1) < 0.02
    assert torch.equal(p["blocks"]["ln1"]["scale"], torch.ones(1, 256))


def test_moe_and_ssm_inits_draw_the_reference_distributions():
    """The experts ~ N(0, 2 / (d + f)); the mamba block's conv ~ N(0,
    0.01), ``a_log``/``dt_bias`` zeros and ``d_skip`` ones in fp32
    whatever ``param_dtype`` is; the shared block unstacked."""
    moe = dataclasses.replace(TC.get_config("granite-moe-1b-a400m"),
                              n_layers=1, vocab=1024)
    p = TT.init_params(torch.Generator().manual_seed(0), moe)
    w = p["blocks"]["moe"]["w_up"]
    assert w.shape == (1, 32, 1024, 512)
    assert abs(w.std().item() / (2.0 / (1024 + 512)) ** 0.5 - 1) < 0.02
    hyb = dataclasses.replace(TC.get_config("zamba2-7b"), n_layers=2,
                              attn_every=1, d_model=256, d_ff=384, vocab=1024,
                              n_heads=2, n_kv_heads=2, head_dim=128,
                              param_dtype="bfloat16")
    p = TT.init_params(torch.Generator().manual_seed(0), hyb)
    ssm = p["mamba_main"]["ssm"]
    assert ssm["conv_w"].dtype == torch.bfloat16
    assert abs(ssm["conv_w"].float().std().item() / 0.1 - 1) < 0.05
    for name, value in (("a_log", 0.0), ("dt_bias", 0.0), ("d_skip", 1.0)):
        assert ssm[name].dtype == torch.float32
        assert torch.equal(ssm[name], torch.full((2, 8), value))
    assert p["shared_attn"]["attn"]["wq"]["w"].shape == (256, 256)


@pytest.mark.parametrize("arch", LATER)
def test_later_families_raise(arch):
    cfg = TC.get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    assert cfg.family == "encdec"
    with pytest.raises(ValueError):
        TT.init_params(gen, cfg)
    with pytest.raises(NotImplementedError, match="whisper"):
        TServeEngine({"embed": {"w": torch.zeros(1)}}, cfg)


@pytest.mark.parametrize("arch", MOE_HYBRID)
def test_moe_and_hybrid_families_build_and_step(arch):
    """The archs that raised before their slice build, run the forward,
    prefill + a decode step, and a loss with a gradient (smoke size)."""
    cfg = TC.get_smoke_config(arch)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.ones(2, 9, dtype=torch.int32)
    logits, _ = TT.forward(params, cfg, toks)
    assert logits.shape[:2] == (2, 9) and torch.isfinite(logits).all()
    cache = TT.init_cache(cfg, 2, 16, dtype=torch.float32)
    lg, cache = TT.prefill(params, cfg, toks[:, :8], cache)
    lg2, _ = TT.decode_step(params, cfg, toks[:, 8],
                            torch.full((2,), 8, dtype=torch.int32), cache)
    assert torch.isfinite(lg).all() and torch.isfinite(lg2).all()
    w = params["embed"]["w"].clone().requires_grad_(True)
    loss, _ = TT.loss_fn(dict(params, embed=dict(w=w)), cfg,
                         dict(tokens=toks))
    loss.backward()
    assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0


def test_mesh_raises_naming_the_roadmap_item():
    ctx = TT.DistCtx(mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        TL.ring_tp_colwise(torch.ones(1, 2, 3), torch.ones(3, 4), ctx)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        TL.ring_tp_rowwise(torch.ones(1, 2, 3), torch.ones(3, 4), ctx)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    want = jax.jit(lambda x, w: RL.rms_norm(x, w, 1e-6))(x, w)
    np.testing.assert_allclose(_np(TL.rms_norm(_t(x), _t(w), 1e-6)),
                               _np(want), rtol=1e-5, atol=1e-6)
    want = jax.jit(lambda x, w, b: RL.layer_norm(x, w, b, 1e-5))(x, w, b)
    np.testing.assert_allclose(_np(TL.layer_norm(_t(x), _t(w), _t(b), 1e-5)),
                               _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 6)).astype(np.int32)
    want = jax.jit(lambda x, p: RL.apply_rope(x, p, theta))(x, pos)
    np.testing.assert_allclose(_np(TL.apply_rope(_t(x), _t(pos), theta)),
                               _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 4])
def test_chunked_attention_matches_reference_on_a_ring(window):
    """Decode-shaped attention over a wrapped ring cache: slots out of
    position order, empty (-1) slots, a chunk that does not divide T."""
    rng = np.random.default_rng(2)
    b, s, h, kv, hd, t = 2, 3, 4, 2, 16, 10
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    q_pos = np.array([[11, 12, 13], [5, 6, 7]], np.int32)
    k_pos = np.array([[10, 11, 12, 13, 4, 5, 6, 7, 8, 9],
                      [0, 1, 2, 3, 4, 5, 6, 7, -1, -1]], np.int32)
    want = jax.jit(lambda *a: RL._chunked_softmax_attention(
        *a, window, 4))(q, k, v, q_pos, k_pos)
    got = TL._chunked_softmax_attention(_t(q), _t(k), _t(v), _t(q_pos),
                                        _t(k_pos), window, 4)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


# the reference's cases (tests/test_kernels_flash.py):
# (B, S, H, KV, hd, causal, window, bq, bk)
FLASH_CASES = [
    (2, 64, 4, 4, 16, True, 0, 16, 16),
    (1, 128, 8, 2, 32, True, 0, 32, 64),
    (2, 96, 4, 1, 16, True, 32, 32, 32),
    (1, 50, 2, 2, 8, True, 0, 128, 128),
    (1, 64, 4, 4, 16, False, 0, 16, 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,bq,bk", FLASH_CASES)
def test_plain_flash_matches_pallas_kernel(b, s, h, kv, hd, causal, window,
                                           bq, bk, dtype):
    rng = np.random.default_rng(s + h)
    q, k, v = (rng.normal(size=(b, s, n, hd)).astype(np.float32)
               for n in (h, kv, kv))
    want = jax.jit(lambda q, k, v: flash_attention_call(
        *(jnp.asarray(a, dtype).transpose(0, 2, 1, 3) for a in (q, k, v)),
        causal=causal, window=window, bq=bq, bk=bk,
        interpret=True).transpose(0, 2, 1, 3))(q, k, v)
    td = getattr(torch, dtype)
    got = ops.flash_attention(*(_t(a).to(td) for a in (q, k, v)),
                              causal=causal, window=window)
    assert got.dtype == td and got.shape == (b, s, h, hd)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_k7_wrapper_refuses_cpu_tensors():
    """On the CPU the front door takes the plain version; the kernel's own
    wrapper takes CUDA tensors only."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k7.flash_attention(q, q, q)
    assert torch.equal(ops.flash_attention(q, q, q),
                       ref.flash_attention(q, q, q))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

NEMO = "mistral-nemo-12b"


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (b, s)) \
        .astype(np.int32)


@pytest.mark.parametrize("flash,window", [(False, 0), (True, 0), (False, 4),
                                          (True, 4)])
def test_nemo_forward_matches_reference(flash, window):
    """The cache-less forward of the smoke mistral-nemo in fp32, flash
    flag off and on (the reference's Pallas kernel in interpret mode; the
    port's plain flash on the CPU), with and without a sliding window."""
    cfg = _fp32(RC.get_smoke_config(NEMO), use_flash_attention=flash,
                sliding_window=window)
    tcfg = _fp32(TC.get_smoke_config(NEMO), use_flash_attention=flash,
                 sliding_window=window)
    params = _ref_params(cfg)
    toks = _tokens(cfg, 2, 16, 0)
    want, _ = jax.jit(lambda p, t: RT.forward(p, cfg, t))(params, toks)
    got, _ = TT.forward(params_from_numpy(params, "cpu"), tcfg, _t(toks))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["qwen3-32b", "starcoder2-15b",
                                  "internvl2-76b"])
def test_dense_family_forward_matches_reference(arch):
    """qk_norm (qwen3), LayerNorm + tanh-GELU (starcoder2) and the visual
    prefix (internvl2) in the cache-less forward, fp32."""
    cfg = _fp32(RC.get_smoke_config(arch))
    tcfg = _fp32(TC.get_smoke_config(arch))
    params = _ref_params(cfg, seed=1)
    toks = _tokens(cfg, 2, 12, 1)
    vis = (np.random.default_rng(2).normal(
        size=(2, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm" else None)
    want, _ = jax.jit(lambda p, t, v: RT.forward(p, cfg, t, vis=v))(
        params, toks, vis)
    got, _ = TT.forward(params_from_numpy(params, "cpu"), tcfg, _t(toks),
                        vis=None if vis is None else _t(vis))
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [0, 4])
def test_prefill_decode_matches_reference_and_forward(window):
    """prefill(t[:k]) then decode(t[k]) against the reference's and
    against the port's own forward(t[:k+1]); window 4 wraps the ring."""
    cfg = _fp32(RC.get_smoke_config(NEMO), sliding_window=window)
    tcfg = _fp32(TC.get_smoke_config(NEMO), sliding_window=window)
    params = _ref_params(cfg, seed=1)
    tp = params_from_numpy(params, "cpu")
    toks = _tokens(cfg, 2, 10, 3)
    k, b = 7, 2
    pos = np.full((b,), k, np.int32)

    @jax.jit
    def ref_run(p, toks):
        cache = RT.init_cache(cfg, b, 32, dtype=jnp.float32)
        lg, cache = RT.prefill(p, cfg, toks[:, :k], cache)
        lg2, _ = RT.decode_step(p, cfg, toks[:, k], pos, cache)
        return lg, lg2

    want1, want2 = ref_run(params, toks)
    cache = TT.init_cache(tcfg, b, 32, dtype=torch.float32)
    got1, cache = TT.prefill(tp, tcfg, _t(toks[:, :k]), cache)
    got2, _ = TT.decode_step(tp, tcfg, _t(toks[:, k]), _t(pos), cache)
    np.testing.assert_allclose(_np(got1), _np(want1), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(got2), _np(want2), rtol=TOL, atol=TOL)
    full, _ = TT.forward(tp, tcfg, _t(toks[:, :k + 1]))
    np.testing.assert_allclose(_np(got1), _np(full[:, k - 1]), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(_np(got2), _np(full[:, k]), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class _Recorder:
    """The reference engine's ``_sample`` (the same draws), recording the
    scores each step takes the argmax of."""

    def __init__(self, eng):
        self.scores, self._eng = [], eng

    def __call__(self, logits, temperature, rng):
        z = np.asarray(logits, np.float64)
        if temperature > 0:
            z = z / temperature + rng.gumbel(size=z.shape)
        self.scores.append((z, np.abs(logits).max() / max(temperature, 1)
                            if temperature > 0 else np.abs(logits).max()))
        return z.argmax(-1).astype(np.int32)


def _margins_hold(rec, temperature):
    """Every sampled row's top-2 margin is over 10x the logits' tolerance
    (scaled by 1/temperature for Gumbel-max)."""
    scale = 1.0 / temperature if temperature > 0 else 1.0
    for z, zmax in rec.scores:
        top2 = np.sort(z, axis=-1)[:, -2:]
        tol = TOL * (1 + zmax) * scale
        assert (top2[:, 1] - top2[:, 0] > 10 * tol).all(), (top2, tol)


@pytest.fixture(scope="module")
def served_pair():
    """One reference engine and one port engine on the same parameters
    (smoke mistral-nemo, fp32 compute): 4 prompts of three lengths over 2
    slots, so every decode row is an active request.  The smoke model's
    128 logits lie close together: parameter seed 1 is one whose every
    sampling step clears the margin that ``_margins_hold`` asserts (seed 2
    does not: one greedy step's top two logits are 0.006 apart)."""
    cfg = _fp32(RC.get_smoke_config(NEMO))
    tcfg = _fp32(TC.get_smoke_config(NEMO))
    params = _ref_params(cfg, seed=1)
    r = RServeEngine(params, cfg, batch_slots=2, max_seq=64)
    t = TServeEngine(params_from_numpy(params, "cpu"), tcfg, batch_slots=2,
                     max_seq=64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (3, 5, 7, 5)]
    return r, t, prompts


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_served_tokens_match_reference(served_pair, temperature):
    r, t, prompts = served_pair
    r._sample = rec = _Recorder(r)
    want = r.generate(prompts, max_new=6, temperature=temperature, seed=0)
    _margins_hold(rec, temperature)
    got = t.generate(prompts, max_new=6, temperature=temperature, seed=0)
    assert [g.tokens for g in got] == [w.tokens for w in want]
    assert [(g.prompt_len, g.steps) for g in got] == \
        [(w.prompt_len, w.steps) for w in want]
    assert len(t.timings["prefill_s"]) == len(prompts)


def test_continuous_batching_matches_solo_runs():
    """Per-slot prefill + cache copy keeps slots isolated: batching 5
    prompts through 2 slots reproduces each prompt's solo generation."""
    cfg = _fp32(TC.get_smoke_config("codeqwen1.5-7b"))
    params = TT.init_params(torch.Generator().manual_seed(2), cfg,
                            vocab_multiple=4)
    eng = TServeEngine(params, cfg, batch_slots=2, max_seq=64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(2, 7))
               .astype(np.int32) for _ in range(5)]
    batched = eng.generate(prompts, max_new=6)
    for i, p in enumerate(prompts):
        solo = eng.generate([p], max_new=6)[0]
        assert batched[i].tokens == solo.tokens, (i, batched[i], solo)


def test_kept_logits_give_the_tokens_and_batched_equals_solo():
    """``keep_logits``: each token is the argmax of its kept row, and the
    batched run's rows equal the solo runs' step by step (fp32 on the
    CPU, 1e-5)."""
    cfg = _fp32(TC.get_smoke_config("codeqwen1.5-7b"))
    params = TT.init_params(torch.Generator().manual_seed(2), cfg,
                            vocab_multiple=4)
    eng = TServeEngine(params, cfg, batch_slots=2, max_seq=64)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(2, 7))
               .astype(np.int32) for _ in range(3)]
    batched = eng.generate(prompts, max_new=5, keep_logits=True)
    assert eng.generate(prompts[:1], max_new=5)[0].logits is None
    for i, p in enumerate(prompts):
        solo = eng.generate([p], max_new=5, keep_logits=True)[0]
        assert solo.logits.shape == (5, params["embed"]["w"].shape[0])
        assert solo.tokens == list(solo.logits.argmax(-1))
        np.testing.assert_allclose(batched[i].logits, solo.logits,
                                   rtol=1e-5, atol=1e-5)


def test_eos_frees_slot_for_refill():
    cfg = _fp32(TC.get_smoke_config("codeqwen1.5-7b"))
    params = TT.init_params(torch.Generator().manual_seed(4), cfg,
                            vocab_multiple=4)
    probe = TServeEngine(params, cfg, batch_slots=1, max_seq=64)
    prompt = np.array([5, 2, 7], np.int32)
    free_run = probe.generate([prompt], max_new=6)[0]
    cut = max(i for i, t in enumerate(free_run.tokens)
              if t not in free_run.tokens[:i])
    eos = free_run.tokens[cut]
    assert cut > 0
    eng = TServeEngine(params, cfg, batch_slots=1, max_seq=64, eos_id=eos)
    res = eng.generate([prompt, np.array([1, 3], np.int32)], max_new=6)
    assert res[0].tokens == free_run.tokens[:cut + 1]
    assert res[0].tokens[-1] == eos
    assert len(res[1].tokens) >= 1


def test_launcher_on_cpu(monkeypatch, capsys):
    rep = tserve.main(["--device", "cpu", "--arch", NEMO, "--smoke"])
    assert rep["device"] == "cpu" and rep["requests"] == 8
    assert all(r.steps == 32 for r in rep["results"])
    assert all(4 <= len(p) <= 16 for p in rep["prompts"])
    assert len(rep["prefill_ms"]) == 8 and rep["tokens_per_s"] > 0
    assert "8 requests, 256 tokens" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", NEMO, "--smoke"])
