"""repro_torch's xlstm inference against the JAX reference.

The same inputs, made with numpy from fixed seeds, and the same parameters
(the reference's, carried over with ``params_from_numpy``) go through both
packages at the smoke size of xlstm-125m (4 layers, d_model 64, 4 heads,
hd 16, vocab 128, chunk 8): the parameter tree's leaf names and shapes,
the sLSTM scan's plain version (K8's) against ``slstm_scan_call`` in
interpret mode, the mLSTM and sLSTM mixers with and without state, the
forward, prefill + decode, and the serving engine's tokens.  Inside the
port: the mLSTM chunked == stepwise, batched == solo tokens, and the
launcher on the CPU.  Every reference call is jitted; the file starts no
XLA subprocess.

Tolerances: the plain scan against the Pallas kernel rtol = atol 2e-4 (the
reference's own, ``tests/test_kernels_slstm.py``); the mixers rtol = atol
1e-5 (fp32 in another order); forwards and prefill/decode against the
reference rtol = atol 2e-4, prefill/decode against the port's own forward
2e-3 (the reference's ``tests/test_models.py``); chunked against stepwise
mLSTM 3e-3 (the reference's ``tests/test_mixers.py``).  Token comparisons
first assert that every sampling step's top-2 margin in the reference is
over ten times the logits' tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.slstm_scan import expand_blockdiag, slstm_scan_call
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro.serve import ServeEngine as RServeEngine

from repro_torch import configs as TC
from repro_torch.core.gnn import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import slstm_scan as k8
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.train.tree import tree_flatten_with_names

from test_torch_lm import TOL, _fp32, _margins_hold, _np, _Recorder, _t

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)

ARCH = "xlstm-125m"


def _cfgs(**kw):
    return (_fp32(RC.get_smoke_config(ARCH), **kw),
            _fp32(TC.get_smoke_config(ARCH), **kw))


def _ref_params(cfg, seed=0):
    return jax.jit(lambda k: RT.init_params(k, cfg, vocab_multiple=4))(
        jax.random.key(seed))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (b, s)) \
        .astype(np.int32)


def _slstm_state(rng, b, heads, hd):
    """A non-trivial sLSTM state: h, c and m of either sign, n in [0.5,
    2)."""
    shape = (b, heads, hd)
    return dict(h=rng.normal(size=shape).astype(np.float32) * 0.5,
                c=rng.normal(size=shape).astype(np.float32),
                n=rng.uniform(0.5, 2.0, shape).astype(np.float32),
                m=rng.normal(size=shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------

def test_init_params_tree_matches_reference():
    cfg = RC.get_smoke_config(ARCH)
    paths, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: RT.init_params(k, cfg, vocab_multiple=16),
        jax.random.key(0)))
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in paths}
    got = dict(tree_flatten_with_names(TT.init_params(
        torch.Generator().manual_seed(0), TC.get_smoke_config(ARCH),
        vocab_multiple=16)))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype) == f"torch.{want[name].dtype}", name


def test_init_params_draws_the_reference_distributions():
    cfg = dataclasses.replace(TC.get_config(ARCH), n_layers=2, vocab=256)
    p = TT.init_params(torch.Generator().manual_seed(0), cfg)
    wr = p["xl_1_s"]["mix"]["wr"]
    assert wr.shape == (1, 4, 192, 768)
    assert abs(wr.std().item() * 192 ** 0.5 - 1) < 0.02
    assert torch.equal(p["xl_0_m"]["mix"]["fgate_bias"],
                       torch.full((1, 4), 3.0))
    assert torch.equal(p["xl_1_s"]["mix"]["bias"], torch.zeros(1, 3072))
    up = p["xl_0_m"]["mix"]["up"]["w"]
    assert abs(up.std().item() / (2.0 / (768 + 3072)) ** 0.5 - 1) < 0.02


def test_init_cache_is_fp32_stacked_by_group():
    cfg = TC.get_smoke_config(ARCH)
    cache = TT.init_cache(cfg, 3, 32, dtype=torch.bfloat16)
    want = jax.eval_shape(lambda: RT.init_cache(
        RC.get_smoke_config(ARCH), 3, 32, dtype=jnp.bfloat16))
    assert sorted(cache) == sorted(want) == ["xl_0_m", "xl_1_s"]
    for name in cache:
        for k, v in cache[name].items():
            assert tuple(v.shape) == want[name][k].shape
            assert v.dtype == torch.float32
    assert torch.equal(cache["xl_1_s"]["n"], torch.ones(2, 3, 4, 16))
    assert torch.equal(cache["xl_0_m"]["m"], torch.full((2, 3, 4), -1e30))


# ---------------------------------------------------------------------------
# K8's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,heads,hd,zero_state",
                         [(2, 12, 4, 16, True), (3, 9, 2, 8, True),
                          (2, 12, 4, 16, False), (1, 20, 1, 8, False)])
def test_plain_scan_matches_pallas_kernel(b, s, heads, hd, zero_state):
    """``slstm_scan_ref`` in the model's head-major layout against
    ``slstm_scan_call`` (interpret mode) given the gate-major permutation
    of xp and the block-diagonal expansion of wr, as the reference's
    kernel test feeds it; the hidden states and all four final states."""
    rng = np.random.default_rng(b * s + hd)
    d = heads * hd
    xp = rng.normal(size=(b, s, 4 * d)).astype(np.float32)
    wr = (rng.normal(size=(heads, hd, 4 * hd)) * hd ** -0.5).astype(
        np.float32)
    st = (dict(h=np.zeros((b, heads, hd), np.float32),
               c=np.zeros((b, heads, hd), np.float32),
               n=np.ones((b, heads, hd), np.float32),
               m=np.zeros((b, heads, hd), np.float32))
          if zero_state else _slstm_state(rng, b, heads, hd))
    # model head-major [h0: z|i|f|o, h1: ...] -> kernel gate-major
    perm = np.arange(4 * d).reshape(heads, 4, hd).transpose(1, 0, 2) \
        .reshape(-1)

    @jax.jit
    def pallas(xp, wr, st):
        return slstm_scan_call(
            xp[:, :, perm], expand_blockdiag(wr),
            {k: v.reshape(b, d) for k, v in st.items()}, heads=heads, hd=hd,
            interpret=True)

    want_h, want_st = pallas(xp, wr, st)
    got_h, got_st = ref.slstm_scan_ref(
        _t(xp), _t(wr), {k: _t(v) for k, v in st.items()})
    assert got_h.shape == (b, s, heads, hd) and got_h.dtype == torch.float32
    np.testing.assert_allclose(_np(got_h).reshape(b, s, d), _np(want_h),
                               rtol=2e-4, atol=2e-4)
    for k in "hcnm":
        np.testing.assert_allclose(_np(got_st[k]).reshape(b, d),
                                   _np(want_st[k]), rtol=2e-4, atol=2e-4)


def test_k8_wrapper_refuses_cpu_tensors():
    """On the CPU the front door takes the plain version; the kernel's own
    wrapper takes CUDA tensors only."""
    xp = torch.zeros(1, 3, 32)
    wr = torch.zeros(1, 8, 32)
    st = {k: torch.zeros(1, 1, 8) for k in "hcnm"}
    with pytest.raises(ValueError, match="CUDA kernel"):
        k8.slstm_scan(xp, wr, st)
    got, got_st = ops.slstm_scan(xp, wr, st)
    want, want_st = ref.slstm_scan_ref(xp, wr, st)
    assert torch.equal(got, want)
    assert all(torch.equal(got_st[k], want_st[k]) for k in "hcnm")


@pytest.mark.parametrize("bt", range(1, k8.MAX_BT + 1))
def test_k8_launch_plan_fits_every_shape(bt):
    """K8's launch plan for every head_dim 1..256 at this bt: a portable
    cluster (2, 4 or 8 blocks; one block at hd 1) whose blocks fit an
    H100's 227 KB of shared memory, hold the block's slice of wr (hd ×
    4·ceil(hd / C) fp32) and h twice, and at least one and at most 48 units
    (384 threads); the smallest that leaves a block at most 16 units, else
    8."""
    limit = 227 * 1024
    for hd in range(1, k8.MAX_HEAD_DIM + 1):
        c, nbytes = k8.plan(hd, bt)
        units = -(-hd // c)
        assert c in (2, 4, 8) or (hd, c) == (1, 1), (hd, c)
        assert nbytes <= limit and (c - 1) * units < hd, (hd, c, nbytes)
        assert nbytes == k8.smem_bytes(hd, bt, c)
        assert nbytes >= 4 * (hd * 4 * units + 2 * bt * hd)
        assert units <= 48 and c in k8.cluster_sizes(hd, bt)
        assert units <= 16 or c == 8, (hd, c)
        assert all(-(-hd // small) > 16 for small in (2, 4, 8)
                   if small < c), (hd, c)
    assert k8.plan(192, bt)[0] == 8          # xlstm-125m: 24 units a block
    assert k8.plan(64, bt)[0] == 4
    assert k8.plan(32, bt)[0] == 2
    assert k8.plan(256, bt)[0] == 8          # 262 KB of wr at 4 blocks
    assert k8.cluster_sizes(192, bt) == [4, 8]
    assert k8.cluster_sizes(256, bt) == [8]


@pytest.mark.parametrize("hd,bt", [(320, 8), (400, 1), (1024, 4)])
def test_k8_launch_plan_raises_where_no_cluster_fits(hd, bt):
    assert k8.cluster_sizes(hd, bt) == []
    with pytest.raises(ValueError, match="fits no portable cluster"):
        k8.plan(hd, bt)


def test_k8_launch_plan_follows_the_limit_and_refuses_bad_bt():
    """A size whose blocks exceed the shared-memory limit is not offered
    (hd 256 at 4 blocks: 262 KB of wr a block); bt outside 1..8 raises."""
    assert k8.plan(192, 2) == (8, 79_888)
    for bt in range(1, k8.MAX_BT + 1):
        assert k8.smem_bytes(256, bt, 4) > k8.SMEM_LIMIT
        assert k8.smem_bytes(256, bt, 8) <= k8.SMEM_LIMIT
        assert k8.cluster_sizes(256, bt) == [8]
    for bt in (0, 9):
        with pytest.raises(ValueError, match="out of range"):
            k8.plan(64, bt)


@pytest.mark.parametrize("hd,sizes,planned", [
    (1, [1], 1), (6, [1, 2], 2), (9, [1, 2], 2), (49, [2, 4], 4),
    (100, [4, 8], 8)])
def test_k8_every_block_of_a_cluster_holds_a_unit(hd, sizes, planned):
    """K8's exchange of h needs every block of the cluster to send, so no
    size that leaves a block with no unit is offered: hd 6 and 9 at 4 or 8
    blocks, 49 at 8; a head of one unit runs in a cluster of one block.
    One block is offered to hd 48 and below but planned only at hd 1."""
    for bt in (1, 8):
        assert k8.cluster_sizes(hd, bt) == sizes
        assert k8.plan(hd, bt)[0] == planned
        for c in sizes:
            assert (c - 1) * -(-hd // c) < hd


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

def _mixer_state(kind, cfg, b, rng):
    if kind == "s":
        return _slstm_state(rng, b, cfg.n_heads, cfg.d_model // cfg.n_heads)
    d_in = 2 * cfg.d_model
    dk = d_in // cfg.n_heads
    return dict(
        c=rng.normal(size=(b, cfg.n_heads, dk, dk)).astype(np.float32) * 0.1,
        n=rng.normal(size=(b, cfg.n_heads, dk)).astype(np.float32),
        m=rng.normal(size=(b, cfg.n_heads)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kind", ["m", "s"])
def test_mixer_matches_reference(kind, with_state):
    """mlstm_apply (two chunks of 8) and slstm_apply, fresh or from a
    random state: the output and the new state."""
    cfg, tcfg = _cfgs()
    init, apply = ((RX.mlstm_init, RX.mlstm_apply) if kind == "m"
                   else (RX.slstm_init, RX.slstm_apply))
    tapply = TX.mlstm_apply if kind == "m" else TX.slstm_apply
    p = jax.jit(lambda k: init(k, cfg))(jax.random.key(3))
    rng = np.random.default_rng(4)
    b, s = 2, 16
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    st = _mixer_state(kind, cfg, b, rng) if with_state else None
    want, want_st = jax.jit(lambda p, x, st: apply(p, x, cfg, state=st))(
        p, x, st)
    got, got_st = tapply(params_from_numpy(p, "cpu"), _t(x), tcfg,
                         state=None if st is None else
                         {k: _t(v) for k, v in st.items()})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert (got_st is None) == (want_st is None)
    for k in (want_st or {}):
        np.testing.assert_allclose(_np(got_st[k]), _np(want_st[k]),
                                   rtol=1e-5, atol=1e-5)


def test_slstm_cell_matches_reference():
    """One step of ``_slstm_cell`` from a random state."""
    cfg, tcfg = _cfgs()
    p = jax.jit(lambda k: RX.slstm_init(k, cfg))(jax.random.key(5))
    rng = np.random.default_rng(7)
    xt = rng.normal(size=(3, 4 * cfg.d_model)).astype(np.float32)
    st = _slstm_state(rng, 3, cfg.n_heads, cfg.d_model // cfg.n_heads)
    want = jax.jit(lambda p, x, st: RX._slstm_cell(p, x, st, cfg))(p, xt, st)
    got = TX._slstm_cell(params_from_numpy(p, "cpu"), _t(xt),
                         {k: _t(v) for k, v in st.items()}, tcfg)
    for k in "hcnm":
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("chunk", [4, 8])
def test_mlstm_chunked_equals_stepwise(chunk):
    """The port's chunkwise-parallel mLSTM against its own step-by-step
    decode (``tests/test_mixers.py:56-75`` for the reference)."""
    tcfg = dataclasses.replace(TC.get_smoke_config(ARCH), ssm_chunk=chunk)
    p = TX.mlstm_init(torch.Generator().manual_seed(0), tcfg)
    b, s = 2, 16
    x = _t(np.random.default_rng(5).normal(
        size=(b, s, tcfg.d_model)).astype(np.float32))
    y_seq, st_seq = TX.mlstm_apply(p, x, tcfg,
                                   state=TX.mlstm_state_init(tcfg, b))
    st = TX.mlstm_state_init(tcfg, b)
    ys = []
    for t in range(s):
        yt, st = TX.mlstm_step(p, x[:, t:t + 1], tcfg, st)
        ys.append(yt)
    np.testing.assert_allclose(_np(y_seq), _np(torch.cat(ys, dim=1)),
                               rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(_np(st_seq["c"]), _np(st["c"]), rtol=3e-3,
                               atol=3e-3)


def test_slstm_apply_equals_stepwise():
    """One scan over 12 steps against 12 scans of one step with the state
    carried (the reference's ``tests/test_mixers.py:78-90``; the
    projections multiply other shapes, so allclose)."""
    tcfg = TC.get_smoke_config(ARCH)
    p = TX.slstm_init(torch.Generator().manual_seed(0), tcfg)
    b, s = 2, 12
    x = _t(np.random.default_rng(6).normal(
        size=(b, s, tcfg.d_model)).astype(np.float32))
    y_seq, st_seq = TX.slstm_apply(p, x, tcfg,
                                   state=TX.slstm_state_init(tcfg, b))
    st = TX.slstm_state_init(tcfg, b)
    ys = []
    for t in range(s):
        yt, st = TX.slstm_step(p, x[:, t:t + 1], tcfg, st)
        ys.append(yt)
    np.testing.assert_allclose(_np(y_seq), _np(torch.cat(ys, dim=1)),
                               rtol=1e-5, atol=1e-5)
    for k in "hcnm":
        np.testing.assert_allclose(_np(st_seq[k]), _np(st[k]), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_matches_reference():
    cfg, tcfg = _cfgs()
    params = _ref_params(cfg)
    toks = _tokens(cfg, 2, 20, 0)                # chunks of 8 do not divide
    want, _ = jax.jit(lambda p, t: RT.forward(p, cfg, t))(params, toks)
    got, cache = TT.forward(params_from_numpy(params, "cpu"), tcfg, _t(toks))
    assert cache is None and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def test_bf16_forward_stays_close_to_reference():
    """The configs' bf16 compute: both packages round at other places, so
    the logits agree only to bf16's few digits; finite, and the argmax
    mostly shared."""
    cfg = dataclasses.replace(RC.get_smoke_config(ARCH), remat=False)
    tcfg = TC.get_smoke_config(ARCH)
    params = _ref_params(cfg)
    toks = _tokens(cfg, 2, 16, 1)
    want, _ = jax.jit(lambda p, t: RT.forward(p, cfg, t))(params, toks)
    got, _ = TT.forward(params_from_numpy(params, "cpu"), tcfg, _t(toks))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=0.1, atol=0.1)
    assert (_np(got).argmax(-1) == _np(want).argmax(-1)).mean() > 0.9


@pytest.mark.parametrize("k", [7, 9])
def test_prefill_decode_matches_reference_and_forward(k):
    """prefill(t[:k]) then decode(t[k]) against the reference's and
    against the port's own forward(t[:k+1]); k = 9 runs a chunk of 8 and
    a remainder as one chunk of 9."""
    cfg, tcfg = _cfgs()
    params = _ref_params(cfg, seed=1)
    tp = params_from_numpy(params, "cpu")
    toks = _tokens(cfg, 2, 10, 3)
    b = 2
    pos = np.full((b,), k, np.int32)

    @jax.jit
    def ref_run(p, toks):
        cache = RT.init_cache(cfg, b, 32, dtype=jnp.float32)
        lg, cache = RT.prefill(p, cfg, toks[:, :k], cache)
        lg2, cache = RT.decode_step(p, cfg, toks[:, k], pos, cache)
        return lg, lg2, cache

    want1, want2, want_cache = ref_run(params, toks)
    cache = TT.init_cache(tcfg, b, 32, dtype=torch.float32)
    got1, cache = TT.prefill(tp, tcfg, _t(toks[:, :k]), cache)
    got2, cache = TT.decode_step(tp, tcfg, _t(toks[:, k]), _t(pos), cache)
    np.testing.assert_allclose(_np(got1), _np(want1), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(got2), _np(want2), rtol=TOL, atol=TOL)
    for name in want_cache:
        for key in want_cache[name]:
            np.testing.assert_allclose(_np(cache[name][key]),
                                       _np(want_cache[name][key]), rtol=TOL,
                                       atol=TOL)
    full, _ = TT.forward(tp, tcfg, _t(toks[:, :k + 1]))
    np.testing.assert_allclose(_np(got1), _np(full[:, k - 1]), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(_np(got2), _np(full[:, k]), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

# a parameter seed whose every sampling step clears the margin that
# ``_margins_hold`` asserts (the smoke model's 128 logits lie close; with
# seed 0 one greedy step's top two logits are 0.005 apart)
PARAM_SEED = 1


@pytest.fixture(scope="module")
def served_pair():
    """One reference engine and one port engine on the same parameters
    (smoke xlstm-125m, fp32 compute): 4 prompts of three lengths over 2
    slots."""
    cfg, tcfg = _cfgs()
    params = _ref_params(cfg, seed=PARAM_SEED)
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


def test_continuous_batching_matches_solo_runs():
    """Every cache leaf of an admission lands in its slot: batching 5
    prompts through 2 slots reproduces each prompt's solo generation."""
    _, tcfg = _cfgs()
    params = TT.init_params(torch.Generator().manual_seed(2), tcfg,
                            vocab_multiple=4)
    eng = TServeEngine(params, tcfg, batch_slots=2, max_seq=64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab, size=rng.integers(2, 12))
               .astype(np.int32) for _ in range(5)]
    batched = eng.generate(prompts, max_new=6)
    for i, p in enumerate(prompts):
        solo = eng.generate([p], max_new=6)[0]
        assert batched[i].tokens == solo.tokens, (i, batched[i], solo)


def test_launcher_on_cpu(capsys):
    rep = tserve.main(["--device", "cpu", "--arch", ARCH, "--smoke"])
    assert rep["device"] == "cpu" and rep["arch"] == ARCH
    assert rep["requests"] == 8
    assert all(r.steps == 32 for r in rep["results"])
    assert len(rep["prefill_ms"]) == 8 and rep["tokens_per_s"] > 0
    assert "8 requests, 256 tokens" in capsys.readouterr().out
