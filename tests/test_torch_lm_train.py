"""repro_torch's LM training against the JAX reference.

The same inputs, made with numpy from fixed seeds, and the same
parameters (the reference's, carried over with ``params_from_numpy``) go
through both packages at the smoke sizes: the sLSTM cell's gradient at
hand-built ties of its two maxima (the port's ``maximum(|n|, 1)`` splits
the gradient half and half as ``jnp.maximum`` does, where ``clamp`` did
not), the plain version of K9 (``ref.slstm_scan_grad_ref``) against
``jax.vjp`` of the reference's scan and of ``slstm_apply``, ``loss_fn``
and its gradients for the xlstm, dense and vlm families, five AdamW steps
of ``make_train_step``, the LM batches, and the launchers' unported flags.
Inside the port: ``_SLSTMScan``'s plain path through ``gradcheck`` in fp64,
remat changing no bit, accumulation over 4 microbatches against 1, the
checkpoint manager, the Trainer's restore after an injected failure,
tracing on == off, and both launchers on the CPU.  Every reference call
is jitted; the file starts no XLA subprocess.

Tolerances: the cell at the ties rtol 1e-6 (fp32, the same operations,
whose transcendentals may differ by an ulp);
the scan's and the mixer's gradients rtol 2e-4 with atol 2e-4 × the
leaf's max |·| (fp32 through S steps in another order); the loss rtol
2e-4 and its gradients the same as the scan's, leaf by leaf; the AdamW
losses 1e-3 (ROADMAP); accumulation the reference's own test's rtol
2e-4, atol 2e-5.
"""
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro.train import AdamWConfig as RAdamWConfig
from repro.train import adamw_init as radamw_init
from repro.train import lm_batch as rlm_batch
from repro.train import make_train_step as rmake_train_step

from repro_torch import configs as TC
from repro_torch.core.gnn import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import slstm_scan as k8
from repro_torch.launch import train as ttrain
from repro_torch.launch import train_lm as ttrain_lm
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.train import (AdamWConfig, LMDataConfig, Trainer,
                               TrainState, adamw_init, lm_batch,
                               make_loss_fn, make_train_step)
from repro_torch.train import checkpoint as ck
from repro_torch.train.trainer import _grads_of
from repro_torch.train.tree import tree_flatten_with_names, tree_leaves

# six test workers share the host's cores: a few torch threads a worker
torch.set_num_threads(2)

TOL = 2e-4
XL = "xlstm-125m"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _fp32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _cfgs(arch, **kw):
    return (_fp32(RC.get_smoke_config(arch), **kw),
            _fp32(TC.get_smoke_config(arch), **kw))


def _ref_params(cfg, seed=0):
    return jax.jit(lambda k: RT.init_params(k, cfg, vocab_multiple=4))(
        jax.random.key(seed))


def _port_params(rparams):
    return params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")


def _ref_names(tree):
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in paths}


def _close(got, want, what, rtol=TOL):
    """``got`` within rtol and atol = rtol × max |want| of ``want``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() or 1.0),
                               err_msg=what)


def _slstm_state(rng, b, heads, hd):
    shape = (b, heads, hd)
    return dict(h=rng.normal(size=shape).astype(np.float32) * 0.5,
                c=rng.normal(size=shape).astype(np.float32),
                n=rng.uniform(0.5, 2.0, shape).astype(np.float32),
                m=rng.normal(size=shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the sLSTM cell at its ties, and K9's plain version
# ---------------------------------------------------------------------------

def _tie_inputs():
    """One row, one head, hd 5, wr 0 (the gates are xt).  Unit 0: |n'| ==
    1 (f'·n underflows against i' = 1); unit 1: log_f + m == log_i (m' at a
    tie, f' = i' = 1); unit 2: both; unit 3: no tie; unit 4: n' == -1."""
    hd = 5
    gz = np.array([0.3, -0.7, 0.9, 0.2, -0.4], np.float32)
    gi = np.array([0.0, 1.0, 1.0, 0.5, 1.0], np.float32)
    gf = np.array([-20.0, 20.0, 20.0, 1.5, 20.0], np.float32)
    go = np.array([0.4, -0.2, 1.1, 0.3, 0.8], np.float32)
    xt = np.concatenate([gz, gi, gf, go])[None, None]      # (1, 1, 4·hd)
    st = dict(h=np.zeros((1, 1, hd), np.float32),
              c=np.array([[[0.5, -1.2, 0.8, 0.3, 1.5]]], np.float32),
              n=np.array([[[1.0, 0.5, 0.0, 1.3, -2.0]]], np.float32),
              m=np.array([[[0.0, 1.0, 1.0, -0.2, 1.0]]], np.float32))
    cot = dict(h=np.array([[[1.0, 0.7, -0.8, 0.6, 1.2]]], np.float32),
               c=np.array([[[0.3, -0.4, 0.5, 0.2, -0.6]]], np.float32),
               n=np.array([[[-0.5, 0.6, 0.4, -0.3, 0.9]]], np.float32),
               m=np.array([[[0.2, 0.8, -0.7, 0.1, 0.5]]], np.float32))
    wr = np.zeros((1, hd, 4 * hd), np.float32)
    return xt, wr, st, cot


def _jax_cell_grads(xt, wr, st, cot):
    hd = wr.shape[1]
    cfg = types.SimpleNamespace(d_model=hd, n_heads=1)

    def cell(x, w, s):
        return RX._slstm_cell(dict(wr=w), x.reshape(1, 4 * hd), s, cfg)

    out, vjp = jax.vjp(cell, jnp.asarray(xt), jnp.asarray(wr),
                       {k: jnp.asarray(v) for k, v in st.items()})
    dx, dw, ds = jax.jit(vjp)({k: jnp.asarray(v) for k, v in cot.items()})
    return out, np.asarray(dx), np.asarray(dw), {k: np.asarray(v)
                                                 for k, v in ds.items()}


def _torch_cell_grads(cell, xt, wr, st, cot):
    x, w = _t(xt).requires_grad_(True), _t(wr).requires_grad_(True)
    s = {k: _t(v).requires_grad_(True) for k, v in st.items()}
    out = cell(x, w, s)
    grads = torch.autograd.grad([out[k] for k in "hcnm"],
                                [x, w] + [s[k] for k in "hcnm"],
                                [_t(cot[k]) for k in "hcnm"])
    return out, grads[0].numpy(), grads[1].numpy(), dict(
        zip("hcnm", (g.numpy() for g in grads[2:])))


def _clamp_cell(xt, wr, st):
    """The cell as the port wrote it before: ``clamp(|n|, min=1)``."""
    hd = wr.shape[1]
    g = xt + torch.einsum("bhd,hdg->bhg", st["h"], wr)
    z, li = torch.tanh(g[..., :hd]), g[..., hd:2 * hd]
    lf = torch.nn.functional.logsigmoid(g[..., 2 * hd:3 * hd])
    o = torch.sigmoid(g[..., 3 * hd:])
    m = torch.maximum(lf + st["m"], li)
    i_p, f_p = torch.exp(li - m), torch.exp(lf + st["m"] - m)
    c = f_p * st["c"] + i_p * z
    n = f_p * st["n"] + i_p
    return dict(h=o * c / torch.clamp(n.abs(), min=1.0), c=c, n=n, m=m)


def test_slstm_cell_gradient_at_ties_matches_jax():
    xt, wr, st, cot = _tie_inputs()
    out, dx, dw, ds = _jax_cell_grads(xt, wr, st, cot)
    # the ties are real in both frameworks' forward
    n, fm = np.asarray(out["n"])[0, 0], np.asarray(out["m"])[0, 0]
    assert np.abs(n)[[0, 2, 4]].tolist() == [1.0, 1.0, 1.0]
    assert fm[[1, 2, 4]].tolist() == xt[0, 0, 5:10][[1, 2, 4]].tolist()
    got = _torch_cell_grads(ref.slstm_cell, xt, wr, st, cot)
    assert np.abs(got[0]["n"].detach().numpy()[0, 0])[[0, 2, 4]].tolist() \
        == [1.0, 1.0, 1.0]
    assert got[0]["m"].detach().numpy()[0, 0][[1, 2, 4]].tolist() \
        == xt[0, 0, 5:10][[1, 2, 4]].tolist()
    for k in "hcnm":
        np.testing.assert_allclose(got[0][k].detach().numpy(),
                                   np.asarray(out[k]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[1], dx, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[2], dw, rtol=1e-6, atol=1e-7)
    for k in "hcnm":
        np.testing.assert_allclose(got[3][k], ds[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # clamp gives the same values and another gradient at |n'| == 1
    old = _torch_cell_grads(_clamp_cell, xt, wr, st, cot)
    assert torch.equal(old[0]["h"], got[0]["h"])
    off = np.abs(old[1] - dx)[0, 0].reshape(4, 5).max(axis=0)
    # (unit 0's tie moves only gradients scaled by f' = exp(-20): with
    # log_i the larger side of m', i' is 1 whatever n' does)
    assert off[[2, 4]].min() > 1e-3 and off[[0, 1, 3]].max() < 1e-6
    assert not np.allclose(old[3]["n"], ds["n"], rtol=1e-3, atol=1e-3)


def _jax_scan_vjp(xp, wr, st, dhs, dst):
    """``jax.vjp`` of the reference's recurrence: ``lax.scan`` over
    ``_slstm_cell``, as ``slstm_apply`` runs it."""
    heads, hd = wr.shape[0], wr.shape[1]
    cfg = types.SimpleNamespace(d_model=heads * hd, n_heads=heads)

    def scan(x, w, s):
        def step(carry, xt):
            new = RX._slstm_cell(dict(wr=w), xt, carry, cfg)
            return new, new["h"]
        last, hs = jax.lax.scan(step, s, jnp.moveaxis(x, 0, 1))
        return jnp.moveaxis(hs, 0, 1), last

    _, vjp = jax.vjp(scan, *jax.tree.map(jnp.asarray, (xp, wr, st)))
    return jax.jit(vjp)((jnp.asarray(dhs), jax.tree.map(jnp.asarray, dst)))


@pytest.mark.parametrize("b,s,h,hd", [(1, 1, 1, 8), (2, 7, 2, 8),
                                      (3, 24, 2, 16)])
def test_slstm_scan_grad_ref_matches_jax_vjp(b, s, h, hd):
    rng = np.random.default_rng(b * 100 + s)
    xp = rng.normal(size=(b, s, h * 4 * hd)).astype(np.float32)
    wr = (rng.normal(size=(h, hd, 4 * hd)) * hd ** -0.5).astype(np.float32)
    st = _slstm_state(rng, b, h, hd)
    dhs = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    dst = _slstm_state(rng, b, h, hd)
    jdx, jdw, jds = _jax_scan_vjp(xp, wr, st, dhs.reshape(b, s, h, hd), dst)
    dxp, dwr, d0 = ref.slstm_scan_grad_ref(
        _t(xp), _t(wr), {k: _t(v) for k, v in st.items()}, _t(dhs),
        {k: _t(v) for k, v in dst.items()})
    _close(dxp, jdx, "dxp")
    _close(dwr, jdw, "dwr")
    for k in "hcnm":
        _close(d0[k], jds[k], f"d{k}0")


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply_gradients_match_reference(with_state):
    """The mixer's gradients (its projections, wr, the input and the
    initial state) through the port's sLSTM on the CPU against
    ``jax.vjp`` of the reference's ``slstm_apply``."""
    rcfg, tcfg = _cfgs(XL)
    rp = jax.jit(lambda k: RX.slstm_init(k, rcfg))(jax.random.key(3))
    rng = np.random.default_rng(5)
    b, s = 2, 12
    x = rng.normal(size=(b, s, rcfg.d_model)).astype(np.float32)
    hd = rcfg.d_model // rcfg.n_heads
    st = _slstm_state(rng, b, rcfg.n_heads, hd) if with_state else None
    dy = rng.normal(size=(b, s, rcfg.d_model)).astype(np.float32)

    def fn(p, xx, ss):
        return RX.slstm_apply(p, xx, rcfg, state=ss)[0]

    args = (rp, jnp.asarray(x), None if st is None else jax.tree.map(
        jnp.asarray, st))
    _, vjp = jax.vjp(fn, *args)
    jp, jx, js = jax.jit(vjp)(jnp.asarray(dy))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    leaves = [v.requires_grad_(True) for v in tree_leaves(tp)]
    tx = _t(x).requires_grad_(True)
    tst = None if st is None else {k: _t(v).requires_grad_(True)
                                   for k, v in st.items()}
    y, _ = TX.slstm_apply(tp, tx, tcfg, state=tst)
    ins = leaves + [tx] + ([] if tst is None else [tst[k] for k in "hcnm"])
    grads = torch.autograd.grad(y, ins, _t(dy))
    want = _ref_names(jp)
    for (name, _), g in zip(tree_flatten_with_names(tp), grads):
        _close(g, want[name], name)
    _close(grads[len(leaves)], jx, "dx")
    if st is not None:
        for i, k in enumerate("hcnm"):
            _close(grads[len(leaves) + 1 + i], js[k], f"d{k}0")


def test_slstm_function_plain_path_passes_gradcheck_in_fp64():
    rng = np.random.default_rng(7)
    b, s, h, hd = 2, 4, 1, 3

    def d(a):
        return torch.from_numpy(np.asarray(a, np.float64)).requires_grad_()

    xp = d(rng.normal(size=(b, s, h * 4 * hd)))
    wr = d(rng.normal(size=(h, hd, 4 * hd)) * hd ** -0.5)
    st = {k: d(v) for k, v in _slstm_state(rng, b, h, hd).items()}
    fn = lambda *a: ops._SLSTMScan.apply(*a, False)       # noqa: E731
    assert torch.autograd.gradcheck(fn, (xp, wr, *(st[k] for k in "hcnm")),
                                    eps=1e-6, atol=1e-6, rtol=1e-5)


def test_ops_slstm_scan_on_the_cpu_is_the_plain_loop_under_autograd():
    """On the CPU ``ops.slstm_scan`` differentiates the plain loop itself:
    its gradients are ``slstm_scan_grad_ref``'s bit for bit, and the plain
    ``_SLSTMScan`` gives the same bits."""
    rng = np.random.default_rng(8)
    b, s, h, hd = 2, 9, 2, 8
    xp = _t(rng.normal(size=(b, s, h * 4 * hd)).astype(np.float32))
    wr = _t((rng.normal(size=(h, hd, 4 * hd)) * hd ** -0.5)
            .astype(np.float32))
    st = {k: _t(v) for k, v in _slstm_state(rng, b, h, hd).items()}
    dhs = _t(rng.normal(size=(b, s, h, hd)).astype(np.float32))
    want = ref.slstm_scan_grad_ref(xp, wr, st, dhs)
    for run in (lambda x, w: ops.slstm_scan(x, w, st)[0],
                lambda x, w: ops._SLSTMScan.apply(
                    x, w, *(st[k] for k in "hcnm"), False)[0]):
        x, w = xp.clone().requires_grad_(), wr.clone().requires_grad_()
        gx, gw = torch.autograd.grad(run(x, w), [x, w], dhs)
        assert torch.equal(gx, want[0]) and torch.equal(gw, want[1])


def test_k9_plan_at_the_model_shapes():
    """K9's cluster plan and shared memory (``bwd_layout`` of the source)
    at xlstm-125m's hd 192: C = 8 at every bt; at bt 8 a block holds dg
    twice, 2 × 8 rows × 192 units × 4 gates fp32 = 49,152 bytes, and two
    8-byte mbarriers, 49,168 bytes: its 24 units' rows of wr (73,728
    bytes in shared memory before) sit in registers, 96 floats a thread;
    every hd the kernel takes has a plan within the limit."""
    assert k8.plan(192, 8, backward=True) == (8, 49_168)
    assert k8.plan(192, 2, backward=True) == (8, 12_304)
    assert k8.bwd_wr_in_registers(192, 8)
    for hd in range(1, k8.MAX_HEAD_DIM + 1):
        for bt in (1, 2, 3, 8):
            c, smem = k8.plan(hd, bt, backward=True)
            assert smem <= k8.SMEM_LIMIT and (c - 1) * -(-hd // c) < hd


@pytest.mark.parametrize("bt", range(1, 9))
def test_k9_smem_bytes_is_the_layouts_formula(bt):
    """``smem_bytes(..., backward=True)`` at every hd 1–256 and cluster
    size that ``cluster_sizes`` admits: dg twice (2 × BT rows × hdk units
    × 4 gates, BT the kernel instance of bt, hdk hd padded to 32), the
    block's rows of wr (hdk / 8 float4s a thread of the block's threads,
    8 a unit rounded up to a warp) unless they are in registers (hdk ≤
    256 and at most 256 threads), and two mbarriers (4 floats), in fp32."""
    bt_i = next(n for n in (1, 2, 4, 8) if bt <= n)
    for hd in range(1, k8.MAX_HEAD_DIM + 1):
        for c in k8.cluster_sizes(hd, bt, backward=True):
            hdk = -(-hd // 32) * 32
            threads = -(-8 * -(-hd // c) // 32) * 32
            regs = hdk <= 256 and threads <= 256
            assert k8.bwd_wr_in_registers(hd, c) == regs, (hd, c)
            wr = 0 if regs else hdk // 8 * 4 * threads
            assert k8.smem_bytes(hd, bt, c, backward=True) == \
                4 * (2 * bt_i * hdk * 4 + wr + 4), (hd, bt, c)


def test_k9_rows_a_cluster():
    """K9's rows a cluster (``bwd_rows``): the fewest that keep the
    clusters at most one a 16 SMs, else MAX_BT; on an H100 (132 SMs) the
    2 × 4096 step (B 2) and the launcher's (B 8) at H 4 run 8 clusters."""
    assert [k8.bwd_rows(b, 4, 132) for b in (1, 2, 3, 8, 9, 16, 64)] == \
        [1, 1, 2, 4, 5, 8, 8]
    assert k8.bwd_rows(2, 4, 10) == k8.MAX_BT     # no rows fit
    for b in range(1, 40):
        for h in (1, 2, 4, 12):
            bt = k8.bwd_rows(b, h, 132)
            assert 1 <= bt <= k8.MAX_BT
            if bt < k8.MAX_BT:
                assert -(-b // bt) * h <= 8
            if bt > 1:
                assert -(-b // (bt - 1)) * h > 8


@pytest.mark.parametrize("backward", [False, True])
def test_slstm_plans_give_every_block_a_unit(backward):
    """Every cluster size that ``cluster_sizes`` admits, and so the plan's,
    gives each of its blocks at least one unit and at most MAX_UNITS
    (the kernels' exchange needs every block to send); hd 1 runs on one
    block; the plan's size is one of them."""
    for hd in range(1, k8.MAX_HEAD_DIM + 1):
        for bt in range(1, k8.MAX_BT + 1):
            sizes = k8.cluster_sizes(hd, bt, backward)
            c, _ = k8.plan(hd, bt, backward)
            assert c in sizes and sizes == sorted(sizes)
            for size in sizes:
                units = -(-hd // size)
                assert 1 <= units <= k8.MAX_UNITS
                assert all(hd - q * units >= 1 for q in range(size))
            assert (c == 1) == (hd == 1)


# ---------------------------------------------------------------------------
# the loss, its gradients and the train step
# ---------------------------------------------------------------------------

def _batch(cfg, b, s, step=0):
    n_vis = cfg.n_vis_tokens if cfg.family == "vlm" else 0
    return lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b,
                                 doc_len=8), step, n_vis=n_vis,
                    d_model=cfg.d_model)


@pytest.mark.parametrize("arch,vocab", [(XL, None),
                                        ("codeqwen1.5-7b", None),
                                        ("internvl2-76b", 130)])
def test_loss_and_grads_match_reference(arch, vocab):
    """The vlm case's vocab 130 pads the head to 132 columns, so its
    logits take the in-place ``-1e30`` write under autograd."""
    kw = {} if vocab is None else dict(vocab=vocab)
    rcfg, tcfg = _cfgs(arch, remat=False, **kw)
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


@pytest.mark.parametrize("arch", [XL, "codeqwen1.5-7b"])
def test_remat_changes_no_bit(arch):
    cfg = TC.get_smoke_config(arch)
    params = TT.init_params(torch.Generator().manual_seed(1), cfg)
    batch = {k: _t(v) for k, v in _batch(cfg, 2, 16).items()}
    out = [_grads_of(make_loss_fn(dataclasses.replace(cfg, remat=r),
                                  TT.DistCtx()), params, batch)
           for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        assert torch.equal(a, b)


def test_train_step_losses_match_reference():
    """Five AdamW steps of the smoke xlstm-125m, the port with remat on (the
    launcher's default), the reference with it off (it moves no value)."""
    rcfg, tcfg = _fp32(RC.get_smoke_config(XL), remat=False), \
        _fp32(TC.get_smoke_config(XL), remat=True)
    rp = _ref_params(rcfg)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    rstep = jax.jit(rmake_train_step(rcfg, RT.DistCtx(),
                                     RAdamWConfig(**ocfg)))
    tstep = make_train_step(tcfg, TT.DistCtx(), AdamWConfig(**ocfg))
    tp = _port_params(rp)
    ro, to = radamw_init(rp), adamw_init(tp)
    rl, tl = [], []
    for s in range(5):
        batch = _batch(rcfg, 2, 16, step=s)
        rp, ro, rm = rstep(rp, ro, jax.tree.map(jnp.asarray, batch))
        tp, to, tm = tstep(tp, to, {k: _t(v) for k, v in batch.items()})
        rl.append(float(rm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, rl, rtol=1e-3)
    assert tl[-1] < tl[0]
    assert int(to["count"]) == 5


def test_grad_accum_matches_full_batch():
    cfg = TC.get_smoke_config("codeqwen1.5-7b")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            vocab_multiple=4)
    batch = {k: _t(v) for k, v in lm_batch(
        LMDataConfig(vocab=cfg.vocab, seq_len=24, global_batch=8), 0)
        .items()}
    p1, _, m1 = make_train_step(cfg, TT.DistCtx(), AdamWConfig(lr=1e-3),
                                accum_steps=1)(params, adamw_init(params),
                                               batch)
    p4, _, m4 = make_train_step(cfg, TT.DistCtx(), AdamWConfig(lr=1e-3),
                                accum_steps=4)(params, adamw_init(params),
                                               batch)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("step,n_vis", [(0, 0), (3, 0), (2, 4)])
def test_lm_batch_matches_reference(step, n_vis):
    from repro.train import LMDataConfig as RLMDataConfig
    kw = dict(vocab=257, seq_len=40, global_batch=3, seed=5, doc_len=16)
    got = lm_batch(LMDataConfig(**kw), step, n_vis=n_vis, d_model=8)
    want = rlm_batch(RLMDataConfig(**kw), step, n_vis=n_vis, d_model=8)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k])


# ---------------------------------------------------------------------------
# the checkpoint manager and the Trainer
# ---------------------------------------------------------------------------

def test_checkpoint_manager_round_trip_and_retention(tmp_path):
    tree = dict(a=torch.arange(6, dtype=torch.float32).reshape(2, 3),
                b=dict(c=torch.ones(4, dtype=torch.bfloat16)),
                d=[torch.zeros(2, dtype=torch.int32), torch.ones(1)])
    mgr = ck.CheckpointManager(str(tmp_path), every=2, keep=2)
    saved = [s for s in range(1, 8) if mgr.maybe_save(s, tree)]
    tree["a"].add_(1.0)       # after the host copy: not in the checkpoint
    mgr.wait()
    assert saved == [2, 4, 6]
    assert sorted(os.listdir(tmp_path)) == ["step-000000004",
                                            "step-000000006"]
    step, out = mgr.restore_latest(tree)
    assert step == 6
    for (name, a), (_, b) in zip(tree_flatten_with_names(tree),
                                 tree_flatten_with_names(out)):
        assert a.dtype == b.dtype, name
        want = a - 1 if name == "a" else a
        assert torch.equal(b, want), name
    assert ck.CheckpointManager(str(tmp_path / "none")).restore_latest(
        tree) == (None, None)


def _codeqwen_setup(accum=1):
    cfg = TC.get_smoke_config("codeqwen1.5-7b")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg,
                            vocab_multiple=4)
    step = make_train_step(cfg, TT.DistCtx(),
                           AdamWConfig(lr=1e-3, warmup_steps=5,
                                       total_steps=100), accum_steps=accum)
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)

    def data():
        s = 0
        while True:
            yield {k: _t(v) for k, v in lm_batch(dcfg, s).items()}
            s += 1

    return params, step, data


def test_trainer_restores_after_injected_failure(tmp_path):
    params, step, data = _codeqwen_setup()
    calls = dict(n=0)
    seen = {}

    def flaky_step(p, o, b):
        calls["n"] += 1
        seen[calls["n"]] = p
        if calls["n"] == 9:              # step 8
            raise RuntimeError("injected preemption")
        return step(p, o, b)

    tr = Trainer(flaky_step, data(), TrainState(params, adamw_init(params)),
                 workdir=str(tmp_path), ckpt_every=5, log_every=1000,
                 log_fn=lambda *_: None)
    losses = tr.run(12)
    assert tr.restarts == 1 and tr.state.step == 12
    assert len(losses) == 12 + 3        # steps 5..7 run again
    assert ck.latest_step(str(tmp_path)) == 10
    # the retry starts from step 5's checkpoint: the parameters step 5 ran
    # on (call 6), bit for bit
    for a, b in zip(tree_leaves(seen[6]), tree_leaves(seen[10])):
        assert torch.equal(a, b)


def test_trainer_gives_up_after_max_retries(tmp_path):
    params, step, data = _codeqwen_setup()

    def broken(p, o, b):
        raise RuntimeError("always")

    tr = Trainer(broken, data(), TrainState(params, adamw_init(params)),
                 workdir=str(tmp_path), max_retries=2, log_fn=lambda *_: None)
    with pytest.raises(RuntimeError, match="always"):
        tr.run(3)


def test_training_losses_bitwise_identical_with_tracing():
    params, step, data = _codeqwen_setup()

    def run(**obs):
        tr = Trainer(step, data(), TrainState(params, adamw_init(params)),
                     log_fn=lambda _s: None, **obs)
        return tr.run(5)

    base = run()
    tracer, reg = Tracer(), MetricsRegistry()
    traced = run(tracer=tracer, metrics=reg)
    assert base == traced                          # bitwise (float equality)
    steps = [e for e in tracer.events() if e["name"] == "train.step"]
    assert len(steps) == 5
    assert reg.histogram("train.step_seconds").count == 5


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_train_launcher_on_cpu(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    metrics = tmp_path / "metrics.json"
    out = ttrain.main(["--device", "cpu", "--arch", XL, "--smoke",
                       "--steps", "3", "--seq", "16", "--batch", "2",
                       "--workdir", str(tmp_path / "ck"), "--ckpt-every",
                       "2", "--trace", str(trace), "--metrics-json",
                       str(metrics)])
    assert out["device"] == "cpu" and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"])) and len(out["step_ms"]) == 3
    assert ck.latest_step(str(tmp_path / "ck")) == 2
    assert "done: loss" in capsys.readouterr().out
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("train.step") == 3
    # a second run resumes from the checkpoint and runs the last step only
    again = ttrain.main(["--device", "cpu", "--arch", XL, "--smoke",
                         "--steps", "3", "--seq", "16", "--batch", "2",
                         "--workdir", str(tmp_path / "ck")])
    assert len(again["losses"]) == 1


def test_train_lm_launcher_tunes_accum_on_cpu():
    out = ttrain_lm.main(["--device", "cpu", "--smoke", "--steps", "14",
                          "--seq", "16", "--batch", "4", "--tune-accum"])
    assert out["arch"] == XL and len(out["losses"]) == 14
    assert out["accum"] in (1, 2, 4) and out["measured"] >= 1
    assert out["retunes"] >= 1


@pytest.mark.parametrize("argv,item", [
    (["--arch", "whisper-base"], "10.5"),
    (["--arch", XL, "--ef-bits", "8"], "item 9"),
    (["--arch", XL, "--ring-tp"], "item 9"),
])
def test_unported_paths_raise_naming_their_item(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(["--device", "cpu", "--smoke", "--steps", "1",
                     "--seq", "8", "--batch", "2", *argv])


def test_encdec_and_ef_bits_raise_in_the_step_factory():
    with pytest.raises(NotImplementedError, match="10.5"):
        make_loss_fn(TC.get_smoke_config("whisper-base"), TT.DistCtx())
    with pytest.raises(NotImplementedError, match="item 9"):
        make_train_step(TC.get_smoke_config(XL), TT.DistCtx(),
                        AdamWConfig(), ef_bits=8)
    with pytest.raises(NotImplementedError, match="10.5"):
        ttrain_lm.main(["--device", "cpu", "--smoke", "--arch",
                        "whisper-base"])


def test_slstm_save_ref_holds_the_loops_gates_and_states():
    """K8's saved gates and states, plain: the last step's states are the
    scan's final ones bitwise, and each step's h follows from its gates
    and the states before it by the cell's formula."""
    rng = np.random.default_rng(9)
    b, s, h, hd = 2, 6, 2, 8
    xp = _t(rng.normal(size=(b, s, h * 4 * hd)).astype(np.float32))
    wr = _t((rng.normal(size=(h, hd, 4 * hd)) * hd ** -0.5)
            .astype(np.float32))
    st = {k: _t(v) for k, v in _slstm_state(rng, b, h, hd).items()}
    hs, last = ref.slstm_scan_ref(xp, wr, st)
    saved = ref.slstm_scan_save_ref(xp, wr, st)
    assert saved["g"].shape == (b, s, h, hd, 4)
    for k in "cnm":
        assert saved[k].shape == (b, s, h, hd)
        assert torch.equal(saved[k][:, -1], last[k])
    g = saved["g"]
    c_prev = torch.cat([st["c"][:, None], saved["c"][:, :-1]], 1)
    m_prev = torch.cat([st["m"][:, None], saved["m"][:, :-1]], 1)
    lf = torch.nn.functional.logsigmoid(g[..., 2])
    m_new = torch.maximum(lf + m_prev, g[..., 1])
    assert torch.equal(m_new, saved["m"])
    c_new = torch.exp(lf + m_prev - m_new) * c_prev \
        + torch.exp(g[..., 1] - m_new) * torch.tanh(g[..., 0])
    torch.testing.assert_close(c_new, saved["c"], rtol=1e-6, atol=1e-6)
    h_new = torch.sigmoid(g[..., 3]) * saved["c"] / torch.maximum(
        saved["n"].abs(), torch.ones(()))
    torch.testing.assert_close(h_new, hs, rtol=1e-6, atol=1e-6)
