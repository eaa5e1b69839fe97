"""Mamba2 (SSD) mixer for the zamba2 hybrid architecture (counterpart of
``repro/models/ssm.py``).

The chunked state-space-dual algorithm: the sequence is processed in
chunks of ``cfg.ssm_chunk``; within a chunk the token-token interactions
are a masked product, and the recurrent state ``h`` (B, H, hd, N) is
carried across chunks (the reference's ``lax.scan`` over chunks is a loop
here, its einsums ``torch.einsum``).

Recurrence (per head, discretized):
    h_t = exp(a·dt_t) · h_{t-1} + dt_t · x_t ⊗ B_t
    y_t = C_t · h_t + D · x_t

Decode is the single-step form (:func:`ssm_step`), O(1) state.  The
reference's simplifications are kept: one B/C group, no dt clamping, a
depthwise causal conv of width 4.  ``a_log``, ``d_skip`` and ``dt_bias``
are fp32 whatever ``param_dtype`` is, and so are the states.

One difference, where the reference is at fault: it computes the
intra-chunk weights as ``where(mask, exp(decay), 0)``.  Above the
diagonal ``decay = cum_i − cum_j`` is positive (up to about 176 in a
256-token chunk), ``exp`` overflows to inf, and the ``where``'s gradient
multiplies that inf by 0: NaN gradients at the configs' own chunk of 256.
The port masks ``decay`` to ``-inf`` before the ``exp``: the same forward
bits (``exp(-inf) = 0``), finite gradients, equal to the reference's
wherever those are finite.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, draw_device, rms_norm

__all__ = ["ssm_init", "ssm_apply", "ssm_step", "ssm_state_init"]

Tensor = torch.Tensor

_CONV_K = 4


def _dims(cfg):
    d_in = cfg.d_model * cfg.ssm_expand
    heads = d_in // cfg.ssm_headdim
    return d_in, heads, cfg.ssm_state


def ssm_init(gen: torch.Generator, cfg, n: Optional[int] = None,
             device=None) -> Dict[str, Any]:
    """The reference's mixer tree; ``n`` stacks layers on a leading axis."""
    d, (d_in, heads, ns) = cfg.d_model, _dims(cfg)
    lead = () if n is None else (n,)
    dev = draw_device(gen, device)
    # in_proj → [z (d_in), x (d_in), B (N), C (N), dt (heads)]
    zxbcdt = 2 * d_in + 2 * ns + heads
    conv = torch.randn(lead + (_CONV_K, d_in + 2 * ns), generator=gen,
                       dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return dict(
        in_proj=dense_init(gen, d, zxbcdt, cfg.pdtype, n, dev),
        conv_w=conv.mul_(0.1).to(cfg.pdtype),
        a_log=torch.zeros(lead + (heads,), **f32),       # a = -exp(a_log)
        d_skip=torch.ones(lead + (heads,), **f32),
        dt_bias=torch.zeros(lead + (heads,), **f32),
        norm_w=torch.ones(lead + (d_in,), dtype=cfg.pdtype, device=dev),
        out_proj=dense_init(gen, d_in, d, cfg.pdtype, n, dev),
    )


def ssm_state_init(cfg, batch: int, dtype=torch.float32, device="cpu"):
    d_in, heads, ns = _dims(cfg)
    return dict(
        h=torch.zeros((batch, heads, cfg.ssm_headdim, ns), dtype=dtype,
                      device=device),
        conv=torch.zeros((batch, _CONV_K - 1, d_in + 2 * ns), dtype=dtype,
                         device=device),
    )


def _split_proj(p, x: Tensor, cfg):
    d_in, heads, ns = _dims(cfg)
    zxbcdt = x @ p["in_proj"]["w"].to(x.dtype)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * ns]
    dt = zxbcdt[..., 2 * d_in + 2 * ns:]
    return z, xbc, dt


def _causal_conv(xbc: Tensor, w: Tensor,
                 state: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv of width 4; returns (out, new_conv_state).
    An fp32 state promotes a bf16 input to fp32, as ``jnp.concatenate``
    does in the reference."""
    b, s, c = xbc.shape
    hist = state if state is not None else xbc.new_zeros(
        (b, _CONV_K - 1, c))
    full = torch.cat([hist, xbc], dim=1)            # (B, S+3, C)
    out = sum(full[:, i:i + s] * w[i][None, None].to(xbc.dtype)
              for i in range(_CONV_K))
    return F.silu(out), full[:, -(_CONV_K - 1):]


def ssm_apply(
    p: Dict[str, Any], x: Tensor, cfg,
    state: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """Chunked SSD over a full sequence. x: (B, S, D)."""
    b, s, d = x.shape
    d_in, heads, ns = _dims(cfg)
    hd = cfg.ssm_headdim
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(
        xbc, p["conv_w"], state["conv"] if state is not None else None)
    xs = xbc[..., :d_in].reshape(b, s, heads, hd)
    bmat = xbc[..., d_in:d_in + ns]                 # (B, S, N)
    cmat = xbc[..., d_in + ns:]                     # (B, S, N)
    # jax.nn.softplus is logaddexp(x, 0); torch's returns x above 20,
    # within 1e-8 relative of it
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])  # (B, S, H)
    a = -torch.exp(p["a_log"])                                  # (H,)

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = s  # smoke shapes; production shapes divide evenly
    n_ch = s // chunk
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    h = (state["h"].float() if state is not None
         else torch.zeros((b, heads, hd, ns), dtype=torch.float32,
                          device=x.device))
    xf, bf, cf = xs.float(), bmat.float(), cmat.float()
    ys = []
    for ci in range(n_ch):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xk, bk, ck, dtk = xf[:, sl], bf[:, sl], cf[:, sl], dt[:, sl]
        la = dtk * a[None, None]                    # log decay (B,c,H) ≤ 0
        cum = torch.cumsum(la, dim=1)               # (B,c,H)
        # intra-chunk: scores[i,j] = (C_i·B_j) exp(cum_i − cum_j) dt_j, j ≤ i
        cb = torch.einsum("bin,bjn->bij", ck, bk)   # (B,c,c)
        decay = cum[:, :, None, :] - cum[:, None, :, :]         # (B,c,c,H)
        # masked before the exp: exp(-inf) = 0 with a finite gradient
        w = torch.exp(torch.where(mask, decay, float("-inf")))
        w = w * (cb[..., None] * dtk[:, None, :, :])
        y = torch.einsum("bijh,bjhp->bihp", w, xk)
        # inter-chunk: contribution of the carried state
        y = y + torch.einsum("bin,bhpn,bih->bihp", ck, h, torch.exp(cum))
        # next state: h' = h·exp(cum_last) + Σ_j exp(cum_last−cum_j) dt_j x_j⊗B_j
        wlast = torch.exp(cum[:, -1:, :] - cum) * dtk           # (B,c,H)
        dh = torch.einsum("bjh,bjhp,bjn->bhpn", wlast, xk, bk)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + dh
        ys.append(y)
    y = torch.cat(ys, dim=1) if n_ch > 1 else ys[0]    # (B, S, H, hd)
    y = y + xf * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"]["w"].to(x.dtype)
    new_state = None
    if state is not None:
        new_state = dict(h=h.to(state["h"].dtype),
                         conv=conv_state.to(state["conv"].dtype))
    return out, new_state


def ssm_step(
    p: Dict[str, Any], x: Tensor, cfg, state: Dict[str, Tensor],
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Single-token decode step. x: (B, 1, D); O(1) state update."""
    b = x.shape[0]
    d_in, heads, ns = _dims(cfg)
    hd = cfg.ssm_headdim
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], state["conv"])
    xs = xbc[:, 0, :d_in].reshape(b, heads, hd).float()
    bmat = xbc[:, 0, d_in:d_in + ns].float()        # (B, N)
    cmat = xbc[:, 0, d_in + ns:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])        # (B, H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a[None])                             # (B, H)
    h = state["h"].float() * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xs, bmat)
    y = torch.einsum("bn,bhpn->bhp", cmat, h)
    y = y + xs * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"]["w"].to(x.dtype)
    return out, dict(h=h.to(state["h"].dtype),
                     conv=conv_state.to(state["conv"].dtype))
