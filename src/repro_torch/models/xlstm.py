"""xLSTM blocks (Beck et al. 2024) for the xlstm-125m architecture
(counterpart of ``repro/models/xlstm.py``): mLSTM (matrix memory) and
sLSTM (scalar memory with recurrent gating), inference only.

* **mLSTM** runs in the reference's chunkwise-parallel form: within a
  chunk, token-token terms are a masked product; across chunks the matrix
  memory ``C (B, H, dk, dk)``, the normaliser ``n (B, H, dk)`` and the
  stabiliser ``m (B, H)`` are carried (the reference's ``lax.scan`` over
  chunks is a loop here, its einsums ``torch.einsum``).
* **sLSTM** has a true recurrent connection (the hidden state feeds the
  gates), so it is sequential.  The reference scans ``_slstm_cell`` with
  ``lax.scan`` and never launches its Pallas kernel from the model; the
  port runs the recurrence through ``kernels.ops.slstm_scan``: K8
  (``csrc/slstm_scan.cu``, the port of ``slstm_scan_call``) on the card,
  the plain loop of :func:`_slstm_cell`'s arithmetic on the CPU.  It is
  the same function (the reference's own kernel test holds the kernel to
  the cell); on the card it replaces some 15 small launches a token with
  one launch a layer.

Both carry O(1) state at decode time.  Inits draw on a ``torch.Generator``
from the reference's distributions (other bits); ``n`` stacks that many
layers on a leading axis.  The simplifications the reference notes (one
projection block a layer, no conv4 front, an exp forget gate with its
sigmoid bound folded into the bias init) are kept as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from .layers import dense_init, draw_device, rms_norm

__all__ = [
    "mlstm_init", "mlstm_apply", "mlstm_step", "mlstm_state_init",
    "slstm_init", "slstm_apply", "slstm_step", "slstm_state_init",
]

Tensor = torch.Tensor


def _lead(n: Optional[int]) -> tuple:
    return () if n is None else (n,)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mdims(cfg):
    d_in = cfg.d_model * 2          # up-projection factor 2
    heads = cfg.n_heads
    dk = d_in // heads
    return d_in, heads, dk


def mlstm_init(gen: torch.Generator, cfg, n: Optional[int] = None,
               device=None) -> Dict[str, Any]:
    d, (d_in, heads, dk) = cfg.d_model, _mdims(cfg)
    dt, dev = cfg.pdtype, draw_device(gen, device)
    return dict(
        up=dense_init(gen, d, 2 * d_in, dt, n, dev),      # x, z-gate
        wq=dense_init(gen, d_in, d_in, dt, n, dev),
        wk=dense_init(gen, d_in, d_in, dt, n, dev),
        wv=dense_init(gen, d_in, d_in, dt, n, dev),
        wif=dense_init(gen, d_in, 2 * heads, dt, n, dev),  # i, f gates
        fgate_bias=torch.full(_lead(n) + (heads,), 3.0, dtype=torch.float32,
                              device=dev),
        norm_w=torch.ones(_lead(n) + (d_in,), dtype=dt, device=dev),
        down=dense_init(gen, d_in, d, dt, n, dev),
    )


def mlstm_state_init(cfg, batch: int, dtype=torch.float32, device="cpu"):
    d_in, heads, dk = _mdims(cfg)
    return dict(
        c=torch.zeros((batch, heads, dk, dk), dtype=dtype, device=device),
        n=torch.zeros((batch, heads, dk), dtype=dtype, device=device),
        m=torch.full((batch, heads), -1e30, dtype=dtype, device=device),
    )


def _mlstm_qkvif(p, x, cfg):
    d_in, heads, dk = _mdims(cfg)
    b, s, _ = x.shape
    up = x @ p["up"]["w"].to(x.dtype)
    xi, z = up[..., :d_in], up[..., d_in:]
    q = (xi @ p["wq"]["w"].to(x.dtype)).reshape(b, s, heads, dk)
    k = (xi @ p["wk"]["w"].to(x.dtype)).reshape(b, s, heads, dk) * dk**-0.5
    v = (xi @ p["wv"]["w"].to(x.dtype)).reshape(b, s, heads, dk)
    gif = (xi @ p["wif"]["w"].to(x.dtype)).float()
    log_i = gif[..., :heads]                                   # (B,S,H)
    log_f = F.logsigmoid(gif[..., heads:] + p["fgate_bias"])
    return xi, z, q, k, v, log_i, log_f


def mlstm_apply(
    p: Dict[str, Any], x: Tensor, cfg,
    state: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """Chunkwise-parallel mLSTM over a sequence. x: (B, S, D)."""
    b, s, d = x.shape
    d_in, heads, dk = _mdims(cfg)
    xi, z, q, k, v, log_i, log_f = _mlstm_qkvif(p, x, cfg)

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = s
    n_ch = s // chunk

    st = state if state is not None else mlstm_state_init(cfg, b,
                                                          device=x.device)
    c, n, m = st["c"].float(), st["n"].float(), st["m"].float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    hs = []
    for ci in range(n_ch):                 # (B,H,dk,dk), (B,H,dk), (B,H)
        sl = slice(ci * chunk, (ci + 1) * chunk)
        qf, kf, vf = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        li, lf = log_i[:, sl], log_f[:, sl]
        cum_f = torch.cumsum(lf, dim=1)                        # (B,c,H)
        # stabiliser: the running max of (m_prev + cum_f_i) against the
        # intra-chunk terms (cum_f_i − cum_f_j + log_i_j), per position
        inter_log = m[:, None, :] + cum_f                      # (B,c,H)
        intra_log = cum_f[:, :, None, :] - cum_f[:, None, :, :] \
            + li[:, None, :, :]                                # (B,c,c,H)
        intra_log = torch.where(mask[None, :, :, None], intra_log, -1e30)
        m_new = torch.maximum(inter_log, intra_log.amax(dim=2))  # (B,c,H)
        w_intra = torch.exp(intra_log - m_new[:, :, None, :])  # (B,c,c,H)
        w_inter = torch.exp(inter_log - m_new)                 # (B,c,H)
        scores = torch.einsum("bihd,bjhd->bijh", qf, kf) * w_intra
        num = torch.einsum("bijh,bjhd->bihd", scores, vf)
        num = num + torch.einsum("bihd,bhde,bih->bihe", qf, c, w_inter)
        den = scores.sum(dim=2)                                # (B,c,H)
        den = den + torch.einsum("bihd,bhd,bih->bih", qf, n, w_inter)
        hs.append(num / torch.maximum(den.abs(), den.new_ones(()))[..., None])
        # carry update (stabilised at the chunk-final max)
        m_last = m_new[:, -1]                                  # (B,H)
        wk_c = torch.exp(cum_f[:, -1:, :] - cum_f + li - m_last[:, None, :])
        c = c * torch.exp(m[:, :, None, None]
                          + cum_f[:, -1][:, :, None, None]
                          - m_last[:, :, None, None]) \
            + torch.einsum("bjh,bjhd,bjhe->bhde", wk_c, kf, vf)
        n = n * torch.exp(m + cum_f[:, -1] - m_last)[..., None] \
            + torch.einsum("bjh,bjhd->bhd", wk_c, kf)
        m = m_last
    h = torch.cat(hs, dim=1).reshape(b, s, d_in).to(x.dtype)
    h = rms_norm(h, p["norm_w"], cfg.norm_eps) * F.silu(z)
    out = h @ p["down"]["w"].to(x.dtype)
    new_state = None
    if state is not None:
        new_state = dict(c=c.to(state["c"].dtype), n=n.to(state["n"].dtype),
                         m=m.to(state["m"].dtype))
    return out, new_state


def mlstm_step(p, x, cfg, state):
    """Single-token decode. x: (B, 1, D)."""
    return mlstm_apply(p, x, cfg, state=state)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg, n: Optional[int] = None,
               device=None) -> Dict[str, Any]:
    d = cfg.d_model
    heads = cfg.n_heads
    hd = d // heads
    dt, dev = cfg.pdtype, draw_device(gen, device)
    wr = torch.randn(_lead(n) + (heads, hd, 4 * hd), generator=gen,
                     dtype=torch.float32, device=dev)
    return dict(
        # input weights for the (z, i, f, o) gates, head-major columns
        wx=dense_init(gen, d, 4 * d, dt, n, dev),
        # block-diagonal recurrent weights, per head: (H, hd, 4*hd)
        wr=wr.mul_(hd ** -0.5).to(dt),
        bias=torch.zeros(_lead(n) + (4 * d,), dtype=torch.float32,
                         device=dev),
        norm_w=torch.ones(_lead(n) + (d,), dtype=dt, device=dev),
        out=dense_init(gen, d, d, dt, n, dev),
    )


def slstm_state_init(cfg, batch: int, dtype=torch.float32, device="cpu"):
    d, heads = cfg.d_model, cfg.n_heads
    shape = (batch, heads, d // heads)
    return dict(h=torch.zeros(shape, dtype=dtype, device=device),
                c=torch.zeros(shape, dtype=dtype, device=device),
                n=torch.ones(shape, dtype=dtype, device=device),
                m=torch.zeros(shape, dtype=dtype, device=device))


def _slstm_cell(p, xt_proj, st, cfg):
    """One sLSTM step. xt_proj: (B, 4D) precomputed Wx·x_t + b."""
    heads = cfg.n_heads
    hd = cfg.d_model // heads
    b = xt_proj.shape[0]
    return ref.slstm_cell(xt_proj.reshape(b, heads, 4 * hd), p["wr"], st)


def slstm_apply(
    p: Dict[str, Any], x: Tensor, cfg,
    state: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """The sLSTM over the sequence (true recurrence). x: (B, S, D).  The
    recurrence is ``ops.slstm_scan``: K8 on the card, the plain loop of
    :func:`_slstm_cell` on the CPU."""
    b, s, d = x.shape
    xp = (x @ p["wx"]["w"].to(x.dtype)).float() + p["bias"]
    st = state if state is not None else slstm_state_init(cfg, b,
                                                          device=x.device)
    st = {k: v.float().contiguous() for k, v in st.items()}
    hs, st_out = ops.slstm_scan(xp.contiguous(),
                                p["wr"].float().contiguous(), st)
    h = hs.reshape(b, s, d).to(x.dtype)
    h = rms_norm(h, p["norm_w"], cfg.norm_eps)
    out = h @ p["out"]["w"].to(x.dtype)
    new_state = None
    if state is not None:
        new_state = {k: v.to(state[k].dtype) for k, v in st_out.items()}
    return out, new_state


def slstm_step(p, x, cfg, state):
    return slstm_apply(p, x, cfg, state=state)
