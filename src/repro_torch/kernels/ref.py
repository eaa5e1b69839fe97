"""Plain PyTorch versions of the port's kernels.

The CPU path and the tests run these; ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  They repeat the kernels' arithmetic
(same summation order), not their speed.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["neighbor_gather_sum_ref", "segment_add_ordered_ref",
           "scatter_sum_ordered_ref", "gather_rows_ref", "topk_decompress",
           "sparse_gather_sum_ref", "flash_attention", "slstm_cell",
           "slstm_scan_ref", "slstm_scan_save_ref", "slstm_scan_grad_ref"]


def neighbor_gather_sum_ref(buf: torch.Tensor, nbrs: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """``out[p] = Σ_j mask[p, j] · buf[nbrs[p, j]]`` → (P, D) float32.

    Slots are summed in order ``j = 0 .. ps-1``, as the kernels do.
    """
    p, ps = nbrs.shape
    out = torch.zeros((p, buf.shape[1]), dtype=torch.float32,
                      device=buf.device)
    for j in range(ps):
        row = buf.index_select(0, nbrs[:, j].long()).float()
        out = out + row * mask[:, j, None].float()
    return out


def topk_decompress(values: torch.Tensor, idx: torch.Tensor,
                    d_feat: int) -> torch.Tensor:
    """Inverse of top-k compression: ``(N, k) → (N, d_feat)`` dense,
    ``out[n, idx[n, s]] = values[n, s]`` and zeros elsewhere.

    A row's ids are distinct (a top-k guarantee), so each word is written
    at most once: deterministic, and an exact identity at ``k == d_feat``.
    The ids may travel as int16; torch's index ops take int64, so they are
    widened here.
    """
    out = values.new_zeros((values.shape[0], d_feat))
    return out.scatter_(1, idx.long(), values)


def sparse_gather_sum_ref(values: torch.Tensor, idx: torch.Tensor,
                          nbrs: torch.Tensor, mask: torch.Tensor,
                          d_feat: int) -> torch.Tensor:
    """``out[p] = Σ_j mask[p, j] · decompress(values, idx)[nbrs[p, j]]`` →
    (P, d_feat) float32: decompress the buffer, then the dense gather-sum
    (the reference's jnp path, ``repro/core/pipeline.py:152-169``)."""
    return neighbor_gather_sum_ref(topk_decompress(values, idx, d_feat),
                                   nbrs, mask)


def _ordered_add(out: torch.Tensor, rows: torch.Tensor, srt: torch.Tensor,
                 start: torch.Tensor, lens: torch.Tensor) -> None:
    """In place: ``out[rows[i]] += srt[start[i] + k]`` for ``k < lens[i]``,
    added in ``k`` order; ``rows`` distinct.  The loop runs over the rank
    ``k``, vectorised across the runs; the runs are taken longest first,
    so the live ones at rank ``k`` are a prefix whose lengths are read
    from the device once."""
    if rows.numel() == 0:
        return
    by_len = torch.argsort(lens, descending=True, stable=True)
    lens_desc = lens[by_len].cpu().numpy()
    # live[k] = runs longer than k
    live = np.searchsorted(-lens_desc, -np.arange(int(lens_desc[0])),
                           side="left")
    start = start[by_len]
    rows = rows[by_len]
    acc = out.index_select(0, rows)
    for k, n in enumerate(live.tolist()):
        acc[:n] += srt.index_select(0, start[:n] + k)
    out[rows] = acc


def segment_add_ordered_ref(out: torch.Tensor, partial: torch.Tensor,
                            order: torch.Tensor, seg_rows: torch.Tensor,
                            seg_start: torch.Tensor,
                            chunks=None) -> torch.Tensor:
    """In place: ``out[seg_rows[s]] += Σ_k partial[order[k]]`` for ``k`` in
    segment ``s``, added in segment order (the order of ``order``).

    ``order`` is a stable argsort of the partitions' targets and
    ``seg_start`` its segment offsets, so each destination row receives its
    partials in partition order: bitwise what a sequential loop
    ``for i: out[tgt[i]] += partial[i]`` gives.  With ``chunks`` (a
    :class:`~repro_torch.kernels.ops.SegmentChunks`) a hub segment takes
    K3's two passes instead: each of its chunks summed in partition order
    from zero, then the chunk sums added onto its row in chunk order; the
    other segments are added as without chunks.
    """
    if seg_rows.numel() == 0:
        return out
    start = seg_start[:-1].long()
    lens = seg_start[1:].long() - start
    rows = seg_rows.long()
    srt = partial.index_select(0, order.long())
    if chunks is None:
        _ordered_add(out, rows, srt, start, lens)
        return out
    hub = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    hub[chunks.hubs.long()] = True
    first = chunks.chunk_start.long()
    sums = torch.zeros((first.shape[0], out.shape[1]), dtype=torch.float32,
                       device=out.device)
    _ordered_add(sums, torch.arange(first.shape[0], device=out.device), srt,
                 first, chunks.chunk_end.long() - first)
    _ordered_add(out, rows[~hub], srt, start[~hub], lens[~hub])
    hc = chunks.hub_chunks.long()
    _ordered_add(out, rows[hub], sums, hc[:-1], hc[1:] - hc[:-1])
    return out


def scatter_sum_ordered_ref(dbuf: torch.Tensor, g: torch.Tensor,
                            index) -> torch.Tensor:
    """In place: ``dbuf[rows[s]] += Σ_k g[src[k]]`` over the masked slots
    ``k`` of segment ``s`` of ``index`` (a
    :class:`~repro_torch.kernels.ops.GradIndex`) — the gather-sum's
    backward (the reference's ``zeros.at[nbrs].add(g · mask)``) with the
    order of its adds fixed: :func:`segment_add_ordered_ref` with ``src``
    as the order and the index's hub chunks."""
    return segment_add_ordered_ref(dbuf, g, index.src, index.rows,
                                   index.start, index.chunks)


def gather_rows_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` → (B, D) float32, bitwise a copy of the
    rows; an id outside ``[0, T)`` gives a zero row, as the kernel does."""
    idx = idx.long()
    ok = (idx >= 0) & (idx < src.shape[0])
    out = src.index_select(0, torch.where(ok, idx, 0)) if src.shape[0] \
        else src.new_zeros((idx.shape[0], src.shape[1]))
    out[~ok] = 0.0
    return out.float()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version of K7: softmax attention of q ``(B, S, H, hd)`` over
    k, v ``(B, S, KV, hd)`` (query head ``h`` reads KV head ``h // (H //
    KV)``), positions ``0 .. S-1`` on both sides, causal ``k <= q`` and
    ``q - k < window`` (0: no window) → ``(B, S, H, hd)`` in q's dtype.

    q is scaled by ``hd**-0.5`` in fp32 before its fp32 dot products, masked
    scores are -1e30, and the softmax over the whole row is fp32 (the
    reference's dense oracle); one (batch, head) at a time, so the
    ``(S, S)`` scores of one head are all it holds at once.
    """
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    pos = torch.arange(s, device=q.device)
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= (pos[:, None] - pos[None, :]) < window
    out = torch.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            qf = q[bi, :, hi].float() * hd ** -0.5
            kf = k[bi, :, hi // rep].float()
            vf = v[bi, :, hi // rep].float()
            scores = torch.where(ok, qf @ kf.T, -1e30)
            out[bi, :, hi] = (torch.softmax(scores, dim=-1) @ vf).to(q.dtype)
    return out


def _at_least_fp32(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def slstm_cell(xt: torch.Tensor, wr: torch.Tensor,
               st: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One sLSTM step, op for op the reference's ``_slstm_cell``
    (``repro/models/xlstm.py:191-210``): xt ``(B, H, 4·hd)`` fp32, each
    head ``[z | i | f | o]``; wr ``(H, hd, 4·hd)``; ``st`` h/c/n/m ``(B, H,
    hd)`` fp32 → the new states (fp64 inputs stay fp64, for gradcheck).
    The normaliser is ``maximum(|n|, 1)`` as the reference writes it, so
    that at ``|n| == 1`` the gradient splits half and half, as
    ``jnp.maximum``'s does (``clamp`` would pass all of it)."""
    hd = wr.shape[1]
    dt = _at_least_fp32(xt)
    h, c, n, m = st["h"], st["c"], st["n"], st["m"]
    rec = torch.einsum("bhd,hdg->bhg", h.to(dt), wr.to(dt))
    gates = xt.to(dt) + rec
    zt = torch.tanh(gates[..., 0 * hd:1 * hd])
    log_i = gates[..., 1 * hd:2 * hd]
    log_f = F.logsigmoid(gates[..., 2 * hd:3 * hd])
    ot = torch.sigmoid(gates[..., 3 * hd:4 * hd])
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * zt
    n = f_p * n + i_p
    h = ot * c / torch.maximum(n.abs(), n.new_ones(()))
    return dict(h=h, c=c, n=n, m=m_new)


def slstm_scan_ref(xp: torch.Tensor, wr: torch.Tensor,
                   state: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain version of K8: the sLSTM recurrence over S steps.

    xp ``(B, S, 4·D)`` fp32 in the model's head-major layout (``reshape(B,
    S, H, 4·hd)``, each head ``[z | i | f | o]``), wr ``(H, hd, 4·hd)``,
    ``state`` h/c/n/m ``(B, H, hd)`` fp32 → (hs ``(B, S, H, hd)`` fp32, the
    states after the last step).  A loop of :func:`slstm_cell`, as the
    reference's ``lax.scan`` over it (``xlstm.py:230``).
    """
    b, s = xp.shape[0], xp.shape[1]
    heads, hd = wr.shape[0], wr.shape[1]
    dt = _at_least_fp32(xp)
    xs = xp.reshape(b, s, heads, 4 * hd)
    st = {k: state[k].to(dt) for k in ("h", "c", "n", "m")}
    hs = []
    for t in range(s):
        st = slstm_cell(xs[:, t], wr, st)
        hs.append(st["h"])
    hs = torch.stack(hs, dim=1) if hs else xp.new_empty(
        (b, 0, heads, hd), dtype=dt)
    return hs, st


def slstm_scan_save_ref(xp: torch.Tensor, wr: torch.Tensor,
                        state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Plain version of K8's save: the loop of :func:`slstm_cell` keeping
    each step's gate pre-activations ``g`` ``(B, S, H, hd, 4)`` (z, i, f, o
    a unit) and the states ``c``, ``n``, ``m`` ``(B, S, H, hd)`` after each
    step."""
    b, s = xp.shape[0], xp.shape[1]
    heads, hd = wr.shape[0], wr.shape[1]
    dt = _at_least_fp32(xp)
    xs = xp.reshape(b, s, heads, 4 * hd).to(dt)
    st = {k: state[k].to(dt) for k in ("h", "c", "n", "m")}
    out = dict(g=[], c=[], n=[], m=[])
    for t in range(s):
        out["g"].append(xs[:, t] + torch.einsum("bhd,hdg->bhg", st["h"],
                                                wr.to(dt)))
        st = slstm_cell(xs[:, t], wr, st)
        for k in "cnm":
            out[k].append(st[k])
    if not s:
        return dict(g=xs.new_empty((b, 0, heads, hd, 4)),
                    **{k: xs.new_empty((b, 0, heads, hd)) for k in "cnm"})
    g = torch.stack(out["g"], 1).reshape(b, s, heads, 4, hd)
    return dict(g=g.transpose(-1, -2).contiguous(),
                **{k: torch.stack(out[k], 1) for k in "cnm"})


def slstm_scan_grad_ref(xp: torch.Tensor, wr: torch.Tensor,
                        state: Dict[str, torch.Tensor], dhs: torch.Tensor,
                        dstate: Optional[Dict[str, torch.Tensor]] = None):
    """Plain version of K9: the gradients of :func:`slstm_scan_ref` by
    autograd through its loop, as the reference's come from autodiff of
    ``lax.scan``.  ``dhs`` ``(B, S, H, hd)`` and ``dstate`` h/c/n/m ``(B,
    H, hd)`` (None: zeros) are the gradients of hs and of the states after
    the last step → (dxp ``(B, S, 4·D)``, dwr ``(H, hd, 4·hd)``, the
    gradients h/c/n/m of ``state``)."""
    with torch.enable_grad():
        xp_ = xp.detach().requires_grad_(True)
        wr_ = wr.detach().requires_grad_(True)
        st_ = {k: state[k].detach().requires_grad_(True) for k in "hcnm"}
        hs, st = slstm_scan_ref(xp_, wr_, st_)
        outs = [hs] + [st[k] for k in "hcnm"]
        cots = [dhs] + [torch.zeros_like(st[k]) if dstate is None
                        or dstate.get(k) is None else dstate[k]
                        for k in "hcnm"]
        ins = [xp_, wr_] + [st_[k] for k in "hcnm"]
        grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(ins, grads)]
    return grads[0], grads[1], dict(zip("hcnm", grads[2:]))
