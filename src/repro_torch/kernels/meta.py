"""The kernels on meta tensors: what a dry run (``launch/dryrun.py``,
``launch/dryrun_gnn.py``) reaches where the card would launch a kernel.

Each function takes what its kernel's wrapper takes, returns an empty
meta tensor of the kernel's result shape (an in-place kernel returns its
output as it is), and records the launch's work in the active counters
(``kernels/cost.py``): exact for the kernels whose work is a function of
their shapes (K3, K7, K8, K9), the most the shapes allow for the
data-dependent ones (K1, K2, K4, K5, K6: a meta tensor holds no ids), so
marked ``exact=False``.  No launch count moves: nothing is launched.
``kernels/ops.py`` routes a meta tensor here, and nothing else does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import cost

__all__ = ["gather_sum_pipelined", "gather_sum_blocked",
           "segment_add_ordered", "scatter_sum_ordered", "sparse_gather_sum",
           "gather_rows", "flash_attention", "slstm_scan",
           "slstm_scan_backward"]

_META = torch.device("meta")


def _empty(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def _gather(name, buf, nbrs):
    p, ps = nbrs.shape
    cost.record(name, lambda: cost.worst_gather_sum(buf.shape[0], p, ps,
                                                    buf.shape[1]))
    return _empty((p, buf.shape[1]))


def gather_sum_pipelined(buf, nbrs, mask) -> torch.Tensor:
    """K1's contract: ``(P, D)`` float32."""
    return _gather("gather_sum_pipelined", buf, nbrs)


def gather_sum_blocked(buf, nbrs, mask, *, pb: int) -> torch.Tensor:
    """K2's contract: ``(P, D)`` float32."""
    return _gather("gather_sum_blocked", buf, nbrs)


def segment_add_ordered(out, partial, order, seg_rows, seg_start,
                        chunks=None) -> torch.Tensor:
    """K3's contract: ``out``, added into in place."""
    cost.record("segment_add_ordered", lambda: cost.segment_add(
        partial.shape[0], seg_rows.shape[0], out.shape[1]))
    return out


def scatter_sum_ordered(dbuf, g, index) -> torch.Tensor:
    """K4's contract: ``dbuf``, added into in place."""
    cost.record("scatter_sum_ordered", lambda: cost.worst_scatter_sum(
        g.shape[0], index.src.shape[0], index.rows.shape[0], dbuf.shape[1]))
    return dbuf


def sparse_gather_sum(values, idx, nbrs, mask, d_feat: int) -> torch.Tensor:
    """K6's contract: ``(P, d_feat)`` float32."""
    p, ps = nbrs.shape
    cost.record("sparse_gather_sum", lambda: cost.worst_sparse_gather_sum(
        values.shape[0], p, ps, values.shape[1], d_feat,
        idx.element_size()))
    return _empty((p, d_feat))


def gather_rows(src, idx) -> torch.Tensor:
    """K5's contract: ``(B, D)`` float32."""
    cost.record("gather_rows", lambda: cost.worst_gather_rows(
        src.shape[0], idx.shape[0], src.shape[1]))
    return _empty((idx.shape[0], src.shape[1]))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """K7's contract: ``(B, S, H, hd)`` in q's dtype."""
    b, s, h, hd = q.shape
    cost.record("flash_attention", lambda: cost.flash_attention(
        b, s, h, k.shape[2], hd, causal=causal, window=window,
        itemsize=q.element_size()))
    return _empty(q.shape, q.dtype)


def slstm_scan(xp, wr, state: Dict[str, torch.Tensor], *,
               bt: Optional[int] = None, save: bool = False):
    """K8's contract: (hs ``(B, S, H, hd)``, the final states), and with
    ``save`` the gates and states K9 reads."""
    b, s = xp.shape[0], xp.shape[1]
    h, hd = wr.shape[0], wr.shape[1]
    cost.record("slstm_scan", lambda: cost.slstm_scan(b, s, h, hd,
                                                      save=save))
    hs = _empty((b, s, h, hd))
    new = {k: _empty((b, h, hd)) for k in "hcnm"}
    if not save:
        return hs, new
    saved = dict(g=_empty((b, s, h, hd, 4)),
                 **{k: _empty((b, s, h, hd)) for k in "cnm"})
    return hs, new, saved


def slstm_scan_backward(dhs, dstate, wr, saved, state, *,
                        bt: Optional[int] = None):
    """K9's contract: (dxp ``(B, S, H·4·hd)``, the initial states'
    gradients)."""
    b, s, h, hd = dhs.shape
    cost.record("slstm_scan_backward",
                lambda: cost.slstm_scan_backward(b, s, h, hd))
    return (_empty((b, s, h * 4 * hd)),
            {k: _empty((b, h, hd)) for k in "hcnm"})
