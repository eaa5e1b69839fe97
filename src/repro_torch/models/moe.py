"""Mixture-of-Experts with sort-based capacity dispatch (counterpart of
``repro/models/moe.py``).

Tokens are bucketed per expert into an ``(E, C, d)`` capacity buffer (the
analogue of MGG's fixed-size neighbor partitions), each expert's FFN runs
as one batched product over its ``C`` slots, and the outputs are combined
back with the renormalized top-k gates.  Pairs beyond an expert's capacity
are dropped (weight 0; the residual keeps those tokens' values).  The
capacity is the reference's ``max(1, int(T·k / E · capacity_factor))``, so
it depends on the number of tokens in the call: at the default 1.25 a
prefill, a decode step and a batch route differently from the whole
sequence, as in the reference.

* Routing keeps ``lax.top_k``'s order: a stable descending sort, whose
  first ``k`` put the lower expert id first on a tie (``torch.topk``
  promises no order).
* The dispatch gather reads a token up to ``k`` times, so its autograd
  backward would be an ``index_add_`` (atomics on the card, other last
  bits from run to run).  :class:`_Dispatch` is that gather with a
  backward that gathers each token's kept slots over the pair→slot map
  and sums them over ``k`` in order: deterministic, plain PyTorch.  The
  combine's own backward only ever adds zeros to a kept slot's sum (a
  dropped pair reads a clipped slot with weight 0).

The expert products are ``torch.bmm`` (the reference's einsums sit
outside any Pallas kernel).  The expert-parallel path
(:func:`moe_apply_ep_shard`, an ``all_to_all`` over a mesh) is ROADMAP
item 9 and raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .layers import dense_init

__all__ = ["moe_init", "moe_apply", "moe_apply_ep_shard"]

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg,
             n: Optional[int] = None) -> Dict[str, Any]:
    """The reference's expert tree (router, ``w_up``/``w_gate`` (E, d, f),
    ``w_down`` (E, f, d) ~ N(0, 2 / (d + f))); ``n`` stacks layers."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    lead = () if n is None else (n,)
    scale = (2.0 / (d + f)) ** 0.5

    def draw(shape):
        w = torch.randn(lead + shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return w.mul_(scale).to(cfg.pdtype)

    p = dict(router=dense_init(gen, d, e, cfg.pdtype, n),
             w_up=draw((e, d, f)), w_down=draw((e, f, d)))
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = draw((e, d, f))
    return p


def _route(p, x2d: Tensor, cfg):
    """Top-k routing → (gates (T, k) fp32, experts (T, k) int64): the
    router logits in fp32, the k largest with the lower id first on a tie
    (``lax.top_k``), softmax-renormalized over the selected."""
    logits = (x2d @ p["router"]["w"].to(x2d.dtype)).float()
    top = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, tope = top.values[:, :cfg.top_k], top.indices[:, :cfg.top_k]
    return torch.softmax(topv, dim=-1), tope


def _dispatch_indices(tope: Tensor, n_experts: int, capacity: int):
    """Sort-based capacity dispatch (no (T, E, C) one-hot tensor).

    Returns per-slot token ids (E, C), per-slot validity, and for each
    (token, k) pair its rank within its expert (its slot when kept) and
    its keep flag, as the reference's ``_dispatch_indices``.
    """
    t, k = tope.shape
    dev = tope.device
    flat_e = tope.reshape(-1)                       # (T·k,)
    order = torch.argsort(flat_e, stable=True)      # pairs grouped by expert
    inv = torch.argsort(order, stable=True)         # pair → rank in sorted
    sorted_e = flat_e[order]
    ids = torch.arange(n_experts, dtype=flat_e.dtype, device=dev)
    start = torch.searchsorted(sorted_e, ids)                   # (E,)
    end = torch.searchsorted(sorted_e, ids + 1)
    # slot s of expert e ← pair order[start[e] + s]
    slot_pair = start[:, None] + torch.arange(capacity, device=dev)[None, :]
    slot_valid = slot_pair < end[:, None]
    slot_pair = slot_pair.clamp(0, t * k - 1)
    slot_token = order[slot_pair] // k                          # (E, C)
    pair_rank = inv - start[flat_e]                 # rank within expert
    pair_kept = pair_rank < capacity
    return (slot_token, slot_valid, pair_rank.reshape(t, k),
            pair_kept.reshape(t, k))


class _Dispatch(torch.autograd.Function):
    """``xe = x2d[slot_token] · slot_valid`` (E, C, d), whose backward is
    a gather: token t's gradient is the sum over its pairs j = 0..k-1, in
    that order, of the gradient at the pair's slot where the pair is kept
    (each valid slot holds exactly one kept pair).  No atomics, so the
    bits are the same from run to run."""

    @staticmethod
    def forward(ctx, x2d, slot_token, slot_valid, pair_idx, pair_kept):
        ctx.save_for_backward(pair_idx, pair_kept)
        return x2d[slot_token] * slot_valid[..., None].to(x2d.dtype)

    @staticmethod
    def backward(ctx, g):
        pair_idx, pair_kept = ctx.saved_tensors
        flat = g.reshape(-1, g.shape[-1])
        dx = None
        for j in range(pair_idx.shape[1]):
            part = flat[pair_idx[:, j]] * pair_kept[:, j, None].to(g.dtype)
            dx = part if dx is None else dx + part
        return dx, None, None, None, None


def _expert_ffn(p, xe: Tensor, cfg) -> Tensor:
    """xe: (E, C, d) → (E, C, d); per-expert SwiGLU/GELU FFN."""
    w_up = p["w_up"].to(xe.dtype)
    w_down = p["w_down"].to(xe.dtype)
    if "w_gate" in p:
        g = F.silu(torch.bmm(xe, p["w_gate"].to(xe.dtype)))
        return torch.bmm(g * torch.bmm(xe, w_up), w_down)
    # jax.nn.gelu's default is the tanh approximation
    return torch.bmm(F.gelu(torch.bmm(xe, w_up), approximate="tanh"), w_down)


def moe_apply(p: Dict[str, Any], x: Tensor, cfg, *,
              capacity_factor: Optional[float] = None,
              ctx=None) -> Tensor:
    """Single-program MoE: dispatch → expert FFN → combine.  x: (B, S, D).
    ``ctx`` is accepted for the reference's signature (its sharding
    anchors are the identity on one card)."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, tope = _route(p, x2d, cfg)
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    capacity = max(1, int(t * cfg.top_k / cfg.n_experts * capacity_factor))
    slot_token, slot_valid, pair_slot, pair_kept = _dispatch_indices(
        tope, cfg.n_experts, capacity)
    # token t's k-th pair reads (expert, slot) of the flat (E·C, d) buffer
    pair_idx = tope * capacity + pair_slot.clamp(0, capacity - 1)
    xe = _Dispatch.apply(x2d, slot_token, slot_valid, pair_idx, pair_kept)
    ye = _expert_ffn(p, xe, cfg)                        # (E, C, d)
    y_pairs = ye.reshape(cfg.n_experts * capacity, d)[pair_idx.reshape(-1)]
    w = (gates * pair_kept).to(x.dtype)
    return torch.einsum("tkd,tk->td", y_pairs.reshape(t, cfg.top_k, d),
                        w).reshape(b, s, d)


def moe_apply_ep_shard(p, x, cfg, mesh, **kw):
    """The expert-parallel path: experts sharded over a mesh's model axis,
    the dispatch buffer exchanged (and pipelined) by ``all_to_all``."""
    raise NotImplementedError(
        "expert-parallel MoE over a mesh (all_to_all dispatch) is ROADMAP "
        "item 9 (ring TP and NCCL across real cards)")
