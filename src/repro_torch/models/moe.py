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
(:func:`moe_apply_ep_shard`) runs every shard of a virtual mesh at once:
each shard routes its own tokens (its capacity from its own token count)
with the dispatch and combine of :func:`moe_apply`, and the ``(E, C, d)``
buffers are exchanged over the model axis by ``all_to_all`` (a copy on
the mesh's side stream), chunked along capacity so that chunk *i+1*'s
exchange overlaps chunk *i*'s expert FFN.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .layers import dense_init, draw_device

__all__ = ["moe_init", "moe_apply", "moe_apply_ep_shard"]

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg, n: Optional[int] = None,
             device=None) -> Dict[str, Any]:
    """The reference's expert tree (router, ``w_up``/``w_gate`` (E, d, f),
    ``w_down`` (E, f, d) ~ N(0, 2 / (d + f))); ``n`` stacks layers."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    lead = () if n is None else (n,)
    scale = (2.0 / (d + f)) ** 0.5

    def draw(shape):
        w = torch.randn(lead + shape, generator=gen, dtype=torch.float32,
                        device=draw_device(gen, device))
        return w.mul_(scale).to(cfg.pdtype)

    p = dict(router=dense_init(gen, d, e, cfg.pdtype, n, device),
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
    its keep flag, as the reference's ``_dispatch_indices``.  ``tope``
    may carry leading dims (one dispatch a shard): each is dispatched on
    its own, and the outputs carry the same leading dims.
    """
    *lead, t, k = tope.shape
    dev = tope.device
    flat_e = tope.reshape(*lead, t * k)                         # (..., T·k)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # pairs by expert
    inv = torch.argsort(order, dim=-1, stable=True)     # pair → rank
    sorted_e = torch.gather(flat_e, -1, order)
    ids = torch.arange(n_experts, dtype=flat_e.dtype, device=dev)
    ids = ids.expand(*lead, n_experts).contiguous()
    start = torch.searchsorted(sorted_e, ids)                   # (..., E)
    end = torch.searchsorted(sorted_e, ids + 1)
    # slot s of expert e ← pair order[start[e] + s]
    slot_pair = start[..., :, None] + torch.arange(capacity, device=dev)
    slot_valid = slot_pair < end[..., None]
    slot_pair = slot_pair.clamp(0, t * k - 1)
    slot_token = torch.gather(order, -1, slot_pair.reshape(
        *lead, n_experts * capacity)).reshape(slot_pair.shape) // k
    pair_rank = inv - torch.gather(start, -1, flat_e)   # rank within expert
    pair_kept = pair_rank < capacity
    return (slot_token, slot_valid, pair_rank.reshape(*lead, t, k),
            pair_kept.reshape(*lead, t, k))


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
              expert_fn=None, ctx=None) -> Tensor:
    """Single-program MoE: dispatch → expert FFN → combine.  x: (B, S, D).
    ``expert_fn(p, xe, cfg)`` replaces the expert FFN on the (E, C, d)
    buffer (the EP path's hook).  ``ctx`` is accepted for the reference's
    signature (its sharding anchors are the identity on one card)."""
    return _moe(p, x, cfg, capacity_factor, expert_fn or _expert_ffn, 0)


def _moe(p, x: Tensor, cfg, capacity_factor, expert_fn, lead: int):
    """:func:`moe_apply` over ``x`` (``*shards, B, S, D``) with ``lead``
    leading shard dims: each shard routes its own ``B·S`` tokens at the
    capacity of that count, through one dispatch gather and one combine
    over all shards (flat indices offset by shard), and ``expert_fn``
    sees the stacked ``(*shards, E, C, d)`` buffers."""
    shards = x.shape[:lead]
    n_sh = int(torch.Size(shards).numel())
    b, s, d = x.shape[lead:]
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    x2d = x.reshape(n_sh * t, d)
    gates, tope = _route(p, x2d, cfg)
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    capacity = max(1, int(t * k / e * capacity_factor))
    tope_g = tope.reshape(n_sh, t, k) if lead else tope
    slot_token, slot_valid, pair_slot, pair_kept = _dispatch_indices(
        tope_g, e, capacity)
    # token t's k-th pair reads (expert, slot) of the flat (E·C, d) buffer
    pair_idx = tope_g * capacity + pair_slot.clamp(0, capacity - 1)
    if lead:        # shard g's tokens and slots sit g·T and g·E·C further
        g = torch.arange(n_sh, device=x.device)
        slot_token = slot_token + (g * t)[:, None, None]
        pair_idx = (pair_idx + (g * e * capacity)[:, None, None]
                    ).reshape(n_sh * t, k)
        pair_kept = pair_kept.reshape(n_sh * t, k)
    xe = _Dispatch.apply(x2d, slot_token, slot_valid, pair_idx, pair_kept)
    ye = expert_fn(p, xe.reshape(shards + (e, capacity, d)), cfg)
    y_pairs = ye.reshape(n_sh * e * capacity, d)[pair_idx.reshape(-1)]
    w = (gates * pair_kept).to(x.dtype)
    return torch.einsum("tkd,tk->td", y_pairs.reshape(n_sh * t, k, d),
                        w).reshape(x.shape)


def moe_apply_ep_shard(
    p: Dict[str, Any],
    x: Tensor,
    cfg,
    mesh,
    *,
    data_axes=("data",),
    model_axis: str = "model",
    capacity_factor: Optional[float] = None,
    pipeline_chunks: int = 1,
) -> Tensor:
    """EP MoE over a virtual mesh: experts sharded over ``model_axis``.

    Tokens are cut over the data axes and, when ``S % ep == 0`` and ``S >=
    ep``, over the model axis too (every shard routes a distinct token
    block; otherwise they are replicated over it).  Each shard's (E, C, d)
    dispatch buffer is exchanged with ``all_to_all`` to (E/ep, C·ep, d);
    with ``pipeline_chunks > 1`` the capacity axis is chunked and the
    exchange of chunk *i+1* is enqueued before the expert FFN of chunk
    *i* consumes its buffer — MGG's communication-computation overlap
    (paper Fig. 7b).
    """
    from ..dist.sharding import MeshSharding

    ep = int(mesh.shape[model_axis])
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts over a model axis of "
                         f"{ep}")
    lead, a = mesh.ndim, mesh.axis(model_axis)

    def expert_fn(p_blk, xe, cfg):
        # xe: (*M, E, C, d) local dispatch buffers → exchange → experts
        c = xe.shape[-2]
        chunks = min(pipeline_chunks, c)
        if c % chunks:
            chunks = 1
        xc = xe.unflatten(lead + 1, (chunks, c // chunks))

        def exchange(z):  # (E, c', d) → (E/ep, c'·ep, d)
            return mesh.all_to_all(z, model_axis, 0, 1)

        outs = []
        cur = exchange(xc.select(lead + 1, 0))
        for i in range(chunks):
            nxt = exchange(xc.select(lead + 1, i + 1)) \
                if i + 1 < chunks else None
            mesh.wait(cur[1])
            with mesh.span("expert_ffn"):
                y = _local_experts(p_blk, cur[0], cfg, a, lead)
            outs.append(mesh.all_to_all(y, model_axis, 1, 0))
            if nxt is not None:
                cur = nxt
        for _, token in outs:
            mesh.wait(token)
        return torch.cat([y for y, _ in outs], dim=lead + 1)

    seq_shardable = x.shape[1] % ep == 0 and x.shape[1] >= ep
    sh = MeshSharding(mesh, (tuple(data_axes),
                             model_axis if seq_shardable else None, None))
    y = _moe(p, sh.cut(x), cfg, capacity_factor, expert_fn, lead)
    return sh.join(y)


def _local_experts(p, xe: Tensor, cfg, a: int, lead: int) -> Tensor:
    """Every shard's FFN on its own experts: ``xe`` (*M, E/ep, C', d), shard
    ``j`` along mesh dim ``a`` holding experts ``[j·E/ep, (j+1)·E/ep)``.
    The other mesh dims fold into the rows, so each expert's table is read
    by one batched product."""
    z = xe.movedim(a, 0).movedim(lead, 1)      # (ep, E/ep, *rest, C', d)
    shp = z.shape
    y = _expert_ffn(p, z.reshape(shp[0] * shp[1], -1, shp[-1]), cfg)
    return y.reshape(shp).movedim(1, lead).movedim(0, a)
