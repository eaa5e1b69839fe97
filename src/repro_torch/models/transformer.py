"""Decoder-only LM assembly (counterpart of ``repro/models/transformer.py``):

  dense  — GQA transformer (codeqwen / nemo / qwen3 / starcoder2)
  vlm    — the dense backbone with a stub visual-token prefix (internvl2)
  moe    — dense attention + a MoE FFN (mixtral, granite; ``models/moe.py``)
  hybrid — Mamba2 blocks (``models/ssm.py``) with ONE shared attention +
           MLP block applied after every group of ``attn_every`` of them,
           then a tail (zamba2)
  xlstm  — alternating mLSTM/sLSTM groups (xlstm-125m; ``models/xlstm.py``,
           the sLSTM recurrence on K8 on the card)

Entry points: ``forward`` (the cache-less whole-sequence forward, where
flash attention runs under ``cfg.use_flash_attention``: every dense and
moe layer, and each application of the hybrid's shared block), ``loss_fn``
(the next-token cross-entropy that training differentiates), ``prefill``
and ``decode_step`` (ring-buffer KV caches, and the hybrid's and xlstm's
fp32 recurrent states; the hybrid's decode takes ``ssm_step``),
``init_params`` and ``init_cache``.  The parameter tree is the
reference's leaf for leaf: blocks are stacked with a leading layer (or
group) axis, and the reference's ``lax.scan`` over them is a loop over
that axis.  ``remat`` (the reference's ``jax.checkpoint``) is
``torch.utils.checkpoint`` around each dense or moe block, each hybrid
group (not its tail) and each xlstm group when autograd records the
cache-less forward: it changes memory, not values.  Caches are updated in
place.  The encdec family (whisper) is ``models/encdec.py``.  Over a
virtual mesh (``DistCtx``) the TP matmuls may take the ring and the moe
family its expert-parallel path.  Training runs with ``use_flash_attention`` off, as the
reference's must: K7 is forward only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import P
from ..train.tree import tree_map
from . import moe as moe_lib
from . import ssm as ssm_lib
from . import xlstm as xlstm_lib
from .layers import (KVCache, attention_apply, attention_init, dense_init,
                     draw_device, embed_init, embed_lookup, kv_cache_init,
                     layer_norm, mlp_apply, mlp_init, rms_norm,
                     unembed_logits)

__all__ = ["DistCtx", "init_params", "forward", "loss_fn", "prefill",
           "decode_step", "init_cache", "cache_length"]

_FAMILIES = ("dense", "vlm", "moe", "hybrid", "xlstm")


def _ported(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)


@dataclasses.dataclass(frozen=True)
class DistCtx:
    """Distribution context threaded through the model (no mesh ⇒ one
    device).  ``mesh`` is a :class:`~repro_torch.dist.mesh.VirtualMesh`:
    with ``use_ring_tp`` the TP matmuls take the ring-pipelined
    collectives (``models/layers.py``; they fall back to the plain matmul
    whenever shapes don't divide the model axis: decode's S = 1, odd head
    counts, ...), and the moe family's ``expert_mode="ep"`` takes the
    expert-parallel path when the model axis divides the experts.
    ``constrain`` is the identity: a layout hint changes no value on one
    card.  ``seq_shard_acts`` (Megatron-style sequence parallelism) is off
    for the recurrent families, as the reference's launchers set it."""

    mesh: Optional[Any] = None
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    moe_pipeline_chunks: int = 1   # MGG pipelining depth for EP dispatch
    shard_activations: bool = True
    use_ring_tp: bool = False
    seq_shard_acts: bool = True

    def constrain(self, h: torch.Tensor, spec=None) -> torch.Tensor:
        return h

    def act_spec(self, seq_sharded: bool = True) -> P:
        seq = seq_sharded and self.seq_shard_acts
        return P(self.data_axes, self.model_axis if seq else None, None)


def _norm(h, w, cfg):
    if cfg.norm == "ln":
        return layer_norm(h, w["scale"], w["bias"], cfg.norm_eps)
    return rms_norm(h, w["scale"], cfg.norm_eps)


def _norm_init(cfg, device, n: Optional[int] = None):
    lead = () if n is None else (n,)
    w = dict(scale=torch.ones(lead + (cfg.d_model,), dtype=cfg.pdtype,
                              device=device))
    if cfg.norm == "ln":
        w["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=cfg.pdtype,
                                device=device)
    return w


# ---------------------------------------------------------------------------
# the dense block
# ---------------------------------------------------------------------------

def _dense_block_init(gen: torch.Generator, cfg, n: Optional[int], dev):
    """One block's parameters, or ``n`` blocks stacked on a leading axis
    (drawn stacked: no second copy while stacking), on ``dev``."""
    return dict(ln1=_norm_init(cfg, dev, n),
                attn=attention_init(gen, cfg, n, dev),
                ln2=_norm_init(cfg, dev, n),
                mlp=mlp_init(gen, cfg, n=n, device=dev))


def _attn_sub(bp, h, cfg, positions, cache, ctx):
    a, new_cache = attention_apply(
        bp["attn"], _norm(h, bp["ln1"], cfg), cfg, positions, cache, ctx=ctx)
    return h + a, new_cache


def _dense_block(bp, h, cfg, positions, cache, ctx):
    h, new_cache = _attn_sub(bp, h, cfg, positions, cache, ctx)
    h = h + mlp_apply(bp["mlp"], _norm(h, bp["ln2"], cfg), cfg, ctx=ctx)
    return ctx.constrain(h), new_cache


def _dense_block_nc(bp, h, cfg, positions, ctx):
    """A dense block without a cache (what ``remat`` checkpoints)."""
    return _dense_block(bp, h, cfg, positions, None, ctx)[0]


# ---------------------------------------------------------------------------
# the moe block
# ---------------------------------------------------------------------------

def _moe_block_init(gen: torch.Generator, cfg, n: Optional[int], dev):
    return dict(ln1=_norm_init(cfg, dev, n),
                attn=attention_init(gen, cfg, n, dev),
                ln2=_norm_init(cfg, dev, n),
                moe=moe_lib.moe_init(gen, cfg, n, dev))


def _moe_block(bp, h, cfg, positions, cache, ctx):
    h, new_cache = _attn_sub(bp, h, cfg, positions, cache, ctx)
    z = _norm(h, bp["ln2"], cfg)
    if (cfg.expert_mode == "ep" and ctx.mesh is not None
            and cfg.n_experts % ctx.mesh.shape[ctx.model_axis] == 0):
        y = moe_lib.moe_apply_ep_shard(
            bp["moe"], z, cfg, ctx.mesh,
            data_axes=ctx.data_axes, model_axis=ctx.model_axis,
            pipeline_chunks=ctx.moe_pipeline_chunks)
    else:
        y = moe_lib.moe_apply(bp["moe"], z, cfg, ctx=ctx)
    return ctx.constrain(h + y), new_cache


def _moe_block_nc(bp, h, cfg, positions, ctx):
    return _moe_block(bp, h, cfg, positions, None, ctx)[0]


# ---------------------------------------------------------------------------
# the hybrid: mamba groups around one shared dense block
# ---------------------------------------------------------------------------

def _hybrid_layout(cfg):
    """(n_groups, group_size, tail) for the hybrid family."""
    gs = max(1, cfg.attn_every)
    n_groups = cfg.n_layers // gs
    return n_groups, gs, cfg.n_layers - n_groups * gs


def _mamba_block_init(gen: torch.Generator, cfg, n: int, dev):
    return dict(ln=_norm_init(cfg, dev, n),
                ssm=ssm_lib.ssm_init(gen, cfg, n, dev))


def _mamba_block(bp, h, cfg, state, ctx, *, step: bool):
    z = _norm(h, bp["ln"], cfg)
    fn = ssm_lib.ssm_step if step else ssm_lib.ssm_apply
    y, new_state = fn(bp["ssm"], z, cfg, state)
    return ctx.constrain(h + y), new_state


def _mamba_layer(stack, i, cfg, h, states, ctx, step):
    """Layer ``i`` of a stacked mamba ``stack``; with ``states`` (the
    stack's in the cache) its state is read and overwritten in place."""
    bp = tree_map(lambda x: x[i], stack)
    if states is None:
        return _mamba_block(bp, h, cfg, None, ctx, step=False)[0]
    st = {k: v[i] for k, v in states.items()}
    h, new = _mamba_block(bp, h, cfg, st, ctx, step=step)
    for k, v in new.items():
        st[k].copy_(v)
    return h


def _hybrid_group(params, cfg, g, h, positions, ctx):
    """Group ``g`` without a cache: its mamba blocks, then the shared
    block (what ``remat`` checkpoints)."""
    gs = _hybrid_layout(cfg)[1]
    for i in range(gs):
        h = _mamba_layer(params["mamba_main"], g * gs + i, cfg, h, None,
                         ctx, False)
    return _dense_block(params["shared_attn"], h, cfg, positions, None,
                        ctx)[0]


def _hybrid_forward(params, cfg, h, positions, cache, ctx, remat, step):
    """The reference's scan over groups (``transformer.py:333-393``):
    group g runs ``gs`` mamba blocks, then the shared dense block with
    group g's KV cache; then the tail's mamba blocks.  With ``remat`` (no
    cache) each group is checkpointed and the tail is not."""
    n_groups, gs, tail = _hybrid_layout(cfg)
    for g in range(n_groups):
        if cache is None:
            h = checkpoint(_hybrid_group, params, cfg, g, h, positions, ctx,
                           use_reentrant=False,
                           preserve_rng_state=False) if remat \
                else _hybrid_group(params, cfg, g, h, positions, ctx)
            continue
        for i in range(gs):
            h = _mamba_layer(params["mamba_main"], g * gs + i, cfg, h,
                             cache["ssm_main"], ctx, step)
        h, _ = _dense_block(params["shared_attn"], h, cfg, positions,
                            cache["attn"].layer(g), ctx)
    for i in range(tail):
        h = _mamba_layer(params["mamba_tail"], i, cfg, h,
                         None if cache is None else cache["ssm_tail"], ctx,
                         step)
    return h


# ---------------------------------------------------------------------------
# the xlstm groups
# ---------------------------------------------------------------------------

def _xlstm_stacks(cfg):
    """(groups, [(stack name, kind)]): the pattern repeated over the
    layers, one stack ``xl_{i}_{kind}`` per pattern element."""
    pat = cfg.xlstm_pattern or ("m", "s")
    return (cfg.n_layers // len(pat),
            [(f"xl_{i}_{kind}", kind) for i, kind in enumerate(pat)])


def _xlstm_block_init(gen: torch.Generator, cfg, kind: str, n: int, dev):
    mix = xlstm_lib.mlstm_init if kind == "m" else xlstm_lib.slstm_init
    return dict(ln=_norm_init(cfg, dev, n), mix=mix(gen, cfg, n, dev))


def _xlstm_block(bp, h, cfg, kind, state, ctx):
    z = _norm(h, bp["ln"], cfg)
    fn = xlstm_lib.mlstm_apply if kind == "m" else xlstm_lib.slstm_apply
    y, new_state = fn(bp["mix"], z, cfg, state=state)
    return ctx.constrain(h + y), new_state


def _xlstm_group(params, cfg, g, h, ctx):
    """Group ``g`` without a cache: one block of every stack in order."""
    for name, kind in _xlstm_stacks(cfg)[1]:
        h, _ = _xlstm_block(tree_map(lambda x: x[g], params[name]), h, cfg,
                            kind, None, ctx)
    return h


def _xlstm_forward(params, cfg, h, cache, ctx, remat=False):
    """The reference's scan over groups (``transformer.py:394-425``): each
    group applies one block of every stack in pattern order; a cache's
    states are read and overwritten in place.  With ``remat`` (no cache)
    each group is checkpointed, as the reference's ``group_fn_nc``."""
    n_groups, stacks = _xlstm_stacks(cfg)
    for g in range(n_groups):
        if cache is None:
            h = checkpoint(_xlstm_group, params, cfg, g, h, ctx,
                           use_reentrant=False,
                           preserve_rng_state=False) if remat \
                else _xlstm_group(params, cfg, g, h, ctx)
            continue
        for name, kind in stacks:
            bp = tree_map(lambda x: x[g], params[name])
            st = {k: v[g] for k, v in cache[name].items()}
            h, new = _xlstm_block(bp, h, cfg, kind, st, ctx)
            for k, v in new.items():
                st[k].copy_(v)
    return h


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg, vocab_multiple: int = 16, *,
                device=None) -> Dict[str, Any]:
    """The reference's parameter tree for ``cfg``, every leaf drawn on
    ``device`` (by default ``gen``'s; no host copy).  ``device="meta"``
    with a CPU generator builds the tree's shapes and allocates nothing,
    as a dry run does."""
    _ported(cfg)
    dev = draw_device(gen, device)
    params: Dict[str, Any] = dict(
        embed=embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype,
                         vocab_multiple, dev),
        final_norm=_norm_init(cfg, dev),
    )
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            gen, cfg.d_model,
            -(-cfg.vocab // vocab_multiple) * vocab_multiple, cfg.pdtype,
            device=dev)
    if cfg.family == "xlstm":
        n_groups, stacks = _xlstm_stacks(cfg)
        for name, kind in stacks:
            params[name] = _xlstm_block_init(gen, cfg, kind, n_groups, dev)
        return params
    if cfg.family == "hybrid":
        n_groups, gs, tail = _hybrid_layout(cfg)
        params["mamba_main"] = _mamba_block_init(gen, cfg, n_groups * gs,
                                                 dev)
        if tail:
            params["mamba_tail"] = _mamba_block_init(gen, cfg, tail, dev)
        # zamba2's shared transformer block (attention + MLP): ONE
        # parameter set applied after every group
        params["shared_attn"] = _dense_block_init(gen, cfg, None, dev)
        return params
    if cfg.family == "moe":
        params["blocks"] = _moe_block_init(gen, cfg, cfg.n_layers, dev)
        return params
    params["blocks"] = _dense_block_init(gen, cfg, cfg.n_layers, dev)
    if cfg.family == "vlm":
        params["vis_proj"] = dense_init(gen, cfg.d_model, cfg.d_model,
                                        cfg.pdtype, device=dev)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_length(cfg, seq_len: int) -> int:
    """Ring-buffer size: the sliding window bounds it when set."""
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cpu"):
    """Decode caches for a maximum context of ``seq_len`` tokens: one
    ring-buffer KV cache a layer, stacked on a leading layer axis; for the
    xlstm family, each stack's recurrent states, fp32 whatever ``dtype``
    is asked (as the reference), stacked on a leading group axis; for the
    hybrid, the mamba states (fp32) of ``ssm_main`` (one a main layer)
    and ``ssm_tail``, and under ``attn`` one KV cache a group (the shared
    block's, stacked on the group axis).  Every leaf has batch on axis 1."""
    _ported(cfg)

    def stack(tree, n):
        return {k: v.expand((n,) + v.shape).contiguous()
                for k, v in tree.items()}

    def kv(n):
        c = kv_cache_init(cfg, batch, cache_length(cfg, seq_len), dtype,
                          device)
        return KVCache(**stack(dict(k=c.k, v=c.v, key_pos=c.key_pos), n))

    if cfg.family == "hybrid":
        n_groups, gs, tail = _hybrid_layout(cfg)
        st = ssm_lib.ssm_state_init(cfg, batch, device=device)
        out = dict(ssm_main=stack(st, n_groups * gs), attn=kv(n_groups))
        if tail:
            out["ssm_tail"] = stack(st, tail)
        return out
    if cfg.family == "xlstm":
        n_groups, stacks = _xlstm_stacks(cfg)
        out = {}
        for name, kind in stacks:
            init = (xlstm_lib.mlstm_state_init if kind == "m"
                    else xlstm_lib.slstm_state_init)
            out[name] = stack(init(cfg, batch, device=device), n_groups)
        return out
    return dict(kv=kv(cfg.n_layers))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(
    params: Dict[str, Any],
    cfg,
    tokens: torch.Tensor,              # (B, S)
    *,
    ctx: DistCtx = DistCtx(),
    positions: Optional[torch.Tensor] = None,
    cache=None,
    vis: Optional[torch.Tensor] = None,   # vlm: (B, n_vis, d_model)
    remat: Optional[bool] = None,
    step: bool = False,                # decode single-step mode
):
    """Returns (logits, new_cache); the cache is updated in place.
    ``remat`` (default ``cfg.remat``) checkpoints each dense or moe block,
    hybrid group or xlstm group when autograd records a cache-less
    forward.  ``step`` (with a cache) runs the hybrid's mamba blocks in
    their single-token form."""
    _ported(cfg)
    remat = (cfg.remat if remat is None else remat) and cache is None \
        and torch.is_grad_enabled()
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev).expand(b, s)
    h = embed_lookup(params["embed"], tokens, cfg.cdtype)
    n_vis = 0
    if cfg.family == "vlm" and vis is not None:
        hv = vis.to(cfg.cdtype) @ params["vis_proj"]["w"].to(cfg.cdtype)
        h = torch.cat([hv, h], dim=1)
        n_vis = vis.shape[1]
        positions = torch.arange(s + n_vis, dtype=torch.int32,
                                 device=dev).expand(b, s + n_vis)
    h = ctx.constrain(h)

    if cfg.family == "xlstm":
        h = _xlstm_forward(params, cfg, h, cache, ctx, remat)
    elif cfg.family == "hybrid":
        h = _hybrid_forward(params, cfg, h, positions, cache, ctx, remat,
                            step)
    else:
        moe = cfg.family == "moe"
        block = _moe_block if moe else _dense_block
        block_nc = _moe_block_nc if moe else _dense_block_nc
        kv = None if cache is None else cache["kv"]
        for i in range(cfg.n_layers):
            bp = tree_map(lambda x: x[i], params["blocks"])
            if remat:
                h = checkpoint(block_nc, bp, h, cfg, positions, ctx,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h, _ = block(bp, h, cfg, positions,
                             None if kv is None else kv.layer(i), ctx)

    h = _norm(h, params["final_norm"], cfg)
    if n_vis:
        h = h[:, n_vis:]
    if cfg.tie_embeddings:
        logits = unembed_logits(params["embed"], h, cfg.vocab)
    else:
        logits = h.float() @ params["lm_head"]["w"].float()
        if logits.shape[-1] != cfg.vocab:
            logits[..., cfg.vocab:] = -1e30
    return logits, cache


def loss_fn(params, cfg, batch: Dict[str, torch.Tensor], *,
            ctx: DistCtx = DistCtx()):
    """Next-token CE (mean over non-masked positions), the reference's
    ``loss_fn`` (``transformer.py:442``): ``batch`` holds ``tokens`` (B,
    S), optionally ``loss_mask`` (B, S) and, for the vlm family, ``vis``
    → ``(loss, dict(loss, ntokens))``."""
    tokens = batch["tokens"]
    logits, _ = forward(params, cfg, tokens, ctx=ctx, vis=batch.get("vis"))
    tgt = tokens[:, 1:]
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(ll) if mask is None \
        else mask[:, 1:].to(ll.dtype)
    ntokens = mask.sum()
    loss = -(ll * mask).sum() / torch.maximum(ntokens, ntokens.new_ones(()))
    return loss, dict(loss=loss, ntokens=ntokens)


def prefill(params, cfg, tokens, cache, *, ctx: DistCtx = DistCtx(),
            vis=None):
    """Run the prompt; fills caches; returns (last-position logits, cache)."""
    logits, new_cache = forward(params, cfg, tokens, ctx=ctx, cache=cache,
                                vis=vis, remat=False)
    return logits[:, -1], new_cache


def decode_step(params, cfg, token, pos, cache, *, ctx: DistCtx = DistCtx()):
    """One decode step. token: (B,) int; pos: (B,) absolute position."""
    logits, new_cache = forward(params, cfg, token[:, None], ctx=ctx,
                                positions=pos[:, None], cache=cache,
                                remat=False, step=True)
    return logits[:, 0], new_cache
