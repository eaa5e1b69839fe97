"""Whisper-style encoder-decoder backbone, whisper-base (counterpart of
``repro/models/encdec.py``).

The conv/mel frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings ``(B, n_frames, d_model)``.  The backbone:

* encoder: pre-LN self-attention with ``causal=False`` + GELU MLP, and
  sinusoidal positions added to the frames;
* decoder: causal self-attention (a ring-buffer KV cache for decode),
  cross attention over the encoder's output and a GELU MLP, sinusoidal
  positions computed per position (so decode takes any position), logits
  from the tied embedding.

The parameter tree is the reference's leaf for leaf: ``enc_blocks`` and
``dec_blocks`` are stacked on a leading layer axis, and the reference's
``lax.scan`` (and ``_stacked_cross``'s ``lax.map``) over them is a loop
over that axis.  ``remat`` is ``torch.utils.checkpoint`` around each block
when autograd records a cache-less pass.  A cache is updated in place
(the reference returns a new one).

The encoder is bidirectional only under ``cfg.use_flash_attention`` (K7
on the card, causal off): with the flag off, its cache-less attention
takes the chunked path, which masks ``k_pos <= q_pos`` whatever
``causal`` says, exactly as the reference's does (ROADMAP §3 F3).
Training runs with the flag off, so the port keeps that behaviour and
holds the reference's losses and gradients.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..train.tree import tree_map
from .layers import (KVCache, attention_apply, attention_init, draw_device,
                     embed_init, embed_lookup, kv_cache_init, layer_norm,
                     mlp_apply, mlp_init, unembed_logits)
from .transformer import DistCtx

__all__ = ["init_params", "loss_fn", "encode", "prefill", "decode_step",
           "init_cache", "sinusoid"]


def _ln_init(cfg, device, n: Optional[int] = None):
    lead = () if n is None else (n,)
    return dict(scale=torch.ones(lead + (cfg.d_model,), dtype=cfg.pdtype,
                                 device=device),
                bias=torch.zeros(lead + (cfg.d_model,), dtype=cfg.pdtype,
                                 device=device))


def _ln(h, w, cfg):
    return layer_norm(h, w["scale"], w["bias"], cfg.norm_eps)


def sinusoid(seq: int, d: int) -> np.ndarray:
    """The encoder's positions: float64 angles, cast to float32."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(
        np.float32)


def _pos_emb(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The decoder's positions (B, S) → (B, S, d) float32: float32 angles
    of float32 positions, as the reference (its float64 frequencies become
    float32 under JAX's default precision)."""
    freqs = torch.from_numpy(
        (10000 ** (-2 * np.arange(d // 2) / d)).astype(np.float32)).to(
        positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_init(gen: torch.Generator, cfg, n: int, dev):
    return dict(ln1=_ln_init(cfg, dev, n),
                attn=attention_init(gen, cfg, n, dev),
                ln2=_ln_init(cfg, dev, n),
                mlp=mlp_init(gen, cfg, n=n, device=dev))


def _dec_block_init(gen: torch.Generator, cfg, n: int, dev):
    return dict(ln1=_ln_init(cfg, dev, n),
                self_attn=attention_init(gen, cfg, n, dev),
                ln2=_ln_init(cfg, dev, n),
                cross_attn=attention_init(gen, cfg, n, dev),
                ln3=_ln_init(cfg, dev, n),
                mlp=mlp_init(gen, cfg, n=n, device=dev))


def init_params(gen: torch.Generator, cfg, vocab_multiple: int = 16, *,
                device=None) -> Dict[str, Any]:
    """The reference's parameter tree, every leaf drawn on ``device`` (by
    default ``gen``'s; ``meta`` allocates nothing); the vocabulary padded
    to ``vocab_multiple`` rows."""
    dev = draw_device(gen, device)
    return dict(
        embed=embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype,
                         vocab_multiple, dev),
        enc_blocks=_enc_block_init(gen, cfg, cfg.n_enc_layers, dev),
        dec_blocks=_dec_block_init(gen, cfg, cfg.n_layers, dev),
        enc_ln=_ln_init(cfg, dev),
        dec_ln=_ln_init(cfg, dev),
    )


def _cross_kv(bp, enc_out, cfg):
    b, t, _ = enc_out.shape
    hd = cfg.head_dim
    k = (enc_out @ bp["wk"]["w"].to(enc_out.dtype)).reshape(
        b, t, cfg.n_kv_heads, hd)
    v = (enc_out @ bp["wv"]["w"].to(enc_out.dtype)).reshape(
        b, t, cfg.n_kv_heads, hd)
    return k, v


def _arange(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device).expand(b, t)


def _enc_block(bp, h, cfg, positions, ctx):
    a, _ = attention_apply(bp["attn"], _ln(h, bp["ln1"], cfg), cfg,
                           positions, causal=False, ctx=ctx)
    h = h + a
    h = h + mlp_apply(bp["mlp"], _ln(h, bp["ln2"], cfg), cfg, ctx=ctx)
    return ctx.constrain(h)


def encode(params, cfg, frames: torch.Tensor, *, ctx: DistCtx = DistCtx(),
           remat: Optional[bool] = None) -> torch.Tensor:
    """frames: (B, T, d_model) stub conv output → encoder states."""
    b, t, d = frames.shape
    h = frames.to(cfg.cdtype) + torch.from_numpy(sinusoid(t, d)).to(
        frames.device, cfg.cdtype)[None]
    h = ctx.constrain(h)
    positions = _arange(b, t, frames.device)
    remat = (cfg.remat if remat is None else remat) \
        and torch.is_grad_enabled()
    for i in range(cfg.n_enc_layers):
        bp = tree_map(lambda x: x[i], params["enc_blocks"])
        h = checkpoint(_enc_block, bp, h, cfg, positions, ctx,
                       use_reentrant=False, preserve_rng_state=False) \
            if remat else _enc_block(bp, h, cfg, positions, ctx)
    return _ln(h, params["enc_ln"], cfg)


def _dec_block(bp, h, cfg, positions, cache, cross, ctx):
    """One decoder block; ``cross`` is (k, v, k_pos) of the encoder's
    output; ``cache`` (a layer's KV cache or None) is updated in place."""
    a, _ = attention_apply(bp["self_attn"], _ln(h, bp["ln1"], cfg), cfg,
                           positions, cache, ctx=ctx)
    h = h + a
    x2, _ = attention_apply(bp["cross_attn"], _ln(h, bp["ln2"], cfg), cfg,
                            positions, kv_override=cross, causal=False,
                            ctx=ctx)
    h = h + x2
    h = h + mlp_apply(bp["mlp"], _ln(h, bp["ln3"], cfg), cfg, ctx=ctx)
    return ctx.constrain(h)


def _dec_layer(bp, h, cfg, positions, enc_out, enc_pos, ctx, cache=None):
    """A decoder block, its cross K/V computed from ``enc_out`` (without
    a cache, what ``remat`` checkpoints)."""
    ck, cv = _cross_kv(bp["cross_attn"], enc_out, cfg)
    return _dec_block(bp, h, cfg, positions, cache, (ck, cv, enc_pos), ctx)


def _embed(params, cfg, tokens, positions):
    return embed_lookup(params["embed"], tokens, cfg.cdtype) \
        + _pos_emb(positions, cfg.d_model).to(cfg.cdtype)


def _decoder(params, cfg, tokens, enc_out, enc_pos, *, ctx, positions,
             cache=None, remat=False):
    """The decoder over ``tokens`` (B, S), each block's cross K/V computed
    from ``enc_out``; ``cache`` (the stacked self-attention KV cache) is
    filled in place → (logits, cache)."""
    h = ctx.constrain(_embed(params, cfg, tokens, positions))
    remat = remat and cache is None and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        bp = tree_map(lambda x: x[i], params["dec_blocks"])
        if remat:
            h = checkpoint(_dec_layer, bp, h, cfg, positions, enc_out,
                           enc_pos, ctx, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _dec_layer(bp, h, cfg, positions, enc_out, enc_pos, ctx,
                           None if cache is None else cache.layer(i))
    h = _ln(h, params["dec_ln"], cfg)
    return unembed_logits(params["embed"], h, cfg.vocab), cache


def loss_fn(params, cfg, batch: Dict[str, torch.Tensor], *,
            ctx: DistCtx = DistCtx()):
    """batch: ``frames`` (B, T, d), ``tokens`` (B, S) → the mean
    next-token cross-entropy, ``(loss, dict(loss, ntokens))``."""
    frames, tokens = batch["frames"], batch["tokens"]
    b, s = tokens.shape
    enc_out = encode(params, cfg, frames, ctx=ctx)
    enc_pos = _arange(b, enc_out.shape[1], enc_out.device)
    logits, _ = _decoder(params, cfg, tokens, enc_out, enc_pos, ctx=ctx,
                         positions=_arange(b, s, tokens.device),
                         remat=cfg.remat)
    tgt = tokens[:, 1:]
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    loss = -ll.mean()
    return loss, dict(loss=loss, ntokens=torch.tensor(
        float(ll.numel()), dtype=torch.float32, device=ll.device))


def init_cache(cfg, batch: int, seq_len: int, n_frames: int,
               dtype=torch.bfloat16, device="cpu"):
    """The decoder's self-attention KV cache (stacked over layers) and
    the cross K/V ``(n_layers, B, n_frames, KV, hd)`` that ``prefill``
    fills, in ``dtype``; ``enc_pos`` (B, n_frames) int32."""
    n = cfg.n_layers
    c = kv_cache_init(cfg, batch, min(seq_len, 2 ** 20), dtype, device)
    stack = lambda x: x.expand((n,) + x.shape).contiguous()
    cross = (n, batch, n_frames, cfg.n_kv_heads, cfg.head_dim)
    return dict(
        kv=KVCache(k=stack(c.k), v=stack(c.v), key_pos=stack(c.key_pos)),
        cross_k=torch.zeros(cross, dtype=dtype, device=device),
        cross_v=torch.zeros(cross, dtype=dtype, device=device),
        enc_pos=torch.zeros((batch, n_frames), dtype=torch.int32,
                            device=device),
    )


def _stacked_cross(params, enc_out, cfg):
    """Every decoder layer's cross K/V, stacked on the layer axis."""
    cross = params["dec_blocks"]["cross_attn"]
    ks, vs = zip(*(_cross_kv(tree_map(lambda x: x[i], cross), enc_out, cfg)
                   for i in range(cfg.n_layers)))
    return torch.stack(ks), torch.stack(vs)


def prefill(params, cfg, frames, tokens, cache, *, ctx: DistCtx = DistCtx()):
    """Encode the audio and run the prompt: fills ``cache`` in place (the
    cross K/V cast to its dtype) → (last-position logits, cache)."""
    b, s = tokens.shape
    enc_out = encode(params, cfg, frames, ctx=ctx, remat=False)
    enc_pos = _arange(b, enc_out.shape[1], enc_out.device)
    ck, cv = _stacked_cross(params, enc_out, cfg)
    logits, _ = _decoder(params, cfg, tokens, enc_out, enc_pos, ctx=ctx,
                         positions=_arange(b, s, tokens.device),
                         cache=cache["kv"])
    cache["cross_k"].copy_(ck)
    cache["cross_v"].copy_(cv)
    cache["enc_pos"].copy_(enc_pos)
    return logits[:, -1], cache


def decode_step(params, cfg, token, pos, cache, *, ctx: DistCtx = DistCtx()):
    """One decoder token (B,) at absolute positions ``pos`` (B,), over the
    cached self KV and cross K/V; the cache is updated in place →
    (logits, cache)."""
    positions = pos[:, None]
    h = _embed(params, cfg, token[:, None], positions)
    kv = cache["kv"]
    for i in range(cfg.n_layers):
        bp = tree_map(lambda x: x[i], params["dec_blocks"])
        h = _dec_block(bp, h, cfg, positions, kv.layer(i),
                       (cache["cross_k"][i], cache["cross_v"][i],
                        cache["enc_pos"]), ctx)
    h = _ln(h, params["dec_ln"], cfg)
    return unembed_logits(params["embed"], h, cfg.vocab)[:, 0], cache
