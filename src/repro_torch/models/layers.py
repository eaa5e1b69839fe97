"""Shared transformer layer library (counterpart of
``repro/models/layers.py``): plain functions on tensors and dicts of
tensors.

  * RMSNorm / LayerNorm
  * rotary embeddings (split halves; configurable theta; per-head qk_norm)
  * GQA attention with causal masking, sliding windows, chunked
    streaming-softmax attention and ring-buffer KV caches for decode; the
    cache-less forward takes flash attention (K7 on the card) when
    ``cfg.use_flash_attention`` is set, as the reference routes it
  * SwiGLU and GELU MLPs
  * padded vocab embedding / logits (pad logits -1e30 in fp32)

Dtype policy, as in the reference: parameters are stored in
``cfg.param_dtype`` and cast to the compute dtype at each use; softmax and
normalisation accumulate in fp32.  Inits draw from an explicit
``torch.Generator`` on the device the parameters live on (the reference's
distributions, other bits).  Unlike the reference, a KV cache is updated
in place (no second copy of a cache is kept).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops

__all__ = [
    "rms_norm", "layer_norm", "rope_frequencies", "apply_rope",
    "attention_init", "attention_apply", "mlp_init", "mlp_apply",
    "embed_init", "embed_lookup", "unembed_logits", "dense_init",
    "KVCache", "kv_cache_init", "padded_vocab",
    "ring_tp_colwise", "ring_tp_rowwise",
]

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# ring-pipelined tensor-parallel matmuls (DistCtx.use_ring_tp)
#
# With Megatron-style sequence parallelism the residual stream is sharded on
# the sequence dim over the model axis; a column-parallel matmul needs the
# full sequence gathered first, and its row-parallel partner a
# reduce(-scatter) after.  These route that pair through the ring-pipelined
# collectives of dist/collectives.py, whose per-step transfer overlaps the
# previous step's product (MGG Fig. 7(b) applied to the dense LM stack).  On
# one card the global tensor is cut into its (data, model) blocks on the
# virtual mesh, the collective runs over the stack, and the global result is
# joined back: the same values as ``x @ w`` in another order of sums.
# ---------------------------------------------------------------------------

def _ring_tp_active(ctx, *dims_divisible) -> bool:
    """True when ctx opted in, the model axis is real, and shapes divide."""
    if ctx is None or not getattr(ctx, "use_ring_tp", False) \
            or getattr(ctx, "mesh", None) is None:
        return False
    m = int(ctx.mesh.shape.get(ctx.model_axis, 1))
    if m <= 1:
        return False
    return all(d % m == 0 for d in dims_divisible)


def _data_size(ctx) -> int:
    return int(np.prod([int(ctx.mesh.shape.get(a, 1))
                        for a in ctx.data_axes]))


def ring_tp_colwise(x: Tensor, w: Tensor, ctx) -> Tensor:
    """``x @ w`` with x (B, S, D) sequence-sharded and w (D, F) column-
    parallel over the model axis → (B, S, F) feature-sharded.

    The sequence all-gather rides the ring fused into the matmul
    (``ring_allgather_matmul``): row block j is multiplied the moment it
    arrives while block j+1 is in flight.  Falls back to a plain matmul
    when the flag is off or shapes don't divide (decode's S = 1 always).
    """
    b, s, d = x.shape
    f = w.shape[-1]
    if not _ring_tp_active(ctx, s, f) or b % _data_size(ctx) != 0:
        return x @ w
    from ..dist.collectives import ring_allgather_matmul
    from ..dist.sharding import MeshSharding

    mesh, axis = ctx.mesh, ctx.model_axis
    m, lead = int(mesh.shape[axis]), mesh.ndim
    data = tuple(ctx.data_axes)
    xs = MeshSharding(mesh, (data, axis, None)).cut(x)  # (*M, B_l, S/m, D)
    ws = MeshSharding(mesh, (None, axis)).cut(w)        # (*M, D, F/m)
    shp, (bl, sl, _) = xs.shape[:lead], xs.shape[lead:]
    fl = ws.shape[-1]
    out = ring_allgather_matmul(xs.reshape(shp + (bl * sl, d)), ws, mesh,
                                axis)                   # (*M, m·B_l·S_l, F/m)
    out = out.reshape(shp + (m, bl, sl, fl)).movedim(lead, lead + 1)
    return MeshSharding(mesh, (data, None, axis)).join(
        out.reshape(shp + (bl, m * sl, fl)))


def ring_tp_rowwise(x: Tensor, w: Tensor, ctx) -> Tensor:
    """``x @ w`` with x (B, S, F) feature-sharded and w (F, D) row-parallel
    over the model axis → (B, S, D) sequence-sharded.

    The partial-sum reduce-scatter is fused into a pipelined ring
    (``matmul_reducescatter``): each step computes one output row block
    while the travelling accumulator is on the wire.
    """
    b, s, f = x.shape
    d = w.shape[-1]
    if not _ring_tp_active(ctx, s, f) or b % _data_size(ctx) != 0:
        return x @ w
    from ..dist.collectives import matmul_reducescatter
    from ..dist.sharding import MeshSharding

    mesh, axis = ctx.mesh, ctx.model_axis
    m, lead = int(mesh.shape[axis]), mesh.ndim
    data = tuple(ctx.data_axes)
    xs = MeshSharding(mesh, (data, None, axis)).cut(x)  # (*M, B_l, S, F/m)
    ws = MeshSharding(mesh, (axis, None)).cut(w)        # (*M, F/m, D)
    shp, (bl, _, fl) = xs.shape[:lead], xs.shape[lead:]
    sl = s // m
    # shard-major row order so shard i's reduce-scatter chunk is its own
    # sequence block (matching the colwise gather order)
    lhs = xs.reshape(shp + (bl, m, sl, fl)).movedim(lead + 1, lead)
    out = matmul_reducescatter(lhs.reshape(shp + (m * bl * sl, fl)), ws,
                               mesh, axis)              # (*M, B_l·S_l, D)
    return MeshSharding(mesh, (data, axis, None)).join(
        out.reshape(shp + (bl, sl, d)))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w.to(x.dtype)


def layer_norm(x: Tensor, w: Tensor, b: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  fp32 inside, cast back."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., None].float() * freqs          # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense / embedding primitives
# ---------------------------------------------------------------------------

def draw_device(gen: torch.Generator, device=None) -> torch.device:
    """Where an init draws: ``device`` when given (``meta`` for a dry
    run, which takes a CPU generator and allocates nothing), else
    ``gen``'s device."""
    return gen.device if device is None else torch.device(device)


def dense_init(gen: torch.Generator, fan_in: int, fan_out: int, dtype,
               n: Optional[int] = None, device=None) -> Dict[str, Tensor]:
    """``w ~ N(0, 2 / (fan_in + fan_out))``, drawn on :func:`draw_device`;
    ``n`` stacks that many layers on a leading axis."""
    shape = (fan_in, fan_out) if n is None else (n, fan_in, fan_out)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=draw_device(gen, device))
    return dict(w=w.mul_((2.0 / (fan_in + fan_out)) ** 0.5).to(dtype))


def padded_vocab(vocab: int, multiple: int) -> int:
    return -(-vocab // multiple) * multiple


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               multiple: int = 16, device=None) -> Dict[str, Tensor]:
    vp = padded_vocab(vocab, multiple)
    w = torch.randn((vp, d_model), generator=gen, dtype=torch.float32,
                    device=draw_device(gen, device))
    return dict(w=w.mul_(d_model ** -0.5).to(dtype))


def embed_lookup(emb: Dict[str, Tensor], tokens: Tensor,
                 compute_dtype) -> Tensor:
    return emb["w"][tokens.long()].to(compute_dtype)


def unembed_logits(emb: Dict[str, Tensor], h: Tensor, vocab: int) -> Tensor:
    """Tied unembedding in fp32; pad logits set to -1e30."""
    logits = h.float() @ emb["w"].float().T
    if emb["w"].shape[0] != vocab:
        logits[..., vocab:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# attention (GQA + RoPE + qk_norm + sliding window + chunked softmax)
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg, n: Optional[int] = None,
                   device=None) -> Dict[str, Any]:
    hd, dt = cfg.head_dim, cfg.pdtype
    p = dict(
        wq=dense_init(gen, cfg.d_model, cfg.n_heads * hd, dt, n, device),
        wk=dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dt, n, device),
        wv=dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dt, n, device),
        wo=dense_init(gen, cfg.n_heads * hd, cfg.d_model, dt, n, device),
    )
    if cfg.qk_norm:
        lead = () if n is None else (n,)
        dev = draw_device(gen, device)
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dt, device=dev)
    return p


@dataclasses.dataclass
class KVCache:
    """Ring-buffer KV cache: ``size`` slots (= sliding window when set).

    ``k``/``v``: (B, size, KV, hd).  ``key_pos``: (B, size) absolute position
    held in each slot (-1 ⇒ empty).  Slot for position p is ``p % size``.
    A stacked cache carries a leading layer axis on all three.
    """

    k: Tensor
    v: Tensor
    key_pos: Tensor

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a stacked cache (views: writes land in it)."""
        return KVCache(self.k[i], self.v[i], self.key_pos[i])


def kv_cache_init(cfg, batch: int, size: int, dtype,
                  device="cpu") -> KVCache:
    hd = cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, size, cfg.n_kv_heads, hd), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, size, cfg.n_kv_heads, hd), dtype=dtype,
                      device=device),
        key_pos=torch.full((batch, size), -1, dtype=torch.int32,
                           device=device),
    )


def _chunked_softmax_attention(
    q: Tensor,        # (B, S, H, hd)
    k: Tensor,        # (B, T, KV, hd)
    v: Tensor,        # (B, T, KV, hd)
    q_pos: Tensor,    # (B, S)
    k_pos: Tensor,    # (B, T)  (-1 ⇒ masked slot)
    window: int,      # 0 ⇒ full causal
    chunk: int,
) -> Tensor:
    """Streaming-softmax attention over key chunks (flash-attention
    dataflow): ``T`` is consumed in chunks with running max/denominator
    carries, so the (S, T) score matrix is never held whole."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    kv = k.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    qf = q.float() * scale
    n_chunks = -(-t // chunk)
    t_pad = n_chunks * chunk
    if t_pad != t:
        pad = (0, 0, 0, 0, 0, t_pad - t)
        k = F.pad(k, pad)
        v = F.pad(v, pad)
        k_pos = F.pad(k_pos, (0, t_pad - t), value=-1)

    acc = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, s, h), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, s, h), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kb = k[:, sl].repeat_interleave(rep, dim=2).float()   # (B,c,H,hd)
        vb = v[:, sl].repeat_interleave(rep, dim=2).float()
        pb = k_pos[:, sl]                                     # (B,c)
        logits = torch.einsum("bshd,bchd->bshc", qf, kb)      # (B,S,H,c)
        ok = (pb[:, None, :] <= q_pos[:, :, None]) & (pb[:, None, :] >= 0)
        if window > 0:
            ok &= (q_pos[:, :, None] - pb[:, None, :]) < window
        logits = torch.where(ok[:, :, None, :], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bshc,bchd->bshd", p, vb)
        m = m_new
    return (acc / torch.maximum(l, l.new_full((), 1e-30))[..., None]).to(
        q.dtype)


def _write_cache(cache: KVCache, k: Tensor, v: Tensor, pos: Tensor) -> None:
    """Write each row's new KV at slots ``pos % size`` (in place)."""
    slots = (pos % cache.k.shape[1]).long()
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache.k[bidx, slots] = k.to(cache.k.dtype)
    cache.v[bidx, slots] = v.to(cache.v.dtype)
    cache.key_pos[bidx, slots] = pos.to(cache.key_pos.dtype)


def attention_apply(
    p: Dict[str, Any],
    x: Tensor,                      # (B, S, D)
    cfg,
    positions: Tensor,              # (B, S)
    cache: Optional[KVCache] = None,
    *,
    causal: bool = True,
    kv_override: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
    chunk: int = 1024,
    ctx=None,
) -> Tuple[Tensor, Optional[KVCache]]:
    """GQA attention, routed as the reference routes it:

    * cross-attention: ``kv_override=(k, v, k_pos)`` bypasses the cache;
    * ``cache=None``: attends over the sequence itself — flash attention
      (K7 on the card) under ``cfg.use_flash_attention``, else chunked;
    * decode (``S == 1`` with a cache): the new KV are written at
      ``positions % size`` first, then the query attends over the ring;
    * prefill (``S > 1`` with a cache): chunked self-attention, then the
      last ``min(S, size)`` KVs are written into the ring.

    The cache is updated in place and returned.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = ring_tp_colwise(x, p["wq"]["w"].to(x.dtype), ctx) \
        .reshape(b, s, cfg.n_heads, hd)
    if kv_override is None:
        k = ring_tp_colwise(x, p["wk"]["w"].to(x.dtype), ctx) \
            .reshape(b, s, cfg.n_kv_heads, hd)
        v = ring_tp_colwise(x, p["wv"]["w"].to(x.dtype), ctx) \
            .reshape(b, s, cfg.n_kv_heads, hd)
    else:
        k, v, kv_pos = kv_override
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if kv_override is None:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0 and kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    window = cfg.sliding_window or 0
    new_cache = None
    if kv_override is not None:
        if causal:
            out = _chunked_softmax_attention(q, k, v, positions, kv_pos,
                                             window, chunk)
        else:
            out = _chunked_softmax_attention(
                q, k, v, torch.full_like(positions, 2 ** 30), kv_pos, 0,
                chunk)
    elif cache is None:
        if getattr(cfg, "use_flash_attention", False):
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
        else:
            # masks k_pos <= q_pos whatever ``causal`` says: the
            # reference drops ``causal=False`` here too (its layers.py
            # :380-383, masked at :305), so whisper's encoder is causal
            # with the flag off and bidirectional with it on; the port
            # keeps that to hold the reference's losses (ROADMAP §3 F3)
            out = _chunked_softmax_attention(q, k, v, positions, positions,
                                             window, chunk)
    elif s == 1:
        _write_cache(cache, k, v, positions)
        new_cache = cache
        out = _chunked_softmax_attention(q, cache.k, cache.v, positions,
                                         cache.key_pos, window, chunk)
    else:
        out = _chunked_softmax_attention(q, k, v, positions, positions,
                                         window, chunk)
        tail = min(s, cache.k.shape[1])
        _write_cache(cache, k[:, -tail:], v[:, -tail:], positions[:, -tail:])
        new_cache = cache
    out = out.reshape(b, s, cfg.n_heads * hd)
    return ring_tp_rowwise(out, p["wo"]["w"].to(x.dtype), ctx), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg, d_ff: Optional[int] = None,
             n: Optional[int] = None, device=None) -> Dict[str, Any]:
    d_ff = d_ff or cfg.d_ff
    dt = cfg.pdtype
    if cfg.mlp_type == "swiglu":
        return dict(
            gate=dense_init(gen, cfg.d_model, d_ff, dt, n, device),
            up=dense_init(gen, cfg.d_model, d_ff, dt, n, device),
            down=dense_init(gen, d_ff, cfg.d_model, dt, n, device),
        )
    return dict(
        up=dense_init(gen, cfg.d_model, d_ff, dt, n, device),
        down=dense_init(gen, d_ff, cfg.d_model, dt, n, device),
    )


def mlp_apply(p: Dict[str, Any], x: Tensor, cfg, ctx=None) -> Tensor:
    if "gate" in p:
        g = F.silu(ring_tp_colwise(x, p["gate"]["w"].to(x.dtype), ctx))
        u = ring_tp_colwise(x, p["up"]["w"].to(x.dtype), ctx)
        return ring_tp_rowwise(g * u, p["down"]["w"].to(x.dtype), ctx)
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(ring_tp_colwise(x, p["up"]["w"].to(x.dtype), ctx),
               approximate="tanh")
    return ring_tp_rowwise(h, p["down"]["w"].to(x.dtype), ctx)
