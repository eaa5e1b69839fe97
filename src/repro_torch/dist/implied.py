"""The collectives a real mesh's partitioner adds to a cell, by site.

On one card ``DistCtx.constrain`` is the identity and nothing moves.  On
the reference's mesh XLA's SPMD partitioner lays every tensor out from
the arguments' specs (``dist/sharding.py``) and the activations'
constraints (``DistCtx.act_spec``: batch on the data axes and, outside
the recurrent families, the sequence on the model axis), and adds a
collective wherever an operation needs a layout its operand lacks.  Each
function here is called by the model at one such site with the tensors
the port holds (global shapes) and, while a ``kernels/cost.py`` counter
records (a dry run, ``launch/dryrun.py``), records what the reference's
partitioned HLO shows at that site: kind, operand bytes per device and
count, forward, rematerialised forward and backward.  Outside a count it
does nothing and returns its tensors unchanged.

Every rule was read off the reference's partitioned HLO of its smoke
cells on (2, 2) and (1, 4) meshes of fake CPU devices (op, operand shape,
replica groups, enclosing computation, trip count; ``hlo_cost``).  Below,
``b`` is the batch a device holds (``B`` over the data axes when the
batch is cut), ``m`` the model axis.  XLA's CPU backend carries bf16
arithmetic in fp32, so every floating collective of the reference's HLO
moves 4 bytes an element whatever the compute dtype: the rules record
that width.

* Attention over the sequence (train, prefill, cross-attention), keys cut
  on the model axis: the key/value chunk scan needs every chunk, so each
  of K and V is all-gathered, ``b · P · KV · hd · 4`` (``P`` the padded
  length over ``m``).  Where padding to whole chunks moves the cut, a
  halo ``collective-permute`` comes first, ``(m - 1)(P - L)`` rows in hops
  of at most ``L = T / m``.  Where the chunks are fewer than ``m`` and
  divide it, XLA cuts the chunk axis over ``n_chunks`` and the rows
  within a chunk over ``m / n_chunks``, and gathers each chunk again at
  both products (``2 n_chunks`` all-gathers of ``b · P · H · hd · 4``).
  Training adds the same again in the rematerialised forward (with the
  key positions' ``int32`` gather, after their halo), and in the backward
  one ``all-reduce`` a chunk of the partial key and value gradients
  (``2 · b · H · chunk · hd · 4``, summed over the cut queries), the
  transposed halo, and in the sub-axis case the chunk gathers again.
* A train step's parameters (tensor-parallel on the model axis, FSDP on
  the data axes): each cut leaf gathered whole for its use, in two
  passes for the stacked layers; each gradient all-reduced whole over
  each axis (an expert-parallel table only over the data axes).
* Prefill's cache write (cache cut on batch and KV heads): the new keys
  and values gathered over the data axes, then ``all-to-all`` from the
  sequence cut to the head cut, and the scatter's ``int32`` indices.
* The next-token loss: the labels' shift across the sequence cut
  (``collective-permute``) and, in the backward, ``take_along_axis``'s
  indices gathered.
* The last position's logits (prefill) and the vlm's visual prefix
  (``all-to-all`` at the concatenation, the backbone's output gathered
  for the slice that drops the prefix, vocab-cut logits' softmax
  reductions).
* Decode (S = 1, activations batch-cut), by size: a weight shard
  smaller than the activation rows is gathered over the model axis, q/k/v
  re-cut to the cache's heads where the model axis divides them (else
  their partial products reduced), the norms reduced; larger shards stay
  cut and the row-parallel outputs are reduced.  Both: the cache write
  and the embedding's and head's reductions.
* The batch-only families (xlstm): the embedding's rows gathered or
  reduced and the tied head's gradient reduced; each layer's fused
  projections split at their middle (halo hops), the inner stream
  gathered, the output projection and the norms reduced; the sLSTM's
  state gathered and its gates re-cut each step, and its recurrent
  weight re-cut each step of the backward.

XLA's combiner merges some ops (a backward's key and value reductions
into one all-reduce; small gradients into one), so counts are the
partitioner's ops as this module issues them and may differ from the
HLO's count where the combiner merged; bytes are what is held to the
reference.  On the CPU backend a partitioner emits an all-reduce where a
GPU's would form a reduce-scatter; the HLO's op is what is recorded.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import cost

__all__ = ["Site", "site", "attention", "prefill_cache", "last_logits",
           "loss", "embed_rows", "vlm_prefix", "vlm_head", "decode_block",
           "decode_head", "xlstm_block"]

_I32 = 4
_F32 = 4


class Site:
    """One call's mesh: ``b`` the batch a device holds, ``m`` the model
    axis, ``data`` the data axes' product, ``seq`` whether activations are
    cut on the sequence; ``train`` while autograd records, ``again`` in a
    checkpointed block's recompute (the reference's remat)."""

    def __init__(self, ctx, batch: int, grad: bool):
        mesh = ctx.mesh
        self.m = int(mesh.shape.get(ctx.model_axis, 1))
        self.data = math.prod(int(mesh.shape.get(a, 1))
                              for a in ctx.data_axes)
        cut = ctx.shard_activations and batch % self.data == 0
        self.b = batch // self.data if cut else batch
        self.batch = batch
        self.seq = bool(ctx.seq_shard_acts) and self.m > 1
        self.train = bool(grad)
        self.again = torch._C._current_graph_task_id() != -1

    @staticmethod
    def rec(kind: str, nbytes: int, count: int = 1) -> None:
        if count and nbytes:
            cost.record_implied(kind, nbytes * count, count)


def site(ctx, batch: int, grad: bool = False) -> Optional[Site]:
    """The call's :class:`Site` while a dry run counts over a mesh with
    more than one device, else None."""
    if ctx is None or getattr(ctx, "mesh", None) is None \
            or not cost.is_counting() or ctx.mesh.size <= 1:
        return None
    return Site(ctx, batch, grad)


class _Backward(torch.autograd.Function):
    """Identity on ``x``; records ``note()`` when the gradient passes."""

    @staticmethod
    def forward(ctx, x, note):
        ctx.note = note
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.note()
        return g, None


def _on_backward(x: torch.Tensor, note) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Backward.apply(x, note)
    return x


def _halo(s: Site, row: int, t: int, p: int) -> None:
    """Padding a length ``t`` cut over the model axis to ``p`` rows a
    device: device ``i`` lacks ``(i + 1)(p - t / m)`` rows, which come
    from its right-hand neighbours in hops of at most ``t / m`` rows (one
    ``collective-permute`` a hop, sized by the last device's need)."""
    per = t // s.m
    left = (s.m - 1) * (p - per)
    while left > 0:
        hop = min(left, per)
        s.rec("collective-permute", s.b * hop * row)
        left -= hop


def attention(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              chunk: int):
    """Chunked attention of ``q`` (B, S, H, hd) over ``k``/``v`` (B, T,
    KV, hd) with the keys cut on the model axis (module docstring).
    Returns ``(k, v)``, which carry the backward's records."""
    train = torch.is_grad_enabled() and (k.requires_grad or q.requires_grad)
    s = site(ctx, k.shape[0], train)
    if s is None or not s.seq:
        return k, v
    _, t, kvh, hd = k.shape
    h = q.shape[2]
    n = -(-t // chunk)
    p = n * chunk // s.m
    row = kvh * hd * _F32
    sub = n < s.m and s.m % n == 0
    for _ in (k, v):
        if n * chunk != t:
            _halo(s, row, t, p)
        s.rec("all-gather", s.b * p * row)
        if sub:
            s.rec("all-gather", s.b * p * h * hd * _F32, n)
    if s.again:                     # the key positions, int32
        if n * chunk != t:
            s.rec("collective-permute",
                  s.b * min((s.m - 1) * (p - t // s.m), t // s.m) * _I32)
        s.rec("all-gather", s.b * p * _I32)
    if not s.train or s.again:
        return k, v

    def backward():
        s.rec("all-reduce", 2 * s.b * h * chunk * hd * _F32, n)
        if sub:
            s.rec("all-reduce", 2 * s.b * h * chunk * hd * _F32
                  * n // s.m, n)
            s.rec("all-gather", s.b * p * h * hd * _F32, 2 * n)
        if n * chunk != t:
            s.rec("collective-permute",
                  s.b * (s.m - 1) * (p - t // s.m) * row, 2)

    return _on_backward(k, backward), v


def prefill_cache(ctx, k: torch.Tensor) -> None:
    """Prefill writing ``k`` and its values (B, S', KV, hd), cut on the
    sequence, into a cache (B, size, KV, hd) cut on batch and on the KV
    heads where the model axis divides them."""
    s = site(ctx, k.shape[0])
    if s is None or not s.seq or k.shape[2] % s.m:
        return
    bsz, t, kvh, hd = k.shape
    rows = t // s.m
    row = kvh * hd * _F32
    if s.b < bsz:                       # the batch gathered over data
        s.rec("all-gather", s.b * rows * row, 2)
        s.rec("all-gather", s.b * rows * 2 * _I32)
        s.rec("collective-permute", s.b * rows * 2 * _I32)
    s.rec("all-to-all", bsz * rows * row, 2)
    s.rec("all-gather", bsz * rows * 2 * _I32)


def last_logits(ctx, logits: torch.Tensor) -> None:
    """Prefill's last-position logits (B, S, V) of a sequence-cut stream:
    the last shard's row, moved and reduced over the model axis."""
    s = site(ctx, logits.shape[0])
    if s is None or not s.seq:
        return
    row = logits.shape[-1] * _F32
    s.rec("all-reduce", s.b * row)
    s.rec("collective-permute", s.b * row)


def loss(ctx, tokens: torch.Tensor, logits: torch.Tensor, masked: bool,
         prefix: bool = False) -> torch.Tensor:
    """The next-token loss over ``tokens`` (B, S).  Sequence-cut logits:
    the labels' (and the mask's) shift across the cut, and in the backward
    ``take_along_axis``'s indices gathered.  Vocab-cut logits (a
    batch-only stream, or the vlm's head behind its ``prefix``): the
    softmax's max and sum reduced, forward and backward.  Returns
    ``logits``, which carries the backward's records."""
    train = torch.is_grad_enabled() and logits.requires_grad
    s = site(ctx, tokens.shape[0], train)
    if s is None or s.m == 1:
        return logits
    b, n = s.b, tokens.shape[1]
    vocab_cut = prefix or not s.seq
    if vocab_cut:
        s.rec("all-reduce", b * (n - 1) * _F32, 2)
    else:
        s.rec("collective-permute", b * _I32, 1 + masked)
    if not s.train:
        return logits

    def backward():
        if vocab_cut:
            s.rec("all-reduce", 2 * b * (n - 1) * _F32)
        else:
            if s.b < s.batch:
                s.rec("all-gather", b * n * _I32)
            s.rec("all-gather", b * n // s.m * _I32)

    return _on_backward(logits, backward)


def embed_rows(ctx, tokens: torch.Tensor, d: int) -> None:
    """A batch-only stream's training embedding of ``tokens`` (B, S) into
    ``d`` features (the table cut on vocab over the model axis, and on d
    over data when there is a data axis): its rows gathered over the
    model axis, or its partial rows reduced; in the backward the tied
    head's input gradient reduced."""
    train = torch.is_grad_enabled()
    s = site(ctx, tokens.shape[0], train)
    if s is None or s.m == 1 or s.seq or not s.train:
        return
    ex = s.b * tokens.shape[1]
    if s.data > 1:
        s.rec("all-gather", ex * d // s.m * _F32)
    else:
        s.rec("all-reduce", ex * d * _F32)
    s.rec("all-reduce", ex * d * _F32)


def vlm_prefix(ctx, h: torch.Tensor, n_vis: int) -> torch.Tensor:
    """The vlm's visual prefix concatenated before the token embeddings
    ``h`` (B, T, d) of a sequence-cut stream: the embeddings' and the
    concatenation's re-cut (``all-to-all``), and the split's in the
    backward.  Returns ``h``, which carries the backward's record."""
    train = torch.is_grad_enabled() and h.requires_grad
    s = site(ctx, h.shape[0], train)
    if s is None or not s.seq:
        return h
    _, t, d = h.shape
    row = d * _F32
    s.rec("all-to-all", s.b * (t - n_vis) // s.m * row)
    s.rec("all-to-all", s.b * t // s.m * row)
    if not s.train:
        return h
    return _on_backward(h, lambda: s.rec("all-to-all", s.b * t // s.m * row))


def vlm_head(ctx, h: torch.Tensor, n_vis: int) -> torch.Tensor:
    """Dropping the visual prefix from a sequence-cut stream ``h`` (B, T,
    d) before the vocab-cut head: the shifted rows' halo, the tokens'
    rows gathered for the product; in the backward the halo twice and the
    product's partial sums over the vocabulary.  Returns ``h``."""
    train = torch.is_grad_enabled() and h.requires_grad
    s = site(ctx, h.shape[0], train)
    if s is None or not s.seq:
        return h
    _, t, d = h.shape
    row = d * _F32
    shift = n_vis * (s.m - 1) // s.m
    s.rec("collective-permute", s.b * shift * row)
    s.rec("all-gather", s.b * (t - n_vis) // s.m * row)
    if not s.train:
        return h

    def backward():
        s.rec("collective-permute", s.b * shift * row, 2)
        s.rec("all-reduce", s.b * (t - n_vis) * d * _F32)

    return _on_backward(h, backward)


def _cut(w: torch.Tensor, dim: int, m: int) -> int:
    """Bytes of one model shard of weight ``w`` cut on ``dim`` (at the
    reference's width), or 0 where ``m`` does not divide it (replicated)."""
    return w.numel() * _F32 // m if w.shape[dim] % m == 0 else 0


def _gathers_weights(s: Site, wq: torch.Tensor, cfg) -> bool:
    """Decode's size rule: XLA moves the smaller operand, so it gathers a
    projection's weight whose model shard is smaller than the activation
    rows it would otherwise reduce (``b · d``; the smoke widths), and
    keeps the weights cut (Megatron's column- then row-parallel pair,
    one reduction each) where the shard is larger (the published
    widths: codeqwen1.5-7b's 4 MiB shard against 128 KiB rows)."""
    return _cut(wq, -1, s.m) < s.b * cfg.d_model * _F32


def decode_block(ctx, bp, h: torch.Tensor, cfg) -> None:
    """One dense or moe layer of a decode step (``h`` (B, 1, d), batch-cut
    activations).  Weights kept cut (:func:`_gathers_weights`): the new
    keys and values gathered over the data axes for the cache's scatter,
    ``wo``'s and the MLP's (or the moe's) row-parallel outputs reduced.
    Weights gathered (the residual stream cut on d over the model axis):
    the projections' weights are gathered over the model axis.  With the cache
    cut on KV heads, q, k and v are re-cut to heads (``all-to-all``) and
    the new keys and values gathered over the data axes for the cache's
    scatter; the attention's output is reduced through ``wo`` (no grouped
    heads) or re-cut back and ``wo`` gathered.  With a replicated cache
    the projections' partial sums are reduced.  Each norm reduces its
    sums of squares; the moe's router is gathered and its output
    reduced."""
    s = site(ctx, h.shape[0])
    if s is None or s.m == 1:
        return
    at, m, b, hd = bp["attn"], s.m, s.b, cfg.head_dim
    q_w, kv_w = cfg.n_heads * hd, cfg.n_kv_heads * hd
    if not _gathers_weights(s, at["wq"]["w"], cfg):
        if cfg.n_kv_heads % m == 0 and s.b < s.batch:
            s.rec("all-gather", b * kv_w // m * _F32, 2)
        s.rec("all-reduce", b * cfg.d_model * _F32, 2)
        return
    for name in ("wq", "wk", "wv"):
        s.rec("all-gather", _cut(at[name]["w"], -1, m))
    if cfg.n_kv_heads % m == 0:
        s.rec("all-to-all", b * q_w * _F32)
        s.rec("all-to-all", b * kv_w * _F32, 2)
        if s.b < s.batch:
            s.rec("all-gather", b * kv_w // m * _F32, 2)
            s.rec("all-gather", b * 2 * _I32)
        if cfg.n_heads == cfg.n_kv_heads:
            s.rec("all-reduce", b * cfg.d_model * _F32)
        else:
            s.rec("all-to-all", b * q_w * _F32)
            s.rec("all-gather", _cut(at["wo"]["w"], -2, m))
    else:
        s.rec("all-reduce", b * (q_w + 2 * kv_w) * _F32)
        s.rec("all-gather", _cut(at["wo"]["w"], -2, m))
    s.rec("all-reduce", b * _F32, 2)
    if "mlp" in bp:
        for name, dim in (("gate", -1), ("up", -1), ("down", -2)):
            if name in bp["mlp"]:
                s.rec("all-gather", _cut(bp["mlp"][name]["w"], dim, m))
    else:
        s.rec("all-gather", _cut(bp["moe"]["router"]["w"], -1, m))
        s.rec("all-reduce", b * cfg.d_model * _F32)


def decode_head(ctx, params, token: torch.Tensor, cfg) -> None:
    """A decode step's embedding and head (``token`` (B,)): the
    vocab-cut embedding's partial rows reduced, the cache scatter's
    indices re-laid once a step, and the head.  Weights kept cut
    (:func:`_gathers_weights`): the head's input rows reduced.  Weights
    gathered: the final norm's sums of squares reduced; a tied embedding
    reduces its input, a separate ``lm_head`` is gathered and its logits
    reduced; padded logits are gathered for the pad's mask."""
    s = site(ctx, token.shape[0])
    if s is None or s.m == 1:
        return
    b, d, m = s.b, cfg.d_model, s.m
    s.rec("all-reduce", b * d * _F32)
    if cfg.family == "xlstm":
        return
    wq = (params["blocks"]["attn"]["wq"]["w"])[0]
    gathers = _gathers_weights(s, wq, cfg)
    if cfg.n_kv_heads % m == 0 and s.b < s.batch:
        for kind in ("all-gather", "collective-permute")[not gathers:]:
            s.rec(kind, b * 2 * _I32)
            s.rec(kind, b * _I32)
    if not gathers:
        s.rec("all-reduce", b * d * _F32)
        return
    s.rec("all-reduce", b * _F32)
    emb = params["embed"]["w"]
    if cfg.tie_embeddings:
        s.rec("all-reduce", b * d * _F32)
        v = emb.shape[0]
    else:
        w = params["lm_head"]["w"]
        v = w.shape[-1]
        s.rec("all-gather", _cut(w, -1, m))
        s.rec("all-reduce", b * v * _F32)
    if v != cfg.vocab and v % m == 0:
        s.rec("all-gather", b * v // m * _F32)


def _split(s: Site, unit: int) -> None:
    """A model-cut projection output split at its middle into two halves
    each re-cut over the model axis (the xlstm's ``x | z`` and ``i | f``):
    the two slices' halo hops move ``m - 1 + m / 2`` shards of a half
    (``unit`` bytes each); the backward's pads move ``2 (m - 1)``."""
    s.rec("collective-permute", unit, s.m - 1 + s.m // 2)


def xlstm_block(ctx, p, z: torch.Tensor, cfg, kind: str,
                decode: bool) -> torch.Tensor:
    """One xlstm layer's mixer (``kind`` "m" or "s") on ``z`` (B, S, d),
    activations batch-cut, weights model-cut (the projections' outputs on
    the model axis).  mLSTM: the fused ``up`` output's halves and the
    gates' halves re-cut (:func:`_split`), the inner stream gathered for
    q/k/v, the matrix memory re-cut for its two products (decode), the
    ``down`` product reduced, the pre-norm's sums reduced; in the
    backward the four products' input gradients and the layer's input
    gradient reduced.  sLSTM: each step's hidden state gathered and its
    gate pre-activations re-cut (train), the recurrent weight re-cut each
    step of the backward (and its gradient reduced each step when the
    weight is also cut over data), ``out`` reduced.  Returns ``z``."""
    train = torch.is_grad_enabled() and z.requires_grad
    s = site(ctx, z.shape[0], train)
    if s is None or s.m == 1:
        return z
    b, n, d, m = s.b, z.shape[1], cfg.d_model, s.m
    h, ex = cfg.n_heads, b * n
    if kind == "m":
        d_in = 2 * d
        dk = d_in // h
        _split(s, ex * d_in // m * _F32)
        _split(s, ex * h // m * _F32)
        s.rec("all-gather", ex * d_in // m * _F32,
              2 if decode and m < h else 1)
        s.rec("all-reduce", ex * d * _F32)
        if decode:
            s.rec("all-to-all", b * h * dk * dk * _F32 // m, 2)
        s.rec("all-reduce", ex * _F32, 2 if s.again else 1)
    else:
        wr = p["wr"].numel() * _F32
        if decode:
            s.rec("all-gather", b * h // m * _F32)
            s.rec("all-to-all", wr // m)
        else:
            hd = d // h
            s.rec("all-gather", b * h // m * hd * _F32, n)
            s.rec("all-to-all", b * 4 * d // m * _F32, n)
        if not s.again:
            s.rec("all-reduce", ex * d * _F32)
        s.rec("all-reduce", ex * _F32)
    if not s.train or s.again:
        return z

    def backward():
        s.rec("all-reduce", ex * d * _F32)
        if kind == "m":
            s.rec("all-reduce", 4 * ex * d_in * _F32)
            s.rec("collective-permute", ex * d_in // m * _F32, 2 * (m - 1))
            s.rec("collective-permute", ex * h // m * _F32, 2 * (m - 1))
            s.rec("all-reduce", ex * _F32)
        else:
            s.rec("all-to-all", wr // (m * s.data), n)
            if s.data > 1:
                s.rec("all-reduce", wr // m, n)

    return _on_backward(z, backward)


_STACKS = ("blocks", "enc_blocks", "dec_blocks", "mamba_main",
           "mamba_tail")


def train_params(ctx, params, cfg) -> None:
    """A train step's parameters, laid by ``dist/sharding.py``'s specs
    (tensor-parallel on the model axis, FSDP on the data axes): each cut
    leaf gathered whole, over the model axis (a shard's bytes) and then
    over the data axes (a data shard's), in two passes for the stacked
    layers (their forward, and the backward's recompute) and one for the
    rest; every gradient all-reduced whole, once over the model axis and
    once over the data axes (the CPU partitioner's all-reduce, where a
    GPU's would reduce-scatter).  An expert-parallel table stays cut on
    the model axis: gathered over the data axes only, its gradient
    reduced over them."""
    from .sharding import ShardingRules, param_specs

    s = site(ctx, 1)
    if s is None:
        return
    rules = ShardingRules(ctx.mesh, data_axes=tuple(ctx.data_axes),
                          model_axis=ctx.model_axis, train=True)
    specs = param_specs(params, rules, cfg.expert_mode)
    reduce = (s.m > 1) + (s.data > 1)
    for key in params:
        passes = 2 if key in _STACKS or key.startswith("xl_") else 1
        for leaf, spec in zip(_leaves(params[key]), _leaves(specs[key])):
            whole = leaf.numel() * _F32
            axes = {a for e in spec if e is not None
                    for a in ((e,) if isinstance(e, str) else e)}
            data = s.data if axes & set(ctx.data_axes) else 1
            if _expert_parallel(leaf, spec, cfg, ctx.model_axis):
                # each model shard keeps its own experts (shard_map)
                if data > 1:
                    s.rec("all-gather", whole // (data * s.m), passes)
                    s.rec("all-reduce", whole // s.m)
                continue
            if ctx.model_axis in axes:
                s.rec("all-gather", whole // (data * s.m), passes)
            if data > 1:
                s.rec("all-gather", whole // data, passes)
            s.rec("all-reduce", whole, reduce)


def _expert_parallel(leaf, spec, cfg, model_axis: str) -> bool:
    """An expert table cut on its expert dim over the model axis."""
    return cfg.expert_mode == "ep" and leaf.dim() >= 3 \
        and spec[leaf.dim() - 3] == model_axis


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]
