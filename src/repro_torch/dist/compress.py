"""Error-feedback compressed gradient all-reduce (counterpart of
``repro/dist/compress.py``).

Data-parallel training reduces gradients every step; at MGG's scale the
reduce competes with the aggregation ring for the interconnect, so the
gradient travels quantized to ``bits``-bit integers.  Plain quantization
biases the update; error feedback carries each step's quantization
residual into the next step's gradient, so the error telescopes:

    sum_t C(g_t + e_{t-1}) = sum_t g_t + e_0 - e_T

State is one fp32 residual a gradient leaf (:func:`ef_state_init`), held
beside the optimizer state.  The mean over the data axes is the
reference's ``pmean``: each leaf is cut into its mesh blocks
(``dist/sharding.py``), the blocks are summed over the shards of those
axes in order, then divided by their count; the counters of
``kernels/cost.py`` record it as one all-reduce of every shard's block.
"""
from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import torch

from ..kernels import cost
from ..train.tree import tree_map
from .sharding import MeshSharding

__all__ = ["ef_state_init", "ef_allreduce_mean", "quantize_dequantize"]


def ef_state_init(grads: Any) -> Any:
    """Zero residual carry, one fp32 leaf per gradient leaf."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def quantize_dequantize(v: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric per-tensor fake-quantization (the wire format simulated):
    scale ``max|v| / (2^(bits-1) - 1)`` in ``v``'s dtype (1 where it is
    0), round half to even (``torch.round``, as ``jnp.round``).  The
    division by the constant is a product by its reciprocal in ``v``'s
    dtype, which is what XLA compiles the reference's division to: the
    scale, and so every quantized value, is the reference's bit for bit."""
    levels = float(2 ** (bits - 1) - 1)
    scale = v.abs().max() * (1.0 / levels)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(v / scale) * scale


def _pmean(v: torch.Tensor, mesh, axes: Tuple[str, ...], spec):
    """``lax.pmean(v, axes)`` of a leaf laid on ``mesh`` by ``spec``."""
    sh = MeshSharding(mesh, spec)
    blocks = sh.cut(v)
    cost.record_transfer("all-reduce", lambda: [blocks], False)
    dims = [mesh.axis(a) for a in axes]
    count = math.prod(mesh.shape[a] for a in axes)
    flat = blocks.movedim(dims, list(range(len(dims)))).flatten(
        0, len(dims) - 1) if dims else blocks.unsqueeze(0)
    acc = flat[0]
    for i in range(1, count):
        acc = acc + flat[i]
    mean = acc / count
    for d in sorted(dims):
        mean = mean.unsqueeze(d)
    return sh.join(mean.expand(blocks.shape))


def ef_allreduce_mean(
    grads: Any,
    err: Any,
    mesh,
    axes: Sequence[str],
    specs: Any,
    *,
    bits: int = 8,
) -> Tuple[Any, Any]:
    """Mean-allreduce ``grads`` over mesh ``axes`` with int-``bits``
    compression and error feedback.

    ``specs``: a tree of specs matching ``grads`` (how each leaf lives on
    ``mesh``).  Returns ``(mean, new_err)``; feed ``new_err`` back in on
    the next step.
    """
    axes = tuple(axes)
    errs = {}

    def one(g, e, spec):
        # a leaf at a time: only one leaf's temporaries are alive at once
        compensated = g.float() + e
        quantized = quantize_dequantize(compensated, bits=bits)
        errs[id(g)] = compensated - quantized
        return _pmean(quantized, mesh, axes, spec)

    mean = tree_map(one, grads, err, specs)
    return mean, tree_map(lambda g: errs[id(g)], grads)
