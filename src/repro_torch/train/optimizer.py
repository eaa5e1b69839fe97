"""AdamW + schedules with the reference's exact update rule
(``repro/train/optimizer.py``), over pytrees of tensors.

Global-norm clipping, bias correction by ``1 - β^t`` with ``t`` the step
count, decay on matrices only (``ndim ≥ 2``), fp32 math and the cosine
schedule by default — not ``torch.optim.AdamW``, whose decay and
schedule differ.  The state mirrors the parameter tree (``m``, ``v`` per
leaf in fp32) plus an int32 ``count``, as the reference's does, so a
checkpoint of it reads the same in both packages.  Callers run it with
TF32 off on the card (the engine sets it), so every product is fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from .tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "linear_warmup"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params: Any) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return dict(m=tree_map(zeros, params), v=tree_map(zeros, params),
                count=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                   torch.Tensor]:
    def lr(step):
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
        return cfg.lr * warm * scale
    return lr


def linear_warmup(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                 torch.Tensor]:
    def lr(step):
        return cfg.lr * torch.clamp(
            (step.to(torch.float32) + 1) / max(1, cfg.warmup_steps), max=1.0)
    return lr


@torch.no_grad()
def adamw_update(
    grads: Any, state: dict, params: Any, cfg: AdamWConfig,
    schedule: Optional[Callable] = None,
) -> Tuple[Any, dict, dict]:
    """One AdamW step with global-norm clipping.  Returns ``(params',
    state', metrics)``: new tensors, the inputs untouched; fp32 math,
    params cast back to their stored dtype."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.clip_norm > 0 else 1.0
    lr = (schedule or cosine_schedule(cfg))(count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)

    def upd(g, m, v, p):
        gf = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mh = m / b1c
        vh = v / b2c
        step = mh / (torch.sqrt(vh) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (standard practice)
            step = step + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), m, v

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
        tree_leaves(params))]
    pick = lambda i: tree_unflatten(params, [o[i] for o in out])
    return pick(0), dict(m=pick(1), v=pick(2), count=count), dict(
        grad_norm=gnorm, lr=lr)
