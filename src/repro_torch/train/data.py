"""Training data (copies of ``repro/train/data.py``'s ``LMDataConfig``,
``lm_batch``, ``lm_stream`` and ``graph_features``; numpy only, so both
packages draw the same arrays from one seed).

LM batches are a pure function of ``(seed, step)``: a Zipfian unigram
draw with short-range Markov structure, plus packed-document loss masks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["LMDataConfig", "lm_batch", "lm_stream", "graph_features"]


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    doc_len: int = 1024          # documents packed per row
    markov: float = 0.7          # P(next token near current)


def lm_batch(cfg: LMDataConfig, step: int,
             n_vis: int = 0, d_model: int = 0) -> Dict[str, np.ndarray]:
    """Batch for ``step`` (whole global batch; shard by slicing dim 0)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xD1CE]))
    b, s = cfg.global_batch, cfg.seq_len
    base = rng.zipf(1.3, size=(b, s)).astype(np.int64) % cfg.vocab
    # short-range structure: with prob markov, copy-shift the previous token
    keep = rng.random((b, s)) < cfg.markov
    shifted = np.roll(base, 1, axis=1)
    tokens = np.where(keep, (shifted + 1) % cfg.vocab, base)
    # packed documents: mask loss across document boundaries
    boundaries = (np.arange(s)[None, :] % cfg.doc_len) == 0
    loss_mask = np.broadcast_to(~boundaries, (b, s)).astype(np.float32).copy()
    out = dict(tokens=tokens.astype(np.int32), loss_mask=loss_mask)
    if n_vis:
        out["vis"] = rng.normal(size=(b, n_vis, d_model)).astype(np.float32)
    return out


def lm_stream(cfg: LMDataConfig, start_step: int = 0, **kw
              ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield lm_batch(cfg, step, **kw)
        step += 1


def graph_features(num_nodes: int, dim: int, num_classes: int,
                   seed: int = 0):
    """Node features + labels with class-dependent means (learnable)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes)
    centers = rng.normal(size=(num_classes, dim)).astype(np.float32)
    x = centers[labels] + 0.5 * rng.normal(size=(num_nodes, dim)).astype(
        np.float32)
    train_mask = rng.random(num_nodes) < 0.6
    return x, labels.astype(np.int32), train_mask
