"""Graph training data (copy of ``repro/train/data.py::graph_features``;
numpy only, so both packages draw the same arrays from one seed).  The
LM batches wait for the LM slice."""
from __future__ import annotations

import numpy as np

__all__ = ["graph_features"]


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
