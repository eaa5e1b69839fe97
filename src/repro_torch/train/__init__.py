"""Training substrate for the port (counterpart of ``repro/train``):
pytrees of tensors and their gradients (:mod:`.tree`), AdamW with the
reference's exact update rule (:mod:`.optimizer`), checkpoints in the
reference's on-disk layout (:mod:`.checkpoint`) and the graph data
(:mod:`.data`).  The LM trainer and its data wait for the LM slice."""
from .data import graph_features
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        cosine_schedule, global_norm, linear_warmup)
from .tree import tree_leaves, tree_map, value_and_grad

__all__ = ["graph_features", "AdamWConfig", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "linear_warmup", "tree_leaves",
           "tree_map", "value_and_grad"]
