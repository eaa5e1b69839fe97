"""Training substrate for the port (counterpart of ``repro/train``):
pytrees of tensors and their gradients (:mod:`.tree`), AdamW with the
reference's exact update rule (:mod:`.optimizer`), checkpoints in the
reference's on-disk layout and their asynchronous manager
(:mod:`.checkpoint`), the LM step factory and fault-tolerant driver
(:mod:`.trainer`), and the LM and graph data (:mod:`.data`)."""
from . import checkpoint
from .data import LMDataConfig, graph_features, lm_batch, lm_stream
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        cosine_schedule, global_norm, linear_warmup)
from .trainer import Trainer, TrainState, make_loss_fn, make_train_step
from .tree import tree_leaves, tree_map, value_and_grad

__all__ = ["checkpoint", "LMDataConfig", "graph_features", "lm_batch",
           "lm_stream", "AdamWConfig", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "linear_warmup", "Trainer",
           "TrainState", "make_loss_fn", "make_train_step", "tree_leaves",
           "tree_map", "value_and_grad"]
