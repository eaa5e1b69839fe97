"""Host-side fanout-bounded neighbor sampling (fixed-shape blocks); see
:mod:`repro_torch.sample.blocks` for the block format and padding
contract."""
from .blocks import (Block, block_tree, sample_blocks, sampled_khop_frontier,
                     seed_batches)

__all__ = [
    "Block",
    "sample_blocks",
    "block_tree",
    "seed_batches",
    "sampled_khop_frontier",
]
