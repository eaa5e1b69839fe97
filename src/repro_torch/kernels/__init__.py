"""Hand-written CUDA kernels for the MGG hot spots, with plain versions:

* neighbor_agg — wrappers (launch counts, checks) around csrc/gather_sum.cu:
  K1 pipelined gather-sum, K2 partition-blocked gather-sum, K3 ordered
  segment add, K4 ordered scatter-sum (the gather-sum's backward);
* rows — the wrapper around csrc/rows.cu: K5 row gather;
* ref — the plain PyTorch versions the CPU path and the tests run;
* ops — the front door that picks one by the tensor's device, and the
  gather-sum's ``autograd.Function``.
"""
from . import neighbor_agg, ops, ref, rows
from .ops import (GradIndex, gather_rows, neighbor_gather_sum,
                  scatter_sum_ordered, segment_add_ordered)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    neighbor_agg.reset_launch_counts()
    rows.reset_launch_counts()


def launch_counts() -> dict:
    """Launches per kernel (K1–K5) since the last reset."""
    return {**neighbor_agg.launch_counts(), **rows.launch_counts()}
