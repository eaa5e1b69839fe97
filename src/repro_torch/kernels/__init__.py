"""Hand-written CUDA kernels for the MGG hot spots, with plain versions:

* neighbor_agg — wrappers (launch counts, checks) around csrc/gather_sum.cu:
  K1 pipelined gather-sum, K2 partition-blocked gather-sum, K3 ordered
  segment add, K4 ordered scatter-sum (the gather-sum's backward), and
  around csrc/sparse_gather_sum.cu: K6 the top-k compressed gather-sum;
* rows — the wrapper around csrc/rows.cu: K5 row gather;
* flash_attention — the wrapper around csrc/flash_attention.cu: K7
  flash attention (forward, GQA, causal and sliding-window);
* slstm_scan — the wrappers around csrc/slstm_scan.cu: K8 the sLSTM
  recurrence over a sequence (forward, with an optional save) and K9 its
  backward;
* ref — the plain PyTorch versions the CPU path and the tests run;
* ops — the front door that picks one by the tensor's device, and the
  gather-sums' autograd Functions;
* cost — each kernel's work a launch (flops, bytes), which its bound and
  the dry-run counters read; meta — the kernels' stand-ins on meta
  tensors, for a dry run.
"""
from . import (cost, flash_attention, meta, neighbor_agg, ops, ref, rows,
               slstm_scan)
from .ops import (GradIndex, gather_rows, neighbor_gather_sum,
                  scatter_sum_ordered, segment_add_ordered,
                  sparse_neighbor_gather_sum)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    neighbor_agg.reset_launch_counts()
    rows.reset_launch_counts()
    flash_attention.reset_launch_counts()
    slstm_scan.reset_launch_counts()


def launch_counts() -> dict:
    """Launches per kernel (K1–K9) since the last reset."""
    return {**neighbor_agg.launch_counts(), **rows.launch_counts(),
            **flash_attention.launch_counts(), **slstm_scan.launch_counts()}
