"""Hand-written CUDA kernels for the MGG hot spot, with plain versions:

* neighbor_agg — wrappers (launch counts, checks) around csrc/gather_sum.cu:
  K1 pipelined gather-sum, K2 partition-blocked gather-sum, K3 ordered
  segment add;
* ref — the plain PyTorch versions the CPU path and the tests run;
* ops — the front door that picks one by the tensor's device.
"""
from . import neighbor_agg, ops, ref
from .ops import neighbor_gather_sum, segment_add_ordered
