"""Distribution for the port (counterpart of ``repro/dist``), all on one
card: a virtual ring of shards (``ring.py``, the MGG aggregation ring) and
a virtual device mesh (``mesh.py``), with

* ``collectives`` — ring-pipelined collectives that overlap each step's
  transfer with the previous step's compute (``ring_allgather_matmul``,
  ``matmul_reducescatter``, ``pipelined_all_to_all``);
* ``compress`` — the error-feedback compressed gradient all-reduce
  (``ef_state_init``, ``ef_allreduce_mean``);
* ``sharding`` — divisibility-respecting specs for every config in
  ``configs.ARCH_IDS`` (``ShardingRules``, ``param_specs``,
  ``batch_specs``, ``cache_specs``, ``to_shardings``).
"""
from . import sharding
from .collectives import (matmul_reducescatter, pipelined_all_to_all,
                          ring_allgather_matmul)
from .compress import ef_allreduce_mean, ef_state_init, quantize_dequantize
from .mesh import VirtualMesh, flat_ring_mesh, make_mesh, ring_order
from .ring import VirtualRing, resolve_device
from .sharding import (P, ShardingRules, batch_specs, cache_specs,
                       param_specs, to_shardings)

__all__ = [
    "VirtualRing", "resolve_device", "VirtualMesh",
    "make_mesh", "flat_ring_mesh", "ring_order",
    "ring_allgather_matmul", "matmul_reducescatter", "pipelined_all_to_all",
    "ef_state_init", "ef_allreduce_mean", "quantize_dequantize",
    "sharding", "P", "ShardingRules", "param_specs", "batch_specs",
    "cache_specs", "to_shardings",
]
