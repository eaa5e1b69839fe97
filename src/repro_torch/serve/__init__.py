"""Serving for the port: LM token decoding and online GNN inference.

* :mod:`repro_torch.serve.engine` — continuous-batching LM generation
  (``ServeEngine``);
* :mod:`repro_torch.serve.gnn` — ``GNNServeEngine``, ``run_trace`` (the
  static engine);
* :mod:`repro_torch.serve.stats` — ``WorkloadStats`` (copy);
* :mod:`repro_torch.serve.hotcache` — ``HotNodeCache`` (copy; the table is
  a device tensor);
* :mod:`repro_torch.serve.traffic` — ``ZipfTraffic`` (copy).
"""
from .engine import GenerationResult, ServeEngine
from .gnn import GNNServeEngine, ServeResult, run_trace
from .hotcache import HotNodeCache
from .stats import TrafficSnapshot, WorkloadStats
from .traffic import TrafficEvent, TrafficPhase, ZipfTraffic

__all__ = [
    "ServeEngine", "GenerationResult",
    "GNNServeEngine", "ServeResult", "run_trace",
    "HotNodeCache", "TrafficSnapshot", "WorkloadStats",
    "TrafficEvent", "TrafficPhase", "ZipfTraffic",
]
