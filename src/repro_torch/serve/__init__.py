"""Serving for the port: LM token decoding and online GNN inference.

* :mod:`repro_torch.serve.engine` — continuous-batching LM generation
  (``ServeEngine``);
* :mod:`repro_torch.serve.gnn` — ``GNNServeEngine``, ``run_trace``;
* :mod:`repro_torch.serve.cluster` — ``ServeCluster``: replicas behind a
  router with staggered retunes and a shared config cache;
* :mod:`repro_torch.serve.router` — ``LeastLoadRouter``,
  ``LocalityRouter``, ``make_router`` (copy);
* :mod:`repro_torch.serve.stats` — ``WorkloadStats`` (copy);
* :mod:`repro_torch.serve.hotcache` — ``HotNodeCache`` (copy; the table is
  a device tensor);
* :mod:`repro_torch.serve.traffic` — ``ZipfTraffic`` (copy).
"""
from .engine import GenerationResult, ServeEngine
from .gnn import GNNServeEngine, ServeResult, run_trace
from .cluster import ServeCluster
from .hotcache import HotNodeCache
from .router import LeastLoadRouter, LocalityRouter, Router, make_router
from .stats import TrafficSnapshot, WorkloadStats
from .traffic import TrafficEvent, TrafficPhase, ZipfTraffic

__all__ = [
    "ServeEngine", "GenerationResult",
    "GNNServeEngine", "ServeResult", "run_trace",
    "ServeCluster", "Router", "LeastLoadRouter", "LocalityRouter",
    "make_router",
    "HotNodeCache", "TrafficSnapshot", "WorkloadStats",
    "TrafficEvent", "TrafficPhase", "ZipfTraffic",
]
