"""Online GNN serving for the port (static engine of the first slice).

* :mod:`repro_torch.serve.gnn` — ``GNNServeEngine``, ``run_trace``;
* :mod:`repro_torch.serve.stats` — ``WorkloadStats`` (copy);
* :mod:`repro_torch.serve.hotcache` — ``HotNodeCache`` (copy; the table is
  a device tensor);
* :mod:`repro_torch.serve.traffic` — ``ZipfTraffic`` (copy).
"""
from .gnn import GNNServeEngine, ServeResult, run_trace
from .hotcache import HotNodeCache
from .stats import TrafficSnapshot, WorkloadStats
from .traffic import TrafficEvent, TrafficPhase, ZipfTraffic

__all__ = [
    "GNNServeEngine", "ServeResult", "run_trace",
    "HotNodeCache", "TrafficSnapshot", "WorkloadStats",
    "TrafficEvent", "TrafficPhase", "ZipfTraffic",
]
