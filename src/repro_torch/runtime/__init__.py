"""repro_torch.runtime — the paper's intelligent runtime (§4): online
cross-iteration re-optimization of the aggregation pipeline during
training and serving (counterpart of ``repro/runtime``).

* :mod:`.profiler` — per-iteration latency windows, a device timer and
  the analytical-model fallback (``ProfileConfig``, ``LatencyWindow``,
  ``time_device``, ``AggregateProfiler``);
* :mod:`.tuner` — the online ps → dist → pb coordinate descent with
  retreat, stop-at-top-3, warm start, budget and drift re-exploration
  (``OnlineTuner``), its layer-wise lift (``PerLayerTuner``) and the
  feasibility rules (``make_vmem_check``, ``make_smem_check``);
* :mod:`.cache` — the persistent JSON config cache keyed by workload
  shape + hardware fingerprint (``ConfigCache``);
* :mod:`.engine` — ``DynamicGNNEngine``: a GNNEngine that rebuilds its
  plans when the tuner moves, without touching model parameters.
"""
from .cache import (ConfigCache, hardware_fingerprint, layers_fingerprint,
                    shape_fingerprint)
from .engine import DynamicGNNEngine
from .profiler import (AggregateProfiler, LatencyWindow, ProfileConfig,
                       time_device)
from .tuner import (OnlineTuner, PerLayerTuner, make_smem_check,
                    make_vmem_check, shape_drift)

__all__ = [
    "ProfileConfig", "LatencyWindow", "time_device", "AggregateProfiler",
    "OnlineTuner", "PerLayerTuner", "make_vmem_check", "make_smem_check",
    "shape_drift", "ConfigCache", "hardware_fingerprint",
    "shape_fingerprint", "layers_fingerprint", "DynamicGNNEngine",
]
