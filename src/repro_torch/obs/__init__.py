"""Tracing and metrics for the port (copies of the reference's leaf
modules ``repro/obs/tracer.py``, ``repro/obs/metrics.py`` and
``repro/obs/validate.py``).

``calibrate`` fits the analytical latency model and probes the device, so
it imports ``repro_torch.core.autotune``: it is loaded lazily (``import
repro_torch.obs.calibrate``, or the package's ``calibrate`` attribute) and
``from repro_torch.obs import Tracer`` stays dependency-free."""
from .tracer import NULL_TRACER, Tracer, merge_traces
from .metrics import MetricsRegistry

__all__ = ["Tracer", "NULL_TRACER", "MetricsRegistry", "merge_traces",
           "calibrate"]


def __getattr__(name):
    if name == "calibrate":  # lazy: pulls in repro_torch.core.autotune
        import importlib
        return importlib.import_module(".calibrate", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
