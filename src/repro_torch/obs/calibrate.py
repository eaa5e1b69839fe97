"""Measured-vs-model calibration for the §4 analytical latency model
(counterpart of ``repro/obs/calibrate.py``).

* **Micro-probes** (:func:`probe_hardware`) measure what a spec claims —
  fp32 matmul FLOP/s, host→device bandwidth, the ring's per-tile
  bandwidth — on the live device, each probe best-effort (``None`` when
  it fails, or for the link of a ring of one shard).
* **Audit-trail fitting** (:func:`fit_spec`) takes the tuner's measured
  ``(config, latency)`` probes and fits per-parameter scale factors on a
  base spec by coordinate descent over a log-spaced grid, minimizing mean
  relative model error.  The identity scale is always in the grid, so
  the calibrated error is never worse than the base spec's.
* **Model-error reporting** (:func:`model_errors`): per-config
  |model − measured| / measured, which the runtime engine feeds into the
  ``tuner.model_error`` histogram of its metrics registry.

The fit's objective is whatever latency the tuner measured (a full
training step or a served micro-batch, not aggregation alone), so the
fitted scales absorb both hardware-constant error and the work the
analytical model does not express.

The model half is a copy of the reference's (numpy and stdlib only;
tests/test_torch_tuner.py holds it to the reference); the probes are
torch.  Unlike the rest of ``repro_torch.obs`` this submodule depends on
``repro_torch.core.autotune``, so the package imports it lazily.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.calibrate [--base h100_sxm] \
        [--json] [--device cpu] [--devices 8]
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core.autotune import (HardwareSpec, TPU_V5E, WorkloadShape,
                             estimate_latency, estimate_pipeline_latency)

__all__ = [
    "CalibrationResult",
    "fit_spec",
    "model_latency",
    "model_errors",
    "observations_from_audit",
    "probe_hardware",
    "spec_from_probes",
    "FIT_PARAMS",
]

# the HardwareSpec fields the fit may scale (vmem_bytes is a feasibility
# constraint, not a latency term — never fitted)
FIT_PARAMS = ("peak_flops", "hbm_bw", "link_bw", "host_bw")

# log2-spaced scale grid: half-notch resolution over 256× in each
# direction, with the identity scale included so the fit can only improve
_DEFAULT_GRID = tuple(2.0 ** (0.5 * k) for k in range(-16, 17))

Config = Union[Dict, List[Dict]]
Shapes = Union[WorkloadShape, Sequence[WorkloadShape]]


def model_latency(shapes: Shapes, config: Config,
                  hw: HardwareSpec, interleave: bool = True) -> float:
    """The analytical estimate for one tuner proposal.

    ``config`` is whatever the tuner probed: a global ``{ps, dist, pb}``
    dict (optionally with ``fuse``), a ``{"layers": [...]}`` wrapper, or
    a bare per-layer list — per-layer forms need ``shapes`` to be the
    matching per-layer list (see
    :func:`repro.core.autotune.layer_workload_shapes`).
    """
    if isinstance(config, dict) and "layers" in config:
        config = config["layers"]
    if isinstance(config, list):
        shapes = list(shapes) if not isinstance(shapes, WorkloadShape) \
            else [shapes] * len(config)
        if len(shapes) != len(config):
            raise ValueError("one shape per layer config required")
        return estimate_pipeline_latency(shapes, config, hw=hw,
                                         interleave=interleave)
    shape = shapes[0] if not isinstance(shapes, WorkloadShape) else shapes
    return estimate_latency(shape, int(config["ps"]), int(config["dist"]),
                            int(config["pb"]), hw=hw, interleave=interleave,
                            fuse=bool(config.get("fuse", False)))


def observations_from_audit(audit: Sequence[dict]) \
        -> List[Tuple[Config, float]]:
    """Extract the fit's ``(config, measured latency)`` pairs from a
    tuner audit trail (``probe`` events with finite positive latency)."""
    out: List[Tuple[Config, float]] = []
    for ev in audit:
        if ev.get("event") != "probe":
            continue
        lat = ev.get("latency")
        cfg = ev.get("config") or ev.get("configs")
        if cfg is None or lat is None:
            continue
        lat = float(lat)
        if math.isfinite(lat) and lat > 0.0:
            out.append((cfg, lat))
    return out


def model_errors(shapes: Shapes, observations: Sequence[Tuple[Config, float]],
                 hw: HardwareSpec, interleave: bool = True) -> List[float]:
    """Per-observation relative model error |model − measured|/measured."""
    errs = []
    for cfg, measured in observations:
        model = model_latency(shapes, cfg, hw, interleave=interleave)
        errs.append(abs(model - measured) / measured)
    return errs


def _mean_error(shapes, observations, hw, interleave) -> float:
    errs = model_errors(shapes, observations, hw, interleave=interleave)
    return sum(errs) / len(errs) if errs else math.inf


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Outcome of :func:`fit_spec`."""

    spec: HardwareSpec            # the calibrated spec
    base: HardwareSpec            # what it was fitted from
    scales: Dict[str, float]      # per-parameter multipliers applied
    base_error: float             # mean relative error of `base`
    error: float                  # mean relative error of `spec` (≤ base)
    n_observations: int

    @property
    def improved(self) -> bool:
        return self.error < self.base_error

    def summary(self) -> str:
        sc = ", ".join(f"{k}×{v:.3g}" for k, v in self.scales.items()
                       if v != 1.0) or "identity"
        return (f"calibrated {self.base.name}: model error "
                f"{self.base_error:.1%} → {self.error:.1%} over "
                f"{self.n_observations} measured configs ({sc})")


def fit_spec(
    shapes: Shapes,
    observations: Sequence[Tuple[Config, float]],
    base: HardwareSpec = TPU_V5E,
    *,
    params: Sequence[str] = FIT_PARAMS,
    grid: Sequence[float] = _DEFAULT_GRID,
    rounds: int = 2,
    interleave: bool = True,
) -> Optional[CalibrationResult]:
    """Fit per-parameter scale factors on ``base`` to the measurements.

    Coordinate descent: for each parameter in turn, sweep the scale grid
    holding the others fixed, keep the best; repeat ``rounds`` times.
    Deterministic, derivative-free, and monotone — the identity scale is
    in the grid, so the result's error is ≤ the base spec's.  Returns
    ``None`` when there are no usable observations.
    """
    obs = [(c, l) for c, l in observations
           if math.isfinite(l) and l > 0.0]
    if not obs:
        return None

    def spec_for(scales: Dict[str, float]) -> HardwareSpec:
        return base.scaled(**scales)

    scales = {p: 1.0 for p in params}
    base_err = _mean_error(shapes, obs, base, interleave)
    best_err = base_err
    for _ in range(max(1, rounds)):
        moved = False
        for p in params:
            for s in grid:
                if s == scales[p]:
                    continue
                trial = dict(scales, **{p: s})
                err = _mean_error(shapes, obs, spec_for(trial), interleave)
                if err < best_err:
                    best_err, scales, moved = err, trial, True
        if not moved:
            break
    return CalibrationResult(spec=spec_for(scales), base=base, scales=scales,
                             base_error=base_err, error=best_err,
                             n_observations=len(obs))


# ---------------------------------------------------------------------------
# micro-probes: measure what a HardwareSpec claims, on the live device
# ---------------------------------------------------------------------------

def _time_best(fn, warmup: int = 2, iters: int = 5) -> float:
    """Best-of-N wall time of a blocking callable (probes want the
    contention-free floor, not the median — bandwidth is a capacity).
    On the card each probe's ``fn`` ends in ``torch.cuda.synchronize``,
    so its time is the device's."""
    import time

    for _ in range(warmup):
        fn()
    best = math.inf
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _blocking(device, fn):
    """``fn`` followed by a synchronize on the card."""
    import torch

    if device.type != "cuda":
        return fn

    def run():
        fn()
        torch.cuda.synchronize(device)
    return run


def probe_matmul_flops(n: Optional[int] = None,
                       device="cuda") -> float:
    """Measured dense-matmul FLOP/s on one device: ``a @ a`` in fp32 with
    TF32 off (the port's GNN matmuls' precision; ``H100_SXM.peak_flops``
    is the fp32 rate outside the tensor cores).  ``n`` defaults to 4096
    on the card (2n³ = 137 GFLOP, milliseconds, well past a launch) and
    512 on the CPU."""
    import torch

    from ..dist.ring import resolve_device

    dev = resolve_device(device)
    n = int(n) if n is not None else (4096 if dev.type == "cuda" else 512)
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = _time_best(_blocking(dev, lambda: a @ a))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2.0 * n ** 3 / max(t, 1e-12)


def probe_host_bw(nbytes: int = 32 << 20, device="cuda") -> float:
    """Measured host→device transfer bandwidth (bytes/s) of a pageable
    numpy array, as the reference's ``device_put`` — the tiered feature
    path's cold-row link (the port's store uploads from pinned memory,
    which is faster)."""
    import numpy as np
    import torch

    from ..dist.ring import resolve_device

    dev = resolve_device(device)
    rows = max(1, nbytes // 1024)
    arr = np.zeros((rows, 256), np.float32)
    t = _time_best(_blocking(dev, lambda: torch.from_numpy(arr).to(
        dev, copy=True)), warmup=1)
    return arr.nbytes / max(t, 1e-12)


def probe_link_bw(ring=None, rows: int = 2048,
                  d: int = 256) -> Optional[float]:
    """Measured per-step ring bandwidth in bytes/s: one
    :meth:`VirtualRing.rotate` of the stacked ``(n_dev, rows, d)`` fp32
    tiles, one tile's bytes over its time (every shard moves its tile at
    once, as the reference's ppermute).  None without a ring of at least
    two shards.  On one card the rotation is an HBM copy, the virtual
    ring's stand-in for the wire, so this measures the card's memory, not
    NVLink."""
    import torch

    if ring is None or ring.n_dev < 2:
        return None
    x = torch.ones((ring.n_dev, rows, d), dtype=torch.float32,
                   device=ring.device)
    dst = torch.empty_like(x)
    t = _time_best(_blocking(ring.device,
                             lambda: ring.wait(ring.rotate(x, dst))))
    return rows * d * 4 / max(t, 1e-12)


def probe_hardware(ring=None, device="cuda") -> Dict[str, Optional[float]]:
    """All micro-probes on ``ring``'s device (else ``device``), each
    best-effort (None on failure)."""
    dev = ring.device if ring is not None else device
    out: Dict[str, Optional[float]] = {}
    for key, probe in (("peak_flops", probe_matmul_flops),
                       ("host_bw", probe_host_bw)):
        try:
            out[key] = float(probe(device=dev))
        except Exception:
            out[key] = None
    try:
        out["link_bw"] = probe_link_bw(ring)
    except Exception:
        out["link_bw"] = None
    return out


def spec_from_probes(base: HardwareSpec = TPU_V5E,
                     probes: Optional[Dict[str, Optional[float]]] = None,
                     ring=None, device="cuda") -> HardwareSpec:
    """A copy of ``base`` with every successfully probed field measured."""
    if probes is None:
        probes = probe_hardware(ring, device)
    changed = {k: v for k, v in probes.items()
               if v is not None and hasattr(base, k)}
    if not changed:
        return base
    return dataclasses.replace(base, name=base.name + "+probed", **changed)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json as _json

    from ..core.autotune import A100_NVSWITCH, H100_SXM
    from ..dist import VirtualRing

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.calibrate",
        description="micro-probe this machine and print a measured "
                    "HardwareSpec")
    ap.add_argument("--base", default="tpu_v5e",
                    choices=["tpu_v5e", "a100_nvswitch", "h100_sxm"])
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual shards of the ring the link probe "
                         "rotates")
    args = ap.parse_args(argv)
    base = {"tpu_v5e": TPU_V5E, "a100_nvswitch": A100_NVSWITCH,
            "h100_sxm": H100_SXM}[args.base]
    probes = probe_hardware(VirtualRing(args.devices, args.device))
    spec = spec_from_probes(base, probes)
    if args.json:
        print(_json.dumps({"probes": probes,
                           "spec": dataclasses.asdict(spec)}, indent=2))
    else:
        for k, v in probes.items():
            print(f"probe {k}: "
                  + (f"{v:.3e}" if v is not None else "unavailable"))
        print(f"spec: {spec}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
