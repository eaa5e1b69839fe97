"""Measured-vs-model calibration for the §4 analytical latency model: the
model half of ``repro/obs/calibrate.py`` (numpy and stdlib only).

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

The micro-probes of the reference (matmul rate, host and ring-link
bandwidth measured on the live backend) are ROADMAP item 8: here they
raise ``NotImplementedError``.  tests/test_torch_tuner.py holds this
module to the reference.
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
# micro-probes: ROADMAP item 8 (the reference's run on JAX)
# ---------------------------------------------------------------------------

def _probes_later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} arrives with the observability slice of the port "
        f"(ROADMAP item 8)")


def probe_hardware(ring=None) -> Dict[str, Optional[float]]:
    """The reference's micro-probes (matmul rate, host and link
    bandwidth): not ported yet."""
    raise _probes_later("probing the hardware")


def spec_from_probes(base: HardwareSpec = TPU_V5E,
                     probes: Optional[Dict[str, Optional[float]]] = None,
                     ring=None) -> HardwareSpec:
    """A spec from :func:`probe_hardware`'s measurements: not ported yet."""
    raise _probes_later("a spec from probes")
