"""Analytical modeling and cross-iteration design optimization (paper §4).

(Framework-free copy of ``repro/core/autotune.py``: the port may not import
the JAX package.  tests/test_torch_tuner.py holds the two copies equal.  The
copy adds :data:`H100_SXM`, the card the port runs on.)

The paper models two resources —

    WPW  = 2 · ps · D · dist                  (work per warp)
    SMEM = ps · wpb · IntS + 2 · wpb · D · FloatS   (shared mem per block)

— and runs a greedy coordinate-descent search (``ps → dist → wpb``, with a
"retreat" rule on ``ps`` and a stop-at-top-3 criterion), converging in ~10
measurements (paper Fig. 10, up to 68% latency reduction vs. the initial
configuration).

TPU re-targeting (DESIGN.md §2):

* ``ps``   — unchanged: neighbor-partition size (layout-time knob).
* ``dist`` — ring tiles per shard: pipeline granularity (init-time knob).
* ``wpb``  — Pallas partition-block height ``pb``: how many neighbor
  partitions one kernel grid cell processes (runtime mapping knob).
* ``SMEM ≤ 164 KB/SM`` becomes ``VMEM ≤ ~16 MB/core``: the ring double
  buffer (2 tiles) plus the kernel block working set must fit VMEM.

The latency model combines the three roofline terms of the ring schedule so
the same machinery drives both the autotuner and the §Roofline analysis in
EXPERIMENTS.md.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .graph import CSRGraph
from .partition import edge_balanced_node_split, locality_edge_split

__all__ = [
    "HardwareSpec",
    "TPU_V5E",
    "A100_NVSWITCH",
    "H100_SXM",
    "FUSE_RING_EFF",
    "estimate_latency",
    "estimate_pipeline_latency",
    "layer_workload_shapes",
    "vmem_bytes",
    "cross_iteration_optimize",
    "SearchResult",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip hardware constants for the analytical model.

    The shipped constants (:data:`TPU_V5E`, :data:`A100_NVSWITCH`) are
    datasheet numbers; :mod:`repro.obs.calibrate` can replace them with
    values *measured* on the live machine — either micro-probed directly
    (``spec_from_probes``) or fitted to the tuner's audit-trail latencies
    (``fit_spec``), via :meth:`scaled`.
    """

    name: str
    peak_flops: float        # FLOP/s (bf16 for TPU)
    hbm_bw: float            # bytes/s
    link_bw: float           # bytes/s per ICI link / NVLink direction
    vmem_bytes: int          # VMEM (TPU) or SMEM-per-SM * SMs (GPU)
    cores: int = 1
    host_bw: float = 32e9    # host→device bytes/s (PCIe gen4 ×16 class);
    #                          the tiered feature path's cold-row gathers
    #                          stream over this link

    def scaled(self, suffix: str = "+calibrated",
               **scales: float) -> "HardwareSpec":
        """A copy with named float fields multiplied by the given scales
        (identity scales elide the copy), e.g. ``hw.scaled(link_bw=0.5)``
        for a machine whose ring moves half the datasheet bytes/s."""
        changed = {k: getattr(self, k) * float(v)
                   for k, v in scales.items() if float(v) != 1.0}
        if not changed:
            return self
        return dataclasses.replace(self, name=self.name + suffix, **changed)


# Target hardware for the roofline (per the brief): TPU v5e.
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    link_bw=50e9,
    vmem_bytes=16 * 2**20,
    host_bw=32e9,
)

# The paper's platform, used to sanity-check the model against paper numbers.
A100_NVSWITCH = HardwareSpec(
    name="a100_nvswitch",
    peak_flops=312e12,
    hbm_bw=1555e9,
    link_bw=300e9,  # NVSwitch per-GPU uni-directional
    vmem_bytes=164 * 1024 * 108,
    host_bw=32e9,
)

# The port's card, from NVIDIA's H100 SXM5 datasheet (not measured here).
# peak_flops is the fp32 rate outside the tensor cores: the port's GNN
# matmuls run in fp32 with TF32 off (repro_torch/core/gnn.py).  link_bw is
# one NVLink 4 direction; on one card the virtual ring's rotation is an
# HBM copy instead (repro_torch/dist/ring.py).  vmem_bytes is the shared
# memory of all SMs (228 KiB x 132), host_bw PCIe gen5 x16.
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops=67e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    vmem_bytes=228 * 1024 * 132,
    host_bw=64e9,
)


# Fused-update MXU efficiency relative to the drained post-ring GEMM: the
# fused path runs one (P, D)·(D, D_out) partial matmul per ring step, whose
# smaller M dimension underutilizes the MXU relative to one full-shard GEMM.
# Calibrated against the measured fig9d rows (benchmarks/fig9_ablations.py
# emits model-vs-measured fused speedups; 0.85 keeps the modeled fused win
# within the measured envelope across the fig9d widths).
FUSE_RING_EFF = 0.85


def vmem_bytes(ps: int, pb: int, dim_block: int, tile_rows: int,
               d_feat: int, itemsize: int = 4) -> int:
    """VMEM working set: ring double buffer + one kernel block.

    Paper SMEM analogue: ids (ps·pb·4) + partial results (pb·D) + staged
    remote rows; the ring adds two tiles (current + in-flight).
    """
    kernel = ps * pb * 4 + pb * dim_block * itemsize + ps * dim_block * itemsize
    ring = 2 * tile_rows * min(dim_block * 8, d_feat) * itemsize
    return kernel + ring


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    """Aggregate statistics the latency model consumes (host-side, cheap)."""

    n_dev: int
    d_feat: int
    rows_per_dev: int
    local_edges_max: int    # max over devices
    remote_edges_max: int
    itemsize: int = 4

    @staticmethod
    def from_graph(graph: CSRGraph, n_dev: int, d_feat: int,
                   itemsize: int = 4) -> "WorkloadShape":
        bounds = edge_balanced_node_split(graph.indptr, n_dev)
        le, re = 0, 0
        for d in range(n_dev):
            vg = locality_edge_split(graph, bounds, d)
            le = max(le, vg.local.num_edges)
            re = max(re, vg.remote.num_edges)
        rows = int((bounds[1:] - bounds[:-1]).max())
        return WorkloadShape(n_dev, d_feat, rows, le, re, itemsize)

    def with_d_feat(self, d_feat: int) -> "WorkloadShape":
        """Same graph/partition statistics at another feature width."""
        return dataclasses.replace(self, d_feat=int(d_feat))


def layer_workload_shapes(
    graph: CSRGraph, n_dev: int, dims: "List[int]", itemsize: int = 4,
) -> "List[WorkloadShape]":
    """Per-layer workload shapes sharing ONE partition-statistics pass.

    GNN layers differ only in feature width ``D`` (the topology — and hence
    the edge/row statistics — is shared), so the per-layer latency model is
    the same :func:`estimate_latency` evaluated at each layer's ``D``.
    """
    if not dims:
        raise ValueError("need at least one layer width")
    base = WorkloadShape.from_graph(graph, n_dev, int(dims[0]), itemsize)
    return [base.with_d_feat(d) for d in dims]


def estimate_latency(
    w: WorkloadShape,
    ps: int,
    dist: int,
    pb: int,
    hw: HardwareSpec = TPU_V5E,
    interleave: bool = True,
    d_out: Optional[int] = None,
    fuse: bool = False,
    host_rows: Optional[int] = None,
    topk: Optional[int] = None,
) -> float:
    """Modeled per-aggregation latency (seconds) for one device.

    Ring schedule: S = (n-1)·dist steps.  Per step,
      comm  = tile_bytes / link_bw
      comp  = (remote gather+add bytes + interleaved local share) / hbm_bw
    With overlap (interleave=True) a step costs max(comm, comp); without, the
    local pass runs first and every step costs comm + remote-comp (paper
    Fig. 7a vs 7b).  Padding inefficiency from partition granularity is
    modeled by rounding edges up to multiples of ps per node — the same
    waste the mask slots represent at runtime.

    ``d_out`` adds the layer's dense ``·W`` update phase
    (``2 · rows · D · D_out`` FLOPs per device): serial after the ring when
    ``fuse=False`` (the cuBLAS-after-aggregation dataflow), or folded into
    each ring step's compute when ``fuse=True`` — which is exactly when
    fusion wins: the MXU term hides under ``max(comm, comp)`` whenever the
    step is transfer-bound.  ``d_out=None`` models aggregation only
    (backward-compatible).

    ``host_rows`` adds the tiered feature path's host→device gather term:
    that many cold rows stream from the host :class:`repro.store`
    FeatureStore over ``hw.host_bw`` per aggregation.  The streamed
    pipeline (pipeline.mgg_aggregate_streamed) double-buffers: the fill
    chunk (``1/dist`` of the gather) is exposed, the rest hides under the
    ring — only the spill past the ring's own time is paid.  Larger
    cache capacity ⇒ fewer ``host_rows`` ⇒ lower latency, which is what
    makes capacity a climbable tuner knob; ``host_rows=None`` (or 0)
    models all-resident features (backward-compatible).

    ``topk`` models the sparse ring payload
    (:func:`repro.core.pipeline.mgg_aggregate_sparse`): each tile ships
    ``k`` top-k values plus their column indices (int16 below the int16
    id range, else int32) instead of ``D`` dense floats, scaling the
    per-step wire bytes by ``k·(itemsize+idx)/(D·itemsize)``.  The
    gather side reads the narrow compressed rows but still accumulates a
    dense ``D``-wide output, so compute bytes scale by
    ``(k·(itemsize+idx) + D·itemsize)/(2·D·itemsize)``.  ``topk=None``
    (or ≥ D) models the dense pipeline.
    """
    k = None if topk is None else int(min(int(topk), w.d_feat))
    idx_b = 2 if w.d_feat <= 32767 else 4
    wire_mult = 1.0 if k is None \
        else k * (w.itemsize + idx_b) / (w.d_feat * w.itemsize)
    comp_mult = 1.0 if k is None \
        else (k * (w.itemsize + idx_b) + w.d_feat * w.itemsize) \
        / (2.0 * w.d_feat * w.itemsize)
    t_update = 0.0
    if d_out is not None:
        t_update = 2.0 * w.rows_per_dev * w.d_feat * d_out / hw.peak_flops
    t_gather = 0.0
    if host_rows:
        t_gather = host_rows * w.d_feat * w.itemsize / hw.host_bw
    if w.n_dev == 1:
        bytes_local = 2 * w.local_edges_max * w.d_feat * w.itemsize
        return bytes_local * comp_mult / hw.hbm_bw + t_update + t_gather
    tile_rows = -(-w.rows_per_dev // dist)
    steps = (w.n_dev - 1) * dist
    tile_bytes = tile_rows * w.d_feat * w.itemsize * wire_mult
    # partition-padding waste: ~ps/2 wasted slots per node on average; fold
    # into an effective edge multiplier (calibrated vs. plan.stats()).
    pad_mult = 1.0 + 0.5 * ps * w.n_dev / max(1, w.remote_edges_max)
    re_bytes = 2 * w.remote_edges_max * pad_mult * w.d_feat * w.itemsize \
        * comp_mult
    lc_bytes = 2 * w.local_edges_max * w.d_feat * w.itemsize * comp_mult
    t_comm = tile_bytes / hw.link_bw
    t_remote = re_bytes / steps / hw.hbm_bw
    t_local = lc_bytes / steps / hw.hbm_bw
    # pb: block mapping efficiency — too small starves the VPU lanes, too big
    # spills VMEM.  Modeled as a mild efficiency curve peaking at pb where the
    # block fits VMEM (hard constraint checked by the caller).
    eff = min(1.0, 0.55 + 0.15 * np.log2(max(1, pb)))
    # fused partial GEMMs run at FUSE_RING_EFF of the drained GEMM's MXU
    # utilization (calibrated vs fig9d)
    t_step_update = t_update / steps / FUSE_RING_EFF if fuse else 0.0
    if interleave:
        per_step = max(t_comm, (t_remote + t_local) / eff + t_step_update)
        t = steps * per_step + t_comm  # + pipeline fill
    else:
        t = lc_bytes / hw.hbm_bw / eff \
            + steps * (t_comm + t_remote / eff + t_step_update)
    if t_gather:
        # double-buffered prefetch: the fill chunk is exposed, the rest
        # overlaps the ring — pay only what spills past the ring's time
        fill = t_gather / max(1, dist)
        t += fill + max(0.0, (t_gather - fill) - t)
    return t if fuse else t + t_update


def estimate_pipeline_latency(
    shapes: "List[WorkloadShape]",
    configs: "List[Dict[str, int]]",
    hw: HardwareSpec = TPU_V5E,
    interleave: bool = True,
    d_outs: Optional["List[Optional[int]]"] = None,
    fuse: bool = False,
    fuses: Optional["List[bool]"] = None,
    topk: Optional[int] = None,
) -> float:
    """Whole-forward model: Σ over layers of the per-layer estimate.

    ``shapes[i]`` carries layer ``i``'s feature width (see
    :func:`layer_workload_shapes`); ``configs[i]`` its ``(ps, dist, pb)``
    and optionally a per-layer ``fuse`` flag (``fuses`` overrides, then
    ``configs[i]['fuse']``, then the call-level ``fuse`` default — the
    same precedence the per-layer tuner's fuse dimension produces).  A
    per-config ``k`` (the v4 cache knob) likewise overrides the
    call-level ``topk`` default; layer 0 is always modeled dense,
    matching :meth:`GNNEngine.stage_topk`.  The
    analytical counterpart of the per-layer tuner's objective — the tuner
    itself descends MEASURED full-forward latencies (it never calls
    this); use it for offline what-if modeling and roofline reports.  The
    ``fuse`` term is calibrated against the measured fig9d rows via
    :data:`FUSE_RING_EFF`.
    """
    if len(shapes) != len(configs):
        raise ValueError("one config per layer required")
    if d_outs is None:
        d_outs = [None] * len(shapes)
    def _k(i, c):
        if i == 0:
            return None
        k = c.get("k", topk)
        return int(k) if k else None

    return sum(
        estimate_latency(s, int(c["ps"]), int(c["dist"]), int(c["pb"]),
                         hw=hw, interleave=interleave, d_out=d_outs[i],
                         fuse=bool(fuses[i] if fuses is not None
                                   else c.get("fuse", fuse)),
                         topk=_k(i, c))
        for i, (s, c) in enumerate(zip(shapes, configs))
    )


@dataclasses.dataclass
class SearchResult:
    best: Dict[str, int]
    best_latency: float
    trajectory: List[Tuple[Dict[str, int], float]]
    table: Dict[Tuple[int, int, int], float]

    @property
    def num_trials(self) -> int:
        return len(self.trajectory)


def cross_iteration_optimize(
    measure: Callable[[int, int, int], float],
    ps_space: Tuple[int, ...] = (1, 2, 4, 8, 16, 32),
    dist_space: Tuple[int, ...] = (1, 2, 4, 8, 16),
    pb_space: Tuple[int, ...] = (1, 2, 4, 8, 16),
    vmem_check: Optional[Callable[[int, int, int], bool]] = None,
) -> SearchResult:
    """The paper's cross-iteration optimization (§4), verbatim logic.

    ``measure(ps, dist, pb) -> latency``.  Parameters start at the smallest
    value; each phase greedily increases one knob while latency improves:

    1. increase ``ps`` until latency rises (layout),
    2. increase ``dist`` likewise (pipeline),
    3. increase ``pb``; if no pb improves, *retreat* ``ps`` one notch and
       retry (the paper's "decrease ps to its second-highest value"),
    stopping when further moves cannot beat the top-3 recorded latencies.
    A lookup table memoizes every measured configuration.
    """
    table: Dict[Tuple[int, int, int], float] = {}
    traj: List[Tuple[Dict[str, int], float]] = []

    def mget(ps: int, dist: int, pb: int) -> float:
        key = (ps, dist, pb)
        if key not in table:
            if vmem_check is not None and not vmem_check(ps, dist, pb):
                table[key] = float("inf")
            else:
                table[key] = float(measure(ps, dist, pb))
            traj.append((dict(ps=ps, dist=dist, pb=pb), table[key]))
        return table[key]

    def climb(values: Tuple[int, ...], cur: int, f: Callable[[int], float]) -> int:
        best, best_lat = cur, f(cur)
        for v in values:
            if v <= cur:
                continue
            lat = f(v)
            if lat < best_lat:
                best, best_lat = v, lat
            else:
                break  # paper: stop the search once latency increases
        return best

    ps = climb(ps_space, ps_space[0], lambda v: mget(v, dist_space[0], pb_space[0]))
    dist = climb(dist_space, dist_space[0], lambda v: mget(ps, v, pb_space[0]))
    pb = climb(pb_space, pb_space[0], lambda v: mget(ps, dist, v))

    # Retreat rule: if pb never improved, drop ps one notch and retry pb.
    if pb == pb_space[0] and ps != ps_space[0]:
        ps_retreat = ps_space[max(0, ps_space.index(ps) - 1)]
        pb2 = climb(pb_space, pb_space[0], lambda v: mget(ps_retreat, dist, v))
        if mget(ps_retreat, dist, pb2) < mget(ps, dist, pb):
            ps, pb = ps_retreat, pb2

    best_key = min(table, key=lambda k: table[k])
    return SearchResult(
        best=dict(ps=best_key[0], dist=best_key[1], pb=best_key[2]),
        best_latency=table[best_key],
        trajectory=traj,
        table=table,
    )
