"""Hybrid GNN data placement (paper §3.2), adapted to a TPU mesh.

(Framework-free copy of ``repro/core/placement.py``: the port may not import the JAX
package.  tests/test_torch_planning.py holds the two copies equal.)

The paper stores node embeddings (NE) in NVSHMEM *shared* global memory — a
PGAS heap spanning all GPUs — and the partitioned topology (GP) in each GPU's
*private* memory, with global node ids remapped to (owner, local offset).

TPU analogue:

* **NE** → a single embedding array of shape ``(n_dev * rows_per_dev, D)``
  with a ``NamedSharding`` over the ring axis: chip ``d`` physically owns the
  row range ``[d * rows, (d+1) * rows)``.  This is the PGAS layout — one
  logical array, physically distributed, remotely reachable (via the ring
  collective rather than one-sided GET; see DESIGN.md §2).
* **GP** → the per-device neighbor-partition tensors built here.  They are
  *also* stacked into device-major arrays (leading axis ``n_dev``) and
  sharded on that axis, so inside ``shard_map`` every chip sees only its own
  topology block — the "private memory" of the paper, including the
  global→local offset remap of Fig. 5.

The :class:`AggregationPlan` is a pytree of plain arrays; building it is
host-side NumPy (cheap preprocessing — paper Table 4 contrasts this with
DGCL's minutes-long partitioner).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import CSRGraph
from .partition import (
    NeighborPartitions,
    VirtualGraphs,
    edge_balanced_node_split,
    locality_edge_split,
    neighbor_partitions,
)

__all__ = [
    "AggregationPlan",
    "SharedPartition",
    "LayerPlan",
    "build_partition",
    "plan_from_partition",
    "build_plan",
    "build_layer_plans",
    "build_bulk_plan",
    "build_fetch_plan",
    "pad_table",
    "unpad_table",
    "pad_embeddings",
    "unpad_embeddings",
    "pgas_rows",
]


@dataclasses.dataclass(frozen=True)
class AggregationPlan:
    """Device-major MGG aggregation plan.

    Shapes (``n`` devices, ``S = (n-1) * dist`` ring steps, ``ps`` slots):

    ================  =============================  ==========================
    field             shape                          meaning
    ================  =============================  ==========================
    local_nbrs        (n, PL, ps) int32              local neighbor offsets
    local_mask        (n, PL, ps) bool               valid slots
    local_targets     (n, PL) int32                  destination local row
    remote_nbrs       (n, S, PR, ps) int32           tile-local nbr offsets
    remote_mask       (n, S, PR, ps) bool
    remote_targets    (n, S, PR) int32
    node_counts       (n,) int32                     real rows per device
    ================  =============================  ==========================

    ``rows_per_dev`` is the padded shard height; ``tile_rows`` =
    ``rows_per_dev / dist`` is the ring-tile height.  Step ``s`` of the ring
    aggregates the tile of chunk ``s % dist`` from owner
    ``(d - (s // dist) - 1) mod n``.
    """

    local_nbrs: np.ndarray
    local_mask: np.ndarray
    local_targets: np.ndarray
    remote_nbrs: np.ndarray
    remote_mask: np.ndarray
    remote_targets: np.ndarray
    node_counts: np.ndarray
    bounds: np.ndarray  # (n+1,) global node-range bounds
    n_dev: int
    rows_per_dev: int
    tile_rows: int
    ps: int
    dist: int

    @property
    def num_steps(self) -> int:
        return int(self.remote_nbrs.shape[1])

    @property
    def padded_nodes(self) -> int:
        return self.n_dev * self.rows_per_dev

    def stats(self) -> dict:
        """Workload-balance diagnostics used by benchmarks and the autotuner."""
        local_parts = self.local_mask.any(-1).sum(-1)  # per device
        remote_parts = self.remote_mask.any(-1).sum(-1).sum(-1)
        return dict(
            local_partitions=local_parts.tolist(),
            remote_partitions=remote_parts.tolist(),
            pad_local=float(self.local_mask.shape[1] * self.n_dev
                            - local_parts.sum()) / max(1, self.local_mask.shape[1] * self.n_dev),
            pad_remote=float(self.remote_mask.shape[1] * self.remote_mask.shape[2] * self.n_dev
                             - remote_parts.sum())
            / max(1, self.remote_mask.shape[1] * self.remote_mask.shape[2] * self.n_dev),
        )


def _pad_parts(parts: NeighborPartitions, p_max: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    p = parts.num_partitions
    nbrs = np.zeros((p_max, parts.ps), dtype=np.int32)
    mask = np.zeros((p_max, parts.ps), dtype=bool)
    tgt = np.zeros((p_max,), dtype=np.int32)
    nbrs[:p] = parts.nbrs
    mask[:p] = parts.mask
    tgt[:p] = parts.targets
    return nbrs, mask, tgt


@dataclasses.dataclass(frozen=True)
class SharedPartition:
    """The layer-independent half of plan construction (paper §3.1–3.2).

    Node split + per-device locality edge split are functions of the *graph*
    only; the neighbor-partition schedules (``ps``) and ring-tile bucketing
    (``dist``) are per-layer knobs.  Building one :class:`SharedPartition`
    and deriving every layer's :class:`AggregationPlan` from it keeps a
    single neighbor table source — per-layer plans differ only in schedule,
    never in topology — and makes per-layer plan construction O(schedules)
    instead of O(layers × locality splits).
    """

    bounds: np.ndarray                 # (n_dev + 1,) global node ranges
    n_dev: int
    vgs: Tuple[VirtualGraphs, ...]     # per-device local/remote virtual CSRs
    base_rows: int                     # unpadded max shard height

    @property
    def node_counts(self) -> np.ndarray:
        return (self.bounds[1:] - self.bounds[:-1]).astype(np.int32)


def build_partition(
    graph: CSRGraph, n_dev: int, bounds: Optional[np.ndarray] = None
) -> SharedPartition:
    """Node split + locality split, shared by every layer's plan."""
    if bounds is None:
        bounds = edge_balanced_node_split(graph.indptr, n_dev)
    bounds = np.asarray(bounds, dtype=np.int64)
    vgs = tuple(locality_edge_split(graph, bounds, d) for d in range(n_dev))
    return SharedPartition(
        bounds=bounds, n_dev=n_dev, vgs=vgs,
        base_rows=int((bounds[1:] - bounds[:-1]).max()),
    )


def plan_from_partition(
    part: SharedPartition,
    ps: int,
    dist: int = 1,
    rows_multiple: int = 1,
) -> AggregationPlan:
    """Derive one (ps, dist) aggregation schedule from a shared partition.

    ``rows_multiple`` forces the padded shard height to a common multiple so
    plans with *different* ``dist`` can share one PGAS embedding layout
    (build_layer_plans passes the lcm of every layer's dist).
    """
    n_dev, bounds = part.n_dev, part.bounds
    # Pad shard height to a multiple of dist (uniform ring tiles) and of
    # rows_multiple (cross-layer shared layout).
    m = dist * rows_multiple // math.gcd(dist, rows_multiple)
    rows = ((part.base_rows + m - 1) // m) * m
    tile_rows = rows // dist
    n_steps = (n_dev - 1) * dist if n_dev > 1 else 0

    per_dev_local = []
    per_dev_remote = []  # list of lists: [dev][step] -> NeighborPartitions
    for d in range(n_dev):
        vg = part.vgs[d]
        # --- local virtual graph: global ids -> my local offsets (Fig. 5) ---
        local_csr = CSRGraph(
            vg.local.indptr,
            (vg.local.indices - vg.lb).astype(np.int32),
            vg.local.num_nodes,
        )
        per_dev_local.append(neighbor_partitions(local_csr, ps))
        # --- remote virtual graph: bucket edges by (owner, ring tile) -------
        cols = vg.remote.indices
        deg = vg.remote.degrees
        rows_ids = np.repeat(np.arange(vg.remote.num_nodes, dtype=np.int64), deg)
        owner = np.searchsorted(bounds, cols, side="right") - 1
        local_off = cols - bounds[owner]
        chunk = local_off // tile_rows  # which ring tile inside the owner shard
        tile_off = (local_off - chunk * tile_rows).astype(np.int32)
        steps = []
        for s in range(n_steps):
            r = s // dist + 1  # rotation count
            c = s % dist  # chunk id
            o = (d - r) % n_dev  # owner whose tile arrives at this step
            m_sel = (owner == o) & (chunk == c)
            sel_rows, sel_off = rows_ids[m_sel], tile_off[m_sel]
            counts = np.bincount(sel_rows, minlength=vg.remote.num_nodes)
            indptr = np.zeros(vg.remote.num_nodes + 1, dtype=np.int64)
            np.cumsum(counts, out=indptr[1:])
            order = np.argsort(sel_rows, kind="stable")
            sub = CSRGraph(indptr, sel_off[order], vg.remote.num_nodes)
            steps.append(neighbor_partitions(sub, ps))
        per_dev_remote.append(steps)

    pl_max = max(1, max(p.num_partitions for p in per_dev_local))
    pr_max = 1
    for steps in per_dev_remote:
        for p in steps:
            pr_max = max(pr_max, p.num_partitions)

    local_nbrs = np.zeros((n_dev, pl_max, ps), dtype=np.int32)
    local_mask = np.zeros((n_dev, pl_max, ps), dtype=bool)
    local_targets = np.zeros((n_dev, pl_max), dtype=np.int32)
    remote_nbrs = np.zeros((n_dev, max(1, n_steps), pr_max, ps), dtype=np.int32)
    remote_mask = np.zeros((n_dev, max(1, n_steps), pr_max, ps), dtype=bool)
    remote_targets = np.zeros((n_dev, max(1, n_steps), pr_max), dtype=np.int32)
    for d in range(n_dev):
        local_nbrs[d], local_mask[d], local_targets[d] = _pad_parts(
            per_dev_local[d], pl_max
        )
        for s in range(n_steps):
            (remote_nbrs[d, s], remote_mask[d, s],
             remote_targets[d, s]) = _pad_parts(per_dev_remote[d][s], pr_max)

    return AggregationPlan(
        local_nbrs=local_nbrs,
        local_mask=local_mask,
        local_targets=local_targets,
        remote_nbrs=remote_nbrs,
        remote_mask=remote_mask,
        remote_targets=remote_targets,
        node_counts=part.node_counts,
        bounds=bounds,
        n_dev=n_dev,
        rows_per_dev=rows,
        tile_rows=tile_rows,
        ps=ps,
        dist=dist,
    )


def build_plan(
    graph: CSRGraph,
    n_dev: int,
    ps: int,
    dist: int = 1,
    bounds: Optional[np.ndarray] = None,
) -> AggregationPlan:
    """Build the full MGG plan: node split → locality split → neighbor split
    → ring-step bucketing, with the PGAS offset remap of paper Fig. 5."""
    return plan_from_partition(build_partition(graph, n_dev, bounds),
                               ps=ps, dist=dist)


# ---------------------------------------------------------------------------
# per-layer pipeline plans (shared partition, per-layer schedules)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One GNN layer's pipeline configuration: an aggregation schedule plus
    the runtime knobs that select how it executes.

    ``plan`` may be SHARED between layers whose ``(ps, dist)`` coincide (see
    :func:`build_layer_plans`) — a LayerPlan never owns topology, only the
    schedule + mapping knobs:

    * ``interleave`` — §3.3 local/remote workload interleaving;
    * ``pb``         — the paper's wpb: kernel partition-block height;
    * ``fuse_update`` — run this layer's dense ``·W`` update *inside* the
      ring (one partial matmul per tile), so update FLOPs overlap the next
      tile's transfer (pipeline.mgg_aggregate ``update_w``);
    * ``topk``       — top-k activation compression: the ring ppermutes the
      compressed ``(values, col_idx)`` payload instead of dense tiles
      (pipeline.mgg_aggregate_sparse).  ``None``/0 = dense.  Model stages
      honour it for hidden layers only — layer 0's inputs aren't ours to
      sparsify.
    """

    plan: AggregationPlan
    interleave: bool = True
    pb: Optional[int] = None
    fuse_update: bool = False
    topk: Optional[int] = None

    @property
    def config(self) -> Dict[str, int]:
        return dict(ps=self.plan.ps, dist=self.plan.dist,
                    pb=self.pb if self.pb is not None else 1)


def build_layer_plans(
    graph: CSRGraph,
    n_dev: int,
    configs: Sequence[Dict],
    *,
    partition: Optional[SharedPartition] = None,
    interleave: bool = True,
    fuse_update: bool = False,
    topk: Optional[int] = None,
) -> List[LayerPlan]:
    """Per-layer plans from ONE shared partition.

    ``configs`` is one dict per layer with keys ``ps`` and ``dist`` (and
    optionally ``pb``, ``interleave``, ``fuse_update``, ``topk`` overriding
    the call-level defaults).  All plans share the partition's neighbor tables
    and — because shard heights are padded to the lcm of every layer's
    ``dist`` — one PGAS embedding layout, so activations flow between
    layers without re-padding.  Layers with identical ``(ps, dist)`` share
    the SAME AggregationPlan object (no duplicated schedule arrays).
    """
    if not configs:
        raise ValueError("need at least one layer config")
    part = partition if partition is not None \
        else build_partition(graph, n_dev)
    lcm = 1
    for cfg in configs:
        d = int(cfg["dist"])
        lcm = lcm * d // math.gcd(lcm, d)
    memo: Dict[Tuple[int, int], AggregationPlan] = {}
    out: List[LayerPlan] = []
    for cfg in configs:
        key = (int(cfg["ps"]), int(cfg["dist"]))
        if key not in memo:
            memo[key] = plan_from_partition(part, ps=key[0], dist=key[1],
                                            rows_multiple=lcm)
        pb = cfg.get("pb")
        tk = cfg.get("topk", topk)
        out.append(LayerPlan(
            plan=memo[key],
            interleave=bool(cfg.get("interleave", interleave)),
            pb=int(pb) if pb is not None else None,
            fuse_update=bool(cfg.get("fuse_update", fuse_update)),
            topk=int(tk) if tk else None,
        ))
    return out


def _padded_offset(bounds: np.ndarray, rows: int, ids: np.ndarray) -> np.ndarray:
    """Global node id → row offset in the padded PGAS table."""
    owner = np.searchsorted(bounds, ids, side="right") - 1
    return (owner * rows + (ids - bounds[owner])).astype(np.int32)


def build_bulk_plan(
    graph: CSRGraph, n_dev: int, ps: int, bounds: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Plan for the bulk (all-gather-then-aggregate, DGCL-style) baseline.

    Returns device-major ``(nbrs, mask, targets, rows_per_dev)`` where
    ``nbrs`` index into the *full padded* table (valid after an all-gather).
    """
    if bounds is None:
        bounds = edge_balanced_node_split(graph.indptr, n_dev)
    rows = int((bounds[1:] - bounds[:-1]).max())
    per_dev = []
    for d in range(n_dev):
        lb, ub = int(bounds[d]), int(bounds[d + 1])
        sub = CSRGraph(
            (graph.indptr[lb : ub + 1] - graph.indptr[lb]),
            graph.indices[graph.indptr[lb] : graph.indptr[ub]],
            ub - lb,
        )
        parts = neighbor_partitions(sub, ps)
        remapped = _padded_offset(bounds, rows, parts.nbrs.ravel()).reshape(
            parts.nbrs.shape
        )
        per_dev.append(
            NeighborPartitions(remapped, parts.mask, parts.targets, ps)
        )
    p_max = max(1, max(p.num_partitions for p in per_dev))
    nbrs = np.zeros((n_dev, p_max, ps), dtype=np.int32)
    mask = np.zeros((n_dev, p_max, ps), dtype=bool)
    tgt = np.zeros((n_dev, p_max), dtype=np.int32)
    for d in range(n_dev):
        nbrs[d], mask[d], tgt[d] = _pad_parts(per_dev[d], p_max)
    return nbrs, mask, tgt, rows


def build_fetch_plan(
    graph: CSRGraph,
    n_dev: int,
    ps: int,
    page_rows: int = 1,
    bounds: Optional[np.ndarray] = None,
) -> dict:
    """Plan for the fetch-then-aggregate baselines (Direct-NVSHMEM / UVM).

    Each device fetches the union of rows it references, expanded to
    ``page_rows`` granularity (``page_rows=1`` → exact rows, the Direct
    baseline; ``page_rows≈4KB/row_bytes`` → the UVM page-migration model).
    Neighbor offsets are remapped into the fetched buffer.
    """
    if bounds is None:
        bounds = edge_balanced_node_split(graph.indptr, n_dev)
    rows = int((bounds[1:] - bounds[:-1]).max())
    fetch_lists, parts_list = [], []
    for d in range(n_dev):
        lb, ub = int(bounds[d]), int(bounds[d + 1])
        sub = CSRGraph(
            (graph.indptr[lb : ub + 1] - graph.indptr[lb]),
            graph.indices[graph.indptr[lb] : graph.indptr[ub]],
            ub - lb,
        )
        parts = neighbor_partitions(sub, ps)
        padded = _padded_offset(bounds, rows, parts.nbrs.ravel())
        pages = np.unique(padded[parts.mask.ravel()] // page_rows)
        fetched = (pages[:, None] * page_rows
                   + np.arange(page_rows)[None, :]).ravel()
        # remap padded offsets → position inside the fetched buffer
        pos = np.searchsorted(fetched, padded).astype(np.int32)
        pos = np.where(parts.mask.ravel(), pos, 0).reshape(parts.nbrs.shape)
        fetch_lists.append(fetched.astype(np.int32))
        parts_list.append(
            NeighborPartitions(pos, parts.mask, parts.targets, ps)
        )
    f_max = max(1, max(len(f) for f in fetch_lists))
    p_max = max(1, max(p.num_partitions for p in parts_list))
    fetch = np.zeros((n_dev, f_max), dtype=np.int32)
    nbrs = np.zeros((n_dev, p_max, ps), dtype=np.int32)
    mask = np.zeros((n_dev, p_max, ps), dtype=bool)
    tgt = np.zeros((n_dev, p_max), dtype=np.int32)
    for d in range(n_dev):
        fetch[d, : len(fetch_lists[d])] = fetch_lists[d]
        nbrs[d], mask[d], tgt[d] = _pad_parts(parts_list[d], p_max)
    return dict(
        fetch_rows=fetch, nbrs=nbrs, mask=mask, targets=tgt,
        rows_per_dev=rows,
        fetched_rows_per_dev=[len(f) for f in fetch_lists],
    )


def pad_table(bounds: np.ndarray, rows: int, x: np.ndarray) -> np.ndarray:
    """Scatter a (num_nodes, D) table into the padded PGAS layout
    (n_dev * rows, D): shard d holds global rows [bounds[d], bounds[d+1])."""
    n_dev = bounds.shape[0] - 1
    out = np.zeros((n_dev * rows,) + x.shape[1:], dtype=x.dtype)
    for dev in range(n_dev):
        lb, ub = int(bounds[dev]), int(bounds[dev + 1])
        out[dev * rows : dev * rows + (ub - lb)] = x[lb:ub]
    return out


def unpad_table(bounds: np.ndarray, rows: int, x: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pad_table`."""
    num_nodes = int(bounds[-1])
    out = np.zeros((num_nodes,) + x.shape[1:], dtype=x.dtype)
    for dev in range(bounds.shape[0] - 1):
        lb, ub = int(bounds[dev]), int(bounds[dev + 1])
        out[lb:ub] = x[dev * rows : dev * rows + (ub - lb)]
    return out


def pgas_rows(plan: AggregationPlan, ids: np.ndarray) -> np.ndarray:
    """Global node ids → row offsets in the plan's padded PGAS table.

    The serving engine uses this to turn request seed ids into gather rows
    of the (sharded) logits/embedding tables.
    """
    return _padded_offset(plan.bounds, plan.rows_per_dev,
                          np.asarray(ids, dtype=np.int64))


def pad_embeddings(plan: AggregationPlan, x: np.ndarray) -> np.ndarray:
    """:func:`pad_table` using an :class:`AggregationPlan`'s layout."""
    return pad_table(plan.bounds, plan.rows_per_dev, x)


def unpad_embeddings(plan: AggregationPlan, x: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pad_embeddings`."""
    return unpad_table(plan.bounds, plan.rows_per_dev, x)
