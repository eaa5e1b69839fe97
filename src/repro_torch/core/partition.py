"""Pipeline-aware workload management (paper §3.1).

(Framework-free copy of ``repro/core/partition.py``: the port may not import the JAX
package.  tests/test_torch_planning.py holds the two copies equal.)

Three stages, faithful to MGG:

1. **Edge-balanced node split** — partition nodes into ``num_parts``
   contiguous ranges holding an approximately equal number of *edges*
   (Algorithm 1's range-constrained binary search over the CSR row pointer).
2. **Locality-aware edge split** — per partition, split incident edges into a
   *local* virtual graph (neighbor owned by the same partition) and a
   *remote* virtual graph (neighbor owned elsewhere), two separate CSRs whose
   partial aggregates are summed (paper Fig. 4a-1).
3. **Workload-aware neighbor split** — chop each virtual-graph row into
   fixed-size neighbor partitions of ``ps`` neighbors (paper Fig. 4a-2) so
   every work unit (GPU warp there, Pallas grid cell / ring-round slice here)
   carries uniform work.

Everything is host-side NumPy: this is the cheap preprocessing the paper
contrasts with DGCL's expensive partitioner (Table 4).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .graph import CSRGraph

__all__ = [
    "edge_balanced_node_split",
    "locality_edge_split",
    "neighbor_partitions",
    "NeighborPartitions",
    "VirtualGraphs",
]


def edge_balanced_node_split(indptr: np.ndarray, num_parts: int) -> np.ndarray:
    """Algorithm 1: choose ``num_parts - 1`` node split points so that each
    contiguous node range covers ~``nnz / num_parts`` edges.

    Returns ``bounds`` of length ``num_parts + 1`` with ``bounds[0] == 0`` and
    ``bounds[-1] == num_nodes``; partition ``p`` owns nodes
    ``[bounds[p], bounds[p+1])``.

    The paper's range-constrained binary search looks, per split point, for
    the node id whose cumulative edge count first reaches
    ``lastSplitEdges + ePerGPU``.  ``indptr`` is exactly that cumulative edge
    count, so each search is a ``searchsorted`` over ``indptr`` restricted to
    ``[lastPos, num_nodes]`` — identical result, branch-free.
    """
    num_nodes = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    if num_parts <= 0:
        raise ValueError("num_parts must be positive")
    e_per_part = (nnz + num_parts - 1) // num_parts  # paper line 2 (ceil)
    bounds = np.zeros(num_parts + 1, dtype=np.int64)
    bounds[-1] = num_nodes
    last = 0
    for p in range(1, num_parts):
        target = min(int(indptr[last]) + e_per_part, nnz)
        # first node id in (last, num_nodes] whose indptr >= target
        nid = int(np.searchsorted(indptr, target, side="left"))
        nid = max(nid, last + 1) if last + 1 <= num_nodes else num_nodes
        nid = min(nid, num_nodes)
        bounds[p] = nid
        last = nid
    # Monotonic repair for degenerate cases (many empty rows / tiny graphs).
    for p in range(1, num_parts + 1):
        bounds[p] = max(bounds[p], bounds[p - 1])
    return bounds


@dataclasses.dataclass(frozen=True)
class VirtualGraphs:
    """Local + remote virtual CSRs for one node partition (paper Fig. 4a-1).

    Rows are partition-local (``0 .. n_local``); ``local.indices`` hold
    *global* neighbor ids within this partition's own range, while
    ``remote.indices`` hold global neighbor ids owned by other partitions.
    """

    part_id: int
    lb: int  # global node-id lower bound (inclusive)
    ub: int  # global node-id upper bound (exclusive)
    local: CSRGraph
    remote: CSRGraph

    @property
    def n_local_nodes(self) -> int:
        return self.ub - self.lb


def locality_edge_split(
    graph: CSRGraph, bounds: np.ndarray, part_id: int
) -> VirtualGraphs:
    """Split partition ``part_id``'s rows into local/remote virtual CSRs."""
    lb, ub = int(bounds[part_id]), int(bounds[part_id + 1])
    n_rows = ub - lb
    row_start = graph.indptr[lb:ub]
    row_end = graph.indptr[lb + 1 : ub + 1]
    deg = (row_end - row_start).astype(np.int64)
    cols = graph.indices[graph.indptr[lb] : graph.indptr[ub]]
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
    is_local = (cols >= lb) & (cols < ub)

    def _build(mask: np.ndarray) -> CSRGraph:
        sel_rows, sel_cols = rows[mask], cols[mask]
        counts = np.bincount(sel_rows, minlength=n_rows)
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        # rows are already sorted (CSR order preserved under boolean mask)
        return CSRGraph(indptr, sel_cols.astype(np.int32), n_rows)

    return VirtualGraphs(
        part_id=part_id,
        lb=lb,
        ub=ub,
        local=_build(is_local),
        remote=_build(~is_local),
    )


@dataclasses.dataclass(frozen=True)
class NeighborPartitions:
    """Fixed-size neighbor partitions of one virtual CSR (paper Fig. 4a-2).

    ``nbrs[p, j]`` is the j-th neighbor id of partition ``p`` (padded),
    ``mask[p, j]`` marks valid slots, ``targets[p]`` is the partition-local
    destination row.  Every partition carries at most ``ps`` neighbors of a
    single destination node, so per-work-unit cost is uniform — the paper's
    answer to inter-node workload imbalance.
    """

    nbrs: np.ndarray  # (P, ps) int32, padded with 0
    mask: np.ndarray  # (P, ps) bool
    targets: np.ndarray  # (P,) int32
    ps: int

    @property
    def num_partitions(self) -> int:
        return int(self.targets.shape[0])


def neighbor_partitions(csr: CSRGraph, ps: int) -> NeighborPartitions:
    """Chop each CSR row into ceil(deg/ps) partitions of ``ps`` slots."""
    if ps <= 0:
        raise ValueError("ps must be positive")
    deg = csr.degrees.astype(np.int64)
    parts_per_row = (deg + ps - 1) // ps
    total = int(parts_per_row.sum())
    nbrs = np.zeros((total, ps), dtype=np.int32)
    mask = np.zeros((total, ps), dtype=bool)
    targets = np.repeat(
        np.arange(csr.num_nodes, dtype=np.int32), parts_per_row
    )
    if total == 0:
        return NeighborPartitions(nbrs, mask, targets, ps)
    # Vectorized fill: edge e of row v goes to partition base[v] + off // ps,
    # slot off % ps, where off is e's offset within its row.
    part_base = np.zeros(csr.num_nodes, dtype=np.int64)
    np.cumsum(parts_per_row[:-1], out=part_base[1:])
    row_ids = np.repeat(np.arange(csr.num_nodes, dtype=np.int64), deg)
    offs = np.arange(csr.num_edges, dtype=np.int64) - csr.indptr[:-1][row_ids]
    p_idx = part_base[row_ids] + offs // ps
    s_idx = offs % ps
    nbrs[p_idx, s_idx] = csr.indices
    mask[p_idx, s_idx] = True
    return NeighborPartitions(nbrs, mask, targets, ps)


def split_summary(graph: CSRGraph, bounds: np.ndarray) -> List[Tuple[int, int, int]]:
    """(edges, local_edges, remote_edges) per partition — for benchmarks."""
    out = []
    for p in range(bounds.shape[0] - 1):
        vg = locality_edge_split(graph, bounds, p)
        out.append(
            (vg.local.num_edges + vg.remote.num_edges,
             vg.local.num_edges, vg.remote.num_edges)
        )
    return out
