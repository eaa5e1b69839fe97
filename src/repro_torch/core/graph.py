"""Graph containers and synthetic generators for the MGG engine.

(Framework-free copy of ``repro/core/graph.py``: the port may not import the JAX
package.  tests/test_torch_planning.py holds the two copies equal.)

The paper evaluates full-graph GNNs on five large graphs (Table 3: reddit,
enwiki-2013, ogbn-products, ogbn-proteins, com-orkut).  Those datasets are not
shippable inside this repo, so we provide deterministic synthetic generators
that reproduce the *structural properties that matter to MGG*: heavy-tailed
degree distributions (power-law), high average degree, and community locality
(which controls the local/remote edge ratio after an edge-balanced node
split).  Scaled-down stand-ins for each paper dataset are exposed through
:func:`paper_dataset` so every benchmark names the graph it models.

All preprocessing here is host-side NumPy — mirroring the paper, where graph
partitioning and workload management run on the CPU before kernels launch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "CSRGraph",
    "erdos_renyi",
    "power_law",
    "paper_dataset",
    "PAPER_DATASETS",
    "neighbors_of",
    "khop_in_frontier",
]


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """A directed graph in CSR form (row = destination, cols = in-neighbors).

    GNN aggregation consumes *in*-edges: row ``v`` of the CSR lists the
    neighbors ``u`` whose embeddings are accumulated into ``v``.  ``indptr``
    has length ``num_nodes + 1``; ``indices`` holds column ids.
    """

    indptr: np.ndarray  # (N+1,) int64
    indices: np.ndarray  # (nnz,) int32
    num_nodes: int

    def __post_init__(self) -> None:
        assert self.indptr.ndim == 1 and self.indices.ndim == 1
        assert self.indptr.shape[0] == self.num_nodes + 1
        assert self.indptr[0] == 0 and self.indptr[-1] == self.indices.shape[0]

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def row(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def with_self_loops(self) -> "CSRGraph":
        """Return a copy with a self edge added to every row (GCN's A + I)."""
        deg = self.degrees
        new_ptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(deg + 1, out=new_ptr[1:])
        new_idx = np.empty(self.num_edges + self.num_nodes, dtype=np.int32)
        # Vectorized construction: positions of original edges shift by row id.
        row_ids = np.repeat(np.arange(self.num_nodes), deg)
        new_pos = self.indptr[:-1][row_ids] + row_ids + (
            np.arange(self.num_edges) - self.indptr[:-1][row_ids]
        )
        new_idx[new_pos] = self.indices
        new_idx[new_ptr[1:] - 1] = np.arange(self.num_nodes, dtype=np.int32)
        return CSRGraph(new_ptr, new_idx, self.num_nodes)

    def transpose(self) -> "CSRGraph":
        """The reverse graph: row ``u`` lists the nodes ``v`` with an edge
        ``u → v`` in this graph (i.e. out-neighbors under the in-edge CSR).

        Serving uses this for cache invalidation: a feature change at ``u``
        dirties the layer-1 aggregates of exactly ``transpose().row(u)``.
        """
        dst = np.repeat(np.arange(self.num_nodes, dtype=np.int32),
                        self.degrees)
        order = np.argsort(self.indices, kind="stable")
        counts = np.bincount(self.indices, minlength=self.num_nodes)
        indptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr, dst[order], self.num_nodes)

    def to_dense(self) -> np.ndarray:
        """Dense adjacency (tests only — O(N^2)); multi-edges accumulate."""
        a = np.zeros((self.num_nodes, self.num_nodes), dtype=np.float32)
        row_ids = np.repeat(np.arange(self.num_nodes), self.degrees)
        np.add.at(a, (row_ids, self.indices), 1.0)
        return a


def neighbors_of(graph: CSRGraph, nodes: np.ndarray) -> np.ndarray:
    """Concatenated in-neighbor lists of ``nodes`` (duplicates kept).

    Vectorized CSR range gather — the serving frontier extractor calls this
    per hop, so no per-node Python loop.
    """
    nodes = np.asarray(nodes, dtype=np.int64)
    starts = graph.indptr[nodes]
    lens = graph.indptr[nodes + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int32)
    # flat positions: for each node, starts[i] + (0..lens[i])
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens)
    return graph.indices[np.repeat(starts, lens) + offs]


def khop_in_frontier(graph: CSRGraph, seeds: np.ndarray,
                     k: int) -> np.ndarray:
    """Sorted node set reachable from ``seeds`` over ≤ ``k`` reverse hops.

    These are exactly the nodes whose embeddings a ``k``-layer GNN reads to
    predict ``seeds`` (the receptive field): hop 0 is the seeds themselves,
    hop ``i`` adds the in-neighbors of hop ``i-1``.
    """
    frontier = np.unique(np.asarray(seeds, dtype=np.int64))
    seen = frontier
    for _ in range(int(k)):
        nxt = np.unique(neighbors_of(graph, frontier).astype(np.int64))
        frontier = nxt[~np.isin(nxt, seen)]
        if frontier.size == 0:
            break
        seen = np.union1d(seen, frontier)
    return seen.astype(np.int64)


def _from_edges(dst: np.ndarray, src: np.ndarray, num_nodes: int) -> CSRGraph:
    """Build a CSR from (dst, src) edge arrays, sorting and deduplicating."""
    order = np.lexsort((src, dst))
    dst, src = dst[order], src[order]
    keep = np.ones(dst.shape[0], dtype=bool)
    keep[1:] = (dst[1:] != dst[:-1]) | (src[1:] != src[:-1])
    dst, src = dst[keep], src[keep]
    counts = np.bincount(dst, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr, src.astype(np.int32), num_nodes)


def erdos_renyi(num_nodes: int, avg_degree: float, seed: int = 0) -> CSRGraph:
    """Uniform random directed graph with the given expected in-degree."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_nodes * avg_degree)
    dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    return _from_edges(dst, src, num_nodes)


def power_law(
    num_nodes: int,
    avg_degree: float,
    alpha: float = 2.1,
    locality: float = 0.0,
    seed: int = 0,
) -> CSRGraph:
    """Heavy-tailed graph: in-degrees ~ Zipf(alpha), sources Zipf-popular.

    ``locality`` in [0, 1) biases a fraction of edges to nearby node ids,
    modeling community structure: after a contiguous node split, higher
    locality ⇒ larger local/remote edge ratio (the knob MGG's locality-aware
    edge split responds to).
    """
    rng = np.random.default_rng(seed)
    # Target in-degree per node: truncated Zipf scaled to the requested mean.
    raw = rng.zipf(alpha, size=num_nodes).astype(np.float64)
    raw = np.minimum(raw, num_nodes / 4)
    deg = np.maximum(1, (raw * (avg_degree / raw.mean())).astype(np.int64))
    dst = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    num_edges = dst.shape[0]
    # Sources: popularity-weighted (hubs), with a locality mixture.
    pop = rng.permutation(num_nodes)  # hub ids are random, not id-ordered
    zipf_src = rng.zipf(alpha, size=num_edges) % num_nodes
    src = pop[zipf_src]
    if locality > 0.0:
        local_mask = rng.random(num_edges) < locality
        width = max(2, num_nodes // 64)
        offs = rng.integers(-width, width + 1, size=num_edges)
        src = np.where(local_mask, (dst + offs) % num_nodes, src)
    return _from_edges(dst, src.astype(np.int64), num_nodes)


# Scaled-down structural stand-ins for the paper's Table 3 datasets.
# (name → (num_nodes, avg_degree, feature dim D, #classes, locality)).
# Full-size graphs do not fit a CPU CI loop; the generators keep the degree
# skew and local/remote edge mix that drive MGG's behaviour.  The real sizes
# are kept alongside for the analytical model / roofline extrapolations.
PAPER_DATASETS: Dict[str, Dict[str, float]] = {
    "reddit": dict(nodes=8192, avg_degree=48.0, dim=602, classes=41,
                   locality=0.30, real_nodes=232_965, real_edges=114_615_892),
    "enwiki": dict(nodes=16384, avg_degree=12.0, dim=96, classes=128,
                   locality=0.15, real_nodes=4_203_323, real_edges=202_623_226),
    "products": dict(nodes=12288, avg_degree=10.0, dim=100, classes=64,
                     locality=0.45, real_nodes=2_449_029, real_edges=61_859_140),
    "proteins": dict(nodes=6144, avg_degree=64.0, dim=128, classes=112,
                     locality=0.25, real_nodes=132_534, real_edges=39_561_252),
    "orkut": dict(nodes=16384, avg_degree=16.0, dim=128, classes=32,
                  locality=0.20, real_nodes=3_072_441, real_edges=117_185_083),
}


def paper_dataset(
    name: str, scale: float = 1.0, seed: int = 0
) -> Tuple[CSRGraph, Dict[str, float]]:
    """Return (graph, meta) for a scaled stand-in of a paper dataset."""
    meta = dict(PAPER_DATASETS[name])
    n = max(64, int(meta["nodes"] * scale))
    g = power_law(
        n,
        avg_degree=float(meta["avg_degree"]),
        locality=float(meta["locality"]),
        seed=seed,
    )
    meta["nodes"] = n
    return g, meta
