"""Hot-node cache of layer-1 aggregates (MG-GCN-style feature caching).

MG-GCN's multi-GPU GCN throughput comes half from overlap and half from
*caching frequently-accessed vertex data* so hot neighborhoods skip the
gather.  The serving analogue here caches the **stage-0 output table** —
the layer-1 aggregate ``h₁ = stage₀(params, engine, x)`` in the padded
PGAS layout — because it is request-independent: any prediction for seed
``v`` only reads ``h₁`` rows of ``v``'s 1-hop in-frontier, so a micro-batch
whose frontier is fully cached runs *only* the remaining layers (the
expensive input-dimension aggregation is skipped entirely).

Validity is tracked **per node** and invalidation is explicit: a feature
update at ``u`` dirties exactly the rows that aggregate ``u``
(``graph.transpose().row(u)``).  At repro scale the full table fits in
memory, so unlike MG-GCN we do not evict by capacity pressure by default;
an optional ``capacity`` restricts validity to the currently-hottest nodes
to model the memory-bound regime.  Hit/miss accounting is per frontier
node, so the reported hit rate is meaningful under either policy.

The table itself is a device tensor (it feeds straight into the cached
serve step); the validity mask is host-side NumPy so lookups stay off the
device queue.

(Copy of ``repro/serve/hotcache.py``; only the table's type differs.
tests/test_torch_planning.py holds the two copies equal.)
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["HotNodeCache"]


class HotNodeCache:
    """Layer-1 aggregate table with per-node validity + hit accounting."""

    def __init__(self, num_nodes: int, capacity: Optional[int] = None):
        self.num_nodes = int(num_nodes)
        self.capacity = None if capacity is None else int(capacity)
        self.table = None            # device tensor, padded PGAS layout
        self.valid = np.zeros(self.num_nodes, dtype=bool)
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.invalidations = 0

    # -- lookup / store ------------------------------------------------------

    def lookup(self, nodes: np.ndarray) -> int:
        """Count hits/misses for one frontier; returns the miss count."""
        nodes = np.asarray(nodes, dtype=np.int64)
        ok = self.valid[nodes] if self.table is not None \
            else np.zeros(nodes.shape, dtype=bool)
        n_hit = int(ok.sum())
        self.hits += n_hit
        self.misses += int(nodes.size) - n_hit
        return int(nodes.size) - n_hit

    def ready(self, nodes: np.ndarray) -> bool:
        """True iff every row this frontier needs is valid."""
        if self.table is None:
            return False
        return bool(self.valid[np.asarray(nodes, dtype=np.int64)].all())

    def store(self, table, hot_nodes: Optional[Sequence[int]] = None) -> None:
        """Install a freshly computed full table.

        With no ``capacity`` every node becomes valid (the table is the
        whole layer-1 state).  With a capacity, only the hottest
        ``capacity`` nodes (``hot_nodes``, hottest first) are marked valid —
        the stored rows exist either way, but cold rows are treated as
        evicted so the hit-rate reflects the memory-bound policy.  A
        capacity with NO hot list marks nothing valid: an empty histogram
        means nothing has earned admission yet, and falling back to
        all-valid would silently disable the memory bound.
        """
        self.table = table
        self.stores += 1
        if self.capacity is None:
            self.valid[:] = True
            return
        self.valid[:] = False
        if hot_nodes is None:
            return
        keep = np.asarray(list(hot_nodes)[: self.capacity],
                          dtype=np.int64)
        if keep.size:
            self.valid[keep] = True

    # -- invalidation --------------------------------------------------------

    def invalidate(self, nodes: Optional[np.ndarray] = None) -> int:
        """Mark ``nodes`` (or everything) dirty; returns rows invalidated."""
        self.invalidations += 1
        if nodes is None:
            n = int(self.valid.sum())
            self.valid[:] = False
            self.table = None
            return n
        # dedupe before counting: a node listed twice is still one row, and
        # the returned count feeds invalidation accounting (serve-properties
        # test pins it to actual rows dirtied)
        nodes = np.unique(np.asarray(nodes, dtype=np.int64))
        n = int(self.valid[nodes].sum())
        self.valid[nodes] = False
        return n

    # -- accounting ----------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
