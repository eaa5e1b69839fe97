"""Device-side tier of the tiered feature path: a bounded hot-row cache.

MG-GCN attributes roughly half its multi-GPU speedup to caching
frequently-accessed vertex data; GNNAdvisor's adaptive runtime shows the
*workload* should decide what is cached.  :class:`HotFeatureCache` is
that component for raw input features: a ``(capacity, d_feat)`` device
array holding the currently-hottest nodes, with admission driven by a
hottest-first node list (the serving engine passes the
:class:`~repro.serve.stats.WorkloadStats` hot-seed histogram) and
explicit per-node invalidation.

Policy follows the (fixed) :class:`~repro.serve.hotcache.HotNodeCache`
semantics:

* admission is hottest-first and capacity-bounded — an empty hot list
  admits *nothing* (an empty histogram means nothing has earned
  admission yet; falling back to all-valid would silently disable the
  memory bound);
* invalidation is explicit and deduplicated — the returned count is
  actual rows dirtied, never inflated by duplicate ids;
* hit/miss accounting is per looked-up row, so the reported hit rate is
  meaningful under any capacity.

Unlike ``HotNodeCache`` (which caches the *layer-1 aggregate* in the
padded PGAS layout and must be flushed when the tuner moves ``dist``),
this cache stores **raw feature rows keyed by global node id** — a
layout-independent key — so tuner-driven plan rebuilds keep every cached
row valid.

Port of ``repro/store/hotfeatures.py``: the table is a device tensor, and
admission is the same hottest-first prefix policy, vectorised over numpy
(one admission at the capacity of a large graph is hundreds of thousands
of rows).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["HotFeatureCache"]


class HotFeatureCache:
    """Bounded device-resident cache of hot feature rows."""

    def __init__(self, num_nodes: int, capacity: int, d_feat: int,
                 device="cpu"):
        self.num_nodes = int(num_nodes)
        self.capacity = max(0, min(int(capacity), self.num_nodes))
        self.d_feat = int(d_feat)
        self.device = torch.device(device)
        # device tier: the only feature storage that lives in device memory
        self.table = torch.zeros((self.capacity, self.d_feat),
                                 dtype=torch.float32, device=self.device) \
            if self.capacity else None
        # host-side metadata, off the device queue (HotNodeCache precedent)
        self._slot_of = np.full(self.num_nodes, -1, dtype=np.int32)
        self._node_at = np.full(self.capacity, -1, dtype=np.int64)
        self._valid = np.zeros(self.capacity, dtype=bool)
        self.hits = 0
        self.misses = 0
        self.admissions = 0
        self.evictions = 0
        self.invalidations = 0

    # -- admission -----------------------------------------------------------

    def admit(self, hot_nodes: Sequence[int], store) -> int:
        """Admit the hottest ``capacity`` of ``hot_nodes`` (hottest first).

        Rows already resident and valid stay put (no refetch); the
        remaining slots are filled from ``store`` (a
        :class:`~repro.store.FeatureStore`) — that gather is the
        admission's host→device traffic and is counted by the store.
        Nodes beyond ``capacity`` are ignored; resident nodes that fell
        out of the hot set are evicted only when their slot is needed.
        Returns the number of rows fetched.

        Hottest-first prefix admission is what makes the hit rate
        monotone in capacity: the admitted set under capacity ``c`` is a
        subset of the admitted set under any ``c' ≥ c`` for the same hot
        list (property-tested in tests/test_store_properties.py).
        """
        if self.capacity == 0:
            return 0
        hot = np.asarray(hot_nodes, dtype=np.int64).ravel()
        _, first = np.unique(hot, return_index=True)
        want = hot[np.sort(first)][: self.capacity]   # first occurrences
        s_want = self._slot_of[want]
        stale = (s_want < 0) | ~self._valid[np.maximum(s_want, 0)]
        new = want[stale]
        if new.size == 0:
            return 0
        # A re-admitted node may still map to its old (invalidated) slot;
        # clear that stale mapping first — otherwise handing the old slot
        # to a different node below would wipe the fresh assignment via
        # ``_slot_of[old] = -1`` and strand the row in an unreachable slot.
        s_old = self._slot_of[new]
        s_old = s_old[s_old >= 0]
        self._node_at[s_old] = -1
        self._valid[s_old] = False
        self._slot_of[new] = -1
        # free slots, ascending: never used, invalid, or holding a node
        # now cold
        in_want = np.zeros(self.num_nodes, dtype=bool)
        in_want[want] = True
        at = self._node_at
        free = np.flatnonzero((at < 0) | ~self._valid
                              | ~in_want[np.maximum(at, 0)])
        assert free.size >= new.size  # |want| ≤ capacity ⇒ always enough
        slots = free[: new.size]
        old = at[slots]
        held = old >= 0
        self.evictions += int((held & self._valid[slots]).sum())
        self._slot_of[old[held]] = -1
        self._slot_of[new] = slots
        self._node_at[slots] = new
        self._valid[slots] = True
        rows = store.upload(new, self.device)
        self.table[torch.from_numpy(slots).to(self.device)] = rows
        self.admissions += int(new.size)
        return int(new.size)

    # -- lookup --------------------------------------------------------------

    def slots(self, nodes: np.ndarray) -> np.ndarray:
        """Resident slot per node (−1 = miss), with hit/miss accounting."""
        nodes = np.asarray(nodes, dtype=np.int64)
        if self.capacity == 0:     # no _valid to index: everything misses
            self.misses += int(nodes.size)
            return np.full(nodes.shape, -1, dtype=np.int32)
        s = self._slot_of[nodes].astype(np.int32)
        ok = (s >= 0) & self._valid[np.maximum(s, 0)]
        s = np.where(ok, s, -1).astype(np.int32)
        n_hit = int(ok.sum())
        self.hits += n_hit
        self.misses += int(nodes.size) - n_hit
        return s

    def resident(self, nodes: np.ndarray) -> np.ndarray:
        """Boolean residency mask (no accounting — introspection only)."""
        nodes = np.asarray(nodes, dtype=np.int64)
        if self.capacity == 0:
            return np.zeros(nodes.shape, dtype=bool)
        s = self._slot_of[nodes]
        return (s >= 0) & self._valid[np.maximum(s, 0)]

    # -- invalidation --------------------------------------------------------

    def invalidate(self, nodes: Optional[np.ndarray] = None) -> int:
        """Mark ``nodes`` (or everything) dirty; returns rows actually
        dirtied (duplicates deduplicated, HotNodeCache semantics)."""
        self.invalidations += 1
        if nodes is None:
            n = int(self._valid.sum())
            self._valid[:] = False
            return n
        nodes = np.unique(np.asarray(nodes, dtype=np.int64))
        s = self._slot_of[nodes]
        s = s[s >= 0]
        n = int(self._valid[s].sum())
        self._valid[s] = False
        return n

    # -- accounting ----------------------------------------------------------

    def resident_ids(self) -> np.ndarray:
        """Global node ids of the currently valid rows, ascending.

        This is the cache's *admitted set* — what a serving engine
        persists across restarts so the next process can re-admit the
        same rows instead of starting cold (the row BITS are refetched
        from the store at admission; only the ids survive)."""
        if self.capacity == 0:
            return np.zeros(0, dtype=np.int64)
        return np.sort(self._node_at[self._valid])

    @property
    def resident_rows(self) -> int:
        return int(self._valid.sum())

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
