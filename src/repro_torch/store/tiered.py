"""TieredFeatures: the host store + the device hot cache as one row source
(counterpart of ``repro/store/tiered.py``, planless mode).

The sampled mini-batch path (:mod:`repro_torch.sample`) calls
:meth:`TieredFeatures.gather_rows` with each block's ``src_ids``:
Zipfian-head rows come off the device hot cache, tail rows ride one host
gather and upload, and the device assembles the ``(rows, d_feat)`` table
with two row gathers (K5, :func:`repro_torch.kernels.ops.gather_rows`)
and a per-row select — each output row one source row verbatim, so the
result is bitwise ``x[ids]`` at any capacity, 0 included.

The reference pads the cold upload to a power-of-two row count so that
JAX does not compile a new gather per miss count; PyTorch runs eagerly,
so the port uploads exactly the missed rows plus one zero row (the
source of the padding rows).  The plan-bound chunk assembly
(``set_plan``, ``device_chunk``, ``padded_table``) and the streamed ring
arrive with the tiered-serving slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..dist.ring import resolve_device
from ..kernels import ops
from ..obs import MetricsRegistry
from .feature_store import FeatureStore
from .hotfeatures import HotFeatureCache

__all__ = ["TieredFeatures"]


class TieredFeatures:
    """Tiered (host store + device hot cache) row source on one device."""

    def __init__(self, store: FeatureStore, plan, capacity: int, *,
                 device="cuda",
                 metrics: Optional[MetricsRegistry] = None,
                 labels: Optional[dict] = None):
        if plan is not None:
            raise NotImplementedError(
                "plan-bound chunk assembly arrives with the tiered-serving "
                "slice of the port; pass plan=None")
        self.store = store
        self.plan = None
        self.device = resolve_device(device)
        self.cache = HotFeatureCache(store.num_nodes, capacity, store.d_feat,
                                     device=self.device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.labels = dict(labels or {})
        self._c_host_rows = self.metrics.counter(
            "store.host_rows_streamed", **self.labels)
        self._c_host_bytes = self.metrics.counter(
            "store.host_bytes_streamed", **self.labels)
        self._c_cache_rows = self.metrics.counter(
            "store.cache_rows_served", **self.labels)
        self._c_assemblies = self.metrics.counter(
            "store.assemblies", **self.labels)

    @property
    def host_rows_streamed(self) -> int:
        """Cold rows uploaded during assembly (host → device misses)."""
        return self._c_host_rows.value

    @property
    def cache_rows_served(self) -> int:
        """Rows sourced from the device tier (hits)."""
        return self._c_cache_rows.value

    @property
    def assemblies(self) -> int:
        return self._c_assemblies.value

    @property
    def capacity(self) -> int:
        return self.cache.capacity

    @property
    def resident_fraction(self) -> float:
        return self.cache.resident_rows / max(1, self.store.num_nodes)

    # -- admission / updates -------------------------------------------------

    def admit(self, hot_nodes: Sequence[int]) -> int:
        """Refresh the device tier from a hottest-first node list."""
        return self.cache.admit(hot_nodes, self.store)

    def resize(self, capacity: int) -> None:
        """Adopt a new capacity; the cache restarts cold."""
        if capacity == self.cache.capacity:
            return
        self.cache = HotFeatureCache(self.store.num_nodes, capacity,
                                     self.store.d_feat, device=self.device)

    def update(self, node: int, value: np.ndarray) -> None:
        """Live feature update: the store is the source of truth, and the
        derived device row (if resident) is invalidated so no later
        assembly can serve the stale bits."""
        self.store.update_row(node, value)
        self.cache.invalidate(np.array([node], dtype=np.int64))

    # -- assembly ------------------------------------------------------------

    def _source(self, ids: np.ndarray):
        """Split one row set into hot (cache slot) and cold rows."""
        if self.cache.capacity:
            slots = self.cache.slots(ids)
        else:
            slots = np.full(ids.shape, -1, dtype=np.int32)
        hot = slots >= 0
        cold = int((~hot).sum())
        self._c_host_rows.inc(cold)
        self._c_host_bytes.inc(cold * self.store.d_feat
                               * self.store.itemsize)
        self._c_cache_rows.inc(int(hot.sum()))
        return hot, slots

    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _assemble(self, rows: int, ids: np.ndarray,
                  pos: np.ndarray) -> torch.Tensor:
        """The ``(rows, d_feat)`` device table holding ``ids``'s rows at
        ``pos`` and zeros elsewhere, as two row gathers and a select:
        host-built selector tables name, for every output row, its source
        row in the uploaded cold batch (whose trailing zero row is the
        padding source) or in the hot-cache table."""
        hot, slots = self._source(ids)
        cold = ~hot
        n_cold = int(cold.sum())
        cold_up = self.store.upload(ids[cold], self.device, pad_rows=1)
        cold_sel = np.full(rows, n_cold, np.int32)   # default: the zero row
        cold_sel[pos[cold]] = np.arange(n_cold, dtype=np.int32)
        out = ops.gather_rows(cold_up, self._index(cold_sel))
        if hot.any():
            hot_sel = np.zeros(rows, np.int32)
            hot_sel[pos[hot]] = slots[hot]
            hot_mask = np.zeros(rows, bool)
            hot_mask[pos[hot]] = True
            out = torch.where(self._index(hot_mask)[:, None],
                              ops.gather_rows(self.cache.table,
                                              self._index(hot_sel)),
                              out)
        self._c_assemblies.inc()
        return out

    def gather_rows(self, ids, rows: Optional[int] = None) -> torch.Tensor:
        """Assemble an arbitrary row set — the sampled path's source tables
        (``Block.src_ids``).  ``ids[i] < 0`` (the sampler's padding) yields
        a zero row, as do rows beyond ``len(ids)`` when ``rows``
        over-allocates; bitwise ``x[ids]`` at any capacity."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        n = ids.shape[0] if rows is None else int(rows)
        if n < ids.shape[0]:
            raise ValueError(f"rows={n} cannot hold {ids.shape[0]} ids")
        pos = np.nonzero(ids >= 0)[0]
        live = ids[pos]
        if live.size and int(live.max()) >= self.store.num_nodes:
            raise ValueError(
                f"node id {int(live.max())} out of range for store of "
                f"{self.store.num_nodes} rows")
        return self._assemble(n, live, pos.astype(np.int32))

    # -- accounting ----------------------------------------------------------

    def report(self) -> dict:
        return dict(
            capacity=self.capacity,
            resident_rows=self.cache.resident_rows,
            resident_fraction=self.resident_fraction,
            hit_rate=self.cache.hit_rate,
            host_rows_streamed=self._c_host_rows.value,
            host_bytes_streamed=self._c_host_bytes.value,
            cache_rows_served=self._c_cache_rows.value,
            admissions=self.cache.admissions,
            evictions=self.cache.evictions,
            store_updates=self.store.updates,
        )
