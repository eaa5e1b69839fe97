"""TieredFeatures: the host store + the device hot cache bound to a padded
layout (counterpart of ``repro/store/tiered.py``).

Given an :class:`~repro_torch.core.placement.AggregationPlan`, it
assembles device *chunks* — one ring tile a virtual shard — sourcing each
row from the device hot cache when resident and from the host
:class:`~repro_torch.store.FeatureStore` otherwise.  Three consumers:

* :func:`repro_torch.core.pipeline.mgg_aggregate_streamed` pulls chunks
  one at a time through :meth:`chunk_fetcher`: it enqueues chunk ``c``'s
  ring and then calls back here for chunk ``c + 1``, whose host gather
  and upload run while that ring is in flight;
* the serving engine's full pass calls :meth:`padded_table` for the whole
  padded table, assembled transiently and dropped after the pass;
* the sampled mini-batch path (:mod:`repro_torch.sample`) calls
  :meth:`gather_rows` with each block's ``src_ids`` (``plan=None`` builds
  this planless view).

The device assembles a table with two row gathers (K5,
:func:`repro_torch.kernels.ops.gather_rows`) and a per-row select over
host-built selector tables — each output row one source row verbatim,
padding rows zero — so every assembly is bitwise
:func:`~repro_torch.core.placement.pad_embeddings` (or ``x[ids]``) at any
capacity, 0 included.  One card holds every virtual shard, so a chunk or
table is one tensor on ``device`` (the reference's ``shard`` callable has
no counterpart).

On the card the uploads (the cold rows, gathered into page-locked memory,
and the selector tables) run on a copy stream of their own, allocated
there so the caching allocator knows the stream that writes them; the
current stream waits on the copy's event before K5 reads it.  So an
upload never queues behind the ring kernels already enqueued, and nothing
in an assembly waits for the device.  ``copy_log`` (a list, off by
default) collects each upload's timing events and bytes.

The reference pads the cold upload to a power-of-two row count so that
JAX does not compile a new gather per miss count; PyTorch runs eagerly,
so the port uploads exactly the missed rows plus one zero row (the
source of the padding rows).  Feature rows are keyed by global node id,
so a tuner move that changes the plan (:meth:`set_plan`) keeps every
cached row valid.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.placement import AggregationPlan
from ..dist.ring import resolve_device
from ..kernels import ops
from ..obs import MetricsRegistry
from .feature_store import FeatureStore
from .hotfeatures import HotFeatureCache

__all__ = ["TieredFeatures"]


class TieredFeatures:
    """Tiered (host store + device hot cache) view of one padded layout."""

    def __init__(self, store: FeatureStore, plan: Optional[AggregationPlan],
                 capacity: int, *, device="cuda",
                 metrics: Optional[MetricsRegistry] = None,
                 labels: Optional[dict] = None):
        self.store = store
        self.device = resolve_device(device)
        self.cache = HotFeatureCache(store.num_nodes, capacity, store.d_feat,
                                     device=self.device)
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self.copy_log: Optional[list] = None
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
        # plan=None: the sampled path's planless view (gather_rows only)
        self.plan = None
        self._chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        if plan is not None:
            self.set_plan(plan)

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

    # -- layout --------------------------------------------------------------

    def set_plan(self, plan: AggregationPlan) -> None:
        """(Re)bind to a padded layout.  Cached rows stay valid (the cache
        key is the global node id), so a tuner move only recomputes the
        chunk maps."""
        if plan.bounds[-1] != self.store.num_nodes:
            raise ValueError(
                f"plan covers {int(plan.bounds[-1])} nodes, store holds "
                f"{self.store.num_nodes}")
        self.plan = plan
        counts = plan.node_counts
        tile, rows = plan.tile_rows, plan.rows_per_dev
        # per chunk c: (global node ids, offsets into the (n_dev·tile) chunk
        # buffer, offsets into the (n_dev·rows) padded table)
        self._chunks = []
        for c in range(plan.dist):
            ids, pos, fpos = [], [], []
            for d in range(plan.n_dev):
                lo, hi = c * tile, min((c + 1) * tile, int(counts[d]))
                if hi > lo:
                    o = np.arange(lo, hi, dtype=np.int64)
                    ids.append(int(plan.bounds[d]) + o)
                    pos.append(d * tile + (o - lo))
                    fpos.append(d * rows + o)
            cat = lambda a: (np.concatenate(a) if a
                             else np.zeros(0, dtype=np.int64))
            self._chunks.append((cat(ids), cat(pos).astype(np.int32),
                                 cat(fpos).astype(np.int32)))

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

    def _upload(self, cold_ids: np.ndarray, tables):
        """The cold rows (plus one zero row) and the selector ``tables`` on
        the device.  On the card they are copied on the copy stream, which
        the current stream then waits on: the copy never queues behind
        work already enqueued, and the host never waits for the device."""
        if self._copy is None:
            return (self.store.upload(cold_ids, self.device, pad_rows=1),
                    *(torch.from_numpy(a).to(self.device) for a in tables))
        log = self.copy_log is not None
        with torch.cuda.stream(self._copy):
            if log:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            up = (self.store.upload(cold_ids, self.device, pad_rows=1),
                  *(torch.from_numpy(a).pin_memory().to(self.device,
                                                         non_blocking=True)
                    for a in tables))
            done = torch.cuda.Event(enable_timing=log)
            done.record()
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(done)
        for t in up:     # read on the current stream: freed after its use
            t.record_stream(cur)
        if log:
            self.copy_log.append(dict(start=start, end=done, bytes=sum(
                t.numel() * t.element_size() for t in up)))
        return up

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
        cold_sel = np.full(rows, n_cold, np.int32)   # default: the zero row
        cold_sel[pos[cold]] = np.arange(n_cold, dtype=np.int32)
        tables = [cold_sel]
        if hot.any():
            hot_sel = np.zeros(rows, np.int32)
            hot_sel[pos[hot]] = slots[hot]
            hot_mask = np.zeros(rows, bool)
            hot_mask[pos[hot]] = True
            tables += [hot_sel, hot_mask]
        cold_up, *sel = self._upload(ids[cold], tables)
        out = ops.gather_rows(cold_up, sel[0])
        if hot.any():
            out = torch.where(sel[2][:, None],
                              ops.gather_rows(self.cache.table, sel[1]), out)
        self._c_assemblies.inc()
        return out

    def _bound(self) -> AggregationPlan:
        if self.plan is None:
            raise ValueError("TieredFeatures built without a plan — only "
                             "gather_rows() is available")
        return self.plan

    def device_chunk(self, c: int) -> torch.Tensor:
        """Assemble ring chunk ``c``: the ``(n_dev · tile_rows, d_feat)``
        table holding every shard's chunk-``c`` tile."""
        plan = self._bound()
        ids, pos, _ = self._chunks[c]
        return self._assemble(plan.n_dev * plan.tile_rows, ids, pos)

    def chunk_fetcher(self) -> Callable[[int], torch.Tensor]:
        """The ``fetch_chunk`` callable of
        :func:`~repro_torch.core.pipeline.mgg_aggregate_streamed`."""
        return self.device_chunk

    def padded_table(self) -> torch.Tensor:
        """The whole padded table as ONE assembly over every chunk's rows
        (the chunk maps are disjoint and cover every real row; everything
        else is padding, served by the zero row).  Transient: callers
        drop it after the pass."""
        plan = self._bound()
        ids = np.concatenate([c[0] for c in self._chunks])
        fpos = np.concatenate([c[2] for c in self._chunks])
        return self._assemble(plan.padded_nodes, ids, fpos)

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
