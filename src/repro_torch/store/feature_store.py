"""Host-side tier of the tiered feature path: the full node-feature table.

MGG keeps node embeddings in a PGAS heap spanning all GPUs; the UVM
baseline it beats (§2.2) instead leaves them in host memory and migrates
4 KB pages on demand.  The tiered path here takes a third position —
features live on the host in a *row-gather* store (this class) and only
a bounded hot set is device-resident (:class:`~repro.store.HotFeatureCache`)
— so the repro can serve graphs whose feature table does not fit on
device while still streaming at row granularity, not page granularity.

Copy of ``repro/store/feature_store.py``.  On the card the host tier is
*pinned* (page-locked) memory when asked for (``pin=True``): the table is
one page-locked tensor, ``x`` its numpy view, and :meth:`upload` gathers
rows into a page-locked staging buffer and copies it to the device
without blocking the host.  The accounting (rows/bytes gathered) is
exact either way.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["FeatureStore"]


class FeatureStore:
    """Full ``(num_nodes, d_feat)`` feature table in host memory.

    The store is the single source of truth for feature values: the
    device hot cache and every assembled tile are derived from it, and
    :meth:`update_row` bumps a monotone version counter that
    :class:`~repro.store.TieredFeatures` uses to invalidate derived rows.
    """

    def __init__(self, features: np.ndarray, copy: bool = True,
                 pin: bool = False):
        x = np.array(features, dtype=np.float32, order="C", copy=copy)
        if x.ndim != 2:
            raise ValueError(f"features must be (num_nodes, d_feat), "
                             f"got shape {x.shape}")
        self._pinned = None
        if pin:   # one page-locked table; x is its numpy view
            self._pinned = torch.from_numpy(x).pin_memory()
            x = self._pinned.numpy()
        self.x = x
        self.version = 0          # bumped on every row update
        # gather accounting: the host→device traffic model reads these
        self.gathers = 0          # gather() calls
        self.rows_gathered = 0    # total rows returned across calls
        self.updates = 0

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def d_feat(self) -> int:
        return int(self.x.shape[1])

    @property
    def itemsize(self) -> int:
        return int(self.x.itemsize)

    @property
    def bytes_gathered(self) -> int:
        return self.rows_gathered * self.d_feat * self.itemsize

    def gather(self, node_ids: Union[np.ndarray, Sequence[int]]) -> np.ndarray:
        """Row-gather ``x[node_ids]`` as a fresh contiguous buffer.

        The copy is deliberate: a contiguous buffer is the transfer-ready
        shape.  Counts toward the gather accounting even when ``node_ids`` is
        empty — an issued transfer of zero rows is still an issue slot in
        the prefetch pipeline.
        """
        ids = np.asarray(node_ids, dtype=np.int64).ravel()
        self.gathers += 1
        self.rows_gathered += int(ids.size)
        return np.ascontiguousarray(self.x[ids])

    def upload(self, node_ids, device, pad_rows: int = 0) -> torch.Tensor:
        """``x[node_ids]`` on ``device`` with ``pad_rows`` zero rows after
        it, counted as one :meth:`gather`.  From a pinned table to the card
        the rows are gathered into a page-locked buffer and copied without
        blocking the host (ordered on the current stream)."""
        ids = np.asarray(node_ids, dtype=np.int64).ravel()
        self.gathers += 1
        self.rows_gathered += int(ids.size)
        device = torch.device(device)
        if self._pinned is not None and device.type == "cuda":
            buf = torch.empty((ids.size + pad_rows, self.d_feat),
                              dtype=torch.float32, pin_memory=True)
            torch.index_select(self._pinned, 0, torch.from_numpy(ids),
                               out=buf[:ids.size])
            buf[ids.size:] = 0.0
            return buf.to(device, non_blocking=True)
        rows = np.zeros((ids.size + pad_rows, self.d_feat), np.float32)
        rows[:ids.size] = self.x[ids]
        return torch.from_numpy(rows).to(device)

    def row(self, node: int) -> np.ndarray:
        """One row, copied (callers must not alias the store)."""
        return self.x[int(node)].copy()

    def update_row(self, node: int, value: np.ndarray) -> None:
        """In-place feature update at ``node`` (live feature refresh)."""
        v = np.asarray(value, dtype=np.float32)
        if v.shape != (self.d_feat,):
            raise ValueError(f"expected shape ({self.d_feat},), got {v.shape}")
        self.x[int(node)] = v
        self.version += 1
        self.updates += 1
