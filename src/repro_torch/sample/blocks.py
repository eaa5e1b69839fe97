"""Fanout-bounded neighbor sampling: fixed-shape GraphSAGE blocks (copy
of ``repro/sample/blocks.py``; numpy only, so both packages draw the same
blocks from the same ``np.random.Generator`` state).

Host-side CSC sampling in the DGL-GraphBolt mold: for a mini-batch of
seed nodes, draw at most ``fanout`` in-neighbors per node per hop
(without replacement; every neighbor when the degree fits) and emit one
:class:`Block` per layer.  The full-graph path caps graph size at
aggregate device memory — sampling bounds every step's working set at
``batch * (fanout + 1) ** num_layers`` rows regardless of graph size,
which is the door to billion-edge workloads (ROADMAP: "Sampled
mini-batch path").

Everything is **fixed-shape**: capacities depend only on ``(batch,
fanouts)``, never on which seeds arrived or how many neighbors they
had.  The padding contract:

* ``src_ids`` is padded with ``-1`` — the feature gather
  (:meth:`repro_torch.store.TieredFeatures.gather_rows`) materializes
  those rows as zeros.
* ``nbr`` holds **local** row indices into the block's source feature
  table; empty slots point at row ``num_src``, a zero sentinel row the
  aggregation appends (see :func:`repro_torch.core.block_neighbor_sum`),
  and carry ``mask == 0`` so they are doubly inert.

Blocks are returned **outermost hop first** — ``blocks[0]`` consumes
raw features, ``blocks[-1]`` produces the seed embeddings — matching
the layer order of ``repro_torch.core.apply_blocks``.
:func:`block_tree` puts them on a device with, per block, the transposed
index that the gather-sum's backward (K4) reads.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import CSRGraph
from ..kernels.ops import GradIndex

__all__ = [
    "Block",
    "sample_blocks",
    "block_tree",
    "seed_batches",
    "sampled_khop_frontier",
]


@dataclasses.dataclass(frozen=True)
class Block:
    """One hop of a sampled mini-batch (fixed-shape, sentinel-padded).

    ``src_ids``: ``(num_src,)`` int64 global node ids, ``-1`` in unused
    slots.  The first ``num_dst`` entries are the destination ids
    themselves (dst-first ordering), so ``h[:num_dst]`` of the source
    embedding table is exactly the destination embedding table — the
    self-term of GraphSAGE needs no second gather.

    ``nbr``: ``(num_dst, fanout)`` int32 local rows into the source
    table; padding points at row ``num_src`` (the appended zero row).

    ``mask``: ``(num_dst, fanout)`` float32, 1.0 on sampled edges.
    """

    src_ids: np.ndarray
    nbr: np.ndarray
    mask: np.ndarray

    @property
    def num_dst(self) -> int:
        return int(self.nbr.shape[0])

    @property
    def num_src(self) -> int:
        return int(self.src_ids.shape[0])

    @property
    def fanout(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def sentinel(self) -> int:
        """The local index padding slots of ``nbr`` point at."""
        return self.num_src


def _sample_in_neighbors(graph: CSRGraph, dst_ids: np.ndarray, fanout: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Per valid dst (id >= 0), draw ≤ ``fanout`` in-neighbors without
    replacement — all of them when the degree fits.  Returns a
    ``(len(dst_ids), fanout)`` int64 table of global ids, ``-1``-padded.

    Vectorized end to end: one flat gather of every candidate edge (the
    ``neighbors_of`` idiom), a random key per edge, then a segment-wise
    lexsort keeping the ``fanout`` smallest keys per destination.
    """
    nd = int(dst_ids.shape[0])
    out = np.full((nd, fanout), -1, dtype=np.int64)
    if fanout <= 0:
        return out
    valid = np.nonzero(dst_ids >= 0)[0]
    if valid.size == 0:
        return out
    nodes = dst_ids[valid]
    starts = graph.indptr[nodes]
    lens = (graph.indptr[nodes + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return out
    seg_starts = np.cumsum(lens) - lens
    seg = np.repeat(np.arange(valid.size, dtype=np.int64), lens)
    offs = np.arange(total, dtype=np.int64) - np.repeat(seg_starts, lens)
    cand = graph.indices[np.repeat(starts, lens) + offs].astype(np.int64)
    # Uniform keys + stable per-segment sort == a without-replacement
    # draw of min(deg, fanout) neighbors per destination.
    order = np.lexsort((rng.random(total), seg))
    seg_sorted = seg[order]
    pos = np.arange(total, dtype=np.int64) - np.repeat(seg_starts, lens)
    keep = pos < fanout
    out[valid[seg_sorted[keep]], pos[keep]] = cand[order][keep]
    return out


def sample_blocks(graph: CSRGraph, seeds: np.ndarray,
                  fanouts: Sequence[int], *,
                  batch: Optional[int] = None,
                  rng: Optional[np.random.Generator] = None) -> List[Block]:
    """Sample a ``len(fanouts)``-hop block pipeline for ``seeds``.

    ``fanouts`` is listed outermost hop first (layer order), matching
    ``apply_blocks``; ``fanouts[-1]`` bounds the seeds' direct
    in-neighborhood.  ``batch`` fixes the innermost destination
    capacity (defaults to ``len(seeds)``); short seed batches are
    ``-1``-padded up to it so shapes never vary.  Seed order is
    preserved — row ``i`` of the final embedding belongs to
    ``seeds[i]`` — and valid seeds must be unique (labels line up
    positionally and the local index map needs one row per node).
    """
    rng = np.random.default_rng() if rng is None else rng
    seeds = np.asarray(seeds, dtype=np.int64).ravel()
    cap = seeds.size if batch is None else int(batch)
    if seeds.size > cap:
        raise ValueError(f"{seeds.size} seeds exceed batch capacity {cap}")
    live = seeds[seeds >= 0]
    if np.unique(live).size != live.size:
        raise ValueError("seeds must be unique")
    dst = np.full(cap, -1, dtype=np.int64)
    dst[:seeds.size] = seeds

    blocks: List[Block] = []
    for fanout in reversed([int(f) for f in fanouts]):
        nd = int(dst.shape[0])
        ns = nd * (fanout + 1)
        sampled = _sample_in_neighbors(graph, dst, fanout, rng)
        # dst-first source ordering; new sources deduped after the dsts.
        extra = np.setdiff1d(sampled[sampled >= 0], dst[dst >= 0])
        src_ids = np.full(ns, -1, dtype=np.int64)
        src_ids[:nd] = dst
        src_ids[nd:nd + extra.size] = extra
        # Global → local over the valid src rows (ids are unique).
        vpos = np.nonzero(src_ids >= 0)[0]
        vids = src_ids[vpos]
        order = np.argsort(vids, kind="stable")
        sorted_ids, sorted_pos = vids[order], vpos[order]
        nbr = np.full((nd, fanout), ns, dtype=np.int32)
        mask = np.zeros((nd, fanout), dtype=np.float32)
        hit = sampled >= 0
        if hit.any():
            loc = sorted_pos[np.searchsorted(sorted_ids, sampled[hit])]
            nbr[hit] = loc.astype(np.int32)
            mask[hit] = 1.0
        blocks.append(Block(src_ids=src_ids, nbr=nbr, mask=mask))
        dst = src_ids
    blocks.reverse()
    return blocks


def block_tree(blocks: Sequence[Block], device="cpu") -> List[dict]:
    """The blocks' ``nbr`` (int32) and ``mask`` (bool) as tensors on
    ``device``, with ``grad``, the transposed index of each block's
    gather-sum (masked slots sorted by source row, each reading its
    destination row's gradient), built on the host from the numpy block.
    ``src_ids`` stays on the host: it drives the feature gather."""
    out = []
    for b in blocks:
        live = b.mask > 0
        out.append({
            "nbr": torch.from_numpy(b.nbr).to(device),
            "mask": torch.from_numpy(live).to(device),
            "grad": GradIndex.build(b.nbr, live, device=device),
        })
    return out


def seed_batches(ids: np.ndarray, batch: int, *,
                 rng: Optional[np.random.Generator] = None,
                 shuffle: bool = True
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(seeds, valid)`` mini-batches of fixed size ``batch``.

    ``seeds`` is ``-1``-padded int64; ``valid`` is float32 (1.0 on real
    seeds) for masking the loss over padded rows.
    """
    ids = np.asarray(ids, dtype=np.int64).ravel()
    if shuffle:
        ids = (np.random.default_rng() if rng is None else rng).permutation(ids)
    for lo in range(0, ids.size, batch):
        part = ids[lo:lo + batch]
        seeds = np.full(batch, -1, dtype=np.int64)
        seeds[:part.size] = part
        valid = (seeds >= 0).astype(np.float32)
        yield seeds, valid


def sampled_khop_frontier(graph: CSRGraph, seeds: np.ndarray,
                          fanouts: Sequence[int], *,
                          rng: Optional[np.random.Generator] = None
                          ) -> np.ndarray:
    """Fanout-bounded receptive field of ``seeds`` — the sampled
    counterpart of :func:`repro.core.khop_in_frontier`.

    Returns sorted unique global ids (seeds included); always a subset
    of the exact k-hop frontier, with size bounded by
    ``len(seeds) * prod(fanout + 1)`` independent of graph degree.
    """
    blocks = sample_blocks(graph, seeds, fanouts, rng=rng)
    ids = blocks[0].src_ids if blocks else np.asarray(seeds, dtype=np.int64)
    return np.unique(ids[ids >= 0])
