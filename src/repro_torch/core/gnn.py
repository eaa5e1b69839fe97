"""Full-graph GNNs on the MGG ring (counterpart of ``repro/core/gnn.py``).

* **GCN** (Kipf & Welling), the paper's setting of 2 layers and 16 hidden
  dims: ``Z = Â · relu(Â X W¹) W²`` with ``Â = D^{-1/2}(A+I)D^{-1/2}``;
* **GIN** (Xu et al.), 5 layers and 64 hidden dims:
  ``h' = MLP((1+ε)h + Σ_{u∈N(v)} h_u)``;
* **GraphSAGE**-mean, and **GAT** (v1) as two sum-aggregations a head.

The sparse products run through
:func:`repro_torch.core.pipeline.mgg_aggregate`, which autograd follows
(its backward is the transposed ring); the dense ``·W`` updates are plain
matmuls, in full fp32 (an engine on the card turns TF32 off for CUDA
matmuls, forward and backward), unless a layer's plan fuses them into the
ring.  Normalizations are folded into per-node scalings so the kernel
stays a pure masked gather-sum.  :func:`sage_apply_blocks` is GraphSAGE
over sampled blocks (:mod:`repro_torch.sample`), and
:func:`masked_cross_entropy` the training loss.

Parameters are plain dicts and lists of tensors, shaped as the
reference's pytrees (``{"layers": [{"w", "b"}, ...]}`` for GCN);
:func:`params_from_numpy` carries any of them over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..dist.ring import VirtualRing
from .graph import CSRGraph
from .placement import (AggregationPlan, LayerPlan, SharedPartition,
                        build_layer_plans, build_partition, pad_embeddings,
                        pad_table)
from .pipeline import (RingArrays, block_neighbor_sum, mgg_aggregate,
                       mgg_aggregate_sparse, mgg_aggregate_sparse_streamed,
                       mgg_aggregate_streamed, plan_device_arrays)

__all__ = ["GNNEngine", "gcn_init", "gcn_stage", "gcn_apply", "gin_init",
           "gin_stage", "gin_apply", "sage_init", "sage_stage", "sage_apply",
           "gat_init", "gat_stage", "gat_apply", "sage_apply_blocks",
           "apply_blocks", "BLOCK_MODELS", "masked_cross_entropy",
           "params_from_numpy", "MODEL_ZOO", "MODEL_STAGES", "num_stages",
           "apply_stage", "apply_from_stage", "aggregation_widths"]


@dataclasses.dataclass
class GNNEngine:
    """Graph partitioning state + the pipelined aggregation op.

    The engine holds one :class:`~repro_torch.core.placement.LayerPlan` a
    GNN layer, all derived from one shared graph partition: layers may run
    different ``(ps, dist, pb)`` schedules over one padded embedding
    layout, so activations flow between layers without re-padding.  A
    single-config engine is the case of one LayerPlan serving every layer.
    ``ring_arrays[i]`` is layer ``i``'s plan bound to the card; layers
    whose ``(ps, dist)`` coincide share one plan object and one
    :class:`RingArrays` (built once, at :meth:`build`).  ``topk`` sends
    the hidden layers' aggregations over the top-k compressed ring
    (:meth:`stage_topk`).  ``use_kernel=False`` (set on a built engine,
    e.g. with ``dataclasses.replace``) runs the plain versions on any
    device — the reference's oracle path, used to check the kernels end
    to end.
    """

    layer_plans: List[LayerPlan]
    ring: VirtualRing
    ring_arrays: List[RingArrays]
    deg: torch.Tensor                    # padded (N_pad,) float32, deg of A+I
    use_kernel: bool = True
    partition: Optional[SharedPartition] = None
    # the streamed ring's arrays (interleave=False) a plan, built on first
    # use and shared with every replace()d copy of this engine
    streamed: Dict[int, tuple] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @staticmethod
    def build(
        graph: CSRGraph,
        ring: VirtualRing,
        *,
        ps: int = 16,
        dist: int = 1,
        pb: Optional[int] = None,
        interleave: bool = True,
        fuse_update: bool = False,
        topk: Optional[int] = None,
        layer_configs: Optional[Sequence[Dict]] = None,
        partition: Optional[SharedPartition] = None,
    ) -> "GNNEngine":
        """Build an engine on ``ring``; GCN's ``Â`` takes ``graph`` with
        self-loops.  ``layer_configs`` (one ``{ps, dist, pb, ...}`` dict a
        layer) selects per-layer plans, otherwise the one ``(ps, dist,
        pb)`` plan serves every layer.  ``partition`` reuses a
        :class:`SharedPartition` built for this graph (with self-loops) and
        this ring's shard count — the dynamic runtime passes it so tuner
        moves re-derive schedules without re-partitioning.  ``topk``
        compresses the hidden layers' ring payloads to their ``k`` largest
        entries a row."""
        if ring.device.type == "cuda":
            # the dense ·W updates, forward and backward, must agree with
            # the reference to fp32 rounding: CUDA matmuls run in full
            # fp32, not TF32
            torch.backends.cuda.matmul.allow_tf32 = False
        g = graph.with_self_loops()
        if layer_configs is None:
            layer_configs = [dict(ps=ps, dist=dist, pb=pb)]
        part = partition if partition is not None \
            else build_partition(g, ring.n_dev)
        plans = build_layer_plans(g, ring.n_dev, layer_configs,
                                  partition=part, interleave=interleave,
                                  fuse_update=fuse_update, topk=topk)
        bound: Dict[tuple, RingArrays] = {}
        for lp in plans:   # one RingArrays per distinct plan object
            key = (id(lp.plan), lp.interleave)
            if key not in bound:
                bound[key] = plan_device_arrays(
                    lp.plan, interleave=lp.interleave, device=ring.device)
        arrays = [bound[(id(lp.plan), lp.interleave)] for lp in plans]
        plan0 = plans[0].plan
        deg = pad_table(plan0.bounds, plan0.rows_per_dev,
                        g.degrees.astype(np.float32)[:, None])[:, 0]
        return GNNEngine(
            layer_plans=plans, ring=ring, ring_arrays=arrays,
            deg=torch.from_numpy(np.maximum(deg, 1.0)).to(ring.device),
            partition=part,
        )

    # -- layer plan access ---------------------------------------------------

    def layer_plan(self, layer: int) -> LayerPlan:
        """The plan driving stage ``layer`` (clamped to the last layer)."""
        return self.layer_plans[min(layer, len(self.layer_plans) - 1)]

    @property
    def plan(self) -> AggregationPlan:
        """Layer 0's schedule; every layer shares its PGAS layout."""
        return self.layer_plans[0].plan

    @property
    def device(self) -> torch.device:
        return self.ring.device

    @property
    def per_layer(self) -> bool:
        return len(self.layer_plans) > 1

    @property
    def pb(self) -> Optional[int]:
        return self.layer_plans[0].pb

    @property
    def config(self) -> Dict[str, int]:
        """Layer 0's (ps, dist, pb) — THE knob set of a single-config
        engine; per-layer engines expose ``layer_configs``."""
        return self.layer_plans[0].config

    @property
    def layer_configs(self) -> List[Dict[str, int]]:
        return [lp.config for lp in self.layer_plans]

    # -- layout --------------------------------------------------------------

    def pad(self, x: np.ndarray) -> np.ndarray:
        return pad_embeddings(self.plan, x)

    def shard(self, x) -> torch.Tensor:
        """Place a padded table on the ring's card: the virtual shards are
        row ranges of this one tensor."""
        return torch.as_tensor(x).to(self.device)

    def stage_topk(self, layer: int) -> Optional[int]:
        """Top-k compression of aggregation stage ``layer``: hidden layers
        only — the input layer's features always ride the dense ring."""
        return self.layer_plan(layer).topk if layer >= 1 else None

    # -- aggregation ---------------------------------------------------------

    def aggregate(self, x: torch.Tensor, layer: int = 0,
                  update_w: Optional[torch.Tensor] = None,
                  topk: Optional[int] = None) -> torch.Tensor:
        lp = self.layer_plan(layer)
        arrays = self.ring_arrays[min(layer, len(self.ring_arrays) - 1)]
        if topk:
            return mgg_aggregate_sparse(
                x, lp.plan, self.ring, k=int(topk),
                interleave=lp.interleave, use_kernel=self.use_kernel,
                update_w=update_w, arrays=arrays)
        return mgg_aggregate(
            x, lp.plan, self.ring,
            interleave=lp.interleave,
            use_kernel=self.use_kernel,
            pb=lp.pb,
            update_w=update_w,
            arrays=arrays,
        )

    def aggregate_update(self, x: torch.Tensor, w: torch.Tensor,
                         layer: int = 0,
                         topk: Optional[int] = None) -> torch.Tensor:
        """Fused ``(A x) @ W``: the update matmul runs inside the ring."""
        return self.aggregate(x, layer=layer, update_w=w, topk=topk)

    def stream_arrays(self, layer: int = 0) -> RingArrays:
        """Layer ``layer``'s plan bound for the streamed ring
        (``interleave=False``): built once a plan, reusing the remote steps
        of :attr:`ring_arrays`, so only the local group is new."""
        arrays = self.ring_arrays[min(layer, len(self.ring_arrays) - 1)]
        if not arrays.interleave:
            return arrays
        hit = self.streamed.get(id(arrays))
        if hit is None or hit[0] is not arrays:
            hit = (arrays, plan_device_arrays(
                self.layer_plan(layer).plan, interleave=False,
                device=self.device, remote_steps=arrays.remote_steps))
            self.streamed[id(arrays)] = hit
        return hit[1]

    def aggregate_streamed(self, tiered, layer: int = 0,
                           update_w: Optional[torch.Tensor] = None,
                           topk: Optional[int] = None,
                           stats: Optional[Dict] = None,
                           tracer=None) -> torch.Tensor:
        """Partly resident aggregation: chunks are pulled on demand from a
        :class:`repro_torch.store.TieredFeatures` (host store + device hot
        cache), each chunk's host gather and upload running while the
        previous chunk's ring is in flight — see
        :func:`repro_torch.core.pipeline.mgg_aggregate_streamed`.  ``topk``
        compresses each landed chunk, so the rings carry the sparse
        payload.  Rebinds ``tiered`` when it holds another plan."""
        lp = self.layer_plan(layer)
        if tiered.plan is not lp.plan:
            tiered.set_plan(lp.plan)
        kw = dict(use_kernel=self.use_kernel, update_w=update_w,
                  arrays=self.stream_arrays(layer), stats=stats,
                  tracer=tracer)
        if topk:
            return mgg_aggregate_sparse_streamed(
                tiered.chunk_fetcher(), lp.plan, self.ring, k=int(topk), **kw)
        return mgg_aggregate_streamed(tiered.chunk_fetcher(), lp.plan,
                                      self.ring, pb=lp.pb, **kw)

    def _dinv(self, x: torch.Tensor) -> torch.Tensor:
        return torch.rsqrt(self.deg)[:, None].to(x.dtype)

    def gcn_norm_aggregate(self, x: torch.Tensor, layer: int = 0,
                           topk: Optional[int] = None) -> torch.Tensor:
        """Â x with Â = D^{-1/2}(A+I)D^{-1/2} (self-loops already in plan)."""
        dinv = self._dinv(x)
        return self.aggregate(x * dinv, layer=layer, topk=topk) * dinv

    def gcn_norm_aggregate_update(self, x: torch.Tensor, w: torch.Tensor,
                                  layer: int = 0,
                                  topk: Optional[int] = None) -> torch.Tensor:
        """Fused ``(Â x) @ W``: the left diagonal scaling commutes with the
        right matmul, so ``D^{-1/2}((A (D^{-1/2} x)) W)`` is exact."""
        dinv = self._dinv(x)
        return self.aggregate_update(x * dinv, w, layer=layer,
                                     topk=topk) * dinv

    def mean_aggregate(self, x: torch.Tensor, layer: int = 0,
                       topk: Optional[int] = None) -> torch.Tensor:
        return self.aggregate(x, layer=layer, topk=topk) \
            / self.deg[:, None].to(x.dtype)

    def mean_aggregate_update(self, x: torch.Tensor, w: torch.Tensor,
                              layer: int = 0,
                              topk: Optional[int] = None) -> torch.Tensor:
        """Fused ``(D^{-1} A x) @ W`` (same commutation as gcn_norm)."""
        return self.aggregate_update(x, w, layer=layer, topk=topk) \
            / self.deg[:, None].to(x.dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, fan_in: int, fan_out: int,
                device) -> Dict[str, torch.Tensor]:
    w = torch.randn((fan_in, fan_out), generator=gen, dtype=torch.float32)
    w = w * float(np.sqrt(2.0 / (fan_in + fan_out)))
    return dict(w=w.to(device), b=torch.zeros(fan_out, device=device))


def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def gcn_init(gen: torch.Generator, in_dim: int, num_classes: int,
             hidden: int = 16, num_layers: int = 2,
             device="cpu") -> Dict:
    """Paper setting: 2 layers, 16 hidden dims; weights ~ N(0, 2/(in+out))
    as the reference draws them (different bits: another generator)."""
    dims = [in_dim] + [hidden] * (num_layers - 1) + [num_classes]
    return dict(layers=[_dense_init(gen, dims[i], dims[i + 1], device)
                        for i in range(num_layers)])


def params_from_numpy(params, device):
    """A parameter pytree of arrays (dicts, lists, numpy or array-likes)
    → the same structure of float32 tensors on ``device``."""
    if isinstance(params, dict):
        return {k: params_from_numpy(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_from_numpy(v, device) for v in params]
    return torch.tensor(np.asarray(params, dtype=np.float32), device=device)


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

def gcn_stage(params: Dict, engine: GNNEngine, h: torch.Tensor,
              i: int) -> torch.Tensor:
    """Layer ``i`` of the GCN: one aggregation + dense update (+ relu).

    Fused (update inside the ring), else transform-first when it shrinks
    the width (``D_in ≥ D_out``), else aggregate-first — the reference's
    three dataflows, with the bias after aggregation in all three.
    """
    n = len(params["layers"])
    layer = params["layers"][i]
    d_in, d_out = layer["w"].shape
    tk = engine.stage_topk(i)  # hidden layers may ride the sparse ring
    if engine.layer_plan(i).fuse_update:
        h = engine.gcn_norm_aggregate_update(h, layer["w"], layer=i,
                                             topk=tk) + layer["b"]
    elif d_in >= d_out:
        h = engine.gcn_norm_aggregate(h @ layer["w"], layer=i, topk=tk) \
            + layer["b"]
    else:
        h = _dense(layer, engine.gcn_norm_aggregate(h, layer=i, topk=tk))
    if i < n - 1:
        h = torch.relu(h)
    return h


def gcn_apply(params: Dict, engine: GNNEngine,
              x: torch.Tensor) -> torch.Tensor:
    """Z = Â relu(... Â relu(Â X W¹) ...) Wᴸ (logits)."""
    h = x
    for i in range(len(params["layers"])):
        h = gcn_stage(params, engine, h, i)
    return h


# ---------------------------------------------------------------------------
# GIN
# ---------------------------------------------------------------------------

def gin_init(gen: torch.Generator, in_dim: int, num_classes: int,
             hidden: int = 64, num_layers: int = 5, device="cpu") -> Dict:
    """Paper setting: 5 layers, 64 hidden dims; a 2-layer MLP per layer
    and a scalar ``eps`` (0 at init)."""
    dims = [in_dim] + [hidden] * num_layers
    layers = [dict(eps=torch.zeros((), device=device),
                   mlp1=_dense_init(gen, dims[i], hidden, device),
                   mlp2=_dense_init(gen, hidden, hidden, device))
              for i in range(num_layers)]
    return dict(layers=layers,
                head=_dense_init(gen, hidden, num_classes, device))


def gin_stage(params: Dict, engine: GNNEngine, h: torch.Tensor,
              i: int) -> torch.Tensor:
    """GIN stage ``i``: layers 0..L-1 are GIN layers, stage L is the head.

    Fused: ``((A h) + ε h) W₁ = (A h) W₁ + ε (h W₁)`` — the aggregate's
    ·W₁ runs inside the ring, the ε-scaled self term is a local matmul.
    """
    if i == len(params["layers"]):
        return _dense(params["head"], h)
    layer = params["layers"][i]
    tk = engine.stage_topk(i)  # sparse ring for hidden layers; self term dense
    if engine.layer_plan(i).fuse_update:
        z = engine.aggregate_update(h, layer["mlp1"]["w"], layer=i, topk=tk) \
            + layer["eps"] * (h @ layer["mlp1"]["w"]) + layer["mlp1"]["b"]
        z = torch.relu(z)
    else:
        # (1+ε)h + Σ_{u∈N(v)} h_u: the plan's self-loop gives the 1·h
        z = engine.aggregate(h, layer=i, topk=tk) + layer["eps"] * h
        z = torch.relu(_dense(layer["mlp1"], z))
    return torch.relu(_dense(layer["mlp2"], z))


def gin_apply(params: Dict, engine: GNNEngine,
              x: torch.Tensor) -> torch.Tensor:
    h = x
    for i in range(len(params["layers"]) + 1):
        h = gin_stage(params, engine, h, i)
    return h


# ---------------------------------------------------------------------------
# GraphSAGE-mean
# ---------------------------------------------------------------------------

def sage_init(gen: torch.Generator, in_dim: int, num_classes: int,
              hidden: int = 32, num_layers: int = 2, device="cpu") -> Dict:
    dims = [in_dim] + [hidden] * (num_layers - 1) + [num_classes]
    return dict(layers=[
        dict(self=_dense_init(gen, dims[i], dims[i + 1], device),
             nbr=_dense_init(gen, dims[i], dims[i + 1], device))
        for i in range(num_layers)])


def sage_stage(params: Dict, engine: GNNEngine, h: torch.Tensor,
               i: int) -> torch.Tensor:
    layer = params["layers"][i]
    tk = engine.stage_topk(i)  # sparse ring for hidden layers; self path dense
    if engine.layer_plan(i).fuse_update:
        nbr = engine.mean_aggregate_update(h, layer["nbr"]["w"], layer=i,
                                           topk=tk) + layer["nbr"]["b"]
    else:
        nbr = _dense(layer["nbr"], engine.mean_aggregate(h, layer=i,
                                                         topk=tk))
    h = _dense(layer["self"], h) + nbr
    if i < len(params["layers"]) - 1:
        h = torch.relu(h)
    return h


def sage_apply(params: Dict, engine: GNNEngine,
               x: torch.Tensor) -> torch.Tensor:
    h = x
    for i in range(len(params["layers"])):
        h = sage_stage(params, engine, h, i)
    return h


def sage_apply_blocks(params: Dict, h: torch.Tensor, blocks,
                      *, use_kernel: bool = True) -> torch.Tensor:
    """GraphSAGE-mean forward over sampled mini-batch blocks.

    ``h`` is the outermost block's source table — ``(num_src, D)`` rows
    aligned with ``blocks[0]["nbr"]``'s local indices, zeros in the
    ``-1``-padded slots (``TieredFeatures.gather_rows``).  ``blocks`` is
    :func:`repro_torch.sample.block_tree`'s list, outermost hop first.
    Destination rows lead each source table (dst-first), so the self term
    is ``h[:num_dst]``.  Returns the ``(batch, num_classes)`` seed logits;
    rows of padded seeds must stay masked in the loss.
    """
    layers = params["layers"]
    if len(blocks) != len(layers):
        raise ValueError(
            f"{len(blocks)} blocks for {len(layers)} layers — sample with "
            f"one fanout per layer")
    for i, (layer, blk) in enumerate(zip(layers, blocks)):
        nbr, mask = blk["nbr"], blk["mask"]
        s = block_neighbor_sum(h, nbr, mask, grad_index=blk["grad"],
                               use_kernel=use_kernel)
        deg = mask.sum(dim=-1).clamp_min(1).to(h.dtype)[:, None]
        h = _dense(layer["self"], h[:nbr.shape[0]]) \
            + _dense(layer["nbr"], s / deg)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


# the sampled path is GraphSAGE-style by construction (per-hop fanout
# bound == per-layer neighbor sample)
BLOCK_MODELS = {"sage": sage_apply_blocks}


def apply_blocks(model: str, params: Dict, h: torch.Tensor, blocks,
                 *, use_kernel: bool = True) -> torch.Tensor:
    """The sampled-block forward of ``model`` (GraphSAGE only)."""
    if model not in BLOCK_MODELS:
        raise ValueError(
            f"model {model!r} has no sampled-block path (have: "
            f"{sorted(BLOCK_MODELS)})")
    return BLOCK_MODELS[model](params, h, blocks, use_kernel=use_kernel)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over real (non-padding) nodes; padded rows carry mask 0."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    # the label's log-probability by a select and a row sum, not a gather:
    # a gather's backward is a scatter-add (atomics on the card), this
    # one's is elementwise
    cls = torch.arange(logp.shape[-1], device=logp.device)
    ll = torch.where(cls == labels.long()[:, None], logp, 0.0).sum(dim=-1)
    m = mask.to(torch.float32)
    return -(ll * m).sum() / m.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# GAT
# ---------------------------------------------------------------------------

def gat_init(gen: torch.Generator, in_dim: int, num_classes: int,
             hidden: int = 32, num_layers: int = 2, heads: int = 4,
             device="cpu") -> Dict:
    """GATv1 (Veličković et al.): its softmax over ``a·Wh_u`` is
    source-decomposable, so each head is two sum-aggregations,
    ``Σ e^{s_u}·Wh_u`` and ``Σ e^{s_u}``."""
    dims = [in_dim] + [hidden * heads] * (num_layers - 1) + [num_classes]
    layers = []
    for i in range(num_layers):
        nh = heads if i < num_layers - 1 else 1
        w = _dense_init(gen, dims[i], dims[i + 1], device)
        a_l = torch.randn((nh, dims[i + 1] // nh), generator=gen) * 0.1
        layers.append(dict(w=w, a_l=a_l.to(device)))
    return dict(layers=layers)


def gat_stage(params: Dict, engine: GNNEngine, h: torch.Tensor,
              i: int) -> torch.Tensor:
    """GAT's ``W`` runs before aggregation (attention needs ``Wh`` per
    source), so there is no update to fuse: ``fuse_update`` is a no-op and
    fused == unfused bitwise.  GAT stays on the dense ring under ``topk``,
    as in the reference."""
    layer = params["layers"][i]
    nh = layer["a_l"].shape[0]
    z = _dense(layer["w"], h)                          # (N, H·hd)
    npad, total = z.shape
    hd = total // nh
    zh = z.reshape(npad, nh, hd)
    s = torch.einsum("nhd,hd->nh", zh, layer["a_l"])
    e = torch.exp(torch.nn.functional.leaky_relu(s, 0.2))   # (N, H)
    num = engine.aggregate((zh * e[..., None]).reshape(npad, total), layer=i)
    # each head's weight repeated over its hd columns (an expand, whose
    # backward is a sum: no index_add_ on the gradient path)
    den = engine.aggregate(e[..., None].expand(npad, nh, hd).reshape(
        npad, total), layer=i)
    out = (num / den.clamp_min(1e-9)).to(h.dtype)
    if i < len(params["layers"]) - 1:
        out = torch.nn.functional.elu(out)
    return out


def gat_apply(params: Dict, engine: GNNEngine,
              x: torch.Tensor) -> torch.Tensor:
    h = x
    for i in range(len(params["layers"])):
        h = gat_stage(params, engine, h, i)
    return h


MODEL_ZOO = {
    "gcn": (gcn_init, gcn_apply, dict(hidden=16, num_layers=2)),
    "gin": (gin_init, gin_apply, dict(hidden=64, num_layers=5)),
    "sage": (sage_init, sage_apply, dict(hidden=32, num_layers=2)),
    "gat": (gat_init, gat_apply, dict(hidden=16, num_layers=2, heads=4)),
}

# stage-wise access: the serving engine resumes from a cached layer-1
# table, folding the same stage functions as the full forward
MODEL_STAGES = {
    "gcn": gcn_stage,
    "gin": gin_stage,
    "sage": sage_stage,
    "gat": gat_stage,
}


def _check_model(model: str) -> None:
    if model not in MODEL_STAGES:
        raise ValueError(f"unknown model {model!r}")


def aggregation_widths(model: str, params: Dict,
                       fused: bool = False) -> List[int]:
    """Feature width crossing the ring at each aggregation layer (the
    tuner's per-layer ``D``); ``fused`` widths are the pre-update ones."""
    _check_model(model)
    widths = []
    for layer in params["layers"]:
        if model == "gcn":
            d_in, d_out = layer["w"].shape
            widths.append(int(d_in if fused else min(d_in, d_out)))
        elif model == "gin":
            widths.append(int(layer["mlp1"]["w"].shape[0]))
        elif model == "sage":
            widths.append(int(layer["nbr"]["w"].shape[0]))
        else:
            widths.append(int(layer["w"]["w"].shape[1]))
    return widths


def num_stages(model: str, params: Dict) -> int:
    """Stages of ``model``'s forward (GIN's head dense is a stage)."""
    _check_model(model)
    n = len(params["layers"])
    return n + 1 if model == "gin" else n


def apply_stage(model: str, params: Dict, engine: GNNEngine,
                h: torch.Tensor, i: int) -> torch.Tensor:
    _check_model(model)
    return MODEL_STAGES[model](params, engine, h, i)


def apply_from_stage(model: str, params: Dict, engine: GNNEngine,
                     h: torch.Tensor, start: int) -> torch.Tensor:
    """Fold stages ``start..`` — ``apply_from_stage(m, p, e, x, 0)`` is the
    full forward, identical to ``MODEL_ZOO[m][1](p, e, x)``."""
    for i in range(start, num_stages(model, params)):
        h = apply_stage(model, params, engine, h, i)
    return h
