"""Full-graph GCN on the MGG ring (counterpart of ``repro/core/gnn.py``).

GCN (Kipf & Welling), the paper's setting of 2 layers and 16 hidden dims:
``Z = Â · relu(Â X W¹) W²`` with ``Â = D^{-1/2}(A+I)D^{-1/2}``.  The
sparse ``Â·X`` runs through :func:`repro_torch.core.pipeline.mgg_aggregate`;
the dense ``·W`` updates are plain matmuls, in full fp32 (an engine on the
card turns TF32 off for CUDA matmuls), unless a layer's plan fuses them into the ring.
Symmetric normalization is folded into per-node scalings so the kernel
stays a pure masked gather-sum.

Parameters are a plain dict of tensors, ``{"layers": [{"w", "b"}, ...]}``;
:func:`params_from_numpy` carries the reference's parameter pytree over.
GIN, GraphSAGE and GAT arrive with training in the next slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..dist.ring import VirtualRing
from .graph import CSRGraph
from .placement import (AggregationPlan, LayerPlan, build_layer_plans,
                        pad_embeddings, pad_table)
from .pipeline import RingArrays, mgg_aggregate, plan_device_arrays

__all__ = ["GNNEngine", "gcn_init", "gcn_stage", "gcn_apply",
           "params_from_numpy", "MODEL_ZOO", "MODEL_STAGES", "num_stages",
           "apply_stage", "apply_from_stage", "aggregation_widths"]

_LATER = "arrives with training (slice 2)"


@dataclasses.dataclass
class GNNEngine:
    """Graph partitioning state + the pipelined aggregation op.

    One :class:`~repro_torch.core.placement.LayerPlan` from one ``(ps,
    dist, pb)`` config serves every GNN layer; ``ring_arrays[0]`` is that
    plan bound to the card (built once, at :meth:`build`).  Per-layer
    plans come with the tuner's slice.  ``use_kernel=False`` (set on a
    built engine, e.g. with ``dataclasses.replace``) runs the plain
    versions on any device — the reference's oracle path, used to check
    the kernels end to end.
    """

    layer_plans: List[LayerPlan]
    ring: VirtualRing
    ring_arrays: List[RingArrays]
    deg: torch.Tensor                    # padded (N_pad,) float32, deg of A+I
    use_kernel: bool = True

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
    ) -> "GNNEngine":
        """Build an engine on ``ring`` whose one ``(ps, dist, pb)`` plan
        serves every layer; GCN's ``Â`` takes ``graph`` with self-loops."""
        if topk:
            raise NotImplementedError(
                "the top-k compressed ring arrives in a later slice")
        if ring.device.type == "cuda":
            # the dense ·W updates must agree with the reference to fp32
            # rounding: CUDA matmuls run in full fp32, not TF32
            torch.backends.cuda.matmul.allow_tf32 = False
        g = graph.with_self_loops()
        plans = build_layer_plans(g, ring.n_dev,
                                  [dict(ps=ps, dist=dist, pb=pb)],
                                  interleave=interleave,
                                  fuse_update=fuse_update)
        plan0 = plans[0].plan
        arrays = [plan_device_arrays(plan0, interleave=interleave,
                                     device=ring.device)]
        deg = pad_table(plan0.bounds, plan0.rows_per_dev,
                        g.degrees.astype(np.float32)[:, None])[:, 0]
        return GNNEngine(
            layer_plans=plans, ring=ring, ring_arrays=arrays,
            deg=torch.from_numpy(np.maximum(deg, 1.0)).to(ring.device),
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
    def config(self) -> Dict[str, int]:
        return self.layer_plans[0].config

    # -- layout --------------------------------------------------------------

    def pad(self, x: np.ndarray) -> np.ndarray:
        return pad_embeddings(self.plan, x)

    def shard(self, x) -> torch.Tensor:
        """Place a padded table on the ring's card: the virtual shards are
        row ranges of this one tensor."""
        return torch.as_tensor(x).to(self.device)

    # -- aggregation ---------------------------------------------------------

    def aggregate(self, x: torch.Tensor, layer: int = 0,
                  update_w: Optional[torch.Tensor] = None) -> torch.Tensor:
        lp = self.layer_plan(layer)
        return mgg_aggregate(
            x, lp.plan, self.ring,
            interleave=lp.interleave,
            use_kernel=self.use_kernel,
            pb=lp.pb,
            update_w=update_w,
            arrays=self.ring_arrays[min(layer, len(self.ring_arrays) - 1)],
        )

    def aggregate_update(self, x: torch.Tensor, w: torch.Tensor,
                         layer: int = 0) -> torch.Tensor:
        """Fused ``(A x) @ W``: the update matmul runs inside the ring."""
        return self.aggregate(x, layer=layer, update_w=w)

    def _dinv(self, x: torch.Tensor) -> torch.Tensor:
        return torch.rsqrt(self.deg)[:, None].to(x.dtype)

    def gcn_norm_aggregate(self, x: torch.Tensor,
                           layer: int = 0) -> torch.Tensor:
        """Â x with Â = D^{-1/2}(A+I)D^{-1/2} (self-loops already in plan)."""
        dinv = self._dinv(x)
        return self.aggregate(x * dinv, layer=layer) * dinv

    def gcn_norm_aggregate_update(self, x: torch.Tensor, w: torch.Tensor,
                                  layer: int = 0) -> torch.Tensor:
        """Fused ``(Â x) @ W``: the left diagonal scaling commutes with the
        right matmul, so ``D^{-1/2}((A (D^{-1/2} x)) W)`` is exact."""
        dinv = self._dinv(x)
        return self.aggregate_update(x * dinv, w, layer=layer) * dinv

    def mean_aggregate(self, x: torch.Tensor, layer: int = 0) -> torch.Tensor:
        return self.aggregate(x, layer=layer) / self.deg[:, None].to(x.dtype)


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
    if engine.layer_plan(i).fuse_update:
        h = engine.gcn_norm_aggregate_update(h, layer["w"], layer=i) \
            + layer["b"]
    elif d_in >= d_out:
        h = engine.gcn_norm_aggregate(h @ layer["w"], layer=i) + layer["b"]
    else:
        h = _dense(layer, engine.gcn_norm_aggregate(h, layer=i))
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


MODEL_ZOO = {
    "gcn": (gcn_init, gcn_apply, dict(hidden=16, num_layers=2)),
}

MODEL_STAGES = {
    "gcn": gcn_stage,
}


def _check_model(model: str) -> None:
    if model not in MODEL_STAGES:
        if model in ("gin", "sage", "gat"):
            raise NotImplementedError(f"model {model!r} {_LATER}")
        raise ValueError(f"unknown model {model!r}")


def aggregation_widths(model: str, params: Dict,
                       fused: bool = False) -> List[int]:
    """Feature width crossing the ring at each aggregation layer."""
    _check_model(model)
    widths = []
    for layer in params["layers"]:
        d_in, d_out = layer["w"].shape
        widths.append(int(d_in if fused else min(d_in, d_out)))
    return widths


def num_stages(model: str, params: Dict) -> int:
    _check_model(model)
    return len(params["layers"])


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
