"""GNN-engine dry run on meta tensors: the paper's own workload (the
pipelined ring aggregation of a GCN layer) over 256 (single-pod) or 512
(multi-pod) ring shards, with its roofline terms (counterpart of
``repro/launch/dryrun_gnn.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn [--chips 512] \\
        [--dim 602]

The graph is the reddit stand-in; its plan is built on the host exactly
as in production (node split, locality split, ring-step bucketing).  The
reference lowers the ring's shard body and reads its HLO; the port runs
``mgg_aggregate`` itself over ``VirtualRing(chips, "meta")`` under
``launch/op_cost.py``'s counter, so the rotations are counted from the
real call sequence, and nothing is allocated.  On meta the gather-sum
(K1) can only record the most its shapes allow; the kernels' exact work
comes from the host plan through ``kernels/cost.py`` (:func:`plan_work`),
and ``bytes_accessed`` takes it in place of the meta records.  The
counted rotation bytes per shard must equal ``collective_bytes(plan,
dim)``: the run raises if they do not.  The roofline terms divide by
``H100_SXM``'s datasheet figures (fp32 rate, HBM rate, one NVLink
direction), not by a measurement.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from ..core import build_plan, collective_bytes, paper_dataset
from ..core.autotune import H100_SXM
from ..core.pipeline import host_groups, mgg_aggregate, plan_device_arrays
from ..dist import VirtualRing
from ..kernels import cost
from .op_cost import analyze

__all__ = ["plan_work", "count_ring", "to_meta", "main"]


def plan_work(plan, d: int, *, interleave: bool = True) -> Dict[str, dict]:
    """The exact work of one aggregation of ``plan`` at width ``d``: K1
    and K3 a non-empty launch group (:func:`~repro_torch.core.pipeline.
    host_groups`), from the host arrays the groups are built from."""
    out = {k: dict(launches=0, flops=0, bytes=0, exact=True)
           for k in ("gather_sum_pipelined", "segment_add_ordered")}
    local, local_steps, remote_steps = host_groups(plan,
                                                   interleave=interleave)
    groups = list(remote_steps) + list(local_steps) + (
        [] if local is None else [local])
    for nbrs, mask, tgt in groups:
        if not len(nbrs):
            continue
        for name, work in (
                ("gather_sum_pipelined", cost.gather_sum(nbrs, mask, d)),
                ("segment_add_ordered", cost.segment_add(
                    len(nbrs), cost.distinct(tgt), d))):
            out[name]["launches"] += 1
            out[name]["flops"] += work.flops
            out[name]["bytes"] += work.bytes
    return out


def to_meta(obj):
    """A copy of a plan's device arrays (``RingArrays`` and the
    dataclasses in it) with every tensor on meta."""
    if isinstance(obj, torch.Tensor):
        return obj.to("meta")
    if isinstance(obj, tuple):
        return tuple(to_meta(o) for o in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_meta(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def count_ring(plan, d: int, arrays=None):
    """One ``mgg_aggregate`` of ``plan`` at width ``d`` over a meta ring,
    under the counter → its ``OpCost``.  ``arrays`` (the plan's device
    arrays, on any device) are moved to meta; by default they are built
    there."""
    arrays = plan_device_arrays(plan, device="meta") if arrays is None \
        else to_meta(arrays)
    x = torch.empty((plan.padded_nodes, d), dtype=torch.float32,
                    device="meta")
    ring = VirtualRing(plan.n_dev, "meta")
    with torch.inference_mode():
        return analyze(mgg_aggregate, x, plan, ring, arrays=arrays)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, default=256, choices=(256, 512))
    ap.add_argument("--dim", type=int, default=602)   # reddit embedding dim
    ap.add_argument("--ps", type=int, default=16)
    ap.add_argument("--dist", type=int, default=1)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    g, meta = paper_dataset("reddit", scale=args.scale)
    t0 = time.perf_counter()
    plan = build_plan(g, args.chips, ps=args.ps, dist=args.dist)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    oc = count_ring(plan, args.dim)
    trace_s = time.perf_counter() - t0
    exact = plan_work(plan, args.dim)
    n = plan.n_dev
    rotated = oc.collectives.get("collective-permute", {}).get("bytes", 0)
    model = collective_bytes(plan, args.dim)
    if rotated != model * n:
        raise RuntimeError(
            f"counted rotation bytes {rotated} / {n} shards != "
            f"collective_bytes {model}")
    for name, w in exact.items():
        if oc.kernels.get(name, {}).get("launches", 0) != w["launches"]:
            raise RuntimeError(f"{name}: {oc.kernels.get(name)} launched on "
                               f"meta, the host plan has {w['launches']}")
    # the traced operations with the kernels' exact work for their
    # worst-case meta records
    nbytes = oc.bytes_accessed - sum(k["bytes"] for k in oc.kernels.values()
                                     ) + sum(w["bytes"]
                                             for w in exact.values())
    flops = oc.dot_flops - sum(k["flops"] for k in oc.kernels.values()) \
        + sum(w["flops"] for w in exact.values())
    coll = oc.as_dict()
    coll["per_op"] = {k: dict(bytes=v["bytes"] / n, count=v["count"],
                              source="issued")
                      for k, v in coll["per_op"].items()}
    coll["total_bytes"] = oc.total_collective_bytes / n
    hw = H100_SXM
    result = dict(
        arch="gnn-reddit-gcn-aggregate", shape=f"dim{args.dim}",
        mesh=f"ring{args.chips}", n_chips=args.chips,
        nodes=g.num_nodes, edges=g.num_edges,
        plan_build_s=round(t_plan, 2), trace_s=round(trace_s, 2),
        flops=flops / n, bytes_accessed=nbytes / n, collectives=coll,
        kernels_exact=exact, model_collective_bytes=model,
        counted_rotation_bytes=rotated / n,
        terms=dict(compute=flops / n / hw.peak_flops,
                   memory=nbytes / n / hw.hbm_bw,
                   collective=rotated / n / hw.link_bw),
        terms_are=f"seconds at {hw.name}'s datasheet figures (fp32 "
                  f"{hw.peak_flops:.3g} FLOP/s, HBM {hw.hbm_bw:.3g} B/s, "
                  f"one NVLink direction {hw.link_bw:.3g} B/s), not "
                  "measured",
    )
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out,
                           f"gnn_reddit_ring{args.chips}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("collectives", "kernels_exact")},
                     indent=1))
    print("collectives:", json.dumps(result["collectives"]["per_op"]))
    print("kernels (exact, host plan):", json.dumps(exact))
    return result


if __name__ == "__main__":
    main()
