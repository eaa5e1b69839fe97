"""Dry run of every (arch × shape × mesh) cell on meta tensors
(counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 256 or 512 fake devices and
reads XLA's partitioned HLO.  The port builds the cell on a virtual
production mesh on the meta device (``make_production_mesh(device=
"meta")``: nothing is allocated) and runs its step once under
``launch/op_cost.py``'s counter, so every figure comes from the eager
program the card would run, and no card is needed:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]

It writes the reference's JSON keys, with these differences:

* ``trace_s`` (building the cell and running it on meta) replaces
  ``lower_s`` and ``compile_s``: nothing is lowered or compiled;
* ``xla_raw`` is dropped: it held XLA's own cost analysis, which has no
  counterpart, and so :func:`parse_collectives` and
  ``cost_analysis_dict`` (parsers of XLA output) have none either;
* ``flops`` and ``bytes_accessed`` are per device: the virtual mesh
  stacks every shard's work into one program, so they are its totals
  divided by the mesh's size; a hand-written kernel on meta counts the
  most its shapes allow where its work depends on the data
  (``collectives["kernels"]``, ``exact``);
* ``collectives["per_op"]`` holds two parts, each entry tagged by
  ``source``.  ``issued``: the transfers the port enqueues (ring TP, the
  expert-parallel exchange, the ef all-reduce), counted exactly as the
  step runs, bytes per device.  ``implied``: what the spec trees imply on
  a real mesh, which on one card moves nothing (``DistCtx.constrain`` is
  the identity) — an all-gather of each data-sharded parameter block in
  the forward and again in the backward, a reduce-scatter of its
  gradient, and an all-reduce of each replicated gradient, per train step
  (the activations' tensor-parallel reduces, which XLA would add, are not
  implied here).  Together they stand where the reference has XLA's
  partitioned collectives;
* ``memory``: ``argument_size`` and ``output_size`` are exact, the bytes
  of one device's shards of the arguments and the outputs
  (``argument_sizes`` splits the first by argument); ``temp_size`` is the
  peak of live meta storages during the step over the mesh's size, an
  estimate (``temp_size_is``); there is no generated code.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch

from ..dist import sharding as shd
from .cells import all_cells, build_cell
from .mesh import make_production_mesh
from .op_cost import analyze

__all__ = ["run_cell", "implied_collectives", "shard_bytes", "main"]


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _split(spec, mesh) -> int:
    """How many shards a tensor laid by ``spec`` is cut into."""
    return math.prod(mesh.shape[a] for e in spec for a in _axes(e))


def _pairs(tree, shardings):
    """``(tensor, MeshSharding)`` pairs of a tree and its sharding tree."""
    if isinstance(shardings, shd.MeshSharding):
        if isinstance(tree, torch.Tensor):
            yield tree, shardings
    elif isinstance(shardings, dict):
        for k in shardings:
            yield from _pairs(tree[k], shardings[k])
    elif isinstance(shardings, (list, tuple)):
        for t, s in zip(tree, shardings):
            yield from _pairs(t, s)
    else:                                   # a dataclass (a KV cache)
        for f in dataclasses.fields(shardings):
            yield from _pairs(getattr(tree, f.name),
                              getattr(shardings, f.name))


def shard_bytes(tree, shardings) -> int:
    """Bytes of one device's shards of ``tree``, laid by ``shardings`` (a
    matching tree of ``MeshSharding``)."""
    return sum(t.numel() * t.element_size() // _split(s.spec, s.mesh)
               for t, s in _pairs(tree, shardings))


def implied_collectives(params, p_shardings, data_axes) -> Dict[str, dict]:
    """The collectives a train step's spec trees imply on a real mesh,
    per device (operand bytes, count): each data-sharded parameter block
    all-gathered in the forward and again in the backward, its gradient
    reduce-scattered from the block gathered over the data axes, and each
    replicated gradient all-reduced over them."""
    out = {k: dict(bytes=0, count=0, source="implied")
           for k in ("all-gather", "reduce-scatter", "all-reduce")}
    for t, s in _pairs(params, p_shardings):
        mesh = s.mesh
        data = math.prod(mesh.shape.get(a, 1) for a in data_axes)
        if data <= 1:
            continue
        block = t.numel() * t.element_size() // _split(s.spec, mesh)
        if any(a in data_axes for e in s.spec for a in _axes(e)):
            out["all-gather"]["bytes"] += 2 * block
            out["all-gather"]["count"] += 2
            out["reduce-scatter"]["bytes"] += block * data
            out["reduce-scatter"]["count"] += 1
        else:
            out["all-reduce"]["bytes"] += block
            out["all-reduce"]["count"] += 1
    return {k: v for k, v in out.items() if v["count"]}


def _output_shardings(cell, out):
    """The outputs laid as the step's state is: a train step's parameters
    and optimizer state as its arguments, logits by the batch rule, a
    cache as the cache argument; metrics replicated."""
    mesh = next(_pairs(cell.args, cell.in_shardings))[1].mesh
    if cell.shape.kind == "train":
        p_sh, o_sh, _ = cell.in_shardings
        return (p_sh, o_sh, {k: shd.MeshSharding(mesh, shd.P())
                             for k in out[2]})
    c_sh = cell.in_shardings[-1]
    rules = shd.ShardingRules(mesh, data_axes=_data_axes(cell))
    return (shd.to_shardings(shd.batch_specs(out[0], rules), mesh), c_sh)


def _data_axes(cell) -> tuple:
    return ("pod", "data") if cell.meta["multi_pod"] else ("data",)


def run_cell(arch: str, shape: str, multi_pod: bool,
             out_dir: Optional[str] = None,
             moe_pipeline_chunks: int = 1,
             extra_cfg: Optional[dict] = None,
             tag: str = "",
             fsdp: bool = True,
             shard_acts: bool = True,
             seq_shard_acts: Optional[bool] = None,
             mesh=None) -> Dict[str, Any]:
    """Build one cell on ``mesh`` (the production mesh on meta by
    default), run its step once under the counter, and return (and with
    ``out_dir`` write) the reference's record."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        mesh_name = "multi_pod" if multi_pod else "single_pod"
    else:
        mesh_name = "x".join(str(s) for s in mesh.devices_shape)
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, mesh, multi_pod=multi_pod,
                      moe_pipeline_chunks=moe_pipeline_chunks,
                      extra_cfg=extra_cfg, fsdp=fsdp, shard_acts=shard_acts,
                      seq_shard_acts=seq_shard_acts)
    train = cell.shape.kind == "train"
    with torch.inference_mode(not train):
        oc = analyze(cell.fn, *cell.args)
    trace_s = time.perf_counter() - t0
    n = mesh.size
    coll = oc.as_dict()
    per_op = {k: dict(bytes=v["bytes"] / n, count=v["count"],
                      source="issued") for k, v in coll["per_op"].items()}
    if train:
        for k, v in implied_collectives(cell.args[0], cell.in_shardings[0],
                                        _data_axes(cell)).items():
            if k in per_op:
                per_op[k] = dict(bytes=per_op[k]["bytes"] + v["bytes"],
                                 count=per_op[k]["count"] + v["count"],
                                 source="issued+implied")
            else:
                per_op[k] = v
    coll.update(per_op=per_op,
                total_bytes=sum(v["bytes"] for v in per_op.values()))
    sizes = [shard_bytes(a, s) for a, s in zip(cell.args, cell.in_shardings)]
    result = dict(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n,
        kind=cell.shape.kind, model_params=cell.meta["params"],
        trace_s=round(trace_s, 2), flops=oc.dot_flops / n,
        bytes_accessed=oc.bytes_accessed / n, collectives=coll,
        memory=dict(
            argument_size=sum(sizes), argument_sizes=sizes,
            output_size=shard_bytes(oc.output,
                                    _output_shardings(cell, oc.output)),
            temp_size=oc.peak_live_bytes // n,
            temp_size_is="an estimate: the peak of live meta storages "
                         "during the step over the mesh's size"),
        moe_pipeline_chunks=moe_pipeline_chunks, tag=tag,
    )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fname = os.path.join(
            out_dir, f"{arch}_{shape}_{result['mesh']}{suffix}.json")
        with open(fname, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=False)
    ap.add_argument("--shape", required=False)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--moe-pipeline-chunks", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-shard-acts", action="store_true")
    ap.add_argument("--seq-shard-acts", default="auto",
                    choices=["auto", "on", "off"])
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--param-dtype", default="")
    args = ap.parse_args(argv)
    knobs = dict(
        fsdp=not args.no_fsdp, shard_acts=not args.no_shard_acts,
        seq_shard_acts={"auto": None, "on": True, "off": False}[
            args.seq_shard_acts])
    extra = {}
    if args.capacity_factor:
        extra["moe_capacity_factor"] = args.capacity_factor
    if args.param_dtype:
        extra["param_dtype"] = args.param_dtype
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)

    if args.all:
        run, skipped = all_cells()
        for arch, shape in run:
            for mp in meshes:
                r = run_cell(arch, shape, mp, args.out,
                             args.moe_pipeline_chunks, extra_cfg=extra or None,
                             tag=args.tag, **knobs)
                print(f"{arch} × {shape} × {r['mesh']}: OK "
                      f"flops={r['flops']:.3e} "
                      f"coll={r['collectives']['total_bytes']:.3e}B "
                      f"trace={r['trace_s']}s", flush=True)
        for arch, shape, why in skipped:
            print(f"{arch} × {shape}: SKIP ({why})")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    for mp in meshes:
        r = run_cell(args.arch, args.shape, mp, args.out,
                     args.moe_pipeline_chunks, extra_cfg=extra or None,
                     tag=args.tag, **knobs)
        print(json.dumps(
            {k: r[k] for k in ("arch", "shape", "mesh", "n_chips", "flops",
                               "bytes_accessed", "trace_s")}, indent=1))
        print("memory:", r["memory"])
        print("collectives:", json.dumps(r["collectives"], indent=1))


if __name__ == "__main__":
    main()
