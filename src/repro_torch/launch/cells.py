"""(architecture × input-shape × mesh) cell builder for the dry run
(counterpart of ``repro/launch/cells.py``).

For every cell this gives:

* the step callable (``make_train_step`` / ``prefill`` / ``decode_step``
  of the port per ``shape.kind``, ``models/encdec.py`` for whisper);
* its arguments as tensors on the mesh's device, meta for a dry run
  (``launch/dryrun.py``): building a cell allocates nothing;
* the arguments' shardings from ``dist/sharding.py``'s rules.

The reference's rules hold: bf16 parameters to serve, fp32 masters to
train, FSDP over the data axes in training only, the vocabulary padded to
the model axis, activations sharded only when the batch divides the data
axes, and no sequence sharding of activations for the recurrent families
(xlstm, hybrid).  On one card the activation hints change no value
(``DistCtx.constrain`` is the identity); they are set as the reference
sets them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import configs
from ..configs import SHAPES, ModelConfig, ShapeSpec, shape_applicable
from ..dist import sharding as shd
from ..models import encdec, transformer
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.trainer import make_train_step

__all__ = ["Cell", "N_FRAMES", "input_specs", "build_cell", "all_cells"]

N_FRAMES = 1500  # whisper stub frontend output length


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: Callable
    args: Tuple[Any, ...]           # tensors on the mesh's device
    in_shardings: Tuple[Any, ...]   # MeshSharding trees, one per argument
    donate_argnums: Tuple[int, ...]
    cfg: ModelConfig
    meta: Dict[str, Any]


def _on(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                device="meta") -> Dict[str, Any]:
    """Empty stand-ins (meta by default) for every model input of this
    cell, with the reference's shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    extra = {}
    if cfg.family == "vlm":
        extra["vis"] = _on((b, cfg.n_vis_tokens, cfg.d_model),
                           torch.float32, device)
    if cfg.family == "encdec":
        extra["frames"] = _on((b, N_FRAMES, cfg.d_model), torch.float32,
                              device)
    if shape.kind == "train":
        return dict(tokens=_on((b, s), torch.int32, device),
                    loss_mask=_on((b, s), torch.float32, device), **extra)
    if shape.kind == "prefill":
        return dict(tokens=_on((b, s), torch.int32, device), **extra)
    return dict(token=_on((b,), torch.int32, device),
                pos=_on((b,), torch.int32, device))


def build_cell(arch: str, shape_name: str, mesh,
               *, multi_pod: bool = False,
               moe_pipeline_chunks: int = 1,
               extra_cfg: Optional[dict] = None,
               fsdp: bool = True,
               shard_acts: bool = True,
               seq_shard_acts: Optional[bool] = None) -> Cell:
    """The cell on ``mesh`` (a ``VirtualMesh``; its device holds the
    arguments)."""
    cfg = configs.get_config(arch)
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} × {shape_name} skipped: {why}")
    data_axes = ("pod", "data") if multi_pod else ("data",)
    train = shape.kind == "train"
    # serve uses bf16 parameters; train keeps fp32 masters
    if not train:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    vocab_mult = mesh.shape["model"]
    if seq_shard_acts is None:
        # recurrent families reshard the sequence dim inside their scans:
        # batch-only activation sharding for them
        seq_shard_acts = cfg.family not in ("xlstm", "hybrid")
    ctx = transformer.DistCtx(
        mesh=mesh, data_axes=data_axes,
        moe_pipeline_chunks=moe_pipeline_chunks,
        # batch must divide the data axes to shard activations on them
        shard_activations=shard_acts and shape.global_batch % math.prod(
            mesh.shape[a] for a in data_axes) == 0,
        seq_shard_acts=seq_shard_acts,
    )
    rules = shd.ShardingRules(mesh, data_axes=data_axes,
                              train=train and fsdp)
    init = (encdec.init_params if cfg.family == "encdec"
            else transformer.init_params)
    dev = mesh.device
    params = init(torch.Generator().manual_seed(0), cfg,
                  vocab_multiple=vocab_mult, device=dev)
    p_specs = shd.param_specs(params, rules, cfg.expert_mode)
    p_shard = shd.to_shardings(p_specs, mesh)
    meta = dict(arch=arch, shape=shape_name, kind=shape.kind,
                multi_pod=multi_pod, params=cfg.param_count())

    def batch_shardings(tree):
        return shd.to_shardings(shd.batch_specs(tree, rules), mesh)

    if train:
        opt = adamw_init(params)
        o_shard = shd.to_shardings(
            dict(m=p_specs, v=p_specs, count=shd.P()), mesh)
        batch = input_specs(cfg, shape, dev)
        step = make_train_step(cfg, ctx, AdamWConfig())
        return Cell(arch, shape, step, (params, opt, batch),
                    (p_shard, o_shard, batch_shardings(batch)), (0, 1), cfg,
                    meta)

    inp = input_specs(cfg, shape, dev)
    if cfg.family == "encdec":
        cache = encdec.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  N_FRAMES, device=dev)
    else:
        cache = transformer.init_cache(cfg, shape.global_batch,
                                       shape.seq_len, device=dev)
    c_shard = shd.to_shardings(
        shd.cache_specs(cache, rules, shape.global_batch), mesh)
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            fn = lambda p, frames, tokens, c: encdec.prefill(
                p, cfg, frames, tokens, c, ctx=ctx)
            args = (params, inp["frames"], inp["tokens"], cache)
        elif cfg.family == "vlm":
            fn = lambda p, tokens, vis, c: transformer.prefill(
                p, cfg, tokens, c, ctx=ctx, vis=vis)
            args = (params, inp["tokens"], inp["vis"], cache)
        else:
            fn = lambda p, tokens, c: transformer.prefill(
                p, cfg, tokens, c, ctx=ctx)
            args = (params, inp["tokens"], cache)
        in_sh = (p_shard, *(batch_shardings(a) for a in args[1:-1]),
                 c_shard)
        return Cell(arch, shape, fn, args, in_sh, (len(args) - 1,), cfg,
                    meta)

    step_fn = encdec.decode_step if cfg.family == "encdec" \
        else transformer.decode_step
    fn = lambda p, t, pos, c: step_fn(p, cfg, t, pos, c, ctx=ctx)
    args = (params, inp["token"], inp["pos"], cache)
    in_sh = (p_shard, batch_shardings(inp["token"]),
             batch_shardings(inp["pos"]), c_shard)
    return Cell(arch, shape, fn, args, in_sh, (3,), cfg, meta)


def all_cells() -> tuple:
    """Every runnable (arch × shape) pair, and the documented skips."""
    run, skipped = [], []
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            (run if ok else skipped).append(
                (arch, sname) if ok else (arch, sname, why))
    return run, skipped
