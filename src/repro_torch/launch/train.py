"""LM training launcher for the port (counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        [--steps 100 --seq 256 --batch 8] [--accum 2] [--smoke] \
        [--workdir DIR --ckpt-every 50] [--trace PATH] [--metrics-json PATH]
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch xlstm-125m --smoke --steps 3 --seq 32 --batch 2

The reference's flags and defaults: random parameters from seed 0
(``vocab_multiple=16``, drawn by a ``torch.Generator`` on the device),
AdamW with ``warmup_steps=20`` and the cosine schedule over ``--steps``,
``lm_batch`` data from seed 0 with one document a row, the family's
``remat`` on, ``ssm_chunk`` at most ``--seq``.  The dense, vlm, moe,
hybrid and xlstm families train; on the card the xlstm's sLSTM runs K8
forward and K9 backward, and attention takes the chunked path
(``use_flash_attention`` off, as the reference must: K7 has no
backward).  TF32 is off: every fp32 product is fp32.  The reference's
``--devices N`` (fake host devices and a data mesh) becomes ``--device
cpu|cuda``: without ``--device cpu`` it runs on the card or raises.  On
one device there is no mesh, so ``--moe-pipeline-chunks`` (the EP
dispatch's pipelining depth) does nothing, as in the reference's
one-device run.  ``--ef-bits`` and ``--ring-tp`` (ROADMAP item 9) raise
``NotImplementedError``; so does whisper (the encdec family), which the
reference's launcher has no path for either: train it through
``repro_torch.models.encdec`` and ``train.make_train_step``.  Prints the
first and last loss; ``main`` returns the losses, each step's ms and the
trainer's counts.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Iterator, Optional, Sequence

import torch

from .. import configs
from ..dist.ring import resolve_device
from ..models import transformer as T
from ..obs import MetricsRegistry, Tracer
from ..train import (AdamWConfig, LMDataConfig, Trainer, TrainState,
                     adamw_init, lm_batch, make_train_step)

__all__ = ["main", "lm_batches"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--moe-pipeline-chunks", type=int, default=1,
                    help="pipelining depth of the expert-parallel dispatch "
                         "over a mesh; one device has no mesh, so it "
                         "does nothing here")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ef-bits", type=int, default=0,
                    help="int-N error-feedback gradient compression "
                         "(ROADMAP item 9: raises)")
    ap.add_argument("--ring-tp", action="store_true",
                    help="ring-pipelined TP matmuls (ROADMAP item 9: "
                         "raises)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the training loop")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot as JSON")
    return ap


def lm_batches(cfg, dcfg: LMDataConfig, device) -> Iterator[dict]:
    """``lm_batch`` for steps 0, 1, ... as tensors on ``device``."""
    s = 0
    while True:
        b = lm_batch(dcfg, s,
                     n_vis=cfg.n_vis_tokens if cfg.family == "vlm" else 0,
                     d_model=cfg.d_model)
        yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        s += 1


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    if args.ef_bits:
        raise NotImplementedError(
            "--ef-bits: the error-feedback compressed all-reduce is ROADMAP "
            "item 9 (it needs a mesh of cards)")
    if args.ring_tp:
        raise NotImplementedError(
            "--ring-tp: ring tensor parallelism is ROADMAP item 9")
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracer = Tracer() if args.trace else None
    registry = MetricsRegistry() if (args.trace or args.metrics_json) \
        else None

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    cfg = dataclasses.replace(cfg, ssm_chunk=min(cfg.ssm_chunk, args.seq))
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encdec family has no launcher path, as in the "
            "reference; use repro_torch.models.encdec directly")
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"device={dev} seq={args.seq} batch={args.batch}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, vocab_multiple=16)
    opt = adamw_init(params)
    step_fn = make_train_step(
        cfg, T.DistCtx(), AdamWConfig(lr=args.lr, warmup_steps=20,
                                      total_steps=args.steps),
        accum_steps=args.accum)
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq,
                        global_batch=args.batch, doc_len=args.seq)
    tr = Trainer(step_fn, lm_batches(cfg, dcfg, dev), TrainState(params, opt),
                 workdir=args.workdir or None, ckpt_every=args.ckpt_every,
                 tracer=tracer, metrics=registry)
    tr.maybe_restore()
    losses = tr.run(args.steps)
    if losses:
        print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"stragglers={tr.stragglers} restarts={tr.restarts}")
    if args.metrics_json:
        registry.dump_json(args.metrics_json)
        print(f"[launch] metrics snapshot: {args.metrics_json}")
    if tracer is not None:
        tracer.dump_chrome(args.trace)
        print(f"[launch] chrome trace: {args.trace} ({len(tracer)} events)")
    return dict(arch=cfg.name, device=str(dev), losses=losses,
                step_ms=[t * 1e3 for t in tr.step_times],
                stragglers=tr.stragglers, restarts=tr.restarts,
                state=tr.state)


if __name__ == "__main__":
    main()
