"""End-to-end LM pretraining driver for the port (counterpart of
``examples/train_lm.py``): any ``--arch`` but whisper (the encdec
family, which ``examples/train_lm.py`` refuses too), the fault-tolerant
``Trainer`` (checkpoint/restart, straggler watchdog) and the shardable
synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 300 \
        --seq 128 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \
        --smoke --steps 24 --tune-accum

The default arch is xlstm-125m, whose sLSTM runs K8 forward and K9
backward on the card.  ``--tune-accum`` makes the gradient-accumulation
depth an online-tuned knob: the port's ``OnlineTuner`` (the one that
drives the GNN aggregation search) runs a 1-D search over
``accum_steps`` on measured step times and swaps step functions through
``Trainer(tune_cb=...)``.  The reference's default ``--workdir`` is a
fixed path under ``/tmp``; here checkpoints are written only when
``--workdir`` is given.  ``--device cpu`` runs on the CPU; without it
the run needs the card.  ``main`` returns the losses, each step's ms and
the tuner's result.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional, Sequence

import torch

from .. import configs
from ..dist.ring import resolve_device
from ..models import transformer as T
from ..runtime import LatencyWindow, OnlineTuner, ProfileConfig
from ..train import (AdamWConfig, LMDataConfig, Trainer, TrainState,
                     adamw_init, make_train_step)
from .train import lm_batches

__all__ = ["main", "make_accum_tuner"]


def make_accum_tuner(build_step_fn: Callable[[int], Callable], batch: int,
                     *, space=(1, 2, 4, 8), budget=None, log=print):
    """A ``Trainer(tune_cb=...)`` callback tuning ``accum_steps`` online
    (the reference's, ``examples/train_lm.py:29``).

    The tuner's first axis carries the accumulation depth (the other two
    are trivial), measurements are median step times from a
    ``LatencyWindow``, and every move returns a new step function for the
    Trainer to swap in.  Returns ``(tuner, state, tune_cb)``.
    """
    space = tuple(a for a in space if batch % a == 0 and a <= batch)
    tuner = OnlineTuner(ps_space=space, dist_space=(1,), pb_space=(1,),
                        budget=budget)
    window = LatencyWindow(ProfileConfig(warmup=1, iters=2))
    state = dict(accum=tuner.propose()["ps"])

    def tune_cb(dt, step):
        if tuner.converged:
            return None
        window.add(dt)
        if not window.ready:
            return None
        lat = window.value()
        window.reset()
        tuner.observe(lat)
        cfg = tuner.propose()
        accum = int(cfg["ps"]) if cfg is not None else state["accum"]
        if tuner.converged:
            log(f"[tune-accum] converged after {tuner.measured} "
                f"measurements: accum_steps={accum} "
                f"({tuner.best_latency * 1e3:.1f} ms)")
        if accum == state["accum"]:
            return None
        log(f"[tune-accum] step {step}: accum_steps "
            f"{state['accum']} → {accum}")
        state["accum"] = accum
        return build_step_fn(accum)

    return tuner, state, tune_cb


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train_lm")
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--tune-accum", action="store_true",
                    help="online-tune accum_steps via Trainer(tune_cb=...)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--workdir", default="",
                    help="checkpoint directory (none when empty)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encdec family has no launcher path, as in the "
            "reference; use repro_torch.models.encdec directly")
    cfg = dataclasses.replace(cfg, ssm_chunk=min(cfg.ssm_chunk, args.seq))
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"device={dev} seq={args.seq} batch={args.batch}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, vocab_multiple=16)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)

    def build_step_fn(accum: int):
        return make_train_step(cfg, T.DistCtx(), ocfg, accum_steps=accum)

    tuner, tune_state, tune_cb = None, None, None
    if args.tune_accum:
        tuner, tune_state, tune_cb = make_accum_tuner(build_step_fn,
                                                      args.batch)
        args.accum = tune_state["accum"]
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq,
                        global_batch=args.batch, doc_len=args.seq)
    tr = Trainer(build_step_fn(args.accum), lm_batches(cfg, dcfg, dev),
                 TrainState(params, opt), workdir=args.workdir or None,
                 ckpt_every=50, log_every=10, tune_cb=tune_cb)
    tr.maybe_restore()
    losses = tr.run(args.steps)
    if losses:
        print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"stragglers={tr.stragglers} restarts={tr.restarts}")
    out = dict(arch=cfg.name, device=str(dev), losses=losses,
               step_ms=[t * 1e3 for t in tr.step_times],
               retunes=tr.retunes, restarts=tr.restarts)
    if args.tune_accum:
        print(f"tuned accum_steps={tune_state['accum']} "
              f"after {tuner.measured} measurements "
              f"({tr.retunes} step-fn swaps)")
        out.update(accum=tune_state["accum"], converged=tuner.converged,
                   measured=tuner.measured)
    return out


if __name__ == "__main__":
    main()
