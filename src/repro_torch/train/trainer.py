"""LM training step factory and fault-tolerant driver loop for the port
(counterpart of ``repro/train/trainer.py``).

``make_train_step`` builds the step for every family (dense, vlm, moe,
hybrid, xlstm and encdec, whose batch holds ``frames`` beside
``tokens``): value and gradient of the family's loss by autograd, optional
microbatch gradient accumulation (the reference's ``lax.scan`` is a loop
that adds each microbatch's gradients to fp32 zeros in order, then
divides), and AdamW (``train/optimizer.py``, the reference's update
rule).  A step returns new tensors and updates nothing in place, as the
reference's pure step does, so a step that fails leaves the parameters
and the optimizer state as they were.  On the card the xlstm's sLSTM
recurrence runs K8 forward and K9 backward (``kernels/ops.py``); the
moe's dispatch has a deterministic backward (``models/moe.py``), so a
step's bits repeat there too.

``Trainer`` is the reference's driver: checkpoint/restart
(``CheckpointManager``, asynchronous), the straggler watchdog against a
running median, bounded retries that restore the last checkpoint, and
the ``tune_cb(dt, step)`` hook whose non-None return replaces the step
function.  Each step ends in one synchronize of the device, as the
reference's ``block_until_ready``: the step time exists whether or not a
tracer records it, so tracing adds no synchronization and the losses are
bitwise the same with it on or off.

With ``ef_bits > 0`` (a pure data-parallel mesh) the gradients pass
through the error-feedback compressed all-reduce
(``dist/compress.py``) after accumulation and before AdamW, and the
optimizer state is the pair ``(adamw_state, ef_err)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..dist import implied
from ..models import encdec, transformer
from ..obs import NULL_TRACER
from . import checkpoint as ckpt_lib
from .optimizer import AdamWConfig, adamw_update
from .tree import tree_leaves, tree_map, value_and_grad

__all__ = ["make_loss_fn", "make_train_step", "Trainer", "TrainState"]


def make_loss_fn(cfg, ctx: transformer.DistCtx) -> Callable:
    """``loss(params, batch) -> (loss, aux)`` for ``cfg``'s family."""
    if cfg.family == "encdec":
        return lambda p, batch: encdec.loss_fn(p, cfg, batch, ctx=ctx)
    return lambda p, batch: transformer.loss_fn(p, cfg, batch, ctx=ctx)


def _grads_of(loss_fn: Callable, params: Any, batch: Dict):
    """``(loss, aux, grads)`` of ``loss_fn(params, batch)``."""
    (loss, aux), grads = value_and_grad(lambda p: loss_fn(p, batch), params,
                                        has_aux=True)
    return loss, aux, grads


def make_train_step(
    cfg,
    ctx: transformer.DistCtx,
    opt_cfg: AdamWConfig,
    *,
    accum_steps: int = 1,
    ef_bits: int = 0,
) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt, metrics)``.

    With ``accum_steps > 1`` the batch's leading dim is split into that
    many microbatches (rows ``[i·b/a, (i+1)·b/a)``, as the reference's
    reshape), whose gradients are added in order to fp32 zeros and then
    divided by ``accum_steps``; the loss is their mean.

    With ``ef_bits > 0`` the gradients pass through
    ``dist.compress.ef_allreduce_mean`` over ``ctx.data_axes`` before the
    optimizer: the int-``ef_bits`` wire format, its residual carried into
    the next step.  This needs a mesh whose model axis is trivial (pure
    data parallelism) and makes ``opt_state`` the pair ``(adamw_state,
    ef_err)`` with ``ef_err = ef_state_init(params)``.
    """
    ef_on = int(ef_bits) > 0
    if ef_on:
        if ctx.mesh is None:
            raise ValueError("ef_bits > 0 needs a mesh (ctx.mesh is None)")
        if int(ctx.mesh.shape.get(ctx.model_axis, 1)) > 1:
            raise ValueError(
                "ef_bits > 0 is a pure-DP path; model axis "
                f"{ctx.model_axis!r} has size "
                f"{ctx.mesh.shape[ctx.model_axis]} > 1")
        from ..dist.compress import ef_allreduce_mean
        from ..dist.sharding import P
    if accum_steps < 1:
        raise ValueError(f"accum_steps {accum_steps} < 1")
    loss_fn = make_loss_fn(cfg, ctx)

    def step(params, opt_state, batch):
        if ef_on:
            opt_state, ef_err = opt_state
        implied.train_params(ctx, params, cfg)
        if accum_steps == 1:
            loss, _, grads = _grads_of(loss_fn, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"accum_steps {accum_steps}")
            mb = b // accum_steps
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = None
            for i in range(accum_steps):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, _, g = _grads_of(loss_fn, params, part)
                gsum = tree_map(torch.add, gsum, g)
                lsum = loss if lsum is None else lsum + loss
            grads = tree_map(lambda g: g / accum_steps, gsum)
            loss = lsum / accum_steps
        if ef_on:
            # the int-bits wire format + error feedback; the mean over the
            # data axes is the data-parallel gradient all-reduce
            grads, ef_err = ef_allreduce_mean(
                grads, ef_err, ctx.mesh, ctx.data_axes,
                tree_map(lambda _: P(), grads), bits=ef_bits)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        if ef_on:
            opt_state = (opt_state, ef_err)
        return params, opt_state, dict(loss=loss, **om)

    return step


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def _block(t: torch.Tensor) -> None:
    """Wait for the device to finish ``t`` (``block_until_ready``)."""
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Trainer:
    """Fault-tolerant driver: run → watchdog → checkpoint → restart."""

    def __init__(
        self,
        step_fn: Callable,
        data_it: Iterator[Dict[str, torch.Tensor]],
        state: TrainState,
        *,
        workdir: Optional[str] = None,
        ckpt_every: int = 50,
        straggler_factor: float = 4.0,
        max_retries: int = 2,
        log_every: int = 10,
        log_fn: Callable[[str], None] = print,
        tune_cb: Optional[Callable[[float, int], Optional[Callable]]] = None,
        tracer=None,
        metrics=None,
    ):
        self.step_fn = step_fn
        self.data_it = data_it
        self.state = state
        self.workdir = workdir
        self.mgr = (ckpt_lib.CheckpointManager(workdir, every=ckpt_every)
                    if workdir else None)
        self.straggler_factor = straggler_factor
        self.max_retries = max_retries
        self.log_every = log_every
        self.log = log_fn
        self.tune_cb = tune_cb
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.step_times: list = []
        self.stragglers = 0
        self.restarts = 0
        self.retunes = 0

    def maybe_restore(self) -> bool:
        if self.mgr is None:
            return False
        target = dict(params=self.state.params,
                      opt_state=self.state.opt_state)
        step, tree = self.mgr.restore_latest(
            target, tree_leaves(self.state.params)[0].device)
        if step is None:
            return False
        self.state = TrainState(tree["params"], tree["opt_state"], step)
        self.log(f"[trainer] restored step {step} from {self.workdir}")
        return True

    def _watchdog(self, dt: float, step: int) -> None:
        if len(self.step_times) >= 5:
            med = float(np.median(self.step_times[-50:]))
            if dt > self.straggler_factor * med:
                self.stragglers += 1
                self.log(f"[trainer] straggler at step {step}: "
                         f"{dt:.3f}s vs median {med:.3f}s")
                self.tracer.instant("train.straggler", cat="train",
                                    step=step, dt=dt, median=med)
                if self.metrics is not None:
                    self.metrics.counter("train.stragglers").inc()
        self.step_times.append(dt)

    def run(self, num_steps: int, metrics_cb: Optional[Callable] = None):
        losses = []
        retries = 0
        step = self.state.step
        while step < num_steps:
            batch = next(self.data_it)
            t0 = time.perf_counter()
            try:
                params, opt, metrics = self.step_fn(
                    self.state.params, self.state.opt_state, batch)
                _block(metrics["loss"])
            except Exception as e:  # transient failure → restore & retry
                retries += 1
                self.restarts += 1
                self.log(f"[trainer] step {step} failed ({e!r}); "
                         f"retry {retries}/{self.max_retries}")
                self.tracer.instant("train.restart", cat="train", step=step)
                if self.metrics is not None:
                    self.metrics.counter("train.restarts").inc()
                if retries > self.max_retries or not self.maybe_restore():
                    raise
                step = self.state.step
                continue
            retries = 0
            dt = time.perf_counter() - t0
            if self.tracer.enabled:
                self.tracer.complete("train.step", t0, t0 + dt, cat="train",
                                     args={"step": step})
            if self.metrics is not None:
                self.metrics.histogram("train.step_seconds").observe(dt)
            self._watchdog(dt, step)
            if self.tune_cb is not None:
                new_fn = self.tune_cb(dt, step)
                if new_fn is not None:
                    self.step_fn = new_fn
                    self.retunes += 1
                    # old medians describe the old step function
                    self.step_times.clear()
                    self.log(f"[trainer] dynamic-tune: step fn swapped "
                             f"at step {step} (retune #{self.retunes})")
                    self.tracer.instant("train.retune", cat="train",
                                        step=step, retune=self.retunes)
                    if self.metrics is not None:
                        self.metrics.counter("train.retunes").inc()
            self.state = TrainState(params, opt, step + 1)
            losses.append(float(metrics["loss"]))
            if self.mgr is not None:
                self.mgr.maybe_save(step + 1, dict(
                    params=params, opt_state=opt))
            if metrics_cb:
                metrics_cb(step, metrics)
            if step % self.log_every == 0:
                self.log(f"[trainer] step {step} "
                         f"loss {float(metrics['loss']):.4f} "
                         f"({dt*1e3:.1f} ms)")
            step += 1
        if self.mgr is not None:
            self.mgr.wait()
        return losses
