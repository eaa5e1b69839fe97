"""GNN training launcher for the port (counterpart of
``examples/train_gnn.py``): full-graph training over the MGG ring, or
sampled mini-batch GraphSAGE over the tiered store, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train_gnn [--steps 100]
        [--model gcn|gin|sage|gat] [--fuse-update] [--devices 8]
        [--dynamic-tune] [--per-layer-tune] [--tune-fuse]
        [--tune-cache PATH]
        [--sample-fanout F --sample-batch B --feature-capacity C]
        [--device cpu]

The full-graph branch builds the static engine of the reference (``ps=16,
dist=2``) over ``--devices`` virtual shards, takes the loss's gradient
through the ring (its backward is the transposed ring, K4), runs AdamW
and saves a checkpoint every 50 steps, in the reference's layout.
``--dynamic-tune`` wraps the engine in
:class:`~repro_torch.runtime.DynamicGNNEngine`: every step's wall time
feeds the online ps → dist → pb search (pb 0 is K1, pb ≥ 1 K2 on the
card), and whenever the tuner moves the plan is rebuilt and the padded
node tables with it — parameters never change, so the loss curve is the
one a static engine gives config for config.  ``--per-layer-tune`` lifts
the search to one config a layer, ``--tune-fuse`` also probes each
layer's fused-update dataflow (both imply ``--dynamic-tune``), and
``--tune-cache`` persists the committed config for the next run.
``--sample-fanout F`` switches to fanout-bounded blocks (GraphSAGE only)
whose source rows come from a tiered store: a device hot cache of
``--feature-capacity`` rows (default ``num_nodes // 8``, admitted
hottest-degree first) over the host table, assembled by the row-gather
kernel (K5); with ``--dynamic-tune`` fanout and batch become the tuner's
knobs (climbed over {F, 2F} × {B, 2B} on per-seed step time) and the loop
adopts them live.  Both report test accuracy.  The demo caps of the reference
hold: ``--scale 0.5`` of the dataset, at most 64 feature dims and 10
classes.  ``--device cpu`` runs on the CPU with the plain versions;
``--trace`` writes a Chrome trace of the steps and ``--metrics-json`` the
metrics snapshot with the tuner's audit trail.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import core as C
from ..dist import VirtualRing, resolve_device
from ..obs import MetricsRegistry, Tracer
from ..runtime import DynamicGNNEngine, ProfileConfig
from ..train import (AdamWConfig, adamw_init, adamw_update, graph_features,
                     value_and_grad)
from ..train import checkpoint as ck


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train_gnn")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--model", default="gcn",
                    choices=["gcn", "gin", "sage", "gat"])
    ap.add_argument("--dataset", default="products")
    ap.add_argument("--scale", type=float, default=0.5,
                    help="dataset scale (the reference's demo uses 0.5)")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--fuse-update", action="store_true",
                    help="run the dense ·W update inside the ring")
    ap.add_argument("--sample-fanout", type=int, default=0,
                    help="train on fanout-bounded sampled mini-batch "
                         "blocks instead of the full graph (sage only; "
                         "0 = full-graph)")
    ap.add_argument("--sample-batch", type=int, default=128,
                    help="seed mini-batch size for --sample-fanout")
    ap.add_argument("--feature-capacity", type=int, default=-1,
                    help="device hot-cache rows for the sampled path's "
                         "tiered store (-1 = num_nodes // 8)")
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual shards of the ring on the card")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write a Chrome-trace JSON of the steps")
    ap.add_argument("--metrics-json", default="", metavar="PATH",
                    help="write the metrics snapshot")
    ap.add_argument("--dynamic-tune", action="store_true",
                    help="online cross-iteration (ps, dist, pb) tuning")
    ap.add_argument("--per-layer-tune", action="store_true",
                    help="tune one (ps, dist, pb) per GNN layer "
                         "(implies --dynamic-tune)")
    ap.add_argument("--tune-fuse", action="store_true",
                    help="let the per-layer tuner probe flipping each "
                         "layer's fused-update dataflow (implies "
                         "--per-layer-tune)")
    ap.add_argument("--tune-cache", default="",
                    help="JSON path persisting tuned configs across runs")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _step_done(i, t0, dev, tracer, registry, name, **args) -> float:
    _sync(dev)
    dt = time.perf_counter() - t0
    if tracer is not None:
        tracer.complete(name, t0, t0 + dt, cat="train",
                        args=dict(step=i, **args))
    registry.histogram("train.step_seconds").observe(dt)
    return dt


def _finish(args, tracer, registry, eng) -> None:
    if args.metrics_json:
        audit = eng.audit if isinstance(eng, DynamicGNNEngine) else []
        registry.dump_json(args.metrics_json, extra={"audit": audit})
        print(f"metrics snapshot: {args.metrics_json}")
    if tracer is not None:
        tracer.dump_chrome(args.trace)
        print(f"chrome trace: {args.trace} ({len(tracer)} events "
              f"— open in ui.perfetto.dev)")


def run_sampled(args, g, x, y, train_mask, dim, ncls, dev, tracer,
                registry) -> dict:
    """Sampled mini-batch GraphSAGE: fanout-bounded blocks over the tiered
    store (host table + device hot cache)."""
    from ..sample import block_tree, sample_blocks, seed_batches
    from ..store import FeatureStore, TieredFeatures

    init, _, kw = C.MODEL_ZOO["sage"]
    params = init(torch.Generator().manual_seed(0), dim, ncls, device=dev,
                  **kw)
    n_layers = len(params["layers"])
    fanout, batch = args.sample_fanout, args.sample_batch

    eng = None
    if args.dynamic_tune:
        # schedule knobs pinned (the ring plan is idle here — blocks
        # aggregate locally); the search space is the sampling geometry,
        # whose moves keep the one plan built here
        eng = DynamicGNNEngine.build(
            g, VirtualRing(args.devices, dev), d_feat=dim,
            ps_space=(8,), dist_space=(1,), pb_space=(0,),
            fanout_space=(fanout, 2 * fanout),
            batch_space=(batch, 2 * batch),
            window=ProfileConfig(warmup=1, iters=2),
            cache_path=args.tune_cache or None, log_fn=print,
            tracer=tracer, metrics=registry)
        fanout = eng.sample_fanout or fanout
        batch = eng.sample_batch or batch

    store = FeatureStore(x, pin=dev.type == "cuda")
    cap = args.feature_capacity if args.feature_capacity >= 0 \
        else g.num_nodes // 8
    tiers = TieredFeatures(store, None, capacity=cap, device=dev)
    if cap:
        # degree order ≈ the Zipfian head: hubs land in most samples
        tiers.admit(np.argsort(-np.diff(g.indptr))[:cap])

    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=args.steps,
                       weight_decay=0.0)
    rng = np.random.default_rng(0)
    train_ids = np.nonzero(train_mask)[0]

    def minibatches():
        while True:   # resample every epoch: new draw, new neighbors
            yield from seed_batches(train_ids, batch, rng=rng)

    def forward(p, seeds):
        blocks = sample_blocks(g, seeds, [fanout] * n_layers, batch=batch,
                               rng=rng)
        h0 = tiers.gather_rows(blocks[0].src_ids)
        return C.apply_blocks("sage", p, h0, block_tree(blocks, dev))

    batches = minibatches()
    losses = []
    for i in range(args.steps):
        seeds, valid = next(batches)
        t0 = time.perf_counter()
        yb = torch.from_numpy(y[np.clip(seeds, 0, None)]).to(dev)
        mb = torch.from_numpy(valid).to(dev)
        loss, grads = value_and_grad(
            lambda p: C.masked_cross_entropy(forward(p, seeds), yb, mb),
            params)
        params, opt, _ = adamw_update(grads, opt, params, ocfg)
        dt = _step_done(i, t0, dev, tracer, registry, "train.sampled_step",
                        fanout=fanout, batch=batch)
        losses.append(float(loss))
        if eng is not None and eng.observe_step(dt / batch):
            # per-seed latency drives the climb; adopt the tuned geometry
            fanout = eng.sample_fanout or fanout
            batch = eng.sample_batch or batch
            batches = minibatches()
        if i % 10 == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"(fanout {fanout}, batch {batch})")

    # sampled inference over the held-out nodes, same block machinery
    test_ids = np.nonzero(~train_mask)[0]
    correct = total = 0
    with torch.no_grad():
        for seeds, valid in seed_batches(test_ids, batch, rng=rng,
                                         shuffle=False):
            pred = forward(params, seeds).argmax(-1).cpu().numpy()
            live = valid > 0
            correct += int((pred[live] == y[seeds[live]]).sum())
            total += int(live.sum())
    rep = tiers.report()
    acc = correct / max(1, total)
    print(f"final loss {losses[-1]:.4f}; sampled test acc {acc:.3f}")
    print(f"tiered store: cap {rep['capacity']} rows, hit rate "
          f"{rep['hit_rate']:.3f}, "
          f"{rep['host_rows_streamed']} host rows streamed")
    if eng is not None:
        print(f"tuned config: {eng.config} after "
              f"{eng.tuner.measured} measurements")
    _finish(args, tracer, registry, eng)
    return dict(losses=losses, test_acc=acc, store=rep, device=str(dev),
                params=params, fanout=fanout, batch=batch,
                config=eng.config if eng is not None else None)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the losses, the test accuracy, the device and the
    final parameters (plus the checkpoint directory, full-graph)."""
    ap = _parser()
    args = ap.parse_args(argv)
    args.per_layer_tune = args.per_layer_tune or args.tune_fuse
    args.dynamic_tune = args.dynamic_tune or args.per_layer_tune
    if args.sample_fanout and args.model != "sage":
        ap.error("--sample-fanout requires --model sage "
                 "(block aggregation is GraphSAGE-only)")
    dev = resolve_device(args.device)
    tracer = Tracer() if args.trace else None
    registry = MetricsRegistry()

    g, meta = C.paper_dataset(args.dataset, scale=args.scale)
    # demo-friendly label space, as the reference's demo
    ncls = min(int(meta["classes"]), 10)
    dim = min(int(meta["dim"]), 64)
    x, y, train_mask = graph_features(g.num_nodes, dim, ncls, seed=0)
    if args.sample_fanout:
        return run_sampled(args, g, x, y, train_mask, dim, ncls, dev,
                           tracer, registry)

    ring = VirtualRing(args.devices, dev)
    init, apply, kw = C.MODEL_ZOO[args.model]
    params = init(torch.Generator().manual_seed(0), dim, ncls, device=dev,
                  **kw)
    if args.dynamic_tune:
        layer_dims = C.aggregation_widths(args.model, params,
                                          fused=args.fuse_update) \
            if args.per_layer_tune else None
        # pb 0 is K1; pb 1-4 K2 (collapsed off the card)
        eng = DynamicGNNEngine.build(
            g, ring, d_feat=dim,
            ps_space=(1, 2, 4, 8, 16, 32), dist_space=(1, 2, 4),
            pb_space=(0, 1, 2, 4),
            window=ProfileConfig(warmup=1, iters=2),
            cache_path=args.tune_cache or None,
            fuse_update=args.fuse_update, tune_fuse=args.tune_fuse,
            layer_dims=layer_dims, log_fn=print,
            tracer=tracer, metrics=registry)
    else:
        eng = C.GNNEngine.build(g, ring, ps=16, dist=2,
                                fuse_update=args.fuse_update)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=args.steps,
                       weight_decay=0.0)

    def prepare():
        """Pad the node tables for the CURRENT plan (the layout moves
        with dist)."""
        pad1 = lambda a: C.pad_table(eng.plan.bounds, eng.plan.rows_per_dev,
                                     a[:, None])[:, 0]
        return (eng.shard(eng.pad(x)),
                torch.from_numpy(pad1(y.astype(np.int32))).to(dev),
                torch.from_numpy(pad1(train_mask.astype(np.float32))).to(dev))

    xp, yp, mp = prepare()
    workdir = args.workdir or tempfile.mkdtemp(prefix="gnn_ckpt_")
    losses = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda p: C.masked_cross_entropy(apply(p, eng, xp), yp, mp),
            params)
        params, opt, _ = adamw_update(grads, opt, params, ocfg)
        dt = _step_done(i, t0, dev, tracer, registry, "train.step")
        losses.append(float(loss))
        if args.dynamic_tune and eng.observe_step(dt):
            # the tuner moved: the plan (and maybe the padded layout)
            # changed — re-pad; params are untouched
            xp, yp, mp = prepare()
        if i % 10 == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}")
        if (i + 1) % 50 == 0:
            ck.save(workdir, i + 1, dict(params=params))
    with torch.no_grad():
        logits = C.unpad_embeddings(eng.plan,
                                    apply(params, eng, xp).cpu().numpy())
    pred = logits.argmax(-1)
    test = ~train_mask
    acc = float((pred[test] == y[test]).mean())
    print(f"[train_gnn] {ring.n_dev} virtual shards on {ring.device}")
    print(f"final loss {losses[-1]:.4f}; test acc {acc:.3f}; "
          f"checkpoints in {workdir}")
    if args.dynamic_tune:
        print(f"tuned config: {eng.config} after "
              f"{eng.tuner.measured} measurements "
              f"({len(eng.history) - 1} swaps)")
    _finish(args, tracer, registry, eng)
    return dict(losses=losses, test_acc=acc, device=str(dev),
                workdir=workdir, params=params,
                config=eng.config)


if __name__ == "__main__":
    main()
