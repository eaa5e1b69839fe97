"""GNN training launcher for the port (counterpart of
``examples/train_gnn.py``): full-graph training over the MGG ring, or
sampled mini-batch GraphSAGE over the tiered store, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train_gnn [--steps 100]
        [--model gcn|gin|sage|gat] [--fuse-update] [--devices 8]
        [--sample-fanout F --sample-batch B --feature-capacity C]
        [--device cpu]

The full-graph branch builds the static engine of the reference (``ps=16,
dist=2``) over ``--devices`` virtual shards, takes the loss's gradient
through the ring (its backward is the transposed ring, K4), runs AdamW
and saves a checkpoint every 50 steps, in the reference's layout.
``--sample-fanout F`` switches to fanout-bounded blocks (GraphSAGE only)
whose source rows come from a tiered store: a device hot cache of
``--feature-capacity`` rows (default ``num_nodes // 8``, admitted
hottest-degree first) over the host table, assembled by the row-gather
kernel (K5).  Both report test accuracy.  The demo caps of the reference
hold: ``--scale 0.5`` of the dataset, at most 64 feature dims and 10
classes.  ``--device cpu`` runs on the CPU with the plain versions;
``--trace`` writes a Chrome trace of the steps and ``--metrics-json`` the
metrics snapshot.  The tuner's flags raise ``NotImplementedError``.
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
from ..train import (AdamWConfig, adamw_init, adamw_update, graph_features,
                     value_and_grad)
from ..train import checkpoint as ck

_TUNER_FLAGS = [
    ("dynamic_tune", "online (ps, dist, pb) tuning"),
    ("per_layer_tune", "per-layer tuning"),
    ("tune_fuse", "fused-update tuning"),
    ("tune_cache", "the tuned-config cache"),
]


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
    tuner = ap.add_argument_group("tuner slice (raise NotImplementedError)")
    tuner.add_argument("--dynamic-tune", action="store_true")
    tuner.add_argument("--per-layer-tune", action="store_true")
    tuner.add_argument("--tune-fuse", action="store_true")
    tuner.add_argument("--tune-cache", default="")
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


def _finish(args, tracer, registry) -> None:
    if args.metrics_json:
        registry.dump_json(args.metrics_json, extra={"audit": []})
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
        _step_done(i, t0, dev, tracer, registry, "train.sampled_step",
                   fanout=fanout, batch=batch)
        losses.append(float(loss))
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
    _finish(args, tracer, registry)
    return dict(losses=losses, test_acc=acc, store=rep, device=str(dev),
                params=params)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns the losses, the test accuracy, the device and the
    final parameters (plus the checkpoint directory, full-graph)."""
    ap = _parser()
    args = ap.parse_args(argv)
    for attr, what in _TUNER_FLAGS:
        if getattr(args, attr):
            raise NotImplementedError(
                f"{what} arrives with the tuner slice of the port")
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
    eng = C.GNNEngine.build(g, ring, ps=16, dist=2,
                            fuse_update=args.fuse_update)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=args.steps,
                       weight_decay=0.0)
    pad1 = lambda a: C.pad_table(eng.plan.bounds, eng.plan.rows_per_dev,
                                 a[:, None])[:, 0]
    xp = eng.shard(eng.pad(x))
    yp = torch.from_numpy(pad1(y.astype(np.int32))).to(dev)
    mp = torch.from_numpy(pad1(train_mask.astype(np.float32))).to(dev)

    def loss_fn(p):
        return C.masked_cross_entropy(apply(p, eng, xp), yp, mp)

    workdir = args.workdir or tempfile.mkdtemp(prefix="gnn_ckpt_")
    losses = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss, grads = value_and_grad(loss_fn, params)
        params, opt, _ = adamw_update(grads, opt, params, ocfg)
        _step_done(i, t0, dev, tracer, registry, "train.step")
        losses.append(float(loss))
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
    _finish(args, tracer, registry)
    return dict(losses=losses, test_acc=acc, device=str(dev),
                workdir=workdir, params=params)


if __name__ == "__main__":
    main()
