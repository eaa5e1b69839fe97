"""GNN serving launcher for the port: Zipfian traffic with phase shifts
over the static MGG pipeline on one card (counterpart of
``repro/launch/serve_gnn.py``, single-replica static path).

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --dataset products \
        --model gcn --requests 200 --rotate

Serves any of the four models (``--model gcn|gin|sage|gat``) and reports
p50/p99 request latency and the layer-1 cache hit rate.
``--devices N`` is the number of virtual shards of the ring on the card
(default 8); ``--device cpu`` runs on the CPU with the plain versions.
``--trace PATH`` writes a Chrome-trace JSON of the request lifecycles;
``--metrics-json PATH`` writes the metrics snapshot.  The flags of later
slices (drift retuning, tiered features, sampled frontiers, replicas)
are accepted and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from .. import core as C
from ..dist import VirtualRing
from ..obs import MetricsRegistry, Tracer
from ..serve import (GNNServeEngine, TrafficPhase, WorkloadStats,
                     ZipfTraffic, run_trace)


def _pct(lat, q):
    return float(np.percentile(np.asarray(lat), q)) if len(lat) else 0.0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_gnn")
    ap.add_argument("--dataset", default="products")
    ap.add_argument("--model", default="gcn",
                    choices=["gcn", "gin", "sage", "gat"])
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--requests", type=int, default=200,
                    help="requests per phase")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=1.1)
    ap.add_argument("--rate", type=float, default=200.0)
    ap.add_argument("--rotate", action="store_true",
                    help="rotate the hot set at the phase boundary")
    ap.add_argument("--burst", type=float, default=1.0,
                    help="phase-2 rate multiplier (burst load)")
    ap.add_argument("--update-frac", type=float, default=0.02)
    ap.add_argument("--fuse-update", action="store_true",
                    help="run the dense ·W update inside the ring")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual shards of the ring on the card")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    ap.add_argument("--stats-window", type=int, default=32,
                    help="WorkloadStats window")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of request lifecycles")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot as JSON")
    # later slices: accepted so the flag set matches the reference's
    later = ap.add_argument_group("later slices (raise NotImplementedError)")
    later.add_argument("--dynamic-tune", action="store_true")
    later.add_argument("--per-layer-tune", action="store_true")
    later.add_argument("--tune-cache", default=None)
    later.add_argument("--check-every", type=int, default=None)
    later.add_argument("--min-records", type=int, default=None)
    later.add_argument("--feature-capacity", type=int, default=None)
    later.add_argument("--frontier-fanout", type=int, default=None)
    later.add_argument("--replicas", type=int, default=1)
    later.add_argument("--router", default="locality",
                       choices=["load", "locality"])
    return ap


_LATER_FLAGS = [
    ("dynamic_tune", "drift retuning", "tuner"),
    ("per_layer_tune", "per-layer tuning", "tuner"),
    ("tune_cache", "the tuned-config cache", "tuner"),
    ("check_every", "drift checks", "tuner"),
    ("min_records", "drift checks", "tuner"),
    ("feature_capacity", "the tiered feature store", "tiered-store"),
    ("frontier_fanout", "the fanout-bounded frontier", "sampled-blocks"),
]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Serve two traffic phases; returns the engine's report plus the
    latency percentiles (seconds)."""
    args = _parser().parse_args(argv)
    for attr, what, slice_name in _LATER_FLAGS:
        if getattr(args, attr):
            raise NotImplementedError(
                f"{what} arrives with the {slice_name} slice of the port")
    if args.replicas > 1:
        raise NotImplementedError(
            "serving replicas arrive with the cluster slice of the port")

    ring = VirtualRing(args.devices, args.device)
    tracer = Tracer() if args.trace else None
    registry = MetricsRegistry()

    g, meta = C.paper_dataset(args.dataset, scale=args.scale)
    dim = min(int(meta["dim"]), 64)
    ncls = min(int(meta["classes"]), 16)
    x = np.random.default_rng(args.seed).normal(
        size=(g.num_nodes, dim)).astype(np.float32)
    init, _apply, kw = C.MODEL_ZOO[args.model]
    gen = torch.Generator().manual_seed(args.seed)
    params = init(gen, dim, ncls, device=ring.device, **kw)

    eng = C.GNNEngine.build(g, ring, ps=8, dist=1,
                            fuse_update=args.fuse_update)
    srv = GNNServeEngine(eng, params, args.model, x, g,
                         slots=args.slots,
                         stats=WorkloadStats(window=args.stats_window),
                         use_cache=not args.no_cache,
                         tracer=tracer, metrics=registry)

    phases = [
        TrafficPhase(requests=args.requests, alpha=args.alpha,
                     rate=args.rate, seeds_max=min(4, args.slots),
                     update_frac=args.update_frac),
        TrafficPhase(requests=args.requests, alpha=args.alpha,
                     rate=args.rate * args.burst, rotate=args.rotate,
                     seeds_max=min(4, args.slots),
                     update_frac=args.update_frac),
    ]
    traffic = ZipfTraffic(g.num_nodes, dim, phases, seed=args.seed)
    results = run_trace(srv, traffic)
    lat = [r.latency for r in results]
    rep = srv.report()
    rep.update(p50=_pct(lat, 50), p99=_pct(lat, 99), device=str(ring.device))
    print(f"[serve_gnn] {ring.n_dev} virtual shards on {ring.device}")
    print(f"served {rep['served']} requests over {rep['batches']} "
          f"micro-batches (dropped {rep['dropped']})")
    print(f"latency p50 {rep['p50'] * 1e3:.2f} ms  "
          f"p99 {rep['p99'] * 1e3:.2f} ms")
    print(f"cache hit rate {rep['cache_hit_rate']:.3f} "
          f"({rep['cache_stores']} stores, "
          f"{rep['cache_invalidations']} invalidations)")
    if args.metrics_json:
        registry.dump_json(args.metrics_json)
        print(f"[serve_gnn] metrics snapshot: {args.metrics_json}")
    if tracer is not None:
        tracer.dump_chrome(args.trace)
        print(f"[serve_gnn] chrome trace: {args.trace} "
              f"({len(tracer)} events — open in ui.perfetto.dev)")
    return rep


if __name__ == "__main__":
    main()
