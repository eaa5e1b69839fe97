"""GNN serving launcher for the port: Zipfian traffic with phase shifts
over the (dynamically re-tuned) MGG pipeline on one card (counterpart of
``repro/launch/serve_gnn.py``, single replica).

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --dataset products \
        --model gcn --requests 200 --rotate [--dynamic-tune]

Serves any of the four models (``--model gcn|gin|sage|gat``) and reports
p50/p99 request latency and the layer-1 cache hit rate.
``--devices N`` is the number of virtual shards of the ring on the card
(default 8); ``--device cpu`` runs on the CPU with the plain versions.
``--trace PATH`` writes a Chrome-trace JSON of the request lifecycles;
``--metrics-json PATH`` writes the metrics snapshot with the tuner's
audit trail.  ``--dynamic-tune`` serves through a
:class:`~repro_torch.runtime.DynamicGNNEngine` that re-tunes ``(ps,
dist)`` when the traffic drifts (checked every ``--check-every``
micro-batches once ``--min-records`` are in the window);
``--per-layer-tune`` tunes one config a layer (implies
``--dynamic-tune``), ``--tune-cache`` persists the committed configs.
The flags of later slices (tiered features, sampled frontiers, replicas)
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
from ..runtime import DynamicGNNEngine, ProfileConfig
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
    ap.add_argument("--dynamic-tune", action="store_true",
                    help="re-tune (ps, dist) under traffic drift")
    ap.add_argument("--per-layer-tune", action="store_true",
                    help="one (ps, dist, pb) per GNN layer "
                         "(implies --dynamic-tune)")
    ap.add_argument("--tune-cache", default=None,
                    help="JSON path persisting tuned configs across runs")
    ap.add_argument("--check-every", type=int, default=8,
                    help="micro-batches between traffic-drift checks")
    ap.add_argument("--min-records", type=int, default=8,
                    help="stats records required before drift checks")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of request lifecycles")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot as JSON")
    # later slices: accepted so the flag set matches the reference's
    later = ap.add_argument_group("later slices (raise NotImplementedError)")
    later.add_argument("--feature-capacity", type=int, default=None)
    later.add_argument("--frontier-fanout", type=int, default=None)
    later.add_argument("--replicas", type=int, default=1)
    later.add_argument("--router", default="locality",
                       choices=["load", "locality"])
    return ap


_LATER_FLAGS = [
    ("feature_capacity", "the tiered feature store",
     "tiered-store slice (ROADMAP item 5)"),
    ("frontier_fanout", "the fanout-bounded frontier",
     "sampled-frontier slice (ROADMAP item 6)"),
]


def _print_audit(audit, indent: str = "  ") -> None:
    """Print the retune trail from the tuner's audit events (one line a
    non-probe event)."""
    for ev in audit:
        if ev["event"] == "probe":
            continue                       # one line per probe is too chatty
        detail = ", ".join(f"{k}={v}" for k, v in ev.items()
                           if k not in ("event", "measured"))
        print(f"{indent}[{ev['measured']:4d} measured] "
              f"{ev['event']}: {detail}")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Serve two traffic phases; returns the engine's report plus the
    latency percentiles (seconds)."""
    args = _parser().parse_args(argv)
    for attr, what, slice_name in _LATER_FLAGS:
        if getattr(args, attr) is not None:
            raise NotImplementedError(
                f"{what} arrives with the {slice_name} of the port")
    if args.replicas > 1:
        raise NotImplementedError(
            "serving replicas arrive with the cluster slice of the port "
            "(ROADMAP item 7)")
    args.dynamic_tune = args.dynamic_tune or args.per_layer_tune

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

    if args.dynamic_tune:
        layer_dims = C.aggregation_widths(args.model, params,
                                          fused=args.fuse_update) \
            if args.per_layer_tune else None
        eng = DynamicGNNEngine.build(
            g, ring, d_feat=dim,
            ps_space=(1, 2, 4, 8, 16), dist_space=(1, 2, 4),
            pb_space=(0,),
            window=ProfileConfig(warmup=1, iters=2),
            fuse_update=args.fuse_update, layer_dims=layer_dims,
            cache_path=args.tune_cache, log_fn=print,
            tracer=tracer, metrics=registry)
    else:
        eng = C.GNNEngine.build(g, ring, ps=8, dist=1,
                                fuse_update=args.fuse_update)
    srv = GNNServeEngine(eng, params, args.model, x, g,
                         slots=args.slots,
                         stats=WorkloadStats(window=args.stats_window),
                         check_every=args.check_every,
                         min_records=args.min_records,
                         use_cache=not args.no_cache, log_fn=print,
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
    if args.dynamic_tune:
        print(f"retunes {rep['retunes']}, rebuilds {rep['rebuilds']}, "
              f"final config {rep['config']}")
        _print_audit(srv.eng.audit)
    if args.metrics_json:
        audit = {"replica0": srv.eng.audit} if args.dynamic_tune else {}
        registry.dump_json(args.metrics_json, extra={"audit": audit})
        print(f"[serve_gnn] metrics snapshot: {args.metrics_json}")
    if tracer is not None:
        tracer.dump_chrome(args.trace)
        print(f"[serve_gnn] chrome trace: {args.trace} "
              f"({len(tracer)} events — open in ui.perfetto.dev)")
    return rep


if __name__ == "__main__":
    main()
