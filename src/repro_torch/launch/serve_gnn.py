"""GNN serving launcher for the port: Zipfian traffic with phase shifts
over the (dynamically re-tuned) MGG pipeline on one card (counterpart of
``repro/launch/serve_gnn.py``).

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
``--feature-capacity N`` serves tiered: the features live in a host store
(pinned on the card) and the card holds only ``N`` hot rows (0 streams
everything); with ``--trace`` three streamed aggregations then run
through the live store and print their overlap efficiency and prefetch
counts.  ``--frontier-fanout F`` bounds the receptive field the traffic
statistics see with a sampled k-hop frontier.

``--replicas N`` serves through a :class:`~repro_torch.serve.ServeCluster`
of N replicas behind a router (``--router load|locality``), each its own
engine over its own virtual ring on the one card.  They share one tuned
config cache (``--tune-cache``, or a temporary file with
``--dynamic-tune``), stagger their drift retunes (drain → retune →
rejoin) and drop no request.  With ``--trace`` each replica records onto
its own tracer, dumped as a JSONL sidecar (``PATH.replicaI.jsonl``,
the cluster's ``PATH.cluster.jsonl``) and merged into one Chrome trace
at ``PATH``; ``python -m repro_torch.obs.validate PATH`` checks it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from .. import core as C
from ..dist import VirtualRing, resolve_device
from ..obs import MetricsRegistry, Tracer, merge_traces
from ..runtime import DynamicGNNEngine, ProfileConfig
from ..serve import (GNNServeEngine, ServeCluster, TrafficPhase,
                     WorkloadStats, ZipfTraffic, make_router, run_trace)
from ..store import FeatureStore


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
                    help="JSON path persisting tuned configs across runs "
                         "(replicas warm-start each other's retunes "
                         "through it)")
    ap.add_argument("--check-every", type=int, default=8,
                    help="micro-batches between traffic-drift checks")
    ap.add_argument("--min-records", type=int, default=8,
                    help="stats records required before drift checks")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of request lifecycles")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot as JSON")
    ap.add_argument("--feature-capacity", type=int, default=None,
                    help="serve tiered: features live in a host store, "
                         "the card holds only this many hot rows "
                         "(0 = stream everything)")
    ap.add_argument("--frontier-fanout", type=int, default=None,
                    help="bound the stats-side receptive field with a "
                         "sampled k-hop frontier of this per-hop fanout; "
                         "cache gating stays exact")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas behind the router")
    ap.add_argument("--router", default="locality",
                    choices=["load", "locality"],
                    help="cluster routing policy (--replicas > 1)")
    return ap


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


def _profile_pipeline(srv, tracer, passes: int = 3) -> Optional[dict]:
    """A few streamed aggregations of the features through the live
    tiered store, so the trace carries the ring's ``mgg.stream.*`` spans
    with their measured overlap efficiency (the values are the resident
    ones; only the schedule is traced).  Returns the prefetch stats."""
    if srv.tiers is None:
        print("[serve_gnn] pipeline profile skipped "
              "(needs --feature-capacity for the tiered streamed path)")
        return None
    stats: dict = {}
    with torch.inference_mode():
        for _ in range(passes):
            srv.eng.aggregate_streamed(srv.tiers, stats=stats, tracer=tracer)
    print(f"[serve_gnn] pipeline profile: overlap efficiency "
          f"{stats.get('overlap_efficiency', 0.0):.3f} "
          f"(prefetch {stats.get('prefetch_inflight', 0)}/"
          f"{stats.get('prefetch_issued', 0)} in flight)")
    return stats


def _dump_obs(args, tracer, registry, engines, replica_tracers=None):
    """Write ``--metrics-json`` (with each dynamic engine's audit trail)
    and ``--trace``.  With per-replica tracers each timeline is dumped as
    a JSONL sidecar and merged into one Chrome trace: the cluster (router,
    drain, rejoin) on one process row, each replica on its own."""
    if args.metrics_json:
        audits = {f"replica{i}": e.eng.audit
                  for i, e in enumerate(engines) if e.dynamic}
        registry.dump_json(args.metrics_json, extra={"audit": audits})
        print(f"[serve_gnn] metrics snapshot: {args.metrics_json}")
    if tracer is None:
        return
    if replica_tracers:
        paths, labels = [], []
        for label, t in [("cluster", tracer)] + [
                (f"replica{i}", rt) for i, rt in enumerate(replica_tracers)]:
            path = f"{args.trace}.{label}.jsonl"
            t.dump_jsonl(path)
            paths.append(path)
            labels.append(label)
        merge_traces(paths, labels, out=args.trace)
        n = len(tracer) + sum(len(t) for t in replica_tracers)
        print(f"[serve_gnn] merged chrome trace: {args.trace} ({n} events "
              f"across {len(paths)} timelines; sidecars {args.trace}.*.jsonl)")
    else:
        tracer.dump_chrome(args.trace)
        print(f"[serve_gnn] chrome trace: {args.trace} "
              f"({len(tracer)} events — open in ui.perfetto.dev)")


def _print_served(rep) -> None:
    print(f"latency p50 {rep['p50'] * 1e3:.2f} ms  "
          f"p99 {rep['p99'] * 1e3:.2f} ms")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Serve two traffic phases; returns the engine's report (the
    cluster's with ``--replicas`` > 1) plus the latency percentiles
    (seconds)."""
    args = _parser().parse_args(argv)
    args.dynamic_tune = args.dynamic_tune or args.per_layer_tune

    dev = resolve_device(args.device)
    tracer = Tracer() if args.trace else None
    registry = MetricsRegistry()

    g, meta = C.paper_dataset(args.dataset, scale=args.scale)
    dim = min(int(meta["dim"]), 64)
    ncls = min(int(meta["classes"]), 16)
    x = np.random.default_rng(args.seed).normal(
        size=(g.num_nodes, dim)).astype(np.float32)
    init, _apply, kw = C.MODEL_ZOO[args.model]
    gen = torch.Generator().manual_seed(args.seed)
    params = init(gen, dim, ncls, device=dev, **kw)

    cache_path = args.tune_cache
    if args.dynamic_tune and args.replicas > 1 and cache_path is None:
        # replicas share ONE cache for cross-replica warm starts
        cache_path = os.path.join(tempfile.mkdtemp(prefix="mgg-serve-"),
                                  "tuned.json")
        print(f"[serve_gnn] shared config cache: {cache_path}")

    def build_replica(idx=0, rep_tracer=None):
        rtr = rep_tracer if rep_tracer is not None else tracer
        ring = VirtualRing(args.devices, dev)
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
                cache_path=cache_path, log_fn=print,
                tracer=rtr, metrics=registry)
        else:
            eng = C.GNNEngine.build(g, ring, ps=8, dist=1,
                                    fuse_update=args.fuse_update)
        store = None
        if args.feature_capacity is not None:
            # the host tier: page-locked on the card, so uploads never block
            store = FeatureStore(x, pin=dev.type == "cuda")
        labels = {"replica": idx} if args.replicas > 1 else {}
        return GNNServeEngine(eng, params, args.model, x, g,
                              slots=args.slots,
                              stats=WorkloadStats(window=args.stats_window),
                              check_every=args.check_every,
                              min_records=args.min_records,
                              use_cache=not args.no_cache,
                              feature_store=store,
                              feature_capacity=args.feature_capacity,
                              frontier_fanout=args.frontier_fanout,
                              frontier_seed=args.seed + idx, log_fn=print,
                              tracer=rtr, metrics=registry,
                              obs_labels=labels)

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
    print(f"[serve_gnn] {args.replicas} x {args.devices} virtual shards "
          f"on {dev}")

    if args.replicas > 1:
        # each replica records onto its own tracer (pid = index + 1; the
        # cluster keeps pid 0), merged into one timeline at the end
        rep_tracers = ([Tracer(pid=i + 1) for i in range(args.replicas)]
                       if tracer is not None else None)
        replicas = [build_replica(i, rep_tracers[i] if rep_tracers else None)
                    for i in range(args.replicas)]
        cluster = ServeCluster(replicas, router=make_router(args.router),
                               log_fn=print, tracer=tracer,
                               metrics=registry)
        results = cluster.run_trace(traffic)
        lat = [r.latency for r in results]
        rep = cluster.report()
        rep.update(p50=_pct(lat, 50), p99=_pct(lat, 99), device=str(dev))
        print(f"cluster: {rep['replicas']} replicas, "
              f"router={rep['router']}, served {rep['served']} "
              f"(dropped {rep['dropped']}, shadow {rep['shadow_served']})")
        _print_served(rep)
        print(f"staggered retunes {rep['staggered_retunes']} "
              f"(deferred {rep['deferred_retunes']})")
        for entry in rep["retune_log"]:
            print(f"  {entry}")
        for i, p in enumerate(rep["per_replica"]):
            print(f"  replica {i}: served {p['served']}, hit rate "
                  f"{p['cache_hit_rate']:.3f}, retunes {p['retunes']}, "
                  f"config {p['config']}")
        if any(p.get("tiers") for p in rep["per_replica"]):
            print(f"tiered features (cluster): "
                  f"{rep['host_rows_streamed']} rows streamed from host, "
                  f"{rep['cache_rows_served']} rows served from the card's "
                  f"cache")
        if args.dynamic_tune:
            for i, r in enumerate(replicas):
                if r.eng.audit:
                    print(f"  replica {i} audit trail:")
                    _print_audit(r.eng.audit, indent="    ")
        if tracer is not None:
            rep["pipeline_profile"] = _profile_pipeline(replicas[0],
                                                        rep_tracers[0])
        _dump_obs(args, tracer, registry, replicas,
                  replica_tracers=rep_tracers)
        return rep

    srv = build_replica()
    results = run_trace(srv, traffic)
    lat = [r.latency for r in results]
    rep = srv.report()
    rep.update(p50=_pct(lat, 50), p99=_pct(lat, 99), device=str(dev))
    print(f"served {rep['served']} requests over {rep['batches']} "
          f"micro-batches (dropped {rep['dropped']})")
    _print_served(rep)
    print(f"cache hit rate {rep['cache_hit_rate']:.3f} "
          f"({rep['cache_stores']} stores, "
          f"{rep['cache_invalidations']} invalidations)")
    if rep["tiers"] is not None:
        t = rep["tiers"]
        print(f"tiered features: cap {t['capacity']} rows "
              f"({t['resident_fraction']:.1%} resident), feature hit rate "
              f"{t['hit_rate']:.3f}, streamed "
              f"{t['host_bytes_streamed'] / 1e6:.1f} MB from host")
    if args.dynamic_tune:
        print(f"retunes {rep['retunes']}, rebuilds {rep['rebuilds']}, "
              f"final config {rep['config']}")
        _print_audit(srv.eng.audit)
    if tracer is not None:
        rep["pipeline_profile"] = _profile_pipeline(srv, tracer)
    _dump_obs(args, tracer, registry, [srv])
    return rep


if __name__ == "__main__":
    main()
