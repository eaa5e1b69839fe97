"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:

1. environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, and the build of the CUDA kernels from
   ``src/repro_torch/kernels/csrc``;
2. every kernel against its plain PyTorch version on the card over a
   sweep of shapes (rtol/atol 1e-5), and two launches bitwise equal;
3. the main path at full width: GCN serving of the products stand-in at
   its real size (2.45 M nodes, D = 100, 64 classes, hidden 16, 2 layers)
   over 8 virtual shards, through ``GNNServeEngine``/``run_trace``, with
   the kernels' launch counts read around it; every request of the trace
   answered; served logits bitwise equal to the offline forward (full and
   cached passes), and a sample held against the plain-version path at
   rtol 2e-4; the ``pb=4`` aggregation (K2) held against the ``pb=None``
   and the plain-version aggregations at rtol/atol 1e-5;
4. the launcher entry point at a small scale;
5. kernel timings at the main path's shapes (CUDA events), beside the
   plain versions, one PyTorch library call and the memory-rate bound;
   each kernel held against its plain version on every ring group of
   those shapes at rtol/atol 1e-5.

The line before the last is a JSON object of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

CARD_RATES = [  # (name fragments, bytes/s): NVIDIA data sheets, dense
    (("H200",), 4.8e12),
    (("H100", "PCIE"), 2.0e12),
    (("H100", "NVL"), 3.9e12),
    (("H100",), 3.35e12),    # SXM (HBM3)
]
SOURCE = "src/repro_torch/kernels/csrc/gather_sum.cu"
REPLACES = {
    "gather_sum_pipelined": "src/repro/kernels/neighbor_agg.py:77",
    "gather_sum_blocked": "src/repro/kernels/neighbor_agg.py:209",
    # no Pallas kernel: the per-step scatter-add of the ring
    "segment_add_ordered": "src/repro/core/pipeline.py:313",
}
PRODUCTS_SCALE = 199.3   # 12288 · 199.3 ≈ 2.449 M nodes (ogbn-products)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def held(got, want, what):
    """Hold a kernel's output to its plain version (rtol/atol 1e-5);
    returns the largest absolute difference."""
    check(got.shape == want.shape
          and got.allclose(want, rtol=1e-5, atol=1e-5),
          f"{what}: disagrees with its plain version")
    return (got - want).abs().max().item()


def say(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw), default=str), flush=True)


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from the repository")
    sys.path.insert(0, SRC)

    import repro_torch.core as C
    from repro_torch.core.pipeline import mgg_aggregate
    from repro_torch.dist import VirtualRing
    from repro_torch.kernels import _build, neighbor_agg, ops, ref
    from repro_torch.launch import serve_gnn
    from repro_torch.serve import (GNNServeEngine, TrafficPhase,
                                   WorkloadStats, ZipfTraffic, run_trace)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. environment -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    rate = next((r for frags, r in CARD_RATES
                 if all(f in name.upper() for f in frags)), None)
    check(rate is not None, f"no memory rate on record for {name}")
    t0 = time.perf_counter()
    _build.library()
    say("environment", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=name,
        kernel_build_s=round(time.perf_counter() - t0, 3),
        nvcc_s=_build.build_seconds, peak_bytes_per_s=rate)

    # -- 2. kernels against their plain versions ---------------------------
    gen = np.random.default_rng(0)
    n_cases, worst = 0, 0.0
    for d in (1, 16, 100, 130, 602):
        for ps in (1, 8, 16):
            for p in (1, 37, 1000):            # 37, 1000: not multiples of pb
                for all_masked in (False, True):
                    t = 3000
                    buf = torch.from_numpy(gen.normal(size=(t, d)).astype(
                        np.float32)).to(dev)
                    nbrs = torch.from_numpy(gen.integers(
                        0, t, (p, ps)).astype(np.int32)).to(dev)
                    mask = torch.from_numpy(
                        np.zeros((p, ps), bool) if all_masked
                        else gen.random((p, ps)) < 0.8).to(dev)
                    want = ref.neighbor_gather_sum_ref(buf, nbrs, mask)
                    for pb in (None, 1, 4, 8):
                        got = ops.neighbor_gather_sum(buf, nbrs, mask, pb=pb)
                        again = ops.neighbor_gather_sum(buf, nbrs, mask,
                                                        pb=pb)
                        worst = max(worst, held(
                            got, want,
                            f"gather-sum D={d} ps={ps} P={p} pb={pb}"))
                        check(torch.equal(got, again),
                              f"gather-sum not bitwise stable D={d} pb={pb}")
                        n_cases += 1
    for d in (1, 16, 100, 602):
        rows, p = 500, 20000
        tgt = np.concatenate([np.sort(gen.zipf(1.5, p - 64) % rows),
                              np.zeros(64, np.int64)])  # padded tail
        grp = C.WorkGroup.build(np.zeros((p, 1)), np.ones((p, 1), bool), tgt,
                                dev)
        partial = torch.from_numpy(gen.normal(size=(p, d)).astype(
            np.float32)).to(dev)
        out0 = torch.from_numpy(gen.normal(size=(rows, d)).astype(
            np.float32)).to(dev)
        segs = (grp.order, grp.seg_rows, grp.seg_start)
        want = ref.segment_add_ordered_ref(out0.clone(), partial, *segs)
        got = ops.segment_add_ordered(out0.clone(), partial, *segs)
        again = ops.segment_add_ordered(out0.clone(), partial, *segs)
        worst = max(worst, held(got, want, f"segment add D={d}"))
        check(torch.equal(got, again), f"segment add not bitwise D={d}")
        n_cases += 1
    say("kernels_vs_plain", cases=n_cases, max_abs_err=worst,
        tolerance="rtol 1e-5 atol 1e-5", bitwise_relaunch=True)

    # -- 3. the main path at full width ------------------------------------
    t0 = time.perf_counter()
    g, meta = C.paper_dataset("products", scale=PRODUCTS_SCALE, seed=0)
    d_in, ncls = int(meta["dim"]), int(meta["classes"])
    x = np.random.default_rng(0).normal(
        size=(g.num_nodes, d_in)).astype(np.float32)
    ring = VirtualRing(8, dev)
    init, apply, kw = C.MODEL_ZOO["gcn"]
    params = init(torch.Generator().manual_seed(0), d_in, ncls,
                  device=dev, **kw)
    eng = C.GNNEngine.build(g, ring, ps=8, dist=1)
    srv = GNNServeEngine(eng, params, "gcn", x, g, slots=8,
                         stats=WorkloadStats(window=32))
    t_build = time.perf_counter() - t0
    say("main_path_built", nodes=g.num_nodes, edges=g.num_edges,
        edges_with_self_loops=srv.g_full.num_edges, d_in=d_in, classes=ncls,
        shards=ring.n_dev, config=eng.config, build_s=round(t_build, 3),
        gpu_mem_gb=round(torch.cuda.memory_allocated() / 1e9, 3))

    phases = [TrafficPhase(requests=200, alpha=1.1, rate=200.0, seeds_max=4,
                           update_frac=0.02),
              TrafficPhase(requests=200, alpha=1.1, rate=200.0, rotate=True,
                           seeds_max=4, update_frac=0.02)]
    events = list(ZipfTraffic(g.num_nodes, d_in, phases, seed=0))
    n_requests = sum(not ev.is_update for ev in events)
    lay0 = eng.ring_arrays[0]

    neighbor_agg.reset_launch_counts()
    t0 = time.perf_counter()
    results = run_trace(srv, events)
    with torch.inference_mode():      # the pb knob of the dynamic engine
        h0 = srv.xp @ params["layers"][0]["w"]
        h_pb = mgg_aggregate(h0, eng.plan, ring, pb=4, arrays=lay0)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = neighbor_agg.launch_counts()
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    lat = np.array([r.latency for r in results])
    rep = srv.report()
    check(n_requests > 0 and len(results) == rep["served"] == n_requests
          and sorted(r.request_id for r in results) == list(range(n_requests)),
          f"{n_requests} requests in the trace, {len(results)} answered")
    say("main_path_served", requests=len(results), batches=rep["batches"],
        cached_requests=int(sum(r.cached for r in results)),
        p50_ms=float(np.percentile(lat, 50) * 1e3),
        p99_ms=float(np.percentile(lat, 99) * 1e3),
        cache_hit_rate=rep["cache_hit_rate"],
        cache_invalidations=rep["cache_invalidations"],
        serve_s=round(t_serve, 3), launches=launches)
    check(all(np.isfinite(r.logits).all() and r.logits.shape ==
              (r.seeds.size, ncls) for r in results), "bad served logits")

    # served == offline, bitwise, through a full and a cached pass
    seeds = np.unique(np.concatenate([r.seeds for r in results[:3]]))[:8]
    srv.cache.invalidate()
    srv.submit(seeds)
    (full,) = srv.step()
    srv.submit(seeds)
    (cached,) = srv.step()
    check(not full.cached and cached.cached, "full/cached passes not taken")
    with torch.inference_mode():
        offline = apply(params, eng, srv.xp)
        plain = apply(params, dataclasses.replace(eng, use_kernel=False),
                      srv.xp)
    rows = torch.from_numpy(C.pgas_rows(eng.plan, seeds).astype(np.int64))
    off_rows = offline[rows.to(dev)].cpu().numpy()
    check(np.array_equal(full.logits, off_rows), "full pass != offline")
    check(np.array_equal(cached.logits, off_rows), "cached pass != offline")
    sample = torch.from_numpy(np.random.default_rng(1).choice(
        eng.plan.padded_nodes, min(4096, eng.plan.padded_nodes),
        replace=False)).to(dev)
    check(torch.allclose(offline[sample], plain[sample], rtol=2e-4,
                         atol=1e-5), "kernel path != plain path")
    check(np.allclose(cached.logits, plain[rows.to(dev)].cpu().numpy(),
                      rtol=2e-4, atol=1e-5), "served != plain path")
    with torch.inference_mode():      # K2's aggregation, on the same arrays
        err_pb = max(
            held(h_pb, mgg_aggregate(h0, eng.plan, ring, arrays=lay0),
                 "pb=4 aggregation against pb=None"),
            held(h_pb, mgg_aggregate(h0, eng.plan, ring, use_kernel=False,
                                     arrays=lay0),
                 "pb=4 aggregation against the plain path"))
    say("main_path_checked", served_equals_offline="bitwise (full, cached)",
        plain_max_abs_err=float((offline[sample] - plain[sample]).abs()
                                .max()),
        tolerance_plain="rtol 2e-4 atol 1e-5", pb4_max_abs_err=err_pb,
        tolerance_pb4="rtol 1e-5 atol 1e-5")

    # launches of one full forward pass
    neighbor_agg.reset_launch_counts()
    with torch.inference_mode():
        apply(params, eng, srv.xp)
    torch.cuda.synchronize()
    per_pass = neighbor_agg.launch_counts()   # K2 runs only with pb set

    # -- 4. the launcher ----------------------------------------------------
    rep_small = serve_gnn.main(["--scale", "1", "--requests", "30",
                                "--rotate", "--devices", "8"])
    check(rep_small["served"] > 0 and rep_small["device"].startswith("cuda"),
          "launcher did not serve on the card")
    say("launcher", served=rep_small["served"], p50_ms=rep_small["p50"] * 1e3)

    # -- 5. timings at the main path's shapes ------------------------------
    kernels = time_kernels(torch, eng, srv, params, ref, neighbor_agg, lay0,
                           rate)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_per_full_pass"] = per_pass[k["name"]]
    with torch.inference_mode():    # whole passes, as the serving steps run
        h1 = C.apply_stage("gcn", params, eng, srv.xp, 0)
        full_ms = _time(torch, lambda: apply(params, eng, srv.xp), reps=5)
        cached_ms = _time(torch, lambda: C.apply_from_stage(
            "gcn", params, eng, h1, 1), reps=5)
        breakdown = profile_pass(torch, lambda: apply(params, eng, srv.xp))
    say("passes", full_pass_ms=full_ms, cached_pass_ms=cached_ms,
        **breakdown)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def _time(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_pass(torch, fn, reps=3):
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler),
    beside the host-clock time of the same calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    by_kernel = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            by_kernel[evt.key] = us / reps / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return dict(profiled_wall_ms=wall_ms, device_ms_sum=busy,
                device_ms_by_kernel=dict(top))


def time_kernels(torch, eng, srv, params, ref, neighbor_agg, arrays, rate):
    """Time one aggregation's worth of each kernel (every group of the
    products plan: 7 remote ring steps + 7 interleaved local slices, D=16,
    the width both GCN layers aggregate at) with its real layer-0 input."""
    import torch.nn.functional as F

    with torch.inference_mode():
        dinv = torch.rsqrt(eng.deg)[:, None]
        h = ((srv.xp @ params["layers"][0]["w"]) * dinv).contiguous()
        d = h.shape[1]
        n_dev, tile_rows = eng.plan.n_dev, eng.plan.tile_rows
        tiles = h.view(n_dev, tile_rows, d)
        cur = torch.roll(tiles, 1, 0).contiguous().view(-1, d)
        groups = [(cur, g) for g in arrays.remote_steps] + \
                 [(h, g) for g in arrays.local_steps]
        groups = [(b, g) for b, g in groups if g.num_partitions]
        out0 = torch.zeros_like(h)
        partials = [neighbor_agg.gather_sum_pipelined(b, g.nbrs, g.mask)
                    for b, g in groups]
        w = [g.mask.float() for _, g in groups]
        nb_long = [g.nbrs.long() for _, g in groups]
        tgt = [g.seg_rows.long().repeat_interleave(
            (g.seg_start[1:] - g.seg_start[:-1]).long()) for _, g in groups]
        srt = [p.index_select(0, g.order.long())
               for p, (_, g) in zip(partials, groups)]

        valid = sum(int(g.mask.sum()) for _, g in groups)
        n_p = sum(g.num_partitions for _, g in groups)
        ps = groups[0][1].nbrs.shape[1]
        n_seg = sum(int(g.seg_rows.numel()) for _, g in groups)
        gather_bytes = valid * d * 4 + n_p * ps * (4 + 1) + n_p * d * 4
        seg_bytes = n_p * d * 4 + n_p * 4 + n_seg * 4 * 2 + n_seg * d * 4 * 2

        def k1():
            for b, g in groups:
                neighbor_agg.gather_sum_pipelined(b, g.nbrs, g.mask)

        def k2():
            for b, g in groups:
                neighbor_agg.gather_sum_blocked(b, g.nbrs, g.mask, pb=4)

        def plain_gather():
            for b, g in groups:
                ref.neighbor_gather_sum_ref(b, g.nbrs, g.mask)

        def lib_gather():
            for (b, g), nb, ww in zip(groups, nb_long, w):
                F.embedding_bag(nb, b, mode="sum", per_sample_weights=ww)

        outs = [out0.clone() for _ in groups]

        def k3():
            for o, p, (_, g) in zip(outs, partials, groups):
                neighbor_agg.segment_add_ordered(o, p, g.order, g.seg_rows,
                                                 g.seg_start)

        def plain_seg():
            for o, p, (_, g) in zip(outs, partials, groups):
                ref.segment_add_ordered_ref(o, p, g.order, g.seg_rows,
                                            g.seg_start)

        def lib_seg():
            for o, s, t in zip(outs, srt, tgt):
                o.index_add_(0, t, s)

        # each kernel held to its plain version on every group
        err_k1 = max(held(neighbor_agg.gather_sum_pipelined(b, g.nbrs, g.mask),
                          ref.neighbor_gather_sum_ref(b, g.nbrs, g.mask),
                          "gather_sum_pipelined at the main path's shapes")
                     for b, g in groups)
        err_k2 = max(held(neighbor_agg.gather_sum_blocked(b, g.nbrs, g.mask,
                                                          pb=4),
                          ref.neighbor_gather_sum_ref(b, g.nbrs, g.mask),
                          "gather_sum_blocked at the main path's shapes")
                     for b, g in groups)
        err_k3 = max(held(neighbor_agg.segment_add_ordered(
            out0.clone(), p, g.order, g.seg_rows, g.seg_start),
            ref.segment_add_ordered_ref(out0.clone(), p, g.order,
                                        g.seg_rows, g.seg_start),
            "segment_add_ordered at the main path's shapes")
            for p, (_, g) in zip(partials, groups))

        # plain and library calls around the kernels: plain, kernel,
        # kernel, plain in one process on one card
        t_plain_g = _time(torch, plain_gather, reps=5)
        t_k1 = _time(torch, k1)
        t_k2 = _time(torch, k2)
        t_lib_g = _time(torch, lib_gather)
        t_k3 = _time(torch, k3)
        t_lib_s = _time(torch, lib_seg)
        t_plain_s = _time(torch, plain_seg, reps=2, warmup=1)

    def row(name, ms, plain_ms, lib_ms, nbytes, err):
        return dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=nbytes / rate * 1e3,
                    bound_by="bytes", library_ms=lib_ms, bytes=nbytes,
                    groups=len(groups), partitions=n_p, valid_slots=valid,
                    width=d)

    return [row("gather_sum_pipelined", t_k1, t_plain_g, t_lib_g,
                gather_bytes, err_k1),
            row("gather_sum_blocked", t_k2, t_plain_g, t_lib_g,
                gather_bytes, err_k2),
            row("segment_add_ordered", t_k3, t_plain_s, t_lib_s, seg_bytes,
                err_k3)]


if __name__ == "__main__":
    main()
