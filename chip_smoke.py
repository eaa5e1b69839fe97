"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:

1. environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, and the build of the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
2. every kernel against its plain PyTorch version on the card over a
   sweep of shapes (rtol/atol 1e-5), and two launches bitwise equal;
3. serving at full width: GCN serving of the products stand-in at its
   real size (2.45 M nodes, D = 100, 64 classes, hidden 16, 2 layers)
   over 8 virtual shards, through ``GNNServeEngine``/``run_trace``, with
   the kernels' launch counts read around it; every request of the trace
   answered; served logits bitwise equal to the offline forward (full and
   cached passes), and a sample held against the plain-version path at
   rtol 2e-4; the ``pb=4`` aggregation (K2) held against the ``pb=None``
   and the plain-version aggregations at rtol/atol 1e-5;
4. the serving launcher at a small scale;
5. K1–K3 timings at the serving shapes (CUDA events), beside the plain
   versions, one PyTorch library call and the memory-rate bound; each
   kernel held against its plain version on every ring group of those
   shapes at rtol/atol 1e-5;
6. full-graph training at full width: GCN (hidden 16, 2 layers) on the
   same graph with ``graph_features`` data, ``ps=16, dist=2``, 8 virtual
   shards, 10 AdamW steps on the kernels with the launch counts read
   around them; step 0's gradients held against the plain-version path
   (rtol 1e-4), run twice bitwise equal, and a fused step against the
   unfused one (rtol 2e-4); step time by CUDA events, a torch.profiler
   breakdown of one step, and K4 timed at the backward's shapes;
7. GIN, SAGE and GAT: one training step each on a reduced products
   stand-in (``REDUCED_SCALE``: 122,880 nodes, the models' own widths),
   gradients held against the plain-version path (rtol 1e-4) and, for
   GIN and SAGE, the fused step against the unfused one (rtol 2e-4);
8. sampled GraphSAGE at full size (hidden 32 × 2, fanout 10, batch 1024,
   a hot cache of N // 8 rows over the pinned host table): 10 steps with
   the launch counts read around them; ``gather_rows`` bitwise equal to
   ``x[ids]`` at capacities 0, N // 8 and N; K5 timed at the step's
   shapes;
9. the training launcher at a small scale, both branches.

The line before the last is a JSON object of the kernels K1–K5; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
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
SOURCE = {name: "src/repro_torch/kernels/csrc/gather_sum.cu" for name in (
    "gather_sum_pipelined", "gather_sum_blocked", "segment_add_ordered",
    "scatter_sum_ordered")}
SOURCE["gather_rows"] = "src/repro_torch/kernels/csrc/rows.cu"
REPLACES = {
    "gather_sum_pipelined": "src/repro/kernels/neighbor_agg.py:77",
    "gather_sum_blocked": "src/repro/kernels/neighbor_agg.py:209",
    # no Pallas kernel: the per-step scatter-add of the ring
    "segment_add_ordered": "src/repro/core/pipeline.py:313",
    # no Pallas kernel: the gather-sum's custom-VJP backward
    "scatter_sum_ordered": "src/repro/kernels/ops.py:76",
    "gather_rows": "src/repro/kernels/rows.py:31",
}
# the kernels each main path must launch
PATH_KERNELS = {
    "serving": ("gather_sum_pipelined", "gather_sum_blocked",
                "segment_add_ordered"),
    "training": ("gather_sum_pipelined", "segment_add_ordered",
                 "scatter_sum_ordered"),
    "sampled": ("gather_sum_pipelined", "scatter_sum_ordered",
                "gather_rows"),
}
PRODUCTS_SCALE = 199.3   # 12288 · 199.3 ≈ 2.449 M nodes (ogbn-products)
REDUCED_SCALE = 10.0     # 122,880 nodes: GIN, SAGE and GAT, one step each
TRAIN_STEPS = 10
TOL_PLAIN = "rtol 1e-4, atol 1e-4 * max|leaf|"
TOL_FUSED = "rtol 2e-4, atol 2e-4 * max|leaf|"


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
    import repro_torch.kernels as K
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
    _build.build_all()
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
    for d in (1, 16, 100, 130):          # K4: the gather-sum's backward
        for ps, p, t in ((1, 1, 50), (8, 37, 3000), (16, 20000, 3000)):
            nb = gen.integers(0, t, (p, ps))
            nb[: p // 3, 0] = 7                     # a hub row
            mk = gen.random((p, ps)) < 0.8
            mk[1::5] = False                        # all-masked partitions
            nb[~mk] = t - 1            # masked slots name a sentinel row
            nb[mk & (nb == t - 1)] = 0
            tgt = gen.integers(0, 500, p)
            idx = ops.GradIndex.build(nb, mk, tgt, dev)
            g_out = torch.from_numpy(gen.normal(size=(500, d)).astype(
                np.float32)).to(dev)
            base = torch.from_numpy(gen.normal(size=(t, d)).astype(
                np.float32)).to(dev)
            args = (g_out, idx)
            want = ref.scatter_sum_ordered_ref(base.clone(), *args)
            got = ops.scatter_sum_ordered(base.clone(), *args)
            again = ops.scatter_sum_ordered(base.clone(), *args)
            worst = max(worst, held(got, want, f"scatter-sum D={d} P={p}"))
            check(torch.equal(got, again), f"scatter-sum not bitwise D={d}")
            check(torch.equal(got[-1], base[-1]),
                  f"scatter-sum D={d}: the sentinel row got a gradient")
            n_cases += 1
    for d in (1, 16, 100, 130):          # K5: row gather, repeats, sentinels
        for b, t in ((1, 1), (37, 10), (5000, 3000)):
            src = torch.from_numpy(gen.normal(size=(t, d)).astype(
                np.float32)).to(dev)
            ids = gen.integers(0, t, b)
            ids[::7] = ids[0]                       # repeated rows
            ids[3::11] = -1                         # out of range: zero rows
            idx = torch.from_numpy(ids.astype(np.int32)).to(dev)
            want = ref.gather_rows_ref(src, idx)
            got = ops.gather_rows(src, idx)
            check(torch.equal(got, want) and torch.equal(
                got, ops.gather_rows(src, idx)),
                f"gather_rows D={d} B={b} not bitwise its plain version")
            n_cases += 1
    say("kernels_vs_plain", cases=n_cases, max_abs_err=worst,
        tolerance="rtol 1e-5 atol 1e-5 (K5: bitwise)",
        bitwise_relaunch=True)

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

    K.reset_launch_counts()
    t0 = time.perf_counter()
    results = run_trace(srv, events)
    with torch.inference_mode():      # the pb knob of the dynamic engine
        h0 = srv.xp @ params["layers"][0]["w"]
        h_pb = mgg_aggregate(h0, eng.plan, ring, pb=4, arrays=lay0)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {"serving": K.launch_counts()}
    check(all(launches["serving"][k] > 0 for k in PATH_KERNELS["serving"]),
          f"a kernel of the serving path never launched: {launches}")
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
        serve_s=round(t_serve, 3), launches=launches["serving"])
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
    K.reset_launch_counts()
    with torch.inference_mode():
        apply(params, eng, srv.xp)
    torch.cuda.synchronize()
    per_pass = K.launch_counts()   # K2 runs only with pb set

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
        k["launches_per_full_pass"] = per_pass[k["name"]]
    with torch.inference_mode():    # whole passes, as the serving steps run
        h1 = C.apply_stage("gcn", params, eng, srv.xp, 0)
        full_ms = _time(torch, lambda: apply(params, eng, srv.xp), reps=5)
        cached_ms = _time(torch, lambda: C.apply_from_stage(
            "gcn", params, eng, h1, 1), reps=5)
        breakdown = profile_pass(torch, lambda: apply(params, eng, srv.xp))
    say("passes", full_pass_ms=full_ms, cached_pass_ms=cached_ms,
        **breakdown)
    del srv, eng, lay0, offline, plain, h0, h_pb, h1

    # -- 6.-9. training ----------------------------------------------------
    kernels.append(train_full_graph(torch, C, K, g, ring, dev, ncls, rate,
                                    launches))
    train_other_models(torch, C, dev, ncls)
    kernels.append(train_sampled(torch, C, K, g, dev, ncls, rate, launches))
    train_launcher(dev)

    for k in kernels:
        by_path = {p: launches[p][k["name"]] for p in launches
                   if k["name"] in PATH_KERNELS[p]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        k["launches_per_step"] = {p: by_path[p] / TRAIN_STEPS
                                  for p in ("training", "sampled")
                                  if p in by_path}
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
        # device-side events only (kernels, copies): a host op's "self"
        # device time repeats the kernels it launched
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            by_kernel[evt.key[:80]] = us / reps / 1e3
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

    def row(name, ms, plain_ms, lib_ms, lib, nbytes, err):
        return dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=REPLACES[name], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=nbytes / rate * 1e3,
                    bound_by="bytes", library_ms=lib_ms, library=lib,
                    bytes=nbytes, groups=len(groups), partitions=n_p,
                    valid_slots=valid, width=d)

    return [row("gather_sum_pipelined", t_k1, t_plain_g, t_lib_g,
                "embedding_bag", gather_bytes, err_k1),
            row("gather_sum_blocked", t_k2, t_plain_g, t_lib_g,
                "embedding_bag", gather_bytes, err_k2),
            row("segment_add_ordered", t_k3, t_plain_s, t_lib_s,
                "index_add_", seg_bytes, err_k3)]


# ---------------------------------------------------------------------------
# training phases
# ---------------------------------------------------------------------------

def _grads_held(torch, got, want, rtol, what):
    """Every leaf of two gradient trees within ``rtol``, with ``atol =
    rtol · max|want|`` per leaf (a leaf's sums over millions of nodes
    leave entries near zero beside entries of its full scale), and none
    all zero; returns the largest absolute difference."""
    from repro_torch.train.tree import tree_flatten_with_names

    worst = 0.0
    for (name, a), (_, b) in zip(tree_flatten_with_names(got),
                                 tree_flatten_with_names(want)):
        scale = b.abs().max().item()
        check(scale > 0, f"{what}: gradient of {name} is 0")
        check(a.shape == b.shape
              and torch.allclose(a, b, rtol=rtol, atol=rtol * scale),
              f"{what}: gradient of {name} disagrees")
        worst = max(worst, (a - b).abs().max().item())
    return worst


def _bitwise(torch, a_tree, b_tree):
    from repro_torch.train.tree import tree_leaves

    return all(torch.equal(a, b)
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def _fused(eng):
    return dataclasses.replace(eng, layer_plans=[
        dataclasses.replace(lp, fuse_update=True) for lp in eng.layer_plans])


def _tables(torch, C, eng, x, y, train_mask, dev):
    pad1 = lambda a: C.pad_table(eng.plan.bounds, eng.plan.rows_per_dev,
                                 a[:, None])[:, 0]
    return (eng.shard(eng.pad(x)), torch.from_numpy(pad1(y)).to(dev),
            torch.from_numpy(pad1(train_mask.astype(np.float32))).to(dev))


def train_full_graph(torch, C, K, g, ring, dev, ncls, rate, launches):
    """Phase 6: GCN training on the full products stand-in."""
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features, value_and_grad)

    t0 = time.perf_counter()
    d_in = 100
    x, y, train_mask = graph_features(g.num_nodes, d_in, ncls, seed=0)
    eng = C.GNNEngine.build(g, ring, ps=16, dist=2)
    xp, yp, mp = _tables(torch, C, eng, x, y, train_mask, dev)
    del x
    params = C.gcn_init(torch.Generator().manual_seed(0), d_in, ncls,
                        hidden=16, num_layers=2, device=dev)
    arrays = eng.ring_arrays[0]
    groups = arrays.remote_steps + arrays.local_steps
    say("train_built", nodes=g.num_nodes, padded_rows=eng.plan.padded_nodes,
        d_in=d_in, classes=ncls, hidden=16, layers=2, shards=ring.n_dev,
        config=eng.config, groups=len(groups),
        partitions=sum(grp.num_partitions for grp in groups),
        masked_slots=sum(grp.grad.num_slots for grp in groups),
        build_s=round(time.perf_counter() - t0, 3))

    def loss_fn(e):
        return lambda p: C.masked_cross_entropy(C.gcn_apply(p, e, xp), yp, mp)

    # held outside the main path's window: the same step twice, the plain
    # path at full size, and the fused dataflow
    loss_a, g_a = value_and_grad(loss_fn(eng), params)
    loss_b, g_b = value_and_grad(loss_fn(eng), params)
    check(torch.equal(loss_a, loss_b) and _bitwise(torch, g_a, g_b),
          "two runs of step 0 differ")
    t0 = time.perf_counter()
    loss_p, g_p = value_and_grad(
        loss_fn(dataclasses.replace(eng, use_kernel=False)), params)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err_plain = _grads_held(torch, g_a, g_p, 1e-4, "kernels vs plain path")
    loss_f, g_f = value_and_grad(loss_fn(_fused(eng)), params)
    err_fused = _grads_held(torch, g_f, g_a, 2e-4, "fused vs unfused")
    check(torch.allclose(loss_f, loss_a, rtol=2e-4), "fused loss differs")
    say("train_step0_checked", loss=float(loss_a),
        bitwise_twice=True, plain_loss=float(loss_p),
        plain_max_abs_err=err_plain, tolerance_plain=TOL_PLAIN,
        plain_step_s=round(plain_s, 3), fused_loss=float(loss_f),
        fused_max_abs_err=err_fused, tolerance_fused=TOL_FUSED)

    # the main path: TRAIN_STEPS AdamW steps on the kernels
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=TRAIN_STEPS,
                       weight_decay=0.0)
    p, losses, wall = params, [], []
    K.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, grads = value_and_grad(loss_fn(eng), p)
        p, opt, _ = adamw_update(grads, opt, p, ocfg)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if i == 0:
            check(_bitwise(torch, grads, g_a), "step 0 != its held run")
    launches["training"] = counts = K.launch_counts()
    check(all(counts[k] > 0 for k in PATH_KERNELS["training"]),
          f"a kernel of the training path never launched: {counts}")
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    say("train_steps", steps=TRAIN_STEPS, losses=losses,
        step_wall_ms=wall, launches=counts,
        launches_per_step={k: v / TRAIN_STEPS for k, v in counts.items()})

    def one_step():
        loss, grads = value_and_grad(loss_fn(eng), p)
        adamw_update(grads, opt, p, ocfg)

    step_ms = _time(torch, one_step, reps=5, warmup=1)
    breakdown = profile_pass(torch, one_step, reps=2)
    say("train_step_time", step_ms=step_ms, **breakdown)
    return time_scatter(torch, K, arrays, eng.plan, rate, dev)


def train_other_models(torch, C, dev, ncls):
    """Phase 7: one step of GIN, SAGE and GAT on a reduced stand-in."""
    from repro_torch.dist import VirtualRing
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features, value_and_grad)

    g, _ = C.paper_dataset("products", scale=REDUCED_SCALE, seed=0)
    d_in = 100
    x, y, train_mask = graph_features(g.num_nodes, d_in, ncls, seed=0)
    eng = C.GNNEngine.build(g, VirtualRing(8, dev), ps=16, dist=2)
    xp, yp, mp = _tables(torch, C, eng, x, y, train_mask, dev)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=TRAIN_STEPS,
                       weight_decay=0.0)
    for model in ("gin", "sage", "gat"):
        init, apply, kw = C.MODEL_ZOO[model]
        params = init(torch.Generator().manual_seed(0), d_in, ncls,
                      device=dev, **kw)

        def grads(e):
            return value_and_grad(lambda p: C.masked_cross_entropy(
                apply(p, e, xp), yp, mp), params)

        loss, g_k = grads(eng)
        _, g_p = grads(dataclasses.replace(eng, use_kernel=False))
        err = _grads_held(torch, g_k, g_p, 1e-4, f"{model}: kernels vs plain")
        _, g_f = grads(_fused(eng))
        if model == "gat":       # W runs before aggregation: nothing to fuse
            check(_bitwise(torch, g_f, g_k), "gat: fused != unfused")
            err_f = 0.0
        else:
            err_f = _grads_held(torch, g_f, g_k, 2e-4,
                                f"{model}: fused vs unfused")
        p2, _, m = adamw_update(g_k, adamw_init(params), params, ocfg)
        check(np.isfinite(float(loss)) and np.isfinite(float(m["grad_norm"])),
              f"{model}: loss or gradient not finite")
        say("train_model", model=model, nodes=g.num_nodes, **kw,
            loss=float(loss), grad_norm=float(m["grad_norm"]),
            plain_max_abs_err=err, fused_max_abs_err=err_f,
            tolerance_plain=TOL_PLAIN, tolerance_fused=TOL_FUSED)


def train_sampled(torch, C, K, g, dev, ncls, rate, launches):
    """Phase 8: sampled GraphSAGE over the tiered store at full size."""
    from repro_torch.sample import block_tree, sample_blocks, seed_batches
    from repro_torch.store import FeatureStore, TieredFeatures
    from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                                   graph_features, value_and_grad)

    t0 = time.perf_counter()
    n, d_in, fanout, batch = g.num_nodes, 100, 10, 1024
    x, y, train_mask = graph_features(n, d_in, ncls, seed=0)
    store = FeatureStore(x, copy=False, pin=True)
    hot_order = np.argsort(-np.diff(g.indptr))
    tiers = TieredFeatures(store, None, n // 8, device=dev)
    tiers.admit(hot_order[: n // 8])
    params = C.sage_init(torch.Generator().manual_seed(0), d_in, ncls,
                         hidden=32, num_layers=2, device=dev)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=TRAIN_STEPS,
                       weight_decay=0.0)
    rng = np.random.default_rng(0)
    batches = seed_batches(np.nonzero(train_mask)[0], batch, rng=rng)
    say("sampled_built", nodes=n, d_in=d_in, fanout=fanout, batch=batch,
        capacity=tiers.capacity, pinned=True,
        build_s=round(time.perf_counter() - t0, 3))

    def batch_of(seeds, valid):
        blocks = sample_blocks(g, seeds, [fanout, fanout], batch=batch,
                               rng=rng)
        return (blocks, tiers.gather_rows(blocks[0].src_ids),
                block_tree(blocks, dev),
                torch.from_numpy(y[np.clip(seeds, 0, None)]).to(dev),
                torch.from_numpy(valid).to(dev))

    def loss_of(b, use_kernel=True):
        _, h0, bt, yb, mb = b
        return lambda p: C.masked_cross_entropy(
            C.apply_blocks("sage", p, h0, bt, use_kernel=use_kernel), yb, mb)

    # held outside the window: one batch's gradients against the plain path
    b = batch_of(*next(batches))
    _, g_k = value_and_grad(loss_of(b), params)
    _, g_p = value_and_grad(loss_of(b, use_kernel=False), params)
    err = _grads_held(torch, g_k, g_p, 1e-4, "sampled: kernels vs plain")

    p, losses, wall = params, [], []
    K.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        seeds, valid = next(batches)
        t0 = time.perf_counter()
        b = batch_of(seeds, valid)
        loss, grads = value_and_grad(loss_of(b), p)
        p, opt, _ = adamw_update(grads, opt, p, ocfg)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches["sampled"] = counts = K.launch_counts()
    check(all(counts[k] > 0 for k in PATH_KERNELS["sampled"]),
          f"a kernel of the sampled path never launched: {counts}")
    check(all(np.isfinite(losses)), f"sampled loss not finite: {losses}")
    say("sampled_steps", steps=TRAIN_STEPS, losses=losses,
        step_wall_ms=wall, launches=counts, store=tiers.report(),
        plain_max_abs_err=err, tolerance_plain=TOL_PLAIN,
        src_rows=int(b[0][0].num_src))

    # the tiered rows, bitwise x[ids], at capacities 0, N // 8 and N
    ids = b[0][0].src_ids
    x_dev = torch.from_numpy(store.x).to(dev)
    live = torch.from_numpy(ids).to(dev)
    want = torch.where((live >= 0)[:, None], x_dev[live.clamp_min(0)], 0.0)
    del x_dev
    hits = {}
    for cap in (0, n // 8, n):
        t = TieredFeatures(store, None, cap, device=dev)
        if cap:
            t.admit(hot_order[:cap])
        got = t.gather_rows(ids)
        check(torch.equal(got, want), f"gather_rows != x[ids] at cap {cap}")
        hits[cap] = t.report()["hit_rate"]
        del t, got
    say("tiered_rows_checked", bitwise=True, rows=int(ids.size),
        hit_rate_by_capacity=hits)
    return time_gather_rows(torch, K, tiers, ids, rate, dev)


def train_launcher(dev):
    """Phase 9: the training launcher, both branches, at a small scale."""
    from repro_torch.launch import train_gnn

    work = os.path.join(ROOT, "build", "train_gnn_smoke")
    full = train_gnn.main(["--scale", "1", "--steps", "3", "--devices", "8",
                           "--workdir", work])
    sampled = train_gnn.main(["--scale", "1", "--steps", "3", "--model",
                              "sage", "--sample-fanout", "5",
                              "--sample-batch", "256"])
    for rep in (full, sampled):
        check(rep["device"].startswith("cuda")
              and np.isfinite(rep["losses"]).all(),
              "training launcher did not train on the card")
    say("train_launcher", full_losses=full["losses"],
        full_test_acc=full["test_acc"], sampled_losses=sampled["losses"],
        sampled_test_acc=sampled["test_acc"],
        sampled_hit_rate=sampled["store"]["hit_rate"])


def time_scatter(torch, K, arrays, plan, rate, dev):
    """Time one backward aggregation's worth of K4 (every group of the
    training plan, D = 16, the width both GCN layers' gradients carry)."""
    ref = K.ref
    d, rows = 16, plan.padded_nodes
    tile_total = plan.n_dev * plan.tile_rows
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((rows, d), generator=gen, device=dev)
    groups = [(tile_total, grp) for grp in arrays.remote_steps] + \
             [(rows, grp) for grp in arrays.local_steps] + \
             ([(rows, arrays.local)] if arrays.local is not None else [])
    groups = [(n, grp.grad) for n, grp in groups if grp.grad.num_slots]
    outs = [torch.zeros((n, d), device=dev) for n, _ in groups]
    err = max(held(K.neighbor_agg.scatter_sum_ordered(
        torch.zeros((n, d), device=dev), g, ix),
        ref.scatter_sum_ordered_ref(torch.zeros((n, d), device=dev), g, ix),
        "scatter_sum_ordered at the training shapes") for n, ix in groups)
    slot_rows = [ix.rows.long().repeat_interleave(
        (ix.start[1:] - ix.start[:-1]).long()) for _, ix in groups]
    g_slots = [g.index_select(0, ix.src.long()) for _, ix in groups]

    def k4():
        for o, (_, ix) in zip(outs, groups):
            K.neighbor_agg.scatter_sum_ordered(o, g, ix)

    def plain():
        for o, (_, ix) in zip(outs, groups):
            ref.scatter_sum_ordered_ref(o, g, ix)

    def lib():
        for o, r, gs in zip(outs, slot_rows, g_slots):
            o.index_add_(0, r, gs)

    with torch.inference_mode():
        t_plain = _time(torch, plain, reps=2, warmup=1)
        t_k4 = _time(torch, k4)
        t_lib = _time(torch, lib)
    slots = sum(ix.num_slots for _, ix in groups)
    segs = sum(int(ix.rows.numel()) for _, ix in groups)
    distinct_g = sum(int(torch.unique(ix.src).numel()) for _, ix in groups)
    # g's rows read once each, ids and offsets, dbuf's rows read and written
    nbytes = distinct_g * d * 4 + slots * 4 + (2 * segs + len(groups)) * 4 \
        + 2 * segs * d * 4
    return dict(name="scatter_sum_ordered", route="cuda",
                source=SOURCE["scatter_sum_ordered"],
                replaces=REPLACES["scatter_sum_ordered"], max_abs_err=err,
                ms=t_k4, plain_ms=t_plain, bound_ms=nbytes / rate * 1e3,
                bound_by="bytes", library_ms=t_lib, library="index_add_",
                bytes=nbytes, groups=len(groups), masked_slots=slots,
                segments=segs, chunks=sum(ix.num_chunks for _, ix in groups),
                longest_segment=max(int((ix.start[1:] - ix.start[:-1]).max())
                                    for _, ix in groups), width=d)


def time_gather_rows(torch, K, tiers, ids, rate, dev):
    """Time one ``gather_rows`` call's worth of K5 (the cold gather and the
    hot gather of one step's outermost block) at the sampled shapes."""
    ref = K.ref
    pos = np.nonzero(ids >= 0)[0]
    live = ids[pos]
    slots = tiers.cache.slots(live)
    hot = slots >= 0
    n_cold = int((~hot).sum())
    cold_up = tiers.store.upload(live[~hot], dev, pad_rows=1)
    cold_sel = np.full(ids.size, n_cold, np.int32)
    cold_sel[pos[~hot]] = np.arange(n_cold, dtype=np.int32)
    hot_sel = np.zeros(ids.size, np.int32)
    hot_sel[pos[hot]] = slots[hot]
    calls = [(cold_up, torch.from_numpy(cold_sel).to(dev)),
             (tiers.cache.table, torch.from_numpy(hot_sel).to(dev))]
    longs = [idx.long() for _, idx in calls]
    for src, idx in calls:
        check(torch.equal(K.rows.gather_rows(src, idx),
                          ref.gather_rows_ref(src, idx)),
              "gather_rows at the sampled shapes != its plain version")

    def k5():
        for src, idx in calls:
            K.rows.gather_rows(src, idx)

    def plain():
        for src, idx in calls:
            ref.gather_rows_ref(src, idx)

    def lib():
        for (src, _), idx in zip(calls, longs):
            torch.index_select(src, 0, idx)

    with torch.inference_mode():
        t_plain = _time(torch, plain)
        t_k5 = _time(torch, k5)
        t_lib = _time(torch, lib)
    d = cold_up.shape[1]
    # the distinct rows read once each, the ids, the rows written
    nbytes = sum(int(torch.unique(idx).numel()) * d * 4 + idx.numel() * 4
                 + idx.numel() * d * 4 for _, idx in calls)
    return dict(name="gather_rows", route="cuda", source=SOURCE["gather_rows"],
                replaces=REPLACES["gather_rows"], max_abs_err=0.0,
                ms=t_k5, plain_ms=t_plain, bound_ms=nbytes / rate * 1e3,
                bound_by="bytes", library_ms=t_lib, library="index_select",
                bytes=nbytes, rows=int(ids.size), hot_rows=int(hot.sum()),
                cold_rows=n_cold, width=d)


if __name__ == "__main__":
    main()
