"""Time the designs of K5 (the row gather) on the card, each as a build of
``src/repro_torch/kernels/csrc/rows.cu`` beside the kept source, in one
process and in turns.

    python3 tools/k5_variants.py [--parent PATH] [--out PATH]

Each other design is the kept source with a textual patch (``VARIANTS``
below): U = 2 and 8 vectors in flight a thread for the kept 4 (its
``kUnroll``), 128 and 512 threads a block for the kept 256 (``kThreads``),
rows loaded past L1 (``no_allocate``, the first plan of this design) or
kept in it (``evict_last``), write-back stores for streaming ones, and
``bulk_copy`` (``BULK_COPY``): Hopper's bulk
copy (TMA 1-D), each row a ``cp.async.bulk`` into a ring of tiles in
shared memory completing on an mbarrier, a tile's contiguous output rows
leaving in one bulk store, one warp a block; it takes the 16-byte path
(D * 4 % 16 == 0, both tables on 16 bytes) and keeps the word path.
``--parent`` adds another source of the file with the earlier C signature
(src, idx, out, B, T, D, stream), such as commit f2601cb's::

    git show f2601cb:src/repro_torch/kernels/csrc/rows.cu > build/k5_parent.cu

Every design runs at ``chip_smoke.py``'s two K5 shapes, rebuilt from the
same seeds: the sampled step's (the cold and the hot gather of the last
step's outermost block, ``train_sampled``) and the padded table's at
capacity N // 8 (``tiered_streaming``), two launches a call.  Each must
give the kept build's output bit for bit, and the kept build the plain
version's (``ref.gather_rows_ref``).  Times are CUDA events in four turns,
A..Z, Z..A, A..Z, Z..A; in each turn a design is timed (a) from a full
queue, the stream held by a spin kernel while 25 calls are enqueued:
each call between its own events (their median) and the 25 back to back
(their mean), as ``chip_smoke.py``'s ``device_ms``; and (b) as the host
reaches the calls, as its ``ms``: 25 calls each between its own events
(median) and 20 back to back (mean).  At the sampled step's shape, with
``--parent``, the repository's wrapper (``rows.gather_rows``) and the
earlier one (its checks and allocation over the parent build) are also
timed in turns: host µs a launch, and the call as the host reaches it.
Prints the card's name and power limit, then one JSON line, also written
to ``--out``.  Needs one CUDA card and nvcc; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import repro_torch.core as C  # noqa: E402
from repro_torch.kernels import _build, ref, rows  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/rows.cu"
OUT_DIR = ROOT / "build" / "k5_variants"
CALLS = 25          # calls a timing (a), and (b)'s median
BACK_TO_BACK = 20   # (b)'s calls back to back

# The bulk-copy design: a tile of kTileRows rows a step, one lane a row; a
# ring of kStages tiles, loads kAhead tiles ahead of the tile that leaves.
BULK_KERNEL = r'''
constexpr int kTileRows = 32;
constexpr int kStages = 4;
constexpr int kAhead = 2;   // a stage is reused kStages - kAhead - 1 = 1
                            // bulk store after its last one left

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(32)
    gather_rows_bulk_kernel(const float* __restrict__ src,
                            const int* __restrict__ idx,
                            float* __restrict__ out, long long B,
                            long long T, int D) {
  extern __shared__ __align__(128) unsigned char tiles[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const int lane = threadIdx.x;
  const unsigned row_bytes = 4u * D;
  const long long n_tiles = (B + kTileRows - 1) / kTileRows;
  const long long mine =
      n_tiles > blockIdx.x ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                           : 0;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&bars[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (long long k = 0; k < mine + kAhead; ++k) {
    if (k < mine) {  // the rows of tile k into stage k % kStages
      const int s = static_cast<int>(k % kStages);
      if (lane == 0)  // the store that last read this stage is done reading
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      __syncwarp();
      const long long r = (blockIdx.x + k * gridDim.x) * kTileRows + lane;
      unsigned char* slot =
          tiles + (static_cast<size_t>(s) * kTileRows + lane) * row_bytes;
      const long long id = r < B ? __ldg(idx + r) : -1;
      const bool hit = r < B && id >= 0 && id < T;
      if (hit) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(slot)),
            "l"(src + id * D), "r"(row_bytes), "r"(smem_u32(&bars[s]))
            : "memory");
      } else if (r < B) {  // a zero row, written here, seen by the store
        for (unsigned o = 0; o < row_bytes; o += 16)
          *reinterpret_cast<float4*>(slot + o) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      const unsigned hits = __popc(__ballot_sync(0xffffffffu, hit));
      if (lane == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_u32(&bars[s])),
            "r"(hits * row_bytes)
            : "memory");
    }
    __syncwarp();
    const long long j = k - kAhead;
    if (j >= 0 && lane == 0) {  // tile j leaves in one bulk store
      const int s = static_cast<int>(j % kStages);
      const uint32_t parity = static_cast<uint32_t>((j / kStages) & 1);
      uint32_t done = 0;
      while (!done)
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(&bars[s])), "r"(parity)
            : "memory");
      const long long r0 = (blockIdx.x + j * gridDim.x) * kTileRows;
      const long long n = B - r0 < kTileRows ? B - r0 : kTileRows;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          "cp.async.bulk.commit_group;\n" ::"l"(out + r0 * D),
          "r"(smem_u32(tiles + static_cast<size_t>(s) * kTileRows *
                                   row_bytes)),
          "r"(static_cast<unsigned>(n) * row_bytes)
          : "memory");
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int launch_bulk(const float* src, const int* idx, float* out, long long B,
                long long T, int D, cudaStream_t stream) {
  static int grid = 0, smem_of = 0;
  const int smem = kStages * kTileRows * D * 4;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (smem != smem_of) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaFuncSetAttribute(gather_rows_bulk_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_rows_bulk_kernel, 32, smem);
    grid = sms * (per_sm > 0 ? per_sm : 1);
    smem_of = smem;
  }
  const long long tiles = (B + kTileRows - 1) / kTileRows;
  gather_rows_bulk_kernel<<<static_cast<unsigned>(
                                tiles < grid ? tiles : grid),
                            32, smem, stream>>>(src, idx, out, B, T, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
'''
BULK_COPY = (
    ("}  // namespace\n", BULK_KERNEL),
    ("  int vpr = D / width;\n",
     "  if (width == 4)\n    return launch_bulk(src, idx, out, B, T, D,\n"
     "                       static_cast<cudaStream_t>(stream));\n"
     "  int vpr = D / width;\n"),
)
# rows not kept in L1 (ld.global.nc.L1::no_allocate): a row that many
# vectors repeat, such as the cold table's pad row or the hot table's row
# 0, is then read from L2 each time
ROWS_NOT_IN_L1 = (
    ('asm("ld.global.nc.f32', 'asm("ld.global.nc.L1::no_allocate.f32'),
    ('asm("ld.global.nc.v4.f32', 'asm("ld.global.nc.L1::no_allocate.v4.f32'))
# rows kept in L1 ahead of other lines (ld.global.nc.L1::evict_last)
ROWS_EVICT_LAST = (
    ('asm("ld.global.nc.f32', 'asm("ld.global.nc.L1::evict_last.f32'),
    ('asm("ld.global.nc.v4.f32', 'asm("ld.global.nc.L1::evict_last.v4.f32'))
# write-back stores instead of streaming ones (st.global.cs)
DEFAULT_STORES = ((
    "      if (rows[u] < B) __stcs(out + rows[u] * vpr + cols[u], vals[u]);",
    "      if (rows[u] < B) out[rows[u] * vpr + cols[u]] = vals[u];"),)


def _constant(name: str, kept: int, value: int):
    """The patch that sets one of the kernel's constants."""
    return ((f"constexpr int {name} = {kept};",
             f"constexpr int {name} = {value};"),)


# name -> the design: "patch", (text, replacement) pairs applied to the kept
# source; "unroll" and "threads", its constants where the patch sets them
# (the plan's rule gives its grid); "parent", the earlier C signature
VARIANTS = {
    "kept": {},
    **{f"unroll_{u}": dict(patch=_constant("kUnroll", rows.UNROLL, u),
                           unroll=u) for u in (2, 8)},
    **{f"threads_{t}": dict(patch=_constant("kThreads", rows.THREADS, t),
                            threads=t) for t in (128, 512)},
    "rows_not_in_l1": dict(patch=ROWS_NOT_IN_L1),
    "rows_evict_last": dict(patch=ROWS_EVICT_LAST),
    "default_stores": dict(patch=DEFAULT_STORES),
    "bulk_copy": dict(patch=BULK_COPY),
}


def _compile(name: str, src: Path, patch) -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu = OUT_DIR / f"{name}.cu"
    text = src.read_text()
    for old, new in patch or ():
        if old not in text:
            raise RuntimeError(f"{name}: the patched text is not in {src}")
        text = text.replace(old, new)
    cu.write_text(text)
    so = OUT_DIR / f"{name}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           "-Xptxas", "-v", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    return dict(so=so, seconds=time.perf_counter() - t0,
                registers=_registers(proc.stderr))


def _registers(log: str) -> dict:
    """Registers and spill bytes of each kernel ([regs, spill stores, spill
    loads]) from ptxas -v, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, [0, 0, 0])[1:] = [int(m.group(1)),
                                                   int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, [0, 0, 0])[0] = int(m.group(1))
    return out


def _launcher(lib, variant: dict, calls, sms: int):
    """One call of the design: its launches over ``calls`` into outputs
    allocated once, with the plans computed once."""
    stream = torch.cuda.current_stream().cuda_stream
    outs = [torch.empty((idx.numel(), src.shape[1]), dtype=torch.float32,
                        device=src.device) for src, idx in calls]
    if variant.get("parent"):
        fn = lib.mgg_gather_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        args = [(src.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                 src.shape[0], src.shape[1], stream)
                for (src, idx), out in zip(calls, outs)]
        plans = None
    else:
        fn = lib.mgg_gather_rows
        fn.argtypes = _build._SIGNATURES["mgg_gather_rows"]
        fn.restype = ctypes.c_int
        occ = lib.mgg_gather_rows_occupancy
        occ.argtypes = _build._SIGNATURES["mgg_gather_rows_occupancy"]
        occ.restype = ctypes.c_int
        u = variant.get("unroll", rows.UNROLL)
        t = variant.get("threads", rows.THREADS)
        plans = []
        for src, idx in calls:
            width = rows.plan(idx.numel(), src.shape[1], sms, 1).width
            n = ctypes.c_int(0)      # the build's own occupancy
            if occ(ctypes.addressof(n), width):
                raise RuntimeError("occupancy query failed")
            # the plan's rule at the build's U and block size
            plans.append(rows.Plan(width, rows._grid(
                idx.numel() * src.shape[1] // width, sms * max(1, n.value),
                u * t)))
        args = [(src.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                 src.shape[0], src.shape[1], *p, stream)
                for (src, idx), out, p in zip(calls, outs, plans)]
        plans = [dict(p._asdict(), unroll=u, threads=t) for p in plans]

    def run():
        for a in args:
            rc = fn(*a)
            if rc:
                raise RuntimeError(f"K5 launch failed: CUDA error {rc}")
        return outs
    return run, plans


def _sampled_shape(C, g, ncls, dev):
    """``chip_smoke.train_sampled``'s K5 calls: its store and hot set, the
    same seed batches and samples (the held batch, then TRAIN_STEPS steps)
    and the last step's outermost block."""
    from repro_torch.sample import sample_blocks, seed_batches
    from repro_torch.store import FeatureStore, TieredFeatures
    from repro_torch.train import graph_features
    n, d_in, fanout, batch = g.num_nodes, 100, 10, 1024
    x, _, train_mask = graph_features(n, d_in, ncls, seed=0)
    tiers = TieredFeatures(FeatureStore(x, copy=False, pin=True), None,
                           n // 8, device=dev)
    tiers.admit(np.argsort(-np.diff(g.indptr))[: n // 8])
    rng = np.random.default_rng(0)
    batches = seed_batches(np.nonzero(train_mask)[0], batch, rng=rng)
    for _ in range(S.TRAIN_STEPS + 1):
        seeds, _ = next(batches)
        blocks = sample_blocks(g, seeds, [fanout, fanout], batch=batch,
                               rng=rng)
    calls, n_hot, n_cold = S.k5_calls(torch, tiers, blocks[0].src_ids, dev)
    return calls, dict(rows=int(blocks[0].src_ids.size), hot_rows=n_hot,
                       cold_rows=n_cold)


def _padded_shape(C, g, x, dev):
    """``chip_smoke.tiered_streaming``'s K5 calls: the padded table of the
    streamed ring's plan (ps STREAM_PS, dist STREAM_DIST, 8 shards) at
    capacity N // 8."""
    from repro_torch.dist import VirtualRing
    from repro_torch.store import FeatureStore, TieredFeatures
    n = g.num_nodes
    plan = C.GNNEngine.build(g, VirtualRing(8, dev), ps=S.STREAM_PS,
                             dist=S.STREAM_DIST).plan
    tiers = TieredFeatures(FeatureStore(x, copy=False, pin=True), plan,
                           n // 8, device=dev)
    tiers.admit(np.argsort(-g.degrees, kind="stable")[: n // 8])
    ids = np.full(plan.padded_nodes, -1, np.int64)
    for ch_ids, _, fpos in tiers._chunks:
        ids[fpos] = ch_ids
    calls, n_hot, n_cold = S.k5_calls(torch, tiers, ids, dev)
    return calls, dict(rows=int(ids.size), hot_rows=n_hot, cold_rows=n_cold)


def _parent_wrapper(lib):
    """The earlier ``rows.gather_rows`` (commit f2601cb) over its build:
    the same checks and allocation, the earlier C signature, no plan."""
    from repro_torch.kernels.neighbor_agg import _check, _raise_on, _stream
    fn = lib.mgg_gather_rows

    def gather_rows(src, idx):
        if src.device.type != "cuda":
            raise ValueError(f"CUDA kernel called on a {src.device} tensor")
        _check("src", src, torch.float32, 2, src.device)
        _check("idx", idx, torch.int32, 1, src.device)
        out = torch.empty((idx.shape[0], src.shape[1]), dtype=torch.float32,
                          device=src.device)
        _raise_on(fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(),
                     idx.shape[0], src.shape[0], src.shape[1],
                     _stream(src.device)), "gather_rows")
        return out
    return gather_rows


def _wrapper_times(gather, calls, n=100):
    """A wrapper's host µs a launch (``n`` calls enqueued behind a spin
    kernel, so the card never pushes back) and the call's ms as the host
    reaches it, as ``chip_smoke.py`` times it (its median of 25 alone and
    the mean of 20 back to back)."""
    def run():
        for src, idx in calls:
            gather(src, idx)
    run()
    torch.cuda.synchronize()
    torch.cuda._sleep(4 * S.K5_HOLD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    host = (time.perf_counter() - t0) / (n * len(calls)) * 1e6
    torch.cuda.synchronize()
    return dict(host_us_a_launch=host,
                host_paced_median_alone=float(np.median(
                    S._each_ms(torch, run, CALLS))),
                host_paced_back_to_back=S._time(torch, run,
                                                reps=BACK_TO_BACK))


def _times(run):
    """One turn of a design: (a) from a full queue, (b) as the host reaches
    the calls."""
    each, mean, queued = S._held_ms(torch, run, CALLS)
    if not queued:
        raise SystemExit("the spin kernel ended before the calls were queued")
    paced = S._each_ms(torch, run, CALLS)
    return dict(median_alone=float(np.median(each)), back_to_back=mean,
                host_paced_median_alone=float(np.median(paced)),
                host_paced_back_to_back=S._time(torch, run,
                                                reps=BACK_TO_BACK))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier rows.cu (src, idx, out, B, T, D, "
                         "stream), timed as 'parent'")
    ap.add_argument("--out", type=Path, default=OUT_DIR / "k5_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    rate = next(r for frags, r in S.CARD_RATES
                if all(f in name.upper() for f in frags))
    variants = dict(VARIANTS)
    sources = {n: SOURCE for n in variants}
    if args.parent is not None:
        variants["parent"] = dict(parent=True)
        sources["parent"] = args.parent
    key = {n: (str(sources[n]), v.get("patch")) for n, v in variants.items()}
    first = {}
    for n in variants:
        first.setdefault(key[n], n)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(first)) as pool:
        built = dict(zip(first.values(), pool.map(
            lambda n: _compile(n, sources[n], variants[n].get("patch")),
            first.values())))
    build_s = time.perf_counter() - t0
    libs = {n: ctypes.CDLL(str(built[first[key[n]]]["so"]))
            for n in variants}
    t0 = time.perf_counter()
    g, meta = C.paper_dataset("products", scale=S.PRODUCTS_SCALE, seed=0)
    x = np.random.default_rng(0).normal(
        size=(g.num_nodes, int(meta["dim"]))).astype(np.float32)
    shapes = {"sampled_step": _sampled_shape(C, g, int(meta["classes"]),
                                             dev),
              "padded_table": _padded_shape(C, g, x, dev)}
    del x
    setup_s = time.perf_counter() - t0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    report = dict(device=name, nvidia_smi=smi, torch=torch.__version__,
                  cuda=torch.version.cuda, sms=sms,
                  build_s={n: round(b["seconds"], 1)
                           for n, b in built.items()},
                  build_wall_s=round(build_s, 1), setup_s=round(setup_s, 1),
                  registers_spills={n: b["registers"]
                                    for n, b in built.items()},
                  order=list(variants), shapes={})
    order = list(variants)
    for shape_name, (calls, counts) in shapes.items():
        runs = {n: _launcher(libs[n], variants[n], calls, sms)
                for n in order}
        want = [ref.gather_rows_ref(src, idx) for src, idx in calls]
        kept = [o.clone() for o in runs["kept"][0]()]
        if not all(torch.equal(a, b) for a, b in zip(kept, want)):
            raise SystemExit(f"kept at {shape_name}: not bitwise its plain "
                             "version")
        del want
        for n in order:
            got = runs[n][0]()
            if not all(torch.equal(a, b) for a, b in zip(got, kept)):
                raise SystemExit(f"{n} at {shape_name}: not bitwise the "
                                 "kept build")
        turns = {n: [] for n in order}
        with torch.inference_mode():
            for rnd in (order, order[::-1], order, order[::-1]):
                for n in rnd:
                    turns[n].append(_times(runs[n][0]))
        nbytes = S.k5_bytes(torch, calls)
        bound = nbytes / rate * 1e3
        summary = {n: {m: float(np.median([t[m] for t in ts]))
                       for m in ts[0]} for n, ts in turns.items()}
        report["shapes"][shape_name] = dict(
            **counts, width=int(calls[0][0].shape[1]), bytes=nbytes,
            bound_ms=bound, bitwise_kept=True,
            plans={n: r[1] for n, r in runs.items()},
            ms=summary,
            share_of_bound={n: bound / v["median_alone"]
                            for n, v in summary.items()},
            bytes_per_s={n: nbytes / (v["back_to_back"] / 1e3)
                         for n, v in summary.items()},
            turns=turns)
        if shape_name == "sampled_step" and "parent" in libs:
            wrappers = {"kept": rows.gather_rows,
                        "parent": _parent_wrapper(libs["parent"])}
            wt = {n: [] for n in wrappers}
            with torch.inference_mode():
                for rnd in (list(wrappers), list(wrappers)[::-1]) * 2:
                    for n in rnd:
                        wt[n].append(_wrapper_times(wrappers[n], calls))
            report["shapes"][shape_name]["through_wrappers"] = dict(
                ms={n: {m: float(np.median([t[m] for t in ts]))
                        for m in ts[0]} for n, ts in wt.items()},
                turns=wt)
        del runs, calls, kept
        torch.cuda.empty_cache()
    line = json.dumps(report)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
