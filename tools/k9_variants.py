"""Time the levers of K9 (the sLSTM scan's backward) on the card, each as
a variant build of ``src/repro_torch/kernels/csrc/slstm_scan.cu`` beside
the kept source, in one process and in turns.

    python3 tools/k9_variants.py [--parent PATH] [--out PATH]

A variant is the kept source with a textual patch (each lever's text in
``VARIANTS`` below), compiled into ``build/k9_variants/`` with the repo's
nvcc flags and ``-Xptxas -v`` (each K9 instance's registers and spills
are reported) and loaded with ctypes; a variant may also run at other
rows or blocks a cluster than the plan's.  ``--parent`` adds another
source of the same file (an earlier commit's) as the variant ``parent``,
run at 8 rows a cluster (the batch, at most 8).  Every variant runs K9 on the same inputs at three shapes of
one sLSTM layer of xlstm-125m (H 4, hd 192): the 2 x 4096 training step
(B 2, S 4096), the launcher's step (B 8, S 256) and one row (B 1, S
4096).  Its output must equal the kept build's bit for bit where the
variant keeps the association, and hold the plain version
(``ref.slstm_scan_grad_ref``) within the tolerances of ``chip_smoke.py``
everywhere; diagnostic builds that drop work are timed only.  Times are
CUDA events over 3 launches after a warm-up, each variant timed four
times in the order A..Z, Z..A, A..Z, Z..A; the exchange probes (K9's at
the plan's and at 8 rows a cluster, with the owners' sends, and K8's) are
timed beside them.  Prints the card's name and power limit, then one JSON
line, also written to ``--out``.  Needs one CUDA card and nvcc; exits 2
without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import slstm_scan as K  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/csrc/slstm_scan.cu"
OUT_DIR = ROOT / "build" / "k9_variants"

# name -> the variant: "patch", (text, replacement) pairs applied to the
# copied source (every occurrence); "bits", "kept" where the variant keeps
# the kept build's association and must give its bits, "own" where it
# changes it and must hold the plain version, None for a diagnostic build
# that drops work (timing only, wrong results); "cluster", blocks a
# cluster (the plan's if absent); "bt", rows a cluster (the plan's,
# bwd_rows, if absent; "old": the batch up to 8, the first design's rule).
RECOMPUTE_AFTER_WAIT = (
    ("    // everything of the update that does not depend on the exchanged "
     "dg,\n    // before the wait\n    const Fwd f = forward_step(cur);\n"
     "    computed(f);\n", ""),
    ("    if (comp) {\n      // after the wait only what depends on dh\n",
     "    if (comp) {\n      const Fwd f = forward_step(cur);\n"))
WR_IN_SHARED_MEMORY = (("constexpr int kBwdRegHdk = 256;",
                        "constexpr int kBwdRegHdk = 0;"),)
OWNER_SENDS = (   # K9 and its probe: the owner (lane s < rows) computes
    ("  const int row = p.s % p.rows;\n  const bool comp = p.live;\n"
     "  const int copies = (kSplit - 1 - row) / p.rows + 1;\n"
     "  const int first = p.s / p.rows;\n",
     "  const int row = p.s;\n  const bool comp = p.owner;\n"
     "  const int copies = 1;\n  const int first = 0;\n"),)
FOUR_ACCUMULATORS = (   # a row's product in four chains, one a gate
    ("#pragma unroll\n  for (int r = 0; r < BT; ++r) acc[r] = 0.f;\n"
     "  auto step = [&](int i, const float4 w) {\n#pragma unroll\n"
     "    for (int r = 0; r < BT; ++r) {\n"
     "      const float4 d = *reinterpret_cast<const float4*>(\n"
     "          dgb + (r * hdk + kSplit * i) * 4);\n"
     "      acc[r] = __fmaf_rn(d.x, w.x, acc[r]);\n"
     "      acc[r] = __fmaf_rn(d.y, w.y, acc[r]);\n"
     "      acc[r] = __fmaf_rn(d.z, w.z, acc[r]);\n"
     "      acc[r] = __fmaf_rn(d.w, w.w, acc[r]);\n",
     "  float a4[4][BT] = {};\n"
     "  auto step = [&](int i, const float4 w) {\n#pragma unroll\n"
     "    for (int r = 0; r < BT; ++r) {\n"
     "      const float4 d = *reinterpret_cast<const float4*>(\n"
     "          dgb + (r * hdk + kSplit * i) * 4);\n"
     "      a4[0][r] = __fmaf_rn(d.x, w.x, a4[0][r]);\n"
     "      a4[1][r] = __fmaf_rn(d.y, w.y, a4[1][r]);\n"
     "      a4[2][r] = __fmaf_rn(d.z, w.z, a4[2][r]);\n"
     "      a4[3][r] = __fmaf_rn(d.w, w.w, a4[3][r]);\n"),
    ("    for (int i = 0; i < n_it; ++i) step(i, wt[i * nt]);\n  }\n}\n",
     "    for (int i = 0; i < n_it; ++i) step(i, wt[i * nt]);\n  }\n"
     "#pragma unroll\n  for (int r = 0; r < BT; ++r)\n"
     "    acc[r] = __fadd_rn(__fadd_rn(a4[0][r], a4[1][r]),\n"
     "                       __fadd_rn(a4[2][r], a4[3][r]));\n}\n"))
RECIPROCALS = (
    ("  const float q = __fdiv_rn(dh, f.nrm);\n"
     "  const float d_nrm = -__fdiv_rn(__fmul_rn(dh, f.oc), f.nrm2);\n",
     "  const float q = __fmul_rn(dh, __frcp_rn(f.nrm));\n"
     "  const float d_nrm = -__fmul_rn(__fmul_rn(dh, f.oc), "
     "__frcp_rn(f.nrm2));\n"),)
CLUSTER_16 = (   # K9 also on a cluster of 16, a non-portable size
    ("(C == 1 || C == 2 || C == 4 || C == 8) && (C - 1) * units < hd",
     "(C == 1 || C == 2 || C == 4 || C == 8 || C == 16) &&\n"
     "         (C - 1) * units < hd"),
    ("    err = cudaFuncGetAttributes(&fa, fn);\n",
     "    err = cudaFuncGetAttributes(&fa, fn);\n"
     "    if (err == cudaSuccess && C > 8)\n"
     "      err = cudaFuncSetAttribute(\n"
     "          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"))
NO_PRODUCT = (("      float acc[BT];\n      bwd_product<BT, NIT>(",
               "      float acc[BT] = {};\n      if (false)\n"
               "        bwd_product<BT, NIT>("),)
VARIANTS = {
    "kept": dict(bits="kept"),
    **{f"kept_rows_{bt}": dict(bits="kept", bt=bt) for bt in (1, 2, 4, 8)},
    "recompute_after_wait": dict(patch=RECOMPUTE_AFTER_WAIT, bits="kept"),
    "wr_in_shared_memory": dict(patch=WR_IN_SHARED_MEMORY, bits="kept"),
    **{f"inputs_{k}_steps_ahead": dict(patch=((
        "constexpr int kBwdAhead = 2;", f"constexpr int kBwdAhead = {k};"),),
        bits="kept") for k in (1, 3)},
    "owner_sends": dict(patch=OWNER_SENDS, bits="kept"),
    "four_accumulators": dict(patch=FOUR_ACCUMULATORS, bits="own"),
    "reciprocals": dict(patch=RECIPROCALS, bits="own"),
    "cluster_16": dict(bits="kept", cluster=16, patch=CLUSTER_16),
    "diag_no_product": dict(patch=NO_PRODUCT),
    "diag_no_product_rows_2": dict(patch=NO_PRODUCT, bt=2),
    "diag_no_product_rows_8": dict(patch=NO_PRODUCT, bt=8),
}
SHAPES = {"train_2x4096": (2, 4096, 4, 192), "launcher_8x256": (8, 256, 4, 192),
          "one_row_1x4096": (1, 4096, 4, 192)}
K9_TOL = 1e-4        # chip_smoke.py: rtol, atol x max|.| at S <= 256
K9_RMS_TOL = 1e-3    # chip_smoke.py: rms difference over rms at S 4096


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
                resources=_k9_resources(proc.stderr))


def _k9_resources(log: str) -> dict:
    """Registers and spill bytes of each K9 instance ('BT,NIT': [regs,
    spill stores, spill loads]) from ptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"slstm_bwd_cluster_kernelILi(\d+)ELi(\d+)E",
                          m.group(1))
            name = f"{k.group(1)},{k.group(2)}" if k else None
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


def _load(so: Path):
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _inputs(b, s, h, hd, dev, seed=17):
    gen = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)
    xp = t(gen.normal(size=(b, s, h * 4 * hd)))
    wr = t(gen.normal(size=(h, hd, 4 * hd)) * hd ** -0.5)
    shape = (b, h, hd)
    st = dict(h=t(gen.normal(size=shape) * 0.5), c=t(gen.normal(size=shape)),
              n=t(gen.uniform(0.5, 2.0, shape)), m=t(gen.normal(size=shape)))
    dhs = t(gen.normal(size=(b, s, h, hd)))
    dst = {k: t(gen.normal(size=shape)) for k in "hcnm"}
    return xp, wr, st, dhs, dst


def _run(lib, case, cluster, bt=K.MAX_BT):
    """One K9 launch of ``lib`` at ``cluster`` blocks and ``bt`` rows a
    cluster: [dxp, dh0, dc0, dn0, dm0]."""
    xp, wr, st, dhs, dst, saved = case
    b, s, h, hd = dhs.shape
    dxp = torch.empty((b, s, h * 4 * hd), dtype=torch.float32,
                      device=dhs.device)
    d0 = dict(zip("hcnm", torch.empty((4, b, h, hd), dtype=torch.float32,
                                      device=dhs.device)))
    rc = lib.mgg_slstm_scan_backward(
        dhs.data_ptr(), *(dst[k].data_ptr() for k in "hcnm"), wr.data_ptr(),
        *(saved[k].data_ptr() for k in "gcnm"),
        *(st[k].data_ptr() for k in "cnm"), dxp.data_ptr(),
        *(d0[k].data_ptr() for k in "hcnm"), b, s, h, hd, min(b, bt),
        cluster, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"K9 launch failed: cuda error {rc}")
    return [dxp] + [d0[k] for k in "hcnm"]


def _ms(fn, reps=3):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rms_ratio(a, b):
    return ((a - b).double().pow(2).mean().sqrt()
            / b.double().pow(2).mean().sqrt().clamp_min(1e-30)).item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another slstm_scan.cu, timed as 'parent'")
    ap.add_argument("--out", type=Path, default=OUT_DIR / "k9_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k9_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    variants = dict(VARIANTS)
    sources = {n: SOURCE for n in variants}
    if args.parent is not None:
        variants = {"parent": dict(bits="kept", bt="old"), **variants}
        sources["parent"] = args.parent
    # one build a distinct (source, patch)
    key = {n: (str(sources[n]), v.get("patch")) for n, v in variants.items()}
    first = {}
    for n in variants:
        first.setdefault(key[n], n)
    with ThreadPoolExecutor(max_workers=len(first) + 1) as pool:
        repo_lib = pool.submit(_build.library_path, "slstm_scan")
        built = dict(zip(first.values(), pool.map(
            lambda n: _compile(n, sources[n], variants[n].get("patch")),
            first.values())))
        repo_lib.result()               # K8's save and the probes
    builds = {n: built[first[key[n]]] for n in variants}
    libs = {n: _load(b["so"]) for n, b in builds.items()}
    report = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  torch=torch.__version__, cuda=torch.version.cuda,
                  build_s={n: round(b["seconds"], 1)
                           for n, b in built.items()},
                  k9_registers_spills={n: b["resources"]
                                       for n, b in built.items()},
                  shapes={})
    order = list(variants)
    for shape_name, (b, s, h, hd) in SHAPES.items():
        xp, wr, st, dhs, dst = _inputs(b, s, h, hd, dev)
        with torch.inference_mode():
            _, _, saved = K.slstm_scan(xp, wr, st, save=True)
        case = (xp, wr, st, dhs, dst, saved)
        rows = K.bwd_rows(b, h, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        cluster, smem = K.plan(hd, min(b, rows), backward=True)
        dxp, dwr, d0 = ref.slstm_scan_grad_ref(xp, wr, st, dhs, dst)
        plain = [dxp] + [d0[k] for k in "hcnm"]
        at = {n: (v.get("cluster", cluster),
                  {None: rows, "old": K.MAX_BT}.get(v.get("bt"), v.get("bt")))
              for n, v in variants.items()}
        kept = _run(libs["kept"], case, cluster, rows)
        checks = {}
        for n in order:
            got = _run(libs[n], case, *at[n])
            if variants[n].get("bits") is None:
                continue
            same = all(torch.equal(x, y) for x, y in zip(got, kept))
            rms = [_rms_ratio(x, y) for x, y in zip(got, plain)]
            rel = max(((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                      .item() for x, y in zip(got, plain))
            held = (max(rms) <= K9_RMS_TOL if s > 256 else all(
                torch.allclose(x, y, rtol=K9_TOL,
                               atol=K9_TOL * y.abs().max().item())
                for x, y in zip(got, plain)))
            checks[n] = dict(bitwise_kept=same, rms_over_rms=max(rms),
                             max_err_over_max=rel, holds_plain=held)
            if variants[n]["bits"] == "kept" and not same:
                raise SystemExit(f"{n} at {shape_name}: the variant should "
                                 "keep the kept build's bits and does not")
            if not held:
                raise SystemExit(f"{n} at {shape_name}: outside the plain "
                                 f"version's tolerance ({checks[n]})")
        times = {n: [] for n in order}
        for rnd in (order, order[::-1], order, order[::-1]):
            for n in rnd:
                times[n].append(_ms(lambda n=n: _run(libs[n], case,
                                                      *at[n])))
        probes = {}
        for which, lib, bt in (("k9", libs["kept"], rows),
                               ("k9_rows_old", libs["kept"], K.MAX_BT),
                               ("k9_owner_sends", libs["owner_sends"], rows),
                               ("k8", None, K.MAX_BT)):
            def run(lib=lib, bt=bt):
                if lib is None:
                    return K.cluster_probe(b, s, h, hd, min(b, bt), cluster,
                                           dev)
                out = torch.zeros((b, h, hd), dtype=torch.float32,
                                  device=dev)
                rc = lib.mgg_slstm_bwd_cluster_probe(
                    out.data_ptr(), b, s, h, hd, min(b, bt), cluster,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"probe launch failed: {rc}")
                return out
            if not bool((run() == s).all().item()):
                raise SystemExit(f"the {which} probe lost a store")
            probes[which] = _ms(run, reps=5)
        report["shapes"][shape_name] = dict(
            batch=b, seq=s, heads=h, head_dim=hd, cluster=cluster,
            rows_per_cluster=rows, smem_bytes=smem,
            ms={n: float(np.median(v)) for n, v in times.items()},
            us_per_step={n: float(np.median(v)) * 1e3 / s
                         for n, v in times.items()},
            ms_runs=times, checks=checks,
            exchange_probe_ms=probes,
            exchange_probe_us_per_step={k: v * 1e3 / s
                                        for k, v in probes.items()})
        del xp, wr, st, dhs, dst, saved, case, plain, kept
        torch.cuda.empty_cache()
    line = json.dumps(report)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
