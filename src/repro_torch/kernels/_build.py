"""Build and load the port's CUDA kernels (``csrc/*.cu``) with nvcc + ctypes.

Each source compiles on first use into one shared library with a plain C
interface, under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``).  The file name carries a hash of the source and the flags,
so an edited kernel is rebuilt and an unchanged one is loaded as it is.
The library includes no PyTorch header, so a build takes seconds;
:func:`build_all` starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["library", "library_path", "toolkit_binary", "build_all",
           "build_seconds", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# seconds spent in nvcc per source name, for the smoke script's report
build_seconds: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _compile(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{src.stem}-",
                               suffix=".so")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[src.name] = time.perf_counter() - t0
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # buf, nbrs, mask, out, P, ps, D, stream
    "mgg_gather_sum_pipelined": [_P, _P, _P, _P, _L, _I, _I, _P],
    # buf, nbrs, mask, out, P, ps, D, pb, stream
    "mgg_gather_sum_blocked": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
    # out, partial, order, seg_rows, seg_start, n_seg, D, hubs, hub_chunks,
    # n_hubs, chunk_start, chunk_end, n_chunks, chunk_len, sums, stream
    "mgg_segment_add_ordered": [_P, _P, _P, _P, _P, _L, _I, _P, _P, _L, _P,
                                _P, _L, _I, _P, _P],
    # src, idx, out, B, T, D, stream
    "mgg_gather_rows": [_P, _P, _P, _L, _L, _I, _P],
    # values, idx, nbrs, mask, out, P, ps, k, D, id_bytes, stream
    "mgg_sparse_gather_sum": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # q, k, v, o, B, S, H, KV, hd, q/k/v strides (b, s, h), causal, window,
    # bf16, stream
    "mgg_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L,
                            _L, _L, _L, _L, _L, _L, _I, _I, _I, _P],
    # xp, wr, h0, c0, n0, m0, hs, hN, cN, nN, mN, B, S, H, hd, bt, cluster,
    # stream
    "mgg_slstm_scan": [_P] * 11 + [_I] * 6 + [_P],
    # hd, bt, cluster
    "mgg_slstm_smem_bytes": [_I, _I, _I],
    # out, B, S, H, hd, bt, cluster, barrier, stream
    "mgg_slstm_cluster_probe": [_P] + [_I] * 6 + [_P],
}


@functools.lru_cache(maxsize=None)
def library(name: str = "gather_sum") -> ctypes.CDLL:
    """Compile (once per source version) and load ``csrc/<name>.cu``."""
    lib = ctypes.CDLL(str(_compile(CSRC / f"{name}.cu")))
    for fn, argtypes in _SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def library_path(name: str) -> Path:
    """The shared library built from ``csrc/<name>.cu`` (built if need be)."""
    return _compile(CSRC / f"{name}.cu")


def toolkit_binary(name: str) -> str:
    """A binary of the CUDA toolkit beside nvcc (``cuobjdump``, ...)."""
    return os.path.join(os.path.dirname(_nvcc()), name)


def build_all() -> list:
    """Compile every ``csrc/*.cu`` at once (one nvcc each, in parallel) and
    load them; returns the source names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(lambda n: _compile(CSRC / f"{n}.cu"), names))
    for n in names:
        library(n)
    return names
