"""Persistent tuned-config cache: workload-shape × hardware → (ps, dist, pb).

(Copy of ``repro/runtime/cache.py``, numpy and stdlib only, with the same
file format; the hardware fingerprint reads torch's devices instead of
JAX's.  tests/test_torch_tuner.py holds the two copies equal.)

The paper's runtime converges in ~10 measured iterations; a *later run* of
the same workload on the same hardware should not pay those iterations
again.  :class:`ConfigCache` stores each converged config in a JSON file
keyed by the :class:`~repro.core.autotune.WorkloadShape` fingerprint plus a
hardware fingerprint (platform, device kind, device count), so
:class:`~repro.runtime.engine.DynamicGNNEngine` warm-starts the search from
the cached optimum.

Robustness rules (this file lives across jobs — and, with serving
replicas (:mod:`repro.serve.cluster`), across concurrent *processes*):

* writes are atomic (tmp file + ``os.replace``) — a preempted writer never
  corrupts the cache;
* the read-modify-write in :meth:`put` / :meth:`put_layers` is serialized
  across processes by an exclusive ``flock`` on a sidecar ``<path>.lock``
  file, so two replicas committing different entries never lose each
  other's update (on platforms without ``fcntl`` the RMW falls back to
  last-writer-wins, which is still corruption-free);
* reads retry briefly on malformed JSON (an external non-atomic copy can
  race a reader even though our own writes cannot) before reading as
  empty;
* a corrupt or version-mismatched file reads as empty (tuning simply
  starts cold) rather than raising — pre-per-layer (v1) cache files are
  discarded with a single :class:`RuntimeWarning` per path per process,
  never a crash and never silent;
* entries keep the latency and shape they were tuned at, for debugging
  and for future staleness policies.

Schema v2 adds **per-layer** entries: a tuned config may be either one
global ``{ps, dist, pb}`` or ``{"layers": [{ps, dist, pb}, ...]}`` keyed
by the joint fingerprint of every layer's WorkloadShape (the per-layer
tuner's warm start).

Schema v3 rounds out the knob set: the tiered feature-cache capacity
(``cap``, an int) and the per-layer fused-update dataflow (``fuse``, a
bool) persist alongside ``(ps, dist, pb)`` when the committed config
carries them — previously only the three schedule knobs round-tripped,
so a re-opened search re-probed capacity and fuse from scratch.  v2
files are discarded with the same one-time-per-path RuntimeWarning as
v1 (tuning starts cold, never a crash).

Schema v4 persists the sparsity knob: the top-k compression width
(``k``, an int — see :func:`repro.core.pipeline.mgg_aggregate_sparse`)
rides alongside the other knobs when the committed config carries it.
v3 (and older) files are discarded the same way.

Schema v5 persists the sampled mini-batch geometry: the per-hop
neighbor bound (``fanout``) and seed-batch size (``batch``) of the
sampled path (:mod:`repro.sample`) round-trip when the committed config
carries them, so a warm-started search re-validates the tuned sampling
geometry instead of re-climbing it.  v4 (and older) files are discarded
the same way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Set

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

from ..core.autotune import WorkloadShape

__all__ = ["ConfigCache", "hardware_fingerprint", "shape_fingerprint",
           "layers_fingerprint"]

_VERSION = 5

_KNOBS = ("ps", "dist", "pb")

# optional integer knobs persisted when the committed config carries them
_OPT_INT_KNOBS = ("cap", "k", "fanout", "batch")

# paths whose version-mismatch discard has already been reported (once per
# process, not once per read — replicas poll the cache constantly)
_VERSION_WARNED: Set[str] = set()


def _valid_cfg(cfg: Any) -> bool:
    if not isinstance(cfg, dict) \
            or not all(isinstance(cfg.get(k), int) for k in _KNOBS):
        return False
    for k in _OPT_INT_KNOBS:
        if k in cfg and not isinstance(cfg[k], int):
            return False
    if "fuse" in cfg and not isinstance(cfg["fuse"], bool):
        return False
    return True


def _pack_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The persisted knob set: (ps, dist, pb) plus the optional knobs the
    committed config carries (cap/k v3-v4, fanout/batch v5, fuse bool)."""
    out: Dict[str, Any] = {k: int(cfg[k]) for k in _KNOBS}
    for k in _OPT_INT_KNOBS:
        if k in cfg:
            out[k] = int(cfg[k])
    if "fuse" in cfg:
        out["fuse"] = bool(cfg["fuse"])
    return out


def hardware_fingerprint(device=None) -> str:
    """platform:device_kind:count — stable across runs on the same host:
    ``cuda:<card name>:<card count>`` for a CUDA device (the current card
    when ``device`` is None and CUDA is there), else ``cpu:cpu:1``."""
    import torch

    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type != "cuda":
        return "cpu:cpu:1"
    kind = torch.cuda.get_device_name(dev)
    return f"cuda:{kind}:{torch.cuda.device_count()}".replace(" ", "_")


def shape_fingerprint(w: WorkloadShape) -> str:
    return (f"ndev{w.n_dev}_d{w.d_feat}_rows{w.rows_per_dev}"
            f"_le{w.local_edges_max}_re{w.remote_edges_max}_it{w.itemsize}")


def layers_fingerprint(shapes: Sequence[WorkloadShape]) -> str:
    """Joint fingerprint of a per-layer shape stack (the topology part is
    shared, so only the widths vary between segments)."""
    dims = "-".join(str(w.d_feat) for w in shapes)
    return f"L{len(shapes)}_d{dims}|{shape_fingerprint(shapes[0])}"


class ConfigCache:
    """JSON-file-backed map: (shape, hardware) → tuned config."""

    def __init__(self, path: str, hw: Optional[str] = None):
        self.path = str(path)
        self.hw = hw if hw is not None else hardware_fingerprint()

    # -- key / io ------------------------------------------------------------

    def key(self, shape: WorkloadShape, hw: Optional[str] = None) -> str:
        return f"{shape_fingerprint(shape)}|{hw or self.hw}"

    @contextlib.contextmanager
    def _locked(self):
        """Exclusive cross-process lock for read-modify-write sections.

        A sidecar ``<path>.lock`` file is flocked so the cache file itself
        can keep being atomically replaced (flocking the data file would
        pin the lock to a replaced inode).  No-op where fcntl is missing.
        """
        if fcntl is None:
            yield
            return
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        with open(self.path + ".lock", "a") as lf:
            fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf.fileno(), fcntl.LOCK_UN)

    def _load(self) -> Dict[str, Any]:
        data = None
        for attempt in range(3):
            try:
                with open(self.path) as f:
                    data = json.load(f)
                break
            except OSError:
                return {}
            except ValueError:
                # our writes are atomic (os.replace), but an external
                # non-atomic copy can expose a truncated file to a reader;
                # retry briefly before treating it as genuinely corrupt
                if attempt == 2:
                    return {}
                time.sleep(0.01 * (attempt + 1))
        if not isinstance(data, dict) or data.get("version") != _VERSION:
            key = os.path.abspath(self.path)
            if key not in _VERSION_WARNED:
                _VERSION_WARNED.add(key)
                found = data.get("version") if isinstance(data, dict) \
                    else None
                warnings.warn(
                    f"config cache {self.path}: discarding entries with "
                    f"schema version {found!r} (expected {_VERSION}); "
                    f"tuning starts cold", RuntimeWarning, stacklevel=3)
            return {}
        entries = data.get("entries")
        return entries if isinstance(entries, dict) else {}

    def _store(self, entries: Dict[str, Any]) -> None:
        payload = dict(version=_VERSION, entries=entries)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".cfgcache-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- public api ----------------------------------------------------------

    def get(self, shape: WorkloadShape,
            hw: Optional[str] = None) -> Optional[Dict[str, int]]:
        """The cached (ps, dist, pb) for this workload/hardware, or None."""
        entry = self._load().get(self.key(shape, hw))
        if not isinstance(entry, dict):
            return None
        cfg = entry.get("config")
        if _valid_cfg(cfg):
            return _pack_cfg(cfg)
        return None

    def put(self, shape: WorkloadShape, config: Dict[str, int],
            latency: float, hw: Optional[str] = None) -> None:
        with self._locked():
            entries = self._load()
            entries[self.key(shape, hw)] = dict(
                config=_pack_cfg(config),
                latency=float(latency),
                shape=dataclasses.asdict(shape),
                hw=hw or self.hw,
            )
            self._store(entries)

    # -- per-layer entries (schema v2+) ---------------------------------------

    def layers_key(self, shapes: Sequence[WorkloadShape],
                   hw: Optional[str] = None) -> str:
        return f"{layers_fingerprint(shapes)}|{hw or self.hw}"

    def get_layers(self, shapes: Sequence[WorkloadShape],
                   hw: Optional[str] = None) -> Optional[List[Dict[str, int]]]:
        """The cached per-layer configs for this shape stack, or None."""
        entry = self._load().get(self.layers_key(shapes, hw))
        if not isinstance(entry, dict):
            return None
        cfg = entry.get("config")
        layers = cfg.get("layers") if isinstance(cfg, dict) else None
        if (isinstance(layers, list) and len(layers) == len(shapes)
                and all(_valid_cfg(c) for c in layers)):
            return [_pack_cfg(c) for c in layers]
        return None

    def put_layers(self, shapes: Sequence[WorkloadShape],
                   configs: Sequence[Dict[str, int]], latency: float,
                   hw: Optional[str] = None) -> None:
        with self._locked():
            entries = self._load()
            entries[self.layers_key(shapes, hw)] = dict(
                config=dict(layers=[_pack_cfg(c) for c in configs]),
                latency=float(latency),
                shape=[dataclasses.asdict(s) for s in shapes],
                hw=hw or self.hw,
            )
            self._store(entries)

    def __len__(self) -> int:
        return len(self._load())
