"""Atomic checkpoints in the reference's on-disk layout
(``repro/train/checkpoint.py``), for pytrees of tensors.

* every leaf is one ``.npy`` file named by its tree path
  (``params/layers/0/w`` → ``params__layers__0__w.npy``); a
  ``manifest.json`` records the step, each leaf's name, file, shape and
  dtype, and ``extra``;
* writes go to ``<dir>/tmp-<step>`` and are renamed atomically to
  ``<dir>/step-<step:09d>`` — a crash mid-write never corrupts the latest
  checkpoint;
* retention keeps the newest ``keep`` checkpoints.

With the same layout, a checkpoint the port writes is one the reference's
``restore`` reads, and the other way round.  bf16 leaves are stored as
their raw 16 bits, as the reference stores them.  The asynchronous
``CheckpointManager`` waits for the LM slice.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from .tree import tree_flatten_with_names, tree_unflatten

__all__ = ["save", "restore", "latest_step"]


def _to_numpy(leaf) -> tuple:
    """``(array, logical dtype name)`` of one leaf."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[Dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = dict(step=step, leaves=[], extra=extra or {})
    for name, leaf in tree_flatten_with_names(tree):
        arr, logical = _to_numpy(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            dict(name=name, file=fname, shape=list(arr.shape),
                 dtype=logical))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step-")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(
        int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step-")
    )
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, target: Any, device="cpu") -> Any:
    """Load into the structure of ``target`` (a pytree whose leaves only
    name the slots), as tensors on ``device``."""
    d = os.path.join(ckpt_dir, f"step-{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
    leaves = []
    for name, _ in tree_flatten_with_names(target):
        entry = by_name[name]
        arr = np.load(os.path.join(d, entry["file"]))
        if entry["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        leaves.append(t.to(device))
    return tree_unflatten(target, leaves)
