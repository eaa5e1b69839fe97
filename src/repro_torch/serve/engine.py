"""Batched LM serving engine: prefill + decode over fixed batch slots
(counterpart of ``repro/serve/engine.py``).

Continuous batching: requests are admitted into a fixed number of batch
slots; one ``decode_step`` advances every active slot; a slot that finishes
(EOS / budget) is refilled from the queue at the next step, not at a wave
boundary.

Each admission prefills alone (batch 1, exact prompt length) and every
leaf of its cache (a KV cache's k, v and key positions, an xlstm's
recurrent states, or the hybrid's mamba states and per-group KV caches,
nested dicts) is copied into the shared decode cache at the slot index
(axis 1, under the layer or group axis), as the reference's ``_scatter``
does, so per-slot results are those of running that prompt solo.  Idle
slots feed token 0 at position 0, as the reference's engine: every decode
step runs all ``batch_slots`` rows, so under the moe family's capacity
routing (``models/moe.py``) the idle rows take capacity as they do in the
reference, and the served tokens are the reference's.
The decode cache is fp32, as the reference allocates it, whatever the
compute dtype.  Sampling stays on the host with numpy, as in the
reference (argmax, or Gumbel-max over ``np.random.default_rng(seed)``), so
the same logits give the same tokens.  Each ``generate`` records the host
time of every admission's prefill and of every decode step (each ends in
the logits' copy to the host, which waits for the device) in
``self.timings``.  With ``keep_logits`` each result also carries the
logits every one of its tokens was sampled from, so a batched run can be
held to solo runs step by step.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import transformer
from ..models.layers import KVCache

__all__ = ["ServeEngine", "GenerationResult"]


def _cache_leaves(cache) -> List[torch.Tensor]:
    """Every tensor of a cache tree, in a fixed order (a KVCache's three
    fields included)."""
    if isinstance(cache, KVCache):
        return [cache.k, cache.v, cache.key_pos]
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in _cache_leaves(cache[k])]
    return [cache]


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    prompt_len: int
    steps: int
    # (steps, vocab) float32: row t the logits token t was sampled from
    # (``generate(keep_logits=True)`` only)
    logits: Optional[np.ndarray] = None


class ServeEngine:
    def __init__(self, params, cfg, *, batch_slots: int = 8,
                 max_seq: int = 512, ctx=None, eos_id: Optional[int] = None):
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.max_seq = max_seq
        self.ctx = ctx or transformer.DistCtx()
        self.eos_id = eos_id
        if cfg.family == "encdec":
            raise NotImplementedError(
                "use encdec.prefill/decode_step directly for whisper")
        self.device = params["embed"]["w"].device
        self.timings: Dict[str, List[float]] = dict(prefill_s=[], decode_s=[])

    def _sample(self, logits: np.ndarray, temperature: float,
                rng: np.random.Generator) -> np.ndarray:
        """Vectorized over rows: argmax (greedy) or Gumbel-max (categorical
        at ``temperature``)."""
        if temperature <= 0:
            return logits.argmax(-1).astype(np.int32)
        z = logits.astype(np.float64) / temperature
        g = rng.gumbel(size=z.shape)
        return (z + g).argmax(-1).astype(np.int32)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def generate(self, prompts: List[np.ndarray], *, max_new: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 keep_logits: bool = False) -> List[GenerationResult]:
        """Continuously batched generation over all prompts;
        ``keep_logits`` fills each result's ``logits``."""
        rng = np.random.default_rng(seed)
        self.timings = dict(prefill_s=[], decode_s=[])
        results: List[Optional[GenerationResult]] = [None] * len(prompts)
        if not prompts:
            return []
        cfg, dev = self.cfg, self.device
        queue = deque(range(len(prompts)))
        L = min(self.max_seq, max(len(p) for p in prompts) + max_new)
        cache = transformer.init_cache(cfg, self.B, L, dtype=torch.float32,
                                       device=dev)
        slot_req = [-1] * self.B                 # request index per slot
        out_tokens: List[List[int]] = [[] for _ in range(self.B)]
        out_logits: List[List[np.ndarray]] = [[] for _ in range(self.B)]
        cur_logits: List[Optional[np.ndarray]] = [None] * self.B
        cur = np.zeros(self.B, np.int32)          # next token to emit/feed
        pos = np.zeros(self.B, np.int32)
        active = np.zeros(self.B, bool)

        def finalize(j: int) -> None:
            i = slot_req[j]
            results[i] = GenerationResult(
                tokens=out_tokens[j], prompt_len=len(prompts[i]),
                steps=len(out_tokens[j]),
                logits=np.stack(out_logits[j]) if keep_logits else None)
            slot_req[j] = -1
            active[j] = False
            cur[j] = 0
            pos[j] = 0

        while queue or active.any():
            # -- refill every free slot from the queue -------------------
            for j in range(self.B):
                if slot_req[j] >= 0 or not queue:
                    continue
                i = queue.popleft()
                t0 = time.perf_counter()
                toks = np.asarray(prompts[i], np.int32)[None, :]
                c1 = transformer.init_cache(cfg, 1, L, dtype=torch.float32,
                                            device=dev)
                logits1, c1 = transformer.prefill(
                    self.params, cfg, self._tensor(toks), c1, ctx=self.ctx)
                for dst, src in zip(_cache_leaves(cache),
                                    _cache_leaves(c1)):
                    dst[:, j:j + 1].copy_(src)
                lg = logits1.float().cpu().numpy()
                cur[j] = self._sample(lg, temperature, rng)[0]
                if keep_logits:
                    cur_logits[j] = lg[0]
                self.timings["prefill_s"].append(time.perf_counter() - t0)
                pos[j] = toks.shape[1]
                slot_req[j] = i
                out_tokens[j] = []
                out_logits[j] = []
                active[j] = True

            # -- emit the sampled token for every active slot -------------
            for j in range(self.B):
                if not active[j]:
                    continue
                out_tokens[j].append(int(cur[j]))
                if keep_logits:
                    out_logits[j].append(cur_logits[j])
                if ((self.eos_id is not None and cur[j] == self.eos_id)
                        or len(out_tokens[j]) >= max_new):
                    finalize(j)
            if not active.any():
                continue  # refill (or exit) without a wasted decode

            # -- one decode step advances every active slot ----------------
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(
                self.params, cfg, self._tensor(cur),
                self._tensor(np.minimum(pos, L - 1)), cache, ctx=self.ctx)
            lg = logits.float().cpu().numpy()
            nxt = self._sample(lg, temperature, rng)
            self.timings["decode_s"].append(time.perf_counter() - t0)
            if keep_logits:
                for j in np.flatnonzero(active):
                    cur_logits[j] = lg[j].copy()
            cur = np.where(active, nxt, cur).astype(np.int32)
            pos = pos + active.astype(np.int32)
        return results  # type: ignore[return-value]
