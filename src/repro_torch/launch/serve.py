"""LM serving launcher for the port: continuously batched generation over
synthetic prompts (counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \
        --requests 8 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mistral-nemo-12b --smoke

Flags and defaults are the reference's: ``--requests 8 --max-new 32
--batch-slots 4``, prompts of 4–16 tokens drawn from
``np.random.default_rng(0)``, ``max_seq=512``, random parameters from seed
0 with ``vocab_multiple=16``; the dense, vlm, moe, hybrid and xlstm archs
run (whisper's encdec raises, as in the reference).  The reference's
``--devices N`` (fake host devices) becomes ``--device cpu|cuda``: without
``--device cpu`` it runs on the card or raises.  Prints the requests,
tokens, seconds and tokens/s, and the prefill and decode-step times;
``main`` returns them.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import configs
from ..dist.ring import resolve_device
from ..models import transformer as T
from ..serve import ServeEngine


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu' is asked for)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, vocab_multiple=16)
    eng = ServeEngine(params, cfg, batch_slots=args.batch_slots,
                      max_seq=512)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(4, 17))
               .astype(np.int32) for _ in range(args.requests)]
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new=args.max_new,
                       temperature=args.temperature)
    dt = time.perf_counter() - t0
    tok = sum(r.steps for r in res)
    prefill_ms = [t * 1e3 for t in eng.timings["prefill_s"]]
    decode_ms = [t * 1e3 for t in eng.timings["decode_s"]]
    print(f"{len(res)} requests, {tok} tokens, {dt:.2f}s "
          f"({tok/dt:.1f} tok/s)")
    print(f"prefill {np.median(prefill_ms):.2f} ms median over "
          f"{len(prefill_ms)}, decode step {np.median(decode_ms):.2f} ms "
          f"median over {len(decode_ms)} on {dev}")
    return dict(arch=cfg.name, device=str(dev), requests=len(res),
                tokens=tok, seconds=dt, tokens_per_s=tok / dt,
                prefill_ms=prefill_ms, decode_ms=decode_ms,
                results=res, prompts=prompts)


if __name__ == "__main__":
    main()
