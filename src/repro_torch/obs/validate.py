"""Validate an emitted Chrome-trace file (CI smoke gate).

(Copy of ``repro/obs/validate.py``: the port may not import the JAX
package.  tests/test_torch_obs.py holds the two copies' problems equal.)

    PYTHONPATH=src python -m repro_torch.obs.validate trace.json

Asserts the structural properties the observability layer promises:

1. the file parses as Chrome-trace JSON (``traceEvents`` list);
2. it contains at least one ring-step pipeline span
   (``mgg.stream.*``) and the stream-level span reports a nonzero
   ``overlap_efficiency``;
3. it contains at least one tuner audit event (``tuner.*`` instant).

Exit code 0 on success; 1 with a reason on stderr otherwise.
"""
from __future__ import annotations

import json
import sys


def validate(path: str) -> list:
    """Return a list of problems (empty = valid)."""
    problems = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"not parseable as JSON: {e}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["no traceEvents list"]
    for ev in events:
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            problems.append(f"malformed event: {ev!r}")
            return problems

    ring_steps = [e for e in events
                  if e["name"].startswith("mgg.stream.")
                  and e["ph"] == "X"]
    if not ring_steps:
        problems.append("no ring-step spans (mgg.stream.*)")
    overlaps = [e["args"]["overlap_efficiency"] for e in events
                if e.get("args") and "overlap_efficiency" in e["args"]]
    if not overlaps:
        problems.append("no span reports overlap_efficiency")
    elif max(overlaps) <= 0.0:
        problems.append(f"overlap_efficiency never positive: {overlaps}")

    tuner_events = [e for e in events if e["name"].startswith("tuner.")]
    if not tuner_events:
        problems.append("no tuner audit events (tuner.*)")
    return problems


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.validate TRACE.json",
              file=sys.stderr)
        return 2
    problems = validate(argv[0])
    if problems:
        for p in problems:
            print(f"[obs.validate] FAIL: {p}", file=sys.stderr)
        return 1
    with open(argv[0]) as f:
        n = len(json.load(f)["traceEvents"])
    print(f"[obs.validate] OK: {argv[0]} ({n} events, ring-step spans "
          f"with overlap_efficiency and tuner audit events present)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
