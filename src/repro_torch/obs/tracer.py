"""Span tracer with a Chrome-trace (Perfetto) exporter.

(Framework-free copy of ``repro/obs/tracer.py``: the port may not import the JAX
package.  tests/test_torch_planning.py holds the two copies equal.)

Design constraints (the acceptance criteria of the observability PR):

- **No-op when disabled.** The common case is a tracer that is off —
  every hot loop in the repo takes a ``tracer`` argument and must pay
  (almost) nothing when observability wasn't requested.  A disabled
  tracer's ``span()`` returns one preallocated context manager whose
  ``__enter__``/``__exit__`` do nothing; ``instant``/``complete``/
  ``counter`` return immediately on a single attribute check.
- **Injectable clock.** Everything times through ``self._clock`` (default
  ``time.perf_counter``) so tests drive spans deterministically — the
  same pattern as ``runtime.profiler``.
- **Bounded.** Events land in a ring buffer (``collections.deque`` with
  ``maxlen``); a week-long serve run cannot OOM the host through its
  own telemetry.
- **Thread-safe.** Serving replicas and background pumps record from
  wherever they run; one lock guards the buffer, and span begin/end
  pairs are folded into single complete events so interleaved threads
  can't corrupt nesting.

Events use the Chrome trace "X" (complete) and "i" (instant) phases;
``dump_chrome`` writes the ``{"traceEvents": [...]}`` wrapper that
ui.perfetto.dev and chrome://tracing both load.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Optional


class _NullSpan:
    """Shared do-nothing context manager handed out by disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span: records begin time at __enter__, emits at __exit__."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self.name, self._t0, self._tracer._clock(),
                              cat=self.cat, args=self.args)
        return False

    def set(self, **args) -> None:
        """Attach/override args on the span before it closes."""
        if self.args is None:
            self.args = {}
        self.args.update(args)


class Tracer:
    """Bounded, thread-safe span recorder with Perfetto export.

    ``Tracer(enabled=False)`` (or the module-level :data:`NULL_TRACER`)
    is safe to thread everywhere: every recording call bails on one
    ``enabled`` check and ``span()`` allocates nothing.
    """

    def __init__(self, enabled: bool = True, *,
                 clock: Callable[[], float] = time.perf_counter,
                 capacity: int = 200_000, pid: int = 0):
        self.enabled = bool(enabled)
        self._clock = clock
        self._events: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._pid = int(pid)
        self._epoch = clock() if self.enabled else 0.0
        self.dropped = 0  # events pushed out of the ring buffer

    # -- recording ---------------------------------------------------------

    def span(self, name: str, cat: str = "", **args):
        """Context manager timing a region; no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def complete(self, name: str, t0: float, t1: float, *, cat: str = "",
                 tid: int = 0, args: Optional[dict] = None) -> None:
        """Record a span retroactively from clock readings t0..t1.

        Used for lifecycle spans whose start was observed earlier (e.g.
        a request's admission time) without holding a span object open.
        """
        if not self.enabled:
            return
        ev = {"ph": "X", "name": name, "cat": cat or "span",
              "ts": (t0 - self._epoch) * 1e6,
              "dur": max(0.0, (t1 - t0) * 1e6),
              "pid": self._pid, "tid": int(tid)}
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, *, cat: str = "", tid: int = 0,
                **args) -> None:
        """Record a point event (shown as a marker in Perfetto)."""
        if not self.enabled:
            return
        ev = {"ph": "i", "name": name, "cat": cat or "event",
              "ts": (self._clock() - self._epoch) * 1e6,
              "pid": self._pid, "tid": int(tid), "s": "t"}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, *, tid: int = 0, **values) -> None:
        """Record a counter sample (Perfetto renders a stacked track)."""
        if not self.enabled:
            return
        self._push({"ph": "C", "name": name, "cat": "counter",
                    "ts": (self._clock() - self._epoch) * 1e6,
                    "pid": self._pid, "tid": int(tid),
                    "args": {k: float(v) for k, v in values.items()}})

    def now(self) -> float:
        """Clock reading, for callers building retroactive spans."""
        return self._clock()

    def _push(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    # -- export ------------------------------------------------------------

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def to_chrome(self) -> dict:
        """The ``{"traceEvents": [...]}`` object Perfetto loads."""
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def dump_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev) + "\n")


NULL_TRACER = Tracer(enabled=False, capacity=1)


def resolve(tracer: Optional[Tracer]) -> Tracer:
    """Normalize an optional tracer argument to a Tracer instance."""
    return tracer if tracer is not None else NULL_TRACER


# ---------------------------------------------------------------------------
# multi-replica trace merging
# ---------------------------------------------------------------------------

def _load_events(path: str) -> list:
    """Events from either export format (JSONL or Chrome ``traceEvents``).

    Both start with ``{``, so sniffing the first byte can't tell them
    apart: parse as one JSON document first, fall back to line-per-event.
    """
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        return [json.loads(line) for line in text.splitlines()
                if line.strip()]
    if isinstance(doc, dict):
        if "traceEvents" in doc:
            return list(doc["traceEvents"])
        return [doc]        # single-line JSONL: one bare event
    return list(doc)        # bare event array


def merge_traces(paths, labels=None, out: Optional[str] = None) -> dict:
    """Fold N per-replica trace dumps into one Perfetto timeline.

    Each input (JSONL from :meth:`Tracer.dump_jsonl` or Chrome JSON from
    :meth:`Tracer.dump_chrome`) becomes its own process row: every event
    is reassigned ``pid=i`` (the input's position), and a Chrome ``M``
    (``process_name``) metadata event names the row — by ``labels[i]``
    when given, else ``replica<i>``.  Timestamps are left alone: each
    tracer's clock already starts at its own epoch, so replica timelines
    align at zero, which is what you want for comparing per-replica
    phase timing side by side.

    Returns the merged ``{"traceEvents": [...]}`` object; also writes it
    to ``out`` when given.  Used by ``launch/serve_gnn.py`` for
    ``--replicas N --trace``.
    """
    merged = []
    for i, path in enumerate(paths):
        label = labels[i] if labels and i < len(labels) else f"replica{i}"
        merged.append({"ph": "M", "name": "process_name", "pid": i,
                       "tid": 0, "args": {"name": label}})
        for ev in _load_events(path):
            ev = dict(ev)
            ev["pid"] = i
            merged.append(ev)
    doc = {"traceEvents": merged, "displayTimeUnit": "ms",
           "otherData": {"merged_from": len(list(paths))}}
    if out:
        with open(out, "w") as f:
            json.dump(doc, f)
    return doc
