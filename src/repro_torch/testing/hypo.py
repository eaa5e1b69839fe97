"""``hypothesis`` front-end: the real library when installed, else a
deterministic fallback for the API subset the suite uses.

(Framework-free copy of ``repro/testing/hypo.py``: the port may not import
the JAX package.)

Property tests import from here unconditionally —

    from repro_torch.testing.hypo import given, settings, strategies as st

— and get real hypothesis whenever it is importable (CI installs it; see
the re-export at the bottom of this module).  Hermetic images without it
get the shim.

Shim semantics: ``@given`` runs the test body ``max_examples`` times with values
drawn from a per-example seeded ``numpy`` RNG — deterministic across runs
and machines (no shrinking, no database, no deadline handling; ``settings``
accepts and ignores the extra knobs).  Strategies cover exactly what the
suite draws: ``integers``, ``floats``, ``booleans``, ``sampled_from``,
``just``, ``lists``, ``tuples``, and ``composite``.
"""
from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Sequence

import numpy as np

__all__ = ["given", "settings", "strategies"]

_DEFAULT_MAX_EXAMPLES = 100


class Strategy:
    """A value generator: ``example(rng) -> value``."""

    def __init__(self, draw_fn: Callable[[np.random.Generator], Any],
                 label: str = "strategy"):
        self._draw = draw_fn
        self._label = label

    def example(self, rng: np.random.Generator) -> Any:
        return self._draw(rng)

    def map(self, f: Callable[[Any], Any]) -> "Strategy":
        return Strategy(lambda rng: f(self._draw(rng)),
                        f"{self._label}.map")

    def filter(self, pred: Callable[[Any], bool],
               max_tries: int = 100) -> "Strategy":
        def draw(rng):
            for _ in range(max_tries):
                v = self._draw(rng)
                if pred(v):
                    return v
            raise ValueError(f"{self._label}.filter found no example "
                             f"in {max_tries} tries")
        return Strategy(draw, f"{self._label}.filter")

    def __repr__(self):
        return f"<{self._label}>"


class _Strategies:
    @staticmethod
    def integers(min_value: int, max_value: int) -> Strategy:
        return Strategy(
            lambda rng: int(rng.integers(min_value, max_value + 1)),
            f"integers({min_value},{max_value})")

    @staticmethod
    def floats(min_value: float, max_value: float) -> Strategy:
        return Strategy(
            lambda rng: float(rng.uniform(min_value, max_value)),
            f"floats({min_value},{max_value})")

    @staticmethod
    def booleans() -> Strategy:
        return Strategy(lambda rng: bool(rng.integers(0, 2)), "booleans")

    @staticmethod
    def sampled_from(options: Sequence) -> Strategy:
        opts = list(options)
        return Strategy(lambda rng: opts[int(rng.integers(len(opts)))],
                        "sampled_from")

    @staticmethod
    def just(value) -> Strategy:
        return Strategy(lambda rng: value, "just")

    @staticmethod
    def lists(elements: Strategy, *, min_size: int = 0,
              max_size: int = 10) -> Strategy:
        def draw(rng):
            n = int(rng.integers(min_size, max_size + 1))
            return [elements.example(rng) for _ in range(n)]
        return Strategy(draw, "lists")

    @staticmethod
    def tuples(*strats: Strategy) -> Strategy:
        return Strategy(lambda rng: tuple(s.example(rng) for s in strats),
                        "tuples")

    @staticmethod
    def composite(f: Callable) -> Callable[..., Strategy]:
        """``@st.composite``: ``f(draw, *args) -> value`` becomes a strategy
        factory, mirroring hypothesis' signature contract."""
        @functools.wraps(f)
        def factory(*args, **kwargs) -> Strategy:
            def draw_value(rng):
                draw = lambda strat: strat.example(rng)
                return f(draw, *args, **kwargs)
            return Strategy(draw_value, f"composite:{f.__name__}")
        return factory


strategies = _Strategies()


def settings(*, max_examples: int = _DEFAULT_MAX_EXAMPLES, **_ignored):
    """Decorator recording ``max_examples``; other knobs (deadline, …) are
    accepted for signature compatibility and ignored."""
    def deco(fn):
        fn._hypo_max_examples = max_examples
        return fn
    return deco


def given(*strats: Strategy, **kw_strats: Strategy):
    """Run the wrapped test for each deterministic example draw."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            n = getattr(wrapper, "_hypo_max_examples",
                        getattr(fn, "_hypo_max_examples",
                                _DEFAULT_MAX_EXAMPLES))
            for i in range(n):
                rng = np.random.default_rng(
                    np.random.SeedSequence([0xC0FFEE, i]))
                vals = [s.example(rng) for s in strats]
                kwvals = {k: s.example(rng) for k, s in kw_strats.items()}
                try:
                    fn(*args, *vals, **{**kwargs, **kwvals})
                except Exception as e:
                    raise AssertionError(
                        f"property falsified on example {i}: "
                        f"args={vals} kwargs={kwvals}") from e
        # keep pytest from trying to collect strategy params as fixtures
        sig = inspect.signature(fn)
        keep = list(sig.parameters.values())[: max(
            0, len(sig.parameters) - len(strats) - len(kw_strats))]
        wrapper.__signature__ = sig.replace(parameters=keep)
        return wrapper
    return deco


try:  # prefer the real library whenever it is installed (e.g. in CI)
    from hypothesis import given, settings, strategies  # noqa: F811,F401
except ModuleNotFoundError:
    pass
