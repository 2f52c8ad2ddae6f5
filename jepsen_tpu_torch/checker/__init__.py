"""Checker core: the protocol, the validity lattice and the crash-safe
check.

Counterpart of `jepsen_tpu/checker/__init__.py`: the validity
lattice (true < :unknown < false), the exception-absorbing `check_safe`,
the parallel `compose` and `concurrency_limit`. A checker is any object
with ``check(test, history, opts) -> result-dict``; results carry a
``'valid?'`` key which is True, False, or the string ``'unknown'``.
Plain functions ``f(test, history, opts)`` are adapted by `coerce`.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Mapping

import torch

from .._platform import classify_backend_error
from ..history import History, history
from ..util import bounded_pmap

UNKNOWN = "unknown"

# :valid? priorities — larger dominates in composition
_VALID_PRIORITIES = {True: 0, UNKNOWN: 0.5, False: 1}


def merge_valid(valids) -> Any:
    """Merge :valid? values; the highest-priority (worst) wins."""
    out = True
    for v in valids:
        if v not in _VALID_PRIORITIES:
            raise ValueError(f"{v!r} is not a known valid? value")
        if _VALID_PRIORITIES[v] > _VALID_PRIORITIES[out]:
            out = v
    return out


class Checker:
    """Protocol base. Subclasses implement check()."""

    def check(self, test: Mapping, hist: History, opts: Mapping) -> dict:
        raise NotImplementedError

    def __call__(self, test, hist, opts=None):
        return self.check(test, hist, opts or {})


class FnChecker(Checker):
    """Adapts a plain function into a Checker."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def check(self, test, hist, opts):
        return self.fn(test, hist, opts)


def coerce(c) -> Checker:
    if isinstance(c, Checker):
        return c
    if callable(c):
        return FnChecker(c)
    raise TypeError(f"not a checker: {c!r}")


class _Noop(Checker):
    def check(self, test, hist, opts):
        return None


def noop() -> Checker:
    """A checker that returns nothing (reference checker.clj:68-72)."""
    return _Noop()


class _UnbridledOptimism(Checker):
    def check(self, test, hist, opts):
        return {"valid?": True}


def unbridled_optimism() -> Checker:
    """Everything is awesome (reference checker.clj:118-122)."""
    return _UnbridledOptimism()


def checker_name(checker) -> str:
    """A human-readable name for a checker, for error attribution."""
    c = checker
    if isinstance(c, FnChecker):
        c = c.fn
    if isinstance(c, Checker):
        return type(c).__name__
    return getattr(c, "__name__", None) or type(c).__name__


def check_safe(checker, test, hist, opts=None, name=None) -> dict:
    """check(), but exceptions come back as {'valid?': 'unknown', ...},
    naming the checker that failed ('checker'). Only an exception that
    `_platform.classify_backend_error` places reports 'degraded': True
    with its 'fault' bucket; a plain RuntimeError of checker logic
    reports like any other crash."""
    cname = name if name is not None else checker_name(checker)
    try:
        return coerce(checker).check(test, history(hist), opts or {})
    except (NotImplementedError, RecursionError):
        # RuntimeError subclasses, but ordinary checker bugs
        return {"valid?": UNKNOWN, "checker": cname,
                "error": traceback.format_exc()}
    except Exception as e:  # noqa: BLE001 — crashes must not kill the run
        kind = classify_backend_error(e)
        if kind is not None:
            return {"valid?": UNKNOWN, "checker": cname,
                    "degraded": True, "fault": kind,
                    "error": traceback.format_exc()}
        return {"valid?": UNKNOWN, "checker": cname,
                "error": traceback.format_exc()}


class Compose(Checker):
    """Runs a map of named checkers (in parallel) and merges validity
    (reference checker.clj:87-99).

    Device-fault outcomes are summarized across the composition:
    'recovered-checkers' names sub-checkers whose results carry a
    recovery trail (the device faulted and the verdict was recovered),
    'degraded-checkers' those that lost their verdict to faults past the
    recovery budget. Tiered-verification outcomes likewise:
    'screened-checkers' names sub-checkers whose verdict came from the
    tier-1 screen alone, 'escalated-checkers' those the screen escalated
    to a full search, and 'attested-checkers' those whose device results
    carried (and passed) ABFT attestation."""

    def __init__(self, checker_map: Mapping[str, Any]):
        self.checkers = {k: coerce(c) for k, c in checker_map.items()}

    def check(self, test, hist, opts):
        hist = history(hist)
        items = list(self.checkers.items())
        # the sub-checkers run on pool threads, where PyTorch's current
        # CUDA device is the default one: give them the caller's card
        card = (torch.cuda.current_device()
                if torch.cuda.is_initialized() else None)

        def one(kv):
            if card is not None:
                torch.cuda.set_device(card)
            return kv[0], check_safe(kv[1], test, hist, opts, name=kv[0])

        results = bounded_pmap(one, items, max_workers=8)
        out: dict = dict(results)
        out["valid?"] = merge_valid(
            r.get("valid?", True) for _, r in results if r is not None)

        def names(pred) -> list:
            return sorted(k for k, r in results
                          if isinstance(r, dict) and pred(r))

        # a recovery trail is a dict ({'faults': ..., 'retries': ...});
        # workload checkers reuse the 'recovered' key for other payloads
        for key, pred in (
                ("recovered-checkers",
                 lambda r: isinstance(r.get("recovered"), dict)),
                ("degraded-checkers", lambda r: r.get("degraded")),
                ("screened-checkers",
                 lambda r: r.get("screened") and not r.get("escalated")),
                ("escalated-checkers",
                 lambda r: isinstance(r.get("escalated"), dict)),
                ("attested-checkers",
                 lambda r: isinstance(r.get("attested"), dict))):
            found = names(pred)
            if found:
                out[key] = found
        return out


def compose(checker_map: Mapping[str, Any]) -> Checker:
    return Compose(checker_map)


class ConcurrencyLimit(Checker):
    """Bounds concurrent executions of a checker with a fair semaphore
    (reference checker.clj:101-116)."""

    def __init__(self, limit: int, checker):
        self.sem = threading.Semaphore(limit)
        self.checker = coerce(checker)

    def check(self, test, hist, opts):
        with self.sem:
            return self.checker.check(test, hist, opts)


def concurrency_limit(limit: int, checker) -> Checker:
    return ConcurrencyLimit(limit, checker)


# Re-exports of the standard checkers (defined in submodules).
from .basic import (  # noqa: E402
    counter, counter_plot, log_file_pattern, queue, set_checker, set_full, stats,
    total_queue, unhandled_exceptions, unique_ids,
)
from .clock import clock_plot  # noqa: E402
from .linear import linearizable  # noqa: E402
# `perf_checker` (not `perf`) so the factory doesn't shadow the
# checker.perf submodule attribute.
from .perf import latency_graph, perf_checker  # noqa: E402
from .perf import rate_graph_checker as rate_graph  # noqa: E402

__all__ = [
    "Checker", "UNKNOWN", "merge_valid", "check_safe", "checker_name",
    "compose",
    "concurrency_limit", "noop", "unbridled_optimism", "coerce",
    "stats", "unhandled_exceptions", "set_checker", "set_full", "queue",
    "total_queue", "unique_ids", "counter", "counter_plot",
    "log_file_pattern",
    "linearizable", "latency_graph", "rate_graph", "perf_checker",
    "clock_plot",
]
