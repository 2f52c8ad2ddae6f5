"""Checker core: the protocol, the validity lattice and the crash-safe
check.

Counterpart of `jepsen_tpu/checker/__init__.py`, cut to what the
linearizability and independent checkers need. A checker is any object
with ``check(test, history, opts) -> result-dict``; results carry a
``'valid?'`` key which is True, False, or the string ``'unknown'``.
Plain functions ``f(test, history, opts)`` are adapted by `coerce`.
"""

from __future__ import annotations

import traceback
from typing import Any, Callable, Mapping

from .._platform import classify_backend_error
from ..history import History, history

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
