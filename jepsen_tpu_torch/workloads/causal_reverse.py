"""Strict-serializability G-single probe: T1 < T2, but T2 is visible
without T1 (reference `jepsen/src/jepsen/tests/causal_reverse.clj`).

Concurrent blind writes of distinct values per key; reads return the set
of visible values. Replaying the history, every write w_i records the set
of writes acknowledged before w_i's invocation; a read that sees w_i but
misses some w_j in that set violates strict serializability.
"""

from __future__ import annotations

import itertools

from .. import generator as gen
from .. import independent
from ..checker import Checker, compose
from ..history import history as as_history, is_invoke, is_ok


def graph(hist) -> dict:
    """value -> set of values acknowledged before its write was invoked
    (`causal_reverse.clj:21-47`)."""
    completed: set = set()
    expected: dict = {}
    for op in as_history(hist):
        if op.get("f") != "write":
            continue
        if is_invoke(op):
            expected[op["value"]] = frozenset(completed)
        elif is_ok(op):
            completed.add(op["value"])
    return expected


def errors(hist, expected: dict) -> list:
    """Reads that saw a write but missed one of its predecessors
    (`causal_reverse.clj:49-71`)."""
    errs = []
    for op in as_history(hist):
        if not (is_ok(op) and op.get("f") == "read"):
            continue
        seen = set(op.get("value") or ())
        our_expected: set = set()
        for v in seen:
            our_expected |= set(expected.get(v, ()))
        missing = our_expected - seen
        if missing:
            err = dict(op)
            err.pop("value", None)
            err["missing"] = sorted(missing)
            err["expected-count"] = len(our_expected)
            errs.append(err)
    return errs


class CausalReverseChecker(Checker):
    def check(self, test, hist, opts):
        expected = graph(hist)
        errs = errors(hist, expected)
        return {"valid?": not errs, "errors": errs}


def checker() -> Checker:
    return CausalReverseChecker()


def workload(opts: dict | None = None) -> dict:
    """Generator + checker bundle (`causal_reverse.clj:87-110`)."""
    opts = opts or {}
    n = len(opts.get("nodes", ["n1", "n2", "n3", "n4", "n5"]))
    per_key = opts.get("per-key-limit", 500)

    def fgen(k):
        writes = (lambda test, ctx:
                  {"f": "write", "value": next(counter)})
        counter = iter(range(10**9))
        return gen.limit(per_key, gen.stagger(
            1 / 100, gen.mix([gen.repeat({"f": "read", "value": None}),
                              writes])))

    return {
        "checker": compose(
            {"sequential": independent.checker(checker())}),
        "generator": independent.concurrent_generator(
            n, itertools.count(), fgen),
    }
