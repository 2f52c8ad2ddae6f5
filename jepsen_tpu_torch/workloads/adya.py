"""Adya G2 anti-dependency-cycle probe over *predicates* (reference
`jepsen/src/jepsen/tests/adya.clj`; see Adya's thesis for the anomaly
taxonomy).

For each key, exactly two concurrent :insert txns run: one holding an
a-table id, one a b-table id ({'f': 'insert', 'value': (key, [a_id,
b_id])} with exactly one id non-None). Each txn reads both tables by
predicate and inserts only if both reads are empty — so under
serializability at most one insert per key can commit.
"""

from __future__ import annotations

import itertools
import threading

from .. import generator as gen
from .. import independent
from ..checker import Checker
from ..history import history as as_history, is_ok


def g2_gen():
    """Pairs of insert ops per concurrent unique key
    (`adya.clj:12-57`)."""
    ids = itertools.count(1)
    lock = threading.Lock()

    def next_id() -> int:
        with lock:
            return next(ids)

    def fgen(k):
        return [
            gen.once(lambda test, ctx:
                     {"type": "invoke", "f": "insert",
                      "value": [None, next_id()]}),
            gen.once(lambda test, ctx:
                     {"type": "invoke", "f": "insert",
                      "value": [next_id(), None]}),
        ]

    return independent.concurrent_generator(2, itertools.count(), fgen)


class G2Checker(Checker):
    """At most one :insert may succeed per key (`adya.clj:59-87`)."""

    def check(self, test, hist, opts):
        keys: dict = {}
        for op in as_history(hist):
            if op.get("f") != "insert":
                continue
            v = op.get("value")
            k = v.key if isinstance(v, independent.KV) else None
            if k is None:
                continue
            if is_ok(op):
                keys[k] = keys.get(k, 0) + 1
            else:
                keys.setdefault(k, 0)
        illegal = {k: c for k, c in sorted(keys.items()) if c > 1}
        insert_count = sum(1 for c in keys.values() if c > 0)
        return {"valid?": not illegal,
                "key-count": len(keys),
                "legal-count": insert_count - len(illegal),
                "illegal-count": len(illegal),
                "illegal": illegal}


def g2_checker() -> Checker:
    return G2Checker()


def workload() -> dict:
    return {"checker": g2_checker(), "generator": g2_gen()}
