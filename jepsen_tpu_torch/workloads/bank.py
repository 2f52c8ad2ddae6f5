"""Bank test: simulated transfers between accounts; every read must show
the same total balance (reference `jepsen/src/jepsen/tests/bank.clj`).

Test map options: 'accounts' (ids), 'total-amount', 'max-transfer'.
Ops: {'f': 'read'} -> value {account: balance}; {'f': 'transfer',
'value': {'from': a, 'to': b, 'amount': n}}.

The checker is an O(n) fold over ok reads; balance sums are vectorized
with numpy per read (host-side — this checker is bandwidth-trivial; the
card's budget goes to the linearizability/Elle kernels).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .. import generator as gen
from ..checker import Checker, compose
from ..history import history as as_history, is_ok


def read(test, ctx) -> dict:
    """A generator of read operations (`bank.clj:20-23`)."""
    return {"type": "invoke", "f": "read"}


def transfer(test, ctx) -> dict:
    """A random transfer between two random accounts (`bank.clj:25-33`)."""
    accounts = test.get("accounts", list(range(8)))
    return {"type": "invoke", "f": "transfer",
            "value": {"from": gen.rng.choice(accounts),
                      "to": gen.rng.choice(accounts),
                      "amount": 1 + gen.rng.randrange(
                          test.get("max-transfer", 5))}}


def diff_transfer():
    """Transfers only between distinct accounts (`bank.clj:35-39`)."""
    return gen.filter(
        lambda op: op["value"]["from"] != op["value"]["to"], transfer)


def generator():
    """A mixture of reads and transfers (`bank.clj:41-44`)."""
    return gen.mix([diff_transfer(), read])


def err_badness(test, err: dict) -> float:
    """How egregious is this error? (`bank.clj:46-55`)"""
    t = err["type"]
    if t == "unexpected-key":
        return len(err["unexpected"])
    if t == "nil-balance":
        return len(err["nils"])
    if t == "wrong-total":
        total_amount = test.get("total-amount", 100)
        return abs((err["total"] - total_amount) / total_amount)
    if t == "negative-value":
        return -sum(err["negative"])
    return 0


def check_op(accts: set, total: int, negative_balances: bool,
             op: dict) -> dict | None:
    """Errors in a single read's balance map (`bank.clj:57-82`)."""
    value = op.get("value") or {}
    ks = list(value.keys())
    balances = list(value.values())
    unexpected = [k for k in ks if k not in accts]
    if unexpected:
        return {"type": "unexpected-key", "unexpected": unexpected,
                "op": op}
    nils = {k: v for k, v in value.items() if v is None}
    if nils:
        return {"type": "nil-balance", "nils": nils, "op": op}
    arr = np.asarray(balances, dtype=np.int64) if balances \
        else np.zeros(0, np.int64)
    got = int(arr.sum())
    if got != total:
        return {"type": "wrong-total", "total": got, "op": op}
    if not negative_balances and bool((arr < 0).any()):
        return {"type": "negative-value",
                "negative": [int(b) for b in arr[arr < 0]], "op": op}
    return None


class BankChecker(Checker):
    """All reads sum to total-amount; balances non-negative unless
    'negative-balances?' (`bank.clj:84-121`)."""

    def __init__(self, opts: dict | None = None):
        self.opts = opts or {}

    def check(self, test, hist, opts):
        accts = set(test.get("accounts", list(range(8))))
        total = test.get("total-amount", 100)
        neg_ok = bool(self.opts.get("negative-balances?"))
        hist = as_history(hist).index()
        reads = [o for o in hist if is_ok(o) and o["f"] == "read"]
        errors: dict[str, list] = {}
        for o in reads:
            err = check_op(accts, total, neg_ok, o)
            if err is not None:
                errors.setdefault(err["type"], []).append(err)
        all_errs = [e for errs in errors.values() for e in errs]
        out: dict[str, Any] = {
            "valid?": not all_errs,
            "read-count": len(reads),
            "error-count": len(all_errs),
            "first-error": min(
                (e for e in all_errs),
                key=lambda e: e["op"].get("index", 0), default=None),
            "errors": {},
        }
        for typ, errs in errors.items():
            entry = {"count": len(errs), "first": errs[0],
                     "worst": max(errs,
                                  key=lambda e: err_badness(test, e)),
                     "last": errs[-1]}
            if typ == "wrong-total":
                entry["lowest"] = min(errs, key=lambda e: e["total"])
                entry["highest"] = max(errs, key=lambda e: e["total"])
            out["errors"][typ] = entry
        return out


def checker(opts: dict | None = None) -> Checker:
    return BankChecker(opts)


def test(opts: dict | None = None) -> dict:
    """A partial test bundling default accounts/amounts with generator and
    checker; caller opts override the defaults (`bank.clj:179-192`)."""
    opts = opts or {"negative-balances?": False}
    out = {
        "max-transfer": 5,
        "total-amount": 100,
        "accounts": list(range(8)),
        "checker": compose({"SI": checker(opts)}),
        "generator": generator(),
    }
    out.update({k: v for k, v in opts.items()
                if k != "negative-balances?"})
    return out
