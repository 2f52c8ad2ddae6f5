"""Causal-consistency register workload (reference
`jepsen/src/jepsen/tests/causal.clj`).

A causal order of 5 ops (read-init, write 1, read, write 2, read) is issued
per key by a single site; ops carry 'position' (this op's position id) and
'link' (the position this op causally follows, or 'init'). The
CausalRegister model steps through completions, rejecting broken links,
out-of-order writes, and unwritten reads.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

from .. import generator as gen
from .. import independent
from ..checker import Checker
from ..history import history as as_history, is_ok
from ..models import inconsistent, is_inconsistent


@dataclasses.dataclass(frozen=True)
class CausalRegister:
    """value/counter/last_pos state machine (`causal.clj:33-88`)."""
    value: int = 0
    counter: int = 0
    last_pos: Any = None

    def step(self, op: dict):
        c = self.counter + 1
        v = op.get("value")
        pos = op.get("position")
        link = op.get("link")
        if link != "init" and link != self.last_pos:
            return inconsistent(
                f"Cannot link {link!r} to last-seen position "
                f"{self.last_pos!r}")
        f = op["f"]
        if f == "write":
            if v == c:
                return CausalRegister(v, c, pos)
            return inconsistent(
                f"expected value {c} attempting to write {v} instead")
        if f == "read-init":
            if self.counter == 0 and v not in (0, None):
                return inconsistent(f"expected init value 0, read {v}")
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return inconsistent(
                f"can't read {v} from register {self.value}")
        if f == "read":
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return inconsistent(
                f"can't read {v} from register {self.value}")
        return inconsistent(f"unknown f {f!r}")


def causal_register() -> CausalRegister:
    return CausalRegister()


class CausalChecker(Checker):
    """Steps the model through every :ok op in order
    (`causal.clj:90-112`)."""

    def __init__(self, model):
        self.model = model

    def check(self, test, hist, opts):
        s = self.model
        for op in as_history(hist):
            if not is_ok(op):
                continue
            s = s.step(op)
            if is_inconsistent(s):
                return {"valid?": False, "error": s.msg}
        return {"valid?": True, "model": s}


def check(model=None) -> Checker:
    return CausalChecker(model if model is not None else causal_register())


# Generators (`causal.clj:115-118`) — one causal chain per key.
def r(test, ctx):
    return {"type": "invoke", "f": "read"}


def ri(test, ctx):
    return {"type": "invoke", "f": "read-init"}


def cw1(test, ctx):
    return {"type": "invoke", "f": "write", "value": 1}


def cw2(test, ctx):
    return {"type": "invoke", "f": "write", "value": 2}


def test(opts: dict | None = None) -> dict:
    """Workload bundle: per-key causal chains, staggered, with a
    start/stop nemesis cycle (`causal.clj:120-132`)."""
    opts = opts or {}
    chain = [gen.once(g) for g in (ri, cw1, r, cw2, r)]
    g = gen.stagger(
        1, independent.concurrent_generator(1, itertools.count(),
                                            lambda k: chain))
    g = gen.nemesis(
        gen.cycle(gen.concat(gen.sleep(10), {"type": "info", "f": "start"},
                             gen.sleep(10), {"type": "info", "f": "stop"})),
        g)
    return {
        "checker": independent.checker(check(causal_register())),
        "generator": gen.time_limit(opts.get("time-limit", 60), g),
    }
