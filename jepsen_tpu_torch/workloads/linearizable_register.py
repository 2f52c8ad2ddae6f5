"""Linearizability over a set of independent registers (reference
`jepsen/src/jepsen/tests/linearizable_register.clj`).

Clients understand three functions over (key, value) tuples:

    {'type': 'invoke', 'f': 'write', 'value': (k, v)}
    {'type': 'invoke', 'f': 'read',  'value': (k, None)}
    {'type': 'invoke', 'f': 'cas',   'value': (k, (v, v2))}

The checker is the port's main path to the card: independent/checker
batches every key's subhistory into one batched WGL walk (see
independent.py and checker/wgl.py), on the device named by
opts['device'] (CUDA when it is absent; 'cpu' runs the plain path).
"""

from __future__ import annotations

import itertools

from .. import generator as gen
from .. import independent
from ..checker import linearizable
from ..models import cas_register


def w(test, ctx):
    return {"type": "invoke", "f": "write", "value": gen.rng.randrange(5)}


def r(test, ctx):
    return {"type": "invoke", "f": "read", "value": None}


def cas(test, ctx):
    return {"type": "invoke", "f": "cas",
            "value": (gen.rng.randrange(5), gen.rng.randrange(5))}


def test(opts: dict | None = None) -> dict:
    """A partial test: generator, model, checker; you provide the client
    (`linearizable_register.clj:22-53`)."""
    opts = opts or {}
    n = len(opts.get("nodes", ["n1", "n2", "n3", "n4", "n5"]))
    model = opts.get("model", cas_register())
    per_key_limit = opts.get("per-key-limit")
    process_limit = opts.get("process-limit", 20)

    def fgen(k):
        g = gen.reserve(n, r, gen.mix([w, cas, cas]))
        if per_key_limit:
            # randomize the limit so keys drift out of phase
            g = gen.limit(
                max(1, round((0.9 + gen.rng.random() * 0.2)
                             * per_key_limit)), g)
        return gen.process_limit(process_limit, g)

    # A bare Linearizable subchecker (not compose-wrapped) lets
    # independent.checker take the batched walk on the card.
    return {
        "checker": independent.checker(
            linearizable(model, device=opts.get("device"))),
        "generator": independent.concurrent_generator(
            2 * n, itertools.count(), fgen),
    }
