"""Monotonic-register workload (reference `tidb/src/tidb/monotonic.clj`
and `cockroachdb/src/jepsen/cockroach/monotonic.clj`): clients bump
registers via read-then-write-v+1 transactions and read them back.
Every committed write of a key is its predecessor plus one, so:

  * a lost update makes two txns write the same value — the rw-register
    checker's `duplicate-writes` case;
  * a stale read (the register "going backwards") closes a dependency
    cycle only through a realtime or process precedence edge — exactly
    what `additional_graphs` exists for (`monotonic.clj` passes
    `:additional-graphs` at its lines 108/164/212). The anomaly
    surfaces as G-single-realtime / G-single-process.

Ops: {'f': 'inc', 'value': [['r', k, nil], ['w', k, nil]]} — the client
fills the read and writes read+1 — and {'f': 'read', 'value':
[['r', k, nil] ...]} multi-key reads.
"""

from __future__ import annotations

import dataclasses

from .. import generator as gen
from ..checker import elle

DEFAULT_GRAPHS = ("realtime", "process")


@dataclasses.dataclass(frozen=True)
class _MonotonicGen(gen.Gen):
    key_count: int
    read_len: int

    def op(self, test, ctx):
        if gen.rng.random() < 0.5:
            k = gen.rng.randrange(self.key_count)
            o = gen.fill_in_op(
                {"f": "inc", "value": [["r", k, None], ["w", k, None]]},
                ctx)
        else:
            n = min(self.read_len, self.key_count)
            ks = gen.rng.sample(range(self.key_count), n)
            o = gen.fill_in_op(
                {"f": "read", "value": [["r", k, None] for k in ks]},
                ctx)
        if o is gen.PENDING:
            return gen.PENDING, self
        return o, self

    def update(self, test, ctx, event):
        return self


def generator(key_count: int = 4, read_len: int = 2) -> gen.Gen:
    return _MonotonicGen(key_count, read_len)


def workload(opts: dict | None = None) -> dict:
    """Options: 'key-count', 'read-len', 'anomalies' (default up to
    G-single — monotonicity, not full serializability),
    'additional-graphs' (default realtime + process), and 'device' for
    the checker's classifier (CUDA when it is absent)."""
    opts = opts or {}
    anomalies = tuple(opts.get("anomalies", ("G0", "G1", "G-single")))
    graphs = tuple(opts.get("additional-graphs", DEFAULT_GRAPHS))
    return {
        "checker": elle.rw_register_checker(
            anomalies, mesh=opts.get("mesh"), additional_graphs=graphs,
            device=opts.get("device")),
        "generator": generator(opts.get("key-count", 4),
                               opts.get("read-len", 2)),
    }
