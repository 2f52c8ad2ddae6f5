"""Sequential-consistency workload (reference
`tidb/src/tidb/sequential.clj` and
`cockroachdb/src/jepsen/cockroach/sequential.clj`): each pair id i owns
two keys (2i, 2i+1); one thread writes key 2i, then — in a *separate*
transaction — key 2i+1, while readers read the pair in reverse order
(2i+1 first). Observing the second write but not the first violates
sequential consistency: the reader anti-depends on W(2i), which
process-precedes W(2i+1), which the reader observed —

    reader -rw-> W(2i) -process-> W(2i+1) -wr-> reader

a cycle invisible to ww/wr/rw edges alone. It classifies as
G-single-process, courtesy of the process precedence graph
(`checker/elle/graphs.py`).
"""

from __future__ import annotations

import dataclasses

from .. import generator as gen
from ..checker import elle

DEFAULT_GRAPHS = ("process",)


@dataclasses.dataclass(frozen=True)
class _SequentialGen(gen.Gen):
    """pending maps a thread to the pair id whose second write it still
    owes; recent holds completed pair ids for readers to probe."""
    next_pair: int
    pending: tuple   # ((thread, pair-id), ...)
    recent: tuple    # recently finished pair ids

    def op(self, test, ctx):
        process = gen.some_free_process(ctx)
        thread = gen.process_to_thread(ctx, process)
        if thread is None:
            return gen.PENDING, self
        owed = next((i for t, i in self.pending if t == thread), None)
        if owed is not None:
            o = gen.fill_in_op(
                {"process": process, "f": "write",
                 "value": [["w", 2 * owed + 1, owed + 1]]}, ctx)
            if o is gen.PENDING:
                return gen.PENDING, self
            return o, dataclasses.replace(
                self,
                pending=tuple((t, i) for t, i in self.pending
                              if t != thread),
                recent=(self.recent + (owed,))[-8:])
        if self.recent and gen.rng.random() < 0.5:
            i = self.recent[gen.rng.randrange(len(self.recent))]
            o = gen.fill_in_op(
                {"process": process, "f": "read",
                 "value": [["r", 2 * i + 1, None], ["r", 2 * i, None]]},
                ctx)
            if o is gen.PENDING:
                return gen.PENDING, self
            return o, self
        i = self.next_pair
        o = gen.fill_in_op(
            {"process": process, "f": "write",
             "value": [["w", 2 * i, i + 1]]}, ctx)
        if o is gen.PENDING:
            return gen.PENDING, self
        return o, dataclasses.replace(
            self, next_pair=i + 1,
            pending=self.pending + ((thread, i),))

    def update(self, test, ctx, event):
        return self


def generator() -> gen.Gen:
    return _SequentialGen(0, (), ())


def workload(opts: dict | None = None) -> dict:
    """Options: 'anomalies' (default up to G-single),
    'additional-graphs' (default process — the graph this workload's
    violation needs), and 'device' for the checker's classifier (CUDA
    when it is absent)."""
    opts = opts or {}
    anomalies = tuple(opts.get("anomalies", ("G0", "G1", "G-single")))
    graphs = tuple(opts.get("additional-graphs", DEFAULT_GRAPHS))
    return {
        "checker": elle.rw_register_checker(
            anomalies, mesh=opts.get("mesh"), additional_graphs=graphs,
            device=opts.get("device")),
        "generator": generator(),
    }
