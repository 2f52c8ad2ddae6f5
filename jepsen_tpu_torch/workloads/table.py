"""Table-visibility workload (reference `tidb/src/tidb/table.clj`):
one process stream creates numbered tables while everyone else races
inserts into them. Once a `create-table` has *completed*, every insert
*invoked* later must see the table — "table doesn't exist" after the
create's completion is a realtime visibility anomaly (a schema change
that un-happened). The checker derives that precedence with the Elle
additional-graphs layer's interval machinery
(`checker/elle/graphs.node_intervals`) rather than wall-clock times.

Ops: {'f': 'create-table', 'value': t} and {'f': 'insert', 'value':
[t, k]}; an insert that finds no table fails with error
['table-missing', t] (allowed while the create is still in flight).
"""

from __future__ import annotations

import dataclasses

from .. import generator as gen
from ..checker import Checker
from ..checker.elle import graphs
from ..history import history as as_history, is_fail, is_info, is_ok


@dataclasses.dataclass(frozen=True)
class _TableGen(gen.Gen):
    create_prob: float
    next_table: int
    next_row: int

    def op(self, test, ctx):
        if gen.rng.random() < self.create_prob:
            o = gen.fill_in_op(
                {"f": "create-table", "value": self.next_table}, ctx)
            if o is gen.PENDING:
                return gen.PENDING, self
            return o, dataclasses.replace(
                self, next_table=self.next_table + 1)
        # inserts may target the not-yet-created next table: that race
        # is the point of the workload
        t = gen.rng.randrange(self.next_table + 1)
        o = gen.fill_in_op(
            {"f": "insert", "value": [t, self.next_row]}, ctx)
        if o is gen.PENDING:
            return gen.PENDING, self
        return o, dataclasses.replace(self, next_row=self.next_row + 1)

    def update(self, test, ctx, event):
        return self


def generator(create_prob: float = 0.2) -> gen.Gen:
    return _TableGen(create_prob, 0, 0)


def _is_missing(op: dict) -> bool:
    err = op.get("error")
    return (isinstance(err, (list, tuple)) and len(err) == 2
            and err[0] == "table-missing")


class TableChecker(Checker):
    """Flags inserts that failed 'table-missing' though the table's
    create completed before they were invoked, and inserts that
    succeeded into a table no create (ok or :info — maybe-applied)
    ever touched."""

    def check(self, test, hist, opts):
        hist = as_history(hist).index().client_ops()
        nodes = [o for o in hist
                 if (is_ok(o) or is_fail(o) or is_info(o))
                 and o.get("f") in ("create-table", "insert")]
        iv = graphs.node_intervals(hist, nodes)
        create_done: dict = {}   # table -> earliest create-ok comp pos
        created_any: set = set()
        for o, (_ip, cp, ok) in zip(nodes, iv):
            if o.get("f") != "create-table":
                continue
            t = o.get("value")
            if ok:
                create_done[t] = min(cp, create_done.get(t, cp))
                created_any.add(t)
            elif is_info(o):
                created_any.add(t)
        missing_after_create = []
        phantom = []
        for o, (ip, _cp, ok) in zip(nodes, iv):
            if o.get("f") != "insert":
                continue
            t = (o.get("value") or [None])[0]
            if ok and t not in created_any:
                phantom.append(o)
            elif is_fail(o) and _is_missing(o) \
                    and create_done.get(t, ip + 1) < ip:
                missing_after_create.append(o)
        errors = {}
        if missing_after_create:
            errors["missing-after-create"] = missing_after_create
        if phantom:
            errors["phantom-table"] = phantom
        return {"valid?": not errors,
                "table-count": len(created_any),
                **errors}


def checker() -> Checker:
    return TableChecker()


def workload(opts: dict | None = None) -> dict:
    opts = opts or {}
    return {"checker": checker(),
            "generator": generator(opts.get("create-prob", 0.2))}
