"""Comments workload (reference
`cockroachdb/src/jepsen/cockroach/comments.clj`): writers insert
uniquely-numbered rows ("comments") and readers list every row they can
see. Under strict serializability a reader can never observe a later
insert while missing an earlier one that *completed before the later
one began* — the classic "comment 5 appears before comment 3" gap
CockroachDB's non-linearizable timestamp allocation makes possible.
That ordering is exactly the realtime precedence relation, so the
checker leans on the Elle additional-graphs layer
(`checker/elle/graphs.node_intervals`) for the completed-before-invoked
pairs instead of trusting wall clocks.

Ops: {'f': 'write', 'value': id} and {'f': 'read', 'value': None},
whose :ok carries the list of observed ids.
"""

from __future__ import annotations

import dataclasses

from .. import generator as gen
from ..checker import Checker
from ..checker.elle import graphs
from ..history import history as as_history, is_info, is_ok


@dataclasses.dataclass(frozen=True)
class _CommentsGen(gen.Gen):
    next_id: int

    def op(self, test, ctx):
        if gen.rng.random() < 0.5:
            o = gen.fill_in_op({"f": "write", "value": self.next_id},
                               ctx)
            if o is gen.PENDING:
                return gen.PENDING, self
            return o, dataclasses.replace(self, next_id=self.next_id + 1)
        o = gen.fill_in_op({"f": "read", "value": None}, ctx)
        if o is gen.PENDING:
            return gen.PENDING, self
        return o, self

    def update(self, test, ctx, event):
        return self


def generator() -> gen.Gen:
    return _CommentsGen(0)


class CommentsChecker(Checker):
    """Hunts realtime gaps: a read that observed id b but not id a,
    where a's insert completed before b's insert was invoked; and stale
    reads: a read invoked after a's insert completed that misses a."""

    def check(self, test, hist, opts):
        from bisect import bisect_left

        hist = as_history(hist).index().client_ops()
        writes = [o for o in hist
                  if o.get("f") == "write" and (is_ok(o) or is_info(o))]
        reads = [o for o in hist if o.get("f") == "read" and is_ok(o)]
        w_iv = graphs.node_intervals(hist, writes)
        r_iv = graphs.node_intervals(hist, reads)
        inv_of = {o["value"]: ip for o, (ip, _cp, _ok)
                  in zip(writes, w_iv)}
        # acknowledged writes only, sorted by completion position: an
        # :info insert may never have happened, so missing it proves
        # nothing. comp_rank lets each read count its seen-and-
        # relevant writes in O(|seen|); only a read with a genuine
        # mismatch (an anomaly) pays for the prefix scan — a valid
        # 100k-op history stays linear in total read size.
        acked = sorted(((cp, o["value"], o) for o, (_ip, cp, ok)
                        in zip(writes, w_iv) if ok))
        comps = [cp for cp, _a, _o in acked]
        comp_rank = {a: i for i, (_cp, a, _o) in enumerate(acked)}
        gaps = []
        stale = []
        for o, (r_ip, _cp, _ok) in zip(reads, r_iv):
            if not isinstance(o.get("value"), (list, tuple, set)):
                continue
            seen = set(o["value"])
            latest_inv = max((inv_of[b] for b in seen if b in inv_of),
                             default=-1)
            bound = max(r_ip, latest_inv)
            n_prefix = bisect_left(comps, bound)
            n_matched = sum(1 for b in seen
                            if comp_rank.get(b, n_prefix) < n_prefix)
            if n_matched == n_prefix:
                continue  # every realtime-preceding write was observed
            for comp, a, wop in acked[:n_prefix]:
                if a in seen:
                    continue
                if comp < r_ip:
                    stale.append({"read": o, "missing": wop})
                else:
                    gaps.append({"read": o, "missing": wop})
        errors = {}
        if gaps:
            errors["realtime-gaps"] = gaps
        if stale:
            errors["stale-reads"] = stale
        return {"valid?": not errors,
                "read-count": len(reads),
                "write-count": len(acked),
                **errors}


def checker() -> Checker:
    return CommentsChecker()


def workload(opts: dict | None = None) -> dict:
    opts = opts or {}
    return {"checker": checker(), "generator": generator()}
