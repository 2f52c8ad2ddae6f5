"""Long-fork detection: an anomaly legal in parallel snapshot isolation
but prohibited by SI (reference `jepsen/src/jepsen/tests/long_fork.clj`;
the algorithm is documented at length in its lines 1-95).

Write txns write a single key once ([['w', k, 1]]); read txns read a whole
key *group* ([['r', k1, None], ['r', k2, None], ...]). Since each key is
written exactly once, a total order over reads exists iff every pair of
reads in a group is comparable under "a dominates b when a's non-nil
observations are a superset of b's". An incomparable pair is a long fork:
r1 saw x but not y while r2 saw y but not x.
"""

from __future__ import annotations

import dataclasses
import itertools

from .. import generator as gen
from .. import txn as mop
from ..checker import Checker, UNKNOWN
from ..history import history as as_history, is_invoke, is_ok


def group_for(n: int, k: int) -> list[int]:
    """The collection of keys for key k's group (`long_fork.clj:97-104`)."""
    lo = k - (k % n)
    return list(range(lo, lo + n))


def read_txn_for(n: int, k: int) -> list:
    """A txn reading k's whole group, in shuffled order
    (`long_fork.clj:106-112`)."""
    ks = group_for(n, k)
    gen.rng.shuffle(ks)
    return [["r", k2, None] for k2 in ks]


@dataclasses.dataclass(frozen=True)
class Generator(gen.Gen):
    """Single-key writes of fresh keys, interleaved with group reads of
    recently written groups (`long_fork.clj:117-150`). workers maps a
    thread to the key it just wrote (it reads that group next)."""
    n: int
    next_key: int
    workers: tuple  # ((thread, key-or-None), ...)

    def _last_written(self, thread):
        for t, k in self.workers:
            if t == thread:
                return k
        return None

    def _with(self, thread, k):
        pairs = tuple((t, x) for t, x in self.workers if t != thread)
        return dataclasses.replace(self,
                                   workers=pairs + ((thread, k),))

    def op(self, test, ctx):
        process = gen.some_free_process(ctx)
        worker = gen.process_to_thread(ctx, process)
        if worker is None:
            return gen.PENDING, self
        k = self._last_written(worker)
        if k is not None:
            # we wrote a key; read its group and clear our last-written
            op = gen.fill_in_op(
                {"process": process, "f": "read",
                 "value": read_txn_for(self.n, k)}, ctx)
            return op, self._with(worker, None)
        active = [key for _, key in self.workers if key is not None]
        if gen.rng.random() < 0.5 and active:
            # read some other active group
            k2 = active[gen.rng.randrange(len(active))]
            op = gen.fill_in_op(
                {"process": process, "f": "read",
                 "value": read_txn_for(self.n, k2)}, ctx)
            return op, self
        # write a fresh key
        op = gen.fill_in_op(
            {"process": process, "f": "write",
             "value": [["w", self.next_key, 1]]}, ctx)
        return op, dataclasses.replace(
            self._with(worker, self.next_key), next_key=self.next_key + 1)

    def update(self, test, ctx, event):
        return self


def generator(n: int) -> Generator:
    return Generator(n, 0, ())


class IllegalHistory(Exception):
    def __init__(self, info: dict):
        self.info = info
        super().__init__(info.get("msg", "illegal history"))


def read_compare(a: dict, b: dict):
    """-1 if a dominates, 0 if equal, 1 if b dominates, None if
    incomparable (`long_fork.clj:158-196`)."""
    if len(a) != len(b) or set(a) != set(b):
        raise IllegalHistory(
            {"type": "illegal-history", "reads": [a, b],
             "msg": "These reads did not query for the same keys, and "
                    "therefore cannot be compared."})
    res = 0
    for k in a:
        va, vb = a[k], b[k]
        if va == vb:
            continue
        if vb is None:      # a observed more here
            if res > 0:
                return None
            res = -1
        elif va is None:    # b observed more here
            if res < 0:
                return None
            res = 1
        else:
            raise IllegalHistory(
                {"type": "illegal-history", "key": k, "reads": [a, b],
                 "msg": "These two read states contain distinct values "
                        "for the same key; this checker assumes only one "
                        "write occurs per key."})
    return res


def read_op_value_map(op: dict) -> dict:
    """A read op's txn as {key: value} (`long_fork.clj:198-206`)."""
    return {mop.key(m): mop.value(m) for m in op["value"]}


def distinct_pairs(coll):
    return list(itertools.combinations(coll, 2))


def find_forks(ops) -> list:
    """Mutually incomparable read pairs (`long_fork.clj:216-224`)."""
    forks = []
    for a, b in distinct_pairs(ops):
        if read_compare(read_op_value_map(a),
                        read_op_value_map(b)) is None:
            forks.append([a, b])
    return forks


def is_read_txn(txn) -> bool:
    return all(mop.is_read(m) for m in txn)


def is_write_txn(txn) -> bool:
    return len(txn) == 1 and mop.is_write(txn[0])


def op_read_keys(op: dict) -> frozenset:
    return frozenset(mop.key(m) for m in op["value"])


def groups(n: int, read_ops) -> list:
    """Partition read ops by key-group; a read observing the wrong number
    of keys is illegal (`long_fork.clj:248-261`)."""
    by_group: dict[frozenset, list] = {}
    for o in read_ops:
        by_group.setdefault(op_read_keys(o), []).append(o)
    out = []
    for group, ops in by_group.items():
        if len(group) != n:
            raise IllegalHistory(
                {"type": "illegal-history", "op": ops[0],
                 "msg": f"Every read in this history should have observed "
                        f"exactly {n} keys, but this read observed "
                        f"{len(group)} instead: {sorted(group)}"})
        out.append(ops)
    return out


def ensure_no_long_forks(n: int, reads) -> dict | None:
    forks = [f for ops in groups(n, reads) for f in find_forks(ops)]
    if forks:
        return {"valid?": False, "forks": forks}
    return None


def ensure_no_multiple_writes_to_one_key(hist) -> dict | None:
    seen: set = set()
    for o in hist:
        if is_invoke(o) and is_write_txn(o.get("value") or []):
            k = mop.key(o["value"][0])
            if k in seen:
                return {"valid?": UNKNOWN,
                        "error": ["multiple-writes", k]}
            seen.add(k)
    return None


def ok_reads(hist) -> list:
    return [o for o in hist
            if is_ok(o) and is_read_txn(o.get("value") or [])]


def early_reads(reads) -> list:
    """Reads that are too early to tell us anything (all nil)
    (`long_fork.clj:297-302`)."""
    return [o["value"] for o in reads
            if not any(mop.value(m) for m in o["value"])]


def late_reads(reads) -> list:
    """Reads that are too late to tell us anything (all written)
    (`long_fork.clj:304-309`)."""
    return [o["value"] for o in reads
            if all(mop.value(m) for m in o["value"])]


class LongForkChecker(Checker):
    """Searches for read pairs that order concurrent writes inconsistently
    (`long_fork.clj:311-324`)."""

    def __init__(self, n: int):
        self.n = n

    def check(self, test, hist, opts):
        hist = as_history(hist)
        reads = ok_reads(hist)
        out = {"reads-count": len(reads),
               "early-read-count": len(early_reads(reads)),
               "late-read-count": len(late_reads(reads))}
        try:
            err = (ensure_no_multiple_writes_to_one_key(hist)
                   or ensure_no_long_forks(self.n, reads)
                   or {"valid?": True})
        except IllegalHistory as e:
            err = {"valid?": UNKNOWN, "error": e.info}
        out.update(err)
        return out


def checker(n: int = 2) -> Checker:
    return LongForkChecker(n)


def workload(n: int = 2) -> dict:
    """Checker + generator hunting long forks; n is the group size
    (`long_fork.clj:326-332`)."""
    return {"checker": checker(n), "generator": generator(n)}
