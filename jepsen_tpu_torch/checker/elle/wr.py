"""Elle-class rw-register checker (reference consumes
`elle.rw-register/check` via `jepsen/src/jepsen/tests/cycle/wr.clj:14-54`,
anomaly taxonomy documented there at lines 31-45).

Txns mix ['w', k, v] and ['r', k, v] micro-ops over registers. Writes are
assumed globally unique per key (duplicates are flagged); version order is
only *partially* recoverable, from:

  * the initial state: nil precedes every written value;
  * intra-txn sequencing: a txn that observes u (by read or its own
    write) and then writes v establishes u < v.

Edges: wr from each value's writer to its external readers (exact); ww
between writers of known-ordered values; rw from a reader of u to the
writers of known successors of u (a read of nil anti-depends on every
writer of that key). rw edges built from non-immediate successions are
rw;ww* composites — sound for cycle detection and classification, since
the composite still contains exactly one anti-dependency.

Single-pass anomalies: G1a (aborted read), G1b (intermediate read — a
read of a txn's non-final write), internal (txn disagrees with its own
prior ops), duplicate writes.

The port's own copy of `jepsen_tpu/checker/elle/wr.py`: the graph build
is the same host code; `check` runs its classification on CUDA unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any

from ... import txn as mop
from ...history import history as as_history, is_fail, is_info, is_ok
from ... import parallel
from . import graphs as precedence, kernels

_WW, _WR, _RW = kernels._WW, kernels._WR, kernels._RW

_INIT = object()  # the unwritten initial state (reads return None)


def op_internal_case(op: dict) -> dict | None:
    """A read must agree with the txn's own latest prior op on that key."""
    # positional micro-op access (f, k, v = m): once per mop on
    # 10k-txn histories
    known: dict[Any, Any] = {}
    for m in op.get("value") or ():
        k, v = m[1], m[2]
        if m[0] == "r":
            if k in known and known[k] != v:
                return {"op": op, "mop": list(m), "expected": known[k]}
            known[k] = v
        elif m[0] == "w":
            known[k] = v
    return None


def internal_cases(hist) -> list:
    return [c for o in hist if is_ok(o)
            for c in [op_internal_case(o)] if c is not None]


class _Analysis:
    def __init__(self, hist):
        hist = as_history(hist).index().client_ops()
        self.hist = hist
        self.oks = [o for o in hist if is_ok(o)]
        self.infos = [o for o in hist if is_info(o)
                      and isinstance(o.get("value"), (list, tuple))]
        self.fails = [o for o in hist if is_fail(o)]
        # (k, v) -> (op, final?) over ok/info writes
        self.writer_of: dict[tuple, tuple] = {}
        self.duplicates: list = []
        for o in self.oks + self.infos:
            writes: dict[Any, list] = {}
            for m in o.get("value") or ():
                # a None-valued write is unresolved (e.g. a crashed
                # read-increment whose value was never filled in): it
                # identifies no version, so it carries no information
                if m[0] == "w" and m[2] is not None:
                    writes.setdefault(m[1], []).append(m[2])
            for k, vs in writes.items():
                for i, v in enumerate(vs):
                    if (k, v) in self.writer_of:
                        self.duplicates.append(
                            {"key": k, "value": v,
                             "ops": [self.writer_of[(k, v)][0], o]})
                    self.writer_of[(k, v)] = (o, i == len(vs) - 1)
        self.failed_writes = {
            (mop.key(m), mop.value(m)): o
            for o in self.fails
            for m in (o.get("value") or ())
            if mop.is_write(m) and mop.value(m) is not None}

    def version_pairs(self):
        """Known per-key order pairs {k: set of (u, v)} with u possibly
        _INIT, from intra-txn sequencing."""
        pairs: dict[Any, set] = {}
        for o in self.oks:
            cur: dict[Any, Any] = {}
            for m in o.get("value") or ():
                k, v = m[1], m[2]
                if m[0] == "r":
                    cur[k] = _INIT if v is None else v
                elif v is not None:
                    u = cur.get(k)
                    if u is not None and u != v:
                        pairs.setdefault(k, set()).add((u, v))
                    cur[k] = v
        return pairs

    def g1a_cases(self) -> list:
        cases = []
        fw = self.failed_writes
        for o in self.oks:
            for m in o.get("value") or ():
                if m[0] == "r" and m[2] is not None:
                    w = fw.get((m[1], m[2]))
                    if w is not None:
                        cases.append({"op": o, "mop": list(m),
                                      "writer": w})
        return cases

    def g1b_cases(self) -> list:
        cases = []
        wo = self.writer_of
        for o in self.oks:
            for m in o.get("value") or ():
                if m[0] == "r" and m[2] is not None:
                    w = wo.get((m[1], m[2]))
                    if w is not None and not w[1] and id(w[0]) != id(o):
                        cases.append({"op": o, "mop": list(m),
                                      "writer": w[0]})
        return cases


def graph(hist):
    """(txns, edges, analysis) — sparse dependency graph; see module
    docstring for the edge-inference rules."""
    a = _Analysis(hist)
    txns = a.oks + a.infos
    idx = {id(o): i for i, o in enumerate(txns)}
    # bitmask edge accumulation inlined, as in list_append.graph
    acc: dict[tuple, int] = {}
    acc_get = acc.get

    pairs = a.version_pairs()
    writers_by_key: dict[Any, list] = {}
    for (k, v), w in a.writer_of.items():
        writers_by_key.setdefault(k, []).append((v, w[0]))

    # ww between known-ordered writes
    for k, ps in pairs.items():
        for u, v in ps:
            wv = a.writer_of.get((k, v))
            if wv is None:
                continue
            if u is not _INIT:
                wu = a.writer_of.get((k, u))
                if wu is not None and wu[0] is not wv[0]:
                    key = (idx[id(wu[0])], idx[id(wv[0])])
                    acc[key] = acc_get(key, 0) | _WW

    # wr + rw, one ext_reads pass per op (each read-map is consumed
    # while hot rather than precomputed into a list — keeping 10k maps
    # alive simultaneously measurably worsens best-case locality):
    # wr: writer -> external reader (exact); rw: external reader of u
    # -> writers of known successors of u, and a read of nil
    # anti-depends on every writer of that key
    succ: dict[tuple, list] = {}
    for k, ps in pairs.items():
        for u, v in ps:
            succ.setdefault((k, u), []).append(v)
    for o in a.oks:
        for k, v in mop.ext_reads(o.get("value") or ()).items():
            if v is None:
                for _, w in writers_by_key.get(k, ()):
                    if w is not o:
                        key = (idx[id(o)], idx[id(w)])
                        acc[key] = acc_get(key, 0) | _RW
                continue
            w = a.writer_of.get((k, v))
            if w is not None and w[0] is not o:
                key = (idx[id(w[0])], idx[id(o)])
                acc[key] = acc_get(key, 0) | _WR
            for v2 in succ.get((k, v), ()):
                w2 = a.writer_of.get((k, v2))
                if w2 is not None and w2[0] is not o:
                    key = (idx[id(o)], idx[id(w2[0])])
                    acc[key] = acc_get(key, 0) | _RW
    edges = kernels.mask_edges_to_sets(acc)
    return txns, edges, a


DEFAULT_ANOMALIES = ("G0", "G1a", "G1b", "G1c", "G-single", "G2-item",
                     "internal", "duplicate-writes")


def check(hist, anomalies=DEFAULT_ANOMALIES, mesh=None,
          additional_graphs=(), device=None) -> dict:
    """Full rw-register analysis; result shape mirrors the reference
    checker (`tests/cycle/wr.clj:46-54`). additional_graphs names extra
    precedence graphs ('realtime'/'process') to union into the cycle
    search, enabling the -realtime/-process anomaly variants. device
    and mesh as in `list_append.check`."""
    mesh, dev = parallel.resolve(mesh, device)
    hist = as_history(hist).index()
    txns, edges, a = graph(hist)
    if additional_graphs:
        edges = precedence.union_edges(
            edges, precedence.additional_edges(a.hist, txns,
                                               additional_graphs))
        anomalies = precedence.expand_anomalies(anomalies,
                                                additional_graphs)
    found: dict[str, list] = {}
    if a.duplicates:
        found["duplicate-writes"] = a.duplicates
    g1a = a.g1a_cases()
    if g1a:
        found["G1a"] = g1a
    g1b = a.g1b_cases()
    if g1b:
        found["G1b"] = g1b
    internal = internal_cases(a.hist)
    if internal:
        found["internal"] = internal

    cyc = kernels.analyze_edges(len(txns), edges, mesh=mesh, device=dev)
    found.update(kernels.certificates(txns, edges, cyc))

    reported = {t: cases for t, cases in found.items() if t in anomalies}
    return {
        "valid?": not reported,
        "anomaly-types": sorted(reported),
        "anomalies": reported,
        "txn-count": len(txns),
    }
