"""Elle-class list-append checker (reference consumes
`elle.list-append/check` via `jepsen/src/jepsen/tests/cycle/append.clj:
11-55`; algorithm re-derived from the Elle paper's list-append analysis).

Txns are micro-op lists mixing ['append', k, v] and ['r', k, [v...]].
Because appends are traceable — every read of k returns the *full
append order so far* — the per-key version order is recoverable:

  * a read whose value is None carries no information (the client never
    filled it in); an observed-empty read is [];
  * every observed read list must be a prefix of the longest one
    (else 'incompatible-order');
  * the longest list per key is the version chain v1 < v2 < ...;
  * ww: writer(vi) -> writer(vi+1) for consecutive versions with
    distinct writers;
  * wr: writer(last element of a read) -> reader;
  * rw: reader of a prefix ending at vi -> writer(vi+1) (reads of the
    empty list anti-depend on the first writer).

Single-pass anomalies: duplicate appended elements, G1a (reading a
failed txn's append), G1b (observing an intermediate state of a
multi-append txn), internal (a txn's read inconsistent with its own
earlier ops).

Cycle anomalies (G0/G1c/G-single/G2-item) are decided by
`kernels.analyze_edges` (sparse SCC condensation + batched dense
classification on the card); certificates are reconstructed host-side.

The port's own copy of `jepsen_tpu/checker/elle/list_append.py`: the
graph build is the same host code; `check` runs its classification on
CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any

from ... import parallel, txn as mop
from ...history import history as as_history, is_fail, is_info, is_ok
from . import graphs as precedence, kernels


def _is_append(m) -> bool:
    return m[0] == "append"


# edge-type bitmask for graph()'s hot accumulation path; kernels owns
# the canonical bits and the mask -> shared-frozenset table in the
# {(i, j): {'ww', ...}} shape the cycle analyzers consume
_WW, _WR, _RW = kernels._WW, kernels._WR, kernels._RW


def op_internal_case(op: dict) -> dict | None:
    """A txn's reads must be consistent with its own earlier appends: a
    read of k after this txn appended vs must end with those vs in
    order."""
    # micro-op fields accessed positionally (f, k, v = m): this loop
    # runs once per mop over 100k-txn histories
    expected_suffix: dict[Any, list] = {}
    prev_read: dict[Any, list] = {}
    for m in op.get("value") or ():
        k = m[1]
        if m[0] == "append":
            expected_suffix.setdefault(k, []).append(m[2])
            if k in prev_read:
                prev_read[k] = prev_read[k] + [m[2]]
        elif m[0] == "r":
            if m[2] is None:
                continue  # unfilled read: no information
            v = list(m[2])
            suffix = expected_suffix.get(k, [])
            if suffix and v[len(v) - len(suffix):] != suffix:
                return {"op": op, "mop": list(m),
                        "expected": ["...", *suffix]}
            if k in prev_read and v[:len(prev_read[k])] != prev_read[k]:
                return {"op": op, "mop": list(m),
                        "expected": prev_read[k]}
            prev_read[k] = v
    return None


def internal_cases(hist) -> list:
    # a txn needs at least two mops to disagree with itself; skipping
    # the (common) single-mop txns saves two dict allocations each
    # across a 100k-txn history
    out = []
    for o in hist:
        if is_ok(o):
            v = o.get("value")
            if v is not None and len(v) > 1:
                c = op_internal_case(o)
                if c is not None:
                    out.append(c)
    return out


class _Analysis:
    """Shared single-pass extraction over an indexed client history."""

    def __init__(self, hist):
        hist = as_history(hist).index().client_ops()
        self.hist = hist
        self.oks = [o for o in hist if is_ok(o)]
        self.infos = [o for o in hist if is_info(o)]
        self.fails = [o for o in hist if is_fail(o)]
        # txns is the graph's node order; writer_of[k][v] -> (txn index,
        # final?) for ok/info appends.  Indices (not op objects) keep
        # the 100k-txn hot loops free of id()-keyed lookups — an ok
        # writer is exactly an index < len(self.oks).
        self.txns = self.oks + self.infos
        self.writer_of: dict[Any, dict[Any, tuple]] = {}
        self.duplicates: list = []
        # ok_reads: every informative read mop of an ok txn, extracted
        # once as (reader txn index, op, mop) — version_orders, g1a,
        # g1b, and graph() all iterate this flat list instead of
        # re-dispatching over every op's mop list (4 extra full passes
        # at 100k-txn scale)
        self.ok_reads: list[tuple] = []
        n_oks = len(self.oks)
        for ti, o in enumerate(self.txns):
            appended: dict[Any, list] = {}
            val = o.get("value")
            if ti >= n_oks and not isinstance(val, (list, tuple)):
                continue  # info op that crashed before we knew the txn
            is_ok_t = ti < n_oks
            for m in val or ():
                if m[0] == "append":
                    appended.setdefault(m[1], []).append(m[2])
                elif is_ok_t and m[0] == "r" and m[2] is not None:
                    self.ok_reads.append((ti, o, m))
            for k, vs in appended.items():
                for i, v in enumerate(vs):
                    w = self.writer_of.setdefault(k, {})
                    if v in w:
                        self.duplicates.append(
                            {"key": k, "value": v,
                             "ops": [self.txns[w[v][0]], o]})
                    w[v] = (ti, i == len(vs) - 1)
        self.failed_writes = {
            (mop.key(m), mop.value(m)): o
            for o in self.fails
            for m in (o.get("value") or ())
            if _is_append(m)}

    def version_orders(self):
        """Longest observed prefix per key; returns (orders, incompatible)
        where orders[k] is the version chain and incompatible lists
        prefix-violations."""
        longest: dict[Any, list] = {}
        incompatible: list = []
        for _ri, o, m in self.ok_reads:
            k, v = m[1], list(m[2])
            cur = longest.get(k, [])
            shorter, lnger = (v, cur) if len(v) <= len(cur) \
                else (cur, v)
            if lnger[:len(shorter)] != shorter:
                incompatible.append(
                    {"key": k, "values": [cur, v], "op": o})
            elif len(v) > len(cur):
                longest[k] = v
        return longest, incompatible

    def g1a_cases(self) -> list:
        """Reads observing a failed append (`aborted read`)."""
        fw = self.failed_writes
        if not fw:
            return []   # no failed appends: nothing to observe
        # only reads of keys with a failed append can hit; scanning
        # every element of every read otherwise costs ~1s per 100k txns
        fkeys = {k for k, _v in fw}
        cases = []
        for _ri, o, m in self.ok_reads:
            if m[2] and m[1] in fkeys:
                k = m[1]
                for v in m[2]:
                    w = fw.get((k, v))
                    if w is not None:
                        cases.append({"op": o, "mop": list(m),
                                      "writer": w})
        return cases

    def g1b_cases(self) -> list:
        """Reads whose final observed element is a non-final append of a
        multi-append txn (`intermediate read`)."""
        cases = []
        wo = self.writer_of
        empty: dict = {}
        for ri, o, m in self.ok_reads:
            if m[2]:
                k, v = m[1], m[2][-1]
                w = wo.get(k, empty).get(v)
                if w is not None and not w[1] and w[0] != ri:
                    cases.append({"op": o, "mop": list(m),
                                  "writer": self.txns[w[0]]})
        return cases


def graph(hist):
    """Build the sparse dependency graph. Returns (txn_ops, edges, a,
    incompatible) where txn_ops[i] is the i-th transaction (ok/info) and
    edges maps (i, j) -> set of edge-type strings.

    rw edges stay linear in history size: a read of the chain prefix
    ending at v_i anti-depends on writer(v_{i+1}) only — the *immediate*
    in-chain successor; anti-dependencies on later versions are rw;ww*
    composites reconstructed through the ww chain, which preserves both
    cycle detection and the one-vs-many-rw classification. Appends never
    observed in any read carry genuine information of their own — the
    read proves they happened after its snapshot — so each reader
    anti-depends on every never-observed :ok append of its key (crashed
    never-observed appends may not have executed)."""
    a = _Analysis(hist)
    txns = a.txns
    n_oks = len(a.oks)
    # hot path (~5 calls per op on 100k-txn histories): bitmask edge
    # accumulation inlined (an add() call per edge costs ~25% of the
    # whole build at this scale), converted once at the end to the
    # {(i, j): {type, ...}} shape consumers read (kernels owns the
    # representation); writer_of holds txn INDICES, so no id()-keyed
    # lookups anywhere
    acc: dict[tuple, int] = {}
    acc_get = acc.get

    orders, incompatible = a.version_orders()
    writer_of = a.writer_of
    empty: dict = {}
    # ww along each key's observed version chain
    for k, chain in orders.items():
        writers = writer_of.get(k, empty)
        wget = writers.get
        for v1, v2 in zip(chain, chain[1:]):
            w1, w2 = wget(v1), wget(v2)
            if w1 and w2 and w1[0] != w2[0]:
                key = (w1[0], w2[0])
                acc[key] = acc_get(key, 0) | _WW
    # never-observed :ok appends per key (not in the longest chain):
    # ok txns are exactly indices < n_oks
    unobserved: dict[Any, list] = {}
    for k, writers in writer_of.items():
        observed = set(orders.get(k, ()))
        un = [wi for v, (wi, _f) in writers.items()
              if v not in observed and wi < n_oks]
        if un:
            unobserved[k] = un
    # wr + rw per read (over the pre-extracted flat read list)
    for i_reader, _o, m in a.ok_reads:
        k = m[1]
        vs = m[2]
        writers = writer_of.get(k, empty)
        chain = orders.get(k, ())
        if vs:
            w = writers.get(vs[-1])
            if w is not None and w[0] != i_reader:
                key = (w[0], i_reader)
                acc[key] = acc_get(key, 0) | _WR
        # first in-chain successor with a known writer (observed =>
        # committed, so info writers count too). Versions with no
        # known writer — phantom values a corrupt store fabricated —
        # are skipped over, not stopped at, so the anti-dependency
        # still lands on the next real writer. If that writer is
        # the reader itself, its own ww chain edge carries the
        # composite onward and no rw edge is needed.
        p = len(vs)
        while p < len(chain):
            w2 = writers.get(chain[p])
            if w2 is not None:
                if w2[0] != i_reader:
                    key = (i_reader, w2[0])
                    acc[key] = acc_get(key, 0) | _RW
                break
            p += 1
        for wi in unobserved.get(k, ()):
            if wi != i_reader:
                key = (i_reader, wi)
                acc[key] = acc_get(key, 0) | _RW
    edges = kernels.mask_edges_to_sets(acc)
    return txns, edges, a, incompatible


DEFAULT_ANOMALIES = ("G0", "G1a", "G1b", "G1c", "G-single", "G2-item",
                     "internal", "duplicate-elements",
                     "incompatible-order")


def check(hist, anomalies=DEFAULT_ANOMALIES, mesh=None,
          additional_graphs=(), device=None) -> dict:
    """Full list-append analysis. Returns {'valid?': ..,
    'anomaly-types': [..], 'anomalies': {type: [case...]}}, matching the
    reference checker's result shape (`tests/cycle/append.clj:28-55`).
    additional_graphs names extra precedence graphs
    ('realtime'/'process') to union into the cycle search, enabling the
    -realtime/-process anomaly variants. device: where the SCC
    classifier runs (None = CUDA, raising without it; "cpu" = the plain
    PyTorch path; None = the mesh's device, else CUDA). mesh: a
    `parallel.Mesh` or a `DeviceMesh` to shard the SCC classifier over,
    as the JAX package's mesh (every rank makes the same call)."""
    mesh, dev = parallel.resolve(mesh, device)
    hist = as_history(hist).index()
    txns, edges, a, incompatible = graph(hist)
    if additional_graphs:
        edges = precedence.union_edges(
            edges, precedence.additional_edges(a.hist, txns,
                                               additional_graphs))
        anomalies = precedence.expand_anomalies(anomalies,
                                                additional_graphs)
    found: dict[str, list] = {}

    if a.duplicates:
        found["duplicate-elements"] = a.duplicates
    if incompatible:
        found["incompatible-order"] = incompatible
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
