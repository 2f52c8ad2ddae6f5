"""Additional precedence graphs for the Elle cycle search (reference
`jepsen/src/jepsen/tests/cycle.clj:9-16` folds extra graph analyzers —
most importantly `cycle/realtime-graph` — into the dependency-cycle
search; `tests/cycle/wr.clj:17-26` is the canonical consumer).

Two graphs are derivable from the history alone, no workload semantics
needed:

  * **realtime** — op A completed (:ok) before op B was invoked. Built
    with the completed-frontier construction: walking the journal in
    order, each invocation links from every member of the current
    antichain of maximal completed ops; a completion evicts the ops it
    was linked from. The edge set is transitively reduced (size is
    bounded by concurrency x ops, not ops^2) and its transitive closure
    is exactly the realtime order — all the cycle search needs. :info
    ops never complete, so they take incoming edges only.
  * **process** — same process, consecutive ops. A chain edge per
    adjacent pair; an :info op ends its chain (its effect time is
    unknown, and in Jepsen a crashed process number is never reused).
    Since a process invokes its next op only after the previous
    completed, process edges are a subset of the realtime relation —
    which is why the classifier's realtime level folds both
    (`kernels._LEVEL_SPECS`).

The edges union with the workload-derived ww/wr/rw edges into one
adjacency structure (`union_edges`) and ride the existing pipeline
unchanged: one sparse SCC condensation over the union, then per-level
dense classification on device (kernels.py stacks the levels along the
batch axis, so the classifier itself never changes). Cycles
that *require* a precedence edge classify as G0-process, G0-realtime,
G1c-process, G1c-realtime, G-single-process, G-single-realtime,
G2-item-process, G2-item-realtime — the reference's `elle.txn`
taxonomy.

The port's own copy of `jepsen_tpu/checker/elle/graphs.py` (host code,
no device work).
"""

from __future__ import annotations

from ...history import history as as_history, is_ok
from . import kernels

GRAPH_NAMES = ("realtime", "process")


def node_intervals(hist, ops) -> list:
    """Per-op (inv_pos, comp_pos, ok?) tuples, positions within `hist`'s
    journal order (which the interpreter guarantees is consistent with
    real time). `ops` are completion ops drawn from `hist`; an op whose
    invocation was not journaled (completion-only histories are legal
    checker input) gets inv_pos -1 — "invoked before everything" — so
    it can never *gain* a precedence edge it cannot prove, only grant
    them from its journaled completion."""
    hist = as_history(hist)
    pos_of = {id(o): p for p, o in enumerate(hist.ops)}
    pairs = hist.pair_index()
    end = len(hist.ops)
    out = []
    for o in ops:
        cp = pos_of.get(id(o))
        if cp is None:
            out.append((end, end, False))
            continue
        ip = pairs.get(cp, -1)
        out.append((min(ip, cp), cp, is_ok(o)))
    return out


def realtime_edges(hist, txns) -> dict:
    """{(i, j): mask} — txn i completed before txn j was invoked
    (transitively reduced via the completed frontier)."""
    iv = node_intervals(hist, txns)
    events = []
    for ti, (ip, cp, ok) in enumerate(iv):
        events.append((ip, 0, ti))
        if ok:
            events.append((cp, 1, ti))
    events.sort()
    acc: dict[tuple, int] = {}
    frontier: set[int] = set()
    snapshot: dict[int, frozenset] = {}
    for _pos, tag, ti in events:
        if tag == 0:    # invocation: link from the completed frontier
            s = frozenset(frontier)
            snapshot[ti] = s
            for a in s:
                acc[(a, ti)] = kernels._RT
        else:           # completion: evict everything it was linked from
            frontier -= snapshot.get(ti, frozenset())
            frontier.add(ti)
    return acc


def process_edges(hist, txns) -> dict:
    """{(i, j): mask} — consecutive ops of one process, chained in
    *completion* order; edges originate only from :ok ops. A process is
    sequential (it invokes its next op only after the previous one
    completed), so its completions journal in op order — which makes
    completion position the correct chain key even for ops whose
    invocation was never journaled (invocation order would put those
    first and fabricate reversed edges)."""
    iv = node_intervals(hist, txns)
    by_proc: dict = {}
    for ti, (_ip, cp, _ok) in enumerate(iv):
        by_proc.setdefault(txns[ti].get("process"), []).append((cp, ti))
    acc: dict[tuple, int] = {}
    for lst in by_proc.values():
        lst.sort()
        for (_, a), (_, b) in zip(lst, lst[1:]):
            if is_ok(txns[a]):
                acc[(a, b)] = kernels._PROC
    return acc


_BUILDERS = {"realtime": realtime_edges, "process": process_edges}


def additional_edges(hist, txns, graphs) -> dict:
    """Union of the requested precedence graphs over the txn node list,
    as {(i, j): frozenset of edge-type names}."""
    hist = as_history(hist)
    acc: dict[tuple, int] = {}
    for g in graphs:
        builder = _BUILDERS.get(g)
        if builder is None:
            raise ValueError(f"unknown additional graph {g!r}; "
                             f"expected one of {GRAPH_NAMES}")
        for k, m in builder(hist, txns).items():
            acc[k] = acc.get(k, 0) | m
    return kernels.mask_edges_to_sets(acc)


def union_edges(*edge_dicts) -> dict:
    """Union several {(i, j): types} edge dicts into one (types may be
    frozensets or masks); the result uses the shared frozensets."""
    acc: dict[tuple, int] = {}
    for d in edge_dicts:
        for k, t in d.items():
            acc[k] = acc.get(k, 0) | kernels.type_mask(t)
    return kernels.mask_edges_to_sets(acc)


def expand_anomalies(anomalies, graphs) -> tuple:
    """Extend an anomaly list with the -process/-realtime variants of
    whichever cycle anomalies it already names, per the requested
    graphs. A caller asking for G-single with realtime edges is asking
    for G-single-realtime too (`tests/cycle/wr.clj:17-26` wires the
    realtime analyzer in exactly this implicit way)."""
    out = list(anomalies)
    for base in kernels._VARIANT_BASES:
        if base not in out:
            continue
        if "process" in graphs:
            out.append(base + "-process")
        if "realtime" in graphs:
            out.append(base + "-realtime")
    return tuple(dict.fromkeys(out))
