"""The O(n) fold checkers.

Behavioral parity with `jepsen/src/jepsen/checker.clj`:
stats (:166-183), unhandled-exceptions (:124-151), queue (:218-238),
set (:240-291), set-full (:294-592), total-queue (:628-687, with drain
expansion :594-626), unique-ids (:689-734), counter (:737-795),
log-file-pattern (:839-881).
"""

from __future__ import annotations

import os
import re
from collections import Counter
from typing import Any

from .. import models as m
from ..history import (History, NEMESIS, is_client_op, is_fail, is_info,
                       is_invoke, is_ok)
from ..util import bounded_pmap, integer_interval_set_str, nanos_to_ms
from . import Checker, UNKNOWN, merge_valid


def _stats(ops) -> dict:
    ok = sum(1 for o in ops if is_ok(o))
    fail = sum(1 for o in ops if is_fail(o))
    info = sum(1 for o in ops if is_info(o))
    return {"valid?": ok > 0, "count": ok + fail + info,
            "ok-count": ok, "fail-count": fail, "info-count": info}


class Stats(Checker):
    """Success/failure rates, overall and by :f. Valid iff every :f saw at
    least one :ok op."""

    def check(self, test, hist, opts):
        comps = [o for o in hist
                 if not is_invoke(o) and o.get("process") != NEMESIS]
        by_f: dict = {}
        for o in comps:
            by_f.setdefault(o["f"], []).append(o)
        groups = {f: _stats(ops) for f, ops in sorted(by_f.items(),
                                                      key=lambda kv: str(kv[0]))}
        out = _stats(comps)
        out["by-f"] = groups
        out["valid?"] = merge_valid(g["valid?"] for g in groups.values())
        return out


def stats() -> Checker:
    return Stats()


class UnhandledExceptions(Checker):
    """Aggregates :info ops carrying an :exception, grouped by class,
    descending frequency."""

    def check(self, test, hist, opts):
        excs = [o for o in hist
                if o.get("exception") is not None and is_info(o)]
        groups: dict = {}
        for o in excs:
            cls = o["exception"].get("class") \
                if isinstance(o["exception"], dict) \
                else type(o["exception"]).__name__
            groups.setdefault(cls, []).append(o)
        out = [{"count": len(ops), "class": cls, "example": ops[0]}
               for cls, ops in sorted(groups.items(),
                                      key=lambda kv: -len(kv[1]))]
        result = {"valid?": True}
        if out:
            result["exceptions"] = out
        return result


def unhandled_exceptions() -> Checker:
    return UnhandledExceptions()


class Queue(Checker):
    """Every dequeue must come from somewhere: assume every non-failing
    enqueue succeeded, only :ok dequeues succeeded; fold through the model."""

    def __init__(self, model: m.Model):
        self.model = model

    def check(self, test, hist, opts):
        state = self.model
        for o in hist:
            take = (is_invoke(o) if o["f"] == "enqueue"
                    else is_ok(o) if o["f"] == "dequeue" else False)
            if not take:
                continue
            state = state.step(o)
            if m.is_inconsistent(state):
                return {"valid?": False, "error": state.msg}
        return {"valid?": True, "final-queue": state}


def queue(model: m.Model) -> Checker:
    return Queue(model)


class SetChecker(Checker):
    """:add ops followed by a final :read; every acknowledged add must be
    present, and nothing never-attempted may appear."""

    def check(self, test, hist, opts):
        attempts = {o["value"] for o in hist
                    if is_invoke(o) and o["f"] == "add"}
        adds = {o["value"] for o in hist if is_ok(o) and o["f"] == "add"}
        final_read = None
        for o in hist:
            if is_ok(o) and o["f"] == "read":
                final_read = o["value"]
        if final_read is None:
            return {"valid?": UNKNOWN, "error": "Set was never read"}
        final_read = set(final_read)
        ok = final_read & attempts
        unexpected = final_read - attempts
        lost = adds - final_read
        recovered = ok - adds
        return {
            "valid?": not lost and not unexpected,
            "attempt-count": len(attempts),
            "acknowledged-count": len(adds),
            "ok-count": len(ok),
            "lost-count": len(lost),
            "recovered-count": len(recovered),
            "unexpected-count": len(unexpected),
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
        }


def set_checker() -> Checker:
    return SetChecker()


# -- set-full ---------------------------------------------------------------

class _SetElement:
    """Timeline state for one element (reference SetFullElement,
    checker.clj:313-344)."""

    __slots__ = ("element", "known", "last_present", "last_absent")

    def __init__(self, element):
        self.element = element
        self.known = None          # completion op confirming existence
        self.last_present = None   # most recent observing read *invocation*
        self.last_absent = None    # most recent missing read *invocation*

    def add_ok(self, op):
        if self.known is None:
            self.known = op

    def read_present(self, inv, op):
        if self.known is None:
            self.known = op
        if self.last_present is None or \
                self.last_present["index"] < inv["index"]:
            self.last_present = inv

    def read_absent(self, inv, op):
        if self.last_absent is None or \
                self.last_absent["index"] < inv["index"]:
            self.last_absent = inv


def _set_element_results(e: _SetElement) -> dict:
    def idx(op, default=-1):
        return op["index"] if op is not None else default

    stable = e.last_present is not None and \
        idx(e.last_absent) < idx(e.last_present)
    lost = (e.known is not None and e.last_absent is not None
            and idx(e.last_present) < idx(e.last_absent)
            and idx(e.known) < idx(e.last_absent))
    never_read = not (stable or lost)
    known_time = e.known["time"] if e.known else None
    stable_time = ((e.last_absent["time"] + 1 if e.last_absent else 0)
                   if stable else None)
    lost_time = ((e.last_present["time"] + 1 if e.last_present else 0)
                 if lost else None)
    stable_latency = (int(nanos_to_ms(max(0, stable_time - known_time)))
                      if stable else None)
    lost_latency = (int(nanos_to_ms(max(0, lost_time - known_time)))
                    if lost else None)
    return {"element": e.element,
            "outcome": ("stable" if stable else
                        "lost" if lost else "never-read"),
            "stable-latency": stable_latency,
            "lost-latency": lost_latency,
            "known": e.known,
            "last-absent": e.last_absent}


def _frequency_distribution(points, xs):
    xs = sorted(xs)
    if not xs:
        return None
    n = len(xs)
    return {p: xs[min(n - 1, int(n * p))] for p in points}


class SetFull(Checker):
    """Per-element stable/lost timeline analysis (reference set-full,
    checker.clj:461-592). With linearizable=True, stale reads fail."""

    def __init__(self, linearizable: bool = False):
        self.linearizable = linearizable

    def check(self, test, hist, opts):
        hist = History(hist).index()
        elements: dict[Any, _SetElement] = {}
        reads: dict[int, dict] = {}   # process -> read invocation
        dups: dict[Any, int] = {}     # element -> max multiplicity > 1
        for o in hist:
            if not is_client_op(o):
                continue
            f, p, v = o["f"], o["process"], o["value"]
            if f == "add":
                if is_invoke(o):
                    elements.setdefault(v, _SetElement(v))
                elif is_ok(o):
                    if v in elements:
                        elements[v].add_ok(o)
            elif f == "read":
                if is_invoke(o):
                    reads[p] = o
                elif is_fail(o):
                    reads.pop(p, None)
                elif is_ok(o):
                    inv = reads.pop(p, o)
                    for x, n in Counter(v).items():
                        if n > 1:
                            dups[x] = max(dups.get(x, 0), n)
                    vs = set(v)
                    for element, state in elements.items():
                        if element in vs:
                            state.read_present(inv, o)
                        else:
                            state.read_absent(inv, o)
        rs = [_set_element_results(e)
              for _, e in sorted(elements.items(), key=lambda kv: kv[0])]
        outcomes: dict[str, list] = {}
        for r in rs:
            outcomes.setdefault(r["outcome"], []).append(r)
        stable = outcomes.get("stable", [])
        lost = outcomes.get("lost", [])
        never_read = outcomes.get("never-read", [])
        stale = [r for r in stable if r["stable-latency"]]
        worst_stale = sorted(stale, key=lambda r: -r["stable-latency"])[:8]
        valid = (False if lost else
                 UNKNOWN if not stable else
                 False if self.linearizable and stale else
                 True)
        out = {
            "valid?": valid if not dups else False,
            "attempt-count": len(rs),
            "stable-count": len(stable),
            "lost-count": len(lost),
            "lost": sorted(r["element"] for r in lost),
            "never-read-count": len(never_read),
            "never-read": sorted(r["element"] for r in never_read),
            "stale-count": len(stale),
            "stale": sorted(r["element"] for r in stale),
            "worst-stale": worst_stale,
            "duplicated-count": len(dups),
            "duplicated": dict(sorted(dups.items())),
        }
        points = [0, 0.5, 0.95, 0.99, 1]
        sl = _frequency_distribution(
            points, [r["stable-latency"] for r in rs
                     if r["stable-latency"] is not None])
        if sl:
            out["stable-latencies"] = sl
        ll = _frequency_distribution(
            points, [r["lost-latency"] for r in rs
                     if r["lost-latency"] is not None])
        if ll:
            out["lost-latencies"] = ll
        return out


def set_full(linearizable: bool = False) -> Checker:
    return SetFull(linearizable)


# -- queues -----------------------------------------------------------------

def expand_queue_drain_ops(hist) -> list[dict]:
    """Expand :ok :drain ops (value = collection of elements) into
    :dequeue invoke/ok pairs (reference checker.clj:594-626)."""
    out = []
    for o in hist:
        if o["f"] != "drain":
            out.append(o)
        elif is_invoke(o) or is_fail(o):
            continue
        elif is_ok(o):
            for element in o["value"]:
                out.append({**o, "type": "invoke", "f": "dequeue",
                            "value": None})
                out.append({**o, "type": "ok", "f": "dequeue",
                            "value": element})
        else:
            raise ValueError(f"can't handle a crashed drain operation: {o}")
    return out


class TotalQueue(Checker):
    """What goes in must come out; requires the history to fully drain the
    queue (reference total-queue, checker.clj:628-687)."""

    def check(self, test, hist, opts):
        # Indeterminate dequeues/drains may have consumed messages whose
        # values we never learned (e.g. a destructive get whose response
        # was lost in transit). Each :info dequeue can absorb one lost
        # message — a :info drain, any number — degrading a "lost"
        # verdict to unknown rather than reporting a false loss.
        indet = sum(1 for o in hist
                    if is_info(o) and o["f"] == "dequeue")
        indet_drain = any(is_info(o) and o["f"] == "drain" for o in hist)
        hist = expand_queue_drain_ops(
            [o for o in hist if not (is_info(o) and o["f"] == "drain")])
        attempts = Counter(o["value"] for o in hist
                           if is_invoke(o) and o["f"] == "enqueue")
        enqueues = Counter(o["value"] for o in hist
                           if is_ok(o) and o["f"] == "enqueue")
        dequeues = Counter(o["value"] for o in hist
                           if is_ok(o) and o["f"] == "dequeue")
        ok = dequeues & attempts
        unexpected = Counter({k: n for k, n in dequeues.items()
                              if k not in attempts})
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues
        valid: Any = not lost and not unexpected
        if (lost and not unexpected
                and (indet_drain or sum(lost.values()) <= indet)):
            valid = UNKNOWN
        return {
            "valid?": valid,
            "attempt-count": sum(attempts.values()),
            "acknowledged-count": sum(enqueues.values()),
            "ok-count": sum(ok.values()),
            "unexpected-count": sum(unexpected.values()),
            "duplicated-count": sum(duplicated.values()),
            "lost-count": sum(lost.values()),
            "recovered-count": sum(recovered.values()),
            "lost": dict(lost),
            "unexpected": dict(unexpected),
            "duplicated": dict(duplicated),
            "recovered": dict(recovered),
        }


def total_queue() -> Checker:
    return TotalQueue()


class UniqueIds(Checker):
    """A unique-id generator must emit distinct ids (:f :generate)."""

    def check(self, test, hist, opts):
        attempted = sum(1 for o in hist
                        if is_invoke(o) and o["f"] == "generate")
        acks = [o["value"] for o in hist
                if is_ok(o) and o["f"] == "generate"]
        counts = Counter(acks)
        dups = {k: n for k, n in counts.items() if n > 1}
        rng = [min(acks), max(acks)] if acks else [None, None]
        return {
            "valid?": not dups,
            "attempted-count": attempted,
            "acknowledged-count": len(acks),
            "duplicated-count": len(dups),
            "duplicated": dict(sorted(dups.items(),
                                      key=lambda kv: -kv[1])[:48]),
            "range": rng,
        }


def unique_ids() -> Checker:
    return UniqueIds()


class CounterChecker(Checker):
    """Monotonically-increasing counter bounds: at each read, the observed
    value must lie within [sum of :ok adds at invoke, sum of attempted adds
    at completion] (reference counter, checker.clj:737-795)."""

    def check(self, test, hist, opts):
        hist = History(hist).client_ops()
        pairs = hist.pair_index()
        # knossos history/complete semantics: drop pairs whose completion
        # failed; reads take their completion's observed value.
        drop = set()
        values: dict[int, Any] = {}
        for i, o in enumerate(hist.ops):
            j = pairs.get(i)
            if is_fail(o):
                drop.add(i)
                if j is not None:
                    drop.add(j)
            if is_invoke(o) and j is not None:
                values[i] = hist.ops[j]["value"]
        lower, upper = 0, 0
        pending_reads: dict[int, list] = {}
        reads = []
        for i, o in enumerate(hist.ops):
            if i in drop:
                continue
            t, f, p = o["type"], o["f"], o["process"]
            if t == "invoke" and f == "read":
                pending_reads[p] = [lower, values.get(i, o["value"])]
            elif t == "ok" and f == "read":
                r = pending_reads.pop(p, [lower, o["value"]])
                reads.append([r[0], o["value"], upper])
            elif t == "invoke" and f == "add":
                assert o["value"] >= 0, "counter assumes increments only"
                upper += o["value"]
            elif t == "ok" and f == "add":
                lower += o["value"]
        errors = [r for r in reads if not r[0] <= r[1] <= r[2]]
        return {"valid?": not errors, "reads": reads, "errors": errors}


def counter() -> Checker:
    return CounterChecker()


class CounterPlotChecker(Checker):
    """Renders counter.svg: the admissible [lower, upper] band over
    time (lower = sum of acked adds, upper = sum of attempted adds)
    with each observed read on top — green inside the band, red
    outside.  The reference wants exactly this plot (its `doc/plan.md`
    "add a plot for counters, showing the upper and lower bounds, and
    the observed value"); compose it next to `counter()`, which does
    the judging."""

    def check(self, test, hist, opts):
        from .. import plot as gp
        from .perf import out_path

        hist = History(hist).client_ops()
        # same pair semantics as CounterChecker: a failed completion
        # definitely did not happen, so its invoke must not widen the
        # upper bound — otherwise the plot green-lights reads the
        # counter checker rejects
        pairs = hist.pair_index()
        drop = set()
        for i, o in enumerate(hist.ops):
            if is_fail(o):
                drop.add(i)
                j = pairs.get(i)
                if j is not None:
                    drop.add(j)
        lower = upper = 0
        t0 = hist.ops[0]["time"] if hist.ops else 0
        lows, highs, ok_reads, bad_reads = [], [], [], []
        pending: dict[int, int] = {}  # process -> lower at invoke
        for i, o in enumerate(hist.ops):
            if i in drop:
                continue
            t = (o["time"] - t0) / 1e9
            ty, f, p = o["type"], o["f"], o["process"]
            if f == "add":
                if ty == "invoke":
                    upper += o["value"]
                    highs.append((t, upper))
                elif ty == "ok":
                    lower += o["value"]
                    lows.append((t, lower))
            elif f == "read":
                if ty == "invoke":
                    pending[p] = lower
                elif ty == "ok":
                    lo = pending.pop(p, lower)
                    tgt = ok_reads if lo <= o["value"] <= upper \
                        else bad_reads
                    tgt.append((t, o["value"]))
        p = gp.Plot(title=f"{test.get('name', '')} counter",
                    ylabel="Value")
        if lows:
            p.series.append(gp.Series(
                title="lower bound (acked adds)", data=lows,
                color="#4477aa", mode="steps"))
        if highs:
            p.series.append(gp.Series(
                title="upper bound (attempted adds)", data=highs,
                color="#FFA400", mode="steps"))
        if ok_reads:
            p.series.append(gp.Series(
                title="read", data=ok_reads, color="#6DB6FE",
                mode="points", point_type=1))
        if bad_reads:
            p.series.append(gp.Series(
                title="read out of bounds", data=bad_reads,
                color="#FF1E90", mode="points", point_type=2))
        gp.write(p, out_path(test, opts, "counter.svg"))
        return {"valid?": True}


def counter_plot() -> Checker:
    return CounterPlotChecker()


class LogFilePattern(Checker):
    """Greps each node's downloaded log file for a pattern; matches make the
    history invalid (reference checker.clj:839-881)."""

    def __init__(self, pattern: str, filename: str):
        self.pattern = re.compile(pattern)
        self.filename = filename

    def check(self, test, hist, opts):
        from .. import store
        matches = []

        def search(node):
            path = store.path(test, node, self.filename)
            if not os.path.exists(path):
                return []
            out = []
            with open(path, errors="replace") as fh:
                for line in fh:
                    if self.pattern.search(line):
                        out.append({"node": node, "line": line.rstrip("\n")})
            return out

        for found in bounded_pmap(search, test.get("nodes", [])):
            matches.extend(found)
        return {"valid?": not matches, "count": len(matches),
                "matches": matches}


def log_file_pattern(pattern: str, filename: str) -> Checker:
    return LogFilePattern(pattern, filename)
