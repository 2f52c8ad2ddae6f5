"""Linearizability checking: the host oracle and the checker.

Counterpart of `jepsen_tpu/checker/linear.py`. The host half is a copy
of the JAX package's CPU oracle: a just-in-time linearization search in
the style of knossos.linear, walking the history entry by entry over the
set of *configurations* (model state, subset of pending operations
already linearized).

  * at an invocation, the op joins the pending set (not yet linearized);
  * at an :ok completion of op i, configurations expand by linearizing any
    sequence of pending ops; configurations in which i has not linearized by
    its completion are killed;
  * :fail pairs never took effect and are excluded up front;
  * :info ops stay pending forever (crashed reads constrain nothing and
    are dropped);
  * the history is linearizable iff a configuration survives every entry.

`Linearizable` routes models with a device form to the port's GPU engine
(`wgl.analysis_gpu`) and everything else to this oracle, or races the
two (algorithm 'competition'); at tier 'screen' it runs the O(n)
screen first (`checker/screen.py`). The independent checker hands its
per-key subhistories to the batch entry (`wgl.analysis_gpu_batch`) with
the same options.
"""

from __future__ import annotations

import atexit
import logging
import threading
import time as _time

from .. import models as m
from ..history import DeviceEncodingError, History, \
    history as as_history, is_fail, is_info, is_invoke
from . import Checker, UNKNOWN

log = logging.getLogger(__name__)

def _prepare(hist: History):
    """Lower an indexed client history to a list of entries:
    ('invoke', op_id, op) / ('ok', op_id, op). op_id is the invocation's
    history index; the op dict carries the authoritative value (completion
    value for :ok ops). Fail pairs and pending reads are dropped."""
    hist = as_history(hist).client_ops()
    pairs = hist.pair_index()
    entries = []
    for i, o in enumerate(hist.ops):
        if not is_invoke(o):
            continue
        j = pairs.get(i)
        comp = hist.ops[j] if j is not None else None
        if comp is not None and is_fail(comp):
            continue
        if comp is None or is_info(comp):
            if o["f"] in ("read", "r"):
                continue  # a pending read constrains nothing
            entries.append((i, None, dict(o)))
        else:
            op = dict(o)
            op["type"] = comp["type"]
            op["value"] = comp["value"]
            entries.append((i, j, op))
    # Emit in history order: invoke events at position i, ok events at j.
    events = []
    for i, j, op in entries:
        events.append((i, "invoke", i, op))
        if j is not None:
            events.append((j, "ok", i, op))
    events.sort(key=lambda e: e[0])
    return [(kind, op_id, op) for _, kind, op_id, op in events]


def _closure(configs: set, pending: dict) -> set:
    """All configurations reachable by linearizing pending ops in any
    order. A configuration is (model, frozenset-of-linearized-op-ids)."""
    stack = list(configs)
    seen = set(configs)
    while stack:
        model, lin = stack.pop()
        for op_id, op in pending.items():
            if op_id in lin:
                continue
            m2 = model.step(op)
            if m.is_inconsistent(m2):
                continue
            c = (m2, lin | {op_id})
            if c not in seen:
                seen.add(c)
                stack.append(c)
    return seen


def analysis_host(model: m.Model, hist, budget_s: float | None = None,
                  cancel=None) -> dict:
    """Run the JIT-linearization search on the host. Returns an analysis map
    with 'valid?' plus failure diagnostics.

    budget_s: wall-clock budget; past it the search stops with
    {'valid?': 'unknown'} (the reference bounds knossos the same way, via
    memory/`concurrency-limit`, `checker.clj:101-116`). cancel: optional
    zero-arg callable polled between events — truthy stops the search
    (used by competition racing, `checker.clj:199-203`)."""
    t0 = _time.monotonic()
    events = _prepare(as_history(hist).index())
    empty: frozenset = frozenset()
    configs: set = {(model, empty)}
    pending: dict[int, dict] = {}
    op_count = sum(1 for e in events if e[0] == "invoke")
    previous_ok = None
    processed = 0
    for kind, op_id, op in events:
        if budget_s is not None and _time.monotonic() - t0 > budget_s:
            # ops-processed lets callers extrapolate total runtime (a
            # lower bound: per-op cost is nondecreasing as the pending
            # set and config space grow)
            return {"valid?": UNKNOWN, "analyzer": "host-jit-linear",
                    "op-count": op_count, "cause": "budget exhausted",
                    "ops-processed": processed,
                    "duration-ms": (_time.monotonic() - t0) * 1e3}
        if cancel is not None and cancel():
            return {"valid?": UNKNOWN, "analyzer": "host-jit-linear",
                    "op-count": op_count, "cause": "cancelled",
                    "ops-processed": processed,
                    "duration-ms": (_time.monotonic() - t0) * 1e3}
        processed += kind == "invoke"
        if kind == "invoke":
            pending[op_id] = op
            continue
        # :ok completion — op_id must linearize by now.
        expanded = _closure(configs, pending)
        survivors = {(mod, lin) for (mod, lin) in expanded if op_id in lin}
        if not survivors:
            return {
                "valid?": False,
                "op": op,
                "op-index": op.get("index"),
                "previous-ok": previous_ok,
                "op-count": op_count,
                "analyzer": "host-jit-linear",
                "configs": [_config_info(c, pending)
                            for c in sorted(expanded,
                                            key=lambda c: -len(c[1]))[:10]],
                "final-paths": _final_paths(configs, pending, op, op_id),
                "duration-ms": (_time.monotonic() - t0) * 1e3,
            }
        del pending[op_id]
        configs = {(mod, lin - {op_id}) for (mod, lin) in survivors}
        previous_ok = op
    return {"valid?": True,
            "op-count": op_count,
            "analyzer": "host-jit-linear",
            "configs": [_config_info(c, pending)
                        for c in list(configs)[:10]],
            "final-paths": [],
            "duration-ms": (_time.monotonic() - t0) * 1e3}


def _brief(op: dict) -> dict:
    return {k: op.get(k) for k in ("index", "process", "f", "value")}


def _final_paths(configs: set, pending: dict, death_op: dict,
                 death_id: int, cap: int = 10,
                 max_steps: int = 6) -> list:
    """Reconstruct failure paths for a nonlinearizable verdict — the
    analog of knossos's final-paths (rendered by the reference at
    `checker.clj:205-216`). Each path is a sequence of
    {'op', 'model'} steps: a legal linearization of pending ops from a
    surviving configuration, ending with the failing attempt to
    linearize the culprit op and the resulting model inconsistency."""
    paths: list = []
    for mod, lin in sorted(configs, key=lambda c: -len(c[1]))[:cap]:
        if len(paths) >= cap:
            break
        avail = {i: op for i, op in pending.items()
                 if i not in lin and i != death_id}
        stack: list = [(mod, (), frozenset())]
        seen = set()
        while stack and len(paths) < cap:
            m0, steps, used = stack.pop()
            dm = m0.step(death_op)
            if m.is_inconsistent(dm):
                paths.append(
                    [*steps, {"op": _brief(death_op), "model": repr(dm)}])
            if len(steps) >= max_steps:
                continue
            for i, op in avail.items():
                if i in used:
                    continue
                m2 = m0.step(op)
                if m.is_inconsistent(m2):
                    continue
                key = (m2, used | {i})
                if key in seen:
                    continue
                seen.add(key)
                stack.append(
                    (m2, (*steps, {"op": _brief(op), "model": repr(m2)}),
                     used | {i}))
    return paths[:cap]


def explain_failure(model: m.Model, hist, op_index: int,
                    budget_s: float | None = 60.0) -> dict | None:
    """Host re-search of the history prefix ending at the culprit op's
    completion — reconstructs configs and final-paths for a device
    'invalid' verdict (the device kernel reports only the death op).
    Returns the host analysis, or None if the prefix can't be found or
    the budget expires."""
    hist = as_history(hist)
    if hist.ops and "index" not in hist.ops[0]:
        hist = hist.index()
    pos = None
    for i, o in enumerate(hist.ops):
        if o.get("index") == op_index:
            j = hist.pair_index().get(i)
            pos = j if j is not None else i
            break
    if pos is None:
        return None
    prefix = History(hist.ops[:pos + 1])
    a = analysis_host(model, prefix, budget_s=budget_s)
    if a["valid?"] is not False:
        return None
    return a


def _config_info(config, pending) -> dict:
    model, lin = config
    return {"model": repr(model),
            "pending": [pending[i] for i in sorted(lin) if i in pending],
            "linearized-pending": sorted(lin)}


class Linearizable(Checker):
    """Linearizability checker (reference checker.clj:185-216). Algorithms:

      'host'  — pure-Python JIT-linearization (any model)
      'gpu'   — the port's device engines, dense or sort-frontier
                (enumerable-state models); 'tpu' and 'tpu-wgl' are
                accepted aliases, so a test map written for the JAX
                package runs unchanged
      'auto'  — gpu when the model has a device form and the history fits
                its device encoding, else host
      'competition' — the host search raced against the device search
                (`_compete`); the first definite verdict wins and names
                its side in 'competition-winner' ("host" or "gpu")
      'linear'/'wgl' — accepted aliases (reference names) for 'auto'.

    On a definite invalid verdict with an op-index, writes the failure
    neighborhood to linear.svg in the test's store directory (the
    reference renders knossos analyses the same way,
    checker.clj:205-212).

    Two options are this checker's own:

      tier='full'|'screen'|1 — tiered verification (checker/screen.py).
                     'screen' runs the O(n) invariant screen first and
                     the full search only on suspicion or a sampled
                     fraction; a screen pass returns a screened verdict,
                     an escalated result carries 'escalated' with the
                     screen's suspicion and the cost-model pricing. The
                     test map's 'tier' applies when unset here.
      screen_sample float — sampled-escalation fraction for clean
                     histories at tier 1 (default screen.DEFAULT_SAMPLE;
                     the test map's 'screen-sample').

    The other keyword options flow straight to `wgl.analysis_gpu`:
    device ('cuda' by default; 'cpu' runs the plain PyTorch path),
    engine, dense_slot_cap, chunk_entries, budget_s, explain, frontier,
    max_frontier, slot_overflow_fallback, and max_recovery_retries (the
    recovery ladder's budget of classified device faults; the test
    map's 'max-recovery-retries' applies when it is unset here). Under
    `independent.checker` the same options go to the batch entry
    `wgl.analysis_gpu_batch` (device, engine, dense_slot_cap,
    chunk_entries, budget_s, frontier, max_frontier, slots,
    max_recovery_retries; an option it does not take raises).

    A verdict the online pipeline already produced for this history
    (the test map's 'streamed-results', `checker/streaming.py`) is
    reused instead of searching again.
    """

    def __init__(self, model: m.Model, algorithm: str = "auto", **opts):
        assert model is not None, \
            "the linearizable checker requires a model"
        self.model = model
        self.algorithm = algorithm
        self.opts = opts

    def check(self, test, hist, opts):
        from . import screen as _screen
        tier = self.opts.get("tier", (test or {}).get("tier"))
        if _screen.tier_is_screen(tier):
            return self._tier1(test, hist, opts)
        return self._full_check(test, hist, opts)

    def _tier1(self, test, hist, opts):
        """The tiered pipeline: O(n) screen every history; run the full
        device search only on suspicion or a deterministic sampled
        fraction, priced through wgl.select_engine's cost model."""
        from . import screen as _screen
        sc = self._streamed_screen(test, hist) \
            or _screen.screen_history(self.model, hist)
        price = _screen.price_escalation(self.model, hist)
        sample = self.opts.get("screen_sample")
        if sample is None:
            sample = (test or {}).get("screen-sample")
        if sample is None:
            sample = _screen.DEFAULT_SAMPLE
        esc, why = _screen.should_escalate(
            sc, sample=float(sample),
            cost=price["cost"] if price else None)
        if not esc:
            out = dict(sc)
            out["tier"] = 1
            return out
        full = self._full_check(test, hist, opts)
        full["escalated"] = _screen.escalation_record(sc, why, price)
        full["tier"] = 1
        return full

    def _streamed_screen(self, test, hist) -> dict | None:
        """A screen verdict the online pipeline already produced
        (maybe_online's 'screen-linear' target), reused under the same
        coverage guards as _streamed_result."""
        r = ((test or {}).get("streamed-results") or {}) \
            .get("screen-linear")
        if not r or not r.get("screened"):
            return None
        if r.get("model") != repr(self.model):
            return None
        if r.get("history-len") != len(as_history(hist).client_ops()):
            return None
        return dict(r)

    def _full_check(self, test, hist, opts):
        streamed = self._streamed_result(test, hist)
        if streamed is not None:
            # same post-processing as an offline verdict: a definite
            # invalid still renders its linear.svg failure neighborhood
            _write_svg(test, opts, streamed, hist)
            return streamed
        algo = self.algorithm
        if algo in ("linear", "wgl"):
            algo = "auto"
        elif algo in ("tpu", "tpu-wgl"):
            algo = "gpu"
        if algo not in ("auto", "gpu", "host", "competition"):
            raise ValueError(f"unknown linearizability algorithm {algo!r}")
        kw = dict(self.opts)
        kw.pop("tier", None)           # tier knobs are this checker's,
        kw.pop("screen_sample", None)  # not the device engine's
        mrr = (test or {}).get("max-recovery-retries")
        if mrr is not None:
            kw.setdefault("max_recovery_retries", mrr)
        a = None
        if algo == "competition" and self.model.device_model is not None:
            a = self._compete(hist, kw)
        elif algo in ("auto", "gpu", "competition"):
            if self.model.device_model is not None:
                from .wgl import analysis_gpu
                try:
                    a = analysis_gpu(self.model, hist, **kw)
                except DeviceEncodingError:
                    # history exceeds the device encoding (e.g. values
                    # outside int32): the host model handles it
                    if algo == "gpu":
                        raise
            elif algo == "gpu":
                return {"valid?": UNKNOWN,
                        "error": f"model {self.model!r} has no device form"}
        if a is None:
            a = analysis_host(self.model, hist,
                              budget_s=self.opts.get("budget_s"))
        a = _truncate(a)
        _write_svg(test, opts, a, hist)
        return a

    def _streamed_result(self, test, hist) -> dict | None:
        """A verdict already produced by the online pipeline (stashed
        under test['streamed-results']), reused instead of re-searching
        the same history, but only when it is definite and demonstrably
        covers this history (same client op count) AND this checker's
        model (a Compose can hold several Linearizable checkers). An
        'unknown' streamed verdict (frontier cap) re-checks offline."""
        r = ((test or {}).get("streamed-results") or {}).get("linear")
        if not r or r.get("valid?") not in (True, False):
            return None
        if r.get("model") != repr(self.model):
            return None
        if r.get("history-len") != len(as_history(hist).client_ops()):
            return None
        return _truncate(dict(r))

    def _compete(self, hist, base_opts: dict | None = None) -> dict:
        """Race the host search against the device search; the first
        definitive (non-'unknown') verdict returns at once, and the loser
        is cancelled: the host search stops before its next event, the
        device search before its next step. A loser still running when
        the interpreter exits is joined then (`_join_racers`), so no
        search is left inside a device call at teardown.

        The JAX package turns an exception on either side into an
        'unknown'. Here the device side's failures stay visible: a device
        search that raises (a kernel that does not build or launch, a
        fault the ladder does not classify) before the race is decided
        cancels the host search and re-raises, so a broken kernel never
        comes back as a host verdict; one that ends degraded past its
        recovery budget leaves its error on the result under
        'device-error'; one that fails after the host has won is logged.
        The device side runs in its own thread, where PyTorch's current
        device is the default one, so the device is resolved here and
        passed explicitly."""
        import queue as _queue

        from .._platform import pin_device
        from .wgl import analysis_gpu

        cancel = threading.Event()
        results: _queue.Queue = _queue.Queue()
        decided = threading.Lock()
        done = []   # set (under `decided`) once the race has returned

        def run(name, fn):
            try:
                r, exc = fn(), None
            except Exception as e:  # noqa: BLE001 — loser may die racing
                r, exc = {"valid?": UNKNOWN, "error": repr(e)}, e
            finally:
                _racer_done()
            with decided:
                if done:
                    if name == "gpu" and exc is not None:
                        log.warning("competition: the device search failed "
                                    "after the race was decided: %r", exc)
                    return
                results.put((name, r, exc if name == "gpu" else None))

        opts = dict(base_opts if base_opts is not None else self.opts)
        opts["device"] = pin_device(opts.get("device"))
        opts["explain"] = False  # explain after the race, not during it
        # on slot overflow the device path would duplicate the racing
        # host thread's search: make it concede instead
        opts["slot_overflow_fallback"] = False
        threads = [
            threading.Thread(
                target=run, daemon=True,
                args=("host", lambda: analysis_host(
                    self.model, hist, cancel=cancel.is_set))),
            threading.Thread(
                target=run, daemon=True,
                args=("gpu", lambda: analysis_gpu(
                    self.model, hist, cancel=cancel.is_set, **opts))),
        ]
        for t in threads:
            _racer_start(t, cancel)
        a = device_error = None
        try:
            for _ in threads:
                name, r, exc = results.get()
                if exc is not None:
                    raise exc
                if name == "gpu" and r.get("degraded"):
                    device_error = r.get("error")
                if r.get("valid?") != UNKNOWN:
                    r["competition-winner"] = name
                    a = r
                    break
                a = r
        finally:
            with decided:
                done.append(True)
            cancel.set()
        if device_error is not None and a.get("competition-winner"):
            a["device-error"] = device_error
        if a.get("valid?") is False and not a.get("final-paths") \
                and "op-index" in a:
            ex = explain_failure(self.model, hist, a["op-index"])
            if ex is not None:
                a["configs"] = ex["configs"]
                a["final-paths"] = ex["final-paths"]
        return a  # or, both indefinite, the second 'unknown'


# The threads of every race still running, with their race's cancel:
# the loser of a decided race runs on until its next poll of `cancel`.
_RACERS: dict = {}
_RACERS_LOCK = threading.Lock()


def _racer_start(t: threading.Thread, cancel: threading.Event) -> None:
    with _RACERS_LOCK:
        _RACERS[t] = cancel
    t.start()


def _racer_done() -> None:
    with _RACERS_LOCK:
        _RACERS.pop(threading.current_thread(), None)


@atexit.register
def _join_racers(timeout_s: float = 60.0) -> None:
    """Cancel and join every race thread still running, before the
    interpreter tears down the device under it. A loser stops at its
    next poll; one that polls for none of timeout_s (a hung device call)
    is left behind rather than hanging the exit."""
    with _RACERS_LOCK:
        racers = list(_RACERS.items())
    for _, cancel in racers:
        cancel.set()
    deadline = _time.monotonic() + timeout_s
    for t, _ in racers:
        t.join(max(0.0, deadline - _time.monotonic()))


def _write_svg(test, opts, a: dict, hist) -> None:
    """linear.svg for a definite invalid verdict (explain.py); an
    unwritable store is not a checking failure."""
    from .explain import write_failure_svg
    try:
        write_failure_svg(test or {}, opts, a, hist)
    except OSError:
        pass


def _truncate(a: dict) -> dict:
    """Writing full configs/final-paths 'can take hours' — truncate to 10
    (reference checker.clj:213-216)."""
    a["final-paths"] = list(a.get("final-paths", []))[:10]
    a["configs"] = list(a.get("configs", []))[:10]
    return a


def linearizable(model_or_opts, algorithm: str = "auto", **opts) -> Checker:
    """Build a linearizability checker. Accepts linearizable(model) or the
    reference's map shape linearizable({'model': m, 'algorithm': 'wgl'})."""
    if isinstance(model_or_opts, dict):
        o = dict(model_or_opts)
        model = o.pop("model")
        algorithm = o.pop("algorithm", algorithm)
        opts = {**o, **opts}
    else:
        model = model_or_opts
    return Linearizable(model, algorithm, **opts)
