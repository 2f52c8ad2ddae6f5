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
(`wgl.analysis_gpu`) and everything else to this oracle.
"""

from __future__ import annotations

import time as _time

from .. import models as m
from ..history import DeviceEncodingError, History, \
    history as as_history, is_fail, is_info, is_invoke
from . import Checker, UNKNOWN

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
      'gpu'   — the port's dense engine (enumerable-state models); 'tpu'
                and 'tpu-wgl' are accepted aliases, so a test map written
                for the JAX package runs unchanged
      'auto'  — gpu when the model has a device form and the history fits
                its device encoding, else host
      'linear'/'wgl' — accepted aliases (reference names) for 'auto'.

    Extra keyword options flow straight to `wgl.analysis_gpu`: device
    ('cuda' by default; 'cpu' runs the plain PyTorch path), engine,
    dense_slot_cap, chunk_entries, budget_s, explain, frontier.

    A history whose shape needs the sort-frontier family raises
    NotImplementedError from analysis_gpu under 'gpu' and 'auto' alike:
    the port does not hand it to the host oracle behind the caller's
    back.
    """

    def __init__(self, model: m.Model, algorithm: str = "auto", **opts):
        assert model is not None, \
            "the linearizable checker requires a model"
        self.model = model
        self.algorithm = algorithm
        self.opts = opts

    def check(self, test, hist, opts):
        return self._full_check(test, hist, opts)

    def _full_check(self, test, hist, opts):
        algo = self.algorithm
        if algo in ("linear", "wgl"):
            algo = "auto"
        elif algo in ("tpu", "tpu-wgl"):
            algo = "gpu"
        if algo not in ("auto", "gpu", "host"):
            raise ValueError(f"unknown linearizability algorithm {algo!r}")
        a = None
        if algo in ("auto", "gpu"):
            if self.model.device_model is not None:
                from .wgl import analysis_gpu
                try:
                    a = analysis_gpu(self.model, hist, **self.opts)
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
        return _truncate(a)


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
