"""Membership nemesis: grow/shrink-cluster state machine.

Reference: `jepsen/src/jepsen/nemesis/membership.clj` (view-merging loop
refreshing each node's view every 5 s, pending-op resolution to a fixed
point, nemesis + generator pair) and `membership/state.clj` (the State
protocol users implement per-database).

The cluster state is {"node-views": {node: view}, "view": merged,
"pending": set of (op, op') pairs} plus whatever the State carries.
"""

from __future__ import annotations

import logging
import threading
from typing import Any

from .. import generator as gen
from . import Nemesis

log = logging.getLogger(__name__)

NODE_VIEW_INTERVAL = 5  # seconds between node-view refreshes (`:59-61`)


class State:
    """Per-database membership state machine (`membership/state.clj`).

    Implementations are immutable-style: methods return new states (or
    None where documented)."""

    def setup(self, test: dict) -> "State":
        """One-time initialization; returns a new state."""
        return self

    def node_view(self, test: dict, node: str) -> Any:
        """The cluster view from one node; None = unknown (ignored)."""
        return None

    def merge_views(self, test: dict) -> Any:
        """Derive the authoritative view from self.node_views."""
        return None

    def fs(self) -> set:
        """All op :f's this state machine can generate."""
        return set()

    def op(self, test: dict):
        """An op we could perform next, or "pending" if none available."""
        return "pending"

    def invoke(self, test: dict, op: dict) -> dict:
        """Apply a generated op; returns the completion."""
        return dict(op)

    def resolve(self, test: dict) -> "State":
        """Evolve toward a fixed point; called repeatedly."""
        return self

    def resolve_op(self, test: dict, op_pair: tuple) -> "State | None":
        """If (op, op') has resolved, return a new state; else None."""
        return None

    def teardown(self, test: dict) -> None:
        pass


def _op_key(op_pair) -> str:
    import json

    return json.dumps(op_pair, sort_keys=True, default=str)


class _Shared:
    """The mutable cell the nemesis, generator, and view threads share
    (the reference's state atom)."""

    def __init__(self, state: State):
        self.lock = threading.RLock()
        self.state = state
        self.node_views: dict = {}
        self.view: Any = None
        self.pending: dict[str, tuple] = {}  # key -> (op, op')


def _resolve(shared: _Shared, test: dict, opts: dict) -> None:
    """state.resolve + resolve-op over pending until fixed point
    (`membership.clj:79-107`). Caller holds the lock."""
    for _ in range(100):  # fixed-point iteration, bounded
        before_state = shared.state
        before_pending = dict(shared.pending)
        shared.state = shared.state.resolve(test) or shared.state
        for key, pair in list(shared.pending.items()):
            state2 = shared.state.resolve_op(test, pair)
            if state2 is not None:
                if opts.get("log-resolve-op"):
                    log.info("Resolved pending membership operation: %s",
                             pair)
                shared.state = state2
                shared.pending.pop(key, None)
        if shared.state is before_state and \
                shared.pending == before_pending:
            return


class MembershipNemesis(Nemesis):
    """Drives a State machine; keeps per-node views fresh from
    background threads (`membership.clj:159-210`)."""

    def __init__(self, state: State, opts: dict | None = None):
        self.shared = _Shared(state)
        self.opts = opts or {}
        self._running = threading.Event()
        self._threads: list[threading.Thread] = []

    def fs(self):
        return self.shared.state.fs()

    def _update_node_view(self, test, node):
        """(`membership.clj:109-140`)"""
        from .. import control as c

        with c.on(node):
            nv = self.shared.state.node_view(test, node)
        if nv is None:
            return
        with self.shared.lock:
            old = self.shared.node_views.get(node)
            if self.opts.get("log-node-views") and nv != old:
                log.info("New view from %s: %s", node, nv)
            self.shared.node_views[node] = nv
            # expose node_views on the state so merge_views can see them
            self.shared.state.node_views = dict(self.shared.node_views)
            view = self.shared.state.merge_views(test)
            changed = view != self.shared.view
            self.shared.view = view
            self.shared.state.view = view
            _resolve(self.shared, test, self.opts)
            if changed and self.opts.get("log-view"):
                log.info("New membership view from %s: %s", node, view)

    def _view_loop(self, test, node):
        while self._running.is_set():
            try:
                self._update_node_view(test, node)
            except Exception as e:  # noqa: BLE001 — keep refreshing
                log.warning("Node view updater caught %s; will retry", e)
            self._running.wait(0)  # yield
            for _ in range(NODE_VIEW_INTERVAL * 10):
                if not self._running.is_set():
                    return
                threading.Event().wait(0.1)

    def setup(self, test):
        with self.shared.lock:
            self.shared.state.node_views = {}
            self.shared.state.view = None
            self.shared.state = self.shared.state.setup(test) or \
                self.shared.state
        self._running.set()
        for node in test["nodes"]:
            t = threading.Thread(target=self._view_loop,
                                 args=(test, node), daemon=True,
                                 name=f"membership-view-{node}")
            t.start()
            self._threads.append(t)
        return self

    def invoke(self, test, op):
        op2 = self.shared.state.invoke(test, op)
        with self.shared.lock:
            pair = (op, op2)
            self.shared.pending[_op_key(pair)] = pair
            _resolve(self.shared, test, self.opts)
        return op2

    def teardown(self, test):
        self._running.clear()
        for t in self._threads:
            t.join(timeout=1.0)
        self.shared.state.teardown(test)


class MembershipGenerator(gen.Gen):
    """Asks the shared state machine for the next legal op
    (`membership.clj:212-222`)."""

    def __init__(self, shared: _Shared):
        self.shared = shared

    def op(self, test, ctx):
        with self.shared.lock:
            o = self.shared.state.op(test)
        if o is None:
            return None
        if o == "pending" or o is gen.PENDING:
            return gen.PENDING, self
        return gen.fill_in_op(dict(o), ctx), self

    def update(self, test, ctx, event):
        return self


def package(opts: dict) -> dict | None:
    """Build {"state", "nemesis", "generator"} when faults include
    "membership" (`membership.clj:224-255`). opts["membership"]["state"]
    is the user's State machine."""
    if "membership" not in set(opts.get("faults") or ()):
        return None
    mopts = opts.get("membership") or {}
    nem = MembershipNemesis(
        mopts["state"],
        {k: mopts.get(k) for k in
         ("log-node-views", "log-view", "log-resolve", "log-resolve-op")})
    g = gen.stagger(opts.get("interval", 10),
                    MembershipGenerator(nem.shared))
    return {"state": nem.shared, "nemesis": nem, "generator": g}
