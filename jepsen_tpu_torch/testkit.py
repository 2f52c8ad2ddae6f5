"""Hermetic test scaffolding: the noop test map and an in-process CAS
register backed by a lock-guarded cell (reference `jepsen/src/jepsen/
tests.clj:12-67` — noop-test, atom-db, atom-client).

These make a complete end-to-end run (generator -> interpreter -> history
-> checker) possible in one process with no cluster, which is the
reference's core test strategy (`core_test.clj:62-121`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from . import client as jclient
from . import nemesis as jnemesis
from . import net as jnet
from .checker import unbridled_optimism


class AtomState:
    """A compare-and-swappable cell with a lock, standing in for the
    database under test."""

    def __init__(self, value: Any = None):
        self.value = value
        self.lock = threading.Lock()
        self.meta_log: list = []

    def reset(self, v):
        with self.lock:
            self.value = v

    def cas(self, old, new) -> bool:
        with self.lock:
            if self.value == old:
                self.value = new
                return True
            return False

    def read(self):
        with self.lock:
            return self.value


class AtomClient(jclient.Client):
    """CAS-register client against an AtomState. Sleeps ~1 ms per invoke
    so histories exhibit real concurrency (`tests.clj:50-51`)."""

    def __init__(self, state: AtomState, latency_s: float = 0.001):
        self.state = state
        self.latency_s = latency_s

    def open(self, test, node):
        self.state.meta_log.append("open")
        return self

    def setup(self, test):
        self.state.meta_log.append("setup")

    def invoke(self, test, op):
        if self.latency_s:
            time.sleep(self.latency_s)
        out = dict(op)
        f = op["f"]
        if f == "write":
            self.state.reset(op["value"])
            out["type"] = "ok"
        elif f == "cas":
            old, new = op["value"]
            out["type"] = "ok" if self.state.cas(old, new) else "fail"
        elif f == "read":
            out["type"] = "ok"
            out["value"] = self.state.read()
        else:
            raise ValueError(f"unknown f {f!r}")
        return out

    def teardown(self, test):
        self.state.meta_log.append("teardown")

    def close(self, test):
        self.state.meta_log.append("close")

    def reusable(self, test):
        return True


def atom_client(state: Optional[AtomState] = None,
                latency_s: float = 0.001) -> AtomClient:
    return AtomClient(state if state is not None else AtomState(0),
                      latency_s)


def noop_test() -> dict:
    """Boring test stub, a basis for more complex tests
    (`tests.clj:12-25`)."""
    return {
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "name": "noop",
        "concurrency": 5,
        "client": jclient.noop,
        "nemesis": jnemesis.noop,
        "net": jnet.iptables,
        "generator": None,
        "checker": unbridled_optimism(),
    }


class AtomDB:
    """In-process 'database' over an AtomState: setup zeroes the cell,
    teardown marks it 'done' (`tests.clj:27-43`)."""

    def __init__(self, state: AtomState):
        self.state = state

    def setup(self, test, node):
        self.state.reset(0)

    def teardown(self, test, node):
        self.state.reset("done")


def atom_db(state: AtomState) -> AtomDB:
    return AtomDB(state)
