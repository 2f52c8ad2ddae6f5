"""Nemesis protocol: fault injection driven by generator ops (reference
`jepsen/src/jepsen/nemesis.clj:11-16`).

A nemesis receives :info ops from the generator's nemesis thread and
performs faults against the cluster. The full built-in nemesis stack
(partitioners, grudges, clock skew, kill/pause) lives in sibling modules;
this module holds the protocol, the noop nemesis, validation, and
composition.
"""

from __future__ import annotations

from typing import Callable


class Nemesis:
    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        """Apply a fault op; returns the completion op."""
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass

    def fs(self) -> set | None:
        """Reflection: the :f values this nemesis handles, or None if
        unknown (`nemesis.clj:18-21`). Enables collection-style compose
        and f_map."""
        return None


class Noop(Nemesis):
    """Does nothing (`nemesis.clj:92-99`)."""

    def invoke(self, test, op):
        return dict(op)

    def fs(self):
        return set()


noop = Noop()


class InvalidCompletion(Exception):
    def __init__(self, op, op2, problems):
        self.op, self.op2, self.problems = op, op2, problems
        super().__init__(
            "nemesis returned an invalid completion: "
            + "; ".join(problems) + f" — invoke {op!r}, completion {op2!r}")


class Validate(Nemesis):
    """Asserts nemesis completions are well-formed (`nemesis.clj:49-90`)."""

    def __init__(self, nemesis: Nemesis):
        self.nemesis = nemesis

    def setup(self, test):
        res = self.nemesis.setup(test)
        if not isinstance(res, Nemesis):
            raise TypeError(f"nemesis setup returned non-nemesis {res!r}")
        return Validate(res)

    def invoke(self, test, op):
        op2 = self.nemesis.invoke(test, op)
        problems = []
        if not isinstance(op2, dict):
            problems.append("should be a dict")
        else:
            if op2.get("process") != op.get("process"):
                problems.append(":process should be the same")
            if op2.get("f") != op.get("f"):
                problems.append(":f should be the same")
        if problems:
            raise InvalidCompletion(op, op2, problems)
        return op2

    def teardown(self, test):
        self.nemesis.teardown(test)


def validate(n: Nemesis) -> Nemesis:
    return Validate(n)


class Compose(Nemesis):
    """Routes ops to sub-nemeses by :f through per-nemesis f-sets or
    f-mapping dicts (`nemesis.clj:384-428`)."""

    def __init__(self, nemeses):
        """nemeses: pairs of (fs, nemesis) where fs is either a set of :f
        values this nemesis handles, or a dict mapping outer :f -> inner
        :f (the op is rewritten on the way in and back on the way out).
        Accepts a dict {frozenset: nemesis} or, since dicts can't be dict
        keys, a list of (fs_or_fmap, nemesis) pairs."""
        pairs = nemeses.items() if isinstance(nemeses, dict) else nemeses
        self.nemeses = tuple((fs, n) for fs, n in pairs)

    def setup(self, test):
        return Compose([(fs, n.setup(test)) for fs, n in self.nemeses])

    def invoke(self, test, op):
        f = op.get("f")
        for fs, n in self.nemeses:
            if isinstance(fs, dict):
                if f in fs:
                    inner = dict(op)
                    inner["f"] = fs[f]
                    out = n.invoke(test, inner)
                    out = dict(out)
                    out["f"] = f
                    return out
            elif f in fs:
                return n.invoke(test, op)
        raise ValueError(f"no nemesis handles f={f!r}")

    def teardown(self, test):
        for _, n in self.nemeses:
            n.teardown(test)

    def fs(self):
        """Union of routed f-spaces: dict f-maps contribute their outer
        keys, sets their members (`nemesis.clj:373-382`)."""
        out = set()
        for fs, _ in self.nemeses:
            out |= set(fs.keys()) if isinstance(fs, dict) else set(fs)
        return out


def compose(nemeses) -> Nemesis:
    """Combine nemeses into one, routing by :f. Accepts {fs: nemesis} /
    [(fs, nemesis)] pairs, or a plain collection of nemeses whose fs()
    reflection determines routing (`nemesis.clj:384-428`)."""
    if isinstance(nemeses, dict):
        return Compose(nemeses)
    nemeses = list(nemeses)
    if nemeses and all(isinstance(n, Nemesis) for n in nemeses):
        pairs, seen = [], {}
        for n in nemeses:
            fs = n.fs()
            if fs is None:
                raise ValueError(
                    f"{n!r} doesn't support fs() reflection; compose it "
                    "with explicit (fs, nemesis) pairs instead")
            for f in fs:
                if f in seen:
                    raise ValueError(
                        f"nemeses {n!r} and {seen[f]!r} are mutually "
                        f"incompatible; both use f={f!r}")
                seen[f] = n
            pairs.append((fs, n))
        return Compose(pairs)
    return Compose(nemeses)


class FMap(Nemesis):
    """Remaps the :f values a nemesis accepts: ops arrive with f=lift(f0),
    are unlifted for the inner nemesis, and completions are re-lifted —
    the mirror of generator f_map so the two compose
    (`nemesis.clj:285-327`)."""

    def __init__(self, lift: Callable, nem: Nemesis,
                 unlift: dict | None = None):
        self.lift = lift
        self.nem = nem
        fs = nem.fs()
        if fs is None and unlift is None:
            raise ValueError(
                f"{nem!r} doesn't support fs() reflection; f_map needs it")
        self.unlift = unlift if unlift is not None else \
            {lift(f): f for f in fs}

    def setup(self, test):
        return FMap(self.lift, self.nem.setup(test), self.unlift)

    def invoke(self, test, op):
        inner = dict(op)
        inner["f"] = self.unlift[op["f"]]
        out = dict(self.nem.invoke(test, inner))
        out["f"] = op["f"]
        return out

    def teardown(self, test):
        self.nem.teardown(test)

    def fs(self):
        return set(self.unlift.keys())


def f_map(lift: Callable, nem: Nemesis) -> FMap:
    return FMap(lift, nem)


class TimeoutNemesis(Nemesis):
    """Times out unreliable nemesis invocations; timed-out ops get
    :value :timeout (`nemesis.clj:92-106`)."""

    def __init__(self, timeout_ms: float, nem: Nemesis):
        self.timeout_ms = timeout_ms
        self.nem = nem

    def setup(self, test):
        from ..util import timeout as _timeout

        return TimeoutNemesis(
            self.timeout_ms,
            _timeout(self.timeout_ms / 1000,
                     lambda: self.nem.setup(test)))

    def invoke(self, test, op):
        from ..util import timeout as _timeout

        return _timeout(self.timeout_ms / 1000,
                        lambda: self.nem.invoke(test, op),
                        default={**op, "value": "timeout"})

    def teardown(self, test):
        self.nem.teardown(test)

    def fs(self):
        return self.nem.fs()


def timeout(timeout_ms: float, nem: Nemesis) -> TimeoutNemesis:
    return TimeoutNemesis(timeout_ms, nem)


# -- clock, process, and file faults ---------------------------------------

def set_time(t: float) -> None:
    """Set the current node's wall clock, POSIX seconds
    (`nemesis.clj:430-433`)."""
    from .. import control as c

    with c.su():
        c.exec_("date", "+%s", "-s", f"@{int(t)}")


class ClockScrambler(Nemesis):
    """Randomizes node clocks within a ±dt-second window
    (`nemesis.clj:435-450`)."""

    def __init__(self, dt: float):
        self.dt = dt

    def fs(self):
        return {"scramble-clock"}

    def invoke(self, test, op):
        import random as _random
        import time as _time

        from .. import control as c

        dt = self.dt

        def f(t, node):
            set_time(_time.time() + _random.randint(-int(dt), int(dt)))

        value = c.on_nodes(test, f)
        return {**op, "value": value}

    def teardown(self, test):
        import time as _time

        from .. import control as c

        c.on_nodes(test, lambda t, n: set_time(_time.time()))


def clock_scrambler(dt: float) -> ClockScrambler:
    return ClockScrambler(dt)


class NodeStartStopper(Nemesis):
    """:start runs start_fn on targeted nodes; :stop undoes it on the
    same nodes (`nemesis.clj:452-495`). Targeter takes (test, nodes) or
    (nodes); returning None skips. Values become the op's :value, e.g.
    {"n1": ["killed", "java"]}."""

    def __init__(self, targeter, start_fn, stop_fn):
        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self._nodes = None
        import threading

        self._lock = threading.Lock()

    def fs(self):
        return {"start", "stop"}

    def invoke(self, test, op):
        from .. import control as c

        with self._lock:
            f = op.get("f")
            if f == "start":
                try:
                    ns = self.targeter(test, list(test["nodes"]))
                except TypeError:
                    ns = self.targeter(list(test["nodes"]))
                if ns is None:
                    value = "no-target"
                elif self._nodes is not None:
                    value = f"nemesis already disrupting {self._nodes!r}"
                else:
                    ns = ns if isinstance(ns, (list, tuple, set)) else [ns]
                    self._nodes = list(ns)
                    value = c.on_many(
                        ns, lambda: self.start_fn(test, c.var("host")))
            elif f == "stop":
                if self._nodes is None:
                    value = "not-started"
                else:
                    value = c.on_many(
                        self._nodes,
                        lambda: self.stop_fn(test, c.var("host")))
                    self._nodes = None
            else:
                raise ValueError(f"can't handle f={f!r}")
            return {**op, "type": "info", "value": value}


def node_start_stopper(targeter, start_fn, stop_fn) -> NodeStartStopper:
    return NodeStartStopper(targeter, start_fn, stop_fn)


def hammer_time(process: str, targeter=None) -> NodeStartStopper:
    """SIGSTOP a process on :start, SIGCONT on :stop
    (`nemesis.clj:497-511`)."""
    import random as _random

    from .. import control as c

    if targeter is None:
        targeter = lambda nodes: _random.choice(nodes)

    def start(test, node):
        with c.su():
            c.exec_("killall", "-s", "STOP", process)
        return ["paused", process]

    def stop(test, node):
        with c.su():
            c.exec_("killall", "-s", "CONT", process)
        return ["resumed", process]

    return NodeStartStopper(targeter, start, stop)


class TruncateFile(Nemesis):
    """{:f :truncate :value {node: {"file": ..., "drop": bytes}}} drops
    the last bytes from files (`nemesis.clj:513-539`)."""

    def fs(self):
        return {"truncate"}

    def invoke(self, test, op):
        from .. import control as c

        assert op.get("f") == "truncate"
        plan = op.get("value") or {}

        def f(t, node):
            spec = plan[node]
            assert isinstance(spec["file"], str)
            assert isinstance(spec["drop"], int)
            with c.su():
                c.exec_("truncate", "-c", "-s", f"-{spec['drop']}",
                        spec["file"])

        c.on_nodes(test, f, nodes=list(plan.keys()))
        return dict(op)


def truncate_file() -> TruncateFile:
    return TruncateFile()


class FnNemesis(Nemesis):
    """Lift a function (test, op) -> op' into a nemesis."""

    def __init__(self, f: Callable[[dict, dict], dict],
                 setup_fn: Callable[[dict], None] | None = None,
                 teardown_fn: Callable[[dict], None] | None = None):
        self.f = f
        self.setup_fn = setup_fn
        self.teardown_fn = teardown_fn

    def setup(self, test):
        if self.setup_fn:
            self.setup_fn(test)
        return self

    def invoke(self, test, op):
        return self.f(test, op)

    def teardown(self, test):
        if self.teardown_fn:
            self.teardown_fn(test)
