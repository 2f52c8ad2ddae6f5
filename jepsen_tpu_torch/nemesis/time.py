"""Clock nemesis: wall-clock faults driven by on-node native tools.

Reference: `jepsen/src/jepsen/nemesis/time.clj` — uploads C sources and
compiles them on each DB node (:20-61 `compile!`/`install!`), then drives
them: ops `:reset` (ntpdate), `:bump` (one-shot jump), `:strobe`
(oscillation), `:check-offsets` (:98-146 `clock-nemesis`); randomized
skew generators ±2²–2¹⁸ ms (:148-205). The native tools themselves are
C++ ports in the port's `native/` (copies of the JAX package's; see
each file's header).
"""

from __future__ import annotations

import os
import random
import time as _time

from .. import control as c
from ..control import util as cu
from ..control.core import RemoteError
from . import Nemesis

DIR = "/opt/jepsen"

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")

TOOLS = {"bump-time": "bump_time.cpp",
         "strobe-time": "strobe_time.cpp",
         # phase-locked variant (the reference's abandoned
         # strobe-time-experiment.c, finished): flips align to absolute
         # monotonic ticks instead of drifting relative sleeps
         "strobe-time-experiment": "strobe_time_experiment.cpp",
         "adj-time": "adj_time.cpp"}


def compile_tool(source_path: str, bin: str) -> str:
    """Upload a C++ source and compile it to /opt/jepsen/<bin> on the
    current node, if not already present (`nemesis/time.clj:20-39`)."""
    with c.su():
        if not cu.exists(f"{DIR}/{bin}"):
            c.exec_("mkdir", "-p", DIR)
            c.exec_("chmod", "a+rwx", DIR)
            c.upload(source_path, f"{DIR}/{bin}.cpp")
            with c.cd(DIR):
                c.exec_("g++", "-O2", "-std=c++17", "-o", bin,
                        f"{bin}.cpp")
    return bin


def compile_tools() -> None:
    for bin, src in TOOLS.items():
        compile_tool(os.path.join(NATIVE_DIR, src), bin)


def install() -> None:
    """Upload + compile the clock tools, installing a compiler on demand
    (`nemesis/time.clj:52-61`)."""
    try:
        compile_tools()
    except RemoteError:
        from ..os_ import centos, debian

        try:
            debian.install(["build-essential"])
        except RemoteError:
            centos.install(["gcc-c++"])
        compile_tools()


def current_offset() -> float:
    """This node's clock offset from the control node, seconds
    (`nemesis/time.clj:69-78`)."""
    remote = float(c.exec_("date", "+%s.%N"))
    return remote - _time.time()


def reset_time() -> None:
    """Reset the current node's clock via NTP (`nemesis/time.clj:80-84`)."""
    with c.su():
        c.exec_("ntpdate", "-p", 1, "-b", "time.google.com")


def reset_time_all(test: dict) -> None:
    c.on_nodes(test, lambda t, n: reset_time())


def bump_time(delta_ms: float) -> float:
    """Jump this node's clock by delta ms; returns the resulting offset
    in seconds (`nemesis/time.clj:86-90`)."""
    with c.su():
        t = float(c.exec_(f"{DIR}/bump-time", delta_ms))
    return t - _time.time()


def strobe_time(delta_ms: float, period_ms: float,
                duration_s: float, phase_locked: bool = False) -> None:
    """Oscillate this node's clock (`nemesis/time.clj:92-96`).
    phase_locked uses the tick-anchored experiment variant, whose flip
    edges don't drift with per-iteration overhead."""
    tool = "strobe-time-experiment" if phase_locked else "strobe-time"
    with c.su():
        c.exec_(f"{DIR}/{tool}", delta_ms, period_ms, duration_s)


class ClockNemesis(Nemesis):
    """Ops (`nemesis/time.clj:98-146`):
      {"f": "reset",  "value": [node, ...]}
      {"f": "strobe", "value": {node: {"delta": ms, "period": ms,
                                       "duration": s}}}
      {"f": "bump",   "value": {node: delta-ms}}
      {"f": "check-offsets"}
    Completions carry {"clock-offsets": {node: seconds}}."""

    def fs(self):
        return {"reset", "strobe", "bump", "check-offsets"}

    def setup(self, test):
        def prep(t, node):
            install()
            try:
                with c.su():
                    c.exec_("service", "ntpd", "stop")
            except RemoteError:
                pass
            reset_time()

        c.on_nodes(test, prep)
        return self

    def invoke(self, test, op):
        f = op.get("f")
        if f == "reset":
            res = c.on_nodes(
                test, lambda t, n: (reset_time(), current_offset())[1],
                nodes=op.get("value"))
        elif f == "check-offsets":
            res = c.on_nodes(test, lambda t, n: current_offset())
        elif f == "strobe":
            m = op["value"]

            def go(t, node):
                s = m[node]
                strobe_time(s["delta"], s["period"], s["duration"],
                            phase_locked=bool(s.get("phase-locked")))
                return current_offset()

            res = c.on_nodes(test, go, nodes=list(m.keys()))
        elif f == "bump":
            m = op["value"]
            res = c.on_nodes(test, lambda t, n: bump_time(m[n]),
                             nodes=list(m.keys()))
        else:
            raise ValueError(f"clock nemesis can't handle f={f!r}")
        return {**op, "clock-offsets": res}

    def teardown(self, test):
        reset_time_all(test)


def clock_nemesis() -> ClockNemesis:
    return ClockNemesis()


# -- randomized skew generators (`nemesis/time.clj:148-205`) ---------------

def random_nonempty_subset(nodes, rng=None):
    r = rng or random
    n = r.randint(1, len(nodes))
    return r.sample(list(nodes), n)


def reset_gen_select(select):
    """Reset generator targeting select(test) nodes
    (`nemesis/time.clj:148-154`). Fn-generators take (test, ctx)."""
    def gen(test, ctx):
        return {"type": "info", "f": "reset", "value": select(test)}
    return gen


def reset_gen(test, ctx):
    """Reset clocks on a random nonempty node subset
    (`nemesis/time.clj:156-159`)."""
    return {"type": "info", "f": "reset",
            "value": random_nonempty_subset(test["nodes"])}


def _exp_ms(rng=None):
    """±2²–2¹⁸ ms, exponentially distributed (`nemesis/time.clj:161-173`)."""
    r = rng or random
    return int(r.choice([-1, 1]) * 2 ** (2 + r.random() * 16))


def bump_gen_select(select):
    def gen(test, ctx):
        return {"type": "info", "f": "bump",
                "value": {n: _exp_ms() for n in select(test)}}
    return gen


def bump_gen(test, ctx):
    return bump_gen_select(
        lambda t: random_nonempty_subset(t["nodes"]))(test, ctx)


def strobe_gen_select(select):
    """Strobes of 4 ms–262 s delta, 1 ms–1 s period, 0–32 s duration
    (`nemesis/time.clj:179-192`)."""
    def gen(test, ctx):
        return {"type": "info", "f": "strobe",
                "value": {n: {"delta": int(2 ** (2 + random.random() * 16)),
                              "period": int(2 ** (random.random() * 10)),
                              "duration": random.random() * 32}
                          for n in select(test)}}
    return gen


def strobe_gen(test, ctx):
    return strobe_gen_select(
        lambda t: random_nonempty_subset(t["nodes"]))(test, ctx)


def clock_gen():
    """A random schedule of clock-skew ops, starting with a
    check-offsets to establish a baseline (`nemesis/time.clj:199-205`)."""
    from .. import generator as gen

    return gen.phases(
        {"type": "info", "f": "check-offsets"},
        gen.mix([reset_gen, bump_gen, strobe_gen]))
