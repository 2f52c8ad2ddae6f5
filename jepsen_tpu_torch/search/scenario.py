"""Genome -> runnable scenario: generator, synthetic executor, model.

`build(genome, bug=...)` turns a typed genome into the three things a
simulated run needs: a Context sized to the genome's concurrency, a
generator (client ops under `gen.clients`, nemesis fault-window
boundary ops on the nemesis thread), and a fault-aware *executor* — a
`complete(ctx, invoke)` function for `generator.simulate`.

The executor is a tiny in-memory register service that linearizes
every op at its invoke point (simulate() calls complete() at dispatch,
so invoke order IS linearization order): healthy runs are linearizable
by construction and tier-1 screens stay silent on them. It also
watches the nemesis boundary ops flow past and tracks which fault
kinds are active — which is what planted *bugs* key on. A bug from
BUGS gives the executor one precise defect, e.g.
'lost-write-kill-partition': a write is acknowledged ok but silently
dropped iff kill AND partition are both active at its invoke — a
conjunction-fault window bug that only a schedule overlapping both
kinds with the write phase can surface (later reads of the stale value
trip the screen's stale-read invariant).

Scenarios (the genome's `workload` field):

  register          uniform read/write mix over the whole horizon
  phased-register   long read phase, a NARROW write phase (the only
                    mutation window), then reads again — the planted-
                    bug demo target: the violation exists only when
                    fault windows overlap the write phase
"""

from __future__ import annotations

import random

from .. import models
from ..generator import clients as gen_clients
from ..generator import context as gen_context
from ..generator import delay as gen_delay
from ..generator import limit as gen_limit
from ..generator import sleep as gen_sleep
from ..generator import stagger as gen_stagger
from ..generator import time_limit as gen_time_limit
from ..generator import rng as gen_rng
from .coverage import START_F, STOP_F
from .mutate import Genome

# fault kind -> (window-start f, window-stop f); the f names are the
# nemesis/combined.py package op vocabulary, and tests pin this table
# against both the packages and coverage.START_F/STOP_F
KIND_OPS = {
    "partition": ("start-partition", "stop-partition"),
    "kill": ("kill", "start"),
    "pause": ("pause", "resume"),
    "clock": ("strobe-clock", "reset-clock"),
}

NEMESIS_LATENCY_NS = 1_000          # boundary ops are near-instant
VALUE_SPACE = 1_000_000_000

# phased-register shape: writes exist ONLY in [WRITE_AT_S,
# WRITE_AT_S + WRITES * WRITE_SPACING_S] — about 0.1s of a 60s run
PHASED_HORIZON_S = 60.0
WRITE_AT_S = 45.0
PHASED_WRITES = 5
WRITE_SPACING_S = 0.02
READ_STAGGER_S = 0.25


class Bug:
    """A planted executor defect: drop semantics gated on a
    conjunction of active fault kinds."""

    def __init__(self, name: str, trigger: frozenset, effect: str):
        self.name = name
        self.trigger = trigger
        self.effect = effect


BUGS = {
    # acked-but-lost write iff kill AND partition are simultaneously
    # active at the write's invoke
    "lost-write-kill-partition": Bug(
        "lost-write-kill-partition",
        frozenset({"kill", "partition"}), "lose-write"),
    # single-kind variant, for tests that need an easy target
    "lost-write-pause": Bug(
        "lost-write-pause", frozenset({"pause"}), "lose-write"),
}


class RegisterExecutor:
    """In-memory register `complete` fn. Ops linearize at invoke;
    completion latency comes from an executor-private stream seeded
    off the genome so it never touches the generator's pinned RNG."""

    def __init__(self, genome: Genome, bug: Bug | None = None):
        self.bug = bug
        # the register starts at 0, not None: the model treats a read
        # of None as a wildcard (knossos nil-read convention), so a
        # bug that strands the INITIAL value must strand a real one or
        # the full checkers would call the stale reads linearizable
        self.state = 0
        self.active: set = set()
        self.lost_writes = 0
        self._lat = random.Random(genome.seed ^ 0x5EED_CAFE)

    def _latency_ns(self) -> int:
        base = 2_000_000 if "pause" in self.active else 200_000
        return self._lat.randrange(base, base * 4)

    def complete(self, ctx, invoke: dict) -> dict:
        out = dict(invoke)
        if invoke.get("process") == "nemesis":
            f = invoke.get("f")
            if f in START_F:
                self.active.add(START_F[f])
            elif f in STOP_F:
                self.active.discard(STOP_F[f])
            out["time"] = invoke["time"] + NEMESIS_LATENCY_NS
            return out
        f = invoke.get("f")
        if f == "write":
            dropped = (self.bug is not None
                       and self.bug.effect == "lose-write"
                       and self.bug.trigger <= self.active)
            if dropped:
                self.lost_writes += 1
            else:
                self.state = invoke.get("value")
        elif f == "read":
            out["value"] = self.state
        out["type"] = "ok"
        out["time"] = invoke["time"] + self._latency_ns()
        return out


def _nemesis_gen(genome: Genome):
    """Fault-window boundaries as absolute-time nemesis info ops:
    sleeps between consecutive boundary events, windows free to
    overlap across kinds."""
    events = []
    for w in genome.faults:
        start_f, stop_f = KIND_OPS[w.kind]
        events.append((w.start_s, start_f))
        events.append((w.start_s + w.duration_s, stop_f))
    events.sort(key=lambda e: e[0])
    seq: list = []
    now = 0.0
    for at_s, f in events:
        if at_s > now:
            seq.append(gen_sleep(at_s - now))
            now = at_s
        seq.append({"type": "info", "f": f, "value": None})
    return seq


def _register_client(genome: Genome):
    def rw(test, ctx):
        if gen_rng.random() < 0.5:
            return {"f": "read", "value": None}
        return {"f": "write",
                "value": gen_rng.randrange(VALUE_SPACE)}
    horizon = _horizon_s(genome)
    return gen_time_limit(horizon, gen_stagger(0.1, rw))


def _phased_register_client(genome: Genome):
    def read(test, ctx):
        return {"f": "read", "value": None}

    writes = iter({"f": "write", "value": v + 1}
                  for v in range(PHASED_WRITES))

    def write(test, ctx):
        return next(writes, None)

    return [gen_time_limit(WRITE_AT_S,
                           gen_stagger(READ_STAGGER_S, read)),
            gen_limit(PHASED_WRITES,
                      gen_delay(WRITE_SPACING_S, write)),
            gen_time_limit(PHASED_HORIZON_S - WRITE_AT_S
                           - PHASED_WRITES * WRITE_SPACING_S,
                           gen_stagger(READ_STAGGER_S, read))]


SCENARIOS = {
    "register": {"client": _register_client, "horizon-s": 30.0,
                 "max-ops": 400},
    "phased-register": {"client": _phased_register_client,
                        "horizon-s": PHASED_HORIZON_S,
                        "max-ops": 600},
}


def _horizon_s(genome: Genome) -> float:
    spec = SCENARIOS[genome.workload]
    return float(genome.opts.get("horizon-s", spec["horizon-s"]))


def default_horizon_s(workload: str) -> float:
    return float(SCENARIOS[workload]["horizon-s"])


def default_max_ops(workload: str) -> int:
    return int(SCENARIOS[workload]["max-ops"])


def build(genome: Genome, bug: Bug | str | None = None):
    """(ctx, gen, executor, model) for one genome. `bug` is a BUGS
    name, a Bug, or None for a healthy executor."""
    if isinstance(bug, str):
        bug = BUGS[bug]
    spec = SCENARIOS.get(genome.workload)
    if spec is None:
        raise ValueError(
            f"unknown search workload {genome.workload!r}; "
            f"have {sorted(SCENARIOS)}")
    ctx = gen_context({"concurrency": genome.concurrency})
    g = gen_clients(spec["client"](genome), _nemesis_gen(genome))
    return ctx, g, RegisterExecutor(genome, bug), models.register(0)
