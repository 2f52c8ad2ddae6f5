"""The chaos genome: one fuzzable fault+lifecycle schedule.

A chaos genome describes one self-test of the verification pipeline:
a workload seed + op budget, and an ordered list of *events* to
inject while the workload streams through a live
``VerificationService``. Events come in two families:

  backend    one of ``_platform.FAULT_KINDS`` + ``bitflip``, armed as
             a relative site-hit trigger: event i+1 starts counting
             hits only after event i fired (``FaultSchedule``
             semantics — what the absolute-counter env clauses cannot
             express, and the only way to land a fault *inside* the
             recovery replay of the previous one)
  lifecycle  a scripted service action at an op index: shed, socket
             drop (the session drop-proxy), SIGKILL+recover, standby
             failover, drain+resume

Genomes are plain data (to_dict/from_dict round-trip through JSON for
corpus artifacts and repro files), mutators are deterministic under an
explicit ``random.Random``, and shrink_reductions() yields candidate
reductions in decreasing-aggressiveness order — the same engine shape
as search/mutate.py, over a different universe.

The port's copy of `jepsen_tpu/chaos/genome.py`: the same draws in the
same order, so a seed gives the same genomes in both packages.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterator

# the backend vocabulary: _platform.FAULT_KINDS (dispatch-time raises)
# plus bitflip (staging-time silent corruption, caught by ABFT)
BACKEND_KINDS = ("oom", "device-lost", "compile", "wedged", "corrupt",
                 "bitflip")
LIFECYCLE_KINDS = ("shed", "drop", "kill-recover", "failover",
                   "drain-resume")

# genome sampling ranges (the "seed universe"): guided and random draw
# from exactly this space, so an A/B at a fixed budget compares search
# strategies, not spaces. MAX_AFTER is deliberately wide relative to
# the handful of chunks a smoke workload dispatches: most random
# backend events never fire, and a second event landing inside a
# recovery replay (a 1-2 hit window) is a conjunction random sampling
# essentially never constructs — the gradient the guided search climbs
MAX_EVENTS = 4
MAX_AFTER = 32
_AFTER_LOG2 = 5.0    # log2(MAX_AFTER): sample_at's draw exponent
MIN_OPS = 64
SEED_SPACE = 2 ** 32
DEFAULT_SITE = "stream-chunk/*"
LIFECYCLE_P = 0.2


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled event. For backend kinds ``at`` is the site-hit
    count after the previous backend event fired (>= 1); for
    lifecycle kinds it is the op index in the feed (>= 0)."""
    kind: str
    at: int
    site: str = DEFAULT_SITE

    @property
    def lifecycle(self) -> bool:
        return self.kind in LIFECYCLE_KINDS

    def to_dict(self) -> dict:
        return {"kind": self.kind, "at": self.at, "site": self.site}

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosEvent":
        return cls(kind=d["kind"], at=int(d["at"]),
                   site=d.get("site", DEFAULT_SITE))


@dataclasses.dataclass(frozen=True)
class ChaosGenome:
    seed: int
    workload: str
    ops: int
    events: tuple

    def to_dict(self) -> dict:
        return {"seed": self.seed, "workload": self.workload,
                "ops": self.ops,
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosGenome":
        return cls(seed=int(d["seed"]), workload=d["workload"],
                   ops=int(d["ops"]),
                   events=tuple(ChaosEvent.from_dict(e)
                                for e in d.get("events", [])))

    def key(self) -> tuple:
        """Canonical identity for corpus dedup. Event ORDER is
        identity — the whole point of a schedule."""
        return (self.seed, self.workload, self.ops,
                tuple((e.kind, e.at, e.site) for e in self.events))

    def backend_events(self) -> list:
        return [e for e in self.events if not e.lifecycle]

    def lifecycle_events(self) -> list:
        return [e for e in self.events if e.lifecycle]


def _clamp(x: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(x)))


def sample_at(rng: random.Random) -> int:
    """Log-uniform backend trigger draw over 1..MAX_AFTER: a smoke
    workload only dispatches a handful of chunks, so a uniform draw
    would leave most events inert and the coverage landscape flat
    (no fired fault, no gradient for the guided search to climb).
    Both strategies sample from this same distribution — the A/B
    compares search, not spaces."""
    return _clamp(round(2.0 ** rng.uniform(0.0, _AFTER_LOG2)),
                  1, MAX_AFTER)


def sample_event(rng: random.Random, ops: int,
                 lifecycle_p: float = LIFECYCLE_P) -> ChaosEvent:
    if rng.random() < lifecycle_p:
        return ChaosEvent(kind=rng.choice(LIFECYCLE_KINDS),
                          at=rng.randrange(ops))
    return ChaosEvent(kind=rng.choice(BACKEND_KINDS),
                      at=sample_at(rng))


def sample_genome(rng: random.Random, workload: str, ops: int,
                  lifecycle_p: float = LIFECYCLE_P) -> ChaosGenome:
    """One uniform draw from the seed universe."""
    n = rng.randint(1, MAX_EVENTS - 1)
    return ChaosGenome(
        seed=rng.randrange(SEED_SPACE), workload=workload, ops=ops,
        events=tuple(sample_event(rng, ops, lifecycle_p)
                     for _ in range(n)))


# -- mutators ---------------------------------------------------------------

def _with_event(g: ChaosGenome, i: int, e: ChaosEvent) -> ChaosGenome:
    events = list(g.events)
    events[i] = e
    return dataclasses.replace(g, events=tuple(events))


def _event_bounds(e: ChaosEvent, ops: int) -> tuple:
    return (0, ops - 1) if e.lifecycle else (1, MAX_AFTER)


def _perturb(g: ChaosGenome, rng: random.Random) -> ChaosGenome:
    """Nudge one event's trigger — the workhorse. Small sigma keeps a
    coverage-novel schedule's mutants exploring its neighborhood (a
    fired fault's successors inch toward the replay window)."""
    if not g.events:
        return _add_event(g, rng)
    i = rng.randrange(len(g.events))
    e = g.events[i]
    lo, hi = _event_bounds(e, g.ops)
    sigma = max(1.0, 0.15 * (hi - lo))
    at = _clamp(round(e.at + rng.gauss(0.0, sigma)), lo, hi)
    return _with_event(g, i, dataclasses.replace(e, at=at))


def _hasten(g: ChaosGenome, rng: random.Random) -> ChaosGenome:
    """Halve one trigger toward its floor — the directed version of
    perturb (earlier faults fire more, and a small relative trigger
    is what lands event i+1 inside event i's recovery replay)."""
    if not g.events:
        return _add_event(g, rng)
    i = rng.randrange(len(g.events))
    e = g.events[i]
    lo, _hi = _event_bounds(e, g.ops)
    return _with_event(g, i, dataclasses.replace(
        e, at=max(lo, e.at // 2)))


def _swap_kind(g: ChaosGenome, rng: random.Random) -> ChaosGenome:
    if not g.events:
        return _add_event(g, rng)
    i = rng.randrange(len(g.events))
    e = g.events[i]
    pool = LIFECYCLE_KINDS if e.lifecycle else BACKEND_KINDS
    others = [k for k in pool if k != e.kind]
    return _with_event(g, i, dataclasses.replace(
        e, kind=rng.choice(others)))


def _add_event(g: ChaosGenome, rng: random.Random) -> ChaosGenome:
    if len(g.events) >= MAX_EVENTS:
        return _perturb(g, rng)
    e = sample_event(rng, g.ops)
    i = rng.randint(0, len(g.events))
    events = list(g.events)
    events.insert(i, e)
    return dataclasses.replace(g, events=tuple(events))


def _stack_fault(g: ChaosGenome, rng: random.Random) -> ChaosGenome:
    """Append a backend fault with a SMALL relative trigger right
    after an existing backend event — the direct constructor of the
    fault-during-recovery conjunction."""
    backend = [i for i, e in enumerate(g.events) if not e.lifecycle]
    if not backend or len(g.events) >= MAX_EVENTS:
        return _add_event(g, rng)
    i = rng.choice(backend)
    stacked = ChaosEvent(kind=rng.choice(BACKEND_KINDS),
                         at=rng.randint(1, 3), site=g.events[i].site)
    events = list(g.events)
    events.insert(i + 1, stacked)
    return dataclasses.replace(g, events=tuple(events))


def _drop_event(g: ChaosGenome, rng: random.Random) -> ChaosGenome:
    if len(g.events) <= 1:
        return _perturb(g, rng)
    i = rng.randrange(len(g.events))
    return dataclasses.replace(
        g, events=g.events[:i] + g.events[i + 1:])


def _swap_order(g: ChaosGenome, rng: random.Random) -> ChaosGenome:
    if len(g.events) < 2:
        return _perturb(g, rng)
    i = rng.randrange(len(g.events) - 1)
    events = list(g.events)
    events[i], events[i + 1] = events[i + 1], events[i]
    return dataclasses.replace(g, events=tuple(events))


def _reseed(g: ChaosGenome, rng: random.Random) -> ChaosGenome:
    return dataclasses.replace(g, seed=rng.randrange(SEED_SPACE))


MUTATORS = (
    (_perturb, 5), (_hasten, 3), (_swap_kind, 2), (_add_event, 1),
    (_stack_fault, 3), (_drop_event, 1), (_swap_order, 1),
    (_reseed, 1),
)


def splice(a: ChaosGenome, b: ChaosGenome,
           rng: random.Random) -> ChaosGenome:
    """Cross two genomes: a prefix of one parent's schedule followed
    by a suffix of the other's (order within each parent preserved —
    schedules are sequences, not sets), capped at MAX_EVENTS."""
    ea, eb = list(a.events), list(b.events)
    cut_a = rng.randint(0, len(ea))
    cut_b = rng.randint(0, len(eb))
    events = tuple((ea[:cut_a] + eb[cut_b:])[:MAX_EVENTS])
    if not events:
        events = tuple(ea or eb)[:MAX_EVENTS]
    return ChaosGenome(
        seed=(a if rng.random() < 0.5 else b).seed,
        workload=a.workload, ops=a.ops, events=events)


def mutate(g: ChaosGenome, rng: random.Random,
           corpus: list | None = None) -> ChaosGenome:
    """One mutation step. With a corpus of >= 2 genomes, splice fires
    with probability 0.25; otherwise a weighted point mutator."""
    if corpus and len(corpus) >= 2 and rng.random() < 0.25:
        mate = corpus[rng.randrange(len(corpus))]
        out = splice(g, mate, rng)
        if out.key() != g.key():
            return out
    total = sum(w for _, w in MUTATORS)
    pick = rng.random() * total
    for fn, w in MUTATORS:
        pick -= w
        if pick <= 0:
            return fn(g, rng)
    return _perturb(g, rng)


# -- shrinking --------------------------------------------------------------

def shrink_reductions(g: ChaosGenome) -> Iterator[ChaosGenome]:
    """Candidate reductions, most aggressive first: drop whole events,
    then halve triggers toward their floor, then trim the op budget.
    Every candidate is strictly 'smaller'; the driver keeps one only
    if the oracle failure still reproduces."""
    if len(g.events) > 1:
        for i in range(len(g.events)):
            yield dataclasses.replace(
                g, events=g.events[:i] + g.events[i + 1:])
    for i, e in enumerate(g.events):
        lo, _hi = _event_bounds(e, g.ops)
        half = max(lo, e.at // 2)
        if half != e.at:
            yield _with_event(g, i, dataclasses.replace(e, at=half))
    if g.ops > 2 * MIN_OPS:
        yield dataclasses.replace(g, ops=max(MIN_OPS, g.ops // 2))


def genome_size(g: ChaosGenome) -> tuple:
    """The (lexicographic) size a shrink minimizes: event count, total
    trigger mass, op budget."""
    return (len(g.events), sum(e.at for e in g.events), g.ops)
