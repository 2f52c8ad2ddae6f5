"""The scenario genome and its seeded mutation engine.

A *genome* is the typed, serializable description of one scenario:
generator seed, client concurrency, the workload (a scenario name
from scenario.SCENARIOS plus opts), and a nemesis schedule — a
list of fault *windows*, each a (kind, start_s, duration_s) triple
over the fault-kind vocabulary of nemesis/combined.py's packages
(partition / kill / pause / clock). Genomes are plain data: to_dict /
from_dict round-trip through JSON for corpus artifacts and repro
files. The port's copy of `jepsen_tpu/search/mutate.py`: the same draws
in the same order, so a seed gives the same genomes in both packages.

Mutators are deterministic under an explicit `random.Random` — the
driver owns the rng, so a whole search replays from one seed:

  perturb    nudge one window's start or duration
  widen      grow one window
  narrow     shrink one window
  swap-kind  change one window's fault kind
  stack-kind add a DIFFERENT kind over an existing window's span —
             the direct constructor of conjunction faults (pairwise
             overlap is its own coverage dimension in coverage.py)
  add-window / drop-window
  reseed     new generator seed (same schedule, new interleaving)
  concurrency  bump client thread count
  splice     cross two corpus genomes: windows drawn from both parents
             (the conjunction-fault maker: a kill-overlapping parent
             spliced with a partition-overlapping one yields a
             schedule with both)

shrink_reductions() yields the candidate *reductions* of a genome in
decreasing-aggressiveness order; the driver's shrinker greedily
re-simulates them to a minimal reproducing scenario.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterator, Optional

FAULT_KINDS = ("partition", "kill", "pause", "clock")

# genome sampling ranges (the "seed universe"): both the guided search
# and the pure-random baseline draw from exactly this space, so an A/B
# at a fixed simulation budget compares search strategies, not spaces
MAX_WINDOWS = 3
MIN_DURATION_S = 0.2
MAX_DURATION_S = 2.0
MIN_CONCURRENCY = 2
MAX_CONCURRENCY = 5
SEED_SPACE = 2 ** 32


@dataclasses.dataclass(frozen=True)
class FaultWindow:
    kind: str
    start_s: float
    duration_s: float

    def to_dict(self) -> dict:
        return {"kind": self.kind, "start-s": round(self.start_s, 6),
                "duration-s": round(self.duration_s, 6)}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultWindow":
        return cls(kind=d["kind"], start_s=float(d["start-s"]),
                   duration_s=float(d["duration-s"]))


@dataclasses.dataclass(frozen=True)
class Genome:
    seed: int
    concurrency: int
    workload: str
    faults: tuple
    opts: dict = dataclasses.field(default_factory=dict)
    max_ops: Optional[int] = None

    def to_dict(self) -> dict:
        return {"seed": self.seed, "concurrency": self.concurrency,
                "workload": self.workload,
                "faults": [w.to_dict() for w in self.faults],
                "opts": dict(self.opts), "max-ops": self.max_ops}

    @classmethod
    def from_dict(cls, d: dict) -> "Genome":
        return cls(seed=int(d["seed"]),
                   concurrency=int(d["concurrency"]),
                   workload=d["workload"],
                   faults=tuple(FaultWindow.from_dict(w)
                                for w in d.get("faults", [])),
                   opts=dict(d.get("opts") or {}),
                   max_ops=d.get("max-ops"))

    def key(self) -> tuple:
        """Canonical identity for corpus dedup."""
        return (self.seed, self.concurrency, self.workload,
                tuple(sorted((w.kind, round(w.start_s, 6),
                              round(w.duration_s, 6))
                             for w in self.faults)),
                tuple(sorted(self.opts.items())), self.max_ops)


def _clamp(x: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, x))


def sample_window(rng: random.Random, horizon_s: float) -> FaultWindow:
    return FaultWindow(
        kind=rng.choice(FAULT_KINDS),
        start_s=round(rng.uniform(0.0, horizon_s), 3),
        duration_s=round(rng.uniform(MIN_DURATION_S, MAX_DURATION_S),
                         3))


def sample_genome(rng: random.Random, workload: str,
                  horizon_s: float, opts: dict | None = None,
                  max_ops: Optional[int] = None) -> Genome:
    """One uniform draw from the seed universe."""
    n = rng.randint(1, MAX_WINDOWS)
    return Genome(
        seed=rng.randrange(SEED_SPACE),
        concurrency=rng.randint(MIN_CONCURRENCY, MAX_CONCURRENCY),
        workload=workload,
        faults=tuple(sample_window(rng, horizon_s) for _ in range(n)),
        opts=dict(opts or {}),
        max_ops=max_ops)


# -- mutators ---------------------------------------------------------------

def _with_window(g: Genome, i: int, w: FaultWindow) -> Genome:
    faults = list(g.faults)
    faults[i] = w
    return dataclasses.replace(g, faults=tuple(faults))


def _perturb(g: Genome, rng: random.Random, horizon_s: float) -> Genome:
    if not g.faults:
        return _add_window(g, rng, horizon_s)
    i = rng.randrange(len(g.faults))
    w = g.faults[i]
    if rng.random() < 0.7:
        # timing nudges are the workhorse: small sigma keeps a
        # coverage-novel window's mutants exploring its neighborhood
        sigma = max(0.05, 0.05 * horizon_s * rng.random())
        w = dataclasses.replace(
            w, start_s=round(
                _clamp(w.start_s + rng.gauss(0.0, sigma), 0.0,
                       horizon_s), 3))
    else:
        w = dataclasses.replace(
            w, duration_s=round(
                _clamp(w.duration_s * rng.uniform(0.5, 2.0),
                       MIN_DURATION_S, MAX_DURATION_S), 3))
    return _with_window(g, i, w)


def _widen(g: Genome, rng: random.Random, horizon_s: float) -> Genome:
    if not g.faults:
        return _add_window(g, rng, horizon_s)
    i = rng.randrange(len(g.faults))
    w = g.faults[i]
    return _with_window(g, i, dataclasses.replace(
        w, duration_s=round(_clamp(w.duration_s * 1.5, MIN_DURATION_S,
                                   MAX_DURATION_S), 3)))


def _narrow(g: Genome, rng: random.Random, horizon_s: float) -> Genome:
    if not g.faults:
        return _add_window(g, rng, horizon_s)
    i = rng.randrange(len(g.faults))
    w = g.faults[i]
    return _with_window(g, i, dataclasses.replace(
        w, duration_s=round(_clamp(w.duration_s * 0.5, MIN_DURATION_S,
                                   MAX_DURATION_S), 3)))


def _swap_kind(g: Genome, rng: random.Random,
               horizon_s: float) -> Genome:
    if not g.faults:
        return _add_window(g, rng, horizon_s)
    i = rng.randrange(len(g.faults))
    w = g.faults[i]
    others = [k for k in FAULT_KINDS if k != w.kind]
    return _with_window(g, i, dataclasses.replace(
        w, kind=rng.choice(others)))


def _stack_kind(g: Genome, rng: random.Random,
                horizon_s: float) -> Genome:
    if not g.faults or len(g.faults) >= MAX_WINDOWS:
        return _perturb(g, rng, horizon_s)
    w = g.faults[rng.randrange(len(g.faults))]
    others = [k for k in FAULT_KINDS if k != w.kind]
    jitter = rng.uniform(-0.25, 0.25) * w.duration_s
    stacked = FaultWindow(
        kind=rng.choice(others),
        start_s=round(_clamp(w.start_s + jitter, 0.0, horizon_s), 3),
        duration_s=w.duration_s)
    return dataclasses.replace(g, faults=g.faults + (stacked,))


def _add_window(g: Genome, rng: random.Random,
                horizon_s: float) -> Genome:
    if len(g.faults) >= MAX_WINDOWS:
        return _perturb(g, rng, horizon_s)
    return dataclasses.replace(
        g, faults=g.faults + (sample_window(rng, horizon_s),))


def _drop_window(g: Genome, rng: random.Random,
                 horizon_s: float) -> Genome:
    if len(g.faults) <= 1:
        return _perturb(g, rng, horizon_s)
    i = rng.randrange(len(g.faults))
    return dataclasses.replace(
        g, faults=g.faults[:i] + g.faults[i + 1:])


def _reseed(g: Genome, rng: random.Random, horizon_s: float) -> Genome:
    return dataclasses.replace(g, seed=rng.randrange(SEED_SPACE))


def _concurrency(g: Genome, rng: random.Random,
                 horizon_s: float) -> Genome:
    c = _clamp(g.concurrency + rng.choice((-1, 1)), MIN_CONCURRENCY,
               MAX_CONCURRENCY)
    return dataclasses.replace(g, concurrency=int(c))


MUTATORS = (
    (_perturb, 5), (_widen, 1), (_narrow, 1), (_swap_kind, 2),
    (_stack_kind, 3), (_add_window, 1), (_drop_window, 1),
    (_reseed, 2), (_concurrency, 1),
)


def splice(a: Genome, b: Genome, rng: random.Random) -> Genome:
    """Cross two genomes: each parent contributes a nonempty subset of
    its windows (capped at MAX_WINDOWS total), scalar fields drawn
    from either parent."""
    pool: list = []
    for parent in (a, b):
        ws = list(parent.faults)
        if ws:
            rng.shuffle(ws)
            pool.extend(ws[:max(1, rng.randint(1, len(ws)))])
    rng.shuffle(pool)
    return Genome(
        seed=(a if rng.random() < 0.5 else b).seed,
        concurrency=(a if rng.random() < 0.5 else b).concurrency,
        workload=a.workload,
        faults=tuple(pool[:MAX_WINDOWS]),
        opts=dict(a.opts),
        max_ops=a.max_ops)


def mutate(g: Genome, rng: random.Random, horizon_s: float,
           corpus: list | None = None) -> Genome:
    """One mutation step. With a corpus of >= 2 genomes, splice fires
    with probability 0.25 (crossing this genome with a random corpus
    mate); otherwise a weighted point mutator."""
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
            return fn(g, rng, horizon_s)
    return _perturb(g, rng, horizon_s)


# -- shrinking --------------------------------------------------------------

def shrink_reductions(g: Genome) -> Iterator[Genome]:
    """Candidate reductions, most aggressive first: drop whole
    windows, then halve durations, then coarsen start times, then
    lower concurrency, then trim the op budget. Every candidate is
    strictly 'smaller'; the driver keeps one only if the violation
    still reproduces."""
    if len(g.faults) > 1:
        for i in range(len(g.faults)):
            yield dataclasses.replace(
                g, faults=g.faults[:i] + g.faults[i + 1:])
    for i, w in enumerate(g.faults):
        if w.duration_s > 2 * MIN_DURATION_S:
            yield _with_window(g, i, dataclasses.replace(
                w, duration_s=round(max(MIN_DURATION_S,
                                        w.duration_s / 2), 3)))
    for i, w in enumerate(g.faults):
        coarse = round(w.start_s, 1)
        if coarse != w.start_s:
            yield _with_window(g, i, dataclasses.replace(
                w, start_s=coarse))
        whole = float(int(w.start_s))
        if whole not in (w.start_s, coarse):
            yield _with_window(g, i, dataclasses.replace(
                w, start_s=whole))
    if g.concurrency > MIN_CONCURRENCY:
        yield dataclasses.replace(g, concurrency=MIN_CONCURRENCY)
        if g.concurrency - 1 > MIN_CONCURRENCY:
            yield dataclasses.replace(g, concurrency=g.concurrency - 1)
    if g.max_ops and g.max_ops > 50:
        yield dataclasses.replace(g, max_ops=max(50, g.max_ops // 2))


def genome_size(g: Genome) -> tuple:
    """The (lexicographic) size a shrink minimizes: window count, total
    fault seconds, concurrency, op budget."""
    return (len(g.faults),
            round(sum(w.duration_s for w in g.faults), 6),
            g.concurrency, g.max_ops or 0)
