"""Nemesis packages: a composable algebra of faults + their generators.

Reference: `jepsen/src/jepsen/nemesis/combined.clj` — a *package* is
{"nemesis", "generator", "final-generator", "perf"}; node-spec DSL
(:38-68), db kill/pause package (:70-160), partition-spec grudges +
package (:162-246), clock package (:248-280), f-map lifting (:282-303),
and composition (:305-374).
"""

from __future__ import annotations

import random
from typing import Iterable

from .. import db as db_
from .. import generator as gen
from ..util import majority
from . import Nemesis, compose as n_compose, f_map as n_f_map, noop as n_noop
from . import partition as part
from . import time as nt

DEFAULT_INTERVAL = 10  # seconds between nemesis ops (`combined.clj:27-29`)

noop = {"generator": None, "final-generator": None, "nemesis": n_noop,
        "perf": set()}


def minority_third(n: int) -> int:
    """Up to, but not including, one third of n (reference
    `util/minority-third`)."""
    return max(0, (n - 1) // 3) if n % 3 == 0 else (n - 1) // 3


def random_nonempty_subset(nodes, rng=None):
    r = rng or random
    return r.sample(list(nodes), r.randint(1, len(nodes)))


def db_nodes(test: dict, db, node_spec):
    """Resolve a node spec to nodes (`combined.clj:38-61`):
    None | "one" | "minority" | "majority" | "minority-third" |
    "primaries" | "all" | explicit list."""
    nodes = list(test["nodes"])
    if node_spec is None:
        return random_nonempty_subset(nodes)
    if node_spec == "one":
        return [random.choice(nodes)]
    if node_spec == "minority":
        random.shuffle(nodes)
        return nodes[:majority(len(nodes)) - 1]
    if node_spec == "majority":
        random.shuffle(nodes)
        return nodes[:majority(len(nodes))]
    if node_spec == "minority-third":
        random.shuffle(nodes)
        return nodes[:minority_third(len(nodes))]
    if node_spec == "primaries":
        return random_nonempty_subset(db.primaries(test))
    if node_spec == "all":
        return nodes
    return list(node_spec)


def node_specs(db) -> list:
    """All node specs valid for this DB (`combined.clj:63-68`)."""
    specs = [None, "one", "minority-third", "minority", "majority", "all"]
    if db_.supports(db, "primary"):
        specs.append("primaries")
    return specs


class DBNemesis(Nemesis):
    """start/kill/pause/resume against node specs (`combined.clj:70-98`)."""

    def __init__(self, db):
        self.db = db

    def fs(self):
        return {"start", "kill", "pause", "resume"}

    def invoke(self, test, op):
        from .. import control as c

        f = {"start": lambda t, n: self.db.start(t, n),
             "kill": lambda t, n: self.db.kill(t, n),
             "pause": lambda t, n: self.db.pause(t, n),
             "resume": lambda t, n: self.db.resume(t, n)}[op["f"]]
        nodes = db_nodes(test, self.db, op.get("value"))
        res = c.on_nodes(test, f, nodes=nodes)
        return {**op, "value": res}


def db_generators(opts: dict) -> dict:
    """:generator/:final-generator for kill/pause flip-flops, driven by
    which capability protocols the DB implements
    (`combined.clj:100-139`)."""
    db = opts["db"]
    faults = opts["faults"]
    kill = db_.supports(db, "process") and "kill" in faults
    pause = db_.supports(db, "pause") and "pause" in faults
    kill_targets = opts.get("kill", {}).get("targets") or node_specs(db)
    pause_targets = opts.get("pause", {}).get("targets") or node_specs(db)

    start = {"type": "info", "f": "start", "value": "all"}
    resume = {"type": "info", "f": "resume", "value": "all"}

    def kill_op(test, ctx):
        return {"type": "info", "f": "kill",
                "value": random.choice(kill_targets)}

    def pause_op(test, ctx):
        return {"type": "info", "f": "pause",
                "value": random.choice(pause_targets)}

    modes, final = [], []
    if pause:
        modes.append(gen.flip_flop(pause_op, gen.repeat(resume)))
        final.append(resume)
    if kill:
        modes.append(gen.flip_flop(kill_op, gen.repeat(start)))
        final.append(start)
    return {"generator": gen.mix(modes) if modes else None,
            "final-generator": final or None}


def db_package(opts: dict) -> dict:
    """Kill/pause package (`combined.clj:141-160`)."""
    needed = bool({"kill", "pause"} & set(opts["faults"]))
    gens = db_generators(opts)
    g = gens["generator"]
    if g is not None:
        g = gen.stagger(opts.get("interval", DEFAULT_INTERVAL), g)
    return {"generator": g if needed else None,
            "final-generator": gens["final-generator"] if needed else None,
            "nemesis": DBNemesis(opts["db"]),
            "perf": {("kill", frozenset({"kill"}), frozenset({"start"}),
                      "#E9A4A0"),
                     ("pause", frozenset({"pause"}),
                      frozenset({"resume"}), "#A0B1E9")}}


def grudge(test: dict, db, part_spec):
    """Compute a grudge from a partition spec (`combined.clj:162-188`):
    "one" | "majority" | "majorities-ring" | "minority-third" |
    "primaries" | explicit grudge dict."""
    nodes = list(test["nodes"])
    if part_spec == "one":
        return part.complete_grudge(part.split_one(nodes))
    if part_spec == "majority":
        random.shuffle(nodes)
        return part.complete_grudge(part.bisect(nodes))
    if part_spec == "majorities-ring":
        return part.majorities_ring(nodes)
    if part_spec == "minority-third":
        random.shuffle(nodes)
        k = minority_third(len(nodes))
        return part.complete_grudge([nodes[:k], nodes[k:]])
    if part_spec == "primaries":
        primaries = db.primaries(test)
        chosen = random_nonempty_subset(primaries)
        rest = [n for n in nodes if n not in set(primaries)]
        return part.complete_grudge([rest] + [[p] for p in chosen])
    return part_spec


def partition_specs(db) -> list:
    specs = ["one", "minority-third", "majority", "majorities-ring"]
    if db_.supports(db, "primary"):
        specs.append("primaries")
    return specs


class PartitionNemesis(Nemesis):
    """Partitioner lifted to partition specs (`combined.clj:196-224`)."""

    def __init__(self, db, p: Nemesis | None = None):
        self.db = db
        self.p = p or part.partitioner()

    def fs(self):
        return {"start-partition", "stop-partition"}

    def setup(self, test):
        return PartitionNemesis(self.db, self.p.setup(test))

    def invoke(self, test, op):
        if op["f"] == "start-partition":
            g = grudge(test, self.db, op.get("value"))
            out = self.p.invoke(test, {**op, "f": "start", "value": g})
        elif op["f"] == "stop-partition":
            out = self.p.invoke(test, {**op, "f": "stop"})
        else:
            raise ValueError(f"can't handle f={op['f']!r}")
        return {**out, "f": op["f"]}

    def teardown(self, test):
        self.p.teardown(test)


def partition_package(opts: dict) -> dict:
    """Partition package (`combined.clj:226-246`)."""
    needed = "partition" in set(opts["faults"])
    db = opts["db"]
    targets = opts.get("partition", {}).get("targets") or \
        partition_specs(db)

    def start(test, ctx):
        return {"type": "info", "f": "start-partition",
                "value": random.choice(targets)}

    stop = {"type": "info", "f": "stop-partition", "value": None}
    g = gen.stagger(opts.get("interval", DEFAULT_INTERVAL),
                    gen.flip_flop(start, gen.repeat(stop)))
    return {"generator": g if needed else None,
            "final-generator": stop if needed else None,
            "nemesis": PartitionNemesis(db),
            "perf": {("partition", frozenset({"start-partition"}),
                      frozenset({"stop-partition"}), "#E9DCA0")}}


def clock_package(opts: dict) -> dict:
    """Clock-skew package (`combined.clj:248-280`)."""
    needed = "clock" in set(opts["faults"])
    db = opts["db"]
    nemesis = n_compose([({"reset-clock": "reset",
                           "check-clock-offsets": "check-offsets",
                           "strobe-clock": "strobe",
                           "bump-clock": "bump"}, nt.clock_nemesis())])
    target_specs = opts.get("clock", {}).get("targets") or node_specs(db)

    def targets(test):
        return db_nodes(test, db,
                        random.choice(target_specs) if target_specs
                        else None)

    lift = {"reset": "reset-clock",
            "check-offsets": "check-clock-offsets",
            "strobe": "strobe-clock",
            "bump": "bump-clock"}
    clock_gen = gen.phases(
        {"type": "info", "f": "check-offsets"},
        gen.mix([nt.reset_gen_select(targets),
                 nt.bump_gen_select(targets),
                 nt.strobe_gen_select(targets)]))
    g = gen.stagger(opts.get("interval", DEFAULT_INTERVAL),
                    gen.f_map(lift, clock_gen))
    return {"generator": g if needed else None,
            "final-generator": ({"type": "info", "f": "reset-clock"}
                                if needed else None),
            "nemesis": nemesis,
            "perf": {("clock", frozenset({"bump-clock"}),
                      frozenset({"reset-clock"}), "#A0E9E3")}}


def f_map(lift, pkg: dict) -> dict:
    """Lift a whole package's f-space (`combined.clj:294-303`)."""
    perf = set()
    for name, start, stop, color in pkg["perf"]:
        perf.add((lift(name), frozenset(lift(f) for f in start),
                  frozenset(lift(f) for f in stop), color))
    return {
        "generator": gen.f_map(lift, pkg["generator"])
        if pkg["generator"] is not None else None,
        "final-generator": gen.f_map(lift, pkg["final-generator"])
        if pkg["final-generator"] is not None else None,
        "nemesis": n_f_map(lift, pkg["nemesis"]),
        "perf": perf,
    }


def compose_packages(packages: Iterable[dict]) -> dict:
    """Combine packages: generators via gen.any, final generators
    sequentially, nemeses by f-routing (`combined.clj:305-316`)."""
    packages = list(packages)
    if not packages:
        return noop
    if len(packages) == 1:
        return packages[0]
    gens = [p["generator"] for p in packages
            if p["generator"] is not None]
    finals = [p["final-generator"] for p in packages
              if p["final-generator"] is not None]
    perf = set()
    for p in packages:
        perf |= p["perf"]
    return {"generator": gen.any(*gens) if gens else None,
            "final-generator": finals or None,
            "nemesis": n_compose([p["nemesis"] for p in packages]),
            "perf": perf}


def nemesis_packages(opts: dict) -> list[dict]:
    """The individual packages, pre-composition (`combined.clj:318-326`)."""
    opts = {**opts, "faults": set(opts.get("faults")
                                  or ["partition", "kill", "pause",
                                      "clock"])}
    return [partition_package(opts), clock_package(opts),
            db_package(opts)]


def nemesis_package(opts: dict) -> dict:
    """The kitchen-sink package: partitions + clock skew + kill/pause,
    each fault type gated by opts["faults"] (`combined.clj:328-374`).

    Mandatory: opts["db"]. Optional: "interval" (s), "faults" (list),
    "partition"/"kill"/"pause"/"clock" each {"targets": [...]}.
    """
    return compose_packages(nemesis_packages(opts))
