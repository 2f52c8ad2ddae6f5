"""Network-partition nemeses and grudge calculus.

Reference: `jepsen/src/jepsen/nemesis.clj` — `bisect` (:108-111),
`split-one` (:113-118), `complete-grudge` (:120-132), `invert-grudge`
(:134-142), `bridge` (:144-155), `partitioner` (:157-183), the packaged
partitioners (:185-200, :277-281), and the majorities-ring grudges:
exact for ≤5 nodes (:202-216), stochastic for larger clusters
(:218-258).

A *grudge* maps each node to the set of nodes whose traffic it drops.
"""

from __future__ import annotations

import random
from typing import Callable, Iterable

from .. import net
from ..util import majority
from . import Nemesis


def bisect(coll: list) -> tuple[list, list]:
    """Cut a sequence in half; smaller half first (`nemesis.clj:108-111`)."""
    mid = len(coll) // 2
    return list(coll[:mid]), list(coll[mid:])


def split_one(coll: list, loner=None) -> tuple[list, list]:
    """Split one node (random unless given) from the rest
    (`nemesis.clj:113-118`)."""
    if loner is None:
        loner = random.choice(list(coll))
    return [loner], [x for x in coll if x != loner]


def complete_grudge(components: Iterable[Iterable]) -> dict:
    """Grudge in which no node can talk outside its component
    (`nemesis.clj:120-132`)."""
    comps = [set(c) for c in components]
    universe = set().union(*comps) if comps else set()
    grudge = {}
    for comp in comps:
        for node in comp:
            grudge[node] = universe - comp
    return grudge


def invert_grudge(nodes: Iterable, conns: dict) -> dict:
    """From {node: set-of-connected} to {node: set-to-DROP}
    (`nemesis.clj:134-142`)."""
    ns = set(nodes)
    return {a: ns - conns.get(a, set()) - {a} for a in sorted(ns)}


def bridge(nodes: list) -> dict:
    """Cut the network in half but keep one bridge node connected to both
    sides (`nemesis.clj:144-155`)."""
    components = bisect(list(nodes))
    bridge_node = components[1][0]
    grudge = complete_grudge(components)
    grudge.pop(bridge_node, None)
    return {k: v - {bridge_node} for k, v in grudge.items()}


def majorities_ring_perfect(nodes: list,
                            rng: random.Random | None = None) -> dict:
    """Exact ring of overlapping majorities for ≤5 nodes
    (`nemesis.clj:202-216`)."""
    r = rng or random
    U = set(nodes)
    n = len(nodes)
    m = majority(n)
    ring = list(nodes)
    r.shuffle(ring)
    grudge = {}
    for i in range(n):
        maj = [ring[(i + j) % n] for j in range(m)]
        holder = maj[len(maj) // 2]
        grudge[holder] = U - set(maj)
    return grudge


def majorities_ring_stochastic(nodes: list,
                               rng: random.Random | None = None) -> dict:
    """Incremental least-connected matching until every node sees a
    majority (`nemesis.clj:218-258`)."""
    r = rng or random
    n = len(nodes)
    m = majority(n)
    conns: dict = {a: {a} for a in nodes}
    while True:
        # shuffled, degree-ordered [degree, node]
        by_degree: dict[int, list] = {}
        for node, cs in conns.items():
            by_degree.setdefault(len(cs), []).append(node)
        dns = []
        for d in sorted(by_degree):
            group = by_degree[d]
            r.shuffle(group)
            dns.extend((d, x) for x in group)
        a_degree, a = dns[0]
        if m <= a_degree:
            return invert_grudge(nodes, conns)
        b = next(node for d, node in dns if node not in conns[a])
        conns[a].add(b)
        conns[b].add(a)


def majorities_ring(nodes: list, rng: random.Random | None = None) -> dict:
    """Every node sees a majority; no two see the same one
    (`nemesis.clj:260-275`)."""
    if len(nodes) <= 5:
        return majorities_ring_perfect(nodes, rng)
    return majorities_ring_stochastic(nodes, rng)


class Partitioner(Nemesis):
    """:start cuts links per (grudge nodes) or the op's :value grudge;
    :stop heals (`nemesis.clj:157-183`)."""

    def __init__(self, grudge: Callable[[list], dict] | None = None):
        self.grudge = grudge

    def fs(self):
        return {"start-partition", "stop-partition", "start", "stop"}

    def setup(self, test):
        test["net"].heal(test)
        return self

    def invoke(self, test, op):
        f = op.get("f")
        if f in ("start", "start-partition"):
            grudge = op.get("value")
            if grudge is None:
                if self.grudge is None:
                    raise ValueError(
                        f"op {op!r} needs a grudge :value, and this "
                        "partitioner has no grudge function")
                grudge = self.grudge(list(test["nodes"]))
            net.drop_all(test, grudge)
            return {**op, "value": ["isolated", grudge]}
        if f in ("stop", "stop-partition"):
            test["net"].heal(test)
            return {**op, "value": "network-healed"}
        raise ValueError(f"partitioner can't handle f={f!r}")

    def teardown(self, test):
        test["net"].heal(test)


def partitioner(grudge=None) -> Partitioner:
    return Partitioner(grudge)


def partition_halves() -> Partitioner:
    """First half vs second half (`nemesis.clj:185-190`)."""
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves() -> Partitioner:
    """Random halves (`nemesis.clj:192-195`)."""
    def g(nodes):
        ns = list(nodes)
        random.shuffle(ns)
        return complete_grudge(bisect(ns))
    return Partitioner(g)


def partition_random_node() -> Partitioner:
    """Isolate one random node (`nemesis.clj:197-200`)."""
    return Partitioner(lambda nodes: complete_grudge(split_one(nodes)))


def partition_majorities_ring() -> Partitioner:
    """Overlapping-majorities ring (`nemesis.clj:277-281`)."""
    return Partitioner(majorities_ring)
