"""The port's generator package (`jepsen_tpu_torch/generator/`) and the
independent generators (`jepsen_tpu_torch/independent.py`) against the
JAX package's on the same combinator trees.

Each tree is built once from each package's own combinators and run
through each package's simulator (`quick`, `perfect`, `perfect_info`,
`imperfect`, `simulate`) under one pinned seed. Tolerance: none — the
histories must be equal op for op, since the scenario search is only
reproducible when every draw goes through the same `random.Random`
calls in the same order.
"""

from __future__ import annotations

import pytest

from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jindependent
from jepsen_tpu.generator import simulate as jsim
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch.generator import simulate as sim


def _rw(g):
    def rw(test, ctx):
        if g.rng.random() < 0.5:
            return {"f": "read", "value": None}
        return {"f": "write", "value": g.rng.randrange(100)}
    return rw


def _counter(limit):
    n = {"i": 0}

    def nxt():
        n["i"] += 1
        return {"f": "inc", "value": n["i"]} if n["i"] <= limit else None
    return nxt


def _nemesis_cycle(g):
    return g.cycle_times(0.05, {"type": "info", "f": "start-partition"},
                         0.05, {"type": "info", "f": "stop-partition"})


TREES = {
    "dict": lambda g: {"f": "write", "value": 1},
    "fn-limit": lambda g: g.limit(12, _rw(g)),
    "sequence": lambda g: [{"f": "a"}, [{"f": "b"}, {"f": "c"}], None,
                           {"f": "d"}],
    "once-repeat": lambda g: [g.once({"f": "x"}), g.repeat(3, {"f": "y"})],
    "cycle": lambda g: g.limit(9, g.cycle([{"f": "a"}, {"f": "b"}])),
    "map-f_map-filter": lambda g: g.f_map(
        {"write": "put"},
        g.filter(lambda o: o["f"] != "read",
                 g.map(lambda o: {**o, "tag": 1}, g.limit(20, _rw(g))))),
    "clients-nemesis": lambda g: g.clients(
        g.limit(15, _rw(g)),
        [{"type": "info", "f": "kill"}, g.sleep(0.001),
         {"type": "info", "f": "start"}]),
    "nemesis-only": lambda g: g.nemesis(g.limit(3, {"f": "pause"})),
    "each-thread": lambda g: g.each_thread(g.limit(2, {"f": "r"})),
    "reserve": lambda g: g.reserve(1, g.repeat(4, {"f": "w"}),
                                   g.repeat(4, {"f": "r"})),
    "any": lambda g: g.limit(10, g.any(g.repeat({"f": "a"}),
                                       g.repeat({"f": "b"}))),
    "mix": lambda g: g.limit(30, g.mix([g.repeat({"f": "a"}),
                                        g.repeat({"f": "b"}),
                                        _rw(g)])),
    "flip-flop": lambda g: g.limit(7, g.flip_flop(g.repeat({"f": "a"}),
                                                  g.repeat({"f": "b"}))),
    "stagger": lambda g: g.limit(20, g.stagger(0.01, _rw(g))),
    "delay": lambda g: g.limit(10, g.delay(0.002, g.repeat({"f": "r"}))),
    "time-limit": lambda g: g.time_limit(0.05, g.stagger(0.004, _rw(g))),
    "sleep": lambda g: [{"f": "a"}, g.sleep(0.01), {"f": "b"}],
    "phases-then": lambda g: g.phases(
        g.repeat(4, {"f": "a"}),
        g.then(g.repeat(2, {"f": "c"}), g.repeat(2, {"f": "b"}))),
    "synchronize": lambda g: [g.repeat(3, {"f": "a"}),
                              g.synchronize(g.repeat(3, {"f": "b"}))],
    "process-limit": lambda g: g.process_limit(5, g.repeat(20, {"f": "r"})),
    "until-ok": lambda g: g.limit(8, g.until_ok(g.repeat({"f": "cas"}))),
    "cycle-times": lambda g: g.time_limit(
        0.3, g.clients(g.stagger(0.01, _rw(g)), _nemesis_cycle(g))),
    "on-threads": lambda g: g.on_threads(
        lambda t: t == 0, g.repeat(5, {"f": "zero"})),
    "concat": lambda g: g.concat(g.repeat(2, {"f": "a"}),
                                 g.repeat(2, {"f": "b"})),
    "fn-counter": lambda g: _counter(6),
    "iterator": lambda g: iter([{"f": "i", "value": v} for v in range(5)]),
    "derefer": lambda g: g.derefer(
        lambda test, ctx: g.repeat(3, {"f": "d"})),
    "on-update": lambda g: g.on_update(
        lambda self, test, ctx, event: self, g.repeat(4, {"f": "u"})),
    "ignore-updates": lambda g: g.ignore_updates(g.repeat(4, {"f": "v"})),
    "validate-friendly": lambda g: g.friendly_exceptions(
        g.validate(g.limit(6, _rw(g)))),
    "log": lambda g: [g.log("hello"), {"f": "after"}],
}

def _build(g, tree):
    """A tree built under the package's pinned rng: some combinators
    draw when built (`mix` picks its first source)."""
    with g.fixed_rng(11):
        return tree(g)


RUNS = {
    "quick": lambda s, tree: s.quick(tree),
    "perfect": lambda s, tree: s.perfect(tree),
    "perfect_info": lambda s, tree: s.perfect_info(tree),
    "imperfect": lambda s, tree: s.imperfect(tree),
    "simulate-4": lambda s, tree: s.simulate(
        s.n_plus_nemesis_context(4), tree, s._latency("ok"), seed=7),
}


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("name", sorted(TREES))
def test_simulated_history_equals_the_jax_package(name, run):
    want = RUNS[run](jsim, _build(jgen, TREES[name]))
    got = RUNS[run](sim, _build(gen, TREES[name]))
    assert got == want
    assert len(got) > 0


def test_fixed_rng_draws_equal_the_jax_package():
    with jgen.fixed_rng(45100):
        want = [jgen.rng.random() for _ in range(5)] + [
            jgen._rand_nanos(1_000_000) for _ in range(5)]
    with gen.fixed_rng(45100):
        got = [gen.rng.random() for _ in range(5)] + [
            gen._rand_nanos(1_000_000) for _ in range(5)]
    assert got == want


def test_context_helpers_equal_the_jax_package():
    jc = jgen.context({"concurrency": 3})
    c = gen.context({"concurrency": 3})
    assert c.time == jc.time and c.free_threads == jc.free_threads
    assert c.workers == jc.workers
    jc2 = jc.busy(1).with_time(5)
    c2 = c.busy(1).with_time(5)
    assert gen.free_processes(c2) == jgen.free_processes(jc2)
    assert gen.all_processes(c2) == jgen.all_processes(jc2)
    assert gen.next_process(c2, 1) == jgen.next_process(jc2, 1)


def _seq(ind, g):
    return ind.sequential_generator(
        range(4), lambda k: g.limit(3, g.repeat({"f": "w", "value": k})))


def _conc(ind, g):
    return ind.concurrent_generator(
        2, range(5), lambda k: g.limit(4, _rw(g)))


def _conc_nemesis(ind, g):
    return g.clients(
        ind.concurrent_generator(1, iter(range(6)),
                                 lambda k: g.repeat(2, {"f": "r"})),
        [{"type": "info", "f": "kill"}])


def _tuple(ind, g):
    return ind.tuple_gen("k", g.limit(5, _rw(g)))


INDEPENDENT = {"sequential": _seq, "concurrent": _conc,
               "concurrent-nemesis": _conc_nemesis, "tuple": _tuple}


@pytest.mark.parametrize("run", ["perfect", "imperfect", "simulate-4"])
@pytest.mark.parametrize("name", sorted(INDEPENDENT))
def test_independent_generators_equal_the_jax_package(name, run):
    want = RUNS[run](jsim, _build(
        jgen, lambda g: INDEPENDENT[name](jindependent, g)))
    got = RUNS[run](sim, _build(
        gen, lambda g: INDEPENDENT[name](independent, g)))
    assert got == want
    kv = [o["value"] for o in got if isinstance(o.get("value"), tuple)]
    assert kv and all(type(v) is independent.KV for v in kv)


def test_concurrent_generator_rejects_indivisible_threads():
    g = independent.concurrent_generator(2, range(3),
                                         lambda k: {"f": "r"})
    with pytest.raises(ValueError):
        sim.simulate(sim.n_plus_nemesis_context(3), g, sim._ok)
    jg = jindependent.concurrent_generator(2, range(3),
                                           lambda k: {"f": "r"})
    with pytest.raises(ValueError):
        jsim.simulate(jsim.n_plus_nemesis_context(3), jg, jsim._ok)
