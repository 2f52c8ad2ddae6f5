"""The port's Elle checkers against the JAX package's, on the CPU.

The same inputs go through both packages: the batched SCC classifier on
seeded 0/1 buckets, `analyze_edges` over the adversarial corpus of
tests/test_elle_adversarial.py and self-loops, `list_append.check` and
`wr.check` over golden and synthetic histories (with and without the
realtime/process graphs), `transitive_closure`, the synth transaction
generators, the checker adapters through `check_safe`, and the 'elle'
fault-injection site. The JAX side runs its XLA classifier on the CPU
(`JAX_PLATFORMS=cpu`), with `JEPSEN_TPU_ELLE_HOST` unset; the port runs
its plain PyTorch path (`device="cpu"`).

Every comparison is exact equality: flags, residues, labels, node
arrays and whole result dicts, certificates included. The classifier's
arithmetic is on integers far below float32's 2^24, so no tolerance is
needed or allowed.
"""

import numpy as np
import pytest
import torch

from jepsen_tpu import _platform as jplat
from jepsen_tpu.checker import check_safe as jcheck_safe
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.checker.elle import (ListAppendChecker as JListAppend,
                                     RWRegisterChecker as JRWRegister)
from jepsen_tpu.checker.elle import kernels as jk
from jepsen_tpu.checker.elle import list_append as jla
from jepsen_tpu.checker.elle import wr as jwr
from jepsen_tpu.history import history as jhistory
from jepsen_tpu_torch import _platform as tplat
from jepsen_tpu_torch import parallel
from jepsen_tpu_torch.checker import check_safe as tcheck_safe
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker.elle import (ListAppendChecker,
                                           RWRegisterChecker,
                                           list_append_checker,
                                           rw_register_checker)
from jepsen_tpu_torch.checker.elle import kernels as tk
from jepsen_tpu_torch.checker.elle import list_append as tla
from jepsen_tpu_torch.checker.elle import wr as twr
from jepsen_tpu_torch.history import history as thistory

CPU = "cpu"
_FLAG_KEYS = ("G0", "G1c", "G-single", "G2-item")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only contend with the
    other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_faults(monkeypatch):
    """No injection left over from another test, in either package."""
    monkeypatch.delenv(tplat.FAULT_INJECT_ENV, raising=False)
    monkeypatch.delenv("JEPSEN_TPU_ELLE_HOST", raising=False)
    tplat.reset_fault_injection()
    jplat.reset_fault_injection()
    yield monkeypatch
    tplat.reset_fault_injection()
    jplat.reset_fault_injection()


def same(a, b, path="result"):
    """Exact equality of two result trees; numpy arrays by dtype and
    value."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            (path, sorted(set(a) ^ set(b)))
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), (path, a, b)


# -- the batched classifier ---------------------------------------------------

def _bucket(e, b, rng, density):
    """(ww, wr, rw) float32 0/1 stacks, each entry set with probability
    density / e, no self-loops (the classifier never sees them)."""
    mats = []
    for _ in range(3):
        m = (rng.random((b, e, e)) < density / e).astype(np.float32)
        m[:, np.arange(e), np.arange(e)] = 0.0
        mats.append(m)
    return tuple(mats)


@pytest.mark.parametrize("e,b,density,seed", [
    (8, 16, 0.3, 1), (8, 8, 0.3, 4), (16, 8, 0.3, 1), (32, 4, 0.4, 3),
    (64, 4, 0.3, 3), (64, 2, 0.3, 0)])
def test_classifier_flags_match_jax_and_the_mirror(e, b, density, seed,
                                                   clean_faults):
    buckets = {e: _bucket(e, b, np.random.default_rng(seed), density)}
    got = tk._classify_batches(buckets, device=CPU)
    want = jk._classify_batches(buckets)
    mirror = tk._classify_batches_host(buckets)
    for g, w, m in zip(got[e], want[e], mirror[e]):
        assert g.dtype == np.bool_ and np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, m)
    # the density leaves some flags set and some clear
    every = np.concatenate(got[e])
    assert every.any() and not every.all()
    # residues: zero on both sides
    steps = tk._steps(e)
    *_, res = tk._flags_batch(*(torch.from_numpy(x) for x in buckets[e]),
                              steps)
    assert res.dtype == torch.int64 and res.tolist() == [0] * b
    *_, jres = jk._flags_batch_fn(e, steps)(*buckets[e])
    assert np.asarray(jres).tolist() == [0] * b


def test_classifier_runs_several_buckets_in_size_order(clean_faults):
    rng = np.random.default_rng(9)
    buckets = {32: _bucket(32, 2, rng, 1.5), 8: _bucket(8, 4, rng, 1.5)}
    before = tk.LAUNCHES
    got = tk._classify_batches(buckets, device=CPU)
    assert tk.LAUNCHES == before + 2 and list(got) == [8, 32]
    want = jk._classify_batches(buckets)
    for e in buckets:
        for g, w in zip(got[e], want[e]):
            assert np.array_equal(g, np.asarray(w))


def test_residue_catches_a_corrupted_product(monkeypatch):
    """The column checksum is live: a product that comes back with one
    entry off by one leaves a nonzero residue in that block only."""
    buckets = _bucket(16, 2, np.random.default_rng(3), 2.0)
    real = torch.bmm

    def off_by_one(a, b):
        out = real(a, b)
        out[1, 0, 0] += 1.0
        return out

    monkeypatch.setattr(torch, "bmm", off_by_one)
    *_, res = tk._flags_batch(*(torch.from_numpy(x) for x in buckets),
                              tk._steps(16))
    assert res[0] == 0 and res[1] > 0


# -- analyze_edges over the adversarial corpus --------------------------------

def _edges(edge_list):
    edges = {}
    for i, j, t in edge_list:
        edges.setdefault((i, j), set()).add(t)
    return edges


def _ring(n, rw_at=()):
    return [(k, (k + 1) % n, "rw" if k in rw_at else "ww")
            for k in range(n)]


def _figure_eight_rings():
    edges = [(k, (k + 1) % 32, "rw" if k == 5 else "ww") for k in range(32)]
    ring2 = [0] + list(range(32, 63))
    for ix, v in enumerate(ring2):
        edges.append((v, ring2[(ix + 1) % len(ring2)],
                      "rw" if ix == 7 else "ww"))
    return edges


def _flower(petals):
    out = []
    for k in range(1, petals + 1):
        out += [(0, k, "rw"), (k, 0, "ww")]
    return out


def _ladder(rungs):
    out = []
    for k in range(rungs):
        out += [(k, k + 1, "rw"), (k + 1, k, "ww")]
    return out


CORPUS = {
    "figure-eight": (3, [(0, 1, "rw"), (1, 0, "ww"), (1, 2, "rw"),
                         (2, 1, "ww")], {}),
    "figure-eight-wr": (4, [(0, 1, "rw"), (1, 2, "wr"), (2, 0, "ww"),
                            (2, 3, "rw"), (3, 2, "ww")], {}),
    "flower": (4, _flower(3), {}),
    "chained-figure-eights": (6, _ladder(5), {}),
    "two-rw-g2": (4, [(0, 1, "rw"), (1, 2, "ww"), (2, 3, "rw"),
                      (3, 0, "ww")], {}),
    "g2-with-petal": (5, [(0, 1, "rw"), (1, 2, "ww"), (2, 3, "rw"),
                          (3, 0, "ww"), (0, 4, "rw"), (4, 0, "wr")], {}),
    "adjacent-double-rw": (2, [(0, 1, "rw"), (1, 0, "rw")], {}),
    "ww-cycle": (2, [(0, 1, "ww"), (1, 0, "ww")], {}),
    "wr-cycle": (2, [(0, 1, "wr"), (1, 0, "ww")], {}),
    "g1c-and-g-single": (5, [(0, 1, "wr"), (1, 0, "ww"), (2, 3, "rw"),
                             (3, 2, "ww")], {}),
    "oversized-ww-ring": (64, _ring(64), {"max_dense": 8}),
    "oversized-one-rw-ring": (64, _ring(64, {10}), {"max_dense": 8}),
    "oversized-two-rw-ring": (64, _ring(64, {10, 40}), {"max_dense": 8}),
    "oversized-figure-eight": (63, _figure_eight_rings(), {"max_dense": 8}),
    "dense-figure-eight-rings": (63, _figure_eight_rings(), {}),
    "rings-mixed-sizes": (
        100, _ring(9) + [(9 + i, 9 + (i + 1) % 20, "rw" if i == 3 else "ww")
                         for i in range(20)]
        + [(29 + i, 29 + (i + 1) % 40, "rw" if i in (2, 30) else "ww")
           for i in range(40)], {}),
    "acyclic": (4, [(0, 1, "ww"), (1, 2, "wr"), (2, 3, "rw")], {}),
}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_analyze_edges_matches_jax_on_the_corpus(name, clean_faults):
    n, edge_list, kw = CORPUS[name]
    got = tk.analyze_edges(n, _edges(edge_list), device=CPU, **kw)
    want = jk.analyze_edges(n, _edges(edge_list), **kw)
    same(got, want)


@pytest.mark.parametrize("seed", range(12))
def test_analyze_edges_matches_jax_on_random_graphs(seed, clean_faults):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 14))
    m = int(rng.integers(n, 3 * n))
    edge_list = []
    for _ in range(m):
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        t = ("ww", "wr", "rw")[int(rng.integers(0, 3))]
        edge_list.append((int(i), int(j), t))
    flags = {}
    for max_dense in (4096, 2):
        got = tk.analyze_edges(n, _edges(edge_list), device=CPU,
                               max_dense=max_dense)
        same(got, jk.analyze_edges(n, _edges(edge_list),
                                   max_dense=max_dense))
        flags[max_dense] = _flags(got)
    # the dense classifier and the oversized path's probes agree
    assert flags[4096] == flags[2]


PRECEDENCE = {
    "realtime-only": (2, {(0, 1): frozenset({"realtime"}),
                          (1, 0): frozenset({"rw"})}),
    "process-subsumed": (2, {(0, 1): frozenset({"ww"}),
                             (1, 0): frozenset({"ww", "process"})}),
    "per-scc": (4, {(0, 1): frozenset({"ww"}), (1, 0): frozenset({"ww"}),
                    (2, 3): frozenset({"ww"}),
                    (3, 2): frozenset({"process"})}),
    "realtime-folds-process": (3, {(0, 1): frozenset({"process"}),
                                   (1, 2): frozenset({"realtime"}),
                                   (2, 0): frozenset({"ww"})}),
    "g2-variant": (3, {(0, 1): frozenset({"rw"}),
                       (1, 2): frozenset({"process"}),
                       (2, 0): frozenset({"rw"})}),
}


@pytest.mark.parametrize("name", sorted(PRECEDENCE))
def test_analyze_edges_matches_jax_on_precedence_levels(name, clean_faults):
    n, edges = PRECEDENCE[name]
    same(tk.analyze_edges(n, dict(edges), device=CPU),
         jk.analyze_edges(n, dict(edges)))


@pytest.mark.parametrize("edge_list", [
    [(0, 0, "ww")], [(1, 1, "wr"), (0, 1, "ww")], [(2, 2, "rw")],
    [(0, 0, "process")], [(0, 0, "realtime")],
    [(0, 0, "ww"), (0, 1, "rw"), (1, 0, "ww"), (3, 3, "rw")],
])
def test_analyze_edges_matches_jax_on_self_loops(edge_list, clean_faults):
    n = 4
    same(tk.analyze_edges(n, _edges(edge_list), device=CPU),
         jk.analyze_edges(n, _edges(edge_list)))


def test_analyze_graph_and_empty_inputs_match_jax(clean_faults):
    rng = np.random.default_rng(5)
    ww, wr, rw = (rng.random((12, 12)) < 0.12 for _ in range(3))
    same(tk.analyze_graph(ww, wr, rw, device=CPU),
         jk.analyze_graph(ww, wr, rw))
    same(tk.analyze_edges(0, {}, device=CPU), jk.analyze_edges(0, {}))
    same(tk.analyze_edges(5, {}, device=CPU), jk.analyze_edges(5, {}))


# -- transitive_closure -------------------------------------------------------

@pytest.mark.parametrize("n,p,seed", [(1, 0.0, 0), (3, 0.4, 1),
                                      (10, 0.15, 2), (130, 0.01, 3)])
def test_transitive_closure_matches_jax(n, p, seed):
    adj = np.random.default_rng(seed).random((n, n)) < p
    got = tk.transitive_closure(adj, device=CPU)
    assert got.dtype == np.bool_
    assert np.array_equal(got, jk.transitive_closure(adj))
    assert tk.transitive_closure(np.zeros((0, 0), bool),
                                 device=CPU).shape == (0, 0)


# -- the synth transaction generators -----------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("append_history", dict(n_txns=400)),
    ("append_history", dict(n_txns=300, concurrency=3, active_keys=2,
                            max_txn_len=6, appends_per_key=4, seed=9)),
    ("wr_history", dict(n_txns=400)),
    ("wr_history", dict(n_txns=300, concurrency=7, writes_per_key=3,
                        seed=2)),
])
def test_synth_transaction_generators_match_jax(name, kw):
    t, j = getattr(tsynth, name)(**kw), getattr(jsynth, name)(**kw)
    assert t.ops == j.ops
    if name == "append_history":
        for args in ((5, "G1c"), (3, "G-single", 11, 2 * 10 ** 9)):
            assert tsynth.inject_append_cycles(t, *args).ops == \
                jsynth.inject_append_cycles(j, *args).ops


# -- list_append.check and wr.check -------------------------------------------

def _ok(process, txn, t):
    return [{"type": "invoke", "f": "txn", "value": txn, "process": process,
             "time": t},
            {"type": "ok", "f": "txn", "value": txn, "process": process,
             "time": t + 1}]


def _fail(process, txn, t):
    return [{"type": "invoke", "f": "txn", "value": txn, "process": process,
             "time": t},
            {"type": "fail", "f": "txn", "value": txn, "process": process,
             "time": t + 1}]


def _info(process, txn, t):
    return [{"type": "invoke", "f": "txn", "value": txn, "process": process,
             "time": t},
            {"type": "info", "f": "txn", "value": txn, "process": process,
             "time": t + 1}]


def _append_synth(kind):
    h = jsynth.append_history(500, seed=31)
    if kind == "g1c":
        return jsynth.inject_append_cycles(h, 20, "G1c").ops
    if kind == "mixed":
        h = jsynth.inject_append_cycles(h, 6, "G1c")
        return jsynth.inject_append_cycles(h, 6, "G-single", seed=11,
                                           key_base=2 * 10 ** 9).ops
    return h.ops


APPEND = {
    "valid-500": lambda: _append_synth("valid"),
    "g1c-500-x20": lambda: _append_synth("g1c"),
    "mixed-500": lambda: _append_synth("mixed"),
    "g0": lambda: (_ok(0, [["append", "x", 1], ["append", "y", 2]], 0)
                   + _ok(1, [["append", "x", 2], ["append", "y", 1]], 2)
                   + _ok(2, [["r", "x", [1, 2]]], 4)
                   + _ok(3, [["r", "y", [1, 2]]], 6)),
    "g1a": lambda: (_fail(0, [["append", "x", 1]], 0)
                    + _ok(1, [["r", "x", [1]]], 2)),
    "g1b": lambda: (_ok(0, [["append", "x", 1], ["append", "x", 2]], 0)
                    + _ok(1, [["r", "x", [1]]], 2)),
    "duplicates": lambda: (_ok(0, [["append", "x", 1]], 0)
                           + _ok(1, [["append", "x", 1]], 2)),
    "incompatible-order": lambda: (_ok(0, [["r", "x", [1, 2]]], 0)
                                   + _ok(1, [["r", "x", [1, 3]]], 2)),
    "internal": lambda: _ok(0, [["append", "x", 5], ["r", "x", []]], 0),
    "g-single": lambda: (_ok(0, [["append", "x", 1], ["append", "y", 1]], 0)
                         + _ok(1, [["r", "x", [1]], ["r", "y", []]], 2)),
    "realtime-only": lambda: (_ok(0, [["append", "x", 1]], 0)
                              + _ok(1, [["r", "x", []]], 2)),
    "process-only": lambda: (_ok(0, [["append", "x", 1]], 0)
                             + _ok(0, [["r", "x", []]], 2)),
    "info-and-nemesis": lambda: (
        _ok(0, [["append", "x", 1]], 0)
        + _info(1, [["append", "x", 2]], 2)
        + [{"type": "info", "f": "start", "value": None,
            "process": "nemesis", "time": 3}]
        + _ok(2, [["r", "x", [1, 2]], ["append", "y", 1]], 4)
        + _ok(3, [["r", "y", []], ["r", "x", [1]]], 6)),
}

GRAPHS = [(), ("realtime",), ("process",), ("realtime", "process")]


@pytest.mark.parametrize("graphs", GRAPHS, ids=lambda g: "+".join(g) or "base")
@pytest.mark.parametrize("name", sorted(APPEND))
def test_list_append_check_matches_jax(name, graphs, clean_faults):
    ops = APPEND[name]()
    got = tla.check(thistory(ops), device=CPU, additional_graphs=graphs)
    want = jla.check(jhistory(ops), additional_graphs=graphs)
    same(got, want)


WR = {
    "valid-500": lambda: jsynth.wr_history(500, seed=17).ops,
    "valid": lambda: (_ok(0, [["w", "x", 1]], 0) + _ok(1, [["r", "x", 1]], 2)
                      + _ok(0, [["w", "x", 2]], 4)
                      + _ok(1, [["r", "x", 2]], 6)),
    "g1c": lambda: (_ok(0, [["w", "x", 1], ["r", "y", 1]], 0)
                    + _ok(1, [["w", "y", 1], ["r", "x", 1]], 2)),
    "g-single": lambda: (_ok(0, [["w", "x", 1], ["w", "y", 1]], 0)
                         + _ok(1, [["r", "y", 1], ["r", "x", None]], 2)),
    "g1a": lambda: _fail(0, [["w", "x", 9]], 0) + _ok(1, [["r", "x", 9]], 2),
    "g1b": lambda: (_ok(0, [["w", "x", 1], ["w", "x", 2]], 0)
                    + _ok(1, [["r", "x", 1]], 2)),
    "internal": lambda: _ok(0, [["w", "x", 1], ["r", "x", 2]], 0),
    "duplicates": lambda: (_ok(0, [["w", "x", 1]], 0)
                           + _ok(1, [["w", "x", 1]], 2)),
    "ww-from-intra-txn": lambda: (
        _ok(0, [["w", "x", 1], ["r", "y", 2]], 0)
        + _ok(1, [["r", "x", 1], ["w", "x", 9], ["w", "y", 2]], 2)),
    "g2-beside-g1c": lambda: (_ok(0, [["w", "a", 1], ["r", "b", 1]], 0)
                              + _ok(1, [["w", "b", 1], ["r", "a", 1]], 2)
                              + _ok(2, [["w", "x", 1], ["r", "y", None]], 4)
                              + _ok(3, [["w", "y", 1], ["r", "x", None]], 6)),
    "g0-realtime": lambda: (_ok(0, [["r", "x", 1], ["w", "x", 2]], 0)
                            + _ok(1, [["w", "x", 1]], 2)),
    "stale-read": lambda: _ok(0, [["w", "x", 1]], 0) + _ok(0, [["r", "x", None]],
                                                          2),
}


@pytest.mark.parametrize("graphs", GRAPHS, ids=lambda g: "+".join(g) or "base")
@pytest.mark.parametrize("name", sorted(WR))
def test_wr_check_matches_jax(name, graphs, clean_faults):
    ops = WR[name]()
    got = twr.check(thistory(ops), device=CPU, additional_graphs=graphs)
    want = jwr.check(jhistory(ops), additional_graphs=graphs)
    same(got, want)


def test_anomaly_selection_matches_jax(clean_faults):
    ops = APPEND["g-single"]()
    for anomalies in (("G1a", "G1b", "G1c"), ("G-single",), ()):
        same(tla.check(thistory(ops), anomalies, device=CPU),
             jla.check(jhistory(ops), anomalies))
    ops = WR["g2-beside-g1c"]()
    same(twr.check(thistory(ops), ("G-single", "G2-item"), device=CPU),
         jwr.check(jhistory(ops), ("G-single", "G2-item")))


def test_valid_history_makes_no_classifier_call(clean_faults):
    h = tsynth.append_history(2000, seed=3)
    before = tk.LAUNCHES
    assert tla.check(h, device=CPU)["valid?"] is True
    assert twr.check(tsynth.wr_history(1000, seed=3), device=CPU,
                     additional_graphs=("realtime", "process"))[
        "valid?"] is True
    assert tk.LAUNCHES == before


# -- the adapters through check_safe -----------------------------------------

@pytest.mark.parametrize("which,name,graphs", [
    ("append", "g1c-500-x20", ()), ("append", "realtime-only", ("realtime",)),
    ("append", "valid-500", ()), ("wr", "g2-beside-g1c", ()),
    ("wr", "stale-read", ("process",)), ("wr", "valid-500", ())])
def test_adapters_through_check_safe_match_jax(which, name, graphs,
                                               clean_faults):
    ops = (APPEND if which == "append" else WR)[name]()
    if which == "append":
        t = ListAppendChecker(additional_graphs=graphs, device=CPU)
        j = JListAppend(additional_graphs=graphs)
    else:
        t = RWRegisterChecker(additional_graphs=graphs, device=CPU)
        j = JRWRegister(additional_graphs=graphs)
    same(tcheck_safe(t, {}, ops), jcheck_safe(j, {}, ops))
    factory = list_append_checker if which == "append" \
        else rw_register_checker
    same(factory(("G1",), additional_graphs=graphs, device=CPU).check(
        {}, thistory(ops), {}),
        (JListAppend if which == "append" else JRWRegister)(
            ("G1",), additional_graphs=graphs).check({}, jhistory(ops), {}))


def test_rw_register_full_tier_and_graphs_at_screen_tier_match_jax(
        clean_faults):
    ops = WR["stale-read"]()
    for tier in (None, 0, "full"):
        same(RWRegisterChecker(device=CPU).check({"tier": tier}, ops, {}),
             JRWRegister().check({"tier": tier}, ops, {}))
    # with precedence graphs the JAX adapter runs the full search at
    # the screen tier too, and so does the port
    same(RWRegisterChecker(additional_graphs=("process",), device=CPU)
         .check({"tier": "screen"}, ops, {}),
         JRWRegister(additional_graphs=("process",))
         .check({"tier": "screen"}, ops, {}))


def test_mesh_and_screen_tier_raise(clean_faults):
    """A mesh is accepted (tests/test_torch_sharded.py runs it); an
    object that is not one raises TypeError naming the expected type."""
    ops = WR["valid"]()
    one = parallel.local_mesh(CPU)
    same(tk.analyze_edges(2, {(0, 1): {"ww"}, (1, 0): {"ww"}}, mesh=one,
                          device=CPU),
         tk.analyze_edges(2, {(0, 1): {"ww"}, (1, 0): {"ww"}}, device=CPU))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tk.analyze_edges(2, {(0, 1): {"ww"}}, mesh=object(), device=CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tk.transitive_closure(np.zeros((2, 2), bool), mesh=object(),
                              device=CPU)
    for fn, h in ((tla.check, tsynth.append_history(60, seed=2)),
                  (twr.check, thistory(ops))):
        with pytest.raises(TypeError, match="DeviceMesh"):
            fn(h, mesh=object(), device=CPU)
        assert fn(h, mesh=one, device=CPU)["valid?"] is True
    for cls in (ListAppendChecker, RWRegisterChecker):
        with pytest.raises(TypeError, match="DeviceMesh"):
            cls(mesh=object(), device=CPU)
        assert cls(mesh=one, device=CPU).mesh is one
    # the screen tier no longer raises: it is the JAX package's screen
    # (its result dict, duration aside), escalating when sampled
    for tier in ("screen", 1, "1"):
        for sample in (0, 1):
            test = {"tier": tier, "screen-sample": sample}
            t = RWRegisterChecker(device=CPU).check(test, ops, {})
            j = JRWRegister().check(test, jhistory(ops), {})
            assert t["tier"] == j["tier"] == 1
            assert ("escalated" in t) is ("escalated" in j) is (sample == 1)
            assert {k: v for k, v in t.items() if k != "duration-ms"} == \
                {k: v for k, v in j.items() if k != "duration-ms"}


def test_entries_default_to_cuda_and_raise_without_it(clean_faults):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    ops = thistory(WR["valid"]())
    for call in (lambda: tla.check(ops), lambda: twr.check(ops),
                 lambda: tk.analyze_edges(2, {(0, 1): {"ww"}}),
                 lambda: tk.analyze_edges(0, {}),
                 lambda: tk.transitive_closure(np.eye(2, dtype=bool)),
                 lambda: ListAppendChecker().check({}, ops, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -- the 'elle' fault-injection site ------------------------------------------

_CYCLE = {(0, 1): frozenset({"ww"}), (1, 2): frozenset({"wr"}),
          (2, 0): frozenset({"rw"}), (3, 4): frozenset({"rw"}),
          (4, 3): frozenset({"rw"})}


def _flags(out):
    return {k: out[k] for k in _FLAG_KEYS}


@pytest.mark.parametrize("spec,launches", [("bitflip@elle:1", 2),
                                           ("oom@elle:1", 1),
                                           ("wedged@elle:1", 1),
                                           ("device-lost@elle:1", 1)])
def test_one_injected_fault_retries_once_with_the_same_flags(
        spec, launches, clean_faults):
    mp = clean_faults
    base = tk.analyze_edges(5, dict(_CYCLE), device=CPU)
    jbase = jk.analyze_edges(5, dict(_CYCLE))
    mp.setenv(tplat.FAULT_INJECT_ENV, spec)
    tplat.reset_fault_injection()
    hits = []
    mp.setattr(tplat, "corrupt_hook",
               lambda site, arr: hits.append(site) or None)
    before = tk.LAUNCHES
    got = tk.analyze_edges(5, dict(_CYCLE), device=CPU)
    assert tk.LAUNCHES == before + launches
    # a dispatch fault fires before staging, so only the retry stages
    assert hits == ["elle"] * launches
    same(got, base)
    jplat.reset_fault_injection()
    jgot = jk.analyze_edges(5, dict(_CYCLE))
    assert _flags(jgot) == _flags(jbase) == _flags(got)
    # the check around it decides as the JAX package's does
    ops = APPEND["g1c-500-x20"]()
    tplat.reset_fault_injection()
    jplat.reset_fault_injection()
    same(tla.check(thistory(ops), device=CPU), jla.check(jhistory(ops)))


def test_two_faults_in_a_row_raise_where_jax_decides_on_its_mirror(
        clean_faults):
    """The fourth deliberate difference: after its one retry the port
    raises the classified fault, naming the trail; the JAX package
    decides the bucket on its numpy mirror."""
    mp = clean_faults
    mp.setenv(tplat.FAULT_INJECT_ENV, "oom@elle:1,oom@elle:2")
    tplat.reset_fault_injection()
    with pytest.raises(tk.ClassifierFaulted) as ei:
        tk.analyze_edges(5, dict(_CYCLE), device=CPU)
    assert ei.value.kind == "oom" and ei.value.faults == ["oom", "oom"]
    assert tplat.classify_backend_error(ei.value) == "oom"
    assert "['oom', 'oom']" in str(ei.value)
    jplat.reset_fault_injection()
    jgot = jk.analyze_edges(5, dict(_CYCLE))
    mp.delenv(tplat.FAULT_INJECT_ENV)
    assert _flags(jgot) == _flags(tk.analyze_edges(5, dict(_CYCLE),
                                                   device=CPU))
    # through the adapter: a degraded 'unknown' naming the fault
    mp.setenv(tplat.FAULT_INJECT_ENV, "device-lost@elle:1,oom@elle:2")
    tplat.reset_fault_injection()
    r = tcheck_safe(ListAppendChecker(device=CPU), {}, APPEND["g0"]())
    assert r["valid?"] == "unknown" and r["degraded"] is True
    assert r["fault"] == "oom" and "['device-lost', 'oom']" in r["error"]


def test_persistent_corruption_raises_where_jax_takes_its_mirror(
        clean_faults):
    mp = clean_faults
    mp.setattr(tplat, "corrupt_hook",
               lambda site, arr: tplat.flip_bit(arr) if site == "elle"
               else None)
    mp.setattr(jplat, "corrupt_hook",
               lambda site, arr: jplat.flip_bit(arr) if site == "elle"
               else None)
    with pytest.raises(tk.ClassifierFaulted) as ei:
        tk.analyze_edges(5, dict(_CYCLE), device=CPU)
    assert ei.value.faults == ["corrupt", "corrupt"]
    assert "staged-buffer digest" in str(ei.value)
    jgot = jk.analyze_edges(5, dict(_CYCLE))
    mp.setattr(tplat, "corrupt_hook", None)
    assert _flags(jgot) == _flags(tk.analyze_edges(5, dict(_CYCLE),
                                                   device=CPU))


def test_attestation_off_skips_the_digests(clean_faults):
    """JEPSEN_TPU_ATTEST=0: a flipped staged bit goes unseen, so the
    bucket is classified once, with no retry."""
    mp = clean_faults
    mp.setenv(tplat.ATTEST_ENV, "0")
    mp.setenv(tplat.FAULT_INJECT_ENV, "bitflip@elle:1")
    tplat.reset_fault_injection()
    before = tk.LAUNCHES
    tk.analyze_edges(5, dict(_CYCLE), device=CPU)
    assert tk.LAUNCHES == before + 1


def test_an_ordinary_bug_is_not_retried(clean_faults, monkeypatch):
    def broken(*a):
        raise RuntimeError("shape mismatch in the port's own code")

    monkeypatch.setattr(tk, "_flags_batch", broken)
    before = tk.LAUNCHES
    with pytest.raises(RuntimeError, match="shape mismatch"):
        tk.analyze_edges(5, dict(_CYCLE), device=CPU)
    assert tk.LAUNCHES == before + 1


def test_elle_staging_digests_and_bitflip_match_jax(clean_faults):
    """The 'elle' site's staged float32 stacks: the same bit flipped by
    the same clause, and the same digests, host and device, as the JAX
    package's."""
    from jepsen_tpu.checker import abft as jabft
    from jepsen_tpu_torch.checker import abft as tabft

    mp = clean_faults
    ww, *_ = _bucket(8, 4, np.random.default_rng(2), 1.0)
    mp.setenv(tplat.FAULT_INJECT_ENV, "bitflip@elle:2")
    tplat.reset_fault_injection()
    jplat.reset_fault_injection()
    assert tplat.maybe_corrupt("elle", ww) is ww
    assert jplat.maybe_corrupt("elle", ww) is ww
    t, j = tplat.maybe_corrupt("elle", ww), jplat.maybe_corrupt("elle", ww)
    assert t.dtype == j.dtype == np.float32
    assert np.array_equal(t.view(np.uint32), j.view(np.uint32))
    assert not np.array_equal(t, ww)
    for x in (ww, t):
        want = jabft.digest_host(x)
        assert tabft.digest_host(x) == want
        assert int(tabft.digest_device(torch.from_numpy(x))) == want
    assert tabft.digest_host(t) != tabft.digest_host(ww)
