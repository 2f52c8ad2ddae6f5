"""The port's `core.run`: every case of tests/test_core.py, run on the
port; then the port against the JAX package on the same runs. Under one
worker and a fixed generator seed both packages produce the same history
op for op (all but `time`), and the stored history of a run at
concurrency 10 gets the same verdicts from both packages' checkers."""

import pytest
import torch

import torch_mirror
from jepsen_tpu import core as jcore
from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jind
from jepsen_tpu import store as jstore
from jepsen_tpu import testkit as jtestkit
from jepsen_tpu.checker.linear import linearizable as jlinearizable
from jepsen_tpu.models import cas_register as jcas
from jepsen_tpu.workloads import linearizable_register as jlr
from jepsen_tpu_torch import client as tclient
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import testkit as ttestkit
from jepsen_tpu_torch.checker.linear import linearizable as tlinearizable
from jepsen_tpu_torch.models import cas_register as tcas
from jepsen_tpu_torch.workloads import linearizable_register as tlr

globals().update(torch_mirror.cases("test_core"))

JAX = dict(core=jcore, gen=jgen, testkit=jtestkit, lr=jlr)
PORT = dict(core=tcore, gen=tgen, testkit=ttestkit, lr=tlr)


@pytest.fixture
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _when_free(gen, g):
    """g, asked only when a process is free. The interpreter asks its
    generator for an op whenever no completion is waiting; a random
    generator asked while its one worker is busy still draws from the
    rng before it finds no free process (it answers PENDING), and how
    often that happens depends on the host's timing, in both packages
    (ROADMAP F7). This wrapper answers PENDING without asking g, so the
    draws follow the ops alone."""

    class WhenFree(gen.Gen):
        def __init__(self, g):
            self.g = g

        def op(self, test, ctx):
            if not gen.free_processes(ctx):
                return gen.PENDING, self
            res = gen.op(self.g, test, ctx)
            return None if res is None else (res[0], WhenFree(res[1]))

        def update(self, test, ctx, event):
            return WhenFree(gen.update(self.g, test, ctx, event))

    return WhenFree(g)


def _single_register_run(pkg, store_dir, seed, n=200):
    """One worker, no nemesis, latency 0: the register workload's
    read/write/cas mix against an atom register."""
    gen, testkit, lr = pkg["gen"], pkg["testkit"], pkg["lr"]
    state = testkit.AtomState(None)
    t = testkit.noop_test()
    # `mix` draws its first pick when it is built: build it pinned too
    with gen.fixed_rng(seed):
        t.update({"name": "determinism", "ssh": {"dummy": True},
                  "store-dir": str(store_dir), "concurrency": 1,
                  "db": testkit.atom_db(state),
                  "client": testkit.atom_client(state, latency_s=0.0),
                  "generator": gen.clients(_when_free(gen, gen.limit(
                      n, gen.mix([lr.r, lr.w, lr.cas]))))})
        return pkg["core"].run(t)


@pytest.mark.parametrize("seed", [45100, 7])
def test_one_worker_history_equals_the_jax_run_op_for_op(tmp_path, seed):
    port = _single_register_run(PORT, tmp_path / "port", seed)
    ref = _single_register_run(JAX, tmp_path / "jax", seed)

    def timeless(h):
        return [{k: v for k, v in o.items() if k != "time"} for o in h]

    assert len(port["history"]) == 400
    assert timeless(port["history"]) == timeless(ref["history"])
    assert port["results"] == ref["results"]
    # each package's store holds the run, and reads the other's
    assert timeless(jstore.load_history(port)) == \
        timeless(tstore.load_history(ref))


def _keyed_client(liar_key=None):
    """One atom register per key; `liar_key`'s reads return a value no
    one wrote."""

    class KeyedAtom(tclient.Client):
        def __init__(self):
            self.cells = {}

        def open(self, test, node):
            return self

        def invoke(self, test, op):
            k, v = op["value"].key, op["value"].value
            cell = self.cells.setdefault(k, ttestkit.AtomState(None))
            out = dict(op)
            if op["f"] == "write":
                cell.reset(v)
                out["type"] = "ok"
            elif op["f"] == "cas":
                out["type"] = "ok" if cell.cas(*v) else "fail"
            else:
                seen = cell.read()
                out["type"] = "ok"
                out["value"] = tind.ktuple(
                    k, 99 if k == liar_key and seen is not None else seen)
            return out

        def reusable(self, test):
            return True

    return KeyedAtom()


def _rekey(hist, ind):
    """The stored history's [key, value] lists as the package's KVs (the
    store writes a KV as a JSON list)."""
    out = []
    for o in hist:
        o = dict(o)
        if isinstance(o.get("value"), list):
            o["value"] = ind.ktuple(*o["value"])
        out.append(o)
    return out


def test_concurrency_10_run_gets_the_same_verdicts_from_both_checkers(
        tmp_path, _one_torch_thread):
    with tgen.fixed_rng(3):
        w = tlr.test({"per-key-limit": 20, "device": "cpu"})
        t = ttestkit.noop_test()
        t.update({"name": "keyed", "ssh": {"dummy": True},
                  "store-dir": str(tmp_path), "concurrency": 10,
                  "client": _keyed_client(liar_key=2),
                  "checker": w["checker"],
                  "generator": tgen.clients(tgen.limit(200,
                                                       w["generator"]))})
        done = tcore.run(t)
    run = done["results"]
    assert run["valid?"] is False and run["failures"] == [2]

    port = tind.checker(
        tlinearizable(tcas(), device="cpu")).check(
            {}, _rekey(tstore.load_history(done), tind), {})
    ref = jind.checker(jlinearizable(jcas())).check(
        {}, _rekey(jstore.load_history(done), jind), {})
    for a in (run, port):
        assert (a["valid?"], a["failures"], list(a["results"])) == \
            (ref["valid?"], ref["failures"], list(ref["results"]))
        for k, r in a["results"].items():
            b = ref["results"][k]
            assert (r["valid?"], r.get("op-index")) == \
                (b["valid?"], b.get("op-index")), k


def test_a_crashed_run_salvages_the_same_prefix_for_both_packages(
        tmp_path):
    """A generator that dies after 20 ops: the port's run leaves its
    journaled prefix as the stored history, and both packages'
    `load_test` read the same ops from it."""
    def ops():
        for i in range(20):
            yield {"f": "write", "value": i}
        raise RuntimeError("generator died")

    state = ttestkit.AtomState(None)
    t = ttestkit.noop_test()
    t.update({"name": "crashed", "ssh": {"dummy": True},
              "store-dir": str(tmp_path), "concurrency": 1,
              "client": ttestkit.atom_client(state, latency_s=0.0),
              "generator": tgen.clients(ops())})
    with pytest.raises(tgen.GenException):
        tcore.run(t)
    d = tstore.latest(str(tmp_path))
    port, ref = tstore.load_test(d), jstore.load_test(d)
    h = port["history"]
    # the last completion may not have landed before the crash
    assert len(h.invocations()) == 20
    assert len(h) + len(h.pending()) == 40
    assert list(port["history"]) == list(ref["history"])
    assert port["name"] == ref["name"] == "crashed"
