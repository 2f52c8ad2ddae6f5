"""The port's three workloads (`workloads.linearizable_register`,
`append`, `wr`) against the JAX package's: under a fixed generator seed
they generate the same ops, their checkers give the same results on the
same histories, and each runs end to end through the port's `core.run`
with an in-process client, its stored history judged alike by both
packages' checkers."""

import threading

import pytest
import torch

from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jind
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.generator import simulate as jsim
from jepsen_tpu.history import history as jhistory
from jepsen_tpu.workloads import append as jappend
from jepsen_tpu.workloads import linearizable_register as jlr
from jepsen_tpu.workloads import wr as jwr
from jepsen_tpu_torch import client as tclient
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import testkit as ttestkit
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.generator import simulate as tsim
from jepsen_tpu_torch.history import history as thistory
from jepsen_tpu_torch.workloads import append as tappend
from jepsen_tpu_torch.workloads import linearizable_register as tlr
from jepsen_tpu_torch.workloads import wr as twr

JAX = dict(gen=jgen, sim=jsim, ind=jind, history=jhistory, synth=jsynth,
           register=lambda o: jlr.test(o),
           append=lambda o: jappend.workload(o),
           wr=lambda o: jwr.workload(o))
PORT = dict(gen=tgen, sim=tsim, ind=tind, history=thistory, synth=tsynth,
            register=lambda o: tlr.test({**o, "device": "cpu"}),
            append=lambda o: tappend.workload({**o, "device": "cpu"}),
            wr=lambda o: twr.workload({**o, "device": "cpu"}))

WORKLOADS = [
    ("register", {"per-key-limit": 30}),
    ("register", {"per-key-limit": 8, "nodes": ["a", "b", "c"]}),
    ("append", {}),
    ("append", {"key-count": 3, "max-txn-length": 6}),
    ("wr", {}),
    ("wr", {"key-count": 2, "max-writes-per-key": 4}),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _generated(pkg, name, opts, seed):
    gen, sim = pkg["gen"], pkg["sim"]
    with gen.fixed_rng(seed):
        w = pkg[name](opts)
        return sim.quick(sim.n_plus_nemesis_context(30),
                         gen.limit(200, w["generator"]))


@pytest.mark.parametrize("name,opts", WORKLOADS)
@pytest.mark.parametrize("seed", [45100, 3])
def test_workload_generates_the_jax_packages_ops(name, opts, seed):
    t = _generated(PORT, name, opts, seed)
    j = _generated(JAX, name, opts, seed)
    assert len(t) == 200
    assert t == j


def _keyed_ops(ind, corrupt_keys=(2,)):
    """Six keys' register histories composed by time, some corrupted."""
    ops = []
    for k in range(6):
        h = tsynth.register_history(40, concurrency=3, values=4,
                                    crash_rate=0.03, seed=70 + k)
        if k in corrupt_keys:
            h = tsynth.corrupt(h, seed=k, value=4)
        for o in h.ops:
            o = dict(o)
            o["process"] = o["process"] + 10 * k
            o["value"] = ind.ktuple(k, o["value"])
            o["time"] = o["time"] * 6 + k
            ops.append(o)
    ops.sort(key=lambda o: o["time"])
    return ops


def _register_check(pkg, ops):
    return pkg["register"]({})["checker"].check(
        {}, pkg["history"](ops), {})


def _same_keyed_results(t, j):
    assert (t["valid?"], t["failures"], list(t["results"])) == \
        (j["valid?"], j["failures"], list(j["results"]))
    for k in t["results"]:
        a, b = t["results"][k], j["results"][k]
        assert (a["valid?"], a.get("op-index")) == \
            (b["valid?"], b.get("op-index")), k


@pytest.mark.parametrize("corrupt_keys", [(), (2,), (0, 5)])
def test_register_checker_matches_the_jax_package(corrupt_keys):
    t = _register_check(PORT, _keyed_ops(tind, corrupt_keys))
    j = _register_check(JAX, _keyed_ops(jind, corrupt_keys))
    _same_keyed_results(t, j)
    assert sorted(t["failures"]) == sorted(corrupt_keys)
    assert all(r["analyzer"] == "gpu-wgl-batch"
               for r in t["results"].values())


TXN_HISTORIES = [
    ("append", lambda s: s.append_history(200, concurrency=5, seed=4)),
    ("append", lambda s: s.inject_append_cycles(
        s.append_history(200, concurrency=5, seed=4), 2, "G1c")),
    ("wr", lambda s: s.wr_history(200, concurrency=5, seed=9)),
]


@pytest.mark.parametrize("name,make", TXN_HISTORIES)
def test_elle_checkers_match_the_jax_package(name, make):
    t = PORT[name]({})["checker"].check(
        {}, thistory(make(tsynth).ops), {})
    j = JAX[name]({})["checker"].check(
        {}, jhistory(make(jsynth).ops), {})
    assert t == j


class _TxnClient(tclient.Client):
    """A serializable in-process store: each transaction runs whole
    under one lock, over lists (append) or registers (wr)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.data = {}

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        out = []
        with self.lock:
            for f, k, v in op["value"]:
                if f == "append":
                    self.data.setdefault(k, []).append(v)
                    out.append([f, k, v])
                elif f == "w":
                    self.data[k] = v
                    out.append([f, k, v])
                else:
                    seen = self.data.get(k)
                    out.append([f, k, list(seen) if isinstance(
                        seen, list) else seen])
        return {**op, "type": "ok", "value": out}

    def reusable(self, test):
        return True


@pytest.mark.parametrize("name", ["append", "wr"])
def test_elle_workload_runs_end_to_end(tmp_path, name):
    with tgen.fixed_rng(11):
        w = PORT[name]({})
        t = ttestkit.noop_test()
        t.update({"name": name, "ssh": {"dummy": True},
                  "store-dir": str(tmp_path), "concurrency": 5,
                  "client": _TxnClient(), "checker": w["checker"],
                  "generator": tgen.clients(tgen.limit(150,
                                                       w["generator"]))})
        done = tcore.run(t)
    assert done["results"]["valid?"] is True
    stored = tstore.load_history(done)
    assert len(stored) == 300
    t_res = PORT[name]({})["checker"].check({}, thistory(stored.ops), {})
    j_res = JAX[name]({})["checker"].check({}, jhistory(stored.ops), {})
    assert t_res == j_res == done["results"]
