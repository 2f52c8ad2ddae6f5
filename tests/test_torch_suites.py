"""The port's suites against the JAX package's, side by side at a small
size: the etcd register, hazelcast cas-register and lock, and tidb
append maps, each built by its suite in both packages under one
generator seed at concurrency 1, with the map's time-limited generator
replaced by a `gen.limit` over the same workload, one op in flight at a
time, and no nemesis (etcd's register takes two threads per key, so it
runs two processes with one op in flight). Each run goes to a fresh
fake of the suite's data plane (tests/fake_etcd.py, `suites.cp_shim`,
tests/fake_mysql.py). The two histories are equal op for op (all fields
but `time`), and both packages' checkers give each stored history the
same result, the port's on the CPU. Last, `chip_smoke.py`'s phase 14
maps (the etcd and hazelcast suites' own, concurrency 10, a partition
nemesis) run at a small size on the CPU against their CPU-path check."""

import pytest
import torch

import chip_smoke
from fake_etcd import FakeEtcd
from fake_mysql import FakeMySQLServer

import jepsen_tpu.db as jdb
import jepsen_tpu.os_ as jos
from jepsen_tpu import core as jcore
from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jind
from jepsen_tpu import suites as jsuites
from jepsen_tpu import store as jstore
from jepsen_tpu.suites import cp_shim as jshim
from jepsen_tpu.suites import mysql_proto as jmysql

import jepsen_tpu_torch.db as tdb
import jepsen_tpu_torch.os_ as tos
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import suites as tsuites
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.suites import cp_shim as tshim
from jepsen_tpu_torch.suites import mysql_proto as tmysql

JAX = dict(core=jcore, gen=jgen, ind=jind, suites=jsuites, store=jstore,
           db=jdb, os_=jos, shim=jshim, mysql=jmysql, opts={})
PORT = dict(core=tcore, gen=tgen, ind=tind, suites=tsuites, store=tstore,
            db=tdb, os_=tos, shim=tshim, mysql=tmysql,
            opts={"device": "cpu"})


@pytest.fixture
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_at_a_time(gen, g):
    """g, asked only when every process is free: one op in flight at a
    time, so the history follows the ops alone. A random generator asked
    while a worker is busy would still draw from the rng as often as the
    host's timing asks it (ROADMAP F7; at one process this is
    tests/test_torch_core.py's `_when_free`)."""
    class OneAtATime(gen.Gen):
        def __init__(self, g):
            self.g = g

        def op(self, test, ctx):
            if len(gen.free_processes(ctx)) < len(gen.all_processes(ctx)):
                return gen.PENDING, self
            res = gen.op(self.g, test, ctx)
            return None if res is None else (res[0], OneAtATime(res[1]))

        def update(self, test, ctx, event):
            return OneAtATime(gen.update(self.g, test, ctx, event))

    return OneAtATime(g)


def _data_plane(pkg, suite):
    """A fresh data plane for one run: (wire options, stop)."""
    if suite == "etcd":
        f = FakeEtcd()
        url = f"http://127.0.0.1:{f.start()}"
        return {"client-url-fn": lambda node: url}, f.stop
    if suite == "hazelcast":
        server, port = pkg["shim"].serve()
        url = f"http://127.0.0.1:{port}"
        return {"shim-url-fn": lambda node: url}, server.shutdown
    f = FakeMySQLServer()
    conn = pkg["mysql"].Conn
    return {"sql-conn-fn": lambda node: conn("127.0.0.1", f.port)}, f.stop


def _suite_run(pkg, suite, workload, n, store_dir, seed):
    """The suite's own map for `workload` on one node, its generator
    replaced by n invocations of the workload's, one at a time, run
    through the package's core.run against a fresh data plane. The
    etcd register workload gives each key two threads per node, so it
    runs two processes; the others run one."""
    gen, mod = pkg["gen"], pkg["suites"].suite(suite)
    opts = {"nodes": ["n1"], "concurrency": 2 if suite == "etcd" else 1,
            "ssh": {"dummy": True}, "workload": workload, "ops-per-key": 10, "nemesis": "none",
            "faults": ["none"], "store-dir": str(store_dir), **pkg["opts"]}
    wire, stop = _data_plane(pkg, suite)
    try:
        # the map's builders draw from the rng (`mix` when it is
        # built), and so does the run: both go under the pinned seed
        with gen.fixed_rng(seed):
            t = getattr(mod, f"{suite}_test")(opts)
            w = mod.WORKLOADS[workload](opts)
            t.update(wire, db=pkg["db"].noop, os=pkg["os_"].noop,
                     generator=gen.clients(_one_at_a_time(gen, gen.limit(
                         n, w["generator"]))))
            return pkg["core"].run(t)
    finally:
        stop()


def _timeless(h):
    return [{k: v for k, v in o.items() if k != "time"} for o in h]


def _rekey(hist, ind):
    """The stored history's [key, value] lists as the package's KVs
    (ROADMAP F6)."""
    out = []
    for o in hist:
        o = dict(o)
        if isinstance(o.get("value"), list):
            o["value"] = ind.ktuple(*o["value"])
        out.append(o)
    return out


def _verdicts(r):
    """A result with each linearizability result cut to its verdict and
    its first bad op: the rest (analyzer, engine, walk counters, times)
    names the package's device path."""
    if not isinstance(r, dict):
        return r
    if "analyzer" in r:
        return {k: r[k] for k in ("valid?", "op-index") if k in r}
    return {k: _verdicts(v) for k, v in r.items()}


CASES = [("etcd", "register", True), ("hazelcast", "cas-register", False),
         ("hazelcast", "lock", False), ("tidb", "append", False)]


@pytest.mark.parametrize("suite,workload,keyed", CASES,
                         ids=[f"{s}-{w}" for s, w, _ in CASES])
def test_suite_run_equals_the_jax_run(tmp_path, _one_torch_thread, suite,
                                      workload, keyed):
    port = _suite_run(PORT, suite, workload, 60, tmp_path / "port", 45100)
    ref = _suite_run(JAX, suite, workload, 60, tmp_path / "jax", 45100)
    assert len(port["history"]) == 120
    assert _timeless(port["history"]) == _timeless(ref["history"])
    assert port["results"]["valid?"] is True, port["results"]
    wl = {"port": _verdicts(port["results"]["workload"]),
          "jax": _verdicts(ref["results"]["workload"])}
    assert wl["port"] == wl["jax"]
    # both packages' checkers on each stored history: the workload's
    # checker as the suite built it, the port's on the CPU
    for done in (port, ref):
        got = {}
        for name, pkg in (("port", PORT), ("jax", JAX)):
            h = pkg["store"].load_history(done)
            if keyed:
                h = _rekey(h, pkg["ind"])
            with pkg["gen"].fixed_rng(45100):
                w = pkg["suites"].suite(suite).WORKLOADS[workload](
                    {"nodes": ["n1"], "ops-per-key": 10, **pkg["opts"]})
            got[name] = _verdicts(
                w["checker"].check({"name": "recheck"}, h, {}))
        assert got["port"] == got["jax"] == wl["port"]


@pytest.mark.parametrize("kind", ["etcd", "hazelcast"])
def test_chip_smoke_suite_maps_run_on_the_cpu(tmp_path, monkeypatch, kind):
    """`chip_smoke.py`'s phase 14 maps at a small size on the CPU: the
    suite's own map with its client, partition nemesis and checker
    compose against its fake, valid, and its workload result equal,
    whole but for device and duration, to the CPU path's check of the
    stored history (`cpu_suite_check`)."""
    monkeypatch.setattr(chip_smoke, "SUITE_RUN", dict(
        chip_smoke.SUITE_RUN, invocations=400))
    monkeypatch.setattr(chip_smoke, "RUN_NEMESIS_S", 1.0)
    monkeypatch.setattr(chip_smoke, "RUN_NEMESIS_CYCLE_S", 0.2)
    if kind == "etcd":
        fake, url = chip_smoke.fake_etcd()
        stop = fake.stop
    else:
        server, port = tshim.serve()
        url, stop = f"http://127.0.0.1:{port}", server.shutdown
    remote = chip_smoke.getent_remote()
    try:
        with tgen.fixed_rng(chip_smoke.SEED):
            t = chip_smoke.suite_run_test(kind, "cpu", str(tmp_path),
                                          remote, url)
        clock = {}
        t["checker"].checkers["workload"] = chip_smoke.clocked(
            t["checker"].checkers["workload"], clock, "workload_check_s")
        t["checker"] = chip_smoke.clocked(t["checker"], clock, "check_s")
        done = tcore.run(t)
    finally:
        stop()
    res = done["results"]
    assert res["valid?"] is True, res
    nem = [o for o in done["history"] if o["process"] == "nemesis"]
    assert {o["f"] for o in nem} == {"start", "stop"}
    assert len(done["history"]) == 800 + len(nem)
    assert any("iptables" in a.get("cmd", "") for _, _, a in remote.log)
    run_dir = str(tmp_path / done["name"] / "latest")
    want, _ = chip_smoke.cpu_suite_check(kind, run_dir)
    assert chip_smoke.strip_volatile(res["workload"]) == want
    assert 0 < clock["workload_check_s"] <= clock["check_s"]
