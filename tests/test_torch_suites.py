"""The port's suites against the JAX package's, side by side at a small
size: the etcd register, hazelcast cas-register and lock, tidb append,
dgraph linearizable-register, faunadb register, yugabyte
ycql/single-key-acid, rethinkdb document-cas, raftis register, rabbitmq
mutex and ignite register maps, each built by its
suite in both packages under one generator seed at concurrency 1, with
the map's time-limited generator replaced by a `gen.limit` over the
same workload, one op in flight at a time, and no nemesis (the keyed
register workloads take two threads per key, so they run two processes
with one op in flight). Each run goes to a fresh fake of the suite's
data plane (tests/fake_etcd.py, `suites.cp_shim`, tests/fake_mysql.py,
fake_dgraph.py, fake_fauna.py, fake_cql.py, fake_rethinkdb.py,
fake_resp.py, fake_rabbitmq.py, fake_es_ignite.py). The two histories
are equal op for op (all fields but `time`), and both packages' checkers
give each stored history the same result, the port's on the CPU. Last,
`chip_smoke.py`'s phase 14-16 maps (the etcd, hazelcast, dgraph,
yugabyte, faunadb, raftis, rabbitmq and ignite suites' own, concurrency
10, a partition nemesis) run at a small size on the CPU against their
CPU-path check."""

import concurrent.futures
import threading

import pytest
import torch

import chip_smoke
from fake_cql import FakeCQLServer
from fake_dgraph import FakeDgraph
from fake_es_ignite import FakeIgnite
from fake_etcd import FakeEtcd
from fake_fauna import FakeFauna
from fake_mysql import FakeMySQLServer
from fake_rabbitmq import FakeRabbitMQ
from fake_resp import FakeRedis
from fake_rethinkdb import FakeRethinkDB

import jepsen_tpu.db as jdb
import jepsen_tpu.os_ as jos
from jepsen_tpu import core as jcore
from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jind
from jepsen_tpu import suites as jsuites
from jepsen_tpu import store as jstore
from jepsen_tpu.suites import cp_shim as jshim
from jepsen_tpu.suites import cql_proto as jcql
from jepsen_tpu.suites import mysql_proto as jmysql
from jepsen_tpu.suites import reql_proto as jreql
from jepsen_tpu.suites import resp_proto as jresp

import jepsen_tpu_torch.db as tdb
import jepsen_tpu_torch.os_ as tos
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import suites as tsuites
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.suites import cp_shim as tshim
from jepsen_tpu_torch.suites import cql_proto as tcql
from jepsen_tpu_torch.suites import mysql_proto as tmysql
from jepsen_tpu_torch.suites import reql_proto as treql
from jepsen_tpu_torch.suites import resp_proto as tresp
from jepsen_tpu_torch.checker import wgl as twgl
from jepsen_tpu_torch.checker import (wgl_closure, wgl_dedup, wgl_sortwalk,
                                      wgl_walk)

JAX = dict(core=jcore, gen=jgen, ind=jind, suites=jsuites, store=jstore,
           db=jdb, os_=jos, shim=jshim, mysql=jmysql, cql=jcql,
           reql=jreql, resp=jresp, opts={})
PORT = dict(core=tcore, gen=tgen, ind=tind, suites=tsuites, store=tstore,
            db=tdb, os_=tos, shim=tshim, mysql=tmysql, cql=tcql,
            reql=treql, resp=tresp, opts={"device": "cpu"})

# the keyed register workloads: two threads per key on one node
TWO_PROCESSES = ("etcd", "dgraph", "faunadb", "yugabyte", "rethinkdb",
                 "ignite")
# each suite's own options for the side-by-side run: no nemesis, and
# no per-key pacing (faunadb's 0.1 s stagger and 0.5 s delay,
# yugabyte's 1 s acid-stagger). faunadb's registers start nil, so a
# key takes the 30 ops of its own e2e test (tests/test_suite_faunadb.py)
# to land an ok cas, which the compose's stats checker asks of each f
SUITE_OPTS = {"dgraph": {"nemesis": [], "per-key-limit": 10,
                         "dgraph-conn-retry-delay": 0.0},
              "faunadb": {"nemesis": [], "register-stagger": 0,
                          "register-delay": 0, "ops-per-key": 30,
                          "fauna-conn-retry-delay": 0.0},
              "yugabyte": {"acid-stagger": 0},
              "rethinkdb": {"per-key-limit": 10},
              "ignite": {"per-key-limit": 10}}


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
    if suite == "dgraph":
        f = FakeDgraph()
        conn = pkg["suites"].suite("dgraph").DgraphConn
        return {"dgraph-conn-fn": lambda node: conn(
            "127.0.0.1", f.port, timeout_s=5.0)}, f.stop
    if suite == "faunadb":
        f = FakeFauna()
        conn = pkg["suites"].suite("faunadb").FaunaConn
        return {"fauna-conn-fn": lambda node, linearized=False: conn(
            "127.0.0.1", f.port, linearized=linearized,
            timeout_s=5.0)}, f.stop
    if suite == "yugabyte":
        f = FakeCQLServer()
        conn = pkg["cql"].Conn
        return {"cql-conn-fn": lambda node: conn("127.0.0.1", f.port)}, \
            f.stop
    if suite == "rethinkdb":
        f = FakeRethinkDB()
        conn = pkg["reql"].Conn
        return {"reql-conn-fn": lambda node: conn("127.0.0.1", f.port)}, \
            f.stop
    if suite == "raftis":
        f = FakeRedis()
        conn = pkg["resp"].Conn
        return {"resp-conn-fn": lambda node: conn("127.0.0.1", f.port)}, \
            f.stop
    if suite in ("rabbitmq", "ignite"):
        f = FakeRabbitMQ() if suite == "rabbitmq" else FakeIgnite()
        url = f"http://127.0.0.1:{f.port}"
        return {"mgmt-url-fn" if suite == "rabbitmq" else "ignite-url-fn":
                lambda node: url}, f.stop
    f = FakeMySQLServer()
    conn = pkg["mysql"].Conn
    return {"sql-conn-fn": lambda node: conn("127.0.0.1", f.port)}, f.stop


def _suite_run(pkg, suite, workload, n, store_dir, seed):
    """The suite's own map for `workload` on one node, its generator
    replaced by n invocations of the workload's, one at a time, run
    through the package's core.run against a fresh data plane. The
    keyed register workloads give each key two threads per node, so
    they run two processes; the others run one."""
    gen, mod = pkg["gen"], pkg["suites"].suite(suite)
    opts = {"nodes": ["n1"],
            "concurrency": 2 if suite in TWO_PROCESSES else 1,
            "ssh": {"dummy": True}, "workload": workload, "ops-per-key": 10, "nemesis": "none",
            "faults": ["none"], "store-dir": str(store_dir),
            **SUITE_OPTS.get(suite, {}), **pkg["opts"]}
    wire, stop = _data_plane(pkg, suite)
    try:
        # the map's builders draw from the rng (`mix` when it is
        # built), and so does the run: both go under the pinned seed
        with gen.fixed_rng(seed):
            t = getattr(mod, f"{suite}_test")(opts)
            w = mod.WORKLOADS[workload](opts)
            g = w["generator"]
            if isinstance(g, gen.Stagger):
                # dgraph's register workloads pace their ops on the
                # host's clock (`gen.stagger(1/100, ...)`)
                g = g.gen
            t.update(wire, db=pkg["db"].noop, os=pkg["os_"].noop,
                     generator=gen.clients(_one_at_a_time(gen, gen.limit(
                         n, g))))
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
         ("hazelcast", "lock", False), ("tidb", "append", False),
         ("dgraph", "linearizable-register", True),
         ("faunadb", "register", True),
         ("yugabyte", "ycql/single-key-acid", True),
         ("rethinkdb", "document-cas", True), ("raftis", "register", False),
         ("rabbitmq", "mutex", False), ("ignite", "register", True)]


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
                    {"nodes": ["n1"], "ops-per-key": 10,
                     **SUITE_OPTS.get(suite, {}), **pkg["opts"]})
            got[name] = _verdicts(
                w["checker"].check({"name": "recheck"}, h, {}))
        assert got["port"] == got["jax"] == wl["port"]


class _Inline:
    """A worker pool that runs each job at once, in this process."""

    def submit(self, fn, *a):
        f = concurrent.futures.Future()
        f.set_result(fn(*a))
        return f


@pytest.mark.parametrize("kind", ["etcd", "hazelcast", "dgraph", "yugabyte",
                                  "faunadb", "raftis", "rabbitmq", "ignite"])
def test_chip_smoke_suite_maps_run_on_the_cpu(tmp_path, monkeypatch,
                                              _one_torch_thread, kind):
    """`chip_smoke.py`'s phase 14-16 maps at a small size on the CPU,
    through `drive_suite` with each fake in a child process of its own:
    the suite's own map with its client, partition nemesis and checker
    compose, valid, its nemesis ops and iptables cuts there, its eager
    walks, plain K1 rounds and plain K2 calls (counted as the card's K3
    and K3-sort launches, K3 rounds and K3-sort hash dedups) equal to
    what its results report, and its workload result equal, whole but for device and
    duration, to the CPU path's check of the stored history
    (`cpu_suite_check`)."""
    monkeypatch.setattr(chip_smoke, "SUITE_RUN", dict(
        chip_smoke.SUITE_RUN, invocations=400))
    for counts in ("SUITE2_INVOCATIONS", "SUITE3_INVOCATIONS"):
        monkeypatch.setattr(chip_smoke, counts, dict.fromkeys(
            getattr(chip_smoke, counts), 400))
    monkeypatch.setattr(chip_smoke, "RUN_NEMESIS_S", 1.0)
    monkeypatch.setattr(chip_smoke, "RUN_NEMESIS_CYCLE_S", 0.2)
    # one torch thread throughout, the CPU path's etcd check too
    monkeypatch.setattr(chip_smoke, "CPU_WORKERS", 1)
    monkeypatch.setattr(chip_smoke, "CPU_WORKER_THREADS", 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    lock = threading.Lock()
    # on the card a dense walk is K3 (its rounds those of K1's plain
    # version here) and a sort walk K3-sort (its hash dedups those of
    # K2's plain version here)
    for mod, name, owner, count in (
            (wgl_closure, "closure_round_plain", wgl_walk, "ROUNDS"),
            (wgl_dedup, "dedup_plain", wgl_sortwalk, "DEDUPS"),
            (twgl.DenseKernel, "run_range_eager", wgl_walk, "LAUNCHES"),
            (twgl.DenseKernel, "run_range_batch_eager", wgl_walk,
             "LAUNCHES"),
            (twgl.SortKernel, "run_range_eager", wgl_sortwalk, "LAUNCHES"),
            (twgl.SortKernel, "run_range_batch_eager", wgl_sortwalk,
             "LAUNCHES")):
        def counted(*a, _owner=owner, _count=count,
                    _plain=getattr(mod, name), **k):
            with lock:
                setattr(_owner, _count, getattr(_owner, _count) + 1)
            return _plain(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    row, job = chip_smoke.drive_suite(
        kind, "cpu", str(tmp_path), _Inline(),
        *chip_smoke.data_planes([kind])[kind])
    assert row["ops"] == 2 * 400 + row["nemesis_ops"] and row["iptables"]
    assert row["k3_launches"] > 0 and row["k1_launches"] == 0
    assert row["k2_launches"] == 0 and row["k3s_launches"] == 0
    assert 0 < row["workload_check_s"] <= row["check_s"]
    if kind in ("yugabyte", "faunadb"):
        # a compose per key: each key is walked alone
        assert row["keys_alone"] == row["keys"] and not row["groups"]
    chip_smoke.same_as_cpu({kind: row}, {kind: job})


def _std_partition_run(pkg, tmp_path, plot=None):
    """The raftis register map as `std_test` builds it under its default
    partition fault (a `nemesis.combined` package), a second long,
    against a fresh FakeRedis over the dummy remote; `plot` rewrites
    the map's plot options first."""
    wire, stop = _data_plane(pkg, "raftis")
    try:
        t = pkg["suites"].suite("raftis").raftis_test({
            "nodes": ["n1", "n2", "n3"], "concurrency": 3,
            "ssh": {"dummy": True}, "rate": 200, "time-limit": 1,
            "nemesis-interval": 0.2, "store-dir": str(tmp_path),
            **pkg["opts"]})
        t.update(wire, db=pkg["db"].noop, os=pkg["os_"].noop,
                 remote=chip_smoke.getent_remote())
        if plot is not None:
            t["plot"] = plot(t["plot"])
        return pkg["core"].run(t)["results"]
    finally:
        stop()


def test_combined_perf_specs_end_a_std_test_run_unknown(tmp_path):
    """ROADMAP F9, the reference's own behaviour: `nemesis.combined`'s
    packages give their perf specs as (name, start, stop, color)
    tuples, which `std_test` hands the perf checker as the plot's
    nemeses, and the perf checker reads only maps, so a std_test map
    with a fault ends `unknown` in both packages though its workload is
    valid. `chip_smoke.perf_maps` gives the port's run the maps, and
    then the run is valid."""
    for name, pkg in (("port", PORT), ("jax", JAX)):
        r = _std_partition_run(pkg, tmp_path / name)
        assert r["valid?"] == "unknown", (name, r["valid?"])
        assert r["workload"]["valid?"] is True
        errors = [v["error"] for v in r["perf"].values()
                  if isinstance(v, dict) and "error" in v]
        assert r["perf"]["valid?"] == "unknown" and errors
        assert all("'tuple' object has no attribute 'get'" in e
                   for e in errors)
    r = _std_partition_run(PORT, tmp_path / "maps", chip_smoke.perf_maps)
    assert r["valid?"] is True and r["perf"]["valid?"] is True, r
