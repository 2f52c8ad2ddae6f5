"""The port's host modules against the JAX package's: its own copies of
history, models, synth and the host oracle give the same values, its
engine choice agrees, it resolves devices without falling back, and it
never imports jax or jepsen_tpu (a fresh interpreter runs linearizability,
batch, independent, list-append and rw-register checks, a tiered check,
the competition race, a stream, the service and the sharded batch and
list-append checks over a one-rank gloo group to show it; a second runs
the scenario search with its batch escalation and the self-chaos
harness)."""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu import history as jhistory
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import linear as jlinear
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu_torch import _platform
from jepsen_tpu_torch import history as thistory
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker import linear as tlinear
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the
    other test workers' threads, which slows these tests tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GENERATORS = [
    ("register_history", dict(n_ops=300, concurrency=5, crash_rate=0.02)),
    ("register_history", dict(n_ops=200, concurrency=3, cas=False,
                              seed=9)),
    ("adversarial_register_history", dict(n_ops=300, crashed_writes=4)),
    ("adversarial_register_history", dict(n_ops=400, concurrency=4,
                                          front_load=True, seed=3)),
]


@pytest.mark.parametrize("name,kw", GENERATORS)
def test_synth_copies_make_the_same_histories(name, kw):
    t = getattr(tsynth, name)(**kw)
    j = getattr(jsynth, name)(**kw)
    assert t.ops == j.ops
    assert tsynth.corrupt(t, seed=4).ops == jsynth.corrupt(j, seed=4).ops


def test_corrupt_value_option_keeps_other_reads():
    h = tsynth.register_history(100, seed=2)
    a, b = tsynth.corrupt(h, seed=1), tsynth.corrupt(h, seed=1, value=5)
    diff = [(x, y) for x, y in zip(a.ops, b.ops) if x != y]
    assert len(diff) == 1
    assert diff[0][0]["value"] == 10 ** 6 and diff[0][1]["value"] == 5


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_encoding_and_steps_match_jax(seed, merge):
    h = jsynth.register_history(250, concurrency=5, crash_rate=0.04,
                                seed=seed)
    tops = twgl.encode_ops_for_model(tmodels.cas_register(),
                                     thistory.History(h.ops))
    jops = jwgl.encode_ops_for_model(jmodels.cas_register(), h)
    for f in ("f", "a", "b", "kind", "inv", "ret", "process", "index"):
        np.testing.assert_array_equal(getattr(tops, f), getattr(jops, f))
    assert twgl.required_slots(tops) == jwgl.required_slots(jops)
    assert twgl.event_count(tops) == jwgl.event_count(jops)
    p = twgl.required_slots(tops) + seed
    ts, js = twgl.build_steps(tops, p, merge), jwgl.build_steps(jops, p,
                                                                merge)
    for f in ("x", "ret_row", "inv_row"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    assert (ts.w, ts.n) == (js.w, js.n)
    assert twgl._state_range("cas-register", tmodels.cas_register(),
                             [tops]) == \
        jwgl._state_range("cas-register", jmodels.cas_register(), [jops])


SHAPES = [((-1, 4), 7, 14_000), ((-1, 4), 14, 14_000), ((-1, 4), 19, 14_000),
          ((-1, 4), 21, 14_000), ((0, 600), 3, 500), ((0, 200), 12, 100),
          ((-1, 10 ** 6), 7, 14_000), ((0, 1), 22, 10), ((-3, 3), 9, 10 ** 6),
          # the main path's adversarial and counter histories (synth,
          # seed 45100, 10k ops): both take the sort family's hash dedup
          ((-1, 4), 14, 14_626), ((-4975, 5076), 4, 20_000),
          ((-1, 4), 30, 200)]


@pytest.mark.parametrize("srange,p,n", SHAPES)
def test_select_engine_agrees_with_jax_off_tpu(srange, p, n):
    """The port's engine choice is the JAX package's as it resolves on
    its accelerator: `select_engine(..., pallas=True)`, which prices the
    sort family at the hash dedup wherever its gate admits the shape
    (65,536 is past the gate's capacity at these slot counts)."""
    for engine, cap, F in itertools.product(("auto", "dense", "sort"),
                                            (None, 8), (256, 65_536)):
        kw = dict(engine=engine, dense_slot_cap=cap, frontier=F)
        try:
            want = jwgl.select_engine(srange, p, n, pallas=True, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                twgl.select_engine(srange, p, n, **kw)
            continue
        got = twgl.select_engine(srange, p, n, **kw)
        assert (got.family, got.dense, got.dedup, got.reason) == \
            (want.family, want.dense, want.dedup, want.reason)
        assert got.costs == want.costs
    assert twgl._dense_shape(srange, p) == jwgl._dense_shape(srange, p)
    assert twgl._family_costs(8, p, 32, 256, n) == \
        jwgl._family_costs(8, p, 32, 256, n)
    for P in (8, 16, 32, 64):
        pack = jwgl._pack_params(srange, P)
        assert twgl._pack_params(srange, P) == pack
        for F in (256, 16_384, 65_536):
            assert twgl.dedup_engine(F, P, pack) == \
                jwgl.dedup_engine(F, P, pack, pallas=True)


@pytest.mark.parametrize("seed", range(3))
def test_host_oracle_copy_matches(seed):
    h = jsynth.register_history(60, concurrency=4, crash_rate=0.05,
                                seed=seed)
    for hist in (h, jsynth.corrupt(h, seed=seed)):
        t = tlinear.analysis_host(tmodels.cas_register(),
                                  thistory.History(hist.ops))
        j = jlinear.analysis_host(jmodels.cas_register(), hist)
        t.pop("duration-ms")
        j.pop("duration-ms")
        assert t == j


def test_host_models_copy_matches():
    ops = [{"f": "write", "value": 3}, {"f": "read", "value": 3},
           {"f": "cas", "value": (3, 4)}, {"f": "read", "value": 1},
           {"f": "cas", "value": (1, 2)}]
    for mk in ("cas_register", "register"):
        tm, jm = getattr(tmodels, mk)(), getattr(jmodels, mk)()
        for o in ops:
            tm, jm = tm.step(o), jm.step(o)
            assert repr(tm) == repr(jm)
            if tmodels.is_inconsistent(tm):
                break
    for mk in ("counter", "mutex", "gset", "unordered_queue"):
        tm, jm = getattr(tmodels, mk)(), getattr(jmodels, mk)()
        assert tm.device_state() == jm.device_state()
        assert tm.device_model == jm.device_model
    assert thistory.NIL == jhistory.NIL and \
        thistory.F_CAS == jhistory.F_CAS


def test_resolve_device_raises_without_cuda_and_never_falls_back():
    assert _platform.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert _platform.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _platform.resolve_device()
    with pytest.raises(RuntimeError):
        _platform.resolve_device("cuda")
    with pytest.raises(ValueError):
        _platform.resolve_device("meta")


def test_attest_gate_reads_the_same_env_var(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_ATTEST", "0")
    assert not _platform.attest_enabled()
    assert _platform.attest_enabled(True)
    monkeypatch.delenv("JEPSEN_TPU_ATTEST")
    assert _platform.attest_enabled()


_GUARD = r"""
import sys
import jepsen_tpu_torch
from jepsen_tpu_torch import _platform, carry, independent, models, util
from jepsen_tpu_torch.checker import (abft, linear, synth, wgl,
                                      wgl_closure, wgl_dedup)
h = synth.register_history(120, concurrency=4, crash_rate=0.03, seed=1)
r = linear.linearizable(models.cas_register(), device="cpu",
                        chunk_entries=40).check({}, h, {})
assert r["valid?"] is True and r["analyzer"] == "gpu-wgl-dense", r
bad = linear.linearizable(models.cas_register(), device="cpu").check(
    {}, synth.corrupt(h, value=5), {})
assert bad["valid?"] is False and "op-index" in bad, bad
srt = linear.linearizable(models.cas_register(), device="cpu",
                          chunk_entries=40).check({}, synth.corrupt(h), {})
assert srt["analyzer"] == "gpu-wgl" and srt["dedup"] == "pallas-hash", srt
assert srt["valid?"] is False and "op-index" in srt, srt
keys = [synth.register_history(40, concurrency=3, seed=s) for s in range(3)]
keys[1] = synth.corrupt(keys[1], value=5)
rs = wgl.analysis_gpu_batch(models.cas_register(), keys, device="cpu")
assert [r["valid?"] for r in rs] == [True, False, True], rs
ops = [dict(o, value=independent.ktuple(k, o["value"]),
            process=o["process"] + 10 * k)
       for k, h in enumerate(keys) for o in h.ops]
ind = independent.checker(linear.linearizable(
    models.cas_register(), device="cpu")).check({}, ops, {})
assert ind["failures"] == [1], ind
from jepsen_tpu_torch import txn
from jepsen_tpu_torch.checker import elle
from jepsen_tpu_torch.checker.elle import graphs, kernels, list_append
from jepsen_tpu_torch.checker.elle import wr as elle_wr
ah = synth.inject_append_cycles(synth.append_history(300, seed=2), 3, "G1c")
ra = list_append.check(ah, device="cpu", additional_graphs=("realtime",))
assert ra["valid?"] is False and "G1c" in ra["anomaly-types"], ra
assert ra["anomalies"]["G1c"][0]["cycle"], ra
rw = elle.rw_register_checker(device="cpu").check(
    {}, synth.wr_history(300, seed=2), {})
assert rw["valid?"] is True and rw["txn-count"] == 300, rw
assert elle_wr.check(synth.wr_history(200, seed=3), device="cpu",
                     additional_graphs=("process",))["valid?"] is True
from jepsen_tpu_torch import telemetry, trace
from jepsen_tpu_torch.checker import (compose, explain, perf, screen,
                                      streaming)
tier = linear.linearizable(models.cas_register(), device="cpu").check(
    {"tier": "screen", "screen-sample": 1}, synth.corrupt(h), {})
assert tier["tier"] == 1 and tier["escalated"]["why"] == "suspicion", tier
assert tier["valid?"] is False, tier
race = linear.linearizable(models.cas_register(), algorithm="competition",
                           device="cpu").check({}, h, {})
assert race["valid?"] is True and race["competition-winner"], race
st = streaming.stream_check(models.cas_register(), synth.corrupt(h, value=5),
                            device="cpu", chunk_entries=64,
                            state_range=(-1, 5), engine="dense")
assert st["valid?"] is False and st["streamed"], st
assert st["op-index"] == bad["op-index"], (st, bad)
sw = screen.screen_wr(synth.wr_history(200, seed=3))
assert sw["valid?"] is True, sw
cmp = compose({"lin": linear.linearizable(models.cas_register(),
                                          device="cpu")}).check({}, h, {})
assert cmp["valid?"] is True, cmp
import jepsen_tpu_torch.__main__
from jepsen_tpu_torch import calibrate, reconnect, service, store
cal = calibrate.activate(calibrate.Calibration(platform="cpu"))
svc = service.VerificationService(device="cpu", calibration=cal)
spec = {"linear": {"kind": "wgl", "model": service.model_spec(
    models.cas_register()), "chunk-entries": 64, "slots": 8,
    "frontier": 128, "engine": "sort"}}
svc.admit("guard", spec)
for o in synth.corrupt(h, value=5).ops:
    svc.offer("guard", o)
svc.seal("guard")
sr = svc.result("guard", timeout_s=120)["linear"]
assert sr["valid?"] is False and sr["op-index"] == bad["op-index"], sr
addr = svc.serve("127.0.0.1:0")
cl = service.ServiceClient(addr, {"name": "g", "start-time": "1"},
                           spec=spec, device="cpu")
for o in h.ops:
    cl.offer(o)
fin = cl.finalize()
assert fin["linear"]["valid?"] is True, fin
assert svc.status()["calibration"]["platform"] == "cpu"
svc.stop()
calibrate.deactivate()
import tempfile
import torch.distributed as dist
from jepsen_tpu_torch import graft_entry, parallel
mesh = parallel.init(0, 1, "file://" + tempfile.mkdtemp() + "/rdv",
                     device="cpu")
ok, pk, info = wgl.check_batch_sharded(models.cas_register(), keys, mesh,
                                       return_info=True)
assert not ok and pk.tolist() == [True, False, True], (pk, info)
assert info["attested"] == {"steps": 1, "carry": 1}, info
assert mesh.calls[("psum", "cpu")] == 1, mesh.calls
rm = list_append.check(ah, mesh=mesh, additional_graphs=("realtime",))
assert rm == ra, rm
dist.destroy_process_group()
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "jepsen_tpu" or m.startswith("jepsen_tpu."))
print("LEAKED", leaked)
"""


def test_port_never_imports_jax_or_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


_GUARD_SEARCH_CHAOS = r"""
import sys, tempfile
from jepsen_tpu_torch import generator, independent, report
from jepsen_tpu_torch.generator import simulate
from jepsen_tpu_torch.search import SearchConfig, run_search
from jepsen_tpu_torch.chaos import ChaosConfig, run_chaos
import jepsen_tpu_torch.__main__
r = run_search(SearchConfig(workload="phased-register",
                            bug="lost-write-kill-partition", generations=12,
                            population=25, seed=2, max_sims=300,
                            escalate="batch", sample=0.3, device="cpu",
                            store_dir=tempfile.mkdtemp()))
assert r["found"] is True and r["escalations"] > 0, r
c = run_chaos(ChaosConfig(budget=3, ops=64, seed=23, device="cpu"))
assert c["failures"] == [] and c["schedules"] == 3, c
assert report.chaos_line(c).startswith("chaos (guided):")
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "jepsen_tpu" or m.startswith("jepsen_tpu."))
print("LEAKED", leaked)
"""


def test_search_and_chaos_never_import_jax_or_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _GUARD_SEARCH_CHAOS],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


_GUARD_RUN = r"""
import sys, tempfile
from jepsen_tpu_torch import (cli, client, control, core, db, independent,
                              models, nemesis, net, os_, plot, store,
                              testkit, workloads)
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import (basic, clock, compose, counter_plot,
                                      log_file_pattern, perf, perf_checker,
                                      stats, timeline, unhandled_exceptions)
from jepsen_tpu_torch.control import dummy, util as cu
from jepsen_tpu_torch.generator import interpreter
from jepsen_tpu_torch.nemesis import combined, partition
from jepsen_tpu_torch.nemesis import time as ntime
from jepsen_tpu_torch.os_ import debian
from jepsen_tpu_torch.workloads import linearizable_register as lr


class Keyed(client.Client):
    def __init__(self):
        self.cells = {}

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        k, v = op["value"].key, op["value"].value
        cell = self.cells.setdefault(k, testkit.AtomState(None))
        out = dict(op)
        if op["f"] == "write":
            cell.reset(v)
            out["type"] = "ok"
        elif op["f"] == "cas":
            out["type"] = "ok" if cell.cas(*v) else "fail"
        else:
            out["type"] = "ok"
            out["value"] = independent.ktuple(k, cell.read())
        return out

    def reusable(self, test):
        return True


remote = dummy.DummyRemote(responses={r"getent ahosts": lambda c, a: {
    "out": "10.0.0.%s STREAM x\n" % a["cmd"].split()[-1][-1]}})
w = lr.test({"per-key-limit": 20, "device": "cpu"})
t = {**testkit.noop_test(), "name": "guard-run", "remote": remote,
     "ssh": {"dummy": True}, "store-dir": tempfile.mkdtemp(),
     "concurrency": 10, "os": debian.os, "client": Keyed(),
     "nemesis": partition.partition_random_halves(),
     "online": True, "service": "127.0.0.1:9", "device": "cpu",
     "generator": gen.phases(
         gen.time_limit(1.0, gen.nemesis(
             gen.cycle(gen.phases(gen.sleep(0.1), gen.once(
                 {"type": "info", "f": "start", "value": None}),
                 gen.sleep(0.1), gen.once(
                 {"type": "info", "f": "stop", "value": None}))),
             gen.limit(200, w["generator"]))),
         gen.nemesis(gen.once({"type": "info", "f": "stop"}))),
     "checker": compose({"perf": perf_checker(),
                         "timeline": timeline.html(),
                         "workload": w["checker"], "stats": stats(),
                         "exceptions": unhandled_exceptions(),
                         "logs": log_file_pattern("PANIC", "db.log")})}
done = core.run(t)
r = done["results"]
assert r["valid?"] is True, r
assert r["workload"]["results"], r
nem = [o for o in done["history"] if o["process"] == "nemesis"]
assert {o["f"] for o in nem} == {"start", "stop"}, nem
assert any(a.get("cmd", "").startswith("iptables") or "iptables"
           in a.get("cmd", "") for _, _, a in remote.log)
assert store.load_results(done)["valid?"] is True
from jepsen_tpu_torch.checker import synth
assert counter_plot().check(done, synth.counter_history(40), {})["valid?"]
clock_ops = ntime.clock_gen()


def no_gxx(ctx, action):
    return {"exit": 1, "err": "g++: not found"}


with control.with_remote(dummy.DummyRemote(responses={r"g\+\+": no_gxx})), \
        control.on("n1"):
    try:
        ntime.install()
    except control.RemoteError:
        pass
from jepsen_tpu_torch import faketime, fs_cache
from jepsen_tpu_torch.control import docker, k8s
from jepsen_tpu_torch.nemesis import charybdefs, membership
from jepsen_tpu_torch.workloads import (adya, append, bank, causal,
                                        causal_reverse, comments,
                                        linearizable_register, long_fork,
                                        monotonic, sequential, table, wr)
assert sorted(workloads.__all__) == sorted(
    m.__name__.rsplit(".", 1)[1] for m in (
        adya, append, bank, causal, causal_reverse, comments,
        linearizable_register, long_fork, monotonic, sequential, table, wr))


class Registers(client.Client):
    def __init__(self):
        self.data = {}

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        out = []
        for f, k, v in op["value"]:
            if f == "r":
                out.append(["r", k, self.data.get(k)])
            else:
                self.data[k] = v if v is not None else \
                    (self.data.get(k) or 0) + 1
                out.append(["w", k, self.data[k]])
        return {**op, "type": "ok", "value": out}

    def reusable(self, test):
        return True


with gen.fixed_rng(3):
    w = monotonic.workload({"device": "cpu"})
    t = {**testkit.noop_test(), "name": "guard-monotonic",
         "ssh": {"dummy": True}, "store-dir": tempfile.mkdtemp(),
         "concurrency": 5, "client": Registers(),
         "checker": compose({"workload": w["checker"]}),
         "generator": gen.clients(gen.limit(200, w["generator"]))}
done = core.run(t)
r = done["results"]["workload"]
assert r["valid?"] is True and r["txn-count"] == 200, r
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "jepsen_tpu" or m.startswith("jepsen_tpu."))
lazy = {"jepsen_tpu_torch.report", "jepsen_tpu_torch.service",
        "jepsen_tpu_torch.checker.streaming", "jepsen_tpu_torch.os_.centos"}
print("LAZY", sorted(lazy - set(sys.modules)))
print("LEAKED", leaked)
"""


def test_the_run_path_never_imports_jax_or_the_jax_package():
    """core.run with the register workload, a partition nemesis, the
    debian OS and the etcd suite's checker compose over the dummy
    remote, on the CPU; the lazy imports inside core, checker.basic and
    nemesis.time are reached and point at the port. Then all twelve
    workloads, the docker and k8s remotes, the membership and
    CharybdeFS nemeses, faketime and fs_cache are imported, and the
    monotonic workload runs through core.run on the CPU."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _GUARD_RUN], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LAZY []" in out.stdout, out.stdout
    assert "LEAKED []" in out.stdout, out.stdout


_GUARD_SUITES = r"""
import json, sys, tempfile, urllib.request
from jepsen_tpu_torch import cli, core, db, os_, repl, web
from jepsen_tpu_torch import __main__ as entry
from jepsen_tpu_torch.suites import (SUITES, aerospike, as_proto, bson_proto,
                                     cockroach, cp_shim, etcd, hazelcast,
                                     mongodb, mysql_proto, netutil,
                                     pg_proto, suite, tidb)
assert suite("etcd") is etcd and "dgraph" in SUITES
try:
    suite("dgraph")
except ModuleNotFoundError:
    pass
else:
    raise AssertionError("dgraph is not ported yet")
server, port = cp_shim.serve()
t = hazelcast.hazelcast_test({
    "nodes": ["n1", "n2", "n3"], "concurrency": 3, "ssh": {"dummy": True},
    "workload": "cas-register", "rate": 100, "time-limit": 1,
    "nemesis": "none", "store-dir": tempfile.mkdtemp(), "device": "cpu"})
t.update(db=db.noop, os=os_.noop,
         **{"shim-url-fn": lambda node: f"http://127.0.0.1:{port}"})
done = core.run(t)
server.shutdown()
assert done["results"]["valid?"] is True, done["results"]
assert repl.latest_test(t["store-dir"])["name"] == "hazelcast-cas-register"
srv = web.serve({"host": "127.0.0.1", "port": 0,
                 "store-dir": t["store-dir"]})
with urllib.request.urlopen(
        f"http://127.0.0.1:{srv.server_address[1]}/") as r:
    assert b"hazelcast-cas-register" in r.read()
srv.shutdown()
for main, argv in ((cli.main, ["bogus"]), (cli.main, ["serve", "-p", "x"]),
                   (entry.main, ["chaos", "--strategy", "bogus"])):
    try:
        main(argv)
    except SystemExit as e:
        assert e.code == 254, (argv, e.code)
    else:
        raise AssertionError(argv)
bad = tempfile.mkdtemp() + "/bad.py"
with open(bad, "w") as f:
    f.write("import os\nimport os\n")
# the metrics analyzer imports the JAX package: it must do so elsewhere
for argv, code in ((["staticcheck", bad, "--only", "style",
                     "--baseline", bad + ".baseline"], 1),
                   (["staticcheck", "--only", "metrics"], 0)):
    try:
        cli.main(argv)
    except SystemExit as e:
        assert e.code == code, (argv, e.code)
    else:
        raise AssertionError(argv)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "jepsen_tpu" or m.startswith("jepsen_tpu."))
print("LEAKED", leaked)
"""


def test_the_suites_web_and_commands_never_import_jax_or_the_jax_package():
    """The thirteen suite and protocol modules, `web`, `repl` and
    `cli.main` in a fresh interpreter: the hazelcast cas-register map
    runs through core.run against the CP shim on the CPU, `repl` and
    the web UI read its store, the command runner refuses bad
    arguments with 254, and `staticcheck` runs the style and metrics
    analyzers with their exit codes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _GUARD_SUITES], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_port_sources_name_no_jax_import():
    paths = list((REPO / "jepsen_tpu_torch").rglob("*.py"))
    names = {p.relative_to(REPO / "jepsen_tpu_torch").as_posix()
             for p in paths}
    assert {"service.py", "calibrate.py", "store.py", "reconnect.py",
            "__main__.py", "telemetry.py", "parallel.py",
            "graft_entry.py", "generator/__init__.py",
            "generator/simulate.py", "search/driver.py",
            "search/scenario.py", "search/coverage.py",
            "search/mutate.py", "chaos/driver.py", "chaos/genome.py",
            "chaos/oracles.py", "report.py", "core.py", "cli.py",
            "client.py", "db.py", "net.py", "plot.py", "testkit.py",
            "control/__init__.py", "control/core.py", "control/util.py",
            "os_/debian.py", "nemesis/__init__.py",
            "nemesis/partition.py", "nemesis/time.py",
            "nemesis/combined.py", "generator/interpreter.py",
            "checker/basic.py", "checker/clock.py", "checker/timeline.py",
            "checker/perf.py", "workloads/linearizable_register.py",
            "workloads/append.py", "workloads/wr.py", "workloads/adya.py",
            "workloads/bank.py", "workloads/causal.py",
            "workloads/causal_reverse.py", "workloads/comments.py",
            "workloads/long_fork.py", "workloads/monotonic.py",
            "workloads/sequential.py", "workloads/table.py",
            "faketime.py", "fs_cache.py", "control/docker.py",
            "control/k8s.py", "nemesis/charybdefs.py",
            "nemesis/membership.py", "web.py", "repl.py",
            "suites/__init__.py", "suites/netutil.py", "suites/etcd.py",
            "suites/cp_shim.py", "suites/hazelcast.py",
            "suites/mysql_proto.py", "suites/tidb.py", "suites/pg_proto.py",
            "suites/cockroach.py", "suites/bson_proto.py",
            "suites/mongodb.py", "suites/as_proto.py",
            "suites/aerospike.py"} <= names
    for p in paths + [REPO / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (p, s)
            assert not s.startswith(("import jepsen_tpu ",
                                     "import jepsen_tpu.",
                                     "from jepsen_tpu ",
                                     "from jepsen_tpu.")), (p, s)
