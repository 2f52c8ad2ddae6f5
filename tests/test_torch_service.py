"""The port's verification service (`jepsen_tpu_torch/service.py`)
against the JAX package's (`jepsen_tpu/service.py`) on the CPU: the spec
functions, multiplexing (each stream equal to its solo run and to the
JAX service's result on the same histories), per-stream isolation under
the fault matrix and an injected `KernelCompileError`, quarantine, shed,
admission control, drain and resume (within the port and across the
packages in both directions), watch mode over the port's journal, the
socket protocol and status, client abort, the refused-attach fallback,
`ChunkBudget` against the JAX budget, and the store satellites
(synchronous unsubscribe, `JournalTail` idle backoff, resume manifests).

Histories are small (300 ops), chunks 64 steps, 8 slots, frontier 128,
as in the JAX package's tests/test_service.py. The port runs with
device="cpu"; the JAX package under JAX_PLATFORMS=cpu with its Pallas
hash dedup on (JEPSEN_TPU_PALLAS_DEDUP=1), as on its accelerator.

Results are compared as canonical JSON without the timing fields
('tail-latency-ms', 'duration-ms', 'violation-at-op', as the JAX tests
drop them). Against the JAX package a port result also drops the keys
only the port reports ('device', 'closure-rounds', 'dedup-launches',
'host-syncs') and its analyzer reads 'gpu-' where the JAX one reads
'tpu-'. JAX tests that exercise only JAX or orchestrator surfaces stay
out: `core.run`'s service option and the two fake-etcd runs through it,
the report line and web note, the CLI table (the port's daemon is
tested in tests/test_torch_service_crash.py).
"""

from __future__ import annotations

import gzip
import itertools
import json
import os
import signal
import threading
import time

import pytest
import torch

import jepsen_tpu._platform as jplat
import jepsen_tpu.control.retry as jretry
from jepsen_tpu import models as jmodels
from jepsen_tpu import service as jservice
from jepsen_tpu import store as jstore
from jepsen_tpu.checker import linearizable as jlinearizable
from jepsen_tpu.checker import streaming as jstreaming
from jepsen_tpu.checker.elle import rw_register_checker as jrw_checker
from jepsen_tpu_torch import _platform as plat
from jepsen_tpu_torch import models, service, store, util
from jepsen_tpu_torch.checker import streaming, synth
from jepsen_tpu_torch.checker.elle import rw_register_checker
from jepsen_tpu_torch.checker.linear import linearizable

MODEL = models.cas_register()
JMODEL = jmodels.cas_register()
CHUNK = 64
SLOTS = 8        # sized so no history rebuilds mid-stream
FRONTIER = 128
CKPT = 2
TIMING = ("tail-latency-ms", "duration-ms", "violation-at-op")
PORT_ONLY = ("device", "closure-rounds", "dedup-launches", "host-syncs")
# the port's launch and read counts: what this process's stream ran, so
# a recovered stream (its replay) or a resumed one (its skipped prefix)
# counts other work than an uninterrupted run
COUNTS = PORT_ONLY[1:]
BACKOFF = util.backoff


@pytest.fixture(autouse=True)
def _setup(monkeypatch, tmp_path):
    """The JAX package as on its accelerator; both ladders' backoff
    zeroed; injection counters isolated; torch on one thread; the
    calibration cache in the test's directory."""
    monkeypatch.setenv("JEPSEN_TPU_PALLAS_DEDUP", "1")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(util, "backoff", lambda *a, **k: itertools.repeat(0.0))
    monkeypatch.setattr(jretry, "backoff", lambda *a, **k: itertools.repeat(0.0))
    plat.reset_fault_injection()
    jplat.reset_fault_injection()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    plat.reset_fault_injection()
    jplat.reset_fault_injection()


def _canon(x):
    return json.loads(json.dumps(x, default=store._json_default,
                                 sort_keys=True))


def _strip(d, extra=()):
    return _canon({k: v for k, v in d.items()
                   if k not in TIMING + tuple(extra)})


def _cross(port: dict, extra=()) -> dict:
    """A port result as the JAX package writes it: the port-only keys
    dropped and the analyzer's family prefix renamed."""
    d = {k: v for k, v in port.items() if k not in PORT_ONLY}
    if isinstance(d.get("analyzer"), str):
        d["analyzer"] = d["analyzer"].replace("gpu-", "tpu-", 1)
    return _strip(d, extra)


def _jops(h):
    """History ops in the journal's wire form (a JSON round trip)."""
    return [json.loads(json.dumps(op, default=store._json_default))
            for op in h.ops]


def _spec(mspec, **over):
    sp = {"kind": "wgl", "model": mspec, "chunk-entries": CHUNK,
          "slots": SLOTS, "engine": "sort", "frontier": FRONTIER,
          "checkpoint-every": CKPT}
    sp.update(over)
    return sp


def _wgl_spec(**over):
    return _spec(service.model_spec(MODEL), **over)


def _jwgl_spec(**over):
    return _spec(jservice.model_spec(JMODEL), **over)


def _solo(ops, **kw):
    s = streaming.WglStream(MODEL, chunk_entries=CHUNK, slots=SLOTS,
                            frontier=FRONTIER, checkpoint_every=CKPT,
                            device="cpu", **kw)
    for op in ops:
        s.feed(op)
    return s.finish()


_HISTS: dict = {}


def _hist(seed, n=300, corrupt_seed=None, **corrupt):
    """A journal-form history and the port's solo verdict, cached across
    tests (the fault matrix reuses the same siblings)."""
    key = (seed, n, corrupt_seed, tuple(corrupt.items()))
    if key not in _HISTS:
        h = synth.register_history(n, concurrency=3, values=5, seed=seed)
        if corrupt_seed is not None:
            h = synth.corrupt(h, seed=corrupt_seed, **corrupt)
        ops = _jops(h)
        _HISTS[key] = (ops, _solo(ops))
    return _HISTS[key]


def _write_journal(run_dir, ops):
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "journal.jsonl"), "w") as fh:
        for op in ops:
            fh.write(json.dumps(op, default=store._json_default) + "\n")


def _write_history_gz(run_dir, ops):
    with gzip.open(os.path.join(run_dir, "history.jsonl.gz"), "wt") as fh:
        for op in ops:
            fh.write(json.dumps(op, default=store._json_default) + "\n")


def _run_streams(svc, hists, specs):
    """Feed each history concurrently through its own stream."""
    for n in hists:
        svc.admit(n, specs[n])

    def feed(n):
        for op in hists[n]:
            svc.offer(n, op)
        svc.seal(n)

    ths = [threading.Thread(target=feed, args=(n,)) for n in hists]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
        assert not t.is_alive()
    return {n: svc.result(n, timeout_s=300) for n in hists}


# -- the spec functions --------------------------------------------------------

def test_model_spec_roundtrip_matches_jax():
    for m, jm in ((models.cas_register(), jmodels.cas_register()),
                  (models.cas_register(0), jmodels.cas_register(0)),
                  (models.register(3), jmodels.register(3))):
        spec = _canon(service.model_spec(m))
        assert spec == _canon(jservice.model_spec(jm))
        assert service.model_from_spec(spec) == m
        # a spec either package wrote builds the other's model
        assert jservice.model_from_spec(spec) == jm
    with pytest.raises(ValueError):
        service.model_from_spec({"class": "NotAModel"})


@pytest.mark.parametrize("tier", [None, "screen"])
def test_targets_spec_and_build_targets_match_jax(tier):
    t = {"checker": linearizable(models.cas_register(0)),
         "concurrency": 5, "online-chunk-entries": 128,
         "online-state-range": [-1, 4]}
    jt = dict(t, checker=jlinearizable(jmodels.cas_register(0)))
    if tier:
        t["tier"] = jt["tier"] = tier
    spec = _canon(service.targets_spec(t))
    assert spec == _canon(jservice.targets_spec(jt))
    assert set(spec) == ({"linear", "screen-linear"} if tier
                         else {"linear"})
    assert spec["linear"]["chunk-entries"] == 128
    # the rw-register checker's target, with and without extra graphs
    for ag in ((), ("realtime",)):
        t2 = {"checker": rw_register_checker(additional_graphs=ag,
                                             device="cpu"),
              "tier": tier}
        jt2 = dict(t2, checker=jrw_checker(additional_graphs=ag))
        assert _canon(service.targets_spec(t2)) == \
            _canon(jservice.targets_spec(jt2))
    # the wire form builds the same targets in both packages
    ts = service.build_targets(spec, stream_name="x", device="cpu")
    jts = jservice.build_targets(spec, stream_name="x")
    assert sorted(ts) == sorted(jts)
    for name, tgt in ts.items():
        assert type(tgt).__name__ == type(jts[name]).__name__, name
    lin, jlin = ts["linear"], jts["linear"]
    assert lin.fault_site == jlin.fault_site == "stream-chunk/x"
    assert lin.auto_pump is jlin.auto_pump is False
    for attr in ("engine", "p", "chunk", "frontier", "state_range",
                 "checkpoint_every"):
        assert getattr(lin, attr) == getattr(jlin, attr), attr
    assert lin.device == torch.device("cpu")


def test_external_pump_parity():
    """auto_pump=False and one pump(1) per chunk equal the auto-pumped
    stream, in the port and against the JAX stream pumped the same
    way; the fault site and the exported checkpoint agree too."""
    ops = _jops(synth.register_history(300, concurrency=4, values=5,
                                       seed=21))
    auto = _solo(ops)
    s = streaming.WglStream(MODEL, chunk_entries=CHUNK, slots=SLOTS,
                            frontier=FRONTIER, checkpoint_every=CKPT,
                            auto_pump=False, fault_site="stream-chunk/p",
                            device="cpu")
    js = jstreaming.WglStream(JMODEL, chunk_entries=CHUNK, slots=SLOTS,
                              frontier=FRONTIER, checkpoint_every=CKPT,
                              auto_pump=False,
                              fault_site="stream-chunk/p")
    for op in ops:
        s.feed(op)
        js.feed(op)
    assert s.pending_chunks() == js.pending_chunks() > 0
    assert s.kernel_key() is None
    while s.pending_chunks():
        assert s.pump(1) == 1 == js.pump(1)
    assert js.pending_chunks() == 0
    assert s.kernel_key() is not None
    ck, jck = s.export_checkpoint(), js.export_checkpoint()
    for key in ("rows", "chunks", "engine", "p", "chunk", "frontier",
                "packed", "att-steps", "att-carry"):
        assert ck[key] == jck[key], key
    for a, b in zip(ck["carry"], jck["carry"]):
        assert a.dtype == b.dtype and (a == b).all()
    r = s.finish()
    assert _strip(r) == _strip(auto)
    assert _cross(r) == _strip(js.finish())


# -- multiplexing and isolation -------------------------------------------------

def test_service_multiplexes_and_matches_solo_and_jax():
    hists = {"a": _hist(31)[0], "b": _hist(32, corrupt_seed=5)[0]}
    solos = {"a": _hist(31)[1], "b": _hist(32, corrupt_seed=5)[1]}
    svc = service.VerificationService(device="cpu")
    res = _run_streams(svc, hists, {n: {"linear": _wgl_spec()}
                                    for n in hists})
    assert solos["a"]["valid?"] is True
    assert solos["b"]["valid?"] is False
    for n in hists:
        assert _strip(res[n]["linear"]) == _strip(solos[n]), n
    st = svc.status()
    assert st["state"] == "serving"
    assert all(s["state"] == "verdict" for s in st["streams"].values())
    assert st["budget"]["capacity"] == st["budget"]["initial"]
    assert st["calibration"]["platform"] == "cpu"
    svc.stop()
    jsvc = jservice.VerificationService()
    jres = _run_streams(jsvc, hists, {n: {"linear": _jwgl_spec()}
                                      for n in hists})
    jsvc.stop()
    for n in hists:
        assert _cross(res[n]["linear"]) == _strip(jres[n]["linear"]), n


def test_service_dense_and_hash_streams_match_jax():
    """A dense stream (K1's path) and a packed sort stream on the hash
    route (K2's path), multiplexed, equal to their solos and to the JAX
    service's results; each counts its own launches."""
    # the invalid read inside the declared range: no range escape
    ops = {"d": _hist(33, corrupt_seed=7, value=4)[0], "h": _hist(34)[0]}
    over = {"d": dict(engine="auto", **{"state-range": [-1, 4],
                                        "concurrency-hint": 3}),
            "h": {"state-range": [-1, 10 ** 6]}}
    svc = service.VerificationService(device="cpu")
    res = _run_streams(svc, ops, {n: {"linear": _wgl_spec(**over[n])}
                                  for n in ops})
    svc.stop()
    d, h = res["d"]["linear"], res["h"]["linear"]
    assert d["analyzer"] == "gpu-wgl-dense-streaming"
    assert h["dedup"] == "pallas-hash"
    assert d["valid?"] is False and h["valid?"] is True
    assert d["closure-rounds"] > 0 and d["dedup-launches"] == 0
    assert h["dedup-launches"] > 0
    assert _strip(d) == _strip(_solo(ops["d"], engine="auto",
                                     state_range=(-1, 4),
                                     concurrency_hint=3))
    assert _strip(h) == _strip(_solo(ops["h"], state_range=(-1, 10 ** 6)))
    jsvc = jservice.VerificationService()
    jres = _run_streams(jsvc, ops, {n: {"linear": _jwgl_spec(**over[n])}
                                    for n in ops})
    jsvc.stop()
    for n in ops:
        assert _cross(res[n]["linear"]) == _strip(jres[n]["linear"]), n


_FAULTS = {"oom": "oom@stream-chunk/r2:3",
           "device-lost": "device-lost@stream-chunk/r2:3",
           "wedged": "wedged@stream-chunk/r2:3",
           "bitflip": "bitflip@stream-chunk/r2:2",
           "compile": None}


def _compile_fault(monkeypatch, count: int = 3):
    """A kernel that does not build, at r2's third chunk dispatch."""
    seen = []

    def hook(site):
        if site == "stream-chunk/r2":
            seen.append(site)
            if len(seen) == count:
                raise plat.KernelCompileError(
                    "nvcc failed for closure_round: injected")
    monkeypatch.setattr(plat, "fault_hook", hook)


@pytest.mark.parametrize("kind", list(_FAULTS))
def test_service_isolation_fault_matrix(kind, monkeypatch):
    """4 concurrent streams and one fault on r2 (its own fault site):
    the 3 siblings, an invalid one among them, equal their solo runs;
    r2 recovers through its own ladder and checkpoint to its solo
    verdict, except under a compile fault, which the port re-raises: r2
    is quarantined (degraded, with the error), the siblings unchanged.
    Each stream equals the JAX service's under the same fault (the JAX
    stream drops Pallas on a compile fault instead, so that case has no
    JAX run)."""
    seeds = {"r0": (40, None), "r1": (41, 9), "r2": (42, None),
             "r3": (43, None)}
    hists = {n: _hist(sd, corrupt_seed=c)[0]
             for n, (sd, c) in seeds.items()}
    solos = {n: _hist(sd, corrupt_seed=c)[1]
             for n, (sd, c) in seeds.items()}
    assert solos["r1"]["valid?"] is False and "op" in solos["r1"]

    def run(mod, svc, spec):
        if kind == "compile":
            _compile_fault(monkeypatch)
        else:
            monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT", _FAULTS[kind])
        try:
            return _run_streams(svc, hists, {n: {"linear": spec()}
                                             for n in hists})
        finally:
            monkeypatch.delenv("JEPSEN_TPU_FAULT_INJECT", raising=False)
            monkeypatch.setattr(mod, "fault_hook", None)

    svc = service.VerificationService(device="cpu")
    res = run(plat, svc, _wgl_spec)
    for n in ("r0", "r1", "r3"):
        assert _strip(res[n]["linear"]) == _strip(solos[n]), n
    st = svc.status()
    svc.stop()
    if kind == "compile":
        assert res["r2"].get("degraded") is True
        assert "KernelCompileError" in res["r2"]["error"]
        assert st["streams"]["r2"]["state"] == service.QUARANTINED
        assert st["quarantined"] == ["r2"]
        return
    r2 = res["r2"]["linear"]
    rec = r2.get("recovered")
    assert isinstance(rec, dict), f"r2 did not recover: {r2}"
    assert ("corrupt" if kind == "bitflip" else kind) in rec["faults"]
    assert rec.get("resumed-from-chunk") is not None
    assert _strip(r2, ("recovered", "attested") + COUNTS) == \
        _strip(solos["r2"], ("recovered", "attested") + COUNTS)
    assert st["streams"]["r2"]["recoveries"] >= 1
    if kind == "bitflip":
        assert st["streams"]["r2"]["attest-failures"] >= 1
    if kind == "oom":
        assert st["budget"]["ooms"] == 1
        assert st["budget"]["capacity"] < st["budget"]["initial"]
    jplat.reset_fault_injection()
    jsvc = jservice.VerificationService()
    jres = run(jplat, jsvc, _jwgl_spec)
    jsvc.stop()
    for n in hists:
        assert _cross(res[n]["linear"]) == _strip(jres[n]["linear"]), n


def test_service_quarantine_contains_unclassified():
    """A checker bug (unclassified exception) quarantines ONLY its
    stream, degraded with the error attached, while a sibling runs to a
    clean verdict."""
    svc = service.VerificationService(device="cpu")
    wb = svc.admit("bad", {"linear": _wgl_spec()})
    svc.admit("good", {"linear": _wgl_spec()})

    def boom(max_chunks=None):
        raise TypeError("checker bug, not a device fault")

    wb.targets["linear"].pump = boom
    for n, ops in (("bad", _hist(43)[0]), ("good", _hist(42)[0])):
        for op in ops:
            svc.offer(n, op)
        svc.seal(n)
    rb = svc.result("bad", timeout_s=60)
    rg = svc.result("good", timeout_s=300)
    assert rb.get("degraded") is True
    assert "checker bug" in rb.get("error", "")
    assert _strip(rg["linear"]) == _strip(_hist(42)[1])
    st = svc.status()
    assert st["streams"]["bad"]["state"] == "quarantined"
    assert st["streams"]["good"]["state"] == "verdict"
    assert st["quarantined"] == ["bad"]
    svc.stop()


def test_service_shed_backpressure_deferred(tmp_path, monkeypatch):
    """A stream whose bounded queue stays full past shed_timeout_s is
    shed: a deferred marker in its run dir, empty results (offline
    analyze covers it from the journal), siblings unaffected."""
    run_dir = str(tmp_path / "store" / "shed" / "t0")
    os.makedirs(run_dir)
    svc = service.VerificationService(queue_ops=4, shed_timeout_s=0.3,
                                      device="cpu")
    w = svc.admit("slow", {"linear": _wgl_spec()}, store_dir=run_dir)
    monkeypatch.setattr(w, "_feed", lambda op: time.sleep(30))
    shed = False
    for op in _hist(61)[0]:
        if not svc.offer("slow", op):
            shed = True
            break
    assert shed and w.state == service.SHED
    assert svc.result("slow", timeout_s=10) == {}
    sr = store.load_streamed_results(run_dir)
    assert sr["deferred"] is True and "backpressure" in sr["reason"]
    ops, solo = _hist(62)
    svc.admit("fine", {"linear": _wgl_spec()})
    for op in ops:
        svc.offer("fine", op)
    svc.seal("fine")
    assert _strip(svc.result("fine", timeout_s=300)["linear"]) == \
        _strip(solo)
    assert svc.status()["shed"] == ["slow"]


def test_service_admission_control():
    svc = service.VerificationService(max_streams=1, device="cpu")
    svc.admit("only", {"linear": _wgl_spec()})
    with pytest.raises(service.AdmissionRefused):
        svc.admit("more", {"linear": _wgl_spec()})
    with pytest.raises(service.AdmissionRefused):
        svc.admit("only", {"linear": _wgl_spec()})   # name collision
    assert svc.status()["refused-total"] == 2
    svc.drain()
    with pytest.raises(service.AdmissionRefused):
        svc.admit("late", {"linear": _wgl_spec()})
    assert svc.status()["state"] == "drained"


def test_service_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service.VerificationService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service.ServiceClient("127.0.0.1:1", {"name": "x"},
                              spec={"linear": _wgl_spec()})


def test_concurrent_drain_does_not_hold_service_lock():
    """A second drain() waits for the first OUTSIDE _lock: every
    service verb's worker lookup takes _lock."""
    svc = service.VerificationService(device="cpu")
    with svc._lock:
        svc.draining = True     # a first drainer in flight
    t = threading.Thread(target=svc.drain, kwargs={"timeout_s": 2.0},
                         daemon=True)
    t.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    st = svc.status()
    took = time.monotonic() - t0
    assert st["state"] == "draining"
    assert took < 0.5, f"status() blocked {took:.2f}s behind drain()"
    svc.drained.set()
    t.join(timeout=5)
    assert not t.is_alive()


# -- drain and resume -----------------------------------------------------------

def _drain_half(svc, name, run_dir, ops, spec, sigterm=False):
    """Admit a stream with a store dir, feed half its ops, wait for its
    first carry checkpoint, and drain (by SIGTERM when asked)."""
    svc.admit(name, {"linear": spec}, store_dir=run_dir)
    for op in ops[:len(ops) // 2]:
        svc.offer(name, op)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        w = svc._worker(name)
        if w.targets["linear"]._ckpt is not None and w.q.empty():
            break
        time.sleep(0.02)
    if sigterm:
        old = signal.getsignal(signal.SIGTERM)
        try:
            svc.install_sigterm()
            os.kill(os.getpid(), signal.SIGTERM)   # the handler drains
            assert svc.drained.wait(60)
        finally:
            signal.signal(signal.SIGTERM, old)
    else:
        svc.drain()
    assert svc.status()["streams"][name]["state"] == service.DRAINED


@pytest.mark.parametrize("seed,corrupt", [(73, False), (74, True)])
def test_sigterm_drain_then_resume_identical(tmp_path, seed, corrupt):
    """SIGTERM mid-stream, then a fresh service resumes from the carry
    checkpoint manifest to a verdict identical to an uninterrupted
    run's, valid and invalid (blame)."""
    ops, solo = _hist(seed, n=600, corrupt_seed=3 if corrupt else None)
    run_dir = str(tmp_path / "store" / "drain" / "t0")
    _write_journal(run_dir, ops)
    svc = service.VerificationService(device="cpu")
    _drain_half(svc, "t0", run_dir, ops, _wgl_spec(), sigterm=True)
    man = store.load_service_resume(run_dir)
    ck = man["checkpoints"]["linear"]
    assert ck["chunks"] >= 1 and ck["pallas"] is True
    _write_history_gz(run_dir, ops)
    svc2 = service.VerificationService(device="cpu")
    assert svc2.resume(run_dir) == "t0"
    r = svc2.result("t0", timeout_s=300)
    assert _strip(r["linear"], COUNTS) == _strip(solo, COUNTS)
    st = svc2.status()["streams"]["t0"]["chunks"]["linear"]
    assert st["resumed-from-chunk"] == ck["chunks"]
    assert st["chunk-syncs"] < solo["chunks"]
    assert store.load_service_resume(run_dir) is None
    assert store.load_test(run_dir)["streamed-results"]["linear"][
        "valid?"] == r["linear"]["valid?"]
    svc2.stop()


@pytest.mark.parametrize("drainer", ["jax", "port"])
def test_drain_resumes_across_packages(tmp_path, drainer):
    """A JAX service's drain resumes in the port's service, and a port
    drain in the JAX service: the manifest and the npz carries are in
    the JAX layout. The same manifest resumed by each package gives
    equal results; both skip the checkpointed prefix and reach the
    uninterrupted run's verdict."""
    import shutil
    ops, solo = _hist(74, n=600, corrupt_seed=3)
    run_dir = str(tmp_path / "store" / "x" / "t0")
    _write_journal(run_dir, ops)
    if drainer == "jax":
        first, spec = jservice.VerificationService(), _jwgl_spec()
    else:
        first, spec = service.VerificationService(device="cpu"), _wgl_spec()
    _drain_half(first, "t0", run_dir, ops, spec)
    ck = store.load_service_resume(run_dir)["checkpoints"]["linear"]
    assert ck["chunks"] >= 1
    _write_history_gz(run_dir, ops)
    other = str(tmp_path / "store" / "y" / "t0")
    shutil.copytree(run_dir, other)
    out = {}
    for pkg, d, svc in (("port", run_dir,
                         service.VerificationService(device="cpu")),
                        ("jax", other, jservice.VerificationService())):
        assert svc.resume(d) == "t0"
        out[pkg] = svc.result("t0", timeout_s=300)["linear"]
        st = svc.status()["streams"]["t0"]["chunks"]["linear"]
        svc.stop()
        assert st["resumed-from-chunk"] == ck["chunks"], pkg
    assert _cross(out["port"]) == _strip(out["jax"])
    assert _strip(out["port"], COUNTS) == _strip(solo, COUNTS)


def test_watch_admits_tails_and_seals_a_port_journal(tmp_path):
    """Store watching over a journal the port's `store.Journal` writes:
    admitted through spec_fn, tailed, and sealed to a verdict once
    history.jsonl.gz lands."""
    base = str(tmp_path / "store")
    test = {"name": "watched", "start-time": "t1", "store-dir": base}
    run_dir = store.dir_name(test)
    ops, solo = _hist(81)
    j = store.open_journal(test)
    for op in ops[:100]:
        j.append(op)
    j.flush()
    svc = service.VerificationService(device="cpu")
    svc.watch(base, spec_fn=lambda d: {"linear": _wgl_spec()},
              scan_interval_s=0.05)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not svc.workers:
        time.sleep(0.02)
    assert svc.workers, "watcher never admitted the run"
    name = next(iter(svc.workers))
    assert name == "watched/t1"
    for op in ops[100:]:
        j.append(op)
    j.close()
    _write_history_gz(run_dir, ops)
    r = svc.result(name, timeout_s=300)
    assert _strip(r["linear"]) == _strip(solo)
    assert store.load_streamed_results(run_dir)["linear"]["valid?"] is True
    svc.stop()


# -- the socket layer -----------------------------------------------------------

def _socket_session(svc, spec, ops):
    """One scripted session over a TCP socket: attach, ops, poll,
    status, finish, an unknown verb. Returns the replies in order."""
    import socket as _socket
    addr = svc.serve("127.0.0.1:0")
    host, _, port = addr.rpartition(":")
    conn = _socket.create_connection((host, int(port)))
    rf = conn.makefile("r")

    def req(msg):
        conn.sendall((json.dumps(msg) + "\n").encode())
        return json.loads(rf.readline())

    out = [req({"type": "attach", "stream": "s1",
                "targets": {"linear": spec}, "id": 1})]
    for op in ops:
        conn.sendall((json.dumps({"type": "op", "op": op}) + "\n").encode())
    out.append(req({"type": "poll", "id": 2}))
    out.append(req({"type": "status", "id": 3}))
    out.append(req({"type": "finish", "id": 4}))
    out.append(req({"type": "warp", "id": 5}))
    conn.close()
    svc.stop()
    return out


def test_socket_protocol_and_status_match_jax():
    ops, solo = _hist(91)
    got = _socket_session(service.VerificationService(device="cpu"),
                          _wgl_spec(), ops)
    want = _socket_session(jservice.VerificationService(), _jwgl_spec(),
                           ops)
    (att, poll, st, fin, bad), (jatt, jpoll, jst, jfin, jbad) = got, want
    assert att == jatt == {"ok": True, "stream": "s1",
                           "targets": ["linear"], "id": 1}
    assert poll == jpoll
    assert bad == jbad
    assert st["ok"] and set(st["status"]) == set(jst["status"])
    for key in ("state", "admitted-total", "refused-total", "shed",
                "quarantined", "sessions", "epoch", "fenced"):
        assert st["status"][key] == jst["status"][key], key
    assert set(st["status"]["streams"]["s1"]) == \
        set(jst["status"]["streams"]["s1"])
    assert fin["state"] == jfin["state"] == service.VERDICT
    assert _strip(fin["results"]["linear"]) == _strip(solo)
    assert _cross(fin["results"]["linear"]) == \
        _strip(jfin["results"]["linear"])


def test_service_client_abort_on_violation():
    bad = _jops(synth.register_history(2000, concurrency=3, values=5,
                                       seed=92))
    for op in bad[200:]:
        if op.get("type") == "ok" and op.get("f") == "read":
            op["value"] = 99     # never written: the frontier dies early
            break
    svc = service.VerificationService(device="cpu")
    addr = svc.serve("127.0.0.1:0")
    t = {"name": "abort", "start-time": "now",
         "abort-on-violation": True, "store-dir": None}
    c = service.ServiceClient(addr, t, spec={"linear": _wgl_spec()},
                              device="cpu")
    aborted = False
    for op in bad:
        c.offer(op)
        if c.should_abort():
            aborted = True
            break
        time.sleep(0.0005)
    deadline = time.monotonic() + 30
    while not aborted and time.monotonic() < deadline:
        aborted = c.should_abort()
        time.sleep(0.05)
    assert aborted, "violation never surfaced through poll"
    c.close()
    svc.stop()


def test_refused_attach_falls_back_to_local_online():
    """A refused (or unreachable) attach returns None and the run checks
    with the port's own online checker; without device='cpu' the
    attach raises here, where there is no card."""
    svc = service.VerificationService(max_streams=0, device="cpu")
    addr = svc.serve("127.0.0.1:0")
    t = {"name": "x", "start-time": "t", "service": addr, "online": True,
         "checker": linearizable(models.cas_register(0), device="cpu"),
         "concurrency": 4}
    assert service.maybe_attach(t, device="cpu") is None
    local = service.maybe_attach(t, device="cpu") or \
        streaming.maybe_online(t)
    assert isinstance(local, streaming.OnlineChecker)
    ops, solo = _hist(93)
    for op in ops:
        local.offer(op)
    r = local.finalize()
    assert r["linear"]["valid?"] is True
    t["service"] = "127.0.0.1:1"             # nothing listens here
    assert service.maybe_attach(t, device="cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            service.maybe_attach(t)
    svc.stop()


# -- the budget -----------------------------------------------------------------

def _budget_script(mod):
    """One scripted acquire / release / note_oom / queue-depth sequence
    on a fresh budget; returns its status() after every step."""
    b = mod.ChunkBudget(1.0, hysteresis_s=0.0)
    out = []
    for cost, secs, clean in ((0.25, 0.01, True), (0.5, 0.02, True),
                              (2.0, 0.5, False), (0.1, 3.0, True)):
        assert b.acquire(cost, timeout_s=1.0)
        out.append(b.status())
        b.release(cost, clean=clean, seconds=secs)
        out.append(b.status())
    b.note_oom()
    b.note_queue_depth(5000)
    out.append(b.status())
    for secs in (0.01, 1.5, 0.01, 0.01):
        assert b.acquire(0.05, priority=1)
        b.release(0.05, seconds=secs)
        out.append(b.status())
    out.append(b.signals() | {"recent_cut": None})
    return out


# the port's budget also grants the one walk: its status and signals add
# the p95 wait for it, which the JAX budget has no counterpart for
_WALK_KEYS = ("p95-walk-wait-s", "p95_walk_wait_s")


def test_chunk_budget_status_matches_jax():
    port = _budget_script(service)
    for st in port:
        wait = st.get("p95-walk-wait-s", st.get("p95_walk_wait_s"))
        assert 0.0 <= wait < 1.0    # one acquirer: it never waits
    port = [{k: v for k, v in st.items() if k not in _WALK_KEYS}
            for st in port]
    assert _canon(port) == _canon(_budget_script(jservice))
    for name in ("DEFAULT_BUDGET_ELEMENTOPS", "BUDGET_FLOOR_FRACTION",
                 "BUDGET_RESTORE_STEP", "BUDGET_HYSTERESIS_S",
                 "BUDGET_BLOWOUT_P95_S", "BUDGET_AGING_S",
                 "BUDGET_LATENCY_WINDOW", "BUDGET_HUNGRY_ROWS",
                 "LADDER_CLIMB_HOLD_S", "LADDER_DESCEND_HOLD_S",
                 "LADDER_SAMPLE", "REPRICE_EVERY_CHUNKS", "MAX_LINE_BYTES",
                 "ACK_EVERY", "TIER_NAMES"):
        assert getattr(service, name) == getattr(jservice, name), name


def _until(pred, timeout_s: float = 30.0):
    end = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < end, "condition not reached"
        time.sleep(0.005)


def _walker(b, order, name, priority=0, hold=None):
    """A thread that takes the walk, notes it in `order`, holds it until
    `hold` is set (when given), and gives it back."""
    def run():
        assert b.acquire(0.4, timeout_s=30, priority=priority)
        order.append(name)
        if hold is not None:
            assert hold.wait(30)
        b.release(0.4)
    th = threading.Thread(target=run)
    th.start()
    return th


def test_budget_grants_one_walk_at_a_time_in_priority_order():
    """A chunk waiting for the walk is not in flight: while one walks,
    the others queue for the walk, even after an OOM has halved
    capacity below two chunks, the service does not read that queue as
    overload, and the walk goes to a suspect (priority 1) before an
    older clean waiter."""
    svc = service.VerificationService(device="cpu")
    # no waiter ages past the priority order, however slow the machine
    b = svc.budget = service.ChunkBudget(1.0, aging_s=600.0)
    order, hold = [], threading.Event()
    first = _walker(b, order, "first", hold=hold)
    _until(lambda: order == ["first"])
    b.note_oom()                    # capacity 0.5: two chunks of 0.4 no
    clean = _walker(b, order, "clean")
    _until(lambda: b.status()["waiters"] == 1)
    suspect = _walker(b, order, "suspect", priority=1)
    _until(lambda: b.status()["waiters"] == 2)
    st = b.status()
    assert st["capacity"] == 0.5 * st["initial"]
    assert st["available"] == pytest.approx(0.1)   # the walker's 0.4 alone
    assert not svc.overloaded()
    hold.set()
    for th in (first, clean, suspect):
        th.join(30)
    assert order == ["first", "suspect", "clean"]
    assert b.status()["waiters"] == 0
    assert b.status()["p95-walk-wait-s"] > 0.0
    svc.stop()


def test_budget_walk_goes_to_an_aged_waiter_before_a_fresh_suspect():
    """Grants follow one total order, so a free walk always has a taker:
    a clean waiter aged past `aging_s` walks before a suspect that came
    later, then the suspect (neither may block the other)."""
    b = service.ChunkBudget(1.0, aging_s=0.05)
    order, hold = [], threading.Event()
    first = _walker(b, order, "first", hold=hold)
    _until(lambda: order == ["first"])
    clean = _walker(b, order, "clean")
    _until(lambda: b.status()["waiters"] == 1)
    time.sleep(0.1)                 # the clean waiter ages
    suspect = _walker(b, order, "suspect", priority=1)
    _until(lambda: b.status()["waiters"] == 2)
    hold.set()
    for th in (first, clean, suspect):
        th.join(30)
    assert order == ["first", "clean", "suspect"]


def test_budget_lend_passes_the_walk_on_and_takes_it_back_first():
    """A walker that lends its walk for host work lets a waiter walk
    meanwhile (its own cost off the ledger), and comes back ahead of a
    suspect that queued after it; a thread holding no walk lends
    nothing."""
    b = service.ChunkBudget(1.0)
    with b.lend():
        pass
    assert b.status()["available"] == 1.0
    order, go, hold = [], threading.Event(), threading.Event()

    def lender():
        assert b.acquire(0.3)
        with b.lend():
            order.append("lent")
            assert go.wait(30)
        order.append("back")
        b.release(0.3)

    lt = threading.Thread(target=lender)
    lt.start()
    _until(lambda: order == ["lent"])
    borrower = _walker(b, order, "borrowed", hold=hold)
    _until(lambda: order == ["lent", "borrowed"])
    assert b.status()["available"] == pytest.approx(0.6)
    go.set()                        # the lender wants its walk back
    _until(lambda: b._returning == 1)
    suspect = _walker(b, order, "suspect", priority=1)
    _until(lambda: b.status()["waiters"] == 1)
    hold.set()
    for th in (lt, borrower, suspect):
        th.join(30)
    assert order == ["lent", "borrowed", "back", "suspect"]
    assert b.status()["available"] == 1.0


@pytest.mark.parametrize("host_work", ["explain", "backoff"])
def test_host_work_inside_a_walk_does_not_stall_a_sibling(host_work,
                                                          monkeypatch):
    """A stream's host-only work inside its walk (the blame's
    explanation at an invalid stream's finish; the recovery ladder's
    backoff after a device fault) lends the walk out: a sibling admitted
    while that work runs reaches its verdict before it ends, and both
    verdicts equal their solo runs."""
    (ops, solo), (sib_ops, sib_solo) = _hist(
        41 if host_work == "explain" else 42,
        corrupt_seed=9 if host_work == "explain" else None), _hist(40)
    entered, sibling_done = threading.Event(), threading.Event()
    if host_work == "explain":
        from jepsen_tpu_torch.checker import linear
        explain = linear.explain_failure

        def slow_explain(*a, **k):
            entered.set()
            sibling_done.wait(40)
            return explain(*a, **k)
        monkeypatch.setattr(linear, "explain_failure", slow_explain)
    else:
        def slow_backoff(*a, **k):
            entered.set()
            sibling_done.wait(40)
            yield from itertools.repeat(0.0)
        monkeypatch.setattr(util, "backoff", slow_backoff)
        monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT",
                           "device-lost@stream-chunk/slow:3")
    svc = service.VerificationService(device="cpu")
    svc.admit("slow", {"linear": _wgl_spec()})
    for op in ops:
        svc.offer("slow", op)
    svc.seal("slow")
    assert entered.wait(60)
    svc.admit("sib", {"linear": _wgl_spec()})
    for op in sib_ops:
        svc.offer("sib", op)
    svc.seal("sib")
    sib = svc.result("sib", timeout_s=30)
    waited = not sibling_done.is_set()
    sibling_done.set()
    slow = svc.result("slow", timeout_s=60)
    svc.stop()
    assert waited and "linear" in sib, "the sibling waited for host work"
    assert _strip(sib["linear"]) == _strip(sib_solo)
    skip = ("recovered", "attested") + COUNTS
    assert _strip(slow["linear"], skip) == _strip(solo, skip)
    if host_work == "explain":
        assert "op" in slow["linear"] and slow["linear"]["configs"]
    else:
        assert slow["linear"]["recovered"]["faults"] == ["device-lost"]


def test_chunk_cost_matches_jax():
    """A stream's chunk price (modeled element-ops, variant, reason)
    equals the JAX service's for the same stream shape."""
    for kw in ({}, {"engine": "auto", "state_range": (-1, 4)},
               {"state_range": (-1, 10 ** 6)}):
        s = streaming.WglStream(MODEL, chunk_entries=CHUNK, slots=SLOTS,
                                frontier=FRONTIER, device="cpu", **kw)
        js = jstreaming.WglStream(JMODEL, chunk_entries=CHUNK, slots=SLOTS,
                                  frontier=FRONTIER, **kw)
        p, jp = service.chunk_cost(s), jservice.chunk_cost(js)
        assert (p.cost, p.elementops, p.variant, p.reason) == \
            (jp.cost, jp.elementops, jp.variant, jp.reason), kw


# -- the store satellites ---------------------------------------------------------

def test_journal_unsubscribe_is_synchronous(tmp_path):
    """Once unsubscribe() returns, the callback is never called again,
    even while another thread is appending."""
    j = store.Journal(str(tmp_path / "j.jsonl"))
    seen = []
    in_cb = threading.Event()
    release = threading.Event()

    def cb(op):
        seen.append(op["i"])
        if op["i"] == 0:
            in_cb.set()
            release.wait(5)

    unsub = j.subscribe(cb)
    t = threading.Thread(target=lambda: [j.append({"i": i, "type": "ok",
                                                   "process": 0})
                                         for i in range(3)])
    t.start()
    assert in_cb.wait(5)
    done = threading.Event()
    u = threading.Thread(target=lambda: (unsub(), done.set()))
    u.start()
    time.sleep(0.05)
    assert not done.is_set()        # waits out the in-flight delivery
    release.set()
    u.join(5)
    t.join(5)
    assert done.is_set() and not t.is_alive()
    n = len(seen)
    j.append({"i": 9, "type": "ok", "process": 0})
    assert len(seen) == n
    j.close()


def test_journal_tail_idle_backoff(tmp_path, monkeypatch):
    """Empty polls walk `util.backoff`'s jittered schedule (within
    [base, cap]); data resets it to zero; a torn line waits for its end;
    a closed tail polls nothing."""
    import random
    monkeypatch.setattr(util, "backoff", BACKOFF)
    p = str(tmp_path / "journal.jsonl")
    tail = store.JournalTail(p, idle_base_s=0.01, idle_cap_s=0.2,
                             rng=random.Random(3))
    assert tail.poll() == [] and tail.idle_s == 0.01
    for _ in range(10):
        tail.poll()
        assert 0.01 <= tail.idle_s <= 0.2
    with open(p, "w") as fh:
        fh.write('{"a": 1}\n{"a": ')
    assert tail.poll() == [{"a": 1}] and tail.idle_s == 0.0
    with open(p, "a") as fh:
        fh.write('2}\n')
    assert tail.poll() == [{"a": 2}]
    with open(p, "a") as fh:
        fh.write('oops\n')
    with pytest.raises(ValueError):
        tail.poll()
    tail.close()
    assert tail.poll() == []


def test_resume_manifest_and_results_load_in_both_packages(tmp_path):
    """A manifest (with an npz carry) and streamed results written by
    one package's store load in the other's, arrays intact; load_test
    surfaces the streamed results."""
    import numpy as np
    carry = [np.arange(6, dtype=np.int32).reshape(2, 3),
             np.array([1, 0], dtype=np.uint32), np.int32(7)]
    man = {"stream": "t/0", "targets": {"linear": _wgl_spec()},
           "ops-fed": 10, "journal-offset": 10, "epoch": 0,
           "checkpoints": {"linear": {"chunks": 3, "rows": 99,
                                      "carry": carry}}}
    for i, (w, r) in enumerate(((store, jstore), (jstore, store))):
        d = str(tmp_path / f"run{i}")
        w.write_service_resume(d, man)
        got = r.load_service_resume(d)
        assert got["stream"] == "t/0" and got["ops-fed"] == 10
        ck = got["checkpoints"]["linear"]
        assert ck["chunks"] == 3
        for a, b in zip(ck["carry"], carry):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert (np.asarray(a) == np.asarray(b)).all()
        w.write_streamed_results(d, {"linear": {"valid?": True}})
        assert r.load_streamed_results(d) == {"linear": {"valid?": True}}
        _write_journal(d, _hist(61)[0][:10])
        assert r.load_test(d)["streamed-results"]["linear"]["valid?"]
        r.clear_service_resume(d)
        assert w.load_service_resume(d) is None
    assert sorted(store.tests(str(tmp_path))) == \
        sorted(jstore.tests(str(tmp_path)))


# -- the kernel plumbing under concurrent streams ---------------------------------

def _at_once(n, fn):
    """Run fn(i) on n threads released together; re-raise any error."""
    import sys
    errs = []
    gate = threading.Barrier(n)

    def run(i):
        try:
            gate.wait(10)
            fn(i)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    if errs:
        raise errs[0]


def test_library_first_use_from_eight_threads_builds_once(monkeypatch):
    from jepsen_tpu_torch import _build
    built, loaded = [], []

    def slow_build(names=None):
        built.append(tuple(names))
        time.sleep(0.05)
        return {}

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda p: loaded.append(p) or object())
    _build.library.cache_clear()
    got = []
    try:
        _at_once(8, lambda i: got.append(_build.library(
            ("closure_round", "dedup")[i % 2])))
    finally:
        _build.library.cache_clear()
    assert sorted(built) == [("closure_round",), ("dedup",)]
    assert len(loaded) == 2 and len({id(g) for g in got}) == 2


def test_build_from_eight_threads_runs_nvcc_once_per_source(monkeypatch,
                                                            tmp_path):
    """Concurrent build() calls on a fresh build directory start one
    compiler per source; each compile writes a temporary file named by
    process and thread before its rename."""
    import subprocess as sp
    from jepsen_tpu_torch import _build
    runs = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            runs.append(os.path.basename(out))
            time.sleep(0.05)
            with open(out, "w") as fh:
                fh.write("lib")
            self.returncode = 0

        def communicate(self):
            return ("ok", None)

        def poll(self):
            return 0

    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(sp, "Popen", FakeNvcc)
    _at_once(8, lambda i: _build.build())
    assert sorted(r.split(".so.")[0] for r in runs) == \
        [f"lib{n}" for n in _build.sources()]
    pid = str(os.getpid())
    assert all(r.split(".")[2] == pid and r.endswith(".tmp")
               and len(r.split(".")) == 5 for r in runs)
    assert sorted(p.name for p in tmp_path.glob("*.so")) == \
        sorted(f"lib{n}.so" for n in _build.sources())


def test_launch_counters_stay_exact_across_threads(monkeypatch):
    """8 threads x 1,000 wrapper launches (the library stubbed, tensors
    on the meta device so the wrappers take their launch path) leave
    each LAUNCHES at exactly 8,000 more."""
    import contextlib
    from jepsen_tpu_torch.checker import wgl_closure, wgl_dedup

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    ok = lambda *a: 0  # noqa: E731 — the stubbed launch succeeds
    monkeypatch.setattr(wgl_closure, "_kernel", lambda: (ok, None))
    monkeypatch.setattr(wgl_closure, "_check",
                        lambda t, m: (1, 8, 16, 4))
    monkeypatch.setattr(wgl_dedup, "_kernel",
                        lambda: (ok, lambda *a: 0, None, None))
    monkeypatch.setattr(wgl_dedup, "_check", lambda k, F: (1, 64))
    table = torch.zeros((8, 16), dtype=torch.bool, device="meta")
    mft = torch.zeros((4, 8, 8), dtype=torch.uint8, device="meta")
    keys = torch.zeros(64, dtype=torch.int32, device="meta")
    k1, k2 = wgl_closure.LAUNCHES, wgl_dedup.LAUNCHES

    def launch(i):
        for _ in range(1000):
            wgl_closure.closure_round(table, mft)
            wgl_dedup.dedup(keys, 16)

    _at_once(8, launch)
    assert wgl_closure.LAUNCHES - k1 == 8000
    assert wgl_dedup.LAUNCHES - k2 == 8000


def test_concurrent_streams_count_their_own_work():
    """Two streams walked from two threads at once, a dense and a hash
    one: each result counts its own closure rounds and dedups, equal to
    the same stream walked alone."""
    cases = {"d": (_hist(33, corrupt_seed=7, value=4)[0],
                   dict(engine="auto", state_range=(-1, 4))),
             "h": (_hist(34)[0], dict(state_range=(-1, 10 ** 6)))}
    alone = {n: _solo(ops, **kw) for n, (ops, kw) in cases.items()}
    together = {}
    names = sorted(cases)
    _at_once(2, lambda i: together.__setitem__(
        names[i], _solo(cases[names[i]][0], **cases[names[i]][1])))
    for n in names:
        for key in COUNTS:
            assert together[n][key] == alone[n][key], (n, key)
    assert together["d"]["closure-rounds"] > 0
    assert together["h"]["dedup-launches"] > 0
