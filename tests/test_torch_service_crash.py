"""Crash consistency of the port's verification service, after the JAX
package's tests/test_service_crash.py, on the CPU: durable periodic
checkpoints, `recover()` after an ungraceful death (a service abandoned
mid-stream, no drain), a corrupt manifest or a truncated carry npz
starting cold, epoch fencing, and standby promotion; the resumed
verdicts equal uninterrupted solo runs as canonical JSON (without the
timing fields, and without the port's launch counts where a stream
resumed: it skipped the checkpointed prefix). The recovered streams
also equal the JAX service's recovery of the same store.

And the daemon (`python -m jepsen_tpu_torch service`) in a subprocess:
`--device cpu` with `--watch` and `--metrics-port 0`, a run attached
through `ServiceClient`, `/metrics` and `/healthz`, a real SIGTERM
(exit 0, a resume manifest in the run's store dir), and a restarted
`--watch` daemon writing the uninterrupted verdict into
streamed-results.json; without `--device` the command exits non-zero
here, where there is no card. The JAX package's SIGKILL smoke (a
subprocess killed at a random point) is marked slow there and has no
copy here: the in-process abandonment below covers `recover()`.
"""

from __future__ import annotations

import gzip
import itertools
import json
import os
import shutil
import socket as _socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

import jepsen_tpu._platform as jplat
from jepsen_tpu import service as jservice
from jepsen_tpu_torch import _platform as plat
from jepsen_tpu_torch import models, service, store, util
from jepsen_tpu_torch.checker import streaming, synth

MODEL = models.cas_register()
CHUNK = 64
SLOTS = 8
FRONTIER = 128
CKPT = 2
TIMING = ("tail-latency-ms", "duration-ms", "violation-at-op")
PORT_ONLY = ("device", "closure-rounds", "dedup-launches", "host-syncs")
COUNTS = PORT_ONLY[1:]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _setup(monkeypatch, tmp_path):
    monkeypatch.setenv("JEPSEN_TPU_PALLAS_DEDUP", "1")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(util, "backoff", lambda *a, **k: itertools.repeat(0.0))
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


def _cross(port: dict) -> dict:
    d = {k: v for k, v in port.items() if k not in PORT_ONLY}
    d["analyzer"] = d["analyzer"].replace("gpu-", "tpu-", 1)
    return _strip(d)


def _jops(h):
    return [json.loads(json.dumps(op, default=store._json_default))
            for op in h.ops]


def _solo(ops):
    s = streaming.WglStream(MODEL, chunk_entries=CHUNK, slots=SLOTS,
                            frontier=FRONTIER, checkpoint_every=CKPT,
                            device="cpu")
    for op in ops:
        s.feed(op)
    return s.finish()


def _wgl_spec(**over):
    sp = {"kind": "wgl", "model": service.model_spec(MODEL),
          "chunk-entries": CHUNK, "slots": SLOTS, "engine": "sort",
          "frontier": FRONTIER, "checkpoint-every": CKPT}
    sp.update(over)
    return sp


def _write_journal(run_dir, ops):
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "journal.jsonl"), "w") as fh:
        for op in ops:
            fh.write(json.dumps(op, default=store._json_default) + "\n")


def _write_history_gz(run_dir, ops):
    with gzip.open(os.path.join(run_dir, "history.jsonl.gz"), "wt") as fh:
        for op in ops:
            fh.write(json.dumps(op, default=store._json_default) + "\n")


def _wait(pred, timeout_s=60.0, interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval_s)
    return None


def _wait_results(run_dir, timeout_s=120.0):
    got = _wait(lambda: store.load_streamed_results(run_dir), timeout_s)
    assert got is not None, f"no streamed results in {run_dir}"
    return got


_HISTS: dict = {}


def _hist(seed, n=300, corrupt_seed=None):
    key = (seed, n, corrupt_seed)
    if key not in _HISTS:
        h = synth.register_history(n, concurrency=3, values=5, seed=seed)
        if corrupt_seed is not None:
            h = synth.corrupt(h, seed=corrupt_seed)
        ops = _jops(h)
        _HISTS[key] = (ops, _solo(ops))
    return _HISTS[key]


# -- durable periodic checkpoints and recover() --------------------------------

def test_periodic_checkpoints_persist_without_drain(tmp_path):
    """Every checkpoint_every cycle the worker persists the exported
    carry, journal offset and attestation tallies atomically; the
    manifest is cleared once the verdict lands."""
    ops, solo = _hist(52)
    run_dir = str(tmp_path / "t" / "0")
    os.makedirs(run_dir)
    svc = service.VerificationService(device="cpu")
    w = svc.admit("t/0", {"linear": _wgl_spec()}, store_dir=run_dir)
    for op in ops:
        assert w.offer(op, 5.0)
    assert _wait(lambda: (store.load_service_resume(run_dir)
                          or {}).get("checkpoints"), 60.0)
    man = store.load_service_resume(run_dir)
    ck = man["checkpoints"]["linear"]
    assert "carry" in ck and ck["chunks"] >= 1
    assert man["stream"] == "t/0" and man["epoch"] == 0
    assert isinstance(man["journal-offset"], int)
    w.seal()
    assert w.done.wait(60.0)
    assert _strip(w.results["linear"]) == _strip(solo)
    assert store.load_service_resume(run_dir) is None
    svc.stop()


@pytest.mark.parametrize("seed,corrupt", [(42, None), (43, 6)])
def test_recover_after_an_ungraceful_death(tmp_path, seed, corrupt):
    """A service abandoned mid-stream (no drain: only its periodic
    manifest survives) is recovered by a fresh service from the last
    durable checkpoint to the uninterrupted verdict; the JAX service
    recovers a copy of the same store to the same result."""
    # 400 ops with 8 slots: no slot-overflow rebuild, whose replay would
    # re-dispatch (and re-attest) a pump-schedule-dependent count
    ops, solo = _hist(seed, n=400, corrupt_seed=corrupt)
    root = str(tmp_path / "st")
    d = os.path.join(root, "t", "0")
    _write_journal(d, ops)
    dead = service.VerificationService(device="cpu")
    dead.claim_store(root)
    w = dead.admit("t/0", {"linear": _wgl_spec()}, store_dir=d)
    for op in ops[:len(ops) // 2]:
        w.offer(op, 5.0)
    assert _wait(lambda: ((store.load_service_resume(d) or {}).get(
        "checkpoints") or {}).get("linear", {}).get("chunks", 0) >= 1)
    # the "crash": the worker is cut off from the store and abandoned
    dead._fenced = True
    dead.stop()
    _write_history_gz(d, ops)
    other = str(tmp_path / "st2")
    shutil.copytree(root, other)
    out = {}
    for pkg, r, svc in (("port", root,
                         service.VerificationService(device="cpu")),
                        ("jax", other, jservice.VerificationService())):
        assert svc.recover(r) == ["t/0"], pkg
        assert svc.epoch == 2
        got = _wait_results(os.path.join(r, "t", "0"))
        st = svc.status()
        svc.stop()
        assert st["recovered-total"] == 1
        out[pkg] = got["linear"]
    assert _cross(out["port"]) == _strip(out["jax"])
    # an invalid stream's checkpoint can hold a carry that already died
    # (the liveness read is one chunk late): the resumed stream then
    # dispatches one more chunk to see the death, and attests it. Both
    # packages resume so; the verdict and its blame are the solo run's
    extra = COUNTS if corrupt is None else COUNTS + ("chunks", "attested")
    assert _strip(out["port"], extra) == _strip(solo, extra)


def test_corrupt_resume_manifest_starts_cold(tmp_path):
    ops, solo = _hist(52)
    root = str(tmp_path / "st")
    d = os.path.join(root, "t", "0")
    _write_journal(d, ops)
    _write_history_gz(d, ops)
    os.makedirs(os.path.join(d, "service"))
    with open(os.path.join(d, "service", "resume.json"), "w") as fh:
        fh.write('{"stream": "t/0", "targets": {"linear"')   # truncated
    assert store.load_service_resume(d) is None
    svc = service.VerificationService(device="cpu")
    try:
        names = svc.recover(root, spec_fn=lambda _d: {"linear": _wgl_spec()})
        assert names == ["t/0"]
        assert _strip(_wait_results(d)["linear"]) == _strip(solo)
    finally:
        svc.stop()


def test_truncated_checkpoint_npz_resumes_cold(tmp_path):
    ops, solo = _hist(55)
    root = str(tmp_path / "st")
    d = os.path.join(root, "t", "0")
    _write_journal(d, ops)
    _write_history_gz(d, ops)
    s = streaming.WglStream(MODEL, chunk_entries=CHUNK, slots=SLOTS,
                            frontier=FRONTIER, checkpoint_every=CKPT,
                            device="cpu")
    for op in ops[:200]:
        s.feed(op)
    s.checkpoint_now()
    ck = s.export_checkpoint()
    assert ck is not None and "carry" in ck
    store.write_service_resume(d, {
        "stream": "t/0", "targets": {"linear": _wgl_spec()},
        "ops-fed": 200, "checkpoints": {"linear": ck}})
    svcdir = os.path.join(d, "service")
    npz = [fn for fn in os.listdir(svcdir) if fn.endswith(".npz")]
    assert npz
    for fn in npz:
        p = os.path.join(svcdir, fn)
        with open(p, "rb") as fh:
            blob = fh.read()
        with open(p, "wb") as fh:
            fh.write(blob[:len(blob) // 2])
    man = store.load_service_resume(d)
    assert man is not None and "linear" not in man["checkpoints"]
    svc = service.VerificationService(device="cpu")
    try:
        assert svc.recover(root) == ["t/0"]
        assert _strip(_wait_results(d)["linear"]) == _strip(solo)
    finally:
        svc.stop()


# -- epoch fencing ---------------------------------------------------------------

def test_epoch_fencing(tmp_path):
    root = str(tmp_path / "st")
    os.makedirs(root)
    a = service.VerificationService(device="cpu")
    b = service.VerificationService(device="cpu")
    assert store.service_epoch(root) == 0
    assert a.claim_store(root) == 1 and not a.fenced()
    assert b.claim_store(root) == 2 and not b.fenced()
    assert a.fenced() and a.fenced()          # sticky
    with pytest.raises(service.AdmissionRefused):
        a.admit("x", {"linear": _wgl_spec()})
    b.admit("x", {"linear": _wgl_spec()})
    assert a.status()["fenced"] is True and a.status()["epoch"] == 1
    b.stop()
    a.stop()


def test_fenced_worker_stops_persisting(tmp_path):
    ops, _ = _hist(52)
    root = str(tmp_path / "st")
    d = os.path.join(root, "t", "0")
    os.makedirs(d)
    a = service.VerificationService(device="cpu")
    a.claim_store(root)
    w = a.admit("t/0", {"linear": _wgl_spec()}, store_dir=d)
    for op in ops[:100]:
        w.offer(op, 5.0)
    assert _wait(lambda: store.load_service_resume(d) is not None, 60.0)
    b = service.VerificationService(device="cpu")
    b.claim_store(root)
    store.clear_service_resume(d)
    for op in ops[100:]:
        w.offer(op, 5.0)
    w.seal()
    assert w.done.wait(60.0)
    assert a.fenced()
    assert store.load_service_resume(d) is None
    assert not os.path.exists(os.path.join(d, store.STREAMED_RESULTS_FILE))
    a.stop()
    b.stop()


def test_standby_promotes_and_serves_correct_verdict(tmp_path):
    """A client streams through the primary; the primary dies; the
    standby fences it, recovers the stream from its checkpoints and
    serves; the client fails over, learns the stream is journal-fed,
    and the promoted standby delivers the solo verdict."""
    ops, solo = _hist(56)
    root = str(tmp_path / "st")
    d = os.path.join(root, "t", "0")
    _write_journal(d, ops)
    addr_a, addr_b = str(tmp_path / "a.sock"), str(tmp_path / "b.sock")
    primary = service.VerificationService(device="cpu")
    primary.claim_store(root)
    assert primary.serve(addr_a) == addr_a
    test = {"name": "t", "start-time": "0", "store-dir": root}
    c = service.ServiceClient(f"{addr_a},{addr_b}", test,
                              spec={"linear": _wgl_spec()}, device="cpu")
    assert c._store_dir == os.path.abspath(d)
    for op in ops[:450]:
        c.offer(op)
    assert _wait(lambda: (store.load_service_resume(d)
                          or {}).get("checkpoints"), 60.0)
    primary.stop()
    try:
        c._wrap.conn().sock.shutdown(_socket.SHUT_RDWR)
    except OSError:
        pass
    standby = service.VerificationService(device="cpu")
    sb = service.Standby(standby, addr_a, root, bind=addr_b, poll_s=0.05,
                         failures=2)
    t = threading.Thread(target=sb.run, daemon=True)
    t.start()
    try:
        assert sb.promoted.wait(120.0), "standby never promoted"
        assert sb.bound == addr_b
        assert standby.epoch > primary.epoch
        assert standby.recovered_total == 1
        c.offer(ops[450])
        assert _wait(lambda: c._journal_fed, 30.0)
        assert c.failovers >= 1 and not c._dead
        _write_history_gz(d, ops)
        got = _wait_results(d)
        assert _strip(got["linear"], COUNTS) == _strip(solo, COUNTS)
        assert c.finalize() == {}
        assert primary.fenced()
    finally:
        sb.stop()
        standby.stop()
        c.close()
        t.join(timeout=10)


# -- the daemon, in a subprocess ---------------------------------------------------

def _spawn(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch", "service", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _announced(proc, want: int) -> dict:
    """Parse the daemon's announce lines from its stdout."""
    got: dict = {}
    deadline = time.monotonic() + 120
    while len(got) < want and time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("Verification service listening on "):
            got["addr"] = line.split(" on ", 1)[1].strip()
        elif line.startswith("Metrics listening on :"):
            got["metrics"] = int(line.split(":", 1)[1].split("/")[0])
    assert len(got) == want, (got, proc.stderr.read()
                              if proc.poll() is not None else "")
    return got


def test_daemon_sigterm_drain_then_watch_resume(tmp_path):
    ops, solo = _hist(42, n=400)
    base = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
               os.environ.get("PYTHONPATH", ""),
               JEPSEN_TPU_TORCH_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("JEPSEN_TPU_FAULT_INJECT", None)
    # without --device the daemon asks for CUDA: no card here
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch",
                            "service", "--bind", "127.0.0.1:0"], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0
        assert "no CUDA device" in r.stderr
    proc = _spawn(["--device", "cpu", "--bind", "127.0.0.1:0", "--watch",
                   base, "--metrics-port", "0"], env)
    try:
        got = _announced(proc, 2)
        test = {"name": "d", "start-time": "0", "store-dir": base}
        run_dir = store.dir_name(test)
        _write_journal(run_dir, ops)       # the run's write-ahead journal
        c = service.ServiceClient(got["addr"], test,
                                  spec={"linear": _wgl_spec()},
                                  device="cpu")
        for op in ops[:len(ops) // 2]:
            c.offer(op)
        assert _wait(lambda: (store.load_service_resume(run_dir)
                              or {}).get("checkpoints"), 60.0)
        murl = f"http://127.0.0.1:{got['metrics']}"
        with urllib.request.urlopen(murl + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "jepsen_tpu_service_stream_events_total" in text
        assert "jepsen_tpu_service_ops_total" in text
        with urllib.request.urlopen(murl + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["state"] == "serving"
        assert "d/0" in health["streams"]
        assert health["calibration"]["platform"] == "cpu"
        st = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch",
                             "service", "status", got["addr"]], cwd=ROOT,
                            env=env, capture_output=True, text=True,
                            timeout=120)
        assert st.returncode == 0 and "d/0" in st.stdout
        proc.send_signal(15)
        assert proc.wait(timeout=120) == 0
        c.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    man = store.load_service_resume(run_dir)
    assert man is not None and man["checkpoints"]["linear"]["chunks"] >= 1
    assert os.path.exists(os.path.join(str(tmp_path / "cache"),
                                       "calibration-cpu.json"))
    _write_history_gz(run_dir, ops)
    proc = _spawn(["--device", "cpu", "--bind", "127.0.0.1:0", "--watch",
                   base], env)
    try:
        _announced(proc, 1)
        res = _wait_results(run_dir)
        assert _strip(res["linear"], COUNTS) == _strip(solo, COUNTS)
        proc.send_signal(15)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
