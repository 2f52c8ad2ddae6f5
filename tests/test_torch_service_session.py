"""The port's session wire protocol (`jepsen_tpu_torch/service.py`),
after the JAX package's tests/test_service_session.py, on the CPU:
per-op sequence numbers with server-side replay dedup, client re-attach
with unacked-op replay across injected socket drops, the hardened
acceptor (malformed, oversized, split and truncated frames answer with
an error and the connection lives on), and the bounded session table.
And the same frames sent to the port's daemon and to a JAX daemon get
the same replies.

Histories are 300 ops, chunks 64 steps, 8 slots, frontier 128; the
port runs with device="cpu", the JAX package under JAX_PLATFORMS=cpu.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time

import pytest

import jepsen_tpu._platform as jplat
from jepsen_tpu import models as jmodels
from jepsen_tpu import service as jservice
from jepsen_tpu_torch import _platform as plat
from jepsen_tpu_torch import models, service, store
from jepsen_tpu_torch.checker import streaming, synth

MODEL = models.cas_register()
CHUNK = 64
SLOTS = 8
FRONTIER = 128
CKPT = 2
TIMING = ("tail-latency-ms", "duration-ms", "violation-at-op")
PORT_ONLY = ("device", "closure-rounds", "dedup-launches", "host-syncs")


@pytest.fixture(autouse=True)
def _reset_fault_injection(monkeypatch, tmp_path):
    monkeypatch.setenv("JEPSEN_TPU_PALLAS_DEDUP", "1")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    plat.reset_fault_injection()
    jplat.reset_fault_injection()
    yield
    plat.reset_fault_injection()
    jplat.reset_fault_injection()


def _canon(x):
    return json.loads(json.dumps(x, default=store._json_default,
                                 sort_keys=True))


def _strip(d, extra=()):
    return _canon({k: v for k, v in d.items()
                   if k not in TIMING + tuple(extra)})


def _jops(h):
    return [json.loads(json.dumps(op, default=store._json_default))
            for op in h.ops]


def _solo(ops, **kw):
    s = streaming.WglStream(MODEL, chunk_entries=CHUNK, slots=SLOTS,
                            frontier=FRONTIER, checkpoint_every=CKPT,
                            device="cpu", **kw)
    for op in ops:
        s.feed(op)
    return s.finish()


_HISTS: dict = {}


def _hist(seed, n=300):
    if seed not in _HISTS:
        h = synth.register_history(n, concurrency=3, values=5, seed=seed)
        ops = _jops(h)
        _HISTS[seed] = (ops, _solo(ops))
    return _HISTS[seed]


def _wgl_spec(**over):
    sp = {"kind": "wgl", "model": service.model_spec(MODEL),
          "chunk-entries": CHUNK, "slots": SLOTS, "engine": "sort",
          "frontier": FRONTIER, "checkpoint-every": CKPT}
    sp.update(over)
    return sp


def _wait_ops_fed(w, n, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while w.ops_fed < n and time.monotonic() < deadline:
        time.sleep(0.02)
    assert w.ops_fed == n


class _Raw:
    """A bare line-JSON protocol client (no ServiceClient smarts)."""

    def __init__(self, addr):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(addr)
        self.rf = self.sock.makefile("r", encoding="utf-8")
        self._rid = 0

    def send(self, msg):
        self.sock.sendall((json.dumps(msg) + "\n").encode())

    def request(self, msg):
        self._rid += 1
        msg = dict(msg, id=self._rid)
        self.send(msg)
        while True:
            line = self.rf.readline()
            assert line, "connection closed awaiting reply"
            r = json.loads(line)
            if r.get("id") == self._rid:
                return r

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


@pytest.fixture
def served(tmp_path):
    svc = service.VerificationService(device="cpu")
    addr = svc.serve(str(tmp_path / "svc.sock"))
    yield svc, addr
    svc.stop()


# -- sequence dedup (exactly-once application) ------------------------------

def test_seq_dedup_pin(served):
    """The pin: 9 op sends carrying 6 distinct seqs → exactly 6 ops
    applied, 3 counted as replays, and the ack high-water mark tracks
    the applied prefix."""
    svc, addr = served
    ops, _ = _hist(61)
    c = _Raw(addr)
    r = c.request({"type": "attach", "stream": "s1",
                   "targets": {"linear": _wgl_spec()},
                   "session": "tok-a"})
    assert r["ok"] and r["stream"] == "s1"
    for seq in (1, 2, 3, 2, 3, 4, 5, 4, 6):   # 3 replayed duplicates
        r = c.request({"type": "op", "op": ops[seq - 1], "seq": seq})
        assert r["ok"]
    assert r["acked"] == 6
    w = svc._worker("s1")
    _wait_ops_fed(w, 6)
    st = svc.status()
    assert st["sessions"]["count"] == 1
    assert st["sessions"]["replays"] == 3
    # a garbage seq is dropped, not applied and not an error
    r = c.request({"type": "op", "op": ops[0], "seq": "bogus"})
    assert r["ok"] and r["acked"] == 6
    time.sleep(0.2)
    assert w.ops_fed == 6
    c.close()


def test_ack_flag_without_id(served):
    """ack:true requests an acked reply without allocating a reply id
    — the client's bounded-replay-buffer heartbeat."""
    _svc, addr = served
    ops, _ = _hist(61)
    c = _Raw(addr)
    c.request({"type": "attach", "stream": "s2",
               "targets": {"linear": _wgl_spec()},
               "session": "tok-b"})
    c.send({"type": "op", "op": ops[0], "seq": 1})   # no reply
    c.send({"type": "op", "op": ops[1], "seq": 2, "ack": True})
    r = json.loads(c.rf.readline())
    assert r == {"ok": True, "acked": 2}
    c.close()


def test_session_token_mismatch_refused(served):
    """A live stream must not be hijackable by name: re-attach with a
    different token is refused (the worker keeps running)."""
    svc, addr = served
    c1 = _Raw(addr)
    c1.request({"type": "attach", "stream": "s3",
                "targets": {"linear": _wgl_spec()},
                "session": "tok-owner"})
    c2 = _Raw(addr)
    r = c2.request({"type": "attach", "stream": "s3",
                    "session": "tok-thief", "resume": True})
    assert r["ok"] is False
    assert "token mismatch" in r["error"]
    assert svc._worker("s3") is not None
    c1.close()
    c2.close()


def test_resume_attach_unknown_stream_deferred(served):
    """resume:true for a stream with no worker must refuse (deferred)
    rather than silently re-admit fresh: the dead worker may have
    acked ops this client already forgot."""
    _svc, addr = served
    c = _Raw(addr)
    r = c.request({"type": "attach", "stream": "ghost",
                   "session": "tok-g", "resume": True})
    assert r["ok"] is False and r["deferred"] is True
    assert "not recovered" in r["error"]
    c.close()


def test_legacy_ops_without_seq_still_apply(served):
    """Pre-session clients send ops with no seq: always applied."""
    svc, addr = served
    ops, _ = _hist(61)
    c = _Raw(addr)
    c.request({"type": "attach", "stream": "s4",
               "targets": {"linear": _wgl_spec()},
               "session": "tok-l"})
    for op in ops[:5]:
        c.send({"type": "op", "op": op})
    r = c.request({"type": "poll"})
    assert r["ok"]
    w = svc._worker("s4")
    _wait_ops_fed(w, 5)
    c.close()


# -- client survives injected socket drops ----------------------------------

class _Proxy:
    """A TCP proxy in front of the service socket whose connections
    the test can cut at will — the socket-drop injector."""

    def __init__(self, upstream_addr):
        self.upstream_addr = upstream_addr
        self.ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.ls.bind(("127.0.0.1", 0))
        self.ls.listen(16)
        self.addr = "127.0.0.1:%d" % self.ls.getsockname()[1]
        self._lock = threading.Lock()
        self._conns = []        # guarded-by: _lock
        self.accepted = 0
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                down, _ = self.ls.accept()
            except OSError:
                return
            self.accepted += 1
            up = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                up.connect(self.upstream_addr)
            except OSError:
                down.close()
                continue
            with self._lock:
                self._conns.append((down, up))
            for a, b in ((down, up), (up, down)):
                threading.Thread(target=self._pump, args=(a, b),
                                 daemon=True).start()

    @staticmethod
    def _pump(src, dst):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        for s in (src, dst):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def drop_all(self):
        """Cut every live proxied connection (both directions)."""
        with self._lock:
            conns, self._conns = self._conns, []
        for down, up in conns:
            for s in (down, up):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass

    def close(self):
        self.drop_all()
        try:
            self.ls.close()
        except OSError:
            pass


def test_client_survives_three_socket_drops(served, tmp_path):
    """ServiceClient rides out ≥3 injected drops
    mid-stream with zero duplicated or lost ops — the verdict is
    byte-identical to a solo run and the worker fed exactly len(ops)
    ops (sequence dedup swallowed every replayed duplicate)."""
    svc, addr = served
    ops, solo = _hist(62)
    proxy = _Proxy(addr)
    try:
        c = service.ServiceClient(
            proxy.addr, {"name": "drop", "start-time": "7",
                         "store-dir": str(tmp_path / "cs")},
            spec={"linear": _wgl_spec()}, device="cpu")
        quarters = len(ops) // 4
        for i, op in enumerate(ops):
            c.offer(op)
            if i in (quarters, 2 * quarters, 3 * quarters):
                proxy.drop_all()
        res = c.finalize()
        assert c.reconnects >= 3
        assert _strip(res["linear"]) == _strip(solo)
        w = svc._worker("drop/7")
        assert w.ops_fed == len(ops)
        assert svc.status()["sessions"]["replays"] >= 0
        c.close()
    finally:
        proxy.close()


# -- acceptor hardening and protocol fuzz ---------------------------------------

def test_oversized_line_answers_and_connection_survives(served):
    """A frame past MAX_LINE_BYTES gets one error reply and the same
    connection keeps working."""
    _svc, addr = served
    c = _Raw(addr)
    c.sock.sendall(b'{"pad": "' + b"x" * (service.MAX_LINE_BYTES + 64)
                   + b'"}\n')
    r = json.loads(c.rf.readline())
    assert r["ok"] is False and "too long" in r["error"]
    r = c.request({"type": "status"})
    assert r["ok"] and r["status"]["state"] == "serving"
    c.close()


def test_malformed_frames_answer_errors(served):
    """Bad json / non-object json / unknown verbs each answer an
    error on a live connection instead of dropping it."""
    _svc, addr = served
    c = _Raw(addr)
    c.sock.sendall(b"{not json at all\n")
    assert json.loads(c.rf.readline())["error"] == "bad json"
    c.sock.sendall(b'[1, 2, 3]\n')
    assert json.loads(c.rf.readline())["error"] == "not an object"
    r = c.request({"type": "warp"})
    assert r["ok"] is False and "unknown type" in r["error"]
    # a verb that explodes server-side is contained too: finish with
    # no attach answers, doesn't kill the thread
    r = c.request({"type": "finish"})
    assert r["ok"] is False and r["error"] == "not attached"
    r = c.request({"type": "poll"})
    assert r["ok"]
    c.close()


def test_protocol_fuzz_daemon_stays_healthy(served):
    """Random bytes, split frames, interleaved verbs, oversized
    lines, and mid-frame disconnects against a live serve() socket:
    the daemon stays healthy throughout and an honest sibling stream
    on the same daemon is unaffected."""
    svc, addr = served
    ops, solo = _hist(61)
    rng = random.Random(1234)

    # the honest sibling, running concurrently with the fuzzer
    sib = _Raw(addr)
    sib.request({"type": "attach", "stream": "honest",
                 "targets": {"linear": _wgl_spec()},
                 "session": "tok-h"})

    verbs = [{"type": "poll"}, {"type": "status"},
             {"type": "attach", "stream": "f", "targets": {}},
             {"type": "op", "op": {"w": 1}, "seq": "NaN"},
             {"type": "finish", "timeout-s": 0.01},
             {"type": "metrics", "compact": True},
             {"type": None}, {"no-type": 1}]
    for trial in range(30):
        f = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        f.connect(addr)
        try:
            kind = trial % 5
            if kind == 0:       # pure garbage bytes
                f.sendall(bytes(rng.randrange(256)
                                for _ in range(rng.randrange(1, 2048))))
            elif kind == 1:     # a frame split across many sends
                data = (json.dumps(verbs[rng.randrange(len(verbs))])
                        + "\n").encode()
                for i in range(0, len(data), 3):
                    f.sendall(data[i:i + 3])
                    time.sleep(0.001)
            elif kind == 2:     # interleaved valid verbs
                for _ in range(rng.randrange(1, 6)):
                    f.sendall((json.dumps(
                        verbs[rng.randrange(len(verbs))])
                        + "\n").encode())
            elif kind == 3:     # mid-frame disconnect
                f.sendall(b'{"type": "attach", "stream": "tru')
            else:               # oversized frame then a valid verb
                f.sendall(b'"' + b"A" * (service.MAX_LINE_BYTES + 1)
                          + b'"\n{"type": "poll"}\n')
        except OSError:
            pass                # the daemon may hang up; that's fine
        finally:
            f.close()
        if trial % 10 == 0:     # the sibling makes live progress
            for op in ops[trial:trial + 10]:
                sib.send({"type": "op", "op": op})

    # daemon healthy after the storm
    st = svc.status()
    assert st["state"] == "serving"
    # the storm interleaved ops[0:30] (10 per tenth trial, in order);
    # feed the rest and the sibling's verdict matches solo exactly
    for op in ops[30:]:
        sib.send({"type": "op", "op": op})
    r = sib.request({"type": "finish", "timeout-s": 300})
    assert r["ok"], r
    assert _strip(r["results"]["linear"]) == _strip(solo)
    sib.close()


# -- the bounded session table ------------------------------------------------

def test_terminal_stream_evicts_session(served):
    """A stream reaching its verdict frees its session entry
    immediately — no client can resume a finished stream onto a live
    worker, so keeping the token + high-water mark is pure growth."""
    svc, addr = served
    ops, solo = _hist(61)
    c = _Raw(addr)
    r = c.request({"type": "attach", "stream": "evict/1",
                   "targets": {"linear": _wgl_spec()},
                   "session": "tok-e"})
    assert r["ok"]
    for seq, op in enumerate(ops, 1):
        c.send({"type": "op", "op": op, "seq": seq})
    with svc._session_lock:
        assert "evict/1" in svc._sessions
    r = c.request({"type": "finish", "timeout-s": 300})
    assert r["ok"]
    assert _strip(r["results"]["linear"]) == _strip(solo)
    with svc._session_lock:
        assert "evict/1" not in svc._sessions
    c.close()


def test_session_ttl_sweep():
    """Sessions idle past the TTL with no live worker are swept;
    a session whose stream is still streaming survives any idle."""
    svc = service.VerificationService(adaptive=False,
                                      session_ttl_s=0.05, device="cpu")
    try:
        ops, _ = _hist(61)
        # a ghost session: its stream never had a worker (the client
        # died between attach and first op)
        assert svc._session_attach("ghost/1", "tok-g", False)
        # a live one: worker admitted and not done
        svc.admit("live/1", {"linear": _wgl_spec()})
        assert svc._session_attach("live/1", "tok-l", False)
        svc.offer("live/1", ops[0])
        time.sleep(0.1)
        svc._prune_sessions()
        with svc._session_lock:
            assert "ghost/1" not in svc._sessions
            assert "live/1" in svc._sessions
        svc.seal("live/1")
        assert svc._worker("live/1").done.wait(60.0)
    finally:
        svc.stop()


def test_session_table_size_backstop():
    """Even inside the TTL, the table cannot grow unboundedly: past
    the size gate, entries with no known worker are dropped."""
    svc = service.VerificationService(adaptive=False, device="cpu")
    try:
        n = max(256, 4 * svc.keep_done) + 10
        for i in range(n):
            svc._session_attach(f"g/{i}", f"tok-{i}", False)
        svc._prune_sessions()
        with svc._session_lock:
            assert len(svc._sessions) <= max(256, 4 * svc.keep_done)
    finally:
        svc.stop()


# -- the same frames, the same replies as a JAX daemon ------------------------------

def _script(svc, addr, ops, spec):
    """One scripted conversation: attach with a session, ops with
    replayed seqs and an ack heartbeat, a token thief, an unknown
    resume, garbage, an oversized frame, bad verbs, poll and finish.
    Returns every reply in order (status and metrics replies reduced to
    their keys: uptimes and timings differ by process)."""
    c = _Raw(addr)
    out = []
    out.append(c.request({"type": "attach", "stream": "p1",
                          "targets": {"linear": spec}, "session": "tok"}))
    for seq in (1, 2, 3, 2, 3, 4, 5, 4, 6):
        out.append(c.request({"type": "op", "op": ops[seq - 1],
                              "seq": seq}))
    c.send({"type": "op", "op": ops[6], "seq": 7})
    c.send({"type": "op", "op": ops[7], "seq": 8, "ack": True})
    out.append(json.loads(c.rf.readline()))
    out.append(c.request({"type": "op", "op": ops[0], "seq": "bogus"}))
    thief = _Raw(addr)
    out.append(thief.request({"type": "attach", "stream": "p1",
                              "session": "other", "resume": True}))
    out.append(thief.request({"type": "attach", "stream": "ghost",
                              "session": "g", "resume": True}))
    thief.close()
    c.sock.sendall(b"{not json at all\n")
    out.append(json.loads(c.rf.readline()))
    c.sock.sendall(b"[1, 2, 3]\n")
    out.append(json.loads(c.rf.readline()))
    c.sock.sendall(b'{"pad": "' + b"x" * (service.MAX_LINE_BYTES + 64)
                   + b'"}\n')
    out.append(json.loads(c.rf.readline()))
    out.append(c.request({"type": "warp"}))
    r = c.request({"type": "status"})
    out.append({"ok": r["ok"], "keys": sorted(r["status"]),
                "sessions": r["status"]["sessions"]})
    r = c.request({"type": "metrics", "compact": True})
    out.append({"ok": r["ok"], "has": "metrics" in r})
    for seq, op in enumerate(ops[8:], 9):
        c.send({"type": "op", "op": op, "seq": seq})
    out.append(c.request({"type": "poll"}))
    r = c.request({"type": "finish", "timeout-s": 300})
    r["results"] = {k: _canon({f: x for f, x in v.items()
                               if f not in TIMING + PORT_ONLY})
                    for k, v in r["results"].items()}
    out.append(r)
    c.close()
    return out


def test_same_frames_get_the_same_replies_as_a_jax_daemon(tmp_path):
    ops, _ = _hist(61)
    got = {}
    for pkg, svc, spec in (
            ("port", service.VerificationService(device="cpu"),
             _wgl_spec()),
            ("jax", jservice.VerificationService(),
             dict(_wgl_spec(), model=jservice.model_spec(
                 jmodels.cas_register())))):
        addr = svc.serve(str(tmp_path / f"{pkg}.sock"))
        try:
            got[pkg] = _script(svc, addr, ops, spec)
        finally:
            svc.stop()
    fin, jfin = got["port"].pop(), got["jax"].pop()
    assert got["port"] == got["jax"]
    lin = fin["results"]["linear"]
    lin["analyzer"] = lin["analyzer"].replace("gpu-", "tpu-", 1)
    assert fin == jfin
