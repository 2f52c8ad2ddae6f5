"""The port's online checking (`checker/streaming.py`) against the JAX
package's: `check_stream_chunk` carries equal after every chunk on both
engine families; `stream_check` results equal on the dense engine and
the sort engine's hash and sort routes, valid and invalid, through slot
overflow rebuilds and range escapes, with the final carry equal to the
offline walk's; a checkpoint exported mid-stream by one package resumed
by the other; recovery under injected oom / device-lost / wedged /
bitflip faults at the 'stream-chunk' site; `WrStream.finish`;
`maybe_online` and `OnlineChecker.finalize`.

The JAX package runs under JAX_PLATFORMS=cpu with its Pallas hash dedup
on (JEPSEN_TPU_PALLAS_DEDUP=1, interpret mode), as on its accelerator;
the port with device="cpu". Histories are small (under 300 ops) and
chunks 64 steps, so every stream crosses several chunk boundaries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jepsen_tpu._platform as jplat
import jepsen_tpu.control.retry as jretry
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import compose as jcompose
from jepsen_tpu.checker import linear as jlinear
from jepsen_tpu.checker import streaming as jstreaming
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu.checker.elle import rw_register_checker as jrw_checker
from jepsen_tpu_torch import _platform as plat
from jepsen_tpu_torch import history as thistory
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch import parallel
from jepsen_tpu_torch import util
from jepsen_tpu_torch.carry import carry_to_numpy
from jepsen_tpu_torch.checker import compose
from jepsen_tpu_torch.checker import linear as tlinear
from jepsen_tpu_torch.checker import streaming as tstreaming
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl
from jepsen_tpu_torch.checker.elle import rw_register_checker

CHUNK = 64
_VOLATILE = {"duration-ms", "tail-latency-ms", "analyzer", "device",
             "closure-rounds", "dedup-launches", "host-syncs"}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """The JAX package as on its accelerator; both ladders' backoff
    zeroed; injection counters isolated; torch on one thread."""
    monkeypatch.setenv("JEPSEN_TPU_PALLAS_DEDUP", "1")
    monkeypatch.setattr(util, "backoff", lambda *a, **k: iter([0.0] * 99))
    monkeypatch.setattr(jretry, "backoff", lambda *a, **k: iter([0.0] * 99))
    plat.reset_fault_injection()
    jplat.reset_fault_injection()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    plat.reset_fault_injection()
    jplat.reset_fault_injection()


def _th(h):
    return thistory.History(h.ops)


def _reg(n=240, conc=4, seed=7, crash=0.0):
    return jsynth.register_history(n, concurrency=conc, values=5,
                                   crash_rate=crash, seed=seed)


def _agree(t: dict, j: dict) -> None:
    for key in sorted(set(t) | set(j)):
        if key not in _VOLATILE:
            assert t.get(key) == j.get(key), key
    assert t["analyzer"] == j["analyzer"].replace("tpu-", "gpu-", 1)


def _assert_carries(tc, jc, where=""):
    jn = jax.device_get(jc)
    assert len(tc) == len(jn)
    for i, (a, b) in enumerate(zip(tc, jn)):
        b = np.asarray(b)
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} elem {i}")


def _pad(rows, w):
    buf = np.zeros((CHUNK, w + 4), np.int32)
    buf[:, w] = -1
    buf[:, w + 2:] = -1
    buf[:len(rows)] = rows
    return buf


# -- the chunk entry ----------------------------------------------------------

# label -> (model, history, family, F, P, hash dedup?)
FAMILIES = {
    "dense": ("cas_register", lambda: _reg(crash=0.01, seed=2), "dense", None, 8,
              None),
    "dense-phantom": ("cas_register",
                      lambda: tsynth.corrupt(_reg(seed=3), seed=3, value=4),
                      "dense", None, 8, None),
    "sort-hash": ("cas_register", lambda: jsynth.corrupt(_reg(seed=5),
                                                         seed=5),
                  "sort", 64, 8, True),
    "sort-packed": ("cas_register", lambda: _reg(seed=9), "sort", 16, 16,
                    False),
    "sort-lex": ("counter", lambda: jsynth.counter_history(200, seed=4),
                 "sort", 64, 40, False),
}


@pytest.mark.parametrize("label", list(FAMILIES))
def test_stream_chunk_carries_match_jax_after_every_chunk(label):
    mname, mk, family, F, P, use_hash = FAMILIES[label]
    model = getattr(jmodels, mname)()
    name = model.device_model
    h = mk()
    ops = jwgl.encode_ops_for_model(model, h)
    srange = jwgl._state_range(name, model, [ops])
    steps = jwgl.build_steps(ops, P)
    init = model.device_state()
    if family == "dense":
        lo, S = srange[0], jwgl._bucket(srange[1] - srange[0] + 1, lo=4)
        jk = jwgl._dense_kernel(name, lo, S, P, CHUNK)
        tk = twgl.DenseKernel(name, lo, S, P, "cpu")
    else:
        pack = jwgl._pack_params(srange, P) if P <= 32 else None
        assert (pack is not None) == (not label.endswith("lex"))
        jk = jwgl._kernel_cached(name, F, P, CHUNK, pack, use_hash, False,
                                 True)
        tk = twgl.SortKernel(name, F, P, pack, twgl.DEDUP_PALLAS if use_hash
                             else twgl.DEDUP_SORT, "cpu")
    jc, tc = jk.init_carry(jnp.int32(init)), tk.init_carry(init)
    offline = tk.run_range(twgl.stage_steps(steps.x, "cpu"), steps.n,
                           tk.init_carry(init))
    for i, e in enumerate(range(0, steps.n, CHUNK)):
        rows = steps.x[e:e + CHUNK]
        buf = _pad(rows, steps.w)
        jc = jk.check_stream_chunk(jnp.asarray(buf), jnp.int32(len(rows)),
                                   jc)
        tc = tk.check_stream_chunk(twgl.stage_steps(buf, "cpu"), len(rows),
                                   tc)
        _assert_carries(carry_to_numpy(tc), jc, f"chunk {i}")
    assert i >= 2
    # streamed chunk by chunk == the offline walk in one range
    for a, b in zip(carry_to_numpy(tc), carry_to_numpy(offline)):
        np.testing.assert_array_equal(a, b)
    if use_hash:
        assert tk.dedups > 0


def test_zero_length_chunk_leaves_the_carry():
    tk = twgl.DenseKernel("cas-register", -1, 8, 8, "cpu")
    c = tk.init_carry(0)
    buf = _pad(np.zeros((0, 5), np.int32), 1)
    out = tk.check_stream_chunk(twgl.stage_steps(buf, "cpu"), 0, c)
    for a, b in zip(out, c):
        assert torch.equal(a, b)


# -- stream_check against the JAX package --------------------------------------

def _cases():
    phantom = jsynth.corrupt(_reg(seed=13), seed=4)
    return {
        "sort-lex-valid": (_reg(seed=11), {}),
        "sort-lex-invalid": (phantom, {}),
        "sort-hash-valid": (_reg(seed=11), {"state_range": (-1, 4),
                                            "engine": "sort"}),
        "sort-hash-invalid": (tsynth.corrupt(_reg(seed=17), seed=2,
                                             value=4),
                              {"state_range": (-1, 4), "engine": "sort"}),
        "dense-valid": (_reg(seed=11), {"state_range": (-1, 4),
                                        "engine": "dense"}),
        "dense-invalid": (tsynth.corrupt(_reg(seed=17), seed=2, value=4),
                          {"state_range": (-1, 4), "engine": "dense"}),
        "dense-range-escape": (phantom, {"state_range": (-1, 4),
                                         "engine": "auto"}),
        "slot-overflow": (_reg(n=200, conc=12, seed=29), {"slots": 8}),
        "crash-tail": (jsynth.History(_reg(seed=23).ops[:-9]), {}),
        "overflow-escalates": (_reg(n=200, conc=6, seed=3, crash=0.05),
                               {"frontier": 4, "max_frontier": 4096}),
    }


@pytest.mark.parametrize("label", list(_cases()))
def test_stream_check_matches_jax(label):
    h, kw = _cases()[label]
    kw = dict(kw, chunk_entries=CHUNK)
    j = jstreaming.stream_check(jmodels.cas_register(), h, **kw)
    s = tstreaming.WglStream(tmodels.cas_register(), device="cpu", **kw)
    for op in _th(h).ops:
        s.feed(op)
    t = s.finish()
    _agree(t, j)
    assert t["streamed"] and t["device"] == "cpu"
    off = tlinear.linearizable(tmodels.cas_register(),
                               device="cpu").check({}, _th(h), {})
    assert t["valid?"] == off["valid?"]
    assert t.get("op-index") == off.get("op-index")
    if label.endswith("-valid"):
        assert t["valid?"] is True and t["chunks"] >= 3
    if label.startswith(("dense", "sort-hash")) and "escape" not in label:
        assert t["dedup"] == ("dense-table" if label.startswith("dense")
                              else "pallas-hash")
        if label.startswith("sort-hash"):
            assert t["dedup-launches"] > 0
    if label == "slot-overflow":
        assert s.p > 8
    if label == "dense-range-escape":
        assert t["analyzer"] == "gpu-wgl-streaming"


@pytest.mark.parametrize("engine", ["dense", "sort"])
def test_final_carry_equals_the_offline_walk(engine):
    h = _reg(seed=31)
    kw = {"state_range": (-1, 4), "engine": engine, "chunk_entries": CHUNK}
    s = tstreaming.WglStream(tmodels.cas_register(), device="cpu", **kw)
    for op in _th(h).ops:
        s.feed(op)
    assert s.finish()["valid?"] is True
    ops = twgl.encode_ops_for_model(tmodels.cas_register(), _th(h))
    steps = twgl.build_steps(ops, s.p)
    k = s._new_kernel()
    want = k.run_range(twgl.stage_steps(steps.x, "cpu"), steps.n,
                       k.init_carry(tmodels.cas_register().device_state()))
    for a, b in zip(s.carry_host(), carry_to_numpy(want)):
        np.testing.assert_array_equal(a, b)


def test_early_abort_matches_jax():
    h = _reg(n=600, seed=31, crash=0.0)
    ops = [dict(o) for o in h.ops]
    for i, o in enumerate(ops):
        if i > len(ops) // 4 and o["type"] == "ok" and o["f"] == "read":
            o["value"] = 10 ** 6
            break
    bad = jsynth.History(ops)
    out = {}
    for pkg, s in (("jax", jstreaming.WglStream(
            jmodels.cas_register(), chunk_entries=CHUNK, slots=8)),
            ("torch", tstreaming.WglStream(
                tmodels.cas_register(), chunk_entries=CHUNK, slots=8,
                device="cpu"))):
        fed = 0
        for op in bad.ops:
            s.feed(op)
            fed += 1
            if s.violation:
                break
        out[pkg] = (fed, s.violation_at_op, s.finish())
    assert out["torch"][:2] == out["jax"][:2]
    assert out["torch"][0] < len(bad.ops)
    _agree(out["torch"][2], out["jax"][2])
    assert out["torch"][2]["violation-at-op"] == out["torch"][1]


# -- checkpoints across the two packages ----------------------------------------

def _half_fed(stream, h, frac=0.75):
    ops = h.ops
    for op in ops[:int(len(ops) * frac)]:
        stream.feed(op)
    assert stream.checkpoint_now()
    return stream.export_checkpoint()


@pytest.mark.parametrize("engine", ["dense", "sort"])
@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_checkpoint_resumes_in_the_other_package(engine, direction):
    h = tsynth.corrupt(_reg(seed=37), seed=8, value=4)
    kw = {"state_range": (-1, 4), "engine": engine, "chunk_entries": CHUNK,
          "checkpoint_every": 2}
    whole_t = tstreaming.stream_check(tmodels.cas_register(), _th(h),
                                      device="cpu", **kw)
    whole_j = jstreaming.stream_check(jmodels.cas_register(), h, **kw)
    if direction == "jax->torch":
        ck = _half_fed(jstreaming.WglStream(jmodels.cas_register(), **kw),
                       h)
        s = tstreaming.WglStream(tmodels.cas_register(), device="cpu",
                                 **kw)
        whole = whole_t
    else:
        ck = _half_fed(tstreaming.WglStream(tmodels.cas_register(),
                                            device="cpu", **kw), _th(h))
        assert ck["carry"][0].dtype == np.int32
        s = jstreaming.WglStream(jmodels.cas_register(), pallas=ck["pallas"],
                                 **kw)
        whole = whole_j
    assert ck["chunks"] >= 2 and ck["rows"] > 0
    assert s.import_checkpoint(ck)
    for op in h.ops:
        s.feed(op)
    r = s.finish()
    assert r["recovered"] is not None if "recovered" in r else True
    for key in sorted(set(r) | set(whole)):
        if key not in _VOLATILE:
            assert r.get(key) == whole.get(key), key
    _agree(whole_t, whole_j)
    assert whole_t["valid?"] is False


def test_checkpoint_shape_mismatch_stays_cold():
    kw = {"state_range": (-1, 4), "engine": "dense", "chunk_entries": CHUNK}
    ck = _half_fed(jstreaming.WglStream(jmodels.cas_register(), **kw),
                   _reg(seed=41))
    s = tstreaming.WglStream(tmodels.cas_register(), device="cpu",
                             **dict(kw, engine="sort"))
    assert not s.import_checkpoint(ck)
    ck2 = dict(ck, carry=ck["carry"][:-1])
    s = tstreaming.WglStream(tmodels.cas_register(), device="cpu", **kw)
    with pytest.raises(ValueError):
        s.import_checkpoint(ck2)


# -- recovery at the stream-chunk site -----------------------------------------

@pytest.mark.parametrize("spec", ["oom@stream-chunk:3",
                                  "device-lost@stream-chunk:3",
                                  "wedged@stream-chunk:2",
                                  "bitflip@stream-chunk:3",
                                  "oom@stream-chunk:2,oom@stream-chunk:6"])
@pytest.mark.parametrize("engine", ["dense", "sort"])
def test_stream_recovery_matches_jax(monkeypatch, spec, engine):
    """One fault on an invalid history (recovered, then blamed), two on
    a valid one that streams long enough for the second to fire."""
    two = "," in spec
    h = _reg(n=400, seed=43) if two else \
        tsynth.corrupt(_reg(seed=43), seed=5, value=4)
    kw = {"state_range": (-1, 4), "engine": engine, "chunk_entries": CHUNK,
          "checkpoint_every": 2}
    monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT", spec)
    j = jstreaming.stream_check(jmodels.cas_register(), h, **kw)
    t = tstreaming.stream_check(tmodels.cas_register(), _th(h),
                                device="cpu", **kw)
    _agree(t, j)
    kinds = [c.partition("@")[0] for c in spec.split(",")]
    assert t["recovered"]["faults"] == [
        "corrupt" if k == "bitflip" else k for k in kinds]
    assert t["valid?"] is two


def test_stream_recovery_budget_declines_the_verdict(monkeypatch):
    """Past the budget a stream declines (finish() is None) in both
    packages; the offline check then decides, and in the port it ends
    on a degraded 'unknown' if the device keeps faulting."""
    h = _reg(seed=47)
    kw = {"chunk_entries": CHUNK, "max_recovery_retries": 1}
    spec = ",".join(f"oom@stream-chunk:{n}" for n in range(1, 9))
    monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT", spec)
    assert jstreaming.stream_check(jmodels.cas_register(), h, **kw) is None
    assert tstreaming.stream_check(tmodels.cas_register(), _th(h),
                                   device="cpu", **kw) is None
    monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT", ",".join(
        f"oom@offline:{n}" for n in range(1, 9)))
    off = tlinear.linearizable(tmodels.cas_register(), device="cpu",
                               max_recovery_retries=1).check({}, _th(h), {})
    assert off["valid?"] == "unknown" and off["degraded"]
    assert off["recovery-failed"]["faults"] == ["oom", "oom"]


def test_compile_fault_raises_through_the_stream(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT", "compile@stream-chunk:2")
    with pytest.raises(plat.InjectedFault):
        tstreaming.stream_check(tmodels.cas_register(), _th(_reg(seed=53)),
                                device="cpu", chunk_entries=CHUNK)


def test_fault_schedule_reaches_the_replay():
    """An ordered schedule: an OOM at the 3rd chunk, then a bit flip one
    staging into the recovery replay; both recovered, probes emitted."""
    seen = []
    plat.probe_hook = seen.append
    try:
        plat.install_fault_schedule(plat.FaultSchedule.from_clauses(
            ["oom@stream-chunk:3", "bitflip@stream-chunk:1"]))
        t = tstreaming.stream_check(
            tmodels.cas_register(), _th(_reg(seed=59)), device="cpu",
            chunk_entries=CHUNK, checkpoint_every=2)
    finally:
        plat.probe_hook = None
    assert t["valid?"] is True
    assert t["recovered"]["faults"] == ["oom", "corrupt"]
    events = [e["event"] for e in seen]
    assert events.count("inject") == 1 and events.count("corrupt") == 1
    assert "replay-begin" in events and "replay-end" in events
    assert plat.current_fault_schedule().done()


def test_external_pump_and_named_fault_site_match_jax(monkeypatch):
    """auto_pump=False: feed only encodes, pump() dispatches under the
    caller's budget; a stream's own fault_site takes the injection."""
    h = _reg(seed=71)
    kw = {"chunk_entries": CHUNK, "auto_pump": False, "fault_site": "s/a"}
    monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT", "oom@s/a:2")
    out = {}
    for pkg, s in (("jax", jstreaming.WglStream(jmodels.cas_register(),
                                                **kw)),
                   ("torch", tstreaming.WglStream(
                       tmodels.cas_register(), device="cpu", **kw))):
        for op in h.ops:
            s.feed(op)
        pending = s.pending_chunks()
        assert pending >= 2 and s.pump(max_chunks=1) == 1
        assert s.pending_chunks() == pending - 1
        out[pkg] = s.finish()
    _agree(out["torch"], out["jax"])
    assert out["torch"]["recovered"]["faults"] == ["oom"]


# -- streaming Elle ---------------------------------------------------------------

def _wr_cases():
    def ok(p, txn):
        return [{"type": "invoke", "f": "txn", "value": txn, "process": p},
                {"type": "ok", "f": "txn", "value": txn, "process": p}]
    cycle = ok(0, [["w", "x", 1], ["r", "y", 1]]) + \
        ok(1, [["w", "y", 1], ["r", "x", 1]])
    late = ok(0, [["r", "x", 2]]) + ok(1, [["w", "x", 2], ["r", "y", 5]]) \
        + ok(2, [["w", "y", 5], ["r", "x", None]])
    return {"valid": jsynth.wr_history(300, seed=45100),
            "cycle": jsynth.History(cycle),
            "late": jsynth.History(late)}


@pytest.mark.parametrize("label", list(_wr_cases()))
def test_wr_stream_finish_matches_jax(label):
    h = _wr_cases()[label]
    j, t = jstreaming.WrStream(), tstreaming.WrStream(device="cpu")
    for op in h.ops:
        j.feed(op)
        t.feed(op)
    rj, rt = j.finish(), t.finish()
    assert set(rt) == set(rj)
    for key in rt:
        if key != "tail-latency-ms":
            assert rt[key] == rj[key], key
    assert rt["valid?"] is (label != "cycle")


def test_wr_stream_mesh_raises():
    """A mesh is accepted and reaches the classifier; an object that is
    not one raises TypeError."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstreaming.WrStream(mesh=object())
    one = parallel.local_mesh("cpu")
    st = tstreaming.WrStream(mesh=one, device="cpu")
    assert st.mesh is one
    for op in tsynth.wr_history(60, seed=2).ops:
        st.feed(op)
    assert st.finish()["valid?"] is True


# -- the online checker -----------------------------------------------------------

def _online_test(pkg, workload, tier):
    if workload == "register":
        c = (jlinear.linearizable(jmodels.cas_register()) if pkg == "jax"
             else tlinear.linearizable(tmodels.cas_register(),
                                       device="cpu"))
    else:
        c = jrw_checker() if pkg == "jax" \
            else rw_register_checker(device="cpu")
    return {"online": True, "tier": tier, "online-chunk-entries": CHUNK,
            "online-state-range": (-1, 4), "concurrency": 4,
            "checker": (jcompose if pkg == "jax" else compose)({"c": c})}


@pytest.mark.parametrize("tier", [None, "screen"])
@pytest.mark.parametrize("workload", ["register", "wr"])
def test_maybe_online_and_finalize_match_jax(workload, tier):
    h = (tsynth.corrupt(_reg(seed=61), seed=6, value=4)
         if workload == "register" else _wr_cases()["cycle"])
    targets, results = {}, {}
    for pkg, mod in (("jax", jstreaming), ("torch", tstreaming)):
        oc = mod.maybe_online(_online_test(pkg, workload, tier))
        targets[pkg] = sorted(oc.targets)
        for op in h.ops:
            oc.offer(op)
        results[pkg] = oc.finalize(timeout_s=120)
    want = (["linear"] + (["screen-linear"] if tier else [])
            if workload == "register"
            else ["elle-wr"] + (["screen-wr"] if tier else []))
    assert targets["torch"] == targets["jax"] == want
    j, t = results["jax"], results["torch"]
    assert sorted(t) == sorted(j) == want
    for name in want:
        if name == "linear":
            _agree(t[name], j[name])
            continue
        for key in set(t[name]) | set(j[name]):
            if key not in _VOLATILE:
                assert t[name].get(key) == j[name].get(key), (name, key)
    # the screens are sound but incomplete: an in-range stale read can
    # pass the linear screen, never the full stream
    assert t[want[0]]["valid?"] is False


def test_maybe_online_declines_without_online_or_targets():
    assert tstreaming.maybe_online({"checker": None}) is None
    assert tstreaming.maybe_online(
        {"online": True, "checker": tlinear.linearizable(
            tmodels.cas_register(), algorithm="host")}) is None


def test_streamed_result_is_reused_by_the_checker():
    h = _reg(seed=67)
    r = tstreaming.stream_check(tmodels.cas_register(), _th(h),
                                device="cpu", chunk_entries=CHUNK)
    lin = tlinear.linearizable(tmodels.cas_register(), device="cpu")
    got = lin.check({"streamed-results": {"linear": r}}, _th(h), {})
    assert got["streamed"] and got["analyzer"] == "gpu-wgl-streaming"
    # another history length, or another model, checks offline
    got = lin.check({"streamed-results": {"linear": dict(
        r, **{"history-len": 5})}}, _th(h), {})
    assert "streamed" not in got
    wr_h = _wr_cases()["valid"]
    ws = tstreaming.WrStream(device="cpu",
                             anomalies=rw_register_checker().anomalies)
    for op in wr_h.ops:
        ws.feed(op)
    wres = ws.finish()
    got = rw_register_checker(device="cpu").check(
        {"streamed-results": {"elle-wr": wres}}, _th(wr_h), {})
    assert got["streamed"] is True
