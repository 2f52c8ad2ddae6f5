"""The port's tiered screen and competition race against the JAX
package's: `screen.screen_history` / `screen_wr` result dicts;
`Linearizable` at tier 'screen' (several sample fractions, register and
counter histories) with its `tier` and `escalated` record; the
rw-register checker's screen tier; the 'competition' race on a single
history and through the independent checker, equal up to the winner's
name ("gpu" where the JAX package says "tpu"); `Compose` /
`ConcurrencyLimit`; linear.svg on an invalid verdict; and ROADMAP
Queue 3's two inputs (F1, F2).

The JAX package runs under JAX_PLATFORMS=cpu with its Pallas hash dedup
switched on (JEPSEN_TPU_PALLAS_DEDUP=1, interpret mode), which is how it
prices and checks on its accelerator; no calibration is active. The
port runs with device="cpu"."""

import os
import subprocess
import sys
import time

import pytest
import torch

from jepsen_tpu import calibrate as jcalibrate
from jepsen_tpu import independent as jindependent
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import compose as jcompose
from jepsen_tpu.checker import concurrency_limit as jconcurrency_limit
from jepsen_tpu.checker import linear as jlinear
from jepsen_tpu.checker import noop as jnoop
from jepsen_tpu.checker import screen as jscreen
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.checker import unbridled_optimism as joptimism
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu.checker.elle import rw_register_checker as jrw_checker
from jepsen_tpu_torch import _platform
from jepsen_tpu_torch import history as thistory
from jepsen_tpu_torch import independent as tindependent
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker import (compose, concurrency_limit, noop,
                                      unbridled_optimism)
from jepsen_tpu_torch.checker import linear as tlinear
from jepsen_tpu_torch.checker import screen as tscreen
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl
from jepsen_tpu_torch.checker.elle import rw_register_checker

# keys that name the package, the host clock, or the port's own counts
_VOLATILE = {"duration-ms", "tail-latency-ms", "analyzer", "device",
             "closure-rounds", "dedup-launches", "host-syncs",
             "dense-shape", "competition-winner"}
_ANALYZERS = {"tpu-wgl": "gpu-wgl", "tpu-wgl-dense": "gpu-wgl-dense"}


@pytest.fixture(autouse=True)
def _as_on_the_accelerator(monkeypatch):
    """The JAX package as it resolves on its accelerator (the hash
    dedup on, interpret mode here), with no calibration; torch on one
    thread (tiny tensors)."""
    monkeypatch.setenv("JEPSEN_TPU_PALLAS_DEDUP", "1")
    assert jcalibrate.active() is None
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _th(h):
    return thistory.History(h.ops)


def _agree(t: dict, j: dict) -> None:
    """Equal result dicts, but for the host clock, the port's counts and
    the analyzer's package name."""
    for key in sorted(set(t) | set(j)):
        if key in _VOLATILE:
            continue
        assert t.get(key) == j.get(key), key
    if "analyzer" in j:
        assert t["analyzer"] == _ANALYZERS.get(j["analyzer"],
                                               j["analyzer"])


# -- ROADMAP Queue 3: F1 and F2 -------------------------------------------

def test_f1_tier_screen_matches_jax():
    """F1: the test map's tier 'screen' (and the checker option) take the
    tier route, with its 'tier' and 'escalated' record."""
    h = jsynth.register_history(200, concurrency=3, values=5, seed=7)
    j = jlinear.linearizable(jmodels.cas_register(0)).check(
        {"tier": "screen"}, h, {})
    t = tlinear.linearizable(tmodels.cas_register(0), device="cpu").check(
        {"tier": "screen"}, _th(h), {})
    assert j["tier"] == 1 and "escalated" in j
    _agree(t, j)
    t2 = tlinear.linearizable(tmodels.cas_register(0), device="cpu",
                              tier="screen").check({}, _th(h), {})
    _agree(t2, j)


def test_f2_competition_is_valid():
    """F2: algorithm 'competition' races instead of raising."""
    h = jsynth.register_history(100, concurrency=3, values=5, seed=3)
    j = jlinear.linearizable(jmodels.cas_register(0),
                             algorithm="competition").check({}, h, {})
    t = tlinear.linearizable(tmodels.cas_register(0),
                             algorithm="competition",
                             device="cpu").check({}, _th(h), {})
    assert j["valid?"] is True and t["valid?"] is True
    assert t["competition-winner"] in ("host", "gpu")


# -- the screens ------------------------------------------------------------

def _histories():
    reg = jsynth.register_history(160, concurrency=4, values=5,
                                  crash_rate=0.02, seed=11)
    return {
        "register": ("cas_register", reg),
        "register-phantom": ("cas_register", jsynth.corrupt(reg, seed=2)),
        "counter": ("counter", jsynth.counter_history(160, seed=5)),
        "counter-bad": ("counter", tsynth.corrupt(
            jsynth.counter_history(160, seed=5), seed=3, value=999)),
        "gset": ("gset", jsynth.gset_history(120, seed=4)),
        "mutex": ("mutex", jsynth.mutex_history(80, seed=6)),
    }


@pytest.mark.parametrize("name", sorted(_histories()))
def test_screen_history_matches_jax(name):
    model, h = _histories()[name]
    j = jscreen.screen_history(getattr(jmodels, model)(), h)
    t = tscreen.screen_history(getattr(tmodels, model)(), _th(h))
    _agree(t, j)
    assert t["screenable"] is (model != "mutex")


@pytest.mark.parametrize("name", ["register", "register-phantom",
                                  "counter", "counter-bad"])
def test_price_escalation_matches_jax(name):
    model, h = _histories()[name]
    j = jscreen.price_escalation(getattr(jmodels, model)(), h)
    t = tscreen.price_escalation(getattr(tmodels, model)(), _th(h))
    assert t == j and t is not None


def _wr_cycle():
    ops = []
    for p, txn in ((0, [["w", "x", 1], ["r", "y", 1]]),
                   (1, [["w", "y", 1], ["r", "x", 1]])):
        ops.append({"type": "invoke", "f": "txn", "value": txn,
                    "process": p})
        ops.append({"type": "ok", "f": "txn", "value": txn, "process": p})
    return jsynth.History(ops)


@pytest.mark.parametrize("which", ["valid", "cycle"])
def test_screen_wr_matches_jax(which):
    h = jsynth.wr_history(300, seed=45100) if which == "valid" \
        else _wr_cycle()
    j = jscreen.screen_wr(h)
    t = tscreen.screen_wr(_th(h))
    _agree(t, j)
    assert t["valid?"] is (which == "valid")


def test_should_escalate_and_sampling_match_jax():
    for key in range(0, 400, 7):
        for frac in (0.0, 0.05, 0.5, 1.0):
            assert tscreen.sample_decision(key, frac) == \
                jscreen.sample_decision(key, frac)
    for sc in ({"screenable": False}, {"suspicion": 1.0},
               {"suspicion": 0.2, "op-count": 17},
               {"suspicion": 0.0, "op-count": 3}):
        for cost in (None, 1e6, 1e9):
            assert tscreen.should_escalate(sc, 0.5, cost) == \
                jscreen.should_escalate(sc, 0.5, cost)


# -- the tier route ---------------------------------------------------------

@pytest.mark.parametrize("sample", [0, 0.5, 1])
@pytest.mark.parametrize("name", ["register", "register-phantom",
                                  "counter", "counter-bad"])
def test_linearizable_tier_matches_jax(name, sample):
    model, h = _histories()[name]
    test = {"tier": "screen", "screen-sample": sample}
    j = jlinear.linearizable(getattr(jmodels, model)()).check(test, h, {})
    t = tlinear.linearizable(getattr(tmodels, model)(),
                             device="cpu").check(test, _th(h), {})
    _agree(t, j)
    assert t["tier"] == 1


def test_rw_register_tier_matches_jax():
    for h in (jsynth.wr_history(300, seed=45100), _wr_cycle()):
        for sample in (0, 1):
            test = {"tier": "screen", "screen-sample": sample}
            j = jrw_checker().check(test, h, {})
            t = rw_register_checker(device="cpu").check(test, _th(h), {})
            _agree(t, j)
            assert t["tier"] == 1


def test_streamed_screen_is_reused():
    """A screen verdict streamed during the run stands in for the
    screen, under the same coverage guards as the JAX package's."""
    _, h = _histories()["register"]
    sc = tscreen.screen_history(tmodels.cas_register(), _th(h))
    sc["suspicion"] = 7.0     # marked, to tell reuse from a rerun
    test = {"tier": "screen", "screen-sample": 0,
            "streamed-results": {"screen-linear": sc}}
    t = tlinear.linearizable(tmodels.cas_register(),
                             device="cpu").check(test, _th(h), {})
    assert t["escalated"]["suspicion"] == 7.0
    test["streamed-results"]["screen-linear"] = dict(sc, **{
        "history-len": 3})
    t = tlinear.linearizable(tmodels.cas_register(),
                             device="cpu").check(test, _th(h), {})
    assert t["tier"] == 1 and "escalated" not in t


# -- the competition race ---------------------------------------------------

def _expected_side(model, h, name):
    """The JAX package's entry for the side that won: analysis_host for
    'host', analysis_tpu for the device, then the race's explanation."""
    jm = getattr(jmodels, model)()
    if name == "host":
        r = jlinear.analysis_host(jm, h)
    else:
        r = jwgl.analysis_tpu(jm, h, explain=False,
                              slot_overflow_fallback=False)
    if r["valid?"] is False and not r.get("final-paths") \
            and "op-index" in r:
        ex = jlinear.explain_failure(jm, h, r["op-index"])
        if ex is not None:
            r["configs"] = ex["configs"]
            r["final-paths"] = ex["final-paths"]
    return jlinear._truncate(r)


@pytest.mark.parametrize("name", ["register", "register-phantom",
                                  "counter-bad"])
def test_competition_matches_jax_up_to_winner(name):
    model, h = _histories()[name]
    j = jlinear.linearizable(getattr(jmodels, model)(),
                             algorithm="competition").check({}, h, {})
    t = tlinear.linearizable(getattr(tmodels, model)(),
                             algorithm="competition",
                             device="cpu").check({}, _th(h), {})
    for key in ("valid?", "op-index", "op", "op-count"):
        assert t.get(key) == j.get(key), key
    side = t["competition-winner"]
    assert side in ("host", "gpu")
    _agree(t, _expected_side(model, h, side))


def _kv_history(n_keys=4, bad=(1,)):
    ops = []
    for k in range(n_keys):
        h = jsynth.register_history(120, concurrency=3, values=5,
                                    crash_rate=0.0, seed=300 + k)
        if k in bad:
            h = tsynth.corrupt(h, seed=k, value=5)
        for o in h.ops:
            o = dict(o)
            o["process"] = o["process"] + 10 * k
            o["value"] = (k, o["value"])
            ops.append(o)
    return ops


def test_competition_batches_through_independent():
    ops = _kv_history()
    jops = [dict(o, value=jindependent.ktuple(*o["value"])) for o in ops]
    tops = [dict(o, value=tindependent.ktuple(*o["value"])) for o in ops]
    j = jindependent.checker(jlinear.linearizable(
        jmodels.cas_register(), algorithm="competition")).check(
        {}, jsynth.History(jops), {})
    t = tindependent.checker(tlinear.linearizable(
        tmodels.cas_register(), algorithm="competition",
        device="cpu")).check({}, thistory.History(tops), {})
    assert t["valid?"] is j["valid?"] is False
    assert t["failures"] == j["failures"] == [1]
    for k in j["results"]:
        for key in ("valid?", "op-index", "op", "op-count",
                    "max-frontier", "dedup"):
            assert t["results"][k].get(key) == \
                j["results"][k].get(key), (k, key)
        assert "batch-walk" in t["results"][k]


# -- the race's loser and the device side's failures ------------------------

def _race(hist, **kw):
    """The port's race on the CPU path: (result, wall seconds)."""
    t0 = time.perf_counter()
    r = tlinear.linearizable(tmodels.cas_register(), algorithm="competition",
                             device="cpu", **kw).check({}, hist, {})
    return r, time.perf_counter() - t0


def _racers_end(timeout_s: float) -> bool:
    """Do the race threads still running end within timeout_s?"""
    deadline = time.monotonic() + timeout_s
    for t in list(tlinear._RACERS):
        t.join(max(0.0, deadline - time.monotonic()))
    return not any(t.is_alive() for t in list(tlinear._RACERS))


def test_race_returns_with_its_winner():
    """The race returns at the winner's pace, with the winner's result,
    and its loser stops at its next poll of `cancel` instead of holding
    the verdict until it finishes. The history has crashed writes at the
    generator's default rate: the host search decides it in about a
    second, while the sort walk on the CPU path takes about 30 s, as one
    chunk."""
    hist = tsynth.register_history(400, concurrency=5, seed=23)
    assert any(o["type"] == "info" for o in hist.ops)
    t0 = time.perf_counter()
    alone = tlinear.analysis_host(tmodels.cas_register(), hist)
    alone_s = time.perf_counter() - t0
    r, race_s = _race(hist)
    assert r["competition-winner"] == "host"
    assert r["valid?"] is alone["valid?"] is True
    for key in sorted(set(r) | set(alone)):
        if key not in ("competition-winner", "duration-ms"):
            assert r.get(key) == alone.get(key), key
    # the two sides share the interpreter's lock, so the winner runs at
    # up to half its own pace in the race
    assert race_s < 4 * alone_s + 5.0, (race_s, alone_s)
    assert _racers_end(10.0)


def test_race_exits_cleanly_with_its_loser_running():
    """An interpreter that exits right after a race, its loser still
    inside a device call, cancels and joins the loser at exit: the
    process ends cleanly (without the join, torch aborts it). The device
    side here decides nothing and, once cancelled, finishes a second of
    tensor work before it returns."""
    code = (
        "import time, torch\n"
        "from jepsen_tpu_torch import models\n"
        "from jepsen_tpu_torch.checker import linear, synth, wgl\n"
        "def device_side(model, hist, cancel=None, **kw):\n"
        "    while not cancel():\n"
        "        time.sleep(0.005)\n"
        "    a = torch.ones(256, 256)\n"
        "    t = time.monotonic()\n"
        "    while time.monotonic() - t < 1.0:\n"
        "        a = torch.tanh(a @ a)\n"
        "    return {'valid?': 'unknown'}\n"
        "wgl.analysis_gpu = device_side\n"
        "h = synth.register_history(60, concurrency=3, seed=3)\n"
        "r = linear.linearizable(models.cas_register(), device='cpu',\n"
        "    algorithm='competition').check({}, h, {})\n"
        "assert r['competition-winner'] == 'host', r\n"
        "assert any(t.is_alive() for t in linear._RACERS)\n"
        "print('raced', flush=True)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "raced"


def _blocked_until_cancel(result: dict):
    """A race side that decides nothing until it is cancelled."""
    def side(model, hist, cancel=None, **_):
        deadline = time.monotonic() + 30.0
        while not cancel() and time.monotonic() < deadline:
            time.sleep(0.005)
        return dict(result, cancelled=cancel())
    return side


def test_race_reraises_a_device_failure(monkeypatch):
    """A kernel that fails to build, or a launch the ladder does not
    classify, is raised by the race and cancels the host search: it
    never comes back as a host verdict."""
    h = _th(jsynth.register_history(60, concurrency=3, values=5, seed=3))
    seen = []
    host = _blocked_until_cancel({"valid?": "unknown"})
    monkeypatch.setattr(tlinear, "analysis_host",
                        lambda *a, **k: seen.append(host(*a, **k)))
    for exc in (_platform.KernelCompileError("nvcc failed for k.cu"),
                _platform.KernelLaunchError("closure_round: bad shape")):
        def fault(site, exc=exc):
            raise exc
        monkeypatch.setattr(_platform, "fault_hook", fault)
        with pytest.raises(type(exc)):
            _race(h)
        assert _racers_end(10.0)
        assert seen.pop()["cancelled"] is True


def test_race_names_a_degraded_device(monkeypatch):
    """A device search that ends degraded past its recovery budget
    leaves its error on the host's verdict."""
    h = _th(jsynth.register_history(60, concurrency=3, values=5, seed=3))
    host = tlinear.analysis_host

    def late_host(*a, **k):
        time.sleep(1.0)   # the device side degrades in milliseconds
        return host(*a, **k)
    monkeypatch.setattr(tlinear, "analysis_host", late_host)
    monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT", "device-lost@offline:1")
    _platform.reset_fault_injection()
    r, _ = _race(h, max_recovery_retries=0)
    _platform.reset_fault_injection()
    assert r["valid?"] is True and r["competition-winner"] == "host"
    assert "device-lost" in r["device-error"]


def test_race_host_failure_is_an_unknown_as_in_jax(monkeypatch):
    """The host side keeps the JAX package's rule: its exception is an
    'unknown', and the device's verdict wins."""
    h = _th(jsynth.register_history(60, concurrency=3, values=5, seed=3))

    def broken(*a, **k):
        raise RuntimeError("host search bug")
    monkeypatch.setattr(tlinear, "analysis_host", broken)
    r, _ = _race(h)
    assert r["valid?"] is True and r["competition-winner"] == "gpu"


@pytest.mark.parametrize("chunk_entries", [4096, 64])
def test_device_search_stops_at_cancel(chunk_entries):
    """The device search polls `cancel` before each step, in a history
    walked as one chunk and in one walked chunk by chunk: a cancel
    raised mid-walk ends it 'unknown' within a step."""
    h = tsynth.register_history(300, concurrency=4, seed=5)
    full = twgl.analysis_gpu(tmodels.cas_register(), h, device="cpu",
                             chunk_entries=chunk_entries)
    polls = []

    def cancel():
        polls.append(1)
        return len(polls) > 40

    r = twgl.analysis_gpu(tmodels.cas_register(), h, device="cpu",
                          chunk_entries=chunk_entries, cancel=cancel)
    assert full["valid?"] is True
    assert r["valid?"] == "unknown" and r["error"] == "search cancelled"
    assert r["closure-rounds"] < full["closure-rounds"] / 4
    assert len(polls) == 41   # none after the first truthy poll


# -- composition and the failure rendering ---------------------------------

def _compose_pair(tier_test: dict):
    _, h = _histories()["register-phantom"]
    wr_h = _wr_cycle()
    jc = jcompose({"lin": jlinear.linearizable(jmodels.cas_register()),
                   "limited": jconcurrency_limit(
                       1, jlinear.linearizable(jmodels.cas_register())),
                   "noop": jnoop(), "ok": joptimism()})
    tc = compose({"lin": tlinear.linearizable(tmodels.cas_register(),
                                              device="cpu"),
                  "limited": concurrency_limit(1, tlinear.linearizable(
                      tmodels.cas_register(), device="cpu")),
                  "noop": noop(), "ok": unbridled_optimism()})
    jw = jcompose({"wr": jrw_checker(), "ok": joptimism()})
    tw = compose({"wr": rw_register_checker(device="cpu"),
                  "ok": unbridled_optimism()})
    return ((jc.check(tier_test, h, {}), tc.check(tier_test, _th(h), {})),
            (jw.check(tier_test, wr_h, {}),
             tw.check(tier_test, _th(wr_h), {})))


@pytest.mark.parametrize("tier", [None, "screen"])
def test_compose_and_concurrency_limit_match_jax(tier):
    test = {"tier": tier, "screen-sample": 0} if tier else {}
    for j, t in _compose_pair(test):
        assert set(t) == set(j)
        for key in t:
            if isinstance(j[key], dict):
                _agree(t[key], j[key])
            else:
                assert t[key] == j[key], key
    lin_j, _ = _compose_pair(test)
    assert lin_j[1]["valid?"] is False and lin_j[1]["noop"] is None
    if tier:
        assert lin_j[1]["escalated-checkers"] == ["limited", "lin"]


def test_invalid_verdict_writes_linear_svg(tmp_path):
    _, h = _histories()["register-phantom"]
    test = {"name": "svg", "start-time": "t0",
            "store-dir": str(tmp_path / "t")}
    jtest = dict(test, **{"store-dir": str(tmp_path / "j")})
    t = tlinear.linearizable(tmodels.cas_register(),
                             device="cpu").check(test, _th(h), {})
    jlinear.linearizable(jmodels.cas_register()).check(jtest, h, {})
    assert t["valid?"] is False
    tp = tmp_path / "t" / "svg" / "t0" / "linear.svg"
    jp = tmp_path / "j" / "svg" / "t0" / "linear.svg"
    assert tp.read_text() == jp.read_text()
    assert f"culprit index {t['op-index']}" in tp.read_text()
    # a valid verdict, and an ad-hoc check with no run, write nothing
    _, ok = _histories()["register"]
    tlinear.linearizable(tmodels.cas_register(),
                         device="cpu").check(dict(test, name="ok"),
                                             _th(ok), {})
    assert not (tmp_path / "t" / "ok").exists()
    assert os.listdir(tmp_path / "t" / "svg" / "t0") == ["linear.svg"]


def test_tier_knobs_never_reach_the_engine():
    """tier / screen_sample are the checker's own options: a full check
    with them set runs the engine without them (the F1 TypeError)."""
    _, h = _histories()["register"]
    t = tlinear.linearizable(tmodels.cas_register(), device="cpu",
                             tier="full", screen_sample=0.5).check(
        {}, _th(h), {})
    a = twgl.analysis_gpu(tmodels.cas_register(), _th(h), device="cpu")
    assert t["valid?"] is a["valid?"] is True and "tier" not in t
