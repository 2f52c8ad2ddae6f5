"""The port's recovery ladder and fault injection (`_platform`,
`wgl.analysis_gpu`, `wgl.analysis_gpu_batch`) against the JAX package's:
the classifier over torch exception types and CUDA messages; every rung
through the env grammar and through `fault_hook` on the offline and the
batch entries, with the verdicts of an uninterrupted run; the OOM split
and its trail merge next to the JAX package's on the same injection;
the final rung, a degraded 'unknown' with the JAX package's fault trail
where the JAX package lets the host decide; a bit flip caught by
attestation and retried; and compile faults re-raised, where the JAX
package retries without its Pallas kernels."""

import threading
import time

import pytest
import torch

import jepsen_tpu._platform as jplat
import jepsen_tpu.control.retry as jretry
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu.history import History as JHistory
from jepsen_tpu_torch import _build
from jepsen_tpu_torch import _platform as plat
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch import util
from jepsen_tpu_torch.checker import UNKNOWN, check_safe, merge_valid
from jepsen_tpu_torch.checker import linear as tlinear
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl

MODEL = tmodels.cas_register()


@pytest.fixture(autouse=True)
def _fast_deterministic_faults(monkeypatch):
    """Zero both ladders' backoff, isolate each test's injection
    counters, and keep torch to one thread."""
    monkeypatch.setattr(util, "backoff", lambda *a, **k: iter([0.0] * 99))
    monkeypatch.setattr(jretry, "backoff", lambda *a, **k: iter([0.0] * 99))
    plat.reset_fault_injection()
    jplat.reset_fault_injection()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    plat.fault_hook = plat.corrupt_hook = None
    jplat.fault_hook = None
    plat.reset_fault_injection()
    jplat.reset_fault_injection()


def _hist(seed=13, n=120, conc=4):
    return tsynth.register_history(n, concurrency=conc, values=5, seed=seed)


def _one_shot(kind, site, at=1, mod=plat):
    """A fault_hook raising InjectedFault(kind) at the at-th dispatch on
    site, once — a transient fault."""
    state = {"n": 0}

    def hook(s):
        if s == site:
            state["n"] += 1
            if state["n"] == at:
                raise mod.InjectedFault(kind, s, state["n"])
    return hook


def _always(kind, site, mod=plat):
    def hook(s):
        if s == site:
            raise mod.InjectedFault(kind, s, 0)
    return hook


# -- classify_backend_error -------------------------------------------------

_ACC = getattr(torch, "AcceleratorError", RuntimeError)


def _acc(msg):
    try:
        return _ACC(msg)
    except TypeError:              # a constructor with another signature
        return RuntimeError("CUDA error: " + msg)


@pytest.mark.parametrize("exc,bucket", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), "oom"),
    (RuntimeError("CUDA error: out of memory"), "oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "device-lost"),
    (RuntimeError("CUDA error: unspecified launch failure"), "device-lost"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
     "device-lost"),
    (RuntimeError("CUDA error: device-side assert triggered"),
     "device-lost"),
    (_acc("CUDA error: an illegal memory access was encountered"),
     "device-lost"),
    (RuntimeError("CUDA error: no kernel image is available for execution "
                  "on the device"), "compile"),
    (RuntimeError("CUDA error: the launch timed out and was terminated"),
     "wedged"),
    (RuntimeError("CUDA error: something opaque"), "wedged"),
    (plat.KernelLaunchError("dedup launch failed: CUDA error 700 (an "
                            "illegal memory access was encountered)"),
     "device-lost"),
    (plat.KernelLaunchError("closure_round launch failed: CUDA error 1 "
                            "(invalid argument)"), None),
    (plat.KernelCompileError("nvcc failed for dedup"), "compile"),
    (plat.WedgedDeviceSync("device sync at x still blocked"), "wedged"),
    (plat.CorruptDeviceResult("offline", "digest"), "corrupt"),
    (plat.InjectedFault("oom", "batch", 1), "oom"),
    (RuntimeError("a checker bug mentioning an illegal memory access"),
     None),
    (ValueError("CUDA error: out of memory"), None),
    (KeyError("oom"), None),
])
def test_classifier_buckets_torch_and_cuda_errors(exc, bucket):
    assert plat.classify_backend_error(exc) == bucket


def test_fault_kinds_and_injection_grammar_match_jax(monkeypatch):
    assert plat.FAULT_KINDS == jplat.FAULT_KINDS
    assert plat.FAULT_INJECT_ENV == jplat.FAULT_INJECT_ENV
    assert plat.SYNC_DEADLINE_ENV == jplat.SYNC_DEADLINE_ENV
    monkeypatch.setenv(plat.FAULT_INJECT_ENV,
                       "oom@batch:2, wedged@offline, bitflip@batch:1")
    seen = []
    for mod in (plat, jplat):
        fired = []
        for site in ("batch", "offline", "batch", "batch", "offline"):
            try:
                mod.maybe_inject_fault(site)
                fired.append(None)
            except RuntimeError as e:
                fired.append((site, e.kind))
        seen.append(fired)
    assert seen[0] == seen[1] == [None, ("offline", "wedged"),
                                  ("batch", "oom"), None, None]
    import numpy as np
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    a, b = plat.maybe_corrupt("batch", x), jplat.maybe_corrupt("batch", x)
    assert (a == b).all() and not (a == x).all()
    assert plat.maybe_corrupt("batch", x) is x       # fires once


def test_guarded_fetch_watchdog(monkeypatch):
    monkeypatch.setenv(plat.SYNC_DEADLINE_ENV, "0.05")
    with pytest.raises(plat.WedgedDeviceSync):
        plat.guarded_fetch(lambda: time.sleep(2), site="test")
    assert plat.guarded_fetch(lambda: 7) == 7
    monkeypatch.delenv(plat.SYNC_DEADLINE_ENV)
    before = threading.active_count()
    me = []
    assert plat.guarded_fetch(lambda: me.append(
        threading.current_thread()) or 3) == 3
    assert me == [threading.current_thread()]     # no thread spawned
    assert threading.active_count() == before


def test_engine_reads_go_through_the_watchdog(monkeypatch):
    monkeypatch.setenv(plat.SYNC_DEADLINE_ENV, "30")
    sites = []
    real = plat.guarded_fetch

    def spy(read, deadline_s=None, site="device-sync"):
        sites.append(site)
        return real(read, deadline_s, site)
    monkeypatch.setattr(twgl, "guarded_fetch", spy)
    a = twgl.analysis_gpu(MODEL, _hist(), device="cpu", chunk_entries=64)
    assert a["valid?"] is True
    assert "offline attest" in sites and len(sites) == a["host-syncs"]


# -- the offline entry ------------------------------------------------------

@pytest.fixture(scope="module")
def offline_baseline():
    return twgl.analysis_gpu(MODEL, _hist(), device="cpu")


@pytest.mark.parametrize("via", ["hook", "env"])
@pytest.mark.parametrize("kind", ["oom", "device-lost", "wedged", "corrupt"])
def test_offline_fault_recovers_with_identical_verdict(
        kind, via, offline_baseline, monkeypatch):
    if via == "hook":
        plat.fault_hook = _one_shot(kind, "offline")
    else:
        monkeypatch.setenv(plat.FAULT_INJECT_ENV, f"{kind}@offline:1")
    a = twgl.analysis_gpu(MODEL, _hist(), device="cpu")
    assert a["valid?"] == offline_baseline["valid?"] is True
    assert a["recovered"] == {"faults": [kind], "retries": 1}
    assert not a.get("degraded")
    if kind == "oom":    # the rung re-selects with dense_slot_cap 0
        assert a["analyzer"] == "gpu-wgl"
    else:
        assert a["analyzer"] == offline_baseline["analyzer"]


def test_offline_rungs_match_jax_on_a_chunked_invalid_history():
    h = tsynth.corrupt(_hist(seed=3), value=5)
    for kind in ("oom", "device-lost", "corrupt"):
        plat.reset_fault_injection()
        jplat.reset_fault_injection()
        plat.fault_hook = _one_shot(kind, "offline", at=2)
        jplat.fault_hook = _one_shot(kind, "offline", at=2, mod=jplat)
        t = twgl.analysis_gpu(MODEL, h, device="cpu", chunk_entries=40)
        j = jwgl.analysis_tpu(jmodels.cas_register(), JHistory(h.ops),
                              chunk_entries=40, pallas=True)
        for f in ("valid?", "op-index", "recovered", "dedup",
                  "frontier-size"):
            assert t.get(f) == j.get(f), (kind, f)


def test_offline_bitflip_caught_by_attestation_and_retried(
        offline_baseline, monkeypatch):
    monkeypatch.setenv(plat.FAULT_INJECT_ENV, "bitflip@offline:1")
    a = twgl.analysis_gpu(MODEL, _hist(), device="cpu")
    assert a["valid?"] is True
    assert a["recovered"] == {"faults": ["corrupt"], "retries": 1}
    assert a["closure-rounds"] == offline_baseline["closure-rounds"]


@pytest.mark.parametrize("kind", ["oom", "device-lost", "wedged",
                                  "corrupt"])
def test_offline_exhausted_budget_degrades_with_jax_trail(kind):
    """Past the retry budget the port reports a degraded 'unknown' with
    its fault trail, where the JAX package lets the host decide: the
    trails are the same, the port's result carries no verdict."""
    plat.fault_hook = _always(kind, "offline")
    jplat.fault_hook = _always(kind, "offline", mod=jplat)
    h = tsynth.corrupt(_hist(), value=5)
    t = twgl.analysis_gpu(MODEL, h, device="cpu", max_recovery_retries=1)
    j = jwgl.analysis_tpu(jmodels.cas_register(), JHistory(h.ops),
                          pallas=True, max_recovery_retries=1)
    assert j["recovered"]["fallback"] == "host"
    assert t["recovery-failed"] == {"faults": j["recovered"]["faults"],
                                    "retries": 1}
    assert t["valid?"] == UNKNOWN and t["degraded"] is True
    assert t["analyzer"] == "gpu-wgl" and "recovered" not in t
    assert "op-index" not in t and t["op-count"] == len(h)


def test_offline_final_rung_never_runs_the_host_oracle(monkeypatch):
    def no_host(*a, **k):
        raise AssertionError("the final rung ran the host oracle")
    monkeypatch.setattr(tlinear, "analysis_host", no_host)
    plat.fault_hook = _always("device-lost", "offline")
    a = twgl.analysis_gpu(MODEL, _hist(), device="cpu",
                          max_recovery_retries=0)
    assert a["valid?"] == UNKNOWN and a["degraded"] is True
    assert a["recovery-failed"]["faults"] == ["device-lost"]
    assert "device-lost" in a["error"]


@pytest.mark.parametrize("exc", [
    plat.InjectedFault("compile", "offline", 1),
    plat.KernelCompileError("nvcc failed for closure_round"),
    RuntimeError("a checker bug, not a device fault"),
])
def test_offline_compile_faults_and_bugs_are_re_raised(exc):
    def hook(site):
        if site == "offline":
            raise exc
    plat.fault_hook = hook
    with pytest.raises(RuntimeError) as got:
        twgl.analysis_gpu(MODEL, _hist(), device="cpu")
    assert got.value is exc


def test_device_reinit_drops_the_kernel_handles():
    from jepsen_tpu_torch.checker import wgl_closure, wgl_dedup
    calls = []
    for fn in (wgl_closure._kernel, wgl_dedup._kernel, _build.library):
        calls.append(hasattr(fn, "cache_clear"))
    twgl._device_reinit()
    assert all(calls)
    assert wgl_closure._kernel.cache_info().currsize == 0


# -- the batch entry --------------------------------------------------------

def _batch_hists():
    hs = [_hist(seed=s, n=40, conc=3) for s in (10, 11, 12, 13)]
    hs[2] = tsynth.corrupt(hs[2], value=5)
    return hs


@pytest.fixture(scope="module")
def batch_baseline():
    return [(r["valid?"], r.get("op-index")) for r in
            twgl.analysis_gpu_batch(MODEL, _batch_hists(), device="cpu")]


@pytest.mark.parametrize("via", ["hook", "env"])
@pytest.mark.parametrize("kind", ["device-lost", "wedged", "corrupt"])
def test_batch_fault_recovers_with_identical_verdicts(
        kind, via, batch_baseline, monkeypatch):
    if via == "hook":
        plat.fault_hook = _one_shot(kind, "batch")
    else:
        monkeypatch.setenv(plat.FAULT_INJECT_ENV, f"{kind}@batch:1")
    rs = twgl.analysis_gpu_batch(MODEL, _batch_hists(), device="cpu")
    assert [(r["valid?"], r.get("op-index")) for r in rs] == batch_baseline
    assert all(r["recovered"] == {"faults": [kind], "retries": 1}
               for r in rs)


@pytest.mark.parametrize("via", ["hook", "env"])
def test_batch_oom_splits_and_merges_trails_like_jax(
        via, batch_baseline, monkeypatch):
    hs = _batch_hists()
    if via == "hook":
        plat.fault_hook = _one_shot("oom", "batch")
        jplat.fault_hook = _one_shot("oom", "batch", mod=jplat)
    else:
        monkeypatch.setenv(plat.FAULT_INJECT_ENV, "oom@batch:1")
    t = twgl.analysis_gpu_batch(MODEL, hs, device="cpu")
    j = jwgl.analysis_tpu_batch(jmodels.cas_register(),
                                [JHistory(h.ops) for h in hs], pallas=True)
    assert [(r["valid?"], r.get("op-index")) for r in t] == batch_baseline
    assert [r["recovered"] for r in t] == [r["recovered"] for r in j]
    assert all(r["recovered"] == {"faults": ["oom"], "retries": 1,
                                  "split": True} for r in t)
    # each half walked on its own: two keys a walk
    assert {r["batch-walk"]["keys"] for r in t} == {2}


def test_batch_oom_in_one_group_splits_that_group_only():
    hs = [_hist(seed=s, n=40, conc=c) for s, c in
          zip((20, 21, 22, 23), (2, 2, 6, 6))]
    plat.fault_hook = _one_shot("oom", "batch")
    jplat.fault_hook = _one_shot("oom", "batch", mod=jplat)
    t = twgl.analysis_gpu_batch(MODEL, hs, device="cpu")
    j = jwgl.analysis_tpu_batch(jmodels.cas_register(),
                                [JHistory(h.ops) for h in hs], pallas=True)
    assert [r.get("recovered") for r in t] == [r.get("recovered") for r in j]
    assert [r["valid?"] for r in t] == [r["valid?"] for r in j]
    assert sum("recovered" in r for r in t) == 2


def test_batch_bitflip_caught_and_retried(batch_baseline, monkeypatch):
    monkeypatch.setenv(plat.FAULT_INJECT_ENV, "bitflip@batch:1")
    rs = twgl.analysis_gpu_batch(MODEL, _batch_hists(), device="cpu")
    assert [(r["valid?"], r.get("op-index")) for r in rs] == batch_baseline
    assert all(r["recovered"]["faults"] == ["corrupt"] for r in rs)


def test_batch_final_rung_degrades_each_key_with_jax_trail():
    hs = _batch_hists()
    plat.fault_hook = _always("wedged", "batch")
    jplat.fault_hook = _always("wedged", "batch", mod=jplat)
    rs = twgl.analysis_gpu_batch(MODEL, hs, device="cpu",
                                 max_recovery_retries=0)
    js = jwgl.analysis_tpu_batch(jmodels.cas_register(),
                                 [JHistory(h.ops) for h in hs], pallas=True,
                                 max_recovery_retries=0)
    assert [j["recovered"]["fallback"] for j in js] == ["host"] * len(hs)
    for r, j, h in zip(rs, js, hs):
        assert r["valid?"] == UNKNOWN and r["degraded"] is True
        assert r["recovery-failed"] == {"faults": j["recovered"]["faults"],
                                        "retries": 0}
        assert r["op-count"] == len(h) and "recovered" not in r


def test_batch_compile_fault_is_re_raised():
    plat.fault_hook = _always("compile", "batch")
    with pytest.raises(plat.InjectedFault, match="compile"):
        twgl.analysis_gpu_batch(MODEL, _batch_hists(), device="cpu")


# -- check_safe and merge_valid ---------------------------------------------

def test_check_safe_reports_classified_faults_as_degraded():
    def dead(test, hist, opts):
        raise plat.InjectedFault("device-lost", "offline", 1)

    def bug(test, hist, opts):
        raise RuntimeError("checker bug")
    r = check_safe(dead, {}, [], {})
    assert r["valid?"] == UNKNOWN and r["degraded"] is True
    assert r["fault"] == "device-lost"
    r = check_safe(bug, {}, [], {})
    assert r["valid?"] == UNKNOWN and "degraded" not in r
    assert merge_valid([True, UNKNOWN, True]) == UNKNOWN
    assert merge_valid([True, False, UNKNOWN]) is False
    with pytest.raises(ValueError):
        merge_valid(["maybe"])


def test_linearizable_threads_the_retry_budget():
    plat.fault_hook = _always("wedged", "offline")
    c = tlinear.linearizable(MODEL, device="cpu")
    a = c.check({"max-recovery-retries": 0}, _hist(), {})
    assert a["recovery-failed"]["faults"] == ["wedged"]
    a = tlinear.linearizable(MODEL, device="cpu",
                             max_recovery_retries=1).check(
        {"max-recovery-retries": 0}, _hist(), {})
    assert a["recovery-failed"]["faults"] == ["wedged"] * 2
