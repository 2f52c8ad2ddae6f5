"""The port's independent checker against the JAX package's: the same
key-sharded histories give the same per-key verdicts, culprit ops and
failures, on `tests/test_independent.py`'s two-key history and on a
20-key one; device subcheckers go through `analysis_gpu_batch`, and a
failing batch raises, and an exhausted ladder degrades, instead of
falling back to per-key host checks."""

import pytest
import torch

from jepsen_tpu import independent as jind
from jepsen_tpu.checker.linear import linearizable as jlinearizable
from jepsen_tpu.history import history as jhistory
from jepsen_tpu.models import cas_register as jcas
from jepsen_tpu_torch import _platform as plat
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl
from jepsen_tpu_torch.checker.linear import linearizable
from jepsen_tpu_torch.history import history


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv_ops(kv):
    """tests/test_independent.py's history: key 'a' linearizable, key 'b'
    not (a read sees a value never written)."""
    ops = []
    t = [0]

    def add(process, typ, f, k, v):
        t[0] += 1
        ops.append({"type": typ, "f": f, "value": kv(k, v),
                    "process": process, "time": t[0]})

    add(0, "invoke", "write", "a", 1)
    add(0, "ok", "write", "a", 1)
    add(0, "invoke", "read", "a", None)
    add(0, "ok", "read", "a", 1)
    add(1, "invoke", "write", "b", 1)
    add(1, "ok", "write", "b", 1)
    add(1, "invoke", "read", "b", None)
    add(1, "ok", "read", "b", 2)  # never written!
    return ops


def _twenty_keys(kv):
    """20 keys' register histories composed into one history by time,
    processes offset per key, keys 3 and 11 corrupted, and a nemesis op
    that every subhistory keeps."""
    ops = []
    for k in range(20):
        h = tsynth.register_history(30, concurrency=3, values=4,
                                    crash_rate=0.03, seed=500 + k)
        if k in (3, 11):
            h = tsynth.corrupt(h, seed=k, value=4)
        for o in h.ops:
            o = dict(o)
            o["process"] = o["process"] + 100 * k
            o["value"] = kv(k, o["value"])
            o["time"] = o["time"] * 20 + k
            ops.append(o)
    ops.sort(key=lambda o: o["time"])
    ops.insert(len(ops) // 2, {"type": "info", "f": "start", "value": None,
                               "process": "nemesis", "time": 0})
    return ops


def _both(make, tcheck, jcheck):
    t = tcheck.check({}, history(make(tind.KV)), {})
    j = jcheck.check({}, jhistory(make(jind.KV)), {})
    assert t["valid?"] == j["valid?"]
    assert t["failures"] == j["failures"]
    assert list(t["results"]) == list(j["results"])
    for k in t["results"]:
        a, b = t["results"][k], j["results"][k]
        assert (a["valid?"], a.get("op-index"), a.get("max-frontier")) \
            == (b["valid?"], b.get("op-index"), b.get("max-frontier")), k
    return t


@pytest.mark.parametrize("make", [_kv_ops, _twenty_keys])
def test_batched_checker_matches_jax(make):
    t = _both(make,
              tind.checker(linearizable(tmodels.cas_register(),
                                        device="cpu")),
              jind.checker(jlinearizable(jcas(), pallas=True)))
    assert t["valid?"] is False and t["failures"]
    assert all(r["analyzer"] == "gpu-wgl-batch"
               for r in t["results"].values())


def test_host_subchecker_matches_jax_per_key():
    t = _both(_kv_ops,
              tind.checker(linearizable(tmodels.cas_register(), "host")),
              jind.checker(jlinearizable(jcas(), "host")))
    assert t["failures"] == ["b"]
    assert all("host" in r["analyzer"] for r in t["results"].values())


def test_failing_batch_raises_and_never_falls_back(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("simulated kernel breakage")

    monkeypatch.setattr(twgl, "analysis_gpu_batch", boom)
    c = tind.checker(linearizable(tmodels.cas_register(), device="cpu"))
    with pytest.raises(RuntimeError, match="simulated"):
        c.check({}, history(_kv_ops(tind.KV)), {})
    # the JAX package's per-key fallback cannot be asked for
    with pytest.raises(ValueError, match="strict_device"):
        tind.checker(linearizable(tmodels.cas_register(), device="cpu"),
                     strict_device=False)


def test_exhausted_ladder_leaves_keys_degraded_not_host_decided(
        monkeypatch):
    """Device faults past the batch's retry budget leave every key a
    degraded 'unknown' with its trail, never a host verdict."""
    def lost(site):
        raise plat.InjectedFault("device-lost", site, 1)

    monkeypatch.setattr(plat, "fault_hook", lost)
    c = tind.checker(linearizable(tmodels.cas_register(), device="cpu",
                                  max_recovery_retries=0))
    t = c.check({}, history(_kv_ops(tind.KV)), {})
    assert t["valid?"] == "unknown" and t["failures"] == []
    for r in t["results"].values():
        assert r["valid?"] == "unknown" and r["degraded"] is True
        assert r["recovery-failed"]["faults"] == ["device-lost"]
        assert "host" not in r["analyzer"]


def test_batch_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    c = tind.checker(linearizable(tmodels.cas_register()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        c.check({}, history(_kv_ops(tind.KV)), {})


def test_tuple_helpers_and_subhistory_match_jax():
    ops = _twenty_keys(tind.KV)
    jops = _twenty_keys(jind.KV)
    assert tind.history_keys(history(ops)) == \
        jind.history_keys(jhistory(jops))
    subs = tind.subhistories(history(ops), range(20))
    for k in (0, 3, 19):
        assert list(tind.subhistory(k, history(ops))) == \
            list(jind.subhistory(k, jhistory(jops))) == list(subs[k])
    t = tind.ktuple("k", 3)
    assert tind.is_tuple(t) and t.key == "k" and t.value == 3
    assert tind.tuple_key({"value": t}) == "k"
    assert tind.tuple_value({"value": t}) == 3
    assert tind.tuple_key({"value": 3}) is None
    assert repr(t) == repr(jind.ktuple("k", 3))
