"""The slice as a whole: `analysis_gpu(device="cpu")` and the port's
`Linearizable` against the JAX package's `analysis_tpu` on the same
histories — same verdict, culprit op, max-frontier, op-count, engine
choice and explanation."""

import random

import pytest
import torch

from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu_torch import history as thistory
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker import linear as tlinear
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl
from jepsen_tpu_torch.checker import wgl_closure


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the
    other test workers' threads, which slows these tests tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEYS = ("valid?", "op-index", "max-frontier", "op-count", "engine-reason",
        "final-paths", "configs", "previous-ok", "op")


def _both(model_name, hist, **kw):
    t = twgl.analysis_gpu(getattr(tmodels, model_name)(),
                          thistory.History(hist.ops), device="cpu", **kw)
    j = jwgl.analysis_tpu(getattr(jmodels, model_name)(), hist, **kw)
    return t, j


def _agree(t, j):
    assert t["analyzer"] == "gpu-wgl-dense" and \
        j["analyzer"] == "tpu-wgl-dense"
    assert t["device"] == "cpu"
    for key in KEYS:
        assert t.get(key) == j.get(key), key


# (n_ops, concurrency, crash_rate, seed, corrupt?)
CORPUS = [(300, 5, 0.01, 1, False), (300, 5, 0.01, 1, True),
          (400, 4, 0.02, 2, False), (400, 4, 0.02, 2, True),
          (250, 6, 0.015, 3, True), (500, 3, 0.0, 4, False),
          (500, 3, 0.0, 4, True), (350, 7, 0.01, 5, True)]


@pytest.mark.parametrize("chunk", [10 ** 9, 97])
@pytest.mark.parametrize("case", CORPUS)
def test_analysis_matches_jax(case, chunk):
    n, conc, crash, seed, bad = case
    h = jsynth.register_history(n, concurrency=conc, values=5,
                                crash_rate=crash, seed=seed)
    if bad:
        # one past the generator's values: illegal, and the state range
        # stays dense (the default phantom sends both packages to the
        # sort family, see the next test)
        h = tsynth.corrupt(h, seed=seed, value=5)
    t, j = _both("cas_register", h, chunk_entries=chunk)
    _agree(t, j)
    assert t["valid?"] is (not bad)
    if chunk < 10 ** 9:
        assert t["attested"] == {"steps": 1, "carry": 1}
    assert t["closure-rounds"] > 0 and t["host-syncs"] >= \
        t["closure-rounds"]


def test_sort_family_shapes_raise_instead_of_leaving_the_device():
    h = jsynth.corrupt(jsynth.register_history(200, concurrency=4,
                                               seed=3), seed=3)
    j = jwgl.analysis_tpu(jmodels.cas_register(), h, explain=False)
    assert j["analyzer"] == "tpu-wgl"       # the sort family
    with pytest.raises(NotImplementedError, match="next slice"):
        twgl.analysis_gpu(tmodels.cas_register(), h, device="cpu")
    with pytest.raises(NotImplementedError, match="sort-frontier"):
        tlinear.linearizable(tmodels.cas_register(), device="cpu").check(
            {}, h, {})
    ok = jsynth.register_history(100, concurrency=3, seed=1)
    with pytest.raises(NotImplementedError):
        twgl.analysis_gpu(tmodels.cas_register(), ok, device="cpu",
                          engine="sort")
    with pytest.raises(ValueError, match="dense_slot_cap"):
        twgl.analysis_gpu(tmodels.cas_register(), ok, device="cpu",
                          engine="dense", dense_slot_cap=1)


def _mutex_history(n, seed):
    """Valid-by-construction mutex history: a lock granted at invoke."""
    rng = random.Random(seed)
    ops, holder, waiting = [], None, {}
    for _ in range(n):
        p = rng.randrange(4)
        if p in waiting:
            ops.append({**waiting.pop(p), "type": "ok"})
            continue
        f = "release" if holder == p else "acquire"
        if f == "acquire" and holder is not None:
            continue
        holder = p if f == "acquire" else None
        inv = {"type": "invoke", "f": f, "value": None, "process": p}
        ops.append(inv)
        waiting[p] = inv
    ops += [{**o, "type": "ok"} for o in waiting.values()]
    return jsynth.History(ops)


def _counter_history(n, seed):
    """Valid-by-construction counter history (applied at invoke)."""
    rng = random.Random(seed)
    ops, value, waiting = [], 0, {}
    for _ in range(n):
        p = rng.randrange(3)
        if p in waiting:
            ops.append(waiting.pop(p))
            continue
        if rng.random() < 0.5:
            d = rng.randrange(-2, 3)
            value += d
            ops.append({"type": "invoke", "f": "add", "value": d,
                        "process": p})
            waiting[p] = {**ops[-1], "type": "ok"}
        else:
            ops.append({"type": "invoke", "f": "read", "value": None,
                        "process": p})
            waiting[p] = {**ops[-1], "type": "ok", "value": value}
    ops += list(waiting.values())
    return jsynth.History(ops)


@pytest.mark.parametrize("seed", range(2))
def test_other_device_models_match_jax(seed):
    for name, h in (("mutex", _mutex_history(120, seed)),
                    ("counter", _counter_history(120, seed))):
        t, j = _both(name, h, chunk_entries=50)
        _agree(t, j)
        assert t["valid?"] is True
        bad = jsynth.History([dict(o) for o in h.ops])
        reads = [o for o in bad.ops if o["type"] == "ok"
                 and o["f"] == "read"]
        if reads:                         # counter: an impossible read
            reads[len(reads) // 2]["value"] += 1
            t, j = _both(name, bad, chunk_entries=50)
            _agree(t, j)


def test_linearizable_checker_routes_to_the_port():
    h = jsynth.register_history(200, concurrency=4, crash_rate=0.02,
                                seed=8)
    th = thistory.History(h.ops)
    for algo in ("auto", "gpu", "tpu", "wgl"):
        r = tlinear.linearizable(tmodels.cas_register(), algo,
                                 device="cpu").check({}, th, {})
        assert r["valid?"] is True and r["analyzer"] == "gpu-wgl-dense"
    r = tlinear.linearizable({"model": tmodels.cas_register(),
                              "algorithm": "host"}).check({}, th, {})
    assert r["valid?"] is True and r["analyzer"] == "host-jit-linear"
    bad = tsynth.corrupt(th, seed=8, value=5)
    r = tlinear.linearizable(tmodels.cas_register(), device="cpu")(
        {}, bad)
    assert r["valid?"] is False and r["final-paths"]
    assert len(r["final-paths"]) <= 10 and len(r["configs"]) <= 10
    # no device form: auto goes to the host oracle, gpu says unknown
    fifo = thistory.History([
        {"type": "invoke", "f": "enqueue", "value": 1, "process": 0},
        {"type": "ok", "f": "enqueue", "value": 1, "process": 0}])
    assert tlinear.linearizable(tmodels.fifo_queue()).check(
        {}, fifo, {})["valid?"] is True
    assert tlinear.linearizable(tmodels.fifo_queue(), "gpu").check(
        {}, fifo, {})["valid?"] == "unknown"
    with pytest.raises(ValueError):
        tlinear.linearizable(tmodels.cas_register(), "knossos").check(
            {}, th, {})


def test_budget_and_cancel_match_jax():
    h = jsynth.register_history(400, concurrency=4, seed=12)
    t, j = _both("cas_register", h, chunk_entries=50, budget_s=0.0)
    assert t["valid?"] == j["valid?"] == "unknown"
    assert "budget" in t["error"]
    t = twgl.analysis_gpu(tmodels.cas_register(), h, device="cpu",
                          chunk_entries=50, cancel=lambda: True)
    assert t["valid?"] == "unknown" and "cancelled" in t["error"]
    # one chunk: decided regardless of the budget
    t, j = _both("cas_register", h, budget_s=0.0)
    assert t["valid?"] is j["valid?"] is True


def test_attestation_off_skips_the_digests(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_ATTEST", "0")
    h = jsynth.register_history(200, concurrency=4, seed=13)
    t = twgl.analysis_gpu(tmodels.cas_register(), h, device="cpu",
                          chunk_entries=50)
    assert t["valid?"] is True and "attested" not in t


def test_corrupted_staging_raises(monkeypatch):
    """A staged buffer that differs from the host copy is caught by the
    staged-buffer digest before the walk starts."""
    real = twgl.stage_steps

    def flipped(x, device):
        s = real(x, device)
        dev = s.dev.clone()
        dev[len(dev) // 2, 3] ^= 1
        return twgl.Staged(s.host, dev)

    monkeypatch.setattr(twgl, "stage_steps", flipped)
    h = jsynth.register_history(100, concurrency=3, seed=14)
    with pytest.raises(twgl.CorruptDeviceResult, match="staged-buffer"):
        twgl.analysis_gpu(tmodels.cas_register(), h, device="cpu")


def test_cpu_run_launches_no_kernel():
    before = wgl_closure.LAUNCHES
    h = jsynth.register_history(150, concurrency=4, seed=15)
    t = twgl.analysis_gpu(tmodels.cas_register(), h, device="cpu")
    assert t["valid?"] is True and t["closure-rounds"] > 0
    assert wgl_closure.LAUNCHES == before
