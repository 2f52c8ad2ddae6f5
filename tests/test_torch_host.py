"""The port's host modules against the JAX package's: its own copies of
history, models, synth and the host oracle give the same values, its
engine choice agrees, it resolves devices without falling back, and it
never imports jax or jepsen_tpu."""

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
          ((-1, 10 ** 6), 7, 14_000), ((0, 1), 22, 10), ((-3, 3), 9, 10 ** 6)]


@pytest.mark.parametrize("srange,p,n", SHAPES)
def test_select_engine_agrees_with_jax_off_tpu(srange, p, n):
    for engine in ("auto", "dense", "sort"):
        for cap in (None, 8):
            try:
                want = jwgl.select_engine(srange, p, n, engine=engine,
                                          dense_slot_cap=cap)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    twgl.select_engine(srange, p, n, engine=engine,
                                       dense_slot_cap=cap)
                continue
            got = twgl.select_engine(srange, p, n, engine=engine,
                                     dense_slot_cap=cap)
            assert (got.family, got.dense, got.dedup, got.reason) == \
                (want.family, want.dense, want.dedup, want.reason)
            assert got.costs == want.costs
    assert twgl._dense_shape(srange, p) == jwgl._dense_shape(srange, p)
    assert twgl._family_costs(8, p, 32, 256, n) == \
        jwgl._family_costs(8, p, 32, 256, n)


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
from jepsen_tpu_torch import carry, models
from jepsen_tpu_torch.checker import linear, synth, wgl, wgl_closure, abft
h = synth.register_history(120, concurrency=4, crash_rate=0.03, seed=1)
r = linear.linearizable(models.cas_register(), device="cpu",
                        chunk_entries=40).check({}, h, {})
assert r["valid?"] is True and r["analyzer"] == "gpu-wgl-dense", r
bad = linear.linearizable(models.cas_register(), device="cpu").check(
    {}, synth.corrupt(h, value=5), {})
assert bad["valid?"] is False and "op-index" in bad, bad
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


def test_port_sources_name_no_jax_import():
    for p in list((REPO / "jepsen_tpu_torch").rglob("*.py")) + \
            [REPO / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (p, s)
            assert not s.startswith(("import jepsen_tpu ",
                                     "import jepsen_tpu.",
                                     "from jepsen_tpu ",
                                     "from jepsen_tpu.")), (p, s)
