"""The port's measured cost model (`jepsen_tpu_torch/calibrate.py`) and
the calibration hooks of its `select_engine` against the JAX package's
(`jepsen_tpu/calibrate.py`, `jepsen_tpu/checker/wgl.py`), on the CPU.

The same observations make the same coefficients; a file either package
saves loads in the other; the two default paths differ (the port never
reads XLA's numbers); and given one `Calibration`, built by `from_dict`
or fed the same observations, never a measured one, the port's engine
decision equals the JAX package's `select_engine(..., pallas=True)` on
a grid of shapes, with and without the process-wide active
calibration. The offline chunked walk feeds the active calibration from
its third chunk on, as the JAX package's does.
"""

from __future__ import annotations

import json
import os

import pytest

from jepsen_tpu import calibrate as jcal
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu_torch import calibrate as cal
from jepsen_tpu_torch import models
from jepsen_tpu_torch.checker import wgl

OBS = [("dense", 3.0e6, 0.0021), ("dense", 2.5e6, 0.0019),
       ("hash", 8.0e5, 0.0040), ("dense", 3.1e6, 60.0),   # a wedged chunk
       ("sort", 1.2e6, 0.0100), ("hash", 7.5e5, 0.0035),
       ("dense", 2.0e6, 1e-12), ("hash", 1.0, 0.5)]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Both packages' caches in the test's directory; no calibration
    active in either process-wide slot."""
    monkeypatch.setenv(cal.CACHE_DIR_ENV, str(tmp_path / "torch"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       str(tmp_path / "jax" / "jax"))
    monkeypatch.setenv("JEPSEN_TPU_PALLAS_DEDUP", "1")
    cal.deactivate()
    jcal.deactivate()
    yield
    cal.deactivate()
    jcal.deactivate()


def _feed(mod, obs, n=1):
    c = mod.Calibration(platform="cpu")
    for _ in range(n):
        for v, ops, s in obs:
            c.observe(v, ops, s)
    return c


def test_same_observations_make_the_same_coefficients():
    for n in (1, 3, 20):
        t, j = _feed(cal, OBS, n), _feed(jcal, OBS, n)
        assert t.coefficients() == j.coefficients()
        assert t.to_dict() == j.to_dict()
        for v in cal.VARIANTS:
            assert t.count(v) == j.count(v)
            assert t.coeff(v) == j.coeff(v)
            assert t.seconds(v, 1e6) == j.seconds(v, 1e6)
        assert t.ready("dense", "hash") == j.ready("dense", "hash")
    assert cal.VARIANTS == jcal.VARIANTS
    for name in ("MIN_OBSERVATIONS", "CLIP_FACTOR", "ALPHA_MIN",
                 "NOMINAL_SECONDS_PER_ELEMENTOP"):
        assert getattr(cal, name) == getattr(jcal, name), name
    assert cal.price(None, "dense", 5e6) == jcal.price(None, "dense", 5e6)
    c = _feed(cal, OBS)
    assert cal.price(c, "sort", 5e6) == jcal.price(
        jcal.Calibration.from_dict(c.to_dict()), "sort", 5e6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_saved_file_loads_in_the_other_package(tmp_path, writer):
    w, r = (cal, jcal) if writer == "port" else (jcal, cal)
    c = _feed(w, OBS, 3)
    p = c.save(str(tmp_path / "calibration-cpu.json"))
    with open(p) as fh:
        assert json.load(fh)["version"] == 1
    got = r.Calibration.load(p, platform="cpu")
    assert got.coefficients() == c.coefficients()
    assert got.to_dict() == c.to_dict()
    # a file for another platform, or a corrupt one, starts cold
    assert r.Calibration.load(p, platform="cuda").coefficients() == {}
    with open(p, "w") as fh:
        fh.write("{not json")
    assert r.Calibration.load(p, platform="cpu").coefficients() == {}


def test_default_paths_differ_and_detect_platform_reads_torch(
        monkeypatch, tmp_path):
    import torch
    assert cal.default_path("cpu") != jcal.default_path("cpu")
    assert cal.default_path("cpu") == os.path.join(
        str(tmp_path / "torch"), "calibration-cpu.json")
    monkeypatch.setenv("JAX_PLATFORMS", "tpu")    # never read by the port
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert cal.detect_platform() == want
    assert cal.Calibration().platform == want
    c = _feed(cal, OBS)
    assert c.save() == cal.default_path("cpu")
    assert cal.Calibration.load(platform="cpu").to_dict() == c.to_dict()


def _ready(mod, dense: float, hash_: float, sort: float):
    """A calibration with every variant trusted, from one dict."""
    n = cal.MIN_OBSERVATIONS
    return mod.Calibration.from_dict({
        "version": 1, "platform": "cpu",
        "families": {"dense": {"coeff": dense, "n": n},
                     "hash": {"coeff": hash_, "n": n},
                     "sort": {"coeff": sort, "n": n}}})


SHAPES = [((-1, 4), 5, 1024, 8, 256), ((-1, 4), 12, 1024, 16, 256),
          ((-1, 4), 14, 4096, 16, 256), ((-1, 10 ** 6), 7, 1024, 8, 256),
          ((0, 100), 3, 64, 8, 128), ((-1, 4), 19, 4096, 32, 256),
          ((0, 3), 8, 64, 8, 128), ((0, 600), 10, 2048, 16, 1024)]
CALS = [None, (1e-9, 1e-9, 1e-9), (1e-12, 1e-6, 1e-6),
        (1e-6, 1e-12, 1e-12), (3e-9, 2e-9, 5e-9)]


@pytest.mark.parametrize("coeffs", CALS)
@pytest.mark.parametrize("via", ["argument", "active"])
def test_select_engine_decisions_match_jax(coeffs, via):
    t = None if coeffs is None else _ready(cal, *coeffs)
    j = None if coeffs is None else _ready(jcal, *coeffs)
    if via == "active" and coeffs is not None:
        cal.activate(t)
        jcal.activate(j)
        t = j = None
    for srange, p, n, slots, F in SHAPES:
        for engine in ("auto", "sort", "dense"):
            try:
                want = jwgl.select_engine(srange, p, n, slots=slots,
                                          frontier=F, engine=engine,
                                          pallas=True, calibration=j)
            except ValueError:
                with pytest.raises(ValueError):
                    wgl.select_engine(srange, p, n, slots=slots,
                                      frontier=F, engine=engine,
                                      calibration=t)
                continue
            got = wgl.select_engine(srange, p, n, slots=slots, frontier=F,
                                    engine=engine, calibration=t)
            key = (srange, p, n, slots, F, engine)
            assert (got.family, got.dense, got.dedup, got.reason) == \
                (want.family, want.dense, want.dedup, want.reason), key
            assert got.costs == want.costs, key
            assert got.seconds == want.seconds, key
            assert wgl.engine_variant(got) == jwgl.engine_variant(want)


def test_half_trained_calibration_decides_nothing():
    """Fewer than MIN_OBSERVATIONS for a variant: the modeled decision
    stands, in both packages."""
    t = _feed(cal, OBS)
    base = wgl.select_engine((-1, 4), 12, 1024, slots=16)
    got = wgl.select_engine((-1, 4), 12, 1024, slots=16, calibration=t)
    assert got.seconds is None and got.reason == base.reason


def test_offline_walk_feeds_the_active_calibration_from_chunk_two():
    """analysis_gpu's chunked walk observes each chunk from the third
    on, into the active calibration only, under the decision's variant,
    as the JAX package's walk does."""
    h = jsynth.register_history(400, concurrency=3, values=5, seed=8)
    chunk = 64
    counts = {}
    for pkg, mod, m in (("port", cal, models), ("jax", jcal, jmodels)):
        def check():
            if pkg == "port":
                return wgl.analysis_gpu(m.cas_register(), h,
                                        chunk_entries=chunk, device="cpu")
            return jwgl.analysis_tpu(m.cas_register(), h,
                                     chunk_entries=chunk)
        c = mod.Calibration(platform="cpu")
        check()
        assert c.coefficients() == {}          # nothing active
        mod.activate(c)
        try:
            r = check()
        finally:
            mod.deactivate()
        assert r["valid?"] is True and r["dedup"] == "dense-table"
        counts[pkg] = {v: f["observations"]
                       for v, f in c.coefficients().items()}
    ops = wgl.encode_ops_for_model(models.cas_register(), h)
    chunks = -(-wgl.build_steps(ops, 4).n // chunk)
    assert chunks >= 4
    assert counts["port"] == counts["jax"] == {"dense": chunks - 2}
