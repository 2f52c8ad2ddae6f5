"""The port's sort-frontier engine against the JAX package's sort kernel
(`_kernel_cached`) on each of the three dedup routes: carries equal
element for element after every chunk, carry digests equal bit for bit,
a search resumed across the two packages in both directions; and
`analysis_gpu(device="cpu")` against `analysis_tpu(..., pallas=True)`,
the JAX package's resolution on its accelerator, with the hash dedup in
interpret mode."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import abft as jabft
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu_torch import history as thistory
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.carry import (SORT_LAYOUT, carry_from_numpy,
                                    carry_to_numpy)
from jepsen_tpu_torch.checker import abft as tabft
from jepsen_tpu_torch.checker import linear as tlinear
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl
from jepsen_tpu_torch.checker import wgl_dedup


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the
    other test workers' threads, which slows these tests tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reg(n=120, conc=4, seed=0, crash=0.02):
    return jsynth.register_history(n, concurrency=conc, values=4,
                                   crash_rate=crash, seed=seed)


def _phantom(h, seed, value=9):
    """One ok read set to a value never written (9 keeps the state range
    packable at 16 slots; the default 10**6 does at 8)."""
    ops = [dict(o) for o in h.ops]
    reads = [i for i, o in enumerate(ops)
             if o["type"] == "ok" and o["f"] == "read"]
    ops[random.Random(seed).choice(reads)]["value"] = value
    return jsynth.History(ops)


# label -> (model, history, F, P, hash dedup?)
SHAPES = {
    "hash": ("cas_register", lambda: _reg(), 256, 16, True),
    "hash-phantom": ("cas_register", lambda: jsynth.corrupt(_reg(seed=1),
                                                             seed=1),
                     256, 8, True),
    "hash-overflow": ("cas_register", lambda: _reg(conc=5, seed=3,
                                                   crash=0.05),
                      16, 16, True),
    "hash-counter": ("counter", lambda: jsynth.counter_history(150, seed=2),
                     256, 8, True),
    "packed": ("cas_register", lambda: _reg(), 256, 16, False),
    "packed-overflow": ("cas_register", lambda: _reg(conc=5, seed=3,
                                                     crash=0.05),
                        16, 16, False),
    "lex-32": ("cas_register", lambda: _phantom(_reg(seed=2), 2), 256, 32,
               False),
    "lex-64": ("cas_register", lambda: _reg(seed=4), 64, 64, False),
    "lex-queue": ("unordered_queue", lambda: jsynth.uqueue_history(
        120, seed=1), 256, 8, False),
    "hash-mutex": ("mutex", lambda: jsynth.History(
        chip_smoke.mutex_history(300, seed=5).ops), 64, 3, True),
    "packed-mutex": ("mutex", lambda: jsynth.History(
        chip_smoke.mutex_history(300, seed=6).ops), 64, 3, False),
}


def _setup(label):
    mname, mk, F, P, use_hash = SHAPES[label]
    model = getattr(jmodels, mname)()
    name = model.device_model
    h = mk()
    ops = jwgl.encode_ops_for_model(model, h)
    pack = jwgl._pack_params(jwgl._state_range(name, model, [ops]), P)
    route = twgl.DEDUP_PALLAS if use_hash else twgl.DEDUP_SORT
    # the label names the route: hash, one packed key, or lexicographic
    assert (pack is not None and P <= 32) == (not label.startswith("lex"))
    steps = jwgl.build_steps(ops, P)
    E = jwgl._bucket(max(jwgl.event_count(ops), 1))
    jk = jwgl._kernel_cached(name, F, P, E, pack, use_hash, False, True)
    tk = twgl.SortKernel(name, F, P, pack, route, "cpu")
    xj = jnp.asarray(steps.pad_to(E).x)
    xs = twgl.stage_steps(steps.x, "cpu")
    init = model.device_state()
    assert init == getattr(tmodels, mname)().device_state()
    return steps, jk, tk, xj, xs, init


def _assert_carry_equal(tc, jc, where):
    tn, jn = carry_to_numpy(tc), jax.device_get(jc)
    assert len(tn) == len(jn) == 12
    for i, (a, b) in enumerate(zip(tn, jn)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} elem {i}")


@pytest.mark.parametrize("label", list(SHAPES))
def test_carries_equal_after_every_chunk(label):
    steps, jk, tk, xj, xs, init = _setup(label)
    chunk = max(steps.n // 4, 1)
    jc, tc = jk.init_carry(jnp.int32(init)), tk.init_carry(init)
    _assert_carry_equal(tc, jc, "init")
    stops = list(range(chunk, steps.n, chunk)) + [steps.n]
    for i, stop in enumerate(stops):
        jc = jk.check_chunk(xj, jnp.int32(stop), jc)
        tc = tk.check_chunk(xs, stop, tc)
        _assert_carry_equal(tc, jc, f"chunk {i}")
        # the carry digest: port device == JAX device == host mirrors
        want = int(jk.digest(jc))
        assert int(tk.digest(tc)) == want
        assert jabft.carry_digest_host(jax.device_get(jc)) == want
        assert tabft.carry_digest_host(carry_to_numpy(tc)) == want
    jsum = [np.asarray(v).item() for v in jk.summarize(jc)]
    assert list(tk.summarize(tc)) == [bool(jsum[0]), jsum[1],
                                      bool(jsum[2])] + jsum[3:]
    if label.startswith("hash"):
        assert tk.dedups > 0 and tk.rounds > 0
    else:
        assert tk.dedups == 0
    if label.endswith("overflow"):
        assert jsum[2]                     # the frontier did overflow


@pytest.mark.parametrize("label", ["hash", "lex-64"])
def test_cross_resume_both_ways(label):
    steps, jk, tk, xj, xs, init = _setup(label)
    mid = steps.n // 2
    full = jk.check_chunk(xj, jnp.int32(steps.n),
                          jk.init_carry(jnp.int32(init)))
    # JAX runs chunk 0, the port resumes chunk 1
    j0 = jax.device_get(jk.check_chunk(xj, jnp.int32(mid),
                                       jk.init_carry(jnp.int32(init))))
    t1 = tk.check_chunk(xs, steps.n, carry_from_numpy(j0, "cpu"))
    _assert_carry_equal(t1, full, "jax->torch")
    # the port runs chunk 0, JAX resumes chunk 1
    t0 = carry_to_numpy(tk.check_chunk(xs, mid, tk.init_carry(init)))
    j1 = jk.check_chunk(xj, jnp.int32(steps.n),
                        tuple(jnp.asarray(c) for c in t0))
    _assert_carry_equal(tk.check_chunk(xs, steps.n, tk.init_carry(init)),
                        j1, "torch->jax")


def test_sort_carry_conversion_and_verification():
    steps, jk, tk, xj, xs, init = _setup("lex-32")
    tc = tk.check_chunk(xs, steps.n // 2, tk.init_carry(init))
    host = carry_to_numpy(tc)
    assert host[1].dtype == np.uint32
    back = carry_from_numpy(host, "cpu")
    assert [t.dtype for t in back] == [d for _n, d, _r in SORT_LAYOUT]
    for a, b in zip(back, tc):
        assert torch.equal(a, b)
    digest = int(tk.digest(tc))
    tabft.verify_carry("test", digest, host)
    jabft.verify_carry("test", digest, host)
    flipped = list(host)
    flipped[3] = host[3].copy()
    flipped[3][-1] = ~flipped[3][-1]          # a valid flag flips
    with pytest.raises(tabft.CorruptDeviceResult):
        tabft.verify_carry("test", digest, flipped)
    bad = list(host)
    bad[1] = bad[1].view(np.int32)            # masks must be uint32
    with pytest.raises(TypeError):
        carry_from_numpy(bad, "cpu")
    bad = list(host)
    bad[2] = bad[2][:-1]                      # states shorter than F
    with pytest.raises(ValueError):
        carry_from_numpy(bad, "cpu")


def test_bit_31_masks_sort_as_unsigned():
    """A mask holding bit 31 must sort after the masks without it, as
    lax.sort orders uint32, not before them as an int32 would."""
    k = twgl.SortKernel("cas-register", 4, 32, None, twgl.DEDUP_SORT, "cpu")
    masks = torch.tensor([[-2 ** 31], [1], [0], [-2 ** 31]],
                         dtype=torch.int32)
    states = torch.tensor([0, 0, 0, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True])
    origin = torch.tensor([False, False, True, True])
    m, s, v, new, ovf, _ = k._dedup(masks, states, valid, origin)
    assert m[:, 0].tolist() == [0, 1, -2 ** 31, -2 ** 31]
    assert v.tolist() == [True, True, True, False]
    assert new.tolist() == [True, False, False, False] and not bool(ovf)


# -- the whole slice against analysis_tpu(..., pallas=True) ------------------

KEYS = ("valid?", "op-index", "max-frontier", "frontier-size", "dedup",
        "engine-reason", "op-count", "configs", "final-paths",
        "previous-ok", "op", "error")


def _both(model_name, hist, **kw):
    t = twgl.analysis_gpu(getattr(tmodels, model_name)(),
                          thistory.History(hist.ops), device="cpu", **kw)
    j = jwgl.analysis_tpu(getattr(jmodels, model_name)(), hist,
                          pallas=True, **kw)
    for key in KEYS:
        assert t.get(key) == j.get(key), key
    assert t["device"] == "cpu"
    assert (t["analyzer"], j["analyzer"]) in (
        ("gpu-wgl", "tpu-wgl"), ("gpu-wgl-dense", "tpu-wgl-dense"))
    return t, j


SORT_KW = dict(frontier=256, slots=16, engine="sort")


@pytest.mark.parametrize("seed", [0, 1])
def test_valid_histories_match_jax(seed):
    t, _ = _both("cas_register", _reg(seed=seed), **SORT_KW)
    assert t["valid?"] is True and t["dedup"] == "pallas-hash"
    assert t["analyzer"] == "gpu-wgl"
    assert t["dedup-launches"] > 0 and t["closure-rounds"] > 0
    assert t["host-syncs"] > t["closure-rounds"]


@pytest.mark.parametrize("seed", [0, 1])
def test_corrupted_histories_blame_the_same_op(seed):
    bad = _phantom(_reg(seed=seed), seed)
    t, _ = _both("cas_register", bad, **SORT_KW)
    assert t["valid?"] is False and isinstance(t["op-index"], int)
    assert t["final-paths"] and t["configs"]


def test_default_phantom_routes_to_the_sort_family_under_auto():
    bad = jsynth.corrupt(jsynth.register_history(200, concurrency=4,
                                                 seed=3), seed=3)
    t, _ = _both("cas_register", bad, chunk_entries=64)
    assert t["valid?"] is False and t["analyzer"] == "gpu-wgl"
    assert t["dedup"] == "pallas-hash" and t["attested"]["carry"] == 1
    r = tlinear.linearizable(tmodels.cas_register(), device="cpu").check(
        {}, thistory.History(bad.ops), {})
    assert r["op-index"] == t["op-index"] and r["analyzer"] == "gpu-wgl"


def test_counter_mutex_and_queue_match_jax():
    t, _ = _both("counter", jsynth.counter_history(150, seed=1),
                 **SORT_KW)
    assert t["valid?"] is True and t["dedup"] == "pallas-hash"
    t, _ = _both("mutex", jsynth.mutex_history(120, seed=1), **SORT_KW)
    assert t["valid?"] is True and t["dedup"] == "pallas-hash"
    t, _ = _both("unordered_queue", jsynth.uqueue_history(120, seed=2))
    assert t["valid?"] is True and t["dedup"] == "xla-sort"
    assert t["analyzer"] == "gpu-wgl" and t["dedup-launches"] == 0


def test_forced_escalation_matches_jax():
    h = _reg(conc=5, seed=3, crash=0.05)
    t, _ = _both("cas_register", h, frontier=16, max_frontier=64,
                 slots=16, engine="sort")
    assert t["valid?"] == "unknown" and t["frontier-size"] == 64
    assert "overflowed at 64" in t["error"]
    t, _ = _both("cas_register", h, frontier=16, max_frontier=1024,
                 slots=16, engine="sort")
    assert t["valid?"] is True and t["frontier-size"] == 256


def test_budget_and_cancel_match_jax():
    h = _reg(conc=5, seed=3, crash=0.05)
    kw = dict(frontier=16, max_frontier=64, slots=16, engine="sort",
              chunk_entries=40)
    t, _ = _both("cas_register", h, budget_s=0.0, **kw)
    assert t["valid?"] == "unknown" and "budget" in t["error"]
    assert "at frontier 16" in t["error"]
    t = twgl.analysis_gpu(tmodels.cas_register(),
                          thistory.History(h.ops), device="cpu",
                          cancel=lambda: True, **kw)
    assert t["valid?"] == "unknown" and "cancelled" in t["error"]


def test_slot_overflow_goes_to_the_host_as_labelled():
    # past MAX_SLOTS (256) slots the device path hands over to the host
    h = _reg(n=60, seed=6)
    t = twgl.analysis_gpu(tmodels.cas_register(),
                          thistory.History(h.ops), device="cpu", slots=512)
    j = jwgl.analysis_tpu(jmodels.cas_register(), h, slots=512)
    assert t["analyzer"] == j["analyzer"] == \
        "host-jit-linear (slot overflow)"
    assert t["valid?"] is j["valid?"] is True
    t = twgl.analysis_gpu(tmodels.cas_register(),
                          thistory.History(h.ops), device="cpu", slots=512,
                          slot_overflow_fallback=False)
    assert t["valid?"] == "unknown" and "slot overflow" in t["error"]


def test_cpu_run_launches_no_kernel():
    before = wgl_dedup.LAUNCHES
    t = twgl.analysis_gpu(tmodels.cas_register(),
                          thistory.History(_reg(seed=5).ops), device="cpu",
                          **SORT_KW)
    assert t["valid?"] is True and t["dedup-launches"] > 0
    assert wgl_dedup.LAUNCHES == before


def test_synth_copies_make_the_same_histories():
    for name, kw in (("counter_history", dict(n_ops=300, crash_rate=0.05,
                                              seed=4)),
                     ("uqueue_history", dict(n_ops=300, seed=6))):
        assert getattr(tsynth, name)(**kw).ops == \
            getattr(jsynth, name)(**kw).ops
