"""The port's dense engine against the JAX package's dense kernel: carries
equal element for element after every chunk, carry and staged-buffer
digests equal bit for bit, and a search resumed across the two packages
in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import abft as jabft
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.carry import LAYOUT, carry_from_numpy, carry_to_numpy
from jepsen_tpu_torch.checker import abft as tabft
from jepsen_tpu_torch.checker import wgl as twgl


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the
    other test workers' threads, which slows these tests tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (n_ops, concurrency, crash_rate, seed, corrupt?) -> P in 4..12
CASES = [(120, 3, 0.03, 1, False), (150, 4, 0.03, 2, False),
         (160, 5, 0.04, 3, True), (200, 6, 0.03, 4, False),
         (180, 7, 0.02, 5, True), (150, 4, 0.05, 6, True)]


def _setup(n, conc, crash, seed, bad):
    h = jsynth.register_history(n, concurrency=conc, values=4,
                                crash_rate=crash, seed=seed)
    if bad:
        h = jsynth.corrupt(h, seed=seed)
        for o in h.ops:                 # keep the state range dense:
            if o["value"] == 10 ** 6:   # a phantom read one past the
                o["value"] = 4          # generator's values
    model = jmodels.cas_register()
    ops = jwgl.encode_ops_for_model(model, h)
    p = jwgl.required_slots(ops)
    dense = jwgl._dense_shape(jwgl._state_range("cas-register", model,
                                                [ops]), p)
    assert dense is not None and 4 <= p <= 12, (p, dense)
    steps = jwgl.build_steps(ops, p)
    E = jwgl._bucket(max(jwgl.event_count(ops), 1))
    jk = jwgl._dense_kernel_cached("cas-register", dense[0], dense[1],
                                   dense[2], E, False, False, True)
    tk = twgl.DenseKernel("cas-register", dense[0], dense[1], dense[2],
                          "cpu")
    xj = jnp.asarray(steps.pad_to(E).x)
    xs = twgl.stage_steps(steps.x, "cpu")
    init = model.device_state()
    assert init == tmodels.cas_register().device_state()
    return steps, jk, tk, xj, xs, init


def _assert_carry_equal(tc, jc, where):
    tn, jn = carry_to_numpy(tc), jax.device_get(jc)
    assert len(tn) == len(jn) == 9
    for i, (a, b) in enumerate(zip(tn, jn)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} elem {i}")


@pytest.mark.parametrize("case", CASES)
def test_carries_equal_after_every_chunk(case):
    steps, jk, tk, xj, xs, init = _setup(*case)
    chunk = max(steps.n // 4, 1)
    jc, tc = jk.init_carry(jnp.int32(init)), tk.init_carry(init)
    _assert_carry_equal(tc, jc, "init")
    stops = list(range(chunk, steps.n, chunk)) + [steps.n]
    assert len(stops) >= 3
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
    assert list(tk.summarize(tc)) == [bool(jsum[0])] + jsum[1:2] + \
        [bool(jsum[2])] + jsum[3:]


@pytest.mark.parametrize("case", CASES[1:4])
def test_cross_resume_both_ways(case):
    steps, jk, tk, xj, xs, init = _setup(*case)
    mid = steps.n // 2
    full = jk.check_chunk(xj, jnp.int32(steps.n), jk.init_carry(
        jnp.int32(init)))
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


def test_dead_carry_freezes_at_the_emptying_step():
    """After the table empties, e is death + 1 and further chunks leave
    the carry as it is — as the JAX while_loop does."""
    steps, jk, tk, xj, xs, init = _setup(160, 5, 0.04, 3, True)
    tc = tk.check_chunk(xs, steps.n, tk.init_carry(init))
    jc = jk.check_chunk(xj, jnp.int32(steps.n),
                        jk.init_carry(jnp.int32(init)))
    _assert_carry_equal(tc, jc, "dead")
    ok, death, *_ = tk.summarize(tc)
    assert not ok and int(tc[0]) == death + 1 < steps.n
    assert tk.check_chunk(xs, steps.n, tc) is tc


def test_carry_conversion_rejects_a_wrong_layout():
    steps, jk, tk, xj, xs, init = _setup(120, 3, 0.03, 1, False)
    good = carry_to_numpy(tk.init_carry(init))
    with pytest.raises(ValueError):
        carry_from_numpy(good[:8], "cpu")
    bad = list(good)
    bad[1] = bad[1].astype(np.int32)
    with pytest.raises(TypeError):
        carry_from_numpy(bad, "cpu")
    bad = list(good)
    bad[2] = bad[2][:-1]
    with pytest.raises(ValueError):
        carry_from_numpy(bad, "cpu")
    back = carry_from_numpy(good, "cpu")
    assert [t.dtype for t in back] == [d for _n, d, _r in LAYOUT]


@pytest.mark.parametrize("seed", range(3))
def test_staged_digest_matches_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(3000, 5),
                     dtype=np.int64).astype(np.int32)
    x[0, :] = [-1, 2 ** 31 - 1, -2 ** 31, 0, 7]
    want = jabft.digest_host(x)
    assert int(jabft.digest_device(jnp.asarray(x))) == want
    assert int(tabft.digest_device(torch.from_numpy(x))) == want
    assert tabft.digest_host(x) == want
    f = rng.standard_normal(257).astype(np.float32)
    assert int(tabft.digest_device(torch.from_numpy(f))) == \
        jabft.digest_host(f)


def test_mixing_primes_match_jax():
    assert [tabft.prime_i32(i) for i in range(20)] == \
        [jabft.prime_i32(i) for i in range(20)]


def test_verify_carry_catches_a_flipped_table_cell():
    steps, jk, tk, xj, xs, init = _setup(150, 4, 0.03, 2, False)
    tc = tk.check_chunk(xs, steps.n // 2, tk.init_carry(init))
    digest = int(tk.digest(tc))
    host = carry_to_numpy(tc)
    tabft.verify_carry("test", digest, host)
    flipped = list(host)
    flipped[1] = host[1].copy()
    flipped[1][0, 0] = ~flipped[1][0, 0]
    with pytest.raises(tabft.CorruptDeviceResult):
        tabft.verify_carry("test", digest, flipped)
