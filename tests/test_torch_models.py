"""The port's device-model step functions against the JAX package's jnp
steps, over exhaustive (state, f, a, b) grids. Exact: both sides are
int32/bool."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu_torch.checker import wgl as twgl


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the
    other test workers' threads, which slows these tests tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_UQ_STATES = [0, 1, 15, 16, 0x1F, 0xF0, 0xFF, 15 << 24, (1 << 28) - 1,
              0x0123456]

GRIDS = {
    "cas-register": (range(-1, 6), range(0, 4), range(-1, 6),
                     range(-1, 6)),
    "register": (range(-1, 6), range(0, 4), range(-1, 6), range(-1, 6)),
    "mutex": (range(-1, 3), range(0, 3), range(-1, 2), range(-1, 2)),
    "counter": (range(-4, 5), range(0, 3), range(-4, 5), range(-1, 2)),
    "g-set": (list(range(0, 17)) + [1 << 30, (1 << 31) - 1],
              range(0, 3), list(range(-1, 9)) + [30, 31, 40],
              range(-1, 1)),
    "unordered-queue": (_UQ_STATES, range(0, 3), range(-2, 9),
                        range(-1, 1)),
}


def _grid(name):
    cols = list(zip(*itertools.product(*GRIDS[name])))
    return [np.asarray(c, np.int32) for c in cols]


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_step_matches_jax_on_exhaustive_grid(name):
    state, f, a, b = _grid(name)
    jl, jn = jwgl.DEVICE_MODELS[name].step(
        jnp.asarray(state), jnp.asarray(f), jnp.asarray(a), jnp.asarray(b))
    tl, tn = twgl.DEVICE_MODELS[name].step(
        torch.from_numpy(state), torch.from_numpy(f), torch.from_numpy(a),
        torch.from_numpy(b))
    assert tl.dtype == torch.bool and tn.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_step_broadcasts_like_the_dense_closure_call(name):
    """The dense engine calls step(S_VALS[None, :], f[:, None], ...):
    (1, S) states against (P, 1) slot arguments give (P, S) outputs."""
    states = np.asarray(sorted(set(GRIDS[name][0]))[:8], np.int32)
    rng = np.random.default_rng(3)
    f, a, b = (rng.choice(np.asarray(list(g), np.int32), 5)
               for g in GRIDS[name][1:])
    jl, jn = jwgl.DEVICE_MODELS[name].step(
        jnp.asarray(states)[None, :], jnp.asarray(f)[:, None],
        jnp.asarray(a)[:, None], jnp.asarray(b)[:, None])
    tl, tn = twgl.DEVICE_MODELS[name].step(
        torch.from_numpy(states)[None, :], torch.from_numpy(f)[:, None],
        torch.from_numpy(a)[:, None], torch.from_numpy(b)[:, None])
    assert tuple(tl.shape) == tuple(tn.shape) == (5, len(states))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_codecs_and_ranges_match_jax():
    ops = [{"f": "acquire", "value": None}, {"f": "release", "value": None}]
    for o in ops:
        assert twgl.mutex_codec(o) == jwgl.mutex_codec(o)
    for o in ({"f": "read", "value": None}, {"f": "read", "value": -1},
              {"f": "add", "value": 3}):
        assert twgl.counter_codec(o) == jwgl.counter_codec(o)
    for o in ({"f": "add", "value": 4}, {"f": "read", "value": [1, 4]},
              {"f": "read", "value": None}):
        assert twgl.gset_codec(o) == jwgl.gset_codec(o)
    for o in ({"f": "enqueue", "value": 2}, {"f": "dequeue", "value": 6}):
        assert twgl.uqueue_codec(o) == jwgl.uqueue_codec(o)
    rng = np.random.default_rng(0)
    f = rng.integers(0, 3, 50).astype(np.int32)
    a = rng.integers(-1, 20, 50).astype(np.int32)
    b = rng.integers(-1, 2, 50).astype(np.int32)
    for name in GRIDS:
        assert twgl.DEVICE_MODELS[name].state_range(0, f, a, b) == \
            jwgl.DEVICE_MODELS[name].state_range(0, f, a, b), name
