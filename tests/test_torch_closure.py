"""K1, the dense closure round: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and against an independent
numpy oracle, per round and at the fixpoint, and the wrapper's contract
on the CPU. The CUDA kernel itself is held against the plain version by
tests/test_torch_gpu.py and chip_smoke.py on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.checker import wgl_pallas
from jepsen_tpu_torch import _build
from jepsen_tpu_torch.checker import wgl_closure
from jepsen_tpu_torch.checker.wgl_closure import (closure_round,
                                                  closure_round_plain)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the
    other test workers' threads, which slows these tests tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle_round(tb, mft):
    """Independent numpy oracle: the XOR-gather formulation, looping
    over slots and source states with no matrix product."""
    P, S, _ = mft.shape
    C = tb.shape[1]
    cols = np.arange(C)
    out = tb.copy()
    for p in range(P):
        src = cols ^ (1 << p)
        has = ((cols >> p) & 1).astype(bool)
        for q in range(S):
            for s in np.nonzero(mft[p, q])[0]:
                out[q] |= tb[s, src] & has
    return out


def _inputs(S, P, seed, density=0.1):
    rng = np.random.default_rng(seed)
    tb = rng.random((S, 1 << P)) < density
    mft = (rng.random((P, S, S)) < 0.15).astype(np.uint8)
    return tb, mft


def _rounds(fn, tb, mft, limit=64):
    """Tables after each round, up to and including the fixpoint."""
    out = [tb]
    for _ in range(limit):
        nxt = fn(out[-1], mft)
        out.append(nxt)
        if (nxt == out[-2]).all():
            return out
    raise AssertionError("no fixpoint")


def _plain_np(tb, mft):
    return closure_round_plain(torch.from_numpy(tb),
                               torch.from_numpy(mft)).numpy()


def _pallas_np(S, P):
    fn = wgl_pallas.closure_round_fn(S, P, interpret=True)

    def run(tb, mft):
        got = fn(jnp.asarray(tb, jnp.float32),
                 jnp.asarray(mft, jnp.float32))
        return np.asarray(got) > 0
    return run


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("S,P", [(16, 7), (8, 9)])
def test_plain_round_matches_pallas_interpret_every_round(S, P, seed):
    assert wgl_pallas.eligible(S, P)
    tb, mft = _inputs(S, P, seed, density=0.02)
    want = _rounds(_pallas_np(S, P), tb, mft)
    got = _rounds(_plain_np, tb, mft)
    assert len(got) == len(want) >= 3
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"round {r}")


@pytest.mark.parametrize("S,P", [(30, 8), (8, 4), (4, 1), (12, 5),
                                 (64, 6)])
def test_plain_round_matches_oracle_where_the_tpu_gate_refuses(S, P):
    assert not wgl_pallas.eligible(S, P)
    tb, mft = _inputs(S, P, seed=S * 31 + P, density=0.05)
    want = _rounds(_oracle_round, tb, mft)
    got = _rounds(_plain_np, tb, mft)
    assert len(got) == len(want)
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"round {r}")


def test_plain_round_keeps_dtype_and_is_jacobi():
    """Reads tb, writes a new tensor: a move found this round does not
    feed another move in the same round."""
    S, P = 2, 2
    tb = np.zeros((S, 4), bool)
    tb[0, 0] = True
    mft = np.zeros((P, S, S), np.uint8)
    mft[0, 1, 0] = 1      # slot 0: state 0 -> 1
    mft[1, 0, 1] = 1      # slot 1: state 1 -> 0
    t = torch.from_numpy(tb)
    one = closure_round_plain(t, torch.from_numpy(mft))
    assert one.dtype == torch.bool and not t[1, 1]
    assert one.numpy().sum() == 2 and one[1, 1]     # only slot 0 moved
    two = closure_round_plain(one, torch.from_numpy(mft))
    assert two[0, 3] and two.numpy().sum() == 3
    u8 = closure_round_plain(t.to(torch.uint8), torch.from_numpy(mft))
    assert u8.dtype == torch.uint8
    np.testing.assert_array_equal(u8.numpy().astype(bool), one.numpy())


def test_wrapper_uses_the_plain_version_on_cpu_tensors():
    tb, mft = _inputs(8, 7, seed=5)
    before = wgl_closure.LAUNCHES
    got = closure_round(torch.from_numpy(tb), torch.from_numpy(mft))
    assert wgl_closure.LAUNCHES == before     # no kernel launched
    np.testing.assert_array_equal(got.numpy(), _plain_np(tb, mft))


def test_wrapper_raises_off_cpu_and_cuda_instead_of_falling_back():
    table = torch.zeros((8, 128), dtype=torch.bool, device="meta")
    mft = torch.zeros((7, 8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        closure_round(table, mft)
    with pytest.raises(ValueError, match="CUDA"):
        closure_round(torch.zeros((8, 128), dtype=torch.bool), mft)


def test_build_command_targets_hopper_with_a_plain_c_interface():
    cmd = _build.command("closure_round", _build.lib_path("closure_round"))
    assert cmd[cmd.index("-gencode") + 1] == \
        "arch=compute_90a,code=sm_90a"
    for flag in ("-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[-1].endswith("csrc/closure_round.cu")
    assert "closure_round" in _build.sources()
    assert _build.lib_path("x").parent.name == "build"
    src = (_build.CSRC / "closure_round.cu").read_text()
    assert 'extern "C" int jt_closure_round' in src
    assert "cudaGetLastError" in src
