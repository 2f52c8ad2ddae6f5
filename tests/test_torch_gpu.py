"""Card-only tests of the PyTorch port: the CUDA kernel against its plain
version, and the dense engine on CUDA against the same engine on the
CPU. Each skips inside the test when no CUDA device is present.

This file imports nothing of JAX, so it also runs on a machine with the
card and no JAX installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import models
from jepsen_tpu_torch.carry import carry_from_numpy, carry_to_numpy
from jepsen_tpu_torch.checker import synth, wgl, wgl_closure
from jepsen_tpu_torch.checker.wgl_closure import (closure_round,
                                                  closure_round_plain)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("S,P", [(8, 7), (8, 14), (16, 7), (30, 8),
                                 (4, 1), (256, 10)])
def test_cuda_kernel_matches_plain_bit_exact(S, P):
    _need_cuda()
    rng = np.random.default_rng(P)
    t = torch.from_numpy(rng.random((S, 1 << P)) < 0.05).cuda()
    m = torch.from_numpy((rng.random((P, S, S)) < 0.15).astype(
        np.uint8)).cuda()
    before = wgl_closure.LAUNCHES
    for _ in range(4):
        got = closure_round(t, m)
        want = closure_round_plain(t, m)
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and torch.equal(got, want)
        t = got
    assert wgl_closure.LAUNCHES == before + 4
    u8 = closure_round(t.to(torch.uint8), m)
    assert u8.dtype == torch.uint8
    assert torch.equal(u8.bool(), closure_round_plain(t, m))


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take():
    _need_cuda()
    t = torch.zeros((8, 128), dtype=torch.bool, device="cuda")
    m = torch.zeros((7, 8, 8), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        closure_round(t, m.float())                  # dtype
    with pytest.raises(ValueError):
        closure_round(t[:, :64], m)                  # C != 2^P
    with pytest.raises(ValueError):
        closure_round(t, m.cpu())                    # mixed devices
    with pytest.raises(ValueError):
        closure_round(t.t().contiguous().t(), m)     # not contiguous


@pytest.mark.gpu
def test_cuda_analysis_matches_cpu():
    _need_cuda()
    h = synth.register_history(600, concurrency=5, crash_rate=0.01,
                               seed=16)
    for hist in (h, synth.corrupt(h, seed=16, value=5)):
        before = wgl_closure.LAUNCHES
        g = wgl.analysis_gpu(models.cas_register(), hist,
                             chunk_entries=200)
        assert wgl_closure.LAUNCHES - before == g["closure-rounds"] > 0
        c = wgl.analysis_gpu(models.cas_register(), hist, device="cpu",
                             chunk_entries=200)
        assert g["device"] == "cuda"
        for key in ("valid?", "op-index", "max-frontier", "op-count",
                    "closure-rounds", "host-syncs", "final-paths"):
            assert g.get(key) == c.get(key), key


@pytest.mark.gpu
def test_cuda_carry_resumes_a_cpu_carry():
    _need_cuda()
    m = models.cas_register()
    h = synth.adversarial_register_history(400, concurrency=4,
                                           crashed_writes=4, seed=2)
    ops, dec = wgl.plan_dense(m, h)
    s_lo, S, P = dec.dense
    steps = wgl.build_steps(ops, P)
    kc = wgl.DenseKernel(m.device_model, s_lo, S, P, "cpu")
    kg = wgl.DenseKernel(m.device_model, s_lo, S, P, "cuda")
    xc = wgl.stage_steps(steps.x, "cpu")
    xg = wgl.stage_steps(steps.x, "cuda")
    mid = steps.n // 2
    half = carry_to_numpy(kc.check_chunk(xc, mid, kc.init_carry(
        m.device_state())))
    resumed = kg.check_chunk(xg, steps.n, carry_from_numpy(half, "cuda"))
    full = kc.check_chunk(xc, steps.n, kc.init_carry(m.device_state()))
    for a, b in zip(carry_to_numpy(resumed), carry_to_numpy(full)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert int(kg.digest(resumed)) == int(kc.digest(full))
