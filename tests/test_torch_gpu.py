"""Card-only tests of the PyTorch port: the CUDA kernels (K1, K2), scalar
and batched, against their plain versions, and both engine families and
the batch entry on CUDA against the same engines on the CPU. Each skips
inside the test when no CUDA device is present.

This file imports nothing of JAX, so it also runs on a machine with the
card and no JAX installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import models
from jepsen_tpu_torch.carry import carry_from_numpy, carry_to_numpy
from jepsen_tpu_torch.checker import synth, wgl, wgl_closure, wgl_dedup
from jepsen_tpu_torch.checker.wgl_closure import (closure_round,
                                                  closure_round_plain)
from jepsen_tpu_torch.checker.wgl_dedup import dedup, dedup_plain


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("S,P", [(8, 7), (8, 14), (16, 7), (30, 8),
                                 (4, 1), (256, 10), (3, 0), (5, 2), (8, 3),
                                 (8, 4), (30, 5), (8, 19)])
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
    pl = wgl.plan(m, h, engine="dense")
    s_lo, S, P = pl.decision.dense
    steps = wgl.build_steps(pl.ops, P)
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


@pytest.mark.gpu
@pytest.mark.parametrize("N,F", [(512, 256), (4352, 256), (77, 16),
                                 (64, 64), (17408, 1024), (8192, 256),
                                 (8193, 256)])
def test_dedup_kernel_matches_plain_bit_exact(N, F):
    _need_cuda()
    rng = np.random.default_rng(N + F)
    cases = [rng.integers(0, N // 3 + 1, N), np.full(N, -1),
             rng.permutation(N), rng.integers(0, 2 ** 31 - 1, N)]
    cases[0][rng.random(N) < 0.4] = -1
    before = wgl_dedup.LAUNCHES
    for k in cases:
        keys = torch.from_numpy(k.astype(np.int32)).cuda()
        got = dedup(keys, F)
        want = dedup_plain(keys, F)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert wgl_dedup.LAUNCHES == before + len(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("N,launches", [(1, 1), (4352, 1), (8192, 1),
                                        (8193, 5), (17408, 5)])
def test_dedup_cuda_launches_per_call(N, launches):
    """The single-block path (N <= 8,192) is one CUDA launch per call,
    the large path five."""
    _need_cuda()
    assert wgl_dedup.path(N) == ("single-block" if launches == 1
                                 else "five-launch")
    keys = torch.from_numpy(np.random.default_rng(N).integers(
        -1, N, N).astype(np.int32)).cuda()
    dedup(keys, 256)                     # builds and loads the library
    before = wgl_dedup.cuda_launches()
    for _ in range(3):
        dedup(keys, 256)
    torch.cuda.synchronize()
    assert wgl_dedup.cuda_launches() - before == 3 * launches


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 2048, 8192])
def test_dedup_both_routes_match_plain(N):
    """Where both routes take N, each is bit-exact on all four outputs;
    the single-block route refuses more than its cap."""
    _need_cuda()
    rng = np.random.default_rng(N)
    keys = torch.from_numpy(rng.integers(-1, 4 * N, N).astype(np.int32))
    want = dedup_plain(keys, 1024)
    for route in ("single-block", "five-launch"):
        got = wgl_dedup.launch(keys.cuda(), 1024, route)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    big = torch.zeros(wgl_dedup.SINGLE_BLOCK_MAX_N + 1, dtype=torch.int32,
                      device="cuda")
    with pytest.raises(ValueError):
        wgl_dedup.launch(big, 256, "single-block")


@pytest.mark.gpu
def test_dedup_wrapper_raises_on_what_the_kernel_does_not_take():
    _need_cuda()
    keys = torch.zeros(64, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        dedup(keys.long(), 8)                         # dtype
    with pytest.raises(ValueError):
        dedup(keys.view(2, 4, 8), 8)                  # rank (2-d: batch)
    with pytest.raises(ValueError):
        dedup(keys[::2], 8)                           # not contiguous
    with pytest.raises(ValueError):
        dedup(keys, 0)                                # no frontier


@pytest.mark.gpu
def test_cuda_sort_family_matches_cpu():
    _need_cuda()
    reg = synth.register_history(600, concurrency=4, crash_rate=0.0,
                                 seed=17)
    wide = synth.register_history(600, concurrency=5, crash_rate=0.01,
                                  seed=17)
    cases = [  # (model, history, engine, the dedup route it takes)
        (models.cas_register(), synth.corrupt(reg), "auto", "pallas-hash"),
        (models.counter(), synth.counter_history(400, seed=3), "sort",
         "pallas-hash"),
        (models.cas_register(), synth.corrupt(wide), "auto", "xla-sort")]
    for model, hist, eng, route in cases:
        before = wgl_dedup.LAUNCHES
        g = wgl.analysis_gpu(model, hist, chunk_entries=200, engine=eng)
        assert g["analyzer"] == "gpu-wgl" and g["dedup"] == route
        assert wgl_dedup.LAUNCHES - before == g["dedup-launches"]
        assert (g["dedup-launches"] > 0) == (route == "pallas-hash")
        cpu = wgl.analysis_gpu(model, hist, device="cpu", chunk_entries=200,
                               engine=eng)
        for key in ("valid?", "op-index", "max-frontier", "frontier-size",
                    "closure-rounds", "dedup-launches", "host-syncs",
                    "final-paths"):
            assert g.get(key) == cpu.get(key), key


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,P", [(4, 3, 0), (4, 4, 1), (4, 5, 2),
                                   (4, 8, 3), (32, 8, 4), (64, 8, 6),
                                   (16, 8, 8), (4, 8, 10), (4, 8, 19)])
def test_batched_closure_round_matches_plain_and_each_row(B, S, P):
    """One launch for B tables; row b equals the unbatched round on
    table b, and the plain version's batched round."""
    _need_cuda()
    rng = np.random.default_rng(B * 100 + P)
    t = torch.from_numpy(rng.random((B, S, 1 << P)) < 0.05).cuda()
    m = torch.from_numpy((rng.random((B, P, S, S)) < 0.15).astype(
        np.uint8)).cuda()
    for _ in range(3):
        before = wgl_closure.LAUNCHES
        got = closure_round(t, m)
        assert wgl_closure.LAUNCHES == before + 1
        want = closure_round_plain(t, m)
        torch.cuda.synchronize()
        assert got.shape == t.shape and torch.equal(got, want)
        for b in (0, B - 1):
            assert torch.equal(got[b], closure_round(t[b], m[b]))
        t = got
    with pytest.raises(ValueError):
        closure_round(t, m[0])                        # unbatched mft
    with pytest.raises(ValueError):
        closure_round(t, m[:B - 1].contiguous() if B > 1 else m[:0])


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,F", [(32, 2048, 1024), (32, 17408, 1024),
                                   (3, 77, 16), (4, 8192, 256),
                                   (4, 8193, 256)])
def test_batched_dedup_matches_plain_and_each_row(B, N, F):
    """One (single-block) or five (large route) CUDA launches for B rows;
    all four outputs of row b equal the unbatched call on row b and the
    plain version's batched call; edge rows: all EMPTY, all distinct,
    heavy duplicates."""
    _need_cuda()
    rng = np.random.default_rng(B + N)
    k = rng.integers(0, N // 3 + 1, (B, N))
    k[rng.random((B, N)) < 0.4] = -1
    k[0] = -1
    k[1] = rng.permutation(N)
    k[-1] = rng.choice([0, 7, 2 ** 31 - 1], N)
    keys = torch.from_numpy(k.astype(np.int32)).cuda()
    dedup(keys, F)
    torch.cuda.synchronize()
    before = wgl_dedup.cuda_launches()
    got = dedup(keys, F)
    torch.cuda.synchronize()
    assert wgl_dedup.cuda_launches() - before == (
        1 if N <= wgl_dedup.SINGLE_BLOCK_MAX_N else 5)
    want = dedup_plain(keys, F)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    for b in range(B):
        for a, o in zip(got, dedup(keys[b].contiguous(), F)):
            assert torch.equal(a[b], o)
    if N <= wgl_dedup.SINGLE_BLOCK_MAX_N:
        for a, b in zip(wgl_dedup.launch(keys, F, "five-launch"), want):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_batch_matches_cpu_on_both_families():
    _need_cuda()
    reg = models.cas_register()
    dense = [synth.register_history(200, concurrency=c, values=5,
                                    crash_rate=0.005, seed=30 + i)
             for i, c in enumerate((2, 3, 4, 4, 5, 3))]
    dense[2] = synth.corrupt(dense[2], value=5)
    cnt = [synth.counter_history(200, seed=40 + i) for i in range(5)]
    cnt[3] = synth.corrupt(cnt[3], value=999)   # S past the dense cap
    for model, hs, kw, k1, k2 in [(reg, dense, {}, True, False),
                                  (models.counter(), cnt, {"slots": 16},
                                   False, True)]:
        b1, b2 = wgl_closure.LAUNCHES, wgl_dedup.LAUNCHES
        g = wgl.analysis_gpu_batch(model, hs, **kw)
        assert (wgl_closure.LAUNCHES > b1) == k1
        assert (wgl_dedup.LAUNCHES > b2) == k2
        c = wgl.analysis_gpu_batch(model, hs, device="cpu", **kw)
        assert any(r["valid?"] is False for r in g)
        for a, b in zip(g, c):
            assert a["device"] == "cuda" and b["device"] == "cpu"
            for key in ("valid?", "op-index", "max-frontier", "dedup",
                        "analyzer", "batch-walk"):
                assert a.get(key) == b.get(key), key
