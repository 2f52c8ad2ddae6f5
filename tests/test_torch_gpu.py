"""Card-only tests of the PyTorch port: the CUDA kernels (K1, K2), scalar
and batched, against their plain versions, the dense and sort step walks
(K3, K3-sort) against the eager walk, both engine families and the
batch entry on CUDA against the same engines on the CPU, the Elle
classifier on CUDA against its CPU path, and the online streams, the
tiered check and the competition race on CUDA against the CPU path.
Each skips inside the test when no CUDA device is present.

This file imports nothing of JAX, so it also runs on a machine with the
card and no JAX installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import time

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import _platform, models
from jepsen_tpu_torch.carry import carry_from_numpy, carry_to_numpy
from jepsen_tpu_torch.checker import (linear, screen, streaming, synth,
                                      wgl, wgl_closure, wgl_dedup,
                                      wgl_sortwalk, wgl_walk)
from jepsen_tpu_torch.checker.elle import k4
from jepsen_tpu_torch.checker.elle import kernels as elle_kernels
from jepsen_tpu_torch.checker.elle import list_append as elle_append
from jepsen_tpu_torch.checker.wgl_closure import (closure_round,
                                                  closure_round_plain)
from jepsen_tpu_torch.checker.wgl_dedup import dedup, dedup_plain


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


class _WalkSyncs:
    """The host syncs the walks of one family make, by engine shape (s_lo,
    S, P) for the dense family, ("sort", F, P) for the sort family: on
    the card the kernel's walks (`DenseKernel._walk_k3`,
    `SortKernel._walk_k3s`, with their calls and launches), on the CPU
    the eager walks."""

    def __init__(self, monkeypatch, card: bool, sort: bool = False):
        self.syncs, self.calls, self.launches = {}, {}, {}
        cls = wgl.SortKernel if sort else wgl.DenseKernel
        self.mod = wgl_sortwalk if sort else wgl_walk
        for name in ((("_walk_k3s" if sort else "_walk_k3"),) if card else
                     ("run_range_eager", "run_range_batch_eager")):
            monkeypatch.setattr(cls, name, self._spy(getattr(cls, name)))

    def _spy(self, real):
        def counted(k, *a):
            s0, l0 = k.syncs, self.mod.LAUNCHES
            out = real(k, *a)
            key = (("sort", k.F, k.P) if isinstance(k, wgl.SortKernel)
                   else (k.s_lo, k.S, k.P))
            for d, v in ((self.syncs, k.syncs - s0), (self.calls, 1),
                         (self.launches, self.mod.LAUNCHES - l0)):
                d[key] = d.get(key, 0) + v
            return out
        return counted

    def total(self, d=None) -> int:
        return sum((self.syncs if d is None else d).values())

    def hold_k3(self):
        """Each kernel walk reads the host once to start and once a
        window."""
        assert self.syncs and all(
            self.syncs[g] == self.calls[g] + self.launches[g]
            for g in self.syncs), (self.syncs, self.calls, self.launches)


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
def test_cuda_analysis_matches_cpu(monkeypatch):
    _need_cuda()
    h = synth.register_history(600, concurrency=5, crash_rate=0.01,
                               seed=16)
    for hist in (h, synth.corrupt(h, seed=16, value=5)):
        before = wgl_walk.ROUNDS, wgl_closure.LAUNCHES
        gw = _WalkSyncs(monkeypatch, card=True)
        g = wgl.analysis_gpu(models.cas_register(), hist,
                             chunk_entries=200)
        gw.hold_k3()
        cw = _WalkSyncs(monkeypatch, card=False)
        # the walk is K3's: its rounds are the result's, K1 runs inside it
        assert wgl_walk.ROUNDS - before[0] == g["closure-rounds"] > 0
        assert wgl_closure.LAUNCHES == before[1]
        c = wgl.analysis_gpu(models.cas_register(), hist, device="cpu",
                             chunk_entries=200)
        assert g["device"] == "cuda"
        for key in ("valid?", "op-index", "max-frontier", "op-count",
                    "closure-rounds", "final-paths"):
            assert g.get(key) == c.get(key), key
        # K3 reads the host once a window, the eager walk every round;
        # every other read is the same on both
        assert g["host-syncs"] - gw.total() == c["host-syncs"] - cw.total()
        assert g["host-syncs"] < c["host-syncs"]


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
def test_cuda_sort_family_matches_cpu(monkeypatch):
    """The sort family on the card walks K3-sort on every route, with K2
    at 0, and gives the CPU path's result: its counts the eager walk's,
    its host reads one a launch where the eager walk read a round."""
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
        k2, k3s, d3s = (wgl_dedup.LAUNCHES, wgl_sortwalk.LAUNCHES,
                        wgl_sortwalk.DEDUPS)
        gw = _WalkSyncs(monkeypatch, card=True, sort=True)
        g = wgl.analysis_gpu(model, hist, chunk_entries=200, engine=eng)
        assert g["analyzer"] == "gpu-wgl" and g["dedup"] == route
        assert wgl_dedup.LAUNCHES == k2 and wgl_sortwalk.LAUNCHES > k3s
        assert wgl_sortwalk.DEDUPS - d3s == g["dedup-launches"]
        assert (g["dedup-launches"] > 0) == (route == "pallas-hash")
        gw.hold_k3()
        cw = _WalkSyncs(monkeypatch, card=False, sort=True)
        cpu = wgl.analysis_gpu(model, hist, device="cpu", chunk_entries=200,
                               engine=eng)
        for key in ("valid?", "op-index", "max-frontier", "frontier-size",
                    "closure-rounds", "dedup-launches", "final-paths"):
            assert g.get(key) == cpu.get(key), key
        assert g["host-syncs"] - gw.total() == cpu["host-syncs"] - cw.total()
        assert g["host-syncs"] < cpu["host-syncs"]


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
def test_cuda_batch_matches_cpu_on_both_families(monkeypatch):
    _need_cuda()
    reg = models.cas_register()
    dense = [synth.register_history(200, concurrency=c, values=5,
                                    crash_rate=0.005, seed=30 + i)
             for i, c in enumerate((2, 3, 4, 4, 5, 3))]
    dense[2] = synth.corrupt(dense[2], value=5)
    cnt = [synth.counter_history(200, seed=40 + i) for i in range(5)]
    cnt[3] = synth.corrupt(cnt[3], value=999)   # S past the dense cap
    for model, hs, kw, sort in [(reg, dense, {}, False),
                                (models.counter(), cnt, {"slots": 16}, True)]:
        b1, b2, b3 = (wgl_walk.LAUNCHES, wgl_dedup.LAUNCHES,
                      wgl_sortwalk.LAUNCHES)
        gw = _WalkSyncs(monkeypatch, card=True, sort=sort)
        g = wgl.analysis_gpu_batch(model, hs, **kw)
        assert (wgl_walk.LAUNCHES > b1) == (not sort)
        assert (wgl_sortwalk.LAUNCHES > b3) == sort
        assert wgl_dedup.LAUNCHES == b2
        gw.hold_k3()
        cw = _WalkSyncs(monkeypatch, card=False, sort=sort)
        c = wgl.analysis_gpu_batch(model, hs, device="cpu", **kw)
        assert any(r["valid?"] is False for r in g)
        for a, b in zip(g, c):
            assert a["device"] == "cuda" and b["device"] == "cpu"
            for key in ("valid?", "op-index", "max-frontier", "dedup",
                        "analyzer"):
                assert a.get(key) == b.get(key), key
            # the kernel reads the host once a window: the walks' host
            # syncs are its own, every other read and count the CPU
            # path's
            wa, wb = dict(a["batch-walk"]), dict(b["batch-walk"])
            shape = tuple(wa["group"]) if sort else tuple(wa["group"][1:])
            ga, gb = wa.pop("host-syncs"), wb.pop("host-syncs")
            assert ga - gw.syncs[shape] == gb - cw.syncs[shape]
            assert ga < gb
            assert wa == wb


def _elle_bucket(e, b, rng, density=0.4):
    """(ww, wr, rw) float32 0/1 stacks, each entry set with probability
    density / e, no self-loops."""
    mats = []
    for _ in range(3):
        m = (rng.random((b, e, e)) < density / e).astype(np.float32)
        m[:, np.arange(e), np.arange(e)] = 0.0
        mats.append(m)
    return tuple(mats)


@pytest.mark.gpu
@pytest.mark.parametrize("e,b", [(8, 64), (64, 16), (256, 8), (1024, 2)])
def test_cuda_elle_classifier_matches_cpu(e, b):
    _need_cuda()
    buckets = {e: _elle_bucket(e, b, np.random.default_rng(e))}
    before = elle_kernels.LAUNCHES
    got = elle_kernels._classify_batches(buckets, device="cuda")
    assert elle_kernels.LAUNCHES == before + 1      # no retry
    want = elle_kernels._classify_batches(buckets, device="cpu")
    for g, w in zip(got[e], want[e]):
        assert g.dtype == np.bool_ and np.array_equal(g, w)
    *flags, res = elle_kernels._flags_batch(
        *(torch.from_numpy(x).cuda() for x in buckets[e]),
        elle_kernels._steps(e))
    assert res.cpu().tolist() == [0] * b
    for f, w in zip(flags, want[e]):
        assert np.array_equal(f.cpu().numpy(), w)


@pytest.mark.gpu
def test_cuda_elle_residue_stays_zero_at_4096_under_tf32():
    """The caller's TF32 setting changes neither the flags nor the
    residue: every product has 0/1 operands. One 4,096-node block: a
    ring with one rw edge and random chords."""
    _need_cuda()
    e, rng = 4096, np.random.default_rng(4096)
    ww, wr, rw = _elle_bucket(e, 1, rng, density=0.2)
    ring = np.arange(e)
    ww[0, ring, (ring + 1) % e] = 1.0
    ww[0, 17, 18], rw[0, 17, 18] = 0.0, 1.0
    args = [torch.from_numpy(x).cuda() for x in (ww, wr, rw)]
    steps = elle_kernels._steps(e)
    old = torch.get_float32_matmul_precision()
    try:
        runs = {}
        for prec in ("highest", "high"):
            torch.set_float32_matmul_precision(prec)
            *flags, res = elle_kernels._flags_batch(*args, steps)
            runs[prec] = ([f.cpu().tolist() for f in flags],
                          res.cpu().tolist())
    finally:
        torch.set_float32_matmul_precision(old)
    assert runs["high"] == runs["highest"]
    assert runs["high"][1] == [0]
    assert runs["high"][0][2] == [True]                 # G-single


@pytest.mark.gpu
def test_cuda_list_append_check_matches_cpu():
    _need_cuda()
    h = synth.inject_append_cycles(synth.append_history(2000, seed=5), 12,
                                   "G1c")
    h = synth.inject_append_cycles(h, 5, "G-single", seed=11,
                                   key_base=2 * 10 ** 9)
    for graphs in ((), ("realtime", "process")):
        before = elle_kernels.LAUNCHES
        g = elle_append.check(h, additional_graphs=graphs)
        assert elle_kernels.LAUNCHES > before
        c = elle_append.check(h, additional_graphs=graphs, device="cpu")
        assert g == c and g["valid?"] is False
        assert {"G1c", "G-single"} <= set(g["anomaly-types"])


_STREAM_VOLATILE = ("duration-ms", "tail-latency-ms", "device",
                    "host-syncs")


def _stream_both(hist, **kw):
    """The same stream on CUDA and on the CPU: (cuda result, cpu result,
    the CUDA stream, (K3's closure rounds, K3-sort's hash dedups, K2
    launches)) — the counts of the CUDA run only."""
    k1, k2, k3s = wgl_walk.ROUNDS, wgl_dedup.LAUNCHES, wgl_sortwalk.DEDUPS
    s = streaming.WglStream(models.cas_register(), **kw)
    for op in hist.ops:
        s.feed(op)
    g = s.finish()
    torch.cuda.synchronize()
    launches = (wgl_walk.ROUNDS - k1, wgl_sortwalk.DEDUPS - k3s,
                wgl_dedup.LAUNCHES - k2)
    c = streaming.stream_check(models.cas_register(), hist, device="cpu",
                               **kw)
    return g, c, s, launches


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["dense", "sort"])
def test_cuda_stream_matches_cpu_and_launches_its_kernel(engine):
    _need_cuda()
    h = synth.register_history(800, concurrency=5, crash_rate=0.005,
                               seed=21)
    for hist in (h, synth.corrupt(h, seed=21, value=4)):
        g, c, s, (k1, d3s, k2) = _stream_both(
            hist, engine=engine, state_range=(-1, 4), chunk_entries=128,
            checkpoint_every=2)
        assert g["device"].startswith("cuda")
        for key in set(g) | set(c):
            if key not in _STREAM_VOLATILE:
                assert g.get(key) == c.get(key), key
        assert k2 == 0
        if engine == "dense":
            assert k1 == g["closure-rounds"] > 0 and d3s == 0
        else:
            assert g["dedup"] == "pallas-hash"
            assert d3s == g["dedup-launches"] > 0 and k1 == 0


@pytest.mark.gpu
def test_cuda_stream_recovers_an_injected_device_loss(monkeypatch):
    _need_cuda()
    monkeypatch.setattr(_platform, "fault_hook", None)
    _platform.reset_fault_injection()
    monkeypatch.setenv("JEPSEN_TPU_FAULT_INJECT",
                       "device-lost@stream-chunk:3")
    h = synth.register_history(800, concurrency=5, crash_rate=0.0,
                               seed=22)
    g = streaming.stream_check(models.cas_register(), h, engine="dense",
                               state_range=(-1, 4), chunk_entries=128,
                               checkpoint_every=2)
    _platform.reset_fault_injection()
    monkeypatch.delenv("JEPSEN_TPU_FAULT_INJECT")
    c = streaming.stream_check(models.cas_register(), h, engine="dense",
                               state_range=(-1, 4), chunk_entries=128,
                               checkpoint_every=2, device="cpu")
    assert g["recovered"]["faults"] == ["device-lost"]
    assert g["valid?"] is c["valid?"] is True
    assert g["chunks"] == c["chunks"]


@pytest.mark.gpu
def test_cuda_tier_and_race_match_cpu():
    _need_cuda()
    # crashed writes at the generator's default rate (pending for the
    # rest of the history)
    h = synth.register_history(300, concurrency=4, seed=5)
    bad = synth.corrupt(h, seed=5)
    assert any(o["type"] == "info" for o in h.ops)
    for hist in (h, bad):
        for sample in (0, 1):
            test = {"tier": "screen", "screen-sample": sample}
            g = linear.linearizable(models.cas_register()).check(
                test, hist, {})
            c = linear.linearizable(models.cas_register(),
                                    device="cpu").check(test, hist, {})
            for key in ("valid?", "tier", "escalated", "op-index",
                        "screened", "suspicion"):
                assert g.get(key) == c.get(key), key
    assert screen.screen_history(models.cas_register(), bad)["valid?"] \
        is False
    # the race returns its winner's result at the winner's pace, and its
    # loser stops once the verdict is in; the third history's sort walk
    # is long, its host search about a second
    for hist in (h, bad, synth.register_history(400, concurrency=5,
                                                seed=23)):
        t0 = time.perf_counter()
        g = linear.linearizable(models.cas_register(),
                                algorithm="competition").check({}, hist, {})
        race_s = time.perf_counter() - t0
        host = linear.analysis_host(models.cas_register(), hist)
        assert g["valid?"] is host["valid?"]
        t0 = time.perf_counter()
        if g["competition-winner"] == "host":
            alone = linear.analysis_host(models.cas_register(), hist)
        else:
            assert g["competition-winner"] == "gpu"
            # the race pins its card (`pin_device`): the winner alone on
            # that card
            alone = wgl.analysis_gpu(models.cas_register(), hist,
                                     device=g["device"], explain=False,
                                     slot_overflow_fallback=False)
            if alone["valid?"] is False and "op-index" in alone:
                ex = linear.explain_failure(models.cas_register(), hist,
                                            alone["op-index"])
                if ex is not None:
                    alone["configs"] = ex["configs"]
                    alone["final-paths"] = ex["final-paths"]
        torch.cuda.synchronize()
        alone_s = time.perf_counter() - t0
        alone = linear._truncate(alone)
        for key in sorted(set(g) | set(alone)):
            if key not in ("competition-winner", "duration-ms"):
                assert g.get(key) == alone.get(key), key
        assert race_s < 4 * alone_s + 5.0, (race_s, alone_s)
        deadline = time.monotonic() + 10.0
        for t in list(linear._RACERS):
            t.join(max(0.0, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in list(linear._RACERS))


# -- the verification service on the card ------------------------------------------

_SVC_TIMING = ("tail-latency-ms", "duration-ms", "violation-at-op")
# (history seed, WglStream options): two dense streams (K1) and two packed
# sort streams on the hash route (K2); one of each made invalid by a read
# inside the declared range
_SVC_STREAMS = {
    "d0": (70, None, dict(engine="auto", state_range=(-1, 4),
                          concurrency_hint=5)),
    "d1": (71, 4, dict(engine="auto", state_range=(-1, 4),
                       concurrency_hint=5)),
    "s0": (72, None, dict(engine="sort", state_range=(-1, 10 ** 6),
                          slots=8)),
    "s1": (73, 999, dict(engine="sort", state_range=(-1, 10 ** 6),
                         slots=8)),
}


def _svc_hist(seed, bad):
    # few crashes: 8 slots hold every pending op, so the sort streams
    # keep their packed keys (and K2) to the end
    h = synth.register_history(600, concurrency=5, values=5,
                               crash_rate=0.0005, seed=seed)
    return synth.corrupt(h, seed=0, value=bad) if bad is not None else h


def _svc_solo(hist, kw):
    s = streaming.WglStream(models.cas_register(), chunk_entries=256,
                            checkpoint_every=2, **kw)
    for op in hist.ops:
        s.feed(op)
    return s.finish()


def _svc_strip(r):
    return {k: v for k, v in r.items() if k not in _SVC_TIMING}


@pytest.mark.gpu
def test_cuda_concurrent_streams_count_their_own_launches():
    """Two streams fed from two threads at once, a dense one and a hash
    one: each result's K3 rounds / K2 counts are its own (equal to the
    stream alone) and together they are the global counters' change; K2
    never launches."""
    _need_cuda()
    import threading
    picks = {"d0": _SVC_STREAMS["d0"], "s0": _SVC_STREAMS["s0"]}
    hists = {n: _svc_hist(sd, bad) for n, (sd, bad, _kw) in picks.items()}
    alone = {n: _svc_solo(hists[n], picks[n][2]) for n in picks}
    k1, k2, d3s = wgl_walk.ROUNDS, wgl_dedup.LAUNCHES, wgl_sortwalk.DEDUPS
    out = {}
    ths = [threading.Thread(target=lambda n=n: out.__setitem__(
        n, _svc_solo(hists[n], picks[n][2]))) for n in picks]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
        assert not t.is_alive()
    torch.cuda.synchronize()
    for n in picks:
        assert _svc_strip(out[n]) == _svc_strip(alone[n]), n
    assert out["d0"]["closure-rounds"] > 0
    assert out["s0"]["dedup-launches"] > 0
    assert wgl_walk.ROUNDS - k1 == out["d0"]["closure-rounds"]
    assert wgl_sortwalk.DEDUPS - d3s == sum(r["dedup-launches"]
                                            for r in out.values())
    assert wgl_dedup.LAUNCHES == k2


@pytest.mark.gpu
def test_cuda_service_four_streams_match_their_solos():
    """A VerificationService on the card with 4 streams (2 dense, K3; 2
    packed sort on the hash route, K3-sort), fed from 4 threads: each
    result equals the stream alone on the card, and the counts add up;
    K2 never launches."""
    _need_cuda()
    import threading
    from jepsen_tpu_torch import service
    hists = {n: _svc_hist(sd, bad)
             for n, (sd, bad, _kw) in _SVC_STREAMS.items()}
    alone = {n: _svc_solo(hists[n], kw)
             for n, (_sd, _bad, kw) in _SVC_STREAMS.items()}
    svc = service.VerificationService()
    for n, (_sd, _bad, kw) in _SVC_STREAMS.items():
        spec = {"kind": "wgl", "model": service.model_spec(
            models.cas_register()), "chunk-entries": 256,
            "checkpoint-every": 2, "engine": kw["engine"],
            "state-range": list(kw["state_range"])}
        if "slots" in kw:
            spec["slots"] = kw["slots"]
        if "concurrency_hint" in kw:
            spec["concurrency-hint"] = kw["concurrency_hint"]
        svc.admit(n, {"linear": spec})
    k1, k2, d3s = wgl_walk.ROUNDS, wgl_dedup.LAUNCHES, wgl_sortwalk.DEDUPS

    def feed(n):
        for op in hists[n].ops:
            svc.offer(n, op)
        svc.seal(n)

    ths = [threading.Thread(target=feed, args=(n,)) for n in hists]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
    res = {n: svc.result(n, timeout_s=300)["linear"] for n in hists}
    torch.cuda.synchronize()
    st = svc.status()
    svc.stop()
    for n in hists:
        assert _svc_strip(res[n]) == _svc_strip(alone[n]), n
    assert [res[n]["valid?"] for n in sorted(res)] == \
        [True, False, True, False]
    assert res["d0"]["analyzer"] == "gpu-wgl-dense-streaming"
    assert res["s0"]["dedup"] == "pallas-hash"
    assert wgl_walk.ROUNDS - k1 == sum(
        res[n]["closure-rounds"] for n in ("d0", "d1"))
    assert wgl_sortwalk.DEDUPS - d3s == sum(
        r["dedup-launches"] for r in res.values())
    assert wgl_dedup.LAUNCHES == k2
    assert all(s["state"] == "verdict" for s in st["streams"].values())
    assert st["calibration"]["platform"] == "cuda"


# -- K3: the dense step walk against the eager walk on the card ---------------

def _k3_case(name):
    """(model, history, plan options) of a K3 walk: the three models of
    the suites' single-object checks (the warp tier), and forced-dense
    tables on the block tier (P = 14) and on a cluster (P = 19)."""
    import chip_smoke
    if name == "register":
        return models.register(), synth.register_history(
            3000, concurrency=5, cas=False, crash_rate=0.002, seed=61), {}
    if name == "cas-register":
        return models.cas_register(), synth.register_history(
            3000, concurrency=5, crash_rate=0.002, seed=62), {}
    if name == "cas-register-dies":
        h = synth.register_history(3000, concurrency=5, crash_rate=0.002,
                                   seed=63)
        return models.cas_register(), synth.corrupt(h, seed=63, value=5), {}
    if name == "mutex":
        return models.mutex(), chip_smoke.mutex_history(3000, seed=64), {}
    conc = {"adversarial-14": 6, "at-cap-19": 11}[name]
    return models.cas_register(), synth.adversarial_register_history(
        300, concurrency=conc, crashed_writes=8, front_load=True,
        seed=65), {"engine": "dense"}


def _same_carry(a, b, where):
    for i, (u, v) in enumerate(zip(carry_to_numpy(a), carry_to_numpy(b))):
        assert u.dtype == v.dtype and u.shape == v.shape, (where, i)
        np.testing.assert_array_equal(u, v, err_msg=f"{where} element {i}")


# where each walks (`wgl_walk.WARP_MAX_WORDS`: a warp up to a word a lane):
# the cas register's 8 x 2^7 and the mutex's 4 x 2^3 cells on a warp, the
# 8 x 2^9 registers, 8 x 2^14 on a block, 8 x 2^19 on a cluster
_K3_TIER = {"register": "block", "cas-register": "warp",
            "cas-register-dies": "block", "mutex": "warp",
            "adversarial-14": "block", "at-cap-19": "cluster"}


def _tier_launches():
    return dict(wgl_walk.TIER_LAUNCHES)


def _took(before, tier):
    """Every K3 launch since `before` walked on `tier`."""
    now = _tier_launches()
    moved = {t: now[t] - before[t] for t in now if now[t] != before[t]}
    assert set(moved) == {tier}, moved


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["register", "cas-register",
                                  "cas-register-dies", "mutex",
                                  "adversarial-14", "at-cap-19"])
def test_k3_walk_matches_the_eager_walk(name, monkeypatch):
    """check_chunk on CUDA is K3: the carry equals the eager walk's
    element for element after every chunk (a carry resuming across
    calls, and across K3's 1,024-step windows inside one call), the
    rounds are exact, and so are the pair rounds K3 reports (the sum of
    each eager round's listed transitions); K1 never launches; and the
    walk took its tier (`_K3_TIER`)."""
    _need_cuda()
    listed = []
    real_round = wgl.closure_round

    def counted(tb, mft):
        listed.append(int(mft.sum()))
        return real_round(tb, mft)

    monkeypatch.setattr(wgl, "closure_round", counted)
    model, hist, kw = _k3_case(name)
    pl = wgl.plan(model, hist, **kw)
    assert pl.decision.dense is not None
    k3, ke = pl.kernel("cuda", 256), pl.kernel("cuda", 256)
    steps = wgl.build_steps(pl.ops, pl.slots)
    xs = wgl.stage_steps(steps.x, "cuda")
    init = model.device_state()
    c3, ce = k3.init_carry(init), ke.init_carry(init)
    launches, pairs = wgl_walk.LAUNCHES, wgl_walk.PAIR_ROUNDS
    tiers = _tier_launches()
    assert wgl_walk.tier(1, k3.S, k3.P) == _K3_TIER[name]
    for stop in (steps.n // 3, steps.n):
        k1 = wgl_closure.LAUNCHES
        c3 = k3.check_chunk(xs, stop, c3)
        assert wgl_closure.LAUNCHES == k1, "K1 launched inside a K3 walk"
        ce = ke.run_range_eager(xs, stop, ce)
        torch.cuda.synchronize()
        _same_carry(c3, ce, f"{name} to {stop}")
    assert k3.rounds == ke.rounds == len(listed) > 0
    assert wgl_walk.PAIR_ROUNDS - pairs == sum(listed)
    assert wgl_walk.LAUNCHES > launches
    _took(tiers, _K3_TIER[name])
    # a read to start each call, one at each window's end
    assert k3.syncs == 2 + wgl_walk.LAUNCHES - launches
    assert k3.syncs < ke.syncs
    assert int(k3.digest(c3)) == int(ke.digest(ce))
    if name == "cas-register-dies":
        assert int(c3[7]) == 0 and int(c3[0]) < steps.n


@pytest.mark.gpu
@pytest.mark.parametrize("B,conc,n", [(64, 4, 300), (3, 6, 200),
                                      (2, 11, 200), (48, 3, 300)])
def test_k3_batched_walk_matches_the_eager_lockstep_walk(B, conc, n):
    """check_chunk_batch on CUDA is one K3 launch per window for every
    key: keys of different stops, some dying mid-walk, each with the
    eager lockstep walk's carry and the same round total. (48, 8 x 2^7)
    walks a warp a key, four keys a block; (64, 8 x 2^9) a block a key;
    (3, P = 14), which took an off-chip path before the tiers, a block a
    key; (2, P = 19) a grid of two clusters."""
    _need_cuda()
    model = models.cas_register()
    if conc <= 4:
        hists = [synth.register_history(n + 13 * (i % 9), concurrency=conc,
                                        values=5, crash_rate=0.005,
                                        seed=1000 + i) for i in range(B)]
        for i in (3, 17, 40):
            hists[i] = synth.corrupt(hists[i], seed=i, value=5)
    else:
        hists = [synth.adversarial_register_history(
            n + 50 * i, concurrency=conc, crashed_writes=8,
            front_load=True, seed=70 + i) for i in range(B)]
    pre = [wgl.encode_ops_for_model(model, h) for h in hists]
    srange = wgl._state_range(model.device_model, model, pre)
    p = max(wgl.required_slots(o) for o in pre)
    dense = wgl._dense_shape(srange, p)
    steps = [wgl.build_steps(o, dense[2]) for o in pre]
    x, ns = wgl._stack_steps(steps, B)
    xs = wgl.stage_steps(x, "cuda")
    k3 = wgl.DenseKernel(model.device_model, *dense, "cuda")
    ke = wgl.DenseKernel(model.device_model, *dense, "cuda")
    init = [model.device_state()] * B
    c3, ce = k3.init_carry_batch(init), ke.init_carry_batch(init)
    launches = wgl_walk.LAUNCHES
    tiers = _tier_launches()
    for stop in (int(ns.max()) // 2, int(ns.max())):
        st = np.minimum(ns, stop)
        c3 = k3.check_chunk_batch(xs, st, c3)
        ce = ke.run_range_batch_eager(xs, st, ce)
        torch.cuda.synchronize()
        _same_carry(c3, ce, f"batch to {stop}")
    assert k3.rounds == ke.rounds > 0
    assert k3.syncs == 2 + wgl_walk.LAUNCHES - launches
    _took(tiers, {3: "warp", 4: "block", 6: "block", 11: "cluster"}[conc])
    if conc <= 4:
        assert (carry_to_numpy(c3)[7] == 0).sum() == 3
    # a block of keys with no step to walk (a sharded rank's padding)
    # comes back as it was, with no launch and one read
    launches, syncs = wgl_walk.LAUNCHES, k3.syncs
    assert k3.check_chunk_batch(xs, np.zeros(B, np.int64), c3) is c3
    assert wgl_walk.LAUNCHES == launches and k3.syncs == syncs + 1


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [None, 16])
def test_k3_stream_chunks_resume_like_the_eager_walk(slots):
    """check_stream_chunk on CUDA (K3, e rebased per chunk) against the
    eager walk over the same chunks: at the history's own slots, and at
    the dense stream's 16 (P = 16, the block tier)."""
    _need_cuda()
    h = synth.adversarial_register_history(600, concurrency=5,
                                           crashed_writes=6,
                                           front_load=True, seed=81)
    pl = wgl.plan(models.cas_register(), h, engine="dense")
    if slots is None:
        k3, ke = pl.kernel("cuda", 256), pl.kernel("cuda", 256)
    else:   # the stream's table: its slots, whatever the history needs
        s_lo, S, _p = pl.decision.dense
        k3, ke = (wgl.DenseKernel(pl.model_name, s_lo, S, slots, "cuda")
                  for _ in range(2))
    steps = wgl.build_steps(pl.ops, k3.P)
    init = models.cas_register().device_state()
    c3, ce = k3.init_carry(init), ke.init_carry(init)
    chunk = 256
    launches = wgl_walk.LAUNCHES
    for lo in range(0, steps.n, chunk):
        part = np.zeros((chunk, steps.x.shape[1]), np.int32)
        part[:, 1] = -1
        n = min(chunk, steps.n - lo)
        part[:n] = steps.x[lo:lo + n]
        xs = wgl.stage_steps(part, "cuda")
        c3 = k3.check_stream_chunk(xs, n, c3)
        out = ke.run_range_eager(xs, n, (ke._i32(0),) + tuple(ce[1:]))
        ce = (out[0] + ce[0],) + tuple(out[1:])
        torch.cuda.synchronize()
        _same_carry(c3, ce, f"stream chunk at {lo}")
    assert k3.rounds == ke.rounds > 0
    assert k3.syncs == len(range(0, steps.n, chunk)) + (
        wgl_walk.LAUNCHES - launches)
    if slots == 16:
        assert k3.P == 16 and wgl_walk.tier(1, k3.S, 16) == "block"


@pytest.mark.gpu
def test_k3_refused_launch_raises_and_does_not_fall_back(monkeypatch):
    """A launch the kernel refuses raises KernelLaunchError; the walk
    never falls back to the eager walk or to the CPU."""
    _need_cuda()
    h = synth.register_history(200, concurrency=4, seed=91)
    pl = wgl.plan(models.cas_register(), h)
    k = pl.kernel("cuda", 256)
    steps = wgl.build_steps(pl.ops, pl.slots)
    xs = wgl.stage_steps(steps.x, "cuda")
    carry = k.init_carry(models.cas_register().device_state())

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the eager walk")

    monkeypatch.setattr(wgl.DenseKernel, "run_range_eager", no_fallback)
    real = wgl_walk._check
    # a slot count past the kernel's 30: the C entry refuses the launch
    monkeypatch.setattr(wgl_walk, "_check",
                        lambda *a: real(*a)[:2] + (31,) + real(*a)[3:])
    before = wgl_walk.LAUNCHES
    with pytest.raises(_platform.KernelLaunchError):
        k.check_chunk(xs, steps.n, carry)
    assert wgl_walk.LAUNCHES == before
    monkeypatch.setattr(wgl_walk, "_check", real)
    with pytest.raises(ValueError):      # a table on another device
        wgl_walk.launch(
            xs.dev[None], torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.zeros((4, 1), dtype=torch.int32, device="cuda"),
            carry[1][None].cpu(),
            torch.zeros((3, 1, k.P), dtype=torch.int32, device="cuda"),
            carry[5][None], model="cas-register", s_lo=k.s_lo, attest=True,
            steps=4)


@pytest.mark.gpu
def test_k3_refused_cluster_launch_raises_and_does_not_fall_back(
        monkeypatch):
    """A cluster the card refuses (the C entry's error code, here set in
    its place) raises KernelLaunchError from the walk: no launch is
    counted, and nothing falls back to the eager walk, another tier or
    the CPU."""
    _need_cuda()
    model, hist, kw = _k3_case("at-cap-19")
    pl = wgl.plan(model, hist, **kw)
    k = pl.kernel("cuda", 256)
    assert wgl_walk.tier(1, k.S, k.P) == "cluster"
    steps = wgl.build_steps(pl.ops, pl.slots)
    xs = wgl.stage_steps(steps.x, "cuda")
    carry = k.init_carry(model.device_state())

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the eager walk")

    real_fn, plan_fn, err = wgl_walk._kernel()
    calls = []

    def refused(*a):
        calls.append(a)
        return 701   # cudaErrorLaunchOutOfResources: the cluster won't fit

    monkeypatch.setattr(wgl.DenseKernel, "run_range_eager", no_fallback)
    monkeypatch.setattr(wgl_walk, "_kernel", lambda: (refused, plan_fn, err))
    before, tiers = wgl_walk.LAUNCHES, _tier_launches()
    with pytest.raises(_platform.KernelLaunchError, match="701"):
        k.check_chunk(xs, steps.n, carry)
    assert len(calls) == 1 and wgl_walk.LAUNCHES == before
    assert _tier_launches() == tiers
    assert real_fn is not refused


# -- K3-sort: the sort step walk against the eager walk on the card -----------

def _k3s_case(name):
    """(model, history, F, slots, route) of a K3-sort walk: each route on
    the shared-memory path, each on the grid path (one key too large for
    shared memory: F >= 1,024), the two-word lexicographic key (40 slots)
    and three more models."""
    import chip_smoke
    reg = models.cas_register()
    adv = synth.adversarial_register_history
    return {
        "hash-phantom": (reg, synth.corrupt(synth.register_history(
            2000, concurrency=5, crash_rate=0.0005, seed=101)), 256, 8,
            "hash"),
        "hash-counter": (models.counter(), synth.counter_history(
            1500, seed=102), 256, 8, "hash"),
        "hash-mutex": (models.mutex(), chip_smoke.mutex_history(
            1500, seed=103), 64, 3, "hash"),
        "hash-scratch": (reg, synth.register_history(
            600, concurrency=5, crash_rate=0.01, seed=104), 1024, 16, "hash"),
        "packed": (reg, synth.register_history(
            1500, concurrency=5, crash_rate=0.002, seed=105), 128, 8,
            "packed"),
        "packed-scratch": (reg, adv(150, concurrency=6, crashed_writes=8,
                                    front_load=True, seed=106), 4096, 16,
                           "packed"),
        "packed-65536": (reg, adv(40, concurrency=6, crashed_writes=8,
                                  front_load=True, seed=107), 65536, 16,
                         "packed"),
        "lex-32": (reg, adv(600, concurrency=11, crashed_writes=8,
                            front_load=True, seed=108), 256, 32, "lex"),
        "lex-40": (reg, synth.register_history(
            600, concurrency=6, crash_rate=0.01, seed=109), 64, 40, "lex"),
        "lex-scratch": (reg, adv(200, concurrency=11, crashed_writes=8,
                                 front_load=True, seed=110), 1024, 32,
                        "lex"),
        "lex-queue": (models.unordered_queue(), synth.uqueue_history(
            400, seed=111), 256, 8, "lex"),
    }[name]


def _k3s_kernels(model, hists, F, slots, route):
    """Two SortKernels on the card at the case's F and route (built
    directly, as the escalation builds them), the staged steps (B, T,
    W+4) and stops of the histories, and the initial state."""
    pre = [wgl.encode_ops_for_model(model, h) for h in hists]
    srange = wgl._state_range(model.device_model, model, pre)
    pack = wgl._pack_params(srange, slots) if route != "lex" else None

    def make():
        return wgl.SortKernel(model.device_model, F, slots, pack,
                              wgl.DEDUP_PALLAS if route == "hash"
                              else wgl.DEDUP_SORT, "cuda")

    assert make().route == route

    x, ns = wgl._stack_steps([wgl.build_steps(o, slots) for o in pre],
                             len(pre))
    return make(), make(), wgl.stage_steps(x, "cuda"), np.asarray(ns), \
        model.device_state()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hash-phantom", "hash-counter",
                                  "hash-mutex", "hash-scratch", "packed",
                                  "packed-scratch", "packed-65536", "lex-32",
                                  "lex-40", "lex-scratch", "lex-queue"])
def test_k3s_walk_matches_the_eager_walk(name):
    """check_chunk on CUDA is K3-sort: the carry equals the eager walk's
    element for element after every chunk (a carry resuming across calls
    and across windows inside one call), rounds and hash dedups exact, K2
    never launched, one host read to start and one a launch."""
    _need_cuda()
    model, hist, F, slots, route = _k3s_case(name)
    k3, ke, xs, ns, init = _k3s_kernels(model, [hist], F, slots, route)
    n = int(ns[0])
    x1 = wgl.Staged(xs.host[0], xs.dev[0])
    c3, ce = k3.init_carry(init), ke.init_carry(init)
    launches = wgl_sortwalk.LAUNCHES
    calls = 0
    for stop in (n // 3, n):
        k2 = wgl_dedup.LAUNCHES
        c3 = k3.check_chunk(x1, stop, c3)
        calls += 1
        assert wgl_dedup.LAUNCHES == k2, "K2 launched inside a K3-sort walk"
        ce = ke.run_range_eager(x1, stop, ce)
        torch.cuda.synchronize()
        _same_carry(c3, ce, f"{name} to {stop}")
    assert k3.rounds == ke.rounds
    assert k3.dedups == ke.dedups
    assert (k3.dedups > 0) == (route == "hash")
    assert wgl_sortwalk.LAUNCHES > launches
    assert k3.syncs == calls + wgl_sortwalk.LAUNCHES - launches
    assert k3.syncs < ke.syncs
    assert int(k3.digest(c3)) == int(ke.digest(ce))


def _k3s_ties(route, F):
    """(model, history, F, slots, route) of a walk whose sort dedups hold
    long runs of equal keys across position F - 1 (the adversarial
    history's crashed writes: on the packed route up to 1,023 rows tied
    with the row at F - 1) and overflow: F = 1,024 walks one key on the
    grid path, F = 256 on shared memory."""
    adv = synth.adversarial_register_history
    hist = (adv(60, concurrency=6, crashed_writes=8, front_load=True,
                seed=117) if F >= 1024 else
            adv(200, concurrency=6, crashed_writes=6, front_load=True,
                seed=119))
    return models.cas_register(), hist, F, 16 if route == "packed" else 32, \
        route


@pytest.mark.gpu
@pytest.mark.parametrize("route,F", [("packed", 1024), ("lex", 1024),
                                     ("packed", 256), ("lex", 256)])
def test_k3s_walk_with_many_ties_matches_the_eager_walk(route, F):
    """K3-sort's select-then-sort where runs of equal keys straddle
    position F - 1 (the selection's threshold ends on equal keys, taken
    lowest row first): the carry equals the eager walk's element for
    element after every chunk, rounds and hash dedups equal, the frontier
    overflowed, on the grid path (F = 1,024, one key) and on shared
    memory (F = 256)."""
    _need_cuda()
    model, hist, F, slots, route = _k3s_ties(route, F)
    k3, ke, xs, ns, init = _k3s_kernels(model, [hist], F, slots, route)
    assert wgl_sortwalk.path(1, F, slots, route) == (
        "grid" if F >= 1024 else "shared")
    n = int(ns[0])
    x1 = wgl.Staged(xs.host[0], xs.dev[0])
    c3, ce = k3.init_carry(init), ke.init_carry(init)
    for stop in (n // 4, n // 2, n):
        c3 = k3.check_chunk(x1, stop, c3)
        ce = ke.run_range_eager(x1, stop, ce)
        torch.cuda.synchronize()
        _same_carry(c3, ce, f"{route} F={F} to {stop}")
    assert k3.rounds == ke.rounds > 0 and k3.dedups == ke.dedups == 0
    assert bool(carry_to_numpy(ce)[8])


@pytest.mark.gpu
@pytest.mark.parametrize("route,F", [("packed", 1024), ("lex", 256)])
def test_k3s_phase_split_fits_in_the_launches_time(route, F):
    """The phase split K3-sort reports (`wgl_sortwalk.PHASE_NS`, each
    key's lead thread between its boundaries) sums to no more than the
    CUDA-event time around the walk's launches, and is not empty: the
    row build and the sort's phases took time."""
    _need_cuda()
    model, hist, F, slots, route = _k3s_ties(route, F)
    k3, _ke, xs, ns, init = _k3s_kernels(model, [hist], F, slots, route)
    x1 = wgl.Staged(xs.host[0], xs.dev[0])
    k3.check_chunk(x1, int(ns[0]), k3.init_carry(init))   # build, warm
    before = dict(wgl_sortwalk.PHASE_NS)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    k3.check_chunk(x1, int(ns[0]), k3.init_carry(init))
    end.record()
    torch.cuda.synchronize()
    ns_split = {k: v - before[k] for k, v in wgl_sortwalk.PHASE_NS.items()}
    event_ns = start.elapsed_time(end) * 1e6
    assert 0 < sum(ns_split.values()) <= event_ns, (ns_split, event_ns)
    for name in ("rows", "select", "count", "scatter", "extract"):
        assert ns_split[name] > 0, (name, ns_split)
    assert (ns_split["wait"] > 0) == (F >= 1024)


@pytest.mark.gpu
@pytest.mark.parametrize("route,F,B", [("hash", 1024, 32), ("hash", 256, 6),
                                       ("lex", 256, 5), ("lex", 1024, 4),
                                       ("packed", 1024, 4)])
def test_k3s_batched_walk_matches_the_eager_lockstep_walk(route, F, B):
    """check_chunk_batch on CUDA is one K3-sort launch per window for every
    key: counter keys of different stops (the counter batch's shape at
    F = 1,024, 16 slots, one block a key in device scratch, on each
    route), some dying mid-walk, each with the eager lockstep walk's
    carry, the same rounds (the max over the invoking keys a step) and
    hash dedups."""
    _need_cuda()
    model = models.counter()
    hists = [synth.counter_history(200 + 37 * (i % 5), seed=2000 + i)
             for i in range(B)]
    for i in (1, B - 2):
        hists[i] = synth.corrupt(hists[i], seed=i, value=999 if i % 2 else
                                 -999)
    slots = 16 if F == 1024 else 8 if route == "hash" else 32
    k3, ke, xs, ns, init = _k3s_kernels(model, hists, F, slots, route)
    c3, ce = k3.init_carry_batch([init] * B), ke.init_carry_batch([init] * B)
    launches = wgl_sortwalk.LAUNCHES
    for stop in (int(ns.max()) // 2, int(ns.max())):
        st = np.minimum(ns, stop)
        c3 = k3.check_chunk_batch(xs, st, c3)
        ce = ke.run_range_batch_eager(xs, st, ce)
        torch.cuda.synchronize()
        _same_carry(c3, ce, f"batch to {stop}")
    assert k3.rounds == ke.rounds > 0
    assert k3.dedups == ke.dedups
    assert k3.syncs == 2 + wgl_sortwalk.LAUNCHES - launches
    assert (carry_to_numpy(c3)[10] == 0).sum() == 2
    # a block of keys with no step to walk comes back as it was, with no
    # launch and one read
    launches, syncs = wgl_sortwalk.LAUNCHES, k3.syncs
    assert k3.check_chunk_batch(xs, np.zeros(B, np.int64), c3) is c3
    assert wgl_sortwalk.LAUNCHES == launches and k3.syncs == syncs + 1


@pytest.mark.gpu
def test_k3s_stream_chunks_resume_like_the_eager_walk():
    """check_stream_chunk on CUDA (K3-sort, e rebased per chunk) against
    the eager walk over the same chunks, on the sort-abort stream's shape
    (packed, hash route, 8 slots, F = 256)."""
    _need_cuda()
    h = synth.corrupt(synth.register_history(1200, concurrency=5,
                                             crash_rate=0.0, seed=112))
    k3, ke, xs, ns, init = _k3s_kernels(models.cas_register(), [h], 256, 8,
                                        "hash")
    x = xs.host[0]
    n_all = int(ns[0])
    c3, ce = k3.init_carry(init), ke.init_carry(init)
    chunk = 256
    for lo in range(0, n_all, chunk):
        part = np.zeros((chunk, x.shape[1]), np.int32)
        part[:, k3.W] = -1
        n = min(chunk, n_all - lo)
        part[:n] = x[lo:lo + n]
        st = wgl.stage_steps(part, "cuda")
        c3 = k3.check_stream_chunk(st, n, c3)
        out = ke.run_range_eager(st, n, (ke._i32(0),) + tuple(ce[1:]))
        ce = (out[0] + ce[0],) + tuple(out[1:])
        torch.cuda.synchronize()
        _same_carry(c3, ce, f"stream chunk at {lo}")
    assert k3.rounds == ke.rounds > 0 and k3.dedups == ke.dedups


@pytest.mark.gpu
def test_k3s_refused_launch_raises_and_does_not_fall_back(monkeypatch):
    """A launch the kernel refuses raises KernelLaunchError; the walk
    never falls back to the eager walk or to K2."""
    _need_cuda()
    h = synth.corrupt(synth.register_history(300, concurrency=4, seed=113))
    k, _ke, xs, ns, init = _k3s_kernels(models.cas_register(), [h], 256, 8,
                                        "hash")
    x1 = wgl.Staged(xs.host[0], xs.dev[0])
    carry = k.init_carry(init)

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the eager walk")

    monkeypatch.setattr(wgl.SortKernel, "run_range_eager", no_fallback)
    real = wgl_sortwalk._check
    # a slot count past the kernel's 256: the C entry refuses the shape
    monkeypatch.setattr(wgl_sortwalk, "_check",
                        lambda *a: real(*a)[:3] + (300,) + real(*a)[4:])
    before, k2 = wgl_sortwalk.LAUNCHES, wgl_dedup.LAUNCHES
    with pytest.raises(_platform.KernelLaunchError):
        k.check_chunk(x1, int(ns[0]), carry)
    assert wgl_sortwalk.LAUNCHES == before and wgl_dedup.LAUNCHES == k2
    monkeypatch.setattr(wgl_sortwalk, "_check", real)
    c = k.init_carry_batch([init])
    with pytest.raises(ValueError):      # masks on another device
        wgl_sortwalk.launch(
            xs.dev, torch.zeros(1, dtype=torch.int32, device="cuda"),
            torch.zeros((5, 1), dtype=torch.int32, device="cuda"),
            c[1].cpu(), c[2], c[3], torch.stack([c[4], c[5], c[6]]), c[7],
            model="cas-register", route="hash", s_lo=k.s_lo,
            sb_bits=k.sb_bits, attest=True, steps=4)


# -- K4: the Elle classifier and transitive closure ---------------------------

# every route's buckets: K4-small's warp teams (e <= 32) and block teams
# (64-256), K4-product's chain (512-2,048, and at 256 called by name)
_K4_BUCKETS = [(8, 64, "small"), (16, 32, "small"), (32, 8, "small"),
               (64, 16, "small"), (128, 4, "small"), (256, 8, "small"),
               (256, 8, "product"), (512, 4, "product"),
               (1024, 2, "product"), (2048, 1, "product")]


def _k4_counts():
    return dict(k4.LAUNCHES), k4.HELPER_LAUNCHES, k4.MEMSETS


def _k4_on(kernel, args, steps):
    """K4 by `classify` where `kernel` is the bucket's route, else the
    product chain by name."""
    b, e = args[0].shape[:2]
    if k4.route(e) == kernel:
        return k4.classify(*args, steps)
    assert kernel == "product"
    return k4._classify_product(*args, steps, b, e)


@pytest.mark.gpu
@pytest.mark.parametrize("e,b,kernel", _K4_BUCKETS)
def test_k4_classifier_matches_the_plain_version(e, b, kernel):
    """K4's flags equal the plain chain's on the card and on the CPU, with
    every residue 0, on random blocks and one ring of each kind (zero
    padding blocks included)."""
    _need_cuda()
    ww, wr, rw = _elle_bucket(e, b, np.random.default_rng(e + b), 1.2)
    n = min(e, 200)
    for s, rw_at in zip(range(min(b, 3)), ((), (n // 3,), (1, n // 2))):
        for m in (ww, wr, rw):
            m[s] = 0.0
        for k in range(n):
            (rw if k in rw_at else ww)[s, k, (k + 1) % n] = 1.0
    if b > 3:
        for m in (ww, wr, rw):
            m[-1] = 0.0
    steps = elle_kernels._steps(e)
    cpu = [torch.from_numpy(x) for x in (ww, wr, rw)]
    args = [x.cuda() for x in cpu]
    before = _k4_counts()
    flags, res = _k4_on(kernel, args, steps)
    torch.cuda.synchronize()
    after = _k4_counts()
    want_flags, want_res = k4.classify(*cpu, steps)
    *plain, plain_res = elle_kernels._flags_batch(*args, steps)
    assert torch.equal(flags.cpu(), want_flags)
    assert torch.equal(torch.stack(plain, 1).to(torch.int32).cpu(),
                       want_flags)
    assert res.cpu().tolist() == want_res.tolist() == \
        plain_res.cpu().tolist() == [0] * b
    assert want_flags[0].tolist()[:2] == [1, 1]            # the ww ring
    if b > 1:
        assert want_flags[1].tolist()[2] == 1               # one rw
    if b > 3:
        assert want_flags[-1].tolist() == [0, 0, 0, 0]      # padding
    if kernel == "small":
        assert after == ({"small": before[0]["small"] + 1,
                          "product": before[0]["product"]}, *before[1:])
    else:
        assert after[0]["small"] == before[0]["small"]
        assert after[0]["product"] - before[0]["product"] == 3 * steps + 3
        # four stagings, a residue a squaring and the pair test
        assert after[1] - before[1] == 4 + 3 * steps + 1
        assert after[2] - before[2] == 1        # one zeroed workspace


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["small", "product"])
def test_k4_takes_more_blocks_than_a_grid_dimension(kernel):
    """A bucket of 65,536 blocks (past a grid's 65,535 in y and z): both
    K4 routes equal the plain chain, the last blocks included."""
    _need_cuda()
    e, b = 8, 65536
    ww, wr, rw = _elle_bucket(e, b, np.random.default_rng(11), 1.2)
    for m in (ww, wr, rw):
        m[-2:] = 0.0
    ww[-1, np.arange(e), (np.arange(e) + 1) % e] = 1.0      # G0, G1c
    ww[-2, np.arange(e - 1), np.arange(1, e)] = 1.0
    rw[-2, e - 1, 0] = 1.0                                   # G-single
    steps = elle_kernels._steps(e)
    args = [torch.from_numpy(x).cuda() for x in (ww, wr, rw)]
    flags, res = _k4_on(kernel, args, steps)
    *plain, plain_res = elle_kernels._flags_batch(*args, steps)
    want = torch.stack(plain, 1).to(torch.int32)
    assert torch.equal(flags, want)
    assert int(res.abs().max()) == int(plain_res.abs().max()) == 0
    assert want[-1].tolist() == [1, 1, 0, 0]
    assert want[-2].tolist() == [0, 0, 1, 0]


@pytest.mark.gpu
def test_k4_small_bucket_is_one_launch_through_the_classifier():
    _need_cuda()
    buckets = {8: _elle_bucket(8, 64, np.random.default_rng(1))}
    before = _k4_counts()
    got = elle_kernels._classify_batches(buckets, device="cuda")
    assert _k4_counts() == ({"small": before[0]["small"] + 1,
                             "product": before[0]["product"]}, *before[1:])
    want = elle_kernels._classify_batches_host(buckets)
    for g, w in zip(got[8], want[8]):
        assert np.array_equal(g, w)


@pytest.mark.gpu
def test_k4_leaves_bmm_and_mm_alone(monkeypatch):
    """On CUDA the classifier and the closure call neither torch.bmm nor
    torch.mm (nor cuBLAS through them): only K4 and its helpers."""
    _need_cuda()
    real_bmm, real_mm = torch.bmm, torch.mm

    def guard(real):
        def call(a, b, *rest, **kw):
            if a.is_cuda or b.is_cuda:
                raise AssertionError("a CUDA product outside K4")
            return real(a, b, *rest, **kw)
        return call

    monkeypatch.setattr(torch, "bmm", guard(real_bmm))
    monkeypatch.setattr(torch, "mm", guard(real_mm))
    rng = np.random.default_rng(5)
    for e, b in ((8, 4), (256, 2), (512, 2), (1024, 1)):
        buckets = {e: _elle_bucket(e, b, rng)}
        got = elle_kernels._classify_batches(buckets, device="cuda")
        want = elle_kernels._classify_batches_host(buckets)
        for g, w in zip(got[e], want[e]):
            assert np.array_equal(g, w)
    ring = np.zeros((1000, 1000), bool)
    ring[np.arange(1000), (np.arange(1000) + 1) % 1000] = True
    before = k4.LAUNCHES["product"]
    closed = elle_kernels.transitive_closure(ring, device="cuda")
    assert closed.all()
    assert k4.LAUNCHES["product"] - before == elle_kernels._steps(1000)


@pytest.mark.gpu
@pytest.mark.parametrize("m,e,density", [(512, 512, 0.02), (128, 4096, 0.001),
                                         (64, 1024, 1.0), (40, 136, 0.3)])
def test_k4_product_squaring_matches_torch_mm(m, e, density):
    """One K4-product squaring of a row block against float64 counts: the
    next rows, and both column sums, exact."""
    _need_cuda()
    rng = np.random.default_rng(m + e)
    a = (rng.random((e, e)) < density).astype(np.float32)
    full = torch.from_numpy(a).cuda().to(torch.bfloat16)
    rows = full[:m].contiguous()
    stats = torch.zeros((2, 1, e), dtype=torch.int32, device="cuda")
    got = k4.product(rows, full, rows, stats=stats)
    counts = torch.from_numpy(a[:m].astype(np.float64) @ a.astype(np.float64))
    want = ((counts + torch.from_numpy(a[:m]).double()) > 0)
    assert torch.equal(got.cpu() > 0, want)
    assert stats[0, 0].cpu().tolist() == counts.sum(0).long().tolist()
    assert stats[1, 0].cpu().tolist() == want.sum(0).tolist()
    assert torch.equal(k4.square_rows(rows, full).cpu() > 0, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [100, 1000, 4096])
def test_k4_transitive_closure_matches_the_cpu(n):
    _need_cuda()
    rng = np.random.default_rng(n)
    adj = rng.random((n, n)) < 1.0 / n
    adj[np.arange(n), (np.arange(n) + 7) % n] = rng.random(n) < 0.9
    got = elle_kernels.transitive_closure(adj, device="cuda")
    want = elle_kernels.transitive_closure(adj, device="cpu")
    assert got.dtype == want.dtype == np.bool_ and np.array_equal(got, want)


@pytest.mark.gpu
def test_k4_refused_launch_raises_and_does_not_fall_back(monkeypatch):
    _need_cuda()
    lib = k4._lib()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def jt_elle_small(*a):
            return 1                    # cudaErrorInvalidValue

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain chain")

    monkeypatch.setattr(k4, "_lib", lambda: Refusing())
    monkeypatch.setattr(elle_kernels, "_flags_batch", no_fallback)
    args = [torch.zeros((2, 8, 8), device="cuda") for _ in range(3)]
    before = _k4_counts()
    with pytest.raises(_platform.KernelLaunchError):
        k4.classify(*args, 3)
    assert _k4_counts() == before
    with pytest.raises(ValueError):     # K not a multiple of 8
        k4.product(*(torch.zeros((12, 12), dtype=torch.bfloat16,
                                 device="cuda"),) * 2)
