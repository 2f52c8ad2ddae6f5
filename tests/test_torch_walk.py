"""K3, the dense step walk (`checker/wgl_walk.py`, `csrc/dense_walk.cu`),
on the CPU: the kernel cannot run here, so these hold what it is built
on.

  * `transition_rows` gives exactly the transitions the eager walk builds
    for K1 (`mft`), and a numpy transcription of the row the kernel
    computes itself for an invoke (the models of `csrc/sort_models.cuh`)
    equals it, for all six device models;
  * the round count K3 reports for a batch (the sum over lockstep steps
    of the max over the keys invoking there of each key's own rounds)
    equals the eager lockstep walk's;
  * the kernel's formulation, emulated in numpy on bit-packed tables
    (shift-mask rounds inside a word, word-XOR rounds across words, the
    completion's gather and shifts, popcount and attestation masks, the
    lane and cluster-rank splits as slices, the read-ahead of step rows,
    windows and the per-step round maxima), gives the eager walk's
    carries and rounds, and, drawn by hypothesis, the JAX package's;
  * the batch's initial carry, built on the host, is the stacked
    `init_carry` of each key, on both families;
  * the dense entries on the CPU (`check_chunk`, `check_chunk_batch`,
    `check_stream_chunk`, which take the eager walk on CPU tensors) still
    give the JAX package's carries, element for element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.carry import carry_to_numpy
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl
from jepsen_tpu_torch.checker import wgl_walk
from jepsen_tpu_torch.history import NIL
from test_torch_sortwalk import np_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the transition rows are the eager walk's transitions --------------

# model -> (s_lo, f codes, values drawn for a and b)
MODEL_OPS = {
    "cas-register": (-1, (0, 1, 2), np.arange(-1, 9)),
    "register": (-1, (0, 1), np.arange(-1, 9)),
    "mutex": (0, (0, 1), np.array([NIL])),
    "counter": (-6, (0, 1), np.arange(-4, 5)),
    "g-set": (0, (0, 1), np.arange(-1, 6)),
    "unordered-queue": (0, (0, 1), np.arange(-1, 8)),
}


def _eager_mft(k, table, slots, occ, monkeypatch):
    """The mft `DenseKernel._closure` hands K1 (its first round)."""
    seen = []

    def record(tb, mft):
        seen.append(mft.clone())
        return tb

    monkeypatch.setattr(twgl, "closure_round", record)
    k._closure(table, slots, occ)
    return seen[0]


@pytest.mark.parametrize("name", sorted(MODEL_OPS))
@pytest.mark.parametrize("S,P", [(2, 1), (5, 3), (8, 6), (13, 4)])
def test_transition_rows_give_the_eager_mft(name, S, P, monkeypatch):
    s_lo, fs, vals = MODEL_OPS[name]
    rng = np.random.default_rng(1000 * S + 10 * P + len(name))
    k = twgl.DenseKernel(name, s_lo, S, P, "cpu")
    for _ in range(6):
        f = rng.choice(fs, P).astype(np.int32)
        a = rng.choice(vals, P).astype(np.int32)
        b = rng.choice(vals, P).astype(np.int32)
        slots = torch.from_numpy(np.stack([f, a, b]))
        occ = torch.from_numpy(rng.random(P) < 0.7)
        table = torch.zeros((S, 1 << P), dtype=torch.bool)
        want = _eager_mft(k, table, slots, occ, monkeypatch).numpy()
        rows = wgl_walk.transition_rows(k.step, s_lo, S, slots[0], slots[1],
                                        slots[2])
        assert rows.dtype == torch.int16 and rows.shape == (P, S)
        rows = rows.numpy().astype(np.int64)
        got = (occ.numpy()[:, None, None]
               & (rows[:, None, :] == np.arange(S)[None, :, None]))
        np.testing.assert_array_equal(got.astype(np.uint8), want)
        # the rows the kernel computes for each slot's op
        mine = np.stack([_kernel_rows(name, s_lo, S, f[p], a[p], b[p])
                         for p in range(P)])
        np.testing.assert_array_equal(mine, rows)


# -- the batch used by (b) and the emulation: hazelcast-shaped keys ---------

def _hazelcast_batch(lengths, seed0=1000, bad=()):
    """Keys shaped like the hazelcast batch (register histories at
    concurrency 4, five values), of different lengths; keys in `bad`
    with one read set to a value no write wrote, so they die mid-walk."""
    model = tmodels.cas_register()
    hists = []
    for i, n in enumerate(lengths):
        h = tsynth.register_history(n, concurrency=4, values=5,
                                    crash_rate=0.005, seed=seed0 + i)
        if i in bad:
            h = tsynth.corrupt(h, seed=seed0 + i, value=5)
        hists.append(h)
    pre = [twgl.encode_ops_for_model(model, h) for h in hists]
    srange = twgl._state_range("cas-register", model, pre)
    p = max(twgl.required_slots(o) for o in pre)
    s_lo, S, P = twgl._dense_shape(srange, p)
    steps = [twgl.build_steps(o, P) for o in pre]
    x, ns = twgl._stack_steps(steps, len(steps))
    k = twgl.DenseKernel("cas-register", s_lo, S, P, "cpu")
    return k, x, ns, int(model.device_state())


def _solo_rounds(k, x, n, init):
    """Each step's closure rounds of one key walked alone (eager)."""
    xs = twgl.stage_steps(x, "cpu")
    carry, out = k.init_carry(init), []
    for e in range(n):
        r0 = k.rounds
        carry = k.run_range_eager(xs, e + 1, carry)
        if int(carry[7]) <= 0 and int(carry[0]) <= e:
            break
        out.append(k.rounds - r0)
        if int(carry[7]) <= 0:
            break
    return out


def test_batched_rounds_are_the_lockstep_max_of_each_keys_own():
    """Sum over lockstep steps t of max over keys of key k's own rounds at
    its t-th step equals the eager batched walk's round count: the
    identity K3's per-step atomicMax relies on."""
    k, x, ns, init = _hazelcast_batch([90, 140, 60, 120, 30], bad=(1, 3))
    per_key = [_solo_rounds(k, x[b], int(ns[b]), init)
               for b in range(len(ns))]
    assert any(len(r) < n for r, n in zip(per_key, ns)), "no key died"
    T = max(len(r) for r in per_key)
    want = sum(max((r[t] for r in per_key if t < len(r)), default=0)
               for t in range(T))
    k.rounds = 0
    xs = twgl.stage_steps(x, "cpu")
    carry = k.run_range_batch_eager(xs, ns, k.init_carry_batch(
        [init] * len(ns)))
    assert k.rounds == want > 0
    # and each key's batched carry is its solo carry
    for b in range(len(ns)):
        solo = k.run_range_eager(twgl.stage_steps(x[b], "cpu"), int(ns[b]),
                                 k.init_carry(init))
        for i, (u, v) in enumerate(zip(carry_to_numpy(solo),
                                       carry_to_numpy(carry))):
            np.testing.assert_array_equal(u, v[b], err_msg=f"key {b} {i}")


# -- the kernel's formulation, emulated in numpy ------------------------------
#
# csrc/dense_walk.cu on bit-packed tables: 32 cells a word (one word a row
# for P < 5, its bits C and up never set), a key's words split over the n
# blocks of its cluster (block r holds words [r NW / n, (r + 1) NW / n) of
# every row, an (n, S, NW / n) array here; n = 1 on the warp and block
# tiers), each block's words over its `lanes` threads (word i to thread
# i % lanes) for the sums, and the step rows read ahead 32 at a time (the
# warp) or in double-buffered chunks of 128 (the block tiers).

_M = np.array([0xAAAAAAAA, 0xCCCCCCCC, 0xF0F0F0F0, 0xFF00FF00, 0xFFFF0000],
              np.uint32)
_ROW_CHUNK = 128


def _popc(words):
    """__popc of each uint32."""
    w = np.ascontiguousarray(words, dtype="<u4")
    return np.unpackbits(w.view(np.uint8).reshape(*w.shape, 4),
                         axis=-1).sum(-1).astype(np.int64)


def _pack(table, n):
    """The launch's packing of one key's bool (S, C) table: (n, S, NW / n)
    uint32, cell c of row s in bit c & 31 of word c >> 5."""
    S, C = table.shape
    t = table.astype(bool)
    if C < 32:
        t = np.pad(t, ((0, 0), (0, 32 - C)))
    bits = t.reshape(S, -1, 32).astype(np.uint64)
    w = (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return np.ascontiguousarray(w.reshape(S, n, -1).transpose(1, 0, 2))


def _unpack(ta, C):
    n, S, nwb = ta.shape
    w = ta.transpose(1, 0, 2).reshape(S, n * nwb)
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(S, -1)[:, :C].astype(bool)


def _global_j(ta):
    """Each word's index j in its row, (n, 1, NW / n)."""
    n, _S, nwb = ta.shape
    return (np.arange(n)[:, None, None] * nwb
            + np.arange(nwb)[None, None, :])


def _word_at(ta, s, j):
    """`word_at`: word j of row s (s broadcasts against j), wherever in the
    cluster's blocks it lies."""
    nwb = ta.shape[2]
    return ta[j // nwb, s, j % nwb]


def _low_mask(nb):
    m = np.uint32(0)
    for b in range(5):
        if (nb >> b) & 1:
            m |= _M[b]
    return m


def _team_sum(ta, nb, attest, lanes):
    """Each block's threads' partial (popcount, attestation) sums, then the
    cluster's: `team_sum` of every pass that writes a table."""
    j = np.broadcast_to(_global_j(ta), ta.shape)
    pc = _popc(ta)
    whole = (j & (nb >> 5)) != 0
    bad = np.where(whole, pc, _popc(ta & _low_mask(nb))) if attest \
        else np.zeros_like(pc)
    tot_pc = tot_bad = 0
    for r in range(ta.shape[0]):
        flat_pc, flat_bad = pc[r].reshape(-1), bad[r].reshape(-1)
        for t in range(lanes):
            tot_pc += int(flat_pc[t::lanes].sum())
            tot_bad += int(flat_bad[t::lanes].sum())
    return tot_pc, tot_bad


def _complete(ta, rm):
    """The completion pass: word j takes word j | (rm >> 5) (0 where
    j & (rm >> 5)), then one shift and mask a set bit of rm & 31."""
    j = _global_j(ta)
    rh, rl = rm >> 5, rm & 31
    src = _word_at(ta, np.arange(ta.shape[1])[None, :, None], j | rh)
    v = np.where((j & rh) == 0, src, 0).astype(np.uint32)
    for b in range(5):
        if (rl >> b) & 1:
            v = (v >> np.uint32(1 << b)) & ~_M[b]
    return v


def _kernel_rows(model, s_lo, S, f, a, b):
    """`next_state` over every state: a numpy transcription of the row the
    kernel computes for an op (csrc/dense_walk.cu, via the models of
    csrc/sort_models.cuh)."""
    s = (np.arange(S, dtype=np.int64) + s_lo).astype(np.int32)
    legal, new = np_step(model, s, f, a, b)
    idx = new.astype(np.int64) - s_lo
    return np.where(legal & (idx >= 0) & (idx < S), idx, -1).astype(np.int16)


def _lists(strow, occ, S, P):
    """`list_sources`: for each state q the (s, p) with str[p][s] = q over
    occupied slots."""
    ent = [[] for _ in range(S)]
    for p in range(P):
        if (occ >> p) & 1:
            for s in range(S):
                if strow[p, s] >= 0:
                    ent[strow[p, s]].append((s, p))
    return ent


def _round(ta, ent):
    """One Jacobi round: in-word shift and mask from slots p < 5, a partner
    word j ^ 2^(p-5) (maybe another block's) from slots p >= 5."""
    j = _global_j(ta)[:, 0, :]
    out = ta.copy()
    for q, pairs in enumerate(ent):
        for s, p in pairs:
            if p < 5:
                out[:, q] |= (ta[:, s] << np.uint32(1 << p)) & _M[p]
            else:
                d = 1 << (p - 5)
                out[:, q] |= np.where((j & d) != 0, _word_at(ta, s, j ^ d),
                                      0).astype(np.uint32)
    return out


def _step_rows(x, b, e0, wend, warp):
    """The rows a key's walk reads, as the kernel reads them ahead: the
    warp 32 at a time (lane l holds step base + l, read by shuffle), the
    block tiers in chunks of 128 into two buffers, chunk k + 1 copied
    while chunk k is walked. Yields (e, row)."""
    if warp:
        base = e0
        lanes = {}
        for e in range(e0, wend):
            if e - base == 32 or not lanes:
                base = e
                lanes = {l: x[b, base + l] for l in range(32)
                         if base + l < wend}
            yield e, lanes[e - base]
    else:
        bufs = [None, None]

        def copy(k):
            lo = e0 + k * _ROW_CHUNK
            return x[b, lo:min(lo + _ROW_CHUNK, wend)].copy()

        bufs[0] = copy(0)
        for e in range(e0, wend):
            t = e - e0
            k = t // _ROW_CHUNK
            if t % _ROW_CHUNK == 0:
                bufs[(k + 1) & 1] = copy(k + 1)
            yield e, bufs[k & 1][t - k * _ROW_CHUNK]


def _emulate_launch(x, wend, sc, table, slots, occ, *, model, s_lo, attest,
                    steps, ranks=1, lanes=32, warp=True):
    """One K3 launch over a batch, as `dense_walk` computes it, on numpy
    inputs in the wrapper's layout; returns the wrapper's outputs (sc,
    table, slots, occ, out)."""
    B, S, C = table.shape
    P = C.bit_length() - 1
    sc, tbl = sc.copy(), table.astype(bool).copy()
    slots, occ = slots.copy(), occ.copy()
    out = np.zeros(2 * B + 1 + steps, np.int64)
    cmask = C - 1
    for b in range(B):
        e, att, count, maxc = (int(v) for v in sc[:, b])
        e0 = e
        ob = sum(1 << p for p in range(P) if occ[b, p])
        ta = _pack(tbl[b], ranks)
        strow = np.stack([_kernel_rows(model, s_lo, S, *slots[:, b, p])
                          for p in range(P)]) if P else np.zeros((0, S))
        nb = ~ob & cmask
        pc, bad = _team_sum(ta, nb, attest, lanes)
        rows = _step_rows(x, b, e0, int(wend[b]), warp)
        while e < wend[b] and count > 0:
            _e, row = next(rows)
            rm, inv = int(row[0]), int(row[1])
            if rm:
                ob &= ~rm
                nb = ~ob & cmask
                ta = _complete(ta, rm)
                pc, bad = _team_sum(ta, nb, attest, lanes)
            if inv >= 0:
                ob |= 1 << inv
                nb = ~ob & cmask
                slots[:, b, inv] = row[2:5]
                strow[inv] = _kernel_rows(model, s_lo, S, *row[2:5])
                ent = _lists(strow, ob, S, P)
                r = 0
                while True:
                    ta = _round(ta, ent)
                    npc, bad = _team_sum(ta, nb, attest, lanes)
                    r += 1
                    moved = npc != pc
                    pc = npc
                    if not moved:
                        break
                out[2 * B + 1 + e - e0] = max(out[2 * B + 1 + e - e0], r)
                out[2 * B] += r * sum(len(q) for q in ent)
            count = pc
            if attest:
                att = int(np.int32(np.uint32((att + bad) & 0xFFFFFFFF)))
            maxc = max(maxc, count)
            e += 1
        sc[:, b] = e, att, count, maxc
        tbl[b] = _unpack(ta, C)
        occ[b] = [(ob >> p) & 1 for p in range(P)]
        out[b], out[B + b] = e, count
    return sc, tbl, slots, occ, out


def _emulated_walk(k, x, stops, carry, window, **split):
    """`DenseKernel._walk_k3`'s window loop around the emulated launch
    (numpy in, numpy out); returns the carry, the rounds and the pair
    rounds."""
    e, table, sf, sa, sb, occ, att, count, maxc = (np.asarray(c) for c
                                                   in carry)
    B, T = x.shape[:2]
    sc = np.stack([e, att, count, maxc]).astype(np.int32)
    slots = np.stack([sf, sa, sb]).astype(np.int32)
    stops = np.minimum(np.asarray(stops, np.int64), T)
    total = pair_rounds = 0
    while True:
        active = (sc[0] < stops) & (sc[2] > 0)
        if not active.any():
            break
        wend = np.where(active, np.minimum(stops, sc[0] + window), sc[0])
        sc, table, slots, occ, out = _emulate_launch(
            x, wend, sc, table, slots, occ, model=k.model_name, s_lo=k.s_lo,
            attest=k.use_attest, steps=int((wend - sc[0]).max()), **split)
        np.testing.assert_array_equal(out[:B], sc[0])
        np.testing.assert_array_equal(out[B:2 * B], sc[2])
        total += int(out[2 * B + 1:].sum())
        pair_rounds += int(out[2 * B])
    return (sc[0], table, slots[0], slots[1], slots[2], occ, sc[1], sc[2],
            sc[3]), total, pair_rounds


def _assert_same(got, want, where):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      np.asarray(b).astype(np.int64),
                                      err_msg=f"{where} element {i}")


def _split(P, warp):
    """A tier's split of one key: the warp's 32 lanes, or a block's 256
    threads on up to four cluster ranks."""
    if warp:
        return {"ranks": 1, "lanes": 32, "warp": True}
    return {"ranks": min(4, 1 << max(P - 5, 0)), "lanes": 256,
            "warp": False}


@pytest.mark.parametrize("window", [1024, 7])
def test_emulated_kernel_matches_the_eager_batched_walk(window):
    """The batch on the warp tier (a window of 1,024 steps) and on the
    block tiers (7 steps, the keys' words split over cluster ranks)."""
    k, x, ns, init = _hazelcast_batch([70, 110, 40, 90], bad=(2,))
    xs = twgl.stage_steps(x, "cpu")
    start = k.init_carry_batch([init] * len(ns))
    k.rounds = 0
    want = carry_to_numpy(k.run_range_batch_eager(xs, ns, start))
    got, rounds, _pairs = _emulated_walk(k, x, ns, carry_to_numpy(start),
                                         window,
                                         **_split(k.P, window == 1024))
    _assert_same(got, want, f"window {window}")
    assert rounds == k.rounds > 0


@pytest.mark.parametrize("n,conc,crash,seed,bad", [
    (60, 2, 0.02, 1, False),        # P < 5: one word a row
    (120, 4, 0.03, 2, True),        # P = 4-6: in-word shifts
    (150, 6, 0.03, 4, False),       # P >= 7: word-XOR rounds too
    (200, 8, 0.02, 5, True)])
def test_emulated_kernel_matches_the_eager_walk(n, conc, crash, seed, bad,
                                               monkeypatch):
    """The emulated launches give the eager walk's carry and rounds, and
    their pair rounds (the closure's work, which the card's bound reads)
    are the eager rounds' listed transitions, the sum of each round's
    mft. The longer histories walk on the block tiers' split (words over
    cluster ranks, 128-step row buffers), the shorter on a warp's."""
    model = tmodels.cas_register()
    h = tsynth.register_history(n, concurrency=conc, values=4,
                                crash_rate=crash, seed=seed)
    if bad:
        h = tsynth.corrupt(h, seed=seed, value=4)
    ops = twgl.encode_ops_for_model(model, h)
    p = twgl.required_slots(ops)
    s_lo, S, P = twgl._dense_shape(twgl._state_range(
        "cas-register", model, [ops]), p)
    steps = twgl.build_steps(ops, P)
    k = twgl.DenseKernel("cas-register", s_lo, S, P, "cpu")
    init = model.device_state()
    xs = twgl.stage_steps(steps.x, "cpu")
    mid = steps.n // 2
    listed = []
    real = twgl.closure_round

    def counted(tb, mft):
        listed.append(int(mft.sum()))
        return real(tb, mft)

    monkeypatch.setattr(twgl, "closure_round", counted)
    for stops in ([steps.n], [mid, steps.n]):
        k.rounds = 0
        listed.clear()
        want = k.init_carry(init)
        got = carry_to_numpy(want)
        rounds = pairs = 0
        for stop in stops:
            want = k.run_range_eager(xs, stop, want)
            got, r, pr = _emulated_walk(
                k, steps.x[None], [stop],
                tuple(np.asarray(c)[None] for c in got), 16 if n < 150
                else 300, **_split(P, n < 150))
            got = tuple(np.asarray(c)[0] for c in got)
            rounds += r
            pairs += pr
        _assert_same(got, carry_to_numpy(want), f"stops {stops}")
        assert rounds == k.rounds == len(listed)
        assert pairs == sum(listed) > 0


# -- (c) the dense entries on the CPU against the JAX package ---------------

def _dense_corrupt(h, seed, value):
    """jsynth.corrupt with its phantom read set to `value`, one past the
    generator's values, so the state range stays dense."""
    h = jsynth.corrupt(h, seed=seed)
    for o in h.ops:
        if o["value"] == 10 ** 6:
            o["value"] = value
    return h


def _jax_setup(n, conc, seed, bad, pallas):
    h = jsynth.register_history(n, concurrency=conc, values=4,
                                crash_rate=0.03, seed=seed)
    if bad:
        h = _dense_corrupt(h, seed, 4)
    model = jmodels.cas_register()
    ops = jwgl.encode_ops_for_model(model, h)
    p = jwgl.required_slots(ops)
    dense = jwgl._dense_shape(jwgl._state_range("cas-register", model,
                                                [ops]), p)
    steps = jwgl.build_steps(ops, dense[2])
    E = jwgl._bucket(max(jwgl.event_count(ops), 1))
    jk = jwgl._dense_kernel_cached("cas-register", *dense, E, pallas, False,
                                   True)
    tk = twgl.DenseKernel("cas-register", *dense, "cpu")
    return steps, E, jk, tk, model.device_state()


def _same_as_jax(tc, jc, where):
    for i, (a, b) in enumerate(zip(carry_to_numpy(tc), jax.device_get(jc))):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} elem {i}")


@pytest.mark.parametrize("case", [(100, 3, 7, False, True),
                                  (140, 5, 8, True, False)])
def test_dense_chunks_and_stream_chunks_match_jax(case):
    steps, E, jk, tk, init = _jax_setup(*case)
    xj = jnp.asarray(steps.pad_to(E).x)
    xs = twgl.stage_steps(steps.x, "cpu")
    third = max(steps.n // 3, 1)
    jc, tc = jk.init_carry(jnp.int32(init)), tk.init_carry(init)
    for stop in (third, 2 * third, steps.n):
        jc = jk.check_chunk(xj, jnp.int32(stop), jc)
        tc = tk.check_chunk(xs, stop, tc)
        _same_as_jax(tc, jc, f"chunk to {stop}")
    # the streaming entry: each chunk's steps alone, e rebased
    chunk = 32
    pad = np.zeros((chunk, steps.x.shape[1]), np.int32)
    pad[:, 1] = -1
    jc, tc = jk.init_carry(jnp.int32(init)), tk.init_carry(init)
    for lo in range(0, steps.n, chunk):
        part = steps.x[lo:lo + chunk]
        n = len(part)
        buf = pad.copy()
        buf[:n] = part
        jc = jk.check_stream_chunk(jnp.asarray(buf), jnp.int32(n), jc)
        tc = tk.check_stream_chunk(twgl.stage_steps(buf, "cpu"), n, tc)
        _same_as_jax(tc, jc, f"stream chunk at {lo}")


def test_dense_batch_chunks_match_jax():
    model = jmodels.cas_register()
    hists = [jsynth.register_history(n, concurrency=4, values=5,
                                     crash_rate=0.005, seed=1000 + i)
             for i, n in enumerate((60, 100, 80))]
    hists[1] = _dense_corrupt(hists[1], 3, 5)
    pre = [jwgl.encode_ops_for_model(model, h) for h in hists]
    srange = jwgl._state_range("cas-register", model, pre)
    p = max(jwgl.required_slots(o) for o in pre)
    dense = jwgl._dense_shape(srange, p)
    steps = [jwgl.build_steps(o, dense[2]) for o in pre]
    E = jwgl._bucket(max(s.n for s in steps))
    x = np.stack([s.pad_to(E).x for s in steps])
    ns = np.array([s.n for s in steps], np.int32)
    jk = jwgl._dense_kernel_cached("cas-register", *dense, E, True, False,
                                   True)
    tk = twgl.DenseKernel("cas-register", *dense, "cpu")
    init = model.device_state()
    jc = jax.vmap(jk.init_carry)(jnp.full(len(ns), init, jnp.int32))
    tc = tk.init_carry_batch([init] * len(ns))
    xs = twgl.stage_steps(x, "cpu")
    for stop in (40, 80, E):
        st = np.minimum(ns, stop)
        jc = jk.check_chunk_batch(jnp.asarray(x), jnp.asarray(st), jc)
        tc = tk.check_chunk_batch(xs, st, tc)
        _same_as_jax(tc, jc, f"batch chunk to {stop}")


def test_walk_dispatch_runs_the_eager_walk_on_cpu_tensors(monkeypatch):
    """On CPU tensors the dense entries take K3's plain version and
    launch nothing; a carry on another device raises."""
    k, x, ns, init = _hazelcast_batch([40, 50])
    calls = []
    real = twgl.DenseKernel.run_range_batch_eager

    def spy(self, *a):
        calls.append(a)
        return real(self, *a)

    monkeypatch.setattr(twgl.DenseKernel, "run_range_batch_eager", spy)
    before = wgl_walk.LAUNCHES
    k.check_chunk_batch(twgl.stage_steps(x, "cpu"), ns,
                        k.init_carry_batch([init] * 2))
    assert len(calls) == 1 and wgl_walk.LAUNCHES == before
    meta = tuple(t.to("meta") for t in k.init_carry(init))
    with pytest.raises(ValueError):
        k.run_range(twgl.stage_steps(x[0], "cpu"), 10, meta)


def test_launch_refuses_tensors_off_cuda():
    k, x, ns, init = _hazelcast_batch([40])
    c = k.init_carry_batch([init])
    sc = torch.stack([c[0], c[6], c[7], c[8]])
    slots = torch.stack([c[2], c[3], c[4]])
    with pytest.raises(ValueError):
        wgl_walk.launch(torch.from_numpy(x), torch.zeros(1, dtype=torch.int32),
                        sc, c[1], slots, c[5], model="cas-register",
                        s_lo=k.s_lo, attest=True, steps=4)


def test_walk_windows_around_emulated_launches(monkeypatch):
    """`DenseKernel._walk_k3` and the engines' shared window loop
    (`_Engine._walk_windows`) around launches emulated on the CPU, with a
    window of 7 steps: the eager batched walk's carry and rounds, one host
    read to start and one a launch, and K3's counts moved by the rounds
    the launches reported."""
    k, x, ns, init = _hazelcast_batch([70, 110, 40, 90], bad=(2,))
    xs = twgl.stage_steps(x, "cpu")
    start = k.init_carry_batch([init] * len(ns))
    want = carry_to_numpy(k.run_range_batch_eager(xs, ns, start))
    eager_rounds = k.rounds
    launches = []

    def fake_launch(x, wend, sc, table, slots, occ, **kw):
        out = _emulate_launch(x.numpy(), wend.numpy(), sc.numpy(),
                              table.numpy(), slots.numpy(), occ.numpy(),
                              **kw)
        launches.append(kw)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in out)

    monkeypatch.setattr(wgl_walk, "launch", fake_launch)
    monkeypatch.setattr(wgl_walk, "WINDOW", 7)
    k.rounds, k.syncs = 0, 0
    rounds0 = wgl_walk.ROUNDS
    got = k._walk_k3(xs.dev, ns, start)
    _assert_same(carry_to_numpy(got), want, "walk windows")
    assert k.rounds == eager_rounds > 0
    assert wgl_walk.ROUNDS - rounds0 == k.rounds
    assert len(launches) > 1 and k.syncs == 1 + len(launches)
    assert all(kw["model"] == "cas-register" and kw["s_lo"] == k.s_lo
               and 1 <= kw["steps"] <= 7 for kw in launches)
    # no key with a step to walk: one read, no launch, None
    assert k._walk_k3(xs.dev, np.zeros(len(ns), np.int64), start) is None
    assert k.syncs == 2 + len(launches)


# -- one step of the bit-packed formulation, drawn, against eager and JAX ----

def _jax_step(S, P, s_lo, x, carry):
    """The JAX package's dense walk (its XLA formulation) over the steps of
    x from the carry's e, on the CPU."""
    E = x.shape[0]
    jk = jwgl._dense_kernel_cached("cas-register", s_lo, S, P, E, False,
                                   False, True)
    jc = tuple(jnp.asarray(c) for c in carry)
    return jax.device_get(jk.check_chunk(jnp.asarray(x), jnp.int32(E), jc))


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data(), S=st.integers(1, 12), P=st.integers(0, 12))
def test_drawn_bit_packed_steps_match_the_eager_walk_and_jax(data, S, P):
    """Two steps (a completion of drawn returned bits rm with a drawn
    invoke, then a drawn completion or invoke) from a drawn carry: a
    table of S x 2^P cells, drawn occupied slots and so drawn unoccupied
    bits, under every tier's split (a warp's lanes, a block's threads on
    1-8 cluster ranks): the emulated kernel's carry, rounds and pair
    rounds are the eager walk's, and its carry the JAX package's (from
    P = 1: its dense kernel indexes a slot)."""
    C = 1 << P
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 32 - 1)))
    s_lo = -1
    occ_bits = data.draw(st.integers(0, C - 1))
    table = rng.random((S, C)) < data.draw(st.sampled_from([0.02, 0.3]))
    # the carry's own invariant: no true cell holds an unoccupied bit
    cols = np.arange(C)
    table &= ((cols & ~occ_bits) == 0)[None, :]
    table[rng.integers(S), 0] = True
    occ = np.array([(occ_bits >> p) & 1 for p in range(P)], bool)
    slots = np.stack([rng.integers(0, 3, P), rng.integers(-1, S - 1, P),
                      rng.integers(-1, S - 1, P)]).astype(np.int32)
    x = np.zeros((2, 5), np.int32)
    x[:, 1] = -1
    for t in range(2):
        if P:
            x[t, 0] = data.draw(st.integers(0, C - 1)) & occ_bits
            if data.draw(st.booleans()):
                free = [p for p in range(P)
                        if not ((occ_bits & ~x[t, 0]) >> p) & 1]
                if free:
                    inv = data.draw(st.sampled_from(free))
                    x[t, 1] = inv
                    x[t, 2:5] = (rng.integers(0, 3), rng.integers(-1, S - 1),
                                 rng.integers(-1, S - 1))
                    occ_bits = (occ_bits & ~x[t, 0]) | (1 << inv)
                    continue
            occ_bits &= ~x[t, 0]
    count = int(table.sum())
    carry = (np.int32(0), table, slots[0], slots[1], slots[2], occ,
             np.int32(0), np.int32(count), np.int32(count))
    k = twgl.DenseKernel("cas-register", s_lo, S, P, "cpu")
    k.rounds = 0
    want = carry_to_numpy(k.run_range_eager(
        twgl.stage_steps(x, "cpu"), 2,
        tuple(torch.from_numpy(np.asarray(c)) for c in carry)))
    if P:   # the JAX package's dense kernel indexes a slot: P >= 1
        _assert_same(_jax_step(S, P, s_lo, x, carry), want, "JAX")
    nw = 1 << max(P - 5, 0)
    for split in ({"ranks": 1, "lanes": 32, "warp": True},
                  {"ranks": min(nw, data.draw(st.sampled_from([1, 2, 8]))),
                   "lanes": data.draw(st.sampled_from([32, 1024])),
                   "warp": False}):
        got, rounds, _pairs = _emulated_walk(
            k, x[None], [2], tuple(np.asarray(c)[None] for c in carry), 2,
            **split)
        _assert_same(tuple(np.asarray(c)[0] for c in got), want, str(split))
        assert rounds == k.rounds


@pytest.mark.parametrize("family", ["dense", "sort-packed", "sort-lex"])
def test_init_carry_batch_is_the_stacked_init_carry(family):
    """`init_carry_batch` builds the B keys' carries on the host and
    copies each element once: element for element (dtype, shape, value)
    the stacked `init_carry` of each key, on both families."""
    inits = [-1, 3, 0, 4, 2]
    if family == "dense":
        k = twgl.DenseKernel("cas-register", -1, 6, 4, "cpu")
    else:
        pack = (-1, 8) if family == "sort-packed" else None
        k = twgl.SortKernel("cas-register", 16, 40 if pack is None else 9,
                            pack, twgl.DEDUP_SORT, "cpu")
    got = k.init_carry_batch(inits)
    want = tuple(torch.stack(c) for c in zip(*(k.init_carry(s)
                                                for s in inits)))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), i


def test_build_command_and_c_interface():
    """K3 builds with the port's nvcc line from its own source and the
    models' header, with C entries for the launch and its plan that
    return the CUDA error, and is written by hand: its tiers keep the
    table on chip (no cooperative grid, no table in device memory) and
    no library kernel is on its path."""
    from jepsen_tpu_torch import _build
    assert "dense_walk" in _build.sources()
    cmd = _build.command("dense_walk", _build.lib_path("dense_walk"))
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1].endswith("csrc/dense_walk.cu")
    src = (_build.CSRC / "dense_walk.cu").read_text()
    for name in ('extern "C" int jt_dense_walk(',
                 'extern "C" int jt_dense_walk_plan(',
                 '#include "sort_models.cuh"', "cudaGetLastError",
                 "cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension",
                 "cudaOccupancyMaxActiveClusters", "map_shared_rank",
                 "__reduce_add_sync", "cp.async", "atomicMax"):
        assert name in src, name
    for banned in ("cudaLaunchCooperativeKernel", "this_grid", "scratch",
                   "__ldcg", "cub::", "thrust", "#include <cub",
                   "#include <torch", "closure_round.cuh"):
        assert banned not in src, banned
    assert wgl_walk.SOURCE == "jepsen_tpu_torch/csrc/dense_walk.cu"
    assert wgl_walk.REPLACES == "jepsen_tpu/checker/wgl.py:1150"
    assert wgl_walk.TIERS == ("warp", "block", "cluster")
    assert set(wgl_walk.TIER_LAUNCHES) == set(wgl_walk.TIERS)
