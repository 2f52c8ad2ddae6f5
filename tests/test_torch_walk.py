"""K3, the dense step walk (`checker/wgl_walk.py`, `csrc/dense_walk.cu`),
on the CPU: the kernel cannot run here, so these hold what it is built
on.

  * `transition_rows`, the next-state rows the wrapper hands the kernel,
    give exactly the transitions the eager walk builds for K1 (`mft`), for
    all six device models;
  * the round count K3 reports for a batch (the sum over lockstep steps
    of the max over the keys invoking there of each key's own rounds)
    equals the eager lockstep walk's;
  * the kernel's formulation, emulated in numpy (word-level completion,
    count and attestation, listed sources, Jacobi rounds on 16-byte chunks
    or cells, windows and the per-step round maxima), gives the eager
    walk's carries and rounds;
  * the dense entries on the CPU (`check_chunk`, `check_chunk_batch`,
    `check_stream_chunk`, which take the eager walk on CPU tensors) still
    give the JAX package's carries, element for element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import synth as jsynth
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.carry import carry_to_numpy
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl
from jepsen_tpu_torch.checker import wgl_walk
from jepsen_tpu_torch.history import NIL


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

def _popc(words):
    """__popc of each uint32."""
    w = np.ascontiguousarray(words, dtype="<u4")
    return np.unpackbits(w.view(np.uint8).reshape(*w.shape, 4),
                         axis=-1).sum(-1).astype(np.int64)


def _complete(ta, rm, P):
    """The completion gather as `complete_words` / `complete_cells`."""
    S, C = ta.shape
    if P < 4:
        c = np.arange(C)
        out = ta[:, c | rm].copy()
        out[:, (c & rm) != 0] = 0
        return out
    w = ta.view("<u4")                                   # (S, C / 4)
    rl, rh = rm & 3, rm >> 2
    k = np.arange(w.shape[1])
    src = w[:, k | rh]
    v = [src, (src >> 8) & 0x00FF00FF, src >> 16, src >> 24][rl]
    v = np.where(((k & rh) == 0)[None, :], v, 0).astype("<u4")
    return np.ascontiguousarray(v).view(np.uint8).reshape(S, C)


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


def _butterfly(w, p):
    z = np.zeros_like(w[..., 0])
    if p == 0:
        return (w << np.uint32(8)) & np.uint32(0xFF00FF00)
    if p == 1:
        return (w << np.uint32(16)) & np.uint32(0xFFFF0000)
    if p == 2:
        return np.stack([z, w[..., 0], z, w[..., 2]], axis=-1)
    return np.stack([z, z, w[..., 0], w[..., 1]], axis=-1)


def _round(ta, ent, P):
    """`round_chunks` / `round_cells`: one Jacobi round and whether any
    cell moved."""
    S, C = ta.shape
    if P < 4:
        c = np.arange(C)
        out = ta.copy()
        for q in range(S):
            for s, p in ent[q]:
                out[q] |= ta[s, c ^ (1 << p)] & ((c >> p) & 1).astype(
                    np.uint8)
        return out, bool((out != ta).any())
    nchunk = C >> 4
    words = ta.view("<u4").reshape(S, nchunk, 4)
    j = np.arange(nchunk)
    out = words.copy()
    for q in range(S):
        for s, p in ent[q]:
            if p < 4:
                out[q] |= _butterfly(words[s], p)
            else:
                take = ((j >> (p - 4)) & 1).astype(bool)
                out[q, take] |= words[s, j[take] ^ (1 << (p - 4))]
    out = out.reshape(S, C // 4).view(np.uint8).reshape(S, C)
    return out, bool((out != ta).any())


def _count(ta, nb, P, attest):
    """`count_words` / `count_cells`: (popcount, cells in bad columns)."""
    S, C = ta.shape
    if P < 4:
        c = np.arange(C)
        bad = int(ta[:, (c & nb) != 0].sum()) if attest else 0
        return int(ta.sum()), bad
    w = ta.view("<u4")
    pc = _popc(w)
    if not attest:
        return int(pc.sum()), 0
    low = (0xFF00FF00 if nb & 1 else 0) | (0xFFFF0000 if nb & 2 else 0)
    first = np.arange(w.shape[1]) << 2
    whole = (first & nb) != 0
    bad = np.where(whole[None, :], pc, _popc(w & np.uint32(low)))
    return int(pc.sum()), int(bad.sum())


def _emulate_launch(x, wend, itr, str0, sc, table, slots, occ, attest):
    """One K3 launch over a batch, as `dense_walk` computes it: numpy
    inputs in the wrapper's layout; returns the same outputs (the pair
    rounds as an int)."""
    B, S, C = table.shape
    P = C.bit_length() - 1
    sc, table = sc.copy(), table.astype(np.uint8).copy()
    slots, occ = slots.copy(), occ.copy()
    W = itr.shape[1]
    rounds = np.zeros(W, np.int32)
    pairs = 0
    for b in range(B):
        e, att, count, maxc = (int(v) for v in sc[:, b])
        e0 = e
        ta = table[b].copy()
        ob = sum(1 << p for p in range(P) if occ[b, p])
        strow = str0[b].astype(np.int64).copy()
        while e < wend[b] and count > 0:
            rm, inv = int(x[b, e, 0]), int(x[b, e, 1])
            if rm:
                ta = _complete(ta, rm, P)
                ob &= ~rm
            if inv >= 0:
                slots[:, b, inv] = x[b, e, 2:5]
                strow[inv] = itr[b, e - e0]
                ob |= 1 << inv
                ent = _lists(strow, ob, S, P)
                r = 0
                while True:
                    ta, moved = _round(ta, ent, P)
                    r += 1
                    if not moved:
                        break
                rounds[e - e0] = max(rounds[e - e0], r)
                pairs += r * sum(len(q) for q in ent)
            count, bad = _count(ta, ~ob & (C - 1), P, attest)
            if attest:
                att = int(np.int32(np.uint32((att + bad) & 0xFFFFFFFF)))
            maxc = max(maxc, count)
            e += 1
        sc[:, b] = e, att, count, maxc
        table[b] = ta
        occ[b] = [(ob >> p) & 1 for p in range(P)]
    return sc, table.astype(bool), slots, occ, rounds, pairs


def _emulated_walk(k, x, stops, carry, window):
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
        W = int((wend - sc[0]).max())
        idx = np.minimum(sc[0][:, None] + np.arange(W)[None, :], T - 1)
        rows = torch.from_numpy(x[np.arange(B)[:, None], idx])
        itr = wgl_walk.transition_rows(k.step, k.s_lo, k.S, rows[..., 2],
                                       rows[..., 3], rows[..., 4]).numpy()
        t = torch.from_numpy(slots)
        str0 = wgl_walk.transition_rows(k.step, k.s_lo, k.S, t[0], t[1],
                                        t[2]).numpy()
        sc, table, slots, occ, rounds, pairs = _emulate_launch(
            x, wend, itr, str0, sc, table, slots, occ, k.use_attest)
        total += int(rounds.sum())
        pair_rounds += pairs
    return (sc[0], table, slots[0], slots[1], slots[2], occ, sc[1], sc[2],
            sc[3]), total, pair_rounds


def _assert_same(got, want, where):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      np.asarray(b).astype(np.int64),
                                      err_msg=f"{where} element {i}")


@pytest.mark.parametrize("window", [1024, 7])
def test_emulated_kernel_matches_the_eager_batched_walk(window):
    k, x, ns, init = _hazelcast_batch([70, 110, 40, 90], bad=(2,))
    xs = twgl.stage_steps(x, "cpu")
    start = k.init_carry_batch([init] * len(ns))
    k.rounds = 0
    want = carry_to_numpy(k.run_range_batch_eager(xs, ns, start))
    got, rounds, _pairs = _emulated_walk(k, x, ns, carry_to_numpy(start),
                                         window)
    _assert_same(got, want, f"window {window}")
    assert rounds == k.rounds > 0


@pytest.mark.parametrize("n,conc,crash,seed,bad", [
    (60, 2, 0.02, 1, False),        # P <= 3: the cells path
    (120, 4, 0.03, 2, True),        # P = 4-6: chunks with butterflies
    (150, 6, 0.03, 4, False),       # P >= 7: chunk slots too
    (200, 8, 0.02, 5, True)])
def test_emulated_kernel_matches_the_eager_walk(n, conc, crash, seed, bad,
                                               monkeypatch):
    """The emulated launches give the eager walk's carry and rounds, and
    their pair rounds (the closure's work, which the card's bound reads)
    are the eager rounds' listed transitions, the sum of each round's
    mft."""
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
                tuple(np.asarray(c)[None] for c in got), 16)
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
    itr = torch.zeros((1, 4, k.S), dtype=torch.int16)
    str0 = torch.zeros((1, k.P, k.S), dtype=torch.int16)
    with pytest.raises(ValueError):
        wgl_walk.launch(torch.from_numpy(x), torch.zeros(1, dtype=torch.int32),
                        itr, str0, sc, c[1], slots, c[5], True)
