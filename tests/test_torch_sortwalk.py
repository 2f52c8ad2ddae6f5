"""K3-sort (the sort engine's step walk, `csrc/sort_walk.cu`) on the CPU,
where the kernel cannot run: its building blocks against the eager walk,
its plain version, and the JAX package's sort kernel.

  * a numpy transcription of `csrc/sort_models.cuh`'s six steps against
    the port's torch steps over a grid of (state, f, a, b) with
    wrap-around and NIL;
  * a numpy emulation of the kernel's formulation (the window loop, the
    per-step round maxima and invoke flags, the completion, stage A and B
    rows in the kernel's order, the hash dedup as a parallel insert with
    minimum-index ranks, the stable LSD radix sort with 8-bit digits,
    skipped constant digits, warp segments ranked by lane and the first-F
    rule)
    against `run_range_eager` / `run_range_batch_eager` and the JAX
    package's carries on every route: carries element for element, rounds
    and hash dedups equal;
  * the CPU dispatch taking the eager walk, and `wgl_sortwalk.launch`
    refusing tensors off CUDA.
"""

import itertools

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
from jepsen_tpu_torch.checker import wgl_dedup, wgl_sortwalk

M32 = 0xFFFFFFFF
NIL = -1
INT_MAX = 2 ** 31 - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(x):
    """Wrap an integer array to int32, as the kernel's uint32 arithmetic."""
    return (np.asarray(x, np.int64) & M32).astype(np.uint32).view(np.int32)


# -- the models: a numpy transcription of csrc/sort_models.cuh ---------------

def np_step(model, state, f, a, b):
    state, f, a, b = np.broadcast_arrays(
        *(np.asarray(v, np.int32) for v in (state, f, a, b)))
    if model in ("register", "cas-register"):
        legal = ((f == 0) & ((a == NIL) | (state == a))) | (f == 1)
        if model == "cas-register":
            cas_ok = (f == 2) & (state == a)
            legal = legal | cas_ok
            new = np.where(f == 1, a, np.where(cas_ok, b, state))
        else:
            new = np.where(f == 1, a, state)
    elif model == "mutex":
        new = np.where(f == 0, 1, 0)
        legal = ((f == 0) & (state == 0)) | ((f == 1) & (state == 1))
    elif model == "counter":
        new = np.where(f == 1, _i32(state.astype(np.int64) + a), state)
        legal = ((f == 0) & ((b == 0) | (state == a))) | (f == 1)
    elif model == "g-set":
        shift = np.clip(a, 0, 30)
        new = np.where(f == 1, state | _i32(np.int64(1) << shift), state)
        legal = ((f == 0) & ((a == NIL) | (state == a))) | (f == 1)
    else:
        shift = 4 * np.clip(a, 0, 6)
        cnt = (state >> shift) & 15
        ok_a = (a >= 0) & (a < 7)
        legal = np.where(f == 1, ok_a & (cnt < 15), ok_a & (cnt > 0))
        one = np.int64(1) << shift
        new = np.where(legal & (f == 1), _i32(state.astype(np.int64) + one),
                       np.where(legal & (f == 0),
                                _i32(state.astype(np.int64) - one), state))
    return legal.astype(bool), np.asarray(new, np.int32)


@pytest.mark.parametrize("model", wgl_sortwalk.MODELS)
def test_model_steps_match_the_torch_steps(model):
    """Every model id's step, over a grid with wrap-around and NIL, equals
    the torch step the eager walk runs, legal flag and new state, legal or
    not."""
    big = 2 ** 31 - 1
    states = [-big - 1, -big, -7, NIL, 0, 1, 2, 5, 0x0FFFFFF0, big - 3, big]
    fs = [0, 1, 2, 3]
    avals = [NIL, 0, 1, 3, 6, 7, 30, 31, -5, 2 ** 20, big]
    bvals = [NIL, 0, 1, 2, big]
    grid = np.array(list(itertools.product(states, fs, avals, bvals)),
                    np.int64).astype(np.int32).T
    legal, new = np_step(model, *grid)
    t = [torch.from_numpy(np.ascontiguousarray(g)) for g in grid]
    tl, tn = twgl.DEVICE_MODELS[model].step(*t)
    np.testing.assert_array_equal(legal, tl.numpy())
    np.testing.assert_array_equal(new, tn.numpy())


# -- the kernel's formulation -------------------------------------------------

def murmur(k):
    h = (k ^ (k >> 16)) & M32
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    h ^= h >> 16
    return h


def hash_dedup(keys, F, threads, rng):
    """The kernel's hash route on N int32 keys (EMPTY = -1): every key
    inserts (here in a random order, as atomics interleave), claims a slot
    by linear probing and records the minimum index there; the first
    occurrences are ranked by an exclusive scan over the threads'
    contiguous segments in input order. Returns (out keys of the first
    min(F, distinct) ranks with their input indices, distinct, the table's
    XOR)."""
    N = len(keys)
    H = wgl_dedup.table_size(N)
    table = np.full(H, -1, np.int64)
    first = np.full(H, INT_MAX, np.int64)
    pos = np.full(N, -1, np.int64)
    for i in rng.permutation(N):
        k = int(keys[i])
        if k == -1:
            continue
        h = murmur(k & M32) & (H - 1)
        while table[h] not in (-1, k):
            h = (h + 1) & (H - 1)
        table[h] = k
        first[h] = min(first[h], i)
        pos[i] = h
    flags = (pos >= 0) & (first[np.maximum(pos, 0)] == np.arange(N))
    per = -(-N // threads)
    seg = np.arange(N) // per
    c = np.bincount(seg, weights=flags, minlength=threads).astype(np.int64)
    start = np.cumsum(c) - c                     # the block scan
    rank = np.full(N, -1, np.int64)
    for t in np.nonzero(c)[0]:
        idx = np.nonzero(flags & (seg == t))[0]
        rank[idx] = start[t] + np.arange(len(idx))
    keep = np.nonzero(flags & (rank < F))[0]
    keep = keep[np.argsort(rank[keep])]
    xt = 0
    for v in table[table != -1]:
        xt ^= int(v) & M32
    return keys[keep], keep, int(flags.sum()), xt


def radix_order(words, threads):
    """The kernel's stable LSD radix sort of the row indices by the key
    words (N, kw) uint32, word 0 the most significant: 8-bit digits from
    the least significant word up, a digit skipped where every key has the
    same value; each pass counts the (digit, warp) pairs over the warps'
    contiguous segments of the order (a multiple of 32 rows each), takes
    one exclusive scan of them in digit-major order, and scatters each
    warp's rows 32 at a time to its pair's next place plus the row's rank
    among the lanes of its digit. Returns the order and the passes run."""
    N, kw = words.shape
    order = np.arange(N)
    passes = 0
    nw = threads // 32
    seg = -(-(-(-N // nw)) // 32) * 32
    warp = np.arange(N) // seg
    for k in reversed(range(kw)):
        col = words[:, k].astype(np.int64)
        diff = int(np.bitwise_and.reduce(col)) ^ int(np.bitwise_or.reduce(col))
        for d in range(0, 32, 8):
            if (diff >> d) & 255 == 0:
                continue
            dg = (col[order] >> d) & 255
            cnt = np.zeros((256, nw), np.int64)
            np.add.at(cnt, (dg, warp), 1)
            offs = (np.cumsum(cnt.reshape(-1)) - cnt.reshape(-1)) \
                .reshape(256, nw)
            dst = np.empty(N, np.int64)
            for b in range(0, N, 32):  # each warp's turns of 32 rows
                g = dg[b:b + 32]
                o = np.argsort(g, kind="stable")
                rank = np.empty(len(g), np.int64)   # among the lanes of g
                rank[o] = np.arange(len(g)) - np.searchsorted(g[o], g[o])
                dst[offs[g, warp[b]] + rank] = order[b:b + 32]
                np.add.at(offs[:, warp[b]], g, 1)
            order = dst
            passes += 1
    return order, passes


class Emu:
    """K3-sort's formulation on numpy arrays, one key at a time, window
    after window as `SortKernel._walk_k3s` launches it."""

    def __init__(self, k: twgl.SortKernel, threads=1024, window=None,
                 seed=0):
        self.k = k
        self.F, self.P, self.W = k.F, k.P, k.W
        self.route = k.route
        self.threads = threads
        self.window = window or wgl_sortwalk.window(k.F, k.P)
        self.rng = np.random.default_rng(seed)
        self.rounds = self.dedups = self.launches = 0
        self.overflowed_with_dup_head = False

    # -- one dedup --------------------------------------------------------
    def rows(self, fr, slots, occ, sa):
        """The N rows of a dedup in the kernel's order: (valid, state,
        mask words) each; stage A (sa >= 0) or stage B."""
        F, P, W = self.F, self.P, self.W
        m, s, v, n = fr
        if sa >= 0:
            fi = np.arange(F)
            pi = np.full(F, sa)
        else:
            fi = np.repeat(np.arange(F), P)
            pi = np.tile(np.arange(P), F)
        legal, ns = np_step(self.k.model_name, s[fi], slots[0][pi],
                            slots[1][pi], slots[2][pi])
        had = ((m[fi, pi >> 5].view(np.uint32) >> (pi & 31)) & 1) == 1
        cv = v[fi] & legal & ~had
        if sa < 0:
            cv &= n[fi] & occ[pi]
        cm = m[fi].copy()
        cm[np.arange(len(fi)), pi >> 5] = _i32(
            cm[np.arange(len(fi)), pi >> 5].view(np.uint32).astype(np.int64)
            | (np.int64(1) << (pi & 31)))
        return (np.concatenate([v, cv]), np.concatenate([s, ns]),
                np.concatenate([m, cm]))

    def dedup(self, valid, state, masks):
        F, P = self.F, self.P
        N = len(valid)
        k = self.k
        if self.route == "hash":
            key = np.where(valid, _i32((state.astype(np.int64) - k.s_lo)
                                       << P | masks[:, 0].view(np.uint32)),
                           -1).astype(np.int64)
            out, src, distinct, xt = hash_dedup(key, F, self.threads,
                                                self.rng)
            ok = out >= 0
            safe = np.where(ok, out, 0)
            m = np.zeros((F, 1), np.int32)
            s = np.full(F, k.s_lo, np.int32)
            v = np.zeros(F, bool)
            nw = np.zeros(F, bool)
            r = len(out)
            m[:r, 0] = safe & ((1 << P) - 1)
            s[:r] = _i32((safe >> P) + k.s_lo)
            v[:r] = ok
            nw[:r] = ok & (src >= F)
            xo = 0
            for x in safe:
                xo ^= int(x) & M32
            mism = int(k.use_attest and xo != xt and distinct <= F)
            self.dedups += 1
            return (m, s, v, nw), distinct > F, mism
        if self.route == "packed":
            key = ((np.where(valid, 0, 1 << 31)
                    | ((((state.astype(np.int64) - k.s_lo) & M32) << P) & M32)
                    | (masks[:, 0].view(np.uint32).astype(np.int64)))
                   & M32)
            words = key[:, None].astype(np.uint32)
        else:
            words = np.concatenate(
                [(~valid).astype(np.uint32)[:, None], masks.view(np.uint32),
                 (state.view(np.uint32) ^ np.uint32(1 << 31))[:, None]], 1)
        order, _passes = radix_order(words, self.threads)
        ws = words[order]
        fst = np.ones(N, bool)
        fst[1:] = (ws[1:] != ws[:-1]).any(1)
        # valid rows sort first: the first-of-run and overflow tests look
        # at the first max(F, V) positions only
        V = int(valid.sum())
        assert not (ws[V:, 0] >> np.uint32(31 if self.route == "packed"
                                            else 0) == 0).any()
        vs = fst & (np.arange(N) < V)
        vs[max(F, V):] = False
        if self.route == "packed":
            head = ws[:F, 0].astype(np.int64)
            m = (head & ((1 << P) - 1)).astype(np.int32)[:, None]
            s = _i32(((head >> P) & ((1 << k.sb_bits) - 1)) + k.s_lo)
        else:
            m, s = masks[order[:F]], state[order[:F]]
        v = vs[:F]
        ovf = bool(vs[F:].any())
        if ovf and not fst[:F].all():
            self.overflowed_with_dup_head = True
        return (m, s, v, v & (order[:F] >= F)), ovf, 0

    # -- one key's steps ----------------------------------------------------
    def key_steps(self, x, c, wend):
        """Walk one key's steps [e, wend) in place; returns its rounds of
        each step walked (-1 for a step without an invoke)."""
        F, P, W = self.F, self.P, self.W
        out = []
        while c["e"] < wend and c["count"] > 0:
            row = x[c["e"]]
            rm = row[:W].view(np.uint32)
            m, s, v = c["masks"], c["states"], c["valid"]
            if rm.any():
                mu = m.view(np.uint32)
                v = v & ((mu & rm) == rm).all(1)
                m = (mu & ~rm).view(np.int32)
                for p in range(P):
                    if (int(rm[p >> 5]) >> (p & 31)) & 1:
                        c["occ"][p] = False
            slot = int(row[W])
            fr = (m, s, v, np.zeros(F, bool))
            rounds = -1
            if slot >= 0:
                c["slots"][:, slot] = row[W + 1:W + 4]
                c["occ"][slot] = True
                rounds = 0
                for stage in itertools.count():
                    sa = slot if stage == 0 else -1
                    valid, state, masks = self.rows(fr, c["slots"],
                                                    c["occ"], sa)
                    if stage > 0 and not valid[F:].any():
                        break
                    fr, ovf, mism = self.dedup(valid, state, masks)
                    c["ovf"] |= ovf
                    c["att"] = int(_i32(c["att"] + mism))
                    rounds += stage > 0
            m, s, v = fr[0], fr[1], fr[2]
            c["masks"], c["states"], c["valid"] = m, s, v
            if self.k.use_attest:
                occw = np.zeros(W, np.int64)
                for p in np.nonzero(c["occ"])[0]:
                    occw[p >> 5] |= 1 << (p & 31)
                bad = v & ((m.view(np.uint32).astype(np.int64)
                            & ~occw & M32) != 0).any(1)
                c["att"] = int(_i32(c["att"] + int(bad.sum())))
            c["count"] = int(v.sum())
            c["maxc"] = max(c["maxc"], c["count"])
            c["e"] += 1
            out.append(rounds)
        return out

    def walk(self, x, stops, carry):
        """The batched walk of a (B, T, W+4) step matrix from a batched
        numpy carry: launches of up to `window` steps per key, each
        launch's rounds the max over the keys invoking at a window step,
        its hash dedups one per step with an invoking key plus one a
        round."""
        (e, masks, states, valid, sf, sa_, sb, occ, ovf, att, count,
         maxc) = (np.array(a) for a in carry)
        B, T = x.shape[0], x.shape[1]
        masks = masks.astype(np.uint32).view(np.int32)   # the carry's words
        keys = [dict(e=int(e[b]), masks=masks[b], states=states[b],
                     valid=valid[b], slots=np.stack([sf[b], sa_[b], sb[b]]),
                     occ=occ[b].copy(), ovf=bool(ovf[b]), att=int(att[b]),
                     count=int(count[b]), maxc=int(maxc[b]))
                for b in range(B)]
        stops = np.minimum(np.asarray(stops), T)
        while True:
            active = [c["e"] < stops[b] and c["count"] > 0
                      for b, c in enumerate(keys)]
            if not any(active):
                break
            self.launches += 1
            iter_rounds = np.zeros(self.window, np.int64)
            iter_inv = np.zeros(self.window, bool)
            for b, c in enumerate(keys):
                wend = min(stops[b], c["e"] + self.window) if active[b] \
                    else c["e"]
                for w, r in enumerate(self.key_steps(x[b], c, wend)):
                    if r >= 0:
                        iter_rounds[w] = max(iter_rounds[w], r)
                        iter_inv[w] = True
            self.rounds += int(iter_rounds.sum())
        return tuple(np.stack([c[k] for c in keys]) for k in (
            "e", "masks", "states", "valid")) + tuple(
            np.stack([c["slots"][i] for c in keys]) for i in range(3)) + \
            tuple(np.asarray([c[k] for c in keys]) for k in (
                "occ", "ovf", "att", "count", "maxc"))


def _emulate(emu, xs, stops, carry):
    """Run the emulation on a batched numpy carry; returns its carry with
    the walk's numpy dtypes."""
    out = emu.walk(xs, stops, carry)
    e, masks, states, valid, sf, sa, sb, occ, ovf, att, count, maxc = out
    return (e.astype(np.int32), masks.astype(np.int32).view(np.uint32),
            states.astype(np.int32), valid.astype(bool),
            sf.astype(np.int32), sa.astype(np.int32), sb.astype(np.int32),
            occ.astype(bool), ovf.astype(bool), att.astype(np.int32),
            count.astype(np.int32), maxc.astype(np.int32))


def _same(a, b, where):
    assert len(a) == len(b) == 12
    for i, (u, v) in enumerate(zip(a, b)):
        u, v = np.asarray(u), np.asarray(v)
        assert u.dtype == v.dtype and u.shape == v.shape, (where, i, u.dtype,
                                                           v.dtype, u.shape,
                                                           v.shape)
        np.testing.assert_array_equal(u, v, err_msg=f"{where} element {i}")


def _corrupt(h, seed=7, value=10 ** 6):
    """One ok read set to a value never current (the port's
    `synth.corrupt`, with the value chosen)."""
    import random
    ops = [dict(o) for o in h.ops]
    reads = [i for i, o in enumerate(ops)
             if o["type"] == "ok" and o["f"] == "read"]
    ops[random.Random(seed).choice(reads)]["value"] = value
    return jsynth.History(ops)


def _reg(n=150, conc=4, seed=0, crash=0.02, values=4):
    return jsynth.register_history(n, concurrency=conc, values=values,
                                   crash_rate=crash, seed=seed)


# label -> (model, history, F, slots, route); the route names what the
# kernel runs: hash (K2's contract), packed (one sorted uint32 key), lex
CASES = {
    "hash": ("cas_register", lambda: _corrupt(_reg(seed=1), seed=1,
                                                    value=9), 16, 8, "hash"),
    "hash-counter": ("counter", lambda: jsynth.counter_history(120, seed=2),
                     32, 8, "hash"),
    "hash-overflow": ("cas_register", lambda: _reg(conc=5, seed=3,
                                                   crash=0.05), 4, 16,
                      "hash"),
    "packed": ("cas_register", lambda: _reg(seed=5), 16, 16, "packed"),
    "packed-overflow": ("cas_register", lambda: _reg(conc=5, crash=0.05),
                        8, 16, "packed"),
    "lex-32": ("cas_register", lambda: _corrupt(_reg(seed=2), seed=2),
               16, 32, "lex"),
    "lex-40": ("cas_register", lambda: _reg(n=60, seed=4), 16, 40, "lex"),
    "lex-overflow": ("cas_register", lambda: _reg(conc=6, crash=0.05), 8,
                     32, "lex"),
    "lex-queue": ("unordered_queue", lambda: jsynth.uqueue_history(
        80, seed=1), 16, 8, "lex"),
}


def _kernels(label):
    """(JAX kernel, port kernel, steps, init) of a case, the port's
    SortKernel built directly at the case's F and route."""
    mname, mk, F, P, route = CASES[label]
    model = getattr(jmodels, mname)()
    name = model.device_model
    ops = jwgl.encode_ops_for_model(model, mk())
    srange = jwgl._state_range(name, model, [ops])
    pack = jwgl._pack_params(srange, P) if route != "lex" else None
    steps = jwgl.build_steps(ops, P)
    E = jwgl._bucket(max(jwgl.event_count(ops), 1))
    use_hash = route == "hash"
    jk = jwgl._kernel_cached(name, F, P, E, pack, use_hash, False, True)
    tk = twgl.SortKernel(name, F, P, pack,
                         twgl.DEDUP_PALLAS if use_hash else twgl.DEDUP_SORT,
                         "cpu")
    assert tk.route == route
    return jk, tk, steps, E, model.device_state()


@pytest.mark.parametrize("label", list(CASES))
def test_emulated_kernel_matches_the_eager_walk_and_jax(label):
    """The kernel's formulation, over windows of 7 steps and 64 emulated
    threads (so segments hold several rows), gives the eager walk's carry
    after every chunk, element for element, the eager walk's rounds and
    hash dedups, and the JAX package's carry."""
    jk, tk, steps, E, init = _kernels(label)
    emu = Emu(tk, threads=64, window=7, seed=len(label))
    ec = tuple(np.asarray(t)[None] for t in carry_to_numpy(
        tk.init_carry(init)))
    tc = tk.init_carry(init)
    jc = jk.init_carry(jnp.int32(init))
    xs = twgl.stage_steps(steps.x, "cpu")
    xj = jnp.asarray(steps.pad_to(E).x)
    chunk = max(steps.n // 3, 1)
    for stop in list(range(chunk, steps.n, chunk)) + [steps.n]:
        ec = _emulate(emu, steps.x[None], [stop], ec)
        tc = tk.run_range_eager(xs, stop, tc)
        jc = jk.check_chunk(xj, jnp.int32(stop), jc)
        want = carry_to_numpy(tc)
        _same(tuple(a[0] for a in ec), want, f"{label} to {stop}")
        _same(tuple(np.asarray(a) for a in jc), want, f"jax to {stop}")
    assert emu.rounds == tk.rounds > 0
    assert emu.dedups == tk.dedups
    assert (tk.dedups > 0) == (label.startswith("hash"))
    assert emu.launches > 1
    if label.endswith("overflow"):
        assert bool(want[8])
    if label in ("packed-overflow", "lex-overflow"):
        # the sorted head kept duplicates (invalid rows) while a valid
        # first-of-run sat past F
        assert emu.overflowed_with_dup_head


def test_hash_dedups_counted_from_rounds_and_invokes():
    """The wrapper's hash-dedup count, one a step with an invoke plus one a
    round of that step (the max over keys), is the eager walk's."""
    jk, tk, steps, E, init = _kernels("hash-counter")
    tc = tk.run_range_eager(twgl.stage_steps(steps.x, "cpu"), steps.n,
                            tk.init_carry(init))
    emu = Emu(tk, threads=32, window=5)
    per_step = []
    real = emu.key_steps

    def spy(xb, c, wend):
        out = real(xb, c, wend)
        per_step.extend(out)
        return out

    emu.key_steps = spy
    ec = _emulate(emu, steps.x[None], [steps.n], tuple(
        np.asarray(t)[None] for t in carry_to_numpy(tk.init_carry(init))))
    _same(tuple(a[0] for a in ec), carry_to_numpy(tc), "hash-counter")
    inv = np.asarray(per_step) >= 0
    rounds = np.maximum(np.asarray(per_step), 0)
    assert int((inv * (1 + rounds)).sum()) == tk.dedups == emu.dedups
    assert int(rounds.sum()) == tk.rounds


def _batch(label, B=5):
    """A batch of B keys of a case's model, route, F and slots, built as
    the batch entry builds it (the port's encoding, steps and stacking)."""
    mname, _mk, F, P, route = CASES[label]
    model = getattr(tmodels, mname)()
    name = model.device_model
    if mname == "counter":
        hists = [tsynth.counter_history(60 + 17 * i, seed=40 + i)
                 for i in range(B)]
        hists[2] = tsynth.corrupt(hists[2], value=99)
    else:
        hists = [tsynth.register_history(60 + 20 * i, concurrency=4,
                                         values=4, crash_rate=0.02,
                                         seed=50 + i) for i in range(B)]
        hists[3] = tsynth.corrupt(hists[3], seed=3, value=9)
    pre = [twgl.encode_ops_for_model(model, h) for h in hists]
    srange = twgl._state_range(name, model, pre)
    pack = twgl._pack_params(srange, P) if route != "lex" else None
    x, ns = twgl._stack_steps([twgl.build_steps(o, P) for o in pre], B)
    tk = twgl.SortKernel(name, F, P, pack,
                         twgl.DEDUP_PALLAS if route == "hash"
                         else twgl.DEDUP_SORT, "cpu")
    assert tk.route == route
    return tk, np.asarray(x), np.asarray(ns), model.device_state(), B


@pytest.mark.parametrize("label", ["hash-counter", "packed", "lex-32"])
def test_emulated_batch_matches_the_eager_lockstep_walk(label):
    """A batch of keys with different stops, one dying mid-walk: each
    launch's round count is the max over the keys invoking at a window
    step, and the sums are the eager lockstep walk's rounds and hash
    dedups; the batched carry equals the eager walk's element for
    element."""
    tk, x, ns, init, B = _batch(label)
    te = twgl.SortKernel(tk.model_name, tk.F, tk.P,
                         None if not tk.packed else (tk.s_lo, tk.sb_bits),
                         tk.dedup_route, "cpu")
    emu = Emu(te, threads=32, window=9)
    xs = twgl.stage_steps(x, "cpu")
    tc = tk.init_carry_batch([init] * B)
    ec = carry_to_numpy(tc)
    per = {}
    real = emu.key_steps

    def spy(xb, c, wend):
        out = real(xb, c, wend)
        for w, r in enumerate(out):
            if r >= 0:
                k = (emu.launches, w)
                per[k] = max(per.get(k, 0), r)
        return out

    emu.key_steps = spy
    for stop in (int(ns.max()) // 2, int(ns.max())):
        st = np.minimum(ns, stop)
        ec = _emulate(emu, x, st, ec)
        tc = tk.run_range_batch_eager(xs, st, tc)
        _same(ec, carry_to_numpy(tc), f"{label} batch to {stop}")
    assert emu.rounds == tk.rounds > 0
    if label.startswith("hash"):
        assert sum(1 + r for r in per.values()) == tk.dedups
    assert (carry_to_numpy(tc)[10] == 0).sum() >= 1


@pytest.mark.parametrize("label", ["hash-counter", "packed-overflow",
                                   "lex-32"])
def test_walk_windows_around_emulated_launches(label, monkeypatch):
    """`SortKernel._walk_k3s` and the engines' shared window loop
    (`_Engine._walk_windows`) around launches emulated on the CPU (the
    emulation's steps of each key, windows of 7): the eager walk's carry,
    rounds and hash dedups, one host read to start and one a launch, and
    the wrapper's counts moved by what the launches reported."""
    tk, x, ns, init, B = _batch(label)
    te = twgl.SortKernel(tk.model_name, tk.F, tk.P,
                         None if not tk.packed else (tk.s_lo, tk.sb_bits),
                         tk.dedup_route, "cpu")
    emu = Emu(te, threads=64)
    launches = []

    def fake_launch(x, wend, sc, masks, states, valid, slots, occ, *,
                    steps, **_kw):
        sc, masks, states, valid, slots, occ = (
            t.numpy().copy() for t in (sc, masks, states, valid, slots, occ))
        rounds, inv = np.zeros(steps, np.int32), np.zeros(steps, np.int32)
        for b in range(masks.shape[0]):
            c = dict(e=int(sc[0, b]), att=int(sc[1, b]),
                     count=int(sc[2, b]), maxc=int(sc[3, b]),
                     ovf=bool(sc[4, b]), masks=masks[b], states=states[b],
                     valid=valid[b], slots=slots[:, b], occ=occ[b])
            out = emu.key_steps(x[b].numpy(), c, int(wend[b]))
            for w, r in enumerate(out):
                if r >= 0:
                    rounds[w] = max(rounds[w], r)
                    inv[w] = 1
            sc[:, b] = c["e"], c["att"], c["count"], c["maxc"], c["ovf"]
            masks[b], states[b], valid[b] = (c["masks"], c["states"],
                                             c["valid"])
        launches.append(1)
        return tuple(torch.from_numpy(a) for a in (
            sc, masks, states, valid, slots, occ, rounds, inv)) + (
            torch.zeros(2, dtype=torch.int64),)

    monkeypatch.setattr(wgl_sortwalk, "launch", fake_launch)
    monkeypatch.setattr(wgl_sortwalk, "window", lambda F, P: 7)
    xs = twgl.stage_steps(x, "cpu")
    start = tk.init_carry_batch([init] * B)
    want = carry_to_numpy(tk.run_range_batch_eager(xs, ns, start))
    rounds, dedups = tk.rounds, tk.dedups
    tk.rounds = tk.dedups = tk.syncs = 0
    r0, d0 = wgl_sortwalk.ROUNDS, wgl_sortwalk.DEDUPS
    got = tk._walk_k3s(xs.dev, ns, start)
    _same(carry_to_numpy(got), want, label)
    assert tk.rounds == rounds > 0 and tk.dedups == dedups
    assert (wgl_sortwalk.ROUNDS - r0, wgl_sortwalk.DEDUPS - d0) == (
        rounds, dedups)
    assert len(launches) > 1 and tk.syncs == 1 + len(launches)
    assert tk._walk_k3s(xs.dev, np.zeros(B, np.int64), start) is None


def test_cpu_dispatch_takes_the_eager_walk(monkeypatch):
    """On CPU tensors the sort entries take K3-sort's plain version and
    launch nothing; a carry on another device raises."""
    jk, tk, steps, E, init = _kernels("hash")
    calls = []
    for name in ("run_range_eager", "run_range_batch_eager"):
        real = getattr(twgl.SortKernel, name)

        def spy(self, *a, _real=real, _name=name):
            calls.append(_name)
            return _real(self, *a)

        monkeypatch.setattr(twgl.SortKernel, name, spy)
    before = wgl_sortwalk.LAUNCHES
    xs = twgl.stage_steps(steps.x, "cpu")
    tk.check_chunk(xs, steps.n, tk.init_carry(init))
    tk.check_chunk_batch(twgl.stage_steps(steps.x[None], "cpu"), [steps.n],
                         tk.init_carry_batch([init]))
    tk.check_stream_chunk(xs, steps.n, tk.init_carry(init))
    assert calls == ["run_range_eager", "run_range_batch_eager",
                     "run_range_eager"]
    assert wgl_sortwalk.LAUNCHES == before
    meta = tuple(t.to("meta") for t in tk.init_carry(init))
    with pytest.raises(ValueError):
        tk.run_range(xs, 10, meta)


def test_launch_refuses_tensors_off_cuda():
    jk, tk, steps, E, init = _kernels("hash")
    c = tk.init_carry_batch([init])
    sc = torch.stack([c[0], c[9], c[10], c[11], c[8].to(torch.int32)])
    slots = torch.stack([c[4], c[5], c[6]])
    with pytest.raises(ValueError):
        wgl_sortwalk.launch(
            torch.from_numpy(steps.x[None]), torch.zeros(1, dtype=torch.int32),
            sc, c[1], c[2], c[3], slots, c[7], model=tk.model_name,
            route="hash", s_lo=tk.s_lo, sb_bits=tk.sb_bits, attest=True,
            steps=4)


def test_window_sizes_follow_the_dedup_rows():
    """A launch walks up to 1,024 steps at the main path's F = 256 (P = 8,
    16, 32), fewer as the escalated frontiers' rows grow, never none."""
    assert [wgl_sortwalk.window(256, p) for p in (8, 16, 32)] == [1024] * 3
    assert wgl_sortwalk.window(1024, 16) < 1024
    assert wgl_sortwalk.window(65536, 16) >= 1
    assert wgl_sortwalk.window(1 << 20, 256) == 1


def test_build_command_and_c_interface():
    """K3-sort builds with the port's nvcc line from its own source and
    the two headers it includes, with a C entry that returns the launch's
    CUDA error, and is written by hand: no library kernel on its path."""
    from jepsen_tpu_torch import _build
    assert "sort_walk" in _build.sources()
    cmd = _build.command("sort_walk", _build.lib_path("sort_walk"))
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1].endswith("csrc/sort_walk.cu")
    src = "".join((_build.CSRC / n).read_text() for n in (
        "sort_walk.cu", "sort_models.cuh", "dedup.cuh"))
    for name in ('extern "C" int jt_sort_walk(',
                 'extern "C" int jt_sort_walk_plan(', '#include "dedup.cuh"',
                 '#include "sort_models.cuh"', "cudaGetLastError",
                 "atomicCAS", "atomicMin", "atomicMax"):
        assert name in src, name
    for banned in ("cub::", "thrust", "#include <cub", "#include <torch"):
        assert banned not in src
    assert wgl_sortwalk.SOURCE == "jepsen_tpu_torch/csrc/sort_walk.cu"
    assert wgl_sortwalk.REPLACES == "jepsen_tpu/checker/wgl.py:864"
