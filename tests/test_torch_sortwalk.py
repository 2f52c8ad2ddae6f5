"""K3-sort (the sort engine's step walk, `csrc/sort_walk.cu`) on the CPU,
where the kernel cannot run: its building blocks against the eager walk,
its plain version, and the JAX package's sort kernel.

  * a numpy transcription of `csrc/sort_models.cuh`'s six steps against
    the port's torch steps over a grid of (state, f, a, b) with
    wrap-around and NIL;
  * a numpy emulation of the kernel's formulation (the window loop, the
    per-step round maxima and invoke flags, the completion, stage A and B
    rows in the kernel's order, the hash dedup as a parallel insert with
    minimum-index ranks, and the sort routes' select-then-sort: the side
    and shared bits from the row build, the bucket's 8-bit histograms and
    threshold refinement over every row, compacted lists and block-local
    lists, ties by row, the compaction in row order with every digit
    counted in one read, the LSD passes over the selected rows only, their
    tiles placed by look-back and ranked by digit, skipped constant
    digits, and the first-of-run rule)
    against `run_range_eager` / `run_range_batch_eager` and the JAX
    package's carries on every route: carries element for element, rounds
    and hash dedups equal;
  * the emulated select-then-sort dedup alone against the port's plain
    dedups (`SortKernel._dedup_packed`, `_dedup_lex`) on hypothesis-drawn
    rows: ties straddling position F - 1, V below, at and above F, no
    valid row, N <= F, a bucket that needs every digit, constant digits,
    two-word lexicographic keys with states of both signs;
  * the CPU dispatch taking the eager walk, and `wgl_sortwalk.launch`
    refusing tensors off CUDA.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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


K_LOCAL = 4096    # csrc/sort_walk.cu's kLocal: a bucket list each block refines
# csrc/sort_walk.cu's kRankGrid, kRankBlock, kRankWords: the selected rows
# a team ranks by counting instead of sorting by radix passes
K_RANK_GRID, K_RANK_BLOCK, K_RANK_WORDS = 4096, 1024, 16384
INT_MAX_ROW = 2 ** 31 - 1


def sort_key_words(route, valid, state, masks, s_lo=0, P=0):
    """The kernel's key words of N rows, (N, kw) uint32, word 0 the most
    significant (the invalid bit, then packed: the key's other 31 bits;
    lex: the mask words and the state with its sign flipped), and its sort
    words (packed: the whole key; lex: the key words)."""
    valid = np.asarray(valid, bool)
    if route == "packed":
        key = ((np.where(valid, 0, 1 << 31)
                | ((((np.asarray(state, np.int64) - s_lo) & M32) << P)
                   & M32)
                | (np.asarray(masks)[:, 0].view(np.uint32)
                   .astype(np.int64))) & M32)
        return (np.stack([key >> 31, key & 0x7FFFFFFF], 1).astype(np.int64),
                key[:, None].astype(np.int64))
    words = np.concatenate(
        [(~valid).astype(np.int64)[:, None],
         np.asarray(masks).view(np.uint32).astype(np.int64),
         (np.asarray(state).view(np.uint32) ^ np.uint32(1 << 31))
         .astype(np.int64)[:, None]], 1)
    return words, words


def prefix_cmp(words, thr, kd, lo):
    """Each row's key against the threshold's known bits (words [0, kd)
    and the bits >= lo of word kd): -1 below, 0 in the bucket, 1 above."""
    n, kw = words.shape
    res = np.zeros(n, np.int64)
    open_ = np.ones(n, bool)
    cols = [(words[:, k], thr[k]) for k in range(min(kd, kw))]
    if kd < kw and lo < 32:
        cols.append((words[:, kd] >> lo, thr[kd] >> lo))
    for a, t in cols:
        res[open_ & (a < t)] = -1
        res[open_ & (a > t)] = 1
        open_ &= a == t
    return res


def _below(lo):
    return M32 if lo >= 32 else (1 << lo) - 1


def _take_shared(thr, kd, lo, o, a):
    """The threshold takes the bits a bucket's rows share below bit lo of
    word kd (their OR o and AND a); returns the new lo."""
    diff = (o ^ a) & _below(lo)
    if diff == 0:
        thr[kd] |= o & _below(lo)
        return 0
    top = diff.bit_length() - 1
    thr[kd] |= o & _below(lo) & ~((2 << top) - 1) & M32
    return top + 1


def _or_and(v):
    v = np.asarray(v, np.int64)
    return (int(np.bitwise_or.reduce(v)) if len(v) else 0,
            int(np.bitwise_and.reduce(v)) if len(v) else M32)


def float_digit(v, lo):
    """The kernel's floating digit of words v below bit lo: w = v's bits
    below lo, w itself under 8, else (h - 2) * 8 plus the 3 bits under
    w's top set bit h."""
    w = np.asarray(v, np.int64) & _below(lo)
    h = np.array([int(x).bit_length() - 1 for x in w], np.int64)
    return np.where(w < 8, w, (h - 2) * 8 + ((w >> np.maximum(h - 3, 0)) & 7))


def _digit_prefix(kind, d, lo2):
    """(bits of the word a digit fixes, its new lo)."""
    if kind == 0:
        return d << lo2, lo2
    if d < 8:
        return d, 0
    h = d // 8 + 2
    return (1 << h) | ((d & 7) << (h - 3)), h - 3


def select_first(words, V, F, local=K_LOCAL):
    """The kernel's selection of the rows at the first F positions of the
    stable order by the key words (N > F): the side of position F - 1 from
    V and the bits its rows share from the ORs of word 1; then, level by
    level below the known bits, the bucket's histograms of two digits (a
    fixed 8-bit window, and a floating digit: the top set bit of the
    remaining bits and 3 bits under it), the digit whose bin holding the
    position still needed is smaller taken, until the bucket is all in or
    the key runs out (equal keys then go lowest row first). The first
    histogram reads every row (the row build's, of the floating digit
    alone, where the side shares only zeros above its differing bits),
    later ones a list compacted in row order; a
    bucket of at most `local` rows is finished by each block alone,
    compacted in place, taking the bits the kept rows share after each
    level and a new word's shared bits as it is loaded. Returns (selected
    flags, overflow, rows the histograms read)."""
    N, kw = words.shape
    side = 0 if V >= F else 1
    need = F if side == 0 else F - V
    nb = nl = N - V if side else V
    thr = [0] * kw
    thr[0] = side
    kd, lst, cut = 1, None, INT_MAX_ROW
    full = nb == need
    lo = _take_shared(thr, 1, 32, *_or_and(words[words[:, 0] == side, 1]))
    rows = 0

    def level(v, local_level):
        """One level over the bucket's words v: returns the kept rows'
        flags; a block-local level also takes the bits the kept rows
        share."""
        nonlocal need, nb, full, lo
        lo2 = max(0, lo - 8)
        best = None
        for kind, dg in ((0, (v >> lo2) & ((1 << (lo - lo2)) - 1)),
                         (1, float_digit(v, lo))):
            h = np.bincount(dg, minlength=256)
            ex = np.cumsum(h) - h
            d = int(np.nonzero((ex < need) & (need <= ex + h))[0][0])
            if best is None or h[d] < best[2]:
                best = (kind, d, int(h[d]), int(ex[d]), dg)
        kind, d, cnt, under, dg = best
        need -= under
        bits, nlo = _digit_prefix(kind, d, lo2)
        thr[kd] |= bits
        nb = cnt
        full = nb == need
        keep = dg == d
        lo = nlo
        if local_level and not full:
            lo = _take_shared(thr, kd, nlo, *_or_and(v[keep]))
        return keep

    if not full and kd == 1 and lo > 0 and thr[1] == 0:
        # the side shares only zeros above its differing bits: the row
        # build's histogram of word 1's floating digit is the first level
        mem = np.nonzero(words[:, 0] == side)[0]
        v = words[mem, 1]
        dg = float_digit(v, 32)
        h = np.bincount(dg, minlength=256)
        ex = np.cumsum(h) - h
        d = int(np.nonzero((ex < need) & (need <= ex + h))[0][0])
        need -= int(ex[d])
        bits, lo = _digit_prefix(1, d, 0)
        thr[1] |= bits
        nb = int(h[d])
        full = nb == need
        rows += N
        if not full and nb < nl:
            lst, nl = mem[dg == d], nb

    while not full:
        if lo == 0:
            kd, lo = kd + 1, 32
        if kd >= kw:
            break
        if lst is not None and nl <= local:
            # each block alone: the bucket (the list) with its word kd
            li, loaded = lst, -1
            while True:
                if lo == 0:
                    kd, lo = kd + 1, 32
                if kd >= kw:
                    break
                if loaded != kd:
                    lv = words[li, kd]
                    lo = _take_shared(thr, kd, lo, *_or_and(lv))
                    loaded = kd
                    continue
                rows += len(li)
                keep = level(lv, True)
                if full:
                    break
                li, lv = li[keep], lv[keep]
            if not full:
                cut = int(li[need - 1])
            break
        cand = np.arange(N) if lst is None else lst
        mem = cand[prefix_cmp(words[cand], thr, kd, lo) == 0]
        rows += len(cand)
        keep = level(words[mem, kd], False)
        if full:
            break
        if nb < nl:
            lst, nl = mem[keep], nb
    if not full and cut == INT_MAX_ROW:
        # every row of the bucket has the same key
        if lst is None:
            lst = np.nonzero(prefix_cmp(words, thr, kd, lo) == 0)[0]
        cut = int(lst[need - 1])
    cmp = prefix_cmp(words, thr, kd, lo)
    sel = (cmp < 0) | ((cmp == 0) & (full | (np.arange(N) <= cut)))
    ovf = V >= F and bool(((cmp > 0) & (words[:, 0] == 0)).any())
    return sel, ovf, rows


def lsd_sort(swords, idx, packed, threads, blocks):
    """The kernel's stable LSD radix sort of the selected rows `idx` (in row
    order) by their sort words: each word's 8-bit digits, the least
    significant word first (lex word 0, the invalid bit, one digit), a
    digit skipped where one value holds every row (read off the counts of
    all digits, taken once); a pass takes the order in `blocks` tiles of
    `threads` rows a turn, each tile placed after the rows of each digit
    in the tiles before it (the look-back), each turn ranked by digit.
    Returns the order and the passes run."""
    n = len(idx)
    order = np.asarray(idx, np.int64)
    passes = 0
    for k in reversed(range(swords.shape[1])):
        for q in range(4 if packed or k > 0 else 1):
            tot = np.bincount((swords[idx, k] >> (8 * q)) & 255,
                              minlength=256)
            if tot.max() == n:
                continue
            dstart = np.cumsum(tot) - tot
            dg = (swords[order, k] >> (8 * q)) & 255
            tile = -(-n // blocks)
            dst = np.full(n, -1, np.int64)
            before = np.zeros(256, np.int64)
            for b in range(blocks):
                lo, hi = min(n, b * tile), min(n, b * tile + tile)
                run = dstart + before
                for t0 in range(lo, hi, threads):
                    g = dg[t0:min(hi, t0 + threads)]
                    o = np.argsort(g, kind="stable")
                    rank = np.empty(len(g), np.int64)
                    rank[o] = np.arange(len(g)) - np.searchsorted(g[o], g[o])
                    dst[run[g] + rank] = order[t0:t0 + len(g)]
                    run = run + np.bincount(g, minlength=256)
                before = before + np.bincount(dg[lo:hi], minlength=256)
            assert (np.sort(dst) == np.sort(order)).all()
            order = dst
            passes += 1
    return order, passes


def rank_sort(swords, idx):
    """The kernel's ranking of the selected rows `idx` (in row order): each
    row's place is the count of rows before it, a smaller key or an equal
    one earlier in row order. Returns the order."""
    n = len(idx)
    keys = swords[idx]
    before = np.zeros((n, n), bool)    # [i, j]: row i goes before row j
    undecided = np.ones((n, n), bool)
    for k in range(keys.shape[1]):
        a, b = keys[:, k][:, None], keys[:, k][None, :]
        before |= undecided & (a < b)
        undecided &= a == b
    before |= undecided & (np.arange(n)[:, None] < np.arange(n)[None, :])
    rank = before.sum(0)
    order = np.empty(n, np.int64)
    order[rank] = idx
    return order


def select_sort(route, valid, state, masks, F, s_lo=0, P=0, threads=64,
                blocks=1, local=K_LOCAL, rank_max=None):
    """A sort route's dedup as the kernel runs it on N rows: select the
    rows at the first F positions, compact them in row order, sort only
    those: by rank where they are few (at most rank_max, by default the
    kernel's limit for a grid of `blocks` > 1 or one block), else by radix
    passes. Returns (the first min(N, F) positions' row indices, their
    first-of-run-and-valid flags, overflow, rows read by the histograms
    and passes or the ranking, (N, kw) key words)."""
    words, swords = sort_key_words(route, valid, state, masks, s_lo, P)
    N = len(words)
    V = int(np.asarray(valid).sum())
    if N <= F:
        sel, ovf, rows = np.ones(N, bool), False, 0
    else:
        sel, ovf, rows = select_first(words, V, F, local)
    idx = np.nonzero(sel)[0]
    assert len(idx) == min(N, F)
    if rank_max is None:
        rank_max = K_RANK_GRID if blocks > 1 else K_RANK_BLOCK
    if len(idx) <= rank_max and len(idx) * swords.shape[1] <= K_RANK_WORDS:
        order, passes = rank_sort(swords, idx), 1
    else:
        order, passes = lsd_sort(swords, idx, route == "packed", threads,
                                 blocks)
    ws = words[order]
    fst = np.ones(len(order), bool)
    fst[1:] = (ws[1:] != ws[:-1]).any(1)
    vs = fst & (ws[:, 0] == 0)
    return order, vs, ovf, rows + passes * len(idx), words


class Emu:
    """K3-sort's formulation on numpy arrays, one key at a time, window
    after window as `SortKernel._walk_k3s` launches it."""

    def __init__(self, k: twgl.SortKernel, threads=1024, window=None,
                 seed=0, blocks=1, local=K_LOCAL, rank_max=None):
        self.k = k
        self.F, self.P, self.W = k.F, k.P, k.W
        self.route = k.route
        self.threads = threads
        self.window = window or wgl_sortwalk.window(k.F, k.P)
        self.rng = np.random.default_rng(seed)
        self.blocks = blocks  # the sort passes' tiles (the grid's blocks)
        self.local = local    # bucket lists refined without compacting
        self.rank_max = rank_max  # selected rows ranked, not radix-sorted
        self.rounds = self.dedups = self.launches = 0
        self.dedup_rows = self.pass_rows = 0
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
        order, vs, ovf, rows, words = select_sort(
            self.route, valid, state, masks, F, k.s_lo, P, self.threads,
            self.blocks, self.local, self.rank_max)
        self.pass_rows += rows
        self.dedup_rows += N
        if self.route == "packed":
            head = (words[order, 0] << 31 | words[order, 1])
            m = (head & ((1 << P) - 1)).astype(np.int32)[:, None]
            s = _i32(((head >> P) & ((1 << k.sb_bits) - 1)) + k.s_lo)
        else:
            m, s = masks[order], state[order]
        v = vs
        if ovf and not vs.all():
            self.overflowed_with_dup_head = True
        return (m, s, v, v & (order >= F)), ovf, 0

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
    # odd cases as the grid path runs a large frontier: bucket lists
    # compacted down to 16 rows before blocks refine them, the selected
    # rows sorted by radix passes in 3 tiles; even ones as one block ranks
    # a small frontier
    grid = len(label) % 2
    emu = Emu(tk, threads=64, window=7, seed=len(label),
              blocks=3 if grid else 1, local=16 if grid else K_LOCAL,
              rank_max=0 if grid else None)
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
    assert (emu.pass_rows > 0) == (tk.route != "hash")


# -- the sort routes' dedup alone: select-then-sort against the plain dedups

def _dedup_rows(case, F, rng):
    """(route, P, pack, valid, state, masks) of one dedup's N rows for a
    case: old configurations first (rows [0, F)), candidates after; keys
    drawn from a pool so runs of equal keys are common."""
    lex = case.startswith("lex") or case == "lex-w2"
    P = int(rng.integers(33, 65)) if case == "lex-w2" else \
        int(rng.integers(5, 33)) if lex else int(rng.integers(3, 14))
    W = (P + 31) // 32
    sb = int(rng.integers(2, 31 - P)) if not lex else 64
    s_lo = int(rng.integers(-1000, 1000))
    N = int(rng.integers(1, F + 1)) if case == "n-le-f" else \
        F * (1 + int(rng.integers(1, min(P, 6) + 1)))
    pool = max(1, {"ties": F // 3, "every-digit": 2, "constant": F,
                   "lex-w2": F // 2}.get(case, 4 * F))
    if lex:
        lo, hi = (-2 ** 31, 2 ** 31) if case in ("lex-w2", "lex-ties") \
            else (-3, 4)
        pstate = rng.integers(lo, hi, pool)
    else:
        pstate = s_lo + rng.integers(0, 2 ** sb, pool)
    pmask = rng.integers(0, 2 ** 32, (pool, W), dtype=np.int64)
    top = P - 32 * (W - 1)          # the last word's live bits
    pmask[:, -1] &= (1 << top) - 1
    if case == "every-digit":
        # two keys that differ in the lowest bit only: the threshold's
        # bucket narrows through every digit, then runs out in a tie
        pstate[:] = pstate[0]
        pmask[:] = pmask[0] & ~1
        pmask[1, 0] |= 1
    if case == "constant":
        # every key the same but for its low mask byte: the digits above
        # it are constant
        pstate[:] = pstate[0]
        pmask[:, 1:] = pmask[0, 1:]
        pmask[:, 0] = (pmask[0, 0] & ~0xFF) | (pmask[:, 0] & 0xFF)
    pick = rng.integers(0, pool, N)
    state = pstate[pick].astype(np.int64)
    masks = pmask[pick]
    V = (int(rng.integers(0, F)) if case == "v-lt-f" else
         F if case == "v-eq-f" else
         int(rng.integers(F + 1, N + 1)) if case == "v-gt-f" else
         0 if case == "all-invalid" else int(rng.integers(0, N + 1)))
    V = min(V, N)
    valid = np.zeros(N, bool)
    valid[rng.choice(N, V, replace=False)] = True
    if not lex:
        # invalid rows carry any state (an illegal candidate's garbage)
        junk = rng.integers(-2 ** 31, 2 ** 31, N)
        state = np.where(valid, state, junk)
    state = _i32(state)
    masks = (masks & M32).astype(np.uint32).view(np.int32)
    return ("lex" if lex else "packed"), P, None if lex else (s_lo, sb), \
        valid, state, masks


DEDUP_CASES = ["ties", "lex-ties", "v-lt-f", "v-eq-f", "v-gt-f",
               "all-invalid", "n-le-f", "every-digit", "constant", "lex-w2"]


@pytest.mark.parametrize("mode", ["block", "grid", "grid-passes"])
@pytest.mark.parametrize("case", DEDUP_CASES)
@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1), F=st.integers(8, 64))
def test_emulated_select_then_sort_equals_the_plain_dedup(case, mode, seed,
                                                          F):
    """The kernel's select-then-sort dedup (emulated: as one block runs it,
    or as a grid of three blocks with bucket lists compacted down to 8
    rows before the blocks refine them, the selected rows ranked or, for
    a frontier too large to rank, sorted by radix passes in three tiles)
    gives `SortKernel._dedup_packed` / `_dedup_lex`'s outputs for the
    first min(N, F) positions: masks, states, valid, new and overflow."""
    rng = np.random.default_rng(seed)
    route, P, pack, valid, state, masks = _dedup_rows(case, F, rng)
    N = len(valid)
    tk = twgl.SortKernel("cas-register", F, P, pack, twgl.DEDUP_SORT, "cpu")
    assert tk.route == route
    origin = torch.arange(N) >= F
    plain = tk._dedup_packed if route == "packed" else tk._dedup_lex
    pm, ps, pv, pn, povf, _ = (t[0].numpy() for t in plain(
        torch.from_numpy(masks)[None], torch.from_numpy(state)[None],
        torch.from_numpy(valid)[None], origin))
    s_lo = pack[0] if pack else 0
    order, vs, ovf, rows, words = select_sort(
        route, valid, state, masks, F, s_lo, P, threads=32,
        blocks=1 if mode == "block" else 3,
        local=K_LOCAL if mode == "block" else 8,
        rank_max=0 if mode == "grid-passes" else None)
    if route == "packed":
        key = words[order, 0] << 31 | words[order, 1]
        m = (key & ((1 << P) - 1)).astype(np.int32)[:, None]
        s = _i32(((key >> P) & ((1 << pack[1]) - 1)) + s_lo)
    else:
        m, s = masks[order], state[order]
    np.testing.assert_array_equal(m, pm)
    np.testing.assert_array_equal(s, ps)
    np.testing.assert_array_equal(vs, pv)
    np.testing.assert_array_equal(vs & (order >= F), pn)
    assert ovf == bool(povf)
    # N <= F selects nothing: only the passes over the N rows read rows
    assert N > F or rows % N == 0


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
            torch.zeros(wgl_sortwalk.WORK, dtype=torch.int64),)

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
