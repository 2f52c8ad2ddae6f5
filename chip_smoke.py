#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (jepsen_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out REPORT.json]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, in order; any failure raises and exits non-zero:

  1. print the card (torch's name, and nvidia-smi's name and power limit)
     and build every kernel under jepsen_tpu_torch/csrc with nvcc, one
     process per source, all at once;
  2. hold K1 (the dense closure round) bit-exact against its plain PyTorch
     version on the card over a shape matrix (P = 0 to 19), several rounds
     each, and on the real table and transitions of the concurrency-11
     history's dense walk after 1,500 steps, then time both with CUDA
     events at the main path's shapes and on the real table;
  3. hold K2 (the sort family's frontier hash dedup) bit-exact against its
     plain version on all four outputs over the main path's (N, F) shapes,
     full frontiers, both sides of the single-block cap (N = 8,192 and
     8,193) and edge cases, then time both, and torch.unique beside
     them, with the path each shape takes and the CUDA launches a call
     makes, and where both routes take a shape (N <= 8,192), each route
     in turns;
  4. drive the main path — `linearizable(model).check(...)` — on the dense
     family (the headline 10k-op register history, the adversarial
     crashed-writes history and the concurrency-11 history forced dense,
     a corrupted headline) and the sort family under engine="auto" (the
     headline with the default phantom read, a 10k-op counter history,
     the concurrency-11 history and the adversarial history, the last two
     under a wall-time budget), with every kernel's launch count set to 0
     just before and read just after; then hold verdicts, culprit ops,
     counts and final carries against the port's own CPU path, and trace
     the first 1,500 steps of four walks with torch.profiler for the
     device's busy share;
  5. hold K1 and K2 with a batch axis bit-exact against their plain
     versions (K1 at each dense group's (B, 8, 2^P) of the hazelcast batch
     and at P = 0-3 and 19 with B = 4; K2 on all four outputs at
     (32, 2048, 1024) and (32, 17408, 1024) and on edge rows, both
     routes), each row against the unbatched call on that row, and time
     each batched launch against B unbatched launches of the same rows,
     in turns;
  6. drive the batch path — `analysis_gpu_batch` and the independent
     checker over a key-sharded history — at full size: the hazelcast
     shape (100 keys of 500 register ops, three corrupted, dense groups
     P = 4-10, K1 batched) and 32 counter keys on the sort family's hash
     route (two corrupted, K2 batched on both routes), with every
     kernel's launch count set to 0 just before each run and read just
     after; then the dense batch again under an injected OOM (the
     ladder's split); then hold verdicts, culprit ops, counts and each
     group's final batched carry against the port's CPU path, and trace
     the first 300 lockstep steps of each batch's largest group;
  7. fail if any result other than the injected run's carries a
     'recovered' or 'degraded' stamp; print one JSON line of per-kernel
     numbers, the nvidia-smi line, and last the line
     {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or without the package beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # outside the tensor cores, FMA = 2 ops

SEED = 45100
HEADLINE = dict(n_ops=10_000, concurrency=5, values=5, crash_rate=0.0005,
                seed=SEED)
ADVERSARIAL = dict(n_ops=10_000, concurrency=6, crashed_writes=8,
                   front_load=True, seed=SEED)
AT_CAP = dict(ADVERSARIAL, concurrency=11)
COUNTER = dict(n_ops=10_000, seed=SEED)
# wall-time budgets of the two escalating sort runs (analysis_gpu's
# budget_s), and their chunk size, so that the budget is read often
AT_CAP_BUDGET_S = 90
ADVERSARIAL_BUDGET_S = 150
BUDGET_CHUNK = 1024
# every P from 0 to 19: P <= 3 is the byte-per-thread path, P = 0-3
# inside a chunk are the byte butterflies; S = 3, 5, 24 and 30 are not
# multiples of 8
K1_MATRIX = [(3, 0), (4, 1), (5, 2), (8, 3), (30, 4), (8, 5), (16, 6),
             (8, 7), (8, 14), (8, 19), (16, 7), (30, 8), (8, 9), (256, 10),
             (24, 11), (512, 12), (8, 13), (8, 15), (64, 16), (8, 17),
             (16, 18)]
K1_TIMED = [(8, 7), (8, 14), (8, 19)]
PROFILE_STEPS = 1_500
# the batch path (bench.py:section_config4's hazelcast shape): 100 keys
# of register_history(500, concurrency=4, values=5, crash_rate=0.005,
# seed=1000 + i), keys 7, 42 and 77 with one read set to 5 (one past the
# value domain, so the batch stays dense); and 32 counter keys, keys 5
# and 20 with one read set to 999 and -999 (unreachable, and inside a
# state range that still packs at 16 slots, so the batch takes the hash
# dedup; 10**6 would not)
HAZELCAST = dict(n_ops=500, concurrency=4, values=5, crash_rate=0.005)
HAZELCAST_KEYS, HAZELCAST_BAD = 100, (7, 42, 77)
COUNTER_KEYS, COUNTER_BAD = 32, {5: 999, 20: -999}
BATCH_SLOTS = 16
BATCH_PROFILE_STEPS = 300
# K1 batched: the hazelcast groups' (B padded, P) at S = 8, then P = 0-3
# and 19 at B = 4; K2 batched: (B, N, F) of the counter batch's stage A
# and stage B at F = 1,024, P = 16
K1_BATCHED = [(32, 8, 4), (64, 8, 6), (16, 8, 8), (4, 8, 10), (4, 3, 0),
              (4, 4, 1), (4, 5, 2), (4, 8, 3), (4, 8, 19)]
K2_BATCHED = [(32, 2048, 1024), (32, 17408, 1024)]
ROUTES = ("single-block", "five-launch")       # K2's two routes
# K2's (N, F, keys): stage A (2F) and stage B (F(1+P), P = 8 and 16) at
# the main path's F = 256, and stage B at the adversarial run's escalated
# F, with keys shaped as `stage_keys` makes them; both sides of the
# single-block route's cap; then full frontiers (`frontier_keys`): stage
# A of the escalated passes at F = 1,024 and 4,096, and stage B at
# F = 256 just before the frontier overflows
K2_MATRIX = [(512, 256, "stage"), (2304, 256, "stage"),
             (4352, 256, "stage"), (17408, 1024, "stage"),
             (69632, 4096, "stage"), (278528, 16384, "stage"),
             (8192, 256, "stage"), (8193, 256, "stage"),
             (2048, 1024, "frontier"), (8192, 4096, "frontier"),
             (4352, 256, "frontier")]

def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_inputs(S, P, rng, dev, density=0.05):
    tb = torch.from_numpy(rng.random((S, 1 << P)) < density).to(dev)
    mft = torch.from_numpy(
        (rng.random((P, S, S)) < 0.15).astype(np.uint8)).to(dev)
    return tb, mft


def transition_inputs(S, P, rng, dev, density=0.3):
    """A table and transitions shaped like the main path's: each slot
    moves each state to at most one state (a deterministic model)."""
    tb = torch.from_numpy(rng.random((S, 1 << P)) < density).to(dev)
    mft = np.zeros((P, S, S), np.uint8)
    for p in range(P):
        for s in range(S):
            if rng.random() < 0.75:
                mft[p, rng.integers(S), s] = 1
    return tb, torch.from_numpy(mft).to(dev)


def time_ms(fn, iters, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters) -> float:
    """Time per call with `iters` calls captured in one CUDA graph and
    replayed: the device's time alone, with no host work between the
    launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    ms = time_ms(g.replay, 5, warmup=2) / iters
    del g
    return ms


def in_turns(timer, kernel, other, iters, share=4) -> tuple[float, float]:
    """Kernel and another version (the plain one, by default run a
    quarter as often) timed in turns (other, kernel, kernel, other),
    each the mean of its two turns."""
    o1 = timer(other, max(iters // share, 10))
    k1 = timer(kernel, iters)
    k2 = timer(kernel, iters)
    o2 = timer(other, max(iters // share, 10))
    return (k1 + k2) / 2, (o1 + o2) / 2


def k1_bound(S, P, mft) -> tuple[float, str, int, int]:
    """The least time an H100 could take for one round on these inputs:
    the larger of bytes (table read once and written once as uint8,
    plus mft) over HBM bandwidth and the AND-ORs the data needs (each
    set mft[p, q, s] against the C/2 columns with bit p set, an AND and
    an OR each) over the fp32 rate. This is compulsory traffic at the
    HBM rate, as for every kernel here; it is not K1's own limit. K1's
    table can stay in the 50 MB L2 between rounds, and the kernel loads
    more than the table from there (`k1_l2_bytes`); the data sheet gives
    no L2 rate, so no L2 bound is computed, and K1's distance to this
    bound overstates how much an L2-bound design could still gain."""
    C = 1 << P
    nbytes = 2 * S * C + P * S * S
    ops = 2 * int(mft.sum().item()) * (C // 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def k1_l2_bytes(S, P, mft) -> int:
    """The bytes K1's design loads and stores per round: each row's own
    table once, for each listed source entry (p, s) of row q the whole
    row s where p < 4 (in-chunk butterflies) or half of it where p >= 4
    (chunks with bit p - 4 set), and the output once. Below P = 4 every
    entry reads a whole row."""
    C = 1 << P
    nnz = mft.to(torch.int64).sum(dim=2)          # (P, S): entries of q
    low = int(nnz[:4].sum().item())
    high = int(nnz[4:].sum().item())
    return 2 * S * C + low * C + high * (C // 2 if P >= 4 else C)


def real_k1_inputs(wgl, model, hist, dev, steps, keep=8):
    """The (table, mft) pairs of the last `keep` closure rounds in the
    first `steps` merged steps of the dense walk: real inputs of K1."""
    seen = collections.deque(maxlen=keep)
    kernel = wgl.closure_round

    def record(table, mft):
        seen.append((table.clone(), mft.clone()))
        return kernel(table, mft)

    wgl.closure_round = record
    try:
        prefix_walk(wgl, model, hist, dev, engine="dense")(steps)
        torch.cuda.synchronize()
    finally:
        wgl.closure_round = kernel
    return list(seen)


def k1_rounds_exact(closure_round, plain, tb, mft, rounds, label) -> int:
    """Hold K1 bit-exact against the plain version over `rounds` rounds
    from tb (fewer once a fixpoint is reached); returns the largest
    absolute difference, 0."""
    max_err = 0
    for r in range(rounds):
        got = closure_round(tb, mft)
        want = plain(tb, mft)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - want.to(torch.int16))
                  .abs().max().item())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 != plain at {label} round {r}")
        if torch.equal(got, tb):
            break
        tb = got
    return max_err


def phase_k1(dev, wgl_closure, real) -> dict:
    closure_round = wgl_closure.closure_round
    plain = wgl_closure.closure_round_plain
    rng = np.random.default_rng(SEED)
    max_err = 0
    for S, P in K1_MATRIX:
        tb, mft = random_inputs(S, P, rng, dev)
        max_err = max(max_err, k1_rounds_exact(
            closure_round, plain, tb, mft, 4, f"S={S} P={P}"))
        log(f"K1 bit-exact vs plain: S={S} P={P}, up to 4 rounds")
    # the real table: each recorded round, then rounds to the fixpoint
    for i, (tb, mft) in enumerate(real):
        max_err = max(max_err, k1_rounds_exact(
            closure_round, plain, tb, mft, 1 if i else 64,
            f"the real table, recorded round {i}"))
    S, P = real[-1][0].shape[0], real[-1][1].shape[0]
    log(f"K1 bit-exact vs plain on {len(real)} real rounds of the dense "
        f"walk at S={S} P={P} ({int(real[-1][0].sum().item())} cells set, "
        f"{int(real[-1][1].sum().item())} transitions)")
    shapes = []
    timed = [(S, P, "shaped", *transition_inputs(S, P, rng, dev))
             for S, P in K1_TIMED]
    timed.append((S, P, f"real: dense walk, step {PROFILE_STEPS}",
                  *real[-1]))
    for S, P, inputs, tb, mft in timed:
        iters = 400 if P < 16 else 100

        def kernel():
            return closure_round(tb, mft)

        def plain_round():
            return plain(tb, mft)

        # device time alone (graph replay), and the time per call of an
        # eager loop, which the host's launch overhead can set
        ms, plain_ms = in_turns(graph_ms, kernel, plain_round, iters)
        eager_ms, plain_eager_ms = in_turns(time_ms, kernel, plain_round,
                                            iters)
        bound_ms, bound_by, nbytes, ops = k1_bound(S, P, mft)
        row = dict(S=S, P=P, inputs=inputs, ms=ms, plain_ms=plain_ms,
                   eager_ms=eager_ms, plain_eager_ms=plain_eager_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   and_or_ops=ops, l2_bytes=k1_l2_bytes(S, P, mft))
        shapes.append(row)
        log(f"K1 time S={S} P={P} ({inputs}): {ms:.6f} ms on the device "
            f"({eager_ms:.6f} ms per eager call); plain {plain_ms:.6f} ms "
            f"({plain_eager_ms:.6f} ms eager); bound {bound_ms:.6f} ms by "
            f"{bound_by} at the HBM rate; {row['l2_bytes']} bytes loaded "
            f"and stored by the design")
    return {"max_abs_err": max_err, "shapes": shapes}


def stage_keys(N, F, rng, live=0.5, legal=0.1):
    """Keys shaped like a dedup input on the main path: F old-frontier
    rows (a share `live` of them distinct keys, the rest EMPTY), then
    N - F candidates, mostly EMPTY (stage B's legality mask is sparse),
    the rest half duplicates of old keys and half new keys drawn from a
    small pool, so that they repeat too."""
    n_live = int(F * live)
    old = np.full(F, -1, np.int64)
    old[:n_live] = rng.choice(2 ** 31 - 1, n_live, replace=False)
    cand = np.full(N - F, -1, np.int64)
    hit = np.nonzero(rng.random(N - F) < legal)[0]
    dup = rng.random(hit.size) < 0.5
    if n_live:
        cand[hit[dup]] = rng.choice(old[:n_live], int(dup.sum()))
    pool = rng.integers(0, 2 ** 31 - 1, max(hit.size // 4, 1))
    cand[hit[~dup]] = rng.choice(pool, int((~dup).sum()))
    return np.concatenate([old, cand]).astype(np.int32)


def frontier_keys(N, F, rng, legal=0.5):
    """Keys shaped like a dedup input from a full frontier: F distinct
    old configurations, then N - F candidates in blocks of F, block m
    the old keys with pending bit m set where the op is legal (a share
    `legal`), else EMPTY. Every valid key is distinct, as in stage A,
    whose candidates all set the bit of the slot just filled."""
    blocks = (N - F) // F
    old = rng.choice(2 ** 31 >> blocks, F, replace=False) << blocks
    cand = [np.where(rng.random(F) < legal, old | (1 << m), -1)
            for m in range(blocks)]
    return np.concatenate([old, *cand]).astype(np.int32)


def k2_keys(N, F, kind, rng):
    return (frontier_keys if kind == "frontier" else stage_keys)(N, F, rng)


def k2_edge_cases(rng):
    """(label, keys, F): all EMPTY, all distinct (count > F, also at the
    single-block cap), N not a power of two, heavy duplicates."""
    return [("all-empty", np.full(512, -1, np.int32), 256),
            ("all-distinct", rng.permutation(4352).astype(np.int32), 256),
            ("all-distinct-8192", rng.permutation(8192).astype(np.int32),
             256),
            ("n-not-pow2", stage_keys(3000, 200, rng), 200),
            ("heavy-dups", rng.choice(np.array([0, 7, 2 ** 31 - 1, 99],
                                               np.int32), 4352), 256)]


def k2_bound(N, F, keys) -> tuple[float, str, int, int]:
    """The least time an H100 could take for one dedup of these keys:
    the larger of bytes (keys read once, the F keys and F flags and the
    count and digest written once) over HBM bandwidth, and the integer
    work the data needs (per valid key the murmur3 finaliser, the
    mask, one probe compare and the XOR: 10 operations; per EMPTY key
    one compare) over the fp32 rate (the guide lists no int32 rate; the
    operations bound is far below the bytes bound either way)."""
    nbytes = 4 * N + 5 * F + 8
    valid = int((keys != -1).sum().item())
    ops = 10 * valid + (N - valid)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def phase_k2(dev, wgl_dedup) -> dict:
    dedup, plain = wgl_dedup.dedup, wgl_dedup.dedup_plain
    rng = np.random.default_rng(SEED + 2)
    cases = [(f"{kind}-{N}-{F}", k2_keys(N, F, kind, rng), F)
             for N, F, kind in K2_MATRIX]
    cases += [(f"dense-{N}-{F}", stage_keys(N, F, rng, live=0.9,
                                            legal=0.6), F)
              for N, F, _kind in K2_MATRIX[:3]]
    cases += k2_edge_cases(rng)
    max_err = 0
    for label, k, F in cases:
        keys = torch.from_numpy(k).to(dev)
        got = dedup(keys, F)
        want = plain(keys, F)
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "new", "count", "digest"), got, want):
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()
                      .item())
            max_err = max(max_err, err)
            if a.dtype != b.dtype or a.shape != b.shape \
                    or not torch.equal(a, b):
                raise AssertionError(f"K2 != plain at {label} (N="
                                     f"{k.size}, F={F}): {name}")
        if k.size <= wgl_dedup.SINGLE_BLOCK_MAX_N:
            # the route `dedup` did not take, on the same keys
            other = [r for r in ROUTES if r != wgl_dedup.path(k.size)][0]
            for name, a, b in zip(("out", "new", "count", "digest"),
                                  wgl_dedup.launch(keys, F, other), want):
                if not torch.equal(a, b):
                    raise AssertionError(f"K2 != plain at {label} (N="
                                         f"{k.size}, F={F}) on the "
                                         f"{other} route: {name}")
        log(f"K2 bit-exact vs plain: {label} N={k.size} F={F} "
            f"({wgl_dedup.path(k.size)}), count {int(got[2].item())}")
    shapes = []
    for N, F, kind in K2_MATRIX:
        keys = torch.from_numpy(k2_keys(N, F, kind, rng)).to(dev)
        iters = 200 if N < 100_000 else 50
        route = wgl_dedup.path(N)
        before = wgl_dedup.cuda_launches()
        dedup(keys, F)
        torch.cuda.synchronize()
        per_call = wgl_dedup.cuda_launches() - before
        if per_call != (1 if route == "single-block" else 5):
            raise AssertionError(f"K2 at N={N}: {per_call} CUDA launches "
                                 f"a call on the {route} route")

        def kernel():
            return dedup(keys, F)

        def plain_dedup():
            return plain(keys, F)

        ms, plain_ms = in_turns(graph_ms, kernel, plain_dedup, iters)
        eager_ms, plain_eager_ms = in_turns(time_ms, kernel, plain_dedup,
                                            iters)
        # both routes where both take N, by graph replay in turns (this
        # route, the other, the other, this one)
        route_ms = {route: ms}
        if N <= wgl_dedup.SINGLE_BLOCK_MAX_N:
            other = [r for r in ROUTES if r != route][0]

            def other_route():
                return wgl_dedup.launch(keys, F, other)

            route_ms[route], route_ms[other] = in_turns(
                graph_ms, kernel, other_route, iters, share=1)
        # the nearest single PyTorch call: distinct keys in key order,
        # with no first-seen order, no new flags and no digest — not the
        # same function, and it reads its output size on the host
        unique_ms = time_ms(lambda: torch.unique(keys), max(iters // 4, 10))
        bound_ms, bound_by, nbytes, ops = k2_bound(N, F, keys)
        row = dict(N=N, F=F, keys=kind, path=route,
                   cuda_launches_per_call=per_call, ms=ms,
                   plain_ms=plain_ms, eager_ms=eager_ms,
                   plain_eager_ms=plain_eager_ms, route_ms=route_ms,
                   unique_ms=unique_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, int_ops=ops)
        shapes.append(row)
        log(f"K2 time N={N} F={F} {kind} keys ({route}, {per_call} CUDA "
            f"launches a call): {ms:.6f} ms on the device "
            f"({eager_ms:.6f} ms per eager call); plain {plain_ms:.6f} ms "
            f"({plain_eager_ms:.6f} ms eager); by route "
            f"{ {r: round(t, 6) for r, t in route_ms.items()} }; "
            f"torch.unique (not the same function) {unique_ms:.6f} ms "
            f"eager; bound {bound_ms:.6f} ms by {bound_by}")
    return {"max_abs_err": max_err, "shapes": shapes}


def exact(got, want, label) -> int:
    """Hold one kernel output bit-exact against the plain version's;
    returns the largest absolute difference, 0."""
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()
              .item()) if got.numel() else 0
    if got.dtype != want.dtype or got.shape != want.shape \
            or not torch.equal(got, want):
        raise AssertionError(f"kernel != plain at {label}")
    return err


def phase_k1_batched(dev, wgl_closure) -> dict:
    """K1 with a batch axis: bit-exact against the plain version and row
    by row against the unbatched kernel over up to four rounds, then the
    batched launch timed against B unbatched launches of the same rows,
    in turns, and the plain version."""
    closure_round = wgl_closure.closure_round
    plain = wgl_closure.closure_round_plain
    rng = np.random.default_rng(SEED + 4)
    max_err, shapes = 0, []
    for B, S, P in K1_BATCHED:
        rows = [transition_inputs(S, P, rng, dev, density=0.05)
                for _ in range(B)]
        tb = torch.stack([t for t, _m in rows])
        mft = torch.stack([m for _t, m in rows])
        t = tb
        for r in range(4):
            before = wgl_closure.LAUNCHES
            got = closure_round(t, mft)
            if wgl_closure.LAUNCHES != before + 1:
                raise AssertionError("a batched K1 call is one launch")
            label = f"K1 batched B={B} S={S} P={P} round {r}"
            max_err = max(max_err, exact(got, plain(t, mft), label))
            for b in range(B):
                exact(got[b], closure_round(t[b], mft[b]), f"{label} row {b}")
            if torch.equal(got, t):
                break
            t = got
        log(f"K1 batched bit-exact vs plain and vs each row's own launch: "
            f"B={B} S={S} P={P}")
        if P >= 19:
            continue
        iters = max(20, 2_000 // B)

        def batched():
            return closure_round(tb, mft)

        def one_by_one():
            return [closure_round(tb[b], mft[b]) for b in range(B)]

        ms, turns_ms = in_turns(graph_ms, batched, one_by_one, iters,
                                share=1)
        _ms, plain_ms = in_turns(graph_ms, batched,
                                 lambda: plain(tb, mft), iters)
        C = 1 << P
        nbytes = B * (2 * S * C + P * S * S)
        ops = 2 * int(mft.sum().item()) * (C // 2)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        row = dict(B=B, S=S, P=P, ms=ms, scalar_turns_ms=turns_ms,
                   plain_ms=plain_ms, bound_ms=max(t_b, t_o) * 1e3,
                   bound_by="bytes" if t_b >= t_o else "operations",
                   bytes=nbytes, and_or_ops=ops)
        shapes.append(row)
        log(f"K1 batched time B={B} S={S} P={P}: {ms:.6f} ms a batched "
            f"launch; {turns_ms:.6f} ms for {B} unbatched launches of the "
            f"same rows (in turns); plain {plain_ms:.6f} ms; bound "
            f"{row['bound_ms']:.6f} ms by {row['bound_by']}")
    return {"max_abs_err": max_err, "shapes": shapes}


def k2_batch_edge_rows(N, F, rng) -> np.ndarray:
    """Four rows: all EMPTY, all distinct, heavy duplicates, and keys
    shaped like a dedup input."""
    return np.stack([np.full(N, -1, np.int32),
                     rng.permutation(N).astype(np.int32),
                     rng.choice(np.array([0, 7, 2 ** 31 - 1, 99], np.int32),
                                N),
                     stage_keys(N, F, rng)])


def phase_k2_batched(dev, wgl_dedup) -> dict:
    """K2 with a batch axis: all four outputs bit-exact against the plain
    version and row by row against the unbatched kernel, on both routes
    where both take N, then the batched call timed against B unbatched
    calls of the same rows, in turns, and the plain version."""
    dedup, plain = wgl_dedup.dedup, wgl_dedup.dedup_plain
    rng = np.random.default_rng(SEED + 6)
    max_err, shapes = 0, []
    cases = [(f"stage-{B}x{N}-{F}",
              np.stack([stage_keys(N, F, rng) for _ in range(B)]), F)
             for B, N, F in K2_BATCHED]
    cases += [(f"edge-rows-{N}-{F}", k2_batch_edge_rows(N, F, rng), F)
              for _B, N, F in K2_BATCHED]
    for label, k, F in cases:
        B, N = k.shape
        keys = torch.from_numpy(k).to(dev)
        route = wgl_dedup.path(N)
        before = wgl_dedup.cuda_launches()
        got = dedup(keys, F)
        torch.cuda.synchronize()
        per_call = wgl_dedup.cuda_launches() - before
        if per_call != (1 if route == "single-block" else 5):
            raise AssertionError(f"K2 batched {label}: {per_call} CUDA "
                                 f"launches on the {route} route")
        want = plain(keys, F)
        for name, a, b in zip(("out", "new", "count", "digest"), got, want):
            max_err = max(max_err, exact(a, b, f"K2 batched {label} {name}"))
        for b in range(B):
            for name, a, o in zip(("out", "new", "count", "digest"), got,
                                  dedup(keys[b].contiguous(), F)):
                exact(a[b], o, f"K2 batched {label} row {b} {name}")
        if N <= wgl_dedup.SINGLE_BLOCK_MAX_N:
            for name, a, b in zip(("out", "new", "count", "digest"),
                                  wgl_dedup.launch(keys, F, "five-launch"),
                                  want):
                exact(a, b, f"K2 batched {label} five-launch {name}")
        log(f"K2 batched bit-exact vs plain and vs each row's own call: "
            f"{label} ({route}, {per_call} CUDA launches a call)")
    for B, N, F in K2_BATCHED:
        k = np.stack([stage_keys(N, F, rng) for _ in range(B)])
        keys = torch.from_numpy(k).to(dev)
        rows = [keys[b].contiguous() for b in range(B)]
        iters = 40

        def batched():
            return dedup(keys, F)

        def one_by_one():
            return [dedup(r, F) for r in rows]

        ms, turns_ms = in_turns(graph_ms, batched, one_by_one, iters,
                                share=1)
        _ms, plain_ms = in_turns(graph_ms, batched,
                                 lambda: plain(keys, F), iters)
        valid = int((keys != -1).sum().item())
        nbytes = B * (4 * N + 5 * F + 8)
        ops = 10 * valid + (B * N - valid)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        row = dict(B=B, N=N, F=F, path=wgl_dedup.path(N), ms=ms,
                   scalar_turns_ms=turns_ms, plain_ms=plain_ms,
                   bound_ms=max(t_b, t_o) * 1e3,
                   bound_by="bytes" if t_b >= t_o else "operations",
                   bytes=nbytes, int_ops=ops)
        shapes.append(row)
        log(f"K2 batched time B={B} N={N} F={F} ({row['path']}): "
            f"{ms:.6f} ms a batched call; {turns_ms:.6f} ms for {B} "
            f"unbatched calls of the same rows (in turns); plain "
            f"{plain_ms:.6f} ms; bound {row['bound_ms']:.6f} ms by "
            f"{row['bound_by']}")
    return {"max_abs_err": max_err, "shapes": shapes}


def batch_histories(models, synth):
    """The hazelcast-shape dense batch and the counter sort batch."""
    hz = [synth.register_history(**HAZELCAST, seed=1000 + i)
          for i in range(HAZELCAST_KEYS)]
    for i in HAZELCAST_BAD:
        hz[i] = synth.corrupt(hz[i], value=HAZELCAST["values"])
    cnt = [synth.counter_history(500, seed=2000 + i)
           for i in range(COUNTER_KEYS)]
    for i, v in COUNTER_BAD.items():
        cnt[i] = synth.corrupt(cnt[i], value=v)
    return (models.cas_register(), hz), (models.counter(), cnt)


def kv_history(independent, hists) -> list:
    """The per-key histories as one key-sharded history: values wrapped
    as (key, value) tuples, processes kept apart per key, ops merged by
    time (each key's ops keep their order)."""
    ops = []
    for k, h in enumerate(hists):
        for o in h.ops:
            ops.append(dict(o, value=independent.ktuple(k, o["value"]),
                            process=o["process"] + 1_000 * k))
    ops.sort(key=lambda o: o["time"])
    return ops


def walk_totals(results) -> dict:
    """The batch walks behind a list of batch results: each walk's
    'batch-walk' stamp once (the keys it decided share it)."""
    walks = {json.dumps(r["batch-walk"], sort_keys=True): r["batch-walk"]
             for r in results if "batch-walk" in r}
    return {"groups": [w["group"] + [w["keys"]] for w in walks.values()],
            "closure_rounds": sum(w["closure-rounds"] for w in walks.values()),
            "dedup_launches": sum(w["dedup-launches"] for w in walks.values()),
            "host_syncs": sum(w["host-syncs"] for w in walks.values())}


def no_stamps(label, results) -> None:
    """A fault the ladder absorbed must not pass unseen."""
    for i, r in enumerate(results):
        if r.get("recovered") or r.get("degraded"):
            raise AssertionError(f"{label} key {i}: recovered/degraded "
                                 f"{r.get('recovered')} {r.get('error')}")


def run_batch(label, fn, wgl, wgl_closure, wgl_dedup, carry_to_numpy):
    """One run of the batch path with every kernel's launch count set to
    0 just before and read just after, and each group walk's final
    batched carry kept (host copies, in walk order)."""
    carries = []
    walk = wgl._batch_walk

    def record(*a, **k):
        carry = walk(*a, **k)
        carries.append(carry_to_numpy(carry))
        return carry

    wgl._batch_walk = record
    wgl_closure.LAUNCHES = 0
    wgl_dedup.LAUNCHES = 0
    cuda0 = wgl_dedup.cuda_launches()
    try:
        t = time.perf_counter()
        rs = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        wgl._batch_walk = walk
    tot = walk_totals(rs)
    rec = dict(wall_s=wall, k1_launches=wgl_closure.LAUNCHES,
               k2_launches=wgl_dedup.LAUNCHES,
               k2_cuda_launches=wgl_dedup.cuda_launches() - cuda0,
               verdicts=[r["valid?"] for r in rs],
               invalid=[i for i, r in enumerate(rs) if r["valid?"] is False],
               op_index={i: r.get("op-index") for i, r in enumerate(rs)
                         if r["valid?"] is False}, **tot)
    log(f"batch {label}: {len(rs)} keys, wall {wall:.3f} s, K1 launches "
        f"{rec['k1_launches']}, K2 launches {rec['k2_launches']} "
        f"({rec['k2_cuda_launches']} CUDA launches), host syncs "
        f"{tot['host_syncs']}, groups [kind, shape..., keys] "
        f"{tot['groups']}, invalid keys {rec['op_index']}")
    return rs, rec, carries


def check_batch(label, rs, rec, bad, dense) -> None:
    """Hold a batch run to what its histories are: the corrupted keys
    invalid with an op-index, the rest valid, K1 launched on the dense
    groups and K2 on the sort group's hash route, each as often as the
    walks counted."""
    if rec["invalid"] != sorted(bad) or any(
            not isinstance(rec["op_index"][i], int) for i in bad):
        raise AssertionError(f"{label}: invalid keys {rec['op_index']}")
    if any(v not in (True, False) for v in rec["verdicts"]):
        raise AssertionError(f"{label}: undecided keys")
    if any(r["analyzer"] != "gpu-wgl-batch" or r["device"] != "cuda"
           for r in rs):
        raise AssertionError(f"{label}: a key left the batch path")
    k1, k2 = rec["k1_launches"], rec["k2_launches"]
    if dense:
        if k1 <= 0 or k1 != rec["closure_rounds"] or k2 != 0 \
                or any(g[0] != "dense" for g in rec["groups"]):
            raise AssertionError(f"{label}: K1 {k1} for "
                                 f"{rec['closure_rounds']} rounds, K2 {k2}")
        return
    singles = (5 * k2 - rec["k2_cuda_launches"]) // 4
    if k1 != 0 or k2 <= 0 or k2 != rec["dedup_launches"] or singles <= 0 \
            or singles >= k2 or any(r["dedup"] != "pallas-hash" for r in rs):
        raise AssertionError(f"{label}: K1 {k1}, K2 {k2} "
                             f"({rec['k2_cuda_launches']} CUDA launches) for "
                             f"{rec['dedup_launches']} hash dedups")


def same_carries(label, a, b) -> None:
    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} group walks vs {len(b)}")
    for g, (ca, cb) in enumerate(zip(a, b)):
        for i, (x, y) in enumerate(zip(ca, cb)):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{label}: walk {g} carry element {i} "
                                     f"differs")


def phase_batch(dev, models, synth, wgl, wgl_closure, wgl_dedup,
                independent, linearizable, platform, carry_to_numpy) -> dict:
    """The batch path at full size on the card, under injection, and
    against the CPU path."""
    (reg, hz), (counter, cnt) = batch_histories(models, synth)
    kw = dict(slots=BATCH_SLOTS)
    out = {}

    def run(label, fn):
        return run_batch(label, fn, wgl, wgl_closure, wgl_dedup,
                         carry_to_numpy)

    dense_rs, out["dense"], dense_carries = run(
        "hazelcast (dense)", lambda: wgl.analysis_gpu_batch(reg, hz, **kw))
    check_batch("hazelcast", dense_rs, out["dense"], HAZELCAST_BAD, True)
    kv = kv_history(independent, hz)

    def independent_check():
        res = independent.checker(linearizable(reg, **kw)).check({}, kv, {})
        if res["valid?"] is not False \
                or sorted(res["failures"]) != sorted(HAZELCAST_BAD):
            raise AssertionError(f"independent: {res['valid?']} "
                                 f"{res['failures']}")
        return [res["results"][k] for k in range(len(hz))]

    ind, out["independent"], _c = run(
        "hazelcast through independent.checker", independent_check)
    check_batch("independent", ind, out["independent"], HAZELCAST_BAD, True)
    for i, (a, b) in enumerate(zip(dense_rs, ind)):
        for key in ("valid?", "max-frontier", "dedup", "batch-walk"):
            if a.get(key) != b.get(key):
                raise AssertionError(f"independent key {i}: {key} "
                                     f"{b.get(key)} != {a.get(key)}")
        if a["valid?"] is False:
            # the op-index of the key-sharded history names the same op
            x, y = kv[b["op-index"]], hz[i].ops[a["op-index"]]
            if (x["time"], x["f"], x["value"]) != \
                    (y["time"], y["f"], independent.ktuple(i, y["value"])):
                raise AssertionError(f"independent key {i}: op {x} != {y}")
    sort_rs, out["sort"], sort_carries = run(
        "counter (sort, hash dedup)",
        lambda: wgl.analysis_gpu_batch(counter, cnt, **kw))
    check_batch("counter", sort_rs, out["sort"], sorted(COUNTER_BAD), False)

    # the ladder on the card: an injected OOM at the first chunk dispatch
    # splits the group walking then (the cheapest dense group) in halves
    os.environ[platform.FAULT_INJECT_ENV] = "oom@batch:1"
    platform.reset_fault_injection()
    try:
        oom_rs, out["oom"], _c = run(
            "hazelcast under oom@batch:1",
            lambda: wgl.analysis_gpu_batch(reg, hz, **kw))
    finally:
        del os.environ[platform.FAULT_INJECT_ENV]
        platform.reset_fault_injection()
    first = min(g[3] for g in out["dense"]["groups"])   # smallest P
    split = [i for i, r in enumerate(oom_rs) if r.get("recovered")]
    want = [i for i, r in enumerate(dense_rs)
            if r["batch-walk"]["group"][3] == first]
    if [r["valid?"] for r in oom_rs] != out["dense"]["verdicts"] \
            or split != want or any(
                oom_rs[i]["recovered"] != {"faults": ["oom"], "retries": 1,
                                           "split": True} for i in split) \
            or any(r.get("degraded") for r in oom_rs):
        raise AssertionError(f"injected OOM: verdicts or stamps differ "
                             f"(split keys {split}, want {want})")
    out["oom"]["split_keys"] = len(split)
    log(f"injected OOM: the same {len(oom_rs)} verdicts; the {len(split)} "
        f"keys of the P={first} group walking at the fault carry "
        f"recovered {oom_rs[split[0]]['recovered']}")
    for label, rs in (("hazelcast", dense_rs), ("independent", ind),
                      ("counter", sort_rs)):
        no_stamps(label, rs)

    # the CPU path: verdicts, counts and each walk's final carry
    t0 = time.perf_counter()
    for label, model, hists, g_rs, g_carries in (
            ("hazelcast", reg, hz, dense_rs, dense_carries),
            ("counter", counter, cnt, sort_rs, sort_carries)):
        t = time.perf_counter()
        c_rs, _rec, c_carries = run_batch(
            f"{label} on the CPU",
            lambda: wgl.analysis_gpu_batch(model, hists, device="cpu", **kw),
            wgl, wgl_closure, wgl_dedup, carry_to_numpy)
        for i, (a, b) in enumerate(zip(g_rs, c_rs)):
            for key in ("valid?", "op-index", "max-frontier", "dedup",
                        "analyzer", "op-count", "batch-walk"):
                if a.get(key) != b.get(key):
                    raise AssertionError(f"{label} key {i}: {key} gpu "
                                         f"{a.get(key)} != cpu {b.get(key)}")
        same_carries(label, g_carries, c_carries)
        out[f"{label}_cpu_s"] = time.perf_counter() - t
        log(f"{label} batch: GPU and CPU agree on every key (verdict, "
            f"op-index, max-frontier, dedup, walk counts) and on the final "
            f"batched carry of each of {len(g_carries)} group walks; CPU "
            f"path {out[f'{label}_cpu_s']:.3f} s")
    out["cpu_agreement_s"] = time.perf_counter() - t0

    # where a batched walk's time goes: its largest group's first steps
    out["profiles"] = {}
    for label, model, hists in (("hazelcast", reg, hz),
                                ("counter", counter, cnt)):
        walk, keys = batch_prefix_walk(wgl, model, hists, dev)
        pr = profile_walk(walk, BATCH_PROFILE_STEPS)
        pr["keys"] = keys
        out["profiles"][label] = pr
        log(f"profile {label} batch, largest group ({keys} keys), first "
            f"{BATCH_PROFILE_STEPS} lockstep steps: wall "
            f"{pr['wall_s']:.4f} s, device busy {pr['device_busy_s']:.4f} s "
            f"({100 * pr['busy_share']:.2f}%), {pr['kernel_launches']} "
            f"kernel launches ({pr['kernel_launches'] / BATCH_PROFILE_STEPS:.1f}"
            f" per step); top {pr['top']}")
    return out


def batch_prefix_walk(wgl, model, hists, device):
    """A function walking the first n lockstep steps of the batch's
    largest dispatch group, as analysis_gpu_batch's walk does, and the
    group's key count."""
    pre = [wgl.encode_ops_for_model(model, h) for h in hists]
    srange = wgl._state_range(model.device_model, model, pre)
    dense, sort_idx = wgl._dispatch_groups(
        srange, [wgl.required_slots(o) for o in pre], "auto",
        n_events=max(wgl.event_count(o) for o in pre))
    d, idx = max(list(dense.values()) + [(None, sort_idx)],
                 key=lambda g: len(g[1]))
    slots = d[2] if d is not None else BATCH_SLOTS
    k = wgl._batch_kernel(model.device_model, d, srange, slots, 1024, device)
    x, ns = wgl._stack_steps([wgl.build_steps(pre[i], slots) for i in idx],
                             wgl._bucket(len(idx), lo=1))
    xs = wgl.stage_steps(x, device)
    init = [model.device_state()] * len(ns)
    return (lambda n: k.check_chunk_batch(xs, np.minimum(ns, n),
                                          k.init_carry_batch(init)),
            len(idx))


def prefix_walk(wgl, model, hist, device, **kw):
    """A function walking the first n merged steps of `hist` on the
    engine `plan` picks (the sort family at frontier F), as
    analysis_gpu's walk does."""
    pl = wgl.plan(model, hist, **kw)
    k = pl.kernel(device, kw.get("frontier", 256))
    xs = wgl.stage_steps(wgl.build_steps(pl.ops, pl.slots).x, device)
    init = model.device_state()
    return lambda n: k.check_chunk(xs, n, k.init_carry(init))


def profile_walk(walk, n) -> dict:
    """Where one walk's time goes: its wall time unprofiled, and the
    device time of every kernel in a torch.profiler trace of a second
    run (kernel durations are device-side, so the profiler's host
    overhead does not inflate them). Kernels run on one stream, so their
    sum is the device's busy time. The durations are summed from the
    trace's raw events: `key_averages()` builds an event tree that costs
    minutes for the sort walk's million events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walk(n)                  # warm: allocator and library load
    torch.cuda.synchronize()
    t = time.perf_counter()
    walk(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        walk(n)
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0, 0])   # count, ns
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = by_name[e.name()]
            row[0] += 1
            row[1] += e.duration_ns()
    busy_s = sum(ns for _c, ns in by_name.values()) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_s": wall, "device_busy_s": busy_s,
            "busy_share": busy_s / wall,
            "kernel_launches": sum(c for c, _ns in by_name.values()),
            "top": [(name[:60], c, ns / 1e6) for name, (c, ns) in top]}


def final_carry(wgl, carry_to_numpy, model, hist, device, **kw):
    """The picked engine's carry after the whole merged stream."""
    pl = wgl.plan(model, hist, **kw)
    k = pl.kernel(device, kw.get("frontier", 256))
    steps = wgl.build_steps(pl.ops, pl.slots)
    carry = k.check_chunk(wgl.stage_steps(steps.x, device), steps.n,
                          k.init_carry(model.device_state()))
    return carry_to_numpy(carry)


def main_path_runs(models, synth):
    """(label, model, history, checker options, expectation) of the main
    path. The expectation holds the verdicts allowed, the analyzer, the
    dedup routes allowed and, for the dense runs, the table's P."""
    reg, counter = models.cas_register(), models.counter()
    head = synth.register_history(**HEADLINE)
    adv = synth.adversarial_register_history(**ADVERSARIAL)
    at_cap = synth.adversarial_register_history(**AT_CAP)
    dense, sort = "gpu-wgl-dense", "gpu-wgl"
    budget = dict(chunk_entries=BUDGET_CHUNK)
    return [
        ("headline", reg, head, {}, ((True,), dense, ("dense-table",), 7)),
        ("adversarial-dense", reg, adv, {"engine": "dense"},
         ((True,), dense, ("dense-table",), 14)),
        ("at-cap-dense", reg, at_cap, {"engine": "dense"},
         ((True,), dense, ("dense-table",), 19)),
        ("corrupted", reg, synth.corrupt(head, value=HEADLINE["values"]),
         {}, ((False,), dense, ("dense-table",), 7)),
        ("phantom", reg, synth.corrupt(head), {},
         ((False,), sort, ("pallas-hash",), None)),
        ("counter", counter, synth.counter_history(**COUNTER), {},
         ((True,), sort, ("pallas-hash",), None)),
        ("at-cap", reg, at_cap, dict(budget, budget_s=AT_CAP_BUDGET_S),
         ((True, "unknown"), sort, ("xla-sort",), None)),
        ("adversarial", reg, adv,
         dict(budget, budget_s=ADVERSARIAL_BUDGET_S),
         ((True, "unknown"), sort, ("pallas-hash", "xla-sort"), None)),
    ]


def check_run(label, r, launches, expect) -> None:
    """Hold one main-path result to its expectation and to the kernels'
    launch counts."""
    verdicts, analyzer, dedups, p_want = expect
    k1, k2 = launches
    if r["valid?"] not in verdicts or r["analyzer"] != analyzer \
            or r["dedup"] not in dedups:
        raise AssertionError(f"{label}: {r['valid?']} {r['analyzer']} "
                             f"{r['dedup']} {r.get('error')}")
    if r["valid?"] == "unknown" and not (
            "budget" in r["error"] or "overflowed" in r["error"]):
        raise AssertionError(f"{label}: unknown without a budget or an "
                             f"overflow: {r.get('error')}")
    if r["valid?"] is False and not isinstance(r.get("op-index"), int):
        raise AssertionError(f"{label}: no op-index")
    if k2 != r["dedup-launches"] or k1 != (
            r["closure-rounds"] if analyzer == "gpu-wgl-dense" else 0):
        raise AssertionError(f"{label}: K1 {k1} / K2 {k2} launches for "
                             f"{r['closure-rounds']} rounds and "
                             f"{r['dedup-launches']} hash dedups")
    if p_want is not None:
        if r["dense-shape"][1:] != [8, p_want] or k1 <= 0:
            raise AssertionError(f"{label}: shape {r['dense-shape']}, "
                                 f"{k1} K1 launches")
    elif r["dedup"] == "pallas-hash" and k2 <= 0:
        raise AssertionError(f"{label}: no K2 launch on the hash route")


def write_report(path, report) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, default=str)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import _build, _platform, independent, models
    from jepsen_tpu_torch.carry import carry_to_numpy
    from jepsen_tpu_torch.checker import synth, wgl, wgl_closure, wgl_dedup
    from jepsen_tpu_torch.checker.linear import linearizable

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(f"nvidia-smi: {smi}")
    phase_s = {}
    mark = [time.perf_counter()]

    def phase_done(label):
        now = time.perf_counter()
        phase_s[label] = now - mark[0]
        mark[0] = now
        log(f"phase {label}: {phase_s[label]:.1f} s")

    # -- phase 1: build -------------------------------------------------------
    build_logs = _build.build()
    for src, text in build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                        "spill", "error")):
                log(f"ptxas[{src}]: {line.strip()}")
    log(f"built {sorted(build_logs) or 'nothing (fresh)'}")
    phase_done("build")

    # -- phase 2: K1 against its plain version --------------------------------
    runs = main_path_runs(models, synth)
    hists = {label: (model, hist) for label, model, hist, *_ in runs}
    real = real_k1_inputs(wgl, *hists["at-cap-dense"], dev, PROFILE_STEPS)
    k1 = phase_k1(dev, wgl_closure, real)
    phase_done("K1 against its plain version")

    # -- phase 3: K2 against its plain version --------------------------------
    k2 = phase_k2(dev, wgl_dedup)
    phase_done("K2 against its plain version")
    del real

    # -- phase 4: the main path -------------------------------------------------
    results = {}
    torch.cuda.reset_peak_memory_stats()
    wgl_closure.LAUNCHES = 0
    wgl_dedup.LAUNCHES = 0
    for label, model, hist, kw, expect in runs:
        before = wgl_closure.LAUNCHES, wgl_dedup.LAUNCHES
        t = time.perf_counter()
        r = linearizable(model, **kw).check({}, hist, {})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = (wgl_closure.LAUNCHES - before[0],
                    wgl_dedup.LAUNCHES - before[1])
        results[label] = dict(r, wall_s=wall, k1_launches=launches[0],
                              k2_launches=launches[1])
        log(f"{label}: valid?={r['valid?']} op-index={r.get('op-index')} "
            f"analyzer={r['analyzer']} dedup={r['dedup']} frontier-size="
            f"{r['frontier-size']} shape={r.get('dense-shape')} "
            f"max-frontier={r['max-frontier']} wall={wall:.3f} s K1 "
            f"launches={launches[0]} K2 launches={launches[1]} closure "
            f"rounds={r['closure-rounds']} host syncs={r['host-syncs']} "
            f"error={r.get('error')}")
        check_run(label, r, launches, expect)
    no_stamps("main path", list(results.values()))
    main_launches = {"closure_round": wgl_closure.LAUNCHES,
                     "dedup": wgl_dedup.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    phase_done("main path")

    # -- agreement with the port's CPU path -----------------------------------
    reg = models.cas_register()
    adv_small = synth.adversarial_register_history(
        **dict(ADVERSARIAL, n_ops=2_000))
    sort_small = dict(engine="sort", frontier=1024, max_frontier=1024)
    agree = [("headline", *hists["headline"], {}),
             ("corrupted", *hists["corrupted"], {}),
             ("adversarial-2k-dense", reg, adv_small, {"engine": "dense"}),
             ("phantom", *hists["phantom"], {}),
             ("counter-2k", models.counter(),
              synth.counter_history(**dict(COUNTER, n_ops=2_000)), {}),
             ("adversarial-2k-sort", reg, adv_small, sort_small)]
    for label, model, hist, kw in agree:
        g = results.get(label) or linearizable(model, **kw).check(
            {}, hist, {})
        t = time.perf_counter()
        c = linearizable(model, device="cpu", **kw).check({}, hist, {})
        cpu_s = time.perf_counter() - t
        for key in ("valid?", "op-index", "max-frontier", "frontier-size",
                    "dedup", "analyzer", "dense-shape", "closure-rounds",
                    "dedup-launches", "host-syncs"):
            if g.get(key) != c.get(key):
                raise AssertionError(f"{label}: {key} gpu {g.get(key)} "
                                     f"!= cpu {c.get(key)}")
        ckw = {k: v for k, v in kw.items() if k != "max_frontier"}
        cg = final_carry(wgl, carry_to_numpy, model, hist, dev, **ckw)
        cc = final_carry(wgl, carry_to_numpy, model, hist, "cpu", **ckw)
        for i, (a, b) in enumerate(zip(cg, cc)):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"{label}: carry element {i} differs")
        log(f"{label}: GPU and CPU agree (verdict {c['valid?']}, "
            f"op-index {c.get('op-index')}, max-frontier "
            f"{c['max-frontier']}, {c['analyzer']} {c['dedup']}, counts, "
            f"final carry of {len(cg)} elements; CPU path {cpu_s:.3f} s)")
    phase_done("agreement with the CPU path")

    # -- where the time goes: the device's busy share ------------------------
    profiles = {}
    for label, kw in (("headline", {}),
                      ("adversarial-dense", {"engine": "dense"}),
                      ("at-cap-dense", {"engine": "dense"}),
                      ("phantom", {})):
        walk = prefix_walk(wgl, *hists[label], dev, **kw)
        profiles[label] = pr = profile_walk(walk, PROFILE_STEPS)
        log(f"profile {label}, first {PROFILE_STEPS} steps: wall "
            f"{pr['wall_s']:.4f} s, device busy "
            f"{pr['device_busy_s']:.4f} s ({100 * pr['busy_share']:.2f}"
            f"%), {pr['kernel_launches']} kernel launches "
            f"({pr['kernel_launches'] / PROFILE_STEPS:.1f} per step); top "
            f"{pr['top']}")
    phase_done("profile")

    # -- phase 5: K1 and K2 with a batch axis ---------------------------------
    k1b = phase_k1_batched(dev, wgl_closure)
    k2b = phase_k2_batched(dev, wgl_dedup)
    phase_done("batched K1 and K2 against their plain versions")

    # -- phase 6: the batch path, on the card and against the CPU -------------
    batch = phase_batch(dev, models, synth, wgl, wgl_closure, wgl_dedup,
                        independent, linearizable, _platform, carry_to_numpy)
    phase_done("batch path")

    if any(m == "jax" or m.startswith("jax.") or m == "jepsen_tpu"
           or m.startswith("jepsen_tpu.") for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")

    k1_main = k1["shapes"][2]             # the at-cap shape, (8, 19)
    k1_real = k1["shapes"][-1]            # the real table at (8, 19)
    k2_main = k2["shapes"][2]             # stage B at F=256, P=16
    kernels = [{
        "name": "closure_round",
        "route": "cuda",
        "source": wgl_closure.SOURCE,
        "replaces": wgl_closure.REPLACES,
        "launches": main_launches["closure_round"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1_main["ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": None,
        "shape": [k1_main["S"], k1_main["P"]],
        "real_table_ms": k1_real["ms"],
        "real_table_bound_ms": k1_real["bound_ms"],
        "shapes": k1["shapes"],
    }, {
        "name": "dedup",
        "route": "cuda",
        "source": wgl_dedup.SOURCE,
        "replaces": wgl_dedup.REPLACES,
        "launches": main_launches["dedup"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        # torch.unique computes a different function (key order, no new
        # flags, no digest): no PyTorch call computes K2's
        "library_ms": None,
        "unique_ms": k2_main["unique_ms"],
        "shape": [k2_main["N"], k2_main["F"]],
        "shapes": k2["shapes"],
    }]
    # the batched launches: K1 at the hazelcast batch's largest group
    # (64 tables of 8 x 2^6), K2 at the counter batch's stage B
    k1b_main = next(r for r in k1b["shapes"] if r["B"] == 64)
    k2b_main = k2b["shapes"][-1]
    for kname, mod, row, err, launches, shape in (
            ("closure_round_batched", wgl_closure, k1b_main,
             k1b["max_abs_err"], batch["dense"]["k1_launches"],
             [k1b_main["B"], k1b_main["S"], k1b_main["P"]]),
            ("dedup_batched", wgl_dedup, k2b_main, k2b["max_abs_err"],
             batch["sort"]["k2_launches"],
             [k2b_main["B"], k2b_main["N"], k2b_main["F"]])):
        kernels.append({
            "name": kname, "route": "cuda", "source": mod.SOURCE,
            # the same TPU kernel, under jax.vmap in the batch entry
            "replaces": mod.REPLACES, "launches": launches,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "scalar_turns_ms": row["scalar_turns_ms"],
            "shape": shape,
            "shapes": (k1b if mod is wgl_closure else k2b)["shapes"]})
    if args.out:
        write_report(args.out, {
            "device": name, "nvidia_smi": smi, "phase_s": phase_s,
            "peak_gb": peak_gb, "kernels": kernels,
            "profiles": profiles, "batch": batch,
            "main_path": {k: {f: v for f, v in r.items()
                              if f not in ("configs", "final-paths", "op",
                                           "previous-ok")}
                          for k, r in results.items()}})
    log(f"peak device memory on the main path: {peak_gb:.3f} GiB")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
