#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (jepsen_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out REPORT.json]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, in order; any failure raises and exits non-zero:

  1. print the card (torch's name, and nvidia-smi's name and power limit)
     and build every kernel under jepsen_tpu_torch/csrc with nvcc;
  2. hold K1 (the dense closure round) bit-exact against its plain PyTorch
     version on the card over a shape matrix, several rounds each, then
     time both with CUDA events at the main path's shapes;
  3. drive the main path — `linearizable(cas_register()).check(...)` — on
     the headline 10k-op register history, the adversarial crashed-writes
     history, the concurrency-11 history on the full 2^22-cell table
     (engine="dense") and a corrupted headline, with K1's launch count set
     to 0 just before and read just after; then hold the verdicts, culprit
     ops, max-frontier and final carries against the port's own CPU path,
     and trace the first 1,500 steps of each history with torch.profiler
     for the device's busy share;
  4. print one JSON line of per-kernel numbers, the nvidia-smi line, and
     last the line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or without the package beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
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
K1_MATRIX = [(8, 7), (8, 14), (8, 19), (16, 7), (30, 8), (256, 10),
             (512, 12)]
K1_TIMED = [(8, 7), (8, 14), (8, 19)]
PROFILE_STEPS = 1_500


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


def in_turns(timer, kernel, plain, iters) -> tuple[float, float]:
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain), each the mean of its two turns."""
    p1 = timer(plain, max(iters // 4, 10))
    k1 = timer(kernel, iters)
    k2 = timer(kernel, iters)
    p2 = timer(plain, max(iters // 4, 10))
    return (k1 + k2) / 2, (p1 + p2) / 2


def k1_bound(S, P, mft) -> tuple[float, str, int, int]:
    """The least time an H100 could take for one round on these inputs:
    the larger of bytes (table read once and written once as uint8,
    plus mft) over HBM bandwidth and the AND-ORs the data needs (each
    set mft[p, q, s] against the C/2 columns with bit p set, an AND and
    an OR each) over the fp32 rate."""
    C = 1 << P
    nbytes = 2 * S * C + P * S * S
    ops = 2 * int(mft.sum().item()) * (C // 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def phase_k1(dev, wgl_closure) -> dict:
    closure_round = wgl_closure.closure_round
    plain = wgl_closure.closure_round_plain
    rng = np.random.default_rng(SEED)
    max_err = 0
    for S, P in K1_MATRIX:
        tb, mft = random_inputs(S, P, rng, dev)
        for r in range(4):
            got = closure_round(tb, mft)
            want = plain(tb, mft)
            torch.cuda.synchronize()
            err = int((got.to(torch.int16) - want.to(torch.int16))
                      .abs().max().item())
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 != plain at S={S} P={P} "
                                     f"round {r}")
            tb = got
        log(f"K1 bit-exact vs plain: S={S} P={P}, 4 rounds, "
            f"{int(tb.sum().item())} cells set")
    shapes = []
    for S, P in K1_TIMED:
        tb, mft = transition_inputs(S, P, rng, dev)
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
        row = dict(S=S, P=P, ms=ms, plain_ms=plain_ms, eager_ms=eager_ms,
                   plain_eager_ms=plain_eager_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, and_or_ops=ops)
        shapes.append(row)
        log(f"K1 time S={S} P={P}: {ms:.6f} ms on the device "
            f"({eager_ms:.6f} ms per eager call); plain {plain_ms:.6f} ms "
            f"({plain_eager_ms:.6f} ms eager); bound {bound_ms:.6f} ms by "
            f"{bound_by}")
    return {"max_abs_err": max_err, "shapes": shapes}


def prefix_walk(wgl, model, hist, device, engine="auto"):
    """A function walking the first n merged steps of `hist` on the
    dense engine, as analysis_gpu's walk does."""
    ops, dec = wgl.plan_dense(model, hist, engine=engine)
    s_lo, S, P = dec.dense
    steps = wgl.build_steps(ops, P)
    xs = wgl.stage_steps(steps.x, device)
    k = wgl.DenseKernel(model.device_model, s_lo, S, P, device)
    init = model.device_state()
    return lambda n: k.check_chunk(xs, n, k.init_carry(init))


def profile_walk(walk, n) -> dict:
    """Where one walk's time goes: its wall time unprofiled, and the
    device time of every kernel in a torch.profiler trace of a second
    run (kernel durations are device-side, so the profiler's host
    overhead does not inflate them). Kernels run on one stream, so their
    sum is the device's busy time."""
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in top]}


def final_carry(wgl, carry_to_numpy, model, hist, device, engine="auto"):
    """The dense engine's carry after the whole merged stream."""
    ops, dec = wgl.plan_dense(model, hist, engine=engine)
    s_lo, S, P = dec.dense
    steps = wgl.build_steps(ops, P)
    k = wgl.DenseKernel(model.device_model, s_lo, S, P, device)
    carry = k.check_chunk(wgl.stage_steps(steps.x, device), steps.n,
                          k.init_carry(model.device_state()))
    return carry_to_numpy(carry)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import _build, models
    from jepsen_tpu_torch.carry import carry_to_numpy
    from jepsen_tpu_torch.checker import synth, wgl, wgl_closure
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
            if "registers" in line or "spill" in line or "error" in line:
                log(f"ptxas[{src}]: {line.strip()}")
    log(f"built {sorted(build_logs) or 'nothing (fresh)'}")
    phase_done("build")

    # -- phase 2: K1 against its plain version --------------------------------
    k1 = phase_k1(dev, wgl_closure)
    phase_done("K1 against its plain version")

    # -- phase 3: the main path -------------------------------------------------
    model = models.cas_register()
    head = synth.register_history(**HEADLINE)
    bad = synth.corrupt(head, value=HEADLINE["values"])
    runs = [("headline", head, {}, True, 7),
            ("adversarial", synth.adversarial_register_history(
                **ADVERSARIAL), {}, True, 14),
            ("at-cap", synth.adversarial_register_history(**AT_CAP),
             {"engine": "dense"}, True, 19),
            ("corrupted", bad, {}, False, 7)]
    runs_by = {label: hist for label, hist, *_ in runs}
    results = {}
    wgl_closure.LAUNCHES = 0
    for label, hist, kw, valid, p_want in runs:
        before = wgl_closure.LAUNCHES
        t = time.perf_counter()
        r = linearizable(model, **kw).check({}, hist, {})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = wgl_closure.LAUNCHES - before
        results[label] = dict(r, wall_s=wall, launches=launches)
        log(f"{label}: valid?={r['valid?']} op-index={r.get('op-index')} "
            f"shape={r['dense-shape']} max-frontier={r['max-frontier']} "
            f"wall={wall:.3f} s K1 launches={launches} "
            f"host syncs={r['host-syncs']}")
        if r["valid?"] is not valid or r["analyzer"] != "gpu-wgl-dense":
            raise AssertionError(f"{label}: {r['valid?']} "
                                 f"{r['analyzer']}")
        if r["dense-shape"][1:] != [8, p_want]:
            raise AssertionError(f"{label}: shape {r['dense-shape']}")
        if launches <= 0 or launches != r["closure-rounds"]:
            raise AssertionError(f"{label}: {launches} K1 launches for "
                                 f"{r['closure-rounds']} rounds")
        if not valid and not isinstance(r.get("op-index"), int):
            raise AssertionError(f"{label}: no op-index")
    main_launches = wgl_closure.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    phase_done("main path")

    # -- agreement with the port's CPU path -----------------------------------
    adv_small = synth.adversarial_register_history(
        **dict(ADVERSARIAL, n_ops=2_000))
    for label, hist in (("headline", head), ("corrupted", bad),
                        ("adversarial-2k", adv_small)):
        g = results.get(label) or linearizable(model).check({}, hist, {})
        t = time.perf_counter()
        c = linearizable(model, device="cpu").check({}, hist, {})
        cpu_s = time.perf_counter() - t
        for key in ("valid?", "op-index", "max-frontier", "dense-shape",
                    "closure-rounds", "host-syncs"):
            if g.get(key) != c.get(key):
                raise AssertionError(f"{label}: {key} gpu {g.get(key)} "
                                     f"!= cpu {c.get(key)}")
        cg = final_carry(wgl, carry_to_numpy, model, hist, dev)
        cc = final_carry(wgl, carry_to_numpy, model, hist, "cpu")
        for i, (a, b) in enumerate(zip(cg, cc)):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"{label}: carry element {i} differs")
        log(f"{label}: GPU and CPU agree (verdict {c['valid?']}, "
            f"op-index {c.get('op-index')}, max-frontier "
            f"{c['max-frontier']}, final carry; CPU path {cpu_s:.3f} s)")
    phase_done("agreement with the CPU path")

    # -- where the time goes: the device's busy share ------------------------
    profiles = {}
    for label, kw in (("headline", {}), ("adversarial", {}),
                      ("at-cap", {"engine": "dense"})):
        walk = prefix_walk(wgl, model, runs_by[label], dev, **kw)
        profiles[label] = pr = profile_walk(walk, PROFILE_STEPS)
        log(f"profile {label}, first {PROFILE_STEPS} steps: wall "
            f"{pr['wall_s']:.4f} s, device busy "
            f"{pr['device_busy_s']:.4f} s ({100 * pr['busy_share']:.2f}"
            f"%), {pr['kernel_launches']} kernel launches; top "
            f"{pr['top']}")
    phase_done("profile")

    if any(m == "jax" or m.startswith("jax.") or m == "jepsen_tpu"
           or m.startswith("jepsen_tpu.") for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")

    main = k1["shapes"][-1]           # the at-cap shape, (8, 19)
    kernels = [{
        "name": "closure_round",
        "route": "cuda",
        "source": wgl_closure.SOURCE,
        "replaces": wgl_closure.REPLACES,
        "launches": main_launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": [main["S"], main["P"]],
        "shapes": k1["shapes"],
    }]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        report = {"device": name, "nvidia_smi": smi, "phase_s": phase_s,
                  "peak_gb": peak_gb, "kernels": kernels,
                  "profiles": profiles,
                  "main_path": {k: {f: v for f, v in r.items()
                                    if f not in ("configs", "final-paths",
                                                 "op", "previous-ok")}
                                for k, r in results.items()}}
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    log(f"peak device memory: {peak_gb:.3f} GiB")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
