"""K3 on the card alone: phase 4b's K3 walks, timed, in this tree and in
another checkout of the port (an earlier K3 design), in turns.

    python3 tools/k3_compare.py [--other DIR] [--order TOOT] [--threshold]
                                [--out REPORT.json]

Each side runs in a subprocess of its own, since both trees name their
package `jepsen_tpu_torch`: `--worker DIR` imports the package from DIR,
builds its K3 (printing ptxas's registers and spills a kernel, once a
tree) and walks, with K3 on the card, the headline, the adversarial and
concurrency-11 histories forced dense, a rabbitmq-shaped mutex, the
hazelcast batch's four dense groups and the dense stream's first three
chunks (`chip_smoke`'s phase 4b shapes). For each walk it reports the
wall of a warm run (host clock, ending in a synchronise), K3's device
time and the device operations (kernels, copies, memsets) in a
torch.profiler trace of another run, K3's launches, steps, pair rounds,
rounds, the tier where the tree names one (`wgl_walk.tier`), the bound
of `chip_smoke.k3_bound` (this tree's, for both sides) and a digest of
the final carry; the parent process holds every side's carries equal.
`--order` runs the sides in that order (T this tree, O the other;
default TOOT, or T alone without --other). `--threshold` walks instead,
on this tree only, the headline, the mutex, forced-dense walks at
P = 9-13 (their first 600 steps) and the hazelcast groups with every
table on a block (`--warp-max-words 0`) and on a warp wherever it fits,
in turns, to place `wgl_walk.WARP_MAX_WORDS`. Needs one CUDA device; prints one JSON
line of the report last and, with --out, writes it there too.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
THRESHOLD_STEPS = 600


def _this_chip_smoke():
    """This tree's chip_smoke, loaded by path (the other tree's package
    may be first on sys.path): its helpers take the package's modules as
    arguments."""
    spec = importlib.util.spec_from_file_location("k3_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(carry_to_numpy, carry) -> str:
    h = hashlib.sha256()
    for a in carry_to_numpy(carry):
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _device_profile(walk) -> dict:
    """K3's device ms and launches, and every device operation, in a
    torch.profiler trace of one walk."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        walk()
        torch.cuda.synchronize()
    ops = collections.Counter()
    k3_ns = k3_n = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        kind = ("memcpy" if "emcpy" in name else
                "memset" if "emset" in name else "kernel")
        ops[kind] += 1
        if "dense_walk" in name:
            k3_ns += e.duration_ns()
            k3_n += 1
    return {"k3_device_ms": k3_ns / 1e6, "k3_profiled_launches": k3_n,
            "device_ops": sum(ops.values()), "device_ops_by_kind": dict(ops)}


def worker(tree: Path, warp_max_words: int | None, threshold: bool) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    cs = _this_chip_smoke()
    from jepsen_tpu_torch import _build, models
    from jepsen_tpu_torch.carry import carry_to_numpy
    from jepsen_tpu_torch.checker import streaming, synth, wgl, wgl_walk
    if not str(Path(wgl.__file__).resolve()).startswith(str(tree.resolve())):
        raise SystemExit(f"k3_compare: imported {wgl.__file__}, not {tree}")
    if warp_max_words is not None:
        wgl_walk.WARP_MAX_WORDS = warp_max_words
    dev = torch.device("cuda")
    report = {"tree": str(tree), "warp_max_words": warp_max_words,
              "device": torch.cuda.get_device_name(0),
              "nvidia_smi": cs.nvidia_smi_line(), "ptxas": [], "walks": {}}
    t = time.perf_counter()
    for text in _build.build(["dense_walk"]).values():
        report["ptxas"] = [ln.strip() for ln in text.splitlines() if any(
            w in ln for w in ("entry function", "registers", "spill"))]
    report["build_s"] = time.perf_counter() - t
    reg = models.cas_register()

    def steps_of(x, e_start, e_end):
        """Steps walked, and those with a completion, between two e's."""
        x = x.reshape(-1, x.shape[-2], x.shape[-1])
        e_start = np.broadcast_to(e_start, (x.shape[0],))
        e_end = np.broadcast_to(e_end, (x.shape[0],))
        comp = sum(int((x[b, e_start[b]:e_end[b], 0] != 0).sum())
                   for b in range(x.shape[0]))
        return int((e_end - e_start).sum()), comp

    def run(label, k, walk, keys, count_steps):
        walk(k)                                   # warm
        torch.cuda.synchronize()
        l0, p0, r0 = wgl_walk.LAUNCHES, wgl_walk.PAIR_ROUNDS, k.rounds
        t = time.perf_counter()
        carry = walk(k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = wgl_walk.LAUNCHES - l0
        pairs = wgl_walk.PAIR_ROUNDS - p0
        rounds = k.rounds - r0
        prof = _device_profile(lambda: walk(k))
        steps, comp = count_steps(carry_to_numpy(carry))
        bound_ms, bound_by = cs.k3_bound(k.S, k.P, keys, launches, steps,
                                         comp, pairs)
        row = {"S": k.S, "P": k.P, "keys": keys, "wall_s": wall,
               "k3_launches": launches, "steps": steps,
               "completions": comp, "pair_rounds": pairs, "rounds": rounds,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tier": (wgl_walk.tier(keys, k.S, k.P)
                        if hasattr(wgl_walk, "tier") else None),
               "carry": _digest(carry_to_numpy, carry), **prof}
        row["device_ms_a_step"] = row["k3_device_ms"] / max(steps, 1)
        row["device_ops_a_launch"] = row["device_ops"] / max(
            prof["k3_profiled_launches"], 1)
        report["walks"][label] = row
        cs.log(f"{label} (S={k.S}, P={k.P}, keys {keys}, tier "
               f"{row['tier']}): wall {wall:.6f} s, K3 device "
               f"{row['k3_device_ms']:.6f} ms over {launches} launches "
               f"({row['device_ms_a_step']:.7f} ms a step, {steps} steps), "
               f"{row['device_ops']} device ops "
               f"({row['device_ops_a_launch']:.2f} a launch: "
               f"{prof['device_ops_by_kind']}); bound {bound_ms:.6f} ms by "
               f"{bound_by}; carry {row['carry']}")

    def single(label, model, hist, kw, limit=None):
        pl = wgl.plan(model, hist, **kw)
        steps = wgl.build_steps(pl.ops, pl.slots)
        xs = wgl.stage_steps(steps.x, dev)
        init = model.device_state()
        stop = steps.n if limit is None else min(limit, steps.n)
        run(label, pl.kernel(dev, 256),
            lambda k: k.check_chunk(xs, stop, k.init_carry(init)), 1,
            lambda c: steps_of(steps.x, 0, int(c[0])))

    adv = synth.adversarial_register_history(**cs.ADVERSARIAL)
    head = synth.register_history(**cs.HEADLINE)
    (_reg, hz), _ = cs.batch_histories(models, synth)

    def hazelcast():
        for P, make, xs, ns, init in cs.dense_groups(wgl, reg, hz, dev):
            run(f"hazelcast P={P} ({len(ns)} rows)", make(),
                lambda k: k.check_chunk_batch(xs, ns,
                                              k.init_carry_batch(init)),
                len(ns), lambda c, xs=xs: steps_of(xs.host, 0, c[0]))

    if threshold:
        # S = 8 tables of 32 (the headline) to 2,048 words (P = 13):
        # adversarial histories at concurrency c hold P = c + 8 slots
        single("headline", reg, head, {})
        single("rabbitmq-mutex", models.mutex(),
               cs.mutex_history(cs.K3_MUTEX_OPS), {})
        for conc in (1, 2, 3, 4, 5):
            h = synth.adversarial_register_history(
                **dict(cs.ADVERSARIAL, concurrency=conc))
            single(f"adversarial-dense conc {conc}, first "
                   f"{THRESHOLD_STEPS} steps", reg, h, {"engine": "dense"},
                   THRESHOLD_STEPS)
        hazelcast()
        return report
    single("headline", reg, head, {})
    single("adversarial-dense", reg, adv, {"engine": "dense"})
    single("at-cap-dense", reg, synth.adversarial_register_history(
        **cs.AT_CAP), {"engine": "dense"})
    single("rabbitmq-mutex", models.mutex(),
           cs.mutex_history(cs.K3_MUTEX_OPS), {})
    hazelcast()
    (s_lo, S, P), chunks = cs.stream_chunks(wgl, streaming, reg, adv, dev,
                                            cs.K3_STREAM_CHUNKS)

    def stream_walk(k):
        carry = chunks[0][2]
        for x, n, _before in chunks:
            carry = k.check_stream_chunk(wgl.stage_steps(x, dev), n, carry)
        return carry

    n_steps = sum(n for _x, n, _c in chunks)
    comp = sum(int((x[:n, 0] != 0).sum()) for x, n, _c in chunks)
    run(f"dense stream, first {len(chunks)} chunks",
        wgl.DenseKernel(reg.device_model, s_lo, S, P, dev), stream_walk, 1,
        lambda c: (n_steps, comp))
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--order", help="T (this tree) and O (the other)")
    ap.add_argument("--threshold", action="store_true",
                    help="place WARP_MAX_WORDS (this tree only)")
    ap.add_argument("--out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--warp-max-words", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_compare: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        rep = worker(Path(args.worker), args.warp_max_words, args.threshold)
        print("K3_COMPARE " + json.dumps(rep))
        return 0
    if args.threshold:
        # every table on a block, then on a warp wherever four keys' pairs
        # fit a block's shared memory (up to P = 14 at S = 8), in turns
        sides = [("T", 0), ("T", 1 << 20), ("T", 1 << 20), ("T", 0)]
    else:
        order = args.order or ("TOOT" if args.other else "T")
        sides = [(c, None) for c in order]
    runs = []
    for side, wmw in sides:
        tree = ROOT if side == "T" else Path(args.other)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(tree)]
        if wmw is not None:
            cmd += ["--warp-max-words", str(wmw)]
        if args.threshold:
            cmd.append("--threshold")
        t = time.perf_counter()
        p = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                           timeout=1800)
        rep = None
        for line in p.stdout.splitlines():
            if line.startswith("K3_COMPARE "):
                rep = json.loads(line[len("K3_COMPARE "):])
            else:
                print(line, flush=True)
        if p.returncode != 0 or rep is None:
            print(f"k3_compare: side {side} failed ({p.returncode})",
                  file=sys.stderr)
            return 1
        rep.update(side=side, process_s=time.perf_counter() - t)
        runs.append(rep)
    # every side walked to the same carries
    for label in runs[0]["walks"]:
        digests = {r["walks"][label]["carry"] for r in runs}
        if len(digests) != 1:
            print(f"k3_compare: {label}: carries differ across sides "
                  f"{digests}", file=sys.stderr)
            return 1
    report = {"runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"ok": True, "sides": [
        (r["side"], r["warp_max_words"], {
            k: (round(v["wall_s"], 6), round(v["device_ms_a_step"], 7),
                v["tier"]) for k, v in r["walks"].items()})
        for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
