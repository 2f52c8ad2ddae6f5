"""K4 on the card alone: the Elle classifier's buckets, timed, in this tree
and in another checkout of the port (an earlier K4), in turns.

    python3 tools/k4_compare.py [--other DIR] [--order TOOT]
                                [--out REPORT.json]

Each side runs in a subprocess of its own, since both trees name their
package `jepsen_tpu_torch`: `--worker DIR` imports the package from DIR,
builds its K4 (printing ptxas's registers and spills a kernel, once a
tree) and classifies, with `k4.classify` on the card, `chip_smoke`'s
`ELLE_K4_BUCKETS` (random 0/1 blocks from one seed) and the rings'
(4, 4,096) bucket (three 4,000-node rings: pure ww, one rw edge, two).
For each bucket it reports the call's card time by CUDA events
(`chip_smoke.time_ms`: the host's work between launches included), its
device time alone (`chip_smoke.graph_ms`: calls captured in a CUDA graph
and replayed), the host's time to issue a call (host clock over calls
with no synchronise between them), K4's launches, helper launches and
zero fills a call where the tree counts them, and a digest of the flags
and the largest residue; the parent process holds every side's flags
equal and every residue 0. `--order` runs the sides in that order (T
this tree, O the other; default TOOT, or T alone without --other).
Needs one CUDA device; prints one JSON line of the report last and,
with --out, writes it there too.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEED = 19
RING = 4_000


def _this_chip_smoke():
    """This tree's chip_smoke, loaded by path (the other tree's package
    may be first on sys.path)."""
    spec = importlib.util.spec_from_file_location("k4_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rings(e: int, n: int) -> tuple:
    """A (4, e, e) bucket: three n-node rings (pure ww, one rw edge, two
    rw edges) and a zero padding block."""
    import numpy as np
    ww = np.zeros((4, e, e), np.float32)
    wr, rw = np.zeros_like(ww), np.zeros_like(ww)
    for s, rw_at in enumerate(((), (n // 3,), (n // 4, 3 * n // 4))):
        k = np.arange(n)
        on = np.isin(k, rw_at)
        ww[s, k[~on], (k[~on] + 1) % n] = 1.0
        rw[s, k[on], (k[on] + 1) % n] = 1.0
    return ww, wr, rw


def worker(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    cs = _this_chip_smoke()
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.checker.elle import k4, kernels
    if not str(Path(k4.__file__).resolve()).startswith(str(tree.resolve())):
        raise SystemExit(f"k4_compare: imported {k4.__file__}, not {tree}")
    dev = torch.device("cuda")
    report = {"tree": str(tree), "device": torch.cuda.get_device_name(0),
              "nvidia_smi": cs.nvidia_smi_line(), "ptxas": [],
              "buckets": {}}
    t = time.perf_counter()
    for text in _build.build(["elle_closure"]).values():
        report["ptxas"] = [ln.strip() for ln in text.splitlines() if any(
            w in ln for w in ("entry function", "registers", "spill"))]
    report["build_s"] = time.perf_counter() - t
    rng = np.random.default_rng(SEED)
    cases = [(f"({e}, {b})", cs.elle_bucket(e, b, rng))
             for e, b in cs.ELLE_K4_BUCKETS]
    cases.append((f"rings (4, 4096), {RING} nodes", _rings(4096, RING)))
    for label, stacks in cases:
        b, e = stacks[0].shape[:2]
        args = [torch.from_numpy(x).to(dev) for x in stacks]
        steps = kernels._steps(e)

        def call():
            return k4.classify(*args, steps)

        before = (dict(k4.LAUNCHES), k4.HELPER_LAUNCHES,
                  getattr(k4, "MEMSETS", None))
        flags, res = call()
        torch.cuda.synchronize()
        launches = {k: k4.LAUNCHES[k] - before[0][k] for k in k4.KERNELS}
        helpers = k4.HELPER_LAUNCHES - before[1]
        memsets = (None if before[2] is None else k4.MEMSETS - before[2])
        f = flags.cpu().numpy().astype(np.int32)
        iters = 20 if e <= 1024 else 5 if e <= 2048 else 3
        ms = cs.time_ms(call, iters, warmup=2)
        graph = cs.graph_ms(call, max(iters // 2, 2))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            call()
        host = (time.perf_counter() - t) / iters * 1e3
        torch.cuda.synchronize()
        row = {"B": b, "e": e, "ms": ms, "graph_ms": graph,
               "host_issue_ms": host, "launches": launches,
               "helper_launches": helpers, "memsets": memsets,
               "flags": hashlib.sha256(f.tobytes()).hexdigest()[:16],
               "flags_set": f.sum(0).tolist(),
               "residue": int(res.abs().max().item()),
               **cs.elle_bound(kernels, e, b)}
        report["buckets"][label] = row
        cs.log(f"{label}: K4 {ms:.6f} ms a call (events), "
               f"{graph:.6f} ms on the device alone (graph), host issue "
               f"{host:.6f} ms; {launches}, {helpers} helper launches, "
               f"{memsets} zero fills; flags set {row['flags_set']}, "
               f"residue {row['residue']}; bound {row['bound_ms']:.6f} ms")
        del args, flags, res
        torch.cuda.empty_cache()
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--order", help="T (this tree) and O (the other)")
    ap.add_argument("--out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k4_compare: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        print("K4_COMPARE " + json.dumps(worker(Path(args.worker))))
        return 0
    runs = []
    for side in args.order or ("TOOT" if args.other else "T"):
        tree = ROOT if side == "T" else Path(args.other)
        t = time.perf_counter()
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--worker", str(tree)], stdout=subprocess.PIPE,
                           text=True, timeout=1800)
        rep = None
        for line in p.stdout.splitlines():
            if line.startswith("K4_COMPARE "):
                rep = json.loads(line[len("K4_COMPARE "):])
            else:
                print(line, flush=True)
        if p.returncode != 0 or rep is None:
            print(f"k4_compare: side {side} failed ({p.returncode})",
                  file=sys.stderr)
            return 1
        rep.update(side=side, process_s=time.perf_counter() - t)
        runs.append(rep)
    # every side classified alike, with no residue
    for label in runs[0]["buckets"]:
        rows = [r["buckets"][label] for r in runs]
        if len({r["flags"] for r in rows}) != 1 or any(r["residue"]
                                                       for r in rows):
            print(f"k4_compare: {label}: flags differ across sides or a "
                  f"residue is not 0", file=sys.stderr)
            return 1
    report = {"runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"ok": True, "sides": [
        (r["side"], {k: (round(v["ms"], 6), round(v["graph_ms"], 6),
                         round(v["host_issue_ms"], 6))
                     for k, v in r["buckets"].items()}) for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
