"""K3-sort on the card alone: where a sort step's time goes.

Runs, from `chip_smoke.py`, phase 1's build of K3-sort (with ptxas's
registers, stack and spills), phase 4b's K3-sort walks against the eager
walk with each walk's phase split (`wgl_sortwalk.PHASE_NS`) and the library
yardstick, then the main path's four sort runs (phantom, counter, at-cap,
adversarial) held to their expectations, the two escalations pass by
pass. Needs one CUDA device; prints one JSON line of the report last and,
with --out, writes it there too.

    python3 tools/k3s_split.py [--out REPORT.json] [--skip-walks]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--skip-walks", action="store_true",
                    help="only the main path's sort runs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3s_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from jepsen_tpu_torch import _build, models
    from jepsen_tpu_torch.carry import carry_to_numpy
    from jepsen_tpu_torch.checker import streaming, synth, wgl
    from jepsen_tpu_torch.checker.linear import linearizable

    dev = torch.device("cuda")
    cs.log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.nvidia_smi_line()}")
    t = time.perf_counter()
    for src, text in _build.build(["sort_walk"]).items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                        "spill", "error", "stack")):
                cs.log(f"ptxas[{src}]: {line.strip()}")
    cs.log(f"build {time.perf_counter() - t:.1f} s")
    report = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": cs.nvidia_smi_line()}
    cs.walk_syncs()
    passes = cs.sort_passes()
    if not args.skip_walks:
        t = time.perf_counter()
        head = synth.register_history(**cs.HEADLINE)
        report["k3s"] = cs.phase_k3s(dev, models, synth, wgl, streaming,
                                     carry_to_numpy, head)
        cs.log(f"phase 4b's K3-sort walks {time.perf_counter() - t:.1f} s")
    report["main_path"] = {}
    for label, model, hist, kw, expect in cs.main_path_runs(models, synth):
        if expect[1] != "gpu-wgl":
            continue
        cs.zero_launches()
        before = cs.launch_counts()
        passes.take()
        t = time.perf_counter()
        r = linearizable(model, **kw).check({}, hist, {})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k: v - before[k] for k, v in cs.launch_counts().items()}
        got = passes.take()
        cs.log(f"{label}: valid?={r['valid?']} dedup={r['dedup']} "
               f"frontier-size={r['frontier-size']} max-frontier="
               f"{r['max-frontier']} wall={wall:.3f} s K3-sort launches="
               f"{launches['k3s_launches']} rounds {launches['k3s_rounds']} "
               f"hash dedups {launches['k3s_dedups']} error={r.get('error')}")
        cs.log_passes(label, got)
        cs.check_run(label, r, launches, expect)
        report["main_path"][label] = {
            "valid?": r["valid?"], "wall_s": wall, "passes": got,
            "frontier-size": r["frontier-size"], **launches}
    cs.walk_syncs().hold()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        cs.write_report(args.out, report)
    cs.log(json.dumps({"ok": True, "main_path": {
        k: (v["valid?"], round(v["wall_s"], 4))
        for k, v in report["main_path"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
