"""The port's graft entry points, twins of the JAX package's
`__graft_entry__.py`.

entry(device=None) — the sort-family WGL check of one encoded history
(the flagship kernel's forward step): `(fn, args)` with `fn(*args)` the
search's (ok, death, overflow, max_count, att).

dryrun_multichip(n, device=None) — the full sharded checking step over
n ranks (the key axis, the checker's data-parallel dimension) on tiny
shapes, with the verdict reduced over the ranks: n spawned ranks under
gloo on the CPU, and on CUDA under NCCL when each rank has its own card,
gloo when they share one.

    python -m jepsen_tpu_torch.graft_entry [--device cpu] [--ranks N]
"""

from __future__ import annotations

import argparse
import functools

import numpy as np

from . import models, parallel
from ._platform import resolve_device
from .checker import synth
from .checker.wgl import (DEDUP_SORT, SortKernel, build_steps,
                          check_batch_sharded, encode_ops_for_model,
                          stage_steps)
from .history import NIL

# the JAX entry's kernel: ("cas-register", F=128, P=16, E=64)
F, P, E = 128, 16, 64


def _example(n_ops: int = 24, seed: int = 0) -> tuple:
    """The JAX entry's history: 24 register ops, seed 0, its steps padded
    to E rows with no-op steps. Returns (x, n) on the host."""
    h = synth.register_history(n_ops, concurrency=3, values=4,
                               crash_rate=0.0, seed=seed)
    st = build_steps(encode_ops_for_model(models.cas_register(), h), P)
    x = np.zeros((E, st.w + 4), np.int32)
    x[:, st.w] = -1                       # no invoke
    x[:, st.w + 2:] = NIL
    x[:st.n] = st.x[:st.n]
    return x, st.n


def entry(device=None) -> tuple:
    """(fn, args): the sort-family check of one encoded history, args
    staged on the device (None = CUDA)."""
    dev = resolve_device(device)
    k = SortKernel("cas-register", F, P, None, DEDUP_SORT, dev)
    x, n = _example()
    return k.check, (stage_steps(x, dev), n, -1)


def _dryrun_rank(n_ranks: int, mesh) -> str:
    """One rank's dryrun: 2n keyed histories, valid, then with key 1
    corrupted; then a list-append history with 3n G1c cycles, each
    checked over the mesh. Returns the closing line."""
    model = models.cas_register()
    hists = [synth.register_history(16, concurrency=3, values=4, seed=s)
             for s in range(2 * n_ranks)]
    all_ok, per_key = check_batch_sharded(model, hists, mesh=mesh,
                                          axis="keys", frontier=128,
                                          slots=16)
    if not (all_ok and per_key.all()):
        raise AssertionError("dryrun histories are valid")
    # and a broken key must flip the collective verdict
    hists[1] = synth.corrupt(hists[1])
    all_ok, per_key = check_batch_sharded(model, hists, mesh=mesh,
                                          axis="keys", frontier=128,
                                          slots=16)
    if all_ok or per_key[1]:
        raise AssertionError("a corrupted key must flip the verdict")
    # and the sharded Elle path: 3n anomaly SCCs, the classifier's batch
    # of blocks sharded over the same ranks
    from .checker.elle import list_append
    eh = synth.inject_append_cycles(synth.append_history(400),
                                    3 * n_ranks, "G1c")
    res = list_append.check(eh, mesh=mesh)
    if res["valid?"] or "G1c" not in res["anomaly-types"]:
        raise AssertionError(f"G1c not found: {res['anomaly-types']}")
    line = (f"dryrun_multichip: {n_ranks} devices, {len(hists)} keyed WGL "
            f"histories + {3 * n_ranks} sharded elle SCC blocks, psum-OR "
            f"verdict OK")
    if mesh.rank == 0:
        print(line, flush=True)
    return line


def dryrun_multichip(n_devices: int, device=None,
                     timeout_s: float = parallel.SPAWN_TIMEOUT_S) -> str:
    """One full sharded checking step over n_devices spawned ranks on
    `device` (None = CUDA); rank 0 prints the closing line, which is
    returned. Raises `parallel.RankError` when a rank fails or the ranks
    outlive timeout_s."""
    dev = resolve_device(device)
    lines = parallel.spawn(functools.partial(_dryrun_rank, n_devices),
                           n_devices, device=dev, timeout_s=timeout_s)
    return lines[0]


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="dryrun ranks (default: the CUDA cards, up to 8; "
                         "1 on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fn, fargs = entry(dev)
    print("entry ok:", fn(*fargs))
    ranks = args.ranks or (min(8, torch.cuda.device_count())
                           if dev.type == "cuda" else 1)
    dryrun_multichip(ranks, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
