"""Write/read register workload bundle (reference
`jepsen/src/jepsen/tests/cycle/wr.clj`): single-register txns with unique
writes; the Elle-class checker recovers what version order it can and
hunts dependency cycles on the card (opts['device'], CUDA when it is
absent)."""

from __future__ import annotations

from ..checker import elle


def workload(opts: dict | None = None) -> dict:
    opts = opts or {}
    anomalies = tuple(opts.get("anomalies", ("G1", "G2")))
    return {
        "checker": elle.rw_register_checker(
            anomalies, mesh=opts.get("mesh"),
            additional_graphs=tuple(opts.get("additional-graphs", ())),
            device=opts.get("device")),
        "generator": elle.wr_gen(
            key_count=opts.get("key-count", 5),
            min_txn_length=opts.get("min-txn-length", 1),
            max_txn_length=opts.get("max-txn-length", 4),
            max_writes_per_key=opts.get("max-writes-per-key", 16)),
    }
