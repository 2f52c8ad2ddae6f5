"""List-append workload bundle (reference
`jepsen/src/jepsen/tests/cycle/append.clj`): clients append unique values
to per-key lists and read whole lists; the Elle-class checker infers the
dependency graph and hunts cycles on the card
(opts['device'], CUDA when it is absent)."""

from __future__ import annotations

from ..checker import elle


def workload(opts: dict | None = None) -> dict:
    """Options: 'key-count', 'min-txn-length', 'max-txn-length',
    'max-writes-per-key', 'anomalies' (default ['G1', 'G2'], matching
    `append.clj:34-40`), 'additional-graphs' (e.g. ('realtime',) per
    `append.clj:48-50`), 'consistency-models' alias accepted."""
    opts = opts or {}
    anomalies = tuple(opts.get("anomalies", ("G1", "G2")))
    return {
        "checker": elle.list_append_checker(
            anomalies, mesh=opts.get("mesh"),
            additional_graphs=tuple(opts.get("additional-graphs", ())),
            device=opts.get("device")),
        "generator": elle.append_gen(
            key_count=opts.get("key-count", 5),
            min_txn_length=opts.get("min-txn-length", 1),
            max_txn_length=opts.get("max-txn-length", 4),
            max_writes_per_key=opts.get("max-writes-per-key", 16)),
    }
