"""Where a checker's rendered artifacts go.

The port's copy of `out_path` from `jepsen_tpu/checker/perf.py`, the one
function of that module the linearizability checker's failure rendering
(`explain.write_failure_svg`) calls, with the run-directory layout of
`jepsen_tpu/store.py` (reference `store.clj`): a run lives under
``<store-dir>/<test-name>/<start-time>/``. The latency and rate graphs
are not ported.
"""

from __future__ import annotations

import os


def out_path(test, opts, filename: str) -> str:
    """Path for a rendered artifact in the test's run directory, honoring
    opts['subdirectory'] (the reference's `store/path! test subdirectory
    file` idiom); creates the parent directories."""
    sub = (opts or {}).get("subdirectory")
    p = os.path.join(test.get("store-dir") or "store",
                     str(test.get("name", "noname")),
                     str(test.get("start-time") or "unknown"),
                     *([str(sub)] if sub else []), filename)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    return p
