"""Where a checker's rendered artifacts go.

The port's copy of `out_path` from `jepsen_tpu/checker/perf.py`, the one
function of that module the linearizability checker's failure rendering
(`explain.write_failure_svg`) calls, over the run-directory layout of
the port's `store` (reference `store.clj`): a run lives under
``<store-dir>/<test-name>/<start-time>/``. The latency and rate graphs
are not ported.
"""

from __future__ import annotations

import os

from .. import store


def out_path(test, opts, filename: str) -> str:
    """Path for a rendered artifact in the test's run directory, honoring
    opts['subdirectory'] (the reference's `store/path! test subdirectory
    file` idiom); creates the parent directories."""
    sub = (opts or {}).get("subdirectory")
    p = store.path(test, *([sub] if sub else []), filename)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    return p
