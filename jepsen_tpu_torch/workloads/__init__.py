"""Workload bundles: generator + checker (+ model) packages for standard
consistency tests, mirroring the reference's `jepsen/src/jepsen/tests/`
namespace family.

The port's counterpart of `jepsen_tpu/workloads/`. Five workloads'
checkers reach the card and take opts['device'] for it (CUDA when it is
absent): `linearizable_register` (batched WGL through the independent
checker) and the Elle checkers of `append`, `wr`, `monotonic` and
`sequential`. The other seven check on the host.

Each module exposes a `workload(...)`/`test(...)` builder returning a dict
with at least 'generator' and 'checker' entries, merged into a test map by
suites (pattern: `zookeeper.clj:106-129`).
"""

from . import adya, append, bank, causal, causal_reverse, comments, \
    linearizable_register, long_fork, monotonic, sequential, table, \
    wr  # noqa: F401

__all__ = ["adya", "append", "bank", "causal", "causal_reverse",
           "comments", "linearizable_register", "long_fork", "monotonic",
           "sequential", "table", "wr"]
