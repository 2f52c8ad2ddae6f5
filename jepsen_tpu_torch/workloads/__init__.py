"""Workload bundles: generator + checker (+ model) packages for standard
consistency tests, mirroring the reference's `jepsen/src/jepsen/tests/`
namespace family.

The port's counterpart of `jepsen_tpu/workloads/`, with the three
workloads whose checkers reach the card: `linearizable_register`
(batched WGL through the independent checker), `append` and `wr` (the
Elle checkers). Each takes opts['device'] for its checker.

Each module exposes a `workload(...)`/`test(...)` builder returning a dict
with at least 'generator' and 'checker' entries, merged into a test map by
suites (pattern: `zookeeper.clj:106-129`).
"""

from . import append, linearizable_register, wr  # noqa: F401

__all__ = ["append", "linearizable_register", "wr"]
