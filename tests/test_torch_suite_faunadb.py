"""Every case of tests/test_suite_faunadb.py (the query builder and the
HTTP client against tests/fake_fauna.py, temporal reads, aborts, index
pagination, error classification, the read-skew, timestamp-order and
monotonic checkers, the topology state machine, every workload through
a hermetic core.run, with the topology and partition nemeses, the
workload menu, the test-all sweep and the plotter) run on the port's
faunadb suite.

The suite's register workload's independent checker checks on CUDA
unless the opts name a device; an autouse fixture fills in
device="cpu" when the opts given to `faunadb_test` name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import faunadb

globals().update(torch_mirror.cases("test_suite_faunadb"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, faunadb, "faunadb_test")
