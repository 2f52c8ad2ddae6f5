"""Every case of tests/test_suite_cockroach.py (the PostgreSQL wire
client against tests/fake_pg.py, DB and clock-nemesis commands over the
dummy remote, and a hermetic core.run of each workload) run on the
port's cockroach suite.

The suite's rw-register, register, monotonic and sequential checkers
check on CUDA unless the opts name a device; an autouse fixture fills in
device="cpu" when the opts given to `cockroach_test` name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import cockroach

globals().update(torch_mirror.cases("test_suite_cockroach"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, cockroach, "cockroach_test")
