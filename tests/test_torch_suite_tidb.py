"""Every case of tests/test_suite_tidb.py (the MySQL wire client against
tests/fake_mysql.py, DB commands over the dummy remote, and a hermetic
core.run of each workload) run on the port's tidb suite.

The suite's append, rw-register, register, monotonic and sequential
checkers check on CUDA unless the opts name a device; an autouse fixture
fills in device="cpu" when the opts given to `tidb_test` name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import tidb

globals().update(torch_mirror.cases("test_suite_tidb"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, tidb, "tidb_test")
