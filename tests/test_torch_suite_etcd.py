"""Every case of tests/test_suite_etcd.py (the v3 JSON-gateway client
against tests/fake_etcd.py, DB commands over the dummy remote, and a
hermetic core.run of each workload) run on the port's etcd suite.

The suite's register workload's independent checker check on CUDA unless
the opts name a device; an autouse fixture fills in device="cpu" when
the opts given to `etcd_test` name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import etcd

globals().update(torch_mirror.cases("test_suite_etcd"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, etcd, "etcd_test")
