"""Every case of tests/test_suite_zookeeper.py (node ids, zoo.cfg and
the DB commands over the dummy remote, the jute wire client against
tests/fake_zk.py over real TCP, the register client's semantics and
connection errors, the test map, and a hermetic suite run) run on the
port's zookeeper suite.

The suite's checker compose checks its register on CUDA unless the
opts name a device; an autouse fixture fills in device="cpu" when the
opts given to `zk_test` name none.

tests/fake_zk.py decodes and encodes with the JAX package's protocol
module (`jepsen_tpu.suites.zk_proto`) while the port's client speaks
through its own copy: the wire cases are also a check of the two copies
on the wire."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import zookeeper

globals().update(torch_mirror.cases("test_suite_zookeeper"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, zookeeper, "zk_test")
