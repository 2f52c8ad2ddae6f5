"""Every case of tests/test_suite_mongodb_smartos.py (the registry, the
SmartOS pkgin/svcadm commands and pkgin version parsing over the dummy
remote, the DB commands, the transfer client against tests/fake_mongo.py
and its transport errors, and a hermetic core.run of each workload) run
on the port's mongodb-smartos suite and `os_.smartos`.

The suite's register workload checks on CUDA unless the opts name a
device; an autouse fixture fills in device="cpu" when the opts given to
`mongodb_smartos_test` name none.

tests/fake_mongo.py encodes with the JAX package's protocol module
(`jepsen_tpu.suites.bson_proto`) while the port's client decodes with
its own copy: the cases are also a check of the two copies on the
wire."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import mongodb_smartos

globals().update(torch_mirror.cases("test_suite_mongodb_smartos"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, mongodb_smartos, "mongodb_smartos_test")
