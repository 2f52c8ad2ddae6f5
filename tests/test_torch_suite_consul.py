"""Every case of tests/test_suite_consul.py (the registry, the DB
commands over the dummy remote, the index-CAS client against the file's
in-process fake consul KV over real HTTP, a refused connection as a
definite fail, and a hermetic suite run) run on the port's consul suite.

The suite's checker compose checks its register on CUDA unless the opts
name a device; an autouse fixture fills in device="cpu" when the opts
given to `consul_test` name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import consul

globals().update(torch_mirror.cases("test_suite_consul"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, consul, "consul_test")
