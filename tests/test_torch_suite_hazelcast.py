"""Every case of tests/test_suite_hazelcast.py (the CP shim's HTTP data
plane, the semaphore checker, ServerDB commands, and a hermetic core.run
of each workload against `cp_shim.serve()`) run on the port's hazelcast
suite.

The suite's linearizability checkers (lock, cas-register, queue-linear,
crdt-map-linear) check on CUDA unless the opts name a device; an autouse
fixture fills in device="cpu" when the opts given to `hazelcast_test`
name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import hazelcast

globals().update(torch_mirror.cases("test_suite_hazelcast"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, hazelcast, "hazelcast_test")
