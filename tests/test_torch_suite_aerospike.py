"""Every case of tests/test_suite_aerospike.py (the wire client against
tests/fake_aerospike.py, the capped kill nemesis, DB commands over the
dummy remote, and hermetic core.run runs) run on the port's aerospike
suite.

The suite's cas-register and counter linearizability checkers check on
CUDA unless the opts name a device; an autouse fixture fills in
device="cpu" when the opts given to `aerospike_test` name none.

tests/fake_aerospike.py encodes with the JAX package's protocol module
(`jepsen_tpu.suites.as_proto`) while the port's client decodes with its
own copy: the cases are also a wire-level parity check of the two
copies."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import aerospike

globals().update(torch_mirror.cases("test_suite_aerospike"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, aerospike, "aerospike_test")
