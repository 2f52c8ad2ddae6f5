"""The mongodb cases of tests/test_suites_catalog.py (the document CAS
client and its error classification against tests/fake_mongo.py, and a
hermetic core.run of the register and set workloads) run on the port's
mongodb suite. That file's other cases test suites the port has not
ported yet, so their imports and cases are left out.

The suite's register workload checks on CUDA unless the opts name a
device; an autouse fixture fills in device="cpu" when the opts given to
`mongodb_test` name none.

tests/fake_mongo.py encodes with the JAX package's protocol module
(`jepsen_tpu.suites.bson_proto`) while the port's client decodes with
its own copy: the cases are also a wire-level parity check of the two
copies."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import mongodb

globals().update(torch_mirror.cases(
    "test_suites_catalog",
    drop_statements=(r"^from jepsen_tpu\.suites import \(disque",
                     r"^from jepsen_tpu\.suites\.resp_proto ",
                     r"(?m)^def test_(?!mongodb)")))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, mongodb, "mongodb_test")
