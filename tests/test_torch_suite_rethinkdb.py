"""The rethinkdb cases of tests/test_suites_small.py (a ReQL round trip
through the port's `reql_proto`, the document CAS client, the DB
commands over the dummy remote, and hermetic core.run runs of the
document-cas workload, one against a fake that serves a phantom read)
run on the port's rethinkdb suite. That file's other cases run in
tests/test_torch_suites_small.py, so they are left out here.

The suite's document-cas workload checks on CUDA unless the opts name a
device; an autouse fixture fills in device="cpu" when the opts given to
`rethinkdb_test` name none.

tests/fake_rethinkdb.py decodes and encodes with the JAX package's
protocol module (`jepsen_tpu.suites.reql_proto`) while the port's client
speaks through its own copy: the cases are also a wire-level parity
check of the two copies."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import rethinkdb

globals().update(torch_mirror.cases(
    "test_suites_small",
    drop_statements=(r"(?m)^def test_(?!reql|rethinkdb)",)))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, rethinkdb, "rethinkdb_test")
