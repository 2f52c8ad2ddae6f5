"""Every case of tests/test_suite_dgraph.py (the HTTP transaction client
against tests/fake_dgraph.py, its error classification and tracing
spans, the bank, set, upsert, register, long-fork and wr workloads
through a hermetic core.run, the nemesis menu, the plotters and the
test-all sweep) run on the port's dgraph suite.

The suite's register workloads' independent checkers and its wr
workload's Elle checker check on CUDA unless the opts name a device; an
autouse fixture fills in device="cpu" when the opts given to
`dgraph_test` name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import dgraph

globals().update(torch_mirror.cases("test_suite_dgraph"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, dgraph, "dgraph_test")
