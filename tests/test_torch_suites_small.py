"""The logcabin, robustirc and mysql-cluster cases of
tests/test_suites_small.py (DB commands over the dummy remote, client
semantics against tests/fake_robustirc.py and fake_mysql.py, and
hermetic core.run runs, three against fakes that serve stale reads,
lost messages or phantom reads) run on the port's suites. The file's
ReQL and rethinkdb cases run in tests/test_torch_suite_rethinkdb.py, so
they are left out here.

The logcabin and mysql-cluster registers check on CUDA unless the opts
name a device; an autouse fixture fills in device="cpu" when the opts
given to their builders name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import logcabin, mysql_cluster

globals().update(torch_mirror.cases(
    "test_suites_small",
    drop_statements=(r"(?m)^def test_(reql|rethinkdb)",)))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, logcabin, "logcabin_test")
    torch_mirror.on_cpu(monkeypatch, mysql_cluster, "mysql_cluster_test")
