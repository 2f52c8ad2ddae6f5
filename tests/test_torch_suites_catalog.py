"""The disque, raftis, rabbitmq, galera, percona, stolon and
postgres-rds cases of tests/test_suites_catalog.py (client semantics
against tests/fake_resp.py, fake_rabbitmq.py, fake_mysql.py and
fake_pg.py, DB commands over the dummy remote, and a hermetic core.run
of each suite's workloads) run on the port's suites. The file's mongodb
cases run in tests/test_torch_suite_mongodb.py, so they are left out
here.

The raftis register, the rabbitmq mutex, the stolon append and the
postgres-rds register check on CUDA unless the opts name a device; an
autouse fixture fills in device="cpu" when the opts given to their
builders name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import postgres_rds, rabbitmq, raftis, stolon

globals().update(torch_mirror.cases(
    "test_suites_catalog", drop_statements=(r"(?m)^def test_mongodb",)))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    for mod, name in ((raftis, "raftis_test"), (rabbitmq, "rabbitmq_test"),
                      (stolon, "stolon_test"),
                      (postgres_rds, "postgres_rds_test")):
        torch_mirror.on_cpu(monkeypatch, mod, name)
