"""Every case of tests/test_suite_yugabyte.py (the CQL client against
tests/fake_cql.py, its batches, error classification and single-key
CAS, the MultiRegister model, the DB and process-nemesis commands over
the dummy remote, the nemesis and workload menus, and a hermetic
core.run of each of the sixteen workloads, the YSQL ones against
tests/fake_pg.py) run on the port's yugabyte suite.

The suite's single-key-acid workload's independent checker and its
ysql/append workload's Elle checker check on CUDA unless the opts name
a device; an autouse fixture fills in device="cpu" when the opts given
to `yugabyte_test` name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import yugabyte

globals().update(torch_mirror.cases("test_suite_yugabyte"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, yugabyte, "yugabyte_test")
