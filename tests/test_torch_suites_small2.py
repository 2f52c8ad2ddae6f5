"""Every case of tests/test_suites_small2.py (the elasticsearch set
clients, crate's lost-updates client and its version-divergence and
dirty-read checkers, the ignite register client, chronos's job targets,
checker and DB commands against tests/fake_es_ignite.py and
fake_crate.py, and hermetic core.run runs of each suite, one against a
chronos that drops runs) run on the port's suites.

The ignite register's independent checker checks on CUDA unless the
opts name a device; an autouse fixture fills in device="cpu" when the
opts given to `ignite_test` name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import ignite

globals().update(torch_mirror.cases("test_suites_small2"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, ignite, "ignite_test")
