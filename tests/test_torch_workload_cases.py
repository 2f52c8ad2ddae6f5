"""Every case of tests/test_workloads.py, run on the port's workloads
(bank, long_fork, causal, causal_reverse, adya, linearizable_register,
monotonic, sequential, table, comments).

Three of the port's constructors make checkers that run on CUDA unless
opts name a device: `monotonic.workload` and `sequential.workload`
(the Elle classifier) and `linearizable_register.test` (the batched
WGL walk). Here each fills in `device="cpu"` when the test's opts name
none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.workloads import (linearizable_register, monotonic,
                                        sequential)

globals().update(torch_mirror.cases("test_workloads"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    for mod, name in ((monotonic, "workload"), (sequential, "workload"),
                      (linearizable_register, "test")):
        build = getattr(mod, name)

        def on_cpu(opts=None, _build=build):
            opts = dict(opts or {})
            opts.setdefault("device", "cpu")
            return _build(opts)

        monkeypatch.setattr(mod, name, on_cpu)
