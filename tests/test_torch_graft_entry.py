"""The port's graft entries (`jepsen_tpu_torch.graft_entry`) against
the JAX package's `__graft_entry__.py` on the CPU: `entry()`'s history
and its check's tuple equal the JAX `entry()`'s; `dryrun_multichip(4,
device="cpu")` runs its sharded WGL and Elle checks in 4 gloo ranks and
returns the JAX dryrun's closing line; `python -m
jepsen_tpu_torch.graft_entry --device cpu` runs both."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from jepsen_tpu_torch import graft_entry

REPO = Path(__file__).resolve().parent.parent


def test_entry_matches_the_jax_entry():
    fn, (xs, n, init) = graft_entry.entry(device="cpu")
    jfn, (jx, jn, jinit) = jentry.entry()
    assert xs.dev.device == torch.device("cpu")
    np.testing.assert_array_equal(xs.host, np.asarray(jx))
    assert torch.equal(xs.dev, torch.from_numpy(np.array(jx)))
    assert (n, init) == (int(jn), int(jinit))
    got, want = fn(xs, n, init), jfn(jx, jn, jinit)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert type(g) in (bool, int) and g == np.asarray(w).item()
    assert got[0] is True and got[4] == 0


def test_entry_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()


def test_dryrun_multichip_over_four_gloo_ranks(capfd):
    line = graft_entry.dryrun_multichip(4, device="cpu", timeout_s=120)
    assert line == ("dryrun_multichip: 4 devices, 8 keyed WGL histories + "
                    "12 sharded elle SCC blocks, psum-OR verdict OK")
    # rank 0 alone prints it
    assert capfd.readouterr().out.count(line) == 1


def test_module_main_runs_entry_and_dryrun():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.graft_entry", "--device",
         "cpu", "--ranks", "2"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("entry ok: (True, -1, False, ")
    assert "dryrun_multichip: 2 devices, 4 keyed WGL histories + 6 " \
        "sharded elle SCC blocks, psum-OR verdict OK" in out.stdout
