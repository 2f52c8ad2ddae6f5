"""The port's `search` and `chaos` commands (`python -m jepsen_tpu_torch`),
each in a fresh interpreter on the CPU (`--device cpu`): the result
JSON on stdout, the `search (guided): ...` / `chaos (guided): ...` line
on stderr, and the JAX CLI's exit codes — 0 when nothing was found, 1
when a violation or an oracle failure was, 254 for a bad argument — and
a refusal (254, `resolve_device`'s message, nothing on stdout) without a
card and without `--device cpu`. A clean exit also shows that no
service worker outlived the run: a torch thread alive at exit aborts
the interpreter.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, code=None):
    env = dict(os.environ, PYTHONPATH=ROOT)
    argv = ([sys.executable, "-c", code, *args] if code else
            [sys.executable, "-m", "jepsen_tpu_torch", *args])
    return subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)


def test_cli_search_exit_codes(tmp_path):
    d = str(tmp_path / "s")
    found = _run(["search", "--workload", "phased-register", "--bug",
                  "lost-write-kill-partition", "--generations", "12",
                  "--population", "25", "--seed", "2", "--max-sims", "300",
                  "--escalate", "service", "--store-dir", d,
                  "--device", "cpu"])
    assert found.returncode == 1, found.stderr[-2000:]
    r = json.loads(found.stdout)
    assert r["found"] is True and r["simulations"] == 78
    assert "search (guided): 78 simulations" in found.stderr
    assert os.path.exists(os.path.join(d, "coverage.bin"))
    clean = _run(["search", "--workload", "phased-register", "--strategy",
                  "random", "--generations", "2", "--population", "5",
                  "--max-sims", "10", "--seed", "3", "--device", "cpu"])
    assert clean.returncode == 0, clean.stderr[-2000:]
    assert json.loads(clean.stdout)["simulations"] == 10
    assert "search (random):" in clean.stderr
    for bad in (["--workload", "bogus", "--device", "cpu"],
                ["--bug", "bogus", "--device", "cpu"],
                ["--resume", str(tmp_path / "none"), "--device", "cpu"],
                ["--escalate", "bogus"]):
        p = _run(["search", *bad])
        assert p.returncode == 254, (bad, p.stderr[-2000:])
        assert p.stdout == ""


def test_cli_chaos_exit_codes(tmp_path):
    d = str(tmp_path / "c")
    clean = _run(["chaos", "--budget", "4", "--ops", "64", "--seed", "23",
                  "--store-dir", d, "--device", "cpu"])
    assert clean.returncode == 0, clean.stderr[-2000:]
    r = json.loads(clean.stdout)
    assert r["schedules"] == 4 and r["failures"] == []
    assert "chaos (guided): 4 schedules" in clean.stderr
    with open(os.path.join(d, "chaos.json")) as f:
        assert json.load(f)["coverage-digest"] == r["coverage-digest"]
    for bad in (["--workload", "bogus", "--device", "cpu"],
                ["--strategy", "bogus"], ["--budget", "x"]):
        p = _run(["chaos", *bad])
        assert p.returncode == 254, (bad, p.stderr[-2000:])
        assert p.stdout == ""


# the chaos command with every schedule failing one oracle: the exit
# code of a found failure, with the oracles replaced inside this
# interpreter only
FAILING = r"""
import sys
from jepsen_tpu_torch import __main__ as cli
from jepsen_tpu_torch.chaos import driver

driver.check_oracles = lambda baseline, outcome, resources=None: [
    {"oracle": "watchdog", "detail": "planted"}]
sys.exit(cli.main(sys.argv[1:]))
"""


def test_cli_chaos_exits_1_on_an_oracle_failure():
    p = _run(["chaos", "--budget", "2", "--ops", "64", "--seed", "23",
              "--no-shrink", "--device", "cpu"], code=FAILING)
    assert p.returncode == 1, p.stderr[-2000:]
    r = json.loads(p.stdout)
    assert r["found"] is True and r["failures"][0]["oracles"] == ["watchdog"]
    assert "chaos (guided): 1 schedules" in p.stderr


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cmd in (["search", "--generations", "1", "--population", "1"],
                ["chaos", "--budget", "1"]):
        p = _run(cmd)
        assert p.returncode == 254, (cmd, p.stderr[-2000:])
        assert "no CUDA device" in p.stderr and p.stdout == ""
