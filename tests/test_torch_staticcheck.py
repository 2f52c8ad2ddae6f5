"""The port's `staticcheck` command: the twin of
tests/test_staticcheck.py::test_cli_subcommand_forwards_to_driver for
`python -m jepsen_tpu_torch`, and its 254 outside a source checkout."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_cli_subcommand_forwards_to_driver(tmp_path):
    """`python -m jepsen_tpu_torch staticcheck` is a thin forwarder to
    the driver: same flags, same exit codes."""
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nimport os\n")
    p = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "staticcheck", str(bad),
         "--only", "style", "--baseline", str(tmp_path / "b.txt")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert p.returncode == 1, p.stdout + p.stderr
    assert "JTS002" in p.stdout and "JTS003" in p.stdout
    p = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "staticcheck",
         "--only", "locks", "--summary-json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["analyzers"] == ["locks"] and out["findings"] == 0


def test_relative_baseline_is_read_from_the_callers_directory(tmp_path):
    """The gate runs from the repo root, so a relative --baseline is
    resolved against the caller's directory first, as it is in the
    JAX package's in-process forwarder."""
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nimport os\n")
    (tmp_path / "b.txt").write_text(
        f"{bad}: JTS002 unused import 'os'\n"
        f"{bad}: JTS002 unused import 'os'\n"
        f"{bad}: JTS003 duplicate import of 'os' (first at line 1)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "staticcheck", str(bad),
         "--only", "style", "--baseline", "b.txt"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "3 baselined" in p.stderr, p.stdout + p.stderr


def test_without_a_source_checkout_exits_254(tmp_path):
    """Outside a source checkout (no tools/ next to the package) the
    command exits 254 and says why."""
    shutil.copytree(ROOT / "jepsen_tpu_torch", tmp_path / "jepsen_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "staticcheck",
         "--only", "style"],
        cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert p.returncode == 254, p.stdout + p.stderr
    assert "requires a source checkout" in p.stderr
