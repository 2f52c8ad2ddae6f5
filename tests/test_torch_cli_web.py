"""Every case of tests/test_cli_web.py (option parsing and
post-processing, the `test`, `analyze` and `test-all` commands over the
dummy remote with their exit codes, the results web UI, `report` and
`repl`) run on the port's `cli`, `web` and `repl`.

The port's commands take ``--device`` and ask for CUDA when it is
absent; an autouse fixture gives the shared test option spec the
default ``--device cpu`` instead."""

import pytest

import torch_mirror
from jepsen_tpu_torch import cli

globals().update(torch_mirror.cases("test_cli_web"))


@pytest.fixture(autouse=True)
def _commands_on_the_cpu(monkeypatch):
    spec = cli.test_opt_spec

    def on_cpu():
        return [dict(o, default="cpu") if o["long"] == "--device" else o
                for o in spec()]

    monkeypatch.setattr(cli, "test_opt_spec", on_cpu)
