"""The port's command line: `python -m jepsen_tpu_torch COMMAND ...`.

    python -m jepsen_tpu_torch serve [--host H] [--port P] [--store-dir DIR]
    python -m jepsen_tpu_torch service [--bind ADDR] [--watch DIR]
        [--standby ADDR] [--max-streams N] [--budget-elementops X]
        [--static-budget] [--metrics-port P] [--metrics-host H]
        [--device cpu]
    python -m jepsen_tpu_torch service status ADDR
    python -m jepsen_tpu_torch staticcheck [TARGET ...] [--only A,B]
        [--baseline PATH] [--write-baseline] [--summary-json]
    python -m jepsen_tpu_torch search [--workload W] [--generations G]
        [--population K] [--seed S] [--workers N] [--strategy S]
        [--escalate none|host|batch|service] [--bug B] [--max-sims N]
        [--sample X] [--store-dir DIR] [--resume DIR] [--device cpu]
    python -m jepsen_tpu_torch chaos [--workload W] [--ops N]
        [--budget N] [--seed S] [--strategy S] [--deadline-s X]
        [--no-shrink] [--store-dir DIR] [--device cpu]

Twins of the JAX package's commands (`jepsen_tpu/cli.py: main`), with the
same options, output and exit codes; `cli.main` registers them and
`cli.run` dispatches. An invalid argument to any command exits 254.
Each command that checks runs on CUDA unless given ``--device cpu``:
without a card `search` and `chaos` exit 254 and the service daemon
exits 1, each with `_platform.resolve_device`'s message.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> None:
    """Run one command; it exits through SystemExit with its code."""
    from . import cli
    cli.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
