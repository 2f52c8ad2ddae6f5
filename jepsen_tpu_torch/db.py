"""DB protocols: database lifecycle on remote nodes.

Reference: `jepsen/src/jepsen/db.clj` — the `DB` setup/teardown protocol
(:11-13) and optional capability protocols `Process` start/kill (:18-24),
`Pause` (:26-29), `Primary` (:31-38), `LogFiles` (:40-41); the `tcpdump`
wrapper DB (:49-115); and `cycle!` — concurrent teardown+setup across
nodes with 3 retries on setup failure (:117-158).

Capabilities are optional-protocol style: a DB advertises a capability by
implementing its methods; `supports(db, "pause")` reflects on that, the
way the reference uses `(satisfies? Pause db)`.
"""

from __future__ import annotations

import logging
import time as _time

from . import control
from .control import util as cu

log = logging.getLogger(__name__)


class DB:
    def setup(self, test: dict, node: str) -> None:
        """Set up the database on this node."""

    def teardown(self, test: dict, node: str) -> None:
        """Tear down the database on this node."""


class Process:
    """Optional: starting and killing a DB's processes (`db.clj:18-24`)."""

    def start(self, test: dict, node: str):
        raise NotImplementedError

    def kill(self, test: dict, node: str):
        raise NotImplementedError


class Pause:
    """Optional: pausing/resuming a DB's processes (`db.clj:26-29`)."""

    def pause(self, test: dict, node: str):
        raise NotImplementedError

    def resume(self, test: dict, node: str):
        raise NotImplementedError


class Primary:
    """Optional: databases with a notion of primary nodes
    (`db.clj:31-38`)."""

    def primaries(self, test: dict) -> list[str]:
        """Nodes that currently think they're primaries (best-effort)."""
        raise NotImplementedError

    def setup_primary(self, test: dict, node: str) -> None:
        """One-time setup on a single node."""


class LogFiles:
    """Optional: per-node log files to snarf (`db.clj:40-41`)."""

    def log_files(self, test: dict, node: str) -> list[str]:
        return []


_CAPABILITIES = {
    "process": ("start", "kill"),
    "pause": ("pause", "resume"),
    "primary": ("primaries",),
    "log-files": ("log_files",),
}


def supports(db, capability: str) -> bool:
    """Does this DB implement an optional capability protocol? The
    reference's `(satisfies? Pause db)` reflection (`db.clj:121-158`,
    `nemesis/combined.clj:141-160` use it to pick nemesis menus)."""
    return all(callable(getattr(db, m, None))
               for m in _CAPABILITIES[capability])


class Noop(DB):
    """Does nothing (`db.clj:43-47`)."""


noop = Noop()


class SetupFailed(Exception):
    """Raise from DB.setup to request a teardown+retry cycle
    (`db.clj:125-126` :type ::setup-failed)."""


class Tcpdump(DB, LogFiles):
    """Runs a tcpdump capture from setup to teardown (`db.clj:49-115`).

    Options: ports (list of ints), filter (extra pcap filter string),
    clients_only (restrict to control-node traffic; needs control_ip).
    """

    DIR = "/tmp/jepsen/tcpdump"

    def __init__(self, ports=(), filter: str | None = None,
                 clients_only: bool = False,
                 control_ip: str | None = None):
        self.ports = list(ports)
        self.filter = filter
        self.clients_only = clients_only
        self.control_ip = control_ip
        self.logfile = f"{self.DIR}/log"
        self.capfile = f"{self.DIR}/tcpdump"
        self.pidfile = f"{self.DIR}/pid"

    def _filter_str(self) -> str:
        parts = []
        if self.ports:
            parts.append(" and ".join(f"port {p}" for p in self.ports))
        if self.clients_only and self.control_ip:
            parts.append(f"host {self.control_ip}")
        if self.filter:
            parts.append(self.filter)
        return " and ".join(parts)

    def setup(self, test, node):
        with control.su():
            control.exec_("mkdir", "-p", self.DIR)
            cu.start_daemon(
                {"logfile": self.logfile, "pidfile": self.pidfile,
                 "chdir": self.DIR},
                "/usr/sbin/tcpdump",
                "-w", self.capfile, "-s", "65535", "-B", "16384",
                # SIGINT should flush the capture, but in practice leaves
                # it half-finished — so don't buffer at all (`db.clj:87-92`)
                "-U", self._filter_str())

    def teardown(self, test, node):
        with control.su():
            pid = cu.meh(lambda: control.exec_("cat", self.pidfile))
            if pid:
                cu.meh(lambda: control.exec_("kill", "-s", "INT", pid))
                while cu.meh(lambda: control.exec_("ps", "-p", pid)) \
                        is not None:
                    log.info("Waiting for tcpdump %s to exit", pid)
                    _time.sleep(0.05)
            cu.stop_daemon(self.pidfile, cmd="tcpdump")
            control.exec_("rm", "-rf", self.DIR)

    def log_files(self, test, node):
        return [self.logfile, self.capfile]


def tcpdump(opts: dict | None = None) -> Tcpdump:
    return Tcpdump(**(opts or {}))


CYCLE_TRIES = 3


def cycle(test: dict) -> None:
    """Tear down then set up the DB on all nodes concurrently; on
    SetupFailed, tear down and retry up to CYCLE_TRIES times
    (`db.clj:117-158`)."""
    db = test["db"]
    tries = CYCLE_TRIES
    while True:
        log.info("Tearing down DB")
        control.on_nodes(test, db.teardown)
        log.info("Setting up DB")
        try:
            control.on_nodes(test, db.setup)
            if supports(db, "primary"):
                primary = test["nodes"][0]
                log.info("Setting up primary %s", primary)
                control.on_nodes(test, db.setup_primary, nodes=[primary])
            return
        except SetupFailed as e:
            tries -= 1
            if tries <= 0:
                raise
            log.warning("Unable to set up database; retrying... (%s)", e)
