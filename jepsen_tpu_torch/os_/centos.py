"""CentOS OS automation: yum-based package management.

Reference: `jepsen/src/jepsen/os/centos.clj` — hostfile fixup that
*appends* the hostname to the loopback line, yum update rate-limited to
daily, installed-package queries via `yum list installed`, and the
default setup package list.
"""

from __future__ import annotations

import logging
import re

from .. import control as c
from ..control import util as cu
from . import OS

log = logging.getLogger(__name__)


def setup_hostfile() -> None:
    """Append the local hostname to the loopback line if missing
    (`os/centos.clj:12-25`)."""
    name = c.exec_("hostname")
    hosts = c.exec_("cat", "/etc/hosts")
    lines = [line + " " + name
             if line.startswith("127.0.0.1") and name not in line
             else line
             for line in hosts.split("\n")]
    with c.su():
        cu.write_file("\n".join(lines), "/etc/hosts")


def time_since_last_update() -> int:
    now = int(c.exec_("date", "+%s"))
    then = int(c.exec_("stat", "-c", "%Y", "/var/log/yum.log"))
    return now - then


def update() -> None:
    with c.su():
        c.exec_("yum", "-y", "update")


def maybe_update() -> None:
    """yum update at most daily; on any error, update anyway
    (`os/centos.clj:37-43`)."""
    try:
        if time_since_last_update() > 86400:
            update()
    except Exception:
        update()


def installed(pkgs) -> set[str]:
    """The subset of pkgs yum reports installed (`os/centos.clj:45-57`)."""
    want = {str(p) for p in pkgs}
    out = c.exec_("yum", "list", "installed")
    have = set()
    for line in out.split("\n"):
        name_arch = line.split()[0] if line.split() else ""
        m = re.match(r"(.*)\.[^\-]+$", name_arch)
        if m:
            have.add(m.group(1))
    return want & have


def is_installed(pkg_or_pkgs) -> bool:
    pkgs = pkg_or_pkgs if isinstance(pkg_or_pkgs, (list, tuple, set)) \
        else [pkg_or_pkgs]
    return {str(p) for p in pkgs} <= installed(pkgs)


def uninstall(pkg_or_pkgs) -> None:
    pkgs = pkg_or_pkgs if isinstance(pkg_or_pkgs, (list, tuple, set)) \
        else [pkg_or_pkgs]
    present = installed(pkgs)
    if present:
        with c.su():
            c.exec_("yum", "-y", "remove", *sorted(present))


def install(pkg_or_pkgs) -> None:
    pkgs = pkg_or_pkgs if isinstance(pkg_or_pkgs, (list, tuple, set)) \
        else [pkg_or_pkgs]
    missing = sorted({str(p) for p in pkgs} - installed(pkgs))
    if missing:
        with c.su():
            c.exec_("yum", "-y", "install", *missing)


class CentOS(OS):
    packages = ["curl", "faketime", "iptables", "logrotate", "man-db",
                "net-tools", "ntpdate", "psmisc", "rsyslog", "sudo",
                "tar", "unzip", "vim", "wget"]

    def setup(self, test: dict, node: str) -> None:
        log.info("%s setting up centos", node)
        setup_hostfile()
        maybe_update()
        install(self.packages)

    def teardown(self, test: dict, node: str) -> None:
        pass


os = CentOS()
