"""SmartOS OS automation: pkgin-based package management — the only
non-apt/yum OS the reference supports.

Reference: `jepsen/src/jepsen/os/smartos.clj` — hostfile fixup that
appends the hostname to the tab-separated loopback line, pkgin update
rate-limited to daily (timestamp of /var/db/pkgin/sql.log), installed
queries via `pkgin -p list` (semicolon-separated, name-version split
on the final dash), versioned installs, and svcadm-enabled ipfilter
(SmartOS's firewall — the ipfilter Net backend pairs with it).
"""

from __future__ import annotations

import logging
import re

from .. import control as c
from ..control import util as cu
from ..control.core import RemoteError
from . import OS

log = logging.getLogger(__name__)

PKGIN_DB_LOG = "/var/db/pkgin/sql.log"


def setup_hostfile() -> None:
    """Append the local hostname to the loopback entry if missing
    (`os/smartos.clj:12-25` — SmartOS uses a tab after 127.0.0.1)."""
    name = c.exec_("hostname")
    hosts = c.exec_("cat", "/etc/hosts")
    lines = [line + " " + name
             if line.startswith("127.0.0.1\t") and name not in line
             else line
             for line in hosts.split("\n")]
    with c.su():
        cu.write_file("\n".join(lines), "/etc/hosts")


def time_since_last_update() -> int:
    """Seconds since the last pkgin update (`os/smartos.clj:27-31`)."""
    now = int(c.exec_("date", "+%s"))
    then = int(c.exec_("stat", "-c", "%Y", PKGIN_DB_LOG))
    return now - then


def update() -> None:
    with c.su():
        c.exec_("pkgin", "update")


def maybe_update() -> None:
    """pkgin update at most daily; on any error, update anyway
    (`os/smartos.clj:37-43`)."""
    try:
        if time_since_last_update() > 86400:
            update()
    except Exception:  # noqa: BLE001 — missing db log etc.
        update()


def _name_of(entry: str) -> str | None:
    """pkgin list entries are 'name-version;description'; the package
    name is everything before the final dash (`os/smartos.clj:45-57`)."""
    head = entry.split(";")[0]
    m = re.match(r"(.*)-[^-]+$", head)
    return m.group(1) if m else None


def _version_of(entry: str) -> str | None:
    head = entry.split(";")[0]
    m = re.search(r".*-([^-]+)$", head)
    return m.group(1) if m else None


def installed(pkgs) -> set[str]:
    """The subset of pkgs pkgin reports installed."""
    want = {str(p) for p in pkgs}
    out = c.exec_("pkgin", "-p", "list")
    have = {_name_of(line) for line in out.split("\n") if line}
    return want & have


def installed_p(pkg_or_pkgs) -> bool:
    pkgs = pkg_or_pkgs if isinstance(pkg_or_pkgs, (list, tuple, set)) \
        else [pkg_or_pkgs]
    return installed(pkgs) == {str(p) for p in pkgs}


def installed_version(pkg: str) -> str | None:
    """The installed version of pkg, or None (`os/smartos.clj:72-84`)."""
    out = c.exec_("pkgin", "-p", "list")
    for line in out.split("\n"):
        if _name_of(line) == str(pkg):
            return _version_of(line)
    return None


def uninstall(pkg_or_pkgs) -> None:
    pkgs = pkg_or_pkgs if isinstance(pkg_or_pkgs, (list, tuple, set)) \
        else [pkg_or_pkgs]
    present = installed(pkgs)
    if present:
        with c.su():
            c.exec_("pkgin", "-y", "remove", *sorted(present))


def install(pkgs) -> None:
    """Ensure packages are installed: a collection installs any
    version; a {pkg: version} map pins versions
    (`os/smartos.clj:86-106`)."""
    if isinstance(pkgs, dict):
        for pkg, version in pkgs.items():
            if installed_version(pkg) != version:
                log.info("Installing %s %s", pkg, version)
                with c.su():
                    c.exec_("pkgin", "-y", "install",
                            f"{pkg}-{version}")
        return
    want = {str(p) for p in pkgs}
    missing = want - installed(want)
    if missing:
        with c.su():
            log.info("Installing %s", sorted(missing))
            c.exec_("pkgin", "-y", "install", *sorted(missing))


class SmartOS(OS):
    """`os/smartos.clj:108-131`: hostfile, rate-limited pkgin update,
    base packages, svcadm-enabled ipfilter, net heal."""

    def setup(self, test, node):
        log.info("%s setting up smartos", node)
        setup_hostfile()
        maybe_update()
        install(["wget", "curl", "vim", "unzip", "rsyslog",
                 "logrotate"])
        with c.su():
            c.exec_("svcadm", "enable", "-r", "ipfilter")
        try:
            test["net"].heal(test)
        except (RemoteError, KeyError):
            pass

    def teardown(self, test, node):
        pass


os = SmartOS()
