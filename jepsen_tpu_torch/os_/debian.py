"""Debian OS automation: apt, hostfiles, repos, JDK install.

Reference: `jepsen/src/jepsen/os/debian.clj:13-197` — hostfile loopback
fixup, `apt-get update` rate-limited to daily, installed-package queries
via dpkg, `install`/`uninstall!`, `add-repo!` with apt-key, and the
default OS setup (core packages + hostname).
"""

from __future__ import annotations

import logging
import time as _time

from .. import control as c
from ..control import util as cu
from ..control.core import lit
from . import OS

log = logging.getLogger(__name__)


def setup_hostfile() -> None:
    """Ensure /etc/hosts has a loopback entry for the local hostname
    (`os/debian.clj:13-27`)."""
    hosts = c.exec_("cat", "/etc/hosts")
    lines = ["127.0.0.1\tlocalhost"
             if line.startswith("127.0.0.1\t") else line
             for line in hosts.split("\n")]
    new = "\n".join(lines)
    if new != hosts:
        with c.su():
            cu.write_file(new, "/etc/hosts")


def time_since_last_update() -> int:
    """Seconds since the last apt-get update (`os/debian.clj:29-33`).
    Unparsable output (e.g. a no-op dummy remote) reads as freshly
    updated, so hermetic runs skip apt entirely."""
    try:
        now = int(c.exec_("date", "+%s"))
        then = int(c.exec_("stat", "-c", "%Y",
                           "/var/cache/apt/pkgcache.bin", lit("||"),
                           "echo", "0"))
    except ValueError:
        return 0
    return now - then


def update() -> None:
    with c.su():
        c.exec_("apt-get", "--allow-releaseinfo-change", "update")


def maybe_update() -> None:
    """apt-get update at most daily (`os/debian.clj:40-43`)."""
    if time_since_last_update() > 86400:
        update()


def installed(pkgs) -> set[str]:
    """The subset of pkgs currently installed (`os/debian.clj:45-56`)."""
    pkgs = [str(p) for p in pkgs]
    out = c.exec_("dpkg", "--get-selections", *pkgs)
    found = set()
    for line in out.split("\n"):
        parts = line.split()
        if len(parts) >= 2 and parts[1] == "install":
            found.add(parts[0].replace(":amd64", "").replace(":i386", ""))
    return found


def is_installed(pkg_or_pkgs) -> bool:
    pkgs = pkg_or_pkgs if isinstance(pkg_or_pkgs, (list, tuple, set)) \
        else [pkg_or_pkgs]
    return set(str(p) for p in pkgs) <= installed(pkgs)


def installed_version(pkg: str) -> str | None:
    """Installed version of pkg, or None (`os/debian.clj:73-79`)."""
    import re

    out = c.exec_("apt-cache", "policy", str(pkg))
    m = re.search(r"Installed: (\S+)", out)
    v = m.group(1) if m else None
    return None if v in (None, "(none)") else v


def uninstall(pkg_or_pkgs) -> None:
    pkgs = pkg_or_pkgs if isinstance(pkg_or_pkgs, (list, tuple, set)) \
        else [pkg_or_pkgs]
    present = installed(pkgs)
    if present:
        with c.su():
            c.exec_("apt-get", "remove", "--purge", "-y", *sorted(present))


def install(pkg_or_pkgs, force: bool = False) -> None:
    """Install packages unless already present. Accepts a name, a
    collection of names, or a dict of name -> pinned version — the
    reference's map form, rendered as apt's pkg=version syntax
    (`os/debian.clj:81-103`)."""
    if isinstance(pkg_or_pkgs, dict):
        versions = {str(k): str(v) for k, v in pkg_or_pkgs.items()}
    elif isinstance(pkg_or_pkgs, (list, tuple, set)):
        versions = {str(p): None for p in pkg_or_pkgs}
    else:
        versions = {str(pkg_or_pkgs): None}
    names = sorted(versions)
    missing = names if force else sorted(set(names) - installed(names))
    if not missing:
        return
    maybe_update()
    specs = [p if versions[p] is None else f"{p}={versions[p]}"
             for p in missing]
    with c.su():
        c.exec_("env", lit("DEBIAN_FRONTEND=noninteractive"),
                "apt-get", "install", "-y", *specs)


def add_repo(repo_name: str, apt_line: str,
             keyserver: str | None = None, key: str | None = None) -> None:
    """Add an apt source + optional key (`os/debian.clj:115-132`)."""
    path = f"/etc/apt/sources.list.d/{repo_name}.list"
    with c.su():
        if not cu.exists(path):
            if keyserver and key:
                c.exec_("apt-key", "adv", "--keyserver", keyserver,
                        "--recv", key)
            cu.write_file(apt_line + "\n", path)
            update()


def install_jdk11() -> None:
    """Install a JDK (`os/debian.clj:134-151` install-jdk11!)."""
    install(["openjdk-11-jdk-headless"])


class Debian(OS):
    """Default Debian setup: hostfile + core packages
    (`os/debian.clj:158-197`)."""

    packages = ["curl", "faketime", "iptables", "logrotate", "man-db",
                "net-tools", "ntpdate", "psmisc", "rsyslog", "sudo",
                "tar", "unzip", "vim", "wget"]

    def setup(self, test: dict, node: str) -> None:
        log.info("%s setting up debian", node)
        setup_hostfile()
        maybe_update()
        install(self.packages)

    def teardown(self, test: dict, node: str) -> None:
        pass


os = Debian()
