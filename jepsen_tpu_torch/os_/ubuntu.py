"""Ubuntu OS automation: Debian tooling + Ubuntu package set + net heal.

Reference: `jepsen/src/jepsen/os/ubuntu.clj` — reuses the debian
helpers, installs the Ubuntu package list, and heals the network on
setup (so a crashed prior run's partitions don't leak in).
"""

from __future__ import annotations

import logging

from . import OS, debian

log = logging.getLogger(__name__)


class Ubuntu(OS):
    packages = ["apt-transport-https", "wget", "curl", "vim", "man-db",
                "faketime", "ntpdate", "unzip", "iptables", "psmisc",
                "tar", "bzip2", "iputils-ping", "iproute2", "rsyslog",
                "sudo", "logrotate"]

    def setup(self, test: dict, node: str) -> None:
        log.info("%s setting up ubuntu", node)
        debian.setup_hostfile()
        debian.maybe_update()
        debian.install(self.packages)
        net = test.get("net")
        if net is not None:
            try:
                net.heal(test)
            except Exception:
                pass

    def teardown(self, test: dict, node: str) -> None:
        pass


os = Ubuntu()
