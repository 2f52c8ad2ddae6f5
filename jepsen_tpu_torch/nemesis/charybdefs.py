"""CharybdeFS: filesystem fault injection via a FUSE passthrough.

Reference: `charybdefs/src/jepsen/charybdefs.clj` — builds thrift from
source (Ubuntu lacks the C++ library; versions can't be mixed, :7-38),
clones + cmake-builds scylladb/charybdefs, mounts the fault-injecting
filesystem at /faulty backed by /real (:40-65), and drives fault recipes
break-all / break-one-percent / clear (:67-85). DBs under test point
their data dirs at /faulty; faults then surface as EIO etc.
"""

from __future__ import annotations

import logging

from .. import control as c
from ..control import util as cu
from ..os_ import debian
from . import Nemesis

log = logging.getLogger(__name__)

THRIFT_URL = "http://www-eu.apache.org/dist/thrift/0.10.0/" \
             "thrift-0.10.0.tar.gz"
THRIFT_DIR = "/opt/thrift"
CHARYBDEFS_REPO = "https://github.com/scylladb/charybdefs.git"
CHARYBDEFS_DIR = "/opt/charybdefs"


def install_thrift() -> None:
    """Build thrift (compiler + C++ + python libs) from source
    (`charybdefs.clj:7-38`)."""
    if cu.exists("/usr/bin/thrift"):
        return
    with c.su():
        debian.install(["automake", "bison", "flex", "g++", "git",
                        "libboost-all-dev", "libevent-dev", "libssl-dev",
                        "libtool", "make", "pkg-config",
                        "python-setuptools", "libglib2.0-dev"])
        log.info("Building thrift (this takes several minutes)")
        cu.install_archive(THRIFT_URL, THRIFT_DIR)
        with c.cd(THRIFT_DIR):
            c.exec_("./configure", "--prefix=/usr")
            c.exec_("make", "-j4")
            c.exec_("make", "install")
        with c.cd(f"{THRIFT_DIR}/lib/py"):
            c.exec_("python", "setup.py", "install")


def install() -> None:
    """Ensure CharybdeFS is built and mounted at /faulty (backed by
    /real) on the current node (`charybdefs.clj:40-65`)."""
    install_thrift()
    bin = f"{CHARYBDEFS_DIR}/charybdefs"
    if not cu.exists(bin):
        with c.su():
            debian.install(["build-essential", "cmake", "libfuse-dev",
                            "fuse"])
            c.exec_("mkdir", "-p", CHARYBDEFS_DIR)
            c.exec_("chmod", "777", CHARYBDEFS_DIR)
        c.exec_("git", "clone", "--depth", 1, CHARYBDEFS_REPO,
                CHARYBDEFS_DIR)
        with c.cd(CHARYBDEFS_DIR):
            c.exec_("thrift", "-r", "--gen", "cpp", "server.thrift")
            c.exec_("cmake", "CMakeLists.txt")
            c.exec_("make")
    with c.su():
        c.exec_("modprobe", "fuse")
        c.exec_("umount", "/faulty", c.lit("||"), "/bin/true")
        c.exec_("mkdir", "-p", "/real", "/faulty")
        c.exec_(bin, "/faulty",
                "-oallow_other,modules=subdir,subdir=/real")
        c.exec_("chmod", "777", "/real", "/faulty")


def _cookbook(flag: str) -> None:
    with c.cd(f"{CHARYBDEFS_DIR}/cookbook"):
        c.exec_("./recipes", flag)


def break_all() -> None:
    """All fs operations fail with EIO (`charybdefs.clj:72-75`)."""
    _cookbook("--io-error")


def break_one_percent() -> None:
    """1% of disk operations fail (`charybdefs.clj:77-80`)."""
    _cookbook("--probability")


def clear() -> None:
    """Clear a previous failure injection (`charybdefs.clj:82-85`)."""
    _cookbook("--clear")


class CharybdeFSNemesis(Nemesis):
    """Nemesis driving the recipes: ops {"f": "break-all" |
    "break-one-percent" | "clear-fs-faults", "value": node-list|None}."""

    def fs(self):
        return {"break-all", "break-one-percent", "clear-fs-faults"}

    def setup(self, test):
        c.on_nodes(test, lambda t, n: install())
        return self

    def invoke(self, test, op):
        action = {"break-all": break_all,
                  "break-one-percent": break_one_percent,
                  "clear-fs-faults": clear}[op["f"]]
        res = c.on_nodes(test, lambda t, n: action(),
                         nodes=op.get("value"))
        return {**op, "value": res}

    def teardown(self, test):
        try:
            c.on_nodes(test, lambda t, n: clear())
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass


def nemesis() -> CharybdeFSNemesis:
    return CharybdeFSNemesis()
