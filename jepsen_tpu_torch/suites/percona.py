"""Percona XtraDB Cluster test suite.

Mirrors the reference's percona suite
(Jepsen's `percona/src/jepsen/percona{,/dirty_reads}.clj`):
the same dirty-reads and bank workloads as galera — Percona XtraDB is
a Galera-based MySQL — over Percona's package install. The clients and
checkers are shared with the galera suite module; only the DB
automation differs (percona repositories + percona-xtradb-cluster
packages, `percona.clj:34-80`)."""

from __future__ import annotations

import logging

from .. import cli, control
from ..control import util as cu
from ..os_ import debian
from . import std_opts, std_test
from .galera import (  # noqa: F401 — shared clients/checkers/workloads
    SQL_PORT, BankClient, DirtyReadsChecker, DirtyReadsClient,
    WORKLOADS, cluster_address)
from .galera import config_body as _galera_config

log = logging.getLogger(__name__)

CONFIG = "/etc/mysql/conf.d/cluster.cnf"
LOGFILE = "/var/log/mysql/error.log"
DEFAULT_VERSION = "5.6"

import jepsen_tpu_torch.db as jdb  # noqa: E402


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing percona-xtradb %s", node,
                     self.version)
            debian.install(["rsync",
                            f"percona-xtradb-cluster-{self.version}"])
            control.exec_("sh", "-c",
                          f"cat > {CONFIG} <<'EOF'\n"
                          f"{_galera_config(test)}EOF")
            control.exec_("service", "mysql", "stop")
            if node == test["nodes"][0]:
                control.exec_("service", "mysql", "bootstrap-pxc")
            else:
                control.exec_("service", "mysql", "start")
            cu.await_tcp_port(SQL_PORT)
            control.exec_(
                "mysql", "-u", "root", "-e",
                "create database if not exists jepsen; "
                "grant all on jepsen.* to 'jepsen'@'%' "
                "identified by 'jepsen'; flush privileges")

    def start(self, test, node):
        with control.su():
            control.exec_("service", "mysql", "start")

    def kill(self, test, node):
        with control.su():
            cu.grepkill("mysqld")

    def teardown(self, test, node):
        with control.su():
            self.kill(test, node)
            control.exec_("rm", "-rf", "/var/lib/mysql/grastate.dat")

    def log_files(self, test, node):
        return [LOGFILE]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


def percona_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "dirty-reads")
    return std_test(
        opts, name=f"percona-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "dirty-reads", DEFAULT_VERSION,
                    "percona-xtradb-cluster version")


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": percona_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
