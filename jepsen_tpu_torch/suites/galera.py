"""MariaDB Galera Cluster test suite.

Mirrors the reference's galera suite
(Jepsen's `galera/src/jepsen/galera.clj` and
`galera/dirty_reads.clj`): mariadb-galera-server install with a wsrep
cluster address over all nodes, first node bootstrapped with
--wsrep-new-cluster (`galera.clj:102-115`), and two workloads — the
signature *dirty reads* test (writers set every row to a unique value
inside a serializable txn, readers scan the table; a failed write's
value visible to any reader is a G1a dirty read, and a mixed-value scan
is a non-atomic read, `dirty_reads.clj:1-96`) — plus the bank test.

Clients reuse the MySQL wire client (`mysql_proto.py`); hermetic tests
run against the in-process MySQL-protocol fake."""

from __future__ import annotations

import itertools
import logging

from .. import cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from ..checker import Checker
from ..control import util as cu
from ..history import history as as_history, is_fail, is_ok
from ..os_ import debian
from ..workloads import bank as bank_w
from . import std_opts, std_test
from .mysql_proto import Conn, MySQLError

log = logging.getLogger(__name__)

SQL_PORT = 3306
CONFIG = "/etc/mysql/conf.d/galera.cnf"
LOGFILE = "/var/log/mysql/error.log"

DEFAULT_VERSION = "10.0"

# conflict/abort codes: deadlock, lock-wait timeout, galera certification
DEFINITE_ABORT = {1205, 1213, 1047}


def cluster_address(test: dict) -> str:
    """gcomm://n1,n2,... (`galera.clj:59-72`)."""
    return "gcomm://" + ",".join(test["nodes"])


def config_body(test: dict) -> str:
    return (
        "[mysqld]\n"
        "bind-address=0.0.0.0\n"
        "wsrep_provider=/usr/lib/galera/libgalera_smm.so\n"
        f"wsrep_cluster_address={cluster_address(test)}\n"
        "wsrep_sst_method=rsync\n"
        "binlog_format=ROW\n"
        "default_storage_engine=InnoDB\n"
        "innodb_autoinc_lock_mode=2\n")


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing mariadb-galera %s", node,
                     self.version)
            debian.install(["rsync", "mariadb-galera-server"])
            control.exec_("sh", "-c",
                          f"cat > {CONFIG} <<'EOF'\n"
                          f"{config_body(test)}EOF")
            control.exec_("service", "mysql", "stop")
            if node == test["nodes"][0]:
                # bootstrap the cluster on the first node
                control.exec_("service", "mysql", "start",
                              "--wsrep-new-cluster")
            else:
                control.exec_("service", "mysql", "start")
            cu.await_tcp_port(SQL_PORT)
            # test account for remote clients
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


def _connect(test, node) -> Conn:
    fn = test.get("sql-conn-fn")
    if fn is not None:
        return fn(node)
    return Conn(node, SQL_PORT, user="jepsen", password="jepsen",
                database="jepsen")


class _SQLClient(jclient.Client):
    def __init__(self):
        self.conn: Conn | None = None

    def open(self, test, node):
        c = type(self).__new__(type(self))
        c.__dict__.update(self.__dict__)
        c.conn = _connect(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def _capture(self, op, e: Exception, read_only: bool) -> dict:
        if isinstance(e, MySQLError):
            if e.code in DEFINITE_ABORT or read_only:
                return {**op, "type": "fail",
                        "error": ["sql", e.code, e.message]}
            return {**op, "type": "info",
                    "error": ["sql", e.code, e.message]}
        return {**op, "type": "fail" if read_only else "info",
                "error": ["conn", str(e)]}

    def _txn(self, stmts_fn, op, read_only=False):
        conn = self.conn
        try:
            conn.query("begin")
            out = stmts_fn(conn)
            conn.query("commit")
            return {**op, "type": "ok", **out}
        except Exception as e:  # noqa: BLE001 — classified below
            try:
                conn.query("rollback")
            except Exception:  # noqa: BLE001 — conn may be dead
                pass
            if isinstance(e, (MySQLError, OSError, ConnectionError)):
                return self._capture(op, e, read_only)
            raise


# -- dirty reads (`dirty_reads.clj`) -----------------------------------------

class DirtyReadsClient(_SQLClient):
    """Writers set every row of the `dirty` table to their unique value
    in one serializable txn; readers scan all rows."""

    def __init__(self, n_rows: int = 4):
        super().__init__()
        self.n_rows = n_rows

    def setup(self, test):
        self.conn.query("create table if not exists dirty "
                        "(id int not null primary key, x bigint)")
        for i in range(self.n_rows):
            try:
                self.conn.query(f"insert into dirty (id, x) values "
                                f"({i}, -1)")
            except MySQLError as e:
                if e.code != 1062:
                    raise

    def invoke(self, test, op):
        if op["f"] == "read":
            def read_body(conn):
                rows, _ = conn.query("select x from dirty")
                return {"value": [int(r[0]) for r in rows]}
            return self._txn(read_body, op, read_only=True)

        x = op["value"]

        def write_body(conn):
            for i in range(self.n_rows):
                conn.query(f"select x from dirty where id = {i}")
            for i in range(self.n_rows):
                conn.query(f"update dirty set x = {x} where id = {i}")
            return {}
        return self._txn(write_body, op)


class DirtyReadsChecker(Checker):
    """A failed write's value visible to any reader is a dirty read;
    a scan with mixed values is a non-atomic read
    (`dirty_reads.clj:73-96`)."""

    def check(self, test, hist, opts):
        hist = as_history(hist)
        failed = {o["value"] for o in hist
                  if is_fail(o) and o.get("f") == "write"}
        reads = [o["value"] for o in hist
                 if is_ok(o) and o.get("f") == "read"]
        inconsistent = [r for r in reads if r and len(set(r)) > 1]
        dirty = [r for r in reads if any(v in failed for v in r)]
        return {"valid?": not dirty,
                "read-count": len(reads),
                "inconsistent-reads": inconsistent[:10],
                "dirty-reads": dirty[:10]}


def dirty_reads_workload(opts: dict) -> dict:
    n = opts.get("dirty-rows", 4)

    def read(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    writes = ({"type": "invoke", "f": "write", "value": v}
              for v in itertools.count())
    return {
        "client": DirtyReadsClient(n),
        "generator": gen.mix([read, writes]),
        "checker": DirtyReadsChecker(),
    }


# -- bank --------------------------------------------------------------------

class BankClient(_SQLClient):
    def setup(self, test):
        self.conn.query("create table if not exists accounts "
                        "(id int not null primary key, "
                        "balance bigint not null)")
        accounts = test.get("accounts", list(range(8)))
        total = test.get("total-amount", 100)
        for a in accounts:
            try:
                self.conn.query(
                    f"insert into accounts (id, balance) values "
                    f"({a}, {total if a == accounts[0] else 0})")
            except MySQLError as e:
                if e.code != 1062:
                    raise

    def invoke(self, test, op):
        if op["f"] == "read":
            def read_body(conn):
                rows, _ = conn.query("select id, balance from accounts")
                return {"value": {int(r[0]): int(r[1]) for r in rows}}
            return self._txn(read_body, op, read_only=True)

        v = op["value"]
        frm, to, amount = v["from"], v["to"], v["amount"]

        def transfer_body(conn):
            rows, _ = conn.query(
                f"select balance from accounts where id = {frm} "
                f"for update")
            b1 = int(rows[0][0]) - amount
            rows, _ = conn.query(
                f"select balance from accounts where id = {to} "
                f"for update")
            b2 = int(rows[0][0]) + amount
            if b1 < 0:
                raise _InsufficientFunds()
            conn.query(f"update accounts set balance = {b1} "
                       f"where id = {frm}")
            conn.query(f"update accounts set balance = {b2} "
                       f"where id = {to}")
            return {}

        try:
            return self._txn(transfer_body, op)
        except _InsufficientFunds:
            return {**op, "type": "fail", "error": "negative"}


class _InsufficientFunds(Exception):
    pass


def bank_workload(opts: dict) -> dict:
    w = bank_w.test(opts)
    w["client"] = BankClient()
    return w


WORKLOADS = {
    "dirty-reads": dirty_reads_workload,
    "bank": bank_workload,
}


def galera_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "dirty-reads")
    return std_test(
        opts, name=f"galera-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "dirty-reads", DEFAULT_VERSION,
                    "mariadb-galera version") + [
    cli.opt("--dirty-rows", type=int, default=4,
            help="rows in the dirty-reads table"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": galera_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
