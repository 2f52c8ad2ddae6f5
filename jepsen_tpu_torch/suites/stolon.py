"""Stolon test suite — PostgreSQL HA under a cloud-native failover
manager.

Mirrors the reference's stolon suite
(Jepsen's `stolon/src/jepsen/stolon{,/db,/client,/append,
/ledger}.clj`): postgres + stolon sentinel/keeper/proxy daemons backed
by an etcd store (`db.clj:22-120`), with the elle list-append workload
(`append.clj` — CONCAT-based list rows over the proxy) and a
ledger/bank workload (`ledger.clj`).

Clients reuse the Postgres wire client (`pg_proto.py`); hermetic tests
run against the in-process Postgres-protocol fake."""

from __future__ import annotations

import logging

from .. import cli, client as jclient, control
from .. import db as jdb
from ..control import util as cu
from ..os_ import debian
from ..workloads import append as append_w, bank as bank_w
from . import std_opts, std_test
from .pg_proto import Conn, PGError

log = logging.getLogger(__name__)

DIR = "/opt/stolon"
DATA_DIR = f"{DIR}/data"
CLUSTER = "jepsen-cluster"
PROXY_PORT = 25432
PG_PORT = 5432
ETCD_ENDPOINT_PORT = 2379

SENTINEL = ("stolon-sentinel", f"{DIR}/sentinel.log",
            f"{DIR}/sentinel.pid")
KEEPER = ("stolon-keeper", f"{DIR}/keeper.log", f"{DIR}/keeper.pid")
PROXY = ("stolon-proxy", f"{DIR}/proxy.log", f"{DIR}/proxy.pid")

DEFAULT_VERSION = "0.16.0"

# 40003 (completion unknown) deliberately absent: ambiguous commits
# must stay :info, not :fail (the txn may have applied).
DEFINITE_ABORT = {"40001", "40P01"}


def tarball_url(version: str) -> str:
    return (f"https://github.com/sorintlab/stolon/releases/download/"
            f"v{version}/stolon-v{version}-linux-amd64.tar.gz")


def store_endpoints(test: dict) -> str:
    return ",".join(f"http://{n}:{ETCD_ENDPOINT_PORT}"
                    for n in test["nodes"])


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    """postgres packages + the stolon daemon trio on every node
    (`db.clj:40-180`). Assumes an etcd store is reachable on the test
    nodes (the reference composes `jepsen.etcd.db` the same way)."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing stolon %s", node, self.version)
            debian.install(["postgresql", "postgresql-client"])
            control.exec_("service", "postgresql", "stop")
            url = test.get("tarball") or tarball_url(self.version)
            cu.install_archive(url, DIR)
            control.exec_("mkdir", "-p", DATA_DIR)
            control.exec_("chown", "-R", "postgres:postgres", DIR)
            if node == test["nodes"][0]:
                control.exec_(
                    f"{DIR}/bin/stolonctl", "init", "-y",
                    "--cluster-name", CLUSTER,
                    "--store-backend", "etcdv3",
                    "--store-endpoints", store_endpoints(test))
            self.start(test, node)

    def start(self, test, node):
        store = ["--cluster-name", CLUSTER, "--store-backend", "etcdv3",
                 "--store-endpoints", store_endpoints(test)]
        with control.su():
            for (bin_, logf, pidf), args in (
                (SENTINEL, []),
                (KEEPER, ["--uid", f"keeper_{node.replace('-', '_')}",
                          "--data-dir", DATA_DIR,
                          "--pg-listen-address", node,
                          "--pg-port", str(PG_PORT),
                          "--pg-su-password", "jepsen",
                          "--pg-repl-username", "repl",
                          "--pg-repl-password", "jepsen"]),
                (PROXY, ["--listen-address", "0.0.0.0",
                         "--port", str(PROXY_PORT)]),
            ):
                cu.start_daemon(
                    {"logfile": logf, "pidfile": pidf, "chdir": DIR},
                    f"{DIR}/bin/{bin_}", *store, *args)

    def kill(self, test, node):
        with control.su():
            for bin_, _logf, pidf in (PROXY, KEEPER, SENTINEL):
                cu.stop_daemon(pidf, cmd=bin_)
                cu.grepkill(bin_)
            cu.grepkill("postgres")

    def teardown(self, test, node):
        with control.su():
            self.kill(test, node)
            control.exec_("rm", "-rf", DATA_DIR,
                          *(x[1] for x in (SENTINEL, KEEPER, PROXY)))

    def log_files(self, test, node):
        return [x[1] for x in (SENTINEL, KEEPER, PROXY)]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


def _connect(test, node) -> Conn:
    fn = test.get("sql-conn-fn")
    if fn is not None:
        return fn(node)
    return Conn(node, PROXY_PORT, user="postgres", database="jepsen")


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
        if isinstance(e, PGError):
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
            if isinstance(e, (PGError, OSError, ConnectionError)):
                return self._capture(op, e, read_only)
            raise


class AppendClient(_SQLClient):
    """Elle list-append micro-ops over one table, appends via
    ON CONFLICT + concat (`append.clj:40-90`)."""

    def setup(self, test):
        self.conn.query("create table if not exists lists "
                        "(id int primary key, val text)")

    def _mop(self, conn, m):
        f, k, v = m[0], m[1], m[2]
        if f == "r":
            rows, _ = conn.query(f"select val from lists where id = {k}")
            if not rows or rows[0][0] is None:
                return ["r", k, []]
            return ["r", k,
                    [int(x) for x in rows[0][0].split(",") if x != ""]]
        conn.query(f"insert into lists (id, val) values ({k}, '{v}') "
                   f"on conflict (id) do update set val = "
                   f"concat(val, ',', '{v}')")
        return ["append", k, v]

    def invoke(self, test, op):
        txn = op["value"]

        def body(conn):
            return {"value": [self._mop(conn, m) for m in txn]}
        return self._txn(body, op,
                         read_only=all(m[0] == "r" for m in txn))


class BankClient(_SQLClient):
    """Ledger-style transfers (`ledger.clj`)."""

    def setup(self, test):
        self.conn.query("create table if not exists accounts "
                        "(id int primary key, balance bigint)")
        accounts = test.get("accounts", list(range(8)))
        total = test.get("total-amount", 100)
        for a in accounts:
            self.conn.query(
                f"insert into accounts (id, balance) values "
                f"({a}, {total if a == accounts[0] else 0}) "
                f"on conflict (id) do update set balance = balance")

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
                f"select balance from accounts where id = {frm}")
            b1 = int(rows[0][0]) - amount
            rows, _ = conn.query(
                f"select balance from accounts where id = {to}")
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


def append_workload(opts: dict) -> dict:
    w = append_w.workload(opts)
    w["client"] = AppendClient()
    return w


def bank_workload(opts: dict) -> dict:
    w = bank_w.test(opts)
    w["client"] = BankClient()
    return w


WORKLOADS = {
    "append": append_workload,
    "bank": bank_workload,
}


def stolon_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "append")
    return std_test(
        opts, name=f"stolon-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "append", DEFAULT_VERSION,
                    "stolon release version")


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": stolon_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
