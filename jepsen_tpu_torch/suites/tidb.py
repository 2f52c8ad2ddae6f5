"""TiDB test suite.

Mirrors the reference's tidb suite (Jepsen's `tidb/src/tidb/`):
pd/tikv/tidb cluster automation (`db.clj`), a MySQL-protocol SQL layer
with the reference's error classification and retry semantics
(`sql.clj`), and the workload menu that matters for the north-star
configs — elle list-append (`txn.clj`, BASELINE config 5 at 100k txns),
rw-register, bank (`bank.clj`), independent linearizable register
(`register.clj`), grow-only set (`sets.clj`), long-fork
(`long_fork.clj`), and the additional-graphs consumers: monotonic
(`monotonic.clj`), sequential (`sequential.clj`), and table
(`table.clj`).

Clients speak the wire protocol directly (`mysql_proto.py`) — no driver
dependency; hermetic tests run against an in-process MySQL-protocol
fake (tests/fake_mysql.py) exactly like the reference's dummy tier.
"""

from __future__ import annotations

import itertools
import logging

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from .. import independent
from ..control import util as cu
from ..workloads import append as append_w, bank as bank_w, \
    linearizable_register, long_fork as long_fork_w, \
    monotonic as monotonic_w, sequential as sequential_w, \
    table as table_w, wr as wr_w
from . import std_opts, std_test
from .mysql_proto import Conn, MySQLError

log = logging.getLogger(__name__)

DIR = "/opt/tidb"
BIN = f"{DIR}/bin"
PD_LOG, KV_LOG, DB_LOG = (f"{DIR}/pd.log", f"{DIR}/kv.log", f"{DIR}/db.log")
PD_PID, KV_PID, DB_PID = (f"{DIR}/pd.pid", f"{DIR}/kv.pid", f"{DIR}/db.pid")
PD_DATA, KV_DATA = f"{DIR}/data/pd", f"{DIR}/data/kv"

CLIENT_PORT = 2379   # pd client (db.clj:45)
PEER_PORT = 2380     # pd peer (db.clj:46)
SQL_PORT = 4000      # tidb-server MySQL port
KV_PORT = 20160

DEFAULT_VERSION = "v3.0.0"

# TiDB/TiKV error codes that mean the transaction definitely rolled
# back — safe to call :fail (`sql.clj` rollback classification):
# deadlock, lock-wait timeout, TiKV busy/conflict/region errors.
DEFINITE_ABORT = {1205, 1213, 8002, 8022, 8028, 9004, 9005, 9007}


def tarball_url(version: str) -> str:
    return (f"https://download.pingcap.org/tidb-{version}"
            f"-linux-amd64.tar.gz")


def peer_url(node: str) -> str:
    return f"http://{node}:{PEER_PORT}"


def client_url(node: str) -> str:
    return f"http://{node}:{CLIENT_PORT}"


def initial_cluster(test: dict) -> str:
    """pd1=http://n1:2380,... (`db.clj:72-79`)."""
    return ",".join(f"pd{i + 1}={peer_url(n)}"
                    for i, n in enumerate(test["nodes"]))


def pd_endpoints(test: dict) -> str:
    return ",".join(f"{n}:{CLIENT_PORT}" for n in test["nodes"])


class DB(jdb.DB, jdb.Process, jdb.Pause, jdb.LogFiles):
    """pd + tikv + tidb on every node (`db.clj:102-240`): install the
    release tarball, then start pd (all nodes), tikv against the pd
    quorum, and tidb-server last."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing TiDB %s", node, self.version)
            url = test.get("tarball") or tarball_url(self.version)
            cu.install_archive(url, DIR)
            control.exec_("mkdir", "-p", PD_DATA, KV_DATA)
            self.start(test, node)

    def start(self, test, node):
        i = test["nodes"].index(node) + 1
        with control.su():
            cu.start_daemon(
                {"logfile": PD_LOG, "pidfile": PD_PID, "chdir": DIR},
                f"{BIN}/pd-server",
                "--name", f"pd{i}",
                "--data-dir", PD_DATA,
                "--client-urls", f"http://0.0.0.0:{CLIENT_PORT}",
                "--advertise-client-urls", client_url(node),
                "--peer-urls", f"http://0.0.0.0:{PEER_PORT}",
                "--advertise-peer-urls", peer_url(node),
                "--initial-cluster", initial_cluster(test))
            cu.await_tcp_port(CLIENT_PORT)
            cu.start_daemon(
                {"logfile": KV_LOG, "pidfile": KV_PID, "chdir": DIR},
                f"{BIN}/tikv-server",
                "--pd", pd_endpoints(test),
                "--addr", f"0.0.0.0:{KV_PORT}",
                "--advertise-addr", f"{node}:{KV_PORT}",
                "--data-dir", KV_DATA)
            cu.await_tcp_port(KV_PORT)
            cu.start_daemon(
                {"logfile": DB_LOG, "pidfile": DB_PID, "chdir": DIR},
                f"{BIN}/tidb-server",
                "--store", "tikv",
                "--path", pd_endpoints(test),
                "-P", str(SQL_PORT))
            cu.await_tcp_port(SQL_PORT)

    def teardown(self, test, node):
        log.info("%s tearing down TiDB", node)
        with control.su():
            self.kill(test, node)
            control.exec_("rm", "-rf", f"{DIR}/data", PD_LOG, KV_LOG,
                          DB_LOG)

    def kill(self, test, node):
        with control.su():
            for pid, name in ((DB_PID, "tidb-server"),
                              (KV_PID, "tikv-server"),
                              (PD_PID, "pd-server")):
                cu.stop_daemon(pid, cmd=name)
                cu.grepkill(name)

    def pause(self, test, node):
        with control.su():
            for name in ("tidb-server", "tikv-server", "pd-server"):
                cu.signal(name, "STOP")

    def resume(self, test, node):
        with control.su():
            for name in ("tidb-server", "tikv-server", "pd-server"):
                cu.signal(name, "CONT")

    def log_files(self, test, node):
        return [PD_LOG, KV_LOG, DB_LOG]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


# -- SQL layer (`sql.clj`) ---------------------------------------------------

def _connect(test, node) -> Conn:
    fn = test.get("sql-conn-fn")
    if fn is not None:
        return fn(node)
    return Conn(node, SQL_PORT, user="root", password="",
                database="", timeout_s=10.0)


def _q(s) -> str:
    """Quote a value into SQL text: ints pass through, strings quote.
    Keys/values in these workloads are ints or int-derived strings."""
    if isinstance(s, bool):
        raise ValueError("no boolean literals in this dialect")
    if isinstance(s, int):
        return str(s)
    s = str(s)
    if "'" in s or "\\" in s:
        raise ValueError(f"unquotable literal {s!r}")
    return f"'{s}'"


class _SQLClient(jclient.Client):
    """Shared open/close and error classification. A statement error
    inside a transaction rolls back and classifies: DEFINITE_ABORT
    codes -> fail; anything else (connection death included) -> info
    unless the op was read-only."""

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
                return {**op, "type": "fail", "error": ["sql", e.code,
                                                        e.message]}
            return {**op, "type": "info", "error": ["sql", e.code,
                                                    e.message]}
        return {**op, "type": "fail" if read_only else "info",
                "error": ["conn", str(e)]}

    def _txn(self, stmts_fn, op, read_only=False):
        """Run stmts_fn(conn) inside begin/commit with rollback and
        classification (`sql.clj` with-txn). SQL/connection errors are
        classified into fail/info; other exceptions (client control
        flow like a failed CAS) roll back and propagate."""
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


# -- transactional micro-op client (`txn.clj`) -------------------------------

class TxnClient(_SQLClient):
    """Executes [f k v] micro-op transactions over `table_count` striped
    tables (`txn.clj:8-51`). Appends use ON DUPLICATE KEY UPDATE +
    CONCAT so the row is created or extended atomically."""

    def __init__(self, table_count: int = 7):
        super().__init__()
        self.table_count = table_count

    def _table(self, k) -> str:
        return f"txn{hash(k) % self.table_count}"

    def setup(self, test):
        for i in range(self.table_count):
            self.conn.query(
                f"create table if not exists txn{i} "
                f"(id int not null primary key, sk int not null, "
                f"val text)")

    def _mop(self, conn, m):
        f, k, v = m[0], m[1], m[2]
        t = self._table(k)
        if f == "r":
            rows, _ = conn.query(
                f"select val from {t} where id = {_q(k)}")
            if not rows or rows[0][0] is None:
                return ["r", k, []]
            raw = rows[0][0]
            return ["r", k, [int(x) for x in raw.split(",") if x != ""]]
        if f == "w":
            conn.query(
                f"insert into {t} (id, sk, val) values "
                f"({_q(k)}, {_q(k)}, {_q(str(v))}) "
                f"on duplicate key update val = {_q(str(v))}")
            return ["w", k, v]
        if f == "append":
            conn.query(
                f"insert into {t} (id, sk, val) values "
                f"({_q(k)}, {_q(k)}, {_q(str(v))}) "
                f"on duplicate key update val = "
                f"concat(val, ',', {_q(str(v))})")
            return ["append", k, v]
        raise ValueError(f"unknown micro-op {f!r}")

    def invoke(self, test, op):
        txn = op["value"]

        def body(conn):
            return {"value": [self._mop(conn, m) for m in txn]}

        if len(txn) > 1:
            return self._txn(body, op,
                             read_only=all(m[0] == "r" for m in txn))
        try:
            return {**op, "type": "ok", **body(self.conn)}
        except Exception as e:  # noqa: BLE001 — classified
            return self._capture(op, e,
                                 read_only=all(m[0] == "r" for m in txn))


class WrTxnClient(TxnClient):
    """rw-register flavor: reads return a single int value."""

    def _mop(self, conn, m):
        f, k, v = m[0], m[1], m[2]
        t = self._table(k)
        if f == "r":
            rows, _ = conn.query(
                f"select val from {t} where id = {_q(k)}")
            val = None if not rows or rows[0][0] is None \
                else int(rows[0][0])
            return ["r", k, val]
        return super()._mop(conn, m)


# -- monotonic (`monotonic.clj`) ---------------------------------------------

class MonotonicClient(_SQLClient):
    """Read-increment-write registers (`monotonic.clj:24-60`): a 'w'
    micro-op with a nil value writes its key's just-read value + 1, so
    every committed write is predecessor + 1. Reads in read-write txns
    take locks (select for update) like the reference's increments."""

    def setup(self, test):
        self.conn.query("create table if not exists mono "
                        "(id int not null primary key, val int)")

    def invoke(self, test, op):
        txn = op["value"]
        read_only = all(m[0] == "r" for m in txn)

        def body(conn):
            out = []
            cur: dict = {}
            for m in txn:
                f, k, v = m[0], m[1], m[2]
                if f == "r":
                    lock = "" if read_only else " for update"
                    rows, _ = conn.query(
                        f"select val from mono where id = {_q(k)}"
                        f"{lock}")
                    val = None if not rows or rows[0][0] is None \
                        else int(rows[0][0])
                    cur[k] = val
                    out.append(["r", k, val])
                else:
                    val = v if v is not None else (cur.get(k) or 0) + 1
                    conn.query(
                        f"insert into mono (id, val) values "
                        f"({_q(k)}, {_q(val)}) "
                        f"on duplicate key update val = {_q(val)}")
                    cur[k] = val
                    out.append(["w", k, val])
            return {"value": out}

        return self._txn(body, op, read_only=read_only)


# -- table (`table.clj`) -----------------------------------------------------

class TableClient(_SQLClient):
    """Creates numbered tables and races inserts into them; an insert
    that finds no table fails ['table-missing', t] (MySQL 1146), which
    the checker cross-references against create completions."""

    def invoke(self, test, op):
        if op["f"] == "create-table":
            t = op["value"]
            try:
                self.conn.query(
                    f"create table if not exists tbl{_q(t)} "
                    f"(id int not null primary key, val int)")
                return {**op, "type": "ok"}
            except Exception as e:  # noqa: BLE001 — classified
                return self._capture(op, e, read_only=False)
        t, k = op["value"]
        try:
            self.conn.query(f"insert into tbl{_q(t)} (id, val) values "
                            f"({_q(k)}, 1)")
            return {**op, "type": "ok"}
        except MySQLError as e:
            if e.code == 1146:
                return {**op, "type": "fail",
                        "error": ["table-missing", t]}
            return self._capture(op, e, read_only=False)
        except Exception as e:  # noqa: BLE001 — classified
            return self._capture(op, e, read_only=False)


# -- bank (`bank.clj`) -------------------------------------------------------

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
                    f"({_q(a)}, {_q(total if a == accounts[0] else 0)})")
            except MySQLError as e:
                if e.code != 1062:  # another client seeded it
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
                f"select balance from accounts where id = {_q(frm)} "
                f"for update")
            b1 = int(rows[0][0]) - amount
            rows, _ = conn.query(
                f"select balance from accounts where id = {_q(to)} "
                f"for update")
            b2 = int(rows[0][0]) + amount
            if b1 < 0:
                raise _InsufficientFunds(frm, b1)
            conn.query(f"update accounts set balance = {_q(b1)} "
                       f"where id = {_q(frm)}")
            conn.query(f"update accounts set balance = {_q(b2)} "
                       f"where id = {_q(to)}")
            return {}

        try:
            return self._txn(transfer_body, op)
        except _InsufficientFunds as e:
            return {**op, "type": "fail",
                    "value": ["negative", e.account, e.balance]}


class _InsufficientFunds(Exception):
    def __init__(self, account, balance):
        super().__init__(f"{account} would go to {balance}")
        self.account = account
        self.balance = balance


# -- linearizable register (`register.clj`) ----------------------------------

class RegisterClient(_SQLClient):
    """Independent-keyed CAS register: read/write/cas over one row per
    key, cas via select-for-update + conditional update in a txn."""

    def setup(self, test):
        self.conn.query("create table if not exists test "
                        "(id int not null primary key, val int)")

    def invoke(self, test, op):
        v = op["value"]
        if independent.is_tuple(v):
            k, inner = v

            def wrap(x):
                return independent.ktuple(k, x)
        else:
            k, inner = 0, v

            def wrap(x):
                return x

        if op["f"] == "read":
            def read_body(conn):
                rows, _ = conn.query(
                    f"select val from test where id = {_q(k)}")
                val = None if not rows or rows[0][0] is None \
                    else int(rows[0][0])
                return {"value": wrap(val)}
            try:
                return {**op, "type": "ok", **read_body(self.conn)}
            except Exception as e:  # noqa: BLE001 — classified
                return self._capture(op, e, read_only=True)

        if op["f"] == "write":
            def write_body(conn):
                conn.query(
                    f"insert into test (id, val) values "
                    f"({_q(k)}, {_q(inner)}) "
                    f"on duplicate key update val = {_q(inner)}")
                return {}
            return self._txn(write_body, op)

        old, new = inner

        def cas_body(conn):
            rows, _ = conn.query(
                f"select val from test where id = {_q(k)} for update")
            cur = None if not rows or rows[0][0] is None \
                else int(rows[0][0])
            if cur != old:
                raise _CasFail()
            conn.query(f"update test set val = {_q(new)} "
                       f"where id = {_q(k)}")
            return {}

        try:
            return self._txn(cas_body, op)
        except _CasFail:
            return {**op, "type": "fail"}


class _CasFail(Exception):
    pass


# -- grow-only set (`sets.clj`) ----------------------------------------------

class SetClient(_SQLClient):
    def setup(self, test):
        self.conn.query("create table if not exists sets "
                        "(id int not null auto_increment primary key, "
                        "value bigint)")

    def invoke(self, test, op):
        if op["f"] == "add":
            def add_body(conn):
                conn.query(f"insert into sets (value) values "
                           f"({_q(op['value'])})")
                return {}
            return self._txn(add_body, op)

        def read_body(conn):
            rows, _ = conn.query("select value from sets")
            return {"value": sorted(int(r[0]) for r in rows)}
        return self._txn(read_body, op, read_only=True)


# -- workloads ---------------------------------------------------------------

def append_workload(opts: dict) -> dict:
    w = append_w.workload(opts)
    w["client"] = TxnClient()
    return w


def wr_workload(opts: dict) -> dict:
    w = wr_w.workload(opts)
    w["client"] = WrTxnClient()
    return w


def bank_workload(opts: dict) -> dict:
    w = bank_w.test(opts)
    w["client"] = BankClient()
    return w


def register_workload(opts: dict) -> dict:
    w = linearizable_register.test({
        "nodes": opts["nodes"],
        "per-key-limit": opts.get("ops-per-key", 100),
        "device": opts.get("device"),
    })
    w["client"] = RegisterClient()
    return w


def set_workload(opts: dict) -> dict:
    adds = ({"type": "invoke", "f": "add", "value": i}
            for i in itertools.count())
    return {
        "client": SetClient(),
        "checker": checker.set_checker(),
        "generator": adds,
        "final-generator": gen.each_thread(gen.once(
            {"type": "invoke", "f": "read", "value": None})),
    }


def long_fork_workload(opts: dict) -> dict:
    w = long_fork_w.workload()
    w["client"] = WrTxnClient()
    return w


def monotonic_workload(opts: dict) -> dict:
    w = monotonic_w.workload(opts)
    w["client"] = MonotonicClient()
    return w


def sequential_workload(opts: dict) -> dict:
    w = sequential_w.workload(opts)
    w["client"] = WrTxnClient()
    return w


def table_workload(opts: dict) -> dict:
    w = table_w.workload(opts)
    w["client"] = TableClient()
    return w


WORKLOADS = {
    "append": append_workload,
    "wr": wr_workload,
    "bank": bank_workload,
    "register": register_workload,
    "set": set_workload,
    "long-fork": long_fork_workload,
    "monotonic": monotonic_workload,
    "sequential": sequential_workload,
    "table": table_workload,
}


def tidb_test(opts: dict) -> dict:
    """Build the test map from CLI options (`core.clj` + `run.sh`
    shape): workload menu x nemesis package."""
    workload_name = opts.get("workload", "append")
    return std_test(
        opts, name=f"tidb-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "append", DEFAULT_VERSION,
                    "TiDB version to install") + [
    cli.opt("--ops-per-key", type=int, default=100,
            help="ops per independent key (register workload)"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": tidb_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
