"""CockroachDB test suite.

Mirrors the reference's cockroachdb suite
(Jepsen's `cockroachdb/src/jepsen/cockroach{,.clj}/`): cluster
automation over the official binary tarball in insecure mode
(`auto.clj:60-140`), a Postgres-wire SQL layer with the reference's
retry/abort classification — SQLSTATE 40001 serialization conflicts are
definite aborts (`client.clj:150-210`) — and the workload menu:
bank (`bank.clj`), elle rw-register (BASELINE config 3 at 10k txns),
independent linearizable register (`register.clj`), grow-only set
(`sets.clj`), the Adya G2 predicate probe (`adya.clj`), and the
additional-graphs consumers: monotonic (`monotonic.clj`), sequential
(`sequential.clj`), and the realtime-gap comments probe
(`comments.clj`).

The clock-skew nemesis family (`nemesis.clj:201-270`, driving the
suite-local bumptime/adjtime C tools) maps to the framework clock
package, which compiles and runs the native C++ time tools on each node
(jepsen_tpu/native/{bump_time,strobe_time,adj_time}.cpp).

Clients speak the wire protocol directly (`pg_proto.py`); hermetic
tests run against an in-process Postgres-protocol fake
(tests/fake_pg.py), the reference's dummy tier.
"""

from __future__ import annotations

import itertools
import logging

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from .. import independent
from ..control import util as cu
from ..workloads import adya as adya_w, bank as bank_w, \
    comments as comments_w, linearizable_register, \
    monotonic as monotonic_w, sequential as sequential_w, wr as wr_w
from . import std_opts, std_test
from .pg_proto import Conn, PGError

log = logging.getLogger(__name__)

DIR = "/opt/cockroach"
BINARY = f"{DIR}/cockroach"
LOGFILE = f"{DIR}/cockroach.log"
PIDFILE = f"{DIR}/cockroach.pid"
STORE = f"{DIR}/data"

SQL_PORT = 26257
HTTP_PORT = 8080

DEFAULT_VERSION = "2.1.6"

# SQLSTATEs that mean the txn definitely rolled back: serialization
# conflicts CockroachDB asks clients to retry (`client.clj:150-210`).
# 40003 (statement_completion_unknown / "result is ambiguous") is NOT
# here: the commit may have applied, so it must classify as :info.
DEFINITE_ABORT = {"40001", "40P01"}


def tarball_url(version: str) -> str:
    return (f"https://binaries.cockroachdb.com/"
            f"cockroach-v{version}.linux-amd64.tgz")


class DB(jdb.DB, jdb.Process, jdb.Pause, jdb.LogFiles):
    """cockroach start --insecure on every node, joined to the full
    node list (`auto.clj:60-140`)."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing cockroach %s", node, self.version)
            url = test.get("tarball") or tarball_url(self.version)
            cu.install_archive(url, DIR)
            control.exec_("mkdir", "-p", STORE)
            self.start(test, node)
            cu.await_tcp_port(SQL_PORT)
            if node == test["nodes"][0]:
                control.exec_(BINARY, "init", "--insecure",
                              f"--host={node}:{SQL_PORT}")

    def start(self, test, node):
        join = ",".join(f"{n}:{SQL_PORT}" for n in test["nodes"])
        with control.su():
            cu.start_daemon(
                {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
                BINARY, "start", "--insecure",
                f"--store={STORE}",
                f"--listen-addr=0.0.0.0:{SQL_PORT}",
                f"--advertise-addr={node}:{SQL_PORT}",
                f"--http-addr=0.0.0.0:{HTTP_PORT}",
                f"--join={join}",
                "--background")

    def teardown(self, test, node):
        log.info("%s tearing down cockroach", node)
        with control.su():
            self.kill(test, node)
            control.exec_("rm", "-rf", STORE, LOGFILE, PIDFILE)

    def kill(self, test, node):
        with control.su():
            cu.stop_daemon(PIDFILE, cmd="cockroach")
            cu.grepkill("cockroach")

    def pause(self, test, node):
        with control.su():
            cu.signal("cockroach", "STOP")

    def resume(self, test, node):
        with control.su():
            cu.signal("cockroach", "CONT")

    def log_files(self, test, node):
        return [LOGFILE]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


# -- SQL layer (`client.clj`) ------------------------------------------------

def _connect(test, node) -> Conn:
    fn = test.get("sql-conn-fn")
    if fn is not None:
        return fn(node)
    return Conn(node, SQL_PORT, user="root", database="jepsen",
                timeout_s=10.0)


def _q(s) -> str:
    if isinstance(s, bool):
        raise ValueError("no boolean literals here")
    if isinstance(s, int):
        return str(s)
    s = str(s)
    if "'" in s or "\\" in s:
        raise ValueError(f"unquotable literal {s!r}")
    return f"'{s}'"


class _SQLClient(jclient.Client):
    """Shared open/close and the reference's error classification:
    DEFINITE_ABORT SQLSTATEs -> fail; other errors -> info unless the
    op was read-only (`client.clj:150-210`)."""

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


# -- bank (`bank.clj`) -------------------------------------------------------

class BankClient(_SQLClient):
    def setup(self, test):
        self.conn.query("create table if not exists accounts "
                        "(id int primary key, balance bigint)")
        accounts = test.get("accounts", list(range(8)))
        total = test.get("total-amount", 100)
        for a in accounts:
            self.conn.query(
                f"upsert into accounts (id, balance) values "
                f"({_q(a)}, {_q(total if a == accounts[0] else 0)})")

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
                f"select balance from accounts where id = {_q(frm)}")
            b1 = int(rows[0][0]) - amount
            rows, _ = conn.query(
                f"select balance from accounts where id = {_q(to)}")
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


# -- rw-register txns (`register.clj` + elle wr) -----------------------------

class WrTxnClient(_SQLClient):
    """[f k v] micro-op transactions over a single striped table."""

    def setup(self, test):
        self.conn.query("create table if not exists txns "
                        "(id int primary key, val int)")

    def _mop(self, conn, m):
        f, k, v = m[0], m[1], m[2]
        if f == "r":
            rows, _ = conn.query(
                f"select val from txns where id = {_q(k)}")
            val = None if not rows or rows[0][0] is None \
                else int(rows[0][0])
            return ["r", k, val]
        conn.query(f"upsert into txns (id, val) values "
                   f"({_q(k)}, {_q(v)})")
        return ["w", k, v]

    def invoke(self, test, op):
        txn = op["value"]

        def body(conn):
            return {"value": [self._mop(conn, m) for m in txn]}
        return self._txn(body, op,
                         read_only=all(m[0] == "r" for m in txn))


# -- monotonic (`monotonic.clj`) ---------------------------------------------

class MonotonicClient(_SQLClient):
    """Read-increment-write registers (`monotonic.clj:33-88`): a 'w'
    micro-op with a nil value writes its key's just-read value + 1;
    CockroachDB's serializable default makes the read-modify-write
    atomic without explicit locks."""

    def setup(self, test):
        self.conn.query("create table if not exists mono "
                        "(id int primary key, val int)")

    def invoke(self, test, op):
        txn = op["value"]

        def body(conn):
            out = []
            cur: dict = {}
            for m in txn:
                f, k, v = m[0], m[1], m[2]
                if f == "r":
                    rows, _ = conn.query(
                        f"select val from mono where id = {_q(k)}")
                    val = None if not rows or rows[0][0] is None \
                        else int(rows[0][0])
                    cur[k] = val
                    out.append(["r", k, val])
                else:
                    val = v if v is not None else (cur.get(k) or 0) + 1
                    conn.query(f"upsert into mono (id, val) values "
                               f"({_q(k)}, {_q(val)})")
                    cur[k] = val
                    out.append(["w", k, val])
            return {"value": out}

        return self._txn(body, op,
                         read_only=all(m[0] == "r" for m in txn))


# -- comments (`comments.clj`) -----------------------------------------------

class CommentsClient(_SQLClient):
    """Insert numbered rows, read all of them back (`comments.clj:
    20-63` — the suite's realtime-gap probe)."""

    def setup(self, test):
        self.conn.query("create table if not exists comments "
                        "(id int primary key, val int)")

    def invoke(self, test, op):
        if op["f"] == "write":
            def write_body(conn):
                conn.query(f"insert into comments (id, val) values "
                           f"({_q(op['value'])}, 1)")
                return {}
            return self._txn(write_body, op)

        def read_body(conn):
            rows, _ = conn.query("select id from comments")
            return {"value": sorted(int(r[0]) for r in rows)}
        return self._txn(read_body, op, read_only=True)


# -- linearizable register (`register.clj`) ----------------------------------

class RegisterClient(_SQLClient):
    def setup(self, test):
        self.conn.query("create table if not exists test "
                        "(id int primary key, val int)")

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
            try:
                rows, _ = self.conn.query(
                    f"select val from test where id = {_q(k)}")
                val = None if not rows or rows[0][0] is None \
                    else int(rows[0][0])
                return {**op, "type": "ok", "value": wrap(val)}
            except Exception as e:  # noqa: BLE001 — classified
                return self._capture(op, e, read_only=True)

        if op["f"] == "write":
            def write_body(conn):
                conn.query(f"upsert into test (id, val) values "
                           f"({_q(k)}, {_q(inner)})")
                return {}
            return self._txn(write_body, op)

        old, new = inner

        def cas_body(conn):
            rows, _ = conn.query(
                f"select val from test where id = {_q(k)}")
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
                        "(id serial primary key, val bigint)")

    def invoke(self, test, op):
        if op["f"] == "add":
            def add_body(conn):
                conn.query(
                    f"insert into sets (val) values ({_q(op['value'])})")
                return {}
            return self._txn(add_body, op)

        def read_body(conn):
            rows, _ = conn.query("select val from sets")
            return {"value": sorted(int(r[0]) for r in rows)}
        return self._txn(read_body, op, read_only=True)


# -- Adya G2 predicate probe (`adya.clj`) ------------------------------------

class G2Client(_SQLClient):
    """Each insert txn reads both tables by key predicate and inserts
    its row only if both are empty — serializability allows at most one
    success per key."""

    def setup(self, test):
        self.conn.query("create table if not exists a "
                        "(id int primary key, k int, val int)")
        self.conn.query("create table if not exists b "
                        "(id int primary key, k int, val int)")

    def invoke(self, test, op):
        v = op["value"]
        k, ids = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        a_id, b_id = ids

        def body(conn):
            ra, _ = conn.query(f"select id from a where k = {_q(k)}")
            rb, _ = conn.query(f"select id from b where k = {_q(k)}")
            if ra or rb:
                raise _G2Blocked()
            if a_id is not None:
                conn.query(f"insert into a (id, k, val) values "
                           f"({_q(a_id)}, {_q(k)}, 1)")
            else:
                conn.query(f"insert into b (id, k, val) values "
                           f"({_q(b_id)}, {_q(k)}, 1)")
            return {}

        try:
            return self._txn(body, op)
        except _G2Blocked:
            return {**op, "type": "fail", "error": "already-inserted"}


class _G2Blocked(Exception):
    pass


# -- workloads ---------------------------------------------------------------

def bank_workload(opts: dict) -> dict:
    w = bank_w.test(opts)
    w["client"] = BankClient()
    return w


def wr_workload(opts: dict) -> dict:
    w = wr_w.workload(opts)
    w["client"] = WrTxnClient()
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


def g2_workload(opts: dict) -> dict:
    w = adya_w.workload()
    w["client"] = G2Client()
    return w


def monotonic_workload(opts: dict) -> dict:
    w = monotonic_w.workload(opts)
    w["client"] = MonotonicClient()
    return w


def sequential_workload(opts: dict) -> dict:
    w = sequential_w.workload(opts)
    w["client"] = WrTxnClient()
    return w


def comments_workload(opts: dict) -> dict:
    w = comments_w.workload(opts)
    w["client"] = CommentsClient()
    return w


WORKLOADS = {
    "bank": bank_workload,
    "wr": wr_workload,
    "register": register_workload,
    "set": set_workload,
    "g2": g2_workload,
    "monotonic": monotonic_workload,
    "sequential": sequential_workload,
    "comments": comments_workload,
}


def cockroach_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "bank")
    return std_test(
        opts, name=f"cockroach-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "bank", DEFAULT_VERSION,
                    "CockroachDB version to install") + [
    cli.opt("--ops-per-key", type=int, default=100,
            help="ops per independent key (register workload)"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": cockroach_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
