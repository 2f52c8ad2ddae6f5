"""YugaByte DB test suite — dual-API (YCQL + YSQL).

Mirrors the reference's yugabyte suite
(Jepsen's `yugabyte/src/yugabyte/`): community-edition
master/tserver automation (`auto.clj:334-445`), the master/tserver
process nemesis plus partitions and clock skew (`nemesis.clj:12-120`,
`core.clj:128-165`), and both API surfaces (`core.clj:75-105`):

  * YCQL (Cassandra-compatible, port 9042) — bank, counter, set,
    set-index, long-fork, single-key-acid, multi-key-acid, driven
    through the hand-rolled CQL wire client (`cql_proto.py`) instead
    of the DataStax driver (`ycql/client.clj`).
  * YSQL (Postgres-compatible, port 5433) — bank, bank-multitable,
    counter, set, long-fork, single-key-acid, multi-key-acid,
    append (elle list-append, `ysql/append.clj`), default-value
    (`ysql/default_value.clj`) — via the Postgres wire client
    (`pg_proto.py`) instead of JDBC (`ysql/client.clj`).

Workload names are namespaced exactly like the reference's CLI:
``ycql/bank``, ``ysql/append``, ... (`core.clj:75-105`).
"""

from __future__ import annotations

import itertools
import logging
import re

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from .. import independent, models
from ..checker import linear, timeline
from ..control import util as cu
from ..nemesis import Nemesis, compose as nemesis_compose
from ..nemesis import combined, partition as npartition, time as ntime
from ..workloads import append as append_w, bank as bank_w, \
    long_fork as long_fork_w
from . import std_test
from .cql_proto import CQLError, Conn as CQLConn, \
    ERR_ALREADY_EXISTS, ERR_INVALID, ERR_SYNTAX
from .pg_proto import Conn as PGConn, PGError

log = logging.getLogger(__name__)

DIR = "/home/yugabyte"
DATA_DIR = f"{DIR}/data"
MASTER_BIN = f"{DIR}/bin/yb-master"
TSERVER_BIN = f"{DIR}/bin/yb-tserver"
MASTER_LOG_DIR = f"{DATA_DIR}/yb-data/master/logs"
TSERVER_LOG_DIR = f"{DATA_DIR}/yb-data/tserver/logs"
MASTER_LOGFILE = f"{MASTER_LOG_DIR}/stdout"
TSERVER_LOGFILE = f"{TSERVER_LOG_DIR}/stdout"
MASTER_PIDFILE = f"{DIR}/master.pid"
TSERVER_PIDFILE = f"{DIR}/tserver.pid"
INSTALLED_URL_FILE = f"{DIR}/installed-url"

MASTER_RPC_PORT = 7100
YCQL_PORT = 9042
YSQL_PORT = 5433

KEYSPACE = "jepsen"
DEFAULT_VERSION = "1.3.1.0"

LIMITS_CONF = "* hard nofile 1048576\n* soft nofile 1048576"


def download_url(version: str) -> str:
    """`auto.clj:258-261`."""
    return f"https://downloads.yugabyte.com/yugabyte-{version}-linux.tar.gz"


def replication_factor(test: dict) -> int:
    return int(test.get("replication-factor", 3))


def master_nodes(test: dict) -> list:
    """Masters run on the first RF nodes (`auto.clj:57-66`)."""
    nodes = test["nodes"][:replication_factor(test)]
    if len(nodes) < replication_factor(test):
        raise ValueError(
            f"need {replication_factor(test)} master nodes, have "
            f"{test['nodes']}")
    return nodes


def master_node(test: dict, node: str) -> bool:
    return node in master_nodes(test)


def master_addresses(test: dict) -> str:
    """"n1:7100,n2:7100,..." (`auto.clj:72-80`)."""
    return ",".join(f"{n}:{MASTER_RPC_PORT}" for n in master_nodes(test))


def api_of(test: dict) -> str:
    """'ycql' or 'ysql', from the namespaced workload name."""
    api = test.get("api")
    if api:
        return api
    w = test.get("workload", "ycql/bank")
    return w.split("/", 1)[0] if "/" in w else "ycql"


class DB(jdb.DB, jdb.Process, jdb.Pause, jdb.Primary, jdb.LogFiles):
    """Community-edition automation (`auto.clj:334-445`): install the
    release tarball + post_install once per URL, raise ulimits, start
    yb-master on the first RF nodes and yb-tserver everywhere, wait
    for both via yb-admin."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    # -- install / configure -------------------------------------------------

    def _install(self, test):
        url = test.get("url") or test.get("tarball") \
            or download_url(test.get("version", self.version))
        installed = control.exec_(
            "bash", "-c", f"cat {INSTALLED_URL_FILE} 2>/dev/null || true")
        if installed.strip() == url:
            return
        log.info("installing yugabyte from %s", url)
        cu.install_archive(url, DIR)
        with control.cd(DIR):
            control.exec_("./bin/post_install.sh")
            control.exec_("bash", "-c",
                          f"echo '{url}' > {INSTALLED_URL_FILE}")

    def _configure(self):
        """ulimit raise (`auto.clj:358-366`)."""
        control.exec_("bash", "-c",
                      f"echo '{LIMITS_CONF}' > "
                      "/etc/security/limits.d/jepsen.conf")

    # -- lifecycle -----------------------------------------------------------

    def setup(self, test, node):
        with control.su():
            self._install(test)
            self._configure()
            self.start(test, node)

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf", DATA_DIR)

    def shared_opts(self, node) -> list:
        """`auto.clj:284-300`."""
        return ["--fs_data_dirs", DATA_DIR,
                "--memory_limit_hard_bytes", "2147483648",
                "--yb_num_shards_per_tserver", "4",
                "--rpc_bind_addresses", node]

    def start_master(self, test, node):
        api = api_of(test)
        with control.su():
            control.exec_("mkdir", "-p", MASTER_LOG_DIR)
            args = self.shared_opts(node) + [
                "--master_addresses", master_addresses(test),
                "--replication_factor", str(replication_factor(test))]
            if api == "ysql":
                args.append("--use_initial_sys_catalog_snapshot")
            cu.start_daemon(
                {"logfile": MASTER_LOGFILE, "pidfile": MASTER_PIDFILE,
                 "chdir": DIR},
                MASTER_BIN, *args)

    def start_tserver(self, test, node):
        api = api_of(test)
        with control.su():
            control.exec_("mkdir", "-p", TSERVER_LOG_DIR)
            args = self.shared_opts(node) + [
                "--tserver_master_addrs", master_addresses(test),
                "--enable_tracing",
                "--rpc_slow_query_threshold_ms", "1000",
                "--load_balancer_max_concurrent_adds", "10"]
            if api == "ysql":
                args += ["--start_pgsql_proxy",
                         "--pgsql_proxy_bind_address", node]
            cu.start_daemon(
                {"logfile": TSERVER_LOGFILE, "pidfile": TSERVER_PIDFILE,
                 "chdir": DIR},
                TSERVER_BIN, *args)

    def stop_master(self, test, node):
        with control.su():
            cu.stop_daemon(MASTER_PIDFILE, cmd="yb-master")

    def stop_tserver(self, test, node):
        with control.su():
            cu.stop_daemon(TSERVER_PIDFILE, cmd="yb-tserver")
            cu.grepkill("postgres")

    def kill_master(self, test, node):
        with control.su():
            cu.grepkill("yb-master")
        self.stop_master(test, node)

    def kill_tserver(self, test, node):
        with control.su():
            cu.grepkill("yb-tserver")
        self.stop_tserver(test, node)

    def start(self, test, node):
        """Master (if a master node) then tserver (`auto.clj:180-194`)."""
        if master_node(test, node):
            self.start_master(test, node)
        self.start_tserver(test, node)

    def kill(self, test, node):
        self.kill_tserver(test, node)
        if master_node(test, node):
            self.kill_master(test, node)

    def pause(self, test, node):
        with control.su():
            cu.signal("yb-master", "STOP")
            cu.signal("yb-tserver", "STOP")

    def resume(self, test, node):
        with control.su():
            cu.signal("yb-master", "CONT")
            cu.signal("yb-tserver", "CONT")

    def setup_primary(self, test, node):
        pass

    def log_files(self, test, node):
        return [MASTER_LOGFILE, TSERVER_LOGFILE]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


# ---------------------------------------------------------------------------
# YCQL data plane (`ycql/client.clj`)
# ---------------------------------------------------------------------------

# Messages that mean the transaction *definitely* failed
# (`ycql/client.clj:234-240`).
_CQL_DEFINITE_FAIL = re.compile(
    r"Value write after transaction start"
    r"|Conflicts with higher priority transaction"
    r"|Conflicts with committed transaction"
    r"|Operation expired: .*status: COMMITTED .*Transaction expired")


def _cql_connect(test, node) -> CQLConn:
    fn = test.get("cql-conn-fn")
    if fn is not None:
        return fn(node)
    return CQLConn(node, YCQL_PORT, timeout_s=10.0)


def _q(v) -> str:
    """Quote a scalar literal into CQL/SQL text."""
    if isinstance(v, bool):
        raise ValueError("no boolean literals here")
    if isinstance(v, int):
        return str(v)
    s = str(v)
    if "'" in s or "\\" in s:
        raise ValueError(f"unquotable literal {s!r}")
    return f"'{s}'"


def _close_quietly(conn) -> None:
    if conn is not None:
        try:
            conn.close()
        except Exception:  # noqa: BLE001 — already broken
            pass


def _reconn_fail(op) -> dict:
    # A failed reconnect proves the op was never sent, so "fail" is
    # safe for reads and writes alike.
    return {**op, "type": "fail", "error": ["conn", "reconnect-failed"]}


class _CQLClient(jclient.Client):
    """Shared open/close + the with-errors classification
    (`ycql/client.clj:197-245`): unavailable -> fail; timeouts ->
    fail when the op was idempotent, else info; messages that prove
    the txn failed -> fail; everything else indeterminate."""

    # ops that are safe to call :fail on error
    idempotent: frozenset = frozenset({"read"})

    def __init__(self):
        self.conn: CQLConn | None = None

    def open(self, test, node):
        c = type(self).__new__(type(self))
        c.__dict__.update(self.__dict__)
        c.node = node
        c.conn = _cql_connect(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def _drop_conn(self):
        """Discard a desynchronized connection. After a socket-level
        timeout the server's late response frame would otherwise be
        read as the next query's result (the raw socket has no
        stream-id correlation the way the reference's DataStax driver
        does, `ycql/client.clj:197`), so the socket must never be
        reused."""
        _close_quietly(self.conn)
        self.conn = None

    def _ensure_keyspace(self, test):
        self.conn.query(
            f"CREATE KEYSPACE IF NOT EXISTS {KEYSPACE} WITH replication"
            " = {'class': 'SimpleStrategy', 'replication_factor': "
            f"{replication_factor(test)}}}")

    def invoke(self, test, op):
        crash = "fail" if op["f"] in self.idempotent else "info"
        if self.conn is None:
            try:
                self.conn = _cql_connect(test, self.node)
            except (ConnectionError, OSError, CQLError) as e:
                # CQLError covers an ERROR frame during STARTUP — a
                # recovering tserver answering Overloaded/ServerError.
                return {**op, "type": "fail", "error": ["conn", str(e)]}
        try:
            return self._invoke(test, op)
        except CQLError as e:
            if e.unavailable:
                return {**op, "type": "fail",
                        "error": ["unavailable", e.message]}
            if e.timeout:
                return {**op, "type": crash, "error": "timed-out"}
            if _CQL_DEFINITE_FAIL.search(e.message):
                return {**op, "type": "fail", "error": e.message}
            if e.code in (ERR_SYNTAX, ERR_ALREADY_EXISTS):
                raise
            if e.code == ERR_INVALID:
                if re.search(r"RPC to .+ timed out after", e.message):
                    return {**op, "type": crash,
                            "error": ["rpc-timed-out", e.message]}
                raise
            return {**op, "type": crash,
                    "error": ["cql", e.code, e.message]}
        except (ConnectionError, OSError) as e:
            self._drop_conn()
            return {**op, "type": crash, "error": ["conn", str(e)]}

    def _invoke(self, test, op):
        raise NotImplementedError


class CQLBank(_CQLClient):
    """Single-table bank over BEGIN/END TRANSACTION batches
    (`ycql/bank.clj:20-59`)."""

    idempotent = frozenset({"read"})

    def setup(self, test):
        self._ensure_keyspace(test)
        self.conn.query(
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.accounts "
            "(id INT PRIMARY KEY, balance BIGINT) "
            "WITH transactions = { 'enabled' : true }",
            timeout_s=30.0)
        accounts = test.get("accounts", list(range(8)))
        total = test.get("total-amount", 100)
        for a in accounts:
            bal = total if a == accounts[0] else 0
            self.conn.query(
                f"INSERT INTO {KEYSPACE}.accounts (id, balance) "
                f"VALUES ({_q(a)}, {_q(bal)})")

    def _invoke(self, test, op):
        if op["f"] == "read":
            rows, _ = self.conn.query(
                f"SELECT id, balance FROM {KEYSPACE}.accounts")
            return {**op, "type": "ok",
                    "value": {int(r[0]): int(r[1]) for r in rows}}
        v = op["value"]
        frm, to, amount = v["from"], v["to"], v["amount"]
        self.conn.query(
            "BEGIN TRANSACTION "
            f"UPDATE {KEYSPACE}.accounts SET balance = balance - "
            f"{amount} WHERE id = {frm};"
            f"UPDATE {KEYSPACE}.accounts SET balance = balance + "
            f"{amount} WHERE id = {to};"
            "END TRANSACTION;")
        return {**op, "type": "ok"}


class CQLCounter(_CQLClient):
    """One counter row (`ycql/counter.clj:13-37`)."""

    idempotent = frozenset({"read"})

    def setup(self, test):
        self._ensure_keyspace(test)
        self.conn.query(
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.counter "
            "(id INT PRIMARY KEY, count COUNTER)", timeout_s=30.0)
        self.conn.query(f"UPDATE {KEYSPACE}.counter SET count = count + 0"
                        " WHERE id = 0")

    def _invoke(self, test, op):
        if op["f"] == "add":
            v = op["value"]
            delta = f"+ {v}" if v >= 0 else f"- {-v}"
            self.conn.query(
                f"UPDATE {KEYSPACE}.counter SET count = count {delta} "
                "WHERE id = 0")
            return {**op, "type": "ok"}
        rows, _ = self.conn.query(
            f"SELECT count FROM {KEYSPACE}.counter WHERE id = 0")
        return {**op, "type": "ok",
                "value": int(rows[0][0]) if rows else 0}


class CQLSet(_CQLClient):
    """Set via per-element counter rows (`ycql/set.clj:11-33`)."""

    idempotent = frozenset({"read"})

    def setup(self, test):
        self._ensure_keyspace(test)
        self.conn.query(
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.elements "
            "(val INT PRIMARY KEY, count COUNTER)", timeout_s=30.0)

    def _invoke(self, test, op):
        if op["f"] == "add":
            self.conn.query(
                f"UPDATE {KEYSPACE}.elements SET count = count + 1 "
                f"WHERE val = {op['value']}")
            return {**op, "type": "ok"}
        rows, _ = self.conn.query(
            f"SELECT val, count FROM {KEYSPACE}.elements")
        out = []
        for val, count in rows:
            out.extend([int(val)] * int(count))
        return {**op, "type": "ok", "value": sorted(out)}


GROUP_COUNT = 8   # `ycql/set.clj:35-37`


class CQLSetIndex(_CQLClient):
    """Set read through a secondary index (`ycql/set.clj:39-72`)."""

    idempotent = frozenset({"read"})

    def setup(self, test):
        self._ensure_keyspace(test)
        self.conn.query(
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.elements2 "
            "(key INT PRIMARY KEY, val INT, grp INT) "
            "WITH transactions = { 'enabled' : true }", timeout_s=30.0)
        try:
            self.conn.query(
                f"CREATE INDEX elements_by_group ON {KEYSPACE}.elements2"
                " (grp) INCLUDE (val)", timeout_s=30.0)
        except CQLError as e:
            if "already exists" not in e.message:
                raise

    def _invoke(self, test, op):
        if op["f"] == "add":
            v = op["value"]
            self.conn.query(
                f"INSERT INTO {KEYSPACE}.elements2 (key, val, grp) "
                f"VALUES ({v}, {v}, {gen.rng.randrange(GROUP_COUNT)})")
            return {**op, "type": "ok"}
        groups = ", ".join(str(g) for g in range(GROUP_COUNT))
        rows, _ = self.conn.query(
            f"SELECT val FROM {KEYSPACE}.elements2 WHERE grp IN "
            f"({groups})")
        return {**op, "type": "ok",
                "value": sorted(int(r[0]) for r in rows)}


class CQLLongFork(_CQLClient):
    """Long-fork reads via the key2 index (`ycql/long_fork.clj:13-55`).
    Nothing is idempotent here — reads carry txn rewrites."""

    idempotent = frozenset()

    def setup(self, test):
        self._ensure_keyspace(test)
        self.conn.query(
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.long_fork "
            "(key INT PRIMARY KEY, key2 INT, val INT) "
            "WITH transactions = { 'enabled' : true }", timeout_s=30.0)
        try:
            self.conn.query(
                f"CREATE INDEX long_forks ON {KEYSPACE}.long_fork (key2)"
                " INCLUDE (val)", timeout_s=30.0)
        except CQLError as e:
            if "already exists" not in e.message:
                raise

    def _invoke(self, test, op):
        txn = op["value"]
        if op["f"] == "read":
            ks = ", ".join(str(k) for _f, k, _v in txn)
            rows, _ = self.conn.query(
                f"SELECT key2, val FROM {KEYSPACE}.long_fork "
                f"WHERE key2 IN ({ks})")
            vs = {int(k): int(v) for k, v in rows}
            txn2 = [[f, k, vs.get(k)] for f, k, _ in txn]
            return {**op, "type": "ok", "value": txn2}
        [[_f, k, v]] = txn
        self.conn.query(
            f"INSERT INTO {KEYSPACE}.long_fork (key, key2, val) "
            f"VALUES ({k}, {k}, {v})")
        return {**op, "type": "ok"}


class CQLSingleKey(_CQLClient):
    """Independent per-key linearizable registers
    (`ycql/single_key_acid.clj:15-48`)."""

    idempotent = frozenset({"read"})

    def setup(self, test):
        self._ensure_keyspace(test)
        self.conn.query(
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.single_key_acid "
            "(id INT PRIMARY KEY, val INT)", timeout_s=30.0)

    def _invoke(self, test, op):
        k, v = op["value"]
        if op["f"] == "write":
            self.conn.query(
                f"INSERT INTO {KEYSPACE}.single_key_acid (id, val) "
                f"VALUES ({k}, {v})")
            return {**op, "type": "ok"}
        if op["f"] == "cas":
            expected, new = v
            rows, cols = self.conn.query(
                f"UPDATE {KEYSPACE}.single_key_acid SET val = {new} "
                f"WHERE id = {k} IF val = {expected}")
            applied = bool(rows and rows[0][cols.index("[applied]")])
            return {**op, "type": "ok" if applied else "fail"}
        rows, _ = self.conn.query(
            f"SELECT val FROM {KEYSPACE}.single_key_acid "
            f"WHERE id = {k}")
        val = int(rows[0][0]) if rows and rows[0][0] is not None else None
        return {**op, "type": "ok",
                "value": independent.ktuple(k, val)}


class CQLMultiKey(_CQLClient):
    """Transactional multi-key writes, independent by ik
    (`ycql/multi_key_acid.clj:13-66`)."""

    idempotent = frozenset({"read"})

    def setup(self, test):
        self._ensure_keyspace(test)
        self.conn.query(
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.multi_key_acid "
            "(id INT, ik INT, val INT, PRIMARY KEY (id, ik)) "
            "WITH transactions = { 'enabled' : true }", timeout_s=30.0)

    def _invoke(self, test, op):
        ik, txn = op["value"]
        if op["f"] == "read":
            ks = ", ".join(str(k) for _f, k, _v in txn)
            rows, _ = self.conn.query(
                f"SELECT id, val FROM {KEYSPACE}.multi_key_acid "
                f"WHERE ik = {ik} AND id IN ({ks})")
            vs = {int(r[0]): int(r[1]) for r in rows if r[1] is not None}
            txn2 = [[f, k, vs.get(k)] for f, k, _ in txn]
            return {**op, "type": "ok",
                    "value": independent.ktuple(ik, txn2)}
        stmts = "".join(
            f"INSERT INTO {KEYSPACE}.multi_key_acid (id, ik, val) "
            f"VALUES ({k}, {ik}, {v});"
            for f, k, v in txn)
        self.conn.query(f"BEGIN TRANSACTION {stmts}END TRANSACTION;")
        return {**op, "type": "ok"}


# ---------------------------------------------------------------------------
# YSQL data plane (`ysql/client.clj`)
# ---------------------------------------------------------------------------

# SQLSTATEs proving rollback (serialization failure, deadlock, aborted
# txn) — safe to :fail (`ysql/client.clj:166-186` message classes).
YSQL_DEFINITE_ABORT = {"40001", "40P01", "25P02"}

_YSQL_FAIL_MSG = re.compile(
    r"conflicts with [- a-z]+ transaction"
    r"|catalog version mismatch"
    r"|try again"
    r"|restart read required", re.I)
_YSQL_INFO_MSG = re.compile(
    r"error during commit.*expired"
    r"|timed out after deadline expired", re.I)


def _ysql_connect(test, node) -> PGConn:
    fn = test.get("sql-conn-fn")
    if fn is not None:
        return fn(node)
    return PGConn(node, YSQL_PORT, user="postgres", database="postgres",
                  timeout_s=30.0)


class _YSQLClient(jclient.Client):
    """Shared open/close, txn wrapper, and exception->op
    classification (`ysql/client.clj:153-253`)."""

    def __init__(self):
        self.conn: PGConn | None = None

    def open(self, test, node):
        c = type(self).__new__(type(self))
        c.__dict__.update(self.__dict__)
        c.node = node
        c._test = test
        c.conn = _ysql_connect(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def _drop_conn(self):
        """Discard a connection after a socket-level error: a late
        response to a timed-out query would otherwise corrupt the next
        query's result. The reference routes ysql conns through
        jepsen.reconnect for the same reason (`ysql/client.clj:60`)."""
        _close_quietly(self.conn)
        self.conn = None

    def _ensure_conn(self) -> bool:
        if self.conn is None:
            try:
                self.conn = _ysql_connect(self._test, self.node)
            except (ConnectionError, OSError, PGError):
                # PGError covers a failed startup handshake — a
                # recovering node answering 57P03 "starting up" or
                # closing the socket mid-handshake (08006).
                self.conn = None
                return False
        return True

    def _capture(self, op, e: Exception, read_only: bool) -> dict:
        # SQLSTATE class 08 is a connection exception (pg_proto
        # synthesizes 08006 when the server closes the socket
        # mid-response) — socket-level, so the conn must be dropped
        # like any OSError.
        if isinstance(e, PGError) and not e.code.startswith("08"):
            definite = (e.code in YSQL_DEFINITE_ABORT
                        or (_YSQL_FAIL_MSG.search(e.message)
                            and not _YSQL_INFO_MSG.search(e.message)))
            if definite or read_only:
                return {**op, "type": "fail",
                        "error": ["sql", e.code, e.message]}
            return {**op, "type": "info",
                    "error": ["sql", e.code, e.message]}
        self._drop_conn()
        return {**op, "type": "fail" if read_only else "info",
                "error": ["conn", str(e)]}

    def _txn(self, stmts_fn, op, read_only=False):
        if not self._ensure_conn():
            return _reconn_fail(op)
        conn = self.conn
        try:
            conn.query("begin")
            out = stmts_fn(conn)
            conn.query("commit")
            return {**op, "type": "ok", **out}
        except Exception as e:  # noqa: BLE001 — classified below
            # Rolling back on a desynced socket would just stall for
            # another timeout; _capture drops the conn for those.
            socket_dead = (isinstance(e, (OSError, ConnectionError))
                           or (isinstance(e, PGError)
                               and e.code.startswith("08")))
            if not socket_dead:
                try:
                    conn.query("rollback")
                except Exception:  # noqa: BLE001 — conn is dead
                    self._drop_conn()
            if isinstance(e, (PGError, OSError, ConnectionError)):
                return self._capture(op, e, read_only)
            raise

    def _run(self, body_fn, op, read_only=False):
        """Single-statement op outside an explicit txn."""
        if not self._ensure_conn():
            return _reconn_fail(op)
        try:
            return {**op, "type": "ok", **body_fn(self.conn)}
        except (PGError, OSError, ConnectionError) as e:
            return self._capture(op, e, read_only)


def _upsert(conn, table: str, where_col: str, where_val, insert_sql: str,
            update_sql: str) -> None:
    """Update-then-insert, the reference's pattern for YB's lack of
    reliable upsert (`ysql/append.clj:56-68`)."""
    n, _ = conn.query(update_sql)
    if not n:
        conn.query(insert_sql)


class YSQLBank(_YSQLClient):
    """Single-table bank (`ysql/bank.clj:20-75`). The menu constructs
    it with negative balances allowed, as the reference does
    (`core.clj:95-96`, `->YSQLBankClient true`)."""

    def __init__(self, allow_negatives: bool = True):
        super().__init__()
        self.allow_negatives = allow_negatives

    def setup(self, test):
        self.conn.query("create table if not exists accounts "
                        "(id int primary key, balance bigint)")
        accounts = test.get("accounts", list(range(8)))
        total = test.get("total-amount", 100)
        for a in accounts:
            bal = total if a == accounts[0] else 0
            self.conn.query(
                f"insert into accounts (id, balance) values "
                f"({_q(a)}, {_q(bal)}) on conflict (id) do update set "
                f"balance = {_q(bal)}")

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
            if b1 < 0 and not self.allow_negatives:
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


class YSQLMultiBank(_YSQLClient):
    """Bank with one table per account (`ysql/bank.clj:77-123`);
    negative balances allowed at construction like the reference's
    `->YSQLMultiBankClient true` (`core.clj:97`)."""

    def __init__(self, allow_negatives: bool = True):
        super().__init__()
        self.allow_negatives = allow_negatives

    def setup(self, test):
        accounts = test.get("accounts", list(range(8)))
        total = test.get("total-amount", 100)
        for a in accounts:
            self.conn.query(f"create table if not exists accounts{a} "
                            "(id int primary key, balance bigint)")
            bal = total if a == accounts[0] else 0
            self.conn.query(
                f"insert into accounts{a} (id, balance) values "
                f"({_q(a)}, {_q(bal)}) on conflict (id) do update set "
                f"balance = {_q(bal)}")

    def invoke(self, test, op):
        accounts = test.get("accounts", list(range(8)))
        if op["f"] == "read":
            def read_body(conn):
                out = {}
                for a in accounts:
                    rows, _ = conn.query(
                        f"select balance from accounts{a} "
                        f"where id = {_q(a)}")
                    out[a] = int(rows[0][0])
                return {"value": out}
            return self._txn(read_body, op, read_only=True)

        v = op["value"]
        frm, to, amount = v["from"], v["to"], v["amount"]

        def transfer_body(conn):
            rows, _ = conn.query(
                f"select balance from accounts{frm} where id = {_q(frm)}")
            b1 = int(rows[0][0]) - amount
            rows, _ = conn.query(
                f"select balance from accounts{to} where id = {_q(to)}")
            b2 = int(rows[0][0]) + amount
            if b1 < 0 and not self.allow_negatives:
                raise _InsufficientFunds(frm, b1)
            conn.query(f"update accounts{frm} set balance = {_q(b1)} "
                       f"where id = {_q(frm)}")
            conn.query(f"update accounts{to} set balance = {_q(b2)} "
                       f"where id = {_q(to)}")
            return {}

        try:
            return self._txn(transfer_body, op)
        except _InsufficientFunds as e:
            return {**op, "type": "fail",
                    "value": ["negative", e.account, e.balance]}


class YSQLCounter(_YSQLClient):
    """Single-row counter (`ysql/counter.clj`)."""

    def setup(self, test):
        self.conn.query("create table if not exists counter "
                        "(id int primary key, count bigint)")
        self.conn.query("insert into counter (id, count) values (0, 0) "
                        "on conflict (id) do update set count = count")

    def invoke(self, test, op):
        if op["f"] == "add":
            v = op["value"]
            expr = f"count + {v}" if v >= 0 else f"count - {-v}"
            return self._run(
                lambda conn: (conn.query(
                    f"update counter set count = {expr} where id = 0"),
                    {})[1],
                op)
        def read_body(conn):
            rows, _ = conn.query("select count from counter where id = 0")
            return {"value": int(rows[0][0])}
        return self._run(read_body, op, read_only=True)


class YSQLSet(_YSQLClient):
    """Grow-only set of inserted rows (`ysql/set.clj:14-45`)."""

    def setup(self, test):
        self.conn.query("create table if not exists elements "
                        "(val int primary key)")

    def invoke(self, test, op):
        if op["f"] == "add":
            v = op["value"]
            return self._run(
                lambda conn: (conn.query(
                    f"insert into elements (val) values ({_q(v)})"),
                    {})[1],
                op)
        def read_body(conn):
            rows, _ = conn.query("select val from elements")
            return {"value": sorted(int(r[0]) for r in rows)}
        return self._run(read_body, op, read_only=True)


class YSQLLongFork(_YSQLClient):
    """Long-fork over a plain table (`ysql/long_fork.clj`)."""

    def setup(self, test):
        self.conn.query("create table if not exists long_fork "
                        "(key int primary key, val int)")

    def invoke(self, test, op):
        txn = op["value"]
        if op["f"] == "read":
            def read_body(conn):
                vs = {}
                for _f, k, _v in txn:
                    rows, _ = conn.query(
                        f"select val from long_fork where key = {_q(k)}")
                    if rows:
                        vs[k] = int(rows[0][0])
                return {"value": [[f, k, vs.get(k)] for f, k, _ in txn]}
            return self._txn(read_body, op, read_only=True)
        [[_f, k, v]] = txn
        return self._run(
            lambda conn: (conn.query(
                f"insert into long_fork (key, val) values "
                f"({_q(k)}, {_q(v)})"), {})[1],
            op)


class YSQLSingleKey(_YSQLClient):
    """Independent per-key registers (`ysql/single_key_acid.clj`)."""

    def setup(self, test):
        self.conn.query("create table if not exists single_key_acid "
                        "(id int primary key, val int)")

    def invoke(self, test, op):
        k, v = op["value"]
        if op["f"] == "write":
            return self._run(
                lambda conn: (_upsert(
                    conn, "single_key_acid", "id", k,
                    f"insert into single_key_acid (id, val) values "
                    f"({_q(k)}, {_q(v)})",
                    f"update single_key_acid set val = {_q(v)} "
                    f"where id = {_q(k)}"), {})[1],
                op)
        if op["f"] == "cas":
            expected, new = v

            def cas_body(conn):
                rows, _ = conn.query(
                    f"select val from single_key_acid where id = {_q(k)}"
                    " for update")
                cur = int(rows[0][0]) if rows else None
                if cur != expected:
                    raise _CasFailed()
                conn.query(f"update single_key_acid set val = {_q(new)} "
                           f"where id = {_q(k)}")
                return {}
            try:
                return self._txn(cas_body, op)
            except _CasFailed:
                try:
                    self.conn.query("rollback")
                except Exception:  # noqa: BLE001
                    pass
                return {**op, "type": "fail"}

        def read_body(conn):
            rows, _ = conn.query(
                f"select val from single_key_acid where id = {_q(k)}")
            val = int(rows[0][0]) if rows and rows[0][0] is not None \
                else None
            return {"value": independent.ktuple(k, val)}
        return self._run(read_body, op, read_only=True)


class _CasFailed(Exception):
    pass


class YSQLMultiKey(_YSQLClient):
    """Transactional multi-key writes (`ysql/multi_key_acid.clj`)."""

    def setup(self, test):
        self.conn.query("create table if not exists multi_key_acid "
                        "(rowkey varchar(32) primary key, ik int, "
                        "id int, val int)")

    def invoke(self, test, op):
        ik, txn = op["value"]
        if op["f"] == "read":
            def read_body(conn):
                vs = {}
                for _f, k, _v in txn:
                    rows, _ = conn.query(
                        "select val from multi_key_acid where rowkey = "
                        f"{_q(f'{ik}_{k}')}")
                    if rows and rows[0][0] is not None:
                        vs[k] = int(rows[0][0])
                return {"value": independent.ktuple(
                    ik, [[f, k, vs.get(k)] for f, k, _ in txn])}
            return self._txn(read_body, op, read_only=True)

        def write_body(conn):
            for _f, k, v in txn:
                rk = _q(f"{ik}_{k}")
                _upsert(conn, "multi_key_acid", "rowkey", f"{ik}_{k}",
                        f"insert into multi_key_acid (rowkey, ik, id, "
                        f"val) values ({rk}, {_q(ik)}, {_q(k)}, {_q(v)})",
                        f"update multi_key_acid set val = {_q(v)} "
                        f"where rowkey = {rk}")
            return {}
        return self._txn(write_body, op)


# -- ysql append (`ysql/append.clj`) -----------------------------------------

TABLE_COUNT = 5       # `append.clj:19-22`
KEYS_PER_ROW = 2      # `append.clj:33`


def append_table_for(k) -> str:
    return f"append{hash(k) % TABLE_COUNT}"


def append_row_for(k) -> int:
    return k // KEYS_PER_ROW


def append_col_for(k) -> str:
    return f"v{k % KEYS_PER_ROW}"


class YSQLAppend(_YSQLClient):
    """Elle list-append over text-concat columns, multiple keys per
    row across several tables (`ysql/append.clj:18-140`)."""

    def setup(self, test):
        cols = ", ".join(f"{append_col_for(i)} text"
                         for i in range(KEYS_PER_ROW))
        for i in range(TABLE_COUNT):
            self.conn.query(
                f"create table if not exists append{i} "
                f"(k int primary key, k2 int, {cols})")

    def _mop(self, conn, mop):
        f, k, v = mop
        table, row, col = (append_table_for(k), append_row_for(k),
                           append_col_for(k))
        if f == "r":
            rows, _ = conn.query(
                f"select {col} from {table} where k = {_q(row)}")
            raw = rows[0][0] if rows else None
            vals = [int(x) for x in (raw or "").split(",") if x != ""]
            return [f, k, vals]
        # append (`append.clj:56-68`)
        n, _ = conn.query(
            f"update {table} set {col} = concat({col}, ',', {_q(v)}) "
            f"where k = {_q(row)}")
        if not n:
            conn.query(
                f"insert into {table} (k, k2, {col}) values "
                f"({_q(row)}, {_q(row)}, {_q(v)})")
        return [f, k, v]

    def invoke(self, test, op):
        txn = op["value"]
        if len(txn) > 1:
            def txn_body(conn):
                return {"value": [self._mop(conn, m) for m in txn]}
            return self._txn(txn_body, op)
        return self._run(
            lambda conn: {"value": [self._mop(conn, m) for m in txn]},
            op)


# -- ysql default-value (`ysql/default_value.clj`) ---------------------------

DV_TABLE = "foo"


class YSQLDefaultValue(_YSQLClient):
    """DDL/DML race client (`ysql/default_value.clj:100-123`)."""

    def invoke(self, test, op):
        f = op["f"]
        if not self._ensure_conn():
            return _reconn_fail(op)
        try:
            if f == "create-table":
                self.conn.query(
                    f"create table if not exists {DV_TABLE} "
                    "(dummy int, v int default 0)")
                return {**op, "type": "ok"}
            if f == "drop-table":
                self.conn.query(f"drop table if exists {DV_TABLE}")
                return {**op, "type": "ok"}
            if f == "insert":
                self.conn.query(
                    f"insert into {DV_TABLE} (dummy) values (1)")
                return {**op, "type": "ok"}
            if f == "read":
                rows, _ = self.conn.query(f"select v from {DV_TABLE}")
                return {**op, "type": "ok",
                        "value": [None if r[0] is None else int(r[0])
                                  for r in rows]}
            raise ValueError(f"unknown f {f!r}")
        except PGError as e:
            if re.search(r"does(n't| not) exist", e.message):
                return {**op, "type": "fail", "error": "table-missing"}
            return self._capture(op, e, read_only=(f == "read"))
        except (OSError, ConnectionError) as e:
            return self._capture(op, e, read_only=(f == "read"))


def default_value_checker() -> checker.Checker:
    """No ok read may observe a row whose v is null
    (`default_value.clj:35-76` in the shared workload file)."""
    def check(test, hist, opts):
        bad = []
        reads = 0
        for op in hist:
            if op.get("type") == "ok" and op.get("f") == "read":
                reads += 1
                if any(v is None for v in (op.get("value") or [])):
                    bad.append(op)
        return {"valid?": not bad, "read-count": reads,
                "bad-read-count": len(bad), "bad-reads": bad[:16]}
    return checker.coerce(check)


# ---------------------------------------------------------------------------
# Workloads (`core.clj:75-105` + the shared workload files)
# ---------------------------------------------------------------------------

def _naturals():
    return itertools.count()


def bank_workload(opts, client) -> dict:
    """`bank.clj:9-15` — negative balances allowed in both APIs."""
    w = bank_w.test({"negative-balances?": True})
    return {"client": client, "generator": w["generator"],
            "final-generator": w.get("final-generator"),
            "checker": checker.compose({
                "bank": w["checker"], "timeline": timeline.html()})}


def counter_workload(opts, client) -> dict:
    """Increment-only counter (`counter.clj:9-24`). Function
    generators: bare dicts are one-shot, which would cap the run at
    ~101 ops with at most a single read."""
    def add(test, ctx):
        return {"type": "invoke", "f": "add", "value": 1}

    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    return {"client": client,
            "generator": gen.mix([r] + [add] * 100),
            "checker": checker.compose({
                "timeline": timeline.html(),
                "counter": checker.counter(),
                "counter-plot": checker.counter_plot()})}


def set_workload(opts, client) -> dict:
    """Half the threads add, half read (`set.clj:10-26`)."""
    adds = ({"type": "invoke", "f": "add", "value": i}
            for i in _naturals())
    reads = {"type": "invoke", "f": "read", "value": None}
    n = max(1, opts.get("concurrency", 5) // 2)
    return {"client": client,
            "generator": gen.reserve(n, adds, reads),
            "final-generator": gen.each_thread(gen.once(
                {"type": "invoke", "f": "read", "value": None})),
            "checker": checker.set_full()}


def long_fork_workload(opts, client) -> dict:
    w = long_fork_w.workload(3)
    return {"client": client, "generator": w["generator"],
            "checker": w["checker"]}


def single_key_acid_workload(opts, client) -> dict:
    """2n threads per key: n writers/cas, n readers
    (`single_key_acid.clj:31-49`)."""
    n = len(opts.get("nodes", ["n1", "n2", "n3", "n4", "n5"]))

    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def w(test, ctx):
        return {"type": "invoke", "f": "write",
                "value": gen.rng.randrange(5)}

    def cas(test, ctx):
        return {"type": "invoke", "f": "cas",
                "value": (gen.rng.randrange(5), gen.rng.randrange(5))}

    stagger = opts.get("acid-stagger", 1)

    def fgen(k):
        return gen.process_limit(
            20, gen.stagger(stagger,
                            gen.reserve(n, gen.mix([w, cas, cas]), r)))

    return {"client": client,
            "generator": independent.concurrent_generator(
                2 * n, _naturals(), fgen),
            "checker": independent.checker(checker.compose({
                "timeline": timeline.html(),
                "linear": linear.linearizable(
                    models.cas_register(0),
                    device=opts.get("device"))}))}


MK_KEYS = (0, 1, 2)   # `multi_key_acid.clj:41-43`


def multi_key_acid_workload(opts, client) -> dict:
    """Transactional reads/writes over 3 subkeys per independent key,
    checked against the MultiRegister model
    (`multi_key_acid.clj:16-75`)."""
    n = len(opts.get("nodes", ["n1", "n2", "n3", "n4", "n5"]))

    def subset():
        ks = [k for k in MK_KEYS if gen.rng.random() < 0.5]
        return ks or [gen.rng.choice(MK_KEYS)]

    def r(test, ctx):
        return {"type": "invoke", "f": "read",
                "value": [["r", k, None] for k in subset()]}

    def w(test, ctx):
        return {"type": "invoke", "f": "write",
                "value": [["w", k, gen.rng.randrange(5)]
                          for k in subset()]}

    stagger = opts.get("acid-stagger", 1)

    def fgen(k):
        return gen.process_limit(
            20, gen.stagger(stagger, gen.reserve(n, gen.mix([w]), r)))

    return {"client": client,
            "generator": independent.concurrent_generator(
                2 * n, _naturals(), fgen),
            "checker": independent.checker(checker.compose({
                "timeline": timeline.html(),
                "linear": linear.linearizable(
                    models.multi_register())}))}


def append_workload(opts, client) -> dict:
    """Elle list-append (`append.clj:12-19`); YugaByte claims
    serializability, so the realtime precedence graph joins the cycle
    search (`append.clj:17` `:additional-graphs [cycle/realtime-graph]`)."""
    w = append_w.workload({"key-count": 32, "max-txn-length": 4,
                           "max-writes-per-key": 1024,
                           "additional-graphs": ("realtime",),
                           "device": opts.get("device")})
    return {"client": client, "generator": w["generator"],
            "checker": w["checker"]}


def default_value_workload(opts, client) -> dict:
    """Concurrent create/drop-table + insert/read
    (`default_value.clj:13-29`). Function generators: every op class
    recurs for the whole run (bare dicts are one-shot, which both
    capped runs at ~52 ops and let the single create-table land after
    every read with probability ~1/26 — a zero-ok class the stats
    checker flags)."""
    def _dv(f):
        return lambda test, ctx: {"type": "invoke", "f": f,
                                  "value": None}

    return {"client": client,
            "generator": gen.mix(
                [_dv("create-table"), _dv("drop-table")]
                + [_dv("read"), _dv("insert")] * 25),
            "checker": default_value_checker()}


WORKLOADS = {
    "ycql/bank": lambda o: bank_workload(o, CQLBank()),
    "ycql/counter": lambda o: counter_workload(o, CQLCounter()),
    "ycql/set": lambda o: set_workload(o, CQLSet()),
    "ycql/set-index": lambda o: set_workload(o, CQLSetIndex()),
    "ycql/long-fork": lambda o: long_fork_workload(o, CQLLongFork()),
    "ycql/single-key-acid":
        lambda o: single_key_acid_workload(o, CQLSingleKey()),
    "ycql/multi-key-acid":
        lambda o: multi_key_acid_workload(o, CQLMultiKey()),
    "ysql/bank": lambda o: bank_workload(o, YSQLBank()),
    "ysql/bank-multitable": lambda o: bank_workload(o, YSQLMultiBank()),
    "ysql/counter": lambda o: counter_workload(o, YSQLCounter()),
    "ysql/set": lambda o: set_workload(o, YSQLSet()),
    "ysql/long-fork": lambda o: long_fork_workload(o, YSQLLongFork()),
    "ysql/single-key-acid":
        lambda o: single_key_acid_workload(o, YSQLSingleKey()),
    "ysql/multi-key-acid":
        lambda o: multi_key_acid_workload(o, YSQLMultiKey()),
    "ysql/append": lambda o: append_workload(o, YSQLAppend()),
    "ysql/default-value":
        lambda o: default_value_workload(o, YSQLDefaultValue()),
}


# ---------------------------------------------------------------------------
# Nemesis (`nemesis.clj:12-120`)
# ---------------------------------------------------------------------------

class ProcessNemesis(Nemesis):
    """Kill/stop/pause master and tserver processes on random subsets;
    start/resume heal everywhere (`nemesis.clj:12-45`)."""

    FS = {"start-master", "start-tserver", "stop-master", "stop-tserver",
          "kill-master", "kill-tserver", "pause-master", "pause-tserver",
          "resume-master", "resume-tserver"}

    def fs(self):
        return set(self.FS)

    def invoke(self, test, op):
        f = op["f"]
        db_ = test["db"]
        if f in ("start-tserver", "resume-tserver"):
            nodes = list(test["nodes"])
        elif f in ("start-master", "resume-master"):
            nodes = master_nodes(test)
        elif f.endswith("master"):
            nodes = combined.random_nonempty_subset(master_nodes(test))
        else:
            nodes = combined.random_nonempty_subset(test["nodes"])

        def act(t, node):
            if f == "start-master":
                return db_.start_master(t, node) or "started"
            if f == "start-tserver":
                return db_.start_tserver(t, node) or "started"
            if f == "stop-master":
                return db_.stop_master(t, node) or "stopped"
            if f == "stop-tserver":
                return db_.stop_tserver(t, node) or "stopped"
            if f == "kill-master":
                return db_.kill_master(t, node) or "killed"
            if f == "kill-tserver":
                return db_.kill_tserver(t, node) or "killed"
            with control.su():
                proc = "yb-master" if f.endswith("master") else \
                    "yb-tserver"
                cu.signal(proc, "STOP" if f.startswith("pause") else
                          "CONT")
            return "paused" if f.startswith("pause") else "resumed"

        return {**op, "value": control.on_nodes(test, act, nodes)}


def _op(f, value=None):
    return {"type": "info", "f": f, "value": value}


def _role_gen(role: str, kind: str):
    """kill/pause cycles for one process role."""
    if kind == "kill":
        return itertools.cycle([_op(f"kill-{role}"),
                                _op(f"start-{role}")])
    return itertools.cycle([_op(f"pause-{role}"),
                            _op(f"resume-{role}")])


def nemesis_package(opts: dict) -> dict:
    """Compose the process nemesis with partitioner + clock
    (`nemesis.clj:69-84`, generators at `nemesis.clj:86-160`)."""
    faults = set(opts.get("faults") or ())
    nemeses = []
    gens = []
    finals = []
    perf = []
    if faults & {"kill-master", "kill-tserver", "pause-master",
                 "pause-tserver"}:
        nemeses.append((frozenset(ProcessNemesis.FS), ProcessNemesis()))
        for f in sorted(faults):
            if f.startswith(("kill-", "pause-")):
                kind, role = f.split("-", 1)
                gens.append(_role_gen(role, kind))
        finals += [_op("resume-tserver"), _op("resume-master"),
                   _op("start-tserver"), _op("start-master")]
        perf += [{"name": "kill master", "start": {"kill-master",
                                                   "stop-master"},
                  "stop": {"start-master"}, "fill-color": "#E9A4A0"},
                 {"name": "kill tserver", "start": {"kill-tserver",
                                                    "stop-tserver"},
                  "stop": {"start-tserver"}, "fill-color": "#E9C3A0"},
                 {"name": "pause master", "start": {"pause-master"},
                  "stop": {"resume-master"}, "fill-color": "#A0B1E9"},
                 {"name": "pause tserver", "start": {"pause-tserver"},
                  "stop": {"resume-tserver"}, "fill-color": "#B8A0E9"}]
    if "partition" in faults:
        nemeses.append((frozenset({"start-partition", "stop-partition"}),
                        npartition.partitioner()))

        def start_partition(test, ctx):
            style = gen.rng.choice(["one", "half", "ring"])
            nodes = list(test["nodes"])
            gen.rng.shuffle(nodes)
            if style == "one":
                grudge = npartition.complete_grudge(
                    npartition.split_one(nodes))
            elif style == "half":
                grudge = npartition.complete_grudge(
                    npartition.bisect(nodes))
            else:
                grudge = npartition.majorities_ring(nodes)
            return {"type": "info", "f": "start-partition",
                    "value": grudge, "partition-type": style}

        gens.append(itertools.cycle(
            [start_partition, _op("stop-partition")]))
        finals.append(_op("stop-partition"))
        perf.append({"name": "partition", "start": {"start-partition"},
                     "stop": {"stop-partition"},
                     "fill-color": "#888888"})
    if "clock" in faults:
        nemeses.append((frozenset({"reset", "bump", "strobe",
                                   "check-offsets"}),
                        ntime.clock_nemesis()))
        gens.append(ntime.clock_gen())
        finals.append(_op("reset"))
        perf.append({"name": "clock skew",
                     "start": {"bump", "strobe"}, "stop": {"reset"},
                     "fill-color": "#D2E9A0"})
    if not nemeses:
        from .. import nemesis as jnemesis
        return {"nemesis": jnemesis.noop, "generator": None,
                "final-generator": None, "perf": []}

    interval = opts.get("nemesis-interval", 10)

    def spaced(g):
        return gen.stagger(interval, g)

    return {
        "nemesis": nemesis_compose(nemeses),
        "generator": gen.mix([spaced(g) for g in gens]),
        "final-generator": finals,
        "perf": perf,
    }


# ---------------------------------------------------------------------------
# Test construction + CLI (`core.clj:198-275`, `runner.clj`)
# ---------------------------------------------------------------------------

YB_FAULTS = ["partition", "kill-master", "kill-tserver", "pause-master",
             "pause-tserver", "clock", "none"]


def yugabyte_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "ycql/bank")
    api = workload_name.split("/", 1)[0]
    opts = {**opts, "api": api}
    workload = WORKLOADS[workload_name](opts)
    faults = [f for f in (opts.get("faults") or ["partition"])
              if f != "none"]
    pkg = nemesis_package({**opts, "faults": faults})
    return std_test(
        opts,
        name=f"yb-{workload_name.replace('/', '-')}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=workload,
        nemesis_package=pkg,
        extra={"api": api,
               "replication-factor": opts.get("replication-factor", 3)})


OPT_SPEC = [
    cli.opt("--workload", "-w", default="ycql/bank",
            choices=sorted(WORKLOADS), help="Which workload to run"),
    cli.opt("--rate", type=float, default=10,
            help="approximate op rate per second"),
    cli.opt("--faults", action="append", choices=YB_FAULTS,
            help="faults to inject (repeatable)"),
    cli.opt("--nemesis-interval", type=float, default=10,
            help="seconds between nemesis operations"),
    cli.opt("--version", default=DEFAULT_VERSION,
            help="yugabyte version to install"),
    cli.opt("--replication-factor", type=int, default=3,
            help="number of master nodes / replicas"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": yugabyte_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
