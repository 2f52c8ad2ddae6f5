"""MySQL Cluster (NDB) test suite.

Mirrors Jepsen's `mysql-cluster/src/jepsen/mysql_cluster.clj`:
the three-daemon topology — management (ndb_mgmd, node ids 1+),
storage (ndbd, ids 11+, first four nodes), and SQL (mysqld, ids 21+)
— with generated config.ini role sections and a templated my.cnf
carrying the ndb connect string. The reference ships no workload
(`simple-test` is a noop, `mysql_cluster.clj:228-234`); since mysqld
speaks the MySQL wire protocol, this suite adds a register workload
over the `mysql_proto` client so the deployment is actually
exercised."""

from __future__ import annotations

import logging

from .. import cli, client as jclient, control, core, models
from .. import db as jdb
from ..checker import linear
from ..control import util as cu
from ..control.core import RemoteError
from ..os_ import debian
from . import std_opts, std_test
from .mysql_proto import Conn, MySQLError

log = logging.getLogger(__name__)

USER = "mysql"
MGMD_DIR = "/var/lib/mysql/cluster"
NDBD_DIR = "/var/lib/mysql/data"
MYSQLD_DIR = "/var/lib/mysql/mysql"
MGMD_ID_OFFSET = 1
NDBD_ID_OFFSET = 11
MYSQLD_ID_OFFSET = 21
BIN_DIR = "/opt/mysql/server-5.6/bin"
SQL_PORT = 3306

DEFAULT_VERSION = "7.4.6"

MY_CNF = """\
[mysqld]
user=mysql
ndbcluster
ndb-connectstring={connect_string}
datadir={data_dir}
server-id={node_id}
[mysql_cluster]
ndb-connectstring={connect_string}
"""

CONFIG_INI_HEAD = """\
[ndbd default]
NoOfReplicas=2
DataMemory=80M
IndexMemory=18M
[tcp default]
"""


def mgmd_id(test, node) -> int:
    return MGMD_ID_OFFSET + test["nodes"].index(node)


def ndbd_id(test, node) -> int:
    return NDBD_ID_OFFSET + test["nodes"].index(node)


def mysqld_id(test, node) -> int:
    return MYSQLD_ID_OFFSET + test["nodes"].index(node)


def ndbd_nodes(test) -> list:
    """Storage role runs on the first four nodes
    (`mysql_cluster.clj:96-99`)."""
    return sorted(test["nodes"])[:4]


def nodes_conf(test) -> str:
    """Role sections for every node (`mysql_cluster.clj:101-112`)."""
    parts = []
    for n in test["nodes"]:
        parts.append(f"[ndb_mgmd]\nNodeId={mgmd_id(test, n)}\n"
                     f"hostname={n}\ndatadir={MGMD_DIR}\n")
    for n in ndbd_nodes(test):
        parts.append(f"[ndbd]\nNodeId={ndbd_id(test, n)}\n"
                     f"hostname={n}\ndatadir={NDBD_DIR}\n")
    for n in test["nodes"]:
        parts.append(f"[mysqld]\nNodeId={mysqld_id(test, n)}\n"
                     f"hostname={n}\n")
    return "\n".join(parts)


def connect_string(test) -> str:
    return ",".join(test["nodes"])


class DB(jdb.DB, jdb.LogFiles):
    """deb install + three-daemon lifecycle
    (`mysql_cluster.clj:22-226`)."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        debian.install({"libaio1": "0.3.110-1"})
        with control.su():
            url = test.get("deb-url") or (
                "https://dev.mysql.com/get/Downloads/MySQL-Cluster-7.4/"
                f"mysql-cluster-gpl-{self.version}-debian7-x86_64.deb")
            deb = cu.cached_wget(url)
            control.exec_("dpkg", "-i", "--force-confask",
                          "--force-confnew", deb)
            try:
                control.exec_("adduser", "--disabled-password",
                              "--gecos", "", USER)
            except RemoteError:
                pass  # user exists
            cu.write_file(MY_CNF.format(
                connect_string=connect_string(test),
                data_dir=MYSQLD_DIR,
                node_id=mysqld_id(test, node)), "/etc/my.cnf")
            control.exec_("mkdir", "-p", MGMD_DIR)
            cu.write_file(CONFIG_INI_HEAD + nodes_conf(test),
                          "/etc/my.config.ini")
            # daemons in lockstep phases: every mgmd must be up
            # before any ndbd registers, and every ndbd before mysqld
            # (`mysql_cluster.clj:190-202`)
            control.exec_(f"{BIN_DIR}/ndb_mgmd",
                          f"--ndb-nodeid={mgmd_id(test, node)}",
                          "-f", "/etc/my.config.ini")
        core.synchronize(test)
        with control.su():
            if node in ndbd_nodes(test):
                control.exec_("mkdir", "-p", NDBD_DIR)
                control.exec_(f"{BIN_DIR}/ndbd",
                              f"--ndb-nodeid={ndbd_id(test, node)}")
        core.synchronize(test)
        with control.su():
            control.exec_("mkdir", "-p", MYSQLD_DIR)
            control.exec_("chown", "-R", f"{USER}:{USER}", MYSQLD_DIR)
        with control.sudo(USER):
            control.exec_(f"{BIN_DIR}/mysqld_safe",
                          "--defaults-file=/etc/my.cnf")
        cu.await_tcp_port(SQL_PORT)

    def teardown(self, test, node):
        with control.su():
            for proc in ("mysqld", "ndbd", "ndb_mgmd"):
                cu.grepkill(proc)
            try:
                control.exec_raw(
                    f"rm -rf {MGMD_DIR}/* {NDBD_DIR}/* {MYSQLD_DIR}/*")
            except RemoteError:
                pass

    def log_files(self, test, node):
        return [f"{MGMD_DIR}/ndb_1_cluster.log",
                f"{MYSQLD_DIR}/mysqld.err"]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


class RegisterClient(jclient.Client):
    """Single-row NDB-table register over the MySQL wire protocol —
    the workload the reference's noop test never got."""

    def __init__(self):
        self.conn: Conn | None = None

    def open(self, test, node):
        c = RegisterClient()
        fn = test.get("sql-conn-fn")
        # connect without a schema: the database may not exist yet
        # (ER_BAD_DB_ERROR in the handshake would wedge every client)
        c.conn = fn(node) if fn else Conn(node, SQL_PORT, user="root")
        try:
            c.conn.query("create database if not exists jepsen")
            c.conn.query("use jepsen")
        except (MySQLError, OSError):
            pass
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def setup(self, test):
        try:
            self.conn.query("create database if not exists jepsen")
            self.conn.query("use jepsen")
            self.conn.query(
                "create table if not exists registers "
                "(id int primary key, val int) engine=ndbcluster")
            self.conn.query(
                "insert into registers (id, val) values (0, 0) "
                "on duplicate key update id = id")
        except (MySQLError, OSError):
            pass  # another worker seeds

    def invoke(self, test, op):
        try:
            if op["f"] == "read":
                rows, _ = self.conn.query(
                    "select val from registers where id = 0")
                v = int(rows[0][0]) if rows and rows[0][0] is not None \
                    else None
                return {**op, "type": "ok", "value": v}
            if op["f"] == "write":
                self.conn.query(
                    f"update registers set val = "
                    f"{int(op['value'])} where id = 0")
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except MySQLError as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": ["sql", e.code, str(e)]}
        except OSError as e:
            return {**op,
                    "type": "fail" if op["f"] == "read" else "info",
                    "error": str(e)}


def register_workload(opts: dict) -> dict:
    from .. import generator as gen

    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def w(test, ctx):
        return {"type": "invoke", "f": "write",
                "value": gen.rng.randrange(5)}

    return {
        "client": RegisterClient(),
        "generator": gen.mix([r, w]),
        "checker": linear.linearizable(models.register(0),
                                       device=opts.get("device")),
    }


WORKLOADS = {"register": register_workload}


def mysql_cluster_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "register")
    return std_test(
        opts, name=f"mysql-cluster-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "register", DEFAULT_VERSION,
                    "MySQL Cluster version")


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": mysql_cluster_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
