"""RethinkDB test suite — document-level CAS with per-op write/read
concerns.

Mirrors Jepsen's `rethinkdb/src/jepsen/rethinkdb{,/
document_cas}.clj`: apt-repo install with optional faketime wrapper
around the binary, cluster join config, table creation with 5
replicas + write_acks/read_mode reconfiguration, and the document-cas
workload — reads via `get(field).default(nil)`, writes via insert
with conflict=update, cas via an update whose row-function branches on
equality and errors to abort (`document_cas.clj:80-106`). Error
classification mirrors `rethinkdb.clj:144-163` (op-indeterminacy by
idempotence; ReQL runtime 'abort' means the cas definitely failed)."""

from __future__ import annotations

import logging

from .. import cli, client as jclient, control, independent
from .. import db as jdb
from ..control import util as cu
from ..control.core import RemoteError
from ..os_ import debian
from . import std_opts, std_test
from . import reql_proto as r
from .reql_proto import Conn, ReQLError

log = logging.getLogger(__name__)

LOG_FILE = "/var/log/rethinkdb"
CONF = "/etc/rethinkdb/instances.d/jepsen.conf"
CLIENT_PORT = 28015
CLUSTER_PORT = 29015

DEFAULT_VERSION = "2.3.5~0jessie"

DB_NAME = "jepsen"
TABLE = "cas"


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    """apt install + join config (`rethinkdb.clj:52-96`)."""

    def __init__(self, version: str = DEFAULT_VERSION,
                 faketime: bool = False):
        self.version = version
        self.faketime = faketime

    def setup(self, test, node):
        with control.su():
            debian.add_repo(
                "rethinkdb",
                "deb http://download.rethinkdb.com/apt jessie main")
            control.exec_raw(
                "wget -qO - https://download.rethinkdb.com/apt/"
                "pubkey.gpg | apt-key add -")
        debian.install({"rethinkdb": self.version})
        with control.su():
            if self.faketime:
                # replace the binary with a random-rate faketime
                # wrapper (`rethinkdb.clj:33-50`)
                try:
                    control.exec_("test", "-e",
                                  "/usr/bin/rethinkdb.no-faketime")
                except RemoteError:
                    control.exec_("mv", "/usr/bin/rethinkdb",
                                  "/usr/bin/rethinkdb.no-faketime")
                    cu.write_file(
                        "#!/bin/bash\n"
                        'faketime -m -f "+$((RANDOM%100))s '
                        'x1.${RANDOM}" /usr/bin/rethinkdb.no-faketime'
                        ' "$@"\n', "/usr/bin/rethinkdb")
                    control.exec_("chmod", "a+x", "/usr/bin/rethinkdb")
            joins = "\n".join(f"join={n}:{CLUSTER_PORT}"
                              for n in test["nodes"])
            cu.write_file(
                f"{joins}\n\nserver-name={node}\nserver-tag={node}\n"
                f"bind=all\n", CONF)
            control.exec_("touch", LOG_FILE)
            control.exec_("chown", "rethinkdb:rethinkdb", LOG_FILE)
            self.start(test, node)
            cu.await_tcp_port(CLIENT_PORT)

    def start(self, test, node):
        with control.su():
            control.exec_("service", "rethinkdb", "start")

    def kill(self, test, node):
        with control.su():
            cu.grepkill("rethinkdb")

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            try:
                control.exec_("rm", "-rf",
                              "/var/lib/rethinkdb/instances.d")
            except RemoteError:
                pass

    def log_files(self, test, node):
        return [LOG_FILE]


def db(version: str = DEFAULT_VERSION, faketime: bool = False) -> DB:
    return DB(version, faketime)


def _connect(test, node) -> Conn:
    fn = test.get("reql-conn-fn")
    if fn is not None:
        return fn(node)
    return Conn(node, CLIENT_PORT)


class DocumentCASClient(jclient.Client):
    """Register per document id; per-op write_acks/read_mode
    (`document_cas.clj:53-106`)."""

    def __init__(self, write_acks: str = "majority",
                 read_mode: str = "majority"):
        self.write_acks = write_acks
        self.read_mode = read_mode
        self.conn: Conn | None = None

    def open(self, test, node):
        c = DocumentCASClient(self.write_acks, self.read_mode)
        c.conn = _connect(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def setup(self, test):
        try:
            self.conn.run(r.db_create(DB_NAME))
        except ReQLError:
            pass  # exists
        try:
            self.conn.run(r.table_create(
                DB_NAME, TABLE, replicas=len(test["nodes"])))
        except ReQLError:
            pass  # exists / another worker created it
        try:
            # write-acks + shard layout via the system table, as the
            # reference does (`document_cas.clj:30-40` set-write-acks!)
            self.conn.run(r.update(
                r.table("rethinkdb", "table_config"),
                {"write_acks": self.write_acks,
                 "shards": [{"primary_replica": test["nodes"][0],
                             "replicas": list(test["nodes"])}]}))
        except ReQLError:
            pass  # hermetic fakes have no system tables
        # every client waits for replica readiness, even the ones that
        # lost the creation race (`document_cas.clj:57-67`)
        self.conn.run(r.wait(r.table(DB_NAME, TABLE)))

    def _row(self, k):
        return r.get(r.table(DB_NAME, TABLE,
                             read_mode=self.read_mode), k)

    def invoke(self, test, op):
        k, v = op["value"]
        idempotent = op["f"] == "read"
        try:
            if op["f"] == "read":
                out = self.conn.run(
                    r.default(r.get_field(self._row(k), "val"), None))
                return {**op, "type": "ok",
                        "value": independent.ktuple(k, out)}
            if op["f"] == "write":
                res = self.conn.run(
                    r.insert(r.table(DB_NAME, TABLE),
                             {"id": k, "val": v}, conflict="update"))
                if res.get("errors"):
                    raise ReQLError(-1, res.get("first_error", ""))
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = v
                res = self.conn.run(
                    r.update(self._row(k), r.func(
                        r.branch(
                            r.eq(r.get_field(r.var(1), "val"), old),
                            {"val": new},
                            r.error("abort")))))
                ok = (res.get("errors", 1) == 0
                      and res.get("replaced", 0) == 1)
                return {**op, "type": "ok" if ok else "fail"}
            raise ValueError(f"unknown f {op['f']!r}")
        except ReQLError as e:
            if "abort" in str(e):
                return {**op, "type": "fail", "error": "cas-abort"}
            t = "fail" if idempotent else "info"
            return {**op, "type": t, "error": str(e)}
        except OSError as e:
            t = "fail" if idempotent else "info"
            return {**op, "type": t, "error": str(e)}


def document_cas_workload(opts: dict) -> dict:
    w = linearizable_register_test(opts)
    w["client"] = DocumentCASClient(
        opts.get("write-acks", "majority"),
        opts.get("read-mode", "majority"))
    return w


def linearizable_register_test(opts):
    from ..workloads import linearizable_register
    return dict(linearizable_register.test(opts))


WORKLOADS = {"document-cas": document_cas_workload}


def rethinkdb_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "document-cas")
    return std_test(
        opts, name=f"rethinkdb-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION),
              opts.get("faketime", False)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "document-cas", DEFAULT_VERSION,
                    "rethinkdb apt version") + [
    cli.opt("--write-acks", default="majority",
            choices=["single", "majority"], help="write concern"),
    cli.opt("--read-mode", default="majority",
            choices=["single", "majority", "outdated"],
            help="read concern"),
    cli.opt("--faketime", action="store_true",
            help="wrap the binary in a random-rate faketime"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": rethinkdb_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
