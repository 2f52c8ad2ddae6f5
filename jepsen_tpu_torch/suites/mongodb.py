"""MongoDB test suite — replica-set document CAS.

Mirrors the reference's mongodb suites
(Jepsen's `mongodb-rocks/src/jepsen/mongodb_rocks.clj`,
`mongodb-smartos/src/jepsen/mongodb_smartos/{core,document_cas}.clj`):
deb package install with a replSet config, replica set initiated from
the first node, and the *document CAS* workload — an independent-keyed
linearizable register over documents, reads with linearizable read
concern, writes/CAS with majority write concern via findAndModify —
plus a grow-only set workload over inserts.

The client speaks OP_MSG/BSON directly (`bson_proto.py`); hermetic
tests run against an in-process fake mongod (tests/fake_mongo.py)."""

from __future__ import annotations

import itertools
import logging

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from .. import independent
from ..control import util as cu
from ..workloads import linearizable_register
from . import std_opts, std_test
from .bson_proto import Conn, MongoError, WriteConcernError

log = logging.getLogger(__name__)

PORT = 27017
CONF = "/etc/mongod.conf"
LOGFILE = "/var/log/mongodb/mongod.log"
REPL_SET = "jepsen"

DEFAULT_VERSION = "4.2.8"

# error codes that mean the write definitely did not commit
DEFINITE_FAIL = {
    11000,  # duplicate key
    112,    # WriteConflict
    10107,  # NotWritablePrimary
    13435,  # NotPrimaryNoSecondaryOk
    211,    # KeyNotFound
}


def config_body(engine: str) -> str:
    return (
        "storage:\n"
        f"  engine: {engine}\n"
        "  dbPath: /var/lib/mongodb\n"
        "systemLog:\n"
        "  destination: file\n"
        f"  path: {LOGFILE}\n"
        "net:\n"
        "  bindIp: 0.0.0.0\n"
        f"  port: {PORT}\n"
        "replication:\n"
        f"  replSetName: {REPL_SET}\n")


class DB(jdb.DB, jdb.Process, jdb.Pause, jdb.LogFiles):
    """mongodb-org-server deb + replSet config; the first node runs
    replSetInitiate over the wire (`mongodb_rocks.clj:29-63`,
    `core.clj` join!)."""

    def __init__(self, version: str = DEFAULT_VERSION,
                 engine: str = "wiredTiger"):
        self.version = version
        self.engine = engine

    def setup(self, test, node):
        with control.su():
            log.info("%s installing mongodb %s (%s)", node,
                     self.version, self.engine)
            deb = test.get("deb") or (
                f"https://repo.mongodb.org/apt/debian/dists/buster/"
                f"mongodb-org/4.2/main/binary-amd64/"
                f"mongodb-org-server_{self.version}_amd64.deb")
            path = cu.cached_wget(deb)
            control.upload(path, "/tmp/mongodb-server.deb")
            control.exec_("dpkg", "-i", "--force-confnew",
                          "/tmp/mongodb-server.deb")
            control.exec_("sh", "-c",
                          f"cat > {CONF} <<'EOF'\n"
                          f"{config_body(self.engine)}EOF")
            control.exec_("mkdir", "-p", "/var/lib/mongodb")
            self.start(test, node)
            cu.await_tcp_port(PORT)
        if node == test["nodes"][0]:
            conn = _connect(test, node)
            try:
                conn.command("admin", {"replSetInitiate": {
                    "_id": REPL_SET,
                    "members": [{"_id": i, "host": f"{n}:{PORT}"}
                                for i, n in enumerate(test["nodes"])],
                }})
            except MongoError as e:
                if "already initialized" not in str(e):
                    raise
            finally:
                conn.close()

    def start(self, test, node):
        with control.su():
            control.exec_("service", "mongod", "start")

    def kill(self, test, node):
        with control.su():
            cu.grepkill("mongod")

    def pause(self, test, node):
        with control.su():
            cu.signal("mongod", "STOP")

    def resume(self, test, node):
        with control.su():
            cu.signal("mongod", "CONT")

    def teardown(self, test, node):
        with control.su():
            self.kill(test, node)
            control.exec_("rm", "-rf", "/var/lib/mongodb", LOGFILE)

    def log_files(self, test, node):
        return [LOGFILE]


def db(version: str = DEFAULT_VERSION,
       engine: str = "wiredTiger") -> DB:
    return DB(version, engine)


def _connect(test, node) -> Conn:
    fn = test.get("mongo-conn-fn")
    if fn is not None:
        return fn(node)
    return Conn(node, PORT)


class DocumentCASClient(jclient.Client):
    """Independent-keyed CAS over documents {_id: k, value: v} in
    jepsen.cas (`document_cas.clj`): reads with linearizable read
    concern, writes upsert with majority write concern, CAS via
    findAndModify on {_id, value}."""

    DB_NAME = "jepsen"
    COLL = "cas"

    def __init__(self):
        self.conn: Conn | None = None

    def open(self, test, node):
        c = DocumentCASClient()
        c.conn = _connect(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

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
        k = int(k)
        try:
            if op["f"] == "read":
                r = self.conn.command(self.DB_NAME, {
                    "find": self.COLL, "filter": {"_id": k},
                    "limit": 1,
                    "readConcern": {"level": "linearizable"},
                })
                docs = r.get("cursor", {}).get("firstBatch", [])
                val = docs[0].get("value") if docs else None
                return {**op, "type": "ok", "value": wrap(val)}
            if op["f"] == "write":
                self.conn.command(self.DB_NAME, {
                    "update": self.COLL,
                    "updates": [{"q": {"_id": k},
                                 "u": {"$set": {"value": inner}},
                                 "upsert": True}],
                    "writeConcern": {"w": "majority"},
                })
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = inner
                r = self.conn.command(self.DB_NAME, {
                    "findAndModify": self.COLL,
                    "query": {"_id": k, "value": old},
                    "update": {"$set": {"value": new}},
                    "writeConcern": {"w": "majority"},
                })
                ok = r.get("lastErrorObject",
                           {}).get("updatedExisting", False)
                return {**op, "type": "ok" if ok else "fail"}
            raise ValueError(f"unknown f {op['f']!r}")
        except WriteConcernError as e:
            # applied locally, durability unknown: always :info
            return {**op, "type": "info",
                    "error": ["mongo-write-concern", e.code, str(e)]}
        except MongoError as e:
            definite = op["f"] == "read" or e.code in DEFINITE_FAIL
            return {**op, "type": "fail" if definite else "info",
                    "error": ["mongo", e.code, str(e)]}
        except OSError as e:
            return {**op,
                    "type": "fail" if op["f"] == "read" else "info",
                    "error": str(e)}


class SetClient(jclient.Client):
    """Grow-only set: insert {value} docs, read = full collection scan
    (the sets workloads in the larger reference suites)."""

    DB_NAME = "jepsen"
    COLL = "set"

    def __init__(self):
        self.conn: Conn | None = None
        self.ids = itertools.count()

    def open(self, test, node):
        c = SetClient()
        c.conn = _connect(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                self.conn.command(self.DB_NAME, {
                    "insert": self.COLL,
                    "documents": [{"value": op["value"]}],
                    "writeConcern": {"w": "majority"},
                })
                return {**op, "type": "ok"}
            if op["f"] == "read":
                r = self.conn.command(self.DB_NAME, {
                    "find": self.COLL, "filter": {},
                    "readConcern": {"level": "majority"},
                    "batchSize": 10 ** 9,
                })
                vals = sorted(d["value"] for d in
                              r.get("cursor", {}).get("firstBatch", []))
                return {**op, "type": "ok", "value": vals}
            raise ValueError(f"unknown f {op['f']!r}")
        except WriteConcernError as e:
            # applied locally, durability unknown: always :info
            return {**op, "type": "info",
                    "error": ["mongo-write-concern", e.code, str(e)]}
        except MongoError as e:
            definite = op["f"] == "read" or e.code in DEFINITE_FAIL
            return {**op, "type": "fail" if definite else "info",
                    "error": ["mongo", e.code, str(e)]}
        except OSError as e:
            return {**op,
                    "type": "fail" if op["f"] == "read" else "info",
                    "error": str(e)}


def register_workload(opts: dict) -> dict:
    w = linearizable_register.test({
        "nodes": opts["nodes"],
        "per-key-limit": opts.get("ops-per-key", 100),
        "device": opts.get("device"),
    })
    w["client"] = DocumentCASClient()
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


WORKLOADS = {
    "register": register_workload,
    "set": set_workload,
}


def mongodb_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "register")
    return std_test(
        opts, name=f"mongodb-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION),
              opts.get("engine", "wiredTiger")),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "register", DEFAULT_VERSION,
                    "mongodb-org-server version") + [
    cli.opt("--engine", default="wiredTiger",
            choices=["wiredTiger", "rocksdb"],
            help="storage engine (rocksdb = the mongodb-rocks suite)"),
    cli.opt("--ops-per-key", type=int, default=100,
            help="ops per independent key (register workload)"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": mongodb_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
