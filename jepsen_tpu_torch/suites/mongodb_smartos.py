"""MongoDB-on-SmartOS suite: the reference's only non-Linux-hosted
database test.

Mirrors Jepsen's `mongodb-smartos/src/jepsen/mongodb_smartos/`:

  * DB automation over the SmartOS OS layer: versioned pkgin installs
    of mongodb + mongo-tools, config to /opt/local/etc/mongod.conf,
    SMF service management (`svcadm clear/enable/disable mongodb`),
    replica-set initiation from the first node (`core.clj:40-290`).
  * document-cas: CAS against a single document with configurable
    write concern (`document_cas.clj`), checked linearizably on the
    device register kernel.
  * transfer: the classic two-phase "transactions by hand" bank —
    txn documents move initial -> pending -> applied -> done while
    account updates guard on pendingTxns membership
    (`transfer.clj:43-140`); checked by the bank checker.

Clients speak the wire protocol from `bson_proto.py`; hermetic tests
run against `tests/fake_mongo.py`."""

from __future__ import annotations

import itertools
import logging
import threading

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from ..control import util as cu
from ..control.core import RemoteError
from ..os_ import smartos
from ..workloads import bank as bank_w, linearizable_register
from . import std_opts, std_test
from .bson_proto import Conn, MongoError, WriteConcernError
from .mongodb import DEFINITE_FAIL, _connect

log = logging.getLogger(__name__)

PORT = 27017
CONF = "/opt/local/etc/mongod.conf"
DATA_DIR = "/var/lib/mongodb"
LOG_DIR = "/var/log/mongodb"
REPL_SET = "jepsen"

DEFAULT_VERSION = "3.4.4"
DEFAULT_TOOLS_VERSION = "3.4.4"

MONGOD_CONF = """\
systemLog:
  destination: file
  path: {log_dir}/mongod.log
  logAppend: true
storage:
  dbPath: {data_dir}
replication:
  replSetName: {repl_set}
net:
  bindIp: 0.0.0.0
  port: {port}
"""


def _meh(*cmd):
    try:
        control.exec_(*cmd)
    except RemoteError:
        pass


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    """mongod via pkgin + SMF (`core.clj:40-86`)."""

    def __init__(self, version: str = DEFAULT_VERSION,
                 tools_version: str = DEFAULT_TOOLS_VERSION):
        self.version = version
        self.tools_version = tools_version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing mongodb %s via pkgin", node,
                     self.version)
            smartos.install({"mongodb": self.version,
                             "mongo-tools": self.tools_version})
            control.exec_("mkdir", "-p", DATA_DIR, LOG_DIR)
            control.exec_("chown", "-R", "mongodb:mongodb", DATA_DIR)
            cu.write_file(MONGOD_CONF.format(
                log_dir=LOG_DIR, data_dir=DATA_DIR,
                repl_set=REPL_SET, port=PORT), CONF)
            self.start(test, node)
            cu.await_tcp_port(PORT)
        if node == test["nodes"][0]:
            conn_fn = test.get("mongo-conn-fn")
            conn = conn_fn(node) if conn_fn else Conn(node, PORT)
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
            _meh("svcadm", "clear", "mongodb")
            control.exec_("svcadm", "enable", "-r", "mongodb")

    def kill(self, test, node):
        with control.su():
            _meh("svcadm", "disable", "mongodb")
            _meh("pkill", "-9", "mongod")

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            _meh("rm", "-rf", f"{LOG_DIR}/mongod.log")
            _meh("rm", "-rf", DATA_DIR)

    def log_files(self, test, node):
        return [f"{LOG_DIR}/mongod.log"]


def db(version: str = DEFAULT_VERSION,
       tools_version: str = DEFAULT_TOOLS_VERSION) -> DB:
    return DB(version, tools_version)


class TransferClient(jclient.Client):
    """Bank transfers via the by-hand two-phase protocol
    (`transfer.clj:43-180`): a txn document advances initial ->
    pending -> applied -> done; the two account updates are guarded by
    pendingTxns membership so a re-applied phase is a no-op."""

    DB_NAME = "jepsen"
    ACCTS = "accts"
    TXNS = "txns"
    _ids = itertools.count()
    _id_lock = threading.Lock()

    def __init__(self, write_concern: str = "majority"):
        self.write_concern = write_concern
        self.conn: Conn | None = None

    def open(self, test, node):
        c = TransferClient(self.write_concern)
        c.conn = _connect(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def setup(self, test):
        accounts = test.get("accounts", list(range(8)))
        total = test.get("total-amount", 100)
        try:
            for a in accounts:
                self.conn.command(self.DB_NAME, {
                    "update": self.ACCTS,
                    "updates": [{
                        "q": {"_id": a},
                        "u": {"$set": {
                            "balance": total if a == accounts[0] else 0,
                            "pendingTxns": []}},
                        "upsert": True}],
                })
        except (MongoError, OSError):
            # setup runs on every node's client: secondaries reject
            # the writes (NotWritablePrimary) — the primary's client
            # seeds the idempotent upserts
            pass

    def _update(self, coll, q, u):
        return self.conn.command(self.DB_NAME, {
            "update": coll, "updates": [{"q": q, "u": u}],
            "writeConcern": {"w": self.write_concern}})

    def _transfer(self, frm, to, amount):
        with TransferClient._id_lock:
            txn_id = next(TransferClient._ids)
        # p0: create in state initial; p2: begin (initial -> pending)
        self.conn.command(self.DB_NAME, {
            "insert": self.TXNS,
            "documents": [{"_id": txn_id, "state": "initial",
                           "from": frm, "to": to, "amount": amount}],
            "writeConcern": {"w": self.write_concern}})
        self._update(self.TXNS, {"_id": txn_id, "state": "initial"},
                     {"$set": {"state": "pending"}})
        # p3: apply to both accounts, guarded on pendingTxns
        self._update(self.ACCTS,
                     {"_id": frm, "pendingTxns": {"$ne": txn_id}},
                     {"$inc": {"balance": -amount},
                      "$push": {"pendingTxns": txn_id}})
        self._update(self.ACCTS,
                     {"_id": to, "pendingTxns": {"$ne": txn_id}},
                     {"$inc": {"balance": amount},
                      "$push": {"pendingTxns": txn_id}})
        # p4: applied; p5: clear pending; p6: done
        self._update(self.TXNS, {"_id": txn_id, "state": "pending"},
                     {"$set": {"state": "applied"}})
        self._update(self.ACCTS, {"_id": frm, "pendingTxns": txn_id},
                     {"$pull": {"pendingTxns": txn_id}})
        self._update(self.ACCTS, {"_id": to, "pendingTxns": txn_id},
                     {"$pull": {"pendingTxns": txn_id}})
        self._update(self.TXNS, {"_id": txn_id, "state": "applied"},
                     {"$set": {"state": "done"}})

    def invoke(self, test, op):
        try:
            if op["f"] == "read":
                r = self.conn.command(self.DB_NAME, {
                    "find": self.ACCTS, "filter": {}})
                docs = r.get("cursor", {}).get("firstBatch", [])
                return {**op, "type": "ok",
                        "value": {d["_id"]: d.get("balance", 0)
                                  for d in docs}}
            if op["f"] == "partial-read":
                # accounts with no transaction in flight: these
                # balances ARE consistent (`transfer.clj:159-165`)
                r = self.conn.command(self.DB_NAME, {
                    "find": self.ACCTS,
                    "filter": {"pendingTxns": {"$size": 0}}})
                docs = r.get("cursor", {}).get("firstBatch", [])
                return {**op, "type": "ok",
                        "value": {d["_id"]: d.get("balance", 0)
                                  for d in docs}}
            if op["f"] == "transfer":
                v = op["value"]
                self._transfer(v["from"], v["to"], v["amount"])
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except WriteConcernError as e:
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


class PartialReadChecker(checker.Checker):
    """Settled accounts (pendingTxns empty) carry consistent balances:
    keys must be known accounts and each balance must stay within
    [-total, 2*total] — the bound any interleaving of conserved
    transfers can reach (`transfer.clj:199-206` checks these reads
    against the account model)."""

    def check(self, test, hist, opts):
        accounts = set(test.get("accounts", list(range(8))))
        total = test.get("total-amount", 100)
        errors = []
        for o in hist:
            if o.get("type") != "ok" or o.get("f") != "partial-read":
                continue
            for acct, balance in (o.get("value") or {}).items():
                if acct not in accounts:
                    errors.append({"type": "unexpected-account",
                                   "op": dict(o), "account": acct})
                elif not isinstance(balance, int) \
                        or not -total <= balance <= 2 * total:
                    errors.append({"type": "impossible-balance",
                                   "op": dict(o), "account": acct,
                                   "balance": balance})
        return {"valid?": not errors, "errors": errors[:16]}


def document_cas_workload(opts: dict) -> dict:
    """Single-document CAS per key (`document_cas.clj`), reusing the
    mongodb suite's wire client over the SmartOS deployment."""
    from .mongodb import DocumentCASClient
    w = linearizable_register.test(opts)
    return {"client": DocumentCASClient(), **w}


def transfer_workload(opts: dict) -> dict:
    # transfers may interleave non-atomically (the two-phase protocol
    # is applied without transactions), so negative balances are legal
    # mid-flight, as in the reference's transfer test; partial-reads
    # (pendingTxns empty) mix in as the consistent-read probe
    def partial_read(test, ctx):
        return {"type": "invoke", "f": "partial-read", "value": None}

    return {
        "client": TransferClient(opts.get("write-concern", "majority")),
        "generator": gen.mix([bank_w.generator(), partial_read]),
        "checker": checker.compose({
            "bank": bank_w.checker({"negative-balances?": True}),
            "partial-reads": PartialReadChecker(),
        }),
    }


WORKLOADS = {
    "document-cas": document_cas_workload,
    "transfer": transfer_workload,
}


def mongodb_smartos_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "document-cas")
    return std_test(
        opts, name=f"mongodb-smartos-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION),
              opts.get("tools-version", DEFAULT_TOOLS_VERSION)),
        os=smartos.os,
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "document-cas", DEFAULT_VERSION,
                    "mongodb pkgin version") + [
    cli.opt("--tools-version", default=DEFAULT_TOOLS_VERSION,
            help="mongo-tools pkgin version"),
    cli.opt("--write-concern", default="majority",
            help="write concern for transfers"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": mongodb_smartos_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
