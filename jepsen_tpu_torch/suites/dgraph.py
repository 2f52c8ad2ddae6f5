"""Dgraph suite (`dgraph/src/jepsen/dgraph/`, 2,599 LoC) — a
distributed graph database offering snapshot isolation (and, with
server-side ordering, linearizability).

The reference drives dgraph through the JVM gRPC driver
(`client.clj:52-81`); this client speaks dgraph's HTTP API on the
alpha instead (the same transactional surface: /alter, /query,
/mutate, /commit with start-ts snapshot reads and commit-time
conflict detection), so no driver or grpc stack is needed.

**Tracing is first-class here**, as in the reference: every client
call runs inside a `trace` span (`client.clj` wraps each
call in `with-trace`; `trace.clj:40-49`), and the bank workload
annotates spans with checker violations found *during the run*
(`bank.clj:155-168`). Configure with the test's "tracing" option — a
file path or Jaeger HTTP endpoint; spans land in the store dir by
default when "tracing" is true.

Workloads: bank, upsert, delete, set, uid-set, sequential,
linearizable-register, uid-linearizable-register, long-fork, wr.
Nemeses: alpha/zero killers, alpha fixer, tablet mover, clock bump,
partitions (`nemesis.clj`).
"""

from __future__ import annotations

import http.client
import itertools
import json
import re
import socket
import threading
import time as _time

from .. import checker, cli, client as jclient, control, db as jdb
from .. import generator as gen, independent, trace
from ..checker import timeline
from ..nemesis import (Nemesis, compose as n_compose, f_map as n_fmap,
                       node_start_stopper)
from ..nemesis import combined as ncomb
from ..nemesis import partition as npart
from ..nemesis import time as ntime
from ..os_ import debian
from ..plot import merged_windows  # window algebra for spot plots
from ..workloads import linearizable_register as lr
from ..workloads import long_fork, wr as wrw

ALPHA_HTTP_PORT = 8080
ZERO_HTTP_PORT = 6080
DEADLINE_S = 30.0


# ---------------------------------------------------------------------------
# Wire client (`client.clj`)
# ---------------------------------------------------------------------------

class DgraphError(Exception):
    """An error from dgraph's HTTP API (message from the errors
    array)."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.message = message
        self.status = status


# with-conflict-as-fail's message->completion table
# (`client.clj:143-245`): first match wins; type 'fail' is definite,
# 'info' indeterminate.
ERROR_TABLE: tuple[tuple[str, str, str], ...] = (
    (r"DEADLINE_EXCEEDED", "info", "timeout-deadline-exceeded"),
    (r"context deadline exceeded", "info",
     "timeout-context-deadline-exceeded"),
    (r"Conflicts with pending transaction\. Please abort\.", "fail",
     "conflict"),
    (r"Transaction has been aborted\. Please retry", "fail", "conflict"),
    (r"readTs: \d+ less than minTs: \d+ for key", "fail",
     "old-timestamp"),
    (r"StartTs: (\d+) is from before MoveTs: (\d+) for pred", "fail",
     "start-ts-before-move-ts"),
    (r"Predicate is being moved, please retry later", "fail",
     "predicate-moving"),
    (r"Tablet isn't being served by this instance", "fail",
     "tablet-not-served-by-instance"),
    (r"Request sent to wrong server", "fail", "wrong-server"),
    (r"Please retry again, server is not ready to accept requests",
     "fail", "not-ready-for-requests"),
    (r"No connection exists", "fail", "no-connection"),
    (r"all SubConns are in TransientFailure", "info",
     "unavailable-all-subconns-transient-failure"),
    (r"transport is closing", "info", "unavailable-transport-closing"),
    (r"Network closed for unknown reason", "info",
     "unavailable-network-closed-unknown-reason"),
    (r"Unhealthy connection", "info", "unhealthy-connection"),
    (r"Only leader can decide to commit or abort", "fail",
     "only-leader-can-commit"),
    (r"This server doesn't serve group id:", "fail",
     "server-doesn't-serve-group"),
    (r"ABORTED", "fail", "transaction-aborted"),
    (r"Attribute .+ not indexed", "fail", "not-indexed"),
    (r"Schema not defined for predicate", "fail", "schema-not-defined"),
)

# errors worth a backoff before the next op. The reference's
# with-unavailable-backoff (`client.clj:128-137`) guards on :fail,
# which its own table makes unreachable for the unavailable-* and
# unhealthy-connection entries (they classify :info); we back off on
# the error name alone so a down node isn't hammered at full rate.
BACKOFF_ERRORS = frozenset({"predicate-moving", "unhealthy-connection"})


class DgraphConn:
    """One HTTP connection to an alpha (`client.clj:52-81` opens a
    gRPC channel; same lifecycle)."""

    def __init__(self, node: str, port: int = ALPHA_HTTP_PORT,
                 timeout_s: float = DEADLINE_S):
        self.node, self.port = node, port
        self.timeout_s = timeout_s
        self._http = http.client.HTTPConnection(node, port,
                                                timeout=timeout_s)

    def post(self, path: str, body, content_type: str) -> dict:
        data = body if isinstance(body, (bytes, str)) \
            else json.dumps(body)
        if isinstance(data, str):
            data = data.encode()
        try:
            self._http.request("POST", path, body=data,
                               headers={"Content-Type": content_type})
            resp = self._http.getresponse()
            raw = resp.read()
        except Exception:
            self._http.close()   # desynced HTTP pipeline
            raise
        try:
            doc = json.loads(raw)
        except ValueError:
            raise DgraphError(raw.decode(errors="replace"), resp.status)
        if doc.get("errors"):
            raise DgraphError(doc["errors"][0].get("message", ""),
                              resp.status)
        return doc

    def close(self):
        self._http.close()


def open_conn(test: dict, node: str) -> DgraphConn:
    with trace.span("client.open"):
        fn = test.get("dgraph-conn-fn")
        if fn is not None:
            return fn(node)
        return DgraphConn(node)


class Txn:
    """One SI transaction: start-ts assigned by the server on first
    use, reads snapshot at start-ts, writes buffered server-side,
    conflicts detected at /commit (`client.clj:106-126` with-txn)."""

    def __init__(self, conn: DgraphConn):
        self.conn = conn
        self.start_ts: int | None = None
        self.keys: list = []
        self.preds: list = []
        self.finished = False

    def _ts_arg(self) -> str:
        return f"?startTs={self.start_ts}" if self.start_ts else ""

    def _absorb(self, doc: dict) -> None:
        txn = (doc.get("extensions") or {}).get("txn") or {}
        if self.start_ts is None and txn.get("start_ts"):
            self.start_ts = txn["start_ts"]
        self.keys.extend(txn.get("keys") or [])
        self.preds.extend(txn.get("preds") or [])

    def query(self, q: str, vars: dict | None = None) -> dict:
        """graphql+- query; vars are $-prefixed like the reference's
        query-with-vars (`client.clj:350-387`)."""
        with trace.span("client.query"):
            body = {"query": q,
                    "vars": {f"${k}": str(v)
                             for k, v in (vars or {}).items()}}
            doc = self.conn.post(f"/query{self._ts_arg()}", body,
                                 "application/json")
            self._absorb(doc)
            return doc.get("data") or {}

    def mutate(self, set_obj) -> dict:
        """JSON set-mutation; returns map of blank names to UIDs
        (`client.clj:285-296`)."""
        with trace.span("client.mutate"):
            doc = self.conn.post(
                f"/mutate{self._ts_arg()}", {"set": [set_obj]},
                "application/json")
            self._absorb(doc)
            return (doc.get("data") or {}).get("uids") or {}

    def delete(self, target) -> None:
        """Delete by uid string (all edges) or JSON object
        (`client.clj:319-331`)."""
        with trace.span("client.delete"):
            if isinstance(target, str):
                target = {"uid": target}
            doc = self.conn.post(
                f"/mutate{self._ts_arg()}", {"delete": [target]},
                "application/json")
            self._absorb(doc)

    def commit(self) -> None:
        if self.finished or self.start_ts is None:
            self.finished = True
            return
        with trace.span("client.commit"):
            self.finished = True
            self.conn.post(f"/commit?startTs={self.start_ts}",
                           {"keys": self.keys, "preds": self.preds},
                           "application/json")

    def discard(self) -> None:
        if self.finished or self.start_ts is None:
            self.finished = True
            return
        with trace.span("client.abort-txn"):
            self.finished = True
            try:
                self.conn.post(
                    f"/commit?startTs={self.start_ts}&abort=true", {},
                    "application/json")
            except (DgraphError, OSError):
                pass


class txn:  # noqa: N801 — context manager mirroring with-txn
    """with txn(conn) as t: ... — commits on clean exit, discards on
    exception (`client.clj:106-126`)."""

    def __init__(self, conn: DgraphConn):
        self.t = Txn(conn)

    def __enter__(self) -> Txn:
        return self.t

    def __exit__(self, et, ev, tb):
        if et is None:
            self.t.commit()
        else:
            self.t.discard()
        return False


def alter_schema(conn: DgraphConn, *schemata: str, tries: int = 10,
                 sleep_s: float = 0.2) -> None:
    """Idempotent schema alteration with retries
    (`client.clj:264-283`)."""
    with trace.span("client.alter-schema"):
        while True:
            try:
                conn.post("/alter", {"schema": "\n".join(schemata)},
                          "application/json")
                return
            except (DgraphError, ConnectionError, OSError):
                tries -= 1
                if tries <= 0:
                    raise
                _time.sleep(sleep_s)


def with_conflict_as_fail(op: dict, thunk, test: dict | None = None):
    """Evaluate thunk, classifying dgraph/network failures
    (`client.clj:143-245`), with the unavailable backoff
    (`client.clj:128-137`)."""
    pause = (test or {}).get("dgraph-conn-retry-delay", 1.0)
    try:
        out = thunk()
    except ConnectionRefusedError as e:
        _time.sleep(pause)
        out = {**op, "type": "fail", "error": "connection-refused"}
    except (socket.timeout, TimeoutError) as e:
        out = {**op, "type": "info", "error": ["timeout", str(e)]}
    except (ConnectionError, OSError) as e:
        msg = str(e)
        if "Connection refused" in msg:
            _time.sleep(pause)
            out = {**op, "type": "fail", "error": "connection-refused"}
        elif "Connection reset" in msg:
            out = {**op, "type": "info", "error": "connection-reset"}
        else:
            out = {**op, "type": "info", "error": ["io", msg]}
    except DgraphError as e:
        for pat, typ, name in ERROR_TABLE:
            if re.search(pat, e.message):
                out = {**op, "type": typ, "error": name}
                break
        else:
            raise
    err = out.get("error")
    if isinstance(err, str) and (err in BACKOFF_ERRORS
                                 or err.startswith("unavailable")):
        _time.sleep(gen.rng.random() * 2 * pause)
    return out


def retry_conflicts(thunk, attempts: int = 10, sleep_s: float = 0.1):
    """Retry a transaction body on conflict aborts
    (`client.clj:247-258` retry-conflicts)."""
    while True:
        try:
            return thunk()
        except DgraphError as e:
            attempts -= 1
            if attempts <= 0 or not re.search(
                    r"abort|Abort|ABORTED|Conflicts", e.message):
                raise
            _time.sleep(gen.rng.random() * sleep_s)


def upsert(t: Txn, pred: str, record: dict):
    """Query-then-insert-or-update upsert on a predicate
    (`client.clj:424-455`). Returns the mutation's uid map, or None
    when a matching record already exists and was updated in place."""
    with trace.span("client.upsert"):
        value = record[pred]
        res = t.query(
            "{ all(func: eq(" + pred + ", $a)) { uid } }", {"a": value})
        matches = res.get("all") or []
        if len(matches) == 0:
            return t.mutate(record)
        if len(matches) == 1:
            t.mutate({**record, "uid": matches[0]["uid"]})
            return None
        raise DgraphError(
            f"unexpected multiple results for upsert of {pred}")


def gen_pred(prefix: str, n: int, k) -> str:
    """Stripe keys over n predicates (`client.clj:457-467`)."""
    return f"{prefix}_{hash(k) % n}"


def gen_preds(prefix: str, n: int) -> list[str]:
    return [f"{prefix}_{i}" for i in range(n)]


class _DgraphClient(jclient.Client):
    def __init__(self):
        self.conn: DgraphConn | None = None

    def open(self, test, node):
        c = type(self).__new__(type(self))
        c.__dict__.update(self.__dict__)
        c.conn = open_conn(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            with trace.span("client.close"):
                self.conn.close()


# ---------------------------------------------------------------------------
# Generic transactional client (`client.clj:469-571` TxnClient)
# ---------------------------------------------------------------------------

class TxnClient(_DgraphClient):
    """Executes [f k v] micro-op transactions over striped key/value
    predicates — the client behind the wr and long-fork workloads."""

    def __init__(self, key_preds: int = 5, val_preds: int = 5,
                 blind_insert: bool = False):
        super().__init__()
        self.key_preds = key_preds
        self.val_preds = val_preds
        self.blind_insert = blind_insert

    def setup(self, test):
        ks = [f"{p}: int @index(int)"
              + (" @upsert" if test.get("upsert-schema") else "") + " ."
              for p in gen_preds("key", self.key_preds)]
        vs = [f"{p}: int ." for p in gen_preds("val", self.val_preds)]
        alter_schema(self.conn, *(ks + vs))

    def _mop(self, t: Txn, mop):
        f, k, v = mop
        kp = gen_pred("key", self.key_preds, k)
        vp = gen_pred("val", self.val_preds, k)
        if f == "r":
            reads = t.query(
                "{ q(func: eq(" + kp + ", $key)) { " + vp + " } }",
                {"key": k}).get("q") or []
            if len(reads) > 1:
                raise DgraphError(
                    f"unexpected multiple results for key {k}")
            return [f, k, int(reads[0][vp]) if reads
                    and reads[0].get(vp) is not None else None]
        if self.blind_insert:
            t.mutate({kp: k, vp: v})
        else:
            upsert(t, kp, {kp: k, vp: v})
        return list(mop)

    def invoke(self, test, op):
        def body():
            with txn(self.conn) as t:
                out = [self._mop(t, m) for m in op["value"]]
            return {**op, "type": "ok", "value": out}
        return with_conflict_as_fail(op, body, test)


# ---------------------------------------------------------------------------
# bank (`bank.clj`)
# ---------------------------------------------------------------------------

BANK_PREDS = 7


class BankClient(_DgraphClient):
    """Accounts striped across key/amount/type predicate families;
    every client call traced, checker violations annotated onto the
    live span (`bank.clj:104-199`)."""

    def setup(self, test):
        with trace.span("bank.setup"):
            schemata = (
                [f"{p}: int @index(int)"
                 + (" @upsert" if test.get("upsert-schema") else "")
                 + " ." for p in gen_preds("key", BANK_PREDS)]
                + [f"{p}: string @index(exact) ."
                   for p in gen_preds("type", BANK_PREDS)]
                + [f"{p}: int ." for p in gen_preds("amount", BANK_PREDS)])
            alter_schema(self.conn, *schemata)
            k = test.get("accounts", list(range(8)))[0]
            kp = gen_pred("key", BANK_PREDS, k)

            def seed():
                with txn(self.conn) as t:
                    upsert(t, kp, {
                        kp: k,
                        gen_pred("type", BANK_PREDS, k): "account",
                        gen_pred("amount", BANK_PREDS, k):
                            test.get("total-amount", 100)})
            # all clients race to seed the first account
            # (`bank.clj:138-147` retry-conflicts)
            retry_conflicts(seed)

    def _read_accounts(self, t: Txn) -> dict:
        """All accounts across every type predicate
        (`bank.clj:36-58`)."""
        with trace.span("read-accounts"):
            fields = " ".join(gen_preds("key", BANK_PREDS)
                              + gen_preds("amount", BANK_PREDS))
            out = {}
            for tp in gen_preds("type", BANK_PREDS):
                rows = t.query(
                    "{ q(func: eq(" + tp + ", $type)) { " + fields
                    + " } }", {"type": "account"}).get("q") or []
                for r in rows:
                    key = amount = None
                    for pred, v in r.items():
                        if pred.startswith("key_"):
                            key = v
                        elif pred.startswith("amount_"):
                            amount = v
                    out[key] = amount
            return dict(sorted(out.items()))

    def _find_account(self, t: Txn, k) -> dict:
        with trace.span("find-account"):
            kp = gen_pred("key", BANK_PREDS, k)
            ap = gen_pred("amount", BANK_PREDS, k)
            rows = t.query(
                "{ q(func: eq(" + kp + ", $key)) { uid " + kp + " "
                + ap + " } }", {"key": k}).get("q") or []
            if rows:
                r = rows[0]
                return {"uid": r["uid"], "key": r.get(kp),
                        "amount": r.get(ap)}
            return {"key": k, "type": "account", "amount": 0}

    def _write_account(self, t: Txn, account: dict) -> None:
        with trace.span("write-account"):
            k = account["key"]
            kp = gen_pred("key", BANK_PREDS, k)
            ap = gen_pred("amount", BANK_PREDS, k)
            tp = gen_pred("type", BANK_PREDS, k)
            if account["amount"] == 0 and account.get("uid"):
                t.delete({"uid": account["uid"],
                          kp: None, ap: None, tp: None})
            else:
                rec = {tp: "account", kp: k, ap: account["amount"]}
                if account.get("uid"):
                    rec["uid"] = account["uid"]
                t.mutate(rec)

    def invoke(self, test, op):
        with trace.span("bank.invoke"):
            def body():
                with txn(self.conn) as t:
                    if op["f"] == "read":
                        with trace.span("bank.invoke.read"):
                            out = {**op, "type": "ok",
                                   "value": self._read_accounts(t)}
                            from ..workloads import bank as bankw
                            err = bankw.check_op(
                                set(test.get("accounts",
                                             list(range(8)))),
                                test.get("total-amount", 100), False,
                                out)
                            if err:
                                # annotate the live span so the trace
                                # carries the violation
                                # (`bank.clj:155-168`)
                                trace.attribute("checker_violation",
                                                "true")
                                msg = {k: v for k, v in err.items()
                                       if k != "op"}
                                msg.update(trace.context())
                                out["message"] = msg
                                out["error"] = "checker-violation"
                            return out
                    with trace.span("bank.invoke.transfer"):
                        v = op["value"]
                        frm = self._find_account(t, v["from"])
                        to = self._find_account(t, v["to"])
                        frm2 = {**frm, "amount": (frm["amount"] or 0)
                                - v["amount"]}
                        to2 = {**to, "amount": (to["amount"] or 0)
                               + v["amount"]}
                        if frm2["amount"] < 0:
                            t.discard()
                            return {**op, "type": "fail",
                                    "error": "insufficient-funds"}
                        self._write_account(t, frm2)
                        self._write_account(t, to2)
                        return {**op, "type": "ok"}
            return with_conflict_as_fail(op, body, test)


def bank_workload(opts: dict) -> dict:
    from ..workloads import bank as bankw
    w = bankw.test()
    return {**w, "client": BankClient()}


# ---------------------------------------------------------------------------
# upsert (`upsert.clj`)
# ---------------------------------------------------------------------------

class UpsertClient(_DgraphClient):
    """At most one upsert per key may succeed (`upsert.clj:13-52`)."""

    def setup(self, test):
        alter_schema(self.conn, "email: string @index(exact)"
                     + (" @upsert" if test.get("upsert-schema", True)
                        else "") + " .")

    def invoke(self, test, op):
        def body():
            k, _ = op["value"]
            with txn(self.conn) as t:
                if op["f"] == "upsert":
                    inserted = upsert(t, "email", {"email": str(k)})
                    if inserted:
                        return {**op, "type": "ok",
                                "value": independent.ktuple(
                                    k, next(iter(inserted.values())))}
                    return {**op, "type": "fail", "error": "present"}
                uids = sorted(
                    r["uid"] for r in (t.query(
                        "{ q(func: eq(email, $email)) { uid } }",
                        {"email": str(k)}).get("q") or []))
                return {**op, "type": "ok",
                        "value": independent.ktuple(k, uids)}
        return with_conflict_as_fail(op, body, test)


class UpsertChecker(checker.Checker):
    """At most one UID ever visible per key (`upsert.clj:54-70`)."""

    def check(self, test, hist, opts):
        reads = [o for o in hist
                 if o.get("type") == "ok" and o.get("f") == "read"]
        upserts = [o for o in hist
                   if o.get("type") == "ok" and o.get("f") == "upsert"]
        bad_reads = [o for o in reads if len(o.get("value") or []) > 1]
        return {"valid?": not bad_reads and len(upserts) <= 1,
                "bad-reads": bad_reads,
                "ok-upserts": len(upserts)}


def upsert_workload(opts: dict) -> dict:
    n = min(int(opts.get("concurrency", 10)),
            2 * (len(opts.get("nodes", [])) or 5))

    def fgen(k):
        return gen.phases(
            gen.each_thread(gen.once({"type": "invoke", "f": "upsert",
                                      "value": None})),
            gen.each_thread(gen.once({"type": "invoke", "f": "read",
                                      "value": None})))

    return {"client": UpsertClient(),
            "checker": independent.checker(UpsertChecker()),
            "generator": independent.concurrent_generator(
                n, itertools.count(), fgen)}


# ---------------------------------------------------------------------------
# delete (`delete.clj`)
# ---------------------------------------------------------------------------

class DeleteClient(_DgraphClient):
    """Create/delete an indexed record; reads must see the index in
    sync (`delete.clj:22-62`)."""

    def setup(self, test):
        alter_schema(self.conn, "key: int @index(int)"
                     + (" @upsert" if test.get("upsert-schema") else "")
                     + " .")

    def invoke(self, test, op):
        def body():
            k, _ = op["value"]
            with txn(self.conn) as t:
                if op["f"] == "read":
                    rows = t.query(
                        "{ q(func: eq(key, $key)) { uid key } }",
                        {"key": k}).get("q") or []
                    return {**op, "type": "ok",
                            "value": independent.ktuple(k, rows)}
                if op["f"] == "upsert":
                    if upsert(t, "key", {"key": k}):
                        return {**op, "type": "ok"}
                    return {**op, "type": "fail", "error": "present"}
                rows = t.query("{ q(func: eq(key, $key)) { uid } }",
                               {"key": k}).get("q") or []
                if not rows:
                    return {**op, "type": "fail", "error": "not-found"}
                t.delete(rows[0]["uid"])
                return {**op, "type": "ok", "uid": rows[0]["uid"]}
        return with_conflict_as_fail(op, body, test)


class DeleteChecker(checker.Checker):
    """Every read finds nothing, or exactly one {uid key} record for
    this key (`delete.clj:64-88`)."""

    def check(self, test, hist, opts):
        k = opts.get("history-key")
        bad = []
        for o in hist:
            if o.get("type") != "ok" or o.get("f") != "read":
                continue
            v = o.get("value") or []
            ok = (len(v) == 0
                  or (len(v) == 1 and set(v[0]) == {"uid", "key"}
                      and (k is None or v[0]["key"] == k)))
            if not ok:
                bad.append(o)
        return {"valid?": not bad, "bad-reads": bad}


def delete_workload(opts: dict) -> dict:
    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def u(test, ctx):
        return {"type": "invoke", "f": "upsert", "value": None}

    def d(test, ctx):
        return {"type": "invoke", "f": "delete", "value": None}

    n = 2 * (len(opts.get("nodes", [])) or 5)

    def fgen(k):
        return gen.stagger(opts.get("delete-stagger", 1 / 10),
                           gen.limit(opts.get("ops-per-key", 1000),
                                     gen.mix([r, u, d])))

    return {"client": DeleteClient(),
            "checker": independent.checker(checker.compose({
                "deletes": DeleteChecker(),
                "timeline": timeline.html()})),
            "generator": independent.concurrent_generator(
                n, itertools.count(), fgen)}


# ---------------------------------------------------------------------------
# set (`set.clj`)
# ---------------------------------------------------------------------------

class SetClient(_DgraphClient):
    """Index-read set (`set.clj:14-46`)."""

    def setup(self, test):
        alter_schema(self.conn,
                     "jepsen-type: string @index(exact)"
                     + (" @upsert" if test.get("upsert-schema") else "")
                     + " .", "value: int .")

    def invoke(self, test, op):
        def body():
            with txn(self.conn) as t:
                if op["f"] == "add":
                    uids = t.mutate({"jepsen-type": "element",
                                     "value": op["value"]})
                    return {**op, "type": "ok",
                            "uid": next(iter(uids.values()), None)}
                rows = t.query(
                    '{ q(func: eq(jepsen-type, $type)) { uid value } }',
                    {"type": "element"}).get("q") or []
                return {**op, "type": "ok",
                        "value": sorted(r["value"] for r in rows)}
        return with_conflict_as_fail(op, body, test)


class UidSetClient(_DgraphClient):
    """Set variant storing every value on one UID, no indices
    (`set.clj:61-105`); adds annotate their value onto the span."""

    def __init__(self):
        super().__init__()
        self.uid_box: dict = {}
        self.lock = threading.Lock()

    def setup(self, test):
        alter_schema(self.conn, "value: [int] .")
        with txn(self.conn) as t:
            uids = t.mutate({"value": -1})
        with self.lock:
            self.uid_box.setdefault("uid",
                                    next(iter(uids.values())))

    def invoke(self, test, op):
        def body():
            uid = self.uid_box.get("uid")
            if op["f"] == "add":
                with trace.span("set-add"):
                    trace.attribute("value", str(op["value"]))
                    with txn(self.conn) as t:
                        t.mutate({"uid": uid, "value": op["value"]})
                    return {**op, "type": "ok", "uid": uid}
            with txn(self.conn) as t:
                rows = t.query("{ q(func: uid($u)) { uid value } }",
                               {"u": uid}).get("q") or []
            vals = sorted({v for r in rows
                           for v in (r.get("value") or []
                                     if isinstance(r.get("value"), list)
                                     else [r.get("value")])
                           if v is not None and v != -1})
            return {**op, "type": "ok", "value": vals}
        return with_conflict_as_fail(op, body, test)


def set_workload(opts: dict) -> dict:
    adds = gen.IterGen({"type": "invoke", "f": "add", "value": i}
                       for i in itertools.count())
    return {
        "client": SetClient(),
        "checker": checker.set_checker(),
        "generator": gen.stagger(opts.get("set-stagger", 1 / 10), adds),
        "final-generator": gen.each_thread(gen.once(
            {"type": "invoke", "f": "read", "value": None})),
    }


def uid_set_workload(opts: dict) -> dict:
    return {**set_workload(opts), "client": UidSetClient()}


# ---------------------------------------------------------------------------
# sequential (`sequential.clj`)
# ---------------------------------------------------------------------------

class SequentialClient(_DgraphClient):
    """Read-only and read-inc-write txns on keyed registers
    (`sequential.clj:66-103`)."""

    def setup(self, test):
        alter_schema(self.conn, "key: int @index(int)"
                     + (" @upsert" if test.get("upsert-schema") else "")
                     + " .", "value: int @index(int) .")

    def invoke(self, test, op):
        def body():
            k, _ = op["value"]
            with txn(self.conn) as t:
                rows = t.query(
                    "{ q(func: eq(key, $key)) { uid value } }",
                    {"key": k}).get("q") or []
                row = rows[0] if rows else None
                if op["f"] == "inc":
                    value = (row.get("value") if row else 0) or 0
                    value += 1
                    if row:
                        t.mutate({"uid": row["uid"], "value": value})
                    else:
                        t.mutate({"key": k, "value": value})
                    return {**op, "type": "ok",
                            "value": independent.ktuple(k, value)}
                return {**op, "type": "ok",
                        "value": independent.ktuple(
                            k, (row.get("value") if row else 0) or 0)}
        return with_conflict_as_fail(op, body, test)


class SequentialChecker(checker.Checker):
    """Per-process monotonicity of the register value
    (`sequential.clj:105-136`)."""

    def check(self, test, hist, opts):
        last: dict = {}
        errs = []
        for o in hist:
            if o.get("type") != "ok":
                continue
            p = o.get("process")
            v = o.get("value") or 0
            pv = (last.get(p) or {}).get("value") or 0
            if v < pv:
                errs.append([last[p], o])
            last[p] = o
        return {"valid?": not errs, "non-monotonic": errs}




class SequentialPlotter(checker.Checker):
    """SVG per-process value plots around non-monotonic spots
    (`sequential.clj:160-215`; gnuplot in the reference, our plot
    library renders SVG into the store dir)."""

    def check(self, test, hist, opts):
        from ..checker.perf import out_path
        from ..plot import (Plot, process_series, regression_spots,
                            write as plot_write)

        ops = [o for o in hist
               if o.get("type") == "ok" and o.get("value") is not None]
        # spots mirror SequentialChecker: per-process regressions
        spots = regression_spots(
            [(o.get("process"), o.get("value") or 0) for o in ops])
        if spots and test.get("store-dir"):
            # per-key filenames: this runs under independent.checker,
            # where every key shares the test's store dir
            k = (opts or {}).get("history-key")
            tag = "" if k is None else f"key-{k}-"
            for wi, (lo, hi) in enumerate(merged_windows(32, spots)):
                window = ops[max(lo, 0):min(hi + 1, len(ops))]
                by_process: dict = {}
                for o in window:
                    by_process.setdefault(o.get("process"), []).append(
                        (o.get("time", 0) / 1e9, o.get("value") or 0))
                p = Plot(title=f"{test.get('name', '')} sequential "
                               f"by process",
                         ylabel="register value",
                         series=process_series(by_process))
                try:
                    plot_write(p, out_path(
                        test, opts, f"sequential-{tag}{wi}.svg"))
                except Exception:  # noqa: BLE001 — plots are best-effort
                    pass
        return {"valid?": True}


def sequential_workload(opts: dict) -> dict:
    def inc_gen(test, ctx):
        return {"type": "invoke", "f": "inc",
                "value": independent.ktuple(gen.rng.randrange(8), None)}

    def read_gen(test, ctx):
        return {"type": "invoke", "f": "read",
                "value": independent.ktuple(gen.rng.randrange(8), None)}

    return {"client": SequentialClient(),
            "checker": independent.checker(checker.compose({
                "sequential": SequentialChecker(),
                "plot": SequentialPlotter(),
                "timeline": timeline.html()})),
            "generator": gen.mix([inc_gen, read_gen])}


# ---------------------------------------------------------------------------
# linearizable register (`linearizable_register.clj`)
# ---------------------------------------------------------------------------

def _read_info_to_fail(out: dict) -> dict:
    """Read timeouts are safe failures — reads are idempotent
    (`linearizable_register.clj:26-33`)."""
    if out.get("f") == "read" and out.get("type") == "info":
        return {**out, "type": "fail"}
    return out


class LinearizableRegisterClient(_DgraphClient):
    """Single-predicate linearizable read/write/cas
    (`linearizable_register.clj:35-72`)."""

    def setup(self, test):
        alter_schema(self.conn, "key: int @index(int)"
                     + (" @upsert" if test.get("upsert-schema") else "")
                     + " .", "value: int .")

    def _read(self, t: Txn, k):
        rows = t.query("{ q(func: eq(key, $key)) { uid value } }",
                       {"key": k}).get("q") or []
        if len(rows) > 1:
            raise DgraphError(
                f"expected at most one record for key {k}")
        return rows[0] if rows else None

    def invoke(self, test, op):
        def body():
            k, v = op["value"]
            with txn(self.conn) as t:
                if op["f"] == "read":
                    row = self._read(t, k)
                    return {**op, "type": "ok",
                            "value": independent.ktuple(
                                k, row.get("value") if row else None)}
                if op["f"] == "write":
                    row = self._read(t, k)
                    if row:
                        t.mutate({"uid": row["uid"], "value": v})
                    else:
                        t.mutate({"key": k, "value": v})
                    return {**op, "type": "ok"}
                expected, new = v
                row = self._read(t, k)
                if row and row.get("value") == expected:
                    t.mutate({"uid": row["uid"], "value": new})
                    return {**op, "type": "ok"}
                t.discard()
                return {**op, "type": "fail", "error": "value-mismatch"}
        return _read_info_to_fail(with_conflict_as_fail(op, body, test))


class UidRegisterClient(LinearizableRegisterClient):
    """Variant addressing registers by UID to avoid @upsert-schema
    linearization points (`linearizable_register.clj:81-160`)."""

    def __init__(self):
        super().__init__()
        self.uids: dict = {}
        self.lock = threading.Lock()

    def setup(self, test):
        alter_schema(self.conn, "value: int .")

    def _uid_read(self, t: Txn, k):
        u = self.uids.get(k)
        if u is None:
            return None
        rows = t.query("{ q(func: uid($u)) { uid value } }",
                       {"u": u}).get("q") or []
        return rows[0] if rows else None

    def invoke(self, test, op):
        def body():
            k, v = op["value"]
            with txn(self.conn) as t:
                if op["f"] == "read":
                    row = self._uid_read(t, k)
                    return {**op, "type": "ok",
                            "value": independent.ktuple(
                                k, row.get("value") if row else None)}
                if op["f"] == "write":
                    u = self.uids.get(k)
                    if u is not None:
                        t.mutate({"uid": u, "value": v})
                        return {**op, "type": "ok"}
                    u = next(iter(t.mutate({"value": v}).values()))
                    with self.lock:
                        winner = self.uids.setdefault(k, u)
                    if winner == u:
                        return {**op, "type": "ok"}
                    return {**op, "type": "fail",
                            "error": "lost-uid-race"}
                expected, new = v
                row = self._uid_read(t, k)
                if row and row.get("value") == expected:
                    t.mutate({"uid": row["uid"], "value": new})
                    return {**op, "type": "ok"}
                t.discard()
                return {**op, "type": "fail", "error": "value-mismatch"}
        return _read_info_to_fail(with_conflict_as_fail(op, body, test))


def linearizable_register_workload(opts: dict) -> dict:
    w = lr.test(opts)
    return {**w, "client": LinearizableRegisterClient(),
            "generator": gen.stagger(1 / 100, w["generator"])}


def uid_linearizable_register_workload(opts: dict) -> dict:
    w = lr.test(opts)
    return {**w, "client": UidRegisterClient(),
            "generator": gen.stagger(1 / 100, w["generator"])}


# ---------------------------------------------------------------------------
# long-fork + wr (`long_fork.clj`, `wr.clj`)
# ---------------------------------------------------------------------------

def long_fork_workload(opts: dict) -> dict:
    w = long_fork.workload(n=2)
    return {**w, "client": TxnClient()}


def wr_workload(opts: dict) -> dict:
    """Elle rw-register over the generic txn client. Dgraph offers
    snapshot isolation, so G2-item (write skew) is permitted — the
    anomaly set is the reference's `[:G0 :G1c :G-single :G1a :G1b
    :internal]` (`wr.clj:22-26`), i.e. everything up to SI — with the
    realtime precedence graph unioned into the cycle search
    (`wr.clj:26` `:additional-graphs [cycle/realtime-graph]`)."""
    w = wrw.workload({"anomalies": ("G0", "G1", "G-single"),
                      "key-count": 4, "min-txn-length": 2,
                      "max-txn-length": 4, "max-writes-per-key": 16,
                      "additional-graphs": ("realtime",),
                      "device": opts.get("device")})
    return {**w, "client": TxnClient()}


# ---------------------------------------------------------------------------
# types (`types.clj`)
# ---------------------------------------------------------------------------

def _type_cases() -> list[tuple[str, int]]:
    """[attribute, value] probes around integer-width boundaries
    (`types.clj:133-158`): byte/short/int/long maxima, the largest
    exactly-float- and double-representable integers, and values well
    outside signed 64-bit range."""
    points = [0, 2**7 - 1, 2**15 - 1, 2**31 - 1, 2**63 - 1,
              16777217, 9007199254740993, 3 * (2**63 - 1)]
    vals: list[int] = []
    for x in points:
        vals.extend(range(x - 8, x + 8))
        vals.extend(range(-x - 8, -x + 8))
    return [(a, v) for a in ("foo", "int64") for v in vals]


class TypesClient(_DgraphClient):
    """Writes boundary integers as fresh entities, then reads them
    back by uid (`types.clj:24-57`)."""

    def __init__(self):
        super().__init__()
        self.entities: list = []
        self.lock = threading.Lock()

    def setup(self, test):
        alter_schema(self.conn, "key: int @index(int) .",
                     "int64: int .", "foo: int .")

    def invoke(self, test, op):
        def body():
            e, a, v = op["value"]
            with txn(self.conn) as t:
                if op["f"] == "write":
                    uids = t.mutate({a: v})
                    uid = next(iter(uids.values()))
                    with self.lock:
                        self.entities.append(uid)
                    return {**op, "type": "ok", "value": [uid, a, v]}
                rows = t.query("{ q(func: uid($entity)) { " + a + " } }",
                               {"entity": e}).get("q") or []
                got = rows[0].get(a) if rows else None
                return {**op, "type": "ok", "value": [e, a, got]}
        return with_conflict_as_fail(op, body, test)


class TypesChecker(checker.Checker):
    """Everything written must read back bit-identical
    (`types.clj:59-125`); written-but-never-read entities degrade the
    verdict to unknown."""

    def check(self, test, hist, opts):
        state: dict = {}
        for o in hist:
            if o.get("type") == "ok" and o.get("f") == "write":
                e, a, v = o["value"]
                state[(e, a)] = v
        read_keys = set()
        errs = []
        for o in hist:
            if o.get("type") != "ok" or o.get("f") != "read":
                continue
            e, a, v = o["value"]
            read_keys.add((e, a))
            if (e, a) in state and v != state[(e, a)]:
                errs.append({"entity": e, "attribute": a,
                             "wrote": state[(e, a)], "read": v})
        unread = sorted(k for k in state if k not in read_keys)
        # distinct errors, preserving order
        seen = set()
        distinct = []
        for err in errs:
            key = (err["entity"], err["attribute"], str(err["wrote"]),
                   str(err["read"]))
            if key not in seen:
                seen.add(key)
                distinct.append(err)
        return {"valid?": (False if errs else
                           "unknown" if unread else True),
                "error-count": len(distinct),
                "bad-read-count": len(errs),   # raw, pre-dedup (3x reads)
                "unread-count": len(unread),
                "errors": distinct,
                "unread": unread[:16]}


TYPES_STAGGER_DEFAULT = 1 / 10
TYPES_SETTLE_DEFAULT = 10.0


def types_workload(opts: dict) -> dict:
    client = TypesClient()
    cases = _type_cases()
    if opts.get("type-cases"):
        # sample evenly (ceil stride, no truncation) so shortened runs
        # still hit the 2^53+ tail for both attributes
        stride = -(-len(cases) // opts["type-cases"])
        cases = cases[::stride]
    writes = gen.IterGen(
        {"type": "invoke", "f": "write", "value": [None, a, v]}
        for a, v in cases)

    def reads(test, ctx):
        attrs = sorted({a for a, _ in cases})
        with client.lock:
            ents = list(client.entities)
        ops = [{"type": "invoke", "f": "read", "value": [e, a, None]}
               for _ in range(3) for e in ents for a in attrs]
        gen.rng.shuffle(ops)
        return gen.stagger(opts.get("types-stagger", TYPES_STAGGER_DEFAULT),
                           gen.IterGen(iter(ops)))

    return {"client": client,
            "checker": TypesChecker(),
            "generator": gen.phases(
                gen.stagger(opts.get("types-stagger", TYPES_STAGGER_DEFAULT), writes),
                gen.sleep(opts.get("types-settle", TYPES_SETTLE_DEFAULT)),
                gen.derefer(reads))}


# ---------------------------------------------------------------------------
# Support: zero/alpha daemons (`support.clj`)
# ---------------------------------------------------------------------------

DGRAPH_DIR = "/opt/dgraph"
ALPHA_PIDFILE = f"{DGRAPH_DIR}/alpha.pid"
ZERO_PIDFILE = f"{DGRAPH_DIR}/zero.pid"
ALPHA_LOG = f"{DGRAPH_DIR}/alpha.log"
ZERO_LOG = f"{DGRAPH_DIR}/zero.log"


class DgraphDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Install the dgraph binary, run zero + alpha daemons
    (`support.clj:40-248`)."""

    def __init__(self, version: str = "1.0.11"):
        self.version = version

    def _url(self) -> str:
        return (f"https://github.com/dgraph-io/dgraph/releases/download/"
                f"v{self.version}/dgraph-linux-amd64.tar.gz")

    def setup(self, test, node):
        from ..control import util as cu
        from .. import core
        debian.install(["curl", "tar"])
        with control.su():
            cu.install_archive(self._url(), DGRAPH_DIR)
            idx = test["nodes"].index(node) + 1
            zero0 = test["nodes"][0]
            self.start_zero(test, node, idx=idx, peer=zero0)
            core.synchronize(test)
            self.start_alpha(test, node, zero=zero0)

    def start_zero(self, test, node, idx: int = 1, peer: str | None = None):
        from ..control import util as cu
        args = ["--idx", str(idx), "--my", f"{node}:5080",
                "--replicas", str(test.get("replicas", 3))]
        if peer and peer != node:
            args += ["--peer", f"{peer}:5080"]
        cu.start_daemon({"logfile": ZERO_LOG, "pidfile": ZERO_PIDFILE,
                         "chdir": DGRAPH_DIR},
                        f"{DGRAPH_DIR}/dgraph", "zero", *args)

    def start_alpha(self, test, node, zero: str | None = None) -> str:
        from ..control import util as cu
        return cu.start_daemon(
            {"logfile": ALPHA_LOG, "pidfile": ALPHA_PIDFILE,
             "chdir": DGRAPH_DIR},
            f"{DGRAPH_DIR}/dgraph",
            "alpha" if self.version >= "1.1" else "server",
            "--my", f"{node}:7080",
            "--zero", f"{zero or node}:5080")

    def stop_alpha(self, test, node):
        from ..control import util as cu
        cu.stop_daemon(ALPHA_PIDFILE)

    def stop_zero(self, test, node):
        from ..control import util as cu
        cu.stop_daemon(ZERO_PIDFILE)

    def start(self, test, node):
        # rejoin the existing zero cluster with this node's raft id —
        # setup-time defaults here would duplicate nodes[0]'s id
        self.start_zero(test, node, idx=test["nodes"].index(node) + 1,
                        peer=test["nodes"][0])
        self.start_alpha(test, node, zero=test["nodes"][0])

    def kill(self, test, node):
        self.stop_alpha(test, node)
        self.stop_zero(test, node)

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf", DGRAPH_DIR)

    def log_files(self, test, node):
        return [ALPHA_LOG, ZERO_LOG]


# -- zero cluster state (`support.clj` zero-state / move-tablet) -------------

def zero_state(test: dict, node: str):
    """GET /state from a zero: groups, tablets, leader
    (`nemesis.clj:57-63` consumes it)."""
    fn = test.get("dgraph-zero-state-fn")
    if fn is not None:
        return fn(node)
    conn = http.client.HTTPConnection(node, ZERO_HTTP_PORT, timeout=5)
    try:
        conn.request("GET", "/state")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def move_tablet(test: dict, node: str, pred: str, group: int) -> None:
    fn = test.get("dgraph-move-tablet-fn")
    if fn is not None:
        return fn(node, pred, group)
    conn = http.client.HTTPConnection(node, ZERO_HTTP_PORT, timeout=5)
    try:
        conn.request("GET", f"/moveTablet?tablet={pred}&group={group}")
        conn.getresponse().read()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# Nemesis (`nemesis.clj`)
# ---------------------------------------------------------------------------

def alpha_killer() -> Nemesis:
    """Kill/restart alpha on all nodes (`nemesis.clj:17-23`)."""
    return node_start_stopper(
        lambda test, nodes: nodes,
        lambda test, node: test["db"].stop_alpha(test, node) or "killed",
        lambda test, node: test["db"].start_alpha(
            test, node, zero=test["nodes"][0]) or "restarted")


def zero_killer() -> Nemesis:
    """Kill/restart zero on a random subset (`nemesis.clj:43-49`)."""
    return node_start_stopper(
        lambda test, nodes: ncomb.random_nonempty_subset(nodes),
        lambda test, node: test["db"].stop_zero(test, node) or "killed",
        lambda test, node: test["db"].start_zero(
            test, node, idx=test["nodes"].index(node) + 1,
            peer=test["nodes"][0]) or "restarted")


class AlphaFixer(Nemesis):
    """Speculative alpha restarts — alpha falls over when zero is
    missing at startup (`nemesis.clj:25-41`). start-stop-daemon
    reports whether alpha was actually down, so already-running nodes
    are recorded as such, as the reference does."""

    def fs(self):
        return {"fix-alpha"}

    def invoke(self, test, op):
        def fix(t, node):
            res = test["db"].start_alpha(t, node, zero=test["nodes"][0])
            return "restarted" if res == "started" else res
        nodes = ncomb.random_nonempty_subset(test["nodes"])
        return {**op, "value": control.on_nodes(test, fix, nodes)}


class TabletMover(Nemesis):
    """Shuffle tablets between groups via zero (`nemesis.clj:51-102`)."""

    def fs(self):
        return {"move-tablet"}

    def invoke(self, test, op):
        node = test["nodes"][gen.rng.randrange(len(test["nodes"]))]
        try:
            state = zero_state(test, node)
        except (OSError, ValueError):
            return {**op, "value": "timeout"}
        if not isinstance(state, dict):
            return {**op, "value": "timeout"}
        groups = list((state.get("groups") or {}).keys())
        moved = {}
        for gid, ginfo in (state.get("groups") or {}).items():
            for pred, tablet in (ginfo.get("tablets") or {}).items():
                if not groups:
                    continue
                target = groups[gen.rng.randrange(len(groups))]
                if target != gid:
                    try:
                        move_tablet(test, node, pred, int(target))
                        moved[pred] = [gid, target]
                    except (OSError, ValueError):
                        pass
        return {**op, "value": moved}


class BumpTime(Nemesis):
    """Bump clocks on random subsets by dt ms; reset heals
    (`nemesis.clj:104-140`)."""

    def __init__(self, dt_ms: int = 15_000):
        self.dt_ms = dt_ms

    def fs(self):
        return {"bump", "reset-time"}

    def invoke(self, test, op):
        if op["f"] == "bump":
            nodes = ncomb.random_nonempty_subset(test["nodes"])

            def bump(t, node):
                return ntime.bump_time(self.dt_ms)
            return {**op, "value": control.on_nodes(test, bump, nodes)}

        def reset(t, node):
            ntime.reset_time()
            return "reset"
        return {**op, "value": control.on_nodes(test, reset,
                                                list(test["nodes"]))}


NEMESIS_SPECS = frozenset({
    "kill-alpha", "kill-zero", "fix-alpha", "partition-halves",
    "partition-ring", "move-tablet", "skew-clock"})


def dgraph_nemesis_package(opts: dict) -> dict:
    """Composed nemesis + generator for the enabled specs
    (`nemesis.clj:142-202`)."""
    nemeses = []
    gens: list = []
    interval = opts.get("interval", 10)

    def _op(f):
        return {"type": "info", "f": f, "value": None}

    # a bare op dict is a ONE-SHOT generator: recurring fault streams
    # must cycle their op pairs (the yugabyte _role_gen pattern), else
    # each fault fires once and the rest of the run is fault-free
    if opts.get("kill-alpha"):
        nemeses.append(n_fmap(
            lambda f: {"start": "stop-alpha",
                       "stop": "start-alpha"}.get(f, f), alpha_killer()))
        gens.append(itertools.cycle([_op("stop-alpha"),
                                     _op("start-alpha")]))
    if opts.get("kill-zero"):
        nemeses.append(n_fmap(
            lambda f: {"start": "stop-zero",
                       "stop": "start-zero"}.get(f, f), zero_killer()))
        gens.append(itertools.cycle([_op("stop-zero"),
                                     _op("start-zero")]))
    if opts.get("fix-alpha"):
        nemeses.append(AlphaFixer())
        gens.append(itertools.cycle([_op("fix-alpha")]))
    if opts.get("partition-halves") or opts.get("partition-ring"):
        nemeses.append(n_fmap(
            lambda f: {"start": "start-partition",
                       "stop": "stop-partition"}.get(f, f),
            npart.partitioner()))
        if opts.get("partition-halves"):
            def halves(test, ctx):
                nodes = list(test["nodes"])
                gen.rng.shuffle(nodes)
                return {"type": "info", "f": "start-partition",
                        "value": npart.complete_grudge(
                            npart.bisect(nodes))}
            gens += [halves, itertools.cycle([_op("stop-partition")])]
        if opts.get("partition-ring"):
            def ring(test, ctx):
                return {"type": "info", "f": "start-partition",
                        "value": npart.majorities_ring(
                            list(test["nodes"]))}
            gens += [ring, itertools.cycle([_op("stop-partition")])]
    if opts.get("move-tablet"):
        nemeses.append(TabletMover())
        gens.append(itertools.cycle([_op("move-tablet")]))
    if opts.get("skew-clock"):
        nemeses.append(BumpTime())
        gens.append(itertools.cycle([_op("bump"), _op("reset-time")]))
    if not nemeses:
        return ncomb.noop
    finals = []
    if opts.get("partition-halves") or opts.get("partition-ring"):
        finals.append(_op("stop-partition"))
    if opts.get("kill-alpha"):
        finals.append(_op("start-alpha"))
    if opts.get("kill-zero"):
        finals.append(_op("start-zero"))
    if opts.get("skew-clock"):
        finals.append(_op("reset-time"))
    return {"nemesis": n_compose(nemeses),
            "generator": gen.stagger(interval, gen.mix(gens)),
            "final-generator": gen.IterGen(iter(finals)),
            "perf": [{"name": "partition",
                      "start": ["start-partition"],
                      "stop": ["stop-partition"]}]}


# ---------------------------------------------------------------------------
# Runner (`core.clj`)
# ---------------------------------------------------------------------------

WORKLOADS = {
    "bank": bank_workload,
    "upsert": upsert_workload,
    "delete": delete_workload,
    "set": set_workload,
    "uid-set": uid_set_workload,
    "sequential": sequential_workload,
    "linearizable-register": linearizable_register_workload,
    "uid-linearizable-register": uid_linearizable_register_workload,
    "long-fork": long_fork_workload,
    "wr": wr_workload,
    "types": types_workload,
}

# the test-all sweep runs everything but types, as the reference does
# (`core.clj:43-45`); consumed by main()'s test-all command
STANDARD_WORKLOADS = sorted(set(WORKLOADS) - {"types"})

STANDARD_NEMESES = [
    {},
    {"kill-alpha": True, "kill-zero": True, "fix-alpha": True},
    {"partition-halves": True, "partition-ring": True},
    {"move-tablet": True},
    {"skew-clock": True},
]


def dgraph_test(opts: dict) -> dict:
    """Build the full test map (`core.clj:89-140`). "tracing" may be a
    Jaeger HTTP endpoint, a file path, or True (spans land in
    <store-dir>/traces.jsonl)."""
    from .. import testkit

    workload_name = opts.get("workload", "bank")
    time_limit = opts.get("time-limit", opts.get("time_limit", 60))
    nodes = opts.get("nodes") or ["n1", "n2", "n3", "n4", "n5"]
    opts = {**opts, "nodes": nodes}

    endpoint = opts.get("tracing")
    if endpoint is True:
        endpoint = (opts.get("store-dir", "store").rstrip("/")
                    + "/traces.jsonl")
    tracing_cfg = trace.tracing(endpoint or None)

    w = WORKLOADS[workload_name](opts)
    nem_opts = {f: True for f in (opts.get("nemesis") or [])}
    nem_opts["interval"] = opts.get("nemesis-interval", 10)
    pkg = dgraph_nemesis_package(nem_opts)

    rate = float(opts.get("rate", 30))
    client_gen = gen.clients(gen.stagger(1 / rate, w["generator"]))
    main_gen = gen.time_limit(
        time_limit,
        gen.any(client_gen, gen.nemesis(pkg["generator"]))
        if pkg.get("generator") is not None else client_gen)
    phases = [main_gen]
    if pkg.get("final-generator") is not None:
        phases.append(gen.nemesis(pkg["final-generator"]))
    if w.get("final-generator") is not None:
        phases.append(gen.clients(w["final-generator"]))

    return {
        **testkit.noop_test(),
        **{k: v for k, v in opts.items() if isinstance(k, str)},
        "name": f"dgraph {workload_name}",
        "os": debian.os,
        "db": DgraphDB(opts.get("version", "1.0.11")),
        "client": w["client"],
        "nemesis": pkg["nemesis"],
        "plot": {"nemeses": pkg.get("perf")},
        "tracing": tracing_cfg,
        "generator": gen.phases(*phases) if len(phases) > 1 else main_gen,
        "checker": checker.compose({
            "perf": checker.perf_checker(),
            "workload": w["checker"],
            "stats": checker.stats(),
            "exceptions": checker.unhandled_exceptions(),
        }),
    }


OPT_SPEC = [
    cli.opt("--workload", "-w", default="bank",
            choices=sorted(WORKLOADS), help="Which workload to run"),
    cli.opt("--rate", type=float, default=30,
            help="approximate op rate per second"),
    cli.opt("--nemesis", action="append",
            choices=sorted(NEMESIS_SPECS), help="fault types (repeatable)"),
    cli.opt("--nemesis-interval", type=float, default=10,
            help="seconds between nemesis operations"),
    cli.opt("--version", default="1.0.11", help="dgraph version"),
    cli.opt("--replicas", type=int, default=3,
            help="zero --replicas (group size)"),
    cli.opt("--upsert-schema", action="store_true",
            help="add @upsert to indexed predicates"),
    cli.opt("--tracing", default=None,
            help="Jaeger HTTP endpoint or file path for client spans"),
    cli.opt("--type-cases", type=int, default=None,
            help="types: sample this many boundary cases evenly"),
    cli.opt("--types-stagger", type=float,
            default=TYPES_STAGGER_DEFAULT,
            help="types: seconds between ops"),
    cli.opt("--types-settle", type=float, default=TYPES_SETTLE_DEFAULT,
            help="types: seconds between write and read phases"),
]


def _all_tests(opts):
    """One test per standard workload x nemesis set
    (`core.clj:215-231` all-tests)."""
    for nem in STANDARD_NEMESES:
        for w in STANDARD_WORKLOADS:
            yield dgraph_test({**opts, "workload": w,
                               "nemesis": sorted(nem)})


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": dgraph_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.test_all_cmd({"tests_fn": _all_tests,
                                 "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
