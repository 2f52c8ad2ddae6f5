"""FaunaDB suite — the reference's largest (3,649 LoC across 14
namespaces at `faunadb/src/jepsen/faunadb/`).

FaunaDB is a temporal, strict-serializable document store driven over
HTTP by a JSON-serialized query AST (`fauna_query.py` builds it; the
reference goes through the official JVM driver instead,
`faunadb/src/jepsen/faunadb/client.clj:45-60`). This module provides:

  * the wire client + error classification (`client.clj:355-418`)
  * topology modeling (`topology.clj`)
  * workloads: register, bank, bank-index, g2, set, pages, monotonic,
    multimonotonic, internal (one module each in the reference)
  * the replica-aware nemesis menu (`nemesis.clj`): inter/intra-replica
    and single-node partitions, kill/stop, clock skew, topology churn
  * cluster automation (`auto.clj`) and the runner/CLI (`runner.clj`)

One deliberate upgrade over the reference: multimonotonic's read-skew
checker is implemented (per-key successor edges + SCC), where the
reference's is a stub that always passes
(`multimonotonic.clj:read-skew-checker` returns `{:valid? true}`).
"""

from __future__ import annotations

import http.client
import itertools
import json
import socket
import threading
import time as _time
from base64 import b64encode

from .. import checker, cli, client as jclient, control, db as jdb
from .. import generator as gen, independent, models
from ..checker import timeline
from ..control import util as cutil
from ..checker.linear import linearizable
from ..nemesis import (Nemesis, compose as n_compose, f_map as n_fmap,
                       timeout as n_timeout)
from ..nemesis import partition as npart
from ..nemesis import time as ntime
from ..os_ import debian
from ..plot import Plot, write as plot_write
from ..workloads import adya, bank as bankw
from . import fauna_query as q

FAUNA_PORT = 8443
ROOT_KEY = "secret"


# ---------------------------------------------------------------------------
# Wire client (`client.clj`)
# ---------------------------------------------------------------------------

class FaunaError(Exception):
    """An error response from FaunaDB: HTTP status + the first error
    object's code/description."""

    def __init__(self, status: int, code: str, description: str):
        super().__init__(f"{status} {code}: {description}")
        self.status = status
        self.code = code
        self.description = description

    @property
    def unavailable(self) -> bool:
        return self.status == 503 or self.code == "unavailable"

    @property
    def internal(self) -> bool:
        return self.status == 500 or self.code == "internal server error"

    @property
    def bad_request(self) -> bool:
        return self.status == 400

    @property
    def not_found(self) -> bool:
        return self.status == 404 or self.code == "instance not found"


class FaunaConn:
    """One HTTP connection speaking the JSON query protocol. `query`
    POSTs a serialized expression and returns the decoded resource
    (`client.clj:146-180`). linearized=True models the reference's
    `linearized-client` (`client.clj:56-59`), which routes through the
    linearized endpoint for single-key strict serializability."""

    def __init__(self, node: str, port: int = FAUNA_PORT,
                 secret: str = ROOT_KEY, timeout_s: float = 10.0,
                 linearized: bool = False):
        self.node, self.port = node, port
        self.timeout_s = timeout_s
        self.linearized = linearized
        self._auth = "Basic " + b64encode(f"{secret}:".encode()).decode()
        self._http = http.client.HTTPConnection(node, port,
                                                timeout=timeout_s)

    def query(self, expr):
        body = json.dumps(expr).encode()
        headers = {"Authorization": self._auth,
                   "Content-Type": "application/json",
                   "X-FaunaDB-API-Version": "2.1"}
        if self.linearized:
            headers["X-Linearized"] = "true"
        try:
            self._http.request("POST", "/", body=body, headers=headers)
            resp = self._http.getresponse()
            data = resp.read()
        except Exception:
            # a failed exchange leaves the HTTP pipeline desynced
            self._http.close()
            raise
        if resp.status != 200:
            try:
                err = json.loads(data)["errors"][0]
            except Exception:  # noqa: BLE001 — non-JSON error body
                err = {"code": "unknown", "description": data.decode(
                    errors="replace")}
            raise FaunaError(resp.status, err.get("code", "unknown"),
                             err.get("description", ""))
        return _decode(json.loads(data)["resource"])

    def close(self):
        self._http.close()


def _decode(v):
    """Unwrap FaunaDB wire-format special values — {"@ts": ...}
    timestamps, {"@ref": ...} refs, {"@obj": ...} escaped objects —
    the decoding the reference gets from the JVM driver's Value tree
    (`client.clj:115-141`). Plain JSON (and the test fake's output)
    passes through unchanged."""
    if isinstance(v, dict):
        if len(v) == 1:
            if "@ts" in v:
                return v["@ts"]
            if "@ref" in v:
                return _decode(v["@ref"])
            if "@obj" in v:
                return _decode(v["@obj"])
        return {k: _decode(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode(x) for x in v]
    return v


def connect(test: dict, node: str, linearized: bool = False) -> FaunaConn:
    fn = test.get("fauna-conn-fn")
    if fn is not None:
        return fn(node, linearized)
    return FaunaConn(node, linearized=linearized)


def query_all(conn: FaunaConn, set_expr, size: int = 1024) -> list:
    """Exhaust a paginated set (`client.clj:216-257`)."""
    out = []
    after = None
    while True:
        page = conn.query(q.paginate(set_expr, size=size, after=after))
        out.extend(page.get("data", []))
        after = page.get("after")
        if after is None:
            return out


def upsert_by_ref(r, params: dict):
    """update-or-create (`client.clj:259-266`)."""
    return q.if_(q.exists(r), q.update(r, params), q.create(r, params))


def upsert_class(conn: FaunaConn, params: dict) -> None:
    """Idempotent class creation (`client.clj:276-301`)."""
    conn.query(q.when(q.not_(q.exists(q.class_(params["name"]))),
                      q.create_class(params)))


def upsert_index(conn: FaunaConn, params: dict) -> None:
    conn.query(q.when(q.not_(q.exists(q.index(params["name"]))),
                      q.create_index(params)))


def wait_for_index(conn: FaunaConn, idx, timeout_s: float = 60.0,
                   poll_s: float = 0.5) -> None:
    """Poll the index's active flag (`client.clj:419-441`)."""
    deadline = _time.monotonic() + timeout_s
    while True:
        res = conn.query(q.get(idx))
        if res.get("active"):
            return
        if _time.monotonic() > deadline:
            raise TimeoutError(f"index {idx} never became active")
        _time.sleep(poll_s)


def with_retry(thunk, tries: int = 5, sleep_s: float = 0.2):
    """Setup-time retry on unavailability (`client.clj:355-373`)."""
    while True:
        try:
            return thunk()
        except (FaunaError, ConnectionError, OSError) as e:
            definite = isinstance(e, FaunaError) and not e.unavailable
            tries -= 1
            if definite or tries <= 0:
                raise
            _time.sleep(sleep_s)


def with_errors(op: dict, idempotent: frozenset, thunk,
                pause_s: float = 1.0) -> dict:
    """Run thunk, mapping Fauna/network failures to :fail / :info per
    the reference's taxonomy (`client.clj:375-418`)."""
    crash = "fail" if op["f"] in idempotent else "info"
    try:
        return thunk()
    except FaunaError as e:
        if e.unavailable:
            return {**op, "type": crash,
                    "error": ["unavailable", e.description]}
        if e.internal:
            if "UninitializedException" in e.description:
                return {**op, "type": "fail", "error": "repo-uninitialized"}
            if "Transaction Coordinator is shut down" in e.description:
                return {**op, "type": "fail",
                        "error": "transaction-coordinator-shut-down"}
            return {**op, "type": crash,
                    "error": ["internal-exception", e.description]}
        if "No configured replica" in e.description:
            return {**op, "type": "fail", "error": "no-configured-replica"}
        raise
    except ConnectionRefusedError as e:
        _time.sleep(pause_s)  # we won't reconnect quickly; breathe
        return {**op, "type": "fail", "error": ["connect", str(e)]}
    except (socket.timeout, TimeoutError) as e:
        return {**op, "type": crash, "error": ["timeout", str(e)]}
    except (ConnectionError, OSError) as e:
        if "Connection refused" in str(e):
            _time.sleep(pause_s)
            return {**op, "type": "fail", "error": "connection-refused"}
        return {**op, "type": crash, "error": ["io", str(e)]}


class _FaunaClient(jclient.Client):
    """Shared open/close. Subclasses set `linearized` when they need
    the linearized endpoint."""

    linearized = False

    def __init__(self):
        self.conn: FaunaConn | None = None

    def open(self, test, node):
        c = type(self).__new__(type(self))
        c.__dict__.update(self.__dict__)
        c.conn = connect(test, node, linearized=self.linearized)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def _pause_s(self, test) -> float:
        return test.get("fauna-conn-retry-delay", 1.0)


# ---------------------------------------------------------------------------
# register (`register.clj`)
# ---------------------------------------------------------------------------

REGISTER_CLASS = "test"


def _r(test, ctx):
    return {"type": "invoke", "f": "read", "value": None}


def _w(test, ctx):
    return {"type": "invoke", "f": "write", "value": gen.rng.randrange(5)}


def _cas(test, ctx):
    return {"type": "invoke", "f": "cas",
            "value": [gen.rng.randrange(5), gen.rng.randrange(5)]}


class AtomicClient(_FaunaClient):
    """Keyed CAS register over instances of class "test"
    (`register.clj:21-63`)."""

    linearized = True

    def setup(self, test):
        with_retry(lambda: upsert_class(self.conn,
                                        {"name": REGISTER_CLASS}))

    def invoke(self, test, op):
        def body():
            k, val = op["value"]
            r = q.ref(REGISTER_CLASS, k)
            if op["f"] == "read":
                v = self.conn.query(q.if_(q.exists(r), q.get(r), None))
                reg = (v or {}).get("data", {}).get("register") \
                    if isinstance(v, dict) else None
                return {**op, "type": "ok",
                        "value": independent.ktuple(k, reg),
                        "write-ts": (v or {}).get("ts")
                        if isinstance(v, dict) else None}
            if op["f"] == "write":
                res = self.conn.query(q.if_(
                    q.exists(r),
                    q.update(r, {"data": {"register": val}}),
                    q.create(r, {"data": {"register": val}})))
                return {**op, "type": "ok", "write-ts": res.get("ts")}
            # cas (`register.clj:48-60`)
            expected, new = val
            res = self.conn.query(q.if_(
                q.exists(r),
                q.let({"reg": q.select(["data", "register"], q.get(r))},
                      q.if_(q.eq(expected, q.var("reg")),
                            q.update(r, {"data": {"register": new}}),
                            False)),
                False))
            out = {**op, "type": "ok" if res else "fail"}
            if res:
                out["write-ts"] = res.get("ts")
            return out
        return with_errors(op, frozenset({"read"}), body,
                           self._pause_s(test))


def register_workload(opts: dict) -> dict:
    """Independent keyed CAS registers (`register.clj:65-84`)."""
    n = max(1, len(opts.get("nodes", [])) or 5)

    def fgen(k):
        return gen.limit(
            opts.get("ops-per-key", 100),
            gen.stagger(opts.get("register-stagger", 0.1), gen.delay(
                opts.get("register-delay", 0.5),
                gen.reserve(n, gen.mix([_w, _cas, _cas]), _r))))

    return {
        "client": AtomicClient(),
        "generator": independent.concurrent_generator(
            2 * n, itertools.count(), fgen),
        "checker": independent.checker(checker.compose({
            "timeline": timeline.html(),
            # nil-initial register: instances don't exist until the
            # first write creates them (reference `(model/cas-register
            # 0)` is wrong about Fauna's initial state; reads of a
            # never-written key return nil here)
            "linearizable": linearizable(models.cas_register(),
                                         device=opts.get("device")),
        })),
    }


# ---------------------------------------------------------------------------
# bank (`bank.clj`)
# ---------------------------------------------------------------------------

ACCOUNTS_CLASS = "accounts"
BANK_IDX = "all_accounts"

_NEGATIVE_ABORT = "balance would go negative"


class BankClient(_FaunaClient):
    """Transactional transfers across account instances
    (`bank.clj:70-135`). `fixed-instances` writes zero balances instead
    of deleting emptied accounts; `at-query` wraps reads in temporal
    `at` snapshots."""

    def setup(self, test):
        def go():
            upsert_class(self.conn, {"name": ACCOUNTS_CLASS})
            self._create_accounts(test)
        with_retry(go)

    def _create_accounts(self, test):
        accounts = test.get("accounts", list(range(8)))
        r0 = q.ref(ACCOUNTS_CLASS, accounts[0])
        self.conn.query(q.when(
            q.not_(q.exists(r0)),
            q.create(r0, {"data": {"balance":
                                   test.get("total-amount", 100)}})))
        if test.get("fixed-instances"):
            self.conn.query(q.do(*[
                upsert_by_ref(q.ref(ACCOUNTS_CLASS, a),
                              {"data": {"balance": 0}})
                for a in accounts[1:]]))

    def _read_expr(self, test):
        return [q.when(q.exists(q.ref(ACCOUNTS_CLASS, i)),
                       [i, q.select(["data", "balance"],
                                    q.get(q.ref(ACCOUNTS_CLASS, i)))])
                for i in test.get("accounts", list(range(8)))]

    def _wrapped(self, test, op, thunk):
        def body():
            try:
                return thunk()
            except FaunaError as e:
                if e.bad_request and _NEGATIVE_ABORT in e.description:
                    return {**op, "type": "fail", "error": "negative"}
                raise
        return with_errors(op, frozenset({"read"}), body,
                           self._pause_s(test))

    def invoke(self, test, op):
        if op["f"] == "read":
            def read():
                expr = self._read_expr(test)
                if test.get("at-query"):
                    ts_res = self.conn.query(
                        [q.NOW, q.at(q.NOW, expr)])
                else:
                    ts_res = self.conn.query([None, expr])
                ts, res = ts_res
                balances = {pair[0]: pair[1] for pair in res
                            if isinstance(pair, list)}
                return {**op, "type": "ok", "value": balances,
                        "ts": str(ts)}
            return self._wrapped(test, op, read)

        def transfer():
            v = op["value"]
            frm, to, amount = v["from"], v["to"], v["amount"]
            fr = q.ref(ACCOUNTS_CLASS, frm)
            tr = q.ref(ACCOUNTS_CLASS, to)
            debit = q.let(
                {"a": q.subtract(
                    q.if_(q.exists(fr),
                          q.select(["data", "balance"], q.get(fr)), 0),
                    amount)},
                q.cond(
                    q.lt(q.var("a"), 0), q.abort(_NEGATIVE_ABORT),
                    q.and_(q.eq(q.var("a"), 0),
                           not test.get("fixed-instances")),
                    q.delete(fr),
                    q.update(fr, {"data": {"balance": q.var("a")}})))
            credit = q.if_(
                q.exists(tr),
                q.let({"b": q.add(q.select(["data", "balance"],
                                           q.get(tr)), amount)},
                      q.update(tr, {"data": {"balance": q.var("b")}})),
                q.create(tr, {"data": {"balance": amount}}))
            self.conn.query(q.do(debit, credit))
            return {**op, "type": "ok"}
        return self._wrapped(test, op, transfer)


class IndexBankClient(BankClient):
    """Bank variant reading through an index (`bank.clj:138-176`)."""

    def setup(self, test):
        def go():
            upsert_class(self.conn, {"name": ACCOUNTS_CLASS})
            upsert_index(self.conn, {
                "name": BANK_IDX,
                "source": q.class_(ACCOUNTS_CLASS),
                "active": True,
                "serialized": bool(test.get("serialized-indices")),
                "values": [{"field": ["ref"]},
                           {"field": ["data", "balance"]}]})
            wait_for_index(self.conn, q.index(BANK_IDX))
            self._create_accounts(test)
        with_retry(go)

    def invoke(self, test, op):
        if op["f"] != "read":
            return super().invoke(test, op)

        def read():
            rows = query_all(self.conn, q.match(q.index(BANK_IDX)))
            balances = {int(ref["id"]): bal for ref, bal in rows}
            return {**op, "type": "ok", "value": balances}
        return self._wrapped(test, op, read)


def bank_workload(opts: dict) -> dict:
    """`bank.clj:178-183`: the shared bank test with a 1/10 delay."""
    w = bankw.test()
    return {**w, "client": BankClient(),
            "generator": gen.delay(opts.get("bank-delay", 0.1),
                                   w["generator"])}


def bank_index_workload(opts: dict) -> dict:
    w = bankw.test()
    return {**w, "client": IndexBankClient(),
            "generator": gen.delay(opts.get("bank-delay", 0.1),
                                   w["generator"])}


# ---------------------------------------------------------------------------
# g2 (`g2.clj`)
# ---------------------------------------------------------------------------

class G2Client(_FaunaClient):
    """Anti-dependency-cycle probe: insert into class a or b only when
    the *other* class's index shows no row for this key
    (`g2.clj:37-70`)."""

    def setup(self, test):
        def go():
            serialized = bool(test.get("serialized-indices", True))
            for name in ("a", "b"):
                upsert_class(self.conn, {"name": name})
                upsert_index(self.conn, {
                    "name": f"{name}-index",
                    "source": q.class_(name),
                    "active": True,
                    "serialized": serialized,
                    "terms": [{"field": ["data", "key"]}]})
            wait_for_index(self.conn, q.index("a-index"))
            wait_for_index(self.conn, q.index("b-index"))
        with_retry(go)

    def invoke(self, test, op):
        def body():
            k, (a_id, b_id) = op["value"]
            ins_id = a_id if a_id is not None else b_id
            cls = "a" if a_id is not None else "b"
            other_idx = q.index("b-index" if a_id is not None
                                else "a-index")
            res = self.conn.query(
                q.when(q.not_(q.non_empty(q.paginate(
                    q.match(other_idx, k), size=1))),
                       q.create(q.ref(cls, ins_id),
                                {"data": {"key": k}})))
            return {**op, "type": "ok" if res else "fail"}
        return with_errors(op, frozenset(), body, self._pause_s(test))


def g2_workload(opts: dict) -> dict:
    return {"client": G2Client(),
            "generator": adya.g2_gen(),
            "checker": adya.g2_checker()}


# ---------------------------------------------------------------------------
# set (`set.clj`)
# ---------------------------------------------------------------------------

ELEMENTS_CLASS = "elements"
SIDE_EFFECTS_CLASS = "side-effects"
SET_IDX = "all-elements"


class SetClient(_FaunaClient):
    """Insert-only set read back through an index; `strong-read`
    smuggles a write into the read txn to force strict serializability
    (`set.clj:19-63`)."""

    linearized = True

    def setup(self, test):
        def go():
            upsert_class(self.conn, {"name": ELEMENTS_CLASS})
            upsert_class(self.conn, {"name": SIDE_EFFECTS_CLASS})
            upsert_index(self.conn, {
                "name": SET_IDX,
                "source": q.class_(ELEMENTS_CLASS),
                "active": True,
                "serialized": bool(test.get("serialized-indices", True)),
                "values": [{"field": ["data", "value"]}]})
            wait_for_index(self.conn, q.index(SET_IDX))
        with_retry(go)

    def invoke(self, test, op):
        def body():
            if op["f"] == "add":
                v = op["value"]
                self.conn.query(q.create(q.ref(ELEMENTS_CLASS, v),
                                         {"data": {"value": v}}))
                return {**op, "type": "ok"}
            if test.get("strong-read"):
                # read + side-effecting create in one txn (`set.clj:44-53`)
                rows = query_all(
                    self.conn,
                    q.let({"r": q.match(q.index(SET_IDX))},
                          q.do(q.at(q.NOW, q.create(
                              q.class_(SIDE_EFFECTS_CLASS), {})),
                               q.var("r"))))
            else:
                rows = query_all(self.conn, q.match(q.index(SET_IDX)))
            return {**op, "type": "ok", "value": sorted(set(rows))}
        return with_errors(op, frozenset({"read"}), body,
                           self._pause_s(test))


def set_workload(opts: dict) -> dict:
    adds = gen.IterGen({"type": "invoke", "f": "add", "value": v}
                       for v in itertools.count())
    def reads(test, ctx):
        # fn gen: a bare dict is one-shot, capping the run at 1 read
        return {"type": "invoke", "f": "read", "value": None}

    return {
        "client": SetClient(),
        # reads deliberately starve writes (`set.clj:76-79`)
        "generator": gen.stagger(1 / 5, gen.mix([adds, reads])),
        "final-generator": gen.once(
            {"type": "invoke", "f": "read", "value": None}),
        "checker": checker.set_full(
            linearizable=bool(opts.get("strong-read")
                              and opts.get("serialized-indices"))),
    }


# ---------------------------------------------------------------------------
# pages (`pages.clj`)
# ---------------------------------------------------------------------------

class PagesClient(_FaunaClient):
    """Insert groups atomically; read the whole keyed index
    (`pages.clj:27-64`)."""

    def setup(self, test):
        def go():
            upsert_class(self.conn, {"name": ELEMENTS_CLASS})
            upsert_index(self.conn, {
                "name": SET_IDX,
                "source": q.class_(ELEMENTS_CLASS),
                "active": True,
                "serialized": bool(test.get("serialized-indices", True)),
                "terms": [{"field": ["data", "key"]}],
                "values": [{"field": ["data", "value"]}]})
            wait_for_index(self.conn, q.index(SET_IDX))
        with_retry(go)

    def invoke(self, test, op):
        def body():
            k, v = op["value"]
            if op["f"] == "add":
                self.conn.query(q.do(*[
                    q.create(q.class_(ELEMENTS_CLASS),
                             {"data": {"key": k, "value": x}})
                    for x in v]))
                return {**op, "type": "ok"}
            rows = query_all(self.conn, q.match(q.index(SET_IDX), k))
            return {**op, "type": "ok",
                    "value": independent.ktuple(k, list(rows))}
        return with_errors(op, frozenset({"read"}), body,
                           self._pause_s(test))


def pages_read_errs(idx: dict, read: set, errs=None) -> list:
    """Can `read` be expressed as a union of add-groups? Pick any
    element, cross off its whole group, recurse (`pages.clj:66-89`)."""
    errs = [] if errs is None else errs
    read = set(read)
    while read:
        e = next(iter(read))
        group = idx.get(e, frozenset({e}))
        missing = [x for x in group if x not in read]
        if missing:
            errs.append({"expected": sorted(group),
                         "found": sorted(read & set(group))})
        read -= set(group)
    return errs


class PagesChecker(checker.Checker):
    """Each read must be a union of potentially-committed add groups
    with no duplicates (`pages.clj:91-141`)."""

    def check(self, test, hist, opts):
        invokes, fails = set(), set()
        groups = []
        for op in hist:
            if op.get("f") != "add":
                continue
            v = tuple(op.get("value") or ())
            if op.get("type") == "invoke":
                invokes.add(v)
                groups.append(v)
            elif op.get("type") == "fail":
                fails.add(v)
        possible = invokes - fails
        idx: dict = {}
        # dedupe while preserving invocation order (the reference folds
        # over a *set* of adds, `pages.clj:110-120`)
        for g in dict.fromkeys(groups):
            if g in possible:
                for x in g:
                    assert x not in idx, "Elements must be unique"
                    idx[x] = frozenset(g)
        errs = []
        ok_reads = 0
        for op in hist:
            if op.get("type") != "ok" or op.get("f") != "read":
                continue
            ok_reads += 1
            v = list(op.get("value") or [])
            vs = set(v)
            if len(v) != len(vs):
                errs.append({"op": op, "errors": ["duplicate-items"]})
                continue
            es = pages_read_errs(idx, vs)
            if es:
                errs.append({"op": op, "errors": es})
        return {"valid?": not errs,
                "ok-read-count": ok_reads,
                "error-count": len(errs),
                "first-error": errs[0] if errs else None}


def pages_workload(opts: dict) -> dict:
    n = max(1, len(opts.get("nodes", [])) or 5)
    half_range = opts.get("pages-elements", 10_000)
    group_size = 4

    def fgen(k):
        vals = list(range(-half_range, half_range))
        gen.rng.shuffle(vals)
        groups = [tuple(vals[i:i + group_size])
                  for i in range(0, len(vals), group_size)]
        # 4:1 add:read weighting (`pages.clj:153-161`); four separate
        # IterGen wrappers over ONE shared iterator so no group is
        # emitted twice (a single instance in four mix slots would
        # re-emit its memoized head from each slot)
        it = iter({"type": "invoke", "f": "add", "value": g}
                  for g in groups)
        reads = {"type": "invoke", "f": "read", "value": None}
        return gen.stagger(
            1 / 5, gen.limit(opts.get("ops-per-key", 256),
                             gen.mix([gen.IterGen(it), gen.IterGen(it),
                                      gen.IterGen(it), gen.IterGen(it),
                                      reads])))

    return {"client": PagesClient(),
            "generator": independent.concurrent_generator(
                2 * n, itertools.count(), fgen),
            "checker": independent.checker(PagesChecker())}


# ---------------------------------------------------------------------------
# monotonic (`monotonic.clj`)
# ---------------------------------------------------------------------------

REGISTERS_CLASS = "registers"
MONO_KEY = 0


def strip_time(ts) -> str:
    """Drop the trailing Z so timestamps compare as strings
    (`monotonic.clj:52-60`)."""
    s = str(ts)
    assert s.endswith("Z"), s
    return s[:-1]


class MonotonicClient(_FaunaClient):
    """Increment-only register read at current and past timestamps
    (`monotonic.clj:84-147`)."""

    def setup(self, test):
        with_retry(lambda: upsert_class(self.conn,
                                        {"name": REGISTERS_CLASS}))

    def _jittered_now(self, test, jitter_ms: int) -> str:
        """A timestamp up to jitter_ms in the past
        (`client.clj:312-318` jitter-time)."""
        now = self.conn.query(q.NOW)
        fn = test.get("fauna-jitter-time-fn")
        if fn is not None:
            return fn(str(now), jitter_ms)
        from datetime import datetime, timedelta
        base = datetime.fromisoformat(str(now).rstrip("Z"))
        back = timedelta(
            milliseconds=gen.rng.randrange(jitter_ms + 1))
        return (base - back).isoformat() + "Z"

    def invoke(self, test, op):
        def body():
            r = q.ref(REGISTERS_CLASS, MONO_KEY)
            f = op["f"]
            if f == "inc":
                res = self.conn.query(
                    [q.NOW,
                     q.if_(q.exists(r),
                           q.let({"v": q.select(["data", "value"],
                                                q.get(r)),
                                  "_": q.update(
                                      r, {"data": {"value": q.add(
                                          q.var("v"), 1)}})},
                                 q.var("v")),
                           q.do(q.create(r, {"data": {"value": 1}}), 0))])
                return {**op, "type": "ok",
                        "value": [strip_time(res[0]), res[1]]}
            if f == "read":
                res = self.conn.query(
                    [q.NOW, q.if_(q.exists(r),
                                  q.select(["data", "value"], q.get(r)),
                                  0)])
                return {**op, "type": "ok",
                        "value": [strip_time(res[0]), res[1]]}
            if f == "read-at":
                ts = (op.get("value") or [None])[0]
                jitter = test.get("at-query-jitter", 0)
                if ts is None and jitter:
                    ts = self._jittered_now(test, jitter)
                ts_expr = ts if ts is not None else q.NOW
                res = self.conn.query(
                    [ts_expr,
                     q.at(ts_expr,
                          q.if_(q.exists(r),
                                q.select(["data", "value"], q.get(r)),
                                0))])
                return {**op, "type": "ok",
                        "value": [strip_time(res[0]), res[1]]}
            # events: the instance's version history (`monotonic.clj:136`)
            evs = self.conn.query(q.paginate(q.events(r), size=1000))
            return {**op, "type": "ok", "value": evs.get("data", [])}

        def guarded():
            try:
                return body()
            except FaunaError as e:
                if e.not_found:
                    return {**op, "type": "fail", "error": "not-found"}
                raise
        return with_errors(op, frozenset({"read", "read-at"}), guarded,
                           self._pause_s(test))


def non_monotonic_pairs_by_process(extract, hist) -> list:
    """Pairs of same-process ok ops whose extracted value went
    backwards (`monotonic.clj:151-171`)."""
    last: dict = {}
    errs = []
    for op in hist:
        if op.get("type") != "ok":
            continue
        p = op.get("process")
        v = extract(op)
        prev = last.get(p)
        if prev is not None and extract(prev) is not None \
                and v is not None and v < extract(prev):
            errs.append([prev, op])
        last[p] = op
    return errs


class MonotonicChecker(checker.Checker):
    """Per-process monotonicity of values and timestamps
    (`monotonic.clj:173-190`)."""

    def check(self, test, hist, opts):
        ops = [o for o in hist if o.get("f") in ("read", "inc")]
        value_errs = non_monotonic_pairs_by_process(
            lambda o: (o.get("value") or [None, None])[1], ops)
        ts_errs = non_monotonic_pairs_by_process(
            lambda o: (o.get("value") or [None])[0], ops)
        return {"valid?": not value_errs and not ts_errs,
                "value-errors": value_errs, "ts-errors": ts_errs}


class TimestampValueChecker(checker.Checker):
    """Globally: sorting reads/incs by Fauna timestamp, values must
    never decrease (`monotonic.clj:203-216`)."""

    def check(self, test, hist, opts):
        ops = sorted((o for o in hist
                      if o.get("type") == "ok"
                      and o.get("f") in ("read-at", "inc")
                      and (o.get("value") or [None])[0] is not None),
                     key=lambda o: o["value"][0])
        errs = [[a, b] for a, b in zip(ops, ops[1:])
                if a["value"][1] is not None and b["value"][1] is not None
                and b["value"][1] < a["value"][1]]
        return {"valid?": not errs, "errors": errs}


class TimestampValuePlotter(checker.Checker):
    """SVG scatter of register value against Fauna timestamp, windowed
    around non-monotonic spots (`monotonic.clj:218-300`: spots ->
    merged +/-32 windows -> one plot each; gnuplot in the reference,
    our plot library renders SVG)."""

    def check(self, test, hist, opts):
        ops = sorted((o for o in hist
                      if o.get("type") == "ok" and o.get("f") == "read-at"
                      and (o.get("value") or [None, None])[1] is not None),
                     key=lambda o: o["value"][0])
        if not ops or not test.get("store-dir"):
            return {"valid?": True}
        from ..checker.perf import out_path
        from ..plot import merged_windows, process_series, \
            regression_spots
        # spots in timestamp order: per-process regressions (the
        # reference plotter's shape) PLUS global consecutive decreases
        # (what TimestampValueChecker flags), so every checker-cited
        # anomaly lands inside a plotted window
        spots = regression_spots(
            [(o.get("process"), o["value"][1]) for o in ops],
            global_too=True)
        # nothing anomalous: plot everything once (the reference emits
        # no plot at all; one overview costs little and helps triage)
        windows = merged_windows(32, spots) or [[0, len(ops)]]
        for wi, (lo, hi) in enumerate(windows):
            window = ops[max(lo, 0):min(hi + 1, len(ops))]
            by_process: dict = {}
            t0 = None
            for o in window:
                try:
                    ts = float(o["value"][0].replace("T", " ")
                               .replace("-", "").replace(":", "")
                               .replace(" ", "") or 0)
                except ValueError:
                    ts = 0.0
                t0 = ts if t0 is None else t0
                by_process.setdefault(o.get("process"), []).append(
                    (ts - t0, o["value"][1]))
            p = Plot(title=f"{test.get('name', '')} timestamp-value "
                           f"by process",
                     xlabel="faunadb timestamp", ylabel="register value",
                     series=process_series(by_process))
            try:
                plot_write(p, out_path(
                    test, opts, f"timestamp-value-{wi}.svg"))
            except Exception:  # noqa: BLE001 — plotting is best-effort
                pass
        return {"valid?": True}


class NotFoundChecker(checker.Checker):
    """Existence-checked reads must never observe not-found
    (`monotonic.clj:302-315`)."""

    def check(self, test, hist, opts):
        errs = [o for o in hist
                if o.get("type") == "fail" and o.get("error") == "not-found"]
        return {"valid?": not errs, "error-count": len(errs),
                "first": errs[0] if errs else None}


def monotonic_workload(opts: dict) -> dict:
    def inc_gen(test, ctx):
        return {"type": "invoke", "f": "inc", "value": None}

    def read_gen(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def read_at_gen(test, ctx):
        return {"type": "invoke", "f": "read-at", "value": [None, None]}

    return {
        "client": MonotonicClient(),
        "generator": gen.mix([inc_gen, read_gen, read_at_gen]),
        "final-generator": gen.once(
            {"type": "invoke", "f": "events", "value": None}),
        "checker": checker.compose({
            "monotonic": MonotonicChecker(),
            "not-found": NotFoundChecker(),
            "timestamp-value": TimestampValueChecker(),
            "timestamp-value-plot": TimestampValuePlotter(),
        }),
    }


# ---------------------------------------------------------------------------
# multimonotonic (`multimonotonic.clj`)
# ---------------------------------------------------------------------------

def map_compare(m1: dict, m2: dict) -> int:
    """Partial-order comparator over state maps; raises Incomparable
    when per-key orders conflict (`multimonotonic.clj:110-150`)."""
    c = 0
    for k, v1 in m1.items():
        if k not in m2:
            continue
        v2 = m2[k]
        c2 = (v1 > v2) - (v1 < v2)
        if c * c2 < 0:
            raise Incomparable(m1, m2)
        if c == 0:
            c = c2
    return c


class Incomparable(Exception):
    def __init__(self, m1, m2):
        super().__init__(f"incomparable states {m1} vs {m2}")
        self.m1, self.m2 = m1, m2


def nonmonotonic_states(state_fn, ops) -> list:
    """Walk ops inferring a per-key lower bound; flag states below it
    (`multimonotonic.clj:152-216`)."""
    inferred: dict = {}
    errs = []
    for op in ops:
        state = state_fn(op)
        nm = [k for k, v in state.items()
              if k in inferred and v < inferred[k]["value"]]
        if nm:
            errs.append({
                "inferred": {k: inferred[k]["value"] for k in state
                             if k in inferred},
                "observed": state, "op": op,
                "errors": {k: [inferred[k],
                               {"value": state[k],
                                "op-index": op.get("index")}]
                           for k in nm}})
        for k, v in state.items():
            if k not in inferred or inferred[k]["value"] < v:
                inferred[k] = {"value": v, "op-index": op.get("index")}
    return errs


def _read_state(op) -> dict:
    regs = (op.get("value") or {}).get("registers") or {}
    return {k: r["value"] for k, r in regs.items()}


class TsOrderChecker(checker.Checker):
    """Reads ordered by Fauna timestamp must observe monotonic register
    states (`multimonotonic.clj:230-246`)."""

    def check(self, test, hist, opts):
        ops = sorted((o for o in hist
                      if o.get("type") == "ok" and o.get("f") == "read"
                      and (o.get("value") or {}).get("ts") is not None),
                     key=lambda o: o["value"]["ts"])
        errs = nonmonotonic_states(_read_state, ops)
        return {"valid?": not errs, "errors": errs}


class ReadSkewChecker(checker.Checker):
    """Read-skew detection via cycle search over per-key version
    orders. The reference documents this algorithm but ships a stub
    that always passes (`multimonotonic.clj:248-290`); here it is
    implemented: each read's state map is a node; for every key we add
    edges from each state to the states holding the next-larger value;
    any SCC larger than one node is a skew cycle."""

    def check(self, test, hist, opts):
        states: list[dict] = []
        seen = set()
        for o in hist:
            if o.get("type") == "ok" and o.get("f") == "read":
                s = _read_state(o)
                key = tuple(sorted(s.items()))
                if s and key not in seen:
                    seen.add(key)
                    states.append(s)
        # per-key next-value edges (`multimonotonic.clj:266-273`)
        edges: dict[int, set[int]] = {i: set() for i in range(len(states))}
        keys = {k for s in states for k in s}
        for k in keys:
            vals = sorted({s[k] for s in states if k in s})
            nxt = {v: vals[i + 1] for i, v in enumerate(vals[:-1])}
            by_val: dict = {}
            for i, s in enumerate(states):
                if k in s:
                    by_val.setdefault(s[k], []).append(i)
            for i, s in enumerate(states):
                if k in s and s[k] in nxt:
                    for j in by_val[nxt[s[k]]]:
                        edges[i].add(j)
        sccs = _tarjan(edges)
        cycles = [[states[i] for i in c] for c in sccs if len(c) > 1]
        return {"valid?": not cycles, "cycles": cycles}


def _tarjan(adj: dict[int, set]) -> list[list[int]]:
    """Iterative Tarjan SCC (host-side; the big transactional SCC work
    lives in the elle kernels — reads here number at most a few
    thousand)."""
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    sccs: list = []
    counter = itertools.count()
    for root in adj:
        if root in index:
            continue
        work = [(root, iter(sorted(adj[root])))]
        index[root] = low[root] = next(counter)
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = next(counter)
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                u = work[-1][0]
                low[u] = min(low[u], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)
    return sccs


class MultiMonotonicClient(_FaunaClient):
    """Blind per-thread register writes + multi-register snapshot reads
    (`multimonotonic.clj:76-110`)."""

    def setup(self, test):
        with_retry(lambda: upsert_class(self.conn,
                                        {"name": REGISTERS_CLASS}))

    def invoke(self, test, op):
        def body():
            if op["f"] == "write":
                self.conn.query([
                    upsert_by_ref(q.ref(REGISTERS_CLASS, k),
                                  {"data": {"value": v}})
                    for k, v in op["value"].items()])
                return {**op, "type": "ok"}
            ks = list(op["value"])
            res = self.conn.query(
                [q.NOW,
                 [q.when(q.exists(q.ref(REGISTERS_CLASS, k)),
                         q.get(q.ref(REGISTERS_CLASS, k))) for k in ks]])
            regs = {}
            for k, inst in zip(ks, res[1]):
                if isinstance(inst, dict):
                    regs[k] = {"value": inst["data"]["value"],
                               "ts": inst.get("ts")}
            return {**op, "type": "ok",
                    "value": {"ts": strip_time(res[0]),
                              "registers": regs}}
        return with_errors(op, frozenset({"read"}), body,
                           self._pause_s(test))


class _MMWrites(gen.Gen):
    """Each thread owns one register (key = its thread id) and blindly
    writes 0, 1, 2, ... — sequenced through update() so probing op()
    twice can't skip values (`multimonotonic.clj:generator`)."""

    def __init__(self, seen: dict, counts: dict | None = None):
        self.seen = seen
        self.counts = counts if counts is not None else {}

    def op(self, test, ctx):
        ts = gen.all_threads(ctx)
        if not ts:
            return None
        t = int(ts[0])
        return (gen.fill_in_op(
            {"type": "invoke", "f": "write",
             "value": {t: self.counts.get(t, 0)}}, ctx), self)

    def update(self, test, ctx, event):
        if event.get("type") == "invoke" and event.get("f") == "write":
            (k, v), = event["value"].items()
            self.seen[k] = max(self.seen.get(k, -1), v)
            counts = dict(self.counts)
            counts[k] = v + 1
            return _MMWrites(self.seen, counts)
        return self


class _MMReads(gen.Gen):
    """Reads of a random nonempty subset of the keys written so far."""

    def __init__(self, seen: dict):
        self.seen = seen

    def op(self, test, ctx):
        ks = sorted(self.seen)
        if not ks:
            ks = [0]
        subset = [k for k in ks if gen.rng.random() < 0.5] or \
            [ks[gen.rng.randrange(len(ks))]]
        return (gen.fill_in_op(
            {"type": "invoke", "f": "read", "value": subset}, ctx), self)

    def update(self, test, ctx, event):
        if event.get("type") == "invoke" and event.get("f") == "write":
            (k, v), = event["value"].items()
            self.seen[k] = max(self.seen.get(k, -1), v)
        return self


def multimonotonic_workload(opts: dict) -> dict:
    seen: dict = {}
    writers = max(1, int(opts.get("concurrency", 10)) // 2)
    return {
        "client": MultiMonotonicClient(),
        "generator": gen.reserve(
            writers, gen.each_thread(_MMWrites(seen)), _MMReads(seen)),
        "checker": checker.compose({
            "ts-order": TsOrderChecker(),
            "read-skew": ReadSkewChecker(),
        }),
    }


# ---------------------------------------------------------------------------
# internal (`internal.clj`)
# ---------------------------------------------------------------------------

CATS_CLASS = "cats"
CATS_IDX = "cats_by_type"


def _match_cats(type_: str):
    """Names of cats of a type, via the index (`internal.clj:33-40`)."""
    return q.select(["data"], q.paginate(
        q.match(q.index(CATS_IDX), type_), size=1024))


class InternalClient(_FaunaClient):
    """Intra-transaction consistency probes: a create must be invisible
    to reads sequenced before it in the same txn, visible after
    (`internal.clj:55-137`)."""

    def setup(self, test):
        def go():
            upsert_class(self.conn, {"name": CATS_CLASS})
            upsert_index(self.conn, {
                "name": CATS_IDX,
                "source": q.class_(CATS_CLASS),
                "active": True,
                "serialized": bool(test.get("serialized-indices", True)),
                "terms": [{"field": ["data", "type"]}],
                "values": [{"field": ["data", "name"]}]})
            wait_for_index(self.conn, q.index(CATS_IDX))
        with_retry(go)

    def invoke(self, test, op):
        def body():
            f, v = op["f"], op.get("value")
            if f == "reset":
                # delete all tabbies and calicos (`internal.clj:42-53`)
                for t in ("tabby", "calico"):
                    for name in query_all(self.conn,
                                          q.match(q.index(CATS_IDX), t)):
                        self.conn.query(q.when(
                            q.exists(q.ref(CATS_CLASS, name)),
                            q.delete(q.ref(CATS_CLASS, name))))
                return {**op, "type": "ok", "value": None}
            if f in ("create-tabby-let", "create-tabby-obj",
                     "create-tabby-arr"):
                create = q.create(q.ref(CATS_CLASS, v),
                                  {"data": {"type": "tabby", "name": v}})
                if f == "create-tabby-let":
                    expr = q.let({"tabbies0": _match_cats("tabby"),
                                  "tabby": create,
                                  "tabbies1": _match_cats("tabby")},
                                 [q.var("tabbies0"), q.var("tabby"),
                                  q.var("tabbies1")])
                else:
                    # obj/arr permutations exercise literal-evaluation
                    # order; our array form covers both
                    expr = [_match_cats("tabby"), create,
                            _match_cats("tabby")]
                t0, tabby, t1 = self.conn.query(expr)
                return {**op, "type": "ok",
                        "value": {"tabbies-0": t0, "tabby": tabby,
                                  "tabbies-1": t1}}
            # change-type (`internal.clj:124-133`)
            res = self.conn.query([
                q.let({"rs": _match_cats("tabby")},
                      q.when(q.non_empty(q.var("rs")),
                             q.update(q.ref(CATS_CLASS,
                                            q.select([0], q.var("rs"))),
                                      {"data": {"type": "calico"}}))),
                _match_cats("tabby"),
                _match_cats("calico")])
            return {**op, "type": "ok", "value": res}
        return with_errors(op, frozenset(), body, self._pause_s(test))


def internal_op_errors(op: dict) -> list:
    """Consistency errors within one op (`internal.clj:139-195`)."""
    v = op.get("value")
    f = op.get("f")
    errs = []
    if f in ("create-tabby-let", "create-tabby-obj", "create-tabby-arr"):
        name = ((v or {}).get("tabby") or {}).get("data", {}).get("name")
        if name is not None:
            if name in (v.get("tabbies-0") or []):
                errs.append({"type": "present-before-create",
                             "name": name, "op": op})
            if name not in (v.get("tabbies-1") or []):
                errs.append({"type": "missing-after-create",
                             "name": name, "op": op})
    elif f == "change-type":
        cat, tabbies, calicos = (v or [None, [], []])[:3]
        name = (cat or {}).get("data", {}).get("name") \
            if isinstance(cat, dict) else None
        if name is not None:
            if name in (tabbies or []):
                errs.append({"type": "present-after-change",
                             "name": name, "op": op})
            if name not in (calicos or []):
                errs.append({"type": "missing-after-change",
                             "name": name, "op": op})
    return errs


class InternalChecker(checker.Checker):
    def check(self, test, hist, opts):
        errors = [e for op in hist if op.get("type") == "ok"
                  for e in internal_op_errors(op)]
        return {"valid?": not errors,
                "error-count": len(errors),
                "error-types": sorted({e["type"] for e in errors}),
                "errors": errors}


def internal_workload(opts: dict) -> dict:
    ids = itertools.count()
    lock = threading.Lock()

    def next_id() -> int:
        with lock:
            return next(ids)

    def creator(f):
        def g(test, ctx):
            return {"type": "invoke", "f": f, "value": next_id()}
        return g

    return {
        "client": InternalClient(),
        "generator": gen.stagger(1 / 10, gen.mix([
            lambda test, ctx: {"type": "invoke", "f": "reset",
                               "value": None},
            lambda test, ctx: {"type": "invoke", "f": "change-type",
                               "value": None},
            creator("create-tabby-let"),
            creator("create-tabby-obj"),
            creator("create-tabby-arr")])),
        "checker": InternalChecker(),
    }


# ---------------------------------------------------------------------------
# Topology (`topology.clj`)
# ---------------------------------------------------------------------------

def replica_name(n: int) -> str:
    return f"replica-{n}"


def initial_topology(test: dict) -> dict:
    """{replica-count, nodes: [{node, state, replica}]}
    (`topology.clj:12-27`)."""
    replicas = test.get("replicas", 1)
    return {"replica-count": replicas,
            "nodes": [{"node": n, "state": "active",
                       "replica": replica_name(i % replicas)}
                      for i, n in enumerate(test["nodes"])]}


def get_node(topo: dict, name: str) -> dict | None:
    for n in topo["nodes"]:
        if n["node"] == name:
            return n
    return None


def only_active(topo: dict) -> dict:
    return {**topo, "nodes": [n for n in topo["nodes"]
                              if n["state"] == "active"]}


def replicas(topo: dict) -> list[str]:
    return [replica_name(i) for i in range(topo["replica-count"])]


def nodes_by_replica(topo: dict) -> dict[str, list[str]]:
    out: dict = {}
    for n in topo["nodes"]:
        out.setdefault(n["replica"], []).append(n["node"])
    return out


def add_ops(test: dict, topo: dict) -> list[dict]:
    """Every node we could add (`topology.clj:104-115`)."""
    active = [n["node"] for n in topo["nodes"]]
    if not active:
        return []
    return [{"type": "info", "f": "add-node",
             "value": {"node": n,
                       "join": active[gen.rng.randrange(len(active))]}}
            for n in set(test["nodes"]) - set(active)]


def remove_ops(test: dict, topo: dict) -> list[dict]:
    """Nodes removable without emptying a replica
    (`topology.clj:117-143`)."""
    topo = only_active(topo)
    candidates = [n for ns in nodes_by_replica(topo).values()
                  if len(ns) > 1 for n in ns]
    return [{"type": "info", "f": "remove-node", "value": n}
            for n in candidates]


def topo_ops(test: dict, topo: dict) -> list[dict]:
    return add_ops(test, topo) + remove_ops(test, topo)


def rand_topo_op(test: dict, topo: dict) -> dict | None:
    """A random transition, balanced across op *types*
    (`topology.clj:163-180`)."""
    groups = [g for g in (add_ops(test, topo), remove_ops(test, topo)) if g]
    if not groups:
        return None
    g = groups[gen.rng.randrange(len(groups))]
    return g[gen.rng.randrange(len(g))]


def apply_topo_op(topo: dict, op: dict) -> dict:
    """The topology resulting from a transition (`topology.clj:182-207`)."""
    f = op["f"]
    if f == "add-node":
        return {**topo,
                "nodes": topo["nodes"] + [{
                    "node": op["value"]["node"], "state": "active",
                    "replica": replica_name(
                        gen.rng.randrange(topo["replica-count"]))}]}
    if f == "remove-node":
        return {**topo,
                "nodes": [{**n, "state": "removing"}
                          if n["node"] == op["value"] else n
                          for n in topo["nodes"]]}
    raise ValueError(f"unknown topology op {f!r}")


# ---------------------------------------------------------------------------
# Nemesis (`nemesis.clj`)
# ---------------------------------------------------------------------------

def _topology(test: dict) -> dict:
    topo = test.get("topology")
    if topo is None:
        topo = {"value": initial_topology(test)}
        test["topology"] = topo
    return topo


def single_node_partition_start(test, ctx):
    """Isolate one node (`nemesis.clj:20-27`)."""
    grudge = npart.complete_grudge(npart.split_one(list(test["nodes"])))
    return {"type": "info", "f": "start-partition", "value": grudge,
            "partition-type": "single-node"}


def intra_replica_partition_start(test, ctx):
    """Split one replica internally (`nemesis.clj:29-40`)."""
    groups = list(nodes_by_replica(_topology(test)["value"]).items())
    replica, nodes = groups[gen.rng.randrange(len(groups))]
    nodes = list(nodes)
    gen.rng.shuffle(nodes)
    grudge = npart.complete_grudge(npart.bisect(nodes))
    return {"type": "info", "f": "start-partition", "value": grudge,
            "partition-type": ["intra-replica", replica]}


def inter_replica_partition_start(test, ctx):
    """Divide replicas from each other (`nemesis.clj:42-55`)."""
    groups = list(nodes_by_replica(_topology(test)["value"]).values())
    gen.rng.shuffle(groups)
    a, b = npart.bisect(groups)
    flat = ([n for g in a for n in g], [n for g in b for n in g])
    grudge = npart.complete_grudge(flat)
    return {"type": "info", "f": "start-partition", "value": grudge,
            "partition-type": "inter-replica"}


def topo_op_gen(test, ctx):
    """A random topology transition, or nothing when none is possible
    (`nemesis.clj:65-72`)."""
    return rand_topo_op(test, _topology(test)["value"])


class TopoNemesis(Nemesis):
    """Applies add-node / remove-node transitions through the cluster
    automation, then commits the new topology (`nemesis.clj:74-139`)."""

    def fs(self):
        return {"add-node", "remove-node"}

    def invoke(self, test, op):
        auto = test.get("fauna-auto") or FaunaAuto()
        topo = _topology(test)
        new = apply_topo_op(topo["value"], op)
        f, v = op["f"], op["value"]
        if f == "add-node":
            def act(t, node):
                auto.configure(t, new, node)
                if node == v["node"]:
                    auto.start(t, node)
                    auto.join(t, node, v["join"])
                return "configured"
            control.on_nodes(test, act,
                             [n["node"] for n in new["nodes"]])
            res = ["added", v]
        else:
            def kill(t, node):
                auto.kill(t, node)
                auto.delete_data_files(t, node)
                return "killed"
            control.on_nodes(test, kill, [v])
            others = [n["node"] for n in topo["value"]["nodes"]
                      if n["node"] != v]
            if others:
                def remove(t, node):
                    auto.remove_node(t, node, v)
                    return "removed"
                control.on_nodes(
                    test, remove,
                    [others[gen.rng.randrange(len(others))]])
            new = {**new, "nodes": [n for n in new["nodes"]
                                    if n["node"] != v]}
            res = ["removed", v]
        topo["value"] = new
        return {**op, "value": res}


class RestartStopKill(Nemesis):
    """start all / stop / kill a random subset (`nemesis.clj:141-161`)."""

    def fs(self):
        return {"restart", "stop", "kill"}

    def invoke(self, test, op):
        auto = test.get("fauna-auto") or FaunaAuto()
        nodes = [n["node"] for n in _topology(test)["value"]["nodes"]]
        if op["f"] in ("stop", "kill"):
            from ..nemesis import combined as ncomb
            nodes = ncomb.random_nonempty_subset(nodes)
        act = {"restart": auto.start, "stop": auto.stop,
               "kill": auto.kill}[op["f"]]

        def f(t, node):
            act(t, node)
            return op["f"]
        return {**op, "value": control.on_nodes(test, f, nodes)}


NEMESIS_SPECS = frozenset({
    "inter-replica-partition", "intra-replica-partition",
    "single-node-partition", "kill", "stop", "topology", "clock-skew"})


def full_nemesis() -> Nemesis:
    """Every fault mode in one composed nemesis (`nemesis.clj:172-186`)."""
    return n_compose([
        n_timeout(60_000, RestartStopKill()),
        n_fmap(lambda f: {"start": "start-partition",
                          "stop": "stop-partition"}.get(f, f),
               npart.partitioner()),
        TopoNemesis(),
        n_fmap(lambda f: {"reset": "reset-clock",
                          "strobe": "strobe-clock",
                          "check-offsets": "check-clock-offsets",
                          "bump": "bump-clock"}.get(f, f),
               ntime.clock_nemesis()),
    ])


def _op(f: str) -> dict:
    return {"type": "info", "f": f, "value": None}


def full_generator(n: dict, interval: float):
    """Mixed fault stream per the enabled specs
    (`nemesis.clj:205-233`)."""
    gens: list = []
    # a bare op dict is a ONE-SHOT generator: recurring fault streams
    # must cycle their op pairs, else each fault fires exactly once
    if n.get("kill"):
        gens.append(itertools.cycle([_op("kill"), _op("restart")]))
    if n.get("stop"):
        gens.append(itertools.cycle([_op("stop"), _op("restart")]))
    if n.get("inter-replica-partition"):
        gens += [inter_replica_partition_start,
                 itertools.cycle([_op("stop-partition")])]
    if n.get("intra-replica-partition"):
        gens += [intra_replica_partition_start,
                 itertools.cycle([_op("stop-partition")])]
    if n.get("single-node-partition"):
        gens += [single_node_partition_start,
                 itertools.cycle([_op("stop-partition")])]
    if n.get("clock-skew"):
        gens.append(gen.f_map(
            lambda f: {"reset": "reset-clock", "strobe": "strobe-clock",
                       "check-offsets": "check-clock-offsets",
                       "bump": "bump-clock"}.get(f, f),
            ntime.clock_gen()))
    if n.get("topology"):
        gens.append(topo_op_gen)
    if not gens:
        return None
    return gen.stagger(interval, gen.mix(gens))


def fauna_nemesis_package(opts: dict) -> dict:
    """{nemesis, generator, final-generator} (`nemesis.clj:235-249`)."""
    n = opts
    finals = []
    if n.get("clock-skew"):
        finals.append(_op("reset-clock"))
    if any(n.get(k) for k in ("inter-replica-partition",
                              "intra-replica-partition",
                              "single-node-partition")):
        finals.append(_op("stop-partition"))
    if n.get("stop") or n.get("kill"):
        finals.append(_op("restart"))
    return {"nemesis": full_nemesis(),
            "generator": full_generator(n, n.get("interval", 10)),
            "final-generator": gen.IterGen(iter(finals))
            if finals else None,
            "perf": [{"name": "partition", "fs": ["start-partition"],
                      "start": ["start-partition"],
                      "stop": ["stop-partition"]}]}


# ---------------------------------------------------------------------------
# Cluster automation (`auto.clj`)
# ---------------------------------------------------------------------------

LOG_DIR = "/var/log/faunadb"
DATA_DIR = "/var/lib/faunadb"
CONFIG = "/etc/faunadb.yml"


class FaunaAuto:
    """Install/configure/init/join over the control layer
    (`auto.clj:107-455`)."""

    def __init__(self, version: str = "2.5.5"):
        self.version = version

    def install(self, test, node):
        """apt repo + package (`auto.clj:379-414`)."""
        debian.install(["curl", "gnupg"])
        control.exec_("bash", "-c",
                      "curl -fsS https://repo.fauna.com/faunadb-gpg-public"
                      ".key | apt-key add -")
        cutil.write_file(
            "deb [arch=all] https://repo.fauna.com/debian stable non-free",
            "/etc/apt/sources.list.d/faunadb.list")
        debian.maybe_update()
        debian.install({"faunadb": self.version})

    def configure(self, test, topo, node):
        """Render /etc/faunadb.yml for this node's replica
        (`auto.clj:416-443`)."""
        me = get_node(topo, node) or {"replica": replica_name(0)}
        cfg = "\n".join([  # (`auto.clj:416-443` renders the same keys)
            "auth_root_key: " + ROOT_KEY,
            f"network_coordinator_http_address: {node}",
            f"network_broadcast_address: {node}",
            f"network_datacenter_name: {me['replica']}",
            f"network_host_id: {node}",
            f"network_listen_address: {node}",
            f"storage_data_path: {DATA_DIR}",
            "storage_transaction_log_nodes:",
            *[f"  - {ns}" for ns in
              [n["node"] for n in topo["nodes"]
               if n.get("state") == "active"]],
        ])
        control.util.write_file(cfg, CONFIG)

    def start(self, test, node):
        control.exec_("service", "faunadb", "start")

    def stop(self, test, node):
        control.exec_("service", "faunadb", "stop")

    def kill(self, test, node):
        control.exec_("bash", "-c",
                      "pkill -9 -f faunadb || true")

    def init(self, test, node):
        """First node initializes the cluster (`auto.clj:114-139`)."""
        control.exec_("faunadb-admin", "init")

    def join(self, test, node, target: str):
        control.exec_("faunadb-admin", "join", target)

    def remove_node(self, test, node, target: str):
        control.exec_("faunadb-admin", "remove", target)

    def status(self, test, node) -> str:
        return control.exec_("faunadb-admin", "status")

    def delete_data_files(self, test, node):
        control.exec_("bash", "-c", f"rm -rf {DATA_DIR}/*")


class FaunaDB(jdb.DB, jdb.Process, jdb.Primary, jdb.LogFiles):
    """DB lifecycle glue (`auto.clj:456-472`). nodes[0] always runs
    `faunadb-admin init`; everyone else synchronizes on the barrier and
    then joins it — init must not race the joins (`auto.clj:107-139`
    has init! and join! as distinct single-node steps)."""

    def __init__(self, auto: FaunaAuto | None = None):
        self.auto = auto or FaunaAuto()

    def setup(self, test, node):
        from .. import core
        test.setdefault("fauna-auto", self.auto)
        topo = _topology(test)["value"]
        self.auto.install(test, node)
        self.auto.configure(test, topo, node)
        self.auto.start(test, node)
        coordinator = test["nodes"][0]
        if node == coordinator:
            self.auto.init(test, node)
        core.synchronize(test)   # joiners wait for init to finish
        if node != coordinator:
            self.auto.join(test, node, coordinator)

    def teardown(self, test, node):
        self.auto.kill(test, node)
        self.auto.delete_data_files(test, node)

    def start(self, test, node):
        self.auto.start(test, node)

    def kill(self, test, node):
        self.auto.kill(test, node)

    def primaries(self, test):
        return [n["node"]
                for n in _topology(test)["value"]["nodes"][:1]]

    def log_files(self, test, node):
        return [f"{LOG_DIR}/core.log", f"{LOG_DIR}/query.log"]


# ---------------------------------------------------------------------------
# Runner (`runner.clj`)
# ---------------------------------------------------------------------------

WORKLOADS = {
    "register": register_workload,
    "bank": bank_workload,
    "bank-index": bank_index_workload,
    "g2": g2_workload,
    "set": set_workload,
    "pages": pages_workload,
    "monotonic": monotonic_workload,
    "multimonotonic": multimonotonic_workload,
    "internal": internal_workload,
}

WORKLOAD_OPTIONS = {
    "set": {"serialized-indices": [True, False],
            "strong-read": [True, False]},
    "bank": {"fixed-instances": [True, False],
             "at-query": [True, False]},
    "bank-index": {"fixed-instances": [True, False],
                   "serialized-indices": [True, False]},
    "g2": {"serialized-indices": [True, False]},
    "internal": {"serialized-indices": [True, False]},
    "monotonic": {"at-query-jitter": [0, 10000, 100000]},
    "multimonotonic": {},
    "pages": {"serialized-indices": [True, False]},
    "register": {},
}

WORKLOAD_OPTIONS_EXPECTED_TO_PASS = {
    **WORKLOAD_OPTIONS,
    "set": {"serialized-indices": [True], "strong-read": [True]},
    "g2": {"serialized-indices": [True]},
}


def all_combos(opts: dict) -> list[dict]:
    """Combinatorial expansion of option values (`runner.clj:67-79`)."""
    out = [{}]
    for k, vs in opts.items():
        out = [{**m, k: v} for m in out for v in vs]
    return out


def all_workload_options(workload_options: dict) -> list[dict]:
    return [{"workload": w, **combo}
            for w, opts in workload_options.items()
            for combo in all_combos(opts)]


ALL_NEMESES = [
    {},
    {"kill": True},
    {"stop": True},
    {"clock-skew": True},
    {"inter-replica-partition": True, "intra-replica-partition": True,
     "single-node-partition": True},
    {"inter-replica-partition": True, "intra-replica-partition": True,
     "single-node-partition": True, "clock-skew": True, "kill": True,
     "stop": True},
    {"topology": True},
]


def faunadb_test(opts: dict) -> dict:
    """Build the full test map (`runner.clj:126-220`)."""
    from .. import testkit

    workload_name = opts.get("workload", "register")
    time_limit = opts.get("time-limit", opts.get("time_limit", 60))
    nodes = opts.get("nodes") or ["n1", "n2", "n3", "n4", "n5"]
    opts = {**opts, "nodes": nodes}
    w = WORKLOADS[workload_name](opts)

    nem_opts = {f: True for f in (opts.get("nemesis") or [])}
    nem_opts["interval"] = opts.get("nemesis-interval", 10)
    pkg = fauna_nemesis_package(nem_opts)

    rate = float(opts.get("rate", 10))
    client_gen = gen.clients(gen.stagger(1 / rate, w["generator"]))
    main_gen = gen.time_limit(
        time_limit,
        gen.any(client_gen, gen.nemesis(pkg["generator"]))
        if pkg["generator"] is not None else client_gen)
    phases = [main_gen]
    if pkg["final-generator"] is not None:
        phases.append(gen.nemesis(pkg["final-generator"]))
    if w.get("final-generator") is not None:
        phases.append(gen.clients(w["final-generator"]))

    name = " ".join(
        ["fauna", workload_name]
        + [k for k in ("strong-read", "at-query", "fixed-instances")
           if opts.get(k)]
        + (["serialized"] if opts.get("serialized-indices") else []))
    test = {
        **testkit.noop_test(),
        **{k: v for k, v in opts.items() if isinstance(k, str)},
        "name": name,
        "os": debian.os,
        "db": FaunaDB(FaunaAuto(opts.get("version", "2.5.5"))),
        "replicas": opts.get("replicas", 1),
        "client": w["client"],
        "nemesis": pkg["nemesis"],
        "plot": {"nemeses": pkg.get("perf")},
        "generator": gen.phases(*phases) if len(phases) > 1 else main_gen,
        "checker": checker.compose({
            "perf": checker.perf_checker(),
            "workload": w["checker"],
            "stats": checker.stats(),
            "exceptions": checker.unhandled_exceptions(),
        }),
    }
    test["topology"] = {"value": initial_topology(test)}
    return test


OPT_SPEC = [
    cli.opt("--workload", "-w", default="register",
            choices=sorted(WORKLOADS), help="Which workload to run"),
    cli.opt("--rate", type=float, default=10,
            help="approximate op rate per second"),
    cli.opt("--nemesis", action="append",
            choices=sorted(NEMESIS_SPECS), help="fault types (repeatable)"),
    cli.opt("--nemesis-interval", type=float, default=10,
            help="seconds between nemesis operations"),
    cli.opt("--replicas", type=int, default=1,
            help="number of FaunaDB replicas (datacenters)"),
    cli.opt("--version", default="2.5.5", help="FaunaDB version"),
    cli.opt("--serialized-indices", action="store_true",
            help="make indexes serialized"),
    cli.opt("--strong-read", action="store_true",
            help="set workload: force strict-serializable reads"),
    cli.opt("--fixed-instances", action="store_true",
            help="bank: write zero balances instead of deleting"),
    cli.opt("--at-query", action="store_true",
            help="bank: read through temporal at-queries"),
]


def _all_tests(opts):
    """The full sweep: every workload-option combination expected to
    pass, crossed with every nemesis set (`runner.clj:215-231`
    all-tests over workload-options-expected-to-pass x all-nemeses)."""
    for nem in ALL_NEMESES:
        for combo in all_workload_options(
                WORKLOAD_OPTIONS_EXPECTED_TO_PASS):
            yield faunadb_test({**opts, **combo,
                                "nemesis": sorted(nem)})


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": faunadb_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.test_all_cmd({"tests_fn": _all_tests,
                                 "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
