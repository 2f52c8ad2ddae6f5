"""CrateDB test suite — dirty reads, lost updates, and version
divergence over the HTTP `_sql` endpoint.

Mirrors Jepsen's `crate/src/jepsen/crate/`:

  * dirty-read (`dirty_read.clj`): writers keep one in-flight insert
    per node while readers chase it; a final strong read per thread
    feeds the set-algebra checker (reads of rows no strong read ever
    saw are dirty; acknowledged writes no strong read saw are lost).
  * lost-updates (`lost_updates.clj`): per-key JSON-array sets updated
    with `_version` preconditions; zero-row updates are definite
    fails.
  * version-divergence (`version_divergence.clj`): every read returns
    (value, _version); the multiversion checker requires each _version
    of a row to name exactly one value.

Where the reference drives Crate's shaded JDBC/PSQL driver, this port
speaks the HTTP `_sql` endpoint ({"stmt": ..., "args": [...]}) —
Crate's own first-class API. Hermetic tests run against
`tests/fake_crate.py`."""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request

from .. import checker, cli, client as jclient, control, independent
from .. import db as jdb
from .. import generator as gen
from ..control import util as cu
from ..control.core import RemoteError
from ..os_ import debian
from . import std_opts, std_test

log = logging.getLogger(__name__)

HTTP_PORT = 4200
DEFAULT_VERSION = "0.54.9"

CRATE_YML = """\
cluster.name: jepsen
node.name: {node}
network.host: 0.0.0.0
discovery.zen.ping.multicast.enabled: false
discovery.zen.ping.unicast.hosts: [{hosts}]
discovery.zen.minimum_master_nodes: {quorum}
"""


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        debian.install_jdk11()
        with control.su():
            url = test.get("tarball") or (
                "https://cdn.crate.io/downloads/releases/"
                f"crate-{self.version}.tar.gz")
            cu.install_archive(url, "/opt/crate")
            hosts = ", ".join(f'"{n}"' for n in test["nodes"])
            cu.write_file(CRATE_YML.format(
                node=node, hosts=hosts,
                quorum=len(test["nodes"]) // 2 + 1),
                "/opt/crate/config/crate.yml")
            cu.start_daemon(
                {"logfile": "/opt/crate/crate.log",
                 "pidfile": "/opt/crate/crate.pid",
                 "chdir": "/opt/crate"},
                "/opt/crate/bin/crate")
            cu.await_tcp_port(HTTP_PORT)

    def start(self, test, node):
        with control.su():
            cu.start_daemon(
                {"logfile": "/opt/crate/crate.log",
                 "pidfile": "/opt/crate/crate.pid",
                 "chdir": "/opt/crate"},
                "/opt/crate/bin/crate")

    def kill(self, test, node):
        with control.su():
            cu.stop_daemon("/opt/crate/crate.pid", cmd="crate")
            cu.grepkill("crate")

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            try:
                control.exec_("rm", "-rf", "/opt/crate/data")
            except RemoteError:
                pass

    def log_files(self, test, node):
        return ["/opt/crate/crate.log"]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


class CrateError(Exception):
    def __init__(self, code, message):
        super().__init__(f"crate error {code}: {message}")
        self.code = code


class SQLClient(jclient.Client):
    """_sql endpoint client; rows come back as arrays."""

    def __init__(self, timeout_s: float = 5.0):
        self.timeout_s = timeout_s
        self.base: str | None = None

    def open(self, test, node):
        c = type(self)(self.timeout_s)
        fn = test.get("crate-url-fn")
        c.base = fn(node) if fn else f"http://{node}:{HTTP_PORT}"
        c.on_open(test, node)
        return c

    def on_open(self, test, node):
        pass

    def sql(self, stmt: str, *args):
        req = urllib.request.Request(
            self.base + "/_sql",
            data=json.dumps({"stmt": stmt, "args": list(args)}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            body = json.loads(e.read() or b"{}")
            err = body.get("error", {})
            raise CrateError(err.get("code", e.code),
                             err.get("message", "sql error")) from e


# -- dirty read (`dirty_read.clj`) -------------------------------------------

class DirtyReadClient(SQLClient):
    def on_open(self, test, node):
        try:
            self.sql("create table if not exists dirty_read "
                     "(id integer primary key)")
        except CrateError:
            pass

    def invoke(self, test, op):
        try:
            if op["f"] == "write":
                self.sql("insert into dirty_read (id) values (?)",
                         op["value"])
                return {**op, "type": "ok"}
            if op["f"] == "read":
                res = self.sql(
                    "select id from dirty_read where id = ?",
                    op["value"])
                found = bool(res.get("rows"))
                return {**op, "type": "ok" if found else "fail"}
            if op["f"] == "strong-read":
                self.sql("refresh table dirty_read")
                res = self.sql("select id from dirty_read")
                return {**op, "type": "ok",
                        "value": sorted(r[0] for r in res["rows"])}
            raise ValueError(f"unknown f {op['f']!r}")
        except (CrateError, OSError) as e:
            t = "fail" if op["f"] != "write" else "info"
            return {**op, "type": t, "error": str(e)}


class DirtyReadChecker(checker.Checker):
    """Set algebra over reads vs per-thread strong reads
    (`dirty_read.clj:143-193`)."""

    def check(self, test, hist, opts):
        writes, reads, strong = set(), set(), []
        for o in hist:
            if o.get("type") != "ok":
                continue
            if o["f"] == "write":
                writes.add(o["value"])
            elif o["f"] == "read":
                reads.add(o["value"])
            elif o["f"] == "strong-read":
                strong.append(set(o["value"]))
        if not strong:
            return {"valid?": "unknown",
                    "error": "no strong reads completed"}
        on_all = set.intersection(*strong)
        on_some = set.union(*strong)
        dirty = reads - on_some
        lost = writes - on_some
        return {
            "valid?": (on_all == on_some and not dirty and not lost),
            "nodes-agree?": on_all == on_some,
            "read-count": len(reads),
            "on-all-count": len(on_all),
            "on-some-count": len(on_some),
            "not-on-all": sorted(on_some - on_all)[:32],
            "dirty": sorted(dirty)[:32],
            "lost": sorted(lost)[:32],
            "some-lost": sorted(writes - on_all)[:32],
        }


class RWGen(gen.Gen):
    """The first `w` threads write fresh values, recording the last
    in-flight write per node; the rest read their node's in-flight
    value (`dirty_read.clj:195-226`)."""

    def __init__(self, w: int, state=None):
        self.w = w
        self.state = state or {"write": -1, "in_flight": {}}

    def op(self, test, ctx):
        p = gen.some_free_process(ctx)
        if p is None:
            return gen.PENDING, self
        n_nodes = len(test["nodes"])
        # crashed processes are replaced with higher ids: route by the
        # stable THREAD, as the reference does (`dirty_read.clj:216`)
        thread = gen.process_to_thread(ctx, p)
        thread = thread if isinstance(thread, int) else 0
        node_ix = thread % n_nodes
        if thread < self.w:
            self.state["write"] += 1
            v = self.state["write"]
            self.state["in_flight"][node_ix] = v
            o = {"type": "invoke", "f": "write", "value": v,
                 "process": p, "time": ctx.time}
        else:
            v = self.state["in_flight"].get(node_ix, 0)
            o = {"type": "invoke", "f": "read", "value": v,
                 "process": p, "time": ctx.time}
        return o, RWGen(self.w, self.state)


def dirty_read_workload(opts) -> dict:
    return {
        "client": DirtyReadClient(),
        "generator": RWGen(opts.get("writers", 2)),
        "checker": DirtyReadChecker(),
        "final-generator": gen.each_thread(gen.once(
            {"type": "invoke", "f": "strong-read", "value": None})),
    }


# -- lost updates (`lost_updates.clj`) ---------------------------------------

class LostUpdatesClient(SQLClient):
    def on_open(self, test, node):
        try:
            self.sql("create table if not exists sets "
                     "(id integer primary key, elements string)")
        except CrateError:
            pass

    def invoke(self, test, op):
        k, v = op["value"]
        try:
            if op["f"] == "read":
                res = self.sql(
                    "select elements from sets where id = ?", k)
                rows = res.get("rows")
                els = sorted(json.loads(rows[0][0])) if rows else []
                return {**op, "type": "ok",
                        "value": independent.ktuple(k, els)}
            if op["f"] == "add":
                res = self.sql(
                    "select elements, _version from sets where id = ?",
                    k)
                rows = res.get("rows")
                if rows:
                    els = json.loads(rows[0][0])
                    version = rows[0][1]
                    res = self.sql(
                        "update sets set elements = ? "
                        "where id = ? and _version = ?",
                        json.dumps(els + [v]), k, version)
                    if res.get("rowcount", 0) == 1:
                        return {**op, "type": "ok"}
                    return {**op, "type": "fail",
                            "error": "version-conflict"}
                self.sql("insert into sets (id, elements) "
                         "values (?, ?)", k, json.dumps([v]))
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except (CrateError, OSError) as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)}


def lost_updates_workload(opts) -> dict:
    import itertools

    counters: dict = {}

    def add(test, ctx):
        k = gen.rng.randrange(8)
        c = counters.setdefault(k, itertools.count())
        return {"type": "invoke", "f": "add",
                "value": independent.ktuple(k, next(c))}

    def final(test, ctx):
        return independent.sequential_generator(
            range(8), lambda k: gen.once(
                {"type": "invoke", "f": "read", "value": None}))

    return {
        "client": LostUpdatesClient(),
        "generator": add,
        "checker": independent.checker(checker.set_checker()),
        "final-generator": gen.derefer(final),
    }


# -- version divergence (`version_divergence.clj`) ---------------------------

class VersionDivergenceClient(SQLClient):
    def on_open(self, test, node):
        try:
            self.sql("create table if not exists registers "
                     "(id integer primary key, value integer)")
        except CrateError:
            pass

    def invoke(self, test, op):
        try:
            if op["f"] == "read":
                res = self.sql(
                    "select value, _version from registers "
                    "where id = 0")
                rows = res.get("rows")
                if not rows:
                    return {**op, "type": "ok", "value": None}
                return {**op, "type": "ok",
                        "value": [rows[0][0], rows[0][1]]}
            if op["f"] == "write":
                res = self.sql(
                    "update registers set value = ? where id = ?",
                    op["value"], 0)
                if res.get("rowcount", 0) == 0:
                    self.sql("insert into registers (id, value) "
                             "values (?, ?)", 0, op["value"])
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except (CrateError, OSError) as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)}


class MultiVersionChecker(checker.Checker):
    """Each _version of the row must name exactly one value
    (`version_divergence.clj:94-108`)."""

    def check(self, test, hist, opts):
        by_version: dict = {}
        for o in hist:
            if o.get("type") == "ok" and o.get("f") == "read" \
                    and o.get("value"):
                value, version = o["value"]
                by_version.setdefault(version, set()).add(value)
        divergent = {v: sorted(vals) for v, vals in by_version.items()
                     if len(vals) > 1}
        return {"valid?": not divergent,
                "versions-read": len(by_version),
                "divergent": divergent}


def version_divergence_workload(opts) -> dict:
    import itertools

    values = itertools.count()

    def w(test, ctx):
        return {"type": "invoke", "f": "write", "value": next(values)}

    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    return {
        "client": VersionDivergenceClient(),
        "generator": gen.mix([w, r, r]),
        "checker": MultiVersionChecker(),
    }


WORKLOADS = {
    "dirty-read": dirty_read_workload,
    "lost-updates": lost_updates_workload,
    "version-divergence": version_divergence_workload,
}


def crate_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "lost-updates")
    return std_test(
        opts, name=f"crate-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "lost-updates", DEFAULT_VERSION,
                    "CrateDB tarball version") + [
    cli.opt("--writers", type=int, default=2,
            help="writer threads for the dirty-read workload"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": crate_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
