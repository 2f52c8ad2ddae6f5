"""Elasticsearch test suite — lost-update set tests over the REST API.

Mirrors Jepsen's `elasticsearch/src/jepsen/elasticsearch/`:
deb install with unicast discovery zen config, and two set
implementations (`sets.clj:40-180`):

  * create-set: every add creates an independent document; the final
    read flushes and scrolls the whole index — lost documents are lost
    inserts.
  * cas-set: one document holding the whole set, updated with MVCC
    version preconditions — version conflicts are definite fails.

Where the reference speaks the Java transport client, this suite uses
the REST API (the same surface ES ships for every other language).
Hermetic tests run against `tests/fake_es_ignite.py`."""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from ..control import util as cu
from ..control.core import RemoteError
from ..os_ import debian
from . import std_opts, std_test

log = logging.getLogger(__name__)

PORT = 9200
INDEX = "jepsen-index"
DEFAULT_VERSION = "1.5.0"

ES_CONF = """\
cluster.name: jepsen
node.name: {node}
network.host: 0.0.0.0
discovery.zen.ping.multicast.enabled: false
discovery.zen.ping.unicast.hosts: [{hosts}]
discovery.zen.minimum_master_nodes: {quorum}
"""


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    """deb install + unicast discovery (`core.clj:150-260`)."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        debian.install_jdk11()
        with control.su():
            url = test.get("deb-url") or (
                "https://download.elastic.co/elasticsearch/"
                f"elasticsearch/elasticsearch-{self.version}.deb")
            control.exec_("dpkg", "-i", "--force-confnew",
                          cu.cached_wget(url))
            hosts = ", ".join(f'"{n}"' for n in test["nodes"])
            cu.write_file(ES_CONF.format(
                node=node, hosts=hosts,
                quorum=len(test["nodes"]) // 2 + 1),
                "/etc/elasticsearch/elasticsearch.yml")
            self.start(test, node)
            cu.await_tcp_port(PORT)

    def start(self, test, node):
        with control.su():
            control.exec_("service", "elasticsearch", "start")

    def kill(self, test, node):
        with control.su():
            try:
                control.exec_("service", "elasticsearch", "stop")
            except RemoteError:
                pass
            cu.grepkill("elasticsearch")

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            try:
                control.exec_("rm", "-rf",
                              "/var/lib/elasticsearch/jepsen")
            except RemoteError:
                pass

    def log_files(self, test, node):
        return ["/var/log/elasticsearch/jepsen.log"]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


class ESClient(jclient.Client):
    def __init__(self, timeout_s: float = 5.0):
        self.timeout_s = timeout_s
        self.base: str | None = None

    def open(self, test, node):
        c = type(self)(self.timeout_s)
        fn = test.get("es-url-fn")
        c.base = fn(node) if fn else f"http://{node}:{PORT}"
        return c

    def _req(self, method: str, path: str, body=None,
             ok_statuses=(200, 201)):
        # str bodies go raw (ES 1.x scroll continuation takes the bare
        # scroll id, not JSON — JSON bodies arrived in ES 2.0)
        data = None
        if body is not None:
            data = body.encode() if isinstance(body, str) \
                else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")


class CreateSetClient(ESClient):
    """Each add is an independent document (`sets.clj:40-95`)."""

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                status, _ = self._req(
                    "POST", f"/{INDEX}/number",
                    {"num": op["value"]})
                if status in (200, 201):
                    return {**op, "type": "ok"}
                return {**op, "type": "info", "error": status}
            if op["f"] == "read":
                # flush, then scroll the WHOLE index: one bounded
                # search would silently truncate past its size cap
                self._req("POST", f"/{INDEX}/_flush")
                status, out = self._req(
                    "GET", f"/{INDEX}/_search?scroll=10s&size=1000",
                    {"query": {"match_all": {}}})
                if status != 200:
                    return {**op, "type": "fail", "error": status}
                vals = []
                while True:
                    hits = out.get("hits", {}).get("hits", [])
                    if not hits:
                        break
                    vals.extend(h["_source"]["num"] for h in hits)
                    sid = out.get("_scroll_id")
                    if sid is None:
                        break
                    status, out = self._req(
                        "POST", "/_search/scroll?scroll=10s", sid)
                    if status != 200:
                        return {**op, "type": "fail", "error": status}
                return {**op, "type": "ok", "value": sorted(vals)}
            raise ValueError(f"unknown f {op['f']!r}")
        except (OSError, KeyError) as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)}


class CASSetClient(ESClient):
    """One document holding the set, updated with MVCC version
    preconditions (`sets.clj:95-180`)."""

    DOC = "0"

    def setup(self, test):
        self._req("PUT", f"/{INDEX}/cas/{self.DOC}?op_type=create",
                  {"values": []})

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                status, cur = self._req("GET",
                                        f"/{INDEX}/cas/{self.DOC}")
                if status != 200 or not cur.get("found", True):
                    return {**op, "type": "fail",
                            "error": "no-current-doc"}
                version = cur["_version"]
                values = cur["_source"]["values"] + [op["value"]]
                status, _ = self._req(
                    "PUT", f"/{INDEX}/cas/{self.DOC}?version={version}",
                    {"values": values})
                if status in (200, 201):
                    return {**op, "type": "ok"}
                if status == 409:   # version conflict: definitely lost
                    return {**op, "type": "fail", "error": "conflict"}
                return {**op, "type": "info", "error": status}
            if op["f"] == "read":
                status, cur = self._req("GET",
                                        f"/{INDEX}/cas/{self.DOC}")
                if status != 200:
                    return {**op, "type": "fail", "error": status}
                return {**op, "type": "ok",
                        "value": sorted(cur["_source"]["values"])}
            raise ValueError(f"unknown f {op['f']!r}")
        except (OSError, KeyError) as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)}


def _set_workload(client) -> dict:
    from .. import generator as gen
    import itertools

    values = itertools.count()

    def add(test, ctx):
        return {"type": "invoke", "f": "add", "value": next(values)}

    return {
        "client": client,
        "generator": add,
        "checker": checker.set_checker(),
        "final-generator": gen.each_thread(gen.once(
            {"type": "invoke", "f": "read", "value": None})),
    }


WORKLOADS = {
    "create-set": lambda opts: _set_workload(CreateSetClient()),
    "cas-set": lambda opts: _set_workload(CASSetClient()),
}


def elasticsearch_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "create-set")
    return std_test(
        opts, name=f"elasticsearch-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "create-set", DEFAULT_VERSION,
                    "elasticsearch deb version")


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": elasticsearch_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
