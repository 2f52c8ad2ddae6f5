"""Consul test suite: a CAS register over the HTTP KV store.

Mirrors the reference's consul suite (`consul/src/jepsen/consul/
{db,client,register}.clj`): single-binary install, bootstrap-mode
primary with retry-join followers, and a KV client whose CAS is
*index*-based — consul has no value CAS, so the client reads the key's
ModifyIndex and conditions the write on it (`client.clj:66-80`),
classifying errors with the usual read-fail/write-info discipline.
"""

from __future__ import annotations

import base64
import json
import logging
import urllib.error
import urllib.request

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from .. import models, testkit
from ..checker import timeline
from ..control import util as cu
from ..nemesis import partition
from ..os_ import debian

log = logging.getLogger(__name__)

DIR = "/opt/consul"
BINARY = f"{DIR}/consul"
PIDFILE = f"{DIR}/consul.pid"
LOGFILE = f"{DIR}/consul.log"
DATA_DIR = f"{DIR}/data"
HTTP_PORT = 8500

DEFAULT_VERSION = "1.17.0"


def zip_url(version: str) -> str:
    return (f"https://releases.hashicorp.com/consul/{version}/"
            f"consul_{version}_linux_amd64.zip")


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Single-binary consul cluster: first node bootstraps, the rest
    retry-join it (`consul/db.clj:23-51`)."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing consul %s", node, self.version)
            cu.install_archive(test.get("tarball")
                               or zip_url(self.version), DIR)
            self.start(test, node)
            cu.await_tcp_port(HTTP_PORT)

    def start(self, test, node):
        primary = test["nodes"][0]
        args = ["agent", "-server", "-log-level", "debug",
                "-client", "0.0.0.0", "-bind", node,
                "-data-dir", DATA_DIR, "-node", node,
                "-retry-interval", "5s"]
        if node == primary:
            args.append("-bootstrap")
        else:
            args += ["-retry-join", primary]
        with control.su():
            cu.start_daemon({"logfile": LOGFILE, "pidfile": PIDFILE,
                             "chdir": DIR}, BINARY, *args)

    def kill(self, test, node):
        with control.su():
            cu.stop_daemon(PIDFILE, cmd="consul")
            cu.grepkill("consul")

    def teardown(self, test, node):
        with control.su():
            self.kill(test, node)
            control.exec_("rm", "-rf", DATA_DIR, LOGFILE, PIDFILE)

    def log_files(self, test, node):
        return [LOGFILE]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


class ConsulClient(jclient.Client):
    """CAS register over /v1/kv. Reads parse the base64 Value and
    ModifyIndex; CAS conditions a PUT on ?cas=<index>
    (`consul/client.clj`)."""

    KEY = "jepsen"

    def __init__(self, timeout_s: float = 5.0, url: str | None = None):
        self.timeout_s = timeout_s
        self.url = url

    def open(self, test, node):
        url = test.get("consul-url-fn",
                       lambda n: f"http://{n}:{HTTP_PORT}")(node)
        return ConsulClient(self.timeout_s, url)

    def _kv(self, params: str = "") -> str:
        return f"{self.url}/v1/kv/{self.KEY}{params}"

    def get(self):
        """-> (value | None, modify_index)."""
        try:
            with urllib.request.urlopen(self._kv(),
                                        timeout=self.timeout_s) as r:
                body = json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None, 0
            raise
        ent = body[0]
        raw = ent.get("Value")
        val = int(base64.b64decode(raw)) if raw is not None else None
        return val, ent["ModifyIndex"]

    def put(self, value, cas_index: int | None = None) -> bool:
        params = f"?cas={cas_index}" if cas_index is not None else ""
        req = urllib.request.Request(self._kv(params),
                                     data=str(value).encode(),
                                     method="PUT")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return r.read().strip() == b"true"

    def invoke(self, test, op):
        f = op["f"]
        if f not in ("read", "write", "cas"):
            raise ValueError(f"unknown f {f!r}")
        try:
            if f == "read":
                val, _ = self.get()
                return {**op, "type": "ok", "value": val}
            if f == "write":
                ok = self.put(op["value"])
                return {**op, "type": "ok" if ok else "fail"}
            old, new = op["value"]
            val, index = self.get()
            if val != old:
                return {**op, "type": "fail"}
            ok = self.put(new, cas_index=index)
            return {**op, "type": "ok" if ok else "fail"}
        except urllib.error.HTTPError as e:
            return {**op, "type": "fail" if f == "read" else "info",
                    "error": ["http", e.code]}
        except (urllib.error.URLError, OSError, ValueError) as e:
            if "refused" in str(e):
                return {**op, "type": "fail",
                        "error": "connection-refused"}
            return {**op, "type": "fail" if f == "read" else "info",
                    "error": ["indeterminate", str(e)]}


def r(test, ctx):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, ctx):
    return {"type": "invoke", "f": "write", "value": gen.rng.randrange(5)}


def cas(test, ctx):
    return {"type": "invoke", "f": "cas",
            "value": [gen.rng.randrange(5), gen.rng.randrange(5)]}


def consul_test(opts: dict) -> dict:
    """Register test over consul KV (`consul/register.clj`)."""
    time_limit = opts.get("time-limit", opts.get("time_limit", 60))
    rate = float(opts.get("rate", 10))
    return {
        **testkit.noop_test(),
        **{k: v for k, v in opts.items() if isinstance(k, str)},
        "name": "consul",
        "os": debian.os,
        "db": db(opts.get("version", DEFAULT_VERSION)),
        "client": ConsulClient(),
        "nemesis": partition.partition_random_halves(),
        "generator": gen.time_limit(time_limit, gen.nemesis(
            gen.cycle(gen.phases(
                gen.sleep(5),
                gen.once({"type": "info", "f": "start", "value": None}),
                gen.sleep(5),
                gen.once({"type": "info", "f": "stop", "value": None}))),
            gen.stagger(1 / rate, gen.mix([r, w, cas])))),
        "checker": checker.compose({
            "linear": checker.linearizable(models.cas_register(),
                                           device=opts.get("device")),
            "timeline": timeline.html(),
            "perf": checker.perf_checker(),
        }),
    }


OPT_SPEC = [
    cli.opt("--version", default=DEFAULT_VERSION,
            help="Consul version to install"),
    cli.opt("--rate", type=float, default=10,
            help="approximate ops per second"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": consul_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
