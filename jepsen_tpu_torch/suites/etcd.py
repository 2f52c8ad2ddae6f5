"""etcd test suite — the canonical tutorial exemplar.

Mirrors the capabilities of the reference's etcd tutorial
(`doc/tutorial/01-scaffolding.md` … `08-set.md`): cluster install from a
release tarball, daemon lifecycle, a CAS-register client with careful
error/timeout classification, independent-key register and set
workloads, partition nemesis, and a CLI entry point. The client speaks
etcd v3's JSON gateway (`/v3/kv/{range,put,txn}`) over plain urllib —
no driver dependency; CAS is a server-side txn compare on value.
"""

from __future__ import annotations

import base64
import binascii
import itertools
import logging
import urllib.error
import urllib.request

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from .. import independent, nemesis as jnemesis, testkit
from ..checker import timeline
from ..control import util as cu
from ..nemesis import partition
from . import http_post
from ..os_ import debian
from ..workloads import linearizable_register

log = logging.getLogger(__name__)

DIR = "/opt/etcd"
BINARY = f"{DIR}/etcd"
LOGFILE = f"{DIR}/etcd.log"
PIDFILE = f"{DIR}/etcd.pid"
DATA_DIR = f"{DIR}/data"

CLIENT_PORT = 2379
PEER_PORT = 2380

DEFAULT_VERSION = "3.5.9"


def node_url(node: str, port: int) -> str:
    return f"http://{node}:{port}"


def peer_url(node: str) -> str:
    return node_url(node, PEER_PORT)


def client_url(node: str) -> str:
    return node_url(node, CLIENT_PORT)


def initial_cluster(test: dict) -> str:
    """n1=http://n1:2380,n2=... (tutorial 02-db.md)."""
    return ",".join(f"{n}={peer_url(n)}" for n in test["nodes"])


def tarball_url(version: str) -> str:
    return (f"https://github.com/etcd-io/etcd/releases/download/"
            f"v{version}/etcd-v{version}-linux-amd64.tar.gz")


class DB(jdb.DB, jdb.Process, jdb.Pause, jdb.Primary, jdb.LogFiles):
    """etcd cluster automation for a particular version."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def node_args(self, test, node):
        return [
            "--name", node,
            "--listen-peer-urls", node_url("0.0.0.0", PEER_PORT),
            "--listen-client-urls", node_url("0.0.0.0", CLIENT_PORT),
            "--advertise-client-urls", client_url(node),
            "--initial-cluster-state", "new",
            "--initial-advertise-peer-urls", peer_url(node),
            "--initial-cluster", initial_cluster(test),
            "--data-dir", DATA_DIR,
            "--snapshot-count", "100",
        ]

    def setup(self, test, node):
        with control.su():
            log.info("%s installing etcd %s", node, self.version)
            url = test.get("tarball") or tarball_url(self.version)
            cu.install_archive(url, DIR)
            self.start(test, node)
            cu.await_tcp_port(CLIENT_PORT)

    def teardown(self, test, node):
        log.info("%s tearing down etcd", node)
        with control.su():
            self.kill(test, node)
            control.exec_("rm", "-rf", DATA_DIR, LOGFILE, PIDFILE)

    def start(self, test, node):
        with control.su():
            cu.start_daemon(
                {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
                BINARY, *self.node_args(test, node))

    def kill(self, test, node):
        with control.su():
            cu.stop_daemon(PIDFILE, cmd="etcd")
            cu.grepkill("etcd")

    def pause(self, test, node):
        with control.su():
            cu.signal("etcd", "STOP")

    def resume(self, test, node):
        with control.su():
            cu.signal("etcd", "CONT")

    def primaries(self, test):
        """Nodes whose member id equals the cluster's leader id, per
        /v3/maintenance/status — asked from the control node."""
        out = []
        for node in test["nodes"]:
            try:
                s = http_post(client_url(node) + "/v3/maintenance/status",
                              {}, timeout=2)
                if s.get("leader") and \
                        s.get("header", {}).get("member_id") == s["leader"]:
                    out.append(node)
            except OSError:
                pass
        return out

    def setup_primary(self, test, node):
        pass

    def log_files(self, test, node):
        return [LOGFILE]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


# -- v3 JSON gateway client -------------------------------------------------

def b64(s) -> str:
    return base64.b64encode(str(s).encode()).decode()


def unb64(s: str) -> str:
    return base64.b64decode(s).decode()


class EtcdClient(jclient.Client):
    """CAS-register client over the v3 JSON gateway.

    Error classification follows the tutorial (06-refining.md): reads
    that fail are safe to call 'fail' (they didn't change anything);
    indeterminate write/cas errors become 'info'. Timeouts on reads →
    fail, on writes/cas → info.
    """

    def __init__(self, timeout_s: float = 5.0, url: str | None = None):
        self.timeout_s = timeout_s
        self.url = url

    def open(self, test, node):
        c = EtcdClient(self.timeout_s,
                       test.get("client-url-fn", client_url)(node))
        return c

    # single-key kv ops ----------------------------------------------------

    def read(self, k):
        r = http_post(self.url + "/v3/kv/range", {"key": b64(k)},
                      self.timeout_s)
        kvs = r.get("kvs") or []
        return unb64(kvs[0]["value"]) if kvs else None

    def write(self, k, v):
        http_post(self.url + "/v3/kv/put",
                  {"key": b64(k), "value": b64(v)}, self.timeout_s)

    def cas(self, k, old, new) -> bool:
        r = http_post(self.url + "/v3/kv/txn", {
            "compare": [{"key": b64(k), "target": "VALUE",
                         "result": "EQUAL", "value": b64(old)}],
            "success": [{"requestPut": {"key": b64(k),
                                        "value": b64(new)}}],
        }, self.timeout_s)
        return bool(r.get("succeeded"))

    def invoke(self, test, op):
        v = op.get("value")
        if independent.is_tuple(v):
            # independent-keyed ops arrive as (k, v) tuples
            k, inner = v

            def wrap(x):
                return independent.ktuple(k, x)
        else:
            k, inner = "r", v

            def wrap(x):
                return x
        if op["f"] not in ("read", "write", "cas"):
            raise ValueError(f"unknown f {op['f']!r}")
        definite_fail = (op["f"] == "read")
        try:
            if op["f"] == "read":
                val = self.read(k)
                val = int(val) if val is not None else None
                return {**op, "type": "ok", "value": wrap(val)}
            if op["f"] == "write":
                self.write(k, inner)
                return {**op, "type": "ok"}
            else:
                old, new = inner
                ok = self.cas(k, old, new)
                return {**op, "type": "ok" if ok else "fail"}
        except urllib.error.HTTPError as e:
            return {**op, "type": "fail" if definite_fail else "info",
                    "error": ["http", e.code]}
        except (urllib.error.URLError, OSError,
                binascii.Error, ValueError) as e:
            err = str(e)
            if "refused" in err:
                # connection refused: the request never started
                return {**op, "type": "fail", "error": "connection-refused"}
            return {**op, "type": "fail" if definite_fail else "info",
                    "error": ["indeterminate", err]}


class EtcdSetClient(EtcdClient):
    """Set workload client (tutorial 08-set.md): 'add' puts a unique
    key under a prefix; 'read' ranges over the prefix."""

    PREFIX = "set/"

    def open(self, test, node):
        return EtcdSetClient(self.timeout_s,
                             test.get("client-url-fn", client_url)(node))

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                self.write(self.PREFIX + str(op["value"]), op["value"])
                return {**op, "type": "ok"}
            if op["f"] == "read":
                r = http_post(self.url + "/v3/kv/range", {
                    "key": b64(self.PREFIX),
                    "range_end": b64(self.PREFIX + "\xff"),
                }, self.timeout_s)
                vals = sorted(int(unb64(kv["value"]))
                              for kv in r.get("kvs") or [])
                return {**op, "type": "ok", "value": vals}
            raise ValueError(f"unknown f {op['f']!r}")
        except urllib.error.HTTPError as e:
            return {**op, "type": "fail" if op["f"] == "read" else "info",
                    "error": ["http", e.code]}
        except (urllib.error.URLError, OSError) as e:
            return {**op,
                    "type": "fail" if op["f"] == "read" else "info",
                    "error": ["indeterminate", str(e)]}


# -- workloads --------------------------------------------------------------

def register_workload(opts: dict) -> dict:
    """Independent linearizable CAS registers, checked on device
    (tutorial 07-parameters.md shape)."""
    w = linearizable_register.test({
        "nodes": opts["nodes"],
        "per-key-limit": opts.get("ops-per-key", 100),
        "device": opts.get("device"),
    })
    w["client"] = EtcdClient()
    return w


def set_workload(opts: dict) -> dict:
    """Grow-only set via unique keys (tutorial 08-set.md)."""
    adds = ({"type": "invoke", "f": "add", "value": i}
            for i in itertools.count())
    return {
        "client": EtcdSetClient(),
        "checker": checker.set_checker(),
        "generator": adds,
        "final-generator": gen.each_thread(gen.once(
            {"type": "invoke", "f": "read", "value": None})),
    }


WORKLOADS = {
    "register": register_workload,
    "set": set_workload,
}


def etcd_test(opts: dict) -> dict:
    """Construct a test map from CLI options (tutorial 01-scaffolding
    through 07-parameters)."""
    workload_name = opts.get("workload", "register")
    workload = WORKLOADS[workload_name](opts)
    nemesis = partition.partition_random_halves() \
        if opts.get("nemesis", "partition") == "partition" \
        else jnemesis.noop
    rate = float(opts.get("rate", 10))
    time_limit = opts.get("time-limit", opts.get("time_limit", 60))

    main_gen = gen.nemesis(
        gen.cycle(gen.phases(
            gen.sleep(5),
            gen.once({"type": "info", "f": "start", "value": None}),
            gen.sleep(5),
            gen.once({"type": "info", "f": "stop", "value": None}))),
        gen.stagger(1 / rate, workload["generator"]))
    main_gen = gen.time_limit(time_limit, main_gen)
    final = workload.get("final-generator")
    generator = gen.phases(
        main_gen,
        gen.nemesis(gen.once({"type": "info", "f": "stop", "value": None})),
        gen.clients(final)) if final else main_gen

    return {
        **testkit.noop_test(),
        **{k: v for k, v in opts.items() if isinstance(k, str)},
        "name": f"etcd-{workload_name}",
        "os": debian.os,
        "db": db(opts.get("version", DEFAULT_VERSION)),
        "client": workload["client"],
        "nemesis": nemesis,
        "generator": generator,
        "checker": checker.compose({
            "perf": checker.perf_checker(),
            "timeline": timeline.html(),
            "workload": workload["checker"],
            "stats": checker.stats(),
            "exceptions": checker.unhandled_exceptions(),
        }),
    }


OPT_SPEC = [
    cli.opt("--workload", "-w", default="register",
            choices=sorted(WORKLOADS),
            help="Which workload to run"),
    cli.opt("--version", default=DEFAULT_VERSION,
            help="etcd version to install"),
    cli.opt("--rate", type=float, default=10,
            help="approximate op rate per second"),
    cli.opt("--ops-per-key", type=int, default=100,
            help="ops per independent key (register workload)"),
    cli.opt("--nemesis", default="partition",
            choices=["partition", "none"], help="fault to inject"),
]


def main(argv=None):
    """CLI entry: run an etcd test or serve the store
    (zookeeper.clj:131-137 shape)."""
    cli.run({**cli.single_test_cmd({"test_fn": etcd_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
