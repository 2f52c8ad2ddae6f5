"""Raftis test suite — a linearizable register over redis+raft.

Mirrors the reference's raftis suite
(Jepsen's `raftis/src/jepsen/raftis.clj`): a single GET/SET
register at key "r" (`:38-48`), error classification where no-leader
and socket-closed writes are definite fails and other write errors are
indeterminate (`:46-59`), knossos-linearizable checking + timeline.
The register has no CAS, so the model is a plain read/write register —
checked on device with the 'register' kernel.

The client speaks RESP (`resp_proto.py`); hermetic tests run against an
in-process fake redis (tests/fake_resp.py)."""

from __future__ import annotations

import logging

from .. import cli, client as jclient, control, models
from .. import db as jdb
from .. import generator as gen
from ..checker import linear
from ..control import util as cu
from . import std_opts, std_test
from .resp_proto import Conn, RESPError

log = logging.getLogger(__name__)

DIR = "/opt/raftis"
LOGFILE = f"{DIR}/raftis.log"
PIDFILE = f"{DIR}/raftis.pid"
BINARY = "raftis"
CLIENT_PORT = 6379
RAFT_PORT = 8901

DEFAULT_VERSION = "latest"


def initial_cluster(test: dict) -> str:
    """n1:8901,n2:8901,... (`raftis.clj:70-77`)."""
    return ",".join(f"{n}:{RAFT_PORT}" for n in test["nodes"])


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing raftis %s", node, self.version)
            tarball = test.get("tarball")
            if tarball:
                cu.install_archive(tarball, DIR)
            control.exec_("mkdir", "-p", f"{DIR}/data")
            self.start(test, node)
            cu.await_tcp_port(CLIENT_PORT)

    def start(self, test, node):
        i = test["nodes"].index(node)
        with control.su():
            cu.start_daemon(
                {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
                f"{DIR}/{BINARY}",
                "-addr", f"{node}:{CLIENT_PORT}",
                "-raft", f"{node}:{RAFT_PORT}",
                "-id", str(i),
                "-cluster", initial_cluster(test))

    def kill(self, test, node):
        with control.su():
            cu.stop_daemon(PIDFILE, cmd=BINARY)
            cu.grepkill(BINARY)

    def teardown(self, test, node):
        with control.su():
            self.kill(test, node)
            control.exec_("rm", "-rf", f"{DIR}/data", LOGFILE, PIDFILE)

    def log_files(self, test, node):
        return [LOGFILE]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


def _connect(test, node) -> Conn:
    fn = test.get("resp-conn-fn")
    if fn is not None:
        return fn(node)
    return Conn(node, CLIENT_PORT)


class RegisterClient(jclient.Client):
    """GET/SET on key "r" with the reference's error classification
    (`raftis.clj:38-59`)."""

    KEY = "r"

    def __init__(self):
        self.conn: Conn | None = None

    def open(self, test, node):
        c = RegisterClient()
        c.conn = _connect(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def invoke(self, test, op):
        try:
            if op["f"] == "read":
                v = self.conn.call("GET", self.KEY)
                return {**op, "type": "ok",
                        "value": int(v) if v is not None else None}
            if op["f"] == "write":
                self.conn.call("SET", self.KEY, op["value"])
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except RESPError as e:
            msg = str(e)
            definite = op["f"] == "read" or "no leader" in msg \
                or "socket closed" in msg
            return {**op, "type": "fail" if definite else "info",
                    "error": msg}
        except OSError as e:
            return {**op,
                    "type": "fail" if op["f"] == "read" else "info",
                    "error": str(e)}


def register_workload(opts: dict) -> dict:
    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def w(test, ctx):
        return {"type": "invoke", "f": "write",
                "value": gen.rng.randrange(5)}

    return {
        "client": RegisterClient(),
        "generator": gen.mix([r, w]),
        "checker": linear.linearizable(models.register(),
                                       device=opts.get("device")),
    }


WORKLOADS = {"register": register_workload}


def raftis_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "register")
    return std_test(
        opts, name=f"raftis-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "register", DEFAULT_VERSION,
                    "raftis version (tarball install)")


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": raftis_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
