"""Disque test suite — distributed message queue semantics.

Mirrors the reference's disque suite
(Jepsen's `disque/src/jepsen/disque.clj`): build from source on
each node (`:40-54`), single-config cluster joined via CLUSTER MEET to
the primary (`:96-106`), and the queue workload — enqueue with
configurable replication/retry, dequeue as GETJOB+ACKJOB
(`:195-210`), drain at the end — checked by total-queue.

The client speaks RESP directly (`resp_proto.py`); hermetic tests run
against an in-process RESP fake (tests/fake_disque.py).
"""

from __future__ import annotations

import itertools
import logging

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from ..control import util as cu
from ..os_ import debian
from . import std_opts, std_test
from .resp_proto import Conn, RESPError

log = logging.getLogger(__name__)

DIR = "/opt/disque"
DATA_DIR = "/var/lib/disque"
PIDFILE = "/var/run/disque.pid"
BINARY = f"{DIR}/src/disque-server"
CONTROL_BIN = f"{DIR}/src/disque"
CONFIG = f"{DIR}/disque.conf"
LOGFILE = f"{DATA_DIR}/log"
PORT = 7711

DEFAULT_VERSION = "master"

CONFIG_BODY = f"""\
port {PORT}
daemonize no
dir {DATA_DIR}
"""


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    """git clone + make, then CLUSTER MEET everyone to the first node
    (`disque.clj:40-54,96-106`)."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing disque %s", node, self.version)
            debian.install(["git-core", "build-essential"])
            with control.cd("/opt"):
                if not cu.exists(DIR):
                    control.exec_("git", "clone",
                                  "https://github.com/antirez/disque.git")
            with control.cd(DIR):
                control.exec_("git", "fetch", "--all")
                control.exec_("git", "reset", "--hard", self.version)
                control.exec_("make")
            control.exec_("sh", "-c",
                          f"echo '{CONFIG_BODY}' > {CONFIG}")
            control.exec_("mkdir", "-p", DATA_DIR)
            self.start(test, node)
            cu.await_tcp_port(PORT)
        # join everyone to the first node
        primary = test["nodes"][0]
        if node != primary:
            with control.su():
                out = control.exec_(CONTROL_BIN, "-p", str(PORT),
                                    "cluster", "meet", primary,
                                    str(PORT))
                assert "OK" in str(out)

    def start(self, test, node):
        with control.su():
            cu.start_daemon(
                {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
                BINARY, CONFIG)

    def kill(self, test, node):
        with control.su():
            cu.grepkill("disque-server")

    def teardown(self, test, node):
        log.info("%s wiping disque", node)
        with control.su():
            self.kill(test, node)
            control.exec_("rm", "-rf", f"{DATA_DIR}/*", LOGFILE, PIDFILE)

    def log_files(self, test, node):
        return [LOGFILE]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


def _connect(test, node) -> Conn:
    fn = test.get("resp-conn-fn")
    if fn is not None:
        return fn(node)
    return Conn(node, PORT)


class QueueClient(jclient.Client):
    """enqueue = ADDJOB (replicate/retry per test opts), dequeue =
    GETJOB + ACKJOB, drain = dequeue until empty
    (`disque.clj:180-240`)."""

    QUEUE = "jepsen"

    def __init__(self, timeout_ms: int = 100):
        self.timeout_ms = timeout_ms
        self.conn: Conn | None = None

    def open(self, test, node):
        c = QueueClient(self.timeout_ms)
        c.conn = _connect(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def _dequeue1(self):
        jobs = self.conn.call("GETJOB", "TIMEOUT", self.timeout_ms,
                              "COUNT", 1, "FROM", self.QUEUE)
        if not jobs:
            return None
        queue, job_id, body = jobs[0][0], jobs[0][1], jobs[0][2]
        self.conn.call("ACKJOB", job_id)
        return int(body)

    def invoke(self, test, op):
        try:
            if op["f"] == "enqueue":
                args = ["ADDJOB", self.QUEUE, str(op["value"]),
                        self.timeout_ms]
                replicate = test.get("replicate")
                if replicate:
                    args += ["REPLICATE", replicate]
                retry = test.get("retry-s")
                if retry is not None:
                    args += ["RETRY", retry]
                self.conn.call(*args)
                return {**op, "type": "ok"}
            if op["f"] == "dequeue":
                v = self._dequeue1()
                if v is None:
                    return {**op, "type": "fail", "error": "empty"}
                return {**op, "type": "ok", "value": v}
            if op["f"] == "drain":
                out = []
                while True:
                    v = self._dequeue1()
                    if v is None:
                        return {**op, "type": "ok", "value": out}
                    out.append(v)
            raise ValueError(f"unknown f {op['f']!r}")
        except (RESPError, OSError) as e:
            # enqueue may or may not have landed; dequeue without an
            # ack leaves the job for redelivery
            t = "info" if op["f"] == "enqueue" else "fail"
            return {**op, "type": t, "error": str(e)}


def queue_workload(opts):
    values = itertools.count()

    def enq(test, ctx):
        return {"type": "invoke", "f": "enqueue", "value": next(values)}

    def deq(test, ctx):
        return {"type": "invoke", "f": "dequeue", "value": None}

    return {"client": QueueClient(),
            "generator": gen.mix([enq, deq]),
            "checker": checker.total_queue(),
            "final-generator": gen.each_thread(gen.once(
                {"type": "invoke", "f": "drain", "value": None}))}


WORKLOADS = {"queue": queue_workload}


def disque_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "queue")
    return std_test(
        opts, name=f"disque-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "queue", DEFAULT_VERSION,
                    "disque git rev to build") + [
    cli.opt("--replicate", type=int,
            help="ADDJOB REPLICATE level (default: server default)"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": disque_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
