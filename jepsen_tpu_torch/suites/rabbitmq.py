"""RabbitMQ test suite — queue semantics and a queue-backed mutex.

Mirrors the reference's rabbitmq suite
(Jepsen's `rabbitmq/src/jepsen/rabbitmq.clj`): deb package
install with a shared erlang cookie and config (`:26-75`), a queue
workload (enqueue with publisher confirms, dequeue-and-ack, final
drain, `:128-178`) checked by total-queue, and the *mutex-as-queue*
workload — a single token job; holding it = holding the lock; release
re-publishes (`:180-230`) — checked linearizably against the mutex
model on device.

Where the reference speaks AMQP through the langohr driver, this
client uses RabbitMQ's management HTTP API (publish/get with
ack_requeue_false), which exposes the same enqueue/dequeue/ack
semantics over plain HTTP — no driver dependency, same test meaning.
Hermetic tests run against an in-process fake of that API."""

from __future__ import annotations

import base64
import itertools
import json
import logging
import threading
import urllib.error
import urllib.request

from .. import checker, cli, client as jclient, control, models
from .. import db as jdb
from .. import generator as gen
from ..checker import linear
from ..control import util as cu
from ..os_ import debian
from . import std_opts, std_test

log = logging.getLogger(__name__)

MGMT_PORT = 15672
VHOST = "%2F"
DEFAULT_VERSION = "3.8.9"
COOKIE = "jepsen-rabbitmq"


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    """deb install + shared erlang cookie + clustering via rabbitmqctl
    join_cluster to the first node (`rabbitmq.clj:26-96`)."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing rabbitmq %s", node, self.version)
            debian.install(["erlang-nox", "rabbitmq-server"])
            control.exec_("service", "rabbitmq-server", "stop")
            control.exec_("sh", "-c",
                          f"echo '{COOKIE}' > "
                          f"/var/lib/rabbitmq/.erlang.cookie")
            control.exec_("chmod", "600",
                          "/var/lib/rabbitmq/.erlang.cookie")
            control.exec_("service", "rabbitmq-server", "start")
            control.exec_("rabbitmq-plugins", "enable",
                          "rabbitmq_management")
            primary = test["nodes"][0]
            if node != primary:
                control.exec_("rabbitmqctl", "stop_app")
                control.exec_("rabbitmqctl", "join_cluster",
                              f"rabbit@{primary}")
                control.exec_("rabbitmqctl", "start_app")
            control.exec_("rabbitmqctl", "add_user", "jepsen", "jepsen")
            control.exec_("rabbitmqctl", "set_user_tags", "jepsen",
                          "administrator")
            control.exec_("rabbitmqctl", "set_permissions", "-p", "/",
                          "jepsen", ".*", ".*", ".*")

    def start(self, test, node):
        with control.su():
            control.exec_("service", "rabbitmq-server", "start")

    def kill(self, test, node):
        with control.su():
            cu.grepkill("beam.smp")

    def teardown(self, test, node):
        with control.su():
            self.kill(test, node)
            control.exec_("rm", "-rf", "/var/lib/rabbitmq/mnesia")

    def log_files(self, test, node):
        return ["/var/log/rabbitmq/rabbit.log"]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


class MgmtClient(jclient.Client):
    """Queue ops over the management HTTP API."""

    QUEUE = "jepsen.queue"

    def __init__(self, timeout_s: float = 5.0):
        self.timeout_s = timeout_s
        self.base: str | None = None

    def open(self, test, node):
        c = type(self).__new__(type(self))
        c.__dict__.update(self.__dict__)
        fn = test.get("mgmt-url-fn")
        c.base = fn(node) if fn else f"http://{node}:{MGMT_PORT}"
        return c

    def _req(self, method: str, path: str, body: dict | None = None):
        req = urllib.request.Request(
            self.base + path,
            data=json.dumps(body).encode() if body is not None else None,
            method=method,
            headers={
                "Content-Type": "application/json",
                "Authorization": "Basic " + base64.b64encode(
                    b"jepsen:jepsen").decode(),
            })
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            data = r.read()
            return json.loads(data) if data else None

    def setup(self, test):
        self._req("PUT", f"/api/queues/{VHOST}/{self.QUEUE}",
                  {"durable": True, "auto_delete": False})

    def publish(self, payload: str):
        r = self._req("POST",
                      f"/api/exchanges/{VHOST}/amq.default/publish",
                      {"routing_key": self.QUEUE, "payload": payload,
                       "payload_encoding": "string", "properties": {}})
        if not (r or {}).get("routed"):
            raise OSError("publish not routed")

    def get1(self):
        r = self._req("POST", f"/api/queues/{VHOST}/{self.QUEUE}/get",
                      {"count": 1, "ackmode": "ack_requeue_false",
                       "encoding": "auto"})
        if not r:
            return None
        return r[0]["payload"]


class QueueClient(MgmtClient):
    def invoke(self, test, op):
        try:
            if op["f"] == "enqueue":
                self.publish(str(op["value"]))
                return {**op, "type": "ok"}
            if op["f"] == "dequeue":
                v = self.get1()
                if v is None:
                    return {**op, "type": "fail", "error": "empty"}
                return {**op, "type": "ok", "value": int(v)}
            if op["f"] == "drain":
                out = []
                while True:
                    v = self.get1()
                    if v is None:
                        return {**op, "type": "ok", "value": out}
                    out.append(int(v))
            raise ValueError(f"unknown f {op['f']!r}")
        except (urllib.error.URLError, OSError, ValueError,
                KeyError) as e:
            # Dequeue/drain use ack_requeue_false: the broker removes
            # the message before we see the HTTP response, so a
            # transport error is indeterminate — the message may be
            # gone. Only :info keeps the total-queue checker sound.
            return {**op, "type": "info", "error": str(e)}


class MutexClient(MgmtClient):
    """The queue-as-mutex trick (`rabbitmq.clj:180-230`): one token job
    lives in the queue; acquire = dequeue it, release = re-publish.
    Each process tracks whether it holds the token, like the
    reference's `enqueued?` atom — releasing without holding must not
    mint new tokens."""

    QUEUE = "jepsen.semaphore"

    # guards the seeded flag in the shared test map: without it two
    # workers can both observe the empty list and mint two tokens
    _seed_lock = threading.Lock()

    def __init__(self, timeout_s: float = 5.0):
        super().__init__(timeout_s)
        self.held = False

    def setup(self, test):
        super().setup(test)
        with MutexClient._seed_lock:
            if not test.setdefault("_mutex-seeded", []):
                test["_mutex-seeded"].append(True)
                self.publish("token")

    def invoke(self, test, op):
        try:
            if op["f"] == "acquire":
                if self.held:
                    return {**op, "type": "fail",
                            "error": "already-held"}
                v = self.get1()
                if v is None:
                    return {**op, "type": "fail", "error": "not-free"}
                self.held = True
                return {**op, "type": "ok"}
            if op["f"] == "release":
                if not self.held:
                    return {**op, "type": "fail",
                            "error": "not-held"}
                self.held = False
                self.publish("token")
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except (urllib.error.URLError, OSError, KeyError) as e:
            # an indeterminate release may or may not have re-minted
            # the token
            t = "fail" if op["f"] == "acquire" else "info"
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


def _acquire_release(test, ctx):
    return {"type": "invoke",
            "f": "acquire" if gen.rng.random() < 0.5 else "release",
            "value": None}


def mutex_workload(opts):
    return {
        "client": MutexClient(),
        "generator": gen.repeat(_acquire_release),
        "checker": linear.linearizable(models.mutex(),
                                       device=opts.get("device")),
    }


WORKLOADS = {"queue": queue_workload, "mutex": mutex_workload}


def rabbitmq_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "queue")
    return std_test(
        opts, name=f"rabbitmq-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "queue", DEFAULT_VERSION,
                    "rabbitmq-server version")


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": rabbitmq_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
