"""Hazelcast-style CP-subsystem suite: a workload *menu* over locks,
semaphores, CAS references, unique ids, and queues.

Mirrors the reference's hazelcast suite (`hazelcast/src/jepsen/
hazelcast.clj:652-816`): a `--workload` flag selects one of several
CP-subsystem tests, each pairing a client against the right checker —
locks against a linearizable mutex model (checked on device), id-gen
against `unique_ids`, queues against `total_queue`. The data plane is
the suite's CP service shim (`cp_shim.py`), playing the role of the
reference's in-repo `hazelcast/server/` component.
"""

from __future__ import annotations

import itertools
import logging
import urllib.error
import urllib.request

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from .. import models, nemesis as jnemesis, testkit
from ..checker import timeline
from ..nemesis import partition
from ..os_ import debian
from . import cp_shim, http_post

log = logging.getLogger(__name__)


def shim_url(node: str) -> str:
    return f"http://{node}:{cp_shim.PORT}"


class DB(jdb.DB, jdb.LogFiles):
    """Deploys the CP service shim on each node — the hermetic tier.
    The shim is linearizable by construction; use ServerDB (--deploy
    server) to test actual Hazelcast members."""

    def setup(self, test, node):
        cp_shim.deploy(test.get("shim-port", cp_shim.PORT))

    def teardown(self, test, node):
        from ..control import util as cu
        with control.su():
            cu.stop_daemon(f"{cp_shim.DIR}/shim.pid", cmd="python3")
            control.exec_("rm", "-rf", cp_shim.DIR)

    def log_files(self, test, node):
        return [f"{cp_shim.DIR}/shim.log"]


SERVER_DIR = "/opt/hazelcast"
SERVER_JAR = f"{SERVER_DIR}/server.jar"
SERVER_PID = f"{SERVER_DIR}/server.pid"
SERVER_LOG = f"{SERVER_DIR}/server.log"
MEMBER_PORT = 5701


class ServerDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real Hazelcast members: upload the server fat jar (the
    reference builds `hazelcast/server/target/hazelcast-server.jar`
    via lein and uploads it, `hazelcast.clj:57-96`), install a JDK,
    and run `java -jar server.jar --members ip,ip,...` as a daemon."""

    def __init__(self, server_jar: str | None = None):
        self.server_jar = server_jar

    def setup(self, test, node):
        from ..control import util as cu
        jar = test.get("server-jar") or self.server_jar
        assert jar, "ServerDB needs a server jar (--server-jar)"
        with control.su():
            debian.install_jdk11()
            control.exec_("mkdir", "-p", SERVER_DIR)
            control.upload(jar, SERVER_JAR)
            self.start(test, node)
            cu.await_tcp_port(MEMBER_PORT)

    def start(self, test, node):
        from ..control import util as cu
        with control.su():
            cu.start_daemon(
                {"chdir": SERVER_DIR, "logfile": SERVER_LOG,
                 "pidfile": SERVER_PID},
                "/usr/bin/java", "-jar", SERVER_JAR,
                "--members", ",".join(test["nodes"]))

    def kill(self, test, node):
        from ..control import util as cu
        with control.su():
            cu.stop_daemon(SERVER_PID, cmd="java")

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf", SERVER_LOG, SERVER_PID)

    def log_files(self, test, node):
        return [SERVER_LOG]


class CPClient(jclient.Client):
    """Base client: POSTs ops to the node's shim; network errors become
    info (indeterminate) except on pure reads."""

    READS: tuple = ()

    def __init__(self, timeout_s: float = 5.0, url: str | None = None,
                 owner: str | None = None):
        self.timeout_s = timeout_s
        self.url = url
        self.owner = owner

    def open(self, test, node):
        url = test.get("shim-url-fn", shim_url)(node)
        c = type(self)(self.timeout_s, url, owner=f"{node}-{id(self)}")
        return c

    def post(self, path: str, body: dict) -> dict:
        return http_post(self.url + path, body, self.timeout_s)

    def invoke(self, test, op):
        try:
            return self.apply_op(test, op)
        except (urllib.error.URLError, OSError) as e:
            t = "fail" if op["f"] in self.READS else "info"
            return {**op, "type": t, "error": str(e)}

    def apply_op(self, test, op):
        raise NotImplementedError


class LockClient(CPClient):
    """acquire/release over one named lock; checked against the mutex
    model (`hazelcast.clj` lock workloads)."""

    def apply_op(self, test, op):
        owner = str(op["process"])
        if op["f"] == "acquire":
            r = self.post("/lock/acquire", {"name": "jepsen",
                                            "owner": owner})
            return {**op, "type": "ok" if r["ok"] else "fail"}
        if op["f"] == "release":
            r = self.post("/lock/release", {"name": "jepsen",
                                            "owner": owner})
            return {**op, "type": "ok" if r["ok"] else "fail"}
        raise ValueError(op["f"])


class SemaphoreClient(CPClient):
    def apply_op(self, test, op):
        owner = str(op["process"])
        path = "/semaphore/" + op["f"]
        r = self.post(path, {"name": "jepsen", "owner": owner,
                             "permits": test.get("semaphore-permits", 2)})
        return {**op, "type": "ok" if r["ok"] else "fail"}


class CasClient(CPClient):
    READS = ("read",)

    def apply_op(self, test, op):
        if op["f"] == "read":
            r = self.post("/ref/read", {"name": "jepsen"})
            return {**op, "type": "ok", "value": r["value"]}
        if op["f"] == "write":
            self.post("/ref/write", {"name": "jepsen",
                                     "value": op["value"]})
            return {**op, "type": "ok"}
        if op["f"] == "cas":
            old, new = op["value"]
            r = self.post("/ref/cas", {"name": "jepsen", "old": old,
                                       "new": new})
            return {**op, "type": "ok" if r["ok"] else "fail"}
        raise ValueError(op["f"])


class IdClient(CPClient):
    def apply_op(self, test, op):
        r = self.post("/id", {})
        return {**op, "type": "ok", "value": r["value"]}


class QueueClient(CPClient):
    POLL = "/queue/poll"

    def apply_op(self, test, op):
        if op["f"] == "enqueue":
            self.post("/queue/offer", {"name": "jepsen",
                                       "value": op["value"]})
            return {**op, "type": "ok"}
        if op["f"] == "dequeue":
            r = self.post(self.POLL, {"name": "jepsen"})
            if r["value"] is None:
                return {**op, "type": "fail", "error": "empty"}
            return {**op, "type": "ok", "value": r["value"]}
        if op["f"] == "drain":
            # poll until empty; total_queue expands the collected value
            # back into dequeue pairs (checker.clj:594-626)
            out = []
            while True:
                r = self.post("/queue/poll", {"name": "jepsen"})
                if r["value"] is None:
                    return {**op, "type": "ok", "value": out}
                out.append(r["value"])
        raise ValueError(op["f"])


# -- semaphore checker (suite-local, like the reference's) -------------------

class SemaphoreChecker(checker.Checker):
    """At most N permits *certainly* held at once.

    A permit is certainly held from the acquire's completion until the
    holder's next release *invocation*: the release takes effect
    somewhere between its invoke and its completion, so a concurrent
    acquire granted against the freed permit can journal its ok before
    the release's ok. Counting releases at completion (the naive
    replay) therefore flags that legal interleaving as over-capacity.
    Ending intervals at release-invoke is conservative — only genuine
    overlaps of > N certain-hold intervals are flagged."""

    def __init__(self, permits: int = 2):
        self.permits = permits

    def check(self, test, hist, opts):
        holds: dict = {}          # process -> certainly-held permits
        tentative: set = set()    # processes with an in-flight release
        over = []

        def flag(o):
            over.append({"op": dict(o),
                         "holders": {str(p): n for p, n
                                     in sorted(holds.items()) if n}})

        for o in hist:
            p = o.get("process")
            f = o.get("f")
            t = o.get("type")
            if f == "release":
                if t == "invoke":
                    if holds.get(p, 0) > 0:
                        holds[p] -= 1
                        tentative.add(p)
                elif t == "fail" and p in tentative:
                    # the release definitely didn't free: the permit
                    # was held throughout, so restore and re-check
                    tentative.discard(p)
                    holds[p] = holds.get(p, 0) + 1
                    if sum(holds.values()) > self.permits:
                        flag(o)
                elif t in ("ok", "info"):
                    tentative.discard(p)
            elif f == "acquire" and t == "ok":
                holds[p] = holds.get(p, 0) + 1
                if sum(holds.values()) > self.permits:
                    flag(o)
        return {"valid?": not over, "over-capacity": over[:16]}


# -- workload menu ----------------------------------------------------------

def _acquire_release(test, ctx):
    return {"type": "invoke",
            "f": "acquire" if gen.rng.random() < 0.5 else "release",
            "value": None}


def lock_workload(opts):
    return {"client": LockClient(),
            "generator": gen.repeat(_acquire_release),
            "checker": checker.linearizable(models.mutex(),
                                            device=opts.get("device")),
            "final-generator": None}


def semaphore_workload(opts):
    permits = opts.get("semaphore-permits", 2)
    return {"client": SemaphoreClient(),
            "generator": gen.repeat(_acquire_release),
            "checker": SemaphoreChecker(permits),
            "final-generator": None}


def cas_workload(opts):
    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def w(test, ctx):
        return {"type": "invoke", "f": "write",
                "value": gen.rng.randrange(5)}

    def cas(test, ctx):
        return {"type": "invoke", "f": "cas",
                "value": [gen.rng.randrange(5), gen.rng.randrange(5)]}

    return {"client": CasClient(),
            "generator": gen.mix([r, w, cas]),
            "checker": checker.linearizable(models.cas_register(),
                                            device=opts.get("device")),
            "final-generator": None}


def ids_workload(opts):
    return {"client": IdClient(),
            "generator": gen.repeat({"f": "generate"}),
            "checker": checker.unique_ids(),
            "final-generator": None}


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


class UnorderedQueueClient(QueueClient):
    """Dequeues any element (not FIFO head) so the history is judged
    against the unordered-queue model."""
    POLL = "/queue/poll/value"


def queue_linear_workload(opts):
    """Queue over a small value domain, checked as full
    linearizability against the unordered-queue device model — the
    knossos-model usage the reference gets from hazelcast's queue
    tests (`hazelcast.clj` queue + knossos models)."""
    def enq(test, ctx):
        return {"type": "invoke", "f": "enqueue",
                "value": gen.rng.randrange(5)}

    def deq(test, ctx):
        return {"type": "invoke", "f": "dequeue", "value": None}

    return {"client": UnorderedQueueClient(),
            "generator": gen.mix([enq, deq]),
            "checker": checker.linearizable(models.unordered_queue(),
                                            device=opts.get("device")),
            "final-generator": None}


class MapClient(CPClient):
    """The reference's map / crdt-map workloads: a set stored under
    one map key; `add` merges an element, the final `read` fetches the
    set (`hazelcast.clj:440-507`). crdt toggles which map the server
    uses (PN-counter-backed CRDT vs plain)."""

    READS = ("read",)
    NAME = "jepsen-map"

    def __init__(self, timeout_s: float = 5.0, url: str | None = None,
                 owner: str | None = None, crdt: bool = True):
        super().__init__(timeout_s, url, owner)
        self.crdt = crdt

    def open(self, test, node):
        c = super().open(test, node)
        c.crdt = self.crdt
        return c

    def _name(self):
        return ("crdt:" if self.crdt else "") + self.NAME

    def apply_op(self, test, op):
        if op["f"] == "add":
            self.post("/map/add", {"name": self._name(),
                                   "value": op["value"]})
            return {**op, "type": "ok"}
        if op["f"] == "read":
            r = self.post("/map/read", {"name": self._name()})
            return {**op, "type": "ok", "value": r["value"]}
        raise ValueError(op["f"])


def map_workload(opts, crdt: bool):
    values = itertools.count()

    def add(test, ctx):
        return {"type": "invoke", "f": "add", "value": next(values)}

    return {"client": MapClient(crdt=crdt),
            "generator": add,
            "checker": checker.set_checker(),
            "final-generator": gen.each_thread(gen.once(
                {"type": "invoke", "f": "read", "value": None}))}


def gset_linear_workload(opts):
    """CRDT map over a bounded element domain, checked as full
    linearizability against the g-set device model (duplicate adds are
    idempotent and legal)."""
    def add(test, ctx):
        return {"type": "invoke", "f": "add",
                "value": gen.rng.randrange(16)}

    def read(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    return {"client": MapClient(crdt=True),
            "generator": gen.mix([add, add, read]),
            "checker": checker.linearizable(models.gset(),
                                            device=opts.get("device")),
            "final-generator": None}


WORKLOADS = {
    "lock": lock_workload,
    "semaphore": semaphore_workload,
    "cas-register": cas_workload,
    "unique-ids": ids_workload,
    "queue": queue_workload,
    "queue-linear": queue_linear_workload,
    "map": lambda opts: map_workload(opts, crdt=False),
    "crdt-map": lambda opts: map_workload(opts, crdt=True),
    "crdt-map-linear": gset_linear_workload,
}


def hazelcast_test(opts: dict) -> dict:
    """Menu-driven test construction (`hazelcast.clj:769-816`)."""
    name = opts.get("workload", "cas-register")
    workload = WORKLOADS[name](opts)
    time_limit = opts.get("time-limit", opts.get("time_limit", 60))
    rate = float(opts.get("rate", 10))

    main = gen.time_limit(time_limit, gen.nemesis(
        gen.cycle(gen.phases(
            gen.sleep(5),
            gen.once({"type": "info", "f": "start", "value": None}),
            gen.sleep(5),
            gen.once({"type": "info", "f": "stop", "value": None}))),
        gen.stagger(1 / rate, workload["generator"])))
    final = workload.get("final-generator")
    generator = gen.phases(
        main,
        gen.nemesis(gen.once({"type": "info", "f": "stop",
                              "value": None})),
        gen.clients(final)) if final else main

    return {
        **testkit.noop_test(),
        **{k: v for k, v in opts.items() if isinstance(k, str)},
        "name": f"hazelcast-{name}",
        "os": debian.os,
        "db": (ServerDB(opts.get("server-jar"))
               if opts.get("deploy") == "server" else DB()),
        "client": workload["client"],
        "nemesis": partition.partition_majorities_ring()
        if opts.get("nemesis", "partition") == "partition"
        else jnemesis.noop,
        "generator": generator,
        "checker": checker.compose({
            "workload": workload["checker"],
            "timeline": timeline.html(),
            "perf": checker.perf_checker(),
            "stats": checker.stats(),
        }),
    }


OPT_SPEC = [
    cli.opt("--workload", "-w", default="cas-register",
            choices=sorted(WORKLOADS), help="Which workload to run"),
    cli.opt("--rate", type=float, default=10,
            help="approximate op rate per second"),
    cli.opt("--semaphore-permits", type=int, default=2,
            help="semaphore capacity"),
    cli.opt("--nemesis", default="partition",
            choices=["partition", "none"], help="fault to inject"),
    cli.opt("--deploy", default="shim", choices=["shim", "server"],
            help="shim = hermetic CP service; server = real Hazelcast "
                 "members from --server-jar"),
    cli.opt("--server-jar", default=None,
            help="path to the Hazelcast server fat jar to upload"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": hazelcast_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
