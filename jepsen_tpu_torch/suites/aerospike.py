"""Aerospike test suite — CAS register, counter, set, and the pause
(lost-writes) workload, under a kill/partition/clock nemesis stack.

Mirrors the reference's aerospike suite
(Jepsen's `aerospike/src/aerospike/`):

  * DB automation: local .deb upload + dpkg install, config templating
    with replication-factor / heartbeat-interval / commit-to-device,
    roster-set + recluster on the primary, migration waits, wipe on
    teardown (`support.clj:215-340`).
  * Clients speak the Aerospike wire protocol directly (`as_proto.py`)
    with the reference's error classification (`support.clj:448-501`):
    timeouts/connection errors are :fail for idempotent ops and :info
    otherwise; generation mismatches are definite fails.
  * Workloads: cas-register (`cas_register.clj`), counter
    (`counter.clj`), set-via-string-append (`set.clj`), and the pause
    state machine that traps in-flight writes on a paused master
    (`pause.clj:180-233`).
  * Nemesis: kill/restart with a cap on simultaneously-dead nodes,
    revive + recluster recovery ops, composed with random-halves
    partitions and the clock nemesis (`nemesis.clj:96-145`).

The membership/roster protocol the nemesis drives is modeled by the
formal spec at `spec/aerospike_roster.tla` (the reference ships
`aerospike/spec/aerospike.tla`)."""

from __future__ import annotations

import itertools
import logging
import threading
import time as _time

from .. import checker, cli, client as jclient, control, independent, models
from .. import db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..checker import linear, timeline
from ..control import util as cu
from ..control.core import RemoteError
from ..nemesis import partition as npartition, time as ntime
from . import std_opts, std_test
from .as_proto import (ASError, Conn, RC_GENERATION, RC_FORBIDDEN,
                       RC_HOT_KEY,
                       RC_PARTITION_UNAVAILABLE)

log = logging.getLogger(__name__)

NAMESPACE = "jepsen"            # support.clj ans
PORT = 3000
PACKAGE_DIR = "/tmp/packages"   # support.clj remote-package-dir
CONF = "/etc/aerospike/aerospike.conf"
LOGFILE = "/var/log/aerospike/aerospike.log"


def _meh(*cmd):
    """Run a command, swallowing remote failures (the reference's
    `meh` around best-effort cleanup, e.g. `support.clj:312-327`)."""
    try:
        control.exec_(*cmd)
    except RemoteError:
        pass

CONF_TEMPLATE = """\
service {{
    proto-fd-max 15000
    node-id-interface eth0
}}
logging {{
    file {logfile} {{ context any info }}
}}
network {{
    service {{ address any; port {port} }}
    heartbeat {{
        mode mesh
        address any
        mesh-seed-address-port {mesh_address} 3002
        port 3002
        interval {heartbeat_interval}
        timeout 10
    }}
    fabric {{ port 3001 }}
    info {{ port 3003 }}
}}
namespace {namespace} {{
    replication-factor {replication_factor}
    memory-size 1G
    strong-consistency true
    {commit_to_device}
    storage-engine device {{
        file /opt/aerospike/data/{namespace}.dat
        filesize 1G
    }}
}}
"""


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Aerospike server from local .deb packages (`support.clj:215-340`)."""

    def __init__(self, opts: dict | None = None):
        self.opts = opts or {}

    def setup(self, test, node):
        with control.su():
            ntime.reset_time()
            self.install(test, node)
            self.configure(test, node)
            self.start(test, node)

    def install(self, test, node):
        log.info("%s installing aerospike packages", node)
        control.exec_("mkdir", "-p", PACKAGE_DIR)
        control.exec_("chmod", "a+rwx", PACKAGE_DIR)
        for pkg in test.get("packages",
                            ["aerospike-server.deb",
                             "aerospike-tools.deb"]):
            remote = f"{PACKAGE_DIR}/{pkg.rsplit('/', 1)[-1]}"
            control.upload(pkg, remote)
            control.exec_("dpkg", "-i", "--force-confnew", remote)
        control.exec_("systemctl", "daemon-reload")
        for d, owner in (("/var/log/aerospike", "aerospike:aerospike"),
                         ("/var/run/aerospike", "aerospike:aerospike")):
            control.exec_("mkdir", "-p", d)
            control.exec_("chown", owner, d)

    def configure(self, test, node):
        conf = CONF_TEMPLATE.format(
            logfile=LOGFILE, port=PORT, namespace=NAMESPACE,
            mesh_address=test["nodes"][0],
            heartbeat_interval=self.opts.get("heartbeat-interval", 150),
            replication_factor=self.opts.get("replication-factor", 3),
            commit_to_device=("commit-to-device true"
                              if self.opts.get("commit-to-device")
                              else ""))
        cu.write_file(conf, CONF)

    def start(self, test, node):
        with control.su():
            control.exec_("service", "aerospike", "start")
            cu.await_tcp_port(PORT)
            if node == test["nodes"][0]:
                # roster-set every observed node, then recluster
                # (support.clj:282-310 start!)
                control.exec_(
                    "asinfo", "-v",
                    f"roster-set:namespace={NAMESPACE};nodes="
                    + ",".join(test["nodes"]))
                control.exec_("asadm", "-e", "asinfo -v recluster:")

    def kill(self, test, node):
        with control.su():
            _meh("service", "aerospike", "stop")
            cu.grepkill("asd")

    def teardown(self, test, node):
        with control.su():
            self.kill(test, node)
            _meh("truncate", "--size", "0", LOGFILE)
            for d in ("data", "smd", "udf"):
                _meh("rm", "-rf", f"/opt/aerospike/{d}")

    def log_files(self, test, node):
        return [LOGFILE]


def db(opts: dict | None = None) -> DB:
    return DB(opts)


def revive(node=None):
    """asinfo revive — readmit dead partitions (`support.clj:142-148`)."""
    with control.su():
        control.exec_("asinfo", "-v",
                      f"revive:namespace={NAMESPACE}")


def recluster(node=None):
    with control.su():
        control.exec_("asinfo", "-v", "recluster:")


# -- error classification (support.clj with-errors) --------------------------

DEFINITE_FAIL = {RC_GENERATION, RC_PARTITION_UNAVAILABLE, RC_HOT_KEY,
                 RC_FORBIDDEN}


def _capture(op, e: Exception, idempotent: bool) -> dict:
    if isinstance(e, ASError):
        if e.code in DEFINITE_FAIL:
            return {**op, "type": "fail", "error": ["as", e.code, str(e)]}
        t = "fail" if idempotent else "info"
        return {**op, "type": t, "error": ["as", e.code, str(e)]}
    t = "fail" if idempotent else "info"
    return {**op, "type": t, "error": ["conn", str(e)]}


def _connect(test, node) -> Conn:
    fn = test.get("as-conn-fn")
    if fn is not None:
        return fn(node)
    return Conn(node, PORT)


class _Client(jclient.Client):
    SET = "cats"

    def __init__(self):
        self.conn: Conn | None = None

    def open(self, test, node):
        c = type(self)()
        c.__dict__.update({k: v for k, v in self.__dict__.items()
                           if k != "conn"})
        c.conn = _connect(test, node)
        return c

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


class CasRegisterClient(_Client):
    """CAS register over a single bin, keyed independently
    (`cas_register.clj:43-75`). cas = fetch generation, verify value,
    put with EXPECT_GEN_EQUAL."""

    def invoke(self, test, op):
        k, v = op["value"]
        idempotent = op["f"] == "read"
        try:
            if op["f"] == "read":
                r = self.conn.get(NAMESPACE, self.SET, k)
                val = r["bins"].get("value") if r else None
                return {**op, "type": "ok",
                        "value": independent.ktuple(k, val)}
            if op["f"] == "write":
                self.conn.put(NAMESPACE, self.SET, k, {"value": v})
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = v
                r = self.conn.get(NAMESPACE, self.SET, k)
                if r is None:
                    return {**op, "type": "fail", "error": "not-found"}
                if r["bins"].get("value") != old:
                    return {**op, "type": "fail",
                            "error": "value-mismatch"}
                self.conn.put(NAMESPACE, self.SET, k, {"value": new},
                              generation=r["generation"])
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except (ASError, OSError) as e:
            return _capture(op, e, idempotent)


class CounterClient(_Client):
    """Counter via server-side add (`counter.clj:43-66`)."""

    SET = "counters"
    KEY = "pounce"

    def setup(self, test):
        try:
            self.conn.put(NAMESPACE, self.SET, self.KEY, {"value": 0})
        except (ASError, OSError):
            pass  # another worker's setup may already have seeded it

    def invoke(self, test, op):
        idempotent = op["f"] == "read"
        try:
            if op["f"] == "read":
                r = self.conn.get(NAMESPACE, self.SET, self.KEY)
                return {**op, "type": "ok",
                        "value": r["bins"].get("value") if r else None}
            if op["f"] == "add":
                self.conn.add(NAMESPACE, self.SET, self.KEY,
                              {"value": op["value"]})
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except (ASError, OSError) as e:
            return _capture(op, e, idempotent)


class SetClient(_Client):
    """Set as a string-append bin: add appends " v", read splits
    (`set.clj:12-46`)."""

    def invoke(self, test, op):
        k, v = op["value"]
        try:
            if op["f"] == "read":
                r = self.conn.get(NAMESPACE, self.SET, k)
                raw = (r["bins"].get("value") or "") if r else ""
                vals = sorted(int(x) for x in raw.split() if x)
                return {**op, "type": "ok",
                        "value": independent.ktuple(k, vals)}
            if op["f"] == "add":
                self.conn.append(NAMESPACE, self.SET, k,
                                 {"value": f" {v}"})
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except (ASError, OSError) as e:
            return _capture(op, e, op["f"] == "read")


# -- nemesis (nemesis.clj) ---------------------------------------------------

class KillNemesis(jnemesis.Nemesis):
    """Kills/restarts asd with a cap on simultaneously-dead nodes;
    revive/recluster recovery ops (`nemesis.clj:17-57`)."""

    def __init__(self, signal: int = 9, max_dead: int = 2):
        self.signal = signal
        self.max_dead = max_dead
        self.dead: set = set()
        self.lock = threading.Lock()

    def setup(self, test):
        return self

    def invoke(self, test, op):
        f = op["f"]

        def per_node(test, node):
            if f == "kill":
                with self.lock:
                    if node not in self.dead \
                            and len(self.dead) >= self.max_dead:
                        return "still-alive"
                    self.dead.add(node)
                with control.su():
                    _meh("killall", f"-{self.signal}", "asd")
                return "killed"
            if f == "restart":
                with control.su():
                    control.exec_("service", "aerospike", "restart")
                with self.lock:
                    self.dead.discard(node)
                return "started"
            if f == "revive":
                try:
                    revive(node)
                    return "revived"
                except Exception:  # noqa: BLE001 — dead node
                    return "not-running"
            if f == "recluster":
                try:
                    recluster(node)
                    return "reclustered"
                except Exception:  # noqa: BLE001 — dead node
                    return "not-running"
            raise ValueError(f"unknown nemesis f {f!r}")

        value = control.on_nodes(test, per_node, op["value"])
        return {**op, "value": value}

    def teardown(self, test):
        pass


def _subset(rng, nodes):
    n = rng.randint(1, len(nodes))
    return rng.sample(list(nodes), n)


def kill_gen(test, ctx):
    return {"type": "info", "f": "kill",
            "value": _subset(gen.rng, test["nodes"])}


def restart_gen(test, ctx):
    return {"type": "info", "f": "restart",
            "value": _subset(gen.rng, test["nodes"])}


def revive_gen(test, ctx):
    return {"type": "info", "f": "revive", "value": test["nodes"]}


def recluster_gen(test, ctx):
    return {"type": "info", "f": "recluster", "value": test["nodes"]}


def killer_gen(opts):
    """Mix of kills, restarts, and (unless no-revives) revive+recluster
    pairs (`nemesis.clj:78-94`)."""
    patterns = [[kill_gen], [restart_gen]]
    if not opts.get("no-revives"):
        patterns.append([revive_gen, recluster_gen])

    def stream():
        while True:
            yield from gen.rng.choice(patterns)

    return stream()


def full_nemesis(opts: dict):
    """Partitions + capped kills + clock faults (`nemesis.clj:96-112`)."""
    return jnemesis.compose([
        (frozenset({"start-partition", "stop-partition"}),
         npartition.partition_random_halves()),
        (frozenset({"kill", "restart", "revive", "recluster"}),
         KillNemesis(signal=15 if opts.get("clean-kill") else 9,
                     max_dead=opts.get("max-dead-nodes", 2))),
        (frozenset({"reset", "bump", "strobe", "check-offsets"}),
         ntime.clock_nemesis()),
    ])


def full_gen(opts: dict):
    parts = []
    if not opts.get("no-clocks"):
        parts.append(ntime.clock_gen())
    if not opts.get("no-kills"):
        parts.append(killer_gen(opts))
    if not opts.get("no-partitions"):
        parts.append(itertools.cycle([
            {"type": "info", "f": "start-partition", "value": None},
            {"type": "info", "f": "stop-partition", "value": None}]))
    return gen.mix(parts) if parts else None


def full_package(opts: dict) -> dict:
    """{:nemesis :generator :final-generator} (`nemesis.clj:126-145`)."""
    return {
        "nemesis": full_nemesis(opts),
        "generator": full_gen(opts),
        "final-generator": [
            {"type": "info", "f": "stop-partition", "value": None},
            {"type": "info", "f": "reset", "value": None},
            gen.once(lambda test, ctx: {"type": "info", "f": "restart",
                                        "value": test["nodes"]}),
            gen.sleep(10),
            gen.once(lambda test, ctx: {"type": "info", "f": "revive",
                                        "value": test["nodes"]}),
            gen.once(lambda test, ctx: {"type": "info", "f": "recluster",
                                        "value": test["nodes"]}),
        ],
    }


# -- workloads ---------------------------------------------------------------

def cas_register_workload(opts) -> dict:
    """Independent CAS registers (`cas_register.clj:80-104`)."""
    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def w(test, ctx):
        return {"type": "invoke", "f": "write",
                "value": gen.rng.randrange(5)}

    def cas(test, ctx):
        return {"type": "invoke", "f": "cas",
                "value": (gen.rng.randrange(5), gen.rng.randrange(5))}

    def fgen(k):
        return gen.limit(100 + gen.rng.randrange(100),
                         gen.reserve(5, r, gen.mix([w, cas, cas])))

    return {
        "client": CasRegisterClient(),
        "generator": independent.concurrent_generator(
            _group_size(opts, 10), _naturals(), fgen),
        "checker": independent.checker(checker.compose({
            "linear": linear.linearizable(models.cas_register(),
                                          device=opts.get("device")),
            "timeline": timeline.html()})),
    }


def counter_workload(opts) -> dict:
    """100:1 add:read mix on one counter key (`counter.clj:68-78`)."""
    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def add(test, ctx):
        return {"type": "invoke", "f": "add", "value": 1}

    return {
        "client": CounterClient(),
        "generator": gen.mix([add] * 100 + [r]),
        # the O(n) bounds checker (reference behavior) plus full
        # linearizability against the device counter model; budgeted —
        # under the kill nemesis, crashed adds accumulate and the
        # search is genuinely exponential past the device slot cap
        "checker": checker.compose({
            "counter": checker.counter(),
            "counter-plot": checker.counter_plot(),
            "linear": linear.linearizable(
                models.counter(),
                budget_s=opts.get("linear-budget-s", 60),
                device=opts.get("device")),
        }),
    }


def set_workload(opts) -> dict:
    """Independent append-sets with a final read phase
    (`set.clj:48-72`)."""
    state = {"max_key": 0}

    def fgen(k):
        state["max_key"] = max(state["max_key"], k)
        counter = {"n": -1}

        def add(test, ctx):
            counter["n"] += 1
            return {"type": "invoke", "f": "add", "value": counter["n"]}

        return gen.limit(500, add)

    def final(test, ctx):
        ks = range(state["max_key"] + 1)
        return independent.sequential_generator(
            ks, lambda k: gen.once(
                {"type": "invoke", "f": "read", "value": None}))

    return {
        "client": SetClient(),
        "generator": independent.concurrent_generator(
            _group_size(opts, 5), _naturals(), fgen),
        "final-generator": gen.derefer(final),
        "checker": independent.checker(checker.set_checker()),
    }


def pause_workload(opts) -> dict:
    """The lost-writes pause state machine (`pause.clj:180-233`):
    writes flow; a master is paused (SIGSTOP) with writes in flight;
    after a successful write post-pause the cluster idles past the
    commit window; the master resumes and may stomp the accepted
    writes. States: healthy -> paused -> wait -> healthy."""
    state = {"state": "healthy", "masters": [], "keys": [0],
             "next_key": 0, "lock": threading.Lock(), "value": [-1]}

    def next_healthy(test):
        nodes = list(test["nodes"])
        gen.rng.shuffle(nodes)
        k0 = state["keys"][-1] + 1
        per = max(1, test.get("concurrency", 5) // len(nodes))
        state.update(state=("healthy"), masters=nodes[:1],
                     keys=list(range(k0, k0 + per)))

    class PauseNemesis(jnemesis.Nemesis):
        def setup(self, test):
            return self

        def invoke(self, test, op):
            def per_node(test, node):
                with control.su():
                    if op["f"] == "pause":
                        _meh("killall", "-19", "asd")
                        return "paused"
                    _meh("killall", "-18", "asd")
                    return "resumed"

            v = control.on_nodes(test, per_node, op["value"])
            with state["lock"]:
                if op["f"] == "pause":
                    state["state"] = "paused"
                else:
                    next_healthy(test)
            return {**op, "value": v}

        def teardown(self, test):
            pass

    class PauseClient(SetClient):
        SET = "pause"

        def invoke(self, test, op):
            r = super().invoke(test, op)
            if op["f"] == "add" and r["type"] == "ok":
                with state["lock"]:
                    if state["state"] == "paused":
                        state["state"] = "wait"
            return r

    def nemesis_gen(test, ctx):
        with state["lock"]:
            s = state["state"]
        if s == "healthy":
            return gen.delay(
                opts.get("healthy-delay", 0.5),
                [{"type": "info", "f": "pause",
                  "value": list(state["masters"])}])
        if s == "wait":
            return gen.delay(
                opts.get("pause-delay", 1.0),
                [{"type": "info", "f": "resume",
                  "value": list(state["masters"])}])
        return gen.sleep(0.05)

    def client_gen(test, ctx):
        with state["lock"]:
            if state["state"] == "wait":
                return gen.sleep(0.05)
            keys = state["keys"]
            state["value"][0] += 1
            v = state["value"][0]
        return {"type": "invoke", "f": "add",
                "value": independent.ktuple(keys[v % len(keys)], v)}

    def final(test, ctx):
        ks = range(state["keys"][-1] + 1)
        return independent.sequential_generator(
            ks, lambda k: gen.once(
                {"type": "invoke", "f": "read", "value": None}))

    return {
        "client": PauseClient(),
        "generator": client_gen,
        "final-generator": gen.derefer(final),
        "checker": independent.checker(checker.set_checker()),
        "nemesis-package": {
            "nemesis": PauseNemesis(),
            "generator": nemesis_gen,
            "final-generator": gen.once(
                lambda test, ctx: {"type": "info", "f": "resume",
                                   "value": test["nodes"]}),
        },
    }


def _group_size(opts: dict, preferred: int) -> int:
    """The reference pins concurrent-generator group sizes (10 for
    cas-register, 5 for set) and requires thread count divisible by
    them; adapt to the test's actual concurrency."""
    conc = int(opts.get("concurrency", preferred) or preferred)
    for d in range(min(preferred, conc), 0, -1):
        if conc % d == 0:
            return d
    return 1


def _naturals():
    k = 0
    while True:
        yield k
        k += 1


WORKLOADS = {
    "cas-register": cas_register_workload,
    "counter": counter_workload,
    "set": set_workload,
    "pause": pause_workload,
}


def aerospike_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "cas-register")
    workload = WORKLOADS[workload_name](opts)
    d = db({k: opts.get(k) for k in ("replication-factor",
                                     "heartbeat-interval",
                                     "commit-to-device", "clean-kill")})
    if "nemesis-package" in workload:
        # pause couples workload and nemesis (core.clj workload+nemesis)
        pkg = workload.pop("nemesis-package")
    else:
        faults = [f for f in (opts.get("faults") or []) if f != "none"]
        # the reference composes its own full nemesis stack rather
        # than the std packages (`core.clj:40-77`)
        pkg = full_package(opts) if faults else None
    return std_test(opts, name=f"aerospike-{workload_name}", db=d,
                    workload=workload, nemesis_package=pkg,
                    default_faults=())


OPT_SPEC = std_opts(cli, WORKLOADS, "cas-register") + [
    cli.opt("--replication-factor", type=int, default=3,
            help="number of nodes which must store data"),
    cli.opt("--max-dead-nodes", type=int, default=2,
            help="nodes allowed to be down simultaneously"),
    cli.opt("--clean-kill", action="store_true",
            help="SIGTERM instead of SIGKILL"),
    cli.opt("--commit-to-device", action="store_true",
            help="force writes to disk before commit"),
    cli.opt("--heartbeat-interval", type=int, default=150,
            help="heartbeat interval in ms"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": aerospike_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
