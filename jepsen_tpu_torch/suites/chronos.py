"""Chronos test suite — does the job scheduler actually run jobs when
it promised to?

Mirrors Jepsen's `chronos/src/jepsen/{chronos,chronos/checker,
mesosphere}.clj`: a Mesos master/slave + Zookeeper substrate, Chronos
on top, jobs submitted over the HTTP ISO8601 API whose shell commands
log their own start/end times into per-run tempfiles, a final read
that collects every run log from every node, and the *job-run
checker*: expand each job's schedule into target windows
[start, start+epsilon+forgiveness) and match runs to targets — every
target must be satisfied by a distinct completed run.

The reference matches runs to targets with a constraint solver
(`checker.clj:78-190`, loco); because the generator spaces targets so
they never overlap (interval > duration + epsilon + forgiveness,
`chronos.clj:196-206`), disjoint-interval greedy matching is exact and
O(n) — the solver generality is only needed for overlapping targets,
which this suite never produces."""

from __future__ import annotations

import datetime
import json
import logging
import time as _time
import urllib.request

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from ..control import util as cu
from ..control.core import RemoteError
from ..os_ import debian
from . import std_opts, std_test

log = logging.getLogger(__name__)

PORT = 4400
JOB_DIR = "/tmp/chronos-test"
EPSILON_FORGIVENESS = 5   # checker.clj:26-28

DEFAULT_MESOS_VERSION = "0.23.0-1.0.debian81"
DEFAULT_CHRONOS_VERSION = "2.3.4-1.0.81.debian77"


class DB(jdb.DB, jdb.LogFiles):
    """Zookeeper + Mesos master/slave + Chronos
    (`mesosphere.clj:20-150`, `chronos.clj:55-80`)."""

    def __init__(self, mesos_version: str = DEFAULT_MESOS_VERSION,
                 chronos_version: str = DEFAULT_CHRONOS_VERSION):
        self.mesos_version = mesos_version
        self.chronos_version = chronos_version

    def setup(self, test, node):
        zk_connect = "zk://" + ",".join(
            f"{n}:2181" for n in test["nodes"]) + "/mesos"
        with control.su():
            debian.install({"mesos": self.mesos_version,
                            "zookeeper": "3.4.5+dfsg-2",
                            "chronos": self.chronos_version})
            myid = str(test["nodes"].index(node) + 1)
            cu.write_file(myid, "/etc/zookeeper/conf/myid")
            control.exec_("service", "zookeeper", "restart")
            cu.write_file(zk_connect, "/etc/mesos/zk")
            cu.write_file(str(len(test["nodes"]) // 2 + 1),
                          "/etc/mesos-master/quorum")
            control.exec_("service", "mesos-master", "restart")
            control.exec_("service", "mesos-slave", "restart")
            # lower the scheduler horizon so frequent jobs still run
            # (`chronos.clj:44-48`)
            cu.write_file("1", "/etc/chronos/conf/schedule_horizon")
            control.exec_("mkdir", "-p", JOB_DIR)
            control.exec_("service", "chronos", "restart")
            cu.await_tcp_port(PORT)

    def teardown(self, test, node):
        with control.su():
            for svc in ("chronos", "mesos-slave", "mesos-master",
                        "zookeeper"):
                try:
                    control.exec_("service", svc, "stop")
                except RemoteError:
                    pass
            cu.grepkill("chronos")
            try:
                control.exec_("rm", "-rf", JOB_DIR)
            except RemoteError:
                pass

    def log_files(self, test, node):
        return ["/var/log/mesos/mesos-master.INFO",
                "/var/log/messages"]


def db(mesos_version: str = DEFAULT_MESOS_VERSION,
       chronos_version: str = DEFAULT_CHRONOS_VERSION) -> DB:
    return DB(mesos_version, chronos_version)


def interval_str(job: dict) -> str:
    """ISO8601 repeating interval (`chronos.clj:101-107`)."""
    return (f"R{job['count']}/{job['start']}"
            f"/PT{job['interval']}S")


def command_str(job: dict) -> str:
    """The job logs its own name + start/end times to a tempfile
    (`chronos.clj:109-117`)."""
    return (f"MEW=$(mktemp -p {JOB_DIR}); "
            f"echo \"{job['name']}\" >> $MEW; "
            f"date -u +%s.%N >> $MEW; "
            f"sleep {job['duration']}; "
            f"date -u +%s.%N >> $MEW;")


class Client(jclient.Client):
    """Submit jobs over HTTP; read runs by catting every run log on
    every node (`chronos.clj:134-192`)."""

    def __init__(self, timeout_s: float = 10.0):
        self.timeout_s = timeout_s
        self.base: str | None = None
        self.node = None

    def open(self, test, node):
        c = Client(self.timeout_s)
        fn = test.get("chronos-url-fn")
        c.base = fn(node) if fn else f"http://{node}:{PORT}"
        c.node = node
        return c

    def add_job(self, job: dict):
        body = json.dumps({
            "name": str(job["name"]),
            "command": command_str(job),
            "schedule": interval_str(job),
            "scheduleTimeZone": "UTC",
            "owner": "jepsen@jepsen.io",
            "epsilon": f"PT{job['epsilon']}S",
            "mem": 1, "disk": 1, "cpus": 0.001, "async": False,
        }).encode()
        req = urllib.request.Request(
            self.base + "/scheduler/iso8601", data=body,
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=self.timeout_s).read()

    def read_runs(self, test) -> list:
        """Collect every run log from every node over the control
        sessions (`chronos.clj:161-172`)."""
        runs = []
        sessions = test.get("sessions") or {}
        for node, sess in sessions.items():
            with control.with_session(node, sess):
                try:
                    files = control.exec_("ls", JOB_DIR).split()
                except RemoteError:
                    continue
                for f in files:
                    try:
                        content = control.exec_(
                            "cat", f"{JOB_DIR}/{f}")
                    except RemoteError:
                        continue
                    lines = content.split("\n")
                    if not lines or not lines[0].strip():
                        continue
                    runs.append({
                        "node": node,
                        "name": int(lines[0]),
                        "start": float(lines[1])
                        if len(lines) > 1 and lines[1] else None,
                        "end": float(lines[2])
                        if len(lines) > 2 and lines[2] else None,
                    })
        return runs

    def invoke(self, test, op):
        try:
            if op["f"] == "add-job":
                self.add_job(op["value"])
                return {**op, "type": "ok"}
            if op["f"] == "read":
                return {**op, "type": "ok",
                        "value": self.read_runs(test),
                        "read-time": _time.time()}
            raise ValueError(f"unknown f {op['f']!r}")
        except (OSError, RemoteError) as e:
            return {**op, "type": "fail", "error": str(e)}


# -- the job-run checker (`checker.clj`) -------------------------------------

def job_targets(read_time: float, job: dict) -> list:
    """[start, deadline) windows for runs that must have begun by
    read_time (`checker.clj:30-47`)."""
    out = []
    finish = read_time - job["epsilon"] - job["duration"]
    t = job["start_epoch"]
    for _ in range(job["count"]):
        if t >= finish:
            break
        out.append((t, t + job["epsilon"] + EPSILON_FORGIVENESS))
        t += job["interval"]
    return out


def job_solution(read_time: float, job: dict, runs: list) -> dict:
    """Greedy disjoint-interval matching of completed runs to targets
    (`checker.clj:79-190`; exact here because the generator keeps
    targets disjoint)."""
    complete = sorted((r for r in runs if r.get("end")),
                      key=lambda r: r["start"])
    incomplete = [r for r in runs if not r.get("end")]
    targets = job_targets(read_time, job)
    solution = {}
    used = set()
    ri = 0
    valid = True
    for (start, end) in targets:
        hit = None
        while ri < len(complete):
            r = complete[ri]
            if r["start"] < start:
                ri += 1
                continue
            if r["start"] >= end:
                break
            hit = r
            used.add(id(r))
            ri += 1
            break
        solution[(start, end)] = hit
        if hit is None:
            valid = False
    return {
        "valid?": valid,
        "job": {k: job[k] for k in ("name", "count", "interval",
                                    "epsilon", "duration")},
        "solution": {f"{s:.0f}..{e:.0f}":
                     (None if r is None else r["start"])
                     for (s, e), r in solution.items()},
        "extra": [r["start"] for r in complete
                  if id(r) not in used][:16],
        "complete": len(complete),
        "incomplete": len(incomplete),
    }


class JobRunChecker(checker.Checker):
    """Every job's schedule must be satisfied by distinct completed
    runs (`checker.clj:191-214`)."""

    def check(self, test, hist, opts):
        jobs = [o["value"] for o in hist
                if o.get("type") == "ok" and o.get("f") == "add-job"]
        read = None
        for o in reversed(list(hist)):
            if o.get("type") == "ok" and o.get("f") == "read":
                read = o
                break
        if read is None:
            return {"valid?": "unknown", "error": "no final read"}
        read_time = read.get("read-time")
        if read_time is None:
            # no wall-clock on the read: unknown, never vacuously valid
            return {"valid?": "unknown",
                    "error": "final read carries no read-time"}
        runs_by_name: dict = {}
        for r in read["value"]:
            runs_by_name.setdefault(r["name"], []).append(r)
        solns = {j["name"]: job_solution(read_time, j,
                                         runs_by_name.get(j["name"],
                                                          []))
                 for j in jobs}
        return {
            "valid?": all(s["valid?"] for s in solns.values()),
            "jobs": solns,
            "job-count": len(jobs),
            "read-time": read_time,
        }


def add_job_gen(opts):
    """Jobs spaced so runs never overlap (`chronos.clj:194-216`)."""
    state = {"id": 0}

    def make(test, ctx):
        state["id"] += 1
        duration = gen.rng.randrange(10)
        epsilon = 10 + gen.rng.randrange(20)
        interval = (1 + duration + epsilon + EPSILON_FORGIVENESS
                    + gen.rng.randrange(30))
        # run logs record absolute epoch seconds (`date -u +%s.%N`),
        # so schedules must be absolute wall-clock ISO8601 datetimes
        # too (`chronos.clj:86-107`). Whole seconds: the ISO schedule
        # has second granularity, and a fractional start_epoch would
        # put the checker's windows fractionally *after* the scheduled
        # runs. Negative delays schedule jobs in the past — hermetic
        # tests use that to make run windows due immediately.
        start = float(int(_time.time() + opts.get("job-start-delay", 10)))
        iso = datetime.datetime.fromtimestamp(
            start, datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ")
        return {"type": "invoke", "f": "add-job", "value": {
            "name": state["id"],
            "start_epoch": start,
            "start": iso,
            "count": 1 + gen.rng.randrange(99),
            "duration": duration,
            "epsilon": epsilon,
            "interval": interval,
        }}

    return make


def jobs_workload(opts) -> dict:
    return {
        "client": Client(),
        "generator": gen.stagger(
            opts.get("job-interval", 30), add_job_gen(opts)),
        "checker": JobRunChecker(),
        "final-generator": gen.once(
            {"type": "invoke", "f": "read", "value": None}),
    }


WORKLOADS = {"jobs": jobs_workload}


def chronos_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "jobs")
    return std_test(
        opts, name=f"chronos-{workload_name}",
        db=db(opts.get("mesos-version", DEFAULT_MESOS_VERSION),
              opts.get("chronos-version", DEFAULT_CHRONOS_VERSION)),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "jobs") + [
    cli.opt("--mesos-version", default=DEFAULT_MESOS_VERSION),
    cli.opt("--chronos-version", default=DEFAULT_CHRONOS_VERSION),
    cli.opt("--job-interval", type=float, default=30,
            help="seconds between job submissions"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": chronos_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
