"""Per-database test suites (the reference's L7 layer).

Each suite module exposes `test_fn(opts) -> test-map`, a workload menu,
and `main(argv)` wired through the port's `cli` — mirroring how every
reference suite exposes `-main` via `jepsen.cli` (e.g.
`zookeeper/src/jepsen/zookeeper.clj:131-137`).

The port's copies of the JAX package's suites. Every checker a suite
builds takes `device=opts.get("device")`: CUDA unless the options name
another device (the suites' CLIs take ``--device``). `SUITES` names
every suite of the JAX package; `suite(name)` of one the port has not
ported yet raises `ModuleNotFoundError`, as its import would."""

from __future__ import annotations

import importlib
import json
import urllib.request

SUITES = ("etcd", "zookeeper", "hazelcast", "consul", "tidb",
          "cockroach", "disque", "rabbitmq", "galera", "percona",
          "stolon", "postgres_rds", "raftis", "mongodb", "aerospike",
          "mongodb_smartos", "logcabin", "robustirc",
          "mysql_cluster", "rethinkdb", "elasticsearch", "crate",
          "ignite", "chronos", "yugabyte", "faunadb", "dgraph")


def suite(name: str):
    """Load a suite module by name."""
    name = name.replace("-", "_")
    if name not in SUITES:
        raise ValueError(f"unknown suite {name!r}; known: {SUITES}")
    return importlib.import_module(f".{name}", __name__)


def std_test(opts: dict, *, name: str, db, workload: dict,
             os=None, default_faults=("partition",),
             nemesis_package: dict | None = None,
             extra: dict | None = None) -> dict:
    """Assemble the standard suite test map: workload client/checker +
    nemesis package from opts['faults'] + staggered client generator
    under a time limit, then nemesis-final and workload-final phases,
    with the perf/timeline/stats/exceptions checker stack every
    reference suite composes. Mirrors the per-suite test-map builders
    (e.g. `zookeeper.clj:106-129`)."""
    from .. import checker, generator as gen, testkit
    from ..checker import timeline
    from ..nemesis import combined
    from ..os_ import debian

    faults = [f for f in (opts.get("faults") or list(default_faults))
              if f != "none"]
    if nemesis_package is not None:
        # suites with bespoke nemesis stacks (e.g. aerospike's capped
        # kill + revive/recluster) supply the package whole
        pkg = nemesis_package
    elif faults:
        pkg = combined.nemesis_package({
            "db": db, "faults": faults,
            "interval": opts.get("nemesis-interval", 10)})
    else:
        pkg = combined.noop

    rate = float(opts.get("rate", 10))
    time_limit = opts.get("time-limit", opts.get("time_limit", 60))
    client_gen = gen.clients(gen.stagger(1 / rate,
                                         workload["generator"]))
    main_gen = gen.time_limit(
        time_limit,
        gen.any(client_gen, gen.nemesis(pkg["generator"]))
        if pkg.get("generator") else client_gen)
    phases = [main_gen]
    if pkg.get("final-generator"):
        phases.append(gen.nemesis(pkg["final-generator"]))
    if workload.get("final-generator"):
        phases.append(gen.clients(workload["final-generator"]))
    generator = gen.phases(*phases) if len(phases) > 1 else main_gen

    return {
        **testkit.noop_test(),
        **{k: v for k, v in opts.items() if isinstance(k, str)},
        "name": name,
        "os": os if os is not None else debian.os,
        "db": db,
        "client": workload["client"],
        "nemesis": pkg["nemesis"],
        "plot": {"nemeses": pkg.get("perf")},
        "generator": generator,
        "checker": checker.compose({
            "perf": checker.perf_checker(),
            "timeline": timeline.html(),
            "workload": workload["checker"],
            "stats": checker.stats(),
            "exceptions": checker.unhandled_exceptions(),
        }),
        **(extra or {}),
    }


STD_FAULT_CHOICES = ["partition", "kill", "pause", "clock", "none"]


def std_opts(cli, workloads: dict, default_workload: str,
             version_default: str | None = None,
             version_help: str = "version to install") -> list:
    """The shared option spec every suite CLI extends."""
    spec = [
        cli.opt("--workload", "-w", default=default_workload,
                choices=sorted(workloads), help="Which workload to run"),
        cli.opt("--rate", type=float, default=10,
                help="approximate op rate per second"),
        cli.opt("--faults", action="append", choices=STD_FAULT_CHOICES,
                help="faults to inject (repeatable)"),
        cli.opt("--nemesis-interval", type=float, default=10,
                help="seconds between nemesis operations"),
    ]
    if version_default is not None:
        spec.append(cli.opt("--version", default=version_default,
                            help=version_help))
    return spec


def http_post(url: str, body: dict, timeout: float = 5.0) -> dict:
    """POST a JSON body, parse a JSON response — the shared transport
    for HTTP-spoken data planes (etcd's v3 gateway, the CP shim)."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())
