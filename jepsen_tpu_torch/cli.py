"""Command line interface: utilities for test suites to build their own
runners, and the port's command set.

The port's copy of `jepsen_tpu/cli.py` (reference
`jepsen/src/jepsen/cli.clj`): the shared test option spec (:64-111),
option post-processing (ssh-map renaming, node-list merging, `3n`
concurrency parsing, :143-254), the `test`/`analyze` commands
(:355-430), `test-all` (:432-518), `serve` (:336-353), and the
runner's exit-code contract (:127-139):

  0     all tests passed
  1     some test failed
  2     some test had unknown validity
  254   invalid arguments
  255   internal error

`main(argv)` registers the commands `python -m jepsen_tpu_torch` takes,
as the JAX package's `main` does: `serve` (the results web UI),
`service` (the verification service daemon), `staticcheck` (the
repo's static-analysis gate), `search` (coverage-guided scenario
search) and `chaos` (self-chaos fault-schedule fuzzing).

Two differences from the JAX package. Every command that checks takes
``--device`` (CUDA by default): `test_opt_fn` resolves it with
`_platform.resolve_device`, so without a card and without ``--device
cpu`` a command exits 254 with that function's message (the service
daemon exits 1) and never runs on the CPU quietly; the resolved name
lands in the options as 'device', which the port's workloads and suites
pass to their checkers. And there is no compilation cache to enable: the port's
kernels are built once into its own git-ignored build directory
(`_build.py`).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pprint as _pprint
import re
import subprocess
import sys
import time as _time
from typing import Optional

log = logging.getLogger(__name__)

DEFAULT_NODES = ["n1", "n2", "n3", "n4", "n5"]

TEST_USAGE = """Usage: PROG COMMAND [OPTIONS ...]

Runs a test and exits with a status code:

  0     All tests passed
  1     Some test failed
  2     Some test had an :unknown validity
  254   Invalid arguments
  255   Internal error
"""


def one_of(coll) -> str:
    ks = coll.keys() if isinstance(coll, dict) else coll
    return "Must be one of " + ", ".join(sorted(str(k) for k in ks))


# -- option specs -----------------------------------------------------------
#
# An opt-spec is a list of dicts: {'long': '--name', 'short': '-n', plus
# argparse kwargs}. Suites extend the shared spec; merge_opt_specs
# resolves collisions by long name, preferring the latter (the
# reference's merge-opt-specs, cli.clj:52-59).

def opt(long: str, short: Optional[str] = None, **kw) -> dict:
    return {"long": long, "short": short, **kw}


def merge_opt_specs(a: list, b: list) -> list:
    merged: dict = {}
    for o in list(a) + list(b or []):
        merged[o["long"]] = o
    return list(merged.values())


def _comma_list(s: str) -> list[str]:
    return re.split(r",\s*", s)


def test_opt_spec() -> list[dict]:
    """Shared options for testing (`cli.clj:64-111`)."""
    return [
        # default=None, not DEFAULT_NODES: argparse's append mutates a
        # list default in place; parse_nodes applies the default when no
        # node options were given (reference repeated-opt, cli.clj:27-39)
        opt("--node", "-n", action="append", metavar="HOSTNAME",
            help="Node(s) to run test on; repeat for multiple nodes."),
        opt("--nodes", metavar="NODE_LIST", type=_comma_list,
            help="Comma-separated list of node hostnames."),
        opt("--nodes-file", metavar="FILENAME",
            help="File containing node hostnames, one per line."),
        opt("--username", default="root", help="Username for logins"),
        opt("--password", default="root", help="Password for sudo access"),
        opt("--strict-host-key-checking", action="store_true",
            help="Whether to check host keys"),
        opt("--no-ssh", action="store_true",
            help="Don't establish SSH connections to any nodes."),
        opt("--ssh-private-key", metavar="FILE",
            help="Path to an SSH identity file"),
        opt("--concurrency", default="1n", metavar="NUMBER",
            help="How many workers to run: an integer, optionally "
                 "followed by n (e.g. 3n) to multiply by node count."),
        opt("--leave-db-running", action="store_true",
            help="Leave the database running at the end of the test."),
        opt("--logging-json", action="store_true",
            help="Use JSON structured output in the log."),
        opt("--test-count", type=int, default=1, metavar="NUMBER",
            help="How many times to repeat the test"),
        opt("--time-limit", type=int, default=60, metavar="SECONDS",
            help="How long the test should run, excluding setup/"
                 "teardown, in seconds"),
        opt("--store-dir", default="store", metavar="DIR",
            help="Directory to store test results under"),
        opt("--online", action="store_true",
            help="Verify the history online: a streaming checker "
                 "tails the run's journal and advances the device "
                 "search while the run executes, so analysis latency "
                 "collapses to the unchecked tail."),
        opt("--service", metavar="ADDR", default=None,
            help="Attach this run's journal stream to a persistent "
                 "verification service (see the `service` command) "
                 "at ADDR (host:port, or a unix socket path) instead "
                 "of spawning an in-process online checker. A "
                 "refused or unreachable service falls back to local "
                 "checking; a shed (overloaded) stream is verified "
                 "offline from its journal."),
        opt("--abort-on-violation", action="store_true",
            help="With --online: abort the run as soon as the "
                 "streaming checker confirms a nonlinearizable "
                 "prefix, saving the remaining cluster time."),
        opt("--max-recovery-retries", type=int, default=None,
            metavar="N",
            help="Device-fault recovery budget for the checkers: a "
                 "classified backend fault (OOM, device loss, compile "
                 "failure, wedged sync, attestation corruption) is "
                 "absorbed and retried down the recovery ladder at "
                 "most N times per checking entry before falling back "
                 "to a degraded 'unknown' (default 3)."),
        opt("--tier", default=None, choices=["full", "screen"],
            help="Verification tier: 'screen' runs the O(n) "
                 "invariant screen over every history and escalates "
                 "to the full WGL/Elle device search only on "
                 "suspicion or a sampled fraction (see "
                 "--screen-sample); 'full' (default) always runs the "
                 "full search."),
        opt("--device", default=None, metavar="DEV",
            help="Where the run's checkers run: cuda (the default; "
                 "the command fails without a card) or cpu (the plain "
                 "PyTorch path)."),
        opt("--screen-sample", type=float, default=None,
            metavar="FRACTION",
            help="With --tier screen: the fraction of clean "
                 "(suspicion-free) histories that still escalate to "
                 "a full check, auditing the screen's blind spots "
                 "(default 0.05; scaled down for histories whose "
                 "modeled full-check cost is high)."),
    ]


def tarball_opt(default: str) -> dict:
    """--tarball URL option (`cli.clj:113-125`)."""
    return opt("--tarball", metavar="URL", default=default,
               help="URL for the DB package to install (file://, "
                    "http://, or https://, ending .tar/.tgz/.zip).")


class _Parser(argparse.ArgumentParser):
    """argparse, but invalid arguments exit 254 (`cli.clj:324-326`)."""

    def error(self, message):
        self.print_usage(sys.stderr)
        print(f"{self.prog}: error: {message}", file=sys.stderr)
        raise SystemExit(254)


def build_parser(prog: str, spec: list[dict]) -> _Parser:
    p = _Parser(prog=prog)
    for o in spec:
        args = [s for s in (o.get("short"), o["long"]) if s]
        kw = {k: v for k, v in o.items() if k not in ("short", "long")}
        p.add_argument(*args, **kw)
    return p


# -- option post-processing (`cli.clj:150-254`) -----------------------------

def parse_concurrency(opts: dict, key: str = "concurrency") -> dict:
    """'3n' -> 3 * node count; plain integers pass through."""
    c = str(opts[key])
    m = re.fullmatch(r"(\d+)(n?)", c)
    if not m:
        raise ValueError(f"--{key} {c} should be an integer optionally "
                         "followed by n")
    unit = len(opts["nodes"]) if m.group(2) == "n" else 1
    opts[key] = int(m.group(1)) * unit
    return opts


def parse_nodes(opts: dict) -> dict:
    """Merge --node / --nodes / --nodes-file into opts['nodes']
    (`cli.clj:170-205`)."""
    node = opts.pop("node", None)
    nodes = opts.pop("nodes", None)
    nodes_file = opts.pop("nodes_file", None)
    if node is None and not (nodes or nodes_file):
        node = list(DEFAULT_NODES)
    from_file = []
    if nodes_file:
        with open(nodes_file) as f:
            from_file = [ln.strip() for ln in f if ln.strip()]
    merged = list(from_file) + list(nodes or []) + list(node or [])
    dupes = sorted({n for n in merged if merged.count(n) > 1})
    if dupes:
        # complain early: a duplicated node would open two control
        # sessions to the same host and only fail much later as a
        # port-bind error on the node
        raise ValueError(f"node(s) listed more than once: "
                         f"{', '.join(dupes)}")
    opts["nodes"] = merged
    return opts


def parse_device(opts: dict) -> dict:
    """Resolve --device (CUDA unless named) to the name the run's
    checkers take; a missing card is a bad argument, not a crash."""
    from ._platform import resolve_device
    try:
        opts["device"] = str(resolve_device(opts.get("device")))
    except RuntimeError as e:
        raise ValueError(str(e)) from e
    return opts


def rename_ssh_options(opts: dict) -> dict:
    """Move SSH options under opts['ssh'] (`cli.clj:223-242`)."""
    opts["ssh"] = {
        "dummy": bool(opts.pop("no_ssh", False)),
        "username": opts.pop("username", "root"),
        "password": opts.pop("password", "root"),
        "strict-host-key-checking":
            bool(opts.pop("strict_host_key_checking", False)),
        "private-key-path": opts.pop("ssh_private_key", None),
    }
    return opts


def test_opt_fn(opts: dict) -> dict:
    """The standard option pipeline (`cli.clj:245-254`)."""
    opts = rename_ssh_options(opts)
    opts["leave-db-running?"] = bool(opts.pop("leave_db_running", False))
    opts["logging"] = {"json?": bool(opts.pop("logging_json", False))}
    opts["store-dir"] = opts.pop("store_dir", "store")
    if "time_limit" in opts:
        opts["time-limit"] = opts.pop("time_limit")
    if "test_count" in opts:
        opts["test-count"] = opts.pop("test_count")
    parse_nodes(opts)
    parse_concurrency(opts)
    parse_device(opts)
    # argparse stores --some-flag as some_flag; test maps use the
    # hyphenated spelling throughout (a test *is* a map, keyed like the
    # reference's :some-flag keywords) — rename every remaining
    # underscore key so suite opt-specs can't silently miss
    renamed = []
    for k in [k for k in opts if isinstance(k, str) and "_" in k]:
        hy = k.replace("_", "-")
        if hy not in opts:
            opts[hy] = opts.pop(k)
            renamed.append(k)
    if renamed:
        # visible at debug level so an opt_fn that deliberately reads
        # an underscore key can see why it stopped matching
        log.debug("renamed underscore option keys to hyphenated: %s",
                  sorted(renamed))
    return opts


# -- runner -----------------------------------------------------------------

def run(subcommands: dict, argv: Optional[list[str]] = None) -> None:
    """Parse argv and dispatch to a subcommand spec: a dict with
    'opt_spec' (list), 'opt_fn', 'usage', and 'run' (fn(options dict))
    (`cli.clj:258-334`). Exits via SystemExit with the documented
    codes."""
    argv = list(sys.argv[1:] if argv is None else argv)
    command = argv[0] if argv else None
    try:
        if command not in subcommands:
            print("Usage: PROG COMMAND [OPTIONS ...]")
            print("Commands:", ", ".join(sorted(subcommands)))
            raise SystemExit(254)
        spec = subcommands[command]
        parser = build_parser(command, spec.get("opt_spec") or [])
        if spec.get("usage"):
            parser.usage = spec["usage"]
        opts = vars(parser.parse_args(argv[1:]))
        opts["argv"] = argv
        opt_fn = spec.get("opt_fn")
        if opt_fn:
            try:
                opts = opt_fn(opts)
            except (ValueError, OSError) as e:
                # option post-processing failures are user errors, not
                # internal crashes: report and exit 254 per the contract
                print(e, file=sys.stderr)
                raise SystemExit(254)
        runner = spec.get("run") or (lambda o: _pprint.pprint(o))
        runner(opts)
        raise SystemExit(0)
    except SystemExit:
        raise
    except Exception:
        log.critical("Oh jeez, I'm sorry, Jepsen broke. Here's why:",
                     exc_info=True)
        raise SystemExit(255)


def _exit_for_validity(valid) -> Optional[int]:
    from .checker import UNKNOWN
    if valid is False:
        return 1
    if valid == UNKNOWN:
        return 2
    return None


def _resolve_opt_fn(opts: dict):
    """Compose the standard pipeline with a suite's opt_fn, or replace
    it entirely via opt_fn_ (`cli.clj:381-387`)."""
    opt_fn = test_opt_fn
    if opts.get("opt_fn"):
        f = opts["opt_fn"]
        opt_fn = (lambda base: lambda o: f(base(o)))(opt_fn)
    return opts.get("opt_fn_") or opt_fn


def single_test_cmd(opts: dict) -> dict:
    """Builds the `test` and `analyze` commands around a test_fn
    (`cli.clj:355-430`). Options: opt_spec (extra spec entries),
    opt_fn (composed after test_opt_fn), opt_fn_ (replaces it),
    tarball (default URL), usage, test_fn."""
    from . import core

    spec = merge_opt_specs(test_opt_spec(), opts.get("opt_spec") or [])
    if opts.get("tarball"):
        spec = merge_opt_specs(spec, [tarball_opt(opts["tarball"])])
    opt_fn = _resolve_opt_fn(opts)
    test_fn = opts["test_fn"]
    usage = opts.get("usage") or TEST_USAGE

    def run_test(options):
        log.info("Test options:\n%s", _pprint.pformat(options))
        # test_count fallback: an opt_fn_ override replaces the pipeline
        # that remaps argparse's test_count to test-count
        for _ in range(options.get("test-count",
                                   options.get("test_count", 1))):
            test = core.run(test_fn(options))
            code = _exit_for_validity(
                (test.get("results") or {}).get("valid?"))
            if code is not None:
                raise SystemExit(code)

    def run_analyze(options):
        from . import store
        log.info("Test options:\n%s", _pprint.pformat(options))
        cli_test = test_fn(options)
        latest = store.latest(cli_test.get("store-dir", "store"))
        if latest is None:
            raise RuntimeError("Not sure what the last test was")
        stored = store.load_test(latest)
        if stored.get("name") != cli_test.get("name"):
            raise RuntimeError(
                f"Stored test ({stored.get('name')}) and CLI test "
                f"({cli_test.get('name')}) have different names; aborting")
        if stored.get("salvaged-from-journal"):
            # crashed/killed run: the checkable prefix came from the
            # write-ahead journal; its tail may be pending invocations
            h = stored["history"]  # load_test set it alongside the flag
            log.warning(
                "analyzing a history salvaged from journal.jsonl "
                "(%d ops, %d pending invocations); the run died before "
                "writing history.jsonl.gz", len(h), len(h.pending()))
        stored.pop("results", None)
        test = {**cli_test, **stored}
        core.analyze(test)

    return {
        "test": {"opt_spec": spec, "opt_fn": opt_fn, "usage": usage,
                 "run": run_test},
        "analyze": {"opt_spec": spec, "opt_fn": opt_fn, "usage": usage,
                    "run": run_analyze},
    }


def test_all_run_tests(tests) -> dict:
    """Run tests, returning {outcome: [store paths]} where outcome is
    True/False/'unknown'/'crashed' (`cli.clj:432-448`)."""
    from . import core, store
    out: dict = {}
    for test in tests:
        try:
            # inside the try: a test map prepare_test rejects (e.g.
            # duplicate nodes) records as 'crashed' without aborting
            # the rest of the sweep (dir_name tolerates the missing
            # start-time)
            test = core.prepare_test(test)
            done = core.run(test)
            key = (done.get("results") or {}).get("valid?")
        except Exception:
            log.warning("Test crashed", exc_info=True)
            key = "crashed"
        out.setdefault(key, []).append(store.dir_name(test))
    return out


def test_all_print_summary(results: dict) -> dict:
    """(`cli.clj:450-478`)"""
    from .checker import UNKNOWN
    print("\n")
    for key, heading in ((True, "Successful tests"),
                         (UNKNOWN, "Indeterminate tests"),
                         ("crashed", "Crashed tests"),
                         (False, "Failed tests")):
        if results.get(key):
            print(f"\n# {heading}\n")
            for path in results[key]:
                print(path)
    print()
    print(len(results.get(True, [])), "successes")
    print(len(results.get(UNKNOWN, [])), "unknown")
    print(len(results.get("crashed", [])), "crashed")
    print(len(results.get(False, [])), "failures")
    return results


def test_all_exit(results: dict) -> None:
    """255 if any crashed, 2 if unknown, 1 if invalid, else 0
    (`cli.clj:480-488`)."""
    from .checker import UNKNOWN
    if results.get("crashed"):
        raise SystemExit(255)
    if results.get(UNKNOWN):
        raise SystemExit(2)
    if results.get(False):
        raise SystemExit(1)
    raise SystemExit(0)


def test_all_cmd(opts: dict) -> dict:
    """The `test-all` command around a tests_fn producing a sequence of
    tests (`cli.clj:490-518`)."""
    spec = merge_opt_specs(test_opt_spec(), opts.get("opt_spec") or [])
    opt_fn = _resolve_opt_fn(opts)
    tests_fn = opts["tests_fn"]

    def run_all(options):
        log.info("CLI options:\n%s", _pprint.pformat(options))
        test_all_exit(test_all_print_summary(
            test_all_run_tests(tests_fn(options))))

    return {"test-all": {"opt_spec": spec, "opt_fn": opt_fn,
                         "usage": "Runs all tests", "run": run_all}}



def serve_cmd() -> dict:
    """The `serve` web-server command (`cli.clj:336-353`)."""
    def run_serve(options):
        from . import web
        server = web.serve(options)
        log.info("Listening on http://%s:%s/",
                 options.get("host"), server.server_address[1])
        print(f"Listening on http://{options.get('host')}:"
              f"{server.server_address[1]}/", flush=True)
        try:
            while True:
                _time.sleep(1)
        except KeyboardInterrupt:
            server.shutdown()

    def serve_opt_fn(o):
        o["store-dir"] = o.pop("store_dir", "store")
        return o

    return {"serve": {
        "opt_spec": [
            opt("--host", "-b", default="0.0.0.0",
                help="Hostname to bind to"),
            opt("--port", "-p", type=int, default=8080,
                help="Port number to bind to"),
            opt("--store-dir", default="store", metavar="DIR",
                help="Store directory to serve"),
        ],
        "opt_fn": serve_opt_fn,
        "run": run_serve,
    }}


def _service_status(addr: str) -> int:
    """`service status ADDR`: query a running service's `status` socket
    verb and pretty-print per-stream state, ladder tier, budget capacity
    and calibration coefficients."""
    from . import service as _service
    try:
        sock = _service._connect(addr)
    except OSError as e:
        print(f"service {addr}: unreachable ({e})", file=sys.stderr)
        return 1
    try:
        sock.sendall(b'{"type": "status", "id": 1}\n')
        with sock.makefile("r", encoding="utf-8") as rf:
            line = rf.readline()
    finally:
        sock.close()
    try:
        st = (json.loads(line) or {}).get("status") or {}
    except ValueError:
        print(f"service {addr}: bad reply {line!r}", file=sys.stderr)
        return 1
    print(f"service {st.get('state', '?')}, "
          f"uptime {st.get('uptime_s', 0):g}s, "
          f"{st.get('admitted-total', 0)} admitted, "
          f"{st.get('refused-total', 0)} refused")
    streams = st.get("streams") or {}
    if streams:
        print("streams:")
    for name in sorted(streams):
        s = streams[name]
        extra = ""
        if s.get("violation"):
            extra += "  VIOLATION"
        if s.get("suspicion"):
            extra += f"  suspicion={s['suspicion']:g}"
        if s.get("shed-reason"):
            extra += f"  shed: {s['shed-reason']}"
        print(f"  {name:32s} state={s.get('state', '?'):10s} "
              f"tier={s.get('ladder-tier', 'full'):24s} "
              f"queue={s.get('queue-depth', 0):<6d} "
              f"ops={s.get('ops-fed', 0)}{extra}")
    b = st.get("budget") or {}
    if b:
        line = (f"budget: {b.get('available', 0):.3g}/"
                f"{b.get('capacity', 0):.3g} "
                f"{b.get('unit', 'element-ops')} "
                f"(max {b.get('initial', 0):.3g}")
        if b.get("ooms"):
            line += f", {b['ooms']} ooms"
        if b.get("cuts"):
            line += f", {b['cuts']} cuts"
        if b.get("p95-chunk-latency-s") is not None:
            line += f", p95 {b['p95-chunk-latency-s']:.3g}s"
        print(line + ")")
    lad = st.get("ladder") or {}
    tiers = lad.get("tiers") or {}
    if lad:
        parts = [f"{n} {t}" for t, n in tiers.items() if n]
        print(f"ladder: {', '.join(parts) if parts else 'no streams'}"
              f"; {lad.get('transitions', 0)} transitions"
              + ("" if lad.get("adaptive", True)
                 else " (static budget)"))
    cal = st.get("calibration") or {}
    coeffs = cal.get("coefficients") or {}
    if coeffs:
        parts = [f"{v} {c['seconds-per-elementop']:.3g} s/elementop "
                 f"(n={c['observations']})"
                 for v, c in sorted(coeffs.items())]
        print(f"calibration ({cal.get('platform', '?')}): "
              + ", ".join(parts))
    else:
        print(f"calibration ({cal.get('platform', '?')}): cold "
              "(modeled element-op pricing)")
    return 0


def _device_opt(what: str) -> dict:
    return opt("--device", default=None, metavar="DEV",
               help=f"Where {what} run: CUDA by default (refused "
                    "without a card); 'cpu' runs the plain PyTorch "
                    "path.")


def _device_or_254(name: str, device) -> str:
    """The command's device, or exit 254 with `resolve_device`'s
    message (no card and no ``--device cpu``)."""
    from ._platform import resolve_device
    try:
        return str(resolve_device(device))
    except (RuntimeError, ValueError) as e:
        print(f"{name}: {e}", file=sys.stderr)
        raise SystemExit(254)


def service_cmd() -> dict:
    """The persistent-verification-service command: a daemon that
    accepts live journal streams from many concurrent runs over a local
    socket (`test --service ADDR`) and/or by tail-following a store
    directory, multiplexing them into per-stream online checkers
    (service.py). It loads and activates the measured cost model
    (`calibrate`) at start and saves it at drain; SIGTERM drains (every
    stream's carry checkpointed, resume manifests in the runs' store
    dirs) and exits 0. Without a card and without ``--device cpu`` it
    exits 1 with `resolve_device`'s message."""
    def run_service(options):
        from . import calibrate as _calibrate, service as _service
        from ._platform import resolve_device
        action = list(options.get("action") or [])
        if action:
            if action[0] != "status" or len(action) != 2:
                print("usage: python -m jepsen_tpu_torch service status "
                      "ADDR", file=sys.stderr)
                raise SystemExit(2)
            raise SystemExit(_service_status(action[1]))
        try:
            device = resolve_device(options.get("device"))
        except (RuntimeError, ValueError) as e:
            print(f"service: {e}", file=sys.stderr)
            raise SystemExit(1)
        standby = options.get("standby")
        if standby and not options.get("watch"):
            print("--standby requires --watch DIR (the shared store "
                  "root the replicas fence over)", file=sys.stderr)
            raise SystemExit(2)
        # the measured cost model: persisted in the port's cache
        # directory, loaded at start, saved back at drain, so a
        # restarted daemon prices work in measured device-seconds from
        # its first chunk
        cal = _calibrate.Calibration.load(platform=device.type)
        if cal.coefficients():
            log.info("calibration loaded: %s", cal.coefficients())
        _calibrate.activate(cal)
        svc = _service.VerificationService(
            max_streams=options.get("max_streams", 64),
            budget_elementops=float(
                options.get("budget_elementops") or
                _service.DEFAULT_BUDGET_ELEMENTOPS),
            calibration=cal, adaptive=not options.get("static_budget"),
            device=device)
        svc.calibration_path = _calibrate.default_path(cal.platform)
        msrv = None
        if options.get("metrics_port") is not None:
            from . import telemetry
            mhost = options.get("metrics_host") or "127.0.0.1"
            msrv = telemetry.serve_metrics(
                int(options["metrics_port"]), host=mhost,
                healthz=svc.status)
            mport = msrv.server_address[1]
            log.info("metrics on http://%s:%d/metrics "
                     "(/healthz = service status)", mhost, mport)
            print(f"Metrics listening on :{mport}/metrics", flush=True)
        svc.install_sigterm()
        try:
            if standby:
                sb = _service.Standby(
                    svc, standby, options["watch"],
                    bind=options.get("bind") or "127.0.0.1:0")
                print(f"Standby replica watching primary {standby} "
                      f"(store {options['watch']})", flush=True)
                bound = sb.run()    # blocks until promotion (or drain)
                if bound is None:
                    return
            else:
                if options.get("watch"):
                    # claim the store and resume any streams a crashed
                    # predecessor orphaned, then keep tail-following
                    recovered = svc.recover(options["watch"])
                    if recovered:
                        print(f"Recovered {len(recovered)} orphaned "
                              f"stream(s) from {options['watch']}",
                              flush=True)
                    svc.watch(options["watch"])
                    log.info("watching journals under %s",
                             options["watch"])
                bound = svc.serve(options.get("bind") or "127.0.0.1:0")
            print(f"Verification service listening on {bound}",
                  flush=True)
            try:
                while not svc.drained.is_set():
                    _time.sleep(0.5)
            except KeyboardInterrupt:
                svc.drain()
        finally:
            svc.stop()
            if msrv is not None:
                msrv.shutdown()

    return {"service": {
        "opt_spec": [
            opt("action", nargs="*", metavar="ACTION",
                help="Optional subaction: `status ADDR` queries a "
                     "running service and pretty-prints per-stream "
                     "state, ladder tier, budget, and calibration."),
            opt("--bind", "-b", default="127.0.0.1:0", metavar="ADDR",
                help="host:port (port 0 picks a free port) or a unix "
                     "socket path to listen on"),
            opt("--watch", metavar="DIR", default=None,
                help="Also tail-follow journals under this store "
                     "directory. On start, recover() resumes any "
                     "orphaned runs from their durable checkpoints."),
            opt("--standby", metavar="ADDR", default=None,
                help="Run as a warm replica of the primary at ADDR "
                     "(its socket address or http://.../healthz); "
                     "requires --watch DIR (the shared store)."),
            opt("--max-streams", type=int, default=64, metavar="N",
                help="Admission cap on concurrently attached runs."),
            opt("--budget-elementops", type=float, default=None,
                metavar="X",
                help="Global in-flight chunk budget in cost-model "
                     "element-ops, priced into device-seconds through "
                     "the calibration."),
            opt("--static-budget", action="store_true",
                help="Disable the adaptive controller: no AIMD "
                     "capacity tuning and no degradation ladder."),
            opt("--metrics-port", type=int, default=None, metavar="P",
                help="Serve Prometheus metrics at :P/metrics and the "
                     "service status() JSON at :P/healthz (0 picks a "
                     "free port)."),
            opt("--metrics-host", default="127.0.0.1", metavar="HOST",
                help="Interface for --metrics-port (default "
                     "loopback)."),
            _device_opt("the streams"),
        ],
        "usage": "Runs the persistent verification service",
        "run": run_service,
    }}


def staticcheck_cmd() -> dict:
    """`staticcheck`: the repo's static-analysis gate (tools/staticcheck)
    as a subcommand. A thin forwarder to `python -m tools.staticcheck`:
    same flags, same exit codes (0 clean or baselined, 1 with findings).
    Only available from a source checkout, where tools/ lies next to the
    package; elsewhere it exits 254. The gate runs in a child process:
    its `metrics` analyzer imports the JAX package to read that
    package's metric registry, and this process must never hold it."""
    def run_staticcheck(options):
        repo = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        if not os.path.isdir(os.path.join(repo, "tools",
                                          "staticcheck")):
            print("staticcheck: tools/staticcheck not found next to "
                  "the jepsen_tpu_torch package (requires a source "
                  "checkout)", file=sys.stderr)
            raise SystemExit(254)
        argv = list(options.get("targets") or [])
        if options.get("only"):
            argv += ["--only", options["only"]]
        if options.get("baseline"):
            argv += ["--baseline", os.path.abspath(options["baseline"])]
        if options.get("write_baseline"):
            argv.append("--write-baseline")
        if options.get("summary_json"):
            argv.append("--summary-json")
        raise SystemExit(subprocess.run(
            [sys.executable, "-m", "tools.staticcheck", *argv],
            cwd=repo).returncode)

    return {"staticcheck": {
        "opt_spec": [
            opt("targets", nargs="*", metavar="TARGET",
                help="Files/dirs to check (default: the whole tree)"),
            opt("--only", metavar="ANALYZERS",
                help="Comma-separated analyzer subset (style, "
                     "metrics, device-sync, locks, retrace)"),
            opt("--baseline", metavar="PATH",
                help="Baseline file (default: "
                     "tools/staticcheck/baseline.txt)"),
            opt("--write-baseline", action="store_true",
                help="Rewrite the baseline from current findings"),
            opt("--summary-json", action="store_true",
                help="Emit one machine-readable JSON summary line"),
        ],
        "usage": "Runs the static-analysis gate",
        "run": run_staticcheck,
    }}


def search_cmd() -> dict:
    """`search`: one coverage-guided scenario search over generator and
    nemesis schedules. Prints the result as JSON on stdout and one
    summary line on stderr; exits 0 when the budget ends with no
    violation, 1 when one was found (its minimized genome is in the
    output and the --store-dir artifact), 254 on a bad argument or
    without a card and without ``--device cpu``."""
    def run_search(options):
        from . import report
        from .search.driver import SearchConfig, run_search as _run
        from .search.scenario import BUGS, SCENARIOS
        if options.get("workload") not in SCENARIOS:
            print(f"unknown workload {options.get('workload')!r}; "
                  f"have {sorted(SCENARIOS)}", file=sys.stderr)
            raise SystemExit(254)
        if options.get("bug") and options["bug"] not in BUGS:
            print(f"unknown bug {options['bug']!r}; have {sorted(BUGS)}",
                  file=sys.stderr)
            raise SystemExit(254)
        resume = options.get("resume")
        if resume and not os.path.exists(
                os.path.join(resume, "search.json")):
            print(f"--resume: no search.json under {resume!r}",
                  file=sys.stderr)
            raise SystemExit(254)
        device = _device_or_254("search", options.get("device"))
        results = _run(SearchConfig(
            workload=options["workload"],
            generations=options["generations"],
            population=options["population"], seed=options["seed"],
            workers=options["workers"], strategy=options["strategy"],
            escalate=options["escalate"], bug=options.get("bug") or None,
            max_sims=options.get("max_sims"), sample=options["sample"],
            store_dir=options.get("store_dir") or resume,
            resume_dir=resume, device=device))
        print(json.dumps(results, indent=2, sort_keys=True))
        line = report.search_line(results)
        if line:
            print(line, file=sys.stderr)
        raise SystemExit(1 if results["found"] else 0)

    return {"search": {
        "opt_spec": [
            opt("--workload", "-w", default="register",
                help="Search scenario (search.scenario.SCENARIOS)"),
            opt("--generations", "-g", type=int, default=10,
                help="Search generations"),
            opt("--population", "-k", type=int, default=50,
                help="Genomes per generation"),
            opt("--seed", "-s", type=int, default=45100,
                help="Search seed (sampling + mutation)"),
            opt("--workers", type=int, default=4,
                help="Simulation worker threads"),
            opt("--strategy", default="guided",
                choices=["guided", "random"],
                help="guided (coverage feedback) or random "
                     "(uniform draws, the A/B baseline)"),
            opt("--escalate", default="none",
                choices=["none", "host", "batch", "service"],
                help="Full-checker escalation path for suspicious "
                     "histories"),
            opt("--bug", default=None,
                help="Planted executor bug (search.scenario.BUGS; "
                     "demos/tests)"),
            opt("--max-sims", type=int, default=None,
                help="Total simulation budget (default: unlimited "
                     "within generations x population + shrinking)"),
            opt("--sample", type=float, default=0.0,
                help="Clean-history audit escalation fraction"),
            opt("--store-dir", default=None, metavar="DIR",
                help="Write search.json + coverage.bin here"),
            opt("--resume", default=None, metavar="DIR",
                help="Continue a prior search from its store dir "
                     "(reloads search.json + coverage.bin; restored "
                     "simulations keep counting against --max-sims; "
                     "artifacts are rewritten there unless "
                     "--store-dir overrides)"),
            _device_opt("escalations"),
        ],
        "usage": "Coverage-guided scenario search",
        "run": run_search,
    }}


def chaos_cmd() -> dict:
    """`chaos`: coverage-guided fault-schedule fuzzing of the port's
    verification service. Prints the result as JSON on stdout and one
    summary line on stderr; exits 0 when every oracle stayed green, 1
    when a failure was found (its minimized schedule is in the output
    and the --store-dir artifact), 254 on a bad argument or without a
    card and without ``--device cpu``. The oracles are looked up in
    `chaos.driver` when the command runs."""
    def run_chaos(options):
        from . import report
        from .chaos import ChaosConfig, run_chaos as _run
        from .chaos.driver import WORKLOADS
        if options.get("workload") not in WORKLOADS:
            print(f"unknown workload {options.get('workload')!r}; "
                  f"have {sorted(WORKLOADS)}", file=sys.stderr)
            raise SystemExit(254)
        device = _device_or_254("chaos", options.get("device"))
        results = _run(ChaosConfig(
            workload=options["workload"], ops=options["ops"],
            budget=options["budget"], seed=options["seed"],
            strategy=options["strategy"],
            deadline_s=options["deadline_s"],
            shrink=not options.get("no_shrink"),
            store_dir=options.get("store_dir"), device=device))
        print(json.dumps(results, indent=2, sort_keys=True))
        line = report.chaos_line(results)
        if line:
            print(line, file=sys.stderr)
        raise SystemExit(1 if results["found"] else 0)

    return {"chaos": {
        "opt_spec": [
            opt("--workload", "-w", default="register",
                help="Chaos workload (chaos.driver.WORKLOADS)"),
            opt("--ops", type=int, default=256,
                help="Workload ops per schedule"),
            opt("--budget", "-n", type=int, default=40,
                help="Schedule executions (shrink re-runs included)"),
            opt("--seed", "-s", type=int, default=45100,
                help="Chaos seed (sampling + mutation)"),
            opt("--strategy", default="guided",
                choices=["guided", "random"],
                help="guided (coverage feedback) or random "
                     "(uniform draws, the A/B baseline)"),
            opt("--deadline-s", type=float, default=120.0,
                help="Per-schedule verdict deadline (the watchdog "
                     "oracle)"),
            opt("--no-shrink", action="store_true",
                help="Report oracle failures unminimized"),
            opt("--store-dir", default=None, metavar="DIR",
                help="Write chaos.json + coverage.bin here"),
            _device_opt("the services"),
        ],
        "usage": "Self-chaos fault-schedule fuzzing",
        "run": run_chaos,
    }}


def main(argv: Optional[list[str]] = None) -> None:
    """`python -m jepsen_tpu_torch COMMAND ...`: dispatch to one of the
    port's commands; exits via SystemExit with the command's code."""
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s{%(threadName)s} %(levelname)s [%(name)s] "
               "%(message)s")
    run({**serve_cmd(), **service_cmd(), **staticcheck_cmd(),
         **search_cmd(), **chaos_cmd()}, argv)
