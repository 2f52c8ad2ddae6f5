"""Command line interface: utilities for test suites to build their own
runners.

The port's copy of the runner half of `jepsen_tpu/cli.py` (reference
`jepsen/src/jepsen/cli.clj`): the shared test option spec (:64-111),
option post-processing (ssh-map renaming, node-list merging, `3n`
concurrency parsing, :143-254), the `test`/`analyze` commands
(:355-430), `test-all` (:432-518), and the runner's exit-code contract
(:127-139):

  0     all tests passed
  1     some test failed
  2     some test had unknown validity
  254   invalid arguments
  255   internal error

Two differences from the JAX package. Every command takes ``--device``
(CUDA by default): `test_opt_fn` resolves it with
`_platform.resolve_device`, so without a card and without ``--device
cpu`` a command exits 254 with that function's message and never runs
on the CPU quietly; the resolved name lands in the options as
'device', which the port's workloads pass to their checkers. And there
is no compilation cache to enable: the port's kernels are built once
into its own git-ignored build directory (`_build.py`).
"""

from __future__ import annotations

import argparse
import logging
import pprint as _pprint
import re
import sys
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

