"""Core orchestrator: entry point for all tests.

The port's own copy of `jepsen_tpu/core.py`.

Coordinates server setup, test execution, fault injection, and result
analysis (reference `jepsen/src/jepsen/core.clj:326-401`). A test is a
plain dict; `run(test)` takes it through the full lifecycle:

1. set up the operating system on every node,
2. teardown-then-setup the database (with primary setup if supported),
3. set up the nemesis and one client per node,
4. drive the generator through the interpreter, journaling a history
   (with test['online'], a streaming checker tails the journal and
   advances the device search *during* the run; with
   test['abort-on-violation'] a confirmed nonlinearizable prefix
   stops the run early),
5. capture DB log files,
6. tear down database and OS,
7. index the history and run the checker — on the card for the
   offloaded checkers; a result already streamed online is reused instead of
   re-checked — writing results to the store.

The run survives its own faults the way the reference does: resources
started in parallel are unwound on partial failure (`with-resources`,
`core.clj:70-91`), logs are snarfed even when the run crashes
(`with-log-snarfing`, `core.clj:150-170`), and the history is persisted
*before* analysis so a crashed checker still leaves data on disk
(`save-1!`, `core.clj:397-398`).
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Callable, Iterable

from . import checker as jchecker
from . import client as jclient
from . import control
from . import db as jdb
from . import nemesis as jnemesis
from . import net as jnet
from . import store, util
from .control import util as cu
from .generator import interpreter
from .history import History

log = logging.getLogger(__name__)

NO_BARRIER = "no-barrier"

# Shutdown-path deadlines (seconds): faults are injected on purpose, so
# a dead node must not be able to hang teardown or log collection.
# Override per test with 'teardown-timeout' / 'snarf-timeout'.
TEARDOWN_TIMEOUT_S = 60.0
SNARF_TIMEOUT_S = 300.0

_snarf_lock = threading.Lock()


def _deadline_s(test: dict, key: str, default: float) -> float:
    v = test.get(key)
    return default if v is None else float(v)


def synchronize(test: dict, timeout_s: float = 60) -> None:
    """Block until all nodes have arrived at the same point
    (`core.clj:44-57`). Used by IO-heavy DB setup code; the default
    60 s timeout keeps one crashed thread from deadlocking the rest."""
    barrier = test.get("barrier")
    if barrier == NO_BARRIER or barrier is None:
        return
    barrier.wait(timeout=timeout_s)


def primary(test: dict) -> str:
    """The test's primary node (`core.clj:65-68`)."""
    return test["nodes"][0]


@contextlib.contextmanager
def with_resources(start: Callable, stop: Callable, resources: Iterable):
    """Start resources in parallel, yield them, and ensure all are
    stopped afterwards — including when some starts fail, in which case
    the ones that did start are stopped and the first error is raised
    (`core.clj:70-91`)."""
    resources = list(resources)

    def start1(r):
        try:
            return True, start(r)
        except Exception as e:  # noqa: BLE001 — fcatch semantics
            return False, e

    results = util.real_pmap(start1, resources)
    started = [v for ok, v in results if ok]
    errors = [v for ok, v in results if not ok]

    def stop_all():
        def stop1(r):
            try:
                stop(r)
            except Exception as e:  # noqa: BLE001
                log.warning("error stopping resource: %s", e)
        util.real_pmap(stop1, started)

    if errors:
        stop_all()
        raise errors[0]
    try:
        yield started
    finally:
        stop_all()


@contextlib.contextmanager
def with_os(test: dict):
    """OS setup on entry, teardown on exit (`core.clj:93-100`)."""
    os = test["os"]
    control.on_nodes(test, os.setup)
    try:
        yield test
    finally:
        control.on_nodes(test, os.teardown)


def _short_paths(full_paths: list[str]) -> dict[str, str]:
    """Map full remote paths to their shortest unambiguous suffixes:
    the common *proper* directory prefix is dropped, so a lone file
    keeps its basename (`util/drop-common-proper-prefix`)."""
    if not full_paths:
        return {}
    split = [p.split("/") for p in full_paths]
    prefix = util.longest_common_prefix(split)
    # proper prefix: never swallow an entire path
    n = min(len(prefix), min(len(s) for s in split) - 1)
    return {p: "/".join(s[n:]) for p, s in zip(full_paths, split)}


def snarf_logs(test: dict) -> None:
    """Download DB log files for each node into the store directory and
    refresh symlinks (`core.clj:102-136`). Downloads run under a
    'snarf-timeout' deadline: this is shutdown-path code, and a dead
    node's hung sftp must not wedge the run that was busy killing it.
    _snarf_lock is taken *inside* the deadlined thread, so an abandoned
    (timed out but still downloading) snarf keeps excluding the next
    one — two snarfs interleaving into the same local files is exactly
    what the lock exists to prevent."""
    db = test["db"]
    if jdb.supports(db, "log-files") and test.get("sessions"):
        log.info("Snarfing log files")

        def snarf1(test, node):
            full_paths = list(db.log_files(test, node) or [])
            for remote, local in _short_paths(full_paths).items():
                if cu.exists(remote):
                    dest = store.make_path(
                        test, str(node), local.lstrip("/"))
                    log.info("downloading %s to %s", remote, dest)
                    try:
                        control.download(remote, dest)
                    except OSError as e:
                        log.info("%s: %s", remote, e)

        def snarf_all():
            with _snarf_lock:
                control.on_nodes(test, snarf1)

        t_s = _deadline_s(test, "snarf-timeout", SNARF_TIMEOUT_S)
        if util.timeout(t_s, snarf_all,
                        default=util.TIMED_OUT) is util.TIMED_OUT:
            log.warning("log snarfing still running after %ss; "
                        "abandoning it and continuing shutdown", t_s)
    if test.get("name"):
        # racing an abandoned snarf is fine: update_symlinks tolerates
        # concurrent callers (symlink errors pass)
        store.update_symlinks(test)


def maybe_snarf_logs(test: dict) -> None:
    """Snarf logs, swallowing all errors — used on the abort path where
    a snarfing error must not supersede the root cause
    (`core.clj:138-148`)."""
    try:
        snarf_logs(test)
    except Exception:  # noqa: BLE001
        log.warning("Error snarfing logs and updating symlinks",
                    exc_info=True)


@contextlib.contextmanager
def with_log_snarfing(test: dict):
    """Evaluate body and ensure logs are snarfed afterwards, on success
    and on crash alike (`core.clj:150-170`)."""
    try:
        yield test
        snarf_logs(test)
    finally:
        maybe_snarf_logs(test)


@contextlib.contextmanager
def with_db(test: dict):
    """DB cycle (teardown+setup, with retries) on entry; teardown on
    exit unless `leave-db-running?` (`core.clj:172-181`)."""
    try:
        with with_log_snarfing(test):
            jdb.cycle(test)
            yield test
    finally:
        if not test.get("leave-db-running?"):
            control.on_nodes(test, test["db"].teardown)


def _spawn(fn, box: list, name: str) -> threading.Thread:
    """Run fn on a daemon thread, capturing ('ok', value) or ('err', e)
    into box. Daemon (not a pool worker) so an abandoned hang can never
    block interpreter exit."""
    def run():
        try:
            box.append(("ok", fn()))
        except BaseException as e:  # noqa: BLE001 — surfaced via box
            box.append(("err", e))

    t = threading.Thread(target=run, name=name, daemon=True)
    t.start()
    return t


@contextlib.contextmanager
def with_client_nemesis_setup_teardown(test: dict):
    """Set up the nemesis (concurrently) and one client per node before
    the body; tear them all down after (`core.clj:183-212`). The set-up
    nemesis replaces test['nemesis'] so the interpreter drives the
    initialized instance.

    Teardown runs under 'teardown-timeout' deadlines: client teardown,
    client close, and nemesis teardown are each bounded, so one dead
    node can't hang the shutdown path (the hung call is abandoned per
    util.timeout semantics and logged)."""
    client = test["client"]
    nemesis = jnemesis.validate(test["nemesis"])
    t_s = _deadline_s(test, "teardown-timeout", TEARDOWN_TIMEOUT_S)

    def open1(node):
        c = client.open(test, node)
        c.setup(test)
        return c

    nbox: list = []
    nth = _spawn(lambda: nemesis.setup(test), nbox, "jepsen nemesis")
    try:
        clients = util.real_pmap(open1, test["nodes"])
    except BaseException:
        # wait out an in-flight nemesis setup before propagating, so
        # the enclosing teardown never runs concurrently with it
        nth.join()
        if nbox and nbox[0][0] == "err":
            log.warning("nemesis setup also failed: %s", nbox[0][1])
        raise
    nth.join()
    tag, val = nbox[0]
    if tag == "err":
        raise val
    test = {**test, "nemesis": val or nemesis}
    try:
        yield test
    finally:
        tbox: list = []
        tth = _spawn(lambda: test["nemesis"].teardown(test), tbox,
                     "jepsen nemesis teardown")

        def close1(c):
            try:
                if util.timeout(t_s, lambda: c.teardown(test),
                                default=util.TIMED_OUT) is util.TIMED_OUT:
                    log.warning("client teardown timed out after %ss; "
                                "abandoning it", t_s)
            finally:
                if util.timeout(t_s, lambda: c.close(test),
                                default=util.TIMED_OUT) is util.TIMED_OUT:
                    log.warning("client close timed out after %ss; "
                                "abandoning it", t_s)

        try:
            util.real_pmap(close1, clients)
        finally:
            tth.join(t_s)
            if tth.is_alive():
                log.warning("nemesis teardown still running after %ss; "
                            "abandoning it", t_s)
            elif tbox and tbox[0][0] == "err":
                raise tbox[0][1]


def run_case(test: dict) -> History:
    """Spawn nemesis and clients, run the generator, return the history
    (`core.clj:214-219`)."""
    with with_client_nemesis_setup_teardown(test) as test:
        return interpreter.run(test)


def _salvage_journal(test: dict) -> None:
    """Persist the journal-backed history prefix when the run dies
    before its normal save_1 — checking can always be re-run, but a
    lost history cannot be regenerated. Never raises: the root-cause
    exception is already on its way up."""
    if not test.get("name"):
        return
    try:
        part = store.load_journal(test)
        if part is None:
            return
        done = {k: v for k, v in test.items()
                if k not in ("barrier", "sessions")}
        done["history"] = part
        log.warning("run crashed with %d journaled ops (%d pending "
                    "invocations); writing salvaged history",
                    len(part), len(part.pending()))
        store.save_1(done)
    except Exception:  # noqa: BLE001 — must not mask the root cause
        log.warning("failed to salvage journal-backed history",
                    exc_info=True)


def analyze(test: dict) -> dict:
    """Index the history, run the checker, persist results
    (`core.clj:221-236`)."""
    log.info("Analyzing...")
    test = {**test, "history": History(test["history"]).index()}
    test = {**test,
            "results": jchecker.check_safe(test["checker"], test,
                                           test["history"])}
    log.info("Analysis complete")
    if test.get("name"):
        store.save_2(test)
    return test


def log_results(test: dict) -> dict:
    """Log the results and a verdict (`core.clj:238-251`)."""
    results = test.get("results", {})
    verdict = {
        False: "Analysis invalid! (ﾉಥ益ಥ）ﾉ ┻━┻",
        jchecker.UNKNOWN: ("Errors occurred during analysis, "
                           "but no anomalies found. ಠ~ಠ"),
        True: "Everything looks good! ヽ('ー`)ノ",
    }.get(results.get("valid?"), "")
    err = results.get("error")
    log.info("%s%s\n\n%s", _pstr(results),
             f"\n\n{err}" if err else "", verdict)
    # partial degradation (a checker exhausted its recovery ladder —
    # its verdict is missing) is a different outcome from full
    # recovery (every verdict present; the device faulted en route)
    deg = results.get("degraded-checkers") or \
        (["results"] if results.get("degraded") else [])
    rec = results.get("recovered-checkers") or \
        (["results"]
         if isinstance(results.get("recovered"), dict) else [])
    if deg:
        log.warning("analysis DEGRADED: %s lost their device verdict "
                    "to backend faults past the recovery budget",
                    sorted(deg))
    elif rec:
        from . import report
        detail = "; ".join(filter(None, (
            report.recovery_line(results if k == "results"
                                 else results.get(k))
            for k in sorted(rec))))
        log.info("analysis recovered from backend faults (%s); all "
                 "verdicts are complete%s", sorted(rec),
                 f" — {detail}" if detail else "")
    # tiered verification: which verdicts came from the O(n) screen
    # alone vs escalated to the full search, and which device results
    # carried (passing) ABFT attestation
    scr = results.get("screened-checkers") or \
        (["results"] if results.get("screened")
         and not results.get("escalated") else [])
    esc = results.get("escalated-checkers") or \
        (["results"]
         if isinstance(results.get("escalated"), dict) else [])
    att = results.get("attested-checkers") or \
        (["results"]
         if isinstance(results.get("attested"), dict) else [])
    if scr or esc:
        from . import report
        detail = "; ".join(filter(None, (
            report.tier_line(results if k == "results"
                             else results.get(k))
            for k in sorted(set(scr) | set(esc)))))
        log.info("tier-1 verification: %d screened, %d escalated%s",
                 len(scr), len(esc), f" — {detail}" if detail else "")
    if att:
        log.info("ABFT attestation passed on %s", sorted(att))
    from . import report
    tl = report.telemetry_line(results)
    if tl:
        log.info(tl)
    return test


def _pstr(x: Any, indent: int = 0) -> str:
    pad = " " * indent
    if isinstance(x, dict):
        if not x:
            return "{}"
        lines = [f"{pad} {k!r}: {_pstr(v, indent + 1).lstrip()}"
                 for k, v in x.items()]
        return "{\n" + ",\n".join(lines) + "}"
    return pad + repr(x)


@contextlib.contextmanager
def with_sessions(test: dict):
    """Bind the test's remote + SSH options, open a session to every
    node in parallel, and yield the test with a node→session map under
    'sessions' (`core.clj:274-294`)."""
    with control.with_remote(test.get("remote")), \
            control.with_ssh(test.get("ssh") or {}):
        with with_resources(control.bound_fn(control.session),
                            control.disconnect,
                            test["nodes"]) as sessions:
            yield {**test,
                   "sessions": dict(zip(test["nodes"], sessions))}


@contextlib.contextmanager
def with_logging(test: dict):
    """Per-test log capture into the store directory; crashes are
    logged so they land in the test's own log file
    (`core.clj:296-308`)."""
    store.start_logging(test)
    try:
        log.info("Running test: %s %s", test.get("name"),
                 test.get("start-time"))
        yield test
    except BaseException:
        log.warning("Test crashed!", exc_info=True)
        raise
    finally:
        store.stop_logging()


def prepare_test(test: dict) -> dict:
    """Ensure start-time, concurrency, and barrier fields; required
    before accessing the test's store directory (`core.clj:310-324`).
    Validates the node list: a duplicated node would open two control
    sessions to the same host and only surface much later as a
    port-bind error on the node, so it fails HERE with a clear
    message (the CLI's parse_nodes applies the same rule to --node/
    --nodes/--nodes-file; this covers programmatically-built tests)."""
    test = dict(test)
    nodes = list(test.get("nodes") or [])
    dupes = sorted({n for n in nodes if nodes.count(n) > 1})
    if dupes:
        raise ValueError(
            f"test 'nodes' lists node(s) more than once: "
            f"{', '.join(str(n) for n in dupes)} — each node gets one "
            f"control session and one client; a duplicate would only "
            f"fail later as a bind error on the node")
    if not test.get("start-time"):
        test["start-time"] = store.start_time()
    if not test.get("concurrency"):
        test["concurrency"] = len(test.get("nodes") or [])
    if not test.get("barrier"):
        n = len(test.get("nodes") or [])
        test["barrier"] = threading.Barrier(n) if n > 0 else NO_BARRIER
    test.setdefault("os", _default_os())
    test.setdefault("db", jdb.noop)
    test.setdefault("client", jclient.noop)
    test.setdefault("nemesis", jnemesis.noop)
    test.setdefault("checker", jchecker.unbridled_optimism())
    return test


def _default_os():
    from . import os_ as jos
    return jos.noop


def run(test: dict) -> dict:
    """Run a test end to end and return it with 'history' and 'results'
    (`core.clj:326-401`). See the module docstring for the lifecycle;
    the docstring of the reference `run!` documents the test-map keys,
    which this accepts unchanged (string keys)."""
    test = prepare_test(test)
    jnet.clear_ip_cache()
    with with_logging(test):
        with with_sessions(test) as stest:
            with with_os(stest), with_db(stest):
                oc = _maybe_online(stest)
                if oc is not None:
                    stest = {**stest, "online-checker": oc}
                with util.relative_time():
                    try:
                        hist = run_case(stest)
                    except BaseException:
                        # the journal-backed prefix is still written
                        # even when the run itself dies
                        if oc is not None:
                            oc.close()
                        _salvage_journal(stest)
                        raise
                # strip run-state the analysis/persistence layers must
                # not see (reference dissoc, core.clj:393-395)
                done = {k: v for k, v in stest.items()
                        if k not in ("barrier", "sessions",
                                     "online-checker")}
                done["history"] = hist
                if oc is not None:
                    streamed = oc.finalize()
                    if streamed:
                        done["streamed-results"] = streamed
                        finished = sorted(set(streamed)
                                          - {"degraded", "error",
                                             "ladder"})
                        if streamed.get("degraded"):
                            # targets WITH a streamed verdict keep it;
                            # the crash cost the ones without, and the
                            # offline re-check path covers exactly those
                            lost = sorted(set(oc.targets) -
                                          set(finished))
                            log.warning(
                                "Online checker degraded (driver "
                                "crashed); falling through to the "
                                "offline re-check path for %s",
                                lost or "no targets (all verdicts "
                                        "streamed before the crash)")
                        else:
                            log.info("Online verification finished %s "
                                     "during the run", finished)
                    if oc.aborted:
                        done["aborted-on-violation"] = True
                log.info("Run complete, writing")
                if done.get("name"):
                    store.save_1(done)
            done = analyze(done)
        return log_results(done)


def _maybe_online(test: dict):
    """The streaming/online checker for a test that asked for one, or
    None — never raises: online checking is an optimization and its
    setup failing must not kill the run. A test with a 'service'
    address (CLI --service) attaches to the persistent verification
    service instead of spawning an in-process OnlineChecker; a
    refused/unreachable service falls back to the local online path
    when the test also asked for 'online', else to plain offline."""
    try:
        if test.get("service"):
            from . import service as _service
            sc = _service.maybe_attach(test, device=test.get("device"))
            if sc is not None:
                return sc
            if not test.get("online"):
                return None
        from .checker import streaming
        return streaming.maybe_online(test)
    except Exception:  # noqa: BLE001
        log.warning("online verification setup failed; running "
                    "offline only", exc_info=True)
        return None
