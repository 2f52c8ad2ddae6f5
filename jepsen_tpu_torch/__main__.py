"""The port's command line: the verification service daemon, the
coverage-guided scenario search and the self-chaos harness.

    python -m jepsen_tpu_torch service [--bind ADDR] [--watch DIR]
        [--standby ADDR] [--max-streams N] [--budget-elementops X]
        [--static-budget] [--metrics-port P] [--metrics-host H]
        [--device cpu]
    python -m jepsen_tpu_torch service status ADDR
    python -m jepsen_tpu_torch search [--workload W] [--generations G]
        [--population K] [--seed S] [--workers N] [--strategy S]
        [--escalate none|host|batch|service] [--bug B] [--max-sims N]
        [--sample X] [--store-dir DIR] [--resume DIR] [--device cpu]
    python -m jepsen_tpu_torch chaos [--workload W] [--ops N]
        [--budget N] [--seed S] [--strategy S] [--deadline-s X]
        [--no-shrink] [--store-dir DIR] [--device cpu]

Twins of the JAX package's `service`, `search` and `chaos` commands
(`jepsen_tpu/cli.py`: `service_cmd`, `search_cmd`, `chaos_cmd`), with the
same options, output and exit codes: search and chaos print their
result as JSON on stdout and one summary line on stderr, and exit 0
(nothing found), 1 (a violation or an oracle failure found) or 254 (a
bad argument); an invalid argument to any command exits 254. Each runs
on CUDA unless given ``--device cpu``; without a card it exits non-zero
with `_platform.resolve_device`'s message. The daemon loads and
activates the measured cost model (`calibrate`) at start and saves it
at drain; SIGTERM drains (every stream's carry checkpointed, resume
manifests in the runs' store dirs) and exits 0.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

log = logging.getLogger("jepsen_tpu_torch")


class _Parser(argparse.ArgumentParser):
    """argparse, but an invalid argument exits 254, as in the JAX
    package's CLI."""

    def error(self, message):
        self.print_usage(sys.stderr)
        print(f"{self.prog}: error: {message}", file=sys.stderr)
        raise SystemExit(254)


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


def run_service(options: argparse.Namespace) -> int:
    """The daemon: serve (and/or watch) until drained."""
    from . import calibrate as _calibrate, service as _service
    from ._platform import resolve_device
    action = list(options.action or [])
    if action:
        if action[0] != "status" or len(action) != 2:
            print("usage: python -m jepsen_tpu_torch service status ADDR",
                  file=sys.stderr)
            return 2
        return _service_status(action[1])
    try:
        device = resolve_device(options.device)
    except (RuntimeError, ValueError) as e:
        print(f"service: {e}", file=sys.stderr)
        return 1
    standby = options.standby
    if standby and not options.watch:
        print("--standby requires --watch DIR (the shared store root "
              "the replicas fence over)", file=sys.stderr)
        return 2
    # the measured cost model: persisted in the port's cache directory,
    # loaded at start, saved back at drain, so a restarted daemon prices
    # work in measured device-seconds from its first chunk
    cal = _calibrate.Calibration.load(platform=device.type)
    if cal.coefficients():
        log.info("calibration loaded: %s", cal.coefficients())
    _calibrate.activate(cal)
    svc = _service.VerificationService(
        max_streams=options.max_streams,
        budget_elementops=float(options.budget_elementops
                                or _service.DEFAULT_BUDGET_ELEMENTOPS),
        calibration=cal, adaptive=not options.static_budget,
        device=device)
    svc.calibration_path = _calibrate.default_path(cal.platform)
    msrv = None
    if options.metrics_port is not None:
        from . import telemetry
        mhost = options.metrics_host or "127.0.0.1"
        msrv = telemetry.serve_metrics(int(options.metrics_port),
                                       host=mhost, healthz=svc.status)
        mport = msrv.server_address[1]
        log.info("metrics on http://%s:%d/metrics (/healthz = service "
                 "status)", mhost, mport)
        print(f"Metrics listening on :{mport}/metrics", flush=True)
    svc.install_sigterm()
    try:
        if standby:
            sb = _service.Standby(svc, standby, options.watch,
                                  bind=options.bind or "127.0.0.1:0")
            print(f"Standby replica watching primary {standby} "
                  f"(store {options.watch})", flush=True)
            bound = sb.run()    # blocks until promotion (or drain)
            if bound is None:
                return 0
        else:
            if options.watch:
                # claim the store and resume any streams a crashed
                # predecessor orphaned, then keep tail-following
                recovered = svc.recover(options.watch)
                if recovered:
                    print(f"Recovered {len(recovered)} orphaned "
                          f"stream(s) from {options.watch}", flush=True)
                svc.watch(options.watch)
                log.info("watching journals under %s", options.watch)
            bound = svc.serve(options.bind or "127.0.0.1:0")
        print(f"Verification service listening on {bound}", flush=True)
        try:
            while not svc.drained.is_set():
                time.sleep(0.5)
        except KeyboardInterrupt:
            svc.drain()
    finally:
        svc.stop()
        if msrv is not None:
            msrv.shutdown()
    return 0


def _device_or_254(name: str, device):
    """The command's device, or exit 254 with `resolve_device`'s
    message (no card and no ``--device cpu``)."""
    from ._platform import resolve_device
    try:
        return str(resolve_device(device))
    except (RuntimeError, ValueError) as e:
        print(f"{name}: {e}", file=sys.stderr)
        raise SystemExit(254)


def run_search(options: argparse.Namespace) -> int:
    """`search`: one coverage-guided scenario search. Exits 0 when the
    budget ends with no violation, 1 when one was found (its minimized
    genome is in the output and the --store-dir artifact)."""
    from . import report
    from .search.driver import SearchConfig, run_search as _run
    from .search.scenario import BUGS, SCENARIOS
    if options.workload not in SCENARIOS:
        print(f"unknown workload {options.workload!r}; "
              f"have {sorted(SCENARIOS)}", file=sys.stderr)
        return 254
    if options.bug and options.bug not in BUGS:
        print(f"unknown bug {options.bug!r}; have {sorted(BUGS)}",
              file=sys.stderr)
        return 254
    resume = options.resume
    if resume and not os.path.exists(os.path.join(resume, "search.json")):
        print(f"--resume: no search.json under {resume!r}",
              file=sys.stderr)
        return 254
    device = _device_or_254("search", options.device)
    results = _run(SearchConfig(
        workload=options.workload, generations=options.generations,
        population=options.population, seed=options.seed,
        workers=options.workers, strategy=options.strategy,
        escalate=options.escalate, bug=options.bug or None,
        max_sims=options.max_sims, sample=options.sample,
        store_dir=options.store_dir or resume, resume_dir=resume,
        device=device))
    print(json.dumps(results, indent=2, sort_keys=True))
    line = report.search_line(results)
    if line:
        print(line, file=sys.stderr)
    return 1 if results["found"] else 0


def run_chaos(options: argparse.Namespace) -> int:
    """`chaos`: coverage-guided fault-schedule fuzzing of the port's
    verification service. Exits 0 when every oracle stayed green, 1
    when a failure was found (its minimized schedule is in the output
    and the --store-dir artifact)."""
    from . import report
    from .chaos import ChaosConfig, run_chaos as _run
    from .chaos.driver import WORKLOADS
    if options.workload not in WORKLOADS:
        print(f"unknown workload {options.workload!r}; "
              f"have {sorted(WORKLOADS)}", file=sys.stderr)
        return 254
    device = _device_or_254("chaos", options.device)
    results = _run(ChaosConfig(
        workload=options.workload, ops=options.ops,
        budget=options.budget, seed=options.seed,
        strategy=options.strategy, deadline_s=options.deadline_s,
        shrink=not options.no_shrink, store_dir=options.store_dir,
        device=device))
    print(json.dumps(results, indent=2, sort_keys=True))
    line = report.chaos_line(results)
    if line:
        print(line, file=sys.stderr)
    return 1 if results["found"] else 0


def _search_parser(sub) -> None:
    sp = sub.add_parser("search",
                        help="Coverage-guided scenario search")
    sp.add_argument("--workload", "-w", default="register",
                    help="Search scenario (search.scenario.SCENARIOS)")
    sp.add_argument("--generations", "-g", type=int, default=10,
                    help="Search generations")
    sp.add_argument("--population", "-k", type=int, default=50,
                    help="Genomes per generation")
    sp.add_argument("--seed", "-s", type=int, default=45100,
                    help="Search seed (sampling + mutation)")
    sp.add_argument("--workers", type=int, default=4,
                    help="Simulation worker threads")
    sp.add_argument("--strategy", default="guided",
                    choices=["guided", "random"],
                    help="guided (coverage feedback) or random "
                         "(uniform draws, the A/B baseline)")
    sp.add_argument("--escalate", default="none",
                    choices=["none", "host", "batch", "service"],
                    help="Full-checker escalation path for suspicious "
                         "histories")
    sp.add_argument("--bug", default=None,
                    help="Planted executor bug (search.scenario.BUGS; "
                         "demos/tests)")
    sp.add_argument("--max-sims", type=int, default=None,
                    help="Total simulation budget (default: unlimited "
                         "within generations x population + shrinking)")
    sp.add_argument("--sample", type=float, default=0.0,
                    help="Clean-history audit escalation fraction")
    sp.add_argument("--store-dir", default=None, metavar="DIR",
                    help="Write search.json + coverage.bin here")
    sp.add_argument("--resume", default=None, metavar="DIR",
                    help="Continue a prior search from its store dir "
                         "(reloads search.json + coverage.bin; restored "
                         "simulations keep counting against --max-sims; "
                         "artifacts are rewritten there unless "
                         "--store-dir overrides)")
    sp.add_argument("--device", default=None, metavar="DEV",
                    help="Where escalations run: CUDA by default "
                         "(refused without a card); 'cpu' runs the "
                         "plain PyTorch path.")


def _chaos_parser(sub) -> None:
    sp = sub.add_parser("chaos",
                        help="Self-chaos fault-schedule fuzzing")
    sp.add_argument("--workload", "-w", default="register",
                    help="Chaos workload (chaos.driver.WORKLOADS)")
    sp.add_argument("--ops", type=int, default=256,
                    help="Workload ops per schedule")
    sp.add_argument("--budget", "-n", type=int, default=40,
                    help="Schedule executions (shrink re-runs included)")
    sp.add_argument("--seed", "-s", type=int, default=45100,
                    help="Chaos seed (sampling + mutation)")
    sp.add_argument("--strategy", default="guided",
                    choices=["guided", "random"],
                    help="guided (coverage feedback) or random "
                         "(uniform draws, the A/B baseline)")
    sp.add_argument("--deadline-s", type=float, default=120.0,
                    help="Per-schedule verdict deadline (the watchdog "
                         "oracle)")
    sp.add_argument("--no-shrink", action="store_true",
                    help="Report oracle failures unminimized")
    sp.add_argument("--store-dir", default=None, metavar="DIR",
                    help="Write chaos.json + coverage.bin here")
    sp.add_argument("--device", default=None, metavar="DEV",
                    help="Where the services run: CUDA by default "
                         "(refused without a card); 'cpu' runs the "
                         "plain PyTorch path.")


def parser() -> argparse.ArgumentParser:
    ap = _Parser(
        prog="python -m jepsen_tpu_torch",
        description="The PyTorch/CUDA port's verification service, "
                    "scenario search and self-chaos harness.")
    sub = ap.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("service",
                        help="Runs the persistent verification service")
    sp.add_argument("action", nargs="*", metavar="ACTION",
                    help="Optional subaction: `status ADDR` queries a "
                         "running service and pretty-prints per-stream "
                         "state, ladder tier, budget, and calibration.")
    sp.add_argument("--bind", "-b", default="127.0.0.1:0", metavar="ADDR",
                    help="host:port (port 0 picks a free port) or a unix "
                         "socket path to listen on")
    sp.add_argument("--watch", metavar="DIR", default=None,
                    help="Also tail-follow journals under this store "
                         "directory. On start, recover() resumes any "
                         "orphaned runs from their durable checkpoints.")
    sp.add_argument("--standby", metavar="ADDR", default=None,
                    help="Run as a warm replica of the primary at ADDR "
                         "(its socket address or http://.../healthz); "
                         "requires --watch DIR (the shared store).")
    sp.add_argument("--max-streams", type=int, default=64, metavar="N",
                    help="Admission cap on concurrently attached runs.")
    sp.add_argument("--budget-elementops", type=float, default=None,
                    metavar="X",
                    help="Global in-flight chunk budget in cost-model "
                         "element-ops, priced into device-seconds "
                         "through the calibration.")
    sp.add_argument("--static-budget", action="store_true",
                    help="Disable the adaptive controller: no AIMD "
                         "capacity tuning and no degradation ladder.")
    sp.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="Serve Prometheus metrics at :P/metrics and the "
                         "service status() JSON at :P/healthz (0 picks a "
                         "free port).")
    sp.add_argument("--metrics-host", default="127.0.0.1", metavar="HOST",
                    help="Interface for --metrics-port (default "
                         "loopback).")
    sp.add_argument("--device", default=None, metavar="DEV",
                    help="Where the streams run: CUDA by default "
                         "(raising without a card); 'cpu' runs the "
                         "plain PyTorch path.")
    _search_parser(sub)
    _chaos_parser(sub)
    return ap


COMMANDS = {"service": run_service, "search": run_search,
            "chaos": run_chaos}


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s{%(threadName)s} %(levelname)s [%(name)s] "
               "%(message)s")
    try:
        return COMMANDS[args.command](args)
    except SystemExit:
        raise
    except Exception:   # noqa: BLE001 — the CLI's crash exit, as the JAX one
        log.critical("the command failed", exc_info=True)
        return 255


if __name__ == "__main__":
    sys.exit(main())
