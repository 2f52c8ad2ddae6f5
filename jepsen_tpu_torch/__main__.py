"""The port's command line: the persistent verification service daemon.

    python -m jepsen_tpu_torch service [--bind ADDR] [--watch DIR]
        [--standby ADDR] [--max-streams N] [--budget-elementops X]
        [--static-budget] [--metrics-port P] [--metrics-host H]
        [--device cpu]
    python -m jepsen_tpu_torch service status ADDR

A twin of the JAX package's `service` command (`jepsen_tpu/cli.py`:
`service_cmd` and `_service_status`), with no other command. The daemon
runs on CUDA unless given ``--device cpu``, and without a card exits
non-zero with `_platform.resolve_device`'s message. It loads and
activates the measured cost model (`calibrate`) at start and saves it
at drain; SIGTERM drains (every stream's carry checkpointed, resume
manifests in the runs' store dirs) and exits 0.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

log = logging.getLogger("jepsen_tpu_torch")


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


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch",
        description="The PyTorch/CUDA port's verification service.")
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
    return ap


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s{%(threadName)s} %(levelname)s [%(name)s] "
               "%(message)s")
    return run_service(args)


if __name__ == "__main__":
    sys.exit(main())
