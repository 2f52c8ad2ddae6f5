"""Reporting helper: redirect prints into a store file.

Reference: `jepsen/src/jepsen/report.clj` — the `to` macro captures
stdout to a file while still teeing to the console (:7-16).

The port's copy of `jepsen_tpu/report.py`, with the one-line summaries
the CLI prints for search and chaos runs."""

from __future__ import annotations

import contextlib
import io
import sys


class _Tee(io.TextIOBase):
    def __init__(self, *sinks):
        self.sinks = sinks

    def write(self, s):
        for sink in self.sinks:
            sink.write(s)
        return len(s)

    def flush(self):
        for sink in self.sinks:
            sink.flush()


def recovery_line(results: dict) -> str:
    """One printable line summarizing a result's device-fault recovery
    trail, or '' when the result never faulted — for report `to`
    blocks and the web results page."""
    rec = (results or {}).get("recovered")
    if not isinstance(rec, dict):
        # workload checkers reuse the 'recovered' key for their own
        # payloads (e.g. the set checker's recovered-element string);
        # a device-fault trail is always a dict
        return ""
    line = (f"recovered from backend faults: "
            f"{', '.join(rec.get('faults', []))} "
            f"({rec.get('retries', 0)} retries")
    if "resumed-from-chunk" in rec:
        line += f", resumed from chunk {rec['resumed-from-chunk']}"
    return line + ")"


def tier_line(results: dict) -> str:
    """One printable line summarizing a result's tiered-verification
    outcome, or '' when the result never went through tier 1 (older
    stored results included)."""
    r = results or {}
    esc = r.get("escalated")
    if isinstance(esc, dict):
        line = (f"tier-1 screen escalated ({esc.get('why', '?')}, "
                f"suspicion {esc.get('suspicion', 0):g}) to the full "
                f"checker")
        eng = esc.get("engine")
        if isinstance(eng, dict) and eng.get("family"):
            line += (f" [{eng['family']}, modeled cost "
                     f"{eng.get('cost', 0):.3g}]")
        return line
    if r.get("screened"):
        return (f"tier-1 screen passed (suspicion "
                f"{r.get('suspicion', 0):g}, no escalation)")
    return ""


def telemetry_line(results: dict) -> str:
    """One printable line summarizing a run's pipeline telemetry —
    device chunks, tier-1 escalations, recovery retries, attestation
    failures — or '' when the results carry none of it (older stored
    results included)."""
    r = results or {}
    subs = [r] + [v for v in r.values() if isinstance(v, dict)]
    chunks = sum(s["chunks"] for s in subs
                 if isinstance(s.get("chunks"), int))
    escalated = sum(1 for s in subs
                    if isinstance(s.get("escalated"), dict))
    retries = corrupt = 0
    for s in subs:
        rec = s.get("recovered")
        if isinstance(rec, dict):
            retries += int(rec.get("retries", 0) or 0)
            corrupt += sum(1 for k in rec.get("faults", [])
                           if k == "corrupt")
    # degradation-ladder stamps (service verdicts; tier-full streams
    # carry none — older stored results never do)
    ladder = r.get("ladder") if isinstance(r.get("ladder"), dict) \
        else None
    deferred = sum(1 for s in subs if s.get("deferred")
                   and s.get("ladder-tier"))
    if not (chunks or escalated or retries or corrupt or ladder
            or deferred):
        return ""
    line = (f"telemetry: {chunks} device chunks, {escalated} "
            f"escalated, {retries} recovery retries, {corrupt} "
            f"attest failures")
    if ladder:
        line += (f"; ladder tier {ladder.get('tier', '?')} "
                 f"(max {ladder.get('max-tier', '?')}, "
                 f"{ladder.get('transitions', 0)} transitions)")
    if deferred:
        line += (f"; {deferred} device verdict"
                 f"{'s' if deferred != 1 else ''} deferred to offline")
    return line


def service_line(status: dict) -> str:
    """One printable line summarizing a verification service's status
    (the /healthz shape from service.VerificationService.status), or
    '' for anything else — for operator logs and the web index."""
    st = status or {}
    streams = st.get("streams")
    if not isinstance(streams, dict):
        return ""
    by_state: dict = {}
    for s in streams.values():
        by_state[s.get("state", "?")] = \
            by_state.get(s.get("state", "?"), 0) + 1
    parts = [f"{n} {state}" for state, n in sorted(by_state.items())]
    line = (f"service {st.get('state', '?')}: "
            f"{', '.join(parts) if parts else 'no streams'}")
    # degraded-tier streams (adaptive overload control; older
    # services' status dicts carry no ladder-tier fields)
    degraded = sum(1 for s in streams.values()
                   if s.get("ladder-tier") not in (None, "full"))
    if degraded:
        line += f"; {degraded} ladder-degraded"
    # crash-consistency fields (older services' status dicts carry
    # none of these)
    if st.get("recovered-total"):
        line += (f"; {st['recovered-total']} recovered"
                 f" (epoch {st.get('epoch', 0)})")
    sessions = st.get("sessions") or {}
    if sessions.get("replays"):
        line += f"; {sessions['replays']} op replays deduped"
    if st.get("fenced"):
        line += "; FENCED (another replica owns the store)"
    budget = st.get("budget") or {}
    if budget.get("initial"):
        line += (f"; budget {budget.get('capacity', 0):.3g}/"
                 f"{budget['initial']:.3g}")
        events = []
        if budget.get("ooms"):
            events.append(f"{budget['ooms']} OOM backpressure events")
        if budget.get("cuts"):
            events.append(f"{budget['cuts']} AIMD cuts")
        if events:
            line += f" ({', '.join(events)})"
    ladder = st.get("ladder") or {}
    if ladder.get("transitions"):
        line += f"; {ladder['transitions']} ladder transitions"
    return line


def search_line(results: dict) -> str:
    """One printable line summarizing a coverage-guided scenario
    search (the search.driver.run_search result shape), or '' for
    anything else — for report `to` blocks and operator logs."""
    r = results or {}
    if not isinstance(r.get("coverage-bits"), int) \
            or "simulations" not in r:
        return ""
    line = (f"search ({r.get('strategy', '?')}): "
            f"{r['simulations']} simulations over "
            f"{r.get('generations-run', 0)} generations, "
            f"{r['coverage-bits']} coverage bits, "
            f"corpus {r.get('corpus-size', 0)} genomes")
    viols = r.get("violations") or []
    if viols:
        steps = sum(int(v.get("shrink-steps", 0) or 0)
                    for v in viols)
        line += (f"; {len(viols)} violation"
                 f"{'s' if len(viols) != 1 else ''}, minimized in "
                 f"{steps} shrink steps")
    return line


def chaos_line(results: dict) -> str:
    """One printable line summarizing a self-chaos fuzz of the
    verification pipeline (the chaos.driver.run_chaos result shape),
    or '' for anything else."""
    r = results or {}
    if not isinstance(r.get("coverage-bits"), int) \
            or "schedules" not in r:
        return ""
    line = (f"chaos ({r.get('strategy', '?')}): "
            f"{r['schedules']} schedules, "
            f"{r['coverage-bits']} coverage bits, "
            f"corpus {r.get('corpus-size', 0)} genomes, "
            f"{r.get('conjunction-hits', 0)} replay-conjunction "
            f"hit{'s' if r.get('conjunction-hits', 0) != 1 else ''}")
    fails = r.get("failures") or []
    if fails:
        oracles = sorted({o for f in fails
                          for o in (f.get("oracles") or [])})
        line += (f"; {len(fails)} oracle failure"
                 f"{'s' if len(fails) != 1 else ''} "
                 f"({', '.join(oracles)}), shrunk in "
                 f"{r.get('shrink-steps', 0)} steps")
    return line


@contextlib.contextmanager
def to(filename: str, tee: bool = True):
    """Context manager: stdout inside the block is written to filename
    (and still echoed when tee=True) — the reference's `report/to`."""
    with open(filename, "w") as f:
        old = sys.stdout
        sys.stdout = _Tee(f, old) if tee else f
        try:
            yield f
        finally:
            sys.stdout = old
