"""Chaos oracles: what must hold after EVERY schedule.

The pipeline is decomposed into self-checkable stages (the A-QED
argument, arXiv 2108.06081): each oracle checks one stage's contract
against ground truth the harness already holds — the uninjected solo
verdict, the schedule it injected itself, and the process's own
resource tables. A failure is reported as {oracle, detail}; the
driver shrinks the offending schedule to a minimal repro.

  verdict-identity   a run that reached a full tier-full verdict must
                     match the uninjected solo run byte-for-byte
                     (canonical JSON) modulo the volatile stamps
  violation-missed   a definite violation in the baseline must never
                     come back valid — the one-sided failure no
                     deferred/degraded honesty can excuse
  watchdog           the verdict (or an honest shed/degraded stamp)
                     arrived within the deadline: no wedged worker
  resource-leak      fds and threads return to their pre-run levels
  stamp-consistency  recovered/degraded/deferred stamps match the
                     schedule actually injected: faults fired =>
                     recovered stamp (or honest degradation), nothing
                     fired and no actions => no stamps at all

The port's copy of `jepsen_tpu/chaos/oracles.py`, the same five oracles
in the same meaning.
"""

from __future__ import annotations

import json

from .. import store

# process/feed-timing diagnostics, not verdict content (the same set
# tests/test_service.py strips, plus the fault/attest stamps the
# stamp-consistency oracle checks separately and the per-run ids)
TIMING = ("tail-latency-ms", "duration-ms", "violation-at-op")
# the port's per-walk kernel-launch and host-sync counts: execution
# tallies, like 'attested', that a re-dispatched chunk counts again.
# The JAX package's verdicts carry no such keys, so every key its
# oracle compares is still compared here
COUNTERS = ("closure-rounds", "dedup-launches", "host-syncs")
VOLATILE = TIMING + ("recovered", "attested", "trace-id",
                     "history-len") + COUNTERS

ORACLES = ("verdict-identity", "violation-missed", "watchdog",
           "resource-leak", "stamp-consistency")

# lifecycle actions that promote a standby: after one, the superseded
# (fenced) instance may have consumed schedule events whose stamps the
# successor's verdict never saw — the must-carry-stamp check is only
# sound without a promotion in the schedule
PROMOTIONS = ("kill-recover", "failover", "drain-resume")


def canon(x):
    """Canonical JSON form — 'byte-identical' means identical once
    serialized the way the journal/results serialize everything."""
    return json.loads(json.dumps(x, default=store._json_default,
                                 sort_keys=True))


def normalize_verdict(v: dict) -> dict:
    return canon({k: x for k, x in v.items() if k not in VOLATILE})


def _target_verdicts(results: dict | None) -> dict:
    """The per-target verdict dicts inside a results payload (skips
    the ladder stamp, deferred markers, degraded error strings)."""
    if not isinstance(results, dict):
        return {}
    return {k: v for k, v in results.items()
            if isinstance(v, dict) and "valid?" in v}


def full_verdict(outcome: dict) -> bool:
    """Did this run deliver a complete verdict (not shed-deferred,
    not quarantine-degraded, not timed out)?"""
    return (not outcome.get("timed-out")
            and not outcome.get("deferred")
            and not outcome.get("degraded")
            and bool(_target_verdicts(outcome.get("results"))))


def check_oracles(baseline: dict, outcome: dict,
                  resources: dict | None = None) -> list:
    """All oracle verdicts for one chaos run -> list of failures
    (empty = green). `baseline` maps target name -> solo verdict;
    `outcome` is the driver's run record; `resources` carries the
    before/after fd + thread counts."""
    failures: list = []

    def fail(oracle: str, detail: str) -> None:
        failures.append({"oracle": oracle, "detail": detail})

    fired = list(outcome.get("fired") or [])
    actions = list(outcome.get("actions") or [])
    injected = bool(fired or actions)
    verdicts = _target_verdicts(outcome.get("results"))

    # watchdog: SOMETHING terminal must have arrived in time
    if outcome.get("timed-out"):
        fail("watchdog",
             f"no verdict within {outcome.get('deadline-s')}s "
             f"(fired={fired}, actions={actions})")

    if full_verdict(outcome):
        # verdict-identity (only a full tier-full verdict promises it;
        # a ladder stamp would mark a degraded tier, and the harness
        # runs with the adaptive ladder off)
        for name, solo in baseline.items():
            got = verdicts.get(name)
            if got is None:
                fail("verdict-identity",
                     f"target {name!r} missing from a full verdict")
                continue
            if normalize_verdict(got) != normalize_verdict(solo):
                fail("verdict-identity",
                     f"target {name!r} verdict diverged from the "
                     f"uninjected solo run")

    # violation-missed: one-sided — never report valid over a definite
    # violation, full verdict or not
    for name, solo in baseline.items():
        if solo.get("valid?") is False:
            got = verdicts.get(name)
            if got is not None and got.get("valid?") is True:
                fail("violation-missed",
                     f"target {name!r}: baseline violation reported "
                     f"valid under chaos")

    # stamp-consistency
    backend_fired = [k for (k, _s, _a) in fired]
    promoted = any(a in PROMOTIONS for a in actions)
    if verdicts and not outcome.get("degraded"):
        want = set() if promoted else \
            {"corrupt" if k == "bitflip" else k
             for k in backend_fired}
        for name, got in verdicts.items():
            rec = got.get("recovered")
            have = set((rec or {}).get("faults") or [])
            if want and not rec:
                fail("stamp-consistency",
                     f"target {name!r}: schedule fired {sorted(want)} "
                     f"but the verdict carries no recovered stamp")
            elif want and not want <= have:
                fail("stamp-consistency",
                     f"target {name!r}: recovered stamp {sorted(have)}"
                     f" missing injected {sorted(want - have)}")
            elif not want and rec and not actions:
                fail("stamp-consistency",
                     f"target {name!r}: recovered stamp "
                     f"{rec!r} with nothing injected")
    if outcome.get("degraded") and not injected:
        fail("stamp-consistency",
             "quarantined/degraded with nothing injected")
    if outcome.get("deferred") and not injected:
        fail("stamp-consistency",
             "shed/deferred with nothing injected")
    if not injected and not outcome.get("timed-out") \
            and not full_verdict(outcome):
        fail("stamp-consistency",
             "no faults, no actions, and still no full verdict")

    # resource-leak
    if resources:
        fd0, fd1 = resources.get("fds-before"), resources.get("fds-after")
        th0, th1 = (resources.get("threads-before"),
                    resources.get("threads-after"))
        if fd0 is not None and fd1 is not None and fd1 > fd0:
            fail("resource-leak", f"fds {fd0} -> {fd1}")
        if th0 is not None and th1 is not None and th1 > th0:
            fail("resource-leak", f"threads {th0} -> {th1}")
    return failures
