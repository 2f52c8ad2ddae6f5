"""Tier-1 verification: O(n) streaming invariant screens.

The port's own copy of `jepsen_tpu/checker/screen.py` (host code only;
the one device-facing call is `price_escalation`, which prices over the
port's `wgl.select_engine`). Full WGL / Elle checking of every history
is too expensive to run on all traffic; this module is the cheap first
tier that makes always-on verification affordable (A-QED-style cheap
screen + selective full check, arXiv 2108.06081). A screen consumes a
history one op at a time — live, as an `OnlineChecker` target, or
post-hoc in one pass — maintains O(1)-per-op invariants, and emits a
*screen verdict* with a **suspicion score**:

  * suspicion >= 1 (a definite invariant violation, or a provable
    cycle) escalates to the full device search, which produces the
    authoritative verdict and blame certificate;
  * suspicion in (0, 1) is soft signal (crashed mutating ops make
    anomalies easier to hide and searches harder) — it raises the
    sampling odds but never forces escalation alone;
  * a sampled fraction of clean histories escalates anyway
    (deterministically, keyed on the history length), so the screen's
    blind spots are audited continuously. The sampling probability is
    priced through ``wgl.select_engine``'s cost model: histories whose
    modeled full-check cost is high are sampled proportionally less.

Model families without invariant checks (mutex, unordered-queue,
host-only models) report ``screenable: False`` and ALWAYS escalate — a
no-op screen never feeds the sampled-audit path.

The screens are SOUND for validity ("violation found" implies the
history is really not linearizable / not serializable) but incomplete —
a pure ordering anomaly among concurrent register ops can pass the
linearizable screen. The wr screen is stronger: cycle *existence* is
decided exactly (linear-time SCC over the accumulated dependency edges
— every Adya cycle anomaly implies a nontrivial SCC), so only the
classification/certificate work is deferred to escalation.

Checks per model family (each O(1) amortized per op; g-set is O(E) per
read with E <= GSET_MAX_ELEMENTS):

  register / cas-register
    phantom-read    an ok read observes a value no op ever wrote
    stale-read      a read r of v where some write w' completed before
                    r invoked AND every write of v completed before w'
                    invoked — v was definitely overwritten
  counter
    counter-bounds  an observed read outside [lo, hi], where definite
                    adds (completed before the read's invoke) count
                    exactly and in-flight adds contribute their signed
                    range — sound under any linearization
  g-set
    set-lost        a read missing an element whose add completed
                    before the read invoked
    set-phantom     a read containing a never-added element
  wr transactions (WrScreen)
    the single-pass Elle cases (G1a / G1b / internal / duplicate
    writes) plus exact dependency-cycle existence via SCC

Escalation plumbing lives in `linear.Linearizable(tier=...)` and
`elle.RWRegisterChecker` (the test map's 'tier' and 'screen-sample').
"""

from __future__ import annotations

import logging
import time as _time
from typing import Any

from .. import telemetry as _telemetry
from ..history import history as as_history
from . import UNKNOWN  # noqa: F401  (re-exported result vocabulary)

log = logging.getLogger(__name__)

# -- telemetry (the JAX package's metric names and labels) -------------------
# Per-op increments are deliberately avoided on the screen hot path:
# ops are counted in one batch at finish(), so the O(n) screens stay
# O(n) work + O(1) bookkeeping.
_M_SCREENED = _telemetry.counter(
    "jepsen_tpu_screen_screened_ops_total",
    "History ops consumed by tier-1 screens", ("screen",))
_M_SECONDS = _telemetry.histogram(
    "jepsen_tpu_screen_pass_seconds",
    "Tier-1 screen wall time, feed to finish", ("screen",))
_M_VIOL = _telemetry.counter(
    "jepsen_tpu_screen_violations_total",
    "Definite tier-1 invariant violations by check", ("check",))
_M_ESC = _telemetry.counter(
    "jepsen_tpu_screen_escalations_total",
    "Tier-1 escalations to the full device search, by reason",
    ("why",))

# escalate when suspicion reaches this (any definite violation does)
ESCALATE_THRESHOLD = 1.0
# default sampled-escalation fraction for clean histories
DEFAULT_SAMPLE = 0.05
# soft-signal weight per crashed mutating op, and its total cap —
# always strictly below the threshold: soft signals alone never force
# a full check, they only raise the sampling odds
SOFT_CRASH_WEIGHT = 0.02
SOFT_CAP = 0.5
# modeled element-ops at which sampling is at full strength; costlier
# histories sample proportionally less (see should_escalate)
COST_REF = 5e7


def tier_is_screen(tier) -> bool:
    """Normalize the tier knob: 1 / '1' / 'screen' select the tiered
    pipeline; None / 0 / 'full' keep today's always-full behavior."""
    return tier in (1, "1", "screen")


def sample_decision(key: int, fraction: float) -> bool:
    """Deterministic Bernoulli(fraction) on an integer key (Knuth
    multiplicative hash) — reproducible across runs and processes, so
    a replayed history makes the same escalation choice."""
    if fraction <= 0:
        return False
    if fraction >= 1:
        return True
    u = ((int(key) * 2654435761) & 0xFFFFFFFF) / 2.0 ** 32
    return u < fraction


def should_escalate(screen: dict, sample: float = DEFAULT_SAMPLE,
                    cost: float | None = None,
                    key: int | None = None) -> tuple[bool, str]:
    """The tier-1 escalation decision. Returns (escalate?, why) with
    why in {'suspicion', 'unscreened-model', 'sampled', ''}. A screen
    that ran NO invariants (screenable=False — a model family the
    screen has no checks for) always escalates: a no-op screen must
    never pass a history into the sampled-audit path. `cost` is the
    modeled element-op cost of the full check (price_escalation): the
    sampled fraction scales down as min(1, COST_REF / cost) so the
    audit budget is spent where full checks are cheap."""
    if not screen.get("screenable", True):
        _M_ESC.labels(why="unscreened-model").inc()
        return True, "unscreened-model"
    s = float(screen.get("suspicion", 0.0))
    if s >= ESCALATE_THRESHOLD:
        _M_ESC.labels(why="suspicion").inc()
        return True, "suspicion"
    p = float(sample)
    if cost:
        p *= min(1.0, COST_REF / max(float(cost), 1.0))
    k = key if key is not None else screen.get("op-count", 0)
    if sample_decision(int(k), p):
        _M_ESC.labels(why="sampled").inc()
        return True, "sampled"
    return False, ""


def price_escalation(model, hist) -> dict | None:
    """Price a would-be escalation through the WGL cost model: which
    engine `select_engine` would pick and its modeled element-ops (the
    port's `select_engine` resolves as the JAX package does on its
    accelerator, with no calibration). None when the history has no
    device form (host-only models price nothing — escalation still
    works, just unscaled)."""
    from . import wgl
    try:
        ops = wgl.encode_ops_for_model(model, hist)
        p = wgl.required_slots(ops)
        srange = wgl._state_range(model.device_model, model, [ops])
        dec = wgl.select_engine(srange, p, wgl.event_count(ops))
        return {"family": dec.family, "dedup": dec.dedup,
                "reason": dec.reason, "cost": wgl.engine_cost(dec)}
    except Exception:  # noqa: BLE001 — pricing is advisory
        return None


# ---------------------------------------------------------------------------
# The linearizable-model screen
# ---------------------------------------------------------------------------

class ScreenStream:
    """O(n) invariant screen over one linearizability target's ops.

    feed(op) with every history op in journal order (invokes and
    completions interleaved — that IS the real-time order the
    invariants quantify over); finish() returns the screen verdict.
    Host-only and model-shaped: works for models with no device form
    too. Usable as an OnlineChecker target (`violation` flips on the
    first definite violation, so 'abort-on-violation' works at tier 1
    without any device search)."""

    def __init__(self, model):
        self.model = model
        name = getattr(model, "device_model", None)
        self._kind = name if name in ("register", "cas-register",
                                      "counter", "g-set") else None
        self.violations: list[dict] = []
        self.violation = False
        self.soft = 0.0
        self.client_ops = 0
        self._crashed_mutators = 0
        self._t = 0                      # arrival clock
        self._t0: float | None = None
        # register/cas state. The model's initial value acts as a
        # write that completed at time 0 (before every client op):
        # reading it is legal until some real write completes, exactly
        # like any other value — so registers initialized to 0 by
        # their DB (models.cas_register(0)) screen correctly and a
        # read of the WRONG initial value is a phantom.
        init = getattr(model, "value", None) \
            if self._kind in ("register", "cas-register") else None
        self._seen: set = {init}         # values possibly written
        self._wpend: dict = {}           # value -> pending write count
        self._R: dict = {init: 0}        # value -> max completed-write t
        self._S = 0                      # max inv t among completed writes
        self._open: dict = {}            # process -> (inv_t, snapshot)
        # counter state
        self._init = 0
        if self._kind == "counter":
            try:
                self._init = int(model.device_state())
            except Exception:  # noqa: BLE001 — host-only counter models
                self._init = 0
        self._tpos = self._tneg = 0      # invoked add ranges
        self._d = self._dpos = self._dneg = 0   # completed adds
        # g-set state
        self._added: set = set()
        self._completed_adds: dict = {}  # element -> completion t

    def export_checkpoint(self) -> dict:
        """Screens are host-side and O(n): a recovering stream re-feeds
        them from the journal, so a checkpoint only records progress
        (kind='host' = nothing to import)."""
        return {"kind": "host", "ops-fed": int(self.client_ops)}

    # -- feeding -----------------------------------------------------------

    def feed(self, op: dict) -> None:
        if not isinstance(op.get("process"), int):
            return
        self.client_ops += 1
        self._t += 1
        if self._t0 is None:
            self._t0 = _time.monotonic()
        t = op.get("type")
        if t == "invoke":
            self._invoke(op)
        elif t == "ok":
            self._complete(op)
        elif t == "info":
            self._info(op)
        elif t == "fail":
            self._open.pop(op.get("process"), None)

    def _flag(self, check: str, op: dict, **detail) -> None:
        self.violations.append({"check": check, "op": op, **detail})
        self.violation = True
        _M_VIOL.labels(check=check).inc()

    def _is_write(self, op) -> bool:
        return op.get("f") in ("write", "w", "cas", "add", "append",
                               "acquire", "release", "enqueue",
                               "dequeue", "txn")

    def _invoke(self, op: dict) -> None:
        k, f, v = self._kind, op.get("f"), op.get("value")
        snap: Any = None
        if k in ("register", "cas-register"):
            if f in ("write", "w"):
                self._seen.add(v)
                self._wpend[v] = self._wpend.get(v, 0) + 1
            elif f == "cas" and isinstance(v, (list, tuple)) \
                    and len(v) == 2:
                self._seen.add(v[1])
                self._wpend[v[1]] = self._wpend.get(v[1], 0) + 1
            snap = self._S            # reads AND cas observe at >= inv
        elif k == "counter":
            if f == "add" and v is not None:
                d = int(v)
                self._tpos += max(d, 0)
                self._tneg += min(d, 0)
            snap = (self._d, self._dpos, self._dneg)
        elif k == "g-set":
            if f == "add" and v is not None:
                self._added.add(v)
            snap = self._t            # compare completion times to this
        self._open[op["process"]] = (self._t, snap)

    def _complete(self, op: dict) -> None:
        k, f, v = self._kind, op.get("f"), op.get("value")
        inv = self._open.pop(op.get("process"), None)
        inv_t, snap = inv if inv is not None else (self._t, None)
        if k in ("register", "cas-register"):
            if f in ("write", "w"):
                self._write_done(v, inv_t)
            elif f == "cas" and isinstance(v, (list, tuple)) \
                    and len(v) == 2:
                # a successful cas observed v[0] and wrote v[1]
                self._read_check(op, v[0], snap)
                self._write_done(v[1], inv_t)
            elif f in ("read", "r"):
                self._read_check(op, v, snap)
        elif k == "counter":
            if f == "add" and v is not None:
                d = int(v)
                self._d += d
                self._dpos += max(d, 0)
                self._dneg += min(d, 0)
            elif f == "read" and v is not None and snap is not None:
                d0, dp0, dn0 = snap
                lo = self._init + d0 + (self._tneg - dn0)
                hi = self._init + d0 + (self._tpos - dp0)
                if not lo <= int(v) <= hi:
                    self._flag("counter-bounds", op, lo=lo, hi=hi)
        elif k == "g-set":
            if f == "add" and v is not None:
                self._completed_adds.setdefault(v, self._t)
            elif f == "read" and v is not None:
                got = set(v)
                phantom = got - self._added
                if phantom:
                    self._flag("set-phantom", op,
                               elements=sorted(phantom))
                if snap is not None:
                    lost = sorted(
                        el for el, ct in self._completed_adds.items()
                        if ct < inv_t and el not in got)
                    if lost:
                        self._flag("set-lost", op, elements=lost)

    def _write_done(self, v, inv_t: int) -> None:
        if self._wpend.get(v, 0) > 0:
            self._wpend[v] -= 1
        self._R[v] = self._t          # latest completion of a v-write
        self._S = max(self._S, inv_t)

    def _read_check(self, op: dict, v, s_at_inv) -> None:
        """The register read invariants, evaluated at completion time
        (so only writes invoked early enough to serve this read are in
        scope — see the module docstring for the soundness argument)."""
        if s_at_inv is None:
            return
        if v not in self._seen:
            # never written by any op and not the initial value
            self._flag("phantom-read", op, value=v)
            return
        if self._wpend.get(v, 0) > 0:
            return    # an in-flight write of v can still serve freshly
        r = self._R.get(v)
        if r is not None and s_at_inv > r:
            # some write w' was invoked after EVERY write of v had
            # completed (the initial value "completed" at time 0), and
            # w' itself completed before this read invoked: v cannot
            # be current
            self._flag("stale-read", op, value=v)

    def _info(self, op: dict) -> None:
        self._open.pop(op.get("process"), None)
        if self._is_write(op):
            self._crashed_mutators += 1
            self.soft = min(SOFT_CAP,
                            self.soft + SOFT_CRASH_WEIGHT)
        # register family: a crashed write may or may not have landed;
        # its value stays in _seen (added at invoke) and its pending
        # count stays up forever — both directions stay sound

    # -- finish ------------------------------------------------------------

    @property
    def suspicion(self) -> float:
        return len(self.violations) + self.soft

    def finish(self) -> dict:
        now = _time.monotonic()
        _M_SCREENED.labels(screen="linear").inc(self.client_ops)
        if self._t0 is not None:
            _M_SECONDS.labels(screen="linear").observe(now - self._t0)
        return {
            "screened": True,
            "analyzer": "tier1-screen",
            "valid?": not self.violations,
            "model": repr(self.model),
            # a model family with no invariant checks is NOT screened
            # clean — should_escalate always escalates it
            "screenable": self._kind is not None,
            "suspicion": self.suspicion,
            "violations": self.violations[:10],
            "violation-count": len(self.violations),
            "signals": {"crashed-mutators": self._crashed_mutators,
                        "model-kind": self._kind or "generic"},
            "op-count": self.client_ops,
            "history-len": self.client_ops,
            "duration-ms": ((now - self._t0) * 1e3
                            if self._t0 is not None else 0.0),
        }


def screen_history(model, hist) -> dict:
    """One-pass convenience: push a complete history through a
    ScreenStream (as the live journal feed would) and finish."""
    s = ScreenStream(model)
    for op in as_history(hist).ops:
        s.feed(op)
    return s.finish()


# ---------------------------------------------------------------------------
# The wr-transaction screen
# ---------------------------------------------------------------------------

class WrScreen:
    """Tier-1 screen for rw-register transaction histories.

    Rides WrStream's incremental edge/case accumulation (the same
    machinery the online Elle checker uses) but finishes with only the
    LINEAR-TIME work: the single-pass anomalies plus an SCC pass over
    the accumulated sparse edges for exact cycle existence — no dense
    blocks, no device classification, no certificates. Every Adya
    cycle anomaly (G0/G1c/G-single/G2-item and variants) implies a
    nontrivial SCC of these edges, so "screen passed" has no false
    negatives for the cycle classes; escalation buys the anomaly
    *classification* and human-readable certificates."""

    def __init__(self, anomalies=None):
        from .streaming import WrStream
        self._ws = WrStream(anomalies=anomalies)
        self.violation = False
        self._t0: float | None = None   # first feed, for pass_seconds

    def feed(self, op: dict) -> None:
        if self._t0 is None:
            self._t0 = _time.monotonic()
        self._ws.feed(op)
        if not self.violation and (
                self._ws._g1a or self._ws._g1b or self._ws._internal
                or self._ws._duplicates):
            self.violation = True

    def export_checkpoint(self) -> dict:
        """See ScreenStream.export_checkpoint: progress only."""
        return {"kind": "host",
                "ops-fed": int(self._ws.client_ops_fed)}

    @property
    def suspicion(self) -> float:
        """Live suspicion from the single-pass cases (the SCC cycle
        check only runs at finish — a mid-stream score can grow at
        finish, never shrink)."""
        ws = self._ws
        return float(len(ws._g1a) + len(ws._g1b)
                     + len(ws._internal) + len(ws._duplicates))

    def finish(self) -> dict:
        import numpy as np

        from .elle import kernels
        t0 = _time.monotonic()
        ws = self._ws
        violations: list[dict] = []
        for check, cases in (("G1a", ws._g1a), ("G1b", ws._g1b),
                             ("internal", ws._internal),
                             ("duplicate-writes", ws._duplicates)):
            if cases:
                violations.append({"check": check, "count": len(cases),
                                   "first": cases[0]})
        n = len(ws.txns)
        sccs = 0
        if ws._acc and n:
            src = np.fromiter((i for i, _ in ws._acc), np.int64,
                              count=len(ws._acc))
            dst = np.fromiter((j for _, j in ws._acc), np.int64,
                              count=len(ws._acc))
            labels = kernels.scc_labels(n, src, dst)
            sccs = int((np.bincount(labels, minlength=n) >= 2).sum())
            if sccs:
                violations.append({"check": "dependency-cycle",
                                   "sccs": sccs})
        if violations:
            self.violation = True
            for v in violations:
                _M_VIOL.labels(check=v["check"]).inc()
        _M_SCREENED.labels(screen="wr").inc(ws.client_ops_fed)
        # feed-to-finish, like the linear screen's series — the two
        # label values of one histogram must stay comparable
        _M_SECONDS.labels(screen="wr").observe(
            _time.monotonic() - (self._t0 if self._t0 is not None
                                 else t0))
        return {
            "screened": True,
            "analyzer": "tier1-screen-wr",
            "screenable": True,
            "valid?": not violations,
            "suspicion": float(len(violations)),
            "violations": violations,
            "violation-count": len(violations),
            "signals": {"txns": n, "edges": len(ws._acc),
                        "cyclic-sccs": sccs},
            "txn-count": n,
            "op-count": ws.client_ops_fed,
            "history-len": ws.client_ops_fed,
            "duration-ms": (_time.monotonic() - t0) * 1e3,
        }


def screen_wr(hist, anomalies=None) -> dict:
    """One-pass convenience for WrScreen."""
    s = WrScreen(anomalies=anomalies)
    for op in as_history(hist).ops:
        s.feed(op)
    return s.finish()


def escalation_record(screen: dict, why: str,
                      price: dict | None = None) -> dict:
    """The 'escalated' payload stamped onto a full-check result that
    tier 1 triggered — what the screen saw and what the cost model
    said, for Compose/report/web surfacing."""
    rec = {
        "why": why,
        "suspicion": screen.get("suspicion", 0.0),
        "violations": screen.get("violation-count",
                                 len(screen.get("violations", []))),
    }
    if price:
        rec["engine"] = price
    return rec
