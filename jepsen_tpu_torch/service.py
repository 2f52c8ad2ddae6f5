"""The persistent verification service: many runs, one card.

The port's copy of `jepsen_tpu/service.py`. Per-run checking (offline
`analyze`, or the per-run `OnlineChecker`) ties a checker's lifetime to
a run's. A serving deployment inverts that: one long-lived daemon owns
the device, and many concurrent runs hand it their journal streams —
over a local socket (`python -m jepsen_tpu_torch service`, a run's
`ServiceClient`), or by the service tail-following journals under a
store directory (`--watch`). P-compositionality (arXiv 1504.00204) is
why multiplexing wins: histories decompose into many small independent
projections, so scheduling thousands of small streams beats one giant
search — and the per-stream machinery already exists
(`WglStream`/`WrStream`/`ScreenStream` online checkers, the recovery
ladder, carry checkpoints). This module is the serving layer that makes
them safe to share:

  * **Per-stream fault isolation.** Each stream runs on its own
    worker; a classified backend fault climbs that stream's
    `_RecoveryTrail` and restores its own carry checkpoint (the
    machinery inside `WglStream`) without stalling siblings, and an
    *unclassified* exception quarantines only that stream
    (``degraded`` with the error attached) — the journal remains, so
    offline `analyze` still covers it.
  * **Cost-model scheduling.** Chunk dispatch across streams flows
    through a global element-op budget priced by `wgl.select_engine`:
    each stream's chunk acquires its modeled cost before dispatching.
    In the port a grant is also the card's one walk (below), so chunks
    take turns in the budget's priority order and capacity never holds
    one back.
  * **Admission control + OOM-aware backpressure.** Per-stream op
    queues are bounded; attach is refused past ``max_streams``; a
    stream whose queue stays saturated past ``shed_timeout_s`` is
    *shed* — it gets a ``deferred`` verdict (written into its run's
    store dir) and offline `analyze` picks it up from its journal.
    Any stream's OOM fault halves the global budget (restored
    gradually by clean chunks), as in the JAX service; with one chunk
    on the card at a time, the cut shows in `status()` and throttles
    nothing further.
  * **Graceful drain.** SIGTERM (or `drain()`) stops admissions,
    checkpoints every stream's carry, and writes a resume manifest +
    partial verdicts into each run's store dir
    (`store.write_service_resume`); a restarted service `resume()`s
    from the checkpoints — the journal re-feeds the encoder, dispatch
    skips row-for-row up to the restored carry, and the final verdict
    is identical to an uninterrupted service's. Manifests and carries
    are in the JAX package's layout, so either package's service
    resumes the other's drain.
  * **Status.** `status()` (socket ``{"type": "status"}`` — the
    /healthz shape) reports per-stream state, queue depths, recovery
    and attestation-failure counts, and the budget level.

On the card. The service runs on CUDA unless built with
``device="cpu"`` (`_platform.resolve_device`: no card and no explicit
CPU raises), and every worker thread pins the service's card before it
touches a tensor (PyTorch's current device is per thread). Every worker
launches K3 (dense streams) and K2 (packed sort streams) on the card's
default stream, so kernels of different streams run one after another
on the card. The walks are host-bound and share one interpreter lock,
so the chunk budget grants one walk at a time (a chunk, a finish, a
drain's checkpoint), in its priority order; feeding, encoding, the
screens, the recovery ladder's backoff and the blame's host
explanation run beside it. The JAX service needs no such gate: its
dispatch is asynchronous. The kernels' build (`_build`) and launch
counters are safe across threads; each stream's result counts its own
launches (`closure-rounds`, `dedup-launches`).

A second difference from the JAX service is deliberate: a kernel that
does not build raises `KernelCompileError`, which the port's ladder never
retries (the JAX stream drops Pallas and goes on). Inside a worker that
is an unclassified exception, so only that stream is quarantined
(``degraded`` with the error) and its siblings run on; the journal
remains for the offline check, which also runs on the card.

Stream lifecycle::

    admitted ──▶ streaming ──▶ verdict
                    │ ▲
         ┌──────────┼─┴─ recovering (stream's own ladder; siblings
         │          │                unaffected)
         │          ├──▶ quarantined (unclassified exception;
         │          │                 'degraded' + error)
         │          ├──▶ shed        (backpressure; 'deferred',
         │          │                 analyze covers from journal)
         │          └──▶ drained     (SIGTERM; checkpoint + manifest,
         │                            resume() continues to verdict)
         └─ admission refused (saturated): never admitted, run falls
            back to its local online/offline checking
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import queue as _queue
import signal as _signal
import socket as _socket
import threading
import time as _time
import traceback
import zlib
from collections import deque
from typing import Callable

import torch

from . import calibrate as _calibrate, reconnect as _reconnect, store, \
    telemetry as _telemetry, trace as _trace
from ._platform import pin_device, probe as _probe, resolve_device

log = logging.getLogger(__name__)

# -- telemetry (doc/observability.md catalogs these) -------------------------
_M_EVENTS = _telemetry.counter(
    "jepsen_tpu_service_stream_events_total",
    "Stream lifecycle events (admitted / refused / shed / "
    "quarantined / drained / verdict / resumed)", ("event",))
_M_ACTIVE = _telemetry.gauge(
    "jepsen_tpu_service_active_streams",
    "Streams currently admitted and not yet terminal")
_M_QUEUE = _telemetry.histogram(
    "jepsen_tpu_service_queue_rows",
    "Per-stream op-queue depth, observed at each pump",
    buckets=(0, 16, 64, 256, 1024, 4096, 16384, 65536))
_M_OPS = _telemetry.counter(
    "jepsen_tpu_service_ops_total",
    "Journal ops fed into stream workers")
_M_BUDGET_CAP = _telemetry.gauge(
    "jepsen_tpu_service_budget_capacity_seconds",
    "ChunkBudget capacity in priced device-seconds (AIMD: cut "
    "multiplicatively on OOM/latency blowout, restored additively)")
_M_BUDGET_AVAIL = _telemetry.gauge(
    "jepsen_tpu_service_budget_available_seconds",
    "ChunkBudget device-seconds currently available")
_M_OOMS = _telemetry.counter(
    "jepsen_tpu_service_budget_ooms_total",
    "OOM backpressure events that halved the global budget")
_M_CUTS = _telemetry.counter(
    "jepsen_tpu_service_budget_cuts_total",
    "AIMD multiplicative capacity cuts by triggering signal",
    ("signal",))
_M_PRIO = _telemetry.counter(
    "jepsen_tpu_service_priority_grants_total",
    "Budget grants by scheduling priority class (suspect streams "
    "acquire ahead of clean ones under contention)", ("priority",))
_M_LADDER = _telemetry.counter(
    "jepsen_tpu_service_ladder_transitions_total",
    "Degradation-ladder transitions by direction and destination tier",
    ("direction", "tier"))
_M_TIER = _telemetry.gauge(
    "jepsen_tpu_service_ladder_streams",
    "Live streams per degradation-ladder tier", ("tier",))
_M_VERB = _telemetry.histogram(
    "jepsen_tpu_service_verb_seconds",
    "Socket verb handling latency", ("verb",))
_M_RECOVERIES = _telemetry.counter(
    "jepsen_tpu_service_recoveries_total",
    "Streams resumed by recover() after an ungraceful death, by "
    "resume source (checkpoint = durable carry restored, cold = "
    "journal re-check from scratch)", ("how",))
_M_REPLAYS = _telemetry.counter(
    "jepsen_tpu_service_replays_total",
    "Duplicate session ops deduplicated by the server-side sequence "
    "table (at-least-once delivery, exactly-once application)")
_M_RECONNECTS = _telemetry.counter(
    "jepsen_tpu_service_reconnects_total",
    "Session re-attaches after a dropped connection, by side",
    ("side",))
_M_FAILOVERS = _telemetry.counter(
    "jepsen_tpu_service_failovers_total",
    "Replica failovers: standby promotions and client address-list "
    "failovers", ("role",))

_KNOWN_VERBS = frozenset(
    {"op", "attach", "poll", "finish", "status", "metrics", "close"})

# the socket layer's line cap: a single journal op is a few hundred
# bytes; anything near this is garbage or an attack on the reader's
# memory, and gets an error reply instead of an allocation
MAX_LINE_BYTES = 1 << 20
# client acks: every Nth op asks the server for its sequence
# high-water mark so the replay buffer stays bounded
ACK_EVERY = 64
# reconnect attempts (each cycles the whole address list) before the
# client declares the service gone and falls back to offline checking
RECONNECT_TRIES = 8
# standby failover defaults: consecutive failed health probes (at
# poll_s cadence) before the standby fences the primary and promotes
DEFAULT_STANDBY_POLL_S = 1.0
DEFAULT_STANDBY_FAILURES = 3

# stream lifecycle states (see module docstring)
ADMITTED = "admitted"
STREAMING = "streaming"
RECOVERING = "recovering"
QUARANTINED = "quarantined"
SHED = "shed"
DRAINED = "drained"
VERDICT = "verdict"

# degradation-ladder tiers (doc/robustness.md: the overload ladder).
# Orthogonal to the lifecycle states above: a streaming stream sits at
# exactly one tier; climbing trades verification depth for device time
# and never loses a definite violation (screens keep running at every
# tier, and a suspect stream descends to full immediately).
TIER_FULL = 0           # all targets pump normally
TIER_SAMPLED = 1        # device chunks only for suspect/sampled streams
TIER_SCREEN = 2         # O(n) screens only; device verdict deferred
TIER_SHED = 3           # shed-to-offline (the pre-existing last rung)
TIER_NAMES = ("full", "sampled-escalation-only", "screen-only", "shed")

DEFAULT_MAX_STREAMS = 64
DEFAULT_QUEUE_OPS = 50_000
DEFAULT_SHED_TIMEOUT_S = 2.0
# how long stop() waits for the threads of the stream workers whose
# verdicts are final (each is past its last step when stop() is called)
STOP_JOIN_S = 5.0
# idle sessions older than this are swept even while the table is
# small — a reconnecting client past the TTL re-attaches fresh (its
# unacked tail replays; the worker is long done, so ops drop at offer)
SESSION_TTL_S = 600.0
# global in-flight device budget, in select_engine-modeled element-ops
# (~a dozen default-shape sort chunks); acquire clamps to capacity so
# a single over-budget chunk always eventually dispatches. The budget
# itself runs in priced device-seconds — element-ops convert through
# the calibration (measured coefficients when known, the nominal
# constant otherwise, so uncalibrated scheduling is unchanged: costs
# and capacity scale by the same constant).
DEFAULT_BUDGET_ELEMENTOPS = 1e9
# -- AIMD budget constants (doc/robustness.md documents the policy) --
BUDGET_FLOOR_FRACTION = 1 / 64.0    # capacity never cut below this
BUDGET_RESTORE_STEP = 0.02      # additive restore per clean chunk,
#                                 as a fraction of max capacity
BUDGET_HYSTERESIS_S = 5.0       # after a cut: no restore, and no
#                                 further latency cut, for this long
BUDGET_BLOWOUT_P95_S = 5.0      # p95 chunk latency that cuts capacity
BUDGET_RESTORE_SLOW_FRACTION = 0.5  # clean chunks between the
#                                 low-latency bar and this fraction of
#                                 blowout restore at HALF step — slow
#                                 re-open beats permanent halving
BUDGET_RESTORE_LATENCY_FRACTION = 0.25  # "low-latency" chunk bar for
#                                 restore, as a fraction of blowout
BUDGET_AGING_S = 2.0            # a waiter older than this reserves
#                                 capacity (cheap chunks stop bypassing)
BUDGET_LATENCY_WINDOW = 64      # rolling chunk-latency window for p95
BUDGET_HUNGRY_ROWS = 4096       # queue-depth EWMA past which clean
#                                 chunks restore at double step
# -- ladder controller defaults --
LADDER_TICK_S = 0.25
LADDER_CLIMB_HOLD_S = 2.0       # sustained overload before one climb
LADDER_DESCEND_HOLD_S = 6.0     # sustained calm before one descend
#                                 (descend > climb: transition hysteresis)
# deterministic sampled-escalation fraction for ladder tier 1 (keyed
# on the stream name, so a re-admitted run makes the same choice)
LADDER_SAMPLE = 0.25
# clean chunks between budget re-pricings of a stream's chunk cost —
# the cadence at which a converging calibration reaches the scheduler
REPRICE_EVERY_CHUNKS = 32

# engine shapes (`WglStream.kernel_key`) some stream in this process
# already ran: only the ONE first stream per shape has a first chunk
# tainted by the library load, the CUDA context and the allocator's
# warm-up, so every other stream's chunk-0 sample is a legitimate
# execution measurement
_CAL_SEEN_LOCK = threading.Lock()
_CAL_KERNELS_SEEN: set = set()      # guarded-by: _CAL_SEEN_LOCK


def _kernel_already_run(key) -> bool:
    """True if a stream in this process already ran this engine shape;
    marks it run otherwise."""
    with _CAL_SEEN_LOCK:
        if key in _CAL_KERNELS_SEEN:
            return True
        if len(_CAL_KERNELS_SEEN) > 4096:   # bounded churn, cheap reset
            _CAL_KERNELS_SEEN.clear()
        _CAL_KERNELS_SEEN.add(key)
        return False

_SEAL = object()
_CLOSE = object()


class AdmissionRefused(Exception):
    """The service refused a new stream (saturated or draining)."""


# ---------------------------------------------------------------------------
# serializable target specs (client builds, service rebuilds)
# ---------------------------------------------------------------------------

def _jsonable(v):
    if isinstance(v, (set, frozenset)):
        return sorted(v)
    if isinstance(v, tuple):
        return list(v)
    return v


def model_spec(model) -> dict:
    """A wire-serializable description of a device-model instance
    (the registered models are flat dataclasses)."""
    d: dict = {"class": type(model).__name__}
    if dataclasses.is_dataclass(model):
        d["fields"] = {f.name: _jsonable(getattr(model, f.name))
                       for f in dataclasses.fields(model)}
    return d


def model_from_spec(spec: dict):
    from . import models
    cls = getattr(models, spec.get("class", ""), None)
    if not (isinstance(cls, type) and issubclass(cls, models.Model)):
        raise ValueError(f"unknown model class {spec.get('class')!r}")
    kw = {}
    fields = spec.get("fields") or {}
    for f in dataclasses.fields(cls):
        if f.name in fields:
            v = fields[f.name]
            if "frozenset" in str(f.type) and isinstance(v, list):
                v = frozenset(v)
            kw[f.name] = v
    return cls(**kw)


def targets_spec(test: dict) -> dict:
    """The serializable stream-target spec for a test — the same
    checker walk `streaming.maybe_online` does, minus the stream
    construction (the service builds the streams on its side)."""
    from .checker import screen as _screen
    from .checker.elle import RWRegisterChecker
    from .checker.linear import Linearizable
    from .checker.streaming import (DEFAULT_CHECKPOINT_EVERY,
                                    DEFAULT_CHUNK_ENTRIES,
                                    _walk_checkers)

    specs: dict = {}
    tiered = _screen.tier_is_screen(test.get("tier"))
    for c in _walk_checkers(test.get("checker")):
        if tiered and isinstance(c, Linearizable) \
                and "screen-linear" not in specs:
            specs["screen-linear"] = {"kind": "screen",
                                      "model": model_spec(c.model)}
        if tiered and isinstance(c, RWRegisterChecker) \
                and not c.additional_graphs \
                and "screen-wr" not in specs:
            specs["screen-wr"] = {"kind": "screen-wr",
                                  "anomalies": sorted(c.anomalies)}
        if isinstance(c, Linearizable) and "linear" not in specs:
            if c.model.device_model is None or c.algorithm == "host":
                continue
            srange = test.get("online-state-range")
            specs["linear"] = {
                "kind": "wgl",
                "model": model_spec(c.model),
                "frontier": c.opts.get("frontier", 256),
                "max-frontier": c.opts.get("max_frontier", 65536),
                "chunk-entries": test.get("online-chunk-entries",
                                          DEFAULT_CHUNK_ENTRIES),
                "engine": "auto" if srange else "sort",
                "state-range": (list(srange) if srange else None),
                "concurrency-hint": test.get("concurrency"),
                # the JAX spec's key, for one wire format; the port's
                # routes are the JAX package's with Pallas on, and
                # build_targets reads no 'pallas'
                "pallas": c.opts.get("pallas"),
                "checkpoint-every": test.get("online-checkpoint-every",
                                             DEFAULT_CHECKPOINT_EVERY),
                "max-recovery-retries": test.get("max-recovery-retries"),
            }
        elif isinstance(c, RWRegisterChecker) \
                and "elle-wr" not in specs:
            if c.additional_graphs:
                continue
            specs["elle-wr"] = {"kind": "wr",
                                "anomalies": sorted(c.anomalies)}
    return specs


def build_targets(spec: dict, stream_name: str = "",
                  overrides: dict | None = None, device=None) -> dict:
    """Instantiate stream workers from a targets spec. WGL streams are
    built service-schedulable (auto_pump=False; the worker pumps under
    the budget) with a per-stream fault site
    (``stream-chunk/<name>``) so faults inject and account per
    stream. `overrides` maps target name -> kernel-shape overrides
    from a resume checkpoint (slots/chunk/frontier/engine must match
    the exported carry; a 'pallas' entry is the JAX package's and is
    not read). device: where the device targets run (None = CUDA)."""
    from .checker import screen as _screen
    from .checker.streaming import (DEFAULT_CHECKPOINT_EVERY,
                                    DEFAULT_CHUNK_ENTRIES, WglStream,
                                    WrStream)

    out: dict = {}
    for name, ts in spec.items():
        kind = ts.get("kind")
        if kind == "wgl":
            ov = (overrides or {}).get(name) or {}
            srange = ov.get("state-range", ts.get("state-range"))
            out[name] = WglStream(
                model_from_spec(ts["model"]),
                slots=ov.get("p", ts.get("slots")),
                frontier=ov.get("frontier", ts.get("frontier", 256)),
                max_frontier=ts.get("max-frontier", 65536),
                chunk_entries=ov.get("chunk",
                                     ts.get("chunk-entries",
                                            DEFAULT_CHUNK_ENTRIES)),
                engine=ov.get("engine", ts.get("engine", "sort")),
                state_range=(tuple(srange) if srange else None),
                concurrency_hint=ts.get("concurrency-hint"),
                checkpoint_every=ts.get("checkpoint-every",
                                        DEFAULT_CHECKPOINT_EVERY),
                max_recovery_retries=ts.get("max-recovery-retries"),
                auto_pump=False,
                fault_site=(f"stream-chunk/{stream_name}"
                            if stream_name else "stream-chunk"),
                device=device,
            )
        elif kind == "wr":
            out[name] = WrStream(anomalies=ts.get("anomalies"),
                                 device=device)
        elif kind == "screen":
            out[name] = _screen.ScreenStream(
                model_from_spec(ts["model"]))
        elif kind == "screen-wr":
            out[name] = _screen.WrScreen(anomalies=ts.get("anomalies"))
        else:
            raise ValueError(f"unknown target kind {kind!r}")
    return out


# ---------------------------------------------------------------------------
# the global chunk budget (cost-model scheduling + OOM backpressure)
# ---------------------------------------------------------------------------

class _Waiter:
    """One blocked acquirer (see `ChunkBudget._head_locked` for the
    order grants follow)."""

    __slots__ = ("priority", "seq", "t0")

    def __init__(self, priority: int, seq: int, t0: float):
        self.priority = priority
        self.seq = seq
        self.t0 = t0


class ChunkBudget:
    """A self-tuning weighted semaphore over priced device-seconds:
    each stream acquires its chunk's cost (modeled element-ops priced
    through the calibration, see `chunk_cost`) before dispatching. In
    the JAX service cheap chunks interleave many at a time; in the port
    a grant is the one walk (below).

    **AIMD capacity.** An OOM anywhere halves capacity immediately
    (safety first — no hysteresis on memory pressure); a p95
    chunk-latency blowout halves it too (at most once per
    ``hysteresis_s``). Clean low-latency chunks restore capacity
    *additively* (``restore_step`` of max per chunk; doubled while
    queues run deep — an over-cut hungry system re-opens faster), but
    never within ``hysteresis_s`` of a cut and never past the
    configured max. The floor clamp keeps one chunk always
    dispatchable. ``adaptive=False`` freezes capacity except for the
    pre-existing OOM halving/restore (the bench A/B lever).

    **Priority.** ``acquire(priority=1)`` (suspect streams) grants
    ahead of priority 0 under contention, and a waiter aged past
    ``aging_s`` goes ahead of every younger one, suspects included, so
    a steady suspect load starves no clean stream.

    **One walk at a time** (the port's difference). A grant also hands
    out the card's one walk: the port's walks are host-bound (they
    launch on the default stream and read the host every round), so the
    budget grants the next chunk only when the last one has been
    released, in the same entitlement order. A waiting chunk is not in
    flight, so capacity counts the walking chunk alone and one chunk
    always fits: ``waiters`` are the queue for the walk, shown with the
    p95 of their waits. A walker steps out for host-only work inside
    its grant (`lend`), and device work that is not a priced chunk
    takes the walk alone (`walk`)."""

    def __init__(self, capacity: float = DEFAULT_BUDGET_ELEMENTOPS
                 * _calibrate.NOMINAL_SECONDS_PER_ELEMENTOP,
                 *, adaptive: bool = True,
                 blowout_s: float = BUDGET_BLOWOUT_P95_S,
                 hysteresis_s: float = BUDGET_HYSTERESIS_S,
                 restore_step: float = BUDGET_RESTORE_STEP,
                 aging_s: float = BUDGET_AGING_S):
        self.initial = float(capacity)      # the AIMD ceiling
        self.floor = self.initial * BUDGET_FLOOR_FRACTION
        self.adaptive = bool(adaptive)
        self.blowout_s = float(blowout_s)
        self.hysteresis_s = float(hysteresis_s)
        self.restore_step = float(restore_step)
        self.aging_s = float(aging_s)
        self.capacity = float(capacity)     # guarded-by: _cv
        # outstanding granted cost: availability is DERIVED as
        # capacity - _out, so AIMD capacity moves (cuts and restores)
        # are spendable immediately — a stored available-pool would
        # conserve the post-cut pool and never see the restore
        self._out = 0.0                     # guarded-by: _cv
        self._cv = threading.Condition()
        self.ooms = 0                       # guarded-by: _cv
        self.cuts = 0                       # guarded-by: _cv
        self._waiters: list = []            # guarded-by: _cv
        self._seq = 0                       # guarded-by: _cv
        self._lat: deque = deque(
            maxlen=BUDGET_LATENCY_WINDOW)   # guarded-by: _cv
        self._last_cut = float("-inf")      # guarded-by: _cv
        self._qdepth = 0.0                  # guarded-by: _cv
        # the walk's holder (a thread ident) and its grant's cost;
        # lenders waiting to take their walk back go before any waiter
        self._holder: int | None = None     # guarded-by: _cv
        self._held = 0.0                    # guarded-by: _cv
        self._returning = 0                 # guarded-by: _cv
        self._waits: deque = deque(
            maxlen=BUDGET_LATENCY_WINDOW)   # guarded-by: _cv
        _M_BUDGET_CAP.set(self.capacity)
        _M_BUDGET_AVAIL.set(self.capacity)

    def _avail_locked(self) -> float:  # holds: _cv
        """Spendable device-seconds; negative while an over-capacity
        chunk is in flight or after a cut undercuts outstanding work."""
        return self.capacity - self._out

    def _head_locked(self, now: float) -> _Waiter:  # holds: _cv
        """The waiter the free walk goes to: aged waiters first, in
        arrival order, then the most entitled (priority, then arrival).
        One total order, so a free walk always has exactly one taker.
        (The JAX budget's bypass rules need room for two chunks; with
        one walk every waiter fits, and there its rules let an aged
        clean waiter and a younger suspect each wait for the other.)"""
        def order(w: _Waiter) -> tuple:
            if now - w.t0 > self.aging_s:
                return (0, w.t0, w.seq)
            return (1, -w.priority, w.seq)
        return min(self._waiters, key=order)

    def _grantable(self, w: _Waiter, now: float) -> bool:  # holds: _cv
        # one walk at a time; a lent walk returns before any grant. One
        # chunk always fits: capacity counts the walking chunk alone
        return (self._holder is None and not self._returning
                and self._head_locked(now) is w)

    def acquire(self, cost: float, timeout_s: float | None = None,
                cancel: Callable[[], bool] | None = None,
                priority: int = 0) -> bool:
        cost = max(float(cost), 1e-9)
        deadline = (None if timeout_s is None
                    else _time.monotonic() + timeout_s)
        with self._cv:
            self._seq += 1
            w = _Waiter(int(priority), self._seq, _time.monotonic())
            self._waiters.append(w)
            try:
                while not self._grantable(w, _time.monotonic()):
                    if cancel is not None and cancel():
                        return False
                    wait = 0.1
                    if deadline is not None:
                        wait = min(wait, deadline - _time.monotonic())
                        if wait <= 0:
                            return False
                    self._cv.wait(wait)
                self._out += cost
                self._holder, self._held = threading.get_ident(), cost
                self._waits.append(_time.monotonic() - w.t0)
                _M_BUDGET_AVAIL.set(max(0.0, self._avail_locked()))
                _M_PRIO.labels(priority=str(int(priority))).inc()
                return True
            finally:
                self._waiters.remove(w)
                # a grant/give-up can unblock a DIFFERENT waiter (the
                # entitlement head just left): re-check promptly
                self._cv.notify_all()

    def release(self, cost: float, clean: bool = True,
                seconds: float | None = None) -> None:
        """Return a chunk's cost; `seconds` is its observed device
        latency — the AIMD restore/cut signal."""
        cost = max(float(cost), 1e-9)
        with self._cv:
            now = _time.monotonic()
            if seconds is not None:
                self._lat.append(float(seconds))
                if self.adaptive and len(self._lat) >= 8 \
                        and now - self._last_cut >= self.hysteresis_s:
                    p95 = self._p95_locked()
                    if p95 is not None and p95 > self.blowout_s:
                        self._cut_locked("latency", now)
            low_latency = seconds is None or seconds <= \
                self.blowout_s * BUDGET_RESTORE_LATENCY_FRACTION
            mid_latency = seconds is not None and not low_latency \
                and seconds <= self.blowout_s * \
                BUDGET_RESTORE_SLOW_FRACTION
            if clean and (low_latency or mid_latency) \
                    and self.capacity < self.initial \
                    and now - self._last_cut >= self.hysteresis_s:
                step = self.initial * self.restore_step
                if mid_latency:
                    step *= 0.5   # healthy-but-unhurried chunks
                    #               (between the bars) re-open slowly:
                    #               a fleet whose normal latency sits
                    #               there must not stay halved forever
                elif self._qdepth > BUDGET_HUNGRY_ROWS:
                    step *= 2   # deep queues + clean fast chunks:
                    #             the cut overshot, re-open faster
                self.capacity = min(self.initial,
                                    self.capacity + step)
            self._out = max(0.0, self._out - cost)
            self._holder, self._held = None, 0.0
            _M_BUDGET_CAP.set(self.capacity)
            _M_BUDGET_AVAIL.set(max(0.0, self._avail_locked()))
            self._cv.notify_all()

    @contextlib.contextmanager
    def walk(self, priority: int = 0):
        """The walk alone, for device work that is not a priced chunk (a
        stream's finish, a drain's checkpoint): granted in entitlement
        order like a chunk, charging nothing and feeding no latency."""
        self.acquire(0.0, priority=priority)
        try:
            yield
        finally:
            self.release(0.0, clean=False)

    @contextlib.contextmanager
    def lend(self):
        """Step out of this thread's walk for host-only work inside it
        (the recovery ladder's backoff sleep, the blame's host
        explanation): the walk goes to the next waiter and comes back,
        ahead of every waiter, when that walk ends. The lender's cost
        leaves the ledger meanwhile: its chunk is not on the card. A
        thread that holds no walk lends nothing."""
        with self._cv:
            if self._holder != threading.get_ident():
                held = None
            else:
                held = self._held
                self._out = max(0.0, self._out - held)
                self._holder, self._held = None, 0.0
                self._cv.notify_all()
        try:
            yield
        finally:
            if held is not None:
                with self._cv:
                    self._returning += 1
                    try:
                        while self._holder is not None:
                            self._cv.wait()
                    finally:
                        self._returning -= 1
                    self._out += held
                    self._holder, self._held = threading.get_ident(), held

    def _cut_locked(self, signal: str, now: float) -> None:  # holds: _cv
        self.capacity = max(self.floor, self.capacity / 2)
        self._last_cut = now
        self.cuts += 1
        _M_CUTS.labels(signal=signal).inc()
        _M_BUDGET_CAP.set(self.capacity)
        _M_BUDGET_AVAIL.set(max(0.0, self._avail_locked()))

    def note_oom(self) -> None:
        """Memory pressure cuts immediately, hysteresis or not — the
        alternative is the backend OOM-killing every stream."""
        with self._cv:
            self.ooms += 1
            self._cut_locked("oom", _time.monotonic())
            _M_OOMS.inc()
            self._cv.notify_all()

    def note_queue_depth(self, rows: int) -> None:
        with self._cv:
            self._qdepth = 0.9 * self._qdepth + 0.1 * float(rows)

    def _p95_locked(self, window: deque | None = None) \
            -> float | None:  # holds: _cv
        xs = self._lat if window is None else window
        if not xs:
            return None
        xs = sorted(xs)
        return xs[int(0.95 * (len(xs) - 1))]

    def signals(self) -> dict:
        """The overload signals the ladder controller reads (one lock
        round-trip)."""
        with self._cv:
            return {"waiters": len(self._waiters),
                    "capacity": self.capacity,
                    "initial": self.initial,
                    "available": max(0.0, self._avail_locked()),
                    "p95_latency_s": self._p95_locked(),
                    "p95_walk_wait_s": self._p95_locked(self._waits),
                    "queue_depth_ewma": self._qdepth,
                    "recent_cut": (_time.monotonic() - self._last_cut
                                   < self.hysteresis_s)}

    def status(self) -> dict:
        with self._cv:
            return {"unit": "device-seconds",
                    "initial": self.initial,
                    "capacity": self.capacity,
                    "available": max(0.0, self._avail_locked()),
                    "floor": self.floor,
                    "adaptive": self.adaptive,
                    "ooms": self.ooms,
                    "cuts": self.cuts,
                    "waiters": len(self._waiters),
                    "p95-chunk-latency-s": self._p95_locked(),
                    "p95-walk-wait-s": self._p95_locked(self._waits),
                    "queue-depth-ewma": round(self._qdepth, 1)}


@dataclasses.dataclass
class ChunkPrice:
    """One chunk's price for a WGL stream: modeled element-ops from
    `wgl.select_engine` at the stream's actual kernel shape, priced
    into device-seconds through the calibration."""
    cost: float         # device-seconds (budget units)
    elementops: float   # modeled element-ops for one chunk
    variant: str        # dense | sort | hash | unpriced
    reason: str


def chunk_cost(stream, calibration=None) -> ChunkPrice:
    from .checker import wgl
    srange = stream.state_range or (0, 3)   # undeclared: nominal S=4
    try:
        eng = stream.engine if stream.engine in ("dense", "sort") \
            else "auto"
        dec = wgl.select_engine(tuple(srange), stream.p, stream.chunk,
                                slots=stream.p,
                                frontier=stream.frontier, engine=eng,
                                calibration=calibration)
        ops = wgl.engine_cost(dec)
        variant, reason = wgl.engine_variant(dec), dec.reason
    except Exception:  # noqa: BLE001 — pricing is advisory
        ops, variant, reason = 1e6, "unpriced", "unpriced"
    return ChunkPrice(_calibrate.price(calibration, variant, ops),
                      ops, variant, reason)


# ---------------------------------------------------------------------------
# one stream's worker
# ---------------------------------------------------------------------------

class StreamWorker:
    """One admitted run's verification: a bounded op queue, its stream
    targets, and a dedicated thread that feeds/pumps them. All device
    faults stay inside this worker: classified ones climb the
    stream's own recovery ladder, unclassified ones quarantine the
    worker."""

    def __init__(self, name: str, spec: dict, service: "VerificationService",
                 store_dir: str | None = None,
                 overrides: dict | None = None):
        self.name = name
        self.spec = spec
        self.service = service
        self.store_dir = store_dir
        self.state = ADMITTED
        self.q: _queue.Queue = _queue.Queue(maxsize=service.queue_ops)
        self.targets = build_targets(spec, stream_name=name,
                                     overrides=overrides,
                                     device=service.device)
        self.target_names = sorted(self.targets)
        self._final_chunks: dict = {}
        self._final_attest_failures = 0
        self.results: dict = {}
        self.error: str | None = None
        self.done = threading.Event()
        self._term_lock = threading.Lock()
        self._terminated = False        # guarded-by: _term_lock
        self.violation = False
        self.ops_fed = 0
        self.recoveries = 0
        self.shed_reason: str | None = None
        self._drain = threading.Event()
        self._dead_targets: set[str] = set()
        # durable periodic checkpoints (worker thread only): the last
        # persisted per-target checkpoint_seq snapshot, plus a flag
        # forcing one persist right after admission — a SIGKILL before
        # the first carry checkpoint must still leave a manifest so
        # recover() resumes the stream cold, no drain required
        self._persisted_seqs: dict[str, int] = {}
        self._persist_pending = bool(store_dir)
        self._costs = {n: chunk_cost(t, service.calibration)
                       for n, t in self.targets.items()
                       if hasattr(t, "pending_chunks")}
        for n in self._costs:
            # host-only work inside a walk (backoff, blame) lends it out
            self.targets[n].host_work = service.budget.lend
        # -- degradation-ladder / suspicion-priority scheduling state.
        # Written by the worker thread AND the service ladder thread,
        # read by status()/socket threads — all through the methods
        # below, under _tier_lock.
        self._tier_lock = threading.Lock()
        self.tier = TIER_FULL               # guarded-by: _tier_lock
        self.max_tier = TIER_FULL           # guarded-by: _tier_lock
        self.tier_transitions = 0           # guarded-by: _tier_lock
        self._tier_frozen = False           # guarded-by: _tier_lock
        self.suspicion_score = 0.0          # guarded-by: _tier_lock
        from .checker import screen as _screen
        # deterministic per-stream sample for the sampled-escalation
        # tier (same Knuth hash the tier-1 audit sampling uses)
        self._sampled = _screen.sample_decision(
            zlib.crc32(name.encode()), LADDER_SAMPLE)
        # a stream is *suspect* at the tier-1 escalation bar, not at
        # any nonzero suspicion: soft signals (crashed mutators, 0.02
        # each capped 0.5) ride nearly every realistic history — below
        # the bar they must neither outrank siblings nor pin a stream
        # to tier-full, or priority and the ladder both degenerate
        self._suspect_bar = _screen.ESCALATE_THRESHOLD
        self._pumped = 0    # clean chunks pumped (worker thread only)
        # per-target chunks pumped IN THIS PROCESS (worker thread
        # only) — `t._chunks` survives a checkpoint resume, so it
        # cannot tell a restarted daemon's compile-paying first chunk
        # from a warm one
        self._pumped_by: dict[str, int] = {}
        # targets whose chunk 0 compiled the kernel: their lagged
        # warm==1 latency sample is compile, not execution
        # (worker thread only)
        self._cal_skip: set = set()
        self.thread = threading.Thread(
            target=self._run, name=f"jepsen-service-{name}",
            daemon=True)

    # -- degradation ladder + suspicion-priority metadata --------------------

    def current_tier(self) -> int:
        with self._tier_lock:
            return self.tier

    def set_tier(self, tier: int, why: str) -> bool:
        """One ladder transition (idempotent). Climbing to TIER_SHED
        sheds the stream (the pre-existing terminal rung). Refused
        once the verdict's ladder stamp is cut (_finish): a climb
        after that would show in status() but not in the verdict."""
        with self._tier_lock:
            if self._tier_frozen:
                return False
            old = self.tier
            if tier == old:
                return False
            self.tier = tier
            self.max_tier = max(self.max_tier, tier)
            self.tier_transitions += 1
        with self.service._lock:
            self.service.ladder_transitions_total += 1
        direction = "climb" if tier > old else "descend"
        _M_LADDER.labels(direction=direction,
                         tier=TIER_NAMES[tier]).inc()
        log.log(logging.WARNING if tier > old else logging.INFO,
                "service %s: ladder %s %s -> %s (%s)", self.name,
                direction, TIER_NAMES[old], TIER_NAMES[tier], why)
        if tier == TIER_SHED:
            self.shed(f"degradation ladder: {why}")
        return True

    def refresh_suspicion(self) -> float:
        """Pull the targets' live suspicion into the scheduling
        metadata. A stream that turns suspect is prioritized for
        device time and — safety beats hysteresis — descends to
        tier-full immediately."""
        targets = self.targets   # snapshot: _release_targets swaps it
        s = 0.0
        for n, t in targets.items():
            if n in self._dead_targets:
                continue
            if getattr(t, "violation", False):
                s = max(s, 1.0)
            try:
                s = max(s, float(getattr(t, "suspicion", 0.0) or 0.0))
            except (TypeError, ValueError):
                pass
        with self._tier_lock:
            was, self.suspicion_score = self.suspicion_score, s
        suspect = s >= self._suspect_bar
        if suspect and was < self._suspect_bar:
            _M_EVENTS.labels(event="prioritized").inc()
        if suspect and self.current_tier() in (TIER_SAMPLED,
                                               TIER_SCREEN):
            self.set_tier(TIER_FULL, "suspicion")
        return s

    def scheduling_priority(self) -> int:
        with self._tier_lock:
            return 1 if self.suspicion_score >= self._suspect_bar \
                else 0

    def device_cost(self) -> float:
        """This stream's priced per-chunk device cost — the ladder
        climbs the most expensive clean stream first (shedding a cheap
        screen-heavy stream frees almost nothing)."""
        return sum(p.cost for p in self._costs.values())

    def _device_allowed(self) -> bool:
        """May this stream's device (WGL) targets dispatch chunks at
        its current tier? Screens always run — they are fed, not
        pumped."""
        with self._tier_lock:
            tier, susp = self.tier, self.suspicion_score
        if tier == TIER_FULL:
            return True
        if tier == TIER_SAMPLED:
            return susp >= self._suspect_bar or self._sampled
        return False

    def _terminal(self, event: str) -> None:
        """Mark the worker done, counting the terminal lifecycle event
        exactly once (the first transition wins; a shed racing a drain
        across threads still counts a single terminal event)."""
        with self._term_lock:
            first, self._terminated = not self._terminated, True
        if first:
            _M_EVENTS.labels(event=event).inc()
            _M_ACTIVE.dec()
            _probe("lifecycle", stream=self.name, state=self.state,
                   cause=event)
            # terminal streams free their service-side residue NOW —
            # the session token/high-water mark (no client can resume
            # a finished stream onto a live worker) and the journal
            # tail's poll slot (its fd would otherwise wait for the
            # next watcher pass)
            self.service._stream_terminal(self.name)
        self.done.set()

    # -- worker thread -----------------------------------------------------

    def _run(self) -> None:
        try:
            if self.service.device.type == "cuda":
                # the current device is per thread: name the service's
                # card before any tensor work on this one
                torch.cuda.set_device(self.service.device)
            self._loop()
        except BaseException:  # noqa: BLE001 — thread boundary
            self._quarantine(traceback.format_exc())
        finally:
            # a long-lived daemon serves thousands of runs: once this
            # worker is terminal, its streams' step logs and staging
            # buffers (the whole history, in int32 rows) must not
            # outlive it — snapshot the status detail, drop the rest
            self._release_targets()

    def _release_targets(self) -> None:
        self._final_chunks = self._chunk_status()
        self._final_attest_failures = self._attest_failures()
        # shed/quarantine can leave ops queued (only the _loop bleed
        # branch drains them, and a quarantine raises past it): drop
        # them here so a terminal worker never pins a full queue of
        # op dicts for the daemon's life
        self._bleed_queue()
        for t in self.targets.values():
            # shed/drained/quarantined streams never reach finish():
            # record their root trace spans before dropping them, or
            # their exported chunk spans orphan in the collector
            if hasattr(t, "end_trace"):
                t.end_trace()
        self.targets = {}
        self._dead_targets = set()

    def _attest_failures(self) -> int:
        if not self.targets:
            return self._final_attest_failures
        return sum(
            sum(1 for k in getattr(t, "faults", []) if k == "corrupt")
            for t in self.targets.values())

    def _chunk_status(self) -> dict:
        out = dict(self._final_chunks)
        for name, t in self.targets.items():
            if hasattr(t, "pending_chunks"):
                price = self._costs.get(name)
                out[name] = {
                    "dispatched": getattr(t, "_chunks", 0),
                    "pending": (t.pending_chunks()
                                if name not in self._dead_targets
                                else 0),
                    "chunk-syncs": getattr(t, "_chunk_syncs", 0),
                    "resumed-from-chunk": getattr(
                        t, "_resumed_from_chunk", None),
                    "cost-per-chunk": price.cost if price else None,
                    "elementops-per-chunk": (price.elementops
                                             if price else None),
                    "variant": price.variant if price else None,
                    "engine-reason": price.reason if price else "",
                }
        return out

    def _loop(self) -> None:
        sealed = False
        while True:
            if self._drain.is_set():
                self._do_drain()
                return
            if self.state in (SHED, QUARANTINED):
                self._bleed_queue()
                return
            try:
                item = self.q.get(timeout=0.05)
            except _queue.Empty:
                item = None
            fed = 0
            while item is not None:
                if item is _CLOSE:
                    self.state = SHED
                    self.shed_reason = "client closed"
                    self._terminal("shed")
                    return
                if item is _SEAL:
                    sealed = True
                    break
                self._feed(item)
                fed += 1
                if fed >= 4096:
                    break   # let the pump keep up with a firehose
                try:
                    item = self.q.get_nowait()
                except _queue.Empty:
                    break
            if fed:
                _M_OPS.inc(fed)   # one batched inc per drain burst
            self.refresh_suspicion()
            self._pump()
            self._note_violation()
            self._maybe_persist()
            if sealed and self.q.empty():
                self._finish()
                return

    def _feed(self, op: dict) -> None:
        if self.state == ADMITTED:
            self.state = STREAMING
            _probe("lifecycle", stream=self.name, state=STREAMING)
        self.ops_fed += 1
        for name, t in self.targets.items():
            if name in self._dead_targets:
                continue
            try:
                t.feed(op)
            except Exception as e:  # noqa: BLE001 — containment
                # a target whose *feed* (host-side encode) breaks is
                # dropped like OnlineChecker does; offline covers it.
                # The whole worker quarantines only on errors with no
                # such containment (thread boundary above).
                log.warning("service %s: target %r failed at feed "
                            "(%s); offline checking covers it",
                            self.name, name, e, exc_info=True)
                self._dead_targets.add(name)
        self._note_violation()

    def _note_violation(self) -> None:
        """Copy the targets' violation flags up (screens flip at feed,
        WGL streams flip at a chunk sync inside pump — check after
        both)."""
        if not self.violation and any(
                getattr(t, "violation", False)
                for n, t in self.targets.items()
                if n not in self._dead_targets):
            self.violation = True

    def _pump(self) -> None:
        """Dispatch pending chunks under the global budget — the
        cost-model scheduling point. One chunk per acquire, so other
        streams' acquires interleave between our chunks. Suspicion
        sets the acquire priority; the degradation ladder gates
        whether device chunks dispatch at all (screens are fed, not
        pumped — they run at every tier)."""
        _M_QUEUE.observe(self.q.qsize())
        self.service.budget.note_queue_depth(self.q.qsize())
        for name, t in self.targets.items():
            if name in self._dead_targets \
                    or not hasattr(t, "pending_chunks"):
                continue
            while t.pending_chunks() > 0 and not self._drain.is_set():
                if not self._device_allowed():
                    # deferred by the ladder; chunks stay pending (a
                    # descend or finish-time suspicion re-opens them)
                    return
                price = self._costs.get(name)
                if price is None:
                    price = self._costs[name] = \
                        chunk_cost(t, self.service.calibration)
                if not self.service.budget.acquire(
                        price.cost, timeout_s=5.0,
                        cancel=self._drain.is_set,
                        priority=self.scheduling_priority()):
                    break
                n0 = len(t.faults)
                clean = True
                try:
                    t0 = _time.monotonic()
                    t.pump(1)
                    dt = _time.monotonic() - t0
                except Exception:  # noqa: BLE001 — unclassified
                    self.service.budget.release(price.cost,
                                                clean=False)
                    raise
                new = t.faults[n0:]
                if new:
                    clean = False
                    self.recoveries += len(new)
                    self.state = RECOVERING
                    _probe("lifecycle", stream=self.name,
                           state=RECOVERING, faults=list(new))
                    if any(k == "oom" for k in new):
                        self.service.budget.note_oom()
                    # the stream re-priced itself (OOM halves its chunk
                    # or moves a dense stream to the sort family):
                    # re-price the chunk
                    self._costs[name] = chunk_cost(
                        t, self.service.calibration)
                else:
                    # feed the measured cost model, as the JAX service
                    # does: pump 0 (which builds the engine) never
                    # feeds, pump 1 feeds unless THIS stream was the
                    # first of its shape in the process (its early
                    # chunks paid the library load, the CUDA context
                    # and the allocator's warm-up), and unpriced
                    # targets never feed
                    self._pumped += 1
                    warm = self._pumped_by.get(name, 0)
                    self._pumped_by[name] = warm + 1
                    if warm == 0:
                        kk = getattr(t, "kernel_key", lambda: None)()
                        if kk is not None and \
                                not _kernel_already_run(kk):
                            self._cal_skip.add(name)
                    elif price.variant != "unpriced" and not (
                            warm == 1 and name in self._cal_skip):
                        self.service.calibration.observe(
                            price.variant, price.elementops, dt)
                    if self._pumped % REPRICE_EVERY_CHUNKS == 0:
                        # calibration converges while we pump: re-price
                        # so the budget charge tracks measured seconds
                        self._costs[name] = chunk_cost(
                            t, self.service.calibration)
                self.service.budget.release(price.cost, clean=clean,
                                            seconds=dt)
            if self.state == RECOVERING:
                self.state = STREAMING
                _probe("lifecycle", stream=self.name, state=STREAMING,
                       recovered=True)

    def _walk(self, t):
        """The walk for a target's device work outside a priced chunk (a
        finish, a drain's checkpoint); targets that do not walk (the
        screens, the rw-register stream) run beside it."""
        if not hasattr(t, "pending_chunks"):
            return contextlib.nullcontext()
        return self.service.budget.walk(self.scheduling_priority())

    def _finish(self) -> None:
        # last suspicion pull before the verdict: a stream that turned
        # suspect descends to tier-full (refresh_suspicion) and its
        # pending device chunks run after all — safety beats the ladder
        self.refresh_suspicion()
        self._note_violation()
        with self._tier_lock:
            tier, max_tier = self.tier, self.max_tier
        defer_device = not self._device_allowed()
        out: dict = {}
        for name, t in self.targets.items():
            if name in self._dead_targets:
                continue
            if defer_device and hasattr(t, "pending_chunks") \
                    and t.pending_chunks() > 0:
                # the ladder held this stream's device chunks back and
                # nothing ever looked suspect: defer the device verdict
                # to offline checking (no "valid?" key -> the checkers'
                # streamed-results reuse guard skips it) instead of
                # pumping a whole history at seal time under overload.
                # A target with NOTHING pending finished its device
                # work before the climb — its verdict is already paid
                # for, so finish() keeps it
                out[name] = {"deferred": True,
                             "reason": f"degradation ladder: "
                                       f"{TIER_NAMES[tier]}",
                             "ladder-tier": TIER_NAMES[tier],
                             "history-len": self.ops_fed}
                _M_EVENTS.labels(event="device-verdict-deferred").inc()
                continue
            try:
                with self._walk(t):
                    r = t.finish()
            except RuntimeError:
                # finish runs its own recovery ladder inside the
                # stream; an escape here is unclassified
                self._quarantine(traceback.format_exc())
                return
            if r is not None:
                r.setdefault("history-len", self.ops_fed)
                out[name] = r
        # stamp degraded-tier verdicts so they are distinguishable
        # from full ones. Streams that stayed at tier-full carry NO
        # stamp: their verdicts remain byte-identical to solo runs.
        # Re-read max_tier here, NOT the pre-pump snapshot: the
        # controller can climb this stream while finish() pumps its
        # pending chunks, and status() would then report a max-tier
        # the verdict didn't carry. Freezing the tier under the same
        # lock closes the other half of that race (a climb between
        # this stamp and done.set()).
        with self._tier_lock:
            self._tier_frozen = True
            if self.max_tier > TIER_FULL:
                out["ladder"] = {
                    "tier": TIER_NAMES[self.tier],
                    "max-tier": TIER_NAMES[self.max_tier],
                    "transitions": self.tier_transitions,
                }
        self.results = out
        self.state = VERDICT
        if self.store_dir and not self.service.fenced():
            try:
                store.write_streamed_results(self.store_dir, out)
                store.clear_service_resume(self.store_dir)
            except OSError:
                log.warning("service %s: could not flush verdicts to "
                            "%s", self.name, self.store_dir,
                            exc_info=True)
        self._terminal("verdict")

    def _quarantine(self, tb: str) -> None:
        """Unclassified failure: this stream is done, degraded, with
        the error attached — and ONLY this stream (the journal is
        intact; offline analyze covers it)."""
        self.error = tb
        self.state = QUARANTINED
        self.results = dict(self.results)
        self.results["degraded"] = True
        self.results["error"] = tb
        log.warning("service %s: quarantined on unclassified error; "
                    "siblings unaffected\n%s", self.name, tb)
        self._terminal("quarantined")

    def _bleed_queue(self) -> None:
        try:
            while True:
                self.q.get_nowait()
        except _queue.Empty:
            pass

    def _maybe_persist(self) -> None:
        """Durable periodic checkpoints: whenever a target stored a
        fresh carry checkpoint since the last persist (its
        ``checkpoint_seq`` moved — every ``checkpoint_every`` cycle),
        atomically persist the exported carries + journal offset +
        attestation tallies into the run's store dir. A SIGKILL then
        recovers from the last persisted checkpoint instead of
        re-checking cold — no drain manifest required."""
        if not self.store_dir:
            return
        seqs = {n: t.checkpoint_seq for n, t in self.targets.items()
                if n not in self._dead_targets
                and hasattr(t, "checkpoint_seq")}
        if not self._persist_pending and seqs == self._persisted_seqs:
            return
        if self._persist_checkpoints():
            self._persisted_seqs = seqs
            self._persist_pending = False

    def _export_checkpoints(self) -> dict:
        """Every live target's exportable checkpoint (WGL carries plus
        host streams' progress markers); a target whose export breaks
        is left out — it resumes cold from the journal."""
        checkpoints: dict = {}
        for name, t in self.targets.items():
            if name in self._dead_targets \
                    or not hasattr(t, "export_checkpoint"):
                continue
            try:
                ck = t.export_checkpoint()
            except Exception:  # noqa: BLE001 — persist is best-effort
                log.warning("service %s: could not export %r's "
                            "checkpoint; it will resume cold",
                            self.name, name, exc_info=True)
                continue
            if ck is not None:
                checkpoints[name] = ck
        return checkpoints

    def _persist_checkpoints(self,
                             checkpoints: dict | None = None) -> bool:
        """Write the resume manifest atomically (tmp-then-rename in
        store.write_service_resume) into the run's store dir — unless
        this service has been fenced out of the store by a promoted
        standby, whose recovered state must win over a zombie's late
        writes."""
        if self.service.fenced():
            return False
        if checkpoints is None:
            checkpoints = self._export_checkpoints()
        try:
            store.write_service_resume(self.store_dir, {
                "stream": self.name,
                "targets": self.spec,
                "ops-fed": self.ops_fed,
                "journal-offset": self.ops_fed,
                "epoch": self.service.epoch,
                "checkpoints": checkpoints,
            })
            return True
        except OSError:
            log.warning("service %s: could not persist the resume "
                        "manifest", self.name, exc_info=True)
            return False

    def _do_drain(self) -> None:
        """Checkpoint every WGL target at the exact drain point and
        persist the resume manifest + any partial verdicts into the
        run's store dir."""
        for name, t in self.targets.items():
            if name in self._dead_targets \
                    or not hasattr(t, "checkpoint_now"):
                continue
            try:
                with self._walk(t):
                    t.checkpoint_now()
            except Exception:  # noqa: BLE001 — drain is best-effort
                log.warning("service %s: checkpoint of %r failed at "
                            "drain; it resumes from its last periodic "
                            "checkpoint", self.name, name,
                            exc_info=True)
        if self.store_dir:
            self._persist_checkpoints()
            if self.results and not self.service.fenced():
                try:
                    store.write_streamed_results(self.store_dir,
                                                 self.results)
                except OSError:
                    log.warning("service %s: could not persist "
                                "partial verdicts", self.name,
                                exc_info=True)
        self.state = DRAINED
        self._terminal("drained")

    # -- service-side API --------------------------------------------------

    def offer(self, op: dict, timeout_s: float) -> bool:
        """Enqueue an op; False (and the stream sheds) when the queue
        stayed full past timeout_s — the admission-control
        backpressure rung."""
        if self.state in (SHED, QUARANTINED, DRAINED):
            return False
        try:
            self.q.put(op, timeout=timeout_s)
            return True
        except _queue.Full:
            self.shed("backpressure: op queue full "
                      f"({self.service.queue_ops}) for {timeout_s}s")
            return False

    def seal(self) -> None:
        self.q.put(_SEAL)

    def shed(self, reason: str) -> None:
        if self.state in (VERDICT, QUARANTINED, DRAINED, SHED):
            return
        self.shed_reason = reason
        self.state = SHED
        log.warning("service %s: shed (%s); offline analyze covers "
                    "it from the journal", self.name, reason)
        if self.store_dir and not self.service.fenced():
            try:
                store.write_streamed_results(
                    self.store_dir,
                    {"deferred": True, "reason": reason})
            except OSError:
                pass
        self._terminal("shed")

    def status(self) -> dict:
        with self._tier_lock:
            tier, max_tier = self.tier, self.max_tier
            transitions = self.tier_transitions
            suspicion = self.suspicion_score
        st = {
            "state": self.state,
            "queue-depth": self.q.qsize(),
            "ops-fed": self.ops_fed,
            "violation": self.violation,
            "recoveries": self.recoveries,
            "attest-failures": self._attest_failures(),
            "targets": self.target_names,
            "dead-targets": sorted(self._dead_targets),
            "ladder-tier": TIER_NAMES[tier],
            "ladder-max-tier": TIER_NAMES[max_tier],
            "tier-transitions": transitions,
            "suspicion": suspicion,
            "priority": (1 if suspicion >= self._suspect_bar else 0),
        }
        chunks = self._chunk_status()
        if chunks:
            st["chunks"] = chunks
        if self.shed_reason:
            st["shed-reason"] = self.shed_reason
        if self.error:
            st["error"] = self.error.splitlines()[-1]
        return st


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

class _Session:
    """One client session's server-side wire-protocol state: the
    sequence high-water mark that turns at-least-once delivery into
    exactly-once application. Every field is guarded by the service's
    ``_session_lock`` (the table's own lock — see __init__)."""

    __slots__ = ("token", "seq", "replays", "journal_fed", "touched")

    def __init__(self, token: str, journal_fed: bool = False):
        self.token = token          # the client's opaque identity
        self.seq = 0                # highest op sequence applied
        self.replays = 0            # duplicate ops dropped
        # a journal-fed stream is driven by the store tail (recover or
        # watch); socket ops would double-apply and are dropped
        self.journal_fed = journal_fed
        # last attach/apply (monotonic) — the TTL sweep's idle clock
        self.touched = _time.monotonic()


class VerificationService:
    """See the module docstring. In-process API first (admit / offer /
    seal / result / shed / drain / resume / status); `serve()` exposes
    it over a local socket, `watch()` tails a store directory.
    device: the card every stream runs on (None = CUDA, raising without
    one; 'cpu' = the plain PyTorch path)."""

    def __init__(self, max_streams: int = DEFAULT_MAX_STREAMS,
                 queue_ops: int = DEFAULT_QUEUE_OPS,
                 shed_timeout_s: float = DEFAULT_SHED_TIMEOUT_S,
                 budget_elementops: float = DEFAULT_BUDGET_ELEMENTOPS,
                 calibration: "_calibrate.Calibration | None" = None,
                 adaptive: bool = True,
                 ladder_tick_s: float = LADDER_TICK_S,
                 ladder_climb_hold_s: float = LADDER_CLIMB_HOLD_S,
                 ladder_descend_hold_s: float = LADDER_DESCEND_HOLD_S,
                 session_ttl_s: float = SESSION_TTL_S,
                 device=None):
        # CUDA unless the caller names the CPU; raises without a card.
        # The index is made explicit so worker threads pin this card
        self.device = pin_device(device)
        self.max_streams = max_streams
        self.queue_ops = queue_ops
        self.shed_timeout_s = shed_timeout_s
        # every service calibrates a private cost model from its own
        # chunk latencies (the daemon passes the persisted one in and
        # saves it back at drain — calibration_path); budget capacity
        # converts through the same nominal constant the uncalibrated
        # pricing uses, so static scheduling is unchanged
        self.calibration = (calibration if calibration is not None
                            else _calibrate.Calibration(
                                platform=self.device.type))
        self.calibration_path: str | None = None
        # the budget also grants the card's one walk (a chunk, a finish,
        # a drain's checkpoint): concurrent host-bound walks were slower
        # than serial ones on an H100 (4 streams 18.06 s where 1 took
        # 0.50 s, and 16 passed the 5 s p95 chunk bar). Workers feed and
        # encode beside it; a chunk's latency is its walk, not its wait
        self.budget = ChunkBudget(
            budget_elementops
            * _calibrate.NOMINAL_SECONDS_PER_ELEMENTOP,
            adaptive=adaptive)
        self.adaptive = bool(adaptive)
        self.ladder_tick_s = float(ladder_tick_s)
        self.ladder_climb_hold_s = float(ladder_climb_hold_s)
        self.ladder_descend_hold_s = float(ladder_descend_hold_s)
        self._ladder_stop = threading.Event()
        self._ladder_thread: threading.Thread | None = None  # guarded-by: _lock
        # overload/calm onset timestamps (ladder thread only)
        self._overload_t: float | None = None
        self._calm_t: float | None = None
        self.workers: dict[str, StreamWorker] = {}  # guarded-by: _lock
        # finished workers kept (newest last) for late status/result
        # queries; older ones are reaped so a long-lived daemon's
        # worker table stays bounded
        self.keep_done = 64
        self.draining = False           # guarded-by: _lock
        self.drained = threading.Event()
        self.admitted_total = 0         # guarded-by: _lock
        self.refused_total = 0          # guarded-by: _lock
        # monotonic across the daemon's whole life: summing per-worker
        # counts would go BACKWARDS when finished workers are reaped
        self.ladder_transitions_total = 0   # guarded-by: _lock
        self.t0 = _time.monotonic()
        self._lock = threading.Lock()
        self._server: _socket.socket | None = None
        self._server_threads: list[threading.Thread] = []
        self._watch_stop = threading.Event()
        self._watcher: threading.Thread | None = None
        # run_dir -> (tail, name); shared by resume()/watch() callers
        # and the watcher thread
        self._tails: dict[str, tuple] = {}      # guarded-by: _lock
        self._finished_dirs: set[str] = set()   # guarded-by: _lock
        # -- session table (the session-resilient wire protocol).
        # Its own lock, always taken sequentially with _lock, never
        # nested inside it (the JTS202 order discipline).
        self._session_lock = threading.Lock()
        self._sessions: dict[str, _Session] = {}  # guarded-by: _session_lock
        self.session_ttl_s = float(session_ttl_s)
        # -- crash consistency / replica failover state. claim_store
        # runs before any worker exists (single-threaded start or
        # standby promotion), so epoch/store_root need no lock; _fenced
        # is a monotonic False->True flag like ServiceClient._closed.
        self.store_root: str | None = None
        self.epoch = 0
        self._fenced = False
        self.recovered_total = 0        # guarded-by: _lock

    # -- admission ---------------------------------------------------------

    def admit(self, name: str, spec: dict,
              store_dir: str | None = None,
              overrides: dict | None = None) -> StreamWorker:
        self.fenced()   # a fenced-out instance flips itself draining
        with self._lock:
            if self.draining:
                self.refused_total += 1
                _M_EVENTS.labels(event="refused").inc()
                raise AdmissionRefused("service is draining")
            active = sum(1 for w in self.workers.values()
                         if not w.done.is_set())
            if active >= self.max_streams:
                self.refused_total += 1
                _M_EVENTS.labels(event="refused").inc()
                raise AdmissionRefused(
                    f"saturated: {active} active streams "
                    f"(max {self.max_streams})")
            if name in self.workers \
                    and not self.workers[name].done.is_set():
                raise AdmissionRefused(f"stream {name!r} already "
                                       "attached")
            self._reap_done_locked()
            w = StreamWorker(name, spec, self, store_dir=store_dir,
                             overrides=overrides)
            self.workers[name] = w
            self.admitted_total += 1
            _M_EVENTS.labels(event="admitted").inc()
            _M_ACTIVE.inc()
        w.thread.start()
        self._ensure_ladder()
        self._prune_sessions()
        log.info("service: admitted stream %r (targets %s)", name,
                 sorted(w.targets))
        return w

    def _reap_done_locked(self) -> None:  # holds: _lock
        done = [n for n, w in self.workers.items() if w.done.is_set()]
        for n in done[:-self.keep_done] if self.keep_done else done:
            del self.workers[n]

    def _worker(self, name: str | None) -> StreamWorker | None:
        """Locked worker lookup — the JTS2xx discipline: every read of
        the shared worker table goes through the service lock (admit's
        insert and _reap_done_locked's deletes race it otherwise)."""
        if name is None:
            return None
        with self._lock:
            return self.workers.get(name)

    def offer(self, name: str, op: dict) -> bool:
        w = self._worker(name)
        if w is None:
            return False
        return w.offer(op, self.shed_timeout_s)

    def seal(self, name: str) -> None:
        w = self._worker(name)
        if w is not None:
            w.seal()

    def result(self, name: str, timeout_s: float | None = 600.0) -> dict:
        """Block until the stream's verdicts are in; {} for a stream
        that was shed/drained (offline covers those)."""
        w = self._worker(name)
        if w is None:
            return {}
        if not w.done.wait(timeout_s):
            return {}
        return dict(w.results)

    def shed(self, name: str, reason: str = "operator") -> None:
        w = self._worker(name)
        if w is not None:
            w.shed(reason)

    # -- the degradation-ladder controller ---------------------------------

    def _ensure_ladder(self) -> None:
        with self._lock:
            if not self.adaptive or self._ladder_thread is not None:
                return   # a second controller would double the
                #          climb/descend rate (both mutate the hold
                #          timers), defeating the hysteresis
            t = threading.Thread(
                target=self._ladder_loop, name="jepsen-service-ladder",
                daemon=True)
            self._ladder_thread = t
        t.start()

    def _live_workers(self) -> list:
        with self._lock:
            return [w for w in self.workers.values()
                    if not w.done.is_set()]

    def overloaded(self, sig: dict | None = None) -> bool:
        """The ladder's overload predicate over the budget's signals:
        demand visibly exceeding supply — a p95 chunk-latency blowout
        or a hungry queue. Supply-side facts alone (a recent AIMD cut,
        capacity still below half of max) do NOT count: a lone
        transient OOM must not climb a clean stream and turn a
        deterministic verdict into a deferred one. Unlike the JAX
        service, blocked acquirers do not count either: they queue for
        the one walk, the port's normal state whenever two streams
        have chunks pending."""
        s = sig if sig is not None else self.budget.signals()
        return bool(
            (s["p95_latency_s"] or 0.0) > self.budget.blowout_s
            or s["queue_depth_ewma"] > BUDGET_HUNGRY_ROWS)

    def _ladder_step(self, now: float) -> None:
        """One controller tick: refresh suspicion for idle streams,
        climb ONE stream per sustained-overload hold, descend ONE per
        sustained-calm hold (descend hold > climb hold = transition
        hysteresis), and publish the per-tier stream gauge."""
        workers = self._live_workers()
        for w in workers:
            w.refresh_suspicion()
        if self.overloaded():
            self._calm_t = None
            if self._overload_t is None:
                self._overload_t = now
            elif now - self._overload_t >= self.ladder_climb_hold_s:
                if self._climb_one(workers):
                    self._overload_t = now  # one climb per hold
        else:
            self._overload_t = None
            if self._calm_t is None:
                self._calm_t = now
            elif now - self._calm_t >= self.ladder_descend_hold_s:
                if self._descend_one(workers):
                    self._calm_t = now      # one descend per hold
        counts = dict.fromkeys(TIER_NAMES, 0)
        for w in workers:
            counts[TIER_NAMES[w.current_tier()]] += 1
        for tname, c in counts.items():
            _M_TIER.labels(tier=tname).set(c)

    def _climb_one(self, workers: list) -> bool:
        """Climb ONE clean stream one rung: lowest tier first (spread
        the pain — no stream rides to shed while siblings sit at
        full), most expensive within a tier (climbing a cheap stream
        frees almost nothing). Suspect streams are never climbed —
        under contention they are exactly the ones that must keep
        device time."""
        eligible = [w for w in workers
                    if w.scheduling_priority() == 0
                    and w.current_tier() < TIER_SHED
                    and w._costs]   # streams with device targets only
        if not eligible:
            return False
        w = min(eligible,
                key=lambda w: (w.current_tier(), -w.device_cost()))
        return w.set_tier(w.current_tier() + 1, "sustained overload")

    def _descend_one(self, workers: list) -> bool:
        """Descend ONE degraded stream one rung: most degraded first,
        cheapest within a tier (it re-opens the least device load if
        the calm is a blip)."""
        eligible = [w for w in workers
                    if TIER_FULL < w.current_tier() < TIER_SHED]
        if not eligible:
            return False
        w = min(eligible,
                key=lambda w: (-w.current_tier(), w.device_cost()))
        return w.set_tier(w.current_tier() - 1, "sustained calm")

    def _ladder_loop(self) -> None:
        while not self._ladder_stop.wait(self.ladder_tick_s):
            try:
                self._ladder_step(_time.monotonic())
            except Exception:  # noqa: BLE001 — keep controlling
                log.warning("service: ladder tick failed",
                            exc_info=True)

    # -- drain / resume ----------------------------------------------------

    def drain(self, timeout_s: float = 60.0) -> None:
        """Stop admissions, checkpoint every live stream's carry, and
        persist per-run resume manifests — the SIGTERM path."""
        with self._lock:
            already = self.draining
            if not already:
                self.draining = True
                workers = list(self.workers.values())
        if already:
            # wait for the first drainer OUTSIDE the lock: every
            # service verb (offer/seal/poll/finish/status) now takes
            # _lock for its worker lookup, so blocking here with the
            # lock held would freeze the whole service for timeout_s
            self.drained.wait(timeout_s)
            return
        log.info("service: draining %d streams",
                 sum(1 for w in workers if not w.done.is_set()))
        self._watch_stop.set()
        self._ladder_stop.set()
        for w in workers:
            if not w.done.is_set():
                w._drain.set()
        deadline = _time.monotonic() + timeout_s
        for w in workers:
            w.done.wait(max(0.0, deadline - _time.monotonic()))
        self._join_terminal(workers, deadline)
        if self.calibration_path:
            try:
                self.calibration.save(self.calibration_path)
                log.info("service: calibration saved to %s",
                         self.calibration_path)
            except OSError:
                log.warning("service: could not persist calibration",
                            exc_info=True)
        self.drained.set()
        log.info("service: drained")

    def install_sigterm(self) -> None:
        """SIGTERM → graceful drain (then the serve loop exits)."""
        def _handler(signum, frame):  # noqa: ARG001
            log.info("service: SIGTERM — draining")
            self.drain()
        _signal.signal(_signal.SIGTERM, _handler)

    def resume(self, run_dir: str) -> str | None:
        """Re-admit a drained run from its resume manifest: the
        journal re-feeds from the start and WGL dispatch skips
        row-for-row up to the restored carry checkpoint. Returns the
        stream name (now being tailed), or None when the run carries
        no manifest."""
        man = store.load_service_resume(run_dir)
        if man is None:
            return None
        if not man.get("targets"):
            log.warning("service: resume manifest in %s carries no "
                        "targets spec; ignoring it", run_dir)
            return None
        name = man.get("stream") or os.path.basename(run_dir)
        overrides = {}
        ck_by_target = man.get("checkpoints") or {}
        for target, ck in ck_by_target.items():
            if ck.get("kind") == "host" or "p" not in ck:
                # host streams checkpoint progress only — they rebuild
                # from the re-fed journal, no kernel-shape overrides
                continue
            overrides[target] = {
                "p": ck.get("p"), "chunk": ck.get("chunk"),
                "frontier": ck.get("frontier"),
                "engine": ck.get("engine"),
                "pallas": ck.get("pallas"),
                "state-range": ck.get("state-range"),
            }
        w = self.admit(name, man["targets"], store_dir=run_dir,
                       overrides=overrides)
        _M_EVENTS.labels(event="resumed").inc()
        for target, ck in ck_by_target.items():
            t = w.targets.get(target)
            if t is not None and hasattr(t, "import_checkpoint") \
                    and "carry" in ck:
                try:
                    if t.import_checkpoint(ck):
                        log.info("service %s: %r resuming from chunk "
                                 "%d", name, target, ck["chunks"])
                except (ValueError, KeyError):
                    log.warning("service %s: bad checkpoint for %r; "
                                "resuming cold", name, target,
                                exc_info=True)
        self._tail_run(run_dir, name)
        return name

    # -- crash recovery / replica failover ---------------------------------

    def claim_store(self, store_root: str) -> int:
        """Take ownership of a store root: bump its service epoch so
        any prior owner still running is fenced the moment it next
        checks, and remember ours for the fence checks every durable
        write makes."""
        self.store_root = os.path.abspath(store_root)
        self.epoch = store.fence_service_epoch(self.store_root)
        return self.epoch

    def fenced(self) -> bool:
        """True once another service instance has claimed this store
        (the epoch file moved past ours): a promoted standby owns the
        streams now, so this instance stops persisting, admitting, and
        flushing verdicts — the new owner's state must win. Sticky:
        checked against the store on every call until it trips."""
        if self.store_root is None:
            return False
        if self._fenced:  # noqa: JTS201 — monotonic False->True flag
            return True
        if store.service_epoch(self.store_root) == self.epoch:
            return False
        self._fenced = True
        log.error("service: fenced out of %s (epoch moved past %d); "
                  "stopping admissions and durable writes",
                  self.store_root, self.epoch)
        with self._lock:
            self.draining = True
        self._watch_stop.set()
        return True

    def recover(self, store_root: str,
                spec_fn: Callable[[str], dict | None] | None = None
                ) -> list[str]:
        """Cold-start crash recovery: claim the store (fencing any
        zombie predecessor), scan it for orphaned in-progress runs — a
        journal with no delivered verdict — and resume each from its
        last durable checkpoint. The journal re-feeds from the start
        (the host-side encoder and blame attribution need the whole
        client-op feed) while device dispatch skips row-for-row up to
        the checkpoint's recorded offset, so the resumed verdict is
        byte-identical to an uninterrupted run's. Runs with no (or a
        corrupt) manifest re-check cold via ``spec_fn``. No drain
        manifest required. Returns the recovered stream names."""
        self.claim_store(store_root)
        recovered: list[str] = []
        with _trace.tracer().span("service.recover") as sp:
            for tname, runs in store.tests(store_root).items():
                for start, d in runs.items():
                    if not os.path.exists(
                            os.path.join(d, "journal.jsonl")):
                        continue
                    if os.path.exists(
                            os.path.join(d, "results.json")) \
                            or os.path.exists(os.path.join(
                                d, store.STREAMED_RESULTS_FILE)):
                        continue
                    man = store.load_service_resume(d)
                    if man is not None:
                        try:
                            name = self.resume(d)
                        except AdmissionRefused:
                            continue
                        if name is None:
                            continue
                        how = ("checkpoint" if any(
                            "carry" in ck for ck in
                            (man.get("checkpoints") or {}).values())
                            else "cold")
                    elif spec_fn is not None:
                        spec = spec_fn(d)
                        if not spec:
                            continue
                        name = f"{tname}/{start}"
                        try:
                            self.admit(name, spec, store_dir=d)
                        except AdmissionRefused:
                            continue
                        self._tail_run(d, name)
                        how = "cold"
                    else:
                        continue
                    _M_RECOVERIES.labels(how=how).inc()
                    recovered.append(name)
            if sp is not None:
                sp.tags["streams"] = str(len(recovered))
                sp.tags["epoch"] = str(self.epoch)
        with self._lock:
            self.recovered_total += len(recovered)
        if recovered:
            log.warning("service: recovered %d orphaned stream(s) "
                        "from %s (epoch %d): %s", len(recovered),
                        store_root, self.epoch,
                        ", ".join(sorted(recovered)))
        return recovered

    # -- the session table (session-resilient wire protocol) ---------------

    def _session_attach(self, stream: str, token: str,
                        journal_fed: bool) -> "_Session | None":
        """Register or re-bind a socket session. Returns the session
        (fresh, or the existing one when the token matches), or None
        on a token mismatch — a live stream must not be hijackable by
        name alone."""
        with self._session_lock:
            s = self._sessions.get(stream)
            if s is None:
                s = self._sessions[stream] = _Session(token,
                                                      journal_fed)
                return s
            if s.token == token:
                if journal_fed:
                    s.journal_fed = True
                s.touched = _time.monotonic()
                return s
            return None

    def _session_apply(self, stream: str | None, seq) -> bool:
        """Should this op be applied? False for a replayed duplicate
        (already applied before the disconnect — counted, dropped) and
        for journal-fed streams (the store tail feeds those). Ops
        without a seq are legacy clients: always applied."""
        if stream is None:
            return False
        if seq is None:
            with self._session_lock:
                s = self._sessions.get(stream)
                return not (s and s.journal_fed)
        try:
            seq = int(seq)
        except (TypeError, ValueError):
            return False
        with self._session_lock:
            s = self._sessions.get(stream)
            if s is None:
                return True     # attached without a session handshake
            if s.journal_fed:
                return False
            s.touched = _time.monotonic()
            if seq <= s.seq:
                s.replays += 1
                _M_REPLAYS.inc()
                return False
            s.seq = seq
            return True

    def _session_ack(self, stream: str | None) -> int:
        """The stream's applied-sequence high-water mark — everything
        at or below it is safe for the client to forget."""
        with self._session_lock:
            s = self._sessions.get(stream) if stream else None
            return s.seq if s else 0

    def _session_journal_fed(self, stream: str | None) -> bool:
        with self._session_lock:
            s = self._sessions.get(stream) if stream else None
            return bool(s and s.journal_fed)

    def _stream_terminal(self, name: str) -> None:
        """A worker reached a terminal state (verdict / shed /
        quarantined / drained): evict its session entry and journal
        tail right away instead of waiting for the size-gated prune or
        the next watcher pass. Locks taken sequentially, never
        nested (and never while holding the worker's _term_lock —
        _terminal releases it before calling here)."""
        with self._session_lock:
            self._sessions.pop(name, None)
        with self._lock:
            stale = [d for d, (_t, n) in self._tails.items()
                     if n == name]
            for d in stale:
                tail, _n = self._tails.pop(d)
                self._finished_dirs.add(d)
                tail.close()

    def _prune_sessions(self) -> None:
        """Bound the session table. Terminal streams already evicted
        their entries (_stream_terminal); this sweep covers the rest:
        sessions idle past the TTL with no live worker (a client that
        attached, went away, and never drove its stream to a verdict),
        plus a size-gated prune of anything not in the worker table as
        a backstop. Locks taken sequentially, never nested."""
        now = _time.monotonic()
        with self._lock:
            live = {n for n, w in self.workers.items()
                    if not w.done.is_set()}
            known = set(self.workers)
        with self._session_lock:
            if self.session_ttl_s > 0:
                for n in [n for n, s in self._sessions.items()
                          if n not in live
                          and now - s.touched > self.session_ttl_s]:
                    del self._sessions[n]
            if len(self._sessions) <= max(256, 4 * self.keep_done):
                return
            for n in [n for n in self._sessions if n not in known]:
                del self._sessions[n]

    # -- store watching ----------------------------------------------------

    def watch(self, base_dir: str,
              spec_fn: Callable[[str], dict | None] | None = None,
              scan_interval_s: float = 1.0) -> None:
        """Tail-follow journals under a store directory: every run dir
        with a journal and no results.json is admitted (spec_fn(run_dir)
        supplies its targets spec; None skips the run — without a
        spec_fn only runs with a resume manifest are picked up). Polls
        back off per-tail with decorrelated jitter while a journal is
        quiet (store.JournalTail.idle_s), so hundreds of dormant runs
        cost almost nothing."""
        self._watch_base = base_dir
        self._watch_spec_fn = spec_fn
        self._watch_scan_s = scan_interval_s
        self._ensure_watcher()

    def _ensure_watcher(self) -> None:
        if self._watcher is None:
            self._watcher = threading.Thread(
                target=self._watch_loop, name="jepsen-service-watch",
                daemon=True)
            self._watcher.start()

    def _tail_run(self, run_dir: str, name: str) -> None:
        jp = os.path.join(run_dir, "journal.jsonl")
        with self._lock:
            self._tails[run_dir] = (store.JournalTail(jp), name)
        self._ensure_watcher()

    def _stream_tailed(self, name: str) -> bool:
        """Is this stream fed from a store-side journal tail (resume /
        recover / watch) rather than by its socket?"""
        with self._lock:
            return any(n == name for _t, n in self._tails.values())

    def _scan(self) -> None:
        base = getattr(self, "_watch_base", None)
        spec_fn = getattr(self, "_watch_spec_fn", None)
        if base is None or not os.path.isdir(base):
            return
        for tname, runs in store.tests(base).items():
            for start, d in runs.items():
                with self._lock:
                    known = (d in self._tails
                             or d in self._finished_dirs)
                if known:
                    continue
                if not os.path.exists(
                        os.path.join(d, "journal.jsonl")):
                    continue
                if os.path.exists(os.path.join(d, "results.json")):
                    continue
                if os.path.exists(os.path.join(
                        d, store.STREAMED_RESULTS_FILE)):
                    # a service (this one or a predecessor) already
                    # delivered/deferred this run: re-admitting would
                    # re-verify the whole history on every scan
                    with self._lock:
                        self._finished_dirs.add(d)
                    continue
                if store.load_service_resume(d) is not None:
                    try:
                        self.resume(d)
                    except AdmissionRefused:
                        pass
                    continue
                if spec_fn is None:
                    continue
                spec = spec_fn(d)
                if not spec:
                    continue
                name = f"{tname}/{start}"
                try:
                    self.admit(name, spec, store_dir=d)
                except AdmissionRefused:
                    continue
                self._tail_run(d, name)

    def _watch_loop(self) -> None:
        last_scan = 0.0
        while not self._watch_stop.is_set():
            now = _time.monotonic()
            if now - last_scan >= getattr(self, "_watch_scan_s", 1.0):
                try:
                    self._scan()
                except Exception:  # noqa: BLE001 — keep watching
                    log.warning("service: store scan failed",
                                exc_info=True)
                last_scan = now
            sleep = 0.25
            with self._lock:
                tails = list(self._tails.items())
            for d, (tail, name) in tails:
                w = self._worker(name)
                if w is None or w.done.is_set():
                    with self._lock:
                        self._tails.pop(d, None)
                        self._finished_dirs.add(d)
                    tail.close()
                    continue
                if tail.idle_s > 0 and now < getattr(
                        tail, "_next_poll", 0.0):
                    sleep = min(sleep, tail._next_poll - now)
                    continue
                try:
                    ops = tail.poll()
                except ValueError:
                    w._quarantine(traceback.format_exc())
                    with self._lock:
                        self._tails.pop(d, None)
                    tail.close()
                    continue
                for op in ops:
                    w.offer(op, self.shed_timeout_s)
                if not ops and os.path.exists(
                        os.path.join(d, "history.jsonl.gz")):
                    # the run saved its history: the journal is
                    # complete and fully fed — seal for the verdict
                    w.seal()
                    with self._lock:
                        self._tails.pop(d, None)
                    tail.close()
                    continue
                # decorrelated-jitter idle backoff (satellite): quiet
                # journals get polled less and less, any data resets
                tail._next_poll = _time.monotonic() + tail.idle_s
                sleep = min(sleep, tail.idle_s or 0.01)
            self._watch_stop.wait(max(0.005, sleep))

    # -- status ------------------------------------------------------------

    def status(self) -> dict:
        """The /healthz shape."""
        with self._lock:
            workers = dict(self.workers)
            draining = self.draining
            admitted, refused = self.admitted_total, self.refused_total
            transitions = self.ladder_transitions_total
            recovered = self.recovered_total
        with self._session_lock:
            sessions = len(self._sessions)
            replays = sum(s.replays
                          for s in self._sessions.values())
        tiers = dict.fromkeys(TIER_NAMES, 0)
        for w in workers.values():
            if not w.done.is_set():
                tiers[TIER_NAMES[w.current_tier()]] += 1
        return {
            "state": ("drained" if self.drained.is_set()
                      else "draining" if draining else "serving"),
            "uptime_s": round(_time.monotonic() - self.t0, 3),
            "streams": {n: w.status() for n, w in workers.items()},
            "admitted-total": admitted,
            "refused-total": refused,
            "recovered-total": recovered,
            "epoch": self.epoch,
            "fenced": self._fenced,  # noqa: JTS201 — monotonic flag
            "sessions": {"count": sessions, "replays": replays},
            "shed": sorted(n for n, w in workers.items()
                           if w.state == SHED),
            "quarantined": sorted(n for n, w in workers.items()
                                  if w.state == QUARANTINED),
            "budget": self.budget.status(),
            "ladder": {"adaptive": self.adaptive,
                       "tiers": tiers,
                       "transitions": transitions},
            "calibration": {
                "platform": self.calibration.platform,
                "coefficients": self.calibration.coefficients(),
            },
            # the service-layer registry slice: stream lifecycle
            # counters, budget gauges, queue-depth/verb histograms
            "telemetry": _telemetry.snapshot(
                prefix="jepsen_tpu_service_", compact=True),
        }

    # -- the socket layer --------------------------------------------------

    def serve(self, addr: str = "127.0.0.1:0") -> str:
        """Listen on a local socket (``host:port``, port 0 picks a
        free one; a path serves a unix socket). Returns the bound
        address for clients."""
        if _is_unix_addr(addr):
            try:
                os.unlink(addr)
            except OSError:
                pass
            srv = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            srv.bind(addr)
            bound = addr
        else:
            host, _, port = addr.rpartition(":")
            srv = _socket.create_server((host or "127.0.0.1",
                                         int(port or 0)))
            bound = "%s:%d" % srv.getsockname()[:2]
        srv.listen(64)
        self._server = srv
        t = threading.Thread(target=self._accept_loop,
                             name="jepsen-service-accept", daemon=True)
        t.start()
        self._server_threads.append(t)
        log.info("verification service listening on %s", bound)
        return bound

    def _join_terminal(self, workers, deadline: float) -> None:
        """Join the threads of the workers whose verdict is final, up
        to `deadline`. `done` is set inside the worker's last steps, so
        its thread can still be releasing its targets when a caller
        sees the verdict; a process that ends then would tear torch
        down under a live thread and abort instead of exiting."""
        me = threading.current_thread()
        for w in workers:
            t = w.thread
            if w.done.is_set() and t is not me and t.ident is not None:
                t.join(max(0.0, deadline - _time.monotonic()))

    def stop(self) -> None:
        """Hard stop (after drain, or for tests): close the socket,
        stop watching, and join every terminal stream worker (a stream
        still running is left to its own end)."""
        self._watch_stop.set()
        self._ladder_stop.set()
        with self._lock:
            workers = list(self.workers.values())
        self._join_terminal(workers, _time.monotonic() + STOP_JOIN_S)
        srv, self._server = self._server, None
        if srv is not None:
            # closing the fd does NOT interrupt a thread blocked in
            # accept() on Linux — poke the listener with a throwaway
            # connect so the accept loop wakes, sees _server is None,
            # and exits (the chaos resource-leak oracle counts the
            # thread otherwise)
            try:
                with _socket.socket(srv.family,
                                    _socket.SOCK_STREAM) as poke:
                    poke.settimeout(0.2)
                    poke.connect(srv.getsockname())
            except OSError:
                pass
            try:
                srv.close()
            except OSError:
                pass
            for t in self._server_threads:
                t.join(timeout=1.0)
            self._server_threads.clear()

    def _accept_loop(self) -> None:
        while True:
            srv = self._server
            if srv is None:
                return
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            if self._server is None:   # stop()'s wake-up poke
                try:
                    conn.close()
                except OSError:
                    pass
                return
            # daemon thread per connection, deliberately NOT retained:
            # a serving daemon sees one connection per run, and an
            # ever-growing thread list is a leak
            threading.Thread(target=self._handle_conn, args=(conn,),
                             name="jepsen-service-conn",
                             daemon=True).start()

    def _handle_conn(self, conn: _socket.socket) -> None:
        stream: str | None = None
        wlock = threading.Lock()

        def reply(msg: dict, rid) -> None:
            if rid is not None:
                msg["id"] = rid
            data = (json.dumps(msg, default=store._json_default)
                    + "\n").encode()
            with wlock:
                conn.sendall(data)

        try:
            with conn:
                for line in _recv_lines(conn):
                    if line is None:
                        # oversized frame: the reader skipped it;
                        # answer and keep the connection alive
                        reply({"ok": False,
                               "error": "line too long "
                                        f"(max {MAX_LINE_BYTES})"},
                              None)
                        continue
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        msg = json.loads(line)
                    except ValueError:
                        reply({"ok": False,
                               "error": "bad json"}, None)
                        continue
                    if not isinstance(msg, dict):
                        reply({"ok": False,
                               "error": "not an object"}, None)
                        continue
                    rid = msg.get("id")
                    typ = msg.get("type")
                    t_verb = _time.monotonic()
                    try:
                        if typ == "op":
                            if stream is not None:
                                if self._session_apply(
                                        stream, msg.get("seq")):
                                    self.offer(stream,
                                               msg.get("op") or {})
                                if rid is not None or msg.get("ack"):
                                    reply({"ok": True,
                                           "acked": self._session_ack(
                                               stream)}, rid)
                        elif typ == "attach":
                            stream = self._attach_verb(msg, stream,
                                                       reply, rid)
                        elif typ == "poll":
                            w = self._worker(stream)
                            reply({"ok": True,
                                   "violation": bool(w and w.violation),
                                   "state": w.state if w else None},
                                  rid)
                        elif typ == "finish":
                            if stream is None:
                                reply({"ok": False,
                                       "error": "not attached"}, rid)
                                continue
                            if not self._session_journal_fed(stream):
                                # a journal-fed stream seals when its
                                # journal drains (watch loop), not on
                                # the client's say-so — sealing here
                                # would cut the verdict short
                                self.seal(stream)
                            w = self._worker(stream)
                            timeout = float(msg.get("timeout-s")
                                            or 600.0)
                            r = self.result(stream, timeout)
                            reply({"ok": True, "results": r,
                                   "state": w.state if w else None},
                                  rid)
                        elif typ == "status":
                            reply({"ok": True,
                                   "status": self.status()}, rid)
                        elif typ == "metrics":
                            # the whole registry (not just the
                            # service slice): one verb answers what
                            # /metrics answers over HTTP, for
                            # deployments without --metrics-port
                            reply({"ok": True,
                                   "metrics": _telemetry.snapshot(
                                       compact=bool(
                                           msg.get("compact")))}, rid)
                        elif typ == "close":
                            if stream is not None:
                                w = self._worker(stream)
                                if w is not None \
                                        and not w.done.is_set() \
                                        and not self._stream_tailed(
                                            stream):
                                    w.q.put(_CLOSE)
                            return
                        else:
                            reply({"ok": False,
                                   "error": f"unknown type {typ!r}"},
                                  rid)
                    except OSError:
                        raise   # the peer is gone; drop below
                    except Exception as e:  # noqa: BLE001 — a garbage
                        # frame (or a verb-handler bug) must kill
                        # neither this connection nor its thread;
                        # siblings on other sockets feel nothing
                        log.warning("service: verb %r failed",
                                    typ, exc_info=True)
                        reply({"ok": False,
                               "error": f"{type(e).__name__}: {e}"},
                              rid)
                    finally:
                        _M_VERB.labels(
                            verb=(typ if typ in _KNOWN_VERBS
                                  else "unknown")).observe(
                            _time.monotonic() - t_verb)
        except (OSError, ValueError):
            log.info("service: connection dropped%s",
                     f" (stream {stream})" if stream else "")

    def _attach_verb(self, msg: dict, stream: str | None,
                     reply, rid) -> str | None:
        """The attach verb: fresh admission, or — when the named
        worker already exists and the client presents a session token
        — a session re-attach (socket drop, service restart, or
        standby failover) that acks the high-water mark so the client
        replays only unacked ops."""
        name = str(msg.get("stream"))
        token = msg.get("session")
        w = self._worker(name)
        if token is not None and w is not None:
            journal_fed = self._stream_tailed(name)
            s = self._session_attach(name, str(token), journal_fed)
            if s is None:
                reply({"ok": False,
                       "error": "session token mismatch"}, rid)
                return stream
            _M_RECONNECTS.labels(side="server").inc()
            reply({"ok": True, "stream": name, "resumed": True,
                   "acked": self._session_ack(name),
                   "journal-fed": self._session_journal_fed(name),
                   "targets": w.target_names}, rid)
            return name
        if msg.get("resume") and w is None:
            # the stream's acked ops died with its worker and no
            # recovered worker took over (no journal on the store
            # side): re-admitting fresh would silently lose them
            reply({"ok": False, "deferred": True,
                   "error": "unknown session: stream not recovered"},
                  rid)
            return stream
        try:
            w = self.admit(name, msg.get("targets") or {},
                           store_dir=msg.get("store-dir"))
            if token is not None:
                self._session_attach(w.name, str(token), False)
            reply({"ok": True, "stream": w.name,
                   "targets": sorted(w.targets)}, rid)
            return w.name
        except (AdmissionRefused, ValueError) as e:
            reply({"ok": False, "deferred": True,
                   "error": str(e)}, rid)
            return stream


def _recv_lines(conn: _socket.socket):
    """Bounded line reader for the socket protocol: yields one decoded
    line per frame, or None for a frame that blew past MAX_LINE_BYTES
    (the rest of that line is discarded, the connection survives).
    Undecodable bytes are replaced, not fatal — the json parse then
    rejects the frame with an error reply instead of the decode
    exception killing the reader thread."""
    buf = bytearray()
    skipping = False
    while True:
        try:
            data = conn.recv(65536)
        except OSError:
            return
        if not data:
            return
        buf += data
        while True:
            nl = buf.find(b"\n")
            if nl < 0:
                break
            line, buf = buf[:nl], buf[nl + 1:]
            if skipping:        # tail of an oversized frame
                skipping = False
                continue
            if len(line) > MAX_LINE_BYTES:
                # the whole line arrived before the growth check below
                # could trip — still an oversized frame
                yield None
                continue
            yield line.decode("utf-8", errors="replace")
        if len(buf) > MAX_LINE_BYTES:
            buf.clear()
            if not skipping:    # complain once per oversized frame
                skipping = True
                yield None


def _is_unix_addr(addr: str) -> bool:
    return os.sep in addr and ":" not in addr


# ---------------------------------------------------------------------------
# the client (a run attaches through this)
# ---------------------------------------------------------------------------

POLL_INTERVAL_S = 0.2


class _ClientConn:
    """One live socket — the unit `reconnect.Wrapper` opens and
    closes; its reader thread exits when the socket does."""

    __slots__ = ("sock",)

    def __init__(self, sock: _socket.socket):
        self.sock = sock


class ServiceClient:
    """An `OnlineChecker`-shaped proxy that feeds a remote
    verification service instead of spawning in-process stream
    workers: same offer/should_abort/finalize/close surface, so the
    run's own code cannot tell the difference. device: the run's own
    device (None = CUDA, raising without a card).

    Session resilience: ops carry monotonic sequence numbers and stay
    buffered until the server acks its applied high-water mark; the
    socket lives inside a `reconnect.Wrapper`, so any disconnect
    transparently re-attaches — same session token, decorrelated-
    jitter backoff across the whole address list (`addr` may be
    comma-separated ``primary,standby``) — and replays only unacked
    ops. At-least-once delivery, exactly-once application: the
    server's session table drops replayed duplicates."""

    def __init__(self, addr: str, test: dict, spec: dict | None = None,
                 device=None):
        # the run's own device (None = CUDA, raising without a card):
        # its local checking runs there when the service refuses it
        resolve_device(device)
        self.addrs = [a.strip() for a in str(addr).split(",")
                      if a.strip()]
        self.addr = self.addrs[0] if self.addrs else str(addr)
        self.targets = spec if spec is not None else targets_spec(test)
        if not self.targets:
            raise ValueError("no streamable checker targets")
        self.abort_on_violation = bool(test.get("abort-on-violation"))
        self.aborted = False
        self.stream = "%s/%s" % (test.get("name", "run"),
                                 test.get("start-time", os.getpid()))
        self.session = os.urandom(8).hex()
        store_dir = (store.dir_name(test)
                     if test.get("name") and test.get("start-time")
                     else None)
        self._store_dir = (os.path.abspath(store_dir)
                           if store_dir else None)
        self._wlock = threading.Lock()
        self._rid = 0                       # guarded-by: _reply_evt
        self._replies: dict[int, dict] = {}  # guarded-by: _reply_evt
        self._reply_evt = threading.Condition()
        self._closed = False                # guarded-by: _reply_evt
        self._last_poll = 0.0
        # -- the replay buffer (the client half of the session
        # protocol). _seq is the offering thread's alone.
        self._seq = 0
        self._buf_lock = threading.Lock()
        self._unacked: deque = deque()      # guarded-by: _buf_lock
        self._acked = 0                     # guarded-by: _buf_lock
        # monotonic False->True flags, read lock-free on hot paths
        # (the offer-path noqa discipline): flipped under the
        # wrapper's write lock by the reopen handshake
        self._journal_fed = False
        self._attached = False
        self._dead = False
        self._active: str | None = None     # addr currently attached
        self.reconnects = 0
        self.failovers = 0
        self._wrap = _reconnect.Wrapper(
            self._open_conn, self._close_conn, log=log.info,
            name=f"verification service {self.addr}")
        self._wrap.open()   # first attach; raises on refusal
        log.info("attached to verification service %s as %r "
                 "(targets %s, session %s)", self._active,
                 self.stream, sorted(self.targets), self.session)

    # -- wire --------------------------------------------------------------

    def _open_conn(self) -> _ClientConn:
        """Open + attach one connection, cycling the address list
        under decorrelated-jitter backoff. Landing on a different
        address than last time is a client-side failover."""
        delays = None
        err: Exception | None = None
        for attempt in range(RECONNECT_TRIES):
            if attempt:
                if delays is None:
                    from .util import backoff
                    delays = backoff(0.05, 2.0)
                _time.sleep(next(delays))
            for a in self.addrs:
                try:
                    sock = _connect(a)
                except OSError as e:
                    err = e
                    continue
                try:
                    conn = self._handshake(sock, a)
                except AdmissionRefused:
                    # authoritative refusal: retrying cannot help
                    try:
                        sock.close()
                    except OSError:
                        pass
                    self._dead = True
                    raise
                except (OSError, ValueError) as e:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    err = e
                    continue
                if self._active is not None and a != self._active:
                    self.failovers += 1
                    _M_FAILOVERS.labels(role="client").inc()
                    log.warning("service client %r: failed over "
                                "%s -> %s", self.stream,
                                self._active, a)
                self._active = a
                return conn
        self._dead = True
        raise (err if err is not None else
               OSError(f"no verification service reachable "
                       f"at {self.addrs}"))

    def _handshake(self, sock: _socket.socket,
                   addr: str) -> _ClientConn:
        """Attach on a fresh socket: present the session token, learn
        the server's acked high-water mark, prune the replay buffer
        to it, and re-send whatever the dead connection lost."""
        resume = self._attached
        with self._reply_evt:
            self._rid += 1
            rid = self._rid
        req = {"type": "attach", "stream": self.stream,
               "targets": self.targets, "store-dir": self._store_dir,
               "session": self.session, "resume": resume, "id": rid}
        sock.settimeout(30.0)   # the handshake exchange only
        sock.sendall((json.dumps(req, default=store._json_default)
                      + "\n").encode())
        rf = sock.makefile("r", encoding="utf-8")
        r = None
        while not (isinstance(r, dict) and r.get("id") == rid):
            line = rf.readline()
            if not line:
                raise OSError("connection lost during attach")
            try:
                r = json.loads(line)
            except ValueError:
                r = None
        if not r.get("ok"):
            raise AdmissionRefused(r.get("error") or "attach failed")
        if r.get("journal-fed"):
            # a recovered (or promoted-standby) service tails this
            # run's journal directly: socket ops would double-apply,
            # so the socket feed stops here
            self._journal_fed = True
        acked = int(r.get("acked") or 0)
        with self._buf_lock:
            self._acked = max(self._acked, acked)
            while self._unacked \
                    and self._unacked[0][0] <= self._acked:
                self._unacked.popleft()
            if self._journal_fed:
                self._unacked.clear()
            replay = list(self._unacked)
        for seq, op in replay:
            sock.sendall((json.dumps(
                {"type": "op", "op": op, "seq": seq},
                default=store._json_default) + "\n").encode())
        sock.settimeout(None)
        self._attached = True
        if resume:
            self.reconnects += 1
            _M_RECONNECTS.labels(side="client").inc()
            log.info("service client %r: re-attached to %s "
                     "(acked %d, replayed %d unacked ops%s)",
                     self.stream, addr, acked, len(replay),
                     "; journal-fed" if self._journal_fed else "")
        threading.Thread(target=self._read_loop, args=(rf,),
                         name="jepsen-service-client",
                         daemon=True).start()
        return _ClientConn(sock)

    def _close_conn(self, conn: _ClientConn) -> None:
        try:
            conn.sock.close()   # the reader exits with the socket
        except OSError:
            pass

    def _send(self, msg: dict) -> None:
        data = (json.dumps(msg, default=store._json_default)
                + "\n").encode()

        def _do(conn: _ClientConn) -> None:
            with self._wlock:
                conn.sock.sendall(data)
        # with_conn reopens (re-attach + replay) on failure and
        # re-raises; the callers decide whether that loses anything
        self._wrap.with_conn(_do)

    def _request(self, msg: dict,
                 timeout_s: float = 30.0) -> dict | None:
        with self._reply_evt:
            self._rid += 1
            rid = self._rid
        msg["id"] = rid
        try:
            self._send(msg)
        except (OSError, ValueError):
            return None
        deadline = _time.monotonic() + timeout_s
        with self._reply_evt:
            while rid not in self._replies:
                wait = deadline - _time.monotonic()
                if wait <= 0 or self._closed:
                    return None
                self._reply_evt.wait(wait)
            return self._replies.pop(rid)

    def _note_acked(self, acked) -> None:
        try:
            acked = int(acked)
        except (TypeError, ValueError):
            return
        with self._buf_lock:
            if acked > self._acked:
                self._acked = acked
            while self._unacked \
                    and self._unacked[0][0] <= self._acked:
                self._unacked.popleft()

    def _read_loop(self, rf) -> None:
        try:
            for line in rf:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(msg, dict):
                    continue
                if "acked" in msg:
                    self._note_acked(msg.get("acked"))
                rid = msg.get("id")
                if rid is None:
                    continue
                try:
                    rid = int(rid)
                except (TypeError, ValueError):
                    continue
                with self._reply_evt:
                    self._replies[rid] = msg
                    self._reply_evt.notify_all()
        except (OSError, ValueError):
            pass
        # this socket died, but the wrapper may reopen it under a new
        # reader: wake waiters so requests notice promptly — only
        # _mark_closed flips _closed
        with self._reply_evt:
            self._reply_evt.notify_all()

    # -- OnlineChecker surface ---------------------------------------------

    def offer(self, op: dict) -> None:
        # lock-free reads by design: monotonic flags, and the op hot
        # path must not take the reply lock per op
        if self._closed or self._journal_fed:  # noqa: JTS201
            return
        self._seq += 1
        seq = self._seq
        with self._buf_lock:
            self._unacked.append((seq, op))
        msg = {"type": "op", "op": op, "seq": seq}
        if seq % ACK_EVERY == 0:
            msg["ack"] = True   # bound the replay buffer
        try:
            self._send(msg)
        except OSError:
            # the send failed, but with_conn already re-attached and
            # replayed the buffer — this op included, it was appended
            # before the send. Only a reopen that itself gave up
            # (dead) or was refused ends the session.
            if self._dead:  # noqa: JTS201
                log.warning("verification service connection lost "
                            "and not recoverable; offline checking "
                            "will cover this run")
                self._mark_closed()

    def should_abort(self) -> bool:
        if self.aborted:
            return True
        # monotonic-flag fast path (see offer)
        if not self.abort_on_violation or self._closed:  # noqa: JTS201
            return False
        now = _time.monotonic()
        if now - self._last_poll < POLL_INTERVAL_S:
            return False
        self._last_poll = now
        r = self._request({"type": "poll"}, timeout_s=5.0)
        if r and r.get("violation"):
            self.aborted = True
        return self.aborted

    def finalize(self, timeout_s: float | None = 600.0) -> dict:
        """Seal the stream and collect its verdicts — shaped exactly
        like OnlineChecker.finalize (deferred/drained streams return
        {}, so offline checking covers them)."""
        if self._closed:  # noqa: JTS201 — monotonic-flag fast path
            return {}
        if self._journal_fed:  # noqa: JTS201
            # the recovered service tails the journal and writes
            # streamed results into the run dir itself; analyze
            # reuses them — nothing to collect over this socket
            self._mark_closed()
            return {}
        r = self._request({"type": "finish",
                           "timeout-s": timeout_s},
                          timeout_s=(timeout_s or 600.0) + 30.0)
        if r is None and not self._dead \
                and not self._journal_fed:  # noqa: JTS201
            # the reply (or its socket) was lost mid-wait: finish is
            # idempotent under the session protocol, so ask once more
            # on the reopened connection
            r = self._request({"type": "finish",
                               "timeout-s": timeout_s},
                              timeout_s=(timeout_s or 600.0) + 30.0)
        self._mark_closed()
        if not (r and r.get("ok")):
            log.warning("verification service finish failed; offline "
                        "checking covers this run")
            return {}
        out = r.get("results") or {}
        state = r.get("state")
        if state in (SHED, DRAINED):
            log.warning("verification service %s this run's stream; "
                        "offline checking covers it",
                        "shed" if state == SHED else "drained")
            return {}
        if out.get("deferred"):
            return {}
        return out

    def close(self) -> None:
        try:
            self._send({"type": "close"})
        except OSError:
            pass
        self._mark_closed()

    def _mark_closed(self) -> None:
        with self._reply_evt:
            self._closed = True
            self._reply_evt.notify_all()
        try:
            self._wrap.close()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass


def _connect(addr: str) -> _socket.socket:
    if _is_unix_addr(addr):
        s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        s.connect(addr)
        return s
    host, _, port = addr.rpartition(":")
    s = _socket.create_connection((host or "127.0.0.1", int(port)),
                                  timeout=10.0)
    # the connect timeout must not linger: it would also deadline every
    # later recv, and a run can legitimately go >10s without traffic
    # (request timeouts are enforced at the _request layer instead)
    s.settimeout(None)
    return s


def maybe_attach(test: dict, device=None):
    """A ServiceClient for a test with a 'service' address, or None
    (no streamable targets / service unreachable / admission refused
    — the run then falls back to its local checking,
    `streaming.maybe_online(test)`, on its own card). Raises only for
    a missing card (`resolve_device`); otherwise never: the service is
    an optimization."""
    addr = test.get("service")
    if not addr:
        return None
    device = resolve_device(device)
    try:
        spec = targets_spec(test)
        if not spec:
            log.info("--service: no streamable checker targets; "
                     "running without the service")
            return None
        return ServiceClient(addr, test, spec, device=device)
    except AdmissionRefused as e:
        log.warning("verification service refused this run (%s); "
                    "falling back to local checking", e)
        return None
    except OSError as e:
        log.warning("verification service %s unreachable (%s); "
                    "falling back to local checking", addr, e)
        return None


# ---------------------------------------------------------------------------
# replica failover (the --standby mode)
# ---------------------------------------------------------------------------

class Standby:
    """A warm replica: watch a primary's health endpoint, and after
    ``failures`` consecutive failed probes fence the (presumed dead)
    primary via the store-level epoch file, `recover()` every
    orphaned stream from its durable checkpoints, and begin serving.
    The fence makes promotion safe against false positives: a merely
    partitioned primary notices the epoch moved past its own at its
    next durable write and stops touching the store (doc/robustness.md
    has the state machine)."""

    def __init__(self, svc: VerificationService, primary: str,
                 store_root: str, bind: str = "127.0.0.1:0",
                 poll_s: float = DEFAULT_STANDBY_POLL_S,
                 failures: int = DEFAULT_STANDBY_FAILURES,
                 spec_fn: Callable[[str], dict | None] | None = None):
        self.svc = svc
        self.primary = primary
        self.store_root = store_root
        self.bind = bind
        self.poll_s = float(poll_s)
        self.failures = int(failures)
        self.spec_fn = spec_fn
        self.promoted = threading.Event()
        self.bound: str | None = None
        self._stop = threading.Event()

    def healthy(self) -> bool:
        """One probe of the primary: its /healthz when given an
        http(s) URL, else the socket ``status`` verb."""
        try:
            if self.primary.startswith(("http://", "https://")):
                from urllib.request import urlopen
                with urlopen(self.primary.rstrip("/") + "/healthz",
                             timeout=5.0) as resp:
                    return 200 <= resp.status < 300
            sock = _connect(self.primary)
            try:
                sock.settimeout(5.0)
                sock.sendall(b'{"type": "poll", "id": 0}\n')
                return bool(sock.recv(1))
            finally:
                sock.close()
        except (OSError, ValueError):
            return False

    def run(self) -> str | None:
        """Block watching the primary; on sustained failure promote
        and return the bound serve address (None if stop()ped
        first)."""
        log.info("standby: watching primary %s (probe every %.1fs, "
                 "promote after %d failures)", self.primary,
                 self.poll_s, self.failures)
        failed = 0
        while not self._stop.is_set():
            failed = 0 if self.healthy() else failed + 1
            if failed >= self.failures:
                return self.promote()
            self._stop.wait(self.poll_s)
        return None

    def promote(self) -> str:
        """Fence the primary, recover its streams, start serving."""
        log.warning("standby: primary %s unhealthy for %d probes — "
                    "fencing and promoting", self.primary,
                    self.failures)
        recovered = self.svc.recover(self.store_root,
                                     spec_fn=self.spec_fn)
        # keep admitting fresh runs appearing under the store too
        self.svc.watch(self.store_root, spec_fn=self.spec_fn)
        self.bound = self.svc.serve(self.bind)
        _M_FAILOVERS.labels(role="standby").inc()
        log.warning("standby: promoted — serving on %s (%d streams "
                    "recovered, epoch %d)", self.bound,
                    len(recovered), self.svc.epoch)
        self.promoted.set()
        return self.bound

    def stop(self) -> None:
        self._stop.set()
