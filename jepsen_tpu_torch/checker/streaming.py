"""Online verification: check the history while the test runs.

The port's own copy of `jepsen_tpu/checker/streaming.py`. Offline, a
test pays run wall-clock *plus* analyze wall-clock. Here a feeding thread
consumes the run's history ops as they arrive, encodes them
incrementally into the same packed step stream the offline checker
builds, batches steps into power-of-two chunks, and advances a
device-resident WGL carry with the engines' `check_stream_chunk` entry,
which walks each chunk through the same step walk as the offline check:
K3 (`csrc/dense_walk.cu`) on a dense stream, K2 (`csrc/dedup.cu`) on a
sort stream's hash dedup.

  * **One liveness read per chunk, one chunk late.** The read after
    chunk k is the summary of the carry *before* chunk k, so a
    violation is reported at the same op as in the JAX package (whose
    read overlaps the device's work on chunk k). The port's step walk
    also reads the host per closure round and stage-B round (the eager
    walk; ROADMAP's K3 removes those).
  * **One staging buffer.** The JAX package alternates two host
    buffers under an asynchronous copy. Here each chunk is copied to
    the card synchronously (a pageable-memory copy that returns once
    the source is consumed), and the walk reads its host copy before
    the dispatch returns, so one buffer, rewritten per chunk, is never
    in use by a copy.
  * **Prefix semantics.** An op's encoding is final only once its
    completion lands (an :ok read's authoritative value arrives with
    the completion; a :fail pair is dropped entirely), so the encoder
    emits events exactly up to the earliest still-open invocation.
  * **Early abort.** A dead frontier with no overflow is a *definite*
    nonlinearizable prefix; the stream raises a violation flag mid-run
    and, behind the test's 'abort-on-violation' flag, the run can stop
    issuing ops.

Verdict parity: the encoder's emitted stream is byte-identical to
`build_steps(encode_ops(h), p)` over the completed history (same slot
heap, same merge rule, same droppable elision), and escalation and blame
replay reuse the offline machinery, so the online verdict equals the
offline verdict on the same history, and the stream's final carry equals
the offline walk's on the same engine.

A stream runs on the card unless built with ``device="cpu"`` (the plain
PyTorch path), and never moves to the CPU on its own. Its recovery
ladder is the offline one (`wgl._RecoveryTrail`) with the JAX package's
stream rungs, and the port's two differences apply: a kernel that does
not build re-raises (no rung), and a stream whose budget is spent
declines its verdict, leaving the offline check, whose own ladder ends
on a degraded 'unknown', never on the host. Checkpoints are exported in
the JAX package's carry layout (`carry.py`), so a stream either package
checkpointed resumes in the other.

The Elle side streams too: `WrStream` accumulates the rw-register
ww/wr/rw dependency edges (and the single-pass G1a/G1b/internal/
duplicate cases) incrementally as completions arrive, resolving
late-arriving references through pending indexes; only the final SCC
condensation and the classifier (`elle.kernels`, on the card) run at the
end.
"""

from __future__ import annotations

import contextlib
import heapq
import logging
import queue as _queue
import threading
import time as _time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from .. import parallel
from .. import telemetry as _telemetry
from .. import trace as _trace
from .._platform import (FAULT_DEVICE_LOST, FAULT_OOM, attest_enabled,
                         maybe_corrupt, maybe_inject_fault, pin_device,
                         probe as _probe)
from ..carry import carry_from_numpy, carry_to_numpy
from ..history import (KIND_INFO, KIND_OK, NIL, PENDING_RET,
                       DeviceEncodingError, History, OpArray,
                       history as as_history)
from . import UNKNOWN
from . import abft
from . import wgl as _wgl

log = logging.getLogger(__name__)

DEFAULT_CHUNK_ENTRIES = 1024
# Carry-checkpoint cadence: every K chunks the device carry round-trips
# to host memory (one extra blocking sync per K chunks), so recovery
# from a device fault replays at most K chunks instead of the whole
# stream. 0 disables checkpointing (recovery then replays from chunk 0
# — still correct, just cold).
DEFAULT_CHECKPOINT_EVERY = 8

# row resolution states (kind uses history.KIND_* once resolved)
_UNRESOLVED = -1
_DROPPED = -2

# -- telemetry (the JAX package's metric names and labels) -------------------
_M_CHUNKS = _telemetry.counter(
    "jepsen_tpu_streaming_chunks_total",
    "Stream chunks dispatched to the device", ("family",))
_M_LAG = _telemetry.histogram(
    "jepsen_tpu_streaming_lag_rows",
    "Encoded step rows still awaiting dispatch (the stream's lag "
    "behind the journal tail), observed per chunk",
    buckets=(16, 64, 256, 1024, 4096, 16384, 65536, 262144))
_M_CKPT_S = _telemetry.histogram(
    "jepsen_tpu_streaming_checkpoint_seconds",
    "Carry-checkpoint fetch + verify latency")
_M_CKPTS = _telemetry.counter(
    "jepsen_tpu_streaming_checkpoints_total",
    "Carry checkpoints stored")
_M_REBUILDS = _telemetry.counter(
    "jepsen_tpu_streaming_rebuilds_total",
    "Stream kernel rebuilds by cause", ("reason",))
_M_VIOLATIONS = _telemetry.counter(
    "jepsen_tpu_streaming_violations_total",
    "Definite violations confirmed mid-stream")


class _Row:
    """One logical operation (invoke paired with its completion)."""

    __slots__ = ("f", "a", "b", "kind", "inv_pos", "ret_pos", "slot",
                 "inv_op")

    def __init__(self, inv_pos: int, inv_op: dict):
        self.kind = _UNRESOLVED
        self.f = self.a = self.b = 0
        self.inv_pos = inv_pos
        self.ret_pos = int(PENDING_RET)
        self.slot = -1
        self.inv_op = inv_op


class StreamEncoder:
    """Incremental `encode_ops` + `build_steps(merge=True)`.

    Feed journal ops in arrival order; the encoder emits packed merged
    step rows for the prefix whose encoding is final. Once the history
    is complete and finish() has run, the emitted stream is
    byte-identical to ``build_steps(encode_ops(h, codec, droppable),
    p).x`` — same slot min-heap, same ok-run merging, same droppable
    pending elision — which is what makes online and offline verdicts
    interchangeable.

    Events can only be emitted in history-position order, and an
    invocation's event is unknown until its completion arrives (the
    completion carries the authoritative value; a :fail drops the
    pair), so the emit cursor trails the earliest open invocation —
    the structural lag of any online linearizability checker.
    """

    def __init__(self, codec: Callable, droppable: frozenset, p: int):
        self.p = p
        self.w = max(1, (p + 31) // 32)
        self.codec = codec
        self.droppable = droppable
        self.rows: list[_Row] = []
        self.n_client_ops = 0
        self.finished = False
        self._free = list(range(p))
        heapq.heapify(self._free)
        self._open: dict[Any, int] = {}      # process -> row id
        self._events: list = []              # per client-op position
        self._cursor = 0
        self._pend = [0] * self.w
        self._out: list[list[int]] = []      # emitted, unconsumed steps
        self.steps_emitted = 0

    # -- feeding ----------------------------------------------------------

    def feed(self, op: dict) -> None:
        """Accept the next journal op (client ops only; the caller
        filters). Raises DeviceEncodingError if the op exceeds the
        device encoding and SlotOverflow when concurrency + crashed
        ops exceed p (the caller rebuilds with a larger p)."""
        assert not self.finished, "feed() after finish()"
        pos = self.n_client_ops
        self.n_client_ops += 1
        t = op.get("type")
        if t == "invoke":
            r = len(self.rows)
            self.rows.append(_Row(pos, op))
            self._open[op["process"]] = r
            self._events.append(("inv", r))
        else:
            r = self._open.pop(op["process"], None)
            if r is None:
                # completion with no journaled invocation: encode_ops
                # iterates invokes, so it contributes nothing
                self._events.append(None)
            elif t == "fail":
                self.rows[r].kind = _DROPPED
                self._events.append(None)
            elif t == "ok":
                row = self.rows[r]
                row.f, row.a, row.b = self.codec(op)
                row.kind = KIND_OK
                row.ret_pos = pos
                self._events.append(("ret", r))
            else:  # info: pending forever (encoding is final now)
                self._resolve_info(self.rows[r])
                self._events.append(None)
        self._advance()

    def _resolve_info(self, row: _Row) -> None:
        f, a, b = self.codec(row.inv_op)
        if f in self.droppable:
            row.kind = _DROPPED
        else:
            row.f, row.a, row.b = f, a, b
            row.kind = KIND_INFO

    def finish(self) -> None:
        """Resolve every still-open invocation as pending-forever (the
        crash-salvage tail encode_ops would produce) and flush the
        trailing completion run."""
        if self.finished:
            return
        for r in self._open.values():
            if self.rows[r].kind == _UNRESOLVED:
                self._resolve_info(self.rows[r])
        self._open.clear()
        self._advance()
        assert self._cursor == len(self._events)
        if any(self._pend):
            self._flush(-1, 0, NIL, NIL)
        self.finished = True

    # -- emission ---------------------------------------------------------

    def _flush(self, inv_slot: int, f: int, a: int, b: int) -> None:
        # mask words carry bit 31 when slot 31/63/... is pending —
        # reinterpret as int32 (build_steps does this with a uint32
        # view) so the packed row fits the kernels' int32 matrix
        words = [w - (1 << 32) if w >= (1 << 31) else w
                 for w in self._pend]
        self._out.append(words + [inv_slot, f, a, b])
        self.steps_emitted += 1
        self._pend = [0] * self.w

    def _advance(self) -> None:
        events = self._events
        while self._cursor < len(events):
            ev = events[self._cursor]
            if ev is None:
                self._cursor += 1
                continue
            kind, r = ev
            row = self.rows[r]
            if kind == "inv":
                if row.kind == _UNRESOLVED:
                    return        # the stable prefix ends here
                if row.kind == _DROPPED:
                    self._cursor += 1
                    continue
                if not self._free:
                    raise _wgl.SlotOverflow(
                        f"more than {self.p} pending ops in the live "
                        f"stream (crashed ops hold slots forever)")
                s = heapq.heappop(self._free)
                row.slot = s
                self._flush(s, row.f, row.a, row.b)
            else:  # ret — only emitted for OK rows
                s = row.slot
                heapq.heappush(self._free, s)
                self._pend[s // 32] |= 1 << (s % 32)
            self._cursor += 1

    def take(self, n: int) -> list[list[int]]:
        """Pop up to n emitted step rows."""
        rows, self._out = self._out[:n], self._out[n:]
        return rows

    def available(self) -> int:
        return len(self._out)

    def op_array(self) -> OpArray:
        """The resolved rows as an OpArray — the bridge back to the
        offline machinery (escalation replay, unmerged blame runs,
        model validators)."""
        rows = [r for r in self.rows if r.kind in (KIND_OK, KIND_INFO)]
        cols: list[list[int]] = [[] for _ in range(8)]
        for r in rows:
            cols[0].append(r.f)
            cols[1].append(r.a)
            cols[2].append(r.b)
            cols[3].append(r.kind)
            cols[4].append(r.inv_pos)
            cols[5].append(r.ret_pos if r.kind == KIND_OK
                           else int(PENDING_RET))
            cols[6].append(int(r.inv_op.get("process", -1)))
            cols[7].append(int(r.inv_op.get("index", r.inv_pos)))
        return OpArray(*(np.asarray(c, np.int32) for c in cols))


class WglStream:
    """The online WGL pipeline for one linearizability target.

    feed(op) with every history op (any thread discipline where feeds
    are serialized — the OnlineChecker's feeding thread in practice);
    finish() returns an analysis dict shaped like `wgl.analysis_gpu`'s
    (plus 'tail-latency-ms', 'chunks', 'streamed').

    engine: 'sort' (default — works with no a-priori knowledge) or
    'dense' (exact, no frontier, but needs `state_range` declared up
    front so the reachable-set table can be allocated before the first
    op arrives); 'auto' is dense when a state range is declared. A
    declared state_range also lets the SORT family pack configs into
    one-word keys up front, which is what makes the hash dedup (K2)
    available online; without it the sort stream keeps the
    lexicographic dedup. Values escaping a declared range trigger a
    transparent rebuild: dense -> sort, packed sort -> unpacked sort.

    device: where the stream runs (None = CUDA, raising without it;
    'cpu' = the plain PyTorch path). It is pinned at construction, so a
    feeding thread uses the card the constructing thread named.

    Fault tolerance: the carry round-trips to host memory every
    `checkpoint_every` chunks, so a classified device fault mid-stream
    (OOM, a lost device, a wedged sync, a corrupt staging) recovers by
    rebuilding the engine, restoring the last checkpoint and replaying
    at most `checkpoint_every` chunks from the dispatched-steps log. The
    OOM rung also re-selects a dense stream onto the sort family (the
    table is the memory hog) and halves a sort stream's chunk. A kernel
    that does not build re-raises (the port's ladder has no compile
    rung). A recovered stream reports its trail under 'recovered'.
    """

    def __init__(self, model, *, slots: int | None = None,
                 frontier: int = 256, max_frontier: int = 65536,
                 chunk_entries: int = DEFAULT_CHUNK_ENTRIES,
                 engine: str = "sort",
                 state_range: tuple[int, int] | None = None,
                 concurrency_hint: int | None = None,
                 checkpoint_every: int = DEFAULT_CHECKPOINT_EVERY,
                 max_recovery_retries: int | None = None,
                 auto_pump: bool = True,
                 fault_site: str = "stream-chunk",
                 device=None):
        name = model.device_model
        if name is None or name not in _wgl.DEVICE_MODELS:
            raise ValueError(f"model {model!r} has no device form")
        self.device = pin_device(device)
        self.model = model
        self.name = name
        self.dm = _wgl.DEVICE_MODELS[name]
        # auto_pump=False turns feed() into encode-only: a scheduler
        # calls pump() to dispatch chunks under its own budget.
        # fault_site names this stream's fault-injection/attestation site
        self.auto_pump = bool(auto_pump)
        self.fault_site = fault_site
        # entered around host-only work inside a device walk (the
        # ladder's backoff sleep, the blame's host explanation): a
        # scheduler that grants one walk at a time lends it out there
        self.host_work: Callable[[], Any] = contextlib.nullcontext
        self.chunk = _wgl._bucket(max(int(chunk_entries), 1), lo=64)
        self.frontier = frontier
        self.max_frontier = max_frontier
        if engine not in ("sort", "dense", "auto"):
            raise ValueError(f"unknown streaming engine {engine!r}")
        self.state_range = state_range
        self.engine = self._pick_engine(engine, state_range)
        p0 = slots or _wgl._bucket(
            max(int(concurrency_hint or 0) + 4, 8), lo=8)
        self.p = p0
        # a declared state range lets the sort family pack configs up
        # front (the offline path derives this from the whole history;
        # online it must be promised) — range escapes drop it below
        self._pack = (_wgl._pack_params(state_range, p0)
                      if state_range is not None else None)
        if self.engine == "dense":
            # validate at construction: a forced 'dense' raises, 'auto'
            # downgrades to the sort engine, which needs no table
            try:
                self._dense_shape()
            except ValueError:
                if engine == "dense":
                    raise
                log.info("online WGL stream: dense table exceeds caps "
                         "at %d slots; using the sort engine", p0)
                self.engine = "sort"
        self.encoder = StreamEncoder(self.dm.codec, self.dm.droppable, p0)
        self._client_ops: list[dict] = []   # raw feed, for rebuild/blame
        self._t_first: float | None = None
        self._failed: Exception | None = None
        self.violation = False              # definite dead frontier
        self.violation_at_op: int | None = None  # ops fed at detection
        self._dead = False                  # frontier known dead
        self._dead_overflow = False         # ... but under overflow
        self._k = None
        self._kernels: list = []            # every engine built (counts)
        self._carry = None
        self._chunks = 0
        self._buf: np.ndarray | None = None
        self._pad_row: np.ndarray | None = None
        self._steps_log: list[np.ndarray] = []   # dispatched step slices
        self.checkpoint_every = max(0, int(checkpoint_every))
        self._trail = _wgl._RecoveryTrail(max_recovery_retries)
        # (rows consumed, chunks dispatched, host carry in the JAX layout)
        self._ckpt: tuple[int, int, tuple] | None = None
        # bumped whenever the recovery target changes (a checkpoint
        # lands, or a rebuild invalidates it)
        self.checkpoint_seq = 0
        # an imported checkpoint waiting to seed the carry at the next
        # engine build — see import_checkpoint()
        self._restore_ckpt_pending = False
        self._rows_fed = 0        # step rows appended to the log
        self._rows_done = 0       # step rows the device has consumed
        self._resumed_from_chunk: int | None = None
        self._last_fault: BaseException | None = None
        # ABFT attestation (JEPSEN_TPU_ATTEST, default on): each staged
        # chunk's device digest is held here and verified against the
        # host digest at the NEXT chunk boundary (the lagged liveness
        # read, a checkpoint, finish); carry digests verify at
        # checkpoints
        self._attest = attest_enabled()
        self._att_pending: list[tuple] = []   # (device digest, expected)
        self._att_steps = 0
        self._att_carry = 0
        # attestation tallies as of the last checkpoint, exported with
        # it so a resumed stream reports an uninterrupted run's totals
        self._ckpt_att = (0, 0)
        # one trace id threads stream -> chunk -> recovery-retry; the
        # stream span parents to the caller's span when one is open
        tr = _trace.tracer()
        self._span_stream = None
        self._trace_ctx = None
        if tr.enabled:
            parent = tr.context()
            if not parent.get("trace-id"):
                parent = tr.new_context()
            self._span_stream = tr.start_span("wgl.stream",
                                              parent=parent)
            self._span_stream.tags["model"] = str(self.name)
            self._span_stream.tags["engine"] = str(self.engine)
            self._trace_ctx = self._span_stream.context()

    def end_trace(self, valid=None) -> None:
        """Record the stream's root span (idempotent). Every terminal
        path lands here, so exported chunk spans never point at a
        parent the collector never receives."""
        sp, self._span_stream = self._span_stream, None
        if sp is not None:
            if valid is not None:
                sp.tags["valid"] = str(valid)
            _trace.tracer().finish_span(sp)

    @property
    def faults(self) -> list:
        return self._trail.faults

    def carry_host(self) -> tuple | None:
        """The stream's current carry on the host, in the JAX package's
        layout (`carry.carry_to_numpy`); None before the first chunk."""
        if self._carry is None:
            return None
        return carry_to_numpy(self._carry)

    # -- engine management ---------------------------------------------------

    def _pick_engine(self, engine: str, srange) -> str:
        if engine == "dense" or (engine == "auto" and srange is not None):
            if srange is None:
                raise ValueError(
                    "streaming dense engine needs an up-front "
                    "state_range (the table is allocated before the "
                    "first op arrives)")
            return "dense"
        return "sort"

    def _dense_shape(self):
        lo, hi = self.state_range
        S = _wgl._bucket(hi - lo + 1, lo=4)
        if S > _wgl.DENSE_STATE_CAP or \
                S * (1 << self.p) > _wgl.DENSE_TABLE_CAP:
            raise ValueError(
                f"dense streaming table ({S} states x 2^{self.p} "
                f"slots) exceeds the dense caps")
        return lo, S, self.p

    def _sort_kernel(self, F: int) -> _wgl.SortKernel:
        return _wgl.SortKernel(self.name, F, self.p, self._pack,
                               _wgl.dedup_engine(F, self.p, self._pack),
                               self.device)

    def _new_kernel(self):
        if self.engine == "dense":
            lo, S, P = self._dense_shape()
            k = _wgl.DenseKernel(self.name, lo, S, P, self.device)
        else:
            k = self._sort_kernel(self.frontier)
        self._kernels.append(k)
        return k

    def _stage(self, buf: np.ndarray) -> _wgl.Staged:
        """One chunk buffer to the card: a synchronous copy of what
        `maybe_corrupt` hands back (the buffer itself unless a bitflip
        was injected), with its device digest queued for the lagged
        check against the canonical buffer's host digest."""
        xs = _wgl.stage_steps(maybe_corrupt(self.fault_site, buf),
                              self.device)
        if self._attest:
            self._att_pending.append(
                (abft.digest_device(xs.dev), abft.digest_host(buf)))
        return xs

    def _setup(self) -> None:
        """Build the engine and the staging buffer, and walk a
        zero-length chunk: it consumes nothing and leaves the carry as
        it was."""
        t_build = _time.monotonic()
        self._k = self._new_kernel()
        _wgl._M_COMPILE.labels(family=self.engine, stage="build").observe(
            _time.monotonic() - t_build)
        w = self.encoder.w
        pad = np.zeros((self.chunk, w + 4), np.int32)
        pad[:, w] = -1
        pad[:, w + 2:] = NIL
        self._pad_row = pad[0].copy()
        self._buf = pad.copy()
        self._carry = self._k.init_carry(int(self.model.device_state()))
        t0 = _time.monotonic()
        self._carry = self._k.check_stream_chunk(
            _wgl.stage_steps(self._buf, self.device), 0, self._carry)
        _wgl._M_COMPILE.labels(family=self.engine, stage="warmup").observe(
            _time.monotonic() - t0)
        if self._restore_ckpt_pending and self._ckpt is not None:
            # an imported checkpoint: seed the carry from it so the
            # refed prefix (skipped row for row by _dispatch_once)
            # resumes instead of recomputing
            self._carry = carry_from_numpy(self._ckpt[2], self.device)
            self._restore_ckpt_pending = False

    def _summary(self, carry, extra=(), site: str = "stream summarize",
                 k=None):
        """(ok, death, overflow, max_count, att) of a carry of engine `k`
        (the stream's own by default), and the values of `extra` (0-d
        int32 tensors), in ONE host read."""
        k = k if k is not None else self._k
        vals = k.fetch(torch.stack(list(k._summary_row(carry))
                                   + list(extra)), site=site)
        e, count, maxc, att, ovf = vals[:5]
        ok = count > 0
        return (ok, -1 if ok else e - 1, bool(ovf), maxc, att), vals[5:]

    # -- fault tolerance -----------------------------------------------------

    def _absorb_fault(self, exc: BaseException, site: str) -> bool:
        """Classify and record a device fault; True when another retry
        is allowed (after the backoff sleep), False when the budget is
        spent. Exceptions the classifier rejects (ordinary bugs) and
        compile faults are re-raised by the trail."""
        self._last_fault = exc
        more = self._trail.absorb(exc, f"online WGL stream {site}")
        _probe("fault", site=self.fault_site,
               kind=(self.faults[-1] if self.faults else None),
               retry=len(self.faults), at=site)
        return more

    def _apply_stream_rung(self, kind: str) -> None:
        """Change the stream's knobs per the fault bucket before the
        retry. Every rung drops the engine so the retry rebuilds it."""
        if kind == FAULT_OOM:
            if self.engine == "dense":
                # the dense table is the memory hog: re-select onto the
                # sort family. A dense checkpoint cannot seed a sort
                # carry, so recovery replays the whole log
                log.warning("online WGL stream: OOM on the dense "
                            "engine; re-selecting onto the sort family")
                self.engine = "sort"
                self._ckpt = None
            else:
                self.chunk = _wgl._bucket(max(self.chunk // 2, 64),
                                          lo=64)
                log.warning("online WGL stream: OOM backpressure; "
                            "chunk_entries now %d", self.chunk)
        elif kind == FAULT_DEVICE_LOST:
            _wgl._device_reinit()
        self._k = None

    def _restore_and_replay(self) -> None:
        """Rebuild the engine, restore the last carry checkpoint, and
        replay the dispatched-steps log from its row index. The encoder
        and steps log are host-side and untouched, so the replayed
        stream is byte-identical to the uninterrupted one."""
        self._k = None
        self._setup()
        # digests queued by the failed attempt belong to dead dispatches;
        # the replay below re-stages (and re-attests) every slice
        self._att_pending = []
        if self._ckpt is not None:
            rows0, chunks0, host = self._ckpt
            self._carry = carry_from_numpy(host, self.device)
        else:
            rows0, chunks0 = 0, 0
        self._resumed_from_chunk = chunks0
        self._rows_done = rows0
        _probe("replay-begin", site=self.fault_site, from_chunk=chunks0)
        # rewind the chunk counter too: the replay re-increments it per
        # slice, so it lands back at the live chunk count
        self._chunks = chunks0
        # collect only the rows past the checkpoint, from the end of the
        # log, so recovery costs O(replay), not O(stream)
        need = sum(len(a) for a in self._steps_log) - rows0
        parts: list[np.ndarray] = []
        got = 0
        for a in reversed(self._steps_log):
            if got >= need:
                break
            parts.append(a)
            got += len(a)
        parts.reverse()
        tail = (np.concatenate(parts)[-need:] if need > 0
                else np.zeros((0, self.encoder.w + 4), np.int32))
        for e in range(0, len(tail), self.chunk):
            sl = tail[e:e + self.chunk]
            maybe_inject_fault(self.fault_site)
            buf = np.repeat(self._pad_row[None], self.chunk, axis=0)
            buf[:len(sl)] = sl
            self._carry = self._k.check_stream_chunk(
                self._stage(buf), len(sl), self._carry)
            self._chunks += 1
            self._rows_done += len(sl)
            self._maybe_checkpoint()
        if self._attest:
            self._drain_attest()
        if not self._dead:
            self._check_death(self._carry)
        _probe("replay-end", site=self.fault_site, replayed=len(tail))
        log.info("online WGL stream resumed from chunk %d "
                 "(replayed %d step rows)", chunks0, len(tail))

    def _maybe_checkpoint(self) -> None:
        """Round-trip the carry to host memory every checkpoint_every
        chunks. The blocking fetch also forces completion of every chunk
        queued so far, so a stored checkpoint is known good."""
        if not self.checkpoint_every \
                or self._chunks % self.checkpoint_every:
            return
        self._checkpoint()

    def _checkpoint(self) -> None:
        """Fetch the carry to host memory now and store it as the
        recovery target. Success-only metrics: a failed attempt records
        neither series."""
        t0 = _time.monotonic()
        self._checkpoint_inner()
        _M_CKPT_S.observe(_time.monotonic() - t0)
        _M_CKPTS.inc()

    def _checkpoint_inner(self) -> None:
        k = self._k
        if self._attest:
            # a checkpoint must be KNOWN GOOD before it becomes the
            # recovery target: verify every staged chunk that fed it,
            # then fetch the carry and its device digest and cross-check
            # on the host; corruption found here falls back to the
            # previous checkpoint
            self._drain_attest()
            hd = k.fetch(k.digest(self._carry), site="stream checkpoint")
            host = k.fetch_carry(self._carry, site="stream checkpoint")
            abft.verify_carry(self.fault_site, hd, host)
            self._att_carry += 1
        else:
            host = k.fetch_carry(self._carry, site="stream checkpoint")
        self._ckpt = (self._rows_done, self._chunks, host)
        self._ckpt_att = (self._att_steps, self._att_carry)
        self.checkpoint_seq += 1

    def _recovering(self, fn: Callable[[], Any], site: str,
                    restore: bool = True):
        """Run a device-side closure under the recovery ladder: a
        classified device fault applies its rung, restores the last
        checkpoint, replays the steps log, and retries fn. Returns fn()'s
        value, or None when the retry budget is spent (the caller takes
        its final rung: _dispatch disables the stream, finish declines
        its verdict, blame keeps the verdict without a culprit).

        restore=False skips the restore and replay between retries, for
        closures that build their own engine and carry (escalation,
        blame)."""
        replay = False
        while True:
            try:
                if replay:
                    with _trace.tracer().span(
                            "wgl.stream.recovery-retry",
                            parent=self._trace_ctx) as sp:
                        if sp is not None and self.faults:
                            sp.tags["fault"] = str(self.faults[-1])
                        self._restore_and_replay()
                    replay = False
                return fn()
            except RuntimeError as e:
                with self.host_work():
                    more = self._absorb_fault(e, site)
                if not more:
                    return None
                self._apply_stream_rung(self.faults[-1])
                replay = restore

    # -- feeding -------------------------------------------------------------

    def feed(self, op: dict) -> None:
        if self._failed is not None:
            return
        if not isinstance(op.get("process"), int):
            return
        self._client_ops.append(op)
        if self._t_first is None:
            self._t_first = _time.monotonic()
        try:
            self.encoder.feed(op)
        except _wgl.SlotOverflow:
            self._rebuild(p=self.p * 2)
            return
        except DeviceEncodingError as e:
            # the history exceeds the device encoding altogether: the
            # offline checker covers it
            self._failed = e
            log.warning("online WGL stream disabled (%s); the offline "
                        "checker will run instead", e)
            return
        if self.auto_pump:
            self._pump()

    def _rebuild(self, p: int, reason: str = "slot-overflow") -> None:
        """Re-encode the full feed with new parameters and replay the
        device search from scratch (slot overflow beyond the initial
        estimate, a dense range escape)."""
        _M_REBUILDS.labels(reason=reason).inc()
        p = _wgl._bucket(p, lo=8)
        if p > 256:
            self._failed = _wgl.SlotOverflow(
                "online stream needs more than 256 slots")
            log.warning("online WGL stream disabled (%s)", self._failed)
            return
        if self.engine == "dense":
            # a grown slot count can push the dense table past its caps:
            # downgrade to the sort engine rather than raise
            try:
                old_p, self.p = self.p, p
                self._dense_shape()
                self.p = old_p
            except ValueError as e:
                self.p = old_p
                log.warning("online WGL stream: %s; rebuilding onto "
                            "the sort kernel", e)
                self.engine = "sort"
        log.info("online WGL stream rebuilding: slots %d -> %d "
                 "(engine %s)", self.p, p, self.engine)
        self.p = p
        if self._pack is not None:
            # the packed key budget shrinks as slots grow: recompute,
            # dropping to the multi-word dedup when it no longer fits
            self._pack = _wgl._pack_params(self.state_range, p)
        self.encoder = StreamEncoder(self.dm.codec, self.dm.droppable, p)
        self._k = None
        self._steps_log = []
        self._att_pending = []
        self._chunks = 0
        # the old checkpoint no longer matches the engine
        self._ckpt = None
        self.checkpoint_seq += 1
        self._restore_ckpt_pending = False
        self._rows_fed = self._rows_done = 0
        self._dead = self._dead_overflow = False
        self.violation = False
        self.violation_at_op = None
        ops, self._client_ops = self._client_ops, []
        for op in ops:
            self.feed(op)

    def _pump(self, partial: bool = False,
              limit: int | None = None) -> int:
        """Dispatch full chunks (and, when partial=True, the tail).
        limit caps the chunks dispatched this call. Returns chunks
        dispatched."""
        done = 0
        while limit is None or done < limit:
            if self._failed is not None:
                return done
            avail = self.encoder.available()
            if avail == 0 or (avail < self.chunk and not partial):
                return done
            rows = self.encoder.take(self.chunk)
            arr = np.asarray(rows, np.int32)
            if (self.engine == "dense" or self._pack is not None) \
                    and self._range_escape(arr):
                # a value escaped the declared state range: the dense
                # table would drop legal linearizations (an unsound
                # 'invalid'), and a packed key would wrap into a
                # neighbouring config — downgrade and replay
                log.warning("online WGL stream: value outside the "
                            "declared state range; rebuilding onto "
                            "the unpacked sort kernel")
                self.engine = "sort"
                self._pack = None
                self._rebuild(p=self.p, reason="range-escape")
                return done
            self._dispatch(arr)
            done += 1
        return done

    def _range_escape(self, arr: np.ndarray) -> bool:
        w = self.encoder.w
        lo, hi = self.state_range
        vals = arr[:, w + 2:]
        return bool(((vals != NIL) & ((vals < lo) | (vals > hi))).any())

    # -- external pumping ----------------------------------------------------

    @property
    def chunks(self) -> int:
        """Chunks dispatched so far."""
        return self._chunks

    def pending_chunks(self) -> int:
        """Full chunks encoded and waiting for dispatch."""
        if self._failed is not None:
            return 0
        return self.encoder.available() // self.chunk

    def kernel_key(self):
        """Identity of the stream's engine shape (family, model, slots,
        chunk, frontier, packing, device), or None before setup. The
        service's calibration feed uses it to tell which ONE stream per
        shape ran it first in this process: that stream's first chunk
        paid the library load, the CUDA context and the allocator's
        warm-up (the JAX package's paid the jit compile), so only its
        sample is left out of the fit."""
        if self._k is None:
            return None
        return (self.engine, self.name, self.p, self.chunk, self.frontier,
                self._pack is not None, str(self.device))

    def pump(self, max_chunks: int | None = None) -> int:
        """Dispatch up to max_chunks full chunks (None = all): the
        external-pump entry for a verification service (with
        auto_pump=False, feed() only encodes)."""
        return self._pump(limit=max_chunks)

    def checkpoint_now(self) -> bool:
        """Force a carry checkpoint regardless of cadence. True when a
        checkpoint was stored (False when nothing was dispatched, the
        stream failed, or the recovery budget died trying)."""
        if self._failed is not None or self._k is None:
            return False
        ok = self._recovering(
            lambda: self._checkpoint() or True, "checkpoint") is not None
        if ok and self._attest:
            # the forced checkpoint's own carry verification is not part
            # of the stream's verdict: exclude it from the exported
            # tallies so a resumed stream reports an uninterrupted run's
            self._ckpt_att = (self._ckpt_att[0], self._ckpt_att[1] - 1)
        return ok

    def export_checkpoint(self) -> dict | None:
        """The last carry checkpoint plus the engine-shape parameters
        needed to rebuild an equivalent stream in another process, in
        the JAX package's layout and dtypes: the JAX package's
        `WglStream.import_checkpoint` takes it as it is. 'pallas' is
        True because the port's routes are the JAX package's with its
        Pallas kernels on (the hash dedup where the shape admits it);
        a JAX stream that resumes it must be built with pallas=True to
        walk the same route. None when no checkpoint exists."""
        if self._ckpt is None:
            return None
        rows, chunks, host = self._ckpt
        return {
            "rows": int(rows),
            "chunks": int(chunks),
            "carry": [np.asarray(a) for a in host],
            "engine": self.engine,
            "p": int(self.p),
            "chunk": int(self.chunk),
            "frontier": int(self.frontier),
            "pallas": True,
            "packed": self._pack is not None,
            "att-steps": int(self._ckpt_att[0]),
            "att-carry": int(self._ckpt_att[1]),
            "state-range": (list(self.state_range)
                            if self.state_range is not None else None),
        }

    def import_checkpoint(self, ck: dict) -> bool:
        """Seed a FRESH stream from an exported checkpoint (this
        package's or the JAX package's): the caller re-feeds the history
        from the beginning, the encoder re-emits the byte-identical step
        stream, and dispatch skips row for row up to the checkpoint
        (restoring its carry at the first engine build), so the resumed
        verdict is an uninterrupted run's. Returns False (the stream
        stays cold) when the checkpoint's shape does not match."""
        if self.encoder.n_client_ops or self._chunks or self._steps_log:
            raise ValueError("import_checkpoint on a stream that "
                             "already consumed ops")
        if (ck.get("engine") != self.engine or int(ck["p"]) != self.p
                or int(ck["chunk"]) != self.chunk
                or int(ck["frontier"]) != self.frontier
                or bool(ck.get("packed")) != (self._pack is not None)):
            log.warning("stream checkpoint shape mismatch (%s/%s/%s/%s "
                        "vs %s/%s/%s/%s); resuming cold",
                        ck.get("engine"), ck.get("p"), ck.get("chunk"),
                        ck.get("frontier"), self.engine, self.p,
                        self.chunk, self.frontier)
            return False
        carry = tuple(np.asarray(a) for a in ck["carry"])
        # check the layout now: a carry that does not fit raises here,
        # not at the first dispatch
        carry_from_numpy(carry, "cpu")
        self._ckpt = (int(ck["rows"]), int(ck["chunks"]), carry)
        self._rows_done = int(ck["rows"])
        self._chunks = int(ck["chunks"])
        self._resumed_from_chunk = int(ck["chunks"])
        self._att_steps = int(ck.get("att-steps", 0))
        self._att_carry = int(ck.get("att-carry", 0))
        self._ckpt_att = (self._att_steps, self._att_carry)
        self._restore_ckpt_pending = True
        return True

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, arr: np.ndarray) -> None:
        self._steps_log.append(arr)
        self._rows_fed += len(arr)
        if self._dead and not self._dead_overflow:
            return   # verdict already definite; no device work left
        if self._recovering(lambda: self._dispatch_once(arr) or True,
                            "dispatch") is None:
            # recovery budget spent: disable the stream; the offline
            # checker covers the history
            self._failed = self._last_fault or RuntimeError(
                "stream recovery budget exhausted")
            log.warning("online WGL stream disabled after %d device "
                        "faults (%s); the offline checker will run "
                        "instead", len(self.faults), self._failed)

    def _dispatch_once(self, arr: np.ndarray) -> None:
        if self._rows_done >= self._rows_fed:
            return   # a recovery replay already consumed this slice
        if self._k is None:
            self._setup()
        t_chunk = _time.monotonic()
        sp = _trace.tracer().start_span("wgl.stream.chunk",
                                        parent=self._trace_ctx)
        if sp is not None:
            sp.tags["chunk"] = str(self._chunks)
            sp.tags["rows"] = str(len(arr))
        try:
            with _telemetry.profile_section("wgl.stream.chunk"):
                maybe_inject_fault(self.fault_site)
                buf = self._buf
                n = len(arr)
                buf[:n] = arr
                if n < self.chunk:
                    buf[n:] = self._pad_row
                prev = self._carry
                self._carry = self._k.check_stream_chunk(
                    self._stage(buf), n, self._carry)
                self._chunks += 1
                self._rows_done += n
                if not self._dead:
                    # one liveness read per chunk, one chunk behind
                    self._check_death(prev)
        finally:
            _trace.tracer().finish_span(sp)
        _wgl._M_CHUNK.labels(site="stream", family=self.engine).observe(
            _time.monotonic() - t_chunk)
        _M_CHUNKS.labels(family=self.engine).inc()
        _M_LAG.observe(self.encoder.available())
        self._maybe_checkpoint()

    def _drain_attest(self) -> None:
        """Verify every pending staged-buffer digest (raises
        CorruptDeviceResult on a mismatch; callers run under the
        recovery ladder, which restores the last checkpoint and replays
        the canonical steps log)."""
        while self._att_pending:
            d, exp = self._att_pending[0]
            abft.verify_steps(self.fault_site,
                              self._k.fetch(d, site="stream attest"), exp)
            self._att_pending.pop(0)
            self._att_steps += 1

    def _check_death(self, carry) -> None:
        # ONE read per chunk: the pending staged-buffer digests ride the
        # liveness read, and the summary's att covers the walk's
        # invariants at the same boundary
        pend, self._att_pending = self._att_pending, []
        summary, digs = self._summary(carry, [d for d, _ in pend],
                                      site="stream liveness")
        ok, _death, overflow, _maxc, att = summary
        for dv, (_, exp) in zip(digs, pend):
            abft.verify_steps(self.fault_site, dv, exp)
            self._att_steps += 1
        _wgl._check_att(att, self.fault_site)
        if not ok:
            self._dead = True
            self._dead_overflow = overflow
            if not overflow:
                self.violation = True
                self.violation_at_op = len(self._client_ops)
                _M_VIOLATIONS.inc()
                if self._span_stream is not None:
                    self._span_stream.tags["violation"] = "true"
                log.warning(
                    "online checker: nonlinearizable prefix detected "
                    "after %d ops (%d steps dispatched)",
                    len(self._client_ops), self._chunks * self.chunk)

    # -- finish --------------------------------------------------------------

    def _replay(self, steps_x: np.ndarray, kernel) -> tuple:
        """Run a full step matrix through an engine chunk by chunk, with
        the stream's chunk shape; returns the final carry."""
        carry = kernel.init_carry(int(self.model.device_state()))
        pad = np.zeros((self.chunk, steps_x.shape[1]), np.int32)
        w = steps_x.shape[1] - 4
        pad[:, w] = -1
        pad[:, w + 2:] = NIL
        for e in range(0, len(steps_x), self.chunk):
            sl = steps_x[e:e + self.chunk]
            buf = pad.copy()
            buf[:len(sl)] = sl
            carry = kernel.check_stream_chunk(
                _wgl.stage_steps(buf, self.device), len(sl), carry)
        return carry

    def finish(self) -> dict | None:
        """Drain the tail, settle the verdict (escalating overflowed
        invalids like the offline path), and return the analysis. Every
        exit records the stream's root span."""
        try:
            return self._finish_inner()
        finally:
            self.end_trace()

    def _finish_inner(self) -> dict | None:
        if self._failed is not None:
            return None
        t_tail = _time.monotonic()
        # finishing can itself trigger a rebuild (a slot overflow among
        # the crash-tail pending ops, a range escape in the last chunk),
        # which replaces the encoder: keep finishing until it is stable
        while True:
            enc = self.encoder
            try:
                enc.finish()
            except _wgl.SlotOverflow:
                self._rebuild(p=self.p * 2)
            except DeviceEncodingError as e:
                log.warning("online WGL stream disabled at finish "
                            "(%s)", e)
                return None
            else:
                self._pump(partial=True)
            if self._failed is not None:
                return None
            if self.encoder is enc and enc.finished:
                break
        ops = self.encoder.op_array()
        if self.dm.validate is not None:
            try:
                self.dm.validate(ops, self.model)
            except DeviceEncodingError as e:
                log.warning("online WGL verdict discarded: %s", e)
                return None

        def _settle():
            if self._k is None:
                self._setup()   # zero-op run: still produce a verdict
            if self._attest:
                self._drain_attest()
            out, _ = self._summary(self._carry)
            _wgl._check_att(out[-1], self.fault_site)
            return out

        settled = self._recovering(_settle, "summarize")
        if settled is None:
            return None   # budget spent; offline checking covers
        ok, death, overflow, max_count, _att = settled
        F = self.frontier
        all_steps = (np.concatenate(self._steps_log)
                     if self._steps_log
                     else np.zeros((0, self.encoder.w + 4), np.int32))
        while (not ok and overflow and self.engine == "sort"
               and F < self.max_frontier):
            # invalid under overflow: the witness may have been dropped;
            # replay everything at 4x the frontier (offline contract)
            F *= 4

            def _escalate(F=F):
                k2 = self._sort_kernel(F)
                self._kernels.append(k2)
                carry = self._replay(all_steps, k2)
                out, _ = self._summary(carry, site="stream escalate",
                                       k=k2)
                # inside the closure so a corrupt att re-runs under the
                # same recovery ladder as any other fault here
                _wgl._check_att(out[-1], self.fault_site)
                return k2, carry, out

            esc = self._recovering(_escalate, "escalate", restore=False)
            if esc is None:
                return None
            self._k, self._carry, \
                (ok, death, overflow, max_count, _att2) = esc
            # keep the stream's frontier in lockstep with the engine: a
            # fault during blame rebuilds through _setup(), which reads
            # self.frontier
            self.frontier = F
        now = _time.monotonic()
        out = {
            "valid?": (True if ok else UNKNOWN if overflow else False),
            "model": repr(self.model),
            "analyzer": ("gpu-wgl-dense-streaming"
                         if self.engine == "dense"
                         else "gpu-wgl-streaming"),
            "dedup": (_wgl.DEDUP_NONE if self.engine == "dense" else
                      _wgl.dedup_engine(F, self.p, self._pack)),
            "op-count": len(ops),
            "max-frontier": int(max_count),
            "frontier-size": F,
            "chunks": self._chunks,
            "chunk-entries": self.chunk,
            "streamed": True,
            "history-len": len(self._client_ops),
            "tail-latency-ms": (now - t_tail) * 1e3,
            "duration-ms": ((now - self._t_first) * 1e3
                            if self._t_first is not None else 0.0),
            "configs": [],
            "final-paths": [],
            "device": str(self.device),
        }
        if self._attest:
            out["attested"] = {"steps": self._att_steps,
                               "carry": self._att_carry}
        if self.faults:
            rec = {"faults": list(self.faults),
                   "retries": len(self.faults)}
            if self._resumed_from_chunk is not None:
                rec["resumed-from-chunk"] = self._resumed_from_chunk
            out["recovered"] = rec
        if self.violation:
            out["violation-at-op"] = self.violation_at_op
        if self._trace_ctx is not None:
            # the verdict names its trace: a violation resolves to the
            # exact chunk spans (and recovery retries) that decided it
            out["trace-id"] = self._trace_ctx["trace-id"]
            self.end_trace(valid=out["valid?"])
        if not ok:
            if overflow:
                out["error"] = (
                    f"frontier overflowed at {F} configs; verdict "
                    f"unknown (re-run offline with a larger frontier)")
            else:
                self._blame(ops, out)
        # the port's counts (as analysis_gpu reports them): closure
        # rounds for dense, stage-B rounds for sort; K2 launches; reads
        out["closure-rounds"] = sum(k.rounds for k in self._kernels)
        out["dedup-launches"] = sum(k.dedups for k in self._kernels)
        out["host-syncs"] = sum(k.syncs for k in self._kernels)
        return out

    def _blame(self, ops: OpArray, out: dict) -> None:
        """Name the culprit op: an unmerged replay through the same
        engine shape (the merged stream cannot name one), then the host
        explanation of the prefix — the offline invalid contract."""
        try:
            steps = _wgl.build_steps(ops, self.p, merge=False)
        except _wgl.SlotOverflow:   # cannot happen: same p as merged
            return

        def _run():
            if self._k is None:   # a recovery rung dropped the engine
                self._setup()
            carry = self._replay(steps.x, self._k)
            out, _ = self._summary(carry, site="stream blame")
            return out

        r = self._recovering(_run, "blame", restore=False)
        if r is None:
            # blame is best-effort: the verdict is already decided, only
            # the certificate detail is lost
            log.warning("online blame replay abandoned after device "
                        "faults; verdict kept without a culprit op")
            return
        ok, death, *_rest = r
        d = int(death)
        if ok or d < 0:
            return
        row = int(steps.inv_row[d])
        if row < 0:
            row = int(steps.ret_row[d])
        if row < 0:
            return
        with self.host_work():
            hist = History(self._client_ops).index()
            src = int(ops.index[row])
            op = _wgl._find_op(hist, src)
            if op is None:
                return
            out["op"] = op
            out["op-index"] = src
            try:
                from .linear import explain_failure
                ex = explain_failure(self.model, hist, src)
                if ex is not None:
                    out["configs"] = ex["configs"][:10]
                    out["final-paths"] = ex["final-paths"][:10]
                    if ex.get("previous-ok") is not None:
                        out["previous-ok"] = ex["previous-ok"]
            except Exception:  # noqa: BLE001 — blame is best-effort
                log.warning("online blame explain failed", exc_info=True)


# ---------------------------------------------------------------------------
# Streaming Elle (rw-register): incremental edge accumulation
# ---------------------------------------------------------------------------

_INIT = object()   # the unwritten initial version (reads observe None)


class WrStream:
    """Incremental rw-register dependency analysis.

    Accumulates the same ww/wr/rw edges `wr.graph` derives — plus the
    single-pass G1a/G1b/internal/duplicate cases — as completions
    arrive, one txn at a time. References that resolve only later (a
    read of a value whose writer has not completed yet, a version pair
    naming a future writer, a failed write read before it failed) are
    held in pending indexes and the edges materialize when the other
    side lands, so nothing is ever re-scanned. finish() runs the one
    global pass that cannot stream — SCC condensation + device
    classification over the accumulated graph (the port's classifier, on
    the card unless built with ``device="cpu"``) — and shapes the result
    exactly like `wr.check`, over `mesh` when one is given.

    Node ids are completion-arrival order (the batch path orders oks
    before infos); the graphs are isomorphic, so verdicts and anomaly
    types agree — pinned by tests. Assumes the wr workload's unique-
    writes contract for exact parity (violations still *flag*
    duplicate-writes either way)."""

    def __init__(self, anomalies=None, mesh=None, device=None):
        from .elle import wr as _wr
        self.mesh = None if mesh is None else parallel.as_mesh(mesh)
        self._wr = _wr
        self.anomalies = tuple(anomalies) if anomalies is not None \
            else _wr.DEFAULT_ANOMALIES
        # where finish() classifies (None = CUDA, resolved there: the
        # feed is host work, and a screen that never finishes this
        # stream needs no device at all)
        self.device = device
        self.txns: list[dict] = []
        self._acc: dict[tuple, int] = {}
        self._writer_of: dict = {}        # (k,v) -> (ti, final?, op)
        self._writers_by_key: dict = {}   # k -> [ti]
        self._ext_readers: dict = {}      # (k,v) -> [(ti, op)]
        self._nil_readers: dict = {}      # k -> [(ti, op)]
        self._raw_readers: dict = {}      # (k,v) -> [(ti, op, mop)]
        self._succ: dict = {}             # (k,u) -> [v]
        self._pairs_by_second: dict = {}  # (k,v) -> [u]
        self._pairs_seen: set = set()
        self._failed_writes: dict = {}    # (k,v) -> op
        self._internal: list = []
        self._g1a: list = []
        self._g1b: list = []
        self._duplicates: list = []
        self.client_ops_fed = 0

    def export_checkpoint(self) -> dict:
        """Host streams carry no device state worth persisting: the
        checkpoint records progress counters only, and a recovered
        stream re-derives everything by re-feeding the journal (one
        cheap host-side pass). kind='host' says there is nothing to
        import."""
        return {"kind": "host", "ops-fed": int(self.client_ops_fed)}

    # edge helper — masks as in kernels (_WW=1, _WR=2, _RW=4)
    def _edge(self, i: int, j: int, mask: int) -> None:
        if i != j:
            key = (i, j)
            self._acc[key] = self._acc.get(key, 0) | mask

    def feed(self, op: dict) -> None:
        if not isinstance(op.get("process"), int):
            return
        self.client_ops_fed += 1
        t = op.get("type")
        v = op.get("value")
        if t == "invoke":
            return
        if t == "fail":
            self._feed_fail(op)
            return
        if not isinstance(v, (list, tuple)):
            return   # matches _Analysis's info filter; oks are txns
        if t == "ok":
            self._feed_ok(op)
        elif t == "info":
            ti = len(self.txns)
            self.txns.append(op)
            self._feed_writes(ti, op)

    def _feed_fail(self, op: dict) -> None:
        from .. import txn as mop
        for m in (op.get("value") or ()):
            if mop.is_write(m) and m[2] is not None:
                k, v = m[1], m[2]
                self._failed_writes[(k, v)] = op
                for (rj, ro, ml) in self._raw_readers.get((k, v), ()):
                    self._g1a.append({"op": ro, "mop": ml, "writer": op})

    def _feed_writes(self, ti: int, op: dict) -> None:
        from .elle import kernels
        writes: dict = {}
        for m in (op.get("value") or ()):
            if m[0] == "w" and m[2] is not None:
                writes.setdefault(m[1], []).append(m[2])
        for k, vs in writes.items():
            for i, v in enumerate(vs):
                final = i == len(vs) - 1
                prev = self._writer_of.get((k, v))
                if prev is not None:
                    self._duplicates.append(
                        {"key": k, "value": v, "ops": [prev[2], op]})
                self._writer_of[(k, v)] = (ti, final, op)
                self._writers_by_key.setdefault(k, []).append(ti)
                # wr to readers already seen; G1b if this write is
                # internal (non-final) to its txn
                for (rj, ro) in self._ext_readers.get((k, v), ()):
                    self._edge(ti, rj, kernels._WR)
                if not final:
                    for (rj, ro, ml) in self._raw_readers.get(
                            (k, v), ()):
                        if ro is not op:
                            self._g1b.append(
                                {"op": ro, "mop": ml, "writer": op})
                # a read of nil anti-depends on every writer of the key
                for (rj, ro) in self._nil_readers.get(k, ()):
                    self._edge(rj, ti, kernels._RW)
                # version pairs naming v as the successor: u -> v
                for u in self._pairs_by_second.get((k, v), ()):
                    if u is not _INIT:
                        wu = self._writer_of.get((k, u))
                        if wu is not None:
                            self._edge(wu[0], ti, kernels._WW)
                    for (rj, ro) in self._ext_readers.get((k, u), ()):
                        self._edge(rj, ti, kernels._RW)
                # ... and as the predecessor: v -> v2
                for v2 in self._succ.get((k, v), ()):
                    w2 = self._writer_of.get((k, v2))
                    if w2 is not None:
                        self._edge(ti, w2[0], kernels._WW)

    def _feed_ok(self, op: dict) -> None:
        from .. import txn as mop
        from .elle import kernels
        ti = len(self.txns)
        self.txns.append(op)
        case = self._wr.op_internal_case(op)
        if case is not None:
            self._internal.append(case)
        self._feed_writes(ti, op)
        # raw reads: G1a/G1b (the batch path scans raw read mops, not
        # just external reads)
        for m in (op.get("value") or ()):
            if m[0] == "r" and m[2] is not None:
                k, v = m[1], m[2]
                ml = list(m)
                self._raw_readers.setdefault((k, v), []).append(
                    (ti, op, ml))
                w = self._writer_of.get((k, v))
                if w is not None and not w[1] and w[2] is not op:
                    self._g1b.append({"op": op, "mop": ml,
                                      "writer": w[2]})
                fw = self._failed_writes.get((k, v))
                if fw is not None:
                    self._g1a.append({"op": op, "mop": ml, "writer": fw})
        # external reads: wr / rw edges
        for k, v in mop.ext_reads(op.get("value") or ()).items():
            if v is None:
                self._nil_readers.setdefault(k, []).append((ti, op))
                for wj in self._writers_by_key.get(k, ()):
                    self._edge(ti, wj, kernels._RW)
                continue
            self._ext_readers.setdefault((k, v), []).append((ti, op))
            w = self._writer_of.get((k, v))
            if w is not None:
                self._edge(w[0], ti, kernels._WR)
            for v2 in self._succ.get((k, v), ()):
                w2 = self._writer_of.get((k, v2))
                if w2 is not None:
                    self._edge(ti, w2[0], kernels._RW)
        # intra-txn version order
        cur: dict = {}
        for m in (op.get("value") or ()):
            k, v = m[1], m[2]
            if m[0] == "r":
                cur[k] = _INIT if v is None else v
            elif v is not None:
                u = cur.get(k)
                if u is not None and u != v:
                    self._new_pair(k, u, v)
                cur[k] = v

    def _new_pair(self, k, u, v) -> None:
        from .elle import kernels
        if (k, u, v) in self._pairs_seen:
            return
        self._pairs_seen.add((k, u, v))
        self._succ.setdefault((k, u), []).append(v)
        self._pairs_by_second.setdefault((k, v), []).append(u)
        wv = self._writer_of.get((k, v))
        if wv is None:
            return   # the writer-arrival trigger will materialize these
        if u is not _INIT:
            wu = self._writer_of.get((k, u))
            if wu is not None:
                self._edge(wu[0], wv[0], kernels._WW)
            for (rj, ro) in self._ext_readers.get((k, u), ()):
                self._edge(rj, wv[0], kernels._RW)

    def finish(self) -> dict:
        from .elle import kernels
        t0 = _time.monotonic()
        found: dict[str, list] = {}
        if self._duplicates:
            found["duplicate-writes"] = self._duplicates
        if self._g1a:
            found["G1a"] = self._g1a
        if self._g1b:
            found["G1b"] = self._g1b
        if self._internal:
            found["internal"] = self._internal
        edges = kernels.mask_edges_to_sets(self._acc)
        cyc = kernels.analyze_edges(len(self.txns), edges, mesh=self.mesh,
                                    device=self.device)
        found.update(kernels.certificates(self.txns, edges, cyc))
        reported = {t: cases for t, cases in found.items()
                    if t in self.anomalies}
        return {
            "valid?": not reported,
            "anomaly-types": sorted(reported),
            "anomalies": reported,
            "txn-count": len(self.txns),
            "streamed": True,
            "history-len": self.client_ops_fed,
            # reuse guard: a checker may only adopt this result if it
            # would have asked the same question
            "checked-anomalies": sorted(self.anomalies),
            "tail-latency-ms": (_time.monotonic() - t0) * 1e3,
        }


# ---------------------------------------------------------------------------
# The online checker: one background thread feeding every stream target
# ---------------------------------------------------------------------------

_SENTINEL = object()


class OnlineChecker:
    """Consumes history ops (offer()) on a dedicated thread and feeds
    every stream target. should_abort() flips once a target confirms a
    definite violation and abort_on_violation was requested — a run
    polls it and stops issuing ops. finalize() drains, finishes every target,
    and returns {target-name: result} (targets that failed or
    declined return no entry; offline checking covers them)."""

    def __init__(self, targets: dict[str, Any],
                 abort_on_violation: bool = False):
        self.targets = dict(targets)
        self.abort_on_violation = abort_on_violation
        self.aborted = False
        self.feeder_error: str | None = None
        self._abort = threading.Event()
        self._q: _queue.SimpleQueue = _queue.SimpleQueue()
        self._results: dict[str, dict] = {}
        self._client_ops = 0
        self._thread = threading.Thread(
            target=self._run, name="jepsen-online-checker", daemon=True)
        self._thread.start()

    def offer(self, op: dict) -> None:
        self._q.put(op)

    def should_abort(self) -> bool:
        return self._abort.is_set()

    def _run(self) -> None:
        # the feeding thread must not die silently: an uncaught
        # exception stamps feeder_error, finalize() marks the streamed
        # results degraded, and the offline checks cover the targets
        try:
            self._run_inner()
        except BaseException:  # noqa: BLE001 — thread boundary
            self.feeder_error = traceback.format_exc()
            log.warning("online checker feeding thread crashed; "
                        "streamed results are discarded and offline "
                        "checking covers them", exc_info=True)

    def _run_inner(self) -> None:
        dead: set[str] = set()
        while True:
            op = self._q.get()
            if op is _SENTINEL:
                break
            if isinstance(op.get("process"), int):
                self._client_ops += 1
            for name, t in self.targets.items():
                if name in dead:
                    continue
                try:
                    t.feed(op)
                except Exception:  # noqa: BLE001 — run must survive us
                    log.warning("online target %r failed; offline "
                                "checking will cover it", name,
                                exc_info=True)
                    dead.add(name)
            if self.abort_on_violation and not self._abort.is_set():
                if any(getattr(t, "violation", False)
                       for n, t in self.targets.items()
                       if n not in dead):
                    self.aborted = True
                    self._abort.set()
        for name, t in self.targets.items():
            if name in dead:
                continue
            try:
                r = t.finish()
            except Exception:  # noqa: BLE001
                log.warning("online target %r failed at finish; "
                            "offline checking will cover it", name,
                            exc_info=True)
                continue
            if r is not None:
                r.setdefault("history-len", self._client_ops)
                self._results[name] = r

    def finalize(self, timeout_s: float | None = 600.0) -> dict:
        """Stop the feeding thread and return every finished target's result.
        A crashed feeding thread yields {'degraded': True, 'error': tb}
        (no per-target verdicts) so the caller can log the degradation
        and fall through to offline checking."""
        self._q.put(_SENTINEL)
        self._thread.join(timeout_s)
        if self._thread.is_alive():
            log.warning("online checker still finishing after %ss; "
                        "abandoning it (offline checking still runs)",
                        timeout_s)
            return {}
        out = dict(self._results)
        if self.feeder_error is not None:
            out["degraded"] = True
            out["error"] = self.feeder_error
        return out

    def close(self) -> None:
        """Crash-path stop: don't wait for tail verification."""
        self._q.put(_SENTINEL)
        self._thread.join(5.0)


def _walk_checkers(checker):
    """Yield leaf checkers (descending through Compose)."""
    from . import Compose, ConcurrencyLimit, FnChecker
    if isinstance(checker, Compose):
        for c in checker.checkers.values():
            yield from _walk_checkers(c)
    elif isinstance(checker, ConcurrencyLimit):
        yield from _walk_checkers(checker.checker)
    elif isinstance(checker, FnChecker):
        yield checker.fn
    elif checker is not None:
        yield checker


def maybe_online(test: dict):
    """Build an OnlineChecker for a test that asked for one ('online'
    truthy), wiring a stream target per recognized checker: the first
    Linearizable with a device-form model (key 'linear') and the first
    RWRegisterChecker without additional graphs (key 'elle-wr'). At tier
    'screen' (test['tier']) the O(n) tier-1 screens additionally run
    over the live feed ('screen-linear' / 'screen-wr'), and their
    verdicts are what the tiered checkers reuse at analyze time. Each
    stream runs where its checker runs (the checker's `device` option).
    Returns None when the test declined or nothing is streamable."""
    if not test.get("online"):
        return None
    from . import screen as _screen
    from .elle import RWRegisterChecker
    from .linear import Linearizable

    targets: dict[str, Any] = {}
    tiered = _screen.tier_is_screen(test.get("tier"))
    for c in _walk_checkers(test.get("checker")):
        if tiered and isinstance(c, Linearizable) \
                and "screen-linear" not in targets:
            targets["screen-linear"] = _screen.ScreenStream(c.model)
        if tiered and isinstance(c, RWRegisterChecker) \
                and not c.additional_graphs \
                and "screen-wr" not in targets:
            targets["screen-wr"] = _screen.WrScreen(
                anomalies=c.anomalies)
        if isinstance(c, Linearizable) and "linear" not in targets:
            if c.model.device_model is None or c.algorithm == "host":
                continue
            try:
                targets["linear"] = WglStream(
                    c.model,
                    frontier=c.opts.get("frontier", 256),
                    max_frontier=c.opts.get("max_frontier", 65536),
                    chunk_entries=test.get("online-chunk-entries",
                                           DEFAULT_CHUNK_ENTRIES),
                    engine=("auto"
                            if test.get("online-state-range") else
                            "sort"),
                    state_range=test.get("online-state-range"),
                    concurrency_hint=test.get("concurrency"),
                    checkpoint_every=test.get(
                        "online-checkpoint-every",
                        DEFAULT_CHECKPOINT_EVERY),
                    max_recovery_retries=test.get(
                        "max-recovery-retries"),
                    device=c.opts.get("device"))
            except ValueError as e:
                log.warning("online: linearizable target declined: %s",
                            e)
        elif isinstance(c, RWRegisterChecker) and \
                "elle-wr" not in targets:
            if c.additional_graphs:
                # precedence graphs need full-history positions; the
                # offline path handles them
                log.info("online: elle-wr target declined "
                         "(additional_graphs configured)")
                continue
            targets["elle-wr"] = WrStream(anomalies=c.anomalies,
                                          mesh=c.mesh, device=c.device)
    if not targets:
        log.info("online verification requested but no streamable "
                 "checker found; running offline only")
        return None
    log.info("online verification enabled: %s", sorted(targets))
    return OnlineChecker(
        targets,
        abort_on_violation=bool(test.get("abort-on-violation")))


def stream_check(model, hist, **kw) -> dict | None:
    """Convenience: push a complete history through a WglStream (as the
    live run would, op by op) and finish — the one-call form for tests
    and the chip smoke run."""
    s = WglStream(model, **kw)
    for op in as_history(hist).ops:
        s.feed(op)
    return s.finish()
