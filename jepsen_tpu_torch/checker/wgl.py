"""Linearizability on the GPU: the WGL engines in PyTorch.

Counterpart of `jepsen_tpu/checker/wgl.py`. A configuration is (model
state, set of pending ops already linearized). Each in-flight operation
holds a *slot* in [0, P); slots are assigned host-side by scanning the
history (freed at completion, held forever by crashed :info ops), so the
mask width is bounded by real concurrency, not history length.

Two engine families, picked per history by `select_engine`:

  * **dense** (`DenseKernel`): when S states x 2^P masks fit
    DENSE_TABLE_CAP, the configuration space is a dense boolean table
    T[state, pending-mask]. An :ok return keeps the configurations
    holding the op's bit and clears it (a gather along the mask axis);
    an invoke closes the table under linearization of every occupied
    slot with closure rounds (K1's round, `wgl_closure.closure_round`)
    until the popcount stops growing. Exact. On CUDA the whole walk is
    K3 (`wgl_walk`, `csrc/dense_walk.cu`): a window of steps per launch,
    the rounds inside it.
  * **sort** (`SortKernel`): a frontier of at most F configurations.
    An invoke linearizes the new op (stage A), then closes the frontier
    by expanding only the configurations each round added (stage B);
    after each expansion the frontier is deduplicated and compacted.
    The dedup runs one of three routes: the hash dedup
    (`wgl_dedup.dedup`, the Hopper kernel K2 on CUDA) when the config
    packs into one 31-bit key, else one stable sort of a packed key,
    else a stable lexicographic sort of the mask words and the state.
    A frontier that drops configurations (overflow) makes an invalid
    verdict 'unknown', and `analysis_gpu` escalates F x 4.

The history is linearizable iff the table or frontier is nonempty after
the last step.

Engine and dedup names in results ("dense-table", "pallas-hash",
"xla-sort") are the JAX package's result vocabulary, kept so that
results and calibration keys compare field for field: they name the
route, not the implementation ("pallas-hash" runs K2 here).

The dense walk on CUDA is one kernel, K3, per window of up to 1,024
steps, with one host read at the window's end. The sort walk, and the
dense walk's plain version (`DenseKernel.run_range_eager`, what the CPU
runs), are eager Python loops: each step's control values (the
completion mask and the invoked slot) come from the host copy of the
step matrix, the slot arguments from its device copy. An eager dense
closure round costs one host read of the table's popcount, a sort
stage-B round one read of "any legal candidate?"; those syncs and the
launches around them set the eager walks' pace.

Batched keys (`analysis_gpu_batch`, the independent checker's entry):
both engines also walk B independent histories in lockstep
(`check_chunk_batch`, the JAX package's `jax.vmap` of the walk), one K3
window or K2 launch serving every key of a dispatch group. Both entries run
under the recovery ladder (below `Device-fault recovery ladder`).

Key-sharded batches (`check_batch_sharded`, the JAX package's
`shard_map` over a mesh): every rank of a `parallel.Mesh` walks its
block of each dispatch group's keys, and the ranks reduce the verdict
and gather the per-key rows (below `Key-sharded batches`).
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import logging
import time as _time
from typing import Callable

import numpy as np
import torch

from .. import (calibrate as _calibrate, parallel, telemetry as _telemetry,
               util)
from .._platform import (FAULT_COMPILE, FAULT_DEVICE_LOST, FAULT_OOM,
                         CorruptDeviceResult, attest_enabled,
                         classify_backend_error, guarded_fetch,
                         maybe_corrupt, maybe_inject_fault, resolve_device)
from ..carry import carry_to_numpy
from ..history import (DeviceEncodingError, F_CAS, F_READ, F_WRITE,
                       KIND_OK, NIL, OpArray, UQ_COUNT_MAX, UQ_VALUES,
                       default_register_codec, encode_ops,
                       history as as_history)
from . import abft, wgl_dedup, wgl_walk
from .wgl_closure import closure_round

log = logging.getLogger(__name__)

# -- telemetry (the JAX package's metric names and labels) -------------------
# Per-chunk latency by dispatch site (streaming observes site='stream'),
# and the kernels' build and warm-up latency.
_M_CHUNK = _telemetry.histogram(
    "jepsen_tpu_wgl_chunk_seconds",
    "Device chunk dispatch + lagged-sync latency",
    ("site", "family"))
_M_COMPILE = _telemetry.histogram(
    "jepsen_tpu_wgl_compile_seconds",
    "Kernel build (trace/cache miss) and warm-up compile latency",
    ("family", "stage"))
_M_OPS = _telemetry.counter(
    "jepsen_tpu_wgl_checked_ops_total",
    "History ops decided by device-checking entries",
    ("site",))

# Event kinds (host-side stream construction)
E_INVOKE = 0
E_RETURN = 1


class SlotOverflow(Exception):
    """More concurrent+crashed pending ops than the kernel's P slots."""


# ---------------------------------------------------------------------------
# Device models: vectorized step semantics (mirrors models.device_step_*)
# ---------------------------------------------------------------------------
#
# Each step takes int32 tensors (state, f, a, b) that broadcast together
# and returns (legal: bool, new_state: int32), exactly as the jnp steps
# of the JAX package do.

def _register_step(cas_enabled: bool):
    def step(state, f, a, b):
        legal = (f == F_READ) & ((a == NIL) | (state == a))
        legal = legal | (f == F_WRITE)
        if cas_enabled:
            cas_ok = (f == F_CAS) & (state == a)
            legal = legal | cas_ok
            new = torch.where(f == F_WRITE, a,
                              torch.where(cas_ok, b, state))
        else:
            new = torch.where(f == F_WRITE, a, state)
        return legal, new
    return step


def _mutex_step(state, f, a, b):
    # f: 0 = acquire, 1 = release. Outputs broadcast over state x f.
    state, f = torch.broadcast_tensors(state, f)
    legal = ((f == 0) & (state == 0)) | ((f == 1) & (state == 1))
    new = torch.where(f == 0, torch.ones_like(state),
                      torch.zeros_like(state))
    return legal, new


def mutex_codec(o: dict) -> tuple[int, int, int]:
    f = o["f"]
    if f == "acquire":
        return 0, NIL, NIL
    if f == "release":
        return 1, NIL, NIL
    raise DeviceEncodingError(f"unknown mutex op f={f!r}")


# -- counter: f 0 = read(observed; b=1 iff constrained), 1 = add(delta) ------
# Counters reach negative values routinely, so an observed read of -1
# must NOT collide with the NIL sentinel: b carries an explicit
# "constrained" flag instead.

def _counter_step(state, f, a, b):
    state, f, a, b = torch.broadcast_tensors(state, f, a, b)
    legal = ((f == 0) & ((b == 0) | (state == a))) | (f == 1)
    new = torch.where(f == 1, state + a, state)
    return legal, new


def counter_codec(o: dict) -> tuple[int, int, int]:
    f, v = o["f"], o["value"]
    if f == "read":
        if v is None:
            return 0, 0, 0
        return 0, int(v), 1
    if f == "add":
        return 1, int(v), NIL
    raise DeviceEncodingError(f"unknown counter op f={f!r}")


def _counter_range(init, f, a, b):
    f, a, b = np.asarray(f), np.asarray(a), np.asarray(b)
    deltas = a[f == 1]
    lo = init + int(deltas[deltas < 0].sum()) if deltas.size else init
    hi = init + int(deltas[deltas > 0].sum()) if deltas.size else init
    # completed reads also name reachable values (paranoia: they must
    # equal a state anyway); include them so invalid histories still
    # encode
    reads = a[(f == 0) & (b == 1)]
    if reads.size:
        lo = min(lo, int(reads.min()))
        hi = max(hi, int(reads.max()))
    return lo, hi


# -- grow-only set: f 0 = read(bitmask), 1 = add(element id) -----------------

GSET_MAX_ELEMENTS = 31   # state is an int32 membership bitmask


def _gset_step(state, f, a, b):
    state, f, a = torch.broadcast_tensors(state, f, a)
    legal = ((f == 0) & ((a == NIL) | (state == a))) | (f == 1)
    shift = torch.clamp(a, 0, GSET_MAX_ELEMENTS - 1)
    new = torch.where(f == 1, state | (torch.ones_like(shift) << shift),
                      state)
    return legal, new


def gset_codec(o: dict) -> tuple[int, int, int]:
    f, v = o["f"], o["value"]
    if f == "add":
        v = int(v)
        if not 0 <= v < GSET_MAX_ELEMENTS:
            raise DeviceEncodingError(
                f"g-set element {v} outside [0, {GSET_MAX_ELEMENTS})"
                " — use the host model")
        return 1, v, NIL
    if f == "read":
        if v is None:
            return 0, NIL, NIL
        mask = 0
        for x in v:
            x = int(x)
            if not 0 <= x < GSET_MAX_ELEMENTS:
                raise DeviceEncodingError(
                    f"g-set element {x} outside "
                    f"[0, {GSET_MAX_ELEMENTS}) — use the host model")
            mask |= 1 << x
        return 0, mask, NIL
    raise DeviceEncodingError(f"unknown g-set op f={f!r}")


def _gset_range(init, f, a, b):
    f, a = np.asarray(f), np.asarray(a)
    full = int(init)
    for x in a[f == 1]:
        full |= 1 << int(x)
    for m in a[(f == 0) & (a != NIL)]:
        full |= int(m)
    return 0, full


# -- unordered queue: f 0 = dequeue(v), 1 = enqueue(v) -----------------------
# state: 4-bit per-value multiplicities, values in [0, 7)

def _uqueue_step(state, f, a, b):
    state, f, a = torch.broadcast_tensors(state, f, a)
    shift = 4 * torch.clamp(a, 0, UQ_VALUES - 1)
    cnt = (state >> shift) & UQ_COUNT_MAX
    ok_a = (a >= 0) & (a < UQ_VALUES)
    legal = torch.where(f == 1, ok_a & (cnt < UQ_COUNT_MAX),
                        ok_a & (cnt > 0))
    one = torch.ones_like(shift) << shift
    new = torch.where(legal & (f == 1), state + one,
                      torch.where(legal & (f == 0), state - one, state))
    return legal, new


def _uqueue_validate(ops: OpArray, model) -> None:
    """A sound upper bound on any reachable per-value multiplicity:
    initial copies plus enqueues invoked so far, minus ok dequeues
    returned so far, maxed over the event stream. If it can exceed
    the 4-bit digit cap the device multiset would silently saturate
    (carrying into the next value's digit) — raise so the checker
    falls back to the host model."""
    events: list[tuple[int, int, int]] = []
    for r in range(len(ops)):
        v = int(ops.a[r])
        if ops.f[r] == 1:                       # enqueue (incl. crashed)
            events.append((int(ops.inv[r]), 0, v))
        elif ops.kind[r] == KIND_OK:            # ok dequeue
            events.append((int(ops.ret[r]), 1, v))
    events.sort()
    outstanding = [0] * UQ_VALUES
    for (v, _i) in getattr(model, "pending", ()):
        v = int(v)
        if not 0 <= v < UQ_VALUES:
            raise DeviceEncodingError(
                f"initial queue value {v} outside [0, {UQ_VALUES}) — "
                "use the host model")
        outstanding[v] += 1
        if outstanding[v] > UQ_COUNT_MAX:
            raise DeviceEncodingError(
                f"initial queue state has more than {UQ_COUNT_MAX} "
                f"copies of {v} — use the host model")
    for _, kind, v in events:
        if kind == 0:
            outstanding[v] += 1
            if outstanding[v] > UQ_COUNT_MAX:
                raise DeviceEncodingError(
                    f"queue value {v} may have more than "
                    f"{UQ_COUNT_MAX} outstanding copies — the device "
                    "multiset digit would saturate; use the host model")
        else:
            outstanding[v] -= 1


def uqueue_codec(o: dict) -> tuple[int, int, int]:
    f, v = o["f"], o["value"]
    if v is None:
        raise DeviceEncodingError(
            "queue op with unknown value (crashed dequeue?) — the "
            "device multiset can't branch over it; use the host model")
    v = int(v)
    if not 0 <= v < UQ_VALUES:
        raise DeviceEncodingError(
            f"queue value {v} outside [0, {UQ_VALUES}) — use the "
            "host model")
    if f == "enqueue":
        return 1, v, NIL
    if f == "dequeue":
        return 0, v, NIL
    raise DeviceEncodingError(f"unknown queue op f={f!r}")


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """A model with enumerable int32 state, steppable on device.

    step        (state, f, a, b) -> (legal, new_state), broadcasting
    codec       op dict -> (f, a, b) int encoding
    droppable   f-codes whose pending (crashed) ops constrain nothing
    state_range (init_state, f, a, b arrays) -> inclusive (lo, hi)
                bounds on every reachable state
    """
    step: Callable
    codec: Callable
    droppable: frozenset
    state_range: Callable
    validate: Callable | None = None  # (OpArray, model) -> None | raise


def _register_range(init, f, a, b):
    a, b = np.asarray(a), np.asarray(b)
    hi, lo = init, min(NIL, init)
    for v in (a[a != NIL], b[b != NIL]):
        if v.size:
            hi = max(hi, int(v.max()))
            lo = min(lo, int(v.min()))
    return lo, hi


DEVICE_MODELS: dict[str, DeviceModel] = {
    "cas-register": DeviceModel(_register_step(True),
                                default_register_codec,
                                frozenset({F_READ}), _register_range),
    "register": DeviceModel(_register_step(False), default_register_codec,
                            frozenset({F_READ}), _register_range),
    "mutex": DeviceModel(_mutex_step, mutex_codec, frozenset(),
                         lambda init, f, a, b: (0, 1)),
    # crashed (pending) reads constrain nothing for counter/g-set and
    # are droppable; queue dequeues are never droppable
    "counter": DeviceModel(_counter_step, counter_codec,
                           frozenset({0}), _counter_range),
    "g-set": DeviceModel(_gset_step, gset_codec,
                         frozenset({0}), _gset_range),
    "unordered-queue": DeviceModel(
        _uqueue_step, uqueue_codec, frozenset(),
        lambda init, f, a, b: (0, (1 << (4 * UQ_VALUES)) - 1),
        validate=_uqueue_validate),
}


# ---------------------------------------------------------------------------
# Host preprocessing: ops -> packed event steps with slot assignment
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Steps:
    """The engines' input: the history as packed event steps.

    One int32 row of ``x`` per step: ``[ret_mask words (W) | inv_slot |
    f | a | b]``. A step first *completes* every slot in ret_mask, then
    — when inv_slot >= 0 — *invokes* (inv_slot, f, a, b). Merged
    streams (build_steps merge=True) fold each run of consecutive :ok
    completions into the following invoke's step; unmerged streams
    carry one event per step, so the step where the table died names a
    single culprit op.

    ret_row  int32[T] — op row of the step's sole completion (-1 if
             none, or ambiguous because several were merged)
    inv_row  int32[T] — op row of the step's invoke (-1 if none)
    """
    x: np.ndarray        # (T, W+4) int32
    ret_row: np.ndarray
    inv_row: np.ndarray
    w: int
    n: int               # live steps (<= T)


def event_count(ops: OpArray) -> int:
    """Length of the unmerged event stream (invokes + ok returns)."""
    return len(ops) + int((np.asarray(ops.kind) == KIND_OK).sum())


def required_slots(ops: OpArray) -> int:
    """The peak number of simultaneously-pending ops (crashed ops pend
    forever) — the minimum slot count the engine needs."""
    # same (position, order) tie-break as build_steps: invokes sort
    # before returns at equal positions
    events = []
    for r in range(len(ops)):
        events.append((int(ops.inv[r]), 0, 1))
        if ops.kind[r] == KIND_OK:
            events.append((int(ops.ret[r]), 1, -1))
    events.sort()
    cur = peak = 0
    for _, _, d in events:
        cur += d
        peak = max(peak, cur)
    return max(peak, 1)


def build_steps(ops: OpArray, p: int, merge: bool = True) -> Steps:
    """Lower an OpArray to packed event steps, assigning each op a slot
    in [0, p). Raises SlotOverflow if concurrency + crashed ops exceed
    p."""
    events = []  # (position, order, kind, row)
    for r in range(len(ops)):
        events.append((int(ops.inv[r]), 0, E_INVOKE, r))
        if ops.kind[r] == KIND_OK:
            events.append((int(ops.ret[r]), 1, E_RETURN, r))
    events.sort()
    w = max(1, (p + 31) // 32)
    free = list(range(p))
    heapq.heapify(free)
    slot_of_row: dict[int, int] = {}
    masks: list[list[int]] = []
    rest: list[tuple[int, int, int, int]] = []
    ret_row: list[int] = []
    inv_row: list[int] = []
    pend = [0] * w
    pend_rows: list[int] = []

    def flush(inv_slot: int, f: int, a: int, b: int, row: int) -> None:
        nonlocal pend, pend_rows
        masks.append(pend)
        rest.append((inv_slot, f, a, b))
        ret_row.append(pend_rows[0] if len(pend_rows) == 1 else -1)
        inv_row.append(row)
        pend = [0] * w
        pend_rows = []

    for _, _, k, r in events:
        if k == E_INVOKE:
            if not free:
                raise SlotOverflow(
                    f"more than {p} pending ops at op row {r} "
                    f"(crashed ops hold slots forever); raise p or check "
                    f"on the host")
            s = heapq.heappop(free)
            slot_of_row[r] = s
            flush(s, int(ops.f[r]), int(ops.a[r]), int(ops.b[r]), r)
        else:
            s = slot_of_row.pop(r)
            heapq.heappush(free, s)
            pend[s // 32] |= 1 << (s % 32)
            pend_rows.append(r)
            if not merge:
                flush(-1, 0, NIL, NIL, -1)
    if any(pend):
        flush(-1, 0, NIL, NIL, -1)
    n = len(masks)
    mask_arr = np.asarray(masks, np.uint32).reshape(n, w)
    rest_arr = np.asarray(rest, np.int32).reshape(n, 4)
    return Steps(np.concatenate([mask_arr.view(np.int32), rest_arr],
                                axis=1),
                 np.asarray(ret_row, np.int32),
                 np.asarray(inv_row, np.int32), w, n)


def _bucket(n: int, lo: int = 64) -> int:
    """Round up to a power of two."""
    e = lo
    while e < n:
        e *= 2
    return e


# ---------------------------------------------------------------------------
# Dense reachable-set engine
# ---------------------------------------------------------------------------

DENSE_TABLE_CAP = 1 << 22   # max S * 2^P bools held as the dense table
DENSE_STATE_CAP = 512       # a closure round is O(P * S^2 * C): bound S too

Staged = collections.namedtuple("Staged", ["host", "dev"])
Staged.__doc__ = """A step matrix twice: the numpy original, whose control
values the host walk reads without a device sync, and its device copy,
which the kernels read and the staged-buffer digest covers."""


def stage_steps(x: np.ndarray, device) -> Staged:
    host = np.ascontiguousarray(x, dtype=np.int32)
    return Staged(host, torch.from_numpy(host).to(device))


def _h2d(a: np.ndarray, device) -> torch.Tensor:
    """A host array (a per-key mask or index chosen by the host walk) on
    the device. Non-blocking: CUDA copies a pageable source into its
    staging buffer before the call returns, and the copy waits for no
    queued kernel."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                        non_blocking=True)


class _Engine:
    """What both engine families share: counted, watchdog-guarded host
    reads, the carry digest, the one-call check and the batch entries'
    scaffolding. A subclass sets `device` and implements init_carry,
    run_range, summarize and their batched forms."""

    device: torch.device
    syncs: int
    # a zero-arg callable polled before each step of a walk (the
    # competition race's loser stops there); a walk it stops leaves
    # `interrupted` set and its carry undecided
    cancel = None
    interrupted = False

    def _cancelled(self) -> bool:
        if self.cancel is not None and self.cancel():
            self.interrupted = True
        return self.interrupted

    def fetch(self, t: torch.Tensor, site: str = "device-sync"):
        """Read a tensor's value on the host (one device sync, bounded by
        the watchdog deadline when one is set)."""
        self.syncs += 1
        return guarded_fetch(t.tolist, site=site)

    def fetch_carry(self, carry, site: str = "carry") -> tuple:
        self.syncs += 1
        return guarded_fetch(lambda: carry_to_numpy(carry), site=site)

    def _i32(self, v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32, device=self.device)

    def digest(self, carry) -> torch.Tensor:
        """The carry digest (abft.carry_digest_host is its host mirror),
        unfetched."""
        return abft.carry_digest_device(carry)

    def check(self, xs: Staged, n_steps: int, init_state: int) -> tuple:
        """The whole search in one call: init + walk + summarize."""
        return self.summarize(
            self.run_range(xs, n_steps, self.init_carry(init_state)))

    def check_stream_chunk(self, xs: Staged, n: int, carry) -> tuple:
        """The streaming entry: `xs` holds only this chunk's steps (padded
        to the chunk's length), so the walk runs steps [0, n) with the
        carry's event count rebased to 0, and the count comes back added
        to the carry's own. A growing history streams through one shape
        and ships each step once. Every other carry element is the
        walk's, as in the JAX package's `check_stream_chunk`."""
        out = self.run_range(xs, n, (self._i32(0),) + tuple(carry[1:]))
        return (out[0] + carry[0],) + tuple(out[1:])

    # -- batch entries: jax.vmap of the entries above ---------------------
    #
    # A batched carry holds every element of the carry with a leading B,
    # exactly the JAX package's vmapped carry; the step matrix is (B, T,
    # W+4). Each key walks its own steps to its own stop, and a key that
    # is stopped or dead keeps its carry unchanged, as vmap's select of a
    # batched while_loop leaves it. The host walk keeps each key's step
    # index and liveness (both it reads anyway), gathers each active
    # key's step row on the device, and decides from its own copy of the
    # steps whether any key completes or invokes at this step.

    def init_carry_batch(self, init_states) -> tuple:
        carries = [self.init_carry(int(s)) for s in init_states]
        return tuple(torch.stack(c) for c in zip(*carries))

    def digest_batch(self, carry) -> torch.Tensor:
        """One carry digest per key, as an unfetched int32 (B,) tensor."""
        return abft.carry_digest_device(carry, batch=True)

    def check_batch(self, xs: Staged, n_steps, init_states) -> tuple:
        """The whole search of B keys: init + walk + summarize, batched."""
        return self.summarize_batch(self.run_range_batch(
            xs, n_steps, self.init_carry_batch(init_states)))

    def summarize_batch(self, carry) -> tuple:
        """(ok, death, overflow, max_count, att), numpy arrays of B:
        summarize of each key."""
        e, count, maxc, att, ovf = self.summary_batch(carry)
        ok = count > 0
        return ok, np.where(ok, -1, e - 1), ovf, maxc, att

    def summary_batch(self, carry) -> tuple:
        """(e, count, max_count, att, overflow) of each key, numpy arrays
        of B, in one host read."""
        e, count, maxc, att, ovf = (np.asarray(v) for v in self.fetch(
            torch.stack(self._summary_row(carry)), site="batch summarize"))
        return e, count, maxc, att, ovf.astype(bool)

    def _walk_start(self, carry, stops, count_at: int):
        """Host copies of each key's step index and liveness, or None when
        no key has a step to walk."""
        e_h, count_h = (np.asarray(v, np.int64) for v in self.fetch(
            torch.stack([carry[0], carry[count_at]])))
        alive = count_h > 0
        stops = np.asarray(stops, np.int64)
        if not ((e_h < stops) & alive).any():
            return None
        return e_h, alive, stops

    def _step_rows(self, xs: Staged, e_h: np.ndarray):
        """Each key's current step row: the host copy (control decisions)
        and the device copy, gathered at each key's own step index."""
        T = xs.host.shape[1]
        idx = np.minimum(e_h, T - 1)
        row_h = xs.host[np.arange(len(e_h)), idx]
        row_d = xs.dev[self._keys(len(e_h)), _h2d(idx, self.device)]
        return row_h, row_d

    def _keys(self, B: int) -> torch.Tensor:
        ar = getattr(self, "_ar", None)
        if ar is None or ar.shape[0] != B:
            ar = self._ar = torch.arange(B, device=self.device)
        return ar


class DenseKernel(_Engine):
    """The dense engine for S states x P slots on one device.

    Same entry points as the JAX package's dense `Kernel`: init_carry,
    check_chunk (= run_range), check, summarize and digest, over the
    same carry ``(e, table bool[S,C], slot_f, slot_a, slot_b int32[P],
    slot_occ bool[P], att, count, max_count int32)``. Carries are
    tensors on `device` and are never updated in place, so a caller may
    keep an earlier one (the lagged liveness read does).

    The walk (`run_range`, `run_range_batch`) is K3 on CUDA (`_walk_k3`
    around `wgl_walk.launch`: a window of steps per launch, closure
    rounds inside) and the eager walk (`run_range_eager`,
    `run_range_batch_eager`, K3's plain version) on the CPU.

    `rounds` counts closure rounds (the eager walk's K1 launches, the
    rounds K3 reports) and `syncs` counts blocking device-to-host reads,
    over the kernel's life."""

    dedups = 0   # the dense family has no dedup (SortKernel counts K2's)

    def __init__(self, model_name: str, s_lo: int, S: int, P: int,
                 device):
        if not 0 <= P <= 30:
            raise ValueError(f"dense engine needs 0 <= P <= 30, got {P}")
        self.step = DEVICE_MODELS[model_name].step
        self.s_lo, self.S, self.P, self.C = s_lo, S, P, 1 << P
        self.device = torch.device(device)
        self.use_attest = attest_enabled()
        dev = self.device
        self._s_vals = torch.arange(s_lo, s_lo + S, dtype=torch.int32,
                                    device=dev)
        self._cols = torch.arange(self.C, dtype=torch.int64, device=dev)
        self._bits = torch.tensor([1 << p for p in range(P)],
                                  dtype=torch.int32, device=dev)
        self.rounds = 0
        self.syncs = 0

    # -- carry ---------------------------------------------------------------
    def init_carry(self, init_state: int) -> tuple:
        # att is the ABFT attestation accumulator: table-occupancy
        # invariant residues sum into it and it must read 0 on the host
        # at every chunk boundary (abft.verify_carry)
        P, dev = self.P, self.device
        table = torch.zeros((self.S, self.C), dtype=torch.bool, device=dev)
        table[int(init_state) - self.s_lo, 0] = True
        return (self._i32(0), table,
                torch.zeros(P, dtype=torch.int32, device=dev),
                torch.full((P,), NIL, dtype=torch.int32, device=dev),
                torch.full((P,), NIL, dtype=torch.int32, device=dev),
                torch.zeros(P, dtype=torch.bool, device=dev),
                self._i32(0), self._i32(1), self._i32(1))

    def summarize(self, carry) -> tuple:
        """(ok, death, overflow, max_count, att) on the host. death is
        the merged step at which the table emptied (-1 when alive); the
        dense table never drops configurations, so overflow is always
        False and every verdict is exact."""
        e, _t, _f, _a, _b, _o, att, count, maxc = carry
        e, att, count, maxc = self.fetch(torch.stack([e, att, count, maxc]))
        ok = count > 0
        return ok, (-1 if ok else e - 1), False, maxc, att

    # -- the walk --------------------------------------------------------------
    def _closure(self, table, slots, occ):
        """Close the table under linearization of every occupied slot.
        Returns (table, count tensor, count)."""
        i32 = torch.int32
        legal, new = self.step(self._s_vals[None, :], slots[0][:, None],
                               slots[1][:, None], slots[2][:, None])
        legal = legal & occ[:, None]                            # (P, S)
        # mft[p, q, s] = M[p, s, q]: linearizing slot p moves state s
        # to state q — the transposed layout K1 takes
        mft = (legal[:, None, :]
               & (new[:, None, :] == self._s_vals[None, :, None])
               ).to(torch.uint8)                                # (P, S, S)
        tb = closure_round(table, mft)
        self.rounds += 1
        cnt_t = tb.sum(dtype=i32)
        prev, cnt = self.fetch(torch.stack([table.sum(dtype=i32), cnt_t]))
        # rounds only add configurations, so an unchanged popcount
        # means an unchanged table: the fixpoint
        while cnt != prev:
            prev = cnt
            tb = closure_round(tb, mft)
            self.rounds += 1
            cnt_t = tb.sum(dtype=i32)
            cnt = self.fetch(cnt_t)
        return tb, cnt_t, cnt

    def run_range(self, xs: Staged, stop: int, carry) -> tuple:
        """Walk steps [carry.e, stop) while the table is nonempty: K3 on
        CUDA tensors, the eager walk on CPU tensors."""
        if self._on_cpu(carry):
            return self.run_range_eager(xs, stop, carry)
        out = self._walk_k3(xs.dev[None], [stop],
                            tuple(t[None] for t in carry))
        return carry if out is None else tuple(t[0] for t in out)

    check_chunk = run_range

    def run_range_eager(self, xs: Staged, stop: int, carry) -> tuple:
        """K3's plain version: walk steps [carry.e, stop) while the table
        is nonempty, one host-driven step at a time (K1 per closure
        round on CUDA). The walk stops after the step that empties the
        table, so a dead carry's e is death + 1, as the JAX while_loop
        leaves it."""
        e, count = self.fetch(torch.stack([carry[0], carry[7]]))
        if e >= stop or count <= 0:
            return carry
        i32 = torch.int32
        _e, table, slot_f, slot_a, slot_b, occ, att, count_t, maxc = carry
        # fresh copies, updated in place below: the caller's carry
        # stays as it was
        slots = torch.stack([slot_f, slot_a, slot_b])           # (3, P)
        occ = occ.clone()
        x, xd = xs.host, xs.dev
        # the dense table caps P well below 31, so the completion mask
        # is one non-negative int32 word: row = [rm, slot, f, a, b]
        while e < stop and count > 0 and not self._cancelled():
            rm, s = int(x[e, 0]), int(x[e, 1])
            if rm:
                # survivors hold every returned bit; the new config is
                # the same mask with them cleared:
                # table'[c] = table[c | rm] iff c & rm == 0
                table = table.index_select(1, self._cols | rm) \
                    & ((self._cols & rm) == 0)
                occ &= (self._bits & rm) == 0
            if s >= 0:
                slots[:, s] = xd[e, 2:5]
                occ[s] = True
                table, count_t, count = self._closure(table, slots, occ)
            else:
                count_t = table.sum(dtype=i32)
                count = self.fetch(count_t)
            if self.use_attest:
                # ABFT table invariant: a column whose mask holds a bit
                # of an UNOCCUPIED slot is unreachable, so any true cell
                # there is a bit-flip
                occ_bits = torch.where(occ, self._bits, 0).sum(dtype=i32)
                badc = (self._cols & ~occ_bits) != 0
                att = att + (table & badc).sum(dtype=i32)
            maxc = torch.maximum(maxc, count_t)
            e += 1
        return (self._i32(e), table, slots[0], slots[1], slots[2], occ,
                att, count_t, maxc)

    # -- the batched walk (jax.vmap of run_range) --------------------------
    def _summary_row(self, carry):
        e, att, count, maxc = carry[0], carry[6], carry[7], carry[8]
        return [e, count, maxc, att, torch.zeros_like(e)]

    def _closure_batch(self, table, slots, occ, inv: torch.Tensor,
                       inv_h: np.ndarray):
        """Close the tables of the invoking keys (inv) under
        linearization of their occupied slots, one batched K1 launch a
        round, until no key's popcount changes; a key that has converged
        is frozen, the others' tables are left as they are. Returns
        (table, counts tensor, counts on the host) for every key."""
        i32 = torch.int32
        legal, new = self.step(self._s_vals[None, None, :],
                               slots[0][:, :, None], slots[1][:, :, None],
                               slots[2][:, :, None])            # (B, P, S)
        legal = legal & occ[:, :, None]
        mft = (legal[:, :, None, :]
               & (new[:, :, None, :] == self._s_vals[None, None, :, None])
               ).to(torch.uint8)                             # (B, P, S, S)
        tb = torch.where(inv[:, None, None], closure_round(table, mft),
                         table)
        self.rounds += 1
        cnt_t = tb.sum((1, 2), dtype=i32)
        prev, cnt = (np.asarray(v) for v in self.fetch(
            torch.stack([table.sum((1, 2), dtype=i32), cnt_t])))
        going = inv_h & (cnt != prev)
        while going.any():
            g = _h2d(going, self.device)
            tb = torch.where(g[:, None, None], closure_round(tb, mft), tb)
            self.rounds += 1
            cnt_t = tb.sum((1, 2), dtype=i32)
            nxt = np.asarray(self.fetch(cnt_t))
            going &= nxt != cnt
            cnt = nxt
        return tb, cnt_t, cnt

    def run_range_batch(self, xs: Staged, stops, carry) -> tuple:
        """Walk each key b's steps [e_b, stops[b]) while its table is
        nonempty: K3 on CUDA tensors (one launch walks every key's
        window), the eager lockstep walk on CPU tensors. xs holds a (B,
        T, 5) step matrix; stops is a length-B sequence."""
        if self._on_cpu(carry):
            return self.run_range_batch_eager(xs, stops, carry)
        out = self._walk_k3(xs.dev, stops, carry)
        return carry if out is None else out

    check_chunk_batch = run_range_batch

    def run_range_batch_eager(self, xs: Staged, stops, carry) -> tuple:
        """K3's plain version, batched: walk each key b's steps [e_b,
        stops[b]) while its table is nonempty, all keys in lockstep: per
        step one gather of each key's row, one completion gather for the
        keys that complete, and batched closure rounds (one K1 launch a
        round on CUDA) for the keys that invoke. xs holds a
        (B, T, 5) step matrix; stops is a length-B sequence."""
        start = self._walk_start(carry, stops, 7)
        if start is None:
            return carry
        e_h, alive, stops = start
        i32 = torch.int32
        dev, B = self.device, len(e_h)
        _e, table, slot_f, slot_a, slot_b, occ, att, count, maxc = carry
        slots = torch.stack([slot_f, slot_a, slot_b])           # (3, B, P)
        cols = self._cols[None, :]
        parange = torch.arange(self.P, device=dev)[None, :]
        while True:
            act_h = (e_h < stops) & alive
            if not act_h.any():
                break
            row_h, row = self._step_rows(xs, e_h)
            act = _h2d(act_h, dev)
            if (act_h & (row_h[:, 0] != 0)).any():
                rm = torch.where(act, row[:, 0], 0).to(torch.int64)[:, None]
                idx = (cols | rm)[:, None, :].expand(B, self.S, self.C)
                table = table.gather(2, idx) & ((cols & rm) == 0)[:, None, :]
                occ = occ & ((self._bits[None, :] & rm) == 0)
            inv_h = act_h & (row_h[:, 1] >= 0)
            if inv_h.any():
                inv = _h2d(inv_h, dev)
                # the invoked slot of each invoking key, and no slot at
                # all for the others (vmap's lax.cond writes slot -1 and
                # throws it away; here nothing is written)
                onehot = (parange == row[:, 1:2]) & inv[:, None]  # (B, P)
                slots = torch.where(onehot[None], row[:, 2:5].T[:, :, None],
                                    slots)
                occ = occ | onehot
                table, count_t, cnt_h = self._closure_batch(
                    table, slots, occ, inv, inv_h)
            else:
                count_t = table.sum((1, 2), dtype=i32)
                cnt_h = np.asarray(self.fetch(count_t))
            if self.use_attest:
                occ_bits = torch.where(occ, self._bits, 0).sum(1, dtype=i32)
                badc = (cols & ~occ_bits[:, None]) != 0          # (B, C)
                att = att + torch.where(
                    act, (table & badc[:, None, :]).sum((1, 2), dtype=i32),
                    0)
            count = torch.where(act, count_t, count)
            maxc = torch.where(act, torch.maximum(maxc, count_t), maxc)
            e_h = e_h + act_h
            alive = cnt_h > 0
        return (_h2d(e_h.astype(np.int32), dev), table, slots[0], slots[1],
                slots[2], occ, att, count, maxc)

    # -- K3: the walk on CUDA ------------------------------------------------
    @staticmethod
    def _on_cpu(carry) -> bool:
        """Whether the walk is the eager one: the carry's table lies on
        the CPU. On CUDA the walk is K3's, and nothing falls back."""
        dev = carry[1].device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"the dense walk runs on CUDA (or its plain "
                             f"version on the CPU), got {dev}")
        return dev.type == "cpu"

    def _walk_k3(self, x: torch.Tensor, stops, carry):
        """K3 window after window over a batched carry and its (B, T, 5)
        step matrix, up to `wgl_walk.WINDOW` steps of every key per
        launch; None when no key has a step to walk (the caller keeps its
        carry, as the eager walk does). One host read to start and one
        at the end of each window."""
        B, T = x.shape[0], x.shape[1]
        e, table, sf, sa, sb, occ, att, count, maxc = carry
        e_h, count_h = (np.asarray(v, np.int64).reshape(B) for v in
                        self.fetch(torch.stack([e, count])))
        stops = np.minimum(np.asarray(stops, np.int64).reshape(B), T)
        active = (e_h < stops) & (count_h > 0)
        if not active.any():
            return None
        dev, window = table.device, wgl_walk.WINDOW
        x = x.contiguous()
        sc = torch.stack([e, att, count, maxc]).to(torch.int32).contiguous()
        table = table.contiguous()
        if table.data_ptr() % 16:
            table = table.clone()
        slots = torch.stack([sf, sa, sb]).contiguous()
        occ = occ.contiguous()
        keys = torch.arange(B, device=dev)[:, None]
        steps = torch.arange(window, device=dev)[None, :]
        while not self._cancelled():
            wend = np.where(active, np.minimum(stops, e_h + window), e_h)
            W = int((wend - e_h).max())
            rows = x[keys, (sc[0].to(torch.int64)[:, None]
                            + steps[:, :W]).clamp_(max=T - 1)]  # (B, W, 5)
            itr = wgl_walk.transition_rows(self.step, self.s_lo, self.S,
                                           rows[..., 2], rows[..., 3],
                                           rows[..., 4])
            str0 = wgl_walk.transition_rows(self.step, self.s_lo, self.S,
                                            slots[0], slots[1], slots[2])
            sc, table, slots, occ, rounds, pairs = wgl_walk.launch(
                x, _h2d(wend.astype(np.int32), dev), itr, str0, sc, table,
                slots, occ, self.use_attest)
            got = np.asarray(self.fetch(torch.cat([
                sc[0].to(torch.int64), sc[2].to(torch.int64),
                rounds.sum(dtype=torch.int64)[None], pairs])), np.int64)
            e_h, count_h = got[:B], got[B:2 * B]
            self.rounds += int(got[-2])
            wgl_walk.count_rounds(int(got[-2]), int(got[-1]))
            active = (e_h < stops) & (count_h > 0)
            if not active.any():
                break
        return (sc[0], table, slots[0], slots[1], slots[2], occ, sc[1],
                sc[2], sc[3])


# ---------------------------------------------------------------------------
# Sort-frontier engine
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _neq_prev(x: torch.Tensor) -> torch.Tensor:
    """True at column 0 and wherever a (B, N) tensor's element differs
    from the one before it in its row."""
    out = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    out[:, 1:] = x[:, 1:] != x[:, :-1]
    return out


class SortKernel(_Engine):
    """The sort-frontier engine: an F-configuration frontier over P slots
    on one device (counterpart of the JAX package's `_kernel_cached`).

    Same entry points as `DenseKernel`, over the JAX sort kernel's carry
    ``(e, masks [F,W], states [F], valid bool[F], slot_f, slot_a, slot_b
    int32[P], slot_occ bool[P], overflow bool, att, count, max_count
    int32)``. The masks are uint32 words in the JAX carry; here they are
    int32 tensors holding the same bit patterns (torch has no shifts on
    uint32), and `carry.py` views them as uint32 on the host.

    pack: (s_lo, sb_bits) from `_pack_params`, or None. dedup: the
    resolved route, DEDUP_PALLAS (the hash dedup, K2 on CUDA; needs a
    packed one-word config) or DEDUP_SORT (one stable sort of the packed
    key when pack is given and W == 1, else the lexicographic sort).

    `rounds` counts stage-B expansion rounds, `dedups` the hash-dedup
    calls (K2 launches on CUDA), `syncs` blocking host reads."""

    def __init__(self, model_name: str, F: int, P: int,
                 pack: tuple[int, int] | None, dedup: str, device):
        if not 1 <= P <= 256 or F < 1:
            raise ValueError(f"sort engine needs 1 <= P <= 256 and F >= 1, "
                             f"got P={P}, F={F}")
        self.step = DEVICE_MODELS[model_name].step
        self.F, self.P, self.W = F, P, max(1, (P + 31) // 32)
        self.s_lo, self.sb_bits = pack if pack is not None else (0, 64)
        self.packed = pack is not None and self.W == 1
        if dedup == DEDUP_PALLAS and not self.packed:
            raise ValueError("the hash dedup needs a packed one-word config")
        if dedup not in (DEDUP_PALLAS, DEDUP_SORT):
            raise ValueError(f"unknown dedup route {dedup!r}")
        self.dedup_route = dedup
        self.device = dev = torch.device(device)
        self.use_attest = attest_enabled()
        bits = np.zeros((P, self.W), np.uint32)
        for p in range(P):
            bits[p, p // 32] = np.uint32(1) << np.uint32(p % 32)
        self._bitmat = torch.from_numpy(bits.view(np.int32)).to(dev)
        self._origin_a = torch.arange(2 * F, device=dev) >= F
        self._origin_b = torch.arange(F * (1 + P), device=dev) >= F
        self.rounds = 0
        self.dedups = 0
        self.syncs = 0

    # -- carry ---------------------------------------------------------------
    def init_carry(self, init_state: int) -> tuple:
        # att is the ABFT attestation accumulator: frontier-invariant
        # residues and hash-dedup digest mismatches sum into it, and it
        # must read 0 on the host at every chunk boundary
        F, P, dev = self.F, self.P, self.device
        valid = torch.zeros(F, dtype=torch.bool, device=dev)
        valid[0] = True
        return (self._i32(0),
                torch.zeros((F, self.W), dtype=torch.int32, device=dev),
                torch.full((F,), int(init_state), dtype=torch.int32,
                           device=dev),
                valid,
                torch.zeros(P, dtype=torch.int32, device=dev),
                torch.full((P,), NIL, dtype=torch.int32, device=dev),
                torch.full((P,), NIL, dtype=torch.int32, device=dev),
                torch.zeros(P, dtype=torch.bool, device=dev),
                torch.tensor(False, device=dev),
                self._i32(0), self._i32(1), self._i32(1))

    def summarize(self, carry) -> tuple:
        """(ok, death, overflow, max_count, att) on the host; death is the
        merged step at which the frontier emptied (-1 when alive)."""
        e, overflow, att, count, maxc = self.fetch(torch.stack(
            [carry[0], carry[8].to(torch.int32), carry[9], carry[10],
             carry[11]]))
        ok = count > 0
        return ok, (-1 if ok else e - 1), bool(overflow), maxc, att

    # -- dedup routes ----------------------------------------------------------
    # Each takes B rows of N configurations (old frontier first) and
    # returns the B F-row frontiers (masks, states, valid, new), with each
    # row's overflow and digest-mismatch flags, as tensors; the scalar
    # walk runs them on a batch of one (`_dedup`).

    def _dedup(self, masks, states, valid, origin):
        """One frontier's dedup: the batched route on a batch of one."""
        return tuple(t[0] for t in self._dedup_batch(
            masks[None], states[None], valid[None], origin))

    def _dedup_batch(self, masks, states, valid, origin):
        if self.dedup_route == DEDUP_PALLAS:
            return self._dedup_hash(masks, states, valid)
        if self.packed:
            return self._dedup_packed(masks, states, valid, origin)
        return self._dedup_lex(masks, states, valid, origin)

    def _dedup_hash(self, masks, states, valid):
        """The packed 31-bit key through the hash dedup, every row in one
        call: the distinct keys in first-seen order. Old configs sit in
        rows [0, F), so first-seen wins is the stable sort's
        old-configs-first rule. ABFT: when the count fits the frontier,
        the XOR digest of the compacted output must equal the digest of
        the table's keys."""
        F, P = self.F, self.P
        key = torch.where(valid,
                          ((states - self.s_lo) << P) | masks[:, :, 0],
                          wgl_dedup.EMPTY).contiguous()
        out, new, distinct, kdig = wgl_dedup.dedup(key, F)
        self.dedups += 1
        valid_f = out >= 0
        safe = torch.where(valid_f, out, 0)
        masks_f = (safe & ((1 << P) - 1))[:, :, None]
        states_f = (safe >> P) + self.s_lo
        if self.use_attest:
            exp = abft.wrap_i32(wgl_dedup.xor_fold(safe)
                                ^ wgl_dedup.mix_count(distinct))
            mism = ((exp != kdig) & (distinct <= F)).to(torch.int32)
        else:
            mism = torch.zeros_like(distinct)
        return masks_f, states_f, valid_f, new & valid_f, distinct > F, mism

    def _dedup_packed(self, masks, states, valid, origin):
        """One stable sort along each row of key = invalid<<31 |
        (state-s_lo)<<P | mask, as the uint32 it is in the JAX kernel
        (held in int64)."""
        F, P = self.F, self.P
        i64 = torch.int64
        key = (torch.where(valid, 0, 1 << 31)
               | (((states.to(i64) - self.s_lo) & _M32) << P) & _M32
               | (masks[:, :, 0].to(i64) & _M32))
        key_s, perm = torch.sort(key, dim=1, stable=True)
        valid_s = ((key_s >> 31) == 0) & _neq_prev(key_s)
        head = key_s[:, :F]
        masks_f = (head & ((1 << P) - 1)).to(torch.int32)[:, :, None]
        states_f = ((head >> P) & ((1 << self.sb_bits) - 1)) \
            .to(torch.int32) + self.s_lo
        valid_f = valid_s[:, :F]
        return (masks_f, states_f, valid_f, valid_f & origin[perm[:, :F]],
                valid_s[:, F:].any(1),
                torch.zeros(len(key), dtype=torch.int32, device=self.device))

    def _dedup_lex(self, masks, states, valid, origin):
        """Stable lexicographic sort of each row by (invalid, mask words
        as unsigned, state as signed), as chained stable sorts from the
        least significant key up, each key gathered by the row's
        permutation so far; the first row of each run of equal keys wins,
        so an old config beats an equal candidate."""
        F, W = self.F, self.W
        i64 = torch.int64
        B, N = states.shape
        words = masks.to(i64) & _M32                             # (B, N, W)
        inv = (~valid).to(i64)
        # (invalid, word 0) fit one 33-bit key; the rest sort alone
        keys = [(inv << 32) | words[:, :, 0]] + \
            [words[:, :, w] for w in range(1, W)] + [states.to(i64)]
        perm = torch.arange(N, device=self.device).expand(B, N)
        for k in reversed(keys):
            order = torch.sort(k.gather(1, perm), dim=1, stable=True)[1]
            perm = perm.gather(1, order)
        first = _neq_prev(keys[-1].gather(1, perm))
        for k in keys[:-1]:
            first |= _neq_prev(k.gather(1, perm))
        valid_s = valid.gather(1, perm) & first
        head = perm[:, :F]
        valid_f = valid_s[:, :F]
        return (masks.gather(1, head[:, :, None].expand(B, F, W)),
                states.gather(1, head), valid_f, valid_f & origin[head],
                valid_s[:, F:].any(1),
                torch.zeros(B, dtype=torch.int32, device=self.device))

    # -- the walk --------------------------------------------------------------
    def _expand(self, masks, states, valid, new, slots, occ, overflow, att):
        """Stage B: close the frontier under linearization, expanding
        only the configurations the last round added. One host read per
        round ("any legal candidate?", with the live count); the read
        that finds none ends the stage and gives the step's count. A
        round whose dedup adds nothing leaves no legal candidate for the
        next, so that read also ends the stage, as the JAX loop's
        converged flag does."""
        F, P, W = self.F, self.P, self.W
        bitmat = self._bitmat
        i32 = torch.int32
        while True:
            legal, cstate = self.step(states[:, None], slots[0][None, :],
                                      slots[1][None, :], slots[2][None, :])
            already = ((masks[:, None, :] & bitmat[None]) != 0).any(-1)
            legal = legal & (valid & new)[:, None] & occ[None, :] & ~already
            any_legal, count = self.fetch(torch.stack(
                [legal.any().to(i32), valid.sum(dtype=i32)]))
            if not any_legal:
                return masks, states, valid, overflow, att, count
            cmasks = (masks[:, None, :] | bitmat[None]).reshape(F * P, W)
            masks, states, valid, new, ovf, mism = self._dedup(
                torch.cat([masks, cmasks]),
                torch.cat([states, cstate.reshape(F * P)]),
                torch.cat([valid, legal.reshape(F * P)]), self._origin_b)
            overflow = overflow | ovf
            att = att + mism
            self.rounds += 1

    def run_range(self, xs: Staged, stop: int, carry) -> tuple:
        """Walk steps [carry.e, stop) while the frontier is nonempty; a
        dead carry's e is death + 1, as the JAX while_loop leaves it."""
        e, count = self.fetch(torch.stack([carry[0], carry[10]]))
        if e >= stop or count <= 0:
            return carry
        i32 = torch.int32
        W, bitmat = self.W, self._bitmat
        (_e, masks, states, valid, slot_f, slot_a, slot_b, occ, overflow,
         att, count_t, maxc) = carry
        # fresh copies, updated in place below: the caller's carry stays
        slots = torch.stack([slot_f, slot_a, slot_b])           # (3, P)
        occ = occ.clone()
        x, xd = xs.host, xs.dev
        while e < stop and count > 0 and not self._cancelled():
            s = int(x[e, W])
            if x[e, :W].any():
                # completion: survivors linearized every returned op;
                # clearing the bits keeps distinct configs distinct, so
                # no dedup. rm == 0 is a no-op, so it is skipped.
                rm = xd[e, :W]
                valid = valid & ((masks & rm) == rm).all(1)
                masks = masks & ~rm
                occ &= ~((bitmat & rm) != 0).any(1)
            if s >= 0:
                fab = xd[e, W + 1:W + 4]
                slots[:, s] = fab
                occ[s] = True
                # stage A: linearize just the new op
                legal, nstate = self.step(states, fab[0], fab[1], fab[2])
                bv = bitmat[s]
                cvalid = valid & legal & ~((masks & bv) != 0).any(1)
                masks, states, valid, new, ovf, mism = self._dedup(
                    torch.cat([masks, masks | bv]),
                    torch.cat([states, nstate]),
                    torch.cat([valid, cvalid]), self._origin_a)
                overflow = overflow | ovf
                att = att + mism
                masks, states, valid, overflow, att, count = self._expand(
                    masks, states, valid, new, slots, occ, overflow, att)
            count_t = valid.sum(dtype=i32)
            if s < 0:
                count = self.fetch(count_t)
            if self.use_attest:
                # ABFT frontier invariant: a valid configuration holds
                # pending bits of occupied slots only
                occw = torch.where(occ[:, None], bitmat, 0).sum(0, dtype=i32)
                bad = valid & ((masks & ~occw) != 0).any(1)
                att = att + bad.sum(dtype=i32)
            maxc = torch.maximum(maxc, count_t)
            e += 1
        return (self._i32(e), masks, states, valid, slots[0], slots[1],
                slots[2], occ, overflow, att, count_t, maxc)

    check_chunk = run_range

    # -- the batched walk (jax.vmap of run_range) --------------------------
    def _summary_row(self, carry):
        return [carry[0], carry[10], carry[11], carry[9],
                carry[8].to(torch.int32)]

    def _expand_batch(self, masks, states, valid, new, slots, occ,
                      overflow, att, going: np.ndarray):
        """Stage B for the keys in `going` (the invoking keys): one host
        read per round of each key's "any legal candidate?" and count;
        a key with none leaves the stage and is frozen from then on, and
        the stage runs while any key has one. Returns the frontier and
        each key's count on the host."""
        F, P, W = self.F, self.P, self.W
        B = states.shape[0]
        bitmat = self._bitmat
        i32 = torch.int32
        while True:
            legal, cstate = self.step(states[:, :, None],
                                      slots[0][:, None, :],
                                      slots[1][:, None, :],
                                      slots[2][:, None, :])    # (B, F, P)
            already = ((masks[:, :, None, :] & bitmat[None, None])
                       != 0).any(-1)
            legal = legal & (valid & new)[:, :, None] & occ[:, None, :] \
                & ~already
            any_legal, count = (np.asarray(v) for v in self.fetch(
                torch.stack([legal.any((1, 2)).to(i32),
                             valid.sum(1, dtype=i32)])))
            going = going & (any_legal != 0)
            if not going.any():
                return masks, states, valid, overflow, att, count
            g = _h2d(going, self.device)
            cmasks = (masks[:, :, None, :] | bitmat[None, None]) \
                .reshape(B, F * P, W)
            m2, s2, v2, n2, ovf, mism = self._dedup_batch(
                torch.cat([masks, cmasks], 1),
                torch.cat([states, cstate.reshape(B, F * P)], 1),
                torch.cat([valid, (legal & g[:, None, None])
                           .reshape(B, F * P)], 1), self._origin_b)
            masks = torch.where(g[:, None, None], m2, masks)
            states = torch.where(g[:, None], s2, states)
            valid = torch.where(g[:, None], v2, valid)
            new = n2 & g[:, None]
            overflow = overflow | (ovf & g)
            att = att + torch.where(g, mism, 0)
            self.rounds += 1

    def run_range_batch(self, xs: Staged, stops, carry) -> tuple:
        """Walk each key b's steps [e_b, stops[b]) while its frontier is
        nonempty, all keys in lockstep: per step one gather of each
        key's row, the completion for the keys that complete, and stage
        A and B for the keys that invoke, each dedup one batched call.
        xs holds a (B, T, W+4) step matrix."""
        start = self._walk_start(carry, stops, 10)
        if start is None:
            return carry
        e_h, alive, stops = start
        i32 = torch.int32
        W, bitmat, dev = self.W, self._bitmat, self.device
        B = len(e_h)
        (_e, masks, states, valid, slot_f, slot_a, slot_b, occ, overflow,
         att, count, maxc) = carry
        slots = torch.stack([slot_f, slot_a, slot_b])           # (3, B, P)
        parange = torch.arange(self.P, device=dev)[None, :]
        while True:
            act_h = (e_h < stops) & alive
            if not act_h.any():
                break
            row_h, row = self._step_rows(xs, e_h)
            act = _h2d(act_h, dev)
            if (act_h & row_h[:, :W].any(1)).any():
                rm = torch.where(act[:, None], row[:, :W], 0)[:, None, :]
                valid = valid & ((masks & rm) == rm).all(2)
                masks = masks & ~rm
                occ = occ & ~((bitmat[None] & rm) != 0).any(2)
            inv_h = act_h & (row_h[:, W] >= 0)
            if inv_h.any():
                inv = _h2d(inv_h, dev)
                s = torch.where(inv, row[:, W], 0).to(torch.int64)
                fab = row[:, W + 1:W + 4]                        # (B, 3)
                onehot = (parange == s[:, None]) & inv[:, None]  # (B, P)
                slots = torch.where(onehot[None], fab.T[:, :, None], slots)
                occ = occ | onehot
                # stage A: linearize just the new op
                legal, nstate = self.step(states, fab[:, 0:1], fab[:, 1:2],
                                          fab[:, 2:3])
                bv = bitmat[s][:, None, :]                       # (B, 1, W)
                cvalid = valid & legal & ~((masks & bv) != 0).any(2) \
                    & inv[:, None]
                m2, s2, v2, new, ovf, mism = self._dedup_batch(
                    torch.cat([masks, masks | bv], 1),
                    torch.cat([states, nstate], 1),
                    torch.cat([valid, cvalid], 1), self._origin_a)
                masks = torch.where(inv[:, None, None], m2, masks)
                states = torch.where(inv[:, None], s2, states)
                valid = torch.where(inv[:, None], v2, valid)
                overflow = overflow | (ovf & inv)
                att = att + torch.where(inv, mism, 0)
                masks, states, valid, overflow, att, cnt_h = \
                    self._expand_batch(masks, states, valid, new & inv[:, None],
                                       slots, occ, overflow, att, inv_h)
                count_t = valid.sum(1, dtype=i32)
            else:
                count_t = valid.sum(1, dtype=i32)
                cnt_h = np.asarray(self.fetch(count_t))
            if self.use_attest:
                occw = torch.where(occ[:, :, None], bitmat[None], 0) \
                    .sum(1, dtype=i32)                            # (B, W)
                bad = valid & ((masks & ~occw[:, None, :]) != 0).any(2)
                att = att + torch.where(act, bad.sum(1, dtype=i32), 0)
            count = torch.where(act, count_t, count)
            maxc = torch.where(act, torch.maximum(maxc, count_t), maxc)
            e_h = e_h + act_h
            alive = cnt_h > 0
        return (_h2d(e_h.astype(np.int32), dev), masks, states, valid,
                slots[0], slots[1], slots[2], occ, overflow, att, count,
                maxc)

    check_chunk_batch = run_range_batch


def _dense_shape(srange: tuple[int, int],
                 p_exact: int) -> tuple[int, int, int] | None:
    """(s_lo, S_bucketed, P_exact) if the dense table fits the caps,
    else None. S is bucketed to a power of two; the padding rows are
    unreachable states and never become true."""
    lo, hi = srange
    S = hi - lo + 1
    if S > DENSE_STATE_CAP:
        return None
    S = _bucket(S, lo=4)
    if S * (1 << p_exact) <= DENSE_TABLE_CAP:
        return lo, S, p_exact
    return None


# ---------------------------------------------------------------------------
# Engine cost model: the JAX package's, resolved as on its accelerator
# (the hash dedup on wherever its gate admits the shape; no calibration)
# ---------------------------------------------------------------------------

MXU_ADVANTAGE = 256     # batched-matmul element-ops per VPU-op
CLOSURE_ROUNDS = 2      # typical stage-B fixpoint depth per invoke
HASH_PROBE_COST = 6     # serial probe+claim cost per candidate key
DENSE_EXACT_BIAS = 8.0  # prefer dense until its modeled cost exceeds the
#                         sort family's by this factor
MAX_SLOTS = 256         # past this the device path hands over to the host

# dedup route names, the JAX package's result vocabulary (module doc)
DEDUP_PALLAS = "pallas-hash"   # the hash dedup: K2 on CUDA
DEDUP_SORT = "xla-sort"        # a stable sort (packed key or lexicographic)
DEDUP_NONE = "dense-table"     # the dense family has no dedup at all


def _pack_params(state_range: tuple[int, int] | None,
                 P: int) -> tuple[int, int] | None:
    """(s_lo, sb_bits) when a config (invalid flag, biased state, P-bit
    mask) packs into one 32-bit word, else None."""
    if state_range is None or P > 32:
        return None
    s_lo = state_range[0]
    sb_bits = (state_range[1] - state_range[0] + 1).bit_length()
    if P + sb_bits + 1 > 32:
        return None
    return s_lo, sb_bits


def _hash_gate(F: int, P: int, pack: tuple[int, int] | None) -> bool:
    """The one gate for the hash dedup: a packed config in one mask word
    and the JAX package's capacity gate (`wgl_dedup.eligible`). Shared
    by the kernel choice and every reporting site, so the "dedup"
    stamped in a result is the route that ran."""
    if pack is None or (P + 31) // 32 > 1:
        return False
    return wgl_dedup.eligible(F, P)


def dedup_engine(F: int, P: int, pack: tuple[int, int] | None) -> str:
    """The dedup route the sort family runs at this shape."""
    return DEDUP_PALLAS if _hash_gate(F, P, pack) else DEDUP_SORT


@dataclasses.dataclass(frozen=True)
class EngineDecision:
    """A resolved engine choice for one history shape."""
    family: str                 # 'dense' | 'sort'
    dense: tuple | None         # (s_lo, S, P) when family == 'dense'
    dedup: str                  # DEDUP_* (sort family's dedup engine)
    reason: str
    costs: dict                 # modeled per-history element-ops
    # measured device-seconds of the compared variants, when a trusted
    # calibration priced the comparison (None: modeled element-ops)
    seconds: dict | None = None


def engine_variant(dec: EngineDecision) -> str:
    """The variant a decision runs: 'dense', or the sort family at its
    resolved dedup route ('hash' for the hash dedup, K2; 'sort' for the
    stable sorts) — the JAX package's calibration vocabulary."""
    if dec.family == "dense":
        return "dense"
    return "hash" if dec.dedup == DEDUP_PALLAS else "sort"


def engine_cost(dec: EngineDecision) -> float:
    """The chosen engine's modeled element-ops: the one place the
    family/dedup -> costs-key mapping lives (the screen's escalation
    pricing reads it)."""
    return float(dec.costs.get(engine_variant(dec)) or 0.0)


def _family_costs(S: int, p_dense: int, p_sort: int, F: int,
                  n_events: int) -> dict:
    """Modeled total element-ops per engine variant for a history of
    n_events over S states and an F frontier; each family is priced at
    the slot count its engine runs (exact P for dense, bucketed for
    sort)."""
    n = max(int(n_events), 1)
    C = 1 << min(p_dense, 31)
    K = F * (1 + p_sort)                  # stage-B dedup candidates
    W = max(1, (p_sort + 31) // 32)
    dense = n * CLOSURE_ROUNDS * (p_dense * S * S * C / MXU_ADVANTAGE
                                  + S * C) + S * C
    srt = n * (W + 2) * K * max(np.log2(K), 1.0)
    hsh = n * HASH_PROBE_COST * K
    return {"dense": dense, "sort": srt, "hash": hsh}


def _dense_caps_error(srange, p: int, key=None) -> ValueError:
    """The forced-dense contract violation (one message, three raise
    sites: scalar, batch plain path, batch group split)."""
    who = f"key {key}'s" if key is not None else "the"
    return ValueError(
        f"dense engine requested but {who} {srange} state range x "
        f"2^{p} table exceeds the dense caps")


def select_engine(srange: tuple[int, int], p_exact: int, n_events: int,
                  *, slots: int | None = None, frontier: int = 256,
                  engine: str = "auto",
                  dense_slot_cap: int | None = None,
                  calibration=None) -> EngineDecision:
    """Pick the engine family for one history shape, by the JAX
    package's cost model as it resolves on its accelerator: the sort
    family is priced at the dedup it will run (the hash dedup where
    `_hash_gate` admits the shape). The result is the JAX package's
    `select_engine(..., pallas=True)` given the same calibration.
    engine='dense'/'sort' force a family ('dense' raises when the table
    cannot fit); dense_slot_cap bounds the slot count 'auto' lets the
    dense table absorb.

    calibration: a `jepsen_tpu_torch.calibrate.Calibration` (None = the
    process-wide active one, usually nothing). When it holds trusted
    measured coefficients for BOTH compared variants, the dense-vs-sort
    comparison runs in measured device-seconds instead of modeled
    element-ops, with the same DENSE_EXACT_BIAS preference for exact
    verdicts."""
    if engine not in ("auto", "dense", "sort"):
        raise ValueError(f"unknown WGL engine {engine!r}")
    if slots is None:
        slots = _bucket(p_exact, lo=8)
    S = _bucket(srange[1] - srange[0] + 1, lo=4)
    costs = _family_costs(S, p_exact, slots, frontier, n_events)
    dedup = dedup_engine(frontier, slots, _pack_params(srange, slots))
    sort_variant = "hash" if dedup == DEDUP_PALLAS else "sort"
    sort_cost = costs[sort_variant]
    cal = calibration if calibration is not None \
        else _calibrate.active()
    seconds = None
    if cal is not None and cal.ready("dense", sort_variant):
        seconds = {
            "dense": cal.seconds("dense", costs["dense"]),
            sort_variant: cal.seconds(sort_variant, sort_cost)}
    dense = None
    if engine in ("auto", "dense"):
        if dense_slot_cap is not None and p_exact > dense_slot_cap:
            if engine == "dense":
                raise ValueError(
                    f"dense engine requested but the history needs "
                    f"{p_exact} slots, over dense_slot_cap="
                    f"{dense_slot_cap}")
            return EngineDecision(
                "sort", None, dedup,
                f"p={p_exact} over dense_slot_cap={dense_slot_cap}", costs)
        dense = _dense_shape(srange, p_exact)
        if dense is None and engine == "dense":
            raise _dense_caps_error(srange, p_exact)
    if engine == "sort" or dense is None:
        why = ("forced" if engine == "sort"
               else f"S={S} x 2^{p_exact} exceeds the dense caps")
        return EngineDecision("sort", None, dedup, why, costs, seconds)
    if seconds is not None:
        # measured comparison: same exactness bias, ground-truth units
        dense_v, sort_v = seconds["dense"], seconds[sort_variant]
        if engine == "dense" or dense_v <= DENSE_EXACT_BIAS * sort_v:
            why = ("forced" if engine == "dense" else
                   f"measured dense {dense_v:.3g}s <= "
                   f"{DENSE_EXACT_BIAS:g}x {dedup} {sort_v:.3g}s")
            return EngineDecision("dense", dense, DEDUP_NONE, why, costs,
                                  seconds)
        return EngineDecision(
            "sort", None, dedup,
            f"measured dense {dense_v:.3g}s > {DENSE_EXACT_BIAS:g}x "
            f"{dedup} {sort_v:.3g}s", costs, seconds)
    if engine == "dense" or \
            costs["dense"] <= DENSE_EXACT_BIAS * sort_cost:
        why = ("forced" if engine == "dense" else
               f"dense {costs['dense']:.3g} <= {DENSE_EXACT_BIAS:g}x "
               f"{dedup} {sort_cost:.3g}")
        return EngineDecision("dense", dense, DEDUP_NONE, why, costs)
    return EngineDecision(
        "sort", None, dedup,
        f"dense {costs['dense']:.3g} > {DENSE_EXACT_BIAS:g}x "
        f"{dedup} {sort_cost:.3g}", costs)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def encode_ops_for_model(model, hist) -> OpArray:
    """Encode a history with the model's value codec, honoring the model's
    rules about which pending ops are droppable. Raises ValueError when
    the history exceeds the device encoding."""
    name = model.device_model
    if name is None or name not in DEVICE_MODELS:
        raise ValueError(f"model {model!r} has no device form")
    dm = DEVICE_MODELS[name]
    try:
        ops = encode_ops(as_history(hist), dm.codec, dm.droppable)
    except OverflowError as e:   # value outside int32
        raise DeviceEncodingError(str(e)) from e
    if dm.validate is not None:
        dm.validate(ops, model)
    return ops


def _state_range(name: str, model, entries_list) -> tuple[int, int]:
    """Combined inclusive state bounds over a batch of entry streams."""
    lo = hi = int(model.device_state())
    rng = DEVICE_MODELS[name].state_range
    for e in entries_list:
        l2, h2 = rng(int(model.device_state()), e.f, e.a, e.b)
        lo, hi = min(lo, l2), max(hi, h2)
    return int(lo), int(hi)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A history encoded and its engine picked. decision is None past
    MAX_SLOTS, where the device path hands the history to the host;
    slots is the count the engine runs (exact P for the dense table,
    bucketed for the sort frontier)."""
    model_name: str
    ops: OpArray
    decision: EngineDecision | None
    slots: int
    srange: tuple[int, int] | None

    @property
    def pack(self) -> tuple[int, int] | None:
        return _pack_params(self.srange, self.slots)

    def kernel(self, device, frontier: int) -> "DenseKernel | SortKernel":
        """A fresh engine for this plan (the sort family at frontier F,
        with the dedup route `dedup_engine` picks there)."""
        if self.decision.dense is not None:
            return DenseKernel(self.model_name, *self.decision.dense, device)
        return SortKernel(self.model_name, frontier, self.slots, self.pack,
                          dedup_engine(frontier, self.slots, self.pack),
                          device)


def plan(model, hist, *, frontier: int = 256, slots: int | None = None,
         engine: str = "auto", dense_slot_cap: int | None = None) -> Plan:
    """Encode a history and pick its engine family."""
    ops = encode_ops_for_model(model, hist)
    p_exact = required_slots(ops)
    if slots is None or p_exact > slots:
        slots = _bucket(p_exact, lo=8)
    if slots > MAX_SLOTS:
        return Plan(model.device_model, ops, None, slots, None)
    srange = _state_range(model.device_model, model, [ops])
    decision = select_engine(srange, p_exact, event_count(ops),
                             slots=slots, frontier=frontier,
                             engine=engine, dense_slot_cap=dense_slot_cap)
    if decision.dense is not None:
        slots = decision.dense[2]      # exact P: the table is 2^P wide
    return Plan(model.device_model, ops, decision, slots, srange)


def _check_att(att, site: str) -> None:
    """Raise the corrupt fault when a fetched attestation accumulator
    is nonzero — a table or frontier invariant failed on device."""
    if int(att) != 0:
        raise CorruptDeviceResult(
            site, f"in-kernel attestation accumulator = {att} — a "
                  f"frontier/table invariant or dedup digest failed on "
                  f"device")


# ---------------------------------------------------------------------------
# Device-fault recovery ladder
# ---------------------------------------------------------------------------
#
# A checking entry must not lose a verdict to a transient device fault.
# The ladder classifies each fault (`_platform.classify_backend_error`)
# and re-runs the search down the fault's rung, from canonical host
# data:
#
#   oom          shrink the working set (halve chunk_entries; under
#                'auto', re-select the engine with dense_slot_cap 0, the
#                sort family); the batch entry also SPLITS the batch in
#                half and recovers each half on its own
#   device-lost  synchronize, empty PyTorch's cache and drop the kernels'
#                cached library handles, then retry. This cannot revive a
#                CUDA context after a sticky error (an illegal address,
#                ECC): such retries fail again and end on the final rung
#   wedged       a plain bounded retry (watchdog'd reads)
#   corrupt      a plain bounded retry: the retry re-stages every device
#                buffer from canonical host data
#
# and when the budget is spent, the FINAL rung reports a degraded
# 'unknown' with the fault trail. Results that went through the ladder
# carry a 'recovered' trail.
#
# Two rungs of the JAX package are left out on purpose, so that a broken
# kernel or a lost card never turns into a verdict of the plain version
# or of the host: the compile bucket has NO rung (the JAX package retries
# without its Pallas kernels; the port re-raises at once), and the final
# rung never runs the host oracle (the JAX package's decides histories of
# up to 20,000 ops there).

MAX_RECOVERY_RETRIES = 3


class _RecoveryTrail:
    """Bookkeeping for one checking entry's ladder: classify each fault,
    enforce the retry budget, back off with decorrelated jitter
    (`util.backoff`) between attempts, and stamp the 'recovered' trail on
    the eventual result. Exceptions the classifier rejects, and compile
    faults, re-raise at once."""

    def __init__(self, max_retries: int | None = None):
        self.max = (MAX_RECOVERY_RETRIES if max_retries is None
                    else max(0, int(max_retries)))
        self.faults: list[str] = []
        self._delays = None

    def absorb(self, exc: BaseException, site: str) -> bool:
        """Record exc's bucket; True when another retry is allowed (after
        the backoff sleep), False when the budget is spent and the caller
        must take the final rung."""
        kind = classify_backend_error(exc)
        if kind is None or kind == FAULT_COMPILE:
            raise exc
        self.faults.append(kind)
        if len(self.faults) > self.max:
            log.warning("%s: %s fault after %d recovery retries; taking "
                        "the final rung (%s)", site, kind, self.max, exc)
            return False
        if self._delays is None:
            self._delays = util.backoff()
        delay = next(self._delays)
        log.warning("%s: %s fault (%s); recovering, retry %d/%d in %.2fs",
                    site, kind, exc, len(self.faults), self.max, delay)
        _time.sleep(delay)
        return True

    def stamp(self, result) -> None:
        """Mark a decided result as recovered (no-op when the entry never
        faulted)."""
        if self.faults and isinstance(result, dict):
            result["recovered"] = {"faults": list(self.faults),
                                   "retries": len(self.faults)}


def _apply_recovery_rung(kind: str, kw: dict) -> None:
    """Mutate a retry's kwargs per the fault bucket (only the knobs the
    entry accepts: `kw` is the exact kwargs of the next attempt)."""
    if kind == FAULT_OOM:
        if "chunk_entries" in kw:
            kw["chunk_entries"] = max(
                256, int(kw["chunk_entries"] or 4096) // 2)
        if kw.get("engine") != "dense":
            # cap 0 routes the retry to the sort family (the dense table
            # is the memory hog); a forced 'dense' keeps its contract
            kw["dense_slot_cap"] = 0
    elif kind == FAULT_DEVICE_LOST:
        _device_reinit()
    # corrupt and wedged: a plain retry, which re-stages from the host


def _device_reinit() -> None:
    """The device-lost rung: wait for the card, return PyTorch's cached
    blocks and drop the kernels' cached library handles, so the retry
    reloads them. Best effort: after a sticky CUDA error the calls here
    fail too, and the retry will fault again."""
    from . import wgl_closure
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    except Exception:  # noqa: BLE001 — reinit is best effort by design
        pass
    wgl_closure._kernel.cache_clear()
    wgl_dedup._kernel.cache_clear()
    from .. import _build
    _build.library.cache_clear()


def _final_rung(hist, trail: _RecoveryTrail, exc: BaseException) -> dict:
    """The ladder's last rung: a degraded 'unknown' with the fault trail.
    The device could not decide the history, and nothing else decides it
    in the device's place."""
    return {
        "valid?": "unknown", "analyzer": "gpu-wgl", "degraded": True,
        "op-count": len(as_history(hist)),
        "error": (f"device faults exhausted the recovery budget (trail: "
                  f"{trail.faults}); last fault: {exc}"),
        "recovery-failed": {"faults": list(trail.faults),
                            "retries": trail.max},
        "configs": [], "final-paths": [],
    }


def analysis_gpu(model, hist, *, device=None, frontier: int = 256,
                 slots: int | None = None, max_frontier: int = 65536,
                 chunk_entries: int = 4096, budget_s: float | None = None,
                 cancel=None, explain: bool = True,
                 slot_overflow_fallback: bool = True, engine: str = "auto",
                 dense_slot_cap: int | None = None,
                 max_recovery_retries: int | None = None) -> dict:
    """Check one history on the GPU (counterpart of the JAX package's
    `analysis_tpu`), under the recovery ladder above: a classified device
    fault re-runs the search down its rung, and a result that went
    through the ladder carries its 'recovered' trail.
    max_recovery_retries bounds the ladder (None = MAX_RECOVERY_RETRIES);
    past it the result is a degraded 'unknown' with the fault trail. See
    `_analysis_gpu_once` for the search and the other options."""
    kw = dict(device=device, frontier=frontier, slots=slots,
              max_frontier=max_frontier, chunk_entries=chunk_entries,
              budget_s=budget_s, cancel=cancel, explain=explain,
              slot_overflow_fallback=slot_overflow_fallback, engine=engine,
              dense_slot_cap=dense_slot_cap)
    trail = _RecoveryTrail(max_recovery_retries)
    while True:
        try:
            a = _analysis_gpu_once(model, hist, **kw)
        except RuntimeError as e:
            if not trail.absorb(e, "offline"):
                return _final_rung(hist, trail, e)
            _apply_recovery_rung(trail.faults[-1], kw)
            continue
        trail.stamp(a)
        return a


def _analysis_gpu_once(model, hist, *, device=None, frontier: int = 256,
                       slots: int | None = None, max_frontier: int = 65536,
                       chunk_entries: int = 4096,
                       budget_s: float | None = None, cancel=None,
                       explain: bool = True,
                       slot_overflow_fallback: bool = True,
                       engine: str = "auto",
                       dense_slot_cap: int | None = None) -> dict:
    """Check one history on the GPU: one attempt, which the ladder
    (`analysis_gpu`) re-runs after a classified fault.

    device: 'cuda' by default, where every dense walk runs K3 and every
    hash dedup K2; 'cpu' runs their plain PyTorch versions.

    engine: 'auto' picks the dense or the sort family by the cost model
    (`select_engine`); 'dense' / 'sort' force one. The sort family
    starts at `frontier` configurations and, when a search dies after
    dropping configurations (overflow), runs again at 4x the frontier up
    to max_frontier. Past MAX_SLOTS slots the history goes to the host
    oracle (analyzer "host-jit-linear (slot overflow)"), or, with
    slot_overflow_fallback=False, comes back 'unknown'.

    Histories that fit one chunk run as one walk; longer ones run as
    chunk_entries-step chunks with the carry between them, the host
    reading each chunk's liveness one chunk late. budget_s caps wall
    time across passes (past it an undecided search is 'unknown');
    cancel is polled before every step of the walk. explain: on an invalid verdict,
    re-run the host oracle on the prefix ending at the culprit op for
    configs and final-paths.

    With attestation on (JEPSEN_TPU_ATTEST, default on) the staged step
    buffer's device digest is checked against the host's, and a chunked
    search's final carry against its device digest and invariants. The
    staged buffer passes `maybe_corrupt("offline", ...)` before it is
    copied to the card, and each dispatch `maybe_inject_fault("offline")`
    (the JAX package's injection sites)."""
    t0 = _time.monotonic()
    dev = resolve_device(device)
    pl = plan(model, hist, frontier=frontier, slots=slots, engine=engine,
              dense_slot_cap=dense_slot_cap)
    if pl.decision is None:
        if not slot_overflow_fallback:
            return {"valid?": "unknown", "analyzer": "gpu-wgl",
                    "error": f"slot overflow ({pl.slots} slots needed)"}
        from .linear import analysis_host
        a = analysis_host(model, hist, budget_s=budget_s, cancel=cancel)
        a["analyzer"] = "host-jit-linear (slot overflow)"
        return a
    ops, decision, dense = pl.ops, pl.decision, pl.decision.dense
    steps = build_steps(ops, pl.slots)
    # the staged copy may carry an injected bit flip; the digest of the
    # canonical steps.x catches it before the walk
    xs = stage_steps(maybe_corrupt("offline", steps.x), dev)
    F = frontier
    k = pl.kernel(dev, F)
    k.cancel = cancel
    kernels = [k]
    att_info = None
    if attest_enabled():
        abft.verify_steps("offline", k.fetch(abft.digest_device(xs.dev),
                                             site="offline attest"),
                          abft.digest_host(steps.x))
        att_info = {"steps": 1, "carry": 0}
    init_state = int(model.device_state())
    timed_out = cancelled = False
    while True:
        if steps.n <= chunk_entries:
            maybe_inject_fault("offline")
            ok, death, overflow, max_count, att = k.check(xs, steps.n,
                                                          init_state)
            _check_att(att, "offline")
            timed_out = cancelled = k.interrupted
        else:
            carry = k.init_carry(init_state)
            e = 0
            # measured-cost-model feed: modeled element-ops per step
            # entry, so each chunk's latency pairs with its share of the
            # decision's modeled cost (both linear in entries)
            cal_ops_per_entry = engine_cost(decision) / max(steps.n, 1)
            chunk_i = 0
            while e < steps.n:
                e0 = e
                stop = min(e + chunk_entries, steps.n)
                maybe_inject_fault("offline")
                t_chunk = _time.monotonic()
                prev, carry = carry, k.check_chunk(xs, stop, carry)
                e = stop
                if k.interrupted:
                    timed_out = cancelled = True
                    break
                dead = k.fetch(prev[-2]) == 0
                if chunk_i >= 2:
                    # the walk reads the host every round, so dt is this
                    # chunk's own; chunks 0 and 1 stay out of the fit,
                    # as at the JAX package's site (chunk 0 pays the
                    # library load and the allocator's warm-up)
                    _calibrate.observe(engine_variant(decision),
                                       cal_ops_per_entry * (stop - e0),
                                       _time.monotonic() - t_chunk)
                chunk_i += 1
                if dead:
                    carry = prev   # it died last chunk: definite
                    break
                # only give up when chunks remain — a search that just
                # finished is definitive regardless of elapsed time
                if e < steps.n:
                    over = budget_s is not None and \
                        _time.monotonic() - t0 > budget_s
                    stop_req = cancel is not None and cancel()
                    if over or stop_req:
                        if k.fetch(carry[-2]) == 0:
                            break
                        timed_out = True
                        cancelled = stop_req and not over
                        break
            if att_info is not None:
                # chunk-boundary carry attestation: fetch the carry and
                # its device digest, recompute on the host, check
                # att == 0 and count == the live population
                digest = k.fetch(k.digest(carry))
                abft.verify_carry("offline", digest, k.fetch_carry(carry))
                att_info["carry"] += 1
            ok, death, overflow, max_count, att = k.summarize(carry)
            _check_att(att, "offline")
        ok = ok and not timed_out
        overflow = overflow or timed_out
        if ok or not overflow or F >= max_frontier or timed_out:
            break
        over = budget_s is not None and _time.monotonic() - t0 > budget_s
        if over or (cancel is not None and cancel()):
            timed_out = True
            cancelled = not over
            break
        F *= 4   # invalid + overflow: the witness may have been dropped
        k = pl.kernel(dev, F)
        k.cancel = cancel
        kernels.append(k)
    out = {
        "valid?": True if ok else "unknown" if overflow else False,
        "analyzer": "gpu-wgl-dense" if dense is not None else "gpu-wgl",
        # the route the FINAL pass ran (escalation can move it)
        "dedup": (DEDUP_NONE if dense is not None else
                  dedup_engine(F, pl.slots, pl.pack)),
        "engine-reason": decision.reason,
        "op-count": len(ops),
        "max-frontier": int(max_count),
        "frontier-size": F,
        "duration-ms": (_time.monotonic() - t0) * 1e3,
        "configs": [],
        "final-paths": [],
        "device": str(dev),
    }
    if dense is not None:
        out["dense-shape"] = list(dense)        # [s_lo, S, P]
    if att_info is not None:
        out["attested"] = att_info
    if not ok:
        if cancelled:
            out["error"] = "search cancelled"
        elif timed_out:
            out["error"] = (f"search exceeded the {budget_s} s budget at "
                            f"frontier {F}; verdict unknown")
        elif overflow:
            # the death point is an artifact of dropped configs: no
            # culprit op for an 'unknown' verdict
            out["error"] = (f"frontier overflowed at {F} configs; verdict "
                            f"unknown (re-run with a larger frontier or "
                            f"the host checker)")
        else:
            # the merged stream can't name a single culprit op: re-run
            # the unmerged stream, which dies at the same event
            row = _death_row(k, ops, pl.slots, init_state)
            if row >= 0:
                src_index = int(ops.index[row])
                out["op"] = _find_op(hist, src_index)
                out["op-index"] = src_index
                if explain:
                    from .linear import explain_failure
                    ex = explain_failure(model, hist, src_index)
                    if ex is not None:
                        out["configs"] = ex["configs"]
                        out["final-paths"] = ex["final-paths"]
                        if ex.get("previous-ok") is not None:
                            out["previous-ok"] = ex["previous-ok"]
    out["closure-rounds"] = sum(k.rounds for k in kernels)
    out["dedup-launches"] = sum(k.dedups for k in kernels)
    out["host-syncs"] = sum(k.syncs for k in kernels)
    return out


def _death_row(k: _Engine, ops: OpArray, slots: int,
               init_state: int) -> int:
    """Op row where the search died, from an unmerged re-run."""
    steps = build_steps(ops, slots, merge=False)
    ok, death, *_ = k.check(stage_steps(steps.x, k.device), steps.n,
                            init_state)
    if ok or death < 0:
        return -1
    row = int(steps.inv_row[death])
    return row if row >= 0 else int(steps.ret_row[death])


def _find_op(hist, index: int):
    """The completion op for the invocation with the given :index (the
    completion carries the observed value; knossos reports it too)."""
    hist = as_history(hist)
    if hist.ops and "index" not in hist.ops[0]:
        hist = hist.index()
    for pos, o in enumerate(hist.ops):
        if o.get("index") == index:
            comp = hist.completion(pos)
            return comp if comp is not None else o
    return None


# ---------------------------------------------------------------------------
# Batched keys: many independent histories in lockstep walks
# ---------------------------------------------------------------------------

def _slot_bucket(p: int, p_max: int | None = None) -> int:
    """Bucket a slot count UP to the next even P so nearby keys share one
    dense group, floored at 4 and capped at the batch's true max (the
    cap itself respects the floor, so a batch of tiny keys coalesces
    into one P = 4 group)."""
    pg = max(4, ((p + 1) // 2) * 2)
    return min(pg, max(p_max, 4)) if p_max is not None else pg


def _unknown_result(ops, error: str, t0: float) -> dict:
    """The batch paths' 'unknown' verdict shape."""
    return {"valid?": "unknown", "analyzer": "gpu-wgl-batch",
            "op-count": len(ops), "error": error,
            "configs": [], "final-paths": [],
            "duration-ms": (_time.monotonic() - t0) * 1e3}


def _dispatch_groups(srange, p_req: list[int], engine: str,
                     n_events: int = 1, frontier: int = 1024,
                     dense_slot_cap: int | None = None):
    """Partition a batch's key indices into slot-bucketed dense groups
    plus one shared sort-family group, as the JAX package does: padding
    every key to the worst key's slot count would multiply the batch's
    dense work by 2^(Pmax - P_key). Dense-ineligible keys spill into the
    one sort group (or, under a forced dense engine, raise). Under
    'auto' the cost model can route a dense-eligible bucket to the sort
    family; n_events is the batch's largest event stream.

    Returns (dense_groups: {P: (dense_shape, [key indices])}, sort_idx:
    [key indices])."""
    if engine == "sort":
        return {}, list(range(len(p_req)))
    sort_idx: list[int] = []
    dense_groups: dict[int, tuple[tuple, list[int]]] = {}
    p_max = max(p_req)
    for i, p in enumerate(p_req):
        pg = _slot_bucket(p, p_max)
        d = _dense_shape(srange, pg) or _dense_shape(srange, p)
        if d is not None and engine == "auto":
            dec = select_engine(srange, d[2], n_events, frontier=frontier,
                                dense_slot_cap=dense_slot_cap)
            if dec.family != "dense":
                d = None
        if d is None:
            if engine == "dense":
                raise _dense_caps_error(srange, p, key=i)
            sort_idx.append(i)
        elif d[2] in dense_groups:
            dense_groups[d[2]][1].append(i)
        else:
            dense_groups[d[2]] = (d, [i])
    return dense_groups, sort_idx


def _stack_steps(steps: list[Steps], b_pad: int) -> tuple:
    """(x (B, T, W+4), n (B,)) of a list of step streams, T the longest,
    padded with no-op rows (no completion, no invoke) and with zero-step
    entries up to b_pad keys, which never walk a step."""
    w = steps[0].w
    T = max(max(st.n for st in steps), 1)
    x = np.zeros((b_pad, T, w + 4), np.int32)
    x[:, :, w] = -1                       # no invoke
    x[:, :, w + 2:] = NIL
    ns = np.zeros(b_pad, np.int64)
    for b, st in enumerate(steps):
        x[b, :st.n] = st.x[:st.n]
        ns[b] = st.n
    return x, ns


def analysis_gpu_batch(model, hists: list, *, device=None,
                       frontier: int = 1024, slots: int = 32,
                       chunk_entries: int = 4096,
                       budget_s: float | None = None, cancel=None,
                       engine: str = "auto", max_frontier: int = 65536,
                       dense_slot_cap: int | None = None,
                       max_recovery_retries: int | None = None) -> list[dict]:
    """Check a batch of independent histories (e.g. per-key subhistories
    of the independent checker) on the GPU: counterpart of the JAX
    package's `analysis_tpu_batch`, under the recovery ladder. A
    classified device fault re-runs the batch down the ladder, except
    that the OOM rung SPLITS the batch in half and recovers each half on
    its own, its trail merged into each half's results; past the retry
    budget each history ends on `_final_rung`. See
    `_analysis_gpu_batch_once` for the batching."""
    return _batch_group(model, hists, None, False, None, device=device,
                        frontier=frontier, slots=slots,
                        chunk_entries=chunk_entries, budget_s=budget_s,
                        cancel=cancel, engine=engine,
                        max_frontier=max_frontier,
                        dense_slot_cap=dense_slot_cap,
                        max_recovery_retries=max_recovery_retries)


def _batch_group(model, hists: list, pre, dense, preq, *,
                 max_recovery_retries: int | None = None, **kw) -> list[dict]:
    """The ladder around one batch attempt. pre, dense and preq are what
    a group split already knows of its histories (each one's encoding,
    the group's dense shape, each one's slot need), or None, False and
    None; kw are `_analysis_gpu_batch_once`'s options."""
    trail = _RecoveryTrail(max_recovery_retries)
    while True:
        try:
            rs = _analysis_gpu_batch_once(model, hists, pre, dense, preq,
                                          **kw)
        except RuntimeError as e:
            if not trail.absorb(e, "batch"):
                return [_final_rung(h, trail, e) for h in hists]
            kind = trail.faults[-1]
            if kind == FAULT_OOM and len(hists) > 1:
                mid = len(hists) // 2
                log.warning("batch: splitting %d histories into %d + %d "
                            "after OOM", len(hists), mid, len(hists) - mid)

                def half(sl):
                    return _batch_group(
                        model, hists[sl], None if pre is None else pre[sl],
                        dense, None if preq is None else preq[sl],
                        max_recovery_retries=max_recovery_retries, **kw)

                rs = half(slice(0, mid)) + half(slice(mid, None))
                for r in rs:
                    _merge_trail(r, trail)
                return rs
            _apply_recovery_rung(kind, kw)
            continue
        for r in rs:
            trail.stamp(r)
        return rs


def _merge_trail(r, trail: _RecoveryTrail) -> None:
    """Merge a split batch's trail into one half's result: never stamp
    'recovered' on a result that fell off its own ladder (its faults
    live under 'recovery-failed'), and keep the half's own markers such
    as {'split': True}."""
    if not isinstance(r, dict):
        return
    if r.get("degraded"):
        rf = r.get("recovery-failed")
        if isinstance(rf, dict):
            rf["faults"] = list(trail.faults) + list(rf.get("faults", []))
        return
    inner = r.get("recovered")
    inner = dict(inner) if isinstance(inner, dict) else {}
    faults = list(trail.faults) + list(inner.get("faults", []))
    inner.update(faults=faults, retries=len(faults), split=True)
    r["recovered"] = inner


def _analysis_gpu_batch_once(model, hists: list, _pre: list | None,
                             _dense, _preq: list | None, *, device=None,
                             frontier: int = 1024, slots: int = 32,
                             chunk_entries: int = 4096,
                             budget_s: float | None = None, cancel=None,
                             engine: str = "auto",
                             max_frontier: int = 65536,
                             dense_slot_cap: int | None = None) -> list[dict]:
    """Check a batch of independent histories in batched walks: one
    attempt, which the ladder (`_batch_group`) re-runs.

    The keys split into slot-bucketed dense groups and one sort group
    (`_dispatch_groups`), run cheapest first and the sort group last, so
    a pathological key starves only itself of budget. Each group walks
    all its keys in lockstep (`check_chunk_batch`: K3 and K2 each take
    all keys in one launch), B padded to a power of two with zero-step
    keys whose liveness is ignored, in chunks of chunk_entries steps
    with the liveness read one chunk late and budget_s / cancel polled
    between chunks (undecided keys report 'unknown'). One host read
    gives every key's verdict and whether it was decided. Definite
    invalids are blamed together in one batched walk of their unmerged
    streams; overflow suspects re-run together at 4x the frontier; a key
    needing more slots than the batch's takes the scalar entry.

    Attestation: the stacked step buffer's digest (after
    `maybe_corrupt("batch", ...)`) and each key's final carry; each
    chunk dispatch passes `maybe_inject_fault("batch")`.

    _pre, _dense, _preq: what the group split already knows (see
    `_batch_group`)."""
    t0 = _time.monotonic()
    dev = resolve_device(device)

    def _remaining():
        if budget_s is None:
            return None
        return max(0.0, budget_s - (_time.monotonic() - t0))

    def _out_of_time() -> bool:
        return _remaining() == 0.0 or (cancel is not None and cancel())

    name = model.device_model
    pre = (_pre if _pre is not None
           else [encode_ops_for_model(model, h) for h in hists])
    _srange = _p_needs = None
    if engine in ("auto", "dense") and len(hists) > 1 and _pre is None:
        p_req = [required_slots(ops) for ops in pre]
        srange_all = _state_range(name, model, pre)
        dense_groups, sort_idx = _dispatch_groups(
            srange_all, p_req, engine,
            n_events=max((event_count(o) for o in pre), default=1),
            frontier=frontier, dense_slot_cap=dense_slot_cap)
        group_list = [dense_groups[pg] for pg in sorted(dense_groups)]
        if sort_idx:
            group_list.append((False, sort_idx))
        if len(group_list) > 1:
            grouped: list[dict | None] = [None] * len(hists)
            for d, idx in group_list:
                if _out_of_time():
                    for i in idx:
                        grouped[i] = _unknown_result(
                            pre[i], "batch budget exhausted/cancelled "
                            "before this key's search started", t0)
                    continue
                sub = _batch_group(
                    model, [hists[i] for i in idx], [pre[i] for i in idx],
                    d, [p_req[i] for i in idx], device=dev,
                    frontier=frontier, slots=slots,
                    chunk_entries=chunk_entries, budget_s=_remaining(),
                    cancel=cancel, engine=engine,
                    max_frontier=max_frontier,
                    dense_slot_cap=dense_slot_cap)
                for t, i in enumerate(idx):
                    grouped[i] = sub[t]
            return grouped
        # one bucket: the plain path below, reusing the pre-pass
        if group_list and group_list[0][0] is not False:
            _dense = group_list[0][0]
        else:
            _srange, _p_needs = srange_all, dict(enumerate(p_req))

    results: list[dict | None] = [None] * len(hists)
    encoded = list(enumerate(pre))
    items = []           # (orig index, ops, steps)
    srange = None
    if encoded:
        if _dense is not False:
            dense = _dense
        else:
            srange = (_srange if _srange is not None else
                      _state_range(name, model, [o for _, o in encoded]))
            if _p_needs is not None:
                p_needs = _p_needs
            elif _preq is not None:
                p_needs = dict(enumerate(_preq))
            else:
                p_needs = {i: required_slots(o) for i, o in encoded}
            dense = None
            if engine in ("auto", "dense"):
                # decided before the budget check below, so that a
                # forced dense engine raises the same way at any budget
                dense = select_engine(
                    srange, max(p_needs.values()),
                    max((event_count(o) for _, o in encoded), default=1),
                    frontier=frontier, engine=engine,
                    dense_slot_cap=dense_slot_cap).dense
        if dense is not None:
            slots = dense[2]
        if _out_of_time():
            for i, ops in encoded:
                results[i] = _unknown_result(
                    ops, "batch budget exhausted/cancelled before this "
                    "key's search started", t0)
            encoded = []
        for i, ops in encoded:
            if dense is None and p_needs[i] > slots:
                # this key alone needs more slots than the batch has:
                # the scalar entry sizes them (and hands the history to
                # the host past MAX_SLOTS)
                results[i] = analysis_gpu(
                    model, hists[i], device=dev, frontier=frontier,
                    budget_s=_remaining(), cancel=cancel, engine=engine,
                    dense_slot_cap=dense_slot_cap)
            else:
                items.append((i, ops, build_steps(ops, slots)))
    if items and _out_of_time():
        for i, ops, _st in items:
            results[i] = _unknown_result(
                ops, "batch budget exhausted/cancelled before this key's "
                "search started", t0)
        items = []
    if items:
        _batch_walk(model, hists, items, results, dev, dense, srange,
                    slots, frontier, chunk_entries, budget_s, cancel,
                    engine, max_frontier, dense_slot_cap, t0, _remaining)
    dur = (_time.monotonic() - t0) * 1e3
    for r in results:
        if r is not None:
            r.setdefault("duration-ms", dur)
    return results  # type: ignore[return-value]


def _batch_kernel(name, dense, srange, slots, frontier, dev):
    if dense is not None:
        return DenseKernel(name, *dense, dev)
    pack = _pack_params(srange, slots)
    return SortKernel(name, frontier, slots, pack,
                      dedup_engine(frontier, slots, pack), dev)


def _batch_walk(model, hists, items, results, dev, dense, srange, slots,
                frontier, chunk_entries, budget_s, cancel, engine,
                max_frontier, dense_slot_cap, t0, _remaining):
    """The batched walk of one group's items, its verdicts, blame and
    escalation, written into results. Returns the walk's final batched
    carry."""
    name = model.device_model
    k = _batch_kernel(name, dense, srange, slots, frontier, dev)
    b_pad = _bucket(len(items), lo=1)
    x_np, ns = _stack_steps([st for _, _, st in items], b_pad)
    attest_on = attest_enabled()
    xs = stage_steps(maybe_corrupt("batch", x_np), dev)
    if attest_on:
        # the whole stacked buffer is one staged buffer, one digest
        abft.verify_steps("batch", k.fetch(abft.digest_device(xs.dev),
                                           site="batch attest"),
                          abft.digest_host(x_np))
    init = int(model.device_state())
    carry = k.init_carry_batch([init] * b_pad)
    e, n_max = 0, int(ns.max())
    n_items = len(items)
    while e < n_max:
        stop = min(e + chunk_entries, n_max)
        maybe_inject_fault("batch")
        prev, carry = carry, k.check_chunk_batch(xs, np.minimum(ns, stop),
                                                 carry)
        e = stop
        # padding keys never walk, so their tables stay alive: only the
        # real keys' liveness counts
        all_dead = not any(k.fetch(prev[-2], site="batch liveness")
                           [:n_items])
        if all_dead:
            carry = prev   # every key died last chunk: all definite
            break
        if e < n_max and (
                (budget_s is not None and _time.monotonic() - t0 > budget_s)
                or (cancel is not None and cancel())):
            break
    if attest_on:
        # per-key carry attestation at the batch's final boundary
        digests = k.fetch(k.digest_batch(carry), site="batch attest")
        host = k.fetch_carry(carry, site="batch attest")
        for b, d in enumerate(digests):
            abft.verify_carry("batch", d, tuple(a[b] for a in host))
    # one host read: verdicts, and what decides each key: it walked all
    # its steps or its table or frontier died (death is definite however
    # many steps remain)
    consumed, counts, max_count, att, overflow = k.summary_batch(carry)
    _check_att(int(att.sum()), "batch")
    ok = counts > 0
    decided = (consumed >= ns) | (counts == 0)
    batch_dedup = (DEDUP_NONE if dense is not None else
                   dedup_engine(frontier, slots, _pack_params(srange, slots)))
    suspects, invalids = [], []
    for j, (i, ops, _st) in enumerate(items):
        if not decided[j]:
            results[i] = _unknown_result(
                ops, "batch budget exhausted/cancelled before this key's "
                "search finished", t0)
        elif ok[j]:
            results[i] = {"valid?": True, "analyzer": "gpu-wgl-batch",
                          "dedup": batch_dedup, "op-count": len(ops),
                          "max-frontier": int(max_count[j]),
                          "configs": [], "final-paths": []}
        elif overflow[j]:
            suspects.append((i, ops))
        else:
            invalids.append((j, i, ops))
    if invalids:
        _batch_blame(model, hists, k, invalids, results, max_count,
                     batch_dedup, slots, dev)
    if suspects:
        if frontier < max_frontier:
            sub = analysis_gpu_batch(
                model, [hists[i] for i, _ in suspects], device=dev,
                frontier=frontier * 4, slots=slots,
                chunk_entries=chunk_entries, budget_s=_remaining(),
                cancel=cancel, engine=engine, max_frontier=max_frontier,
                dense_slot_cap=dense_slot_cap)
            for t, (i, _ops) in enumerate(suspects):
                results[i] = sub[t]
        else:
            for i, ops in suspects:
                results[i] = _unknown_result(
                    ops, f"frontier overflowed at {frontier}; escalation "
                    f"cap {max_frontier} reached — verdict unknown", t0)
    if attest_on:
        for i, _ops, _st in items:
            r = results[i]
            if isinstance(r, dict):
                r.setdefault("attested", {"steps": 1, "carry": 1})
    # the walk's counts, on each result it decided (escalated keys carry
    # their own walk's): the group's shape, its keys, its closure rounds
    # (dense) or stage-B rounds (sort), its hash dedups and host reads
    walk = {"group": (["dense", *dense] if dense is not None
                      else ["sort", frontier, slots]),
            "keys": len(items), "closure-rounds": k.rounds,
            "dedup-launches": k.dedups, "host-syncs": k.syncs}
    for i, _ops, _st in items:
        r = results[i]
        if isinstance(r, dict) and r.get("analyzer") == "gpu-wgl-batch" \
                and "batch-walk" not in r:
            r["device"] = str(dev)
            r["batch-walk"] = dict(walk)
    return carry


def _batch_blame(model, hists, k, invalids, results, max_count,
                 batch_dedup, slots, dev) -> None:
    """Name every definite invalid's culprit op with one batched walk of
    their unmerged streams on the group's engine."""
    st2s = [build_steps(ops, slots, merge=False) for _, _, ops in invalids]
    b_pad = _bucket(len(st2s), lo=1)
    x2, n2 = _stack_steps(st2s, b_pad)
    okb, deathb, *_ = k.check_batch(stage_steps(x2, dev), n2,
                                    [int(model.device_state())] * b_pad)
    for t, (j, i, ops) in enumerate(invalids):
        r = {"valid?": False, "analyzer": "gpu-wgl-batch",
             "dedup": batch_dedup, "op-count": len(ops),
             "max-frontier": int(max_count[j]),
             "configs": [], "final-paths": []}
        d = int(deathb[t])
        if not okb[t] and d >= 0:
            row = int(st2s[t].inv_row[d])
            if row < 0:
                row = int(st2s[t].ret_row[d])
            if row >= 0:
                src = int(ops.index[row])
                r["op"] = _find_op(hists[i], src)
                r["op-index"] = src
        results[i] = r


# ---------------------------------------------------------------------------
# Key-sharded batches over a process group
# ---------------------------------------------------------------------------
#
# The JAX package's `check_batch_sharded` runs every dispatch group as one
# `shard_map` over a device mesh, its verdict a psum inside the program.
# Here every rank of a `parallel.Mesh` runs the same call on the same
# histories: it builds the same groups, walks its own contiguous block of
# each group's keys (padded to a multiple of the axis size with zero-step
# keys, which stay alive and so count as valid) through K3 and K2 on its
# device, and the ranks reduce the bad count and the attestation sum and
# gather the per-key rows. A fault on one rank reaches every rank through
# `parallel.agree` after each local dispatch, so all ranks take the same
# rung of the ladder below and return the same result.

def check_batch_sharded(model, hists: list, mesh=None, axis: str = "keys",
                        frontier: int = 1024, slots: int = 32,
                        engine: str = "auto",
                        dense_slot_cap: int | None = None,
                        pallas=None, return_info: bool = False,
                        max_recovery_retries: int | None = None,
                        device=None):
    """Check a batch of independent histories sharded over a mesh's axis
    and reduce the aggregate verdict over it: the counterpart of the JAX
    package's `check_batch_sharded`, under its recovery ladder. Returns
    (all_valid, per_key_ok bool array) and, with return_info=True,
    {'groups': [{family, dedup, keys, slots}, ...], 'attested': {steps,
    carry}} as well, the same on every rank.

    mesh: a `parallel.Mesh` or a `DeviceMesh` naming `axis` (None: the
    default process group where one is initialized, else this process
    alone). device: None, or the type of the mesh's device, where this
    rank walks and its collectives run (another type raises).
    pallas: None or True, as the JAX package runs on its accelerator;
    the port has no XLA route to choose instead.

    The ladder: a classified fault re-runs the dispatch down the
    standard rungs, the OOM rung splits the key list in halves and
    re-shards each over the same mesh ('split': True in the trail), and
    the final rung checks the keys with `analysis_gpu_batch`, each rank
    its block, whose own ladder ends degraded: keys it could not decide
    report False under the boolean contract and are named in
    info['unknown-keys'] with info['degraded'] = True. The trail is in
    info['recovered'], or info['recovery-failed'] when verdicts were
    lost. A compile fault re-raises on every rank."""
    if pallas is False:
        raise ValueError("pallas=False asks for the JAX package's XLA "
                         "route, which the port does not have: its "
                         "kernels are the Hopper ports of the Pallas ones")
    mesh, dev = parallel.resolve(
        mesh if mesh is not None else parallel.default_mesh(axis, device),
        device, axis)
    kw = dict(frontier=frontier, slots=slots, engine=engine,
              dense_slot_cap=dense_slot_cap)
    all_ok, per_key, info = _sharded_ladder(model, hists, mesh, dev, kw,
                                            max_recovery_retries)
    if return_info:
        return all_ok, per_key, info
    return all_ok, per_key


def _half_faults(info: dict) -> list:
    """A split half's faults: under 'recovered' when it healed,
    'recovery-failed' when it fell off."""
    return list((info.get("recovered") or info.get("recovery-failed")
                 or {}).get("faults", []))


def _sharded_ladder(model, hists, mesh, dev, kw, max_retries) -> tuple:
    """The recovery ladder around `_check_batch_sharded_once`; kw holds
    the knobs its rungs change. Returns (all_ok, per_key, info)."""
    kw = dict(kw)
    trail = _RecoveryTrail(max_retries)
    while True:
        try:
            all_ok, per_key, info = _check_batch_sharded_once(
                model, hists, mesh, dev, **kw)
        except RuntimeError as e:
            if not trail.absorb(e, "sharded"):
                return _sharded_final_rung(model, hists, mesh, dev, kw,
                                           trail, max_retries)
            kind = trail.faults[-1]
            if kind == FAULT_OOM and len(hists) > 1:
                mid = len(hists) // 2
                log.warning("sharded: splitting %d keys into %d + %d after "
                            "OOM", len(hists), mid, len(hists) - mid)
                l_ok, l_pk, l_info = _sharded_ladder(
                    model, hists[:mid], mesh, dev, kw, max_retries)
                r_ok, r_pk, r_info = _sharded_ladder(
                    model, hists[mid:], mesh, dev, kw, max_retries)
                faults = (list(trail.faults) + _half_faults(l_info)
                          + _half_faults(r_info))
                trail_d = {"faults": faults, "retries": len(faults),
                           "split": True}
                info = {"groups": l_info["groups"] + r_info["groups"]}
                unknown = list(l_info.get("unknown-keys", [])) \
                    + [mid + i for i in r_info.get("unknown-keys", [])]
                if l_info.get("degraded") or r_info.get("degraded"):
                    info["degraded"] = True
                    if unknown:
                        info["unknown-keys"] = unknown
                    info["recovery-failed"] = trail_d
                else:
                    info["recovered"] = trail_d
                return (bool(l_ok and r_ok), np.concatenate([l_pk, r_pk]),
                        info)
            _apply_recovery_rung(kind, kw)
            continue
        if trail.faults:
            info = dict(info)
            info["recovered"] = {"faults": list(trail.faults),
                                 "retries": len(trail.faults)}
        return all_ok, per_key, info


def _sharded_final_rung(model, hists, mesh, dev, kw, trail,
                        max_retries) -> tuple:
    """The ladder's last rung: every key through `analysis_gpu_batch`
    with the rung-mutated knobs (each rank its block), undecided keys
    reported False and named."""
    codes = _sharded_batch(model, hists, mesh, dev,
                           max_recovery_retries=max_retries, **kw)
    per_key = codes == 1
    info: dict = {"groups": []}
    trail_d = {"faults": list(trail.faults), "retries": len(trail.faults),
               "fallback": "batch"}
    unknown = [int(i) for i in np.flatnonzero(codes < 0)]
    if unknown:
        log.warning("sharded: %d key(s) undecided after the recovery "
                    "budget; per-key False for them is 'unverified', not "
                    "a found anomaly: %s", len(unknown), unknown)
        info.update({"degraded": True, "unknown-keys": unknown,
                     "recovery-failed": trail_d})
    else:
        info["recovered"] = trail_d
    return bool(per_key.all()), per_key, info


def _sharded_batch(model, hists, mesh, dev, **kw) -> np.ndarray:
    """`analysis_gpu_batch` of this rank's block of hists, every rank's
    verdicts gathered to every rank: an int8 code per key, 1 valid, 0
    invalid, -1 undecided."""
    blk = mesh.block(len(hists))
    codes = np.ones(blk.stop - blk.start, np.int8)
    err = None
    try:
        mine = hists[blk]
        if mine:
            rs = analysis_gpu_batch(model, mine, device=dev, **kw)
            codes[:len(rs)] = [1 if r["valid?"] is True
                               else 0 if r["valid?"] is False else -1
                               for r in rs]
    except Exception as e:  # noqa: BLE001 — agreed, then raised
        err = e
    parallel.agree(mesh, err)
    rows = parallel.all_gather_rows(mesh, torch.from_numpy(codes).to(dev))
    return guarded_fetch(lambda: rows.cpu().numpy(),
                         site="sharded fetch")[:len(hists)]


def _check_batch_sharded_once(model, hists, mesh, dev, *, frontier: int,
                              slots: int, engine: str,
                              dense_slot_cap: int | None) -> tuple:
    """One attempt of the sharded check, which the ladder re-runs.
    Every dispatch group (`_dispatch_groups`, cheapest first, the sort
    group last) walks each rank's block of its keys in one batched walk
    (`_sharded_group`); the verdict, overflow and attestation come back
    reduced and gathered. Invalid keys whose frontier overflowed
    re-run together at 4x the frontier (each rank its block). Returns
    (all_ok, per_key, info)."""
    name = model.device_model
    k = len(hists)
    if k == 0:
        return True, np.zeros(0, bool), {"groups": []}
    all_ops = [encode_ops_for_model(model, h) for h in hists]
    srange = _state_range(name, model, all_ops)
    p_req = [required_slots(ops) for ops in all_ops]
    dense_groups, sort_idx = _dispatch_groups(
        srange, p_req, engine,
        n_events=max((event_count(o) for o in all_ops), default=1),
        frontier=frontier, dense_slot_cap=dense_slot_cap)
    plan = [(idx, d) for d, idx in (dense_groups[pg]
                                    for pg in sorted(dense_groups))]
    if sort_idx:
        plan.append((sort_idx, None))
    attest_on = attest_enabled()
    per_key = np.zeros(k, bool)
    overflow = np.zeros(k, bool)
    all_ok = True
    group_info: list[dict] = []
    for idx, dense in plan:
        # the sort group sizes itself to its own keys: never below the
        # caller's slots, never a SlotOverflow on a key the dense caps
        # rejected
        g_slots = dense[2] if dense is not None else max(
            slots, _bucket(max(p_req[i] for i in idx), lo=8))
        family = "dense" if dense is not None else "sort"
        group_info.append({
            "family": family,
            "dedup": (DEDUP_NONE if dense is not None else dedup_engine(
                frontier, g_slots, _pack_params(srange, g_slots))),
            "keys": len(idx), "slots": g_slots})
        t = _time.monotonic()
        ok_g, ov_g, bad, att = _sharded_group(
            model, [all_ops[i] for i in idx], mesh, dev, dense, srange,
            g_slots, frontier, attest_on)
        _M_CHUNK.labels(site="sharded", family=family).observe(
            _time.monotonic() - t)
        _check_att(att, "sharded")
        all_ok &= bad == 0
        per_key[idx] = ok_g[:len(idx)]
        overflow[idx] = ov_g[:len(idx)]
    _M_OPS.labels(site="sharded").inc(sum(len(o) for o in all_ops))
    # an 'invalid' under frontier overflow is unsound (the witness config
    # may have been dropped): escalate those keys together at 4x the
    # frontier; 'unknown' keys report invalid (no third value here)
    suspect = np.flatnonzero(~per_key & overflow)
    if suspect.size:
        codes = _sharded_batch(
            model, [hists[int(i)] for i in suspect], mesh, dev,
            frontier=frontier * 4, slots=slots, engine=engine,
            dense_slot_cap=dense_slot_cap)
        per_key[suspect] = codes == 1
        all_ok = bool(per_key.all())
    info: dict = {"groups": group_info}
    if attest_on:
        # steps: one staged-buffer digest per group (each rank its
        # block); carry: one reduced attestation check per group
        info["attested"] = {"steps": len(plan), "carry": len(plan)}
    return bool(all_ok), per_key, info


def _sharded_group(model, ops_list, mesh, dev, dense, srange, slots,
                   frontier, attest_on) -> tuple:
    """One dispatch group on this rank: its block of the group's keys
    walked in one batched walk, then the ranks' fault agreement, the
    reduced bad count and attestation sum, and the gathered per-key
    (ok, overflow) rows. Returns (ok, overflow) numpy rows of the padded
    group and the two reduced integers."""
    err = None
    try:
        k = _batch_kernel(model.device_model, dense, srange, slots,
                          frontier, dev)
        maybe_inject_fault("sharded")
        steps = [build_steps(ops, slots) for ops in ops_list]
        g_pad = -(-len(steps) // mesh.size) * mesh.size
        x_np, ns = _stack_steps(steps, g_pad)
        # the bit flip lands where the JAX package's does, in the whole
        # staged stack; each rank ships and attests its own block
        shipped = maybe_corrupt("sharded", x_np)
        blk = mesh.block(g_pad)
        xs = stage_steps(shipped[blk], dev)
        if attest_on:
            abft.verify_steps("sharded", k.fetch(abft.digest_device(xs.dev),
                                                 site="sharded attest"),
                              abft.digest_host(x_np[blk]))
        init = int(model.device_state())
        carry = k.run_range_batch(xs, ns[blk],
                                  k.init_carry_batch([init] * len(ns[blk])))
        _e, count, _maxc, att, ovf = k._summary_row(carry)
        ok = count > 0
        rows = torch.stack([ok.to(torch.int32), ovf.to(torch.int32)], 1)
        sums = torch.stack([(~ok).sum(), att.sum()]).to(torch.int64)
    except Exception as e:  # noqa: BLE001 — agreed, then raised
        err = e
    parallel.agree(mesh, err)
    sums = parallel.psum(mesh, sums)
    rows = parallel.all_gather_rows(mesh, rows)
    (bad, att), rows = guarded_fetch(
        lambda: (sums.tolist(), rows.cpu().numpy()), site="sharded fetch")
    return rows[:, 0].astype(bool), rows[:, 1].astype(bool), bad, att
