"""Linearizability on the GPU: the dense reachable-set engine in PyTorch.

Counterpart of `jepsen_tpu/checker/wgl.py`. A configuration is (model
state, set of pending ops already linearized). Each in-flight operation
holds a *slot* in [0, P); slots are assigned host-side by scanning the
history (freed at completion, held forever by crashed :info ops), so the
mask width is bounded by real concurrency, not history length.

When the model's state count S and the slot count P are small enough
that S * 2^P fits DENSE_TABLE_CAP, the whole configuration space is a
dense boolean table T[state, pending-mask], and every history step is a
transform of the whole table:

  * an :ok return keeps the configurations holding the op's bit and
    clears it — a gather along the mask axis;
  * an invoke closes the table under linearization of every occupied
    slot: closure rounds (`wgl_closure.closure_round`, the hand-written
    Hopper kernel K1 on CUDA) repeated until the popcount stops growing;
  * the history is linearizable iff the table is nonempty after the last
    step.

The step walk is an eager Python loop: each step's control values (the
completion mask and the invoked slot) come from the host copy of the
step matrix, the slot arguments from its device copy. One closure round
costs one host read of the table's popcount; that sync and the launches
around it set the pace of this slice (a persistent step-walk kernel is a
later slice's work).

This slice ports the dense family only. A history whose shape needs the
sort-frontier family raises NotImplementedError; that engine and its
hash-dedup kernel come in the next slice.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import time as _time
from typing import Callable

import numpy as np
import torch

from .._platform import CorruptDeviceResult, attest_enabled, resolve_device
from ..carry import carry_to_numpy
from ..history import (DeviceEncodingError, F_CAS, F_READ, F_WRITE,
                       KIND_OK, NIL, OpArray, UQ_COUNT_MAX, UQ_VALUES,
                       default_register_codec, encode_ops,
                       history as as_history)
from . import abft
from .wgl_closure import closure_round

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


class DenseKernel:
    """The dense engine for S states x P slots on one device.

    Same entry points as the JAX package's dense `Kernel`: init_carry,
    check_chunk (= run_range), check, summarize and digest, over the
    same carry ``(e, table bool[S,C], slot_f, slot_a, slot_b int32[P],
    slot_occ bool[P], att, count, max_count int32)``. Carries are
    tensors on `device` and are never updated in place, so a caller may
    keep an earlier one (the lagged liveness read does).

    `rounds` counts closure rounds (K1 launches on CUDA) and `syncs`
    counts blocking device-to-host reads, over the kernel's life."""

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

    # -- host reads ----------------------------------------------------------
    def fetch(self, t: torch.Tensor):
        """Read a tensor's value on the host (one device sync)."""
        self.syncs += 1
        return t.tolist()

    def fetch_carry(self, carry) -> tuple:
        self.syncs += 1
        return carry_to_numpy(carry)

    def _i32(self, v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32, device=self.device)

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

    def digest(self, carry) -> torch.Tensor:
        """The carry digest (abft.carry_digest_host is its host mirror),
        unfetched."""
        return abft.carry_digest_device(carry)

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
        """Walk steps [carry.e, stop) while the table is nonempty. The
        walk stops after the step that empties the table, so a dead
        carry's e is death + 1, as the JAX while_loop leaves it."""
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
        while e < stop and count > 0:
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

    check_chunk = run_range

    def check(self, xs: Staged, n_steps: int, init_state: int) -> tuple:
        """The whole search in one call: init + walk + summarize."""
        return self.summarize(
            self.run_range(xs, n_steps, self.init_carry(init_state)))


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
# Engine cost model: the JAX package's, with the sort family's dedup
# priced as the lexicographic sort until the hash-dedup kernel is ported
# ---------------------------------------------------------------------------

MXU_ADVANTAGE = 256     # batched-matmul element-ops per VPU-op
CLOSURE_ROUNDS = 2      # typical stage-B fixpoint depth per invoke
HASH_PROBE_COST = 6     # serial probe+claim cost per candidate key
DENSE_EXACT_BIAS = 8.0  # prefer dense until its modeled cost exceeds the
#                         sort family's by this factor

# dedup-engine names (reported in analyses)
DEDUP_SORT = "xla-sort"
DEDUP_NONE = "dense-table"   # the dense family has no dedup at all


@dataclasses.dataclass(frozen=True)
class EngineDecision:
    """A resolved engine choice for one history shape."""
    family: str                 # 'dense' | 'sort'
    dense: tuple | None         # (s_lo, S, P) when family == 'dense'
    dedup: str                  # DEDUP_* (sort family's dedup engine)
    reason: str
    costs: dict                 # modeled per-history element-ops


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


def _dense_caps_error(srange, p: int) -> ValueError:
    return ValueError(
        f"dense engine requested but the {srange} state range x "
        f"2^{p} table exceeds the dense caps")


def select_engine(srange: tuple[int, int], p_exact: int, n_events: int,
                  *, slots: int | None = None, frontier: int = 256,
                  engine: str = "auto",
                  dense_slot_cap: int | None = None) -> EngineDecision:
    """Pick the engine family for one history shape, by the JAX
    package's cost model as it resolves without a TPU (no Pallas hash
    dedup, no calibration). engine='dense'/'sort' force a family
    ('dense' raises when the table cannot fit); dense_slot_cap bounds
    the slot count 'auto' lets the dense table absorb."""
    if engine not in ("auto", "dense", "sort"):
        raise ValueError(f"unknown WGL engine {engine!r}")
    if slots is None:
        slots = _bucket(p_exact, lo=8)
    S = _bucket(srange[1] - srange[0] + 1, lo=4)
    costs = _family_costs(S, p_exact, slots, frontier, n_events)
    dedup = DEDUP_SORT
    sort_cost = costs["sort"]
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
        return EngineDecision("sort", None, dedup, why, costs)
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


def plan_dense(model, hist, *, frontier: int = 256,
               slots: int | None = None, engine: str = "auto",
               dense_slot_cap: int | None = None):
    """Encode a history and pick its engine: (ops, decision), where
    decision.dense is (s_lo, S, P). Raises NotImplementedError when the
    shape needs the sort-frontier family, which this slice does not
    port."""
    ops = encode_ops_for_model(model, hist)
    p_exact = required_slots(ops)
    if slots is None or p_exact > slots:
        slots = _bucket(p_exact, lo=8)
    srange = _state_range(model.device_model, model, [ops])
    decision = select_engine(srange, p_exact, event_count(ops),
                             slots=slots, frontier=frontier,
                             engine=engine, dense_slot_cap=dense_slot_cap)
    if decision.dense is None:
        raise NotImplementedError(
            f"this history needs the sort-frontier engine "
            f"({decision.reason}); the port brings that engine and its "
            f"hash-dedup kernel in the next slice")
    return ops, decision


def _check_att(att, site: str) -> None:
    """Raise the corrupt fault when a fetched attestation accumulator
    is nonzero — the table-occupancy invariant failed on device."""
    if int(att) != 0:
        raise CorruptDeviceResult(
            site, f"in-kernel attestation accumulator = {att} — a "
                  f"table invariant failed on device")


def analysis_gpu(model, hist, *, device=None, frontier: int = 256,
                 slots: int | None = None, chunk_entries: int = 4096,
                 budget_s: float | None = None, cancel=None,
                 explain: bool = True, engine: str = "auto",
                 dense_slot_cap: int | None = None) -> dict:
    """Check one history on the dense engine (counterpart of the JAX
    package's `analysis_tpu`, one attempt, without its recovery ladder).

    device: 'cuda' by default, where every closure round runs the K1
    kernel; 'cpu' runs the plain PyTorch version of the same round.

    Histories that fit one chunk run as one walk; longer ones run as
    chunk_entries-step chunks with the carry between them, the host
    reading each chunk's liveness one chunk late. budget_s caps wall
    time (past it an undecided search is 'unknown'); cancel is polled
    between chunks. explain: on an invalid verdict, re-run the host
    oracle on the prefix ending at the culprit op for configs and
    final-paths.

    With attestation on (JEPSEN_TPU_ATTEST, default on) the staged step
    buffer's device digest is checked against the host's, and a chunked
    search's final carry against its device digest and invariants."""
    t0 = _time.monotonic()
    dev = resolve_device(device)
    ops, decision = plan_dense(model, hist, frontier=frontier, slots=slots,
                               engine=engine, dense_slot_cap=dense_slot_cap)
    s_lo, S, P = decision.dense
    steps = build_steps(ops, P)
    k = DenseKernel(model.device_model, s_lo, S, P, dev)
    xs = stage_steps(steps.x, dev)
    att_info = None
    if attest_enabled():
        abft.verify_steps("offline", k.fetch(abft.digest_device(xs.dev)),
                          abft.digest_host(steps.x))
        att_info = {"steps": 1, "carry": 0}
    init_state = int(model.device_state())
    timed_out = cancelled = False
    if steps.n <= chunk_entries:
        ok, death, overflow, max_count, att = k.check(xs, steps.n,
                                                      init_state)
        _check_att(att, "offline")
    else:
        carry = k.init_carry(init_state)
        e = 0
        while e < steps.n:
            stop = min(e + chunk_entries, steps.n)
            prev, carry = carry, k.check_chunk(xs, stop, carry)
            e = stop
            if k.fetch(prev[7]) == 0:
                carry = prev   # the table died last chunk: definite
                break
            # only give up when chunks remain — a search that just
            # finished is definitive regardless of elapsed time
            if e < steps.n:
                over = budget_s is not None and \
                    _time.monotonic() - t0 > budget_s
                stop_req = cancel is not None and cancel()
                if over or stop_req:
                    if k.fetch(carry[7]) == 0:
                        break
                    timed_out = True
                    cancelled = stop_req and not over
                    break
        if att_info is not None:
            # chunk-boundary carry attestation: fetch the carry and its
            # device digest, recompute on the host, check att == 0 and
            # count == popcount(table)
            digest = k.fetch(k.digest(carry))
            abft.verify_carry("offline", digest, k.fetch_carry(carry))
            att_info["carry"] += 1
        ok, death, overflow, max_count, att = k.summarize(carry)
        _check_att(att, "offline")
    ok = ok and not timed_out
    overflow = overflow or timed_out
    out = {
        "valid?": True if ok else "unknown" if overflow else False,
        "analyzer": "gpu-wgl-dense",
        "dedup": DEDUP_NONE,
        "engine-reason": decision.reason,
        "dense-shape": list(decision.dense),    # [s_lo, S, P]
        "op-count": len(ops),
        "max-frontier": int(max_count),
        "frontier-size": frontier,
        "duration-ms": (_time.monotonic() - t0) * 1e3,
        "configs": [],
        "final-paths": [],
        "device": str(dev),
    }
    if att_info is not None:
        out["attested"] = att_info
    if not ok:
        if cancelled:
            out["error"] = "search cancelled"
        elif timed_out:
            out["error"] = (f"search exceeded the {budget_s} s budget; "
                            f"verdict unknown")
        else:
            # the merged stream can't name a single culprit op: re-run
            # the unmerged stream, which dies at the same event
            row = _death_row(k, ops, P, init_state)
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
    out["closure-rounds"] = k.rounds
    out["host-syncs"] = k.syncs
    return out


def _death_row(k: DenseKernel, ops: OpArray, slots: int,
               init_state: int) -> int:
    """Op row where the table died, from an unmerged re-run."""
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
