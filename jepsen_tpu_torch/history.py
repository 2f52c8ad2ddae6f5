"""Operation and history model — the foundation every layer shares.

An *operation* is a plain dict (mirroring the reference's Clojure maps; see
`jepsen/src/jepsen/generator.clj` docstring for the op shape):

    {'type': 'invoke'|'ok'|'fail'|'info',
     'f': <workload-specific function, e.g. 'read'|'write'|'cas'>,
     'value': <payload>,
     'process': int | 'nemesis',
     'time': int nanoseconds, relative to test start,
     'index': int, position in the history (assigned by `index()`)}

A *history* is the ordered journal of invocations and completions recorded by
the interpreter (reference: `jepsen/src/jepsen/generator/interpreter.clj:
181-310` journals a transient vector; `jepsen/src/jepsen/core.clj:228`
indexes it with knossos.history before checking).

This module also defines the *device encoding*: a history lowered to a
structure-of-arrays of fixed-width integers, one row per logical operation
(invoke paired with its completion), ready to ship to the GPU as tensors.

The port's own copy of `jepsen_tpu/history.py`: the port imports nothing
of the JAX package, so the two copies must stay in step (the parity
tests in tests/test_torch_host.py hold them to it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

# Op types
INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

NEMESIS = "nemesis"

# Sentinel for "no value" in integer device encodings. Register-family
# workloads use non-negative small ints; -1 is reserved.
NIL = -1


# device unordered-queue multiset layout: 4-bit per-value counts
UQ_VALUES = 7
UQ_COUNT_MAX = 15


class DeviceEncodingError(ValueError):
    """The history (or model state) exceeds a device encoding's
    capacity — checkers catch this and fall back to the host model.
    Deliberately distinct from plain ValueError so configuration
    errors (e.g. forcing an ineligible engine) still surface."""


def op(type: str, f: Any, value: Any = None, process: Any = None,
       time: int | None = None, **extra: Any) -> dict:
    """Build an op map."""
    o = {"type": type, "f": f, "value": value, "process": process,
         "time": time}
    if extra:
        o.update(extra)
    return o


def invoke_op(process: Any, f: Any, value: Any = None, **extra: Any) -> dict:
    return op(INVOKE, f, value, process, **extra)


def is_invoke(o: dict) -> bool:
    return o["type"] == INVOKE


def is_ok(o: dict) -> bool:
    return o["type"] == OK


def is_fail(o: dict) -> bool:
    return o["type"] == FAIL


def is_info(o: dict) -> bool:
    return o["type"] == INFO


def is_completion(o: dict) -> bool:
    return o["type"] in (OK, FAIL, INFO)


def is_client_op(o: dict) -> bool:
    """Client ops have integer processes; the nemesis uses 'nemesis'."""
    return isinstance(o["process"], int)


def completion_of(invocation: dict, completion_type: str = OK,
                  **overrides: Any) -> dict:
    """Build the completion op for an invocation (same process/f, new type)."""
    o = dict(invocation)
    o["type"] = completion_type
    o.update(overrides)
    return o


class History(Sequence):
    """An immutable-by-convention ordered journal of ops.

    Thin wrapper over a list of op dicts with the derived structure every
    checker needs: indexing, invoke/completion pairing, filtering.
    """

    __slots__ = ("ops", "_pair_index", "_indexed")

    def __init__(self, ops: Iterable[dict]):
        self.ops = list(ops)
        self._pair_index: dict[int, int] | None = None
        self._indexed = False

    # -- Sequence interface -------------------------------------------------
    def __len__(self) -> int:
        return len(self.ops)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return History(self.ops[i])
        return self.ops[i]

    def __iter__(self) -> Iterator[dict]:
        return iter(self.ops)

    def __eq__(self, other) -> bool:
        if isinstance(other, History):
            return self.ops == other.ops
        if isinstance(other, list):
            return self.ops == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"History({len(self.ops)} ops)"

    # -- Derived structure --------------------------------------------------
    def index(self) -> "History":
        """Return a history whose ops carry an :index field equal to their
        position (reference: knossos history/index via core.clj:228). Ops
        that already have correct indices are reused; a fully-indexed
        history returns itself (re-indexing a 100k-op history costs
        half a second of pure dict traffic)."""
        if self._indexed:
            return self   # verified (or built) by an earlier call
        if all(o.get("index") == i for i, o in enumerate(self.ops)):
            self._indexed = True
            return self
        out = []
        for i, o in enumerate(self.ops):
            if o.get("index") != i:
                o = dict(o)
                o["index"] = i
            out.append(o)
        h = History(out)
        h._indexed = True
        return h

    def pair_index(self) -> dict[int, int]:
        """Map from op position -> position of its partner (invoke <->
        completion), for client ops. Pending invocations (no completion) and
        nemesis ops are absent. Requires ops in journal order."""
        if self._pair_index is not None:
            return self._pair_index
        pairs: dict[int, int] = {}
        open_by_process: dict[Any, int] = {}
        for i, o in enumerate(self.ops):
            p = o["process"]
            if not isinstance(p, int):
                continue  # nemesis ops don't pair
            if is_invoke(o):
                open_by_process[p] = i
            else:
                j = open_by_process.pop(p, None)
                if j is not None:
                    pairs[i] = j
                    pairs[j] = i
        self._pair_index = pairs
        return pairs

    def completion(self, i: int) -> dict | None:
        """The completion op for the invocation at position i, or None."""
        j = self.pair_index().get(i)
        return self.ops[j] if j is not None else None

    def invocation(self, i: int) -> dict | None:
        j = self.pair_index().get(i)
        return self.ops[j] if j is not None else None

    # -- Filters ------------------------------------------------------------
    def filter(self, pred: Callable[[dict], bool]) -> "History":
        return History(o for o in self.ops if pred(o))

    def invocations(self) -> "History":
        return self.filter(is_invoke)

    def completions(self) -> "History":
        return self.filter(is_completion)

    def oks(self) -> "History":
        return self.filter(is_ok)

    def fails(self) -> "History":
        return self.filter(is_fail)

    def infos(self) -> "History":
        return self.filter(is_info)

    def client_ops(self) -> "History":
        return self.filter(is_client_op)

    def filter_f(self, f: Any) -> "History":
        fs = f if isinstance(f, (set, frozenset, tuple, list)) else (f,)
        fs = set(fs)
        return self.filter(lambda o: o["f"] in fs)

    def pending(self) -> "History":
        """Client invocations with no completion — the open tail a
        crash, SIGKILL, or op-timeout leaves behind. A salvaged journal
        ends with these; checkers treat them as indeterminate, so the
        prefix stays checkable (cf. P-compositional checking)."""
        pairs = self.pair_index()
        return History(o for i, o in enumerate(self.ops)
                       if is_invoke(o) and isinstance(o["process"], int)
                       and i not in pairs)

    def without_failures(self) -> "History":
        """Drop :fail completions and their invocations — failed ops are
        known to have not taken effect (knossos semantics)."""
        pairs = self.pair_index()
        drop = set()
        for i, o in enumerate(self.ops):
            if is_fail(o):
                drop.add(i)
                j = pairs.get(i)
                if j is not None:
                    drop.add(j)
        return History(o for i, o in enumerate(self.ops) if i not in drop)


def history(ops: Iterable[dict] | History) -> History:
    if isinstance(ops, History):
        return ops
    return History(ops)


# ---------------------------------------------------------------------------
# Device encoding: operations as structure-of-arrays
# ---------------------------------------------------------------------------

# Function codes for the register family (read/write/cas). Other workloads
# register their own codes; these cover the knossos-model kernels.
F_READ = 0
F_WRITE = 1
F_CAS = 2

# Outcome kinds for paired operations.
KIND_OK = 0      # completed :ok — must linearize with recorded result
KIND_INFO = 1    # crashed :info — may linearize (successfully) or never


@dataclasses.dataclass
class OpArray:
    """A history lowered to one row per *logical operation* (invoke paired
    with completion), sorted by invocation order.

    Fields (all numpy, length n):
      f        int32 — function code (F_READ/F_WRITE/F_CAS/...)
      a        int32 — 1st argument (write value, cas old, read-observed)
      b        int32 — 2nd argument (cas new), NIL otherwise
      kind     int32 — KIND_OK | KIND_INFO
      inv      int32 — invocation's rank within the client-op stream this
                       array was built from (ordering only)
      ret      int32 — completion's rank in that same stream, or
                       PENDING_RET (int32 max) for pending/:info ops
      process  int32 — process id (client ops only)
      index    int32 — invocation's :index in the source history (equals
                       inv-rank only if the history was pre-filtered);
                       use this to point back at real ops

    Failed ops are excluded (they did not take effect); crashed reads are
    excluded (a pending read constrains nothing). See checker/wgl.py for the
    soundness argument.
    """
    f: np.ndarray
    a: np.ndarray
    b: np.ndarray
    kind: np.ndarray
    inv: np.ndarray
    ret: np.ndarray
    process: np.ndarray
    index: np.ndarray

    def __len__(self) -> int:
        return len(self.f)

    @property
    def n_ok(self) -> int:
        return int((self.kind == KIND_OK).sum())


# int32 max: ships to TPU unharmed (x64 is typically disabled, and TPUs
# have no native int64 — an int64 sentinel like 2**62 would silently wrap).
PENDING_RET = np.int32(2**31 - 1)


def default_register_codec(o: dict) -> tuple[int, int, int]:
    """Value codec for read/write/cas register ops.

    read:  value is the observed register value (or None on invoke)
    write: value is the written value
    cas:   value is a (old, new) pair
    """
    f = o["f"]
    v = o["value"]
    if f in ("read", "r", F_READ):
        return F_READ, NIL if v is None else int(v), NIL
    if f in ("write", "w", F_WRITE):
        return F_WRITE, int(v), NIL
    if f in ("cas", F_CAS):
        old, new = v
        return F_CAS, int(old), int(new)
    raise DeviceEncodingError(f"unknown register op f={f!r}")


def encode_ops(h: History,
               codec: Callable[[dict], tuple[int, int, int]]
               = default_register_codec,
               drop_pending: frozenset | None = None) -> OpArray:
    """Lower a history to an OpArray for the device checkers.

    Pairing/semantics follow knossos: each client invoke pairs with the next
    completion from the same process; :fail pairs are dropped; :info ops are
    pending forever (ret = PENDING_RET); the *completion's* value is
    authoritative for :ok ops (a read's observed value arrives on the :ok
    op).

    drop_pending: f-codes whose pending (crashed) ops constrain nothing and
    may be elided. This is codec-specific — f-code meanings differ per codec
    (mutex 'acquire' is 0 too) — so the default only drops reads for the
    default register codec and nothing otherwise; keeping a droppable
    pending op is always sound, just slower.
    """
    if drop_pending is None:
        drop_pending = (frozenset({F_READ})
                        if codec is default_register_codec else frozenset())
    if h.ops and "index" not in h.ops[0]:
        h = h.index()
    h = h.client_ops()
    pairs = h.pair_index()
    rows = []
    for i, o in enumerate(h.ops):
        if not is_invoke(o):
            continue
        j = pairs.get(i)
        comp = h.ops[j] if j is not None else None
        if comp is not None and is_fail(comp):
            continue  # did not take effect
        if comp is None or is_info(comp):
            # Pending forever. Ops whose f is in drop_pending constrain
            # nothing when pending (e.g. reads) and are elided.
            f, a, b = codec(o)
            if f in drop_pending:
                continue
            rows.append((f, a, b, KIND_INFO, i, PENDING_RET,
                         o["process"], o.get("index", i)))
        else:
            f, a, b = codec(comp)  # completion value is authoritative
            rows.append((f, a, b, KIND_OK, i, j,
                         o["process"], o.get("index", i)))
    if rows:
        cols = list(zip(*rows))
    else:
        cols = [[] for _ in range(8)]
    return OpArray(
        f=np.asarray(cols[0], np.int32),
        a=np.asarray(cols[1], np.int32),
        b=np.asarray(cols[2], np.int32),
        kind=np.asarray(cols[3], np.int32),
        inv=np.asarray(cols[4], np.int32),
        ret=np.asarray(cols[5], np.int32),
        process=np.asarray(cols[6], np.int32),
        index=np.asarray(cols[7], np.int32),
    )
