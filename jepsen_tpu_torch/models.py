"""System models for linearizability checking.

Equivalents of knossos.model (the reference consumes these via
`jepsen/src/jepsen/checker.clj:185-216` and per-suite model definitions,
e.g. `jepsen/src/jepsen/tests/linearizable_register.clj:37`).

A model is an immutable, hashable value with a ``step(op) -> model`` method;
stepping with an impossible op returns an ``Inconsistent`` describing why.
Device kernels use the *enumerable* subset (register family, mutex) via
integer state encodings declared here; arbitrary Python models fall back to
the host checker.

The port's own copy of `jepsen_tpu/models.py` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .history import DeviceEncodingError, NIL, UQ_COUNT_MAX, UQ_VALUES


class Inconsistent:
    """A terminal model state: the op could not have happened."""

    __slots__ = ("msg",)

    def __init__(self, msg: str):
        self.msg = msg

    def __repr__(self):
        return f"Inconsistent({self.msg!r})"

    def __eq__(self, other):
        return isinstance(other, Inconsistent) and self.msg == other.msg

    def __hash__(self):
        return hash(("inconsistent", self.msg))


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(m: Any) -> bool:
    return isinstance(m, Inconsistent)


class Model:
    """Base class. Subclasses must be immutable and hashable."""

    def step(self, op: dict) -> "Model | Inconsistent":
        raise NotImplementedError

    # -- device lowering ----------------------------------------------------
    # Models that can run on the device provide an integer state encoding plus the
    # name of a registered device step function (see checker/wgl.py).
    device_model: Optional[str] = None

    def device_state(self) -> int:
        raise NotImplementedError(f"{type(self).__name__} has no device form")


@dataclasses.dataclass(frozen=True)
class CASRegister(Model):
    """A register supporting read/write/cas (knossos cas-register)."""
    value: Any = None

    device_model = "cas-register"

    def step(self, op: dict):
        f, v = op["f"], op["value"]
        if f in ("write", "w"):
            return CASRegister(v)
        if f == "cas":
            old, new = v
            if self.value != old:
                return inconsistent(
                    f"can't CAS {self.value!r} from {old!r} to {new!r}")
            return CASRegister(new)
        if f in ("read", "r"):
            if v is None or self.value == v:
                return self
            return inconsistent(f"can't read {v!r} from {self.value!r}")
        return inconsistent(f"unknown op f={f!r}")

    def device_state(self) -> int:
        return NIL if self.value is None else int(self.value)


@dataclasses.dataclass(frozen=True)
class Register(Model):
    """A read/write register (knossos register)."""
    value: Any = None

    device_model = "register"

    def step(self, op: dict):
        f, v = op["f"], op["value"]
        if f in ("write", "w"):
            return Register(v)
        if f in ("read", "r"):
            if v is None or self.value == v:
                return self
            return inconsistent(f"can't read {v!r} from {self.value!r}")
        return inconsistent(f"unknown op f={f!r}")

    def device_state(self) -> int:
        return NIL if self.value is None else int(self.value)


@dataclasses.dataclass(frozen=True)
class Mutex(Model):
    """A lock with acquire/release (knossos mutex)."""
    locked: bool = False

    device_model = "mutex"

    def step(self, op: dict):
        f = op["f"]
        if f == "acquire":
            if self.locked:
                return inconsistent("cannot acquire a held lock")
            return Mutex(True)
        if f == "release":
            if not self.locked:
                return inconsistent("cannot release a free lock")
            return Mutex(False)
        return inconsistent(f"unknown op f={f!r}")

    def device_state(self) -> int:
        return 1 if self.locked else 0


@dataclasses.dataclass(frozen=True)
class NoOp(Model):
    """A model which considers any op legal (knossos noop)."""

    def step(self, op: dict):
        return self


@dataclasses.dataclass(frozen=True)
class Counter(Model):
    """A counter: adds always apply, reads must observe the current
    value (knossos's counter model family; the reference offloads
    counter checking to the O(n) bounds checker, `checker.clj:737-795`
    — this model makes it *linearizability*-checkable on device)."""
    value: int = 0

    device_model = "counter"

    def step(self, op: dict):
        f, v = op["f"], op["value"]
        if f == "add":
            return Counter(self.value + int(v))
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(
                f"read {v!r} but counter is {self.value}")
        return inconsistent(f"unknown op f={f!r}")

    def device_state(self) -> int:
        return self.value


@dataclasses.dataclass(frozen=True)
class GSet(Model):
    """A grow-only set: adds accumulate, reads observe the exact
    current membership (the CRDT G-Set the hazelcast suite's map
    workload exercises, `hazelcast.clj:652-767`)."""
    members: frozenset = frozenset()

    device_model = "g-set"

    def step(self, op: dict):
        f, v = op["f"], op["value"]
        if f == "add":
            return GSet(self.members | {v})
        if f == "read":
            if v is None or frozenset(v) == self.members:
                return self
            return inconsistent(
                f"read {sorted(v)!r} but set is "
                f"{sorted(self.members)!r}")
        return inconsistent(f"unknown op f={f!r}")

    def device_state(self) -> int:
        state = 0
        for v in self.members:
            v = int(v)
            if not 0 <= v < 31:
                raise DeviceEncodingError(
                    f"g-set element {v} outside the device bitmask "
                    "[0, 31) — use the host model")
            state |= 1 << v
        return state


@dataclasses.dataclass(frozen=True)
class UnorderedQueue(Model):
    """A queue where dequeues may return any enqueued-but-not-yet-dequeued
    element (knossos unordered-queue). State is a frozen multiset.

    Device form: the multiset packs into an int32 as 4-bit per-value
    counts when values are ints in [0, 7) and multiplicities stay
    under 16 — enough for token/CP-menu queue workloads; anything
    wider falls back to this host model."""
    pending: frozenset = frozenset()  # of (value, dup-count) expanded pairs

    device_model = "unordered-queue"

    def device_state(self) -> int:
        counts = [0] * UQ_VALUES
        for (v, _i) in self.pending:
            v = int(v)
            if not 0 <= v < UQ_VALUES:
                raise DeviceEncodingError(
                    f"queue value {v} outside the device digit range "
                    f"[0, {UQ_VALUES}) — use the host model")
            counts[v] += 1
            if counts[v] > UQ_COUNT_MAX:
                raise DeviceEncodingError(
                    f"more than {UQ_COUNT_MAX} copies of {v} in the "
                    "initial queue state would carry into the next "
                    "digit — use the host model")
        return sum(c << (4 * v) for v, c in enumerate(counts))

    @staticmethod
    def _add(pending: frozenset, v: Any) -> frozenset:
        n = sum(1 for (x, _) in pending if x == v)
        return pending | {(v, n)}

    @staticmethod
    def _remove(pending: frozenset, v: Any):
        matches = [(x, i) for (x, i) in pending if x == v]
        if not matches:
            return None
        return pending - {max(matches, key=lambda t: t[1])}

    def step(self, op: dict):
        f, v = op["f"], op["value"]
        if f == "enqueue":
            return UnorderedQueue(self._add(self.pending, v))
        if f == "dequeue":
            rest = self._remove(self.pending, v)
            if rest is None:
                return inconsistent(f"can't dequeue {v!r}: not in queue")
            return UnorderedQueue(rest)
        return inconsistent(f"unknown op f={f!r}")


@dataclasses.dataclass(frozen=True)
class FIFOQueue(Model):
    """A strictly-ordered queue (knossos fifo-queue)."""
    items: tuple = ()

    def step(self, op: dict):
        f, v = op["f"], op["value"]
        if f == "enqueue":
            return FIFOQueue(self.items + (v,))
        if f == "dequeue":
            if not self.items:
                return inconsistent(f"can't dequeue {v!r} from empty queue")
            if self.items[0] != v:
                return inconsistent(
                    f"can't dequeue {v!r}: head is {self.items[0]!r}")
            return FIFOQueue(self.items[1:])
        return inconsistent(f"unknown op f={f!r}")


@dataclasses.dataclass(frozen=True)
class MultiRegister(Model):
    """Registers addressed by key, stepped by whole transactions: ops
    carry `value` = [[f, k, v], ...] with f in {"r", "w"}. A nil read
    is always legal. Mirrors the reference's MultiRegister knossos
    model (`yugabyte/src/yugabyte/multi_key_acid.clj:16-38`)."""
    values: tuple = ()   # sorted ((k, v), ...) so the model hashes

    def step(self, op: dict):
        state = dict(self.values)
        for f, k, v in op["value"]:
            if f in ("r", "read"):
                if v is not None and state.get(k) != v:
                    return inconsistent(
                        f"can't read {v!r} from key {k!r} = "
                        f"{state.get(k)!r}")
            elif f in ("w", "write"):
                state[k] = v
            else:
                return inconsistent(f"unknown micro-op f={f!r}")
        return MultiRegister(tuple(sorted(state.items())))


def cas_register(value: Any = None) -> CASRegister:
    return CASRegister(value)


def multi_register(values: dict | None = None) -> MultiRegister:
    return MultiRegister(tuple(sorted((values or {}).items())))


def register(value: Any = None) -> Register:
    return Register(value)


def mutex() -> Mutex:
    return Mutex()


def noop() -> NoOp:
    return NoOp()


def counter(value: int = 0) -> Counter:
    return Counter(value)


def gset() -> GSet:
    return GSet()


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()
