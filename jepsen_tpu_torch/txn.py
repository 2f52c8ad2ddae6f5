"""Transaction micro-op utilities.

Transactions are sequences of micro-ops ("mops"), each a 3-element list/tuple
``[f, k, v]`` where f is 'r' (read), 'w' (write), or 'append'. Behavioral
parity with the reference's vendored txn library
(`txn/src/jepsen/txn.clj:5-73`, `txn/src/jepsen/txn/micro_op.clj:6-35`);
these semantics feed the Elle-class cycle checkers.

The port's own copy of `jepsen_tpu/txn.py` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator


# -- micro-op accessors (reference: txn/micro_op.clj) -----------------------

def f(mop) -> Any:
    return mop[0]


def key(mop) -> Any:
    return mop[1]


def value(mop) -> Any:
    return mop[2]


def is_read(mop) -> bool:
    return mop[0] == "r"


def is_write(mop) -> bool:
    return mop[0] == "w"


def is_mop(mop) -> bool:
    return len(mop) == 3 and mop[0] in ("r", "w", "append")


# -- transaction reductions (reference: txn.clj) ----------------------------

def reduce_mops(fn: Callable, init: Any, history: Iterable[dict]) -> Any:
    """Reduce ``fn(state, op, mop)`` over every micro-op of every op's
    :value transaction in the history."""
    state = init
    for op in history:
        for mop in op["value"]:
            state = fn(state, op, mop)
    return state


def op_mops(history: Iterable[dict]) -> Iterator[tuple[dict, Any]]:
    """All (op, mop) pairs in the history, in order."""
    for op in history:
        for mop in op["value"]:
            yield op, mop


def ext_reads(txn: Iterable) -> dict:
    """Keys -> values for a transaction's *external reads*: values observed
    that the transaction did not itself write first. A read of a key after
    any prior mop on that key (read or write) is internal."""
    ext: dict = {}
    seen: set = set()
    for mop in txn:
        mf, mk, mv = mop[0], mop[1], mop[2]
        if mf == "r" and mk not in seen:
            ext[mk] = mv
        seen.add(mk)
    return ext


def ext_writes(txn: Iterable) -> dict:
    """Keys -> values for a transaction's *external writes*: the final value
    written to each key (intermediate writes are internal)."""
    ext: dict = {}
    for mop in txn:
        if mop[0] != "r":
            ext[mop[1]] = mop[2]
    return ext


def int_write_mops(txn: Iterable) -> dict:
    """Keys -> list of all non-final write mops to that key (only keys with
    more than one write appear)."""
    writes: dict = {}
    for mop in txn:
        if mop[0] != "r":
            writes.setdefault(mop[1], []).append(list(mop))
    return {k: vs[:-1] for k, vs in writes.items() if len(vs) > 1}
