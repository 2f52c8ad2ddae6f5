"""Key-sharded ("independent") checking: a test over many independent
keys, checked key by key.

Counterpart of `jepsen_tpu/independent.py` (reference
`jepsen/src/jepsen/independent.clj`), cut to the checking half: op values
are `(k, v)` tuples (`KV`), generators stamp keys onto a base
generator's values (`tuple_gen`, `sequential_generator`,
`concurrent_generator`: host code, copied from the JAX package), the
history splits per key (`subhistory`), and `IndependentChecker` checks
each key's subhistory.

Per-key subhistories are the batchable axis: when the subchecker is a
device-model linearizability checker, every key goes through one call of
`checker.wgl.analysis_gpu_batch`, whose walks check all keys of a group
in lockstep with one K3 or K2 launch for all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

from . import generator as gen
from .checker import Checker, check_safe, coerce, merge_valid
from .generator import Gen, PENDING
from .history import History, history as as_history
from .util import bounded_pmap


class KV(tuple):
    """A `(key, value)` tuple distinguishable from plain pairs."""

    __slots__ = ()

    def __new__(cls, k, v):
        return super().__new__(cls, (k, v))

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        return self[1]

    def __repr__(self):
        return f"KV({self[0]!r}, {self[1]!r})"


def ktuple(k, v) -> KV:
    """Construct an independent key/value pair."""
    return KV(k, v)


def is_tuple(x) -> bool:
    return isinstance(x, KV)


def tuple_key(op: dict):
    """The key of an op whose value is a KV, else None."""
    v = op.get("value")
    return v.key if isinstance(v, KV) else None


def tuple_value(op: dict):
    v = op.get("value")
    return v.value if isinstance(v, KV) else None


def _wrap(k) -> Callable[[dict], dict]:
    def f(op: dict) -> dict:
        op = dict(op)
        op["value"] = KV(k, op.get("value"))
        return op
    return f


def tuple_gen(k, g):
    """Wrap a generator so every op's value becomes (k, v)."""
    return gen.map(_wrap(k), g)


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

class _KeyStream:
    """Deterministic, memoizing view of a (possibly infinite) key sequence.

    Generator state stays pure — cursors are plain ints held in generator
    records — while realized keys are cached here. Realizing key i is
    deterministic, so sharing the memo across generator copies is safe.
    """

    def __init__(self, keys: Iterable):
        self._it = iter(keys)
        self._memo: list = []
        self._done = False

    def get(self, i: int):
        """The i-th key, or None when the stream is exhausted before i."""
        while len(self._memo) <= i and not self._done:
            try:
                self._memo.append(next(self._it))
            except StopIteration:
                self._done = True
        return self._memo[i] if i < len(self._memo) else None


@dataclasses.dataclass(frozen=True)
class SequentialGenerator(Gen):
    """One key at a time: runs `fgen(k)` (with values wrapped in (k, v))
    for each key in sequence (`independent.clj:31-47`)."""
    keys: Any           # _KeyStream
    fgen: Callable
    i: int              # cursor into keys
    current: Any        # active generator or None (not yet built)
    started: bool

    def _ensure(self):
        if self.started:
            return self
        k = self.keys.get(self.i)
        if k is None:
            return None
        return dataclasses.replace(
            self, current=tuple_gen(k, self.fgen(k)), started=True)

    def op(self, test, ctx):
        me = self._ensure()
        while me is not None:
            res = gen.op(me.current, test, ctx)
            if res is not None:
                return res[0], dataclasses.replace(me, current=res[1])
            me = dataclasses.replace(me, i=me.i + 1, started=False)
            me = me._ensure()
        return None

    def update(self, test, ctx, event):
        me = self._ensure()
        if me is None:
            return self
        return dataclasses.replace(
            me, current=gen.update(me.current, test, ctx, event))


def sequential_generator(keys: Iterable, fgen: Callable) -> Gen:
    """For each key k in sequence, runs fgen(k) with values wrapped as
    (k, v) tuples."""
    return SequentialGenerator(_KeyStream(keys), fgen, 0, None, False)


@dataclasses.dataclass(frozen=True)
class ConcurrentGenerator(Gen):
    """Partitions client threads into groups of n; each group concurrently
    works through the shared key sequence, running an independent
    `fgen(k)` per key (`independent.clj:103-239`).

    State per group: (next-key-cursor-claim handled via `cursor`, the
    group's active key index, and its active generator). Groups claim key
    indices from a shared monotone cursor so no two groups run the same
    key.
    """
    n: int              # threads per group
    keys: Any           # _KeyStream
    fgen: Callable
    cursor: int         # next unclaimed key index
    groups: tuple       # ((group_id, key_index, gen) ...), active groups

    def _group_of(self, thread) -> int | None:
        if not isinstance(thread, int):
            return None  # nemesis never participates
        return thread // self.n

    def _group_pred(self, gid: int) -> Callable:
        lo, hi = gid * self.n, (gid + 1) * self.n
        return lambda t: isinstance(t, int) and lo <= t < hi

    def _group_state(self, gid: int):
        for g, ki, gg in self.groups:
            if g == gid:
                return ki, gg
        return None

    def _with_group(self, gid: int, ki, g, cursor=None):
        groups = tuple((gg, kk, xx) for gg, kk, xx in self.groups
                       if gg != gid)
        if g is not None:
            groups = groups + ((gid, ki, g),)
        return dataclasses.replace(
            self, groups=groups,
            cursor=self.cursor if cursor is None else cursor)

    def op(self, test, ctx):
        client_threads = sorted(t for t in ctx.workers if isinstance(t, int))
        if not client_threads:
            return None
        if len(client_threads) % self.n != 0:
            raise ValueError(
                f"concurrent_generator requires the client thread count "
                f"({len(client_threads)}) to be divisible by n={self.n}")
        gids = sorted({t // self.n for t in client_threads})
        me = self
        best = None
        exhausted = 0
        for gid in gids:
            sub = gen.Context(
                ctx.time,
                tuple(t for t in ctx.free_threads
                      if me._group_pred(gid)(t)),
                {t: p for t, p in ctx.workers.items()
                 if me._group_pred(gid)(t)})
            # Claim keys until this group has a generator that yields —
            # empty per-key generators must not end the group while the
            # key stream has more keys.
            res = None
            ki = None
            while True:
                st = me._group_state(gid)
                if st is None:
                    k = me.keys.get(me.cursor)
                    if k is None:
                        exhausted += 1
                        break
                    me = me._with_group(gid, me.cursor,
                                        tuple_gen(k, me.fgen(k)),
                                        cursor=me.cursor + 1)
                    continue
                ki, g = st
                res = gen.op(g, test, sub)
                if res is None:
                    me = me._with_group(gid, None, None)  # key done
                    continue
                break
            if res is None:
                continue
            o, g1 = res
            cand = {"op": o, "gen": me._with_group(gid, ki, g1,
                                                   cursor=me.cursor),
                    "weight": self.n}
            best = gen._soonest(best, cand)
        if best is not None:
            # each candidate's generator snapshot carries the shared
            # cursor/groups state as of its build; losing candidates'
            # claims are deterministically redone on the next call
            return best["op"], best["gen"]
        if exhausted == len(gids):
            return None
        return PENDING, me

    def update(self, test, ctx, event):
        gid = self._group_of(
            gen.process_to_thread(ctx, event.get("process")))
        if gid is None:
            return self
        st = self._group_state(gid)
        if st is None:
            return self
        ki, g = st
        sub = gen.Context(
            ctx.time,
            tuple(t for t in ctx.free_threads if self._group_pred(gid)(t)),
            {t: p for t, p in ctx.workers.items()
             if self._group_pred(gid)(t)})
        return self._with_group(gid, ki, gen.update(g, test, sub, event))


def concurrent_generator(n: int, keys: Iterable, fgen: Callable) -> Gen:
    """n threads per key; groups of threads run independent keys
    concurrently, pulling fresh keys as theirs exhaust. Client thread
    count must be divisible by n."""
    return ConcurrentGenerator(n, _KeyStream(keys), fgen, 0, ())


# ---------------------------------------------------------------------------
# History splitting
# ---------------------------------------------------------------------------

def history_keys(hist) -> list:
    """Every key present in the history, in order of first appearance."""
    seen = []
    seen_set = set()
    for o in as_history(hist):
        v = o.get("value")
        if isinstance(v, KV) and v.key not in seen_set:
            seen_set.add(v.key)
            seen.append(v.key)
    return seen


def subhistory(k, hist) -> History:
    """The subhistory for key k: ops with that key get their value
    unwrapped; non-client ops (nemesis) pass through; other keys' ops
    are dropped."""
    out = []
    for o in as_history(hist):
        v = o.get("value")
        if isinstance(v, KV):
            if v.key == k:
                o = dict(o)
                o["value"] = v.value
                out.append(o)
        elif not isinstance(o.get("process"), int):
            out.append(o)  # nemesis ops belong to every subhistory
    return History(out)


def subhistories(hist, ks) -> dict:
    """`subhistory` of every key in ks, in one pass over the history."""
    out: dict = {k: [] for k in ks}
    for o in as_history(hist):
        v = o.get("value")
        if isinstance(v, KV):
            if v.key in out:
                o = dict(o)
                o["value"] = v.value
                out[v.key].append(o)
        elif not isinstance(o.get("process"), int):
            for ops in out.values():
                ops.append(o)
    return {k: History(ops) for k, ops in out.items()}


# 'competition' batches too, as in the JAX package: one batched device
# walk decides every key, with nothing for a host search to race
_DEVICE_ALGORITHMS = ("auto", "gpu", "tpu", "linear", "wgl", "competition",
                      "tpu-wgl")


class IndependentChecker(Checker):
    """Applies a subchecker to each key's subhistory; a key's failure
    fails the whole test.

    A device-model `Linearizable` subchecker checks every key in one
    `analysis_gpu_batch` call, with the subchecker's options. There is
    no fallback to per-key host checks, so a broken kernel or a card
    that is gone cannot hide behind the host oracle: if that call
    raises, the check raises; device faults the batch entry's recovery
    ladder absorbs come back stamped 'recovered' on the keys they
    touched, and faults past its retry budget leave those keys a
    degraded 'unknown' with their fault trail.

    strict_device is kept for the JAX package's signature, where False
    (its default) falls back to per-key host checks when the batch
    fails. The port has no such fallback, so only True is accepted.

    Only a subchecker with no device form — algorithm 'host', a model
    without `device_model`, a checker that is not `Linearizable` — runs
    per key, through `check_safe`, eight keys at a time."""

    def __init__(self, subchecker, strict_device: bool = True):
        if not strict_device:
            raise ValueError("strict_device=False: the port has no per-key "
                             "host fallback for a failed device batch")
        self.subchecker = coerce(subchecker)

    def _batched_gpu(self, subs: dict):
        """The batched per-key device check, or None when the subchecker
        has no device form."""
        from .checker.linear import Linearizable
        c = self.subchecker
        if not isinstance(c, Linearizable):
            return None
        if c.model is None or c.model.device_model is None:
            return None
        if c.algorithm not in _DEVICE_ALGORITHMS:
            return None
        from .checker.wgl import analysis_gpu_batch
        return dict(zip(subs, analysis_gpu_batch(c.model, list(
            subs.values()), **c.opts)))

    def check(self, test, hist, opts):
        hist = as_history(hist).index()
        ks = history_keys(hist)
        subs = subhistories(hist, ks)
        results = self._batched_gpu(subs) if ks else {}
        if results is None:
            def one(k):
                sub_opts = dict(opts)
                sub_opts["history-key"] = k
                return k, check_safe(self.subchecker, test, subs[k],
                                     sub_opts)
            results = dict(bounded_pmap(one, ks, max_workers=8))
        valids = {k: (r or {}).get("valid?", True)
                  for k, r in results.items()}
        failures = [k for k, v in valids.items() if v is False]
        return {
            "valid?": merge_valid(valids.values()) if valids else True,
            "results": results,
            "failures": failures,
        }


def checker(subchecker, strict_device: bool = True) -> Checker:
    return IndependentChecker(subchecker, strict_device=strict_device)
