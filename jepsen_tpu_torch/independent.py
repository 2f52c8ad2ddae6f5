"""Key-sharded ("independent") checking: a test over many independent
keys, checked key by key.

Counterpart of `jepsen_tpu/independent.py` (reference
`jepsen/src/jepsen/independent.clj`), cut to the checking half: op values
are `(k, v)` tuples (`KV`), the history splits per key (`subhistory`),
and `IndependentChecker` checks each key's subhistory. The independent
generators are host code with no device path and are not ported yet.

Per-key subhistories are the batchable axis: when the subchecker is a
device-model linearizability checker, every key goes through one call of
`checker.wgl.analysis_gpu_batch`, whose walks check all keys of a group
in lockstep with one K1 or K2 launch for all of them.
"""

from __future__ import annotations

from .checker import Checker, check_safe, coerce, merge_valid
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
