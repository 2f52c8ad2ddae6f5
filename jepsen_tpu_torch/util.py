"""Kitchen-sink utilities shared across layers.

The port's own copy of `jepsen_tpu/util.py`, with `backoff` (the delay
schedule of the recovery ladder and the control layer's retries, from
`jepsen_tpu/control/retry.py`) beside it. Behavioral parity targets from
the reference's `jepsen/src/jepsen/util.clj`: `real-pmap` (crash-safe
parallel map, :65), `with-relative-time` / `relative-time-nanos`
(:333-347), `timeout` (:370), `await-fn` (:383), `nemesis-intervals`
(:736), `history->latencies` (:700), `integer-interval-set-str` (:629),
`named-locks` (:860).
"""

from __future__ import annotations

import concurrent.futures
import math
import random as _random
import threading
import time as _time
from typing import Any, Callable, Iterable, Iterator, Sequence

BACKOFF_S = 0.1       # base (and first) delay
BACKOFF_CAP_S = 2.0   # delays never exceed this


def backoff(base_s: float = BACKOFF_S, cap_s: float = BACKOFF_CAP_S,
            rng: _random.Random | None = None) -> Iterator[float]:
    """Infinite generator of retry delays: base first, then
    decorrelated jitter — sleep = min(cap, U(base, 3·prev)). Every delay
    lies in [base, cap]. Pass a seeded rng for a deterministic
    schedule."""
    u = (rng or _random).uniform
    sleep = base_s
    while True:
        yield sleep
        sleep = min(cap_s, u(base_s, sleep * 3))


# ---------------------------------------------------------------------------
# Relative time
# ---------------------------------------------------------------------------

# Active origins, newest last. A stack removed-by-identity (not a
# saved/restored single slot) so CONCURRENT runs — e.g. several tests
# feeding one verification service — can't leak a dead run's origin:
# with save/restore, interleaved exits re-installed a sibling's saved
# value after that sibling had already finished. Overlapping runs
# still share the newest origin (op times are per-run relative and
# the interpreter's workers must see their spawner's origin, so a
# thread-local can't work here); exits are now always clean.
_ORIGIN_STACK: list["relative_time"] = []


class relative_time:
    """Context manager establishing t=0 for a test run; all op :time fields
    are nanoseconds since this origin (reference util.clj:333-347). Nesting
    restores the enclosing origin on exit, like dynamic binding."""

    def __enter__(self):
        self.origin = _time.monotonic_ns()
        _ORIGIN_STACK.append(self)
        return self

    def __exit__(self, *exc):
        try:
            # remove THIS context wherever it sits (identity ==), not
            # necessarily the top: a concurrent sibling may have
            # entered after us and still be running
            _ORIGIN_STACK.remove(self)
        except ValueError:
            pass
        return False


def relative_time_nanos() -> int:
    if not _ORIGIN_STACK:
        raise RuntimeError("relative_time_nanos called outside relative_time")
    return _time.monotonic_ns() - _ORIGIN_STACK[-1].origin


def ms_to_nanos(ms: float) -> int:
    return int(ms * 1_000_000)


def nanos_to_ms(ns: float) -> float:
    return ns / 1_000_000


def secs_to_nanos(s: float) -> int:
    return int(s * 1_000_000_000)


def nanos_to_secs(ns: float) -> float:
    return ns / 1_000_000_000


# ---------------------------------------------------------------------------
# Parallelism
# ---------------------------------------------------------------------------

def real_pmap(fn: Callable, coll: Iterable) -> list:
    """Parallel map over real threads, one per element. If any element's fn
    throws, the first *interesting* exception propagates after all threads
    finish — barrier/interrupt noise from sibling branches is passed over
    so it can't mask a root cause (reference real-pmap / dom-top)."""
    items = list(coll)
    if not items:
        return []
    if len(items) == 1:
        return [fn(items[0])]
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(items)) as ex:
        futures = [ex.submit(fn, x) for x in items]
        results, excs = [], []
        for fut in futures:
            try:
                results.append(fut.result())
            except BaseException as e:  # noqa: BLE001 — propagate any crash
                excs.append(e)
        if excs:
            # Prefer an *interesting* exception: when one branch crashes
            # for a real reason, sibling branches often die with barrier/
            # interrupt noise that would mask the root cause (reference
            # dom-top real-pmap-helper).
            boring = (threading.BrokenBarrierError, InterruptedError)
            raise next((e for e in excs if not isinstance(e, boring)),
                       excs[0])
        return results


def bounded_pmap(fn: Callable, coll: Iterable, max_workers: int = 16) -> list:
    """Parallel map with bounded concurrency, preserving order."""
    items = list(coll)
    if not items:
        return []
    workers = max(1, min(max_workers, len(items)))
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, items))


class Timeout(Exception):
    pass


class _TimedOut:
    """Sentinel type for TIMED_OUT; falsy so guards read naturally."""

    def __repr__(self):
        return "<util.TIMED_OUT>"

    def __bool__(self):
        return False


# Distinct from anything a wrapped fn could return: pass
# ``default=TIMED_OUT`` to timeout() and compare with ``is``.
TIMED_OUT = _TimedOut()


def timeout(seconds: float, fn: Callable[[], Any],
            default: Any = Timeout, name: str | None = None) -> Any:
    """Run fn in a daemon worker thread; if it exceeds the deadline
    return ``default`` (or raise Timeout when no default is given).

    The reference's `timeout` (util.clj:370) *interrupts* its thread;
    Python threads cannot be interrupted, so the worker here is
    **abandoned**, not killed: fn keeps running in the background until
    it finishes on its own, and its late return value (or late
    exception) is discarded — it is never delivered to any caller. fns
    must therefore tolerate running to completion after their caller
    has moved on (idempotent teardown, no half-owned locks). Pass
    ``default=TIMED_OUT`` to get a sentinel distinct from anything fn
    itself could return. ``name`` labels the worker thread, so an
    abandoned hang is attributable in a thread dump (the device-sync
    watchdog names its guards after the sync site)."""
    box: list = []

    def run():
        try:
            box.append(("ok", fn()))
        except BaseException as e:  # noqa: BLE001
            box.append(("err", e))

    t = threading.Thread(target=run, daemon=True, name=name)
    t.start()
    t.join(seconds)
    if not box:
        if default is Timeout:
            raise Timeout(f"timed out after {seconds}s")
        return default
    tag, val = box[0]
    if tag == "err":
        raise val
    return val


def await_fn(fn: Callable[[], Any], retry_interval: float = 1.0,
             timeout_secs: float = 60.0, log_message: str | None = None,
             log_interval: float | None = 10.0) -> Any:
    """Invoke fn until it returns without throwing; retry every
    retry_interval seconds up to timeout_secs (reference util.clj:383-424)."""
    deadline = _time.monotonic() + timeout_secs
    last_log = _time.monotonic()
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001
            now = _time.monotonic()
            if now >= deadline:
                raise Timeout(
                    f"timed out after {timeout_secs}s awaiting "
                    f"{log_message or fn}") from e
            if (log_message and log_interval
                    and now - last_log >= log_interval):
                print(log_message)
                last_log = now
            _time.sleep(min(retry_interval, max(0.0, deadline - now)))


class NamedLocks:
    """A family of locks, one per name (reference util.clj:860)."""

    def __init__(self):
        self._locks: dict = {}
        self._guard = threading.Lock()

    def lock(self, name) -> threading.Lock:
        with self._guard:
            if name not in self._locks:
                self._locks[name] = threading.Lock()
            return self._locks[name]


# ---------------------------------------------------------------------------
# History analysis helpers
# ---------------------------------------------------------------------------

def history_latencies(hist) -> list[dict]:
    """The same history, but every invocation gains :latency (ns to
    completion) and :completion (the completing op); completions gain
    :latency too. Pending invocations pass through unannotated
    (reference util.clj history->latencies, :700)."""
    from .history import is_invoke
    out: list[dict] = []
    open_idx: dict = {}  # process -> index into out
    for o in hist:
        if is_invoke(o):
            out.append(o)
            open_idx[o["process"]] = len(out) - 1
        else:
            i = open_idx.pop(o["process"], None)
            if i is not None:
                inv = out[i]
                latency = o["time"] - inv["time"]
                o = dict(o)
                o["latency"] = latency
                out[i] = {**inv, "latency": latency, "completion": o}
            out.append(o)
    return out


def nemesis_intervals(hist, start_fs: set | None = None,
                      stop_fs: set | None = None) -> list[tuple]:
    """Pairs of (start-op, stop-op-or-None) nemesis activity intervals
    (reference util.clj nemesis-intervals, :736-782). Nemesis ops arrive in
    invoke/complete pairs; a stop pair closes *all* open start pairs:
    start1 start2 stop1 yields [s1a stop1a] [s1b stop1b] [s2a stop1a]
    [s2b stop1b]. Unclosed starts pair with None."""
    from .history import NEMESIS
    start_fs = start_fs or {"start"}
    stop_fs = stop_fs or {"stop"}
    nem = [o for o in hist if o.get("process") == NEMESIS]
    # Group into invoke/complete pairs with matching :f.
    pairs = [(a, b) for a, b in zip(nem[::2], nem[1::2])
             if a.get("f") == b.get("f")]
    intervals: list[tuple] = []
    starts: list[tuple] = []
    for a, b in pairs:
        if a["f"] in start_fs:
            starts.append((a, b))
        elif a["f"] in stop_fs:
            for s1, s2 in starts:
                intervals.append((s1, a))
                intervals.append((s2, b))
            starts = []
    for s1, s2 in starts:
        intervals.append((s1, None))
        intervals.append((s2, None))
    return intervals


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """Compact string for a set of integers: '#{1 3..5 7}'
    (reference util.clj integer-interval-set-str, :629-654). Any run of
    length >= 2 renders as 'start..end'; None elements fall back to a
    plain set rendering."""
    xs = list(xs)
    if any(x is None for x in xs):
        return "#{" + " ".join(str(x) for x in xs) + "}"
    xs = sorted(set(xs))
    parts = []
    i = 0
    while i < len(xs):
        j = i
        while j + 1 < len(xs) and xs[j + 1] == xs[j] + 1:
            j += 1
        parts.append(str(xs[i]) if j == i else f"{xs[i]}..{xs[j]}")
        i = j + 1
    return "#{" + " ".join(parts) + "}"


def longest_common_prefix(seqs: Sequence[Sequence]) -> list:
    if not seqs:
        return []
    prefix = list(seqs[0])
    for s in seqs[1:]:
        n = 0
        for a, b in zip(prefix, s):
            if a != b:
                break
            n += 1
        prefix = prefix[:n]
        if not prefix:
            break
    return prefix


def majority(n: int) -> int:
    """Smallest majority of n: majority(5) = 3."""
    return n // 2 + 1


def quantile(sorted_xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of a pre-sorted sequence."""
    if not sorted_xs:
        return math.nan
    i = min(len(sorted_xs) - 1, max(0, math.ceil(q * len(sorted_xs)) - 1))
    return sorted_xs[i]


def fraction(a: float, b: float) -> float:
    """a/b, but 1 when b is 0 (reference checker stats convention)."""
    return a / b if b else 1.0
