"""Host utilities the port's checkers need.

The port's own copies of `jepsen_tpu/util.py`'s `bounded_pmap` and
`timeout` (with its `TIMED_OUT` sentinel), and of
`jepsen_tpu/control/retry.py`'s `backoff`, the delay schedule of the
recovery ladder.
"""

from __future__ import annotations

import concurrent.futures
import random as _random
import threading
from typing import Any, Callable, Iterable, Iterator

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


# distinct from anything a wrapped fn could return: pass
# ``default=TIMED_OUT`` to timeout() and compare with ``is``
TIMED_OUT = _TimedOut()


def timeout(seconds: float, fn: Callable[[], Any],
            default: Any = Timeout, name: str | None = None) -> Any:
    """Run fn in a daemon worker thread; past the deadline return
    ``default`` (or raise Timeout when no default is given). The worker
    is abandoned, not killed: fn runs on to its end in the background
    and its late result (or exception) is discarded."""
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
