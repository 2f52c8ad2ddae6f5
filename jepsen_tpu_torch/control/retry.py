"""Retrying remote wrapper: reconnect + bounded retries around any Remote.

Reference: `jepsen/src/jepsen/control/retry.clj` — wraps a Remote in a
stateful auto-reconnecting connection and retries failed operations
**5 times** (`retry.clj:15-30`), because transient SSH failures (EOFs,
dropped channels, slow sshds) are routine during fault injection.

Delays follow capped exponential backoff with *decorrelated jitter*
(sleep = min(cap, U(base, 3·prev))) instead of the reference's fixed
~100 ms: when a partition heals, N workers all lost their connections
at the same instant, and a fixed delay has them retrying in lockstep —
hammering the node's sshd in synchronized waves. Jitter spreads them
out; the cap bounds the worst-case wait.

Commands that fail with a *nonzero exit status* are NOT retried — that's
a real result, not transport trouble. Only transport-level exceptions
trigger reconnect+retry.

`backoff()` (the port keeps it in `util`, beside the other host helpers)
is also the delay schedule for the checkers' device-fault recovery
ladders: a card that just ran out of memory or dropped off the bus is
the same shape of problem as a node whose sshd is drowning.
"""

from __future__ import annotations

import random as _random
import threading
import time

from ..util import BACKOFF_CAP_S, BACKOFF_S, backoff
from .core import Remote, RemoteError

RETRIES = 5


class RetryRemote(Remote):
    def __init__(self, inner: Remote, retries: int = RETRIES,
                 backoff_s: float = BACKOFF_S,
                 backoff_cap_s: float = BACKOFF_CAP_S,
                 rng: _random.Random | None = None):
        self.inner = inner          # unconnected prototype
        self.retries = retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.rng = rng
        self.conn_spec = None
        self._conn: Remote | None = None
        self._lock = threading.Lock()

    def connect(self, conn_spec: dict) -> "RetryRemote":
        r = RetryRemote(self.inner, self.retries, self.backoff_s,
                        self.backoff_cap_s, self.rng)
        r.conn_spec = dict(conn_spec)
        r._conn = self.inner.connect(conn_spec)
        return r

    def disconnect(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.disconnect()
                self._conn = None

    def _reconnect(self) -> Remote:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.disconnect()
                except Exception:
                    pass
            self._conn = self.inner.connect(self.conn_spec)
            return self._conn

    def _with_retry(self, f):
        last = None
        delays = backoff(self.backoff_s, self.backoff_cap_s, self.rng)
        for attempt in range(self.retries + 1):
            conn = self._conn
            if conn is None:
                try:
                    conn = self._reconnect()
                except Exception as e:
                    last = e
                    time.sleep(next(delays))
                    continue
            try:
                return f(conn)
            except RemoteError as e:
                # A real command result: propagate, don't retry.
                if e.exit is not None and e.exit >= 0:
                    raise
                last = e
            except Exception as e:
                last = e
            time.sleep(next(delays))
            try:
                self._reconnect()
            except Exception as e:
                last = e
        raise RemoteError(f"remote operation failed after "
                          f"{self.retries + 1} attempts: {last}",
                          getattr(last, "result", None) or {})

    def execute(self, context, action) -> dict:
        return self._with_retry(lambda c: c.execute(context, action))

    def upload(self, context, local_paths, remote_path, opts=None):
        return self._with_retry(
            lambda c: c.upload(context, local_paths, remote_path, opts))

    def download(self, context, remote_paths, local_path, opts=None):
        return self._with_retry(
            lambda c: c.download(context, remote_paths, local_path, opts))


def remote(inner: Remote, **kw) -> RetryRemote:
    return RetryRemote(inner, **kw)
