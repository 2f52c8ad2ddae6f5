"""Stateful auto-reconnecting connection wrapper.

The port's copy of `jepsen_tpu/reconnect.py`, which the verification
service's client (`service.ServiceClient`) keeps its socket in.
Reference: `jepsen/src/jepsen/reconnect.clj` — a read/write-locked mutable
wrapper around an open/close/name function triple: many threads may use
the connection concurrently (read lock); reopening it takes the write
lock so exactly one reopen happens and in-flight users drain first.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class _RWLock:
    """Writer-preferring read/write lock (stdlib has none)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class Wrapper:
    """A reconnectable connection: `wrapper(open=..., close=..., name=...)`
    (`reconnect.clj:16-32`). Use with_conn/reopen."""

    def __init__(self, open: Callable[[], Any],
                 close: Callable[[Any], None] = lambda c: None,
                 log: Callable[[str], None] | None = None,
                 name: str | None = None):
        self._open = open
        self._close = close
        self._log = log
        self.name = name
        self._lock = _RWLock()
        self._conn: Any = None
        self._opened = False

    def open(self) -> "Wrapper":
        self._lock.acquire_write()
        try:
            if not self._opened:
                self._conn = self._open()
                self._opened = True
        finally:
            self._lock.release_write()
        return self

    def conn(self) -> Any:
        if not self._opened:
            self.open()
        return self._conn

    def reopen(self) -> "Wrapper":
        """Close and reopen under the write lock (`reconnect.clj:60-80`)."""
        self._lock.acquire_write()
        try:
            if self._log:
                self._log(f"Reopening connection {self.name or ''}")
            if self._opened:
                try:
                    self._close(self._conn)
                except Exception:
                    pass
            self._conn = self._open()
            self._opened = True
        finally:
            self._lock.release_write()
        return self

    def close(self) -> None:
        self._lock.acquire_write()
        try:
            if self._opened:
                try:
                    self._close(self._conn)
                finally:
                    self._conn = None
                    self._opened = False
        finally:
            self._lock.release_write()

    def with_conn(self, f: Callable[[Any], Any]) -> Any:
        """Run f(conn) under the read lock; on error, reopen the
        connection and re-raise (`reconnect.clj:82-110`)."""
        if not self._opened:
            self.open()  # before the read lock: open() takes the write lock
        self._lock.acquire_read()
        try:
            return f(self._conn)
        except Exception:
            self._lock.release_read()
            try:
                self.reopen()
            except Exception:
                pass
            self._lock.acquire_read()  # rebalance for finally
            raise
        finally:
            self._lock.release_read()


def wrapper(open, close=lambda c: None, log=None, name=None) -> Wrapper:
    return Wrapper(open, close, log, name)
