"""Minimal pure-Python RESP (REdis Serialization Protocol) client —
the wire protocol spoken by Disque (reference
`disque/src/jepsen/disque.clj`, via the Jedisque Java driver) and by
redis-family systems like raftis
(`raftis/src/jepsen/system/raftis.clj`).

Commands go as RESP arrays of bulk strings; replies parse into
str | int | None | list | RESPError.
"""

from __future__ import annotations

import socket

from .netutil import nodelay


class RESPError(Exception):
    pass


class Conn:
    def __init__(self, host: str, port: int, timeout_s: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout_s)
        nodelay(self.sock)
        self.buf = b""

    def _line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise RESPError("connection closed by server")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise RESPError("connection closed by server")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def _reply(self):
        line = self._line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RESPError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = self._exact(n)
            self._exact(2)  # trailing \r\n
            return data.decode()
        if t == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._reply() for _ in range(n)]
        raise RESPError(f"bad reply type {t!r}")

    def call(self, *args):
        """Send one command, return its parsed reply."""
        out = b"*%d\r\n" % len(args)
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out += b"$%d\r\n%s\r\n" % (len(b), b)
        self.sock.sendall(out)
        return self._reply()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
