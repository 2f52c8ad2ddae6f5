"""Minimal pure-Python PostgreSQL v3 wire client (for CockroachDB).

The reference's cockroachdb suite talks Postgres-protocol JDBC
(`cockroachdb/src/jepsen/cockroach/client.clj:1-60`). This implements
the slice the suite needs against an insecure (trust-auth) CockroachDB:
startup, simple Query, text result sets, transaction status tracking.

Rows come back as lists of str-or-None. Errors raise
PGError(code, message) carrying the SQLSTATE (e.g. '40001' for
serialization conflicts, which CockroachDB asks clients to retry).
"""

from __future__ import annotations

import socket

from .netutil import nodelay
import struct


class PGError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message


class Conn:
    """One Postgres connection in simple-query mode.

    txn_status after each query is 'I' (idle), 'T' (in transaction), or
    'E' (in failed transaction) — from ReadyForQuery."""

    def __init__(self, host: str, port: int = 26257, user: str = "root",
                 database: str = "", timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout_s)
        nodelay(self.sock)
        self.txn_status = "I"
        params = ["user", user]
        if database:
            params += ["database", database]
        body = struct.pack("!I", 196608)  # protocol 3.0
        for p in params:
            body += p.encode() + b"\0"
        body += b"\0"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        self._until_ready(startup=True)

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise PGError("08006", "connection closed by server")
            buf += chunk
        return buf

    def _read_msg(self) -> tuple[bytes, bytes]:
        head = self._read_exact(5)
        typ = head[:1]
        n = struct.unpack("!I", head[1:])[0] - 4
        return typ, self._read_exact(n)

    @staticmethod
    def _error(body: bytes) -> PGError:
        code, msg = "XX000", ""
        for field in body.split(b"\0"):
            if not field:
                continue
            if field[0:1] == b"C":
                code = field[1:].decode()
            elif field[0:1] == b"M":
                msg = field[1:].decode("utf-8", "replace")
        return PGError(code, msg)

    def _until_ready(self, startup: bool = False):
        """Consume messages until ReadyForQuery; returns (rows, cols,
        complete_tags, error)."""
        rows: list = []
        cols: list = []
        tags: list = []
        err: PGError | None = None
        while True:
            typ, body = self._read_msg()
            if typ == b"R":
                auth = struct.unpack("!I", body[:4])[0]
                if auth != 0:
                    raise PGError("28000",
                                  f"unsupported auth method {auth}")
            elif typ in (b"S", b"K", b"N"):  # params, key data, notices
                pass
            elif typ == b"T":
                n = struct.unpack("!H", body[:2])[0]
                off = 2
                cols = []
                for _ in range(n):
                    end = body.index(0, off)
                    cols.append(body[off:end].decode())
                    off = end + 1 + 18  # per-column fixed fields
            elif typ == b"D":
                n = struct.unpack("!H", body[:2])[0]
                off = 2
                row = []
                for _ in range(n):
                    ln = struct.unpack_from("!i", body, off)[0]
                    off += 4
                    if ln < 0:
                        row.append(None)
                    else:
                        row.append(body[off:off + ln].decode())
                        off += ln
                rows.append(row)
            elif typ == b"C":
                tags.append(body.rstrip(b"\0").decode())
            elif typ == b"E":
                err = err or self._error(body)
            elif typ == b"Z":
                self.txn_status = body[:1].decode()
                return rows, cols, tags, err
            elif typ == b"I":  # EmptyQueryResponse
                pass
            else:
                pass  # ignore unknown message types
            if startup and typ == b"E":
                raise self._error(body)

    def query(self, sql: str) -> tuple:
        """Run one simple query. Returns (rows, columns) for result
        sets, (affected, None) otherwise. Raises PGError on error."""
        body = sql.encode() + b"\0"
        self.sock.sendall(b"Q" + struct.pack("!I", len(body) + 4) + body)
        rows, cols, tags, err = self._until_ready()
        if err is not None:
            raise err
        if cols:
            return rows, cols
        affected = 0
        for t in tags:
            parts = t.split()
            if parts and parts[-1].isdigit():
                affected += int(parts[-1])
        return affected, None

    def close(self) -> None:
        try:
            self.sock.sendall(b"X" + struct.pack("!I", 4))
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
