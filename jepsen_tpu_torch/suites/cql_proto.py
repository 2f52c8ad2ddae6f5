"""Minimal CQL binary-protocol (v4) client.

The reference's YCQL layer drives YugaByte's Cassandra-compatible API
through the DataStax Java driver + Cassaforte
(Jepsen's `yugabyte/src/yugabyte/ycql/client.clj:75-127`). We
speak the wire protocol directly instead — same design as the suite
catalog's other hand-rolled clients (`mysql_proto.py`, `pg_proto.py`):
no driver dependency, and hermetic tests can run against an in-process
protocol fake (`tests/fake_cql.py`).

Scope: STARTUP/READY handshake, QUERY with a consistency level and no
bound values (statements carry inline literals, as the reference's
string-munged transactions do, `ycql/bank.clj:47-58`), RESULT parsing
for void / rows / set-keyspace / schema-change, and ERROR frames. No
prepared statements, paging, events, or compression — the suites don't
need them.
"""

from __future__ import annotations

import socket
import time as _time

from .netutil import nodelay
import struct

# request/response opcodes (protocol spec §2.4)
OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_QUERY = 0x07
OP_RESULT = 0x08

RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002
RESULT_SET_KEYSPACE = 0x0003
RESULT_SCHEMA_CHANGE = 0x0005

CONSISTENCY = {
    "ANY": 0x0000, "ONE": 0x0001, "TWO": 0x0002, "THREE": 0x0003,
    "QUORUM": 0x0004, "ALL": 0x0005, "LOCAL_QUORUM": 0x0006,
    "EACH_QUORUM": 0x0007, "SERIAL": 0x0008, "LOCAL_SERIAL": 0x0009,
    "LOCAL_ONE": 0x000A,
}

# error codes we classify on (§9)
ERR_SERVER = 0x0000
ERR_UNAVAILABLE = 0x1000
ERR_OVERLOADED = 0x1001
ERR_WRITE_TIMEOUT = 0x1100
ERR_READ_TIMEOUT = 0x1200
ERR_SYNTAX = 0x2000
ERR_INVALID = 0x2200
ERR_ALREADY_EXISTS = 0x2400

# column type option ids (§4.2.5.2) we decode
TYPE_ASCII = 0x0001
TYPE_BIGINT = 0x0002
TYPE_BLOB = 0x0003
TYPE_BOOLEAN = 0x0004
TYPE_COUNTER = 0x0005
TYPE_DOUBLE = 0x0007
TYPE_INT = 0x0009
TYPE_TEXT = 0x000A
TYPE_VARCHAR = 0x000D


class CQLError(Exception):
    """An ERROR frame: code + server message."""

    def __init__(self, code: int, message: str):
        self.code = code
        self.message = message
        super().__init__(f"[{code:#06x}] {message}")

    @property
    def timeout(self) -> bool:
        return self.code in (ERR_WRITE_TIMEOUT, ERR_READ_TIMEOUT)

    @property
    def unavailable(self) -> bool:
        return self.code in (ERR_UNAVAILABLE, ERR_OVERLOADED)


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("!H", len(b)) + b


def _long_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("!i", len(b)) + b


def _string_map(m: dict) -> bytes:
    out = struct.pack("!H", len(m))
    for k, v in m.items():
        out += _string(k) + _string(v)
    return out


def decode_value(type_id: int, raw: bytes | None):
    """Decode one [bytes] cell by its column-spec type."""
    if raw is None:
        return None
    if type_id == TYPE_INT:
        return struct.unpack("!i", raw)[0]
    if type_id in (TYPE_BIGINT, TYPE_COUNTER):
        return struct.unpack("!q", raw)[0]
    if type_id == TYPE_BOOLEAN:
        return raw != b"\x00"
    if type_id == TYPE_DOUBLE:
        return struct.unpack("!d", raw)[0]
    if type_id in (TYPE_ASCII, TYPE_VARCHAR, TYPE_TEXT):
        return raw.decode()
    return raw  # blob / unknown: raw bytes


class Conn:
    """One CQL connection. `query` returns (rows, cols) for row
    results — rows are lists of decoded Python values — and (None,
    None) for void/DDL results."""

    def __init__(self, host: str, port: int = 9042,
                 keyspace: str | None = None, timeout_s: float = 10.0,
                 connect_timeout_s: float | None = None):
        self.host, self.port = host, port
        self.timeout_s = timeout_s
        self.sock = socket.create_connection(
            (host, port), timeout=connect_timeout_s or timeout_s)
        nodelay(self.sock)
        self.sock.settimeout(timeout_s)
        self._stream = 0
        self._startup()
        if keyspace:
            self.query(f"USE {keyspace}")

    # -- framing -------------------------------------------------------------

    def _send(self, opcode: int, body: bytes) -> None:
        self._stream = (self._stream + 1) % 32768
        hdr = struct.pack("!BBhBI", 0x04, 0x00, self._stream, opcode,
                          len(body))
        self.sock.sendall(hdr + body)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed connection")
            buf += chunk
        return buf

    def _recv_frame(self) -> tuple[int, bytes]:
        """Read frames until one matches the request's stream id.

        Stale frames (late responses to an earlier, abandoned request)
        and EVENT pushes (stream -1) are discarded rather than being
        misread as the current query's result — the correlation the
        reference gets for free from the DataStax driver. Flag bits
        that prepend sections to the body (tracing 0x02, custom
        payload 0x04, warning 0x08) are stripped so result offsets
        stay correct."""
        # time-bounded drain: a long stale backlog must not turn a
        # recoverable read into connection churn. The bound is on the
        # INTER-frame gap (reset after every frame), not the total
        # drain — a response that is still flowing in behind stale
        # frames must be delivered, however long the backlog. A large
        # absolute frame cap backstops a server looping stale frames.
        window = self.sock.gettimeout() or 5.0
        deadline = _time.monotonic() + window
        for _ in range(4096):
            if _time.monotonic() >= deadline:
                break
            hdr = self._recv_exact(9)
            deadline = _time.monotonic() + window
            _ver, flags, stream, opcode, length = struct.unpack(
                "!BBhBI", hdr)
            body = self._recv_exact(length)
            if stream != self._stream:
                continue  # EVENT (-1) or stale response: drop
            if flags & 0x01:
                raise ConnectionError("unexpected compressed frame")
            pos = 0
            if flags & 0x02:  # tracing id: [uuid]
                pos += 16
            if flags & 0x08:  # warnings: [string list] (before payload)
                (n,) = struct.unpack("!H", body[pos:pos + 2])
                pos += 2
                for _i in range(n):
                    (slen,) = struct.unpack("!H", body[pos:pos + 2])
                    pos += 2 + slen
            if flags & 0x04:  # custom payload: [bytes map]
                (n,) = struct.unpack("!H", body[pos:pos + 2])
                pos += 2
                for _i in range(n):
                    (klen,) = struct.unpack("!H", body[pos:pos + 2])
                    pos += 2 + klen
                    (vlen,) = struct.unpack("!i", body[pos:pos + 4])
                    pos += 4 + max(vlen, 0)
            return opcode, body[pos:]
        raise ConnectionError(
            "no frame for current stream id within the timeout window")

    # -- handshake -----------------------------------------------------------

    def _startup(self) -> None:
        self._send(OP_STARTUP, _string_map({"CQL_VERSION": "3.0.0"}))
        opcode, body = self._recv_frame()
        if opcode == OP_ERROR:
            raise self._error(body)
        if opcode != OP_READY:
            raise ConnectionError(f"expected READY, got opcode {opcode}")

    @staticmethod
    def _error(body: bytes) -> CQLError:
        code = struct.unpack("!i", body[:4])[0]
        (mlen,) = struct.unpack("!H", body[4:6])
        return CQLError(code, body[6:6 + mlen].decode())

    # -- queries -------------------------------------------------------------

    def query(self, cql: str, consistency: str = "QUORUM",
              timeout_s: float | None = None) -> tuple:
        """Run one statement; inline literals only (flags byte 0x00 —
        no bound values)."""
        if timeout_s is not None:
            self.sock.settimeout(timeout_s)
        try:
            body = (_long_string(cql)
                    + struct.pack("!H", CONSISTENCY[consistency])
                    + b"\x00")
            self._send(OP_QUERY, body)
            opcode, rbody = self._recv_frame()
        finally:
            if timeout_s is not None:
                self.sock.settimeout(self.timeout_s)
        if opcode == OP_ERROR:
            raise self._error(rbody)
        if opcode != OP_RESULT:
            raise ConnectionError(f"expected RESULT, got opcode {opcode}")
        return self._parse_result(rbody)

    def _parse_result(self, body: bytes) -> tuple:
        (kind,) = struct.unpack("!i", body[:4])
        if kind != RESULT_ROWS:
            return None, None
        pos = 4
        flags, col_count = struct.unpack("!ii", body[pos:pos + 8])
        pos += 8
        global_spec = bool(flags & 0x0001)

        def read_string():
            nonlocal pos
            (n,) = struct.unpack("!H", body[pos:pos + 2])
            pos += 2
            s = body[pos:pos + n].decode()
            pos += n
            return s

        if global_spec:
            read_string()  # keyspace
            read_string()  # table
        cols, types = [], []
        for _ in range(col_count):
            if not global_spec:
                read_string()
                read_string()
            cols.append(read_string())
            (tid,) = struct.unpack("!H", body[pos:pos + 2])
            pos += 2
            types.append(tid)
            # no nested type params for the scalar types we use
        (row_count,) = struct.unpack("!i", body[pos:pos + 4])
        pos += 4
        rows = []
        for _ in range(row_count):
            row = []
            for tid in types:
                (n,) = struct.unpack("!i", body[pos:pos + 4])
                pos += 4
                if n < 0:
                    row.append(None)
                else:
                    row.append(decode_value(tid, body[pos:pos + n]))
                    pos += n
            rows.append(row)
        return rows, cols

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def rows_as_dicts(result: tuple) -> list[dict]:
    """(rows, cols) -> list of {col: value} maps."""
    rows, cols = result
    return [dict(zip(cols, r)) for r in (rows or [])]
