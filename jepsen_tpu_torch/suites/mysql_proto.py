"""Minimal pure-Python MySQL client protocol (for TiDB).

The reference's tidb suite talks to TiDB over JDBC/MySQL
(`tidb/src/tidb/sql.clj:1-60`). No MySQL driver ships in this
environment, so — like the zookeeper suite's jute client
(`zk_proto.py`) — this implements just the slice of the wire protocol
the suite needs: protocol-41 handshake with mysql_native_password,
COM_QUERY with text result sets, OK/ERR/EOF packets.

Values travel as text (the text protocol); rows come back as lists of
str-or-None. Errors raise MySQLError(code, message).
"""

from __future__ import annotations

import hashlib
import socket

from .netutil import nodelay
import struct

CLIENT_PROTOCOL_41 = 0x0200
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x0008_0000
CLIENT_CONNECT_WITH_DB = 0x0008

COM_QUIT = 0x01
COM_QUERY = 0x03
COM_PING = 0x0E


class MySQLError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"({code}) {message}")
        self.code = code
        self.message = message


def _scramble(password: str, salt: bytes) -> bytes:
    """mysql_native_password: SHA1(p) XOR SHA1(salt + SHA1(SHA1(p)))."""
    if not password:
        return b""
    p1 = hashlib.sha1(password.encode()).digest()
    p2 = hashlib.sha1(p1).digest()
    mix = hashlib.sha1(salt + p2).digest()
    return bytes(a ^ b for a, b in zip(p1, mix))


def _lenenc_int(b: bytes, off: int) -> tuple[int, int]:
    first = b[off]
    if first < 0xFB:
        return first, off + 1
    if first == 0xFC:
        return struct.unpack_from("<H", b, off + 1)[0], off + 3
    if first == 0xFD:
        return int.from_bytes(b[off + 1:off + 4], "little"), off + 4
    if first == 0xFE:
        return struct.unpack_from("<Q", b, off + 1)[0], off + 9
    raise MySQLError(-1, f"bad length-encoded integer 0x{first:x}")


def _lenenc_str(b: bytes, off: int) -> tuple[bytes | None, int]:
    if b[off] == 0xFB:  # NULL
        return None, off + 1
    n, off = _lenenc_int(b, off)
    return b[off:off + n], off + n


class Conn:
    """One MySQL connection. query() returns (rows, column_names) for
    result sets or (affected_rows, None) for OK responses."""

    def __init__(self, host: str, port: int = 4000, user: str = "root",
                 password: str = "", database: str = "",
                 timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout_s)
        nodelay(self.sock)
        self.seq = 0
        self._handshake(user, password, database)

    # -- packet framing ----------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise MySQLError(-1, "connection closed by server")
            buf += chunk
        return buf

    def _read_packet(self) -> bytes:
        head = self._read_exact(4)
        n = int.from_bytes(head[:3], "little")
        self.seq = (head[3] + 1) % 256
        return self._read_exact(n)

    def _send_packet(self, payload: bytes) -> None:
        head = len(payload).to_bytes(3, "little") + bytes([self.seq])
        self.sock.sendall(head + payload)
        self.seq = (self.seq + 1) % 256

    # -- handshake ---------------------------------------------------------

    def _handshake(self, user: str, password: str, database: str) -> None:
        greet = self._read_packet()
        if greet and greet[0] == 0xFF:
            raise self._err(greet)
        if greet[0] != 10:
            raise MySQLError(-1, f"unsupported protocol {greet[0]}")
        off = 1
        end = greet.index(0, off)
        off = end + 1          # server version
        off += 4               # thread id
        salt = greet[off:off + 8]
        off += 8 + 1           # auth data part 1 + filler
        off += 2 + 1 + 2 + 2   # caps low, charset, status, caps high
        if len(greet) > off:
            off += 1 + 10      # auth data len + reserved
            rest = greet[off:]
            salt2 = rest.split(b"\0", 1)[0] if rest else b""
            salt = (salt + salt2)[:20]
        caps = (CLIENT_PROTOCOL_41 | CLIENT_TRANSACTIONS |
                CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH)
        if database:
            caps |= CLIENT_CONNECT_WITH_DB
        auth = _scramble(password, salt)
        payload = struct.pack("<IIB23x", caps, 1 << 24, 33)
        payload += user.encode() + b"\0"
        payload += bytes([len(auth)]) + auth
        if database:
            payload += database.encode() + b"\0"
        payload += b"mysql_native_password\0"
        self._send_packet(payload)
        resp = self._read_packet()
        if resp and resp[0] == 0xFF:
            raise self._err(resp)
        # 0x00 OK; 0xFE auth-switch unsupported (TiDB doesn't send it
        # for mysql_native_password)
        if resp and resp[0] == 0xFE:
            raise MySQLError(-1, "auth method switch not supported")

    @staticmethod
    def _err(pkt: bytes) -> MySQLError:
        code = struct.unpack_from("<H", pkt, 1)[0]
        msg = pkt[3:].decode("utf-8", "replace")
        if msg.startswith("#"):
            msg = msg[6:]  # strip sql-state marker
        return MySQLError(code, msg)

    # -- queries -----------------------------------------------------------

    def query(self, sql: str) -> tuple:
        """Run one statement. Returns (rows, columns) for result sets —
        rows are lists of str|None — or (affected_rows, None) for DML."""
        self.seq = 0
        self._send_packet(bytes([COM_QUERY]) + sql.encode())
        pkt = self._read_packet()
        if pkt[0] == 0xFF:
            raise self._err(pkt)
        if pkt[0] == 0x00:  # OK
            affected, _ = _lenenc_int(pkt, 1)
            return affected, None
        ncols, _ = _lenenc_int(pkt, 0)
        cols = []
        for _ in range(ncols):
            cdef = self._read_packet()
            # column def41: catalog, schema, table, org_table, name, ...
            off = 0
            parts = []
            for _f in range(5):
                s, off = _lenenc_str(cdef, off)
                parts.append(s)
            cols.append((parts[4] or b"").decode())
        pkt = self._read_packet()
        if pkt[0] != 0xFE:  # EOF after column definitions
            raise MySQLError(-1, "expected EOF after column definitions")
        rows = []
        while True:
            pkt = self._read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:  # EOF
                break
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            off = 0
            row = []
            for _ in range(ncols):
                s, off = _lenenc_str(pkt, off)
                row.append(None if s is None else s.decode())
            rows.append(row)
        return rows, cols

    def ping(self) -> bool:
        self.seq = 0
        self._send_packet(bytes([COM_PING]))
        return self._read_packet()[0] == 0x00

    def close(self) -> None:
        try:
            self.seq = 0
            self._send_packet(bytes([COM_QUIT]))
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
