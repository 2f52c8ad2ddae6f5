"""A minimal pure-Python ZooKeeper wire-protocol client.

The reference's zookeeper suite drives ZK through avout/the Java client
(`zookeeper/src/jepsen/zookeeper.clj:78-104`); this environment has no
ZK driver, so we speak the stable v3 client protocol directly: 4-byte
length-framed packets of jute-encoded records. Only the five ops a CAS
register needs are implemented — connect, create, getData, setData
(with version: the CAS primitive), exists, close.

Jute wire primitives: int32/int64 big-endian, boolean as one byte,
buffer as int32 length + bytes (-1 = null), string as UTF-8 buffer.
"""

from __future__ import annotations

import socket

from .netutil import nodelay
import struct
from dataclasses import dataclass
from typing import Optional

# op codes
CREATE = 1
DELETE = 2
EXISTS = 3
GET_DATA = 4
SET_DATA = 5
PING = 11
CLOSE = -11

# error codes
OK = 0
NONODE = -101
BADVERSION = -103
NODEEXISTS = -110

# ACL: world:anyone, all perms
OPEN_ACL_UNSAFE = [(0x1F, "world", "anyone")]


class ZkError(Exception):
    def __init__(self, code: int, op: str):
        self.code = code
        super().__init__(f"zookeeper error {code} in {op}")


# -- jute encoding ----------------------------------------------------------

def enc_int(v: int) -> bytes:
    return struct.pack(">i", v)


def enc_long(v: int) -> bytes:
    return struct.pack(">q", v)


def enc_bool(v: bool) -> bytes:
    return b"\x01" if v else b"\x00"


def enc_buffer(b: Optional[bytes]) -> bytes:
    if b is None:
        return enc_int(-1)
    return enc_int(len(b)) + b


def enc_string(s: str) -> bytes:
    return enc_buffer(s.encode())


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) < n:
            raise ZkError(-4, "short read")
        self.pos += n
        return b

    def int(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def long(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def buffer(self) -> Optional[bytes]:
        n = self.int()
        return None if n < 0 else self._take(n)

    def string(self) -> str:
        b = self.buffer()
        return "" if b is None else b.decode()


@dataclass
class Stat:
    czxid: int
    mzxid: int
    ctime: int
    mtime: int
    version: int
    cversion: int
    aversion: int
    ephemeral_owner: int
    data_length: int
    num_children: int
    pzxid: int

    @classmethod
    def read(cls, r: Reader) -> "Stat":
        return cls(r.long(), r.long(), r.long(), r.long(), r.int(),
                   r.int(), r.int(), r.long(), r.int(), r.int(), r.long())


def enc_acls(acls) -> bytes:
    out = enc_int(len(acls))
    for perms, scheme, ident in acls:
        out += enc_int(perms) + enc_string(scheme) + enc_string(ident)
    return out


# -- client -----------------------------------------------------------------

class ZooKeeper:
    """One session to one server. Not thread-safe; each test worker
    owns its own connection, matching the interpreter's
    one-client-per-process model."""

    def __init__(self, host: str, port: int = 2181,
                 timeout: float = 5.0, session_timeout_ms: int = 10_000):
        self.sock = socket.create_connection((host, port), timeout)
        nodelay(self.sock)
        self.sock.settimeout(timeout)
        self.xid = 0
        self._handshake(session_timeout_ms)

    # framing --------------------------------------------------------------

    def _send(self, payload: bytes) -> None:
        self.sock.sendall(enc_int(len(payload)) + payload)

    def _recv(self) -> bytes:
        hdr = self._recv_n(4)
        (n,) = struct.unpack(">i", hdr)
        return self._recv_n(n)

    def _recv_n(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ZkError(-4, "connection closed")
            out += chunk
        return out

    # session --------------------------------------------------------------

    def _handshake(self, session_timeout_ms: int) -> None:
        req = (enc_int(0) + enc_long(0) + enc_int(session_timeout_ms)
               + enc_long(0) + enc_buffer(b"\x00" * 16))
        self._send(req)
        r = Reader(self._recv())
        r.int()                      # protocol version
        self.negotiated_timeout = r.int()
        self.session_id = r.long()
        r.buffer()                   # session password

    def _request(self, op: int, payload: bytes) -> Reader:
        self.xid += 1
        self._send(enc_int(self.xid) + enc_int(op) + payload)
        r = Reader(self._recv())
        r.int()                      # xid
        r.long()                     # zxid
        err = r.int()
        if err != OK:
            raise ZkError(err, f"op {op}")
        return r

    # ops ------------------------------------------------------------------

    def create(self, path: str, data: bytes,
               acls=OPEN_ACL_UNSAFE, flags: int = 0) -> str:
        r = self._request(CREATE, enc_string(path) + enc_buffer(data)
                          + enc_acls(acls) + enc_int(flags))
        return r.string()

    def get_data(self, path: str) -> tuple[bytes, Stat]:
        r = self._request(GET_DATA, enc_string(path) + enc_bool(False))
        data = r.buffer() or b""
        return data, Stat.read(r)

    def set_data(self, path: str, data: bytes, version: int = -1) -> Stat:
        r = self._request(SET_DATA, enc_string(path) + enc_buffer(data)
                          + enc_int(version))
        return Stat.read(r)

    def exists(self, path: str) -> Optional[Stat]:
        try:
            r = self._request(EXISTS, enc_string(path) + enc_bool(False))
            return Stat.read(r)
        except ZkError as e:
            if e.code == NONODE:
                return None
            raise

    def delete(self, path: str, version: int = -1) -> None:
        self._request(DELETE, enc_string(path) + enc_int(version))

    def close(self) -> None:
        try:
            self.xid += 1
            self._send(enc_int(self.xid) + enc_int(CLOSE))
        except OSError:
            pass
        finally:
            self.sock.close()
