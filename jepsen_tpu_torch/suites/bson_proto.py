"""Minimal pure-Python BSON + MongoDB OP_MSG wire client.

The reference's mongodb suites talk to mongod through the monger/Java
driver (`mongodb-rocks/src/jepsen/mongodb_rocks.clj:15-27`). This
implements the slice needed to drive a replica set: the BSON scalar/
document/array types the commands use, OP_MSG framing (opcode 2013,
kind-0 body section), and a `Conn.command(db, doc)` request/reply
call. Commands raise MongoError on {'ok': 0} replies.
"""

from __future__ import annotations

import socket

from .netutil import nodelay
import struct
import threading

OP_MSG = 2013


class MongoError(Exception):
    def __init__(self, code, message):
        super().__init__(f"({code}) {message}")
        self.code = code
        self.message = message


class WriteConcernError(MongoError):
    """The write applied locally but the requested write concern was
    not satisfied — durability is unknown, so callers must record the
    op as :info (indeterminate), never :fail."""


# -- BSON --------------------------------------------------------------------

def _encode_value(name: bytes, v) -> bytes:
    if v is None:
        return b"\x0a" + name + b"\0"
    if isinstance(v, bool):
        return b"\x08" + name + b"\0" + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + name + b"\0" + struct.pack("<i", v)
        return b"\x12" + name + b"\0" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + name + b"\0" + struct.pack("<d", v)
    if isinstance(v, str):
        b = v.encode()
        return b"\x02" + name + b"\0" + \
            struct.pack("<i", len(b) + 1) + b + b"\0"
    if isinstance(v, dict):
        return b"\x03" + name + b"\0" + encode_doc(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + name + b"\0" + encode_doc(
            {str(i): x for i, x in enumerate(v)})
    raise TypeError(f"cannot BSON-encode {type(v)}")


def encode_doc(doc: dict) -> bytes:
    body = b"".join(_encode_value(str(k).encode(), v)
                    for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\0"


def _decode_value(t: int, b: bytes, off: int):
    if t == 0x0A:
        return None, off
    if t == 0x08:
        return b[off] == 1, off + 1
    if t == 0x10:
        return struct.unpack_from("<i", b, off)[0], off + 4
    if t == 0x12:
        return struct.unpack_from("<q", b, off)[0], off + 8
    if t == 0x01:
        return struct.unpack_from("<d", b, off)[0], off + 8
    if t == 0x02:
        n = struct.unpack_from("<i", b, off)[0]
        return b[off + 4:off + 4 + n - 1].decode(), off + 4 + n
    if t == 0x03:
        n = struct.unpack_from("<i", b, off)[0]
        return decode_doc(b[off:off + n]), off + n
    if t == 0x04:
        n = struct.unpack_from("<i", b, off)[0]
        d = decode_doc(b[off:off + n])
        return [d[k] for k in sorted(d, key=int)], off + n
    if t == 0x11:  # timestamp
        return struct.unpack_from("<q", b, off)[0], off + 8
    if t == 0x07:  # objectid: pass through as hex
        return b[off:off + 12].hex(), off + 12
    if t == 0x09:  # UTC datetime
        return struct.unpack_from("<q", b, off)[0], off + 8
    raise MongoError(-1, f"cannot BSON-decode type 0x{t:02x}")


def decode_doc(b: bytes) -> dict:
    out: dict = {}
    off = 4
    while b[off] != 0:
        t = b[off]
        off += 1
        end = b.index(0, off)
        name = b[off:end].decode()
        off = end + 1
        out[name], off = _decode_value(t, b, off)
    return out


# -- OP_MSG ------------------------------------------------------------------

class Conn:
    """One mongod connection in OP_MSG mode."""

    def __init__(self, host: str, port: int = 27017,
                 timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout_s)
        nodelay(self.sock)
        self.req_id = 0
        self.lock = threading.Lock()

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise MongoError(-1, "connection closed by server")
            buf += chunk
        return buf

    def command(self, db: str, cmd: dict) -> dict:
        """Run one command; returns the reply doc, raising MongoError
        on ok == 0."""
        doc = dict(cmd)
        doc["$db"] = db
        body = struct.pack("<I", 0) + b"\x00" + encode_doc(doc)
        with self.lock:
            self.req_id += 1
            header = struct.pack("<iiii", 16 + len(body), self.req_id,
                                 0, OP_MSG)
            self.sock.sendall(header + body)
            raw = self._read_exact(16)
            length, _rid, _rto, opcode = struct.unpack("<iiii", raw)
            payload = self._read_exact(length - 16)
        if opcode != OP_MSG:
            raise MongoError(-1, f"unexpected opcode {opcode}")
        # flagBits(4) + kind byte + doc
        reply = decode_doc(payload[5:])
        if not reply.get("ok"):
            raise MongoError(reply.get("code", -1),
                             reply.get("errmsg", "command failed"))
        # MongoDB reports per-document write failures and unsatisfied
        # write concern on ok:1 replies — surface them, or callers
        # would record failed / non-majority-durable writes as :ok.
        if reply.get("writeErrors"):
            we = reply["writeErrors"][0]
            raise MongoError(we.get("code", -1),
                             we.get("errmsg", "write error"))
        if reply.get("writeConcernError"):
            wce = reply["writeConcernError"]
            raise WriteConcernError(wce.get("code", -1),
                                    wce.get("errmsg",
                                            "write concern error"))
        return reply

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
