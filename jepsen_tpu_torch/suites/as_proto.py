"""Minimal Aerospike binary wire client.

The reference's aerospike suite speaks to the cluster through the Java
`AerospikeClient` (`aerospike/src/aerospike/support.clj:340-445`:
put!/put-if-absent!/append!/add!/fetch/cas! over Policy /
GenerationPolicy / linearize-read). This module implements the same
operations directly on Aerospike's wire protocol — an 8-byte proto
header (version 2; type 1 = info, 3 = message) followed by a 22-byte
message header, fields, and ops — so the framework needs no driver
dependency. Hermetic tests run against `tests/fake_aerospike.py`,
which serves the same format.

Divergence note: the real protocol addresses records by the
RIPEMD-160 digest of (set, key); we send the user key field (which the
real protocol also carries) and the fake resolves on it. The suite's
semantics — generation CAS, append, add, linearized reads — are
identical.
"""

from __future__ import annotations

import socket

from .netutil import nodelay
import struct
import threading

# proto header types
T_INFO = 1
T_MESSAGE = 3

# info1/2/3 bits (subset used by the suite)
INFO1_READ = 0x01
INFO1_GET_ALL = 0x02
INFO2_WRITE = 0x01
INFO2_GENERATION = 0x04        # EXPECT_GEN_EQUAL
INFO2_CREATE_ONLY = 0x20       # RecordExistsAction/CREATE_ONLY
INFO3_LINEARIZE_READ = 0x40    # strong-consistency linearized read

# field types
FIELD_NAMESPACE = 0
FIELD_SET = 1
FIELD_KEY = 2

# op types
OP_READ = 1
OP_WRITE = 2
OP_INCR = 5
OP_APPEND = 9

# particle types
PT_INTEGER = 1
PT_STRING = 3

# result codes (support.clj:453-501 classifies these)
RC_OK = 0
RC_KEY_NOT_FOUND = 2
RC_GENERATION = 3
RC_PARAMETER = 4
RC_KEY_EXISTS = 5
RC_SERVER_NOT_AVAILABLE = -8
RC_PARTITION_UNAVAILABLE = 11
RC_HOT_KEY = 14
RC_FORBIDDEN = 22


class ASError(Exception):
    def __init__(self, code: int, message: str = ""):
        super().__init__(f"aerospike error {code}: {message}")
        self.code = code
        self.message = message


def _encode_value(v) -> tuple[int, bytes]:
    if isinstance(v, bool):
        raise ASError(RC_PARAMETER, "bool bins unsupported")
    if isinstance(v, int):
        return PT_INTEGER, struct.pack(">q", v)
    if isinstance(v, str):
        return PT_STRING, v.encode()
    raise ASError(RC_PARAMETER, f"unsupported bin value {v!r}")


def _decode_value(pt: int, data: bytes):
    if pt == PT_INTEGER:
        return struct.unpack(">q", data)[0]
    if pt == PT_STRING:
        return data.decode()
    raise ASError(RC_PARAMETER, f"unsupported particle type {pt}")


def _field(ftype: int, data: bytes) -> bytes:
    return struct.pack(">IB", len(data) + 1, ftype) + data


def _op(op_type: int, name: str, value=None) -> bytes:
    nb = name.encode()
    if value is None:
        body = struct.pack(">BBBB", op_type, 0, 0, len(nb)) + nb
    else:
        pt, vb = _encode_value(value)
        body = struct.pack(">BBBB", op_type, pt, 0, len(nb)) + nb + vb
    return struct.pack(">I", len(body)) + body


def key_fields(namespace: str, set_name: str, key) -> list[bytes]:
    pt, kb = _encode_value(key)
    return [_field(FIELD_NAMESPACE, namespace.encode()),
            _field(FIELD_SET, set_name.encode()),
            _field(FIELD_KEY, bytes([pt]) + kb)]


def encode_message(info1: int, info2: int, info3: int, generation: int,
                   fields: list[bytes], ops: list[bytes],
                   result_code: int = 0) -> bytes:
    body = b"".join(fields) + b"".join(ops)
    hdr = struct.pack(">BBBBBBIIIHH", 22, info1, info2, info3, 0,
                      result_code & 0xFF, generation, 0, 1000,
                      len(fields), len(ops))
    msg = hdr + body
    proto = struct.pack(">Q", (2 << 56) | (T_MESSAGE << 48) | len(msg))
    return proto + msg


def decode_message(payload: bytes):
    """-> (result_code, generation, fields: list[(ftype, data)],
    bins: dict)."""
    (hsz, i1, i2, i3, _u, rc, gen, _exp, _ttl,
     n_fields, n_ops) = struct.unpack(">BBBBBBIIIHH", payload[:22])
    rc = rc - 256 if rc > 127 else rc  # signed result codes
    off = hsz
    fields = []
    for _ in range(n_fields):
        sz, ftype = struct.unpack(">IB", payload[off:off + 5])
        fields.append((ftype, payload[off + 5:off + 4 + sz]))
        off += 4 + sz
    bins = {}
    for _ in range(n_ops):
        sz, = struct.unpack(">I", payload[off:off + 4])
        op_type, pt, _ver, nlen = struct.unpack(
            ">BBBB", payload[off + 4:off + 8])
        name = payload[off + 8:off + 8 + nlen].decode()
        vdata = payload[off + 8 + nlen:off + 4 + sz]
        bins[name] = _decode_value(pt, vdata) if vdata else None
        off += 4 + sz
    return rc, gen, fields, (i1, i2, i3), bins


class Conn:
    """One Aerospike node connection."""

    def __init__(self, host: str, port: int = 3000,
                 timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout_s)
        nodelay(self.sock)
        self.lock = threading.Lock()

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ASError(RC_SERVER_NOT_AVAILABLE,
                              "connection closed by server")
            buf += chunk
        return buf

    def _roundtrip(self, msg: bytes):
        with self.lock:
            self.sock.sendall(msg)
            proto, = struct.unpack(">Q", self._read_exact(8))
            size = proto & ((1 << 48) - 1)
            ptype = (proto >> 48) & 0xFF
            payload = self._read_exact(size)
        return ptype, payload

    # -- message commands ---------------------------------------------------

    def _command(self, info1, info2, info3, generation, fields, ops):
        ptype, payload = self._roundtrip(
            encode_message(info1, info2, info3, generation, fields, ops))
        if ptype != T_MESSAGE:
            raise ASError(RC_SERVER_NOT_AVAILABLE,
                          f"unexpected proto type {ptype}")
        rc, gen, _fields, _info, bins = decode_message(payload)
        return rc, gen, bins

    def get(self, namespace: str, set_name: str, key,
            linearize: bool = True) -> dict | None:
        """-> {'generation': g, 'bins': {...}} or None if absent
        (support.clj fetch, with the linearize-read policy)."""
        rc, gen, bins = self._command(
            INFO1_READ | INFO1_GET_ALL, 0,
            INFO3_LINEARIZE_READ if linearize else 0, 0,
            key_fields(namespace, set_name, key), [])
        if rc == RC_KEY_NOT_FOUND:
            return None
        if rc != RC_OK:
            raise ASError(rc)
        return {"generation": gen, "bins": bins}

    def put(self, namespace: str, set_name: str, key, bins: dict,
            generation: int | None = None,
            create_only: bool = False) -> None:
        info2 = INFO2_WRITE
        if generation is not None:
            info2 |= INFO2_GENERATION
        if create_only:
            info2 |= INFO2_CREATE_ONLY
        rc, _g, _b = self._command(
            0, info2, 0, generation or 0,
            key_fields(namespace, set_name, key),
            [_op(OP_WRITE, k, v) for k, v in bins.items()])
        if rc != RC_OK:
            raise ASError(rc)

    def append(self, namespace: str, set_name: str, key,
               bins: dict) -> None:
        rc, _g, _b = self._command(
            0, INFO2_WRITE, 0, 0,
            key_fields(namespace, set_name, key),
            [_op(OP_APPEND, k, v) for k, v in bins.items()])
        if rc != RC_OK:
            raise ASError(rc)

    def add(self, namespace: str, set_name: str, key, bins: dict) -> None:
        rc, _g, _b = self._command(
            0, INFO2_WRITE, 0, 0,
            key_fields(namespace, set_name, key),
            [_op(OP_INCR, k, v) for k, v in bins.items()])
        if rc != RC_OK:
            raise ASError(rc)

    # -- info protocol --------------------------------------------------------

    def info(self, *commands: str) -> dict[str, str]:
        """Text info protocol: newline-separated commands, tab-separated
        replies (support.clj server-info)."""
        payload = ("\n".join(commands) + "\n").encode()
        proto = struct.pack(">Q", (2 << 56) | (T_INFO << 48)
                            | len(payload))
        ptype, reply = self._roundtrip(proto + payload)
        if ptype != T_INFO:
            raise ASError(RC_SERVER_NOT_AVAILABLE,
                          f"unexpected proto type {ptype}")
        out = {}
        for line in reply.decode().splitlines():
            if not line:
                continue
            k, _, v = line.partition("\t")
            out[k] = v
        return out

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


