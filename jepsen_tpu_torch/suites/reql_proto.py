"""Minimal ReQL (RethinkDB query protocol) wire client.

The reference's rethinkdb suite drives the clj-rethinkdb driver
(`rethinkdb/src/jepsen/rethinkdb.clj:24-27,108-120`); this module
speaks the JSON protocol directly: the V0_4 handshake (magic +
auth-key + JSON protocol magic, each little-endian) followed by
queries as [QueryType, term, opts] framed by an 8-byte token and a
4-byte length. Terms are the standard nested arrays
([term-id, args, opts]); only the subset the suite needs is exposed.
Hermetic tests run against `tests/fake_rethinkdb.py`."""

from __future__ import annotations

import json
import socket

from .netutil import nodelay
import struct
import threading

V0_4 = 0x400C2D20
PROTOCOL_JSON = 0x7E6970C7

# query types
Q_START = 1
Q_CONTINUE = 2

# response types
R_SUCCESS_ATOM = 1
R_SUCCESS_SEQUENCE = 2
R_SUCCESS_PARTIAL = 3
R_CLIENT_ERROR = 16
R_COMPILE_ERROR = 17
R_RUNTIME_ERROR = 18

# term ids (ql2.proto)
T_DB = 14
T_TABLE = 15
T_GET = 16
T_EQ = 17
T_ERROR = 12
T_FUNC = 69
T_VAR = 10
T_BRANCH = 65
T_GET_FIELD = 31
T_INSERT = 56
T_UPDATE = 53
T_DB_CREATE = 57
T_TABLE_CREATE = 60
T_DEFAULT = 92
T_WAIT = 177
T_DATUM_OBJ = 3   # MAKE_OBJ is implicit via plain dicts


class ReQLError(Exception):
    def __init__(self, rtype: int, message: str):
        super().__init__(f"reql error {rtype}: {message}")
        self.rtype = rtype
        self.message = message


# -- term builders -----------------------------------------------------------

def db(name):
    return [T_DB, [name]]


def table(dbname, tbl, read_mode=None):
    opts = {"read_mode": read_mode} if read_mode else {}
    return [T_TABLE, [db(dbname), tbl], opts] if opts \
        else [T_TABLE, [db(dbname), tbl]]


def get(tbl_term, key):
    return [T_GET, [tbl_term, key]]


def get_field(row, name):
    return [T_GET_FIELD, [row, name]]


def default(term, fallback):
    return [T_DEFAULT, [term, fallback]]


def insert(tbl_term, doc, conflict=None):
    opts = {"conflict": conflict} if conflict else {}
    return [T_INSERT, [tbl_term, _datum(doc)], opts] if opts \
        else [T_INSERT, [tbl_term, _datum(doc)]]


def update(target, func_or_doc):
    return [T_UPDATE, [target, func_or_doc]]


def branch(cond, then, otherwise):
    return [T_BRANCH, [cond, then, otherwise]]


def eq(a, b):
    return [T_EQ, [a, b]]


def error(msg):
    return [T_ERROR, [msg]]


def func(body):
    """One-arg row function: var 1 is the row."""
    return [T_FUNC, [[2, [1]], body]]  # [MAKE_ARRAY, [1]]


def var(n):
    return [T_VAR, [n]]


def db_create(name):
    return [T_DB_CREATE, [name]]


def table_create(dbname, tbl, replicas=None):
    opts = {"replicas": replicas} if replicas else {}
    return [T_TABLE_CREATE, [db(dbname), tbl], opts] if opts \
        else [T_TABLE_CREATE, [db(dbname), tbl]]


def wait(tbl_term):
    return [T_WAIT, [tbl_term]]


def _datum(doc: dict):
    """Literal objects are sent as plain JSON objects in ReQL."""
    return doc


class Conn:
    """One RethinkDB connection in V0_4/JSON mode."""

    def __init__(self, host: str, port: int = 28015,
                 auth_key: str = "", timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout_s)
        nodelay(self.sock)
        self.token = 0
        self.lock = threading.Lock()
        key = auth_key.encode()
        self.sock.sendall(struct.pack("<I", V0_4)
                          + struct.pack("<I", len(key)) + key
                          + struct.pack("<I", PROTOCOL_JSON))
        greeting = b""
        while not greeting.endswith(b"\x00"):
            chunk = self.sock.recv(64)
            if not chunk:
                raise ReQLError(R_CLIENT_ERROR, "handshake EOF")
            greeting += chunk
        if b"SUCCESS" not in greeting:
            raise ReQLError(R_CLIENT_ERROR,
                            greeting.decode(errors="replace"))

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ReQLError(R_CLIENT_ERROR,
                                "connection closed by server")
            buf += chunk
        return buf

    def run(self, term, **opts):
        """Run a term; returns the response datum (atom or sequence)."""
        with self.lock:
            self.token += 1
            token = self.token
            q = json.dumps([Q_START, term, opts]).encode()
            self.sock.sendall(struct.pack("<q", token)
                              + struct.pack("<I", len(q)) + q)
            rtoken, = struct.unpack("<q", self._read_exact(8))
            rlen, = struct.unpack("<I", self._read_exact(4))
            resp = json.loads(self._read_exact(rlen))
        if rtoken != token:
            raise ReQLError(R_CLIENT_ERROR,
                            f"token mismatch {rtoken} != {token}")
        t = resp.get("t")
        if t == R_SUCCESS_ATOM:
            return resp["r"][0]
        if t in (R_SUCCESS_SEQUENCE, R_SUCCESS_PARTIAL):
            return resp["r"]
        raise ReQLError(t, "; ".join(map(str, resp.get("r", []))))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
