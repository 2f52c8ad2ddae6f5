"""A CP-service HTTP shim: the data plane for the hazelcast-style
suite.

The reference's hazelcast suite ships its own in-repo server component
(`hazelcast/server/`) wrapping the DB's client API for the harness to
drive; this module plays that role as a self-contained HTTP service
exposing the CP-subsystem primitives the workload menu exercises —
locks, semaphores, atomic (CAS) references, unique-id generation, and
queues. `serve()` runs it in-process for hermetic tests;
`SCRIPT`+`deploy` let the DB protocol upload and run it on real nodes
via the control layer.
"""

from __future__ import annotations

import json
import random as _random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class CPState:
    """Linearizable in-memory CP primitives behind one lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.locks: dict[str, str | None] = {}     # name -> owner
        self.semaphores: dict[str, dict] = {}      # name -> {n, holders}
        self.refs: dict[str, object] = {}          # name -> value
        self.counter = 0
        self.queues: dict[str, list] = {}

    def handle(self, path: str, req: dict) -> dict:
        with self.lock:
            return getattr(self, "op_" + path.strip("/").replace("/", "_")
                           )(req)

    # locks ----------------------------------------------------------------

    def op_lock_acquire(self, req):
        name, owner = req["name"], req["owner"]
        if self.locks.get(name) is None:
            self.locks[name] = owner
            return {"ok": True}
        return {"ok": False}

    def op_lock_release(self, req):
        name, owner = req["name"], req["owner"]
        if self.locks.get(name) != owner:
            return {"ok": False, "error": "not-lock-owner"}
        self.locks[name] = None
        return {"ok": True}

    # semaphores -----------------------------------------------------------

    def op_semaphore_acquire(self, req):
        s = self.semaphores.setdefault(
            req["name"], {"n": int(req.get("permits", 2)), "holders": []})
        if len(s["holders"]) < s["n"]:
            s["holders"].append(req["owner"])
            return {"ok": True}
        return {"ok": False}

    def op_semaphore_release(self, req):
        s = self.semaphores.get(req["name"])
        if s and req["owner"] in s["holders"]:
            s["holders"].remove(req["owner"])
            return {"ok": True}
        return {"ok": False, "error": "not-a-holder"}

    # atomic refs ----------------------------------------------------------

    def op_ref_read(self, req):
        return {"ok": True, "value": self.refs.get(req["name"])}

    def op_ref_write(self, req):
        self.refs[req["name"]] = req["value"]
        return {"ok": True}

    def op_ref_cas(self, req):
        if self.refs.get(req["name"]) == req["old"]:
            self.refs[req["name"]] = req["new"]
            return {"ok": True}
        return {"ok": False}

    # ids / queues ---------------------------------------------------------

    def op_id(self, req):
        self.counter += 1
        return {"ok": True, "value": self.counter}

    def op_queue_offer(self, req):
        self.queues.setdefault(req["name"], []).append(req["value"])
        return {"ok": True}

    def op_queue_poll(self, req):
        q = self.queues.get(req["name"]) or []
        return {"ok": True, "value": q.pop(0) if q else None}

    def op_queue_poll_value(self, req):
        """Remove one arbitrary (non-FIFO) element — the unordered
        dequeue for the queue-linear workload."""
        q = self.queues.get(req["name"]) or []
        if not q:
            return {"ok": True, "value": None}
        v = _random.choice(q)
        q.remove(v)
        return {"ok": True, "value": v}

    # maps (the reference's map / crdt-map workloads,
    # `hazelcast.clj:440-507`: a set stored under one map key) --------------

    def op_map_add(self, req):
        m = self.queues.setdefault("map:" + req["name"], [])
        if req["value"] not in m:
            m.append(req["value"])
        return {"ok": True}

    def op_map_read(self, req):
        return {"ok": True,
                "value": sorted(self.queues.get("map:" + req["name"])
                                or [])}


def serve(host: str = "127.0.0.1", port: int = 0):
    """Run the shim in a daemon thread; returns (server, port)."""
    state = CPState()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            try:
                out = state.handle(self.path, req)
            except AttributeError:
                self.send_response(404)
                self.end_headers()
                return
            body = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    server.state = state
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


DIR = "/opt/cp-shim"
SCRIPT_PATH = f"{DIR}/cp_shim.py"
PORT = 7171


def deploy(port: int = PORT) -> None:
    """Upload this module to the current node and run it under the
    daemon helpers — the suite DB's setup path."""
    import os

    from .. import control
    from ..control import util as cu

    with control.su():
        control.exec_("mkdir", "-p", DIR)
        with open(os.path.abspath(__file__)) as f:
            src = f.read()
        src += (f"\n\nif __name__ == '__main__':\n"
                f"    s, p = serve('0.0.0.0', {port})\n"
                f"    import time\n"
                f"    while True:\n"
                f"        time.sleep(3600)\n")
        control.upload_str(src, SCRIPT_PATH)
        cu.start_daemon({"logfile": f"{DIR}/shim.log",
                         "pidfile": f"{DIR}/shim.pid", "chdir": DIR},
                        "/usr/bin/python3", SCRIPT_PATH)
        cu.await_tcp_port(port)
