"""Dummy remote: a no-op control backend for hermetic runs.

Reference behavior: `:ssh {:dummy? true}` makes the whole control layer a
no-op (`jepsen/src/jepsen/control.clj:40`, `cli.clj:85-86` `--no-ssh`), so
a complete end-to-end test executes in one process with no cluster. This
implementation additionally journals every action (for assertions in
tests) and supports scripted responses keyed by command regex.
"""

from __future__ import annotations

import re
import threading
from typing import Callable

from .core import Remote


class DummyRemote(Remote):
    """Pretends to run everything, successfully and instantly.

    ``responses`` is an ordered mapping of command-regex → canned stdout
    (or a callable (context, action) → result-fields dict). All executed
    actions are appended to ``log`` as (host, context, action) tuples,
    shared across connect()'d copies so a test can inspect the full
    cluster-wide command stream.
    """

    def __init__(self, responses=None, log=None, files=None):
        self.responses = list((responses or {}).items())
        self.log: list = log if log is not None else []
        # remote-path → contents uploaded; shared across connections
        self.files: dict = files if files is not None else {}
        self.host = None
        self._lock = threading.Lock()

    def connect(self, conn_spec: dict) -> "DummyRemote":
        r = DummyRemote(dict(self.responses), self.log, self.files)
        r.host = conn_spec.get("host")
        return r

    def execute(self, context: dict, action: dict) -> dict:
        cmd = action.get("cmd", "")
        with self._lock:
            self.log.append((self.host, dict(context or {}), dict(action)))
        for pattern, resp in self.responses:
            if re.search(pattern, cmd):
                if isinstance(resp, Callable):
                    extra = resp(context, action)
                    return {**action, "exit": 0, "out": "", "err": "",
                            **extra}
                return {**action, "exit": 0, "out": resp, "err": ""}
        return {**action, **self._fake_fs(cmd), "err": ""}

    def _fake_fs(self, cmd: str) -> dict:
        """Minimal filesystem semantics over the shared ``files`` map,
        so existence-polling helpers (exists/stat, tmp_dir, cached_wget)
        terminate instead of seeing every path as present. Commands may
        arrive wrapped (`cd /foo; stat x`); only the last segment
        matters."""
        # commands may be cd- and sudo-wrapped:
        #   sudo -k -S -u root bash -c "cd /; stat /x"
        tail = cmd.split(";")[-1].strip().rstrip("\"'")
        m = re.fullmatch(r"(?:stat|test -[efd]) (\S+)", tail)
        if m:
            path = m.group(1)
            with self._lock:
                known = any(f == path or f.startswith(path + "/")
                            for f in self.files)
            return {"exit": 0 if known else 1, "out": ""}
        m = re.fullmatch(r"(?:mkdir -p|touch) (\S+)", tail)
        if m:
            with self._lock:
                self.files.setdefault(m.group(1), b"")
            return {"exit": 0, "out": ""}
        m = re.fullmatch(r"mv (\S+) (\S+)", tail)
        if m:
            src, dst = m.groups()
            with self._lock:
                if src in self.files:
                    self.files[dst] = self.files.pop(src)
                else:
                    self.files.setdefault(dst, b"")
            return {"exit": 0, "out": ""}
        return {"exit": 0, "out": ""}

    def upload(self, context, local_paths, remote_path, opts=None):
        if isinstance(local_paths, (str, bytes)):
            local_paths = [local_paths]
        with self._lock:
            for p in local_paths:
                try:
                    with open(p, "rb") as f:
                        self.files[str(remote_path)] = f.read()
                except OSError:
                    self.files[str(remote_path)] = None
                self.log.append((self.host, dict(context or {}),
                                 {"upload": str(p),
                                  "remote": str(remote_path)}))

    def download(self, context, remote_paths, local_path, opts=None):
        if isinstance(remote_paths, (str, bytes)):
            remote_paths = [remote_paths]
        with self._lock:
            for p in remote_paths:
                self.log.append((self.host, dict(context or {}),
                                 {"download": str(p),
                                  "local": str(local_path)}))


def remote(**kw) -> DummyRemote:
    return DummyRemote(**kw)
