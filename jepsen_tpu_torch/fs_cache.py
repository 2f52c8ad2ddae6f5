"""Control-node filesystem cache for expensive artifacts.

Reference: `jepsen/src/jepsen/fs_cache.clj` — caches files/strings/data
under `/tmp/jepsen/cache`, keyed by arbitrary "path" values (strings,
numbers, tuples...), written atomically via rename so concurrent tests
never observe partial writes (`fs_cache.clj:57-155`); `deploy-remote!`
(:223) pushes a cached file to the current remote node.

Encoding: each path component is made filesystem-safe by escaping; data
values are stored as JSON (the reference uses EDN).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from typing import Any

DEFAULT_DIR = "/tmp/jepsen/cache"

_dir = DEFAULT_DIR
_lock = threading.Lock()


def set_dir(d: str) -> None:
    global _dir
    _dir = d


def _escape_component(c: Any) -> str:
    s = str(c)
    if re.fullmatch(r"\.+", s):  # "." / ".." would traverse out of _dir
        return s.replace(".", "%2e")
    return re.sub(r"[^A-Za-z0-9._-]", lambda m: f"%{ord(m.group(0)):02x}",
                  s) or "_"


def _as_components(path) -> list[str]:
    if isinstance(path, (list, tuple)):
        return [_escape_component(c) for c in path]
    return [_escape_component(path)]


def file_path(path) -> str:
    """The local cache file for a cache path (`fs_cache.clj:57-80`)."""
    return os.path.join(_dir, *_as_components(path))


def cached(path) -> bool:
    return os.path.exists(file_path(path))


def _atomic_write(dest: str, write_fn) -> str:
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest),
                               prefix=".cache-tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, dest)  # atomic on POSIX (`fs_cache.clj:96-110`)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return dest


def save_file(local_file: str, path) -> str:
    """Cache a local file's contents under path; returns the cache file."""
    with open(local_file, "rb") as src:
        data = src.read()
    return _atomic_write(file_path(path), lambda f: f.write(data))


def save_bytes(content: bytes, path) -> str:
    return _atomic_write(file_path(path), lambda f: f.write(content))


def save_string(content: str, path) -> str:
    return save_bytes(content.encode(), path)


def save_data(value: Any, path) -> str:
    """Cache a JSON-serializable value (reference caches EDN)."""
    return save_string(json.dumps(value), path)


def load_bytes(path) -> bytes | None:
    try:
        with open(file_path(path), "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None


def load_string(path) -> str | None:
    b = load_bytes(path)
    return None if b is None else b.decode()


def load_data(path) -> Any:
    s = load_string(path)
    return None if s is None else json.loads(s)


def load_file(path) -> str | None:
    """The cache file path, if cached."""
    f = file_path(path)
    return f if os.path.exists(f) else None


def fetch(path, miss_fn) -> str:
    """Return the cache file for path, computing it with miss_fn() → bytes
    on a miss. Locked so concurrent misses compute once."""
    with _lock:
        f = load_file(path)
        if f is not None:
            return f
        return save_bytes(miss_fn(), path)


def clear(path=None) -> None:
    import shutil

    target = _dir if path is None else file_path(path)
    if os.path.isdir(target):
        shutil.rmtree(target, ignore_errors=True)
    elif os.path.exists(target):
        os.unlink(target)


def deploy_remote(path, remote_path: str) -> str:
    """Upload a cached file to the current control node+dir
    (`fs_cache.clj:223`)."""
    from . import control

    f = load_file(path)
    assert f is not None, f"nothing cached under {path!r}"
    return control.upload(f, remote_path)
