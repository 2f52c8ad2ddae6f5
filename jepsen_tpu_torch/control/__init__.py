"""Control DSL: scoped remote shell over polymorphic Remotes.

Reference: `jepsen/src/jepsen/control.clj` — dynamic-var-scoped remote
shell (`*host* *session* *sudo* *dir*`…, `:40-53`), `exec`/`exec*`
escape+sudo+cd pipeline (`:138-157`), `upload`/`download` (`:167-189`),
parallel fan-out `on`/`on-many`/`on-nodes` (`:272-311`), and scoping
macros `cd`/`sudo`/`su`/`with-ssh`/`with-remote` (`:203-262`).

Python rendering: the dynamic vars become a thread-local ``Env`` (worker
threads inherit nothing — each `on_nodes` branch binds its own session),
and the Clojure macros become context managers::

    with with_ssh({"username": "root"}):
        with on("n1"):
            with su(), cd("/opt/db"):
                exec_("bin/db", "start", ">", "db.log")
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Callable, Iterable

from ..util import real_pmap
from . import dummy as dummy_mod
from . import ssh as ssh_mod
from .core import (Literal, Remote, RemoteError, escape, lit,
                   throw_on_nonzero_exit)

log = logging.getLogger(__name__)

PIPE = lit("|")
AND = lit("&&")

_DEFAULTS = {
    "dummy": False,
    "host": None,
    "session": None,
    "trace": False,
    "dir": "/",
    "sudo": None,
    "sudo-password": None,
    "username": "root",
    "password": "root",
    "port": 22,
    "private-key-path": None,
    "strict-host-key-checking": True,
    "remote": None,
    "retries": 5,
}


class _Env(threading.local):
    def __init__(self):
        self.vars = dict(_DEFAULTS)


_env = _Env()


def var(name: str) -> Any:
    return _env.vars[name]


@contextlib.contextmanager
def binding(**kw):
    """Scoped rebinding of control vars (underscores → dashes)."""
    kw = {k.replace("_", "-"): v for k, v in kw.items()}
    old = {k: _env.vars[k] for k in kw}
    _env.vars.update(kw)
    try:
        yield
    finally:
        _env.vars.update(old)


def bound_fn(f: Callable) -> Callable:
    """Capture the current control bindings and re-establish them in
    whatever thread later calls f — the reference's `bound-fn*`, needed
    because worker threads see only default bindings."""
    saved = dict(_env.vars)

    def wrapper(*args, **kwargs):
        old = _env.vars
        _env.vars = dict(saved)
        try:
            return f(*args, **kwargs)
        finally:
            _env.vars = old

    return wrapper


def default_remote() -> Remote:
    """The bound remote, or the default: dummy when `dummy` is set,
    otherwise retry-wrapped OpenSSH (`control.clj:35-37` + the sshj/scp/
    retry wrapper stack)."""
    r = var("remote")
    if r is not None:
        return r
    if var("dummy"):
        return dummy_mod.remote()
    from . import retry as retry_mod
    return retry_mod.remote(ssh_mod.remote())


def conn_spec() -> dict:
    """Conn spec from current bindings (`control.clj:55-70`)."""
    return {k: var(k) for k in
            ("dummy", "host", "port", "username", "password",
             "private-key-path", "strict-host-key-checking")}


def cmd_context() -> dict:
    """Command context from current bindings (`control.clj:72-78`)."""
    return {"dir": var("dir"), "sudo": var("sudo"),
            "sudo-password": var("sudo-password")}


def session(host: str) -> Remote:
    """Connect the bound remote to host (`control.clj:226-229`)."""
    return default_remote().connect({**conn_spec(), "host": host})


def disconnect(remote: Remote) -> None:
    remote.disconnect()


# -- command execution ------------------------------------------------------

def ssh_star(action: dict) -> dict:
    """Wrap an action in cd+sudo and evaluate it against the current
    session (`control.clj:103-136` — wrapping happens here at the DSL
    layer, exactly once, so every Remote backend sees a fully-formed
    command)."""
    from .core import wrap_cd, wrap_sudo

    sess = var("session")
    if sess is None:
        raise RemoteError("no session bound for this host; use on()/"
                          "on_nodes()/with_session()")
    ctx = cmd_context()
    wrapped = wrap_sudo(ctx, wrap_cd(ctx, action))
    res = sess.execute(ctx, wrapped)
    return {**res, "host": var("host"), "action": action}


def exec_raw(*commands) -> str:
    """Join commands unescaped, run, throw on nonzero exit, return
    trimmed stdout (`control.clj:138-149` exec*)."""
    cmd = " ".join(str(c.string if isinstance(c, Literal) else c)
                   for c in commands)
    if var("trace"):
        log.info("Host: %s cmd: %s", var("host"), cmd)
    res = ssh_star({"cmd": cmd})
    throw_on_nonzero_exit(res)
    return res.get("out", "").rstrip("\r\n")


def exec_(*commands) -> str:
    """Escape each argument, run, return stdout (`control.clj:151-157`)."""
    return exec_raw(*[escape(c) for c in commands])


def upload(local_paths, remote_path: str) -> str:
    """Copy local path(s) to the remote node (`control.clj:167-173`)."""
    var("session").upload(cmd_context(), local_paths, remote_path, {})
    return remote_path


def upload_str(content: str | bytes, remote_path: str) -> str:
    """Upload literal content (the reference's `upload-resource!`,
    `control.clj:175-184`, generalized to any string)."""
    import tempfile

    mode = "wb" if isinstance(content, bytes) else "w"
    with tempfile.NamedTemporaryFile(mode, suffix=".upload",
                                     delete=False) as f:
        f.write(content)
        tmp = f.name
    try:
        return upload(tmp, remote_path)
    finally:
        import os
        os.unlink(tmp)


def download(remote_paths, local_path: str) -> None:
    """Copy remote path(s) to the control node (`control.clj:186-189`)."""
    var("session").download(cmd_context(), remote_paths, local_path, {})


def expand_path(path: str) -> str:
    """Resolve path against the bound dir (`control.clj:191-201`)."""
    if path.startswith("/"):
        return path
    d = var("dir")
    return d + ("" if d.endswith("/") else "/") + path


# -- scoping ----------------------------------------------------------------

def cd(dir: str):
    """Evaluate body in dir (`control.clj:203-207`)."""
    return binding(dir=expand_path(dir))


def sudo(user: str):
    """Evaluate body as user (`control.clj:209-213`)."""
    return binding(sudo=str(user))


def su():
    """sudo root (`control.clj:215-218`)."""
    return sudo("root")


def trace():
    """Evaluate body with command tracing (`control.clj:220-224`)."""
    return binding(trace=True)


def with_remote(remote: Remote):
    return binding(remote=remote)


def with_ssh(ssh: dict):
    """Scope SSH config from a test's :ssh map (`control.clj:241-262`)."""
    keys = ("dummy", "username", "password", "sudo-password", "port",
            "private-key-path", "strict-host-key-checking", "remote")
    return binding(**{k.replace("-", "_"): ssh[k]
                      for k in keys if k in ssh})


def with_session(host: str, sess: Remote):
    """Bind host+session without opening/closing (`control.clj:264-270`)."""
    return binding(host=host, session=sess)


@contextlib.contextmanager
def on(host: str):
    """Open a session to host, evaluate body, close
    (`control.clj:272-281`)."""
    sess = session(host)
    try:
        with with_session(host, sess):
            yield sess
    finally:
        sess.disconnect()


def on_many(hosts: Iterable[str], f: Callable[[], Any]) -> dict:
    """Run f() on each host in parallel with that host's session bound;
    returns {host: value} (`control.clj:283-293`)."""
    hosts = list(hosts)
    saved = dict(_env.vars)

    def run1(host):
        _env.vars = dict(saved)
        with on(host):
            return host, f()

    return dict(real_pmap(run1, hosts))


def on_nodes(test: dict, f: Callable[[dict, str], Any],
             nodes: Iterable[str] | None = None) -> dict:
    """Evaluate f(test, node) in parallel on each node with that node's
    *already-open* session (from test["sessions"]) bound; returns
    {node: value} (`control.clj:295-311`)."""
    nodes = list(test["nodes"] if nodes is None else nodes)
    sessions = test.get("sessions") or {}
    saved = dict(_env.vars)

    def run1(node):
        sess = sessions.get(node)
        assert sess is not None, f"No session for node {node!r}"
        _env.vars = dict(saved)
        with with_session(node, sess):
            return node, f(test, node)

    return dict(real_pmap(run1, nodes))
