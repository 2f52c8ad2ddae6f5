"""Remote-execution protocol and shell-command construction.

Reference: `jepsen/src/jepsen/control/core.clj` — the `Remote` protocol
(connect/disconnect/execute/upload/download, `:7-58`), POSIX shell escaping
with `lit` literals (`:60-110`), env-var construction (`:112-140`), sudo
wrapping with password on stdin (`:142-153`), and nonzero-exit → throw
(`:155-171`).

A *conn spec* describes how to reach a node::

    {"host": ..., "port": 22, "username": ..., "password": ...,
     "private-key-path": ..., "strict-host-key-checking": True,
     "dummy": False}

A *context map* describes how to run a command::

    {"dir": ..., "sudo": ..., "sudo-password": ...}

An *action* is ``{"cmd": str, "in": optional stdin str}``; executing it
returns the action plus ``{"exit": int, "out": str, "err": str}``.
"""

from __future__ import annotations

import re
from typing import Any, Mapping


class Remote:
    """Polymorphic remote-execution backend (SSH, docker, k8s, dummy)."""

    def connect(self, conn_spec: dict) -> "Remote":
        """Returns a Remote bound to the node described by conn_spec,
        ready for execute/upload/download."""
        raise NotImplementedError

    def disconnect(self) -> None:
        pass

    def execute(self, context: dict, action: dict) -> dict:
        """Run action's cmd (with optional stdin action["in"]) under
        context; returns action + {"exit", "out", "err"}."""
        raise NotImplementedError

    def upload(self, context: dict, local_paths, remote_path: str,
               opts: dict | None = None) -> None:
        raise NotImplementedError

    def download(self, context: dict, remote_paths, local_path: str,
                 opts: dict | None = None) -> None:
        raise NotImplementedError


class Literal:
    """A string passed to the shell unescaped (`control/core.clj:60-65`)."""

    __slots__ = ("string",)

    def __init__(self, string: str):
        self.string = string

    def __repr__(self):
        return f"lit({self.string!r})"

    def __eq__(self, other):
        return isinstance(other, Literal) and other.string == self.string

    def __hash__(self):
        return hash(("lit", self.string))


def lit(s: str) -> Literal:
    return Literal(s)


# Shell I/O redirection tokens pass through bare, like the reference's
# :> :>> :< keywords (`control/core.clj:90-91`).
_REDIRECTS = {">", ">>", "<"}

_NEEDS_QUOTING = re.compile(r'[\\$`"\s(){}\[\]*?<>&;|!#~\']')
_QUOTE_THESE = re.compile(r'([\\$`"])')


def escape(s: Any) -> str:
    """Escape one argument (or sequence of arguments) for a POSIX shell.

    None → empty string; Literal → verbatim; ">", ">>", "<" → bare
    redirection operators; lists/tuples/sets → each element escaped,
    space-joined; everything else is str()'d and double-quoted when it
    contains shell-special characters (`control/core.clj:67-110`).
    """
    if s is None:
        return ""
    if isinstance(s, Literal):
        return s.string
    if isinstance(s, (list, tuple, set, frozenset)):
        return " ".join(escape(x) for x in s)
    s = str(s)
    if s in _REDIRECTS:
        return s
    if s == "":
        return '""'
    if _NEEDS_QUOTING.search(s):
        return '"' + _QUOTE_THESE.sub(r"\\\1", s) + '"'
    return s


def env(e: Any) -> Literal | None:
    """Build an env-var binding prefix for a command: a mapping of names to
    values becomes the Literal ``K1=v1 K2=v2``; strings/Literals pass
    through as Literals; None → None (`control/core.clj:112-140`)."""
    if e is None:
        return None
    if isinstance(e, Literal):
        return e
    if isinstance(e, str):
        return lit(e)
    if isinstance(e, Mapping):
        return lit(" ".join(f"{k}={escape(v)}" for k, v in e.items()))
    raise TypeError(f"can't build an env mapping from {e!r}")


def wrap_sudo(context: dict, action: dict) -> dict:
    """If the context asks for sudo, wrap the action's cmd in
    ``sudo -k -S -u <user> bash -c <escaped cmd>``, prepending the sudo
    password to stdin when present (`control/core.clj:142-153`)."""
    user = context.get("sudo")
    if not user:
        return action
    out = dict(action)
    out["cmd"] = f"sudo -k -S -u {user} bash -c {escape(action['cmd'])}"
    pw = context.get("sudo-password")
    if pw:
        out["in"] = f"{pw}\n{action.get('in', '')}"
        out["secret-in"] = True  # so error reporting redacts stdin
    return out


def wrap_cd(context: dict, action: dict) -> dict:
    """Prefix the command with a cd to the context's dir."""
    d = context.get("dir")
    if not d:
        return action
    out = dict(action)
    out["cmd"] = f"cd {escape(d)}; {action['cmd']}"
    return out


class RemoteError(Exception):
    """A remote command failed (nonzero exit, or transport trouble)."""

    def __init__(self, message: str, result: dict | None = None):
        super().__init__(message)
        self.result = result or {}

    @property
    def exit(self):
        return self.result.get("exit")

    @property
    def out(self):
        return self.result.get("out")

    @property
    def err(self):
        return self.result.get("err")


def throw_on_nonzero_exit(result: dict) -> dict:
    """Raise RemoteError unless the result's exit status is 0
    (`control/core.clj:155-171`)."""
    if result.get("exit") == 0:
        return result
    stdin = "[redacted]" if result.get("secret-in") \
        else result.get("in", "")
    raise RemoteError(
        "Command exited with non-zero status {} on node {}:\n{}\n\n"
        "STDIN:\n{}\n\nSTDOUT:\n{}\n\nSTDERR:\n{}".format(
            result.get("exit"), result.get("host"),
            (result.get("action") or {}).get("cmd"),
            stdin, result.get("out", ""),
            result.get("err", "")),
        result)


def cli_run(argv, stdin: str | None = None,
            timeout: float | None = None) -> dict:
    """Run a local CLI transport command (ssh/scp/docker/kubectl) and
    return {"exit", "out", "err"} — shared by all subprocess-backed
    Remotes."""
    import subprocess

    try:
        p = subprocess.run(argv, input=stdin, capture_output=True,
                           text=True, timeout=timeout)
        return {"exit": p.returncode, "out": p.stdout, "err": p.stderr}
    except subprocess.TimeoutExpired as e:
        out = e.stdout
        if isinstance(out, bytes):
            out = out.decode(errors="replace")
        return {"exit": -1, "out": out or "",
                "err": f"timeout after {timeout}s"}
    except FileNotFoundError as e:
        return {"exit": -1, "out": "", "err": str(e)}
