"""OpenSSH-based remote: shells out to `ssh`/`scp` with connection
multiplexing.

Reference: the JSch default remote (`control/clj_ssh.clj`) and the SSHJ
remote (`control/sshj.clj`). Two hard-won behaviors are replicated:

* channel limiting — OpenSSH servers cap sessions per connection at 10;
  the reference derates to a fair Semaphore of **6** concurrent channels
  per connection (`control/sshj.clj:173-179`). We keep the same limit
  around concurrent `ssh -S <mux>` invocations.
* scp for bulk files — the reference shells out to `scp` because JVM SFTP
  is "orders of magnitude slower" for GB-scale files
  (`control/scp.clj:1-15`). Here scp *is* the transfer path.

A ControlMaster socket gives one authenticated TCP connection per node
(the analog of the reference's persistent JSch session) so each exec is a
cheap mux client, not a fresh handshake.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
import threading
from typing import Sequence

from .core import Remote, RemoteError, cli_run

CONCURRENCY_LIMIT = 6  # channels per connection, `sshj.clj:173-179`


def available() -> bool:
    return shutil.which("ssh") is not None


class SSHRemote(Remote):
    def __init__(self, conn_spec: dict | None = None):
        self.spec = conn_spec or {}
        self.host = self.spec.get("host")
        self._sem = threading.Semaphore(CONCURRENCY_LIMIT)
        self._mux_dir = None

    # -- connection ---------------------------------------------------------

    def connect(self, conn_spec: dict) -> "SSHRemote":
        if not available():
            raise RemoteError("no `ssh` binary on the control node; use "
                              "the dummy/docker remote or install OpenSSH")
        r = SSHRemote(conn_spec)
        r._mux_dir = tempfile.mkdtemp(prefix="jepsen-ssh-")
        # Open the master eagerly so auth errors surface here. DEVNULL all
        # fds: with pipes, the forked ControlMaster inherits stderr and
        # subprocess.run blocks on EOF until the timeout.
        p = subprocess.run(r._ssh_argv() + ["-fN"],
                           stdin=subprocess.DEVNULL,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, timeout=30)
        check = r._run(r._base_ssh() + ["-O", "check", r._dest()], None,
                       timeout=10)
        if p.returncode != 0 or check["exit"] != 0:
            raise RemoteError(
                f"ssh connect to {r.host} failed "
                f"(exit {p.returncode}): {check['err']}",
                {"exit": -1, **check})
        return r

    def disconnect(self) -> None:
        if self._mux_dir:
            subprocess.run(self._base_ssh() + ["-O", "exit", self._dest()],
                           capture_output=True)
            shutil.rmtree(self._mux_dir, ignore_errors=True)
            self._mux_dir = None

    # -- argv construction --------------------------------------------------

    def _dest(self) -> str:
        user = self.spec.get("username")
        return f"{user}@{self.host}" if user else str(self.host)

    def _base_ssh(self) -> list[str]:
        argv = ["ssh"]
        if self._mux_dir:
            argv += ["-o", "ControlMaster=auto",
                     "-o", f"ControlPath={self._mux_dir}/mux",
                     "-o", "ControlPersist=60"]
        if not self.spec.get("strict-host-key-checking", True):
            argv += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null"]
        if self.spec.get("port"):
            argv += ["-p", str(self.spec["port"])]
        if self.spec.get("private-key-path"):
            argv += ["-i", str(self.spec["private-key-path"])]
        argv += ["-o", "BatchMode=yes"]
        return argv

    def _ssh_argv(self) -> list[str]:
        return self._base_ssh() + [self._dest()]

    def _scp_argv(self) -> list[str]:
        argv = ["scp", "-rq"]
        if self._mux_dir:
            argv += ["-o", f"ControlPath={self._mux_dir}/mux"]
        if not self.spec.get("strict-host-key-checking", True):
            argv += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null"]
        if self.spec.get("port"):
            argv += ["-P", str(self.spec["port"])]
        if self.spec.get("private-key-path"):
            argv += ["-i", str(self.spec["private-key-path"])]
        return argv

    # -- actions ------------------------------------------------------------

    def _run(self, argv: Sequence[str], stdin: str | None,
             timeout: float | None = None) -> dict:
        return cli_run(argv, stdin, timeout)

    def execute(self, context: dict, action: dict) -> dict:
        # actions arrive fully wrapped (cd+sudo) from the DSL layer
        with self._sem:
            res = self._run(self._ssh_argv() + [action["cmd"]],
                            action.get("in"),
                            timeout=action.get("timeout"))
        # OpenSSH reports its own connection/transport failures as client
        # exit 255; raise (rather than return a result) so the retry
        # wrapper reconnects and retries — a remote command's own status
        # is what execute() *returns*.
        if res["exit"] == 255:
            raise RemoteError(
                f"ssh transport failure to {self.host}: {res['err']}",
                {"exit": -1, "err": res["err"], "out": res["out"]})
        return {**action, **res, "host": self.host}

    def upload(self, context, local_paths, remote_path, opts=None):
        if isinstance(local_paths, (str, bytes)):
            local_paths = [local_paths]
        with self._sem:
            res = self._run(self._scp_argv() + [str(p) for p in local_paths]
                            + [f"{self._dest()}:{remote_path}"], None)
        if res["exit"] != 0:
            raise RemoteError(f"scp upload to {self.host} failed: "
                              f"{res['err']}", {**res, "exit": -1})

    def download(self, context, remote_paths, local_path, opts=None):
        if isinstance(remote_paths, (str, bytes)):
            remote_paths = [remote_paths]
        with self._sem:
            res = self._run(
                self._scp_argv()
                + [f"{self._dest()}:{p}" for p in remote_paths]
                + [str(local_path)], None)
        if res["exit"] != 0:
            raise RemoteError(f"scp download from {self.host} failed: "
                              f"{res['err']}", {**res, "exit": -1})


def remote() -> SSHRemote:
    return SSHRemote()
