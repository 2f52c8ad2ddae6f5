"""Docker remote: `docker exec` / `docker cp` as the control transport.

Reference: `jepsen/src/jepsen/control/docker.clj` — an alternate Remote
for nodes that are local containers rather than SSH-able machines. The
conn spec's host is the container name/id.
"""

from __future__ import annotations

from .core import Remote, RemoteError, cli_run


class DockerRemote(Remote):
    def __init__(self, container: str | None = None, binary: str = "docker"):
        self.container = container
        self.binary = binary

    def connect(self, conn_spec: dict) -> "DockerRemote":
        return DockerRemote(conn_spec["host"], self.binary)

    def _run(self, argv, stdin=None) -> dict:
        return cli_run(argv, stdin)

    def execute(self, context: dict, action: dict) -> dict:
        argv = [self.binary, "exec", "-i", self.container,
                "/bin/sh", "-c", action["cmd"]]
        res = self._run(argv, action.get("in"))
        return {**action, **res, "host": self.container}

    def upload(self, context, local_paths, remote_path, opts=None):
        if isinstance(local_paths, (str, bytes)):
            local_paths = [local_paths]
        for p in local_paths:
            res = self._run([self.binary, "cp", str(p),
                             f"{self.container}:{remote_path}"])
            if res["exit"] != 0:
                raise RemoteError(f"docker cp to {self.container} failed: "
                                  f"{res['err']}", res)

    def download(self, context, remote_paths, local_path, opts=None):
        if isinstance(remote_paths, (str, bytes)):
            remote_paths = [remote_paths]
        for p in remote_paths:
            res = self._run([self.binary, "cp",
                             f"{self.container}:{p}", str(local_path)])
            if res["exit"] != 0:
                raise RemoteError(
                    f"docker cp from {self.container} failed: "
                    f"{res['err']}", res)


def remote() -> DockerRemote:
    return DockerRemote()
