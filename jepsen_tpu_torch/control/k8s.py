"""Kubernetes remote: `kubectl exec` / `kubectl cp` as the control
transport.

Reference: `jepsen/src/jepsen/control/k8s.clj` — an alternate Remote for
nodes that are pods. The conn spec's host is the pod name; an optional
``namespace`` is threaded through.
"""

from __future__ import annotations

from .core import Remote, RemoteError, cli_run


class K8sRemote(Remote):
    def __init__(self, pod: str | None = None, namespace: str = "default",
                 binary: str = "kubectl"):
        self.pod = pod
        self.namespace = namespace
        self.binary = binary

    def connect(self, conn_spec: dict) -> "K8sRemote":
        return K8sRemote(conn_spec["host"],
                         conn_spec.get("namespace", self.namespace),
                         self.binary)

    def _run(self, argv, stdin=None) -> dict:
        return cli_run(argv, stdin)

    def execute(self, context: dict, action: dict) -> dict:
        argv = [self.binary, "-n", self.namespace, "exec", "-i", self.pod,
                "--", "/bin/sh", "-c", action["cmd"]]
        res = self._run(argv, action.get("in"))
        return {**action, **res, "host": self.pod}

    def upload(self, context, local_paths, remote_path, opts=None):
        if isinstance(local_paths, (str, bytes)):
            local_paths = [local_paths]
        for p in local_paths:
            res = self._run([self.binary, "-n", self.namespace, "cp",
                             str(p), f"{self.pod}:{remote_path}"])
            if res["exit"] != 0:
                raise RemoteError(f"kubectl cp to {self.pod} failed: "
                                  f"{res['err']}", res)

    def download(self, context, remote_paths, local_path, opts=None):
        if isinstance(remote_paths, (str, bytes)):
            remote_paths = [remote_paths]
        for p in remote_paths:
            res = self._run([self.binary, "-n", self.namespace, "cp",
                             f"{self.pod}:{p}", str(local_path)])
            if res["exit"] != 0:
                raise RemoteError(f"kubectl cp from {self.pod} failed: "
                                  f"{res['err']}", res)


def remote() -> K8sRemote:
    return K8sRemote()
