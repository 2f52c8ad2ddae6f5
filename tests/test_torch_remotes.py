"""The port's last remotes, nemeses and host helpers against the JAX
package's: the docker and kubectl remotes hand the same argv and stdin
to `cli_run`; faketime and the CharybdeFS module send the same commands,
with the same contexts, to the same nodes over the dummy remote; a file
cached by one package's `fs_cache` reads back in the other's; and the
membership nemesis's view threads end with its teardown."""

import random

import pytest

from jepsen_tpu import control as jcontrol
from jepsen_tpu import faketime as jfaketime
from jepsen_tpu import fs_cache as jfs_cache
from jepsen_tpu.control import docker as jdocker
from jepsen_tpu.control import dummy as jdummy
from jepsen_tpu.control import k8s as jk8s
from jepsen_tpu.nemesis import charybdefs as jcharybdefs
from jepsen_tpu_torch import control as tcontrol
from jepsen_tpu_torch import faketime as tfaketime
from jepsen_tpu_torch import fs_cache as tfs_cache
from jepsen_tpu_torch.control import docker as tdocker
from jepsen_tpu_torch.control import dummy as tdummy
from jepsen_tpu_torch.control import k8s as tk8s
from jepsen_tpu_torch.nemesis import charybdefs as tcharybdefs

JAX = dict(control=jcontrol, dummy=jdummy, docker=jdocker, k8s=jk8s,
           faketime=jfaketime, charybdefs=jcharybdefs, fs_cache=jfs_cache)
PORT = dict(control=tcontrol, dummy=tdummy, docker=tdocker, k8s=tk8s,
            faketime=tfaketime, charybdefs=tcharybdefs, fs_cache=tfs_cache)
NODES = ["n1", "n2", "n3"]


# -- docker and kubectl: the argv handed to cli_run -------------------------

def _cli_calls(pkg, monkeypatch, kind, make, exit_code=0):
    """Drive a remote through the control DSL with `cli_run` patched;
    returns the (argv, stdin) calls and the DSL's answers."""
    calls = []

    def fake(argv, stdin=None, timeout=None):
        calls.append((list(argv), stdin))
        return {"exit": exit_code, "out": "out\n", "err": "err"}

    monkeypatch.setattr(pkg[kind], "cli_run", fake)
    c = pkg["control"]
    answers = []
    with c.with_remote(make(pkg[kind])), c.on("n1"):
        try:
            answers.append(c.exec_("echo", "hi there"))
            with c.su(), c.cd("/opt/db"):
                answers.append(c.exec_("ls", "-A"))
            answers.append(c.ssh_star({"cmd": "cat", "in": "payload"}))
            c.upload(["/tmp/a", "/tmp/b"], "/opt/x")
            c.download("/var/log/db.log", "/tmp/logs")
        except c.RemoteError as e:
            answers.append(("error", str(e)))
    return calls, answers


REMOTES = [
    ("docker", lambda m: m.remote()),
    ("docker", lambda m: m.DockerRemote(binary="podman")),
    ("k8s", lambda m: m.remote()),
    ("k8s", lambda m: m.K8sRemote(namespace="jepsen", binary="oc")),
]


@pytest.mark.parametrize("kind,make", REMOTES)
@pytest.mark.parametrize("exit_code", [0, 1])
def test_cli_remotes_pass_the_jax_packages_argv(monkeypatch, kind, make,
                                                exit_code):
    t = _cli_calls(PORT, monkeypatch, kind, make, exit_code)
    j = _cli_calls(JAX, monkeypatch, kind, make, exit_code)
    assert t[0], kind
    assert t == j


# -- faketime and CharybdeFS over the dummy remote ---------------------------

def _responses(stat_ok):
    return {r"\bstat": lambda ctx, a: {"exit": 0 if stat_ok else 1},
            r"dpkg --get-selections": "curl\t\t\tinstall\n",
            r"ls -A": "thrift-0.10.0\n"}


def _sessions_test(remote):
    return {"nodes": list(NODES),
            "sessions": {n: remote.connect({"host": n}) for n in NODES}}


def _faketime_install(p, t):
    p["faketime"].install()


def _faketime_wrap(p, t):
    p["faketime"].wrap("/opt/db/bin/db", -7, 1.25)


def _faketime_unwrap(p, t):
    p["faketime"].unwrap("/opt/db/bin/db")


def _charybdefs_install(p, t):
    p["charybdefs"].install()


def _charybdefs_nemesis(p, t):
    nem = p["charybdefs"].nemesis()
    out = [sorted(nem.fs())]
    nem.setup(t)
    for f, nodes in (("break-all", None), ("break-one-percent", ["n2"]),
                     ("clear-fs-faults", ["n1", "n3"])):
        r = nem.invoke(t, {"type": "info", "f": f, "value": nodes})
        out.append((r["f"], sorted(r["value"])))
    nem.teardown(t)
    return out


CALLS = [
    ("faketime-install", _faketime_install, False, True),
    ("faketime-install-present", _faketime_install, True, True),
    ("faketime-wrap", _faketime_wrap, False, True),
    ("faketime-wrap-again", _faketime_wrap, True, True),
    ("faketime-unwrap", _faketime_unwrap, True, True),
    ("charybdefs-install", _charybdefs_install, False, True),
    ("charybdefs-install-built", _charybdefs_install, True, True),
    ("charybdefs-nemesis", _charybdefs_nemesis, True, False),
]


def _command_log(pkg, fn, stat_ok, on_n1):
    r = pkg["dummy"].DummyRemote(responses=_responses(stat_ok))
    random.seed(5)  # tmp_dir's names
    c = pkg["control"]
    with c.with_remote(r):
        if on_n1:
            with c.on("n1"):
                out = fn(pkg, _sessions_test(r))
        else:
            out = fn(pkg, _sessions_test(r))
    # nodes run in parallel: order each node's commands on its own
    return out, sorted(r.log, key=lambda e: e[0])


@pytest.mark.parametrize("name,fn,stat_ok,on_n1", CALLS,
                         ids=[c[0] for c in CALLS])
def test_helpers_send_the_jax_packages_commands(name, fn, stat_ok, on_n1):
    t_out, t_log = _command_log(PORT, fn, stat_ok, on_n1)
    j_out, j_log = _command_log(JAX, fn, stat_ok, on_n1)
    assert t_log, name
    assert t_out == j_out
    assert t_log == j_log


@pytest.mark.parametrize("args", [("/opt/db/bin/db", -5, 1.5),
                                  ("~/bin/db", 30, 0.5),
                                  ("db", 0, 2)])
def test_faketime_scripts_and_factors_match(args):
    assert tfaketime.script(*args) == jfaketime.script(*args)
    for factor in (1.0, 2.5, 10):
        assert tfaketime.rand_factor(factor, random.Random(3)) == \
            jfaketime.rand_factor(factor, random.Random(3))


# -- fs_cache: one on-disk layout for both packages --------------------------

PATHS = ["k", ("nested", "path", 3), "../../evil", ("a b", "c/d", "%"),
         ".", ("..", "x")]


@pytest.fixture
def shared_cache(tmp_path):
    d = str(tmp_path / "cache")
    assert tfs_cache.DEFAULT_DIR == jfs_cache.DEFAULT_DIR
    for m in (tfs_cache, jfs_cache):
        m.set_dir(d)
    try:
        yield d
    finally:
        for m in (tfs_cache, jfs_cache):
            m.set_dir(m.DEFAULT_DIR)


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_a_cached_file_reads_back_in_the_other_package(shared_cache, tmp_path,
                                                       writer, reader):
    w, r = writer["fs_cache"], reader["fs_cache"]
    for i, p in enumerate(PATHS):
        assert w.file_path(p) == r.file_path(p)
        assert str(tmp_path) in r.file_path(p)
        w.save_string(f"s{i}", p)
        assert r.cached(p) and r.load_string(p) == f"s{i}"
    w.save_data({"a": [1, 2], "b": None, "c": "x"}, ("data", 1))
    assert r.load_data(("data", 1)) == {"a": [1, 2], "b": None, "c": "x"}
    w.save_bytes(b"\x00\x01bin", ("bytes",))
    assert r.load_bytes(("bytes",)) == b"\x00\x01bin"
    src = tmp_path / "artifact.tar"
    src.write_bytes(b"tarball")
    w.save_file(str(src), ("files", "artifact.tar"))
    got = r.load_file(("files", "artifact.tar"))
    assert got == w.load_file(("files", "artifact.tar"))
    assert open(got, "rb").read() == b"tarball"
    calls = []
    f = r.fetch(("data", 1), lambda: calls.append(1) or b"recomputed")
    assert f == w.file_path(("data", 1)) and not calls
    r.clear(("data", 1))
    assert not w.cached(("data", 1))


# -- membership: the view threads end with teardown --------------------------

_MEMBERSHIP_RUN = r"""
import threading, time
import torch
from jepsen_tpu_torch import control
from jepsen_tpu_torch.control import dummy
from jepsen_tpu_torch.nemesis import membership


class Views(membership.State):
    def __init__(self):
        self.removed, self.node_views, self.view = set(), {}, None

    def node_view(self, test, node):
        return sorted(set(test["nodes"]) - self.removed)

    def merge_views(self, test):
        return sorted(self.node_views)

    def fs(self):
        return {"remove-node"}

    def op(self, test):
        return {"type": "info", "f": "remove-node", "value": "n3"}

    def invoke(self, test, op):
        self.removed.add(op["value"])
        return {**op, "value": [op["value"], "removed"]}

    def resolve_op(self, test, op_pair):
        return self


remote = dummy.DummyRemote()
test = {"nodes": ["n1", "n2", "n3"],
        "sessions": {n: remote.connect({"host": n})
                     for n in ("n1", "n2", "n3")}}
pkg = membership.package({"faults": ["membership"],
                          "membership": {"state": Views()}})
nem = pkg["nemesis"]
with control.with_remote(remote):
    nem.setup(test)
    started = sorted(t.name for t in threading.enumerate()
                     if t.name.startswith("membership-view-"))
    assert started == ["membership-view-n1", "membership-view-n2",
                       "membership-view-n3"], started
    time.sleep(0.3)
    out = nem.invoke(test, nem.shared.state.op(test))
    assert out["value"] == ["n3", "removed"], out
    nem.teardown(test)
alive = [t.name for t in threading.enumerate()
         if t.name.startswith("membership-view-")]
print("ALIVE", alive)
"""


def test_membership_view_threads_end_with_teardown():
    """A torch process whose thread outlives teardown aborts at exit
    (the service's F5): the membership nemesis's per-node view threads
    are joined by its teardown, and the process exits 0. (The threads
    do not inherit the caller's control bindings, in either package:
    ROADMAP F8. Here they find no ssh binary and retry until stopped.)"""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    p = subprocess.run([sys.executable, "-c", _MEMBERSHIP_RUN], cwd=repo,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "ALIVE []" in p.stdout, p.stdout
