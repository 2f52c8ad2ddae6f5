"""The port's control layer over the dummy remote: every case of
tests/test_control.py, its fs-cache cases included, run on the port;
then the same calls of `control.util`,
`net.iptables`/`net.ipfilter`, `os_.debian` and `os_.centos` in both
packages send the same commands, with the same contexts, to the same
nodes."""

import random

import pytest

import torch_mirror
from jepsen_tpu import control as jcontrol
from jepsen_tpu import net as jnet
from jepsen_tpu.control import dummy as jdummy
from jepsen_tpu.control import util as jcu
from jepsen_tpu.os_ import centos as jcentos
from jepsen_tpu.os_ import debian as jdebian
from jepsen_tpu_torch import control as tcontrol
from jepsen_tpu_torch import net as tnet
from jepsen_tpu_torch.control import dummy as tdummy
from jepsen_tpu_torch.control import util as tcu
from jepsen_tpu_torch.os_ import centos as tcentos
from jepsen_tpu_torch.os_ import debian as tdebian

globals().update(torch_mirror.cases("test_control"))

JAX = dict(control=jcontrol, net=jnet, dummy=jdummy, cu=jcu,
           debian=jdebian, centos=jcentos)
PORT = dict(control=tcontrol, net=tnet, dummy=tdummy, cu=tcu,
            debian=tdebian, centos=tcentos)
NODES = ["n1", "n2", "n3"]

RESPONSES = {
    r"getent ahosts": lambda ctx, a: {
        "out": f"10.0.0.{a['cmd'].split()[-1][-1]} STREAM x\n"},
    r"dpkg --get-selections": "curl\t\t\tinstall\n",
    r"rpm -q": "curl-7.0\n",
    r"\bcat /run/db.pid": "42",
    r"\bps -o": "42",
    r"ls -A": "db-1.0\n",
}

# each scenario: (name, fn(pkg, test)) run inside a session to n1
NODE_CALLS = [
    ("exists-ls", lambda p, t: (p["cu"].exists("/etc"), p["cu"].ls("/etc"))),
    ("write-file", lambda p, t: p["cu"].write_file("hello\n", "/tmp/x")),
    ("grepkill", lambda p, t: p["cu"].grepkill("mydb", "term")),
    ("start-daemon", lambda p, t: p["cu"].start_daemon(
        {"logfile": "/var/log/db.log", "pidfile": "/run/db.pid",
         "chdir": "/opt/db", "env": {"PORT": 1234}},
        "/opt/db/bin/db", "--serve")),
    ("stop-daemon", lambda p, t: p["cu"].stop_daemon("/run/db.pid",
                                                     cmd="db")),
    ("daemon-running", lambda p, t: p["cu"].daemon_running("/run/db.pid")),
    ("ensure-user", lambda p, t: p["cu"].ensure_user("jepsen")),
    ("signal", lambda p, t: p["cu"].signal("db", "STOP")),
    ("install-archive", lambda p, t: p["cu"].install_archive(
        "file:///tmp/db.tar.gz", "/opt/db")),
    ("debian-hostfile", lambda p, t: p["debian"].setup_hostfile()),
    ("debian-install", lambda p, t: p["debian"].install(["curl", "vim"])),
    ("debian-uninstall", lambda p, t: p["debian"].uninstall(["curl"])),
    ("debian-repo", lambda p, t: p["debian"].add_repo(
        "db", "deb http://example.invalid/ stable main")),
    ("debian-os", lambda p, t: p["debian"].os.setup(t, "n1")),
    ("centos-install", lambda p, t: p["centos"].install(["curl", "vim"])),
    ("centos-os", lambda p, t: p["centos"].os.setup(t, "n1")),
]

# each scenario: (name, fn(pkg, test)) over the whole test's sessions
NET_CALLS = [
    ("iptables-drop-all", lambda p, t: p["net"].iptables.drop_all(
        t, {"n1": {"n2", "n3"}, "n2": {"n1"}, "n3": set()})),
    ("iptables-drop", lambda p, t: p["net"].iptables.drop(t, "n1", "n2")),
    ("iptables-heal", lambda p, t: p["net"].iptables.heal(t)),
    ("iptables-slow", lambda p, t: p["net"].iptables.slow(
        t, mean_ms=100, variance_ms=5)),
    ("iptables-flaky", lambda p, t: p["net"].iptables.flaky(t)),
    ("iptables-fast", lambda p, t: p["net"].iptables.fast(t)),
    ("ipfilter-drop", lambda p, t: p["net"].ipfilter.drop(t, "n1", "n2")),
    ("ipfilter-heal", lambda p, t: p["net"].ipfilter.heal(t)),
]


def _test_map(pkg, remote):
    return {"nodes": list(NODES), "net": pkg["net"].iptables,
            "sessions": {n: remote.connect({"host": n}) for n in NODES}}


def _node_log(pkg, fn):
    r = pkg["dummy"].DummyRemote(responses=dict(RESPONSES))
    pkg["net"]._ip_cache.clear()
    random.seed(5)  # tmp_dir's names
    c = pkg["control"]
    with c.with_remote(r), c.on("n1"):
        out = fn(pkg, _test_map(pkg, r))
    return out, r.log


def _net_log(pkg, fn):
    r = pkg["dummy"].DummyRemote(responses=dict(RESPONSES))
    pkg["net"]._ip_cache.clear()
    with pkg["control"].with_remote(r):
        out = fn(pkg, _test_map(pkg, r))
    # the nodes run in parallel: order each node's commands on its own
    return out, sorted(r.log, key=lambda e: e[0])


def _comparable(log):
    return [(h, ctx, {k: v for k, v in a.items() if k != "upload"})
            for h, ctx, a in log]


@pytest.mark.parametrize("name,fn", NODE_CALLS, ids=[n for n, _ in NODE_CALLS])
def test_node_calls_send_the_jax_packages_commands(name, fn):
    t_out, t_log = _node_log(PORT, fn)
    j_out, j_log = _node_log(JAX, fn)
    assert t_log, name
    assert t_out == j_out
    assert _comparable(t_log) == _comparable(j_log)


@pytest.mark.parametrize("name,fn", NET_CALLS, ids=[n for n, _ in NET_CALLS])
def test_net_calls_send_the_jax_packages_commands(name, fn):
    t_out, t_log = _net_log(PORT, fn)
    j_out, j_log = _net_log(JAX, fn)
    assert t_log, name
    assert t_out == j_out
    assert _comparable(t_log) == _comparable(j_log)


def test_a_run_resolves_its_own_cluster_names():
    """`net.ip` memoizes, as in the JAX package; the port's `core.run`
    clears the memo first, so a name resolved for one run's cluster
    does not leak into the next run's."""
    from jepsen_tpu_torch import core as tcore
    from jepsen_tpu_torch import testkit as ttestkit

    tnet._ip_cache["n1"] = "10.9.9.9"
    t = ttestkit.noop_test()
    t.update({"ssh": {"dummy": True}, "name": None})
    tcore.run(t)
    assert "n1" not in tnet._ip_cache
