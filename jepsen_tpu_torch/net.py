"""Network manipulation: the Net protocol and iptables/ipfilter backends.

Reference: `jepsen/src/jepsen/net.clj` (`Net` protocol :15-26, `drop-all!`
fast path :29-44, iptables impl :58-111, ipfilter :113-145),
`jepsen/src/jepsen/net/proto.clj` (PartitionAll batch drop), and
`jepsen/src/jepsen/control/net.clj` (ip lookup via getent, local-ip,
control-ip).

A *grudge* is {node: set-of-nodes-to-drop-traffic-from}.
"""

from __future__ import annotations

import threading

from . import control as c
from .control.core import RemoteError, lit
from .util import real_pmap

TC = "/sbin/tc"


# -- control.net helpers ----------------------------------------------------

_ip_cache: dict[str, str] = {}
_ip_lock = threading.Lock()


def reachable(node: str) -> bool:
    """Can the current node ping node? (`control/net.clj:8-12`)"""
    try:
        c.exec_("ping", "-w", 1, node)
        return True
    except RemoteError:
        return False


def local_ip() -> str:
    """The current node's IP (`control/net.clj:14-17`)."""
    return c.exec_("hostname", "-I").split()[0]


def ip_uncached(host: str) -> str:
    """Resolve host via getent on the current node
    (`control/net.clj:19-35`)."""
    res = c.exec_("getent", "ahosts", host)
    first = res.split("\n")[0]
    ip = first.split()[0] if first.split() else ""
    if not ip:
        raise RemoteError(f"blank getent ip for {host}: {res!r}")
    return ip


def ip(host: str) -> str:
    """Memoized hostname→IP (`control/net.clj:37-39`)."""
    with _ip_lock:
        if host not in _ip_cache:
            _ip_cache[host] = ip_uncached(host)
        return _ip_cache[host]


def clear_ip_cache() -> None:
    """Forget every memoized address: `core.run` calls it first, so a
    run resolves its own cluster's names and never an earlier run's."""
    with _ip_lock:
        _ip_cache.clear()


def control_ip() -> str:
    """The control node's IP as seen by the current DB node
    (`control/net.clj:41-52`)."""
    with c.binding(sudo=None):  # $SSH_CLIENT doesn't survive sudo subshells
        out = c.exec_("bash", "-c", "echo $SSH_CLIENT")
    return out.split()[0]


# -- Net protocol -----------------------------------------------------------

class Net:
    def drop(self, test: dict, src: str, dest: str) -> None:
        """Drop traffic from src as seen at dest."""
        raise NotImplementedError

    def heal(self, test: dict) -> None:
        """End all drops; restore fast operation."""
        raise NotImplementedError

    def slow(self, test: dict, mean_ms: float = 50, variance_ms: float = 10,
             distribution: str = "normal") -> None:
        """Delay packets cluster-wide."""
        raise NotImplementedError

    def flaky(self, test: dict) -> None:
        """Randomized packet loss cluster-wide."""
        raise NotImplementedError

    def fast(self, test: dict) -> None:
        """Remove delays/loss."""
        raise NotImplementedError


class PartitionAll:
    """Optional fast path: apply a whole grudge in one batched call per
    node (`net/proto.clj:5-12`)."""

    def drop_all(self, test: dict, grudge: dict) -> None:
        raise NotImplementedError


def drop_all(test: dict, grudge: dict) -> None:
    """Apply a grudge to the test's net, batched when supported
    (`net.clj:29-44`)."""
    net = test["net"]
    if isinstance(net, PartitionAll) or callable(
            getattr(net, "drop_all", None)):
        net.drop_all(test, grudge)
        return
    pairs = [(src, dst) for dst, srcs in grudge.items() for src in srcs]
    real_pmap(lambda p: net.drop(test, p[0], p[1]), pairs)


class Noop(Net):
    """Does nothing (`net.clj:48-56`)."""

    def drop(self, test, src, dest):
        pass

    def heal(self, test):
        pass

    def slow(self, test, mean_ms=50, variance_ms=10,
             distribution="normal"):
        pass

    def flaky(self, test):
        pass

    def fast(self, test):
        pass


noop = Noop()


def _each_node(test, f):
    c.on_nodes(test, lambda t, n: f())


class IPTables(Net, PartitionAll):
    """Default iptables implementation (`net.clj:58-111`)."""

    def drop(self, test, src, dest):
        with c.on(dest), c.su():
            c.exec_("iptables", "-A", "INPUT", "-s", ip(src),
                    "-j", "DROP", "-w")

    def heal(self, test):
        def f():
            with c.su():
                c.exec_("iptables", "-F", "-w")
                c.exec_("iptables", "-X", "-w")
        _each_node(test, f)

    def slow(self, test, mean_ms=50, variance_ms=10,
             distribution="normal"):
        def f():
            with c.su():
                c.exec_(TC, "qdisc", "add", "dev", "eth0", "root",
                        "netem", "delay", f"{mean_ms}ms",
                        f"{variance_ms}ms", "distribution", distribution)
        _each_node(test, f)

    def flaky(self, test):
        def f():
            with c.su():
                c.exec_(TC, "qdisc", "add", "dev", "eth0", "root",
                        "netem", "loss", "20%", "75%")
        _each_node(test, f)

    def fast(self, test):
        def f():
            try:
                with c.su():
                    c.exec_(TC, "qdisc", "del", "dev", "eth0", "root")
            except RemoteError as e:
                # no qdisc installed — already fast (`net.clj:95-99`)
                if "RTNETLINK answers: No such file or directory" not in \
                        str(e):
                    raise
        _each_node(test, f)

    def drop_all(self, test, grudge):
        def snub(t, node):
            srcs = grudge.get(node)
            if srcs:
                with c.su():
                    c.exec_("iptables", "-A", "INPUT", "-s",
                            ",".join(ip(s) for s in sorted(srcs)),
                            "-j", "DROP", "-w")
        c.on_nodes(test, snub, nodes=list(grudge.keys()))


iptables = IPTables()


class IPFilter(Net):
    """ipf(8) implementation for BSD-ish systems (`net.clj:113-145`)."""

    def drop(self, test, src, dest):
        with c.on(dest), c.su():
            c.exec_("echo", "block", "in", "from", src, "to", "any",
                    lit("|"), "ipf", "-f", "-")

    def heal(self, test):
        def f():
            with c.su():
                c.exec_("ipf", "-Fa")
        _each_node(test, f)

    def slow(self, test, mean_ms=50, variance_ms=10,
             distribution="normal"):
        def f():
            with c.su():
                c.exec_(TC, "qdisc", "add", "dev", "eth0", "root",
                        "netem", "delay", f"{mean_ms}ms",
                        f"{variance_ms}ms", "distribution", distribution)
        _each_node(test, f)

    def flaky(self, test):
        def f():
            with c.su():
                c.exec_(TC, "qdisc", "add", "dev", "eth0", "root",
                        "netem", "loss", "20%", "75%")
        _each_node(test, f)

    def fast(self, test):
        def f():
            with c.su():
                c.exec_(TC, "qdisc", "del", "dev", "eth0", "root")
        _each_node(test, f)


ipfilter = IPFilter()
