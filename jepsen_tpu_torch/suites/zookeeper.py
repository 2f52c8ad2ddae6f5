"""ZooKeeper test suite — the minimal complete exemplar.

Mirrors `zookeeper/src/jepsen/zookeeper.clj`: apt-installed ZK on
Debian nodes with per-node myid and a generated zoo.cfg quorum section
(:40-72), a CAS-register client over a single znode (:74-104, avout's
zk-atom becomes versioned setData — ZK's native compare-and-swap), a
random-halves partition nemesis, and the linearizable-register checker
running on device.
"""

from __future__ import annotations

import logging

from .. import checker, cli, client as jclient, control
from .. import db as jdb
from .. import generator as gen
from .. import models, testkit
from ..checker import timeline
from ..nemesis import partition
from ..os_ import debian
from . import zk_proto

log = logging.getLogger(__name__)

DEFAULT_VERSION = "3.4.13-6+deb10u1"
CLIENT_PORT = 2181
REGISTER_PATH = "/jepsen"

ZOO_CFG = """\
tickTime=2000
initLimit=10
syncLimit=5
dataDir=/var/lib/zookeeper
clientPort=2181
maxClientCnxns=0
"""


def zk_node_ids(test: dict) -> dict:
    """node name -> numeric id (`zookeeper.clj:20-25`)."""
    return {node: i for i, node in enumerate(test["nodes"])}


def zk_node_id(test: dict, node: str) -> int:
    return zk_node_ids(test)[node]


def zoo_cfg_servers(test: dict) -> str:
    """server.N=host:2888:3888 lines (`zookeeper.clj:33-38`)."""
    return "\n".join(f"server.{i}={node}:2888:3888"
                     for node, i in zk_node_ids(test).items())


class DB(jdb.DB, jdb.LogFiles):
    """ZooKeeper DB for a particular version (`zookeeper.clj:40-72`)."""

    def __init__(self, version: str = DEFAULT_VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            log.info("%s installing ZK %s", node, self.version)
            debian.install({"zookeeper": self.version,
                            "zookeeper-bin": self.version,
                            "zookeeperd": self.version})
            control.exec_("echo", str(zk_node_id(test, node)),
                          control.lit(">"), "/etc/zookeeper/conf/myid")
            control.exec_(
                "echo", ZOO_CFG + "\n" + zoo_cfg_servers(test),
                control.lit(">"), "/etc/zookeeper/conf/zoo.cfg")
            log.info("%s ZK restarting", node)
            control.exec_("service", "zookeeper", "restart")
            log.info("%s ZK ready", node)

    def teardown(self, test, node):
        log.info("%s tearing down ZK", node)
        with control.su():
            control.exec_("service", "zookeeper", "stop")
            control.exec_("rm", "-rf",
                          control.lit("/var/lib/zookeeper/version-*"),
                          control.lit("/var/log/zookeeper/*"))

    def log_files(self, test, node):
        return ["/var/log/zookeeper/zookeeper.log"]


def db(version: str = DEFAULT_VERSION) -> DB:
    return DB(version)


class ZkClient(jclient.Client):
    """A CAS-register client over one znode. CAS = setData conditioned
    on the read version — exactly what avout's swap!! compiles to
    (`zookeeper.clj:78-104`)."""

    def __init__(self, timeout_s: float = 5.0,
                 conn: zk_proto.ZooKeeper | None = None,
                 port: int = CLIENT_PORT):
        self.timeout_s = timeout_s
        self.conn = conn
        self.port = port

    def open(self, test, node):
        port = test.get("zk-port", self.port)
        host = test.get("zk-host-fn", lambda n: n)(node)
        conn = zk_proto.ZooKeeper(host, port, self.timeout_s)
        c = ZkClient(self.timeout_s, conn, port)
        return c

    def setup(self, test):
        try:
            self.conn.create(REGISTER_PATH, b"0")
        except zk_proto.ZkError as e:
            if e.code != zk_proto.NODEEXISTS:
                raise

    def invoke(self, test, op):
        f = op["f"]
        if f not in ("read", "write", "cas"):
            raise ValueError(f"unknown f {f!r}")
        try:
            if f == "read":
                data, _stat = self.conn.get_data(REGISTER_PATH)
                return {**op, "type": "ok", "value": int(data)}
            if f == "write":
                self.conn.set_data(REGISTER_PATH,
                                   str(op["value"]).encode(), -1)
                return {**op, "type": "ok"}
            old, new = op["value"]
            data, stat = self.conn.get_data(REGISTER_PATH)
            if int(data) != old:
                return {**op, "type": "fail"}
            try:
                self.conn.set_data(REGISTER_PATH, str(new).encode(),
                                   stat.version)
                return {**op, "type": "ok"}
            except zk_proto.ZkError as e:
                if e.code == zk_proto.BADVERSION:
                    # someone else wrote between our read and write
                    return {**op, "type": "fail"}
                raise
        except zk_proto.ZkError as e:
            return {**op, "type": "fail" if f == "read" else "info",
                    "error": ["zookeeper", e.code]}
        except (OSError, ValueError) as e:
            return {**op, "type": "fail" if f == "read" else "info",
                    "error": ["timeout", str(e)]}

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


def r(test, ctx):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, ctx):
    return {"type": "invoke", "f": "write", "value": gen.rng.randrange(5)}


def cas(test, ctx):
    return {"type": "invoke", "f": "cas",
            "value": [gen.rng.randrange(5), gen.rng.randrange(5)]}


def zk_test(opts: dict) -> dict:
    """Options map -> test map (`zookeeper.clj:106-129`)."""
    time_limit = opts.get("time-limit", opts.get("time_limit", 15))
    return {
        **testkit.noop_test(),
        **{k: v for k, v in opts.items() if isinstance(k, str)},
        "name": "zookeeper",
        "os": debian.os,
        "db": db(opts.get("version", DEFAULT_VERSION)),
        "client": ZkClient(),
        "nemesis": partition.partition_random_halves(),
        "generator": gen.time_limit(
            time_limit,
            gen.nemesis(
                gen.cycle(gen.phases(
                    gen.sleep(5),
                    gen.once({"type": "info", "f": "start",
                              "value": None}),
                    gen.sleep(5),
                    gen.once({"type": "info", "f": "stop",
                              "value": None}))),
                gen.stagger(1, gen.mix([r, w, cas])))),
        "model": models.cas_register(0),
        "checker": checker.compose({
            "perf": checker.perf_checker(),
            "timeline": timeline.html(),
            "linear": checker.linearizable(models.cas_register(0),
                                           device=opts.get("device")),
        }),
    }


OPT_SPEC = [
    cli.opt("--version", default=DEFAULT_VERSION,
            help="ZooKeeper package version to install"),
]


def main(argv=None):
    """`-main` parity (`zookeeper.clj:131-137`)."""
    cli.run({**cli.single_test_cmd({"test_fn": zk_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
