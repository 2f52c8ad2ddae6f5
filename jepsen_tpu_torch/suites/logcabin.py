"""LogCabin test suite — a CAS register over the Raft reference
implementation.

Mirrors Jepsen's `logcabin/src/jepsen/logcabin.clj`: build from
source (git clone + scons), per-node serverId/listenAddresses config,
bootstrap on the first node, cluster formation via the Reconfigure
tool, and a CAS register client that drives the TreeOps example binary
*through the control layer* (`logcabin.clj:163-208` — ops are remote
shell invocations, not a wire protocol). CAS conflicts and timeouts
are recognized from TreeOps' error text (`logcabin.clj:152-160`)."""

from __future__ import annotations

import json
import logging
import re

from .. import cli, client as jclient, control, core, models
from .. import db as jdb
from ..checker import linear
from ..control import util as cu
from ..control.core import RemoteError
from ..os_ import debian
from . import std_opts, std_test

log = logging.getLogger(__name__)

# the DB node's superuser home, where Jepsen's logcabin suite builds and
# runs everything
NODE_HOME = "/root"
CONFIG_FILE = f"{NODE_HOME}/logcabin.conf"
LOG_FILE = f"{NODE_HOME}/logcabin.log"
PID_FILE = f"{NODE_HOME}/logcabin.pid"
STORE_DIR = f"{NODE_HOME}/storage"
BIN = f"{NODE_HOME}/LogCabin"
RECONFIGURE_BIN = f"{NODE_HOME}/Reconfigure"
TREEOPS_BIN = f"{NODE_HOME}/TreeOps"
PORT = 5254
OP_TIMEOUT_S = 3

CAS_FAIL_RE = re.compile(
    r"Exiting due to LogCabin::Client::Exception: Path '.*' has value "
    r"'.*', not '.*' as required")
TIMEOUT_RE = re.compile(
    r"Exiting due to LogCabin::Client::Exception: Client-specified "
    r"timeout elapsed")


def server_addrs(test: dict) -> str:
    return ",".join(f"{n}:{PORT}" for n in test["nodes"])


class DB(jdb.DB, jdb.LogFiles):
    """Build-from-source install + bootstrap/reconfigure cluster
    formation (`logcabin.clj:23-150`)."""

    def setup(self, test, node):
        debian.install(["git-core", "protobuf-compiler",
                        "libprotobuf-dev", "libcrypto++-dev", "g++",
                        "scons"])
        with control.su():
            try:
                control.exec_("test", "-d", "/logcabin")
            except RemoteError:
                control.exec_(
                    "git", "clone", "--depth", "1",
                    "https://github.com/logcabin/logcabin.git",
                    "/logcabin")
                with control.cd("/logcabin"):
                    control.exec_("git", "submodule", "update",
                                  "--init")
            with control.cd("/logcabin"):
                control.exec_("scons")
            for src, dst in (("build/LogCabin", BIN),
                             ("build/Examples/Reconfigure",
                              RECONFIGURE_BIN),
                             ("build/Examples/TreeOps", TREEOPS_BIN)):
                control.exec_("cp", "-f", f"/logcabin/{src}", dst)
            server_id = str(test["nodes"].index(node) + 1)
            cu.write_file(f"serverId = {server_id}\n"
                          f"listenAddresses = {node}:{PORT}\n",
                          CONFIG_FILE)
            control.exec_("rm", "-rf", LOG_FILE)
            if node == test["nodes"][0]:
                control.exec_(BIN, "-c", CONFIG_FILE, "-l", LOG_FILE,
                              "--bootstrap")
        # barriers between bootstrap / start / reconfigure: Reconfigure
        # needs every peer built and listening (`logcabin.clj:133-141`)
        core.synchronize(test)
        with control.su():
            control.exec_(BIN, "-c", CONFIG_FILE, "-d", "-l", LOG_FILE,
                          "-p", PID_FILE)
        core.synchronize(test)
        if node == test["nodes"][0]:
            with control.su():
                control.exec_(RECONFIGURE_BIN, "-c",
                              server_addrs(test), "set",
                              *[f"{n}:{PORT}" for n in test["nodes"]])
        core.synchronize(test)

    def teardown(self, test, node):
        with control.su():
            cu.grepkill("LogCabin")
            try:
                control.exec_("rm", "-rf", PID_FILE, STORE_DIR)
            except RemoteError:
                pass

    def log_files(self, test, node):
        return [LOG_FILE]


def db() -> DB:
    return DB()


class CASClient(jclient.Client):
    """CAS register at /jepsen via the TreeOps binary, invoked over the
    node's control session (`logcabin.clj:210-262`). Values round-trip
    as JSON text."""

    PATH = "/jepsen"

    def __init__(self):
        self.node = None

    def open(self, test, node):
        c = CASClient()
        c.node = node
        return c

    def _on_node(self, test, fn):
        sess = (test.get("sessions") or {}).get(self.node)
        if sess is None:
            raise RemoteError(f"no session for {self.node!r}")
        with control.with_session(self.node, sess):
            with control.su():
                return fn()

    def setup(self, test):
        try:
            self._on_node(test, lambda: self._write(test, None))
        except RemoteError:
            pass  # another node's client seeds the register

    def _read(self, test):
        return control.exec_(TREEOPS_BIN, "-c", server_addrs(test),
                             "-q", "-t", str(OP_TIMEOUT_S), "read",
                             self.PATH)

    def _run_with_stdin(self, cmd: str, stdin: str) -> str:
        res = control.ssh_star({"cmd": cmd, "in": stdin})
        control.throw_on_nonzero_exit(res)
        return res.get("out", "")

    def _write(self, test, value):
        return self._run_with_stdin(
            f"{TREEOPS_BIN} -c {server_addrs(test)} -q "
            f"-t {OP_TIMEOUT_S} write {self.PATH}",
            json.dumps(value))

    def _cas(self, test, old, new):
        return self._run_with_stdin(
            f"{TREEOPS_BIN} -c {server_addrs(test)} -q "
            f"-p {self.PATH}:{json.dumps(old)} "
            f"-t {OP_TIMEOUT_S} write {self.PATH}",
            json.dumps(new))

    def invoke(self, test, op):
        f = op["f"]
        try:
            if f == "read":
                out = self._on_node(test, lambda: self._read(test))
                v = json.loads(out) if out.strip() else None
                return {**op, "type": "ok", "value": v}
            if f == "write":
                self._on_node(test,
                              lambda: self._write(test, op["value"]))
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = op["value"]
                self._on_node(test,
                              lambda: self._cas(test, old, new))
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {f!r}")
        except RemoteError as e:
            msg = str(e).strip()
            if f == "cas" and CAS_FAIL_RE.search(msg):
                return {**op, "type": "fail", "error": "cas-mismatch"}
            if TIMEOUT_RE.search(msg):
                t = "fail" if f == "read" else "info"
                return {**op, "type": t, "error": "timed-out"}
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": msg[:200]}


def register_workload(opts: dict) -> dict:
    from .. import generator as gen

    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def w(test, ctx):
        return {"type": "invoke", "f": "write",
                "value": gen.rng.randrange(5)}

    def cas(test, ctx):
        return {"type": "invoke", "f": "cas",
                "value": (gen.rng.randrange(5), gen.rng.randrange(5))}

    return {
        "client": CASClient(),
        "generator": gen.mix([r, w, cas]),
        "checker": linear.linearizable(models.cas_register(),
                                       device=opts.get("device")),
    }


WORKLOADS = {"register": register_workload}


def logcabin_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "register")
    return std_test(
        opts, name=f"logcabin-{workload_name}", db=db(),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "register")


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": logcabin_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
