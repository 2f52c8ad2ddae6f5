"""Apache Ignite test suite — register and bank over the REST API.

Mirrors Jepsen's `ignite/src/jepsen/ignite{,/register,/bank}`:
zip-dist install with per-node spring XML carrying the cache config
(backups/mode/atomicity), topology-snapshot waits, and two workloads:

  * register: per-key read/write/cas on one cache —
    `register.clj:32-43` (the Java client's get/put/replace) maps to
    REST cmd=get/put/cas.
  * bank: transfers across account keys. The reference uses thick-
    client transactions (`bank.clj:27-45`); REST has no multi-key
    transactions, so this port keeps the reference's *test semantics*
    by storing all balances in one JSON value updated via cas — the
    conserved-total property the bank checker verifies is identical.

Hermetic tests run against `tests/fake_es_ignite.py`."""

from __future__ import annotations

import json
import logging
import urllib.parse
import urllib.request

from .. import cli, client as jclient, control, independent
from .. import db as jdb
from ..control import util as cu
from ..control.core import RemoteError
from ..os_ import debian
from ..workloads import bank as bank_w
from . import std_opts, std_test

log = logging.getLogger(__name__)

REST_PORT = 8080
SERVER_DIR = "/opt/ignite"
LOGFILE = f"{SERVER_DIR}/node.log"
DEFAULT_VERSION = "2.7.6"

SPRING_XML = """\
<?xml version="1.0" encoding="UTF-8"?>
<beans xmlns="http://www.springframework.org/schema/beans"
       xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
       xsi:schemaLocation="http://www.springframework.org/schema/beans
       http://www.springframework.org/schema/beans/spring-beans.xsd">
  <bean id="ignite.cfg"
        class="org.apache.ignite.configuration.IgniteConfiguration">
    <property name="discoverySpi">
      <bean class="org.apache.ignite.spi.discovery.tcp.TcpDiscoverySpi">
        <property name="ipFinder">
          <bean class="org.apache.ignite.spi.discovery.tcp.ipfinder.vm.\
TcpDiscoveryVmIpFinder">
            <property name="addresses">
              <list>
{addresses}
              </list>
            </property>
          </bean>
        </property>
      </bean>
    </property>
    <property name="cacheConfiguration">
      <bean class="org.apache.ignite.configuration.CacheConfiguration">
        <property name="name" value="{cache}"/>
        <property name="cacheMode" value="{cache_mode}"/>
        <property name="atomicityMode" value="TRANSACTIONAL"/>
        <property name="backups" value="{backups}"/>
      </bean>
    </property>
  </bean>
</beans>
"""


class DB(jdb.DB, jdb.Process, jdb.LogFiles):
    """zip install + spring config + topology wait
    (`ignite.clj:60-160`)."""

    def __init__(self, version: str = DEFAULT_VERSION,
                 opts: dict | None = None):
        self.version = version
        self.opts = opts or {}

    def setup(self, test, node):
        debian.install_jdk11()
        with control.su():
            url = test.get("url") or (
                "https://archive.apache.org/dist/ignite/"
                f"{self.version}/apache-ignite-{self.version}-bin.zip")
            cu.install_archive(url, SERVER_DIR)
            addresses = "\n".join(
                f'                <value>{n}:47500..47509</value>'
                for n in test["nodes"])
            cu.write_file(SPRING_XML.format(
                addresses=addresses,
                cache=self.opts.get("cache", "JEPSEN"),
                cache_mode=self.opts.get("cache-mode", "REPLICATED"),
                backups=self.opts.get("backups", 2)),
                f"{SERVER_DIR}/server-ignite-{node}.xml")
            self.start(test, node)
            cu.await_tcp_port(REST_PORT)

    def start(self, test, node):
        with control.su():
            cu.start_daemon(
                {"logfile": LOGFILE,
                 "pidfile": f"{SERVER_DIR}/node.pid",
                 "chdir": SERVER_DIR},
                f"{SERVER_DIR}/bin/ignite.sh",
                f"{SERVER_DIR}/server-ignite-{node}.xml")

    def kill(self, test, node):
        with control.su():
            cu.stop_daemon(f"{SERVER_DIR}/node.pid", cmd="java")
            cu.grepkill("ignite")

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            try:
                control.exec_("rm", "-rf", f"{SERVER_DIR}/work",
                              LOGFILE)
            except RemoteError:
                pass

    def log_files(self, test, node):
        return [LOGFILE]


def db(version: str = DEFAULT_VERSION, opts: dict | None = None) -> DB:
    return DB(version, opts)


class IgniteError(Exception):
    pass


class RestClient(jclient.Client):
    """Ignite REST API: /ignite?cmd=get|put|cas&cacheName=..."""

    CACHE = "JEPSEN"

    def __init__(self, timeout_s: float = 5.0):
        self.timeout_s = timeout_s
        self.base: str | None = None

    def open(self, test, node):
        c = type(self)(self.timeout_s)
        fn = test.get("ignite-url-fn")
        c.base = fn(node) if fn else f"http://{node}:{REST_PORT}"
        return c

    def cmd(self, **params) -> dict:
        params.setdefault("cacheName", self.CACHE)
        url = self.base + "/ignite?" + urllib.parse.urlencode(params)
        with urllib.request.urlopen(url,
                                    timeout=self.timeout_s) as r:
            out = json.loads(r.read())
        if out.get("successStatus", 1) != 0:
            raise IgniteError(out.get("error") or "rest error")
        return out

    def get(self, key):
        return self.cmd(cmd="get", key=key)["response"]

    def put(self, key, value):
        self.cmd(cmd="put", key=key, val=value)

    def cas(self, key, old, new) -> bool:
        return bool(self.cmd(cmd="cas", key=key, val=new,
                             val2=old)["response"])

    def put_if_absent(self, key, value) -> bool:
        return bool(self.cmd(cmd="putifabs", key=key,
                             val=value)["response"])


class RegisterClient(RestClient):
    """Independent-keyed register (`register.clj:22-48`)."""

    def invoke(self, test, op):
        k, v = op["value"]
        key = f"r{k}"
        try:
            if op["f"] == "read":
                out = self.get(key)
                return {**op, "type": "ok", "value": independent.ktuple(
                    k, int(out) if out is not None else None)}
            if op["f"] == "write":
                self.put(key, v)
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = v
                cur = self.get(key)
                if cur is None or int(cur) != old:
                    return {**op, "type": "fail",
                            "error": "value-mismatch"}
                ok = self.cas(key, old, new)
                return {**op, "type": "ok" if ok else "fail"}
            raise ValueError(f"unknown f {op['f']!r}")
        except (IgniteError, OSError, ValueError) as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)}


class BankClient(RestClient):
    """All balances in one JSON value, moved with cas loops — REST has
    no transactions, but conservation semantics are the reference's
    (`bank.clj:24-60`)."""

    KEY = "accounts"

    def setup(self, test):
        accounts = test.get("accounts", list(range(8)))
        total = test.get("total-amount", 100)
        balances = {str(a): (total if a == accounts[0] else 0)
                    for a in accounts}
        try:
            self.put_if_absent(self.KEY, json.dumps(balances))
        except (IgniteError, OSError):
            pass  # another worker seeds

    def invoke(self, test, op):
        try:
            if op["f"] == "read":
                raw = self.get(self.KEY)
                bal = json.loads(raw) if raw else {}
                return {**op, "type": "ok",
                        "value": {int(k): v for k, v in bal.items()}}
            if op["f"] == "transfer":
                v = op["value"]
                for _ in range(16):
                    raw = self.get(self.KEY)
                    if raw is None:
                        return {**op, "type": "fail",
                                "error": "uninitialized"}
                    bal = json.loads(raw)
                    frm, to = str(v["from"]), str(v["to"])
                    if bal.get(frm, 0) < v["amount"]:
                        return {**op, "type": "fail",
                                "error": "insufficient"}
                    bal[frm] -= v["amount"]
                    bal[to] = bal.get(to, 0) + v["amount"]
                    if self.cas(self.KEY, raw, json.dumps(bal)):
                        return {**op, "type": "ok"}
                return {**op, "type": "fail", "error": "cas-contention"}
            raise ValueError(f"unknown f {op['f']!r}")
        except (IgniteError, OSError) as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)}


def register_workload(opts) -> dict:
    from ..workloads import linearizable_register
    w = dict(linearizable_register.test(opts))
    w["client"] = RegisterClient()
    return w


def bank_workload(opts) -> dict:
    return {
        "client": BankClient(),
        "generator": bank_w.generator(),
        "checker": bank_w.checker({"negative-balances?": False}),
    }


WORKLOADS = {"register": register_workload, "bank": bank_workload}


def ignite_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "register")
    return std_test(
        opts, name=f"ignite-{workload_name}",
        db=db(opts.get("version", DEFAULT_VERSION),
              {k: opts.get(k) for k in ("cache-mode", "backups")}),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "register", DEFAULT_VERSION,
                    "ignite version (zip dist)") + [
    cli.opt("--cache-mode", default="REPLICATED",
            choices=["REPLICATED", "PARTITIONED"]),
    cli.opt("--backups", type=int, default=2),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": ignite_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
