"""RobustIRC test suite — message delivery over a Raft-replicated IRC
network.

Mirrors Jepsen's `robustirc/src/jepsen/robustirc.clj`: build
via `go get`, TLS certs uploaded, the first node starts -singlenode
and the rest -join it; the set workload posts TOPIC changes to a
channel through the HTTP bridge (session create -> NICK/USER/JOIN ->
TOPIC :<n>) and the final read streams all messages back, extracting
topics (`robustirc.clj:103-184`). Verdict: the set checker — every
acknowledged topic must be readable."""

from __future__ import annotations

import hashlib
import json
import logging
import random
import ssl
import urllib.request

from .. import checker, cli, client as jclient, control, core
from .. import db as jdb
from ..control import util as cu
from ..control.core import RemoteError
from ..os_ import debian
from . import std_opts, std_test

log = logging.getLogger(__name__)

PORT = 13001
CHANNEL = "#jepsen"
NETWORK_PASSWORD = "secret"
BIN = "~/gocode/bin/robustirc"


def _meh(*cmd):
    try:
        control.exec_(*cmd)
    except RemoteError:
        pass


class DB(jdb.DB):
    """go-get build, cert upload, singlenode bootstrap + joins
    (`robustirc.clj:24-84`)."""

    def setup(self, test, node):
        with control.su():
            _meh("killall", "robustirc")
            for pkg in ("golang-go", "mercurial"):
                try:
                    control.exec_("dpkg-query", "-l", pkg)
                except RemoteError:
                    debian.install([pkg])
            control.exec_("env", "GOPATH=~/gocode", "go", "get", "-u",
                          "github.com/robustirc/robustirc")
            if test.get("certs-dir"):
                for f in ("cert.pem", "key.pem"):
                    control.upload(f"{test['certs-dir']}/{f}",
                                   f"/tmp/{f}")
            else:
                # the reference ships ONE pre-generated cert/key pair
                # to every node (`robustirc.clj:41-42`): the primary
                # generates, the control node relays the same pair to
                # everyone (per-node certs would fail -tls_ca_file
                # verification on join)
                if node == test["nodes"][0]:
                    control.exec_(
                        "openssl", "req", "-x509", "-newkey",
                        "rsa:2048", "-keyout", "/tmp/key.pem",
                        "-out", "/tmp/cert.pem", "-days", "365",
                        "-nodes", "-subj", "/CN=jepsen")
                    import tempfile
                    d = test.setdefault(
                        "_robustirc-certs",
                        tempfile.mkdtemp(prefix="robustirc-certs-"))
                    for f in ("cert.pem", "key.pem"):
                        control.download(f"/tmp/{f}", f"{d}/{f}")
        core.synchronize(test)
        with control.su():
            if not test.get("certs-dir") and node != test["nodes"][0]:
                d = test["_robustirc-certs"]
                for f in ("cert.pem", "key.pem"):
                    control.upload(f"{d}/{f}", f"/tmp/{f}")
            control.exec_("rm", "-rf", "/var/lib/robustirc")
            control.exec_("mkdir", "-p", "/var/lib/robustirc")
            common = (f"-listen={node}:{PORT}"
                      f" -network_password={NETWORK_PASSWORD}"
                      " -network_name=jepsen"
                      " -tls_cert_path=/tmp/cert.pem"
                      " -tls_ca_file=/tmp/cert.pem"
                      " -tls_key_path=/tmp/key.pem")
        # the primary bootstraps -singlenode; everyone else joins only
        # after it is up (`robustirc.clj:45-78` barriers + sleeps)
        core.synchronize(test)
        primary = test["nodes"][0]
        with control.su():
            if node == primary:
                control.exec_raw(
                    "/sbin/start-stop-daemon --start --background "
                    f"--exec {BIN} -- {common} -singlenode")
                cu.await_tcp_port(PORT)
        core.synchronize(test)
        with control.su():
            if node != primary:
                control.exec_raw(
                    "/sbin/start-stop-daemon --start --background "
                    f"--exec {BIN} -- {common} -join={primary}:{PORT}")
                cu.await_tcp_port(PORT)
        core.synchronize(test)

    def teardown(self, test, node):
        with control.su():
            _meh("killall", "robustirc")


def db() -> DB:
    return DB()


class Session:
    """One RobustIRC HTTP-bridge session (`robustirc.clj:103-121`)."""

    def __init__(self, base: str, timeout_s: float = 5.0):
        self.base = base
        self.timeout_s = timeout_s
        self.ctx = ssl._create_unverified_context() \
            if base.startswith("https") else None
        r = self._request("POST", "/robustirc/v1/session", None, {})
        self.session_id = r["Sessionid"]
        self.auth = r["Sessionauth"]

    def _request(self, method: str, path: str, auth, body):
        req = urllib.request.Request(
            self.base + path,
            data=json.dumps(body).encode() if body is not None else None,
            method=method,
            headers={"Content-Type": "application/json",
                     **({"X-Session-Auth": auth} if auth else {})})
        with urllib.request.urlopen(req, timeout=self.timeout_s,
                                    context=self.ctx) as r:
            data = r.read().decode()
        # the messages endpoint streams concatenated JSON docs
        docs = []
        dec = json.JSONDecoder()
        i = 0
        while i < len(data):
            while i < len(data) and data[i] in " \r\n\t":
                i += 1
            if i >= len(data):
                break
            doc, j = dec.raw_decode(data, i)
            docs.append(doc)
            i = j
        return docs[0] if len(docs) == 1 else docs

    def post(self, ircmessage: str):
        """ClientMessageId mirrors the reference's md5-or-random id
        (`robustirc.clj:115-121`)."""
        msgid = (random.getrandbits(31)
                 | int(hashlib.md5(ircmessage.encode())
                       .hexdigest()[17:], 16)) & 0x7FFFFFFF
        return self._request(
            "POST", f"/robustirc/v1/{self.session_id}/message",
            self.auth,
            {"Data": ircmessage, "ClientMessageId": msgid})

    def messages(self, budget_s: float = 1.0) -> list:
        """The real /messages endpoint is a never-closing long-poll
        stream: read incrementally under a wall-clock budget, keeping
        whatever parsed. This mirrors the reference's read-all exactly
        — `(util/timeout 1000 @out ...)` returns whatever accumulated
        and the read is still recorded :ok (`robustirc.clj:123-136`,
        `:172-177`) — so, like the reference, a read the budget
        truncated can under-report the set."""
        import time as _t
        req = urllib.request.Request(
            self.base + f"/robustirc/v1/{self.session_id}"
                        "/messages?lastseen=0.0",
            headers={"X-Session-Auth": self.auth})
        data = ""
        t0 = _t.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=budget_s,
                                        context=self.ctx) as r:
                while _t.monotonic() - t0 < budget_s:
                    chunk = r.read(4096)
                    if not chunk:
                        break
                    data += chunk.decode()
        except OSError:
            pass  # stream timeout: keep what we have
        docs = []
        dec = json.JSONDecoder()
        i = 0
        while i < len(data):
            while i < len(data) and data[i] in " \r\n\t":
                i += 1
            if i >= len(data):
                break
            try:
                doc, i = dec.raw_decode(data, i)
            except ValueError:
                break  # trailing partial doc at the cut-off
            docs.append(doc)
        return docs


def _is_topic(msg: dict) -> bool:
    parts = (msg.get("Data") or "").split(" ")
    return len(parts) > 1 and parts[1] == "TOPIC"


def _topic_value(msg: dict) -> int:
    return int((msg.get("Data") or "").rsplit(":", 1)[-1])


class SetClient(jclient.Client):
    """Adds = TOPIC changes; the read streams every message and
    collects the topics seen (`robustirc.clj:150-184`)."""

    def __init__(self):
        self.session: Session | None = None
        self.node = None

    def open(self, test, node):
        c = SetClient()
        c.node = node
        fn = test.get("irc-url-fn")
        base = fn(node) if fn else f"https://{node}:{PORT}"
        c.session = Session(base)
        c.session.post(f"NICK {node}-{id(c) % 9973}")
        c.session.post("USER j j j j")
        c.session.post(f"JOIN {CHANNEL}")
        return c

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                self.session.post(f"TOPIC {CHANNEL} :{op['value']}")
                return {**op, "type": "ok"}
            if op["f"] == "read":
                msgs = self.session.messages()
                vals = sorted({_topic_value(m) for m in msgs
                               if _is_topic(m)})
                return {**op, "type": "ok", "value": vals}
            raise ValueError(f"unknown f {op['f']!r}")
        except (OSError, ValueError, KeyError) as e:
            if op["f"] == "read":
                return {**op, "type": "fail", "error": str(e)}
            return {**op, "type": "info", "error": str(e)}


def sets_workload(opts: dict) -> dict:
    from .. import generator as gen
    import itertools

    values = itertools.count()

    def add(test, ctx):
        return {"type": "invoke", "f": "add", "value": next(values)}

    return {
        "client": SetClient(),
        "generator": add,
        "checker": checker.set_checker(),
        "final-generator": gen.each_thread(gen.once(
            {"type": "invoke", "f": "read", "value": None})),
    }


WORKLOADS = {"set": sets_workload}


def robustirc_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "set")
    return std_test(
        opts, name=f"robustirc-{workload_name}", db=db(),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "set") + [
    cli.opt("--certs-dir", default=None,
            help="directory holding cert.pem/key.pem to upload"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": robustirc_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
