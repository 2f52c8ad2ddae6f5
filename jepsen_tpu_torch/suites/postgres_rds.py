"""Postgres-RDS test suite — a single managed-Postgres endpoint.

Mirrors the reference's postgres-rds suite
(Jepsen's `postgres-rds/src/jepsen/postgres_rds.clj`): there is
no DB automation at all — the system under test is an external managed
instance reached by hostname (`--endpoint`) — and the workload is a
CAS register over one row, read/write/cas in explicit transactions.
Nemeses default to none (you can't partition RDS from here), matching
the reference.

The client reuses the Postgres wire client (`pg_proto.py`)."""

from __future__ import annotations

import logging

from .. import cli, client as jclient, models
from .. import db as jdb
from .. import generator as gen
from ..checker import linear
from . import std_opts, std_test
from .pg_proto import Conn, PGError

log = logging.getLogger(__name__)

PG_PORT = 5432
DEFINITE_ABORT = {"40001", "40P01"}


def _connect(test, node) -> Conn:
    fn = test.get("sql-conn-fn")
    if fn is not None:
        return fn(node)
    host = test.get("endpoint") or node
    return Conn(host, test.get("port", PG_PORT),
                user=test.get("user", "jepsen"),
                database=test.get("database", "jepsen"))


class RegisterClient(jclient.Client):
    """One-row CAS register (`postgres_rds.clj:60-140`)."""

    def __init__(self):
        self.conn: Conn | None = None

    def open(self, test, node):
        c = RegisterClient()
        c.conn = _connect(test, node)
        return c

    def setup(self, test):
        self.conn.query("create table if not exists registers "
                        "(id int primary key, val int)")
        self.conn.query("insert into registers (id, val) values (0, 0) "
                        "on conflict (id) do update set val = val")

    def close(self, test):
        if self.conn is not None:
            self.conn.close()

    def invoke(self, test, op):
        try:
            if op["f"] == "read":
                rows, _ = self.conn.query(
                    "select val from registers where id = 0")
                v = None if not rows or rows[0][0] is None \
                    else int(rows[0][0])
                return {**op, "type": "ok", "value": v}
            self.conn.query("begin")
            try:
                if op["f"] == "write":
                    self.conn.query(f"update registers set "
                                    f"val = {op['value']} where id = 0")
                    self.conn.query("commit")
                    return {**op, "type": "ok"}
                old, new = op["value"]
                rows, _ = self.conn.query(
                    "select val from registers where id = 0")
                cur = None if not rows or rows[0][0] is None \
                    else int(rows[0][0])
                if cur != old:
                    self.conn.query("rollback")
                    return {**op, "type": "fail"}
                self.conn.query(f"update registers set val = {new} "
                                f"where id = 0")
                self.conn.query("commit")
                return {**op, "type": "ok"}
            except Exception:
                try:
                    self.conn.query("rollback")
                except Exception:  # noqa: BLE001 — conn may be dead
                    pass
                raise
        except PGError as e:
            definite = e.code in DEFINITE_ABORT or op["f"] == "read"
            return {**op, "type": "fail" if definite else "info",
                    "error": ["sql", e.code, e.message]}
        except OSError as e:
            return {**op,
                    "type": "fail" if op["f"] == "read" else "info",
                    "error": str(e)}


def register_workload(opts: dict) -> dict:
    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def w(test, ctx):
        return {"type": "invoke", "f": "write",
                "value": gen.rng.randrange(5)}

    def cas(test, ctx):
        return {"type": "invoke", "f": "cas",
                "value": (gen.rng.randrange(5), gen.rng.randrange(5))}

    return {
        "client": RegisterClient(),
        "generator": gen.mix([r, w, cas]),
        "checker": linear.linearizable(models.cas_register(0),
                                       device=opts.get("device")),
    }


WORKLOADS = {"register": register_workload}


def postgres_rds_test(opts: dict) -> dict:
    workload_name = opts.get("workload", "register")
    return std_test(
        opts, name=f"postgres-rds-{workload_name}",
        db=jdb.noop, default_faults=(),
        workload=WORKLOADS[workload_name](opts))


OPT_SPEC = std_opts(cli, WORKLOADS, "register") + [
    cli.opt("--endpoint", help="RDS endpoint hostname"),
    cli.opt("--user", default="jepsen", help="database user"),
    cli.opt("--database", default="jepsen", help="database name"),
]


def main(argv=None):
    cli.run({**cli.single_test_cmd({"test_fn": postgres_rds_test,
                                    "opt_spec": OPT_SPEC}),
             **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
