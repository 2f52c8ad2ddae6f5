"""Client protocol: applies operations to the database under test
(reference `jepsen/src/jepsen/client.clj:9-27`).

A client's lifecycle: `open(test, node)` returns a connected client bound
to one node; `setup(test)` prepares DB state; `invoke(test, op)` applies
one operation and returns its completion; `teardown(test)`; `close(test)`.
Open/close must not affect the logical state of the test.

Clients whose `reusable(test)` returns True survive process crashes;
otherwise the interpreter closes and reopens them for each fresh process
(`client.clj:29-34`).
"""

from __future__ import annotations

from typing import Any


class Client:
    def open(self, test: dict, node: str) -> "Client":
        """Connect to `node`; returns a client ready for invoke."""
        return self

    def close(self, test: dict) -> None:
        pass

    def setup(self, test: dict) -> None:
        pass

    def invoke(self, test: dict, op: dict) -> dict:
        """Apply op; return the completion op (type ok/fail/info)."""
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass

    def reusable(self, test: dict) -> bool:
        """May this client be reused by a fresh process after a crash?"""
        return False


class Noop(Client):
    """Does nothing, successfully (`client.clj:46-53`)."""

    def invoke(self, test, op):
        out = dict(op)
        out["type"] = "ok"
        return out

    def reusable(self, test):
        return True


noop = Noop()


class InvalidCompletion(Exception):
    def __init__(self, op, op2, problems):
        self.op, self.op2, self.problems = op, op2, problems
        super().__init__(
            "client returned an invalid completion: "
            + "; ".join(problems) + f" — invoke {op!r}, completion {op2!r}")


class Validate(Client):
    """Wraps a client, asserting its completions are well-formed
    (`client.clj:64-109`)."""

    def __init__(self, client: Client):
        self.client = client

    def open(self, test, node):
        res = self.client.open(test, node)
        if not isinstance(res, Client):
            raise TypeError(
                f"expected open to return a Client, got {res!r}")
        return Validate(res)

    def close(self, test):
        self.client.close(test)

    def setup(self, test):
        self.client.setup(test)

    def invoke(self, test, op):
        op2 = self.client.invoke(test, op)
        problems = []
        if not isinstance(op2, dict):
            problems.append("should be a dict")
        else:
            if op2.get("type") not in ("ok", "info", "fail"):
                problems.append(":type should be ok, info, or fail")
            if op2.get("process") != op.get("process"):
                problems.append(":process should be the same")
            if op2.get("f") != op.get("f"):
                problems.append(":f should be the same")
        if problems:
            raise InvalidCompletion(op, op2, problems)
        return op2

    def teardown(self, test):
        self.client.teardown(test)

    def reusable(self, test):
        return self.client.reusable(test)


def validate(client: Client) -> Client:
    return Validate(client)


def is_reusable(client: Any, test: dict) -> bool:
    try:
        return bool(client.reusable(test))
    except Exception:
        return False
