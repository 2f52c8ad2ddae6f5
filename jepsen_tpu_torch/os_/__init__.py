"""OS protocol: operating-system setup/teardown on DB nodes.

Reference: `jepsen/src/jepsen/os.clj:4-8` — the two-method `OS` protocol
plus a noop. Concrete impls (debian/centos/ubuntu) live in sibling
modules.
"""

from __future__ import annotations


class OS:
    def setup(self, test: dict, node: str) -> None:
        """Set up the operating system on this node."""

    def teardown(self, test: dict, node: str) -> None:
        """Tear down the operating system on this node."""


class Noop(OS):
    pass


noop = Noop()
