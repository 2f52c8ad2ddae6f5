"""Checker core: the protocol and the validity value for 'unknown'.

Counterpart of `jepsen_tpu/checker/__init__.py`, cut to what the
linearizability checker needs. A checker is any object with
``check(test, history, opts) -> result-dict``; results carry a
``'valid?'`` key which is True, False, or the string ``'unknown'``.
"""

from __future__ import annotations

from typing import Mapping

from ..history import History

UNKNOWN = "unknown"


class Checker:
    """Protocol base. Subclasses implement check()."""

    def check(self, test: Mapping, hist: History, opts: Mapping) -> dict:
        raise NotImplementedError

    def __call__(self, test, hist, opts=None):
        return self.check(test, hist, opts or {})
