"""Helpers for interactive analysis sessions.

Reference: `jepsen/src/jepsen/repl.clj` — load the most recent run for
post-hoc re-checking (:6-9)."""

from __future__ import annotations

from . import store


def latest_test(base: str = store.DEFAULT_BASE) -> dict | None:
    """The most recently-run test, loaded from the store with its
    history and results."""
    d = store.latest(base)
    return store.load_test(d) if d else None


def recheck(test: dict, checker=None) -> dict:
    """Re-run analysis on a stored test — the post-hoc resume path. Use
    a different checker to ask new questions of an old history."""
    from . import core
    if checker is not None:
        test = {**test, "checker": checker}
    return core.analyze(test)
