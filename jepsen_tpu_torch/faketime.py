"""libfaketime wrappers: make a DB's clocks run at skewed *rates*.

Reference: `jepsen/src/jepsen/faketime.clj` — installs the jepsen fork of
libfaketime 0.9.6 (patched for CLOCK_*_COARSE) by building from source on
the node (:8-22), replaces DB executables with a `faketime -m -f` wrapper
script moving the original to `x.no-faketime` (:36-47 wrap!), and picks
random rate factors distributed around 1 (:57-65 rand-factor).
"""

from __future__ import annotations

import random

from . import control as c
from .control import util as cu

REPO = "https://github.com/jepsen-io/libfaketime.git"
TAG = "0.9.6-jepsen1"


def install() -> None:
    """Clone + make install the jepsen libfaketime fork on the node
    (`faketime.clj:8-22`)."""
    with c.su():
        c.exec_("mkdir", "-p", "/tmp/jepsen")
        with c.cd("/tmp/jepsen"):
            if not cu.exists("libfaketime-jepsen"):
                c.exec_("git", "clone", REPO, "libfaketime-jepsen")
            with c.cd("libfaketime-jepsen"):
                c.exec_("git", "checkout", TAG)
                c.exec_("make")
                c.exec_("make", "install")


def script(cmd: str, init_offset: float, rate: float) -> str:
    """A sh script invoking cmd under faketime with an initial offset
    (seconds) and clock rate (`faketime.clj:24-34`)."""
    off = int(init_offset)
    sign = "-" if off < 0 else "+"
    return ("#!/bin/bash\n"
            f'faketime -m -f "{sign}{abs(off)}s x{float(rate)}" '
            f'{c.expand_path(cmd)} "$@"\n')


def wrap(cmd: str, init_offset: float, rate: float) -> None:
    """Replace an executable with a faketime wrapper, moving the original
    to cmd.no-faketime; idempotent (`faketime.clj:36-47`)."""
    orig = cmd + ".no-faketime"
    wrapper = script(orig, init_offset, rate)
    if not cu.exists(orig):
        c.exec_("mv", cmd, orig)
    cu.write_file(wrapper, cmd)
    c.exec_("chmod", "a+x", cmd)


def unwrap(cmd: str) -> None:
    """Remove a wrapper, restoring the original binary
    (`faketime.clj:49-55`)."""
    orig = cmd + ".no-faketime"
    if cu.exists(orig):
        c.exec_("mv", orig, cmd)


def rand_factor(factor: float, rng: random.Random | None = None) -> float:
    """A random rate near 1 with max = factor * min, so the fastest clock
    is at most `factor`× the slowest (`faketime.clj:57-65`)."""
    r = rng or random
    hi = 2.0 / (1.0 + 1.0 / factor)
    lo = hi / factor
    return lo + r.random() * (hi - lo)
