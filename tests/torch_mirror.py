"""Run a JAX-package test module's cases against the port.

`cases(name)` reads ``tests/<name>.py``, points every ``jepsen_tpu``
import at ``jepsen_tpu_torch``, executes the result as a module of its
own and returns its names. A ``test_torch_*.py`` file puts them into its
globals, so pytest collects every case of the JAX module a second time,
now on the port, under the same names and with the same parameters and
assertions. For a module whose tail tests what the port has not ported
yet, ``cut`` ends the source at its first occurrence and ``drop`` names
the imports of that code to remove.
"""

import re
import types
from pathlib import Path

_TESTS = Path(__file__).resolve().parent
_JAX_PACKAGE = re.compile(r"\bjepsen_tpu\b(?!_torch)")


def cases(name: str, cut: str | None = None, drop: tuple = ()) -> dict:
    src = (_TESTS / f"{name}.py").read_text()
    if cut is not None:
        src = src[:src.index(cut)]
    for imported in drop:
        src, n = re.subn(rf",\s*{imported}\b", "", src)
        assert n == 1, f"{name}.py imports {imported} {n} times"
    src = _JAX_PACKAGE.sub("jepsen_tpu_torch", src)
    mod = types.ModuleType(f"torch_mirror.{name}")
    mod.__file__ = str(_TESTS / f"{name}.py")
    exec(compile(src, f"{name}.py (on the port)", "exec"), mod.__dict__)
    return {k: v for k, v in vars(mod).items() if not k.startswith("__")}
