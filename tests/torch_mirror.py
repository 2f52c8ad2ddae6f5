"""Run a JAX-package test module's cases against the port.

`cases(name)` reads ``tests/<name>.py``, points every ``jepsen_tpu``
import at ``jepsen_tpu_torch``, executes the result as a module of its
own and returns its names. A ``test_torch_*.py`` file puts them into its
globals, so pytest collects every case of the JAX module a second time,
now on the port, under the same names and with the same parameters and
assertions. For a module whose tail tests what the port has not ported
yet, ``cut`` ends the source at its first occurrence and ``drop`` names
the imports of that code to remove. Where such an import is a statement
of its own (or names nothing else the kept cases need),
``drop_statements`` removes each top-level statement whose source,
decorators included, matches one of its patterns. `on_cpu` makes a
builder of the port's fill in ``device="cpu"`` where its options name
no device.
"""

import ast
import re
import types
from pathlib import Path

_TESTS = Path(__file__).resolve().parent
_JAX_PACKAGE = re.compile(r"\bjepsen_tpu\b(?!_torch)")


def cases(name: str, cut: str | None = None, drop: tuple = (),
          drop_statements: tuple = ()) -> dict:
    src = (_TESTS / f"{name}.py").read_text()
    if cut is not None:
        src = src[:src.index(cut)]
    if drop_statements:
        lines = src.splitlines(keepends=True)
        for node in reversed(ast.parse(src).body):
            start = min([node.lineno] + [d.lineno for d in getattr(
                node, "decorator_list", ())])
            text = "".join(lines[start - 1:node.end_lineno])
            if any(re.search(pat, text) for pat in drop_statements):
                del lines[start - 1:node.end_lineno]
        src = "".join(lines)
    for imported in drop:
        src, n = re.subn(rf",\s*{imported}\b", "", src)
        assert n == 1, f"{name}.py imports {imported} {n} times"
    src = _JAX_PACKAGE.sub("jepsen_tpu_torch", src)
    mod = types.ModuleType(f"torch_mirror.{name}")
    mod.__file__ = str(_TESTS / f"{name}.py")
    exec(compile(src, f"{name}.py (on the port)", "exec"), mod.__dict__)
    return {k: v for k, v in vars(mod).items() if not k.startswith("__")}


def on_cpu(monkeypatch, module, name: str) -> None:
    """Patch `module.name`, a builder taking one options dict, to fill in
    ``device="cpu"`` when the options name no device: the port's checkers
    ask for CUDA otherwise."""
    build = getattr(module, name)

    def built_on_cpu(opts):
        if opts.get("device") is None:
            opts = {**opts, "device": "cpu"}
        return build(opts)

    monkeypatch.setattr(module, name, built_on_cpu)
