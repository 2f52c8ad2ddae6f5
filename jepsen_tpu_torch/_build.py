"""Build the port's CUDA sources and load them with ctypes.

Each source under `csrc/` compiles with nvcc, on its own, into a shared
library with a plain C interface under `build/` at the repository root
(git-ignored), at first use: ``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared -Xcompiler -fPIC``. A library newer than its source is
reused. `build()` starts one nvcc per source, all at once, and waits for
them all; `library(name)` builds what it needs and loads it.

Nothing here falls back: a missing nvcc or a failed compile raises
`KernelCompileError`, which the recovery ladder never retries.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

from ._platform import KernelCompileError

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG.parent / "build"
GENCODE = "arch=compute_90a,code=sm_90a"


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME, else under the
    toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for c in (shutil.which("nvcc"),
              home and os.path.join(home, "bin", "nvcc"),
              "/usr/local/cuda/bin/nvcc"):
        if c and os.path.exists(c):
            return c
    raise KernelCompileError("nvcc not found (PATH, CUDA_HOME): the port's "
                       "CUDA kernels cannot be built")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def command(name: str, out: Path, compiler: str = "nvcc") -> list[str]:
    """The nvcc command line for one source; -Xptxas -v reports each
    kernel's registers, shared memory and spills into the build log."""
    return [compiler, "-gencode", GENCODE, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _fresh(name: str) -> bool:
    lib = lib_path(name)
    return lib.exists() and \
        lib.stat().st_mtime >= (CSRC / f"{name}.cu").stat().st_mtime


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (all of csrc/ by default) that lack a
    fresh library, one nvcc each, started together. Returns each
    compiled source's compiler log (also kept as build/<name>.log);
    raises if any compile fails."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not _fresh(n)]
    if not todo:
        return {}
    BUILD.mkdir(exist_ok=True)
    cc = nvcc()
    procs = {}
    try:
        for n in todo:
            tmp = BUILD / f"lib{n}.so.{os.getpid()}.tmp"
            procs[n] = (tmp, subprocess.Popen(
                command(n, tmp, cc), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs, failed = {}, []
        for n, (tmp, p) in procs.items():
            logs[n] = p.communicate()[0]
            (BUILD / f"{n}.log").write_text(logs[n])
            if p.returncode != 0:
                failed.append(n)
            else:
                os.replace(tmp, lib_path(n))
    finally:
        for _tmp, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise KernelCompileError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    build([name])
    return ctypes.CDLL(str(lib_path(name)))
