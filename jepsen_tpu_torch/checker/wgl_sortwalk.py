"""K3-sort: the sort engine's step walk, hand-written for Hopper.

Replaces the JAX package's on-device walk `jepsen_tpu/checker/wgl.py:864`
(`_kernel_cached.run_range`: a `lax.while_loop` under `jax.jit` whose
stage B is a second `while_loop`, `expand_full` at `:787`, around the
frontier dedup: the Pallas hash kernel `wgl_dedup.dedup_fn` through
`dedup_hash` at `:718`, or the stable sorts at `:702` and `:755`) and its
`jax.vmap` (`check_chunk_batch`, `:958`). On the TPU the whole walk is one
device program; the eager walk (`wgl.SortKernel.run_range_eager` /
`run_range_batch_eager`) reads the host at every stage-B round and every
completion-only step, and launches 165-255 small kernels a step. K3-sort
walks a window of steps of every key in one launch, stage A, stage B's
rounds and the dedup inline on all three routes (hash, packed sort,
lexicographic sort), and writes the whole carry back in the JAX layout and
dtypes, so `summarize`, the carry digest, checkpoints and `carry_to_numpy`
see no difference.

The sort engine's walk (`wgl.SortKernel.run_range` and `run_range_batch`)
launches K3-sort window after window on CUDA tensors and runs the eager
walk, K3-sort's plain version, on CPU tensors. A launch walks at most
`window(F, P)` steps of each key: fewer as a dedup's F (1 + P) rows grow,
so that one launch stays short beside the watchdog's deadline and within
a budgeted walk's 1,024-step chunks. Between launches the walk polls the
engine's cancel hook and reads (e, count, rounds, invokes, work) in one
watchdog-guarded fetch. The stage-B rounds and hash dedups K3-sort reports
are the eager walk's, counted the same way (`csrc/sort_walk.cu`,
"Counts"), and go to the engine's `rounds` and `dedups` and to `ROUNDS`
and `DEDUPS` here (`count`).

What bounds it on an H100: latency. A step is a chain of dependent
team-wide phases (completion, each dedup's row build, then the hash
route's insert and rank or the sort routes' selection of the first F
rows, their compaction, radix passes over those F rows and extraction,
then the count) on one SM per key, or, for one key too large for shared
memory (the escalations' F = 1,024-65,536), on one cooperative grid of a
block per SM joined by grid barriers. Each launch reports where its time
went, phase by phase, on each key's lead thread (`PHASES`, `PHASE_NS`).
Design: `csrc/sort_walk.cu`, with the six models in
`csrc/sort_models.cuh` and K2's insert and rank in `csrc/dedup.cuh`.

On a CUDA tensor the walk launches the kernel or raises: nothing falls
back to the eager walk.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import _build
from .._platform import KernelLaunchError
from .wgl_dedup import table_size

LAUNCHES = 0    # K3-sort launches by `launch`, and nothing else
ROUNDS = 0      # the stage-B rounds those launches ran, as the walk counts
DEDUPS = 0      # the hash-route dedups they ran, as the walk counts them
ROWS = 0        # the rows of every dedup of every key
PASS_ROWS = 0   # rows the sort routes' selection histograms, ranking and
#                 radix passes read (csrc/sort_walk.cu, "Counts")
SORTS = 0       # the dedups those launches ran, on every route
STEPS = 0       # the steps they walked, summed over the keys
# where the launches' time went: each phase's nanoseconds on the lead
# thread of each key (csrc/sort_walk.cu, `Phase`), summed over the keys;
# a launch's phases sum to its lead's time in the kernel
PHASES = ("carry", "completion", "rows", "gather", "select", "count",
          "wait", "scatter", "extract", "insert", "rank", "step")
PHASE_NS = dict.fromkeys(PHASES, 0)
WORK = 4 + len(PHASES)   # a launch's work counts: rows, pass rows, dedups,
#                          steps, then the phases
# stream workers walk from several threads: `+=` on a global is not
# atomic, so the counts move under this lock
_LAUNCH_LOCK = threading.Lock()

SOURCE = "jepsen_tpu_torch/csrc/sort_walk.cu"
REPLACES = "jepsen_tpu/checker/wgl.py:864"

# the kernel's model ids (csrc/sort_models.cuh) and dedup routes
MODELS = ("register", "cas-register", "mutex", "counter", "g-set",
          "unordered-queue")
ROUTES = ("hash", "packed", "lex")
# where a launch's keys walk (csrc/sort_walk.cu, "Layout"): one block a key
# in shared memory or in a device scratch, or one key over the whole grid
PATHS = ("shared", "global", "grid")
MAX_SLOTS = 256
WINDOW = 1024          # steps one launch walks at most
WINDOW_ROWS = 1 << 24  # dedup rows a launch's window is sized by


def window(F: int, P: int) -> int:
    """Steps a launch walks at most at frontier F over P slots: WINDOW,
    fewer once a stage-B dedup's F (1 + P) rows times the steps pass
    WINDOW_ROWS."""
    return max(1, min(WINDOW, WINDOW_ROWS // (F * (1 + P))))


@functools.cache
def _kernel():
    lib = _build.library("sort_walk")
    fn = lib.jt_sort_walk
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, p, p, p, p, p, ll,
                   p, p, p, i, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    plan = lib.jt_sort_walk_plan
    plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ll), ctypes.POINTER(i)]
    plan.restype = ctypes.c_int
    if lib.jt_sort_walk_phases() != len(PHASES):
        raise KernelLaunchError(f"sort_walk times {lib.jt_sort_walk_phases()}"
                                f" phases, the wrapper names {len(PHASES)}")
    err = lib.jt_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, plan, err


def _check(x, wend, sc, masks, states, valid, slots, occ) -> tuple:
    """(B, T, F, P, W) of a launch's tensors; raises on what the kernel
    does not take."""
    dev = masks.device
    ts = (x, wend, sc, masks, states, valid, slots, occ)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"sort_walk takes every tensor on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if masks.dim() != 3 or masks.dtype != torch.int32:
        raise ValueError(f"masks must be int32 (B, F, W), got "
                         f"{masks.dtype} {tuple(masks.shape)}")
    B, F, W = masks.shape
    P = slots.shape[2] if slots.dim() == 3 else 0
    T = x.shape[1] if x.dim() == 3 else 0
    want = {"x": (x, torch.int32, (B, T, W + 4)),
            "wend": (wend, torch.int32, (B,)),
            "sc": (sc, torch.int32, (5, B)),
            "states": (states, torch.int32, (B, F)),
            "valid": (valid, torch.bool, (B, F)),
            "slots": (slots, torch.int32, (3, B, P)),
            "occ": (occ, torch.bool, (B, P))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not 1 <= P <= MAX_SLOTS or W != (P + 31) // 32 or F < 1 or T < 1:
        raise ValueError(f"shape B={B}, F={F}, P={P}, W={W}, T={T} outside "
                         f"the kernel's domain (1 <= P <= {MAX_SLOTS}, "
                         f"W = ceil(P / 32))")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("sort_walk takes contiguous tensors")
    return B, T, F, P, W


def launch(x: torch.Tensor, wend: torch.Tensor, sc: torch.Tensor,
           masks: torch.Tensor, states: torch.Tensor, valid: torch.Tensor,
           slots: torch.Tensor, occ: torch.Tensor, *, model: str,
           route: str, s_lo: int, sb_bits: int, attest: bool,
           steps: int) -> tuple:
    """One K3-sort launch: walk each key b's steps [sc[0, b], wend[b]) of
    x (int32 (B, T, W + 4)) while its frontier is nonempty. sc: int32
    (5, B) = (e, att, count, max_count, overflow); masks int32 (B, F, W),
    states int32 (B, F), valid bool (B, F); slots int32 (3, B, P) =
    (f, a, b); occ bool (B, P); `steps` >= the longest window. Returns new
    (sc, masks, states, valid, slots, occ), the int32 (steps,) rounds of
    each window step (the max over the keys invoking at it), its int32
    (steps,) invoke flags (1 where a key invoked) and an int64 (WORK,) of
    the rows deduped, the rows the sort routes' histograms, ranking and
    radix passes read, the dedups, the steps walked and each phase's
    nanoseconds (`PHASES`). Launches on the
    current stream and does not synchronise."""
    global LAUNCHES
    B, T, F, P, _W = _check(x, wend, sc, masks, states, valid, slots, occ)
    if model not in MODELS or route not in ROUTES:
        raise ValueError(f"no K3-sort model {model!r} or route {route!r}")
    fn, _plan, err = _kernel()
    m_id, r_id = MODELS.index(model), ROUTES.index(route)
    H = table_size(F * (1 + P))
    dev = masks.device
    with torch.cuda.device(dev):
        nbytes, where = _planned(B, F, P, route)
        stride = 0 if where == "shared" else (nbytes + 255) // 256 * 256
        # a failed allocation raises torch.OutOfMemoryError, which the
        # batch ladder's split handles
        scratch = (torch.empty(B * stride, dtype=torch.uint8, device=dev)
                   if stride else None)
        outs = (torch.empty_like(sc), torch.empty_like(masks),
                torch.empty_like(states), torch.empty_like(valid),
                torch.empty_like(slots), torch.empty_like(occ))
        counts = torch.zeros(2 * steps + 2 * WORK, dtype=torch.int32,
                             device=dev)
        rounds, inv = counts[:steps], counts[steps:2 * steps]
        work = counts[2 * steps:].view(torch.int64)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), T, wend.data_ptr(), steps, sc.data_ptr(),
                  masks.data_ptr(), states.data_ptr(), valid.data_ptr(),
                  slots.data_ptr(), occ.data_ptr(),
                  *(t.data_ptr() for t in outs),
                  0 if scratch is None else scratch.data_ptr(), stride,
                  rounds.data_ptr(), inv.data_ptr(), work.data_ptr(), B, F,
                  P, m_id, r_id, int(s_lo), int(min(sb_bits, 32)), H,
                  int(bool(attest)), stream)
    if code != 0:
        raise KernelLaunchError(f"sort_walk launch failed: CUDA error "
                                f"{code} ({err(code).decode()})")
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return (*outs, rounds, inv, work)


def count(rounds: int, dedups: int, work) -> None:
    """Add what launches reported, as the walk reads it, to the counts:
    the stage-B rounds and hash dedups as the walk counts them, and the
    launches' WORK counts."""
    global ROUNDS, DEDUPS, ROWS, PASS_ROWS, SORTS, STEPS
    rows, pass_rows, sorts, steps, *ns = (int(v) for v in work)
    with _LAUNCH_LOCK:
        ROUNDS += rounds
        DEDUPS += dedups
        ROWS += rows
        PASS_ROWS += pass_rows
        SORTS += sorts
        STEPS += steps
        for name, v in zip(PHASES, ns):
            PHASE_NS[name] += v


def _planned(B: int, F: int, P: int, route: str) -> tuple[int, str]:
    """(scratch bytes a key, path) of B keys at (F, P, route) on the
    current device; raises on a shape the kernel refuses."""
    _fn, plan, err = _kernel()
    nbytes, where = ctypes.c_longlong(), ctypes.c_int()
    code = plan(B, F, P, ROUTES.index(route), table_size(F * (1 + P)),
                ctypes.byref(nbytes), ctypes.byref(where))
    if code != 0:
        raise KernelLaunchError(f"sort_walk refused F={F}, P={P}, route "
                                f"{route}: CUDA error {code} "
                                f"({err(code).decode()})")
    return nbytes.value, PATHS[where.value]


def path(B: int, F: int, P: int, route: str) -> str:
    """Where B keys at (F, P, route) walk on the current device (`PATHS`)."""
    return _planned(B, F, P, route)[1]
