"""K3: the dense engine's step walk, hand-written for Hopper.

Replaces the JAX package's on-device walk `jepsen_tpu/checker/wgl.py:1150`
(`_dense_kernel_cached.run_range`: a `lax.while_loop` under `jax.jit`
whose closure fixpoint is a second `while_loop` around the Pallas round,
`:1077-1095`) and its `jax.vmap` (`check_chunk_batch`, `:1220`). On the
TPU the whole walk is one device program with no host read per step; the
eager walk (`wgl.DenseKernel.run_range_eager` / `run_range_batch_eager`)
reads the host at every closure round and every completion-only step,
and launches 49-57 small kernels a step. K3 walks a window of up to
`WINDOW` steps of every key in one launch, closure rounds included, and
writes the whole carry back in the same layout and dtypes, so
`summarize`, the carry digest, checkpoints and `carry_to_numpy` see no
difference.

The dense engine's walk (`wgl.DenseKernel.run_range` and
`run_range_batch`) launches K3 window after window on CUDA tensors and
runs the eager walk, K3's plain version, on CPU tensors. The kernel holds
the six device models (`csrc/sort_models.cuh`, shared with K3-sort) and
computes each invoke's next-state row itself; `transition_rows` is the
same row in torch, held against the kernel's in the CPU tests. A window
costs the host one copy of the window ends, one zeroed buffer, the launch
and one watchdog-guarded fetch of that buffer, which the kernel fills
with each key's e and count, the pair rounds and the rounds of each
window step. Between launches the walk polls the engine's cancel hook
(the competition race's loser stops there). The rounds K3 reports are
the eager walk's, counted the same way (`csrc/dense_walk.cu`, "Round
counts"), and go to the engine's `rounds` and to `ROUNDS` here
(`count_rounds`).

What bounds it on an H100: latency. A step is a chain of dependent
passes over the bit-packed table (completion, each Jacobi round, each
also counting), joined by barriers. The tiers (`TIERS`) keep the chain's
links short: a warp a key for tables of up to `WARP_MAX_WORDS` words, a
word a lane (lanes meet at warp barriers), a block a key for pairs that
fit shared memory, and a thread-block cluster of up to 8 blocks for
larger ones. Design: `csrc/dense_walk.cu`.

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
from .wgl_sortwalk import MODELS

LAUNCHES = 0    # K3 launches by `launch`, and nothing else
ROUNDS = 0      # the closure rounds those launches ran, as the walk counts
# the (source state, slot) pairs listed for each of those rounds, summed
# over every key's own rounds: a round ORs one half row per pair
PAIR_ROUNDS = 0
# where a launch's keys walk (csrc/dense_walk.cu, "Tiers"), and the
# launches on each
TIERS = ("warp", "block", "cluster")
TIER_LAUNCHES = dict.fromkeys(TIERS, 0)
# stream workers walk from several threads: `+=` on a global is not
# atomic, so the counts move under this lock
_LAUNCH_LOCK = threading.Lock()

SOURCE = "jepsen_tpu_torch/csrc/dense_walk.cu"
REPLACES = "jepsen_tpu/checker/wgl.py:1150"

WINDOW = 1024         # steps one launch walks at most, for every key
MAX_STATES = 512      # the dense engine's state cap
MAX_CELLS = 1 << 22   # S * 2^P, the dense engine's table cap
MAX_SLOTS = 30
ROW = 5               # a dense step row: [rm, slot, f, a, b]
# the largest table (S x max(2^P / 32, 1) words) a warp walks, a word a
# lane: larger ones walk on a block, or on a cluster where the pair
# outgrows a block. Where the warp stopped beating a block on an H100
# (`tools/k3_compare.py --threshold`, PERF.md)
WARP_MAX_WORDS = 32


def transition_rows(step, s_lo: int, S: int, f: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The next-state rows of ops (f, a, b) of any shape (...): an int16
    (..., S) tensor whose [..., s] is new - s_lo where linearizing the op
    in state s_lo + s is legal and lands in [s_lo, s_lo + S), else -1.
    This is the eager walk's transposed transitions (mft[p, q, s] =
    occ[p] & (rows[p, s] == q)), and the row the kernel computes for each
    invoke."""
    s_vals = torch.arange(s_lo, s_lo + S, dtype=torch.int32,
                          device=f.device)
    legal, new = step(s_vals, f[..., None], a[..., None], b[..., None])
    shape = (*f.shape, S)
    idx = new.expand(shape).to(torch.int64) - s_lo
    ok = legal.expand(shape) & (idx >= 0) & (idx < S)
    return torch.where(ok, idx, -1).to(torch.int16)


@functools.cache
def _kernel():
    lib = _build.library("dense_walk")
    fn = lib.jt_dense_walk
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(i)
    fn.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                   i, ip, p]
    fn.restype = ctypes.c_int
    plan = lib.jt_dense_walk_plan
    plan.argtypes = [i, i, i, i, ip, ip, ip, ctypes.POINTER(ctypes.c_longlong)]
    plan.restype = ctypes.c_int
    err = lib.jt_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, plan, err


def _check(x, wend, sc, table, slots, occ) -> tuple:
    """(B, S, P, T) of a launch's tensors; raises on what the kernel does
    not take."""
    dev = table.device
    ts = (x, wend, sc, table, slots, occ)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"dense_walk takes every tensor on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if table.dim() != 3 or table.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"table must be bool/uint8 (B, S, C), got "
                         f"{table.dtype} {tuple(table.shape)}")
    B, S, C = table.shape
    P = C.bit_length() - 1
    T = x.shape[1] if x.dim() == 3 else 0
    want = {"x": (x, torch.int32, (B, T, ROW)),
            "wend": (wend, torch.int32, (B,)),
            "sc": (sc, torch.int32, (4, B)),
            "slots": (slots, torch.int32, (3, B, P)),
            "occ": (occ, torch.bool, (B, P))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if C != 1 << P or P > MAX_SLOTS or not 1 <= S <= MAX_STATES \
            or S * C > MAX_CELLS or T < 1 or B > 1 << 30:
        raise ValueError(f"shape B={B}, S={S}, C={C}, T={T} outside the "
                         f"kernel's domain (C = 2^P, P <= {MAX_SLOTS}, "
                         f"S <= {MAX_STATES}, S * C <= {MAX_CELLS})")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("dense_walk takes contiguous tensors")
    if P >= 5 and table.data_ptr() % 16:
        raise ValueError("dense_walk takes a 16-byte aligned table")
    return B, S, P, T


def tier(B: int, S: int, P: int) -> str:
    """Where B keys at (S, P) walk on the current device (`TIERS`);
    raises on a shape the kernel refuses."""
    _fn, plan, err = _kernel()
    where, cluster, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_longlong()
    code = plan(B, S, P, WARP_MAX_WORDS, ctypes.byref(where),
                ctypes.byref(cluster), ctypes.byref(threads),
                ctypes.byref(smem))
    if code != 0:
        raise KernelLaunchError(f"dense_walk refused B={B}, S={S}, P={P}: "
                                f"CUDA error {code} ({err(code).decode()})")
    return TIERS[where.value]


def launch(x: torch.Tensor, wend: torch.Tensor, sc: torch.Tensor,
           table: torch.Tensor, slots: torch.Tensor, occ: torch.Tensor, *,
           model: str, s_lo: int, attest: bool, steps: int) -> tuple:
    """One K3 launch: walk each key b's steps [sc[0, b], wend[b]) of x
    (int32 (B, T, 5)) while its table is nonempty, under the device model
    `model` over states [s_lo, s_lo + S). sc: int32 (4, B) = (e, att,
    count, max_count); table: bool (B, S, 2^P); slots: int32 (3, B, P) =
    (f, a, b); occ: bool (B, P); `steps` >= the longest window. Returns new
    (sc, table, slots, occ) and an int64 (2B + 1 + steps,) tensor: each
    key's e, each key's count, the sum over every key's rounds of the
    source pairs listed for the round, and the rounds of each window step
    (the max over the keys invoking at it). Launches on the current stream
    and does not synchronise."""
    global LAUNCHES
    B, S, P, T = _check(x, wend, sc, table, slots, occ)
    if model not in MODELS:
        raise ValueError(f"no K3 model {model!r}")
    fn, _plan, err = _kernel()
    dev = table.device
    where = ctypes.c_int()
    with torch.cuda.device(dev):
        outs = (torch.empty_like(sc), torch.empty_like(table),
                torch.empty_like(slots), torch.empty_like(occ))
        out = torch.zeros(2 * B + 1 + steps, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), T, wend.data_ptr(), steps, sc.data_ptr(),
                  table.data_ptr(), slots.data_ptr(), occ.data_ptr(),
                  *(t.data_ptr() for t in outs), out.data_ptr(), B, S, P,
                  MODELS.index(model), int(s_lo), int(bool(attest)),
                  WARP_MAX_WORDS, ctypes.byref(where), stream)
    if code != 0:
        raise KernelLaunchError(f"dense_walk launch failed: CUDA error "
                                f"{code} ({err(code).decode()})")
    with _LAUNCH_LOCK:
        LAUNCHES += 1
        TIER_LAUNCHES[TIERS[where.value]] += 1
    return (*outs, out)


def count_rounds(rounds: int, pairs: int) -> None:
    """Add the closure rounds and pair rounds that launches reported, as
    the walk reads them, to `ROUNDS` and `PAIR_ROUNDS`."""
    global ROUNDS, PAIR_ROUNDS
    with _LAUNCH_LOCK:
        ROUNDS += rounds
        PAIR_ROUNDS += pairs
