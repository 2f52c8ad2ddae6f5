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
runs the eager walk, K3's plain version, on CPU tensors. Before each
launch it evaluates the model's own torch `step` once on the device, over
the window's steps and over the carry's slots, into next-state rows
(`transition_rows`): the kernel holds no model. Between launches it polls
the engine's cancel hook (the competition race's loser stops there) and
reads (e, count, rounds) in one watchdog-guarded fetch. The rounds K3
reports are the eager walk's, counted the same way (`csrc/dense_walk.cu`,
"Round counts"), and go to the engine's `rounds` and to `ROUNDS` here
(`count_rounds`).

What bounds it on an H100: latency. A step is a chain of dependent
passes over the table (completion, each Jacobi round, the count and
attestation), joined by block barriers, or grid barriers where one key's
table pair does not fit shared memory. Design and paths:
`csrc/dense_walk.cu`.

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

LAUNCHES = 0    # K3 launches by `launch`, and nothing else
ROUNDS = 0      # the closure rounds those launches ran, as the walk counts
# the (source state, slot) pairs listed for each of those rounds, summed
# over every key's own rounds: a round ORs one half row per pair
PAIR_ROUNDS = 0
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


def transition_rows(step, s_lo: int, S: int, f: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The next-state rows of ops (f, a, b) of any shape (...): an int16
    (..., S) tensor whose [..., s] is new - s_lo where linearizing the op
    in state s_lo + s is legal and lands in [s_lo, s_lo + S), else -1.
    This is the eager walk's transposed transitions: mft[p, q, s] =
    occ[p] & (rows[p, s] == q)."""
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
    fn.argtypes = [p, i, p, p, i, p, p, p, p, p, p, p, p, p, p, p, p, p,
                   i, i, i, i, p]
    fn.restype = ctypes.c_int
    err = lib.jt_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _check(x, wend, itr, str0, sc, table, slots, occ) -> tuple:
    dev = table.device
    ts = (x, wend, itr, str0, sc, table, slots, occ)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"dense_walk takes every tensor on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if table.dim() != 3 or table.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"table must be bool/uint8 (B, S, C), got "
                         f"{table.dtype} {tuple(table.shape)}")
    B, S, C = table.shape
    P = C.bit_length() - 1
    W = itr.shape[1] if itr.dim() == 3 else 0
    want = {"x": (x, torch.int32, (B, x.shape[1] if x.dim() == 3 else 0,
                                   ROW)),
            "wend": (wend, torch.int32, (B,)),
            "itr": (itr, torch.int16, (B, W, S)),
            "str0": (str0, torch.int16, (B, P, S)),
            "sc": (sc, torch.int32, (4, B)),
            "slots": (slots, torch.int32, (3, B, P)),
            "occ": (occ, torch.bool, (B, P))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if C != 1 << P or P > MAX_SLOTS or not 1 <= S <= MAX_STATES \
            or S * C > MAX_CELLS or W < 1 or x.shape[1] < 1 \
            or B > 1 << 30:
        raise ValueError(f"shape B={B}, S={S}, C={C}, W={W} outside the "
                         f"kernel's domain (C = 2^P, P <= {MAX_SLOTS}, "
                         f"S <= {MAX_STATES}, S * C <= {MAX_CELLS})")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("dense_walk takes contiguous tensors")
    if P >= 4 and table.data_ptr() % 16:
        raise ValueError("dense_walk takes a 16-byte aligned table")
    return B, S, P, W


def launch(x: torch.Tensor, wend: torch.Tensor, itr: torch.Tensor,
           str0: torch.Tensor, sc: torch.Tensor, table: torch.Tensor,
           slots: torch.Tensor, occ: torch.Tensor,
           attest: bool) -> tuple:
    """One K3 launch: walk each key b's steps [sc[0, b], wend[b]) of x
    (int32 (B, T, 5)) while its table is nonempty. itr: int16 (B, W, S),
    the next-state rows of each key's steps from sc[0, b] on (W >= the
    longest window); str0: int16 (B, P, S), those of the carry's slots;
    sc: int32 (4, B) = (e, att, count, max_count); table: bool (B, S,
    2^P); slots: int32 (3, B, P) = (f, a, b); occ: bool (B, P). Returns
    new (sc, table, slots, occ), the int32 (W,) rounds of each window
    step, the max over the keys invoking at it, and an int64 (1,) sum
    over every key's rounds of the source pairs listed for the round.
    Launches on the current stream and does not synchronise."""
    global LAUNCHES
    B, S, P, W = _check(x, wend, itr, str0, sc, table, slots, occ)
    fn, err = _kernel()
    sc_out = torch.empty_like(sc)
    tb_out = torch.empty_like(table)
    slots_out = torch.empty_like(slots)
    occ_out = torch.empty_like(occ)
    scratch = torch.empty_like(table)
    rounds = torch.zeros(W, dtype=torch.int32, device=table.device)
    red = torch.zeros(3, dtype=torch.int64, device=table.device)
    pairs = torch.zeros(1, dtype=torch.int64, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        code = fn(x.data_ptr(), x.shape[1], wend.data_ptr(), itr.data_ptr(),
                  W, str0.data_ptr(), sc.data_ptr(), table.data_ptr(),
                  slots.data_ptr(), occ.data_ptr(), sc_out.data_ptr(),
                  tb_out.data_ptr(), slots_out.data_ptr(),
                  occ_out.data_ptr(), scratch.data_ptr(), rounds.data_ptr(),
                  red.data_ptr(), pairs.data_ptr(), B, S, P,
                  int(bool(attest)), stream)
    if code != 0:
        raise KernelLaunchError(f"dense_walk launch failed: CUDA error "
                                f"{code} ({err(code).decode()})")
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return sc_out, tb_out, slots_out, occ_out, rounds, pairs


def count_rounds(rounds: int, pairs: int) -> None:
    """Add the closure rounds and pair rounds that launches reported, as
    the walk reads them, to `ROUNDS` and `PAIR_ROUNDS`."""
    global ROUNDS, PAIR_ROUNDS
    with _LAUNCH_LOCK:
        ROUNDS += rounds
        PAIR_ROUNDS += pairs

