"""K1: the dense engine's closure round, hand-written for Hopper.

Replaces the Pallas TPU kernel `jepsen_tpu/checker/wgl_pallas.py:58`
(`closure_round_fn(S, P)`, whose `pl.pallas_call` is at `:95`). One
Jacobi round over the dense table ``tb`` (S states x C = 2^P pending
masks), with ``mft[p] = M[p].T`` the transposed transition matrix of
slot p:

    out[q, c] = tb[q, c]
              | OR_{p : bit p of c} OR_s (mft[p, q, s] & tb[s, c ^ 2^p])

i.e. linearizing pending slot p moves state s to q and sets bit p of the
mask. The caller (`wgl.DenseKernel._closure`) repeats rounds until the
popcount stops growing.

Design (`csrc/closure_round.cu`). One thread per output cell (q, c), a
block of 256 columns of one state row q. The block first compacts, per
slot p, the source states s with mft[p, q, s] set into shared memory
(a warp ballot per 32 states), so each thread then reads only the
table cells that can move into it: for a deterministic model at most
one source state per slot. The TPU's lane roll + iota mask becomes the
direct index c ^ 2^p, and the TPU's f32 ``dot > 0`` becomes a boolean
OR-AND, bit-exact, with an early exit once the cell is set. The round
reads ``tb`` and writes a separate buffer, so it stays Jacobi, as the
TPU round does. Unlike the TPU kernel's VMEM gate, there is no shape
gate: the kernel reads the table from device memory and L2 at every
dense shape (S <= 512, S * 2^P <= 2^22).

What bounds it on an H100: the bytes. The table is read once and written
once as uint8 (2 * S * C bytes, plus P * S * S for mft); the AND-ORs the
data needs are at most nnz(mft) * C / 2, a few per cell. At the main
path's shapes (S = 8, P = 7 to 19) that is under 10 MB, so the bound is
microseconds and one launch (about 3-5 us) is the real floor; the eager
step walk around the kernel sets the pace of a check.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
PyTorch version runs only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

LAUNCHES = 0    # K1 launches by `closure_round`, and nothing else

SOURCE = "jepsen_tpu_torch/csrc/closure_round.cu"
REPLACES = "jepsen_tpu/checker/wgl_pallas.py:58"

MAX_SLOTS = 30
MAX_SMEM_BYTES = 48 * 1024    # static launch limit: no opt-in needed


def closure_round_plain(table: torch.Tensor,
                        mft: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch round: the same function as K1, as a batched
    product and one gather per slot. 0/1 operands make the f32 product
    exact (sums of at most S ones)."""
    P, S, _ = mft.shape
    C = table.shape[1]
    moved = torch.einsum("pqs,sc->pqc", mft.to(torch.float32),
                         table.to(torch.float32)) > 0          # (P, S, C)
    out = table.to(torch.bool).clone()
    cols = torch.arange(C, device=table.device)
    for p in range(P):
        b = 1 << p
        out |= moved[p][:, cols ^ b] & ((cols & b) != 0)
    return out.to(table.dtype)


def _check(table: torch.Tensor, mft: torch.Tensor) -> tuple[int, int, int]:
    if table.device.type != "cuda" or mft.device != table.device:
        raise ValueError(
            f"closure_round takes both tensors on one CUDA device (or "
            f"both on the CPU), got {table.device} and {mft.device}")
    if table.dtype not in (torch.bool, torch.uint8) or table.dim() != 2:
        raise ValueError(f"table must be bool/uint8 (S, C), got "
                         f"{table.dtype} {tuple(table.shape)}")
    if mft.dtype != torch.uint8 or mft.dim() != 3:
        raise ValueError(f"mft must be uint8 (P, S, S), got "
                         f"{mft.dtype} {tuple(mft.shape)}")
    S, C = table.shape
    P = mft.shape[0]
    if mft.shape[1:] != (S, S) or C != 1 << P or P > MAX_SLOTS:
        raise ValueError(f"shape mismatch: table {tuple(table.shape)}, "
                         f"mft {tuple(mft.shape)} (need C = 2^P, "
                         f"P <= {MAX_SLOTS})")
    if 2 * P * S > MAX_SMEM_BYTES or S > 65535:
        raise ValueError(f"S={S}, P={P} exceeds the kernel's shared "
                         f"memory ({MAX_SMEM_BYTES} bytes)")
    if not (table.is_contiguous() and mft.is_contiguous()):
        raise ValueError("closure_round takes contiguous tensors")
    return S, C, P


@functools.cache
def _kernel():
    lib = _build.library("closure_round")
    fn = lib.jt_closure_round
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.jt_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def closure_round(table: torch.Tensor, mft: torch.Tensor) -> torch.Tensor:
    """One closure round: K1 on CUDA tensors, the plain version on CPU
    tensors. table: bool or uint8 (S, 2^P); mft: uint8 (P, S, S) with
    mft[p] = M[p].T. Returns a new table of table's dtype; launches on
    the current stream and does not synchronise."""
    global LAUNCHES
    if table.device.type == "cpu" and mft.device.type == "cpu":
        return closure_round_plain(table, mft)
    S, C, P = _check(table, mft)
    fn, err = _kernel()
    out = torch.empty_like(table)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        code = fn(table.data_ptr(), mft.data_ptr(), out.data_ptr(),
                  S, P, C, stream)
    if code != 0:
        raise RuntimeError(f"closure_round launch failed: CUDA error "
                           f"{code} ({err(code).decode()})")
    LAUNCHES += 1
    return out
