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

A leading batch axis, ``tb (B, S, C)`` with ``mft (B, P, S, S)``, runs
the B rounds in one launch, as the TPU kernel gains a batch grid axis
under `jax.vmap` in the JAX package's batch entry; row b of the result
is the round of table b (`wgl.DenseKernel.check_chunk_batch`).

Design (`csrc/closure_round.cu`). A block serves one state row q and
first lists, per slot p, the source states s with mft[p, q, s] set in
shared memory (a warp ballot per 32 states), so a thread reads only the
rows that can move into its row: for a deterministic model at most one
source state per slot. A thread owns a 16-byte chunk (columns
[16j, 16j + 16)) of row q: it loads its chunk once, ORs in what moves
into it and writes one 16-byte word. Slots p >= 4 move whole chunks
(bit p of c is bit p - 4 of j: the aligned chunk j ^ 2^(p-4) of each
source row, loaded only where that bit is set); slots p < 4 move bytes
inside the chunk, by shifts and word swaps on its four little-endian
32-bit words, which is the TPU kernel's lane roll plus iota mask. The
TPU's f32 ``dot > 0`` becomes a boolean OR-AND, bit-exact, with no
branch per cell and no early exit. Tables narrower than a chunk
(P <= 3) take a byte-per-thread path in the same source. The round
reads ``tb`` and writes a separate buffer, so it stays Jacobi, as the
TPU round does. Unlike the TPU kernel's VMEM gate, there is no shape
gate over the dense domain (S <= 512, S * 2^P <= 2^22).

What bounds it on an H100: L2 load instructions. The table is at most
4 MB and stays in the 50 MB L2 between rounds, so the round costs
1 + nnz(mft[:4, q]) + nnz(mft[4:, q]) / 2 coalesced 16-byte loads per
chunk of row q, not HBM bytes; the AND-ORs are a few per loaded word.
At the main path's S = 8 there is nothing for the tensor cores to do:
the round is data movement. At P <= 14 one launch (about 3 us) is the
floor, and the eager step walk around the kernel sets the pace of a
check.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
PyTorch version runs only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._platform import KernelLaunchError

LAUNCHES = 0    # K1 launches by `closure_round`, and nothing else

SOURCE = "jepsen_tpu_torch/csrc/closure_round.cu"
REPLACES = "jepsen_tpu/checker/wgl_pallas.py:58"

MAX_SLOTS = 30
MAX_SMEM_BYTES = 48 * 1024    # static launch limit: no opt-in needed
ENTRY_BYTES = 4               # one listed source state in shared memory
CHUNK_SLOTS = 4               # P >= 4: 16-byte chunks, 16-byte aligned


def closure_round_plain(table: torch.Tensor,
                        mft: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch round: the same function as K1, as a batched
    product and one gather per slot. 0/1 operands make the f32 product
    exact (sums of at most S ones). Takes K1's shapes, (S, C) with
    (P, S, S), or the batched (B, S, C) with (B, P, S, S)."""
    P, S = mft.shape[-3], mft.shape[-2]
    C = table.shape[-1]
    moved = torch.einsum("...pqs,...sc->...pqc", mft.to(torch.float32),
                         table.to(torch.float32)) > 0     # (..., P, S, C)
    out = table.to(torch.bool).clone()
    cols = torch.arange(C, device=table.device)
    for p in range(P):
        b = 1 << p
        out |= moved[..., p, :, :][..., cols ^ b] & ((cols & b) != 0)
    return out.to(table.dtype)


def _check(table: torch.Tensor,
           mft: torch.Tensor) -> tuple[int, int, int, int]:
    if table.device.type != "cuda" or mft.device != table.device:
        raise ValueError(
            f"closure_round takes both tensors on one CUDA device (or "
            f"both on the CPU), got {table.device} and {mft.device}")
    batched = table.dim() == 3
    if table.dtype not in (torch.bool, torch.uint8) \
            or table.dim() not in (2, 3):
        raise ValueError(f"table must be bool/uint8 (S, C) or (B, S, C), "
                         f"got {table.dtype} {tuple(table.shape)}")
    if mft.dtype != torch.uint8 or mft.dim() != table.dim() + 1:
        raise ValueError(f"mft must be uint8 (P, S, S), or (B, P, S, S) "
                         f"with a batched table, got {mft.dtype} "
                         f"{tuple(mft.shape)}")
    B = table.shape[0] if batched else 1
    S, C = table.shape[-2:]
    P = mft.shape[-3]
    if mft.shape[-2:] != (S, S) or C != 1 << P or P > MAX_SLOTS \
            or (batched and mft.shape[0] != B):
        raise ValueError(f"shape mismatch: table {tuple(table.shape)}, "
                         f"mft {tuple(mft.shape)} (need C = 2^P, "
                         f"P <= {MAX_SLOTS}, one B)")
    if ENTRY_BYTES * P * S > MAX_SMEM_BYTES or S > 65535 \
            or not 1 <= B <= 65535 or B * S > 1 << 27:
        raise ValueError(f"B={B}, S={S}, P={P} exceeds the kernel's grid "
                         f"or shared memory ({MAX_SMEM_BYTES} bytes)")
    if not (table.is_contiguous() and mft.is_contiguous()):
        raise ValueError("closure_round takes contiguous tensors")
    if P >= CHUNK_SLOTS and table.data_ptr() % 16:
        raise ValueError("closure_round takes a 16-byte aligned table")
    return B, S, C, P


@functools.cache
def _kernel():
    lib = _build.library("closure_round")
    fn = lib.jt_closure_round
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.jt_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def closure_round(table: torch.Tensor, mft: torch.Tensor) -> torch.Tensor:
    """One closure round: K1 on CUDA tensors, the plain version on CPU
    tensors. table: bool or uint8 (S, 2^P); mft: uint8 (P, S, S) with
    mft[p] = M[p].T; or both with a leading batch axis B, one launch
    for all B. Returns a new table of table's dtype; launches on the
    current stream and does not synchronise."""
    global LAUNCHES
    if table.device.type == "cpu" and mft.device.type == "cpu":
        return closure_round_plain(table, mft)
    B, S, C, P = _check(table, mft)
    fn, err = _kernel()
    out = torch.empty_like(table)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        code = fn(table.data_ptr(), mft.data_ptr(), out.data_ptr(),
                  B, S, P, C, stream)
    if code != 0:
        raise KernelLaunchError(f"closure_round launch failed: CUDA error "
                                f"{code} ({err(code).decode()})")
    LAUNCHES += 1
    return out
