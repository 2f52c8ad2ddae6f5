"""K2: the sort family's frontier dedup, hand-written for Hopper.

Replaces the Pallas TPU kernel `jepsen_tpu/checker/wgl_dedup.py:129`
(`dedup_fn(N, F)`, whose `pl.pallas_call` is at `:215`). Contract, the
same as the TPU kernel's:

  * input: N packed config keys, **old frontier first**, invalid
    entries = EMPTY (-1). A key packs ``(state - s_lo) << P | mask``
    into 31 bits (`wgl.SortKernel._dedup_hash` builds it);
  * outputs: the distinct valid keys in **first-seen order**, compacted
    into F slots (EMPTY past them); ``new[i]``, set when out[i]'s first
    occurrence has input index >= F (a candidate, not an old config);
    ``count``, the total of distinct keys (count > F is the overflow
    signal); and ``digest = xor(keys claimed in the hash table) ^
    count * DIGEST_COUNT_MIX`` in wrapping int32, which the caller
    recomputes from the compacted output as its ABFT cross-check.

Design (`csrc/dedup.cu`). The TPU kernel walks the keys in one serial
`fori_loop` against a VMEM table. On the card every key inserts at once:
it hashes (murmur3 finaliser, the TPU kernel's constants) into a table
of H = `table_size(N)` slots, claims a slot with `atomicCAS(EMPTY ->
key)` by linear probing, and records its input index there with
`atomicMin`. A key's first occurrence is the index that owns the
minimum, so flagging those indices and ranking them with an exclusive
scan in input order gives the serial loop's first-seen order. Atomics
move where a key lands in the table, never the outputs: the order comes
from the minimum index, and the digest is a XOR over a set. Two routes,
by N (`path`):

  * N <= `SINGLE_BLOCK_MAX_N` (8,192): one launch of one 1,024-thread
    block with all its state in shared memory (200 KB at most); each
    thread owns up to 8 consecutive keys, so one block scan ranks the
    flags, and takes them as a queue, one probe per turn. No scratch.
    This route
    takes every call of the main path at F = 256 and stage A (N = 2F)
    of the escalated passes at F = 1,024 and 4,096, whose keys, a full
    frontier and its candidates, are nearly all distinct.
    `chip_smoke.py` times both routes on every shape both take, on
    repeating keys and on full frontiers; the single block was the
    faster on each (PERF.md).
  * larger N (stage B of the escalated passes, stage A from
    F = 16,384): five launches (fill, insert, count, scan of the block
    totals, scatter) with the table in a scratch buffer.

What bounds it on an H100: launches. The bytes K2 must move (N keys
read, 2F outputs written) take under a microsecond at the main path's
shapes, at the H100 SXM's 3.35 TB/s (data sheet, 700 W power limit),
and the probes are a few integer operations a key; one launch of a few
microseconds is the single-block route's floor, five that of the large
route's. On the single block, one SM's shared-memory atomics add to the
floor as N and the share of distinct keys grow.

A leading batch axis, keys (B, N), dedups the B rows in one call (one
launch on the single-block route, one block per row; five on the large
route, each with a row axis), as the TPU kernel gains a batch grid axis
under `jax.vmap` in the JAX package's batch entry; row b of each output
is the call on row b (`wgl.SortKernel.check_chunk_batch`).

On a CUDA tensor `dedup` launches K2 or raises; the plain PyTorch
version (`dedup_plain`) runs only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import _build
from .._platform import KernelLaunchError
from .abft import wrap_i32

EMPTY = -1                # table/key sentinel; valid keys are 31-bit
# The TPU kernel's VMEM budget. The CUDA kernel keeps its table in
# device memory and has no such limit, but `eligible` keeps the gate so
# that the port runs the same dedup route as the JAX package at every
# frontier size and stamps the same "dedup" in its results.
MAX_VMEM_BYTES = 12 << 20
# digest mixing constant (golden-ratio prime): the occupancy count is
# folded into the XOR digest so a dropped-and-double-counted key pair
# (XOR-cancelling) still perturbs the digest
DIGEST_COUNT_MIX = -1640531527   # 0x9E3779B9 as int32

LAUNCHES = 0    # K2 launches by `dedup`, and nothing else
# stream workers launch from several threads: `+=` on a global is not
# atomic, so the count moves under this lock
_LAUNCH_LOCK = threading.Lock()
# the largest N that the single-block route takes (csrc/dedup.cu
# kSingleMaxN): one CUDA launch per call, five above it
SINGLE_BLOCK_MAX_N = 8192

SOURCE = "jepsen_tpu_torch/csrc/dedup.cu"
REPLACES = "jepsen_tpu/checker/wgl_dedup.py:129"

_MASK = 0xFFFFFFFF


def table_size(n: int) -> int:
    """Hash slots for n keys: the next power of two (at least 64),
    doubled, for a load factor of at most 1/2."""
    h = 64
    while h < n:
        h *= 2
    return 2 * h


def eligible(F: int, P: int) -> bool:
    """The JAX package's capacity gate for the hash dedup at frontier F
    with P slots, sized for stage B's F * (1 + P) candidates. The
    packed-key requirement is the caller's (`wgl._hash_gate`)."""
    n = F * (1 + P)
    return (n + table_size(n) + 2 * F) * 4 <= MAX_VMEM_BYTES


# xor_fold expands bits up to this many elements (a 32-times larger int64
# intermediate, 32 MiB here) and folds halves past it
XOR_EXPAND_MAX = 1 << 17


def xor_fold(x: torch.Tensor) -> torch.Tensor:
    """The XOR of an int32 tensor's elements along its last axis, as
    int64 in [0, 2^32) (0-d for a 1-d tensor). torch has no XOR
    reduction. Up to XOR_EXPAND_MAX elements (the hash dedup's
    attestation, at (F,) or (B, F)) each bit's parity comes from one sum
    over the expanded bits, in a fixed handful of launches; larger inputs
    (the plain dedup's (B, N) on the CPU) fold halves onto each other,
    log2(N) XORs with no intermediate larger than the input."""
    if x.numel() <= XOR_EXPAND_MAX:
        shifts = torch.arange(32, dtype=torch.int64, device=x.device)
        bits = (x.to(torch.int64)[..., None] >> shifts) & 1
        return ((bits.sum(-2) & 1) << shifts).sum(-1)
    x = x.to(torch.int64) & _MASK
    while x.shape[-1] > 1:
        n = x.shape[-1]
        if n % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
            n += 1
        x = x[..., :n // 2] ^ x[..., n // 2:]
    return x[..., 0]


def mix_count(count: torch.Tensor) -> torch.Tensor:
    """count * DIGEST_COUNT_MIX mod 2^32, as int64 in [0, 2^32)."""
    return (count.to(torch.int64) * (DIGEST_COUNT_MIX & _MASK)) & _MASK


def dedup_plain(keys: torch.Tensor, F: int):
    """The plain PyTorch version of K2's contract, by a stable sort
    instead of a hash table: equal keys sit together in input order, so
    each run's first element is the key's first occurrence. No step
    reads a value on the host, so it runs on any device. keys (N,), or
    (B, N) for B rows at once (outputs with a leading B)."""
    if keys.dim() == 1:
        return tuple(t[0] for t in dedup_plain(keys[None], F))
    B, n = keys.shape
    dev = keys.device
    k64 = torch.where(keys == EMPTY, torch.iinfo(torch.int64).max,
                      keys.to(torch.int64))
    ks, perm = torch.sort(k64, dim=1, stable=True)
    head = torch.ones((B, n), dtype=torch.bool, device=dev)
    head[:, 1:] = ks[:, 1:] != ks[:, :-1]
    head &= ks != torch.iinfo(torch.int64).max
    first = torch.zeros((B, n), dtype=torch.bool, device=dev)
    first.scatter_(1, perm, head)         # flags in input order
    count = first.sum(1, dtype=torch.int32)
    rank = torch.cumsum(first, 1) - 1
    at = torch.where(first & (rank < F), rank, F)   # F: discarded
    out = torch.full((B, F + 1), EMPTY, dtype=torch.int32, device=dev)
    new = torch.zeros((B, F + 1), dtype=torch.bool, device=dev)
    idx = torch.arange(n, device=dev)
    out.scatter_(1, at, torch.where(at < F, keys, EMPTY))
    new.scatter_(1, at, (idx >= F) & (at < F))
    digest = wrap_i32(xor_fold(torch.where(first, keys, 0))
                      ^ mix_count(count))
    return out[:, :F], new[:, :F], count, digest


def _check(keys: torch.Tensor, F: int) -> tuple[int, int]:
    """(B, N) of a keys tensor K2 takes: (N,) is one row."""
    if keys.device.type != "cuda":
        raise ValueError(f"dedup takes a CUDA tensor (or a CPU one), got "
                         f"{keys.device}")
    if keys.dtype != torch.int32 or keys.dim() not in (1, 2) \
            or keys.numel() < 1:
        raise ValueError(f"keys must be a nonempty int32 (N,) or (B, N) "
                         f"tensor, got {keys.dtype} {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("dedup takes a contiguous tensor")
    B, n = (1, keys.shape[0]) if keys.dim() == 1 else keys.shape
    if not 1 <= F < 1 << 30 or table_size(n) >= 1 << 30 \
            or not 1 <= B <= 65535:
        raise ValueError(f"B={B}, N={n}, F={F} outside the kernel's "
                         f"grid or int range")
    return B, n


@functools.cache
def _kernel():
    lib = _build.library("dedup")
    fn = lib.jt_dedup
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = lib.jt_dedup_scratch_ints
    scratch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int]
    scratch.restype = ctypes.c_longlong
    launches = lib.jt_dedup_kernel_launches
    launches.argtypes = []
    launches.restype = ctypes.c_longlong
    err = lib.jt_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, scratch, launches, err


def path(n: int) -> str:
    """The route K2 takes for n keys."""
    return "single-block" if n <= SINGLE_BLOCK_MAX_N else "five-launch"


def cuda_launches() -> int:
    """CUDA kernels launched by K2's library since it was loaded: one
    per call on the single-block path, five on the large path, batched
    or not."""
    return int(_kernel()[2]())


def dedup(keys: torch.Tensor, F: int):
    """Frontier dedup: K2 on a CUDA tensor, the plain version on a CPU
    tensor. keys: int32 (N,), old frontier first, EMPTY = -1. Returns
    (out int32 (F,), new bool (F,), count int32 (), digest int32 ()),
    launched on the current stream without a synchronisation. keys
    (B, N) dedups B rows in one call, with a leading B on each output."""
    if keys.device.type == "cpu":
        return dedup_plain(keys, F)
    return launch(keys, F, path(_check(keys, F)[1]))


def launch(keys: torch.Tensor, F: int, route: str):
    """K2 on the CUDA tensor `keys` by the route named (`path`'s
    values; "single-block" takes at most SINGLE_BLOCK_MAX_N keys).
    `dedup` takes the route `path` picks; this entry lets a measurement
    time the other one on the same keys."""
    global LAUNCHES
    B, n = _check(keys, F)
    if route not in ("single-block", "five-launch"):
        raise ValueError(f"no K2 route {route!r}")
    single = int(route == "single-block")
    if single and n > SINGLE_BLOCK_MAX_N:
        raise ValueError(f"the single-block route takes at most "
                         f"{SINGLE_BLOCK_MAX_N} keys, got {n}")
    fn, scratch_ints, _launches, err = _kernel()
    H = table_size(n)
    dev = keys.device
    # two allocations: out (B x F), count and digest (B x 2) and the
    # large path's scratch (none on the single-block path) in one int32
    # buffer; the flags
    ints = torch.empty(B * (F + 2) + int(scratch_ints(B, n, H, single)),
                       dtype=torch.int32, device=dev)
    new = torch.empty((B, F), dtype=torch.bool, device=dev)
    ptr = ints.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(keys.data_ptr(), B, n, F, H, single, ptr,
                  new.data_ptr(), ptr + 4 * B * F, ptr + 4 * B * (F + 2),
                  stream)
    if code != 0:
        raise KernelLaunchError(f"dedup launch failed: CUDA error {code} "
                                f"({err(code).decode()})")
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    out = ints[:B * F].view(B, F)
    tail = ints[B * F:B * (F + 2)].view(B, 2)
    if keys.dim() == 1:
        return out[0], new[0], tail[0, 0], tail[0, 1]
    return out, new, tail[:, 0], tail[:, 1]
