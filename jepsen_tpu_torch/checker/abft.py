"""ABFT attestation: host-verifiable digests over staged buffers and
device carries.

Counterpart of `jepsen_tpu/checker/abft.py`. Every guarded value is
covered by a cheap checksum computed twice through independent paths:
the host computes it over the canonical numpy data, the device over its
own copy, and a mismatch raises `CorruptDeviceResult`.

  * **Staged-buffer digests.** A position-weighted wrap-around int32
    digest of a staged buffer (the WGL step buffer, the Elle
    classifier's float32 adjacency stacks, by bit pattern):
    `digest_host` over the numpy original, `digest_device` over the
    tensor the device reads.
  * **Carry digests.** `carry_digest_host` recomputes an engine's
    on-device carry digest (`wgl.DenseKernel.digest`,
    `wgl.SortKernel.digest`) from a fetched carry; `verify_carry` also
    checks att == 0 and count == the live population. A batched carry
    (a leading B on every element) has one digest per key
    (`carry_digest_device(..., batch=True)`), checked key by key on the
    host.

Both sides do the arithmetic in int64 and reduce mod 2^32 explicitly,
so the digests agree bit for bit with the JAX package's, which computes
them in wrapping int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._platform import CorruptDeviceResult

_MASK = 0xFFFFFFFF
# position weight period: coprime-ish to power-of-two shapes so equal
# elements at different offsets contribute distinct terms
_W_PERIOD = 8191


def _to_i32(x: int) -> int:
    """Wrap a python int to signed 32-bit (the device digest dtype)."""
    x &= _MASK
    return x - (1 << 32) if x >= (1 << 31) else x


@functools.lru_cache(maxsize=None)
def _weights64(n: int) -> np.ndarray:
    return (np.arange(n, dtype=np.int64) % _W_PERIOD) + 1


def digest_host(arr: np.ndarray) -> int:
    """Position-weighted digest of a host buffer, as signed int32.

    Computed in int64 and masked: sums/products mod 2^32 match the
    device's wrapping int32 arithmetic exactly, regardless of where
    the intermediate wraps land."""
    a = np.asarray(arr)
    if a.dtype.kind == "f":
        a = a.view(np.int32)       # bit pattern, not value
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    flat = a.astype(np.int64, copy=False).reshape(-1)
    if flat.size == 0:
        return 0
    return _to_i32(int((flat * _weights64(flat.size)).sum()))


def wrap_i32(h: torch.Tensor) -> torch.Tensor:
    """An int64 tensor holding a value in [0, 2^32) as signed int32."""
    h = h & _MASK
    return (h - ((h >> 31) & 1) * (1 << 32)).to(torch.int32)


def _as_i64(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        x = x.view(torch.int32)    # bit pattern, not value
    return x.to(torch.int64)


def digest_device(x: torch.Tensor) -> torch.Tensor:
    """Device-side twin of digest_host over a staged tensor. Returns an
    unfetched 0-d int32 tensor, so the caller decides when to sync.

    Each product is reduced mod 2^32 before the sum, so the int64 sum
    cannot overflow for any tensor of fewer than 2^31 elements."""
    flat = _as_i64(x).reshape(-1)
    w = torch.arange(flat.numel(), dtype=torch.int64,
                     device=flat.device) % _W_PERIOD + 1
    return wrap_i32(((flat * w) & _MASK).sum())


def verify_steps(site: str, fetched_digest, expected: int) -> None:
    """Compare a fetched device digest with the host's canonical one;
    raise CorruptDeviceResult on disagreement."""
    got = int(fetched_digest)
    if got != expected:
        raise CorruptDeviceResult(
            site, f"staged-buffer digest {got} != host {expected} — "
                  f"the shipped buffer was corrupted in transit")


# ---------------------------------------------------------------------------
# Carry digests (host mirrors of the engines' digest)
# ---------------------------------------------------------------------------

# per-component mixing primes: position i's component multiplies
# _PRIMES[i % len] before xor-folding
_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
           0x165667B1, 0x68B5A6D9, 0x7FEB352D, 0x846CA68B)


def prime_i32(i: int) -> int:
    return _to_i32(_PRIMES[i % len(_PRIMES)])


def _sum_i32(arr: np.ndarray) -> int:
    a = np.asarray(arr)
    if a.dtype == np.bool_:
        a = a.astype(np.int64)
    elif a.dtype.kind in "fu":
        a = a.view(np.int32) if a.dtype.itemsize == 4 \
            else a.astype(np.int64)
    return int(a.astype(np.int64, copy=False).sum())


def carry_digest_host(carry) -> int:
    """Recompute the device carry digest's mix from a FETCHED host carry
    — xor-fold of (component wrap-sum * prime_i) over every carry
    element, scalars included, in carry order."""
    h = 0
    for i, c in enumerate(carry):
        s = _sum_i32(c) * _PRIMES[i % len(_PRIMES)]
        h ^= s & _MASK
    return _to_i32(h)


def carry_digest_device(carry, batch: bool = False) -> torch.Tensor:
    """The same mix as carry_digest_host, on the device, as an unfetched
    0-d int32 tensor; with batch=True, one digest per key of a batched
    carry, as an int32 (B,) tensor (the vmapped digest). Each product of
    a 32-bit sum and a 32-bit prime is split at bit 16 of the prime, so
    no int64 product overflows."""
    h = None
    for i, c in enumerate(carry):
        if c.dtype == torch.float32:
            c = c.view(torch.int32)
        if batch:
            s = c.reshape(c.shape[0], -1).sum(1, dtype=torch.int64) & _MASK
        else:
            s = c.sum(dtype=torch.int64) & _MASK
        p = _PRIMES[i % len(_PRIMES)]
        term = (s * (p & 0xFFFF) + (((s * (p >> 16)) & 0xFFFF) << 16)) \
            & _MASK
        h = term if h is None else h ^ term
    return wrap_i32(h)


def verify_carry(site: str, fetched_digest, carry_host,
                 att_index: int = -3) -> None:
    """Check a fetched carry against its device-computed digest plus
    the structural invariants the host can see: digest parity, att == 0
    and count == the live population (the dense table's popcount, or
    the sort frontier's sum of valid flags)."""
    got = int(fetched_digest)
    want = carry_digest_host(carry_host)
    if got != want:
        raise CorruptDeviceResult(
            site, f"carry digest {got} != host recompute {want} — the "
                  f"fetched carry differs from the device's")
    att = int(np.asarray(carry_host[att_index]))
    if att != 0:
        raise CorruptDeviceResult(
            site, f"in-kernel attestation accumulator = {att} — a "
                  f"frontier/table invariant or dedup digest failed on "
                  f"device")
    count = int(np.asarray(carry_host[-2]))
    live = np.asarray(carry_host[1])     # table (dense) / masks (sort)
    if live.dtype != np.bool_:
        live = np.asarray(carry_host[3])  # the sort frontier's valid
    pop = int(live.sum())
    if count != pop:
        raise CorruptDeviceResult(
            site, f"carry count {count} != live population {pop}")
