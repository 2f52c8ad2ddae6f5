"""Device resolution, fault classification, fault injection and the
bounded device read.

Counterpart of `jepsen_tpu/_platform.py`. Which device a call runs on:
CUDA unless the caller names another, and never the CPU in its place.

What a device failure means. PyTorch raises most CUDA failures as a
`RuntimeError` (an `AcceleratorError` in newer releases) that tells a
recovery ladder nothing; `classify_backend_error` buckets them into the
faults a checking service on a GPU sees — out of memory, a lost or
poisoned device, a kernel that does not build, a wedged sync — and
returns None for ordinary RuntimeErrors, which are checker bugs and must
never be absorbed. ABFT mismatches (`CorruptDeviceResult`) are the fifth
bucket.

Because real faults are hard to produce on demand, the same module
carries the injection shim of the JAX package, with the same grammar:
`maybe_inject_fault(site)` runs just before every recovery-aware device
dispatch, and either the `JEPSEN_TPU_FAULT_INJECT` env knob (``kind@site:n``
— raise an InjectedFault of `kind` at the n-th dispatch on `site`; a
``bitflip@site:n`` clause flips one bit of the n-th staged buffer on
`site` through `maybe_corrupt`) or the monkeypatchable `fault_hook` /
`corrupt_hook` make each bucket reproducible on the CPU. The JAX
package's ordered `FaultSchedule` and its chaos `probe` belong to the
service and are not ported yet.
"""

from __future__ import annotations

import os

import torch

ATTEST_ENV = "JEPSEN_TPU_ATTEST"
FAULT_INJECT_ENV = "JEPSEN_TPU_FAULT_INJECT"
SYNC_DEADLINE_ENV = "JEPSEN_TPU_SYNC_DEADLINE_S"

# Fault buckets (classify_backend_error's values). FAULT_CORRUPT is
# raised by the checkers themselves (checker/abft.py): a staged buffer
# or a device result was silently corrupted.
FAULT_OOM = "oom"
FAULT_DEVICE_LOST = "device-lost"
FAULT_COMPILE = "compile"
FAULT_WEDGED = "wedged"
FAULT_CORRUPT = "corrupt"
FAULT_KINDS = (FAULT_OOM, FAULT_DEVICE_LOST, FAULT_COMPILE,
               FAULT_WEDGED, FAULT_CORRUPT)


class InjectedFault(RuntimeError):
    """A deterministic stand-in for a device fault (tests only). A
    RuntimeError, as PyTorch's CUDA errors are, so the ladders run the
    same catch/classify/retry path."""

    def __init__(self, kind: str, site: str, seq: int):
        super().__init__(f"injected {kind} fault at {site} dispatch #{seq}")
        self.kind = kind


class CorruptDeviceResult(RuntimeError):
    """An ABFT attestation checksum disagreed: a staged buffer, a device
    reduction or a fetched carry was silently corrupted between the
    device's computation and the host's read."""

    kind = FAULT_CORRUPT

    def __init__(self, site: str, detail: str):
        super().__init__(f"attestation mismatch at {site}: {detail}")
        self.site = site


class WedgedDeviceSync(RuntimeError):
    """A blocking device read outlived its watchdog deadline. The read
    is abandoned, not killed (a Python thread cannot be), and its late
    result is discarded."""

    kind = FAULT_WEDGED


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a kernel source. Classified
    FAULT_COMPILE, a bucket the port's ladder never retries: no plain
    version and no host check stands in for a kernel that does not
    build."""

    kind = FAULT_COMPILE


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error. Classified by its
    message like any other CUDA failure; an error that names no device
    fault (a refused argument, say) is the port's bug and returns
    None."""


# message fragments -> bucket, checked in order, first match wins. Only
# CUDA's own phrases: a checker bug matches only by quoting them.
_FAULT_PATTERNS = (
    (FAULT_OOM, ("out of memory",)),
    (FAULT_DEVICE_LOST, ("illegal memory access", "unspecified launch "
                         "failure", "uncorrectable ecc", "ecc error",
                         "device-side assert", "device lost",
                         "illegal instruction", "hardware stack error",
                         "cuda-capable device(s) is/are busy",
                         "device has fallen off the bus")),
    (FAULT_COMPILE, ("no kernel image is available",
                     "device kernel image is invalid", "nvcc failed")),
    (FAULT_WEDGED, ("launch timed out", "timed out")),
)


def _cuda_error(exc: BaseException) -> bool:
    """Is exc PyTorch's or the port's report of a CUDA failure (not a
    plain RuntimeError of checker logic)?"""
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None and isinstance(exc, acc):
        return True
    if isinstance(exc, KernelLaunchError):
        return True
    # older PyTorch raises CUDA failures as plain RuntimeErrors whose
    # message starts with its own "CUDA error" prefix
    return type(exc) is RuntimeError and (
        str(exc).startswith("CUDA error"))


def classify_backend_error(exc: BaseException) -> str | None:
    """Bucket a device failure into one of FAULT_KINDS, or None when the
    exception is an ordinary bug.

    * an exception carrying ``kind`` (this module's fault types, the
      build error) classifies by it;
    * `torch.cuda.OutOfMemoryError` is oom;
    * a CUDA failure (PyTorch's `AcceleratorError`, its "CUDA error"
      RuntimeErrors, a kernel's `KernelLaunchError`) by its message:
      illegal address, unspecified launch failure, ECC, device-side
      assert, a lost device -> device-lost; no kernel image -> compile;
      timeouts -> wedged; PyTorch's other CUDA errors -> wedged, the
      retry-and-see bucket; the port's own launch refusals -> None;
    * anything else, a plain RuntimeError of checker logic included,
      returns None and re-raises."""
    kind = getattr(exc, "kind", None)
    if kind in FAULT_KINDS:
        return kind
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return FAULT_OOM
    if not _cuda_error(exc):
        return None
    msg = str(exc).lower()
    for bucket, frags in _FAULT_PATTERNS:
        if any(f in msg for f in frags):
            return bucket
    return None if isinstance(exc, KernelLaunchError) else FAULT_WEDGED


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default)
    and absent — the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def attest_enabled(override=None) -> bool:
    """Is ABFT attestation on? An explicit option beats the
    JEPSEN_TPU_ATTEST env gate (default ON; =0 opts out)."""
    if override is not None:
        return bool(override)
    return os.environ.get(ATTEST_ENV, "1") != "0"


# ---------------------------------------------------------------------------
# Fault injection (tests only)
# ---------------------------------------------------------------------------

# Monkeypatchable hook around dispatch: fn(site) -> None, may raise.
# Checked on every maybe_inject_fault call, before the env knob.
fault_hook = None

# Monkeypatchable hook around staging: fn(site, arr) -> ndarray | None
# (None = leave the buffer alone), checked before the env knob.
corrupt_hook = None

# the bit a bitflip clause flips (bit 12 of the middle element), as in
# the JAX package: any single flipped bit fails the staged digest
BITFLIP_KIND = "bitflip"
_BITFLIP_BIT = 12

_fault_seq: dict[str, int] = {}
_corrupt_seq: dict[str, int] = {}


def reset_fault_injection() -> None:
    """Zero the per-site dispatch and staging counters."""
    _fault_seq.clear()
    _corrupt_seq.clear()


def _clauses(kind_is_bitflip: bool):
    """(kind, site, n) of each JEPSEN_TPU_FAULT_INJECT clause of one
    family: bitflips (staging) or the rest (dispatch)."""
    spec = os.environ.get(FAULT_INJECT_ENV)
    for clause in (spec or "").split(","):
        clause = clause.strip()
        if not clause:
            continue
        kind, _, rest = clause.partition("@")
        if (kind == BITFLIP_KIND) != kind_is_bitflip:
            continue
        site, _, seq = rest.partition(":")
        yield kind, site, int(seq or 1)


def maybe_inject_fault(site: str) -> None:
    """Called just before each recovery-aware device dispatch. Sites in
    use: 'offline' (wgl.analysis_gpu) and 'batch'
    (wgl.analysis_gpu_batch). The n-th dispatch on a site named by a
    ``kind@site:n`` clause raises InjectedFault(kind); n counts every
    dispatch since reset_fault_injection(), so a retry moves past the
    clause and the fault fires once, like a real transient."""
    n = _fault_seq.get(site, 0) + 1
    _fault_seq[site] = n
    hook = fault_hook
    if hook is not None:
        hook(site)
    for kind, tsite, seq in _clauses(False):
        if tsite == site and n == seq:
            raise InjectedFault(kind, site, n)


def maybe_corrupt(site: str, arr):
    """Called on each host-staged buffer just before it is copied to the
    device. A ``bitflip@site:n`` clause flips one bit in a COPY of the
    n-th staged buffer on that site: the caller ships the copy while
    its canonical host buffer, and the digest computed from it, stay
    intact — a silent DMA/HBM flip. Returns the array to ship (the
    original object when nothing matched)."""
    n = _corrupt_seq.get(site, 0) + 1
    _corrupt_seq[site] = n
    hook = corrupt_hook
    if hook is not None:
        out = hook(site, arr)
        if out is not None:
            return out
    for _kind, tsite, seq in _clauses(True):
        if tsite == site and n == seq:
            return flip_bit(arr)
    return arr


def flip_bit(arr, bit: int = _BITFLIP_BIT):
    """A copy of arr with one bit flipped in its middle element."""
    import numpy as np

    out = np.array(arr, copy=True)
    flat = out.reshape(-1).view(np.uint32 if out.dtype.itemsize == 4
                                else np.uint8)
    flat[len(flat) // 2] ^= np.uint32(1 << bit) if flat.dtype.itemsize \
        == 4 else np.uint8(1 << (bit % 8))
    return out


# ---------------------------------------------------------------------------
# Watchdog: bounded device reads
# ---------------------------------------------------------------------------

def sync_deadline_s() -> float | None:
    """The watchdog deadline for blocking device reads, from
    JEPSEN_TPU_SYNC_DEADLINE_S (seconds; unset or 0 = unbounded)."""
    raw = os.environ.get(SYNC_DEADLINE_ENV)
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def guarded_fetch(read, deadline_s: float | None = None,
                  site: str = "device-sync"):
    """Run `read` (a blocking device-to-host read) under a watchdog
    deadline: past it, raise WedgedDeviceSync (a recoverable fault)
    instead of blocking forever. deadline_s=None defers to the env knob;
    with neither set, `read` runs on the caller's thread and no thread
    is spawned."""
    if deadline_s is None:
        deadline_s = sync_deadline_s()
    if not deadline_s:
        return read()
    from .util import TIMED_OUT, timeout
    r = timeout(deadline_s, read, default=TIMED_OUT,
                name=f"jepsen-watchdog {site}")
    if r is TIMED_OUT:
        raise WedgedDeviceSync(
            f"device sync at {site} still blocked after {deadline_s}s "
            f"(watchdog); treating the device as wedged")
    return r
