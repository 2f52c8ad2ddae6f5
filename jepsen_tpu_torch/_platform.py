"""Device resolution and the attestation gate.

Counterpart of `jepsen_tpu/_platform.py`, cut to what the dense engine's
offline path needs: which device a call runs on, the fault type an ABFT
mismatch raises, and the ``JEPSEN_TPU_ATTEST`` gate. Fault injection,
the backend-error classifier and the recovery ladder come in a later
slice.
"""

from __future__ import annotations

import os

import torch

ATTEST_ENV = "JEPSEN_TPU_ATTEST"
FAULT_CORRUPT = "corrupt"


class CorruptDeviceResult(RuntimeError):
    """An ABFT attestation checksum disagreed: a staged buffer, a device
    reduction or a fetched carry was silently corrupted between the
    device's computation and the host's read."""

    kind = FAULT_CORRUPT

    def __init__(self, site: str, detail: str):
        super().__init__(f"attestation mismatch at {site}: {detail}")
        self.site = site


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
