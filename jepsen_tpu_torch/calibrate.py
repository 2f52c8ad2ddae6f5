"""Online-calibrated cost model: measured device-seconds per modeled
element-op.

The port's copy of `jepsen_tpu/calibrate.py`. `wgl.select_engine` prices
kernel shapes in *modeled* element-ops, constants fit by hand against one
hardware round, while the telemetry layer records ground-truth chunk
latency at every dispatch site. This module closes that loop:

  * **Robust running fit.** Each engine variant (``dense`` / ``sort`` /
    ``hash``) keeps one coefficient, measured seconds per modeled
    element-op, updated per observation by a bounded-influence running
    regression through the origin: the observed ratio is clipped to
    within ``CLIP_FACTOR``x of the current estimate (one wedged 60 s
    chunk cannot blow up the fit) and folded in with a step that decays
    from plain averaging to an EWMA (``ALPHA_MIN``), so the fit converges
    fast from cold and still tracks drift (clock or power throttling).
  * **Persistence.** Coefficients live in a small JSON file per platform
    (``calibration-<platform>.json``) in the port's own cache directory,
    never next to the JAX package's: coefficients measured under XLA are
    not the card's. The service daemon writes it at drain and loads it at
    start. The format is the JAX package's, so either package loads a
    file the other saved.
  * **Activation.** Nothing observes or consults calibration unless a
    `Calibration` is explicitly activated (:func:`activate`; the daemon
    does; `VerificationService` instances calibrate their own private
    instance either way). `select_engine` compares families by measured
    seconds only once BOTH compared variants have ``MIN_OBSERVATIONS``:
    a half-calibrated model never flips an engine choice on one noisy
    ratio.

Observation sites: the service's stream pump (per chunk, the primary
loop) and wgl's offline chunked walk. Both leave a stream's first chunk
out: on the card it pays the library load, the CUDA context and the
caching allocator's warm-up, which are not execution latency.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading

from . import telemetry as _telemetry

log = logging.getLogger(__name__)

# the engine variants select_engine chooses between (the sort family
# runs at the stable sorts' OR the hash dedup's (K2) cost: different
# kernels, different coefficient)
VARIANTS = ("dense", "sort", "hash")

# observations of a variant before its coefficient is trusted for
# engine *decisions* (budget pricing uses whatever is known earlier)
MIN_OBSERVATIONS = 16
# bounded influence: an observed seconds/elementop ratio is clipped to
# [coeff/CLIP_FACTOR, coeff*CLIP_FACTOR] before it moves the estimate
CLIP_FACTOR = 8.0
# the running fit's step decays 1/n down to this floor (EWMA tail), so
# a long-lived daemon still tracks coefficient drift
ALPHA_MIN = 0.05
# pre-calibration conversion: 1e9 modeled element-ops ~ 1 device-
# second. Scaling BOTH costs and budget capacity by one constant keeps
# uncalibrated scheduling identical to the historical element-op
# budget; calibration then corrects each variant's slope individually.
NOMINAL_SECONDS_PER_ELEMENTOP = 1e-9
# where the port keeps its calibration files
CACHE_DIR_ENV = "JEPSEN_TPU_TORCH_CACHE_DIR"

_M_OBS = _telemetry.counter(
    "jepsen_tpu_wgl_calibration_observations_total",
    "Chunk-latency observations folded into the measured cost model",
    ("variant",))
_M_COEFF = _telemetry.gauge(
    "jepsen_tpu_wgl_calibration_ratio",
    "Measured seconds per modeled element-op, per engine variant",
    ("variant",))


def detect_platform() -> str:
    """The platform key calibration files are keyed by: "cuda" when
    PyTorch sees a card, else "cpu". Reads neither jax nor
    JAX_PLATFORMS."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def default_path(platform: str | None = None) -> str:
    """`calibration-<platform>.json` in the port's cache directory
    (``$JEPSEN_TPU_TORCH_CACHE_DIR``, else
    ``~/.cache/jepsen-tpu-torch``), apart from the JAX package's, which
    sits next to the JAX compile cache."""
    base = os.environ.get(CACHE_DIR_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "jepsen-tpu-torch")
    return os.path.join(base, f"calibration-{platform or detect_platform()}"
                        ".json")


class Calibration:
    """Per-variant robust running coefficients (see module
    docstring). Thread-safe: the service's stream workers observe
    concurrently."""

    def __init__(self, platform: str | None = None):
        self.platform = platform or detect_platform()
        self._lock = threading.Lock()
        # variant -> [coeff (s/elementop), n observations]
        self._fits: dict[str, list] = {}    # guarded-by: _lock

    # -- fitting -------------------------------------------------------------

    def observe(self, variant: str, elementops: float,
                seconds: float) -> float:
        """Fold one (modeled element-ops, observed seconds) chunk pair
        into the variant's coefficient; returns the updated
        coefficient."""
        ratio = max(float(seconds), 1e-9) / max(float(elementops), 1.0)
        with self._lock:
            fit = self._fits.get(variant)
            if fit is None:
                self._fits[variant] = fit = [ratio, 1]
            else:
                coeff, n = fit
                clipped = min(max(ratio, coeff / CLIP_FACTOR),
                              coeff * CLIP_FACTOR)
                alpha = max(ALPHA_MIN, 1.0 / (n + 1))
                fit[0] = (1.0 - alpha) * coeff + alpha * clipped
                fit[1] = n + 1
            coeff = fit[0]
        _M_OBS.labels(variant=variant).inc()
        _M_COEFF.labels(variant=variant).set(coeff)
        return coeff

    # -- reading -------------------------------------------------------------

    def count(self, variant: str) -> int:
        with self._lock:
            fit = self._fits.get(variant)
            return fit[1] if fit else 0

    def coeff(self, variant: str) -> float | None:
        """The variant's measured coefficient, or — for a variant this
        process never ran — the geometric mean of the measured ones
        (right order of magnitude beats the nominal constant). None
        when nothing at all is measured."""
        with self._lock:
            fit = self._fits.get(variant)
            if fit:
                return fit[0]
            if not self._fits:
                return None
            logs = [math.log(f[0]) for f in self._fits.values()]
            return math.exp(sum(logs) / len(logs))

    def ready(self, *variants: str) -> bool:
        """True when EVERY named variant has a trusted (directly
        measured, >= MIN_OBSERVATIONS) coefficient — the bar for
        letting measurement flip an engine decision."""
        with self._lock:
            return all(
                (self._fits.get(v) or [0, 0])[1] >= MIN_OBSERVATIONS
                for v in variants)

    def seconds(self, variant: str, elementops: float) -> float:
        """Price modeled element-ops in device-seconds: measured
        coefficient when known (or the cross-variant fallback),
        nominal conversion otherwise."""
        c = self.coeff(variant)
        if c is None:
            c = NOMINAL_SECONDS_PER_ELEMENTOP
        return float(elementops) * c

    def coefficients(self) -> dict:
        """{variant: {"seconds-per-elementop": c, "observations": n}}
        — the status()/CLI shape."""
        with self._lock:
            return {v: {"seconds-per-elementop": f[0],
                        "observations": f[1]}
                    for v, f in sorted(self._fits.items())}

    # -- persistence ---------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {"version": 1, "platform": self.platform,
                    "families": {v: {"coeff": f[0], "n": f[1]}
                                 for v, f in self._fits.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        cal = cls(platform=d.get("platform"))
        for v, f in (d.get("families") or {}).items():
            try:
                coeff, n = float(f["coeff"]), int(f["n"])
            except (KeyError, TypeError, ValueError):
                continue
            if coeff > 0 and n > 0:
                cal._fits[v] = [coeff, n]
        return cal

    def save(self, path: str | None = None) -> str:
        path = path or default_path(self.platform)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # pid-unique tmp: concurrent savers (two daemons sharing one
        # cache dir) must not unlink each other's staging file
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str | None = None,
             platform: str | None = None) -> "Calibration":
        """The persisted calibration, or a fresh one when the file is
        missing/corrupt (a bad calibration file must never stop the
        daemon — it just starts cold)."""
        path = path or default_path(platform)
        try:
            with open(path) as fh:
                d = json.load(fh)
        except (OSError, ValueError):
            return cls(platform=platform)
        cal = cls.from_dict(d)
        if platform and cal.platform != platform:
            # a cpu file must not price a cuda backend
            return cls(platform=platform)
        return cal


# -- the process-wide active calibration -------------------------------------
#
# Deliberately opt-in: tests and library users get deterministic
# modeled costs unless something (the service daemon, a bench A/B)
# activates measurement. observe()/active() are the only globals.

_active_lock = threading.Lock()
_active: Calibration | None = None      # guarded-by: _active_lock


def activate(cal: Calibration) -> Calibration:
    global _active
    with _active_lock:
        _active = cal
    return cal


def deactivate() -> None:
    global _active
    with _active_lock:
        _active = None


def active() -> Calibration | None:
    with _active_lock:
        return _active


def observe(variant: str, elementops: float, seconds: float) -> None:
    """Feed the active calibration, if any — the instrumentation-site
    helper (a strict no-op when nothing is activated)."""
    cal = active()
    if cal is not None:
        cal.observe(variant, elementops, seconds)


def price(cal: Calibration | None, variant: str,
          elementops: float) -> float:
    """Device-seconds for modeled element-ops under `cal` (None =
    nominal conversion) — the budget-pricing helper."""
    if cal is None:
        return float(elementops) * NOMINAL_SECONDS_PER_ELEMENTOP
    return cal.seconds(variant, elementops)
