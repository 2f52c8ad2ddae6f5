"""Pipeline telemetry: a process-wide metrics registry and exposition.

The port's own copy of `jepsen_tpu/telemetry.py`. The checking pipeline
makes runtime decisions (engine selection, tier-1 escalation, stream
rebuilds, recovery rungs) that would otherwise show only as log lines;
this module counts them:

  * **Registry.** Process-wide, thread-safe counters, gauges and
    histograms with label sets. The hot path takes one uncontended
    per-child lock around a few arithmetic ops; the registry-wide lock
    is taken only when a new (metric, label-set) child materializes.
    ``JEPSEN_TPU_METRICS=0`` (or :func:`set_enabled`) turns every
    mutation into a single attribute check.
  * **Exposition.** :func:`snapshot` (a JSON-able dict),
    :func:`prometheus_text` (the Prometheus text format), and
    :func:`serve_metrics`, an HTTP listener for ``/metrics`` and
    ``/healthz`` (the verification service's status).
  * **Naming convention.** ``jepsen_tpu_<layer>_<name>_<unit>`` with
    layer in :data:`LAYERS` and unit in :data:`UNITS`; counters end in
    ``_total``. Metric names and labels are the JAX package's, so one
    dashboard reads either package.
  * **Profiler hooks.** ``JEPSEN_TPU_PROFILE=<dir>`` makes
    :func:`profile_section` start one ``torch.profiler`` trace (CPU and,
    where there is a card, CUDA activity), exported as a Chrome trace
    into that directory at exit, and wrap each device section in a
    ``record_function`` range so chunk dispatches are named in it.
    Without the env var every call is a no-op that imports nothing.

Instrumentation sites live with the code they observe (wgl dispatch,
streaming chunks and checkpoints, screens); this module imports none of
them.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from typing import Callable, Iterable

# metric-name vocabulary (the JAX package's; keep the sets equal)
LAYERS = ("wgl", "streaming", "screen", "abft", "service", "trace",
          "run", "web", "search", "chaos")
UNITS = ("total", "seconds", "rows", "ops", "chunks", "elementops",
         "bytes", "ratio", "streams", "info", "bits", "genomes")

METRICS_ENV = "JEPSEN_TPU_METRICS"
PROFILE_ENV = "JEPSEN_TPU_PROFILE"

# latency buckets (seconds): device chunks span ~100us (warm CPU sort
# chunk) to minutes (a cold compile on a wedged relay)
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                   120.0)

_enabled = os.environ.get(METRICS_ENV, "1") != "0"


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> bool:
    """Flip the registry hot path on/off process-wide (the overhead
    bench measures the pipeline in both states). Returns the previous
    state."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


def _label_values(labelnames: tuple, kw: dict) -> tuple:
    if set(kw) != set(labelnames):
        raise ValueError(
            f"labels {sorted(kw)} != declared {sorted(labelnames)}")
    return tuple(str(kw[k]) for k in labelnames)


class _Child:
    """One (metric, label-values) series. Mutations take only this
    child's lock — the lock-cheap hot path."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0        # guarded-by: _lock


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple):
        self._lock = threading.Lock()
        self.buckets = buckets          # upper bounds, ascending
        self.counts = [0] * (len(buckets) + 1)   # guarded-by: _lock
        self.sum = 0.0                  # guarded-by: _lock
        self.count = 0                  # guarded-by: _lock

    def observe(self, value: float) -> None:
        if not _enabled:
            return
        v = float(value)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    @contextlib.contextmanager
    def time(self):
        """Observe the wall-clock duration of the with-block."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.observe(time.monotonic() - t0)


class Metric:
    """A named family of label-keyed children. ``labels(**kw)``
    returns (creating on first use) the child for one label-value
    set; unlabeled metrics expose the child's methods directly."""

    kind = "untyped"

    def __init__(self, name: str, help: str,  # noqa: A002 — prometheus vocabulary
                 labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, object] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kw):
        key = _label_values(self.labelnames, kw)
        # lock-free fast path by design: _children is insert-only and
        # dict reads are atomic under the GIL — the hot path must not
        # pay the registry lock per increment
        child = self._children.get(key)  # noqa: JTS201
        if child is None:
            with self._lock:
                child = self._children.setdefault(key,
                                                  self._make_child())
        return child

    def children(self) -> list[tuple[tuple, object]]:
        with self._lock:
            return sorted(self._children.items())

    def clear(self) -> None:
        """Drop every child's accumulated value (tests; the metric and
        its declaration survive)."""
        with self._lock:
            self._children = {}
            if not self.labelnames:
                self._children[()] = self._make_child()

    # unlabeled convenience passthroughs
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} needs labels(...)")
        # lock-free by design: the () child is created in __init__ and
        # never replaced except by clear() (test-only)
        return self._children[()]  # noqa: JTS201


class Counter(Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)


class Gauge(Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._solo().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(),  # noqa: A002
                 buckets: tuple = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    def time(self):
        return self._solo().time()


class Registry:
    """Get-or-create metric registration + exposition. One process-
    wide instance (:data:`REGISTRY`) serves the whole pipeline; tests
    may build private ones."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}   # guarded-by: _lock
        self._lock = threading.Lock()

    def register(self, cls, name: str, help: str,  # noqa: A002
                 labelnames=(), **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise ValueError(
                        f"{name} already registered as {m.kind}")
                if m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"{name} already registered with labels "
                        f"{m.labelnames}")
                want = kw.get("buckets")
                if want is not None and tuple(
                        sorted(float(b) for b in want)) != m.buckets:
                    # a silently-ignored bucket layout would hand the
                    # second caller coarse data with no signal
                    raise ValueError(
                        f"{name} already registered with buckets "
                        f"{m.buckets}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def metrics(self) -> list[Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every metric (tests / per-section bench isolation)."""
        for m in self.metrics():
            m.clear()

    # -- exposition ----------------------------------------------------------

    def snapshot(self, prefix: str = "",
                 compact: bool = False) -> dict:
        """A JSON-able {name: {labels-json: value}} dict. Histograms
        report {count, sum, avg} when compact, full bucket maps
        otherwise. Unlabeled series use the empty-string label key."""
        out: dict = {}
        for m in self.metrics():
            if prefix and not m.name.startswith(prefix):
                continue
            series: dict = {}
            for key, child in m.children():
                lk = ",".join(f"{n}={v}"
                              for n, v in zip(m.labelnames, key))
                if m.kind == "histogram":
                    with child._lock:
                        cnt, tot = child.count, child.sum
                        counts = list(child.counts)
                    if compact:
                        series[lk] = {
                            "count": cnt, "sum": round(tot, 6),
                            "avg": round(tot / cnt, 6) if cnt else 0.0}
                    else:
                        series[lk] = {
                            "count": cnt, "sum": tot,
                            "buckets": dict(zip(
                                [str(b) for b in m.buckets] + ["+Inf"],
                                counts))}
                else:
                    series[lk] = child.value
            # skip all-zero counter/histogram series in compact mode:
            # the BENCH meta should carry what a section exercised,
            # not the catalog. Gauges are ALWAYS kept — a gauge at 0
            # (budget drained, no active streams) is meaningful state,
            # and /healthz consumers must see it, not a vanished key.
            if compact and m.kind != "gauge":
                series = {k: v for k, v in series.items()
                          if (v.get("count") if isinstance(v, dict)
                              else v)}
                if not series:
                    continue
            out[m.name] = series
        return out

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (0.0.4). HELP/TYPE
        lines are emitted for every registered metric — a scraper sees
        the full catalog even before a labeled series materializes."""
        lines: list[str] = []
        for m in self.metrics():
            lines.append(f"# HELP {m.name} {_esc_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, child in m.children():
                labels = _fmt_labels(m.labelnames, key)
                if m.kind == "histogram":
                    with child._lock:
                        counts = list(child.counts)
                        tot, cnt = child.sum, child.count
                    cum = 0
                    for b, c in zip(m.buckets, counts):
                        cum += c
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(m.labelnames, key, le=_fmt(b))}"
                            f" {cum}")
                    cum += counts[-1]
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(m.labelnames, key, le='+Inf')}"
                        f" {cum}")
                    lines.append(f"{m.name}_sum{labels} {_fmt(tot)}")
                    lines.append(f"{m.name}_count{labels} {cnt}")
                else:
                    lines.append(f"{m.name}{labels} "
                                 f"{_fmt(child.value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
    return repr(float(v))


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(names: tuple, values: tuple, **extra) -> str:
    pairs = [f'{n}="{_esc_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_esc_label(v)}"' for n, v in extra.items()]
    return "{" + ",".join(pairs) + "}" if pairs else ""


# -- the process-wide default registry ---------------------------------------

REGISTRY = Registry()


def counter(name: str, help: str, labelnames=()) -> Counter:  # noqa: A002
    return REGISTRY.register(Counter, name, help, labelnames)


def gauge(name: str, help: str, labelnames=()) -> Gauge:  # noqa: A002
    return REGISTRY.register(Gauge, name, help, labelnames)


def histogram(name: str, help: str, labelnames=(),  # noqa: A002
              buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.register(Histogram, name, help, labelnames,
                             buckets=buckets)


def snapshot(prefix: str = "", compact: bool = False) -> dict:
    return REGISTRY.snapshot(prefix=prefix, compact=compact)


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def reset() -> None:
    REGISTRY.reset()


# ---------------------------------------------------------------------------
# HTTP exposition: /metrics (Prometheus text) + /healthz (status JSON)
# ---------------------------------------------------------------------------

def serve_metrics(port: int, host: str = "127.0.0.1",
                  registry: Registry | None = None,
                  healthz: Callable[[], dict] | None = None):
    """Start a daemon-thread HTTP listener serving ``/metrics``
    (Prometheus text, content-type text/plain; version=0.0.4) and
    ``/healthz`` (the JSON from ``healthz()`` — the service passes its
    ``status()``; default ``{"ok": true}``). Returns the server; port
    0 picks a free one (``server.server_address[1]``).

    Binds loopback by default, matching the service socket's posture —
    /healthz carries run names, store paths, and quarantine error
    tails, none of which belong on every interface unasked. Pass
    ``host="0.0.0.0"`` (CLI: ``--metrics-host``) to expose to a
    remote Prometheus deliberately."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else REGISTRY

    class _Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass   # scrapes must not spam stderr

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                return self._send(
                    200, reg.prometheus_text().encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
            if path == "/healthz":
                try:
                    body = healthz() if healthz is not None \
                        else {"ok": True}
                except Exception as e:  # noqa: BLE001 — health must answer
                    return self._send(
                        500, json.dumps({"ok": False,
                                         "error": str(e)}).encode(),
                        "application/json")
                return self._send(200, json.dumps(body).encode(),
                                  "application/json")
            return self._send(404, b"not found", "text/plain")

    server = ThreadingHTTPServer((host, int(port)), _Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="jepsen-metrics")
    t.start()
    return server



# ---------------------------------------------------------------------------
# torch.profiler hooks (JEPSEN_TPU_PROFILE=<dir>)
# ---------------------------------------------------------------------------

_profiler_lock = threading.Lock()
_profiler = None                # guarded-by: _profiler_lock


def profile_dir() -> str | None:
    return os.environ.get(PROFILE_ENV) or None


def _ensure_profiler() -> bool:
    """Start the one process-wide torch.profiler trace on first use
    (exported and stopped at exit). False when the env var is unset or
    the profiler is unavailable; callers then skip annotations too."""
    global _profiler
    d = profile_dir()
    if not d:
        return False
    if _profiler is not None:  # double-checked fast path
        return True
    with _profiler_lock:
        if _profiler is not None:
            return True
        try:
            import atexit

            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            atexit.register(stop_profiler)
            _profiler = prof
        except Exception:  # noqa: BLE001 — profiling is best-effort
            return False
    return True


def stop_profiler() -> None:
    """Stop the trace and write it as ``trace-<pid>.json`` (Chrome trace
    format) into the profile directory."""
    global _profiler
    with _profiler_lock:
        prof, _profiler = _profiler, None
        if prof is None:
            return
        try:
            prof.stop()
            d = profile_dir()
            if d:
                os.makedirs(d, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(d, f"trace-{os.getpid()}.json"))
        except Exception:  # noqa: BLE001 — already stopped / torn down
            pass


@contextlib.contextmanager
def profile_section(name: str):
    """Wrap a device section in a named ``torch.profiler``
    ``record_function`` range when JEPSEN_TPU_PROFILE is set; a strict
    no-op otherwise (no profiler start)."""
    if not _ensure_profiler():
        yield
        return
    try:
        import torch
        rf = torch.profiler.record_function(name)
    except Exception:  # noqa: BLE001 — profiling is best-effort
        yield
        return
    with rf:
        yield
