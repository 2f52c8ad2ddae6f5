"""Distributed tracing for the checking pipeline.

The port's own copy of `jepsen_tpu/trace.py` (host code only). A tracer
is a contextvar-scoped span stack: `span("name")` opens a scoped span,
`annotate` / `attribute` decorate the current span, and `context()`
returns the {span-id, trace-id} map a verdict can carry.

Finished spans are recorded Jaeger-JSON-shaped and exported either to
an in-memory buffer (always), a JSONL file (endpoint = a filesystem
path), or an HTTP collector (endpoint = http(s) URL, posted best-effort
in Jaeger's /api/traces JSON format). Sampling is enabled iff an
endpoint is configured.

HTTP export is asynchronous: finished spans land in a bounded queue
drained in batches by a daemon flusher thread, so a slow or unreachable
collector never stalls span creation on the hot path. `close()`
performs a final flush; a full queue drops the oldest spans and counts
them in `jepsen_tpu_trace_dropped_total`.

Cross-thread spans: `span(name, parent=ctx)` (and the manual
`start_span`/`finish_span` pair for long-lived spans) accept an explicit
`{"trace-id": ..., "span-id": ...}` parent context, so one trace id can
thread stream -> chunk -> recovery-retry across the checker's worker
threads (`checker/streaming.py` stamps the resulting trace id on stream
verdicts)."""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import json
import random
import threading
import time
import urllib.request
from typing import Any

from . import telemetry

_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "trace_stack", default=())

# export tuning: the queue bounds memory under a dead collector; the
# flusher posts at most BATCH spans per request
EXPORT_QUEUE_LIMIT = 4096
EXPORT_BATCH = 256
EXPORT_TIMEOUT_S = 1.0

_M_SPANS = telemetry.counter(
    "jepsen_tpu_trace_spans_total",
    "Finished spans recorded by the tracer")
_M_DROPPED = telemetry.counter(
    "jepsen_tpu_trace_dropped_total",
    "Spans dropped because the HTTP export queue was full")
_M_FLUSH = telemetry.histogram(
    "jepsen_tpu_trace_flush_seconds",
    "HTTP collector POST latency per span batch")


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_us",
                 "duration_us", "tags", "logs", "_t0")

    def __init__(self, name: str, trace_id: str, parent_id: str | None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = f"{random.getrandbits(64):016x}"
        self.parent_id = parent_id
        self.start_us = int(time.time() * 1e6)
        self.duration_us = 0
        self.tags: dict[str, str] = {}
        self.logs: list[dict] = []
        self._t0 = time.monotonic()

    def context(self) -> dict:
        return {"span-id": self.span_id, "trace-id": self.trace_id}

    def to_jaeger(self) -> dict:
        """One span in Jaeger JSON shape."""
        return {
            "traceID": self.trace_id,
            "spanID": self.span_id,
            "parentSpanID": self.parent_id or "",
            "operationName": self.name,
            "startTime": self.start_us,
            "duration": self.duration_us,
            "tags": [{"key": k, "type": "string", "value": v}
                     for k, v in self.tags.items()],
            "logs": self.logs,
            "process": {"serviceName": "jepsen"},
        }


def _new_trace_id() -> str:
    return f"{random.getrandbits(128):032x}"


class Tracer:
    """Sampler + exporter. `endpoint=None` disables sampling — spans
    become no-ops, mirroring `Samplers/neverSample`
    (`trace.clj:9-14`)."""

    def __init__(self, endpoint: str | None = None,
                 buffer_limit: int = 100_000):
        self.endpoint = endpoint
        self.enabled = endpoint is not None
        self.buffer: list[dict] = []    # guarded-by: lock
        self.buffer_limit = buffer_limit
        self.lock = threading.Lock()
        self._file = None               # guarded-by: lock
        self._http = False
        self._q: collections.deque = collections.deque()  # guarded-by: lock
        self._q_event = threading.Event()
        self._stop = threading.Event()
        self._flusher: threading.Thread | None = None
        if self.enabled:
            if str(endpoint).startswith(("http://", "https://")):
                self._http = True
                self._flusher = threading.Thread(
                    target=self._flush_loop, name="jepsen-trace-flush",
                    daemon=True)
                self._flusher.start()
            else:
                self._file = open(endpoint, "a", encoding="utf8")  # noqa: SIM115 — long-lived exporter

    # -- span lifecycle ------------------------------------------------------

    def _make_span(self, name: str, parent: dict | None) -> Span:
        if parent is not None and parent.get("trace-id"):
            return Span(name, parent["trace-id"],
                        parent.get("span-id"))
        stack = _stack.get()
        psp = stack[-1] if stack else None
        trace_id = psp.trace_id if psp else _new_trace_id()
        return Span(name, trace_id, psp.span_id if psp else None)

    @contextlib.contextmanager
    def span(self, name: str, parent: dict | None = None):
        """Scoped span (the `with-trace` macro, `trace.clj:40-49`).
        `parent` overrides the contextvar stack with an explicit
        {"trace-id", "span-id"} context — the cross-thread form."""
        if not self.enabled:
            yield None
            return
        sp = self._make_span(name, parent)
        token = _stack.set(_stack.get() + (sp,))
        try:
            yield sp
        finally:
            sp.duration_us = int((time.monotonic() - sp._t0) * 1e6)
            _stack.reset(token)
            self._record(sp)

    def start_span(self, name: str,
                   parent: dict | None = None) -> Span | None:
        """Open a long-lived span WITHOUT entering the contextvar
        stack (a stream worker owns it across many feed calls); pair
        with finish_span. None when sampling is off."""
        if not self.enabled:
            return None
        return self._make_span(name, parent)

    def finish_span(self, sp: Span | None) -> None:
        if sp is None or not self.enabled:
            return
        sp.duration_us = int((time.monotonic() - sp._t0) * 1e6)
        self._record(sp)

    def new_context(self) -> dict:
        """A fresh root trace context (no parent span) — the anchor a
        run/stream uses when nothing upstream opened a span. The null
        context when sampling is off."""
        if not self.enabled:
            return {"span-id": None, "trace-id": None}
        return {"span-id": None, "trace-id": _new_trace_id()}

    def current(self) -> Span | None:
        stack = _stack.get()
        return stack[-1] if stack else None

    def context(self) -> dict:
        """{span-id, trace-id} of the current span (`trace.clj:51-57`)."""
        sp = self.current()
        if sp is None:
            return {"span-id": None, "trace-id": None}
        return sp.context()

    def annotate(self, message: str) -> None:
        """`trace.clj:59-63`."""
        sp = self.current()
        if sp is not None:
            sp.logs.append({"timestamp": int(time.time() * 1e6),
                            "fields": [{"key": "message",
                                        "value": str(message)}]})

    def attribute(self, k: str, v: Any) -> None:
        """Keys and values are coerced to strings, as opencensus
        requires (`trace.clj:65-73`)."""
        sp = self.current()
        if sp is not None:
            sp.tags[str(k)] = str(v)

    # -- export --------------------------------------------------------------

    def _record(self, sp: Span) -> None:
        doc = sp.to_jaeger()
        _M_SPANS.inc()
        dropped = False
        with self.lock:
            if len(self.buffer) < self.buffer_limit:
                self.buffer.append(doc)
            if self._file is not None:
                self._file.write(json.dumps(doc) + "\n")
                self._file.flush()
            if self._http:
                # bounded enqueue, never a network call: the flusher
                # thread owns the POSTs (one lock acquisition covers
                # buffer + queue — this is the hot path)
                if len(self._q) >= EXPORT_QUEUE_LIMIT:
                    self._q.popleft()
                    dropped = True
                self._q.append(doc)
        if dropped:
            _M_DROPPED.inc()
        if self._http:
            self._q_event.set()

    def _drain(self, n: int) -> list[dict]:
        out: list[dict] = []
        with self.lock:
            while self._q and len(out) < n:
                out.append(self._q.popleft())
        return out

    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            self._q_event.wait(0.5)
            self._q_event.clear()
            docs = self._drain(EXPORT_BATCH)
            while docs:
                self._post(docs)
                docs = self._drain(EXPORT_BATCH)

    def flush(self, max_batches: int | None = None) -> None:
        """Synchronously post everything queued (close() calls this;
        tests may too), up to max_batches POSTs (None = drain fully).
        No-op for file/disabled tracers."""
        n = 0
        docs = self._drain(EXPORT_BATCH)
        while docs:
            self._post(docs)
            n += 1
            if max_batches is not None and n >= max_batches:
                return
            docs = self._drain(EXPORT_BATCH)

    def _post(self, docs: list[dict]) -> None:
        """Best-effort POST to a Jaeger-style HTTP collector, one
        request per traceID group (Jaeger's /api/traces shape nests
        spans under their trace)."""
        groups: dict[str, list[dict]] = {}
        for d in docs:
            groups.setdefault(d["traceID"], []).append(d)
        try:
            with _M_FLUSH.time():
                body = json.dumps({"data": [
                    {"traceID": tid, "spans": spans}
                    for tid, spans in groups.items()]}).encode()
                req = urllib.request.Request(
                    self.endpoint, data=body, method="POST",
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(req,
                                       timeout=EXPORT_TIMEOUT_S).close()
        except OSError:
            pass   # tracing must never fail an op

    def spans(self, name: str | None = None) -> list[dict]:
        with self.lock:
            if name is None:
                return list(self.buffer)
            return [s for s in self.buffer if s["operationName"] == name]

    def close(self) -> None:
        """Stop the flusher (after a final flush) and close the file
        sink. Bounded even against a wedged collector: when the
        flusher fails to join (it is stuck inside a POST), the queue
        is DROPPED (counted) instead of re-posted synchronously, and
        a clean join's residual flush is capped at two batches — so
        close() costs at most a couple of POST timeouts, never a
        queue-length hang on the drain/shutdown path."""
        self._stop.set()
        self._q_event.set()
        if self._flusher is not None:
            self._flusher.join(2 * EXPORT_TIMEOUT_S)
            wedged = self._flusher.is_alive()
            self._flusher = None
            if not wedged:
                self.flush(max_batches=2)
            # wedged: the flusher is stuck inside a POST — re-posting
            # synchronously would hang too; the drop below covers it
        with self.lock:
            if self._q:
                _M_DROPPED.inc(len(self._q))
                self._q.clear()
            if self._file is not None:
                self._file.close()
                self._file = None


# -- module-level default tracer (what suites import) ------------------------

_default = Tracer(None)


def _close_default() -> None:
    _default.close()


# the async exporter must not lose the tail at process exit: the old
# synchronous POST delivered every span before _record returned; the
# flusher needs one final bounded flush when the interpreter goes down
# (suites install tracing() and never close it themselves)
atexit.register(_close_default)


def tracing(endpoint: str | None) -> dict:
    """Install the default tracer for an endpoint; returns the config
    map stored on the test (`trace.clj:34-38`)."""
    global _default
    _default.close()
    _default = Tracer(endpoint)
    return {"endpoint": endpoint, "config": _default.enabled,
            "exporter": _default}


def tracer() -> Tracer:
    return _default


def span(name: str, parent: dict | None = None):
    return _default.span(name, parent=parent)


def context() -> dict:
    return _default.context()


def new_context() -> dict:
    return _default.new_context()


def annotate(message: str) -> None:
    _default.annotate(message)


def attribute(k: str, v: Any) -> None:
    _default.attribute(k, v)
