"""Test persistence: run directories, history/results serialization.

The port's own copy of `jepsen_tpu/store.py` (reference
`jepsen/src/jepsen/store.clj`): runs live under
``store/<test-name>/<date>/`` with ``latest``/``current`` symlinks, a
two-phase save (history before analysis, results after), per-run
logging, the interpreter's write-ahead journal (`Journal`,
`JournalTail`, `read_journal`), the service's handoff files next to it
(streamed results, resume manifests with carry checkpoints, the
store-level service epoch), and `tests` / `load_test` for scanning and
reloading runs. The file formats are the JAX package's, so a run either
package wrote is read by the other.
"""

from __future__ import annotations

import collections as _collections
import datetime as _dt
import gzip
import json
import logging
import os
import threading as _threading
import zipfile
from typing import Any, Callable, Iterable

from .history import INFO, NEMESIS, History, history

log = logging.getLogger(__name__)

DEFAULT_BASE = "store"


def base_dir(test) -> str:
    return test.get("store-dir") or DEFAULT_BASE


def dir_name(test) -> str:
    """The directory for this test run: <base>/<name>/<start-time>."""
    name = test.get("name", "noname")
    start = test.get("start-time") or "unknown"
    return os.path.join(base_dir(test), str(name), str(start))


def path(test, *components) -> str:
    """A path inside the test's store directory."""
    return os.path.join(dir_name(test), *[str(c) for c in components])


def make_path(test, *components) -> str:
    """path(), creating parent directories."""
    p = path(test, *components)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    return p


def start_time() -> str:
    return _dt.datetime.now().strftime("%Y%m%dT%H%M%S.%f%z")


def update_symlinks(test) -> None:
    """Point <base>/<name>/latest and <base>/latest at this run
    (reference store.clj:316-343)."""
    d = dir_name(test)
    if not os.path.isdir(d):
        return
    for link in (os.path.join(base_dir(test), str(test.get("name", "noname")),
                              "latest"),
                 os.path.join(base_dir(test), "latest")):
        try:
            if os.path.islink(link):
                os.unlink(link)
            os.symlink(os.path.abspath(d), link)
        except OSError:
            pass


# -- serialization ----------------------------------------------------------

def _json_default(o: Any):
    import numpy as np
    if isinstance(o, (set, frozenset, tuple)):
        return list(o)
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, BaseException):
        return {"class": type(o).__name__, "message": str(o)}
    return repr(o)


def write_history(test, hist: Iterable[dict]) -> str:
    """Write history.jsonl.gz — one op per line (replaces the reference's
    Fressian binary history, store.clj:360)."""
    p = make_path(test, "history.jsonl.gz")
    with gzip.open(p, "wt") as fh:
        for op in hist:
            fh.write(json.dumps(op, default=_json_default) + "\n")
    return p


def read_history(p: str) -> History:
    """Parse a history.jsonl.gz file."""
    with gzip.open(p, "rt") as fh:
        return history(json.loads(line) for line in fh if line.strip())


def load_history(test) -> History:
    return read_history(path(test, "history.jsonl.gz"))


# -- write-ahead op journal -------------------------------------------------
#
# Faults are injected on purpose, so the harness itself must survive
# them: a SIGKILL'd or crashed run may never reach save_1, and a lost
# history cannot be regenerated (checking always can be re-run).
# The interpreter therefore appends every history op to journal.jsonl
# as it happens; read_journal replays the surviving prefix.

JOURNAL_FLUSH_INTERVAL_S = 0.25


class Journal:
    """Append-only write-ahead log of ops, one JSON object per line.

    append() is called from the interpreter's scheduler hot path, so it
    only enqueues the op (a lock-free deque push); a background writer
    thread serializes and writes the queue every flush interval. :info
    and nemesis ops — the ops a post-mortem most needs, crashes and
    fault transitions — are drained and flushed *synchronously* on
    append. flush() pushes data to the OS, so the journal survives the
    *process* dying at any moment; it does not fsync, so a kernel panic
    may still lose the last interval's ops."""

    def __init__(self, path: str,
                 flush_interval_s: float = JOURNAL_FLUSH_INTERVAL_S):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.flush_interval_s = flush_interval_s
        self._fh = open(path, "a", buffering=64 * 1024)  # guarded-by: _io
        self._buf: _collections.deque = _collections.deque()
        self._io = _threading.Lock()
        self._closed = False
        self._wake = _threading.Event()
        self._subs: list = []           # guarded-by: _sub_lock
        # guards subscriber notification: unsubscribe() takes it too,
        # so unsubscription is SYNCHRONOUS — once it returns, no
        # callback can still be in flight (an async remove raced the
        # notify loop's list snapshot and delivered one late op)
        self._sub_lock = _threading.RLock()
        self._writer = _threading.Thread(
            target=self._write_loop, name="jepsen-journal", daemon=True)
        self._writer.start()

    def subscribe(self, fn) -> Callable[[], None]:
        """Register fn(op), called synchronously with every appended op
        (the live feed for online/streaming checkers — no disk
        round-trip, no flush-interval lag). fn runs on the appending
        thread (the interpreter's scheduler), so it must be cheap: a
        queue push, not a device dispatch. A subscriber that raises is
        dropped, loudly — a broken consumer must never abort the run.
        Returns an unsubscribe thunk. Unsubscription is synchronous:
        the thunk waits out any in-flight delivery (it must not be
        called while holding a lock the callbacks need), so after it
        returns fn will never be called again."""
        with self._sub_lock:
            self._subs.append(fn)

        def unsubscribe() -> None:
            with self._sub_lock:
                try:
                    self._subs.remove(fn)
                except ValueError:
                    pass
        return unsubscribe

    def append(self, op: dict) -> None:
        if self._closed:
            return
        with self._sub_lock:
            for fn in list(self._subs):
                if fn not in self._subs:
                    continue  # unsubscribed by an earlier callback
                try:
                    fn(op)
                except Exception:  # noqa: BLE001 — see subscribe()
                    log.warning("journal subscriber %r failed; "
                                "dropping it", fn, exc_info=True)
                    try:
                        self._subs.remove(fn)
                    except ValueError:
                        pass
        self._buf.append(op)
        if op.get("type") == INFO or op.get("process") == NEMESIS:
            self.flush()

    def flush(self) -> None:
        with self._io:
            self._drain_locked()

    def _drain_locked(self) -> None:  # holds: _io
        if self._fh is None:
            return
        try:
            while True:
                try:
                    op = self._buf.popleft()
                except IndexError:
                    break
                self._fh.write(
                    json.dumps(op, default=_json_default) + "\n")
            self._fh.flush()
        except (OSError, ValueError) as e:
            # the WAL is best-effort protection and must never abort an
            # otherwise-healthy run (a full disk would otherwise kill
            # the run from inside the scheduler). Disable journaling,
            # loudly, and let the run finish — its in-memory history
            # still reaches save_1.
            log.warning("journal %s failed (%s); disabling the "
                        "write-ahead journal for this run", self.path, e)
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
            self._buf.clear()

    def _write_loop(self) -> None:
        while not self._closed:
            self._wake.wait(self.flush_interval_s)
            with self._io:
                if self._fh is None:
                    return
                self._drain_locked()

    def close(self) -> None:
        self._closed = True
        self._wake.set()  # let the writer exit promptly
        with self._io:
            self._drain_locked()
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError as e:
                    log.warning("journal %s close failed: %s",
                                self.path, e)
                self._fh = None


def journal_path(test) -> str:
    return path(test, "journal.jsonl")


def open_journal(test) -> Journal | None:
    """A Journal in the test's store directory, or None when the test
    has no prepared store identity (interpreter-only runs without a
    name/start-time journal nowhere rather than littering ./store)."""
    if not (test.get("name") and test.get("start-time")):
        return None
    j = Journal(make_path(test, "journal.jsonl"))
    # a run killed before save_1 should still be `latest` for salvage
    update_symlinks(test)
    return j


def read_journal(p: str) -> History:
    """Replay a journal into a History, tolerating a torn final line (a
    crash can land mid-write; the readable prefix is still a checkable
    history). Corruption anywhere *before* the final line is real
    damage, not a torn write, and raises ValueError."""
    with open(p) as fh:
        lines = fh.read().split("\n")
    ops: list = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            ops.append(json.loads(line))
        except ValueError as e:
            if any(rest.strip() for rest in lines[i + 1:]):
                raise ValueError(
                    f"{p}: corrupt journal line {i + 1} "
                    f"(not the final line): {e}") from e
            break  # torn final line: keep the prefix
    return history(ops)


class JournalTail:
    """Tail-follow reader of a journal.jsonl another thread/process is
    still appending to — the out-of-process feed for online checking
    (the in-process feed is Journal.subscribe). poll() returns the ops
    whose lines have *completely* landed since the last poll; a torn
    trailing line (the writer mid-write, or mid-OS-flush) is buffered
    until the rest of it arrives, so a consumer polling a live journal
    never sees a parse error for an op that is still being written. A
    corrupt line that HAS been completed (newline present) is real
    damage and raises ValueError, mirroring read_journal.

    Idle backoff: re-polling a quiet journal at a fixed interval is
    cheap for one tail and ruinous for a service tailing hundreds of
    dormant runs. Each empty poll advances `idle_s` down
    `util.backoff`'s decorrelated-jitter schedule (capped);
    any poll that returns data (or buffers a torn tail — the writer
    is mid-line, so it is NOT idle) resets it to zero. Pollers sleep
    `tail.idle_s` between polls: zero while data flows, jittered up
    to `idle_cap_s` once the run goes quiet."""

    def __init__(self, path: str, idle_base_s: float = 0.05,
                 idle_cap_s: float = 1.0, rng=None):
        self.path = path
        self._pos = 0
        self._buf = ""
        self.idle_s = 0.0
        self._idle_base_s = idle_base_s
        self._idle_cap_s = idle_cap_s
        self._rng = rng
        self._delays = None
        self._closed = False

    def close(self) -> None:
        """Retire the tail: drop the torn-line buffer and make every
        later poll() a no-op. poll() opens the journal per call (no
        persistent fd to leak), so close() exists for the CONSUMER
        side — a service dropping a finished run's tail must not race
        a concurrent poller into re-feeding buffered ops."""
        self._closed = True
        self._buf = ""
        self._delays = None
        self.idle_s = self._idle_cap_s

    def _note_idle(self, active: bool) -> None:
        if active:
            self.idle_s = 0.0
            self._delays = None
            return
        if self._delays is None:
            from .util import backoff
            self._delays = backoff(self._idle_base_s,
                                   self._idle_cap_s, self._rng)
        self.idle_s = next(self._delays)

    def poll(self) -> list[dict]:
        if self._closed:
            return []
        try:
            with open(self.path) as fh:
                fh.seek(self._pos)
                data = fh.read()
                self._pos = fh.tell()
        except FileNotFoundError:
            self._note_idle(False)
            return []
        if not data:
            self._note_idle(False)
            return []
        self._note_idle(True)
        self._buf += data
        lines = self._buf.split("\n")
        self._buf = lines.pop()   # incomplete tail (or "")
        out = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError as e:
                raise ValueError(
                    f"{self.path}: corrupt journal line (newline-"
                    f"terminated, so not a torn tail): {e}") from e
        return out


def load_journal(test) -> History | None:
    """The journal-backed history for a test, or None if no journal was
    ever written."""
    p = journal_path(test)
    if not os.path.exists(p):
        return None
    return read_journal(p)


# -- verification-service handoff -------------------------------------------
#
# A long-lived verification service (`service.py`) owns no
# histories: the run's journal is the source of truth, and the service
# leaves its own state NEXT TO it so anyone can pick the run up —
# `analyze` reads streamed-results.json like core.run's in-memory
# streamed results, and a restarted service resumes device work from
# resume.json's carry checkpoints instead of recomputing.

SERVICE_SUBDIR = "service"
STREAMED_RESULTS_FILE = "streamed-results.json"


def _service_dir(run_dir: str) -> str:
    return os.path.join(run_dir, SERVICE_SUBDIR)


def write_streamed_results(run_dir: str, results: dict) -> str:
    """Flush a service's per-run verdicts (complete or partial) into
    the run's store directory; load_test surfaces them as
    'streamed-results' so the checkers' reuse guards see exactly what
    an in-process online run would have stashed."""
    os.makedirs(run_dir, exist_ok=True)
    p = os.path.join(run_dir, STREAMED_RESULTS_FILE)
    # tmp-then-rename (the write_service_resume idiom): this file's
    # very EXISTENCE means "verdict delivered" to recover()'s orphan
    # scan and to concurrent pollers — a torn write would read as an
    # empty verdict (found by the chaos harness's verdict poller
    # racing a shed's deferred flush)
    tmp = f"{p}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(results, fh, indent=2, default=_json_default)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, p)
    return p


def load_streamed_results(run_dir: str) -> dict | None:
    p = os.path.join(run_dir, STREAMED_RESULTS_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as fh:
        return json.load(fh)


def write_service_resume(run_dir: str, manifest: dict) -> str:
    """Persist a service's resume manifest for one run — at drain,
    and periodically at every carry-checkpoint cycle, so a SIGKILL'd
    daemon recovers from its last durable checkpoint. Checkpoint
    entries under manifest['checkpoints'] may carry a 'carry' list of
    arrays; they are split out into .npz files next to resume.json
    (JSON-ing device carries would be both huge and lossy) and
    rejoined by load_service_resume.

    Atomicity (the calibrate.py idiom, multiplied out for the
    json+npz pair): each carry file is written under a pid-unique tmp
    name and renamed into a chunk-versioned final name, and
    resume.json — which references the carries by those versioned
    names — is tmp-then-renamed LAST. A crash at any point leaves
    either the previous consistent (json, npz) pair or the new one,
    never a manifest pointing at a half-written carry. Stale carry
    versions are pruned only after the manifest lands."""
    import numpy as np
    d = _service_dir(run_dir)
    os.makedirs(d, exist_ok=True)
    man = dict(manifest)
    cks = {}
    fresh: set[str] = set()
    for target, ck in (manifest.get("checkpoints") or {}).items():
        ck = dict(ck)
        carry = ck.pop("carry", None)
        if carry is not None:
            safe = str(target).replace(os.sep, "_")
            fn = f"{safe}.carry.c{int(ck.get('chunks', 0))}.npz"
            tmp = os.path.join(d, f"{fn}.{os.getpid()}.tmp")
            with open(tmp, "wb") as fh:
                np.savez(fh, *[np.asarray(a) for a in carry])
            os.replace(tmp, os.path.join(d, fn))
            ck["carry-file"] = fn
            fresh.add(fn)
        cks[target] = ck
    man["checkpoints"] = cks
    p = os.path.join(d, "resume.json")
    tmp = f"{p}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(man, fh, indent=2, default=_json_default)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, p)
    for fn in os.listdir(d):
        # superseded carry versions and orphaned tmps from a crashed
        # writer; the manifest's own references were just renamed in
        if (".carry." in fn or fn.endswith(".tmp")) \
                and fn not in fresh:
            try:
                os.unlink(os.path.join(d, fn))
            except OSError:
                pass
    return p


def load_service_resume(run_dir: str) -> dict | None:
    """The resume manifest for a run, with carry arrays rejoined, or
    None when no service ever checkpointed here. Mirrors
    calibrate.Calibration.load's posture on damage: a corrupt or
    truncated resume.json returns None (the stream re-checks cold
    from its journal), and a corrupt/missing carry .npz drops only
    that target's checkpoint — a bad file must never stop the
    daemon."""
    import numpy as np
    p = os.path.join(_service_dir(run_dir), "resume.json")
    if not os.path.exists(p):
        return None
    try:
        with open(p) as fh:
            man = json.load(fh)
        if not isinstance(man, dict):
            raise ValueError(f"expected a json object, got "
                             f"{type(man).__name__}")
    except (OSError, ValueError) as e:
        log.warning("%s: corrupt resume manifest (%s); the stream "
                    "will re-check cold from its journal", p, e)
        return None
    cks = man.get("checkpoints")
    if not isinstance(cks, dict):
        man["checkpoints"] = {}
        return man
    for target in list(cks):
        ck = cks[target]
        if not isinstance(ck, dict):
            del cks[target]
            continue
        fn = ck.pop("carry-file", None)
        if not fn:
            continue
        try:
            with np.load(os.path.join(_service_dir(run_dir),
                                      os.path.basename(fn))) as z:
                ck["carry"] = [
                    z[k] for k in sorted(
                        z.files, key=lambda s: int(s.split("_")[-1]))]
        except (OSError, ValueError, EOFError,
                zipfile.BadZipFile) as e:
            log.warning("%s: corrupt carry checkpoint %s for %r (%s);"
                        " that target resumes cold", p, fn, target, e)
            del cks[target]
    return man


def clear_service_resume(run_dir: str) -> None:
    """Drop a consumed resume manifest (a finished resume must not be
    resumed twice)."""
    import shutil
    d = _service_dir(run_dir)
    if os.path.isdir(d):
        shutil.rmtree(d, ignore_errors=True)


# -- store-level service epoch (replica fencing) ----------------------------
#
# One monotonic integer per store root, bumped by every service
# instance that takes ownership of the store (cold-start recovery, or
# a standby promoting over a dead primary). A fenced-out instance —
# one whose claimed epoch no longer matches the file — must stop
# persisting checkpoints and verdicts: the classic split-brain guard,
# so a zombie primary cannot clobber the new owner's state.

SERVICE_EPOCH_FILE = "service.epoch"


def service_epoch(base: str) -> int:
    """The store's current service epoch (0 when never claimed; a
    corrupt epoch file reads as 0 — claiming bumps past it)."""
    try:
        with open(os.path.join(base, SERVICE_EPOCH_FILE)) as fh:
            return int(fh.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def fence_service_epoch(base: str) -> int:
    """Bump the store's service epoch (atomic tmp-then-rename) and
    return the new value — the caller now owns the store, and any
    instance still holding the previous epoch is fenced."""
    os.makedirs(base, exist_ok=True)
    epoch = service_epoch(base) + 1
    p = os.path.join(base, SERVICE_EPOCH_FILE)
    tmp = f"{p}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        fh.write(f"{epoch}\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, p)
    return epoch


def write_results(test, results: dict) -> str:
    p = make_path(test, "results.json")
    with open(p, "w") as fh:
        json.dump(results, fh, indent=2, default=_json_default)
    return p


def load_results(test) -> dict:
    with open(path(test, "results.json")) as fh:
        return json.load(fh)


def save_1(test) -> dict:
    """Phase 1: persist the test map + history before analysis, so crashed
    analyses still leave the history on disk (reference save-1!,
    store.clj:388)."""
    write_history(test, test.get("history", []))
    meta = {k: v for k, v in test.items()
            if k not in ("history", "results") and _plain(v)}
    p = make_path(test, "test.json")
    with open(p, "w") as fh:
        json.dump(meta, fh, indent=2, default=_json_default)
    update_symlinks(test)
    return test


def save_2(test) -> dict:
    """Phase 2: persist analysis results (reference save-2!, store.clj:401)."""
    write_results(test, test.get("results", {}))
    update_symlinks(test)
    return test


def _plain(v) -> bool:
    return isinstance(v, (str, int, float, bool, list, tuple, dict,
                          type(None)))


def tests(base: str = DEFAULT_BASE) -> dict:
    """Map of test name -> {start-time -> run dir} for all stored runs
    (reference store.clj:284)."""
    out: dict = {}
    if not os.path.isdir(base):
        return out
    for name in sorted(os.listdir(base)):
        d = os.path.join(base, name)
        if not os.path.isdir(d) or name == "latest":
            continue
        runs = {t: os.path.join(d, t) for t in sorted(os.listdir(d))
                if not t.startswith("latest")
                and os.path.isdir(os.path.join(d, t))}
        if runs:
            out[name] = runs
    return out


def latest(base: str = DEFAULT_BASE) -> str | None:
    link = os.path.join(base, "latest")
    return os.path.realpath(link) if os.path.islink(link) else None


def delete(base: str = DEFAULT_BASE, name: str | None = None) -> None:
    """Delete stored runs (reference store.clj:470)."""
    import shutil
    target = os.path.join(base, name) if name else base
    if os.path.isdir(target):
        shutil.rmtree(target)


# -- logging bootstrap ------------------------------------------------------
#
# Reference store.clj:431-459 (unilog): each run logs to its own
# <dir>/jepsen.log in addition to the console, optionally as JSON.

_log_handler = None
_log_lock = _threading.Lock()

LOG_FORMAT = "%(asctime)s{%(threadName)s} %(levelname)s [%(name)s] %(message)s"


class _JsonFormatter(logging.Formatter):
    def format(self, record):
        out = {
            "time": self.formatTime(record),
            "thread": record.threadName,
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        if record.stack_info:
            out["stack"] = self.formatStack(record.stack_info)
        return json.dumps(out)


def _coerce_level(level) -> int:
    if isinstance(level, int):
        return level
    s = str(level)
    return int(s) if s.isdigit() else \
        getattr(logging, s.upper(), logging.INFO)


# levels to restore on stop: [(logger-name-or-None-for-root, level)]
_saved_levels: list = []


def start_logging(test) -> None:
    """Route the root logger into this run's jepsen.log
    (reference start-logging!, store.clj:431-453). Honors
    test['logging']['json?'] and per-logger overrides."""
    global _log_handler
    if not test.get("name"):
        return
    with _log_lock:
        stop_logging()
        opts = test.get("logging") or {}
        h = logging.FileHandler(make_path(test, "jepsen.log"))
        h.setFormatter(_JsonFormatter() if opts.get("json?")
                       else logging.Formatter(LOG_FORMAT))
        root = logging.getLogger()
        if root.level > logging.INFO or root.level == logging.NOTSET:
            _saved_levels.append((None, root.level))
            root.setLevel(logging.INFO)
        for name, level in (opts.get("overrides") or {}).items():
            logger = logging.getLogger(name)
            _saved_levels.append((name, logger.level))
            logger.setLevel(_coerce_level(level))
        root.addHandler(h)
        _log_handler = h


def stop_logging() -> None:
    global _log_handler
    if _log_handler is not None:
        logging.getLogger().removeHandler(_log_handler)
        _log_handler.close()
        _log_handler = None
    while _saved_levels:
        name, level = _saved_levels.pop()
        logging.getLogger(name).setLevel(level)


def load_test(d: str) -> dict:
    """Reconstruct a test map (with history and, when present, results)
    from a run directory — the post-hoc analysis path (reference
    store/load, store.clj:193-250).

    Salvage path: a run killed mid-history may have died before save_1,
    leaving neither test.json nor history.jsonl.gz. The test identity
    is then reconstructed from the <base>/<name>/<start-time> layout
    and the history replayed from the write-ahead journal; such tests
    carry 'salvaged-from-journal': True."""
    # realpath, not normpath: callers pass the `latest` symlink, and the
    # salvage fallback below reads name/start-time out of the path
    d = os.path.realpath(d)
    tj = os.path.join(d, "test.json")
    have_test_json = os.path.exists(tj)
    if have_test_json:
        with open(tj) as fh:
            test = json.load(fh)
    else:
        test = {"name": os.path.basename(os.path.dirname(d)),
                "start-time": os.path.basename(d)}
    hist_path = os.path.join(d, "history.jsonl.gz")
    if os.path.exists(hist_path):
        # save_1 runs pre-analysis, so the stored history carries no
        # 'index' fields; index here so index-dependent consumers
        # (timeline anchors, linearizability reports) work post-hoc
        test["history"] = read_history(hist_path).index()
    else:
        jp = os.path.join(d, "journal.jsonl")
        if os.path.exists(jp):
            log.warning("%s: no history.jsonl.gz; salvaging history "
                        "from the write-ahead journal", d)
            test["history"] = read_journal(jp).index()
            test["salvaged-from-journal"] = True
        elif not have_test_json:
            # nothing to reconstruct from — fail clearly instead of
            # fabricating an identity for a wrong/empty directory
            raise FileNotFoundError(
                f"{d}: no test.json, history.jsonl.gz, or journal.jsonl"
                " — not a test run directory")
    res_path = os.path.join(d, "results.json")
    if os.path.exists(res_path):
        with open(res_path) as fh:
            test["results"] = json.load(fh)
    sr = load_streamed_results(d)
    if sr is not None:
        # a verification service checked this run: its verdicts ride
        # the same reuse guards as core.run's in-memory streamed
        # results (analyze adopts covered targets, re-checks the rest)
        test["streamed-results"] = sr
    return test
