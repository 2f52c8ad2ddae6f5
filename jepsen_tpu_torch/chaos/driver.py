"""The chaos loop: schedule, execute, oracle, cover, mutate, shrink.

One chaos run is `run_chaos(ChaosConfig)`: per schedule, a genome's
backend events are installed as a `_platform.FaultSchedule` and its
lifecycle events scripted against a live `VerificationService` while a
fixed deterministic workload streams through it; after every run the
oracles (`oracles.py`) compare the outcome against the uninjected solo
verdict and the schedule the harness itself injected. Coverage bits
over (fault-kind x site x lifecycle-state) transitions
(`search.coverage.extract_chaos_coverage`) feed the corpus, so a
guided run gradients toward untrodden recovery paths — most prizedly
the fault-DURING-replay conjunction no single-fault test reaches.
Oracle failures shrink to a minimal schedule via the budgeted greedy
shrinker, `search/driver.py` style.

Execution transports:

  in-process  admit/offer/seal against VerificationService directly,
              the driver mirroring every op into the run's
              journal.jsonl (store layout) so kill-recover / failover
              / drain-resume can promote a standby that re-feeds from
              the journal — the service's crash-consistency machinery
              IS the system under test
  socket      chosen when the genome schedules a socket `drop`: the
              feed rides a ServiceClient through a drop-proxy whose
              connections the driver cuts on cue (session replay must
              make the drops invisible)

Determinism: one `random.Random(cfg.seed)` owns sampling + mutation;
the workload history derives from the genome's seed; probes are
emitted synchronously from the single worker thread. Same config ->
same search.

The port's copy of `jepsen_tpu/chaos/driver.py`: the same schedules,
oracles, probe stream and artifacts (`chaos.json`, `coverage.bin`) on
the same config, held against the port's `VerificationService` on
`ChaosConfig.device`. Each schedule's uninjected baseline stream walks
on that device before the schedule's resource snapshot, so the card's
first context is opened there and not counted as a leak.
"""

from __future__ import annotations

import dataclasses
import gc
import gzip
import json
import os
import random
import shutil
import socket as _socket
import tempfile
import threading
import time as _time
from typing import Optional

from .. import _platform, models, store, telemetry
from .._platform import pin_device
from ..checker import synth
from ..search.coverage import CoverageMap, extract_chaos_coverage
from . import genome as genome_mod
from .genome import ChaosGenome, genome_size, mutate, sample_genome
from .oracles import ORACLES, check_oracles

_M_SCHEDULES = telemetry.counter(
    "jepsen_tpu_chaos_schedules_total",
    "Chaos schedules executed against the live pipeline, by strategy",
    ("strategy",))
_M_FAILURES = telemetry.counter(
    "jepsen_tpu_chaos_oracle_failures_total",
    "Oracle failures observed (pre-shrink), by oracle", ("oracle",))
_M_COV = telemetry.gauge(
    "jepsen_tpu_chaos_coverage_bits",
    "Accumulated chaos-corpus coverage bits")
_M_CORPUS = telemetry.gauge(
    "jepsen_tpu_chaos_corpus_genomes",
    "Genomes in the chaos corpus")
_M_SHRINK = telemetry.counter(
    "jepsen_tpu_chaos_shrink_steps_total",
    "Shrink candidate re-executions")
_M_RUN_S = telemetry.histogram(
    "jepsen_tpu_chaos_schedule_seconds",
    "Wall-clock seconds per executed chaos schedule")

# guided-mode fresh-blood fraction, as in search/driver.py
FRESH_FRACTION = 0.2

# the fixed verification workload (small enough that a smoke budget of
# ~20 schedules stays in CPU seconds; sized so recovery replays span
# 1-2 chunks — the conjunction window)
_MODEL = models.cas_register()
CHUNK = 64
SLOTS = 8
FRONTIER = 128
CKPT = 2

WORKLOADS = ("register", "register-corrupt")


def workload_spec() -> dict:
    from ..service import model_spec
    return {"linear": {"kind": "wgl", "model": model_spec(_MODEL),
                       "chunk-entries": CHUNK, "slots": SLOTS,
                       "engine": "sort", "frontier": FRONTIER,
                       "checkpoint-every": CKPT}}


def workload_ops(workload: str, n: int, seed: int) -> list:
    """Deterministic journal-form ops for a genome. 'register-corrupt'
    plants one definite violation so the violation-missed oracle has
    ground truth to defend."""
    h = synth.register_history(n, concurrency=3, values=5, seed=seed)
    if workload == "register-corrupt":
        h = synth.corrupt(h, seed=7)
    elif workload != "register":
        raise ValueError(f"unknown chaos workload {workload!r}")
    return [json.loads(json.dumps(op, default=store._json_default))
            for op in h.ops]


@dataclasses.dataclass
class ChaosConfig:
    workload: str = "register"
    ops: int = 256
    budget: int = 40              # total schedule executions
    seed: int = 45100
    strategy: str = "guided"      # guided | random
    lifecycle_p: float = genome_mod.LIFECYCLE_P
    deadline_s: float = 120.0     # per-run watchdog (wedge oracle)
    stop_on_failure: bool = True
    shrink: bool = True
    store_dir: Optional[str] = None   # artifact dir (chaos.json, coverage.bin)
    scratch_dir: Optional[str] = None  # per-run store roots (tmp if None)
    # where the services and the baselines run: CUDA unless "cpu" is
    # named (None raises without a card). Not a chaos parameter:
    # chaos.json's config leaves it out, so the artifact is the JAX
    # package's
    device: Optional[str] = None


def _count_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return 0


def _settle(fds0: int, threads0: int, budget_s: float = 3.0) -> tuple:
    """Post-run resource snapshot with a settle wait: terminal worker
    threads and just-closed sockets need a beat to leave the process
    tables, and a transiently elevated count is not a leak."""
    deadline = _time.monotonic() + budget_s
    while True:
        gc.collect()
        fds, threads = _count_fds(), threading.active_count()
        if (fds <= fds0 and threads <= threads0) \
                or _time.monotonic() >= deadline:
            return fds, threads
        _time.sleep(0.05)


def replay_conjunction(probes: list) -> bool:
    """Did a fault land inside an open recovery-replay window? (The
    probe stream is worker-thread-ordered, so this is deterministic.)"""
    open_sites: set = set()
    for p in probes:
        ev = p.get("event")
        sc = str(p.get("site", "")).split("/", 1)[0]
        if ev == "replay-begin":
            open_sites.add(sc)
        elif ev == "replay-end":
            open_sites.discard(sc)
        elif ev in ("fault", "inject", "corrupt") and sc in open_sites:
            return True
    return False


class _DropProxy:
    """A TCP proxy in front of the service's unix socket whose live
    connections the driver cuts on cue — the socket-drop injector
    (the session drop-proxy, harness-side)."""

    def __init__(self, upstream_addr: str):
        self.upstream_addr = upstream_addr
        self.ls = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        self.ls.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self.ls.bind(("127.0.0.1", 0))
        self.ls.listen(16)
        self.addr = "127.0.0.1:%d" % self.ls.getsockname()[1]
        self._lock = threading.Lock()
        self._conns: list = []      # guarded-by: _lock
        self._closing = False
        self._thread = threading.Thread(
            target=self._accept, daemon=True,
            name="jepsen-chaos-proxy")
        self._thread.start()

    def _accept(self) -> None:
        while True:
            try:
                down, _ = self.ls.accept()
            except OSError:
                return
            if self._closing:       # close()'s wake-up poke
                down.close()
                return
            up = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            try:
                up.connect(self.upstream_addr)
            except OSError:
                down.close()
                continue
            with self._lock:
                self._conns.append((down, up))
            for a, b in ((down, up), (up, down)):
                threading.Thread(target=self._pump, args=(a, b),
                                 daemon=True).start()

    @staticmethod
    def _pump(src, dst) -> None:
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        for s in (src, dst):
            try:
                s.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass

    def drop_all(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, []
        for down, up in conns:
            for s in (down, up):
                try:
                    s.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass

    def close(self) -> None:
        self.drop_all()
        self._closing = True
        # accept() does not wake on close() alone; poke it
        try:
            with _socket.socket(_socket.AF_INET,
                                _socket.SOCK_STREAM) as poke:
                poke.settimeout(0.2)
                poke.connect(self.ls.getsockname())
        except OSError:
            pass
        try:
            self.ls.close()
        except OSError:
            pass
        self._thread.join(timeout=1.0)


class _Chaos:
    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        # resolved before any schedule: without a card and without
        # device="cpu" the harness refuses to start
        self.device = pin_device(cfg.device)
        self.rng = random.Random(cfg.seed)
        self.cmap = CoverageMap()
        self.corpus: list = []          # (genome, novel-bit-count)
        self._keys: set = set()
        self.curve: list = []
        self.runs = 0
        self.shrink_steps = 0
        self.failures: list = []
        self.conjunction_hits = 0
        self._baselines: dict = {}
        self._scratch = cfg.scratch_dir
        self._own_scratch = False
        self._seq = 0

    # -- plumbing ----------------------------------------------------------

    def budget_left(self) -> bool:
        return self.runs < self.cfg.budget

    def _count_run(self) -> None:
        self.runs += 1
        _M_SCHEDULES.labels(strategy=self.cfg.strategy).inc()

    def scratch(self) -> str:
        if self._scratch is None:
            self._scratch = tempfile.mkdtemp(prefix="jepsen-chaos-")
            self._own_scratch = True
        return self._scratch

    def baseline(self, g: ChaosGenome) -> dict:
        """The uninjected tier-full solo verdict for this genome's
        workload — the oracle ground truth, cached per (workload,
        ops, seed)."""
        key = (g.workload, g.ops, g.seed)
        if key not in self._baselines:
            from ..checker.streaming import WglStream
            s = WglStream(_MODEL, chunk_entries=CHUNK, slots=SLOTS,
                          frontier=FRONTIER, checkpoint_every=CKPT,
                          device=self.device)
            for op in workload_ops(g.workload, g.ops, g.seed):
                s.feed(op)
            self._baselines[key] = {"linear": s.finish()}
        return self._baselines[key]

    # -- one schedule -------------------------------------------------------

    def run_schedule(self, g: ChaosGenome) -> dict:
        """Execute one genome against a fresh service and check every
        oracle. Returns the outcome record (fired events, applied
        actions, probe stream, coverage, oracle failures)."""
        baseline = self.baseline(g)
        ops = workload_ops(g.workload, g.ops, g.seed)
        self._seq += 1
        base = os.path.join(self.scratch(), f"run{self._seq}")
        run_dir = os.path.join(base, "chaos", "0")
        os.makedirs(run_dir, exist_ok=True)

        probes: list = []
        hook_prev = _platform.probe_hook
        _platform.probe_hook = probes.append
        _platform.reset_fault_injection()
        schedule = _platform.FaultSchedule(
            [_platform.FaultEvent(e.kind, e.site, e.at)
             for e in g.backend_events()])
        _platform.install_fault_schedule(schedule)

        fds0, threads0 = _count_fds(), threading.active_count()
        socket_mode = any(e.kind == "drop"
                          for e in g.lifecycle_events())
        t0 = _time.monotonic()
        try:
            if socket_mode:
                out = self._run_socket(g, base, run_dir, ops)
            else:
                out = self._run_inproc(g, base, run_dir, ops)
        finally:
            _platform.install_fault_schedule(None)
            _platform.probe_hook = hook_prev
            _platform.reset_fault_injection()
        wall = _time.monotonic() - t0
        _M_RUN_S.observe(wall)
        fds1, threads1 = _settle(fds0, threads0)
        try:
            shutil.rmtree(base)
        except OSError:
            pass

        outcome = {
            "genome": g,
            "fired": list(schedule.fired),
            "probes": probes,
            "deadline-s": self.cfg.deadline_s,
            "wall-s": round(wall, 3),
            **out,
        }
        resources = {"fds-before": fds0, "fds-after": fds1,
                     "threads-before": threads0,
                     "threads-after": threads1}
        outcome["failures"] = check_oracles(baseline, outcome,
                                            resources)
        outcome["coverage"] = extract_chaos_coverage(
            probes, outcome.get("actions") or [])
        outcome["conjunction"] = replay_conjunction(probes)
        return outcome

    def _wait_verdict(self, svc, name: str, run_dir: str) -> tuple:
        """(results, timed_out): the worker's in-memory verdict or the
        store's delivered/deferred one, whichever lands first."""
        deadline = _time.monotonic() + self.cfg.deadline_s
        while _time.monotonic() < deadline:
            w = svc._worker(name)
            if w is not None and w.done.is_set():
                res = dict(w.results)
                if not res:
                    res = store.load_streamed_results(run_dir) or res
                return res, False
            res = store.load_streamed_results(run_dir)
            if res is not None:
                return res, False
            _time.sleep(0.01)
        return None, True

    def _run_inproc(self, g: ChaosGenome, base: str, run_dir: str,
                    ops: list) -> dict:
        from ..service import VerificationService
        spec = workload_spec()
        name = "chaos/0"
        lifecycle: dict = {}
        for e in g.lifecycle_events():
            lifecycle.setdefault(min(e.at, len(ops) - 1),
                                 []).append(e.kind)
        svc = VerificationService(adaptive=False, device=self.device)
        svc.claim_store(base)   # so a promoted standby fences us
        svcs = [svc]
        to_seal: list = []
        cur = svc
        applied: list = []
        skipped: list = []
        journal_fed = False
        jf = open(os.path.join(run_dir, "journal.jsonl"), "a")
        try:
            cur.admit(name, spec, store_dir=run_dir)
            for i, op in enumerate(ops):
                for kind in lifecycle.get(i, ()):
                    cur, journal_fed = self._apply_action(
                        kind, cur, svcs, to_seal, name, base,
                        run_dir, spec, applied, skipped,
                        journal_fed)
                jf.write(json.dumps(op,
                                    default=store._json_default)
                         + "\n")
                jf.flush()
                if not journal_fed:
                    cur.offer(name, op)
        finally:
            jf.close()
        if journal_fed:
            # the journal is the feed now: publish the completed
            # history so the watcher seals the tailed stream
            with gzip.open(os.path.join(run_dir,
                                        "history.jsonl.gz"),
                           "wt") as fh:
                for op in ops:
                    fh.write(json.dumps(
                        op, default=store._json_default) + "\n")
        else:
            cur.seal(name)
        for s in to_seal:
            s.seal(name)
        results, timed_out = self._wait_verdict(cur, name, run_dir)
        # teardown: every service instance down, every worker terminal
        deadline = _time.monotonic() + 5.0
        for s in svcs:
            w = s._worker(name)
            if w is not None:
                w.done.wait(max(0.0, deadline - _time.monotonic()))
            s.stop()
        shed = any(k == "shed" for k in applied)
        deferred = bool(isinstance(results, dict)
                        and results.get("deferred")) or shed
        degraded = bool(isinstance(results, dict)
                        and results.get("degraded"))
        return {"results": results, "timed-out": timed_out,
                "deferred": deferred, "degraded": degraded,
                "actions": applied, "skipped-actions": skipped}

    def _apply_action(self, kind: str, cur, svcs: list,
                      to_seal: list, name: str, base: str,
                      run_dir: str, spec: dict, applied: list,
                      skipped: list, journal_fed: bool) -> tuple:
        from ..service import VerificationService
        if kind == "shed":
            cur.shed(name, "chaos: scripted shed")
            applied.append(kind)
            return cur, journal_fed
        if kind in ("kill-recover", "failover", "drain-resume"):
            if journal_fed:
                # one promotion per run: a second would fence the
                # standby we are waiting on
                skipped.append(kind)
                return cur, journal_fed
            if kind == "drain-resume":
                cur.drain(timeout_s=10.0)
            b = VerificationService(adaptive=False, device=self.device)
            # claims the store -> fences `cur`; the journal re-feeds
            # from offset 0 while device dispatch skips to the last
            # durable checkpoint
            b.recover(base, spec_fn=lambda _d: dict(spec))
            if kind == "kill-recover":
                # SIGKILL semantics in-process: the old worker is
                # abandoned mid-queue (fenced, so its residue cannot
                # reach the store) and bled
                cur.shed(name, "chaos: sigkill")
            elif kind == "failover":
                # split-brain window: the old primary keeps running
                # its fed prefix to a (fenced, memory-only) verdict
                to_seal.append(cur)
            svcs.append(b)
            applied.append(kind)
            return b, True
        skipped.append(kind)     # 'drop' without socket transport
        return cur, journal_fed

    def _run_socket(self, g: ChaosGenome, base: str, run_dir: str,
                    ops: list) -> dict:
        from ..service import ServiceClient, VerificationService
        spec = workload_spec()
        name = "chaos/0"
        drops: dict = {}
        skipped: list = []
        for e in g.lifecycle_events():
            if e.kind == "drop":
                drops.setdefault(min(e.at, len(ops) - 1),
                                 []).append(e.kind)
            else:
                # socket transport scripts only drops; service-side
                # lifecycle would race the live client connection
                skipped.append(e.kind)
        svc = VerificationService(adaptive=False, device=self.device)
        svc.claim_store(base)
        addr = svc.serve(os.path.join(base, "sock"))
        proxy = _DropProxy(addr)
        applied: list = []
        results, timed_out = None, False
        try:
            client = ServiceClient(
                proxy.addr,
                {"name": "chaos", "start-time": "0",
                 "store-dir": base},
                spec=spec, device=self.device)
            with open(os.path.join(run_dir, "journal.jsonl"),
                      "a") as jf:
                for i, op in enumerate(ops):
                    for kind in drops.get(i, ()):
                        proxy.drop_all()
                        applied.append(kind)
                    jf.write(json.dumps(
                        op, default=store._json_default) + "\n")
                    client.offer(op)
            try:
                results = client.finalize(
                    timeout_s=self.cfg.deadline_s)
            except Exception:  # noqa: BLE001 — the oracles judge it
                results, timed_out = None, True
            client.close()
        finally:
            proxy.close()
            svc.stop()
            w = svc._worker(name)
            if w is not None:
                w.done.wait(5.0)
        deferred = bool(isinstance(results, dict)
                        and results.get("deferred"))
        degraded = bool(isinstance(results, dict)
                        and results.get("degraded"))
        return {"results": results, "timed-out": timed_out,
                "deferred": deferred, "degraded": degraded,
                "actions": applied, "skipped-actions": skipped}

    # -- shrinking ---------------------------------------------------------

    def _reproduces(self, g: ChaosGenome, oracle_names: set) -> bool:
        self._count_run()
        _M_SHRINK.inc()
        self.shrink_steps += 1
        out = self.run_schedule(g)
        got = {f["oracle"] for f in out["failures"]}
        return bool(got & oracle_names)

    def _shrink(self, g: ChaosGenome, oracle_names: set) -> ChaosGenome:
        """Greedy minimization: accept any reduction that still trips
        (one of) the same oracles and is no larger; restart the
        reduction walk from each accepted genome."""
        cur = g
        improved = True
        while improved and self.budget_left():
            improved = False
            for cand in genome_mod.shrink_reductions(cur):
                if not self.budget_left():
                    break
                if cand.key() == cur.key() \
                        or genome_size(cand) > genome_size(cur):
                    continue
                if self._reproduces(cand, oracle_names):
                    cur = cand
                    improved = True
                    break
        return cur

    def _record_failure(self, g: ChaosGenome, outcome: dict) -> None:
        names = {f["oracle"] for f in outcome["failures"]}
        for f in outcome["failures"]:
            _M_FAILURES.labels(oracle=f["oracle"]).inc()
        found_at = self.runs
        minimized = self._shrink(g, names) if self.cfg.shrink else g
        self.failures.append({
            "genome": g.to_dict(),
            "minimized": minimized.to_dict(),
            "oracles": sorted(names),
            "details": outcome["failures"],
            "fired": outcome["fired"],
            "actions": outcome.get("actions") or [],
            "found-at-schedule": found_at,
            "shrink-steps": self.shrink_steps,
        })

    # -- the loop ----------------------------------------------------------

    def _next_genome(self) -> ChaosGenome:
        cfg = self.cfg
        if cfg.strategy == "random" or not self.corpus \
                or self.rng.random() < FRESH_FRACTION:
            return sample_genome(self.rng, cfg.workload, cfg.ops,
                                 cfg.lifecycle_p)
        # recency-weighted draw, as in search/driver.py
        n = len(self.corpus)
        i = self.rng.choices(range(n), weights=range(1, n + 1))[0]
        parent = self.corpus[i][0]
        mates = [c[0] for c in self.corpus]
        return mutate(parent, self.rng, mates)

    def run(self) -> dict:
        cfg = self.cfg
        t_start = _time.monotonic()
        try:
            while self.budget_left():
                g = self._next_genome()
                outcome = self.run_schedule(g)
                self._count_run()
                novel = self.cmap.add(outcome["coverage"])
                if outcome["conjunction"]:
                    self.conjunction_hits += 1
                if cfg.strategy == "guided" and novel \
                        and g.key() not in self._keys:
                    self._keys.add(g.key())
                    self.corpus.append((g, len(novel)))
                self.curve.append(len(self.cmap))
                _M_COV.set(len(self.cmap))
                _M_CORPUS.set(len(self.corpus))
                if outcome["failures"]:
                    self._record_failure(g, outcome)
                    if cfg.stop_on_failure:
                        break
        finally:
            if self._own_scratch and self._scratch:
                shutil.rmtree(self._scratch, ignore_errors=True)
                self._scratch = None
        result = {
            "workload": cfg.workload,
            "strategy": cfg.strategy,
            "seed": cfg.seed,
            "schedules": self.runs,
            "coverage-bits": len(self.cmap),
            "coverage-curve": self.curve,
            "coverage-digest": self.cmap.digest(),
            "corpus-size": len(self.corpus),
            "conjunction-hits": self.conjunction_hits,
            "found-conjunction": self.conjunction_hits > 0,
            "shrink-steps": self.shrink_steps,
            "failures": self.failures,
            "found": bool(self.failures),
            "oracles": list(ORACLES),
            "wall-s": round(_time.monotonic() - t_start, 3),
        }
        if cfg.store_dir:
            self._store(result)
        return result

    # -- artifacts ---------------------------------------------------------

    def _store(self, result: dict) -> None:
        d = self.cfg.store_dir
        os.makedirs(d, exist_ok=True)
        artifact = dict(result)
        artifact["config"] = {
            f.name: getattr(self.cfg, f.name)
            for f in dataclasses.fields(self.cfg) if f.name != "device"}
        artifact["corpus"] = [
            {"genome": g.to_dict(), "new-bits": n}
            for g, n in self.corpus]
        with open(os.path.join(d, "chaos.json"), "w") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)
        with open(os.path.join(d, "coverage.bin"), "wb") as f:
            f.write(self.cmap.encode())


def run_chaos(cfg: ChaosConfig) -> dict:
    """Run one coverage-guided (or pure-random) chaos fuzz of the
    verification pipeline to its schedule budget. Returns the result
    summary (the store-dir artifact carries the full corpus)."""
    return _Chaos(cfg).run()
