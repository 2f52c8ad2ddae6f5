"""The generational search loop: simulate, screen, cover, mutate.

One search run is `run_search(SearchConfig)`: per generation, a
population of genomes (random draws, or — guided — mutants of corpus
members) is simulated across a worker pool; every history goes through
the tier-1 screen (`checker/screen.py`) and coverage extraction
(`coverage.py`). Genomes that reach novel coverage bits or raise
screen suspicion enter the corpus; suspicious histories escalate to
the full checker (host mirror, a batched `analysis_gpu_batch` call per
generation, or a live VerificationService); confirmed violations are
shrunk to a minimal reproducing genome by greedily re-simulating
`mutate.shrink_reductions`.

Determinism: the search rng (sampling + mutation) lives on the main
thread and is seeded from the config; each simulation pins its own
thread-local generator stream from the genome's seed; worker results
are consumed in submission order. Same config -> same search,
regardless of worker count.

Every `simulate()` call — including escalation confirms and shrink
steps — counts against the one simulation budget (`max_sims`), so a
guided-vs-random A/B at a fixed budget is an honest comparison.

The port's copy of `jepsen_tpu/search/driver.py`. The simulations stay
on host threads; escalation runs on the main thread, so the card is
driven from one thread: the batch mode through
`checker.wgl.analysis_gpu_batch` (K3 batched on the dense groups, K2 on
the hash route), the service mode through an in-process
`VerificationService`, both on `SearchConfig.device`. Results and
artifacts equal the JAX package's on the same config, but for `wall-s`.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import random
import time as _time
from typing import Optional

from .. import telemetry
from .._platform import resolve_device
from ..checker.screen import screen_history, should_escalate
from ..generator.simulate import simulate
from . import mutate as mutate_mod
from . import scenario as scenario_mod
from .coverage import CoverageMap, extract_coverage
from .mutate import Genome, genome_size, mutate, sample_genome

_M_SIMS = telemetry.counter(
    "jepsen_tpu_search_simulations_total",
    "Simulated scenario runs, by search strategy",
    ("strategy",))
_M_NEW_BITS = telemetry.counter(
    "jepsen_tpu_search_new_bits_total",
    "Novel coverage bits admitted to the corpus map")
_M_COV = telemetry.gauge(
    "jepsen_tpu_search_coverage_bits",
    "Accumulated corpus coverage bits")
_M_CORPUS = telemetry.gauge(
    "jepsen_tpu_search_corpus_genomes",
    "Genomes in the search corpus")
_M_ESC = telemetry.counter(
    "jepsen_tpu_search_escalations_total",
    "Histories escalated from the tier-1 screen to a full check",
    ("mode",))
_M_VIOL = telemetry.counter(
    "jepsen_tpu_search_violations_total",
    "Confirmed violations found by search")
_M_SHRINK = telemetry.counter(
    "jepsen_tpu_search_shrink_steps_total",
    "Shrink candidate re-simulations")
_M_GEN_S = telemetry.histogram(
    "jepsen_tpu_search_generation_seconds",
    "Wall-clock seconds per search generation")

# guided-mode fresh-blood fraction: even with a corpus, this share of
# each generation is uniform random draws so the search never inbreeds
FRESH_FRACTION = 0.2
# share of each guided generation spent bursting mutants of the
# PREVIOUS generation's admissions (the AFL energy idea): a genome
# that just reached novel coverage is one mutation from its neighbors,
# and spreading its mutants over later generations dissipates that
BURST_FRACTION = 0.5


@dataclasses.dataclass
class SearchConfig:
    workload: str = "register"
    generations: int = 10
    population: int = 50
    seed: int = 45100
    workers: int = 4
    strategy: str = "guided"          # guided | random
    escalate: str = "none"            # none | host | batch | service
    bug: Optional[str] = None         # a scenario.BUGS name, or None
    max_sims: Optional[int] = None    # total simulate() budget
    max_ops: Optional[int] = None     # per-run history bound
    horizon_s: Optional[float] = None
    sample: float = 0.0               # clean-history audit fraction
    host_budget_s: float = 2.0
    stop_on_violation: bool = True
    store_dir: Optional[str] = None
    resume_dir: Optional[str] = None  # prior store_dir to continue from
    # where escalations run: CUDA unless "cpu" is named (None raises
    # without a card). Not a search parameter: search.json's config
    # leaves it out, so the artifact is the JAX package's
    device: Optional[str] = None

    def resolved_horizon_s(self) -> float:
        if self.horizon_s is not None:
            return float(self.horizon_s)
        return scenario_mod.default_horizon_s(self.workload)

    def resolved_max_ops(self) -> int:
        if self.max_ops is not None:
            return int(self.max_ops)
        return scenario_mod.default_max_ops(self.workload)


def evaluate_genome(genome: Genome, bug=None):
    """Simulate one genome and screen its history. Returns
    (history, Coverage, screen-verdict, model)."""
    ctx, g, ex, model = scenario_mod.build(genome, bug)
    hist = simulate(ctx, g, ex.complete, seed=genome.seed,
                    max_ops=genome.max_ops)
    return hist, extract_coverage(hist), \
        screen_history(model, hist), model


class _Search:
    def __init__(self, cfg: SearchConfig):
        self.cfg = cfg
        # resolved before any simulation: without a card and without
        # device="cpu" the search refuses to start
        self.device = resolve_device(cfg.device)
        self.rng = random.Random(cfg.seed)
        self.cmap = CoverageMap()
        # (genome, novel-bit-count) — admission order
        self.corpus: list = []
        self._keys: set = set()
        self.curve: list = []
        self.sims = 0
        self.escalations = 0
        self.shrink_steps = 0
        self.violations: list = []
        self.generations_run = 0
        self._service = None
        # genomes admitted during the previous generation (burst pool)
        self._fresh: list = []
        if cfg.resume_dir:
            self._resume(cfg.resume_dir)

    def _resume(self, d: str) -> None:
        """Reload a prior run's artifacts (search.json + coverage.bin)
        and continue: the corpus, coverage map, and counters pick up
        where the stored run left off, and the restored simulation
        count keeps charging against max_sims — so a resumed search
        spends only the REMAINING budget, not a fresh one.

        The mutation rng restarts from cfg.seed (its walk position is
        not persisted): a resumed search is deterministic given
        (artifact, config), not a replay of the unsplit run."""
        with open(os.path.join(d, "search.json")) as f:
            art = json.load(f)
        stored = (art.get("config") or {}).get("workload")
        if stored is not None and stored != self.cfg.workload:
            raise ValueError(
                f"resume workload mismatch: {d} was searched with "
                f"workload {stored!r}, config says "
                f"{self.cfg.workload!r}")
        cov_bin = os.path.join(d, "coverage.bin")
        if os.path.exists(cov_bin):
            with open(cov_bin, "rb") as f:
                self.cmap = CoverageMap.decode(f.read())
        for entry in art.get("corpus") or []:
            g = Genome.from_dict(entry["genome"])
            if g.key() in self._keys:
                continue
            self._keys.add(g.key())
            self.corpus.append(
                (g, int(entry.get("new-bits", 0) or 0)))
        self.sims = int(art.get("simulations", 0) or 0)
        self.escalations = int(art.get("escalations", 0) or 0)
        self.shrink_steps = int(art.get("shrink-steps", 0) or 0)
        self.generations_run = int(art.get("generations-run", 0)
                                   or 0)
        self.curve = list(art.get("coverage-curve") or [])
        self.violations = list(art.get("violations") or [])

    # -- budget ------------------------------------------------------------

    def budget_left(self) -> bool:
        return self.cfg.max_sims is None \
            or self.sims < self.cfg.max_sims

    def _count_sim(self) -> None:
        self.sims += 1
        _M_SIMS.labels(strategy=self.cfg.strategy).inc()

    # -- population --------------------------------------------------------

    def _prepare(self, genome: Genome) -> Genome:
        if genome.max_ops is None:
            genome = dataclasses.replace(
                genome, max_ops=self.cfg.resolved_max_ops())
        return genome

    def _next_batch(self) -> list:
        cfg, horizon = self.cfg, self.cfg.resolved_horizon_s()
        out = []
        for _ in range(cfg.population):
            r = self.rng.random()
            if cfg.strategy == "random" or not self.corpus \
                    or r < FRESH_FRACTION:
                g = sample_genome(self.rng, cfg.workload, horizon,
                                  max_ops=cfg.resolved_max_ops())
            else:
                if self._fresh \
                        and r < FRESH_FRACTION + BURST_FRACTION:
                    parent = self._fresh[
                        self.rng.randrange(len(self._fresh))]
                else:
                    # recency-weighted draw over the whole corpus: a
                    # genome admitted late earned bits the earlier
                    # corpus never reached — uniform selection would
                    # let the first (bit-rich but generic) admissions
                    # dominate the mutation budget
                    n = len(self.corpus)
                    i = self.rng.choices(range(n),
                                         weights=range(1, n + 1))[0]
                    parent = self.corpus[i][0]
                mates = [c[0] for c in self.corpus]
                g = mutate(parent, self.rng, horizon, mates)
            out.append(self._prepare(g))
        return out

    # -- escalation --------------------------------------------------------

    def _confirm_host(self, model, hist) -> dict:
        from ..checker.linear import analysis_host
        return analysis_host(model, hist,
                             budget_s=self.cfg.host_budget_s)

    def _confirm_batch(self, model, hists: list) -> list:
        from ..checker.wgl import analysis_gpu_batch
        return analysis_gpu_batch(model, hists, device=self.device,
                                  budget_s=self.cfg.host_budget_s)

    def _confirm_service(self, model, hist, tag: str) -> dict:
        """Round-trip one history through an in-process verification
        service stream (the online path a live cluster would use)."""
        from ..service import (VerificationService, model_spec,
                               targets_spec)
        from ..checker.linear import Linearizable
        if self._service is None:
            self._service = VerificationService(device=self.device)
        spec = targets_spec({
            "checker": Linearizable(model),
            "tier": "screen"})
        if not spec:
            spec = {"screen-linear": {"kind": "screen",
                                      "model": model_spec(model)}}
        name = f"search-{tag}"
        self._service.admit(name, spec)
        for op in hist:
            self._service.offer(name, op)
        self._service.seal(name)
        res = self._service.result(name, timeout_s=60.0)
        for sub in res.values():
            if isinstance(sub, dict) and sub.get("valid?") is False:
                return sub
        for sub in res.values():
            if isinstance(sub, dict) and "valid?" in sub:
                return sub
        return {"valid?": "unknown", "analyzer": "service"}

    def _escalate(self, model, hist, tag: str) -> dict | None:
        """Inline escalation for host/service modes; batch defers to
        generation end. None when mode is none/batch."""
        mode = self.cfg.escalate
        if mode == "host":
            return self._confirm_host(model, hist)
        if mode == "service":
            return self._confirm_service(model, hist, tag)
        return None

    # -- shrinking ---------------------------------------------------------

    def _reproduces(self, genome: Genome) -> bool:
        self._count_sim()
        _M_SHRINK.inc()
        self.shrink_steps += 1
        _, _, screen, _ = evaluate_genome(genome, self.cfg.bug)
        return screen["violation-count"] > 0

    def _shrink(self, genome: Genome) -> Genome:
        """Greedy minimization: accept any reduction that still
        reproduces and is no larger; restart the reduction walk from
        each accepted genome. The screen verdict is the reproduction
        oracle — it is sound (flags only definite violations), and at
        shrink sizes it is orders cheaper than the full search."""
        cur = genome
        improved = True
        while improved and self.budget_left():
            improved = False
            for cand in mutate_mod.shrink_reductions(cur):
                if not self.budget_left():
                    break
                if cand.key() == cur.key() \
                        or genome_size(cand) > genome_size(cur):
                    continue
                if self._reproduces(cand):
                    cur = cand
                    improved = True
                    break
        return cur

    # -- violations --------------------------------------------------------

    def _record_violation(self, genome: Genome, screen: dict,
                          confirm: dict | None) -> None:
        _M_VIOL.inc()
        found_at = self.sims
        minimized = self._shrink(genome)
        self.violations.append({
            "genome": genome.to_dict(),
            "minimized": minimized.to_dict(),
            "screen-violations": screen.get("violations", []),
            "confirmed-by": (confirm or {}).get("analyzer",
                                                "tier1-screen"),
            "found-at-sim": found_at,
            "shrink-steps": self.shrink_steps,
        })

    # -- the loop ----------------------------------------------------------

    def _evaluate_batch(self, batch: list) -> list:
        bug = self.cfg.bug
        if self.cfg.workers <= 1:
            return [evaluate_genome(g, bug) for g in batch]
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self.cfg.workers) as pool:
            futs = [pool.submit(evaluate_genome, g, bug)
                    for g in batch]
            return [f.result() for f in futs]

    def run(self) -> dict:
        cfg = self.cfg
        t_start = _time.monotonic()
        try:
            # cumulative cap: a resumed search (resume_dir) has its
            # prior generations restored, so it runs only the
            # remainder of the configured budget
            while self.generations_run < cfg.generations:
                if not self.budget_left():
                    break
                with _M_GEN_S.time():
                    done = self._generation()
                self.generations_run += 1
                self.curve.append(len(self.cmap))
                _M_COV.set(len(self.cmap))
                _M_CORPUS.set(len(self.corpus))
                if done:
                    break
        finally:
            if self._service is not None:
                try:
                    self._service.drain()
                except Exception:  # noqa: BLE001 — teardown is best-effort
                    pass
        result = {
            "workload": cfg.workload,
            "strategy": cfg.strategy,
            "seed": cfg.seed,
            "bug": cfg.bug,
            "generations-run": self.generations_run,
            "simulations": self.sims,
            "coverage-bits": len(self.cmap),
            "coverage-curve": self.curve,
            "coverage-digest": self.cmap.digest(),
            "corpus-size": len(self.corpus),
            "escalations": self.escalations,
            "shrink-steps": self.shrink_steps,
            "violations": self.violations,
            "found": bool(self.violations),
            "wall-s": round(_time.monotonic() - t_start, 3),
        }
        if cfg.store_dir:
            self._store(result)
        return result

    def _generation(self) -> bool:
        """One generation. True when the search should stop (first
        violation confirmed and stop_on_violation)."""
        cfg = self.cfg
        batch = self._next_batch()
        if cfg.max_sims is not None:
            batch = batch[:max(0, cfg.max_sims - self.sims)]
        if not batch:
            return False
        results = self._evaluate_batch(batch)
        fresh: list = []
        deferred: list = []     # (genome, screen, hist) for batch mode
        for genome, (hist, cov, screen, model) in zip(batch, results):
            self._count_sim()
            novel = self.cmap.add(cov)
            if novel:
                _M_NEW_BITS.inc(len(novel))
            suspicious = screen["suspicion"] > 0
            if (novel or suspicious) \
                    and genome.key() not in self._keys:
                self._keys.add(genome.key())
                self.corpus.append((genome, len(novel)))
                fresh.append(genome)
            if screen["violation-count"] > 0:
                # the screen's verdict is definite; escalation (if
                # configured) corroborates with the full checker
                confirm = None
                if cfg.escalate in ("host", "service"):
                    self.escalations += 1
                    _M_ESC.labels(mode=cfg.escalate).inc()
                    confirm = self._escalate(model, hist,
                                             f"v{self.sims}")
                self._record_violation(genome, screen, confirm)
                if cfg.stop_on_violation:
                    return True
                continue
            esc, _why = should_escalate(screen, sample=cfg.sample,
                                        key=genome.seed)
            if esc and cfg.escalate != "none":
                self.escalations += 1
                _M_ESC.labels(mode=cfg.escalate).inc()
                if cfg.escalate == "batch":
                    deferred.append((genome, screen, hist, model))
                else:
                    confirm = self._escalate(model, hist,
                                             f"e{self.sims}")
                    if confirm is not None \
                            and confirm.get("valid?") is False:
                        self._record_violation(genome, screen,
                                               confirm)
                        if cfg.stop_on_violation:
                            return True
        self._fresh = fresh
        if deferred:
            model = deferred[0][3]
            verdicts = self._confirm_batch(
                model, [d[2] for d in deferred])
            for (genome, screen, _h, _m), verdict in zip(deferred,
                                                         verdicts):
                if verdict.get("valid?") is False:
                    self._record_violation(genome, screen, verdict)
                    if cfg.stop_on_violation:
                        return True
        return False

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
        with open(os.path.join(d, "search.json"), "w") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)
        with open(os.path.join(d, "coverage.bin"), "wb") as f:
            f.write(self.cmap.encode())


def run_search(cfg: SearchConfig) -> dict:
    """Run one coverage-guided (or pure-random) scenario search to its
    generation/simulation budget. Returns the result summary (the
    store-dir artifact carries the full corpus)."""
    return _Search(cfg).run()
