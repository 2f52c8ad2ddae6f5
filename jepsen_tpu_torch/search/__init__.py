"""Coverage-guided scenario search: fuzzing over generator/nemesis
schedules.

The suite menus are a static catalog; this subsystem treats scenario
generation as a feedback loop (ROADMAP "Coverage-guided scenario
search", PAPERS.md: *AccelSync*, arXiv 2605.07881): simulate a typed
scenario *genome* (seed, concurrency, nemesis fault windows, workload
opts) on the deterministic simulator, extract *schedule-coverage*
signals from the history, and mutate genomes that reach novel
synchronization patterns toward the still-uncovered ones. Tier-1
screens triage every simulated history; suspicion escalates to the
full WGL search (host mirror, a batched device call, or a live
verification service); found violations are shrunk to a minimal
reproducing scenario by re-simulating genome reductions.

Layout:

  coverage.py   schedule-coverage signals + corpus-wide coverage map
  mutate.py     the scenario genome, seeded mutators, shrink reductions
  scenario.py   genome -> generator + synthetic fault-aware executor
  driver.py     the generational search loop, worker pool, escalation,
                shrinking, artifacts; CLI `python -m jepsen_tpu_torch search`

See doc/search.md for the genome grammar, the coverage-signal
definitions, and the novelty/corpus semantics.

The port's copy of `jepsen_tpu/search/`: the same genomes, coverage
bits, corpus and artifacts (`search.json`, `coverage.bin`) on the same
config, with escalation through the port's checkers on the card
(`driver.SearchConfig.device`).
"""

from .coverage import Coverage, CoverageMap, extract_coverage  # noqa: F401
from .driver import SearchConfig, run_search  # noqa: F401
# NB: mutate() itself is not re-exported — the bare name would shadow
# the search.mutate submodule attribute
from .mutate import FaultWindow, Genome, sample_genome  # noqa: F401

__all__ = ["Coverage", "CoverageMap", "extract_coverage",
           "FaultWindow", "Genome", "sample_genome",
           "SearchConfig", "run_search"]
