"""The port's coverage-guided scenario search (`jepsen_tpu_torch/search/`)
against the JAX package's (`jepsen_tpu/search/`) on the CPU.

Covered: the fault vocabulary pinned to the JAX package's nemesis
packages; the genome engine (sample -> mutate -> splice -> shrink over
several seeds); coverage extraction (bit sets, family counts, digests,
`CoverageMap.encode` bytes) on simulated histories and chaos probe
streams; scenario evaluation (history, coverage and screen verdict);
`run_search` with every escalation mode, with its `search.json` and
`coverage.bin`; resume; and the `jepsen_tpu_search_*` metric families
(the `search` command: tests/test_torch_cli.py).

Tolerance: none. Every comparison is exact equality, but for the host
clock readings (the result's `wall-s`, the screen's `duration-ms`) and
the store directories named in search.json's config, which differ
because each package writes to its own.

The port runs with device="cpu" (K1 and K2 through their plain
versions); the JAX package under JAX_PLATFORMS=cpu.
"""

from __future__ import annotations

import json
import os
import random

import pytest

from jepsen_tpu import report as jreport
from jepsen_tpu.search import coverage as jcov
from jepsen_tpu.search import driver as jdriver
from jepsen_tpu.search import mutate as jmut
from jepsen_tpu.search import scenario as jscen
from jepsen_tpu_torch import report, telemetry
from jepsen_tpu_torch.checker import wgl_closure
from jepsen_tpu_torch.search import coverage as cov
from jepsen_tpu_torch.search import driver
from jepsen_tpu_torch.search import mutate as mut
from jepsen_tpu_torch.search import scenario as scen

# the pinned planted-bug find (78 simulations, the bug at simulation 56)
BUG = dict(workload="phased-register", bug="lost-write-kill-partition",
           generations=12, population=25, seed=2, max_sims=300)


def _both(tmp_path, tag, **kw):
    """One config through both packages' `run_search`, each with its
    own store dir; returns (jax result, port result, jax dir, port
    dir)."""
    jd, pd = str(tmp_path / f"jax-{tag}"), str(tmp_path / f"port-{tag}")
    want = jdriver.run_search(jdriver.SearchConfig(store_dir=jd, **kw))
    got = driver.run_search(driver.SearchConfig(store_dir=pd,
                                                device="cpu", **kw))
    return want, got, jd, pd


def _no_wall(d):
    return {k: v for k, v in d.items() if k != "wall-s"}


def _artifact(d):
    """search.json without `wall-s` and the config's own directory
    paths (each package writes to its own)."""
    with open(os.path.join(d, "search.json")) as f:
        art = _no_wall(json.load(f))
    for k in ("store_dir", "resume_dir"):
        if art["config"][k] is not None:
            art["config"][k] = os.path.basename(
                art["config"][k]).split("-", 1)[1]
    return art


def _same_artifacts(jd, pd):
    got = _artifact(pd)
    assert got == _artifact(jd)
    with open(os.path.join(jd, "coverage.bin"), "rb") as f:
        jbin = f.read()
    with open(os.path.join(pd, "coverage.bin"), "rb") as f:
        pbin = f.read()
    assert pbin == jbin
    assert cov.CoverageMap.decode(pbin).digest() == got["coverage-digest"]
    with open(os.path.join(jd, "coverage.bin"), "rb") as f:
        jbin = f.read()
    with open(os.path.join(pd, "coverage.bin"), "rb") as f:
        pbin = f.read()
    assert pbin == jbin
    assert cov.CoverageMap.decode(pbin).digest() == got["coverage-digest"]


# -- vocabulary --------------------------------------------------------------

def test_fault_vocabulary_pinned_to_the_jax_nemesis_packages():
    from jepsen_tpu import db as jdb
    from jepsen_tpu.nemesis import combined

    kinds = set()
    for pkg in combined.nemesis_packages(
            {"db": jdb.noop,
             "faults": ["partition", "kill", "pause", "clock"]}):
        for name, start_fs, stop_fs, _color in pkg["perf"]:
            kinds.add(name)
            for f in start_fs:
                assert cov.START_F.get(f) == name, f
            for f in stop_fs:
                assert cov.STOP_F.get(f) == name, f
    assert kinds == set(mut.FAULT_KINDS)
    assert set(scen.KIND_OPS) == set(mut.FAULT_KINDS)
    for kind, (start_f, stop_f) in scen.KIND_OPS.items():
        assert cov.START_F[start_f] == kind
        assert cov.STOP_F[stop_f] == kind
    assert (cov.START_F, cov.STOP_F) == (jcov.START_F, jcov.STOP_F)
    assert scen.KIND_OPS == jscen.KIND_OPS
    assert {n: (b.trigger, b.effect) for n, b in scen.BUGS.items()} == \
        {n: (b.trigger, b.effect) for n, b in jscen.BUGS.items()}
    assert {n: {k: v for k, v in s.items() if k != "client"}
            for n, s in scen.SCENARIOS.items()} == \
        {n: {k: v for k, v in s.items() if k != "client"}
         for n, s in jscen.SCENARIOS.items()}


# -- the genome engine -------------------------------------------------------

def _genome_walk(m, seed, workload, horizon):
    """sample -> 12 mutations (each against the walk so far as mates)
    -> splices -> every shrink reduction of the last genome, as dicts."""
    rng = random.Random(seed)
    g = m.sample_genome(rng, workload, horizon, max_ops=400)
    seen = [g]
    for _ in range(12):
        g = m.mutate(g, rng, horizon, seen)
        seen.append(g)
    for _ in range(4):
        seen.append(m.splice(seen[rng.randrange(len(seen))], g, rng))
    out = [x.to_dict() for x in seen]
    out += [x.to_dict() for x in m.shrink_reductions(g)]
    out.append(list(m.genome_size(g)))
    return out


@pytest.mark.parametrize("seed", [0, 3, 9, 45100])
@pytest.mark.parametrize("workload,horizon", [("register", 30.0),
                                              ("phased-register", 60.0)])
def test_genome_sequences_equal_the_jax_package(seed, workload, horizon):
    got = _genome_walk(mut, seed, workload, horizon)
    assert got == _genome_walk(jmut, seed, workload, horizon)
    g = mut.Genome.from_dict(got[5])
    assert mut.Genome.from_dict(json.loads(json.dumps(g.to_dict()))) == g


# -- coverage ----------------------------------------------------------------

GENOMES = [
    dict(seed=7, concurrency=3, workload="register",
         faults=[dict(kind="kill", **{"start-s": 5.0, "duration-s": 2.0})],
         max_ops=160),
    dict(seed=11, concurrency=5, workload="register",
         faults=[dict(kind="partition", **{"start-s": 1.0,
                                           "duration-s": 6.0}),
                 dict(kind="pause", **{"start-s": 3.0, "duration-s": 4.0})],
         max_ops=200),
    dict(seed=2, concurrency=4, workload="phased-register",
         faults=[dict(kind="kill", **{"start-s": 44.9, "duration-s": 1.0}),
                 dict(kind="partition", **{"start-s": 44.95,
                                           "duration-s": 0.5})],
         max_ops=600),
    dict(seed=99, concurrency=2, workload="phased-register",
         faults=[dict(kind="clock", **{"start-s": 10.0,
                                       "duration-s": 30.0})],
         max_ops=600),
]


@pytest.mark.parametrize("bug", [None, "lost-write-kill-partition",
                                 "lost-write-pause"])
@pytest.mark.parametrize("i", range(len(GENOMES)))
def test_evaluate_genome_equals_the_jax_package(i, bug):
    """The simulated history, its coverage (bits, family counts) and
    the screen verdict, and the coverage map's bytes and digest."""
    d = dict(GENOMES[i], opts={})
    jh, jc, js, _ = jdriver.evaluate_genome(jmut.Genome.from_dict(d), bug)
    h, c, s, model = driver.evaluate_genome(mut.Genome.from_dict(d), bug)
    assert h == jh
    assert (c.bits, c.overlap_bits, c.kgram_bits, c.adjacency_bits) == \
        (jc.bits, jc.overlap_bits, jc.kgram_bits, jc.adjacency_bits)
    assert {k: v for k, v in s.items() if k != "duration-ms"} == \
        {k: v for k, v in js.items() if k != "duration-ms"}
    assert len(c) > 0
    m, jm = cov.CoverageMap(), jcov.CoverageMap()
    assert m.add(c) == jm.add(jc)
    assert m.encode() == jm.encode()
    assert m.digest() == jm.digest()
    assert cov.CoverageMap.decode(m.encode()).bits == m.bits
    assert type(model).__name__ == "Register"


PROBES = [
    [{"event": "fault", "site": "stream-chunk/t", "kind": "oom",
      "retry": 1}],
    [{"event": "lifecycle", "stream": "chaos/0", "state": "streaming"},
     {"event": "fault", "site": "stream-chunk/chaos/0", "kind": "oom",
      "retry": 1},
     {"event": "replay-begin", "site": "stream-chunk/chaos/0",
      "from_chunk": 2},
     {"event": "fault", "site": "stream-chunk/chaos/0",
      "kind": "compile", "retry": 2},
     {"event": "corrupt", "site": "stream-stage/chaos/0"},
     {"event": "replay-end", "site": "stream-chunk/chaos/0",
      "replayed": 64},
     {"event": "inject", "site": "stream-chunk/chaos/0",
      "kind": "device-lost"},
     {"event": "lifecycle", "stream": "chaos/0", "state": "done"}],
]


@pytest.mark.parametrize("actions", [[], ["shed"],
                                     ["drop", "kill-recover", "drop"]])
@pytest.mark.parametrize("i", range(len(PROBES)))
def test_chaos_coverage_equals_the_jax_package(i, actions):
    c = cov.extract_chaos_coverage(PROBES[i], actions)
    jc = jcov.extract_chaos_coverage(PROBES[i], actions)
    assert (c.bits, c.overlap_bits, c.kgram_bits, c.adjacency_bits) == \
        (jc.bits, jc.overlap_bits, jc.kgram_bits, jc.adjacency_bits)
    assert cov.CoverageMap(c.bits).encode() == \
        jcov.CoverageMap(jc.bits).encode()


# -- run_search ----------------------------------------------------------------

@pytest.mark.parametrize("escalate", ["none", "host"])
def test_search_finds_the_planted_bug_as_the_jax_package(tmp_path,
                                                         escalate):
    want, got, jd, pd = _both(tmp_path, escalate, escalate=escalate, **BUG)
    assert _no_wall(got) == _no_wall(want)
    assert got["found"] is True and got["simulations"] == 78
    assert got["violations"][0]["found-at-sim"] == 56
    _same_artifacts(jd, pd)
    with open(os.path.join(pd, "search.json")) as f:
        assert "device" not in json.load(f)["config"]


def test_batch_escalation_launches_k1_and_equals_the_jax_package(
        tmp_path, monkeypatch):
    """The audit sample sends clean phased-register histories to one
    `analysis_gpu_batch` call per generation, which walks them in dense
    groups: K1 (here its plain version) runs, and the search equals the
    JAX package's `analysis_tpu_batch` run."""
    calls = {"n": 0}
    plain = wgl_closure.closure_round_plain

    def counting(*a, **k):
        calls["n"] += 1
        return plain(*a, **k)

    monkeypatch.setattr(wgl_closure, "closure_round_plain", counting)
    want, got, jd, pd = _both(tmp_path, "batch", escalate="batch",
                              sample=0.3, **BUG)
    assert _no_wall(got) == _no_wall(want)
    assert got["found"] is True and got["escalations"] == 10
    assert calls["n"] > 0
    _same_artifacts(jd, pd)


def test_service_escalation_equals_the_jax_package(tmp_path):
    want, got, jd, pd = _both(tmp_path, "service", workload="register",
                              generations=2, population=6, seed=5,
                              max_sims=12, escalate="service", sample=0.5)
    assert _no_wall(got) == _no_wall(want)
    assert got["escalations"] > 0
    _same_artifacts(jd, pd)


def test_resume_equals_the_jax_package(tmp_path):
    kw = dict(workload="phased-register", bug="lost-write-kill-partition",
              population=10, seed=2, max_sims=60, workers=2)
    _both(tmp_path, "r", generations=2, **kw)
    jd, pd = str(tmp_path / "jax-r"), str(tmp_path / "port-r")
    want = jdriver.run_search(jdriver.SearchConfig(
        store_dir=jd, resume_dir=jd, generations=5, **{**kw, "seed": 3}))
    got = driver.run_search(driver.SearchConfig(
        store_dir=pd, resume_dir=pd, generations=5, device="cpu",
        **{**kw, "seed": 3}))
    assert _no_wall(got) == _no_wall(want)
    assert got["generations-run"] > 2
    _same_artifacts(jd, pd)
    with pytest.raises(ValueError, match="resume workload"):
        driver.run_search(driver.SearchConfig(workload="register",
                                              resume_dir=pd, device="cpu"))


def test_search_metrics_and_report_line():
    before = telemetry.snapshot(prefix="jepsen_tpu_search")
    r = driver.run_search(driver.SearchConfig(
        workload="phased-register", generations=2, population=5,
        seed=3, max_sims=10, device="cpu"))
    after = telemetry.snapshot(prefix="jepsen_tpu_search")
    prev = (before.get("jepsen_tpu_search_simulations_total") or {}) \
        .get("strategy=guided", 0)
    assert after["jepsen_tpu_search_simulations_total"][
        "strategy=guided"] - prev == r["simulations"] == 10
    for name in ("jepsen_tpu_search_coverage_bits",
                 "jepsen_tpu_search_corpus_genomes",
                 "jepsen_tpu_search_generation_seconds"):
        assert name in after
    assert report.search_line(r) == jreport.search_line(r)
    assert report.search_line(r).startswith("search (guided):")


def test_search_refuses_to_start_without_a_card():
    if _cuda():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.run_search(driver.SearchConfig(generations=1,
                                              population=1))


def _cuda() -> bool:
    import torch
    return torch.cuda.is_available()
