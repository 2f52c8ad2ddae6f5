"""The port's self-chaos harness (`jepsen_tpu_torch/chaos/`) against the
JAX package's (`jepsen_tpu/chaos/`) on the CPU.

Covered: the chaos genome engine (sample -> mutate -> splice -> shrink
over several seeds); the fixed workload (spec and journal-form ops);
the five oracles on unit cases mirroring tests/test_chaos.py, each
case's failures equal to the JAX oracles'; `run_chaos` on `register`
and `register-corrupt` with every oracle green, its result, `chaos.json`
and `coverage.bin` equal to the JAX package's; a defect planted in a
scratch subclass of the port's `WglStream` (the recovery replay rung
skipped), caught by verdict-identity and shrunk; and no stream worker
left alive after a run.

Tolerance: none. Every comparison is exact equality, but for the
result's `wall-s` (a host clock reading) and the store directory named
in chaos.json's config, which differs because each package writes to
its own. The port runs with device="cpu"; the JAX package under
JAX_PLATFORMS=cpu.
"""

from __future__ import annotations

import json
import os
import random
import threading

import pytest
import torch

from jepsen_tpu import _platform as jplat
from jepsen_tpu.chaos import driver as jdriver
from jepsen_tpu.chaos import genome as jgenome
from jepsen_tpu.chaos import oracles as joracles
from jepsen_tpu_torch import _platform as plat
from jepsen_tpu_torch.chaos import (ChaosConfig, ChaosEvent, ChaosGenome,
                                    run_chaos)
from jepsen_tpu_torch.chaos import driver
from jepsen_tpu_torch.chaos import genome as genome_mod
from jepsen_tpu_torch.chaos import oracles as oracles_mod
from jepsen_tpu_torch.checker import streaming
from jepsen_tpu_torch.search.coverage import (CoverageMap,
                                              extract_chaos_coverage)


@pytest.fixture(autouse=True)
def _reset_fault_injection():
    plat.reset_fault_injection()
    jplat.reset_fault_injection()
    yield
    plat.reset_fault_injection()
    jplat.reset_fault_injection()


def _no_wall(d):
    return {k: v for k, v in d.items() if k != "wall-s"}


# -- genomes ------------------------------------------------------------------

def _genome_walk(m, seed, workload, ops, lifecycle_p):
    rng = random.Random(seed)
    g = m.sample_genome(rng, workload, ops, lifecycle_p)
    seen = [g]
    for _ in range(16):
        g = m.mutate(g, rng, seen)
        seen.append(g)
    for _ in range(4):
        seen.append(m.splice(seen[rng.randrange(len(seen))], g, rng))
    out = [x.to_dict() for x in seen]
    out += [x.to_dict() for x in m.shrink_reductions(g)]
    out.append(list(m.genome_size(g)))
    return out


@pytest.mark.parametrize("lifecycle_p", [0.2, 0.9])
@pytest.mark.parametrize("seed", [1, 5, 23, 45100])
def test_genome_sequences_equal_the_jax_package(seed, lifecycle_p):
    got = _genome_walk(genome_mod, seed, "register", 128, lifecycle_p)
    assert got == _genome_walk(jgenome, seed, "register", 128,
                               lifecycle_p)
    for d in got[:-1]:
        g = ChaosGenome.from_dict(json.loads(json.dumps(d)))
        assert g.to_dict() == d
        assert 1 <= len(g.events) <= genome_mod.MAX_EVENTS
    assert (genome_mod.BACKEND_KINDS, genome_mod.LIFECYCLE_KINDS) == \
        (jgenome.BACKEND_KINDS, jgenome.LIFECYCLE_KINDS)


@pytest.mark.parametrize("workload", list(driver.WORKLOADS))
def test_workload_equals_the_jax_package(workload):
    assert driver.workload_spec() == jdriver.workload_spec()
    assert driver.workload_ops(workload, 128, 9) == \
        jdriver.workload_ops(workload, 128, 9)
    with pytest.raises(ValueError):
        driver.workload_ops("bogus", 64, 1)


# -- oracles (the cases of tests/test_chaos.py) --------------------------------

def _outcome(**kw):
    base = {"timed-out": False, "deferred": False, "degraded": False,
            "fired": [], "actions": [], "deadline-s": 60.0}
    base.update(kw)
    return base


_SOLO = {"valid?": True, "frontier-max": 3, "duration-ms": 9}
ORACLE_CASES = {
    "identity-recovered": ({"linear": _SOLO}, _outcome(
        results={"linear": {"valid?": True, "frontier-max": 3,
                            "duration-ms": 12,
                            "recovered": {"faults": ["oom"],
                                          "retries": 1}}},
        fired=[("oom", "s", 1)]), None),
    "identity-diverged": ({"linear": _SOLO}, _outcome(
        results={"linear": {"valid?": True, "frontier-max": 4}},
        fired=[("oom", "s", 1)]), None),
    "violation-missed": ({"linear": {"valid?": False, "frontier-max": 3}},
                         _outcome(results={"linear": {"valid?": True}},
                                  degraded=True, fired=[("oom", "s", 1)]),
                         None),
    "stamp-missing": ({"linear": {"valid?": True}}, _outcome(
        results={"linear": {"valid?": True}}, fired=[("oom", "s", 1)]),
        None),
    "stamp-promotion": ({"linear": {"valid?": True}}, _outcome(
        results={"linear": {"valid?": True}}, fired=[("oom", "s", 1)],
        actions=["kill-recover"]), None),
    "stamp-no-verdict": ({"linear": {"valid?": True}},
                         _outcome(results=None, deferred=True), None),
    "watchdog-resources": ({"linear": {"valid?": True}}, _outcome(
        results=None, **{"timed-out": True}),
        {"fds-before": 8, "fds-after": 9, "threads-before": 2,
         "threads-after": 2}),
}
EXPECT = {
    "identity-recovered": set(),
    "identity-diverged": {"verdict-identity"},
    "violation-missed": {"violation-missed"},
    "stamp-missing": {"stamp-consistency"},
    "stamp-promotion": set(),
    "stamp-no-verdict": {"stamp-consistency"},
    "watchdog-resources": {"watchdog", "resource-leak"},
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracles_equal_the_jax_package(case):
    baseline, outcome, resources = ORACLE_CASES[case]
    got = oracles_mod.check_oracles(baseline, outcome, resources)
    assert got == joracles.check_oracles(baseline, outcome, resources)
    names = {f["oracle"] for f in got}
    assert EXPECT[case] <= names
    if not EXPECT[case]:
        assert got == []
    assert oracles_mod.ORACLES == joracles.ORACLES


def test_port_launch_counts_are_execution_tallies_not_verdict_content():
    """A retried chunk counts its launches and host reads again: the
    port-only counters do not enter verdict-identity, every key the JAX
    oracle compares still does."""
    solo = {"valid?": True, "op-count": 46, "closure-rounds": 24,
            "dedup-launches": 0, "host-syncs": 75}
    again = dict(solo, **{"host-syncs": 77, "closure-rounds": 26,
                          "recovered": {"faults": ["oom"], "retries": 1}})
    fired = [("oom", "s", 1)]
    assert oracles_mod.check_oracles(
        {"linear": solo}, _outcome(results={"linear": again},
                                   fired=fired)) == []
    wrong = dict(again, **{"op-count": 47})
    assert {f["oracle"] for f in oracles_mod.check_oracles(
        {"linear": solo}, _outcome(results={"linear": wrong},
                                   fired=fired))} == {"verdict-identity"}


def test_chaos_coverage_distinguishes_replay_conjunction():
    plain = [{"event": "fault", "site": "stream-chunk/t", "kind": "oom",
              "retry": 1}]
    conj = plain + [{"event": "replay-begin", "site": "stream-chunk/t",
                     "from_chunk": 2},
                    {"event": "fault", "site": "stream-chunk/t",
                     "kind": "compile", "retry": 2}]
    c_plain = extract_chaos_coverage(plain)
    c_conj = extract_chaos_coverage(conj)
    assert c_conj.bits - c_plain.bits
    assert c_conj.overlap_bits > c_plain.overlap_bits
    assert not driver.replay_conjunction(plain)
    assert driver.replay_conjunction(conj)
    closed = conj + [{"event": "replay-end", "site": "stream-chunk/t",
                      "replayed": 64}]
    assert driver.replay_conjunction(closed) == \
        jdriver.replay_conjunction(closed) is True


# -- run_chaos -----------------------------------------------------------------

def _artifact(d):
    with open(os.path.join(d, "chaos.json")) as f:
        art = _no_wall(json.load(f))
    art["config"]["store_dir"] = os.path.basename(
        art["config"]["store_dir"]).split("-", 1)[1]
    with open(os.path.join(d, "coverage.bin"), "rb") as f:
        return art, f.read()


@pytest.mark.parametrize("workload", ["register", "register-corrupt"])
def test_run_chaos_equals_the_jax_package(tmp_path, workload):
    jd = str(tmp_path / f"jax-{workload}")
    pd = str(tmp_path / f"port-{workload}")
    before = set(threading.enumerate())
    want = jdriver.run_chaos(jdriver.ChaosConfig(
        budget=6, ops=64, seed=23, workload=workload, store_dir=jd))
    got = run_chaos(ChaosConfig(budget=6, ops=64, seed=23,
                                workload=workload, store_dir=pd,
                                device="cpu"))
    assert _no_wall(got) == _no_wall(want)
    assert got["failures"] == [] and got["found"] is False
    assert got["schedules"] == 6 and got["coverage-bits"] > 0
    art, blob = _artifact(pd)
    assert (art, blob) == _artifact(jd)
    assert "device" not in art["config"]
    assert CoverageMap.decode(blob).digest() == got["coverage-digest"]
    for entry in art["corpus"]:
        assert ChaosGenome.from_dict(entry["genome"]).to_dict() == \
            entry["genome"]
    # every service worker either run started is gone (a worker that
    # outlived its service would abort the interpreter at exit)
    alive = [t.name for t in set(threading.enumerate()) - before
             if t.name.startswith("jepsen-service-") and t.is_alive()]
    assert alive == []


class _SkipReplay(streaming.WglStream):
    """A planted defect: the recovery replay rung restores the
    checkpoint and silently drops the steps-log tail past it."""

    def _restore_and_replay(self):
        saved = self._steps_log
        rows0 = self._ckpt[0] if self._ckpt is not None else 0
        kept, got = [], 0
        for a in saved:
            if got + len(a) <= rows0:
                kept.append(a)
                got += len(a)
            elif got < rows0:
                kept.append(a[:rows0 - got])
                got = rows0
            else:
                break
        self._steps_log = kept
        try:
            return super()._restore_and_replay()
        finally:
            self._steps_log = saved


def test_planted_skipped_replay_rung_caught_and_shrunk(monkeypatch):
    """The JAX package's mutation test on the port, its defect in a
    scratch subclass: verdict-identity catches it and the failing
    schedule shrinks to <= 3 events."""
    monkeypatch.setattr(streaming, "WglStream", _SkipReplay)
    c = driver._Chaos(ChaosConfig(budget=60, seed=3, ops=256,
                                  workload="register-corrupt",
                                  device="cpu"))
    g = ChaosGenome(seed=5, workload="register-corrupt", ops=256,
                    events=(ChaosEvent("oom", 2), ChaosEvent("bitflip", 1),
                            ChaosEvent("device-lost", 17)))
    out = c.run_schedule(g)
    assert any(f["oracle"] == "verdict-identity" for f in out["failures"])
    c._record_failure(g, out)
    minimized = c.failures[0]["minimized"]
    assert len(minimized["events"]) <= 3
    assert c.shrink_steps > 0


def test_chaos_refuses_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_chaos(ChaosConfig(budget=1))
