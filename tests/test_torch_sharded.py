"""The port's key-sharded checking (`parallel`, `wgl.check_batch_sharded`,
the Elle mesh path) against the JAX package's over a 4-device virtual
mesh: the port runs in 4 spawned ranks joined under gloo, and every
rank must return exactly what the JAX package returns — `all_ok`,
`per_key`, the group plan, the attestation counts and the recovery
trail; the sharded list-append result, `analyze_edges` and
`transitive_closure`. Faults: an injected OOM on every rank (the split),
the same OOM on one rank only, a bit flip in the staged steps, the final
rung, a failure that is no device fault on one rank, and the Elle
classifier's retry and give-up, each reaching every rank without a hang;
a rank that outlives the join limit is killed. Each spawn joins its ranks
within JOIN_S seconds."""

import functools
import multiprocessing

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import jepsen_tpu._platform as jplat
import jepsen_tpu.control.retry as jretry
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu.checker.elle import kernels as jk
from jepsen_tpu.checker.elle import list_append as jla
from jepsen_tpu.history import History as JHistory
from jepsen_tpu_torch import _platform as tplat
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch import parallel
from jepsen_tpu_torch.checker import streaming as tstreaming
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl
from jepsen_tpu_torch.checker.elle import kernels as tk
from jepsen_tpu_torch.checker.elle import list_append as tla

WORLD = 4
JOIN_S = 120
CPU = "cpu"


@pytest.fixture(autouse=True)
def _jax_side(monkeypatch):
    """The JAX package prices and dedups as on its accelerator (the
    port's engine choice), retries without backoff, and starts with no
    injection; the port's ranks read the env each spawn hands them."""
    monkeypatch.setenv("JEPSEN_TPU_PALLAS_DEDUP", "1")
    monkeypatch.delenv(jplat.FAULT_INJECT_ENV, raising=False)
    monkeypatch.delenv("JEPSEN_TPU_ELLE_HOST", raising=False)
    monkeypatch.setattr(jretry, "backoff", lambda *a, **k: iter([0.0] * 99))
    jplat.reset_fault_injection()
    yield
    jplat.reset_fault_injection()


def _jmesh():
    assert len(jax.devices()) >= WORLD, "conftest forces 8 CPU devices"
    return JMesh(np.array(jax.devices()[:WORLD]), ("keys",))


def _regs(n, conc, seeds, **kw):
    return [tsynth.register_history(n, concurrency=conc(i), seed=s, **kw)
            for i, s in enumerate(seeds)]


def _cases() -> dict:
    """label -> (model name, histories, options): `tests/test_wgl.py`'s
    sharded batches (`:164`, `:200`, `:211`), the mixed buckets with a
    read that keeps them dense, and a counter batch."""
    keys16 = _regs(30, lambda i: 3, range(16))
    bad16 = list(keys16)
    bad16[5] = tsynth.corrupt(bad16[5])
    mixed = [tsynth.register_history(50, concurrency=3 + (i % 5), values=5,
                                     crash_rate=0.01, seed=200 + i)
             for i in range(12)]
    counter = [tsynth.counter_history(40, seed=s) for s in range(6)]
    counter[2] = tsynth.corrupt(counter[2], value=99)
    return {
        "valid-16": ("cas_register", keys16, dict(frontier=128, slots=16)),
        "corrupt-16": ("cas_register", bad16, dict(frontier=128, slots=16)),
        "mixed-buckets": ("cas_register", mixed, dict(slots=16)),
        "mixed-buckets-phantom": (
            "cas_register", mixed + [tsynth.corrupt(mixed[0], seed=3)],
            dict(slots=16)),
        "mixed-buckets-dense-bad": (
            "cas_register", mixed + [tsynth.corrupt(mixed[0], seed=3,
                                                    value=5)],
            dict(slots=16)),
        "forced-sort": ("cas_register", _regs(40, lambda i: 7, range(4)),
                        dict(slots=4, engine="sort")),
        "counter": ("counter", counter, dict(slots=16)),
    }


CASES = _cases()


def _port_call(label, **extra):
    mname, hists, kw = CASES[label]
    return functools.partial(twgl.check_batch_sharded,
                             getattr(tmodels, mname)(), hists,
                             return_info=True, device=CPU, **kw, **extra)


def _jax_result(label, **extra):
    mname, hists, kw = CASES[label]
    return jwgl.check_batch_sharded(
        getattr(jmodels, mname)(), [JHistory(h.ops) for h in hists],
        mesh=_jmesh(), axis="keys", return_info=True, **kw, **extra)


def _same_sharded(got, want, label):
    all_ok, per_key, info = got
    assert all_ok is bool(want[0]), label
    assert per_key.dtype == np.bool_ and np.array_equal(per_key, want[1]), \
        label
    assert info == want[2], label


def _append(n_cycles=11, seed=0):
    return tsynth.inject_append_cycles(tsynth.append_history(300, seed=seed),
                                       n_cycles, "G1c")


def _rings():
    """Three disjoint 20-node rings (G0, G-single, G2-item) and the
    JAX test's precedence graph: several SCC blocks to shard."""
    edges = {}
    for r, rw_at in enumerate(((), (6,), (5, 15))):
        for k in range(20):
            edges[(r * 20 + k, r * 20 + (k + 1) % 20)] = \
                frozenset({"rw"} if k in rw_at else {"ww"})
    return 60, edges


# `tests/test_elle_graphs.py:342`'s edges
PRECEDENCE = {(0, 1): frozenset({"realtime"}), (1, 0): frozenset({"rw"}),
              (2, 3): frozenset({"ww"}), (3, 2): frozenset({"ww"})}


def _chain(n):
    a = np.zeros((n, n), bool)
    for i in range(n - 1):
        a[i, i + 1] = True
    return a


def same(a, b, path="result"):
    """Exact equality of two result trees; numpy arrays by dtype and
    value."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _spawn(fns, env=None):
    """Every rank runs fns in order on one 4-rank gloo mesh, env[rank]'s
    variables set first; returns each rank's list of values."""
    return parallel.spawn(functools.partial(parallel.in_order, fns, env),
                          WORLD, device=CPU, timeout_s=JOIN_S)


def _everywhere(clause):
    return {r: {tplat.FAULT_INJECT_ENV: clause} for r in range(WORLD)}


# one spawn runs every clean call on the same 4-rank mesh
CLEAN = ([_port_call(label) for label in CASES]
         + [functools.partial(tla.check, _append(), device=CPU),
            functools.partial(tk.analyze_edges, *_rings(), device=CPU),
            functools.partial(tk.analyze_edges, 4, PRECEDENCE, device=CPU),
            functools.partial(tk.transitive_closure, _chain(10), device=CPU),
            functools.partial(tk.transitive_closure, _chain(300),
                              device=CPU)])


@pytest.fixture(scope="module")
def clean_ranks():
    return _spawn(CLEAN)


@pytest.mark.parametrize("label", list(CASES))
def test_sharded_batch_matches_jax_on_every_rank(label, clean_ranks):
    want = _jax_result(label)
    i = list(CASES).index(label)
    for rank, outs in enumerate(clean_ranks):
        _same_sharded(outs[i], want, f"{label} rank {rank}")


def test_sharded_elle_matches_jax_on_every_rank(clean_ranks):
    mesh = _jmesh()
    n = len(CASES)
    want = [jla.check(JHistory(_append().ops), mesh=mesh),
            jk.analyze_edges(*_rings(), mesh=mesh),
            jk.analyze_edges(4, PRECEDENCE, mesh=mesh),
            jk.transitive_closure(_chain(10), mesh=mesh),
            jk.transitive_closure(_chain(300), mesh=mesh)]
    assert want[0]["valid?"] is False and "G1c" in want[0]["anomaly-types"]
    assert want[2]["G-single-realtime"] and want[2]["G0"]
    assert want[3][0, 9] and not want[3].diagonal().any()
    for rank, outs in enumerate(clean_ranks):
        for j, w in enumerate(want):
            same(outs[n + j], w, f"rank {rank} elle call {j}")


def test_sharded_oom_splits_like_jax(monkeypatch):
    """`oom@sharded:1` on every rank: the first group's dispatch faults,
    the key list splits in halves re-sharded over the same ranks."""
    clause = "oom@sharded:1"
    got = _spawn([_port_call("mixed-buckets")], _everywhere(clause))
    monkeypatch.setenv(jplat.FAULT_INJECT_ENV, clause)
    want = _jax_result("mixed-buckets")
    assert want[2]["recovered"] == {"faults": ["oom"], "retries": 1,
                                    "split": True}
    for rank, (out,) in enumerate(got):
        _same_sharded(out, want, f"rank {rank}")


def test_fault_on_one_rank_reaches_every_rank(monkeypatch):
    """An OOM raised on rank 1 alone (the WGL groups) and on rank 3
    alone (the Elle classifier): every rank takes the same rung and
    returns what a fault on all ranks gives, the JAX package's trail and
    result."""
    env = {1: {tplat.FAULT_INJECT_ENV: "oom@sharded:1"},
           3: {tplat.FAULT_INJECT_ENV: "oom@elle:1"}}
    got = _spawn([_port_call("mixed-buckets"),
                  functools.partial(tla.check, _append(), device=CPU)], env)
    want_elle = jla.check(JHistory(_append().ops), mesh=_jmesh())
    monkeypatch.setenv(jplat.FAULT_INJECT_ENV, "oom@sharded:1")
    want = _jax_result("mixed-buckets")
    for rank, (wgl_out, elle_out) in enumerate(got):
        _same_sharded(wgl_out, want, f"rank {rank}")
        same(elle_out, want_elle, f"rank {rank} elle")


def test_bit_flip_in_the_staged_steps_is_caught_and_retried(monkeypatch):
    clause = "bitflip@sharded:1"
    got = _spawn([_port_call("valid-16")], _everywhere(clause))
    monkeypatch.setenv(jplat.FAULT_INJECT_ENV, clause)
    want = _jax_result("valid-16")
    assert want[2]["recovered"] == {"faults": ["corrupt"], "retries": 1}
    for rank, (out,) in enumerate(got):
        _same_sharded(out, want, f"rank {rank}")


def test_final_rung_falls_back_to_the_batch_entry_like_jax(monkeypatch):
    clause = "device-lost@sharded:1"
    got = _spawn([_port_call("corrupt-16", max_recovery_retries=0)],
                 _everywhere(clause))
    monkeypatch.setenv(jplat.FAULT_INJECT_ENV, clause)
    want = _jax_result("corrupt-16", max_recovery_retries=0)
    assert want[2] == {"groups": [], "recovered": {
        "faults": ["device-lost"], "retries": 1, "fallback": "batch"}}
    for rank, (out,) in enumerate(got):
        _same_sharded(out, want, f"rank {rank}")


def test_a_bug_on_one_rank_raises_on_every_rank():
    """An exception that is no device fault on rank 2 (an injected fault
    of a kind the classifier rejects): rank 2 re-raises it, the others
    raise PeerFault, and no rank waits for the join limit."""
    with pytest.raises(parallel.RankError) as ei:
        _spawn([_port_call("valid-16")],
               {2: {tplat.FAULT_INJECT_ENV: "bogus@sharded:1"}})
    errors = ei.value.errors
    assert sorted(errors) == list(range(WORLD))
    assert "InjectedFault" in errors[2]
    for r in (0, 1, 3):
        assert "PeerFault" in errors[r] and "join limit" not in errors[r]


def test_classifier_faulting_twice_on_one_rank_gives_up_everywhere():
    with pytest.raises(parallel.RankError) as ei:
        _spawn([functools.partial(tla.check, _append(), device=CPU)],
               {0: {tplat.FAULT_INJECT_ENV: "oom@elle:1,oom@elle:2"}})
    errors = ei.value.errors
    assert sorted(errors) == list(range(WORLD))
    assert all("ClassifierFaulted" in e for e in errors.values())


def test_ranks_past_the_join_limit_are_killed():
    with pytest.raises(parallel.RankError, match="join limit"):
        parallel.spawn(_port_call("valid-16"), WORLD, device=CPU,
                       timeout_s=0.5)
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("jepsen-rank-")]


def test_world_one_device_mesh_in_process(tmp_path):
    """A `DeviceMesh` over a one-rank gloo group in this process: the
    batch, list-append and a WrStream accept it and give the JAX
    package's single-device results; anything else raises TypeError."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        dm = init_device_mesh(CPU, (1,), mesh_dim_names=("keys",))
        mname, hists, kw = CASES["mixed-buckets-dense-bad"]
        got = twgl.check_batch_sharded(tmodels.cas_register(), hists, dm,
                                       return_info=True, device=CPU, **kw)
        one = JMesh(np.array(jax.devices()[:1]), ("keys",))
        want = jwgl.check_batch_sharded(
            jmodels.cas_register(), [JHistory(h.ops) for h in hists],
            mesh=one, return_info=True, **kw)
        _same_sharded(got, want, "device mesh")
        same(tla.check(_append(seed=4), mesh=dm, device=CPU),
             jla.check(JHistory(_append(seed=4).ops), mesh=one))
        st = tstreaming.WrStream(mesh=dm, device=CPU)
        for op in tsynth.wr_history(50, seed=1).ops:
            st.feed(op)
        assert st.finish()["valid?"] is True
    finally:
        dist.destroy_process_group()
    for bad in (object(), "keys", one):
        with pytest.raises(TypeError, match="DeviceMesh"):
            twgl.check_batch_sharded(tmodels.cas_register(), hists, bad,
                                     device=CPU)


def test_without_a_mesh_the_batch_runs_in_this_process_alone():
    mname, hists, kw = CASES["corrupt-16"]
    got = twgl.check_batch_sharded(tmodels.cas_register(), hists,
                                   return_info=True, device=CPU, **kw)
    want = jwgl.check_batch_sharded(
        jmodels.cas_register(), [JHistory(h.ops) for h in hists],
        mesh=JMesh(np.array(jax.devices()[:1]), ("keys",)),
        return_info=True, **kw)
    _same_sharded(got, want, "no mesh")
    with pytest.raises(ValueError, match="XLA route"):
        twgl.check_batch_sharded(tmodels.cas_register(), hists, pallas=False,
                                 device=CPU)
    assert torch.equal(
        parallel.all_gather_rows(parallel.local_mesh(CPU),
                                 torch.arange(3)), torch.arange(3))


def test_ranks_ask_for_cuda_unless_told_and_walk_on_the_mesh_device():
    """`init` and `spawn` default to CUDA and raise without it, before
    any rank joins; with a mesh, a device= of another type than the
    mesh's raises instead of walking off the collectives' device."""
    if torch.cuda.is_available():
        pytest.skip("the CUDA default holds only where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.spawn(_port_call("valid-16"), WORLD, timeout_s=JOIN_S)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init(0, 1, "file:///nonexistent/rendezvous")
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("jepsen-rank-")]
    mname, hists, kw = CASES["valid-16"]
    mesh = parallel.local_mesh(CPU)
    mesh.device = torch.device("cuda", 0)  # a CUDA rank's mesh, seen here
    with pytest.raises(ValueError, match="mesh's device"):
        twgl.check_batch_sharded(tmodels.cas_register(), hists, mesh,
                                 device=CPU, **kw)
    with pytest.raises(ValueError, match="mesh's device"):
        tk.transitive_closure(_chain(4), mesh=mesh, device=CPU)
