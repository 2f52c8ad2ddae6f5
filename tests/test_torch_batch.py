"""The port's batch entries against the JAX package's vmapped ones: the
batched carries of `DenseKernel` / `SortKernel.check_chunk_batch` equal
`jax.vmap(run_range)` of `_dense_kernel_cached` / `_kernel_cached`
element for element after every chunk, on the dense route (the Pallas
closure round under vmap in interpret mode) and the sort family's hash,
packed and lexicographic routes; `analysis_gpu_batch(device="cpu")`
equals `analysis_tpu_batch(..., pallas=True)` field for field; and the
batched plain versions of K1 and K2 equal `jax.vmap` of the Pallas
kernels in interpret mode, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import wgl as jwgl
from jepsen_tpu.checker import wgl_dedup as jdedup
from jepsen_tpu.checker import wgl_pallas
from jepsen_tpu.history import History as JHistory
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.carry import carry_from_numpy, carry_to_numpy
from jepsen_tpu_torch.checker import synth as tsynth
from jepsen_tpu_torch.checker import wgl as twgl
from jepsen_tpu_torch.checker.wgl_closure import closure_round_plain
from jepsen_tpu_torch.checker.wgl_dedup import dedup_plain


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the
    other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _regs(concs, n=40, seed=0, bad=()):
    """Register histories (the port's synth; the JAX package reads the
    same op dicts), one per concurrency, with keys in `bad` given a read
    one past the value domain."""
    hs = [tsynth.register_history(n, concurrency=c, values=4,
                                  crash_rate=0.05, seed=seed + i)
          for i, c in enumerate(concs)]
    return [tsynth.corrupt(h, seed=i, value=4) if i in bad else h
            for i, h in enumerate(hs)]


def _phantom(h, value):
    """One ok read set to `value` (the first read past op 10)."""
    ops = [dict(o) for o in h.ops]
    i = next(i for i, o in enumerate(ops) if i > 10 and o["type"] == "ok"
             and o["f"] == "read")
    ops[i]["value"] = value
    return tsynth.History(ops)


# label -> (model, histories, route, F, P)
ROUTES = {
    "dense": ("cas_register", lambda: _regs([3, 4, 5], bad=(1,)),
              "dense", None, 8),
    "hash": ("cas_register", lambda: _regs([3, 5, 4], seed=5, bad=(2,)),
             twgl.DEDUP_PALLAS, 16, 16),
    "packed": ("cas_register", lambda: _regs([4, 5, 3], seed=9, bad=(0,)),
               twgl.DEDUP_SORT, 16, 16),
    "lex": ("cas_register", lambda: [_phantom(h, 10 ** 6) if i == 1 else h
                                     for i, h in enumerate(
                                         _regs([3, 4, 5], seed=13))],
            twgl.DEDUP_SORT, 16, 16),
    "counter-hash": ("counter", lambda: [
        tsynth.counter_history(40, seed=1),
        tsynth.corrupt(tsynth.counter_history(40, seed=2), value=99),
        tsynth.counter_history(40, seed=3)], twgl.DEDUP_PALLAS, 16, 8),
}


def _batch_setup(label):
    mname, mk, route, F, P = ROUTES[label]
    jm, tm = getattr(jmodels, mname)(), getattr(tmodels, mname)()
    name = jm.device_model
    hs = mk()
    jops = [jwgl.encode_ops_for_model(jm, JHistory(h.ops)) for h in hs]
    tops = [twgl.encode_ops_for_model(tm, h) for h in hs]
    srange = jwgl._state_range(name, jm, jops)
    assert srange == twgl._state_range(name, tm, tops)
    E = jwgl._bucket(max(jwgl.event_count(o) for o in jops))
    jst = [jwgl.build_steps(o, P) for o in jops]
    # three keys and one zero-step padding entry, as the batch entry pads
    jpad = [s.pad_to(E) for s in jst] + [jwgl.Steps.empty(jst[0].w, E)]
    xj = jnp.asarray(np.stack([s.x for s in jpad]))
    ns = np.asarray([s.n for s in jpad], np.int64)
    tst = [twgl.build_steps(o, P) for o in tops]
    x_t, ns_t = twgl._stack_steps(tst, 4)
    np.testing.assert_array_equal(ns_t, ns)
    xs = twgl.stage_steps(x_t, "cpu")
    if route == "dense":
        dense = twgl._dense_shape(srange, P)
        assert dense == jwgl._dense_shape(srange, P)
        jk = jwgl._dense_kernel_cached(name, *dense, E, True, False, True)
        tk = twgl.DenseKernel(name, *dense, "cpu")
    else:
        pack = jwgl._pack_params(srange, P)
        assert (pack is not None) == (label != "lex")
        jk = jwgl._kernel_cached(name, F, P, E, pack,
                                 route == twgl.DEDUP_PALLAS, False, True)
        tk = twgl.SortKernel(name, F, P, pack, route, "cpu")
    return jk, tk, xj, xs, ns, jm.device_state()


def _assert_batched_carry_equal(tc, jc, where):
    tn, jn = carry_to_numpy(tc), jax.device_get(jc)
    assert len(tn) == len(jn)
    for i, (a, b) in enumerate(zip(tn, jn)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} elem {i}")


@pytest.mark.parametrize("label", list(ROUTES))
def test_batched_carries_equal_after_every_chunk(label):
    jk, tk, xj, xs, ns, init = _batch_setup(label)
    n_max = int(ns.max())
    chunk = max(n_max // 3, 1)
    jc = jax.vmap(jk.init_carry)(jnp.full(4, init, jnp.int32))
    tc = tk.init_carry_batch([init] * 4)
    _assert_batched_carry_equal(tc, jc, "init")
    for i, stop in enumerate(list(range(chunk, n_max, chunk)) + [n_max]):
        stops = np.minimum(ns, stop)
        jc = jk.check_chunk_batch(xj, jnp.asarray(stops, jnp.int32), jc)
        tc = tk.check_chunk_batch(xs, stops, tc)
        _assert_batched_carry_equal(tc, jc, f"chunk {i}")
        # per-key digests: the port's batched digest == vmap(digest)
        np.testing.assert_array_equal(
            np.asarray(tk.digest_batch(tc)),
            np.asarray(jax.vmap(jk.digest)(jc)))
    jsum = [np.asarray(v) for v in jax.vmap(jk.summarize)(jc)]
    tsum = tk.summarize_batch(tc)
    for a, b in zip(tsum, jsum):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert not jsum[0].all()           # each route has a dying key
    if label != "dense":
        assert tk.rounds > 0
        assert (tk.dedups > 0) == label.endswith("hash")


def test_batched_carry_round_trips_and_resumes_across_packages():
    jk, tk, xj, xs, ns, init = _batch_setup("hash")
    mid = np.minimum(ns, int(ns.max()) // 2)
    j0 = jax.device_get(jk.check_chunk_batch(
        xj, jnp.asarray(mid, jnp.int32),
        jax.vmap(jk.init_carry)(jnp.full(4, init, jnp.int32))))
    t1 = tk.check_chunk_batch(xs, ns, carry_from_numpy(j0, "cpu",
                                                       batch=True))
    j1 = jk.check_chunk_batch(xj, jnp.asarray(ns, jnp.int32), j0)
    _assert_batched_carry_equal(t1, j1, "jax -> torch")
    with pytest.raises(TypeError):
        carry_from_numpy(j0, "cpu")          # a batched carry, unbatched


# -- analysis_gpu_batch against analysis_tpu_batch(pallas=True) -----------

FIELDS = ("valid?", "op-index", "max-frontier", "dedup", "analyzer",
          "error", "op-count")


def _fields(r):
    out = {k: r.get(k) for k in FIELDS}
    out["analyzer"] = (out["analyzer"] or "").replace("gpu-", "tpu-")
    return out


def _both(hs, model="cas_register", **kw):
    j = jwgl.analysis_tpu_batch(getattr(jmodels, model)(),
                                [JHistory(h.ops) for h in hs],
                                pallas=True, **kw)
    t = twgl.analysis_gpu_batch(getattr(tmodels, model)(), hs,
                                device="cpu", **kw)
    assert [_fields(r) for r in t] == [_fields(r) for r in j]
    return t


CASES = {
    # two dense groups (P = 4 and 6) of 3 and 2 keys, each padded, one
    # invalid key blamed in each
    "groups": (lambda: _regs([2, 3, 6, 2, 6], n=40, seed=20, bad=(1, 2)),
               {}),
    # the sort family escalating overflow suspects from F = 4
    "escalate": (lambda: _regs([3, 4, 3], n=40, seed=30, bad=(1,)),
                 dict(engine="sort", slots=16, frontier=4,
                      max_frontier=64)),
    "budget-zero": (lambda: _regs([3, 4], n=30, seed=40),
                    dict(budget_s=0.0)),
    # key 1 needs more slots than the batch's 4: the scalar entry
    "past-slots": (lambda: _regs([2, 8, 3], n=30, seed=50),
                   dict(engine="sort", slots=4, frontier=64)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_analysis_batch_matches_jax(case):
    mk, kw = CASES[case]
    rs = _both(mk(), **kw)
    if case == "groups":
        shapes = {tuple(r["batch-walk"]["group"]) for r in rs}
        assert len(shapes) == 2
        assert sum(r["valid?"] is False for r in rs) == 2
        assert all(isinstance(r["op-index"], int) for r in rs
                   if r["valid?"] is False)
    elif case == "escalate":
        assert any(r["batch-walk"]["group"][1] > 4 for r in rs)
    elif case == "budget-zero":
        assert all(r["valid?"] == "unknown" for r in rs)
    else:
        assert rs[1]["analyzer"] == "gpu-wgl"       # the scalar entry
        assert rs[0]["analyzer"] == "gpu-wgl-batch"


def test_batch_forced_dense_raises_like_jax():
    hs = [tsynth.register_history(20, concurrency=2, seed=1),
          tsynth.corrupt(tsynth.register_history(20, concurrency=2,
                                                 seed=2))]
    with pytest.raises(ValueError, match="dense caps") as te:
        twgl.analysis_gpu_batch(tmodels.cas_register(), hs, device="cpu",
                                engine="dense")
    with pytest.raises(ValueError, match="dense caps") as je:
        jwgl.analysis_tpu_batch(jmodels.cas_register(),
                                [JHistory(h.ops) for h in hs],
                                engine="dense", pallas=True)
    assert str(te.value) == str(je.value)


def test_dispatch_groups_and_slot_bucket_match_jax():
    for p, pm in [(1, None), (3, 9), (5, 5), (7, 12), (2, 2)]:
        assert twgl._slot_bucket(p, pm) == jwgl._slot_bucket(p, pm)
    for srange, preq, engine in [((-1, 4), [2, 3, 6, 9, 13], "auto"),
                                 ((-1, 10 ** 6), [2, 3], "auto"),
                                 ((-1, 4), [4, 22, 5], "auto"),
                                 ((0, 600), [3, 4], "sort")]:
        t = twgl._dispatch_groups(srange, preq, engine, n_events=500)
        j = jwgl._dispatch_groups(srange, preq, engine, n_events=500,
                                  pallas=True)
        assert t == j


# -- K1 and K2 batched: plain versions against vmapped Pallas -------------

@pytest.mark.parametrize("S,P", [(8, 7), (16, 8)])
def test_k1_batched_plain_matches_vmapped_pallas(S, P):
    assert wgl_pallas.eligible(S, P)
    rng = np.random.default_rng(S + P)
    B = 3
    tb = rng.random((B, S, 1 << P)) < 0.03
    mft = (rng.random((B, P, S, S)) < 0.15).astype(np.uint8)
    fn = jax.vmap(wgl_pallas.closure_round_fn(S, P, interpret=True))
    for _ in range(3):
        want = np.asarray(fn(jnp.asarray(tb, jnp.float32),
                             jnp.asarray(mft, jnp.float32))) > 0
        got = closure_round_plain(torch.from_numpy(tb),
                                  torch.from_numpy(mft)).numpy()
        np.testing.assert_array_equal(got, want)
        for b in range(B):                   # row b == the scalar round
            np.testing.assert_array_equal(
                got[b], closure_round_plain(torch.from_numpy(tb[b]),
                                            torch.from_numpy(mft[b])))
        tb = got


@pytest.mark.parametrize("N,F", [(128, 64), (544, 32)])
def test_k2_batched_plain_matches_vmapped_pallas(N, F):
    rng = np.random.default_rng(N)
    keys = rng.integers(0, 40, (4, N)).astype(np.int32)
    keys[rng.random((4, N)) < 0.4] = -1
    keys[1] = -1                                        # all EMPTY
    keys[2] = rng.permutation(N).astype(np.int32)       # all distinct
    fn = jax.vmap(jdedup.dedup_fn(N, F, interpret=True))
    want = [np.asarray(a) for a in fn(jnp.asarray(keys))]
    got = dedup_plain(torch.from_numpy(keys), F)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    for b in range(4):                       # row b == the scalar call
        one = dedup_plain(torch.from_numpy(keys[b]), F)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
