"""The port's nine remaining workloads (bank, long_fork, adya, causal,
causal_reverse, table, comments, monotonic, sequential) against the JAX
package's: under a fixed generator seed they generate the same ops;
their checkers give equal results on the same simulated histories, valid
and with a planted anomaly; and the monotonic and sequential test maps
of `chip_smoke.py`'s workloads phase, with its planted store, run end to
end through the port's `core.run`, their stored histories judged alike
by both packages' checkers."""

import dataclasses

import pytest
import torch

import chip_smoke
from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jind
from jepsen_tpu.generator import simulate as jsim
from jepsen_tpu.history import history as jhistory
from jepsen_tpu.workloads import (adya as jadya, bank as jbank,
                                  causal as jcausal,
                                  causal_reverse as jcausal_reverse,
                                  comments as jcomments,
                                  long_fork as jlong_fork,
                                  monotonic as jmonotonic,
                                  sequential as jsequential, table as jtable)
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.generator import simulate as tsim
from jepsen_tpu_torch.history import history as thistory
from jepsen_tpu_torch.workloads import (adya as tadya, bank as tbank,
                                        causal as tcausal,
                                        causal_reverse as tcausal_reverse,
                                        comments as tcomments,
                                        long_fork as tlong_fork,
                                        monotonic as tmonotonic,
                                        sequential as tsequential,
                                        table as ttable)


def _bundles(bank, long_fork, adya, causal, causal_reverse, table,
              comments, monotonic, sequential, opts):
    """Each workload's generator and checker from one package's modules
    (opts: extra workload options, the port's device)."""
    return {
        "bank": lambda: {"generator": bank.generator(),
                         "checker": bank.test()["checker"]},
        "long_fork": lambda: long_fork.workload(2),
        "adya": lambda: adya.workload(),
        "causal": lambda: {
            "generator": causal.test({"time-limit": 100})["generator"],
            "checker": causal.test()["checker"]},
        "causal_reverse": lambda: causal_reverse.workload(
            {"nodes": ["a", "b", "c"], "per-key-limit": 12}),
        "table": lambda: table.workload(),
        "comments": lambda: comments.workload(),
        "monotonic": lambda: monotonic.workload(dict(opts)),
        "sequential": lambda: sequential.workload(dict(opts)),
    }


JAX = dict(gen=jgen, sim=jsim, history=jhistory, w=_bundles(
    jbank, jlong_fork, jadya, jcausal, jcausal_reverse, jtable, jcomments,
    jmonotonic, jsequential, {}))
PORT = dict(gen=tgen, sim=tsim, history=thistory, w=_bundles(
    tbank, tlong_fork, tadya, tcausal, tcausal_reverse, ttable, tcomments,
    tmonotonic, tsequential, {"device": "cpu"}))
NAMES = list(PORT["w"])
BANK_TEST = jbank.test()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(x):
    """A result with each package's own dataclasses (the causal model's
    final state) replaced by their class name and fields, so two
    packages' results compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, _plain(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# -- generators ---------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [45100, 3])
def test_generators_give_the_jax_packages_ops(name, seed):
    def ops(pkg):
        gen, sim = pkg["gen"], pkg["sim"]
        with gen.fixed_rng(seed):
            w = pkg["w"][name]()
            return sim.quick_ops(sim.n_plus_nemesis_context(6),
                                 gen.limit(150, w["generator"]),
                                 test=BANK_TEST, max_ops=400)

    t, j = ops(PORT), ops(JAX)
    assert len(t) > 20
    assert t == j


# -- checkers on simulated histories -----------------------------------------

def _bank_complete():
    bal = {a: 0 for a in BANK_TEST["accounts"]}
    bal[0] = BANK_TEST["total-amount"]

    def complete(ctx, invoke):
        out = dict(invoke, type="ok")
        if invoke["f"] == "read":
            out["value"] = dict(bal)
        else:
            v = invoke["value"]
            if bal[v["from"]] < v["amount"]:
                out["type"] = "fail"
            else:
                bal[v["from"]] -= v["amount"]
                bal[v["to"]] += v["amount"]
        return out
    return complete


def _bank_plant(ops):
    r = [o for o in ops if o["type"] == "ok" and o["f"] == "read"][3]
    r["value"] = {**r["value"], 1: r["value"][1] + 1}
    return ops


def _invoked_at(ops) -> dict:
    """Each completion's index -> its invocation's index."""
    out, open_ = {}, {}
    for i, o in enumerate(ops):
        if o["type"] == "invoke":
            open_[o["process"]] = i
        else:
            out[i] = open_.pop(o["process"])
    return out


def _kv_store_complete():
    """Registers for the txn workloads: 'r' micro-ops read, 'w' micro-ops
    write (a nil 'w' writes the prior value + 1)."""
    data = {}

    def complete(ctx, invoke):
        val = []
        for f, k, v in invoke["value"]:
            if f == "r":
                val.append(["r", k, data.get(k)])
            else:
                data[k] = v if v is not None else (data.get(k) or 0) + 1
                val.append(["w", k, data[k]])
        return dict(invoke, type="ok", value=val)
    return complete


def _long_fork_plant(ops):
    keys = sorted(o["value"][0][1] for o in ops
                  if o["type"] == "ok" and o["f"] == "write")
    k = next(k for k in keys if k % 2 == 0 and k + 1 in keys)
    t = max(o["time"] for o in ops) + 1
    for i, seen in enumerate(((1, None), (None, 1))):
        txn = [["r", k, seen[0]], ["r", k + 1, seen[1]]]
        ops += [{"type": "invoke", "f": "read",
                 "value": [["r", k, None], ["r", k + 1, None]],
                 "process": 100 + i, "time": t + 2 * i},
                {"type": "ok", "f": "read", "value": txn,
                 "process": 100 + i, "time": t + 2 * i + 1}]
    return ops


def _adya_complete():
    seen = set()

    def complete(ctx, invoke):
        k = invoke["value"].key
        ok = k not in seen
        seen.add(k)
        return dict(invoke, type="ok" if ok else "fail")
    return complete


def _adya_plant(ops):
    next(o for o in ops if o["type"] == "fail")["type"] = "ok"
    return ops


def _causal_complete():
    regs = {}

    def complete(ctx, invoke):
        k = invoke["value"].key
        r = regs.setdefault(k, {"value": 0, "pos": None, "n": 0})
        r["n"] += 1
        pos = 10 * k + r["n"]
        link = "init" if invoke["f"] == "read-init" else r["pos"]
        out = dict(invoke, type="ok", position=pos, link=link)
        if invoke["f"] == "write":
            r["value"] = invoke["value"].value
        else:
            out["value"] = jind.ktuple(k, r["value"])
        r["pos"] = pos
        return out
    return complete


def _causal_plant(ops):
    r = [o for o in ops if o["type"] == "ok" and o["f"] == "read"
         and o["value"].value == 2][0]
    r["value"] = jind.ktuple(r["value"].key, 1)
    return ops


def _causal_reverse_complete():
    written = {}

    def complete(ctx, invoke):
        k, v = invoke["value"].key, invoke["value"].value
        vs = written.setdefault(k, [])
        if invoke["f"] == "write":
            vs.append(v)
            return dict(invoke, type="ok")
        return dict(invoke, type="ok", value=jind.ktuple(k, sorted(vs)))
    return complete


def _causal_reverse_plant(ops):
    # a read that sees a write but not one acknowledged before it began
    for o in reversed(ops):
        if o["type"] != "ok" or o["f"] != "read":
            continue
        k, seen = o["value"].key, o["value"].value
        expected = jcausal_reverse.graph(
            [dict(x, value=x["value"].value) for x in ops
             if x["value"].key == k])
        drop = next((v for u in seen for v in expected.get(u, ())), None)
        if drop is not None:
            o["value"] = jind.ktuple(k, [v for v in seen if v != drop])
            return ops
    raise AssertionError("no read to plant in")


def _table_complete():
    created = set()

    def complete(ctx, invoke):
        out = dict(invoke, type="ok")
        if invoke["f"] == "create-table":
            created.add(invoke["value"])
        elif invoke["value"][0] not in created:
            out.update(type="fail",
                       error=["table-missing", invoke["value"][0]])
        return out
    return complete


def _table_plant(ops):
    # an insert begun after its table's create completed fails anyway
    inv, created = _invoked_at(ops), {}
    for i, o in enumerate(ops):
        if o["type"] == "ok" and o["f"] == "create-table":
            created.setdefault(o["value"], i)
        elif o["type"] == "ok" and o["f"] == "insert" and \
                inv[i] > created.get(o["value"][0], len(ops)):
            o.update(type="fail", error=["table-missing", o["value"][0]])
            return ops
    raise AssertionError("no insert to plant in")


def _comments_complete():
    ids = set()

    def complete(ctx, invoke):
        if invoke["f"] == "write":
            ids.add(invoke["value"])
            return dict(invoke, type="ok")
        return dict(invoke, type="ok", value=sorted(ids))
    return complete


def _comments_plant(ops):
    # a read begun after a write completed misses it
    inv, done = _invoked_at(ops), {}
    for i, o in enumerate(ops):
        if o["type"] == "ok" and o["f"] == "write":
            done[o["value"]] = i
        elif o["type"] == "ok" and o["f"] == "read":
            gone = [v for v in o["value"] if done[v] < inv[i]]
            if gone:
                o["value"] = [v for v in o["value"] if v != gone[0]]
                return ops
    raise AssertionError("no read to plant in")


def _monotonic_plant(ops):
    # a read begun after its key's latest write completed sees the
    # version before it: G-single-realtime
    inv, written = _invoked_at(ops), {}
    for i, o in enumerate(ops):
        if o["type"] != "ok":
            continue
        if o["f"] == "inc":
            written[o["value"][1][1]] = (o["value"][1][2], i)
        elif o["f"] == "read":
            for m in o["value"]:
                v, at = written.get(m[1], (None, len(ops)))
                if m[2] == v and v and at < inv[i]:
                    m[2] = v - 1 or None
                    return ops
    raise AssertionError("no read to plant in")


def _sequential_plant(ops):
    # a pair read sees the second write but not the first
    r = [o for o in ops if o["type"] == "ok" and o["f"] == "read"
         and o["value"][0][2] is not None][-1]
    r["value"][1][2] = None
    return ops


SIMULATED = {
    "bank": (_bank_complete, _bank_plant, 120),
    "long_fork": (_kv_store_complete, _long_fork_plant, 120),
    "adya": (_adya_complete, _adya_plant, 40),
    "causal": (_causal_complete, _causal_plant, 60),
    "causal_reverse": (_causal_reverse_complete, _causal_reverse_plant,
                       120),
    "table": (_table_complete, _table_plant, 120),
    "comments": (_comments_complete, _comments_plant, 120),
    "monotonic": (_kv_store_complete, _monotonic_plant, 150),
    "sequential": (_kv_store_complete, _sequential_plant, 150),
}


def _simulated(name, planted):
    complete, plant, n = SIMULATED[name]
    with jgen.fixed_rng(7):
        w = JAX["w"][name]()
        g = jgen.clients(jgen.limit(n, w["generator"])) \
            if name != "causal" else jgen.limit(n, w["generator"])
        client = complete()
        ops = jsim.simulate(
            jsim.n_plus_nemesis_context(6), g,
            lambda ctx, o: client(ctx, o) if isinstance(o["process"], int)
            else dict(o, type="info"), test=BANK_TEST, max_ops=4 * n)
    ops = [{k: v for k, v in o.items() if k != "index"} for o in ops
           if isinstance(o.get("process"), int)]
    return plant(ops) if planted else ops


def _port_kvs(ops):
    """The same ops with the JAX package's KVs as the port's."""
    return [dict(o, value=tind.ktuple(*o["value"]))
            if isinstance(o.get("value"), jind.KV) else o for o in ops]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("planted", [False, True], ids=["valid", "planted"])
def test_checkers_match_the_jax_package(name, planted):
    ops = _simulated(name, planted)
    test = BANK_TEST if name == "bank" else {}
    t = PORT["w"][name]()["checker"].check(test, thistory(_port_kvs(ops)),
                                           {})
    j = JAX["w"][name]()["checker"].check(test, jhistory(ops), {})
    assert _plain(t) == _plain(j)
    assert t["valid?"] is (not planted), t


# -- the workloads phase's runs, end to end on the CPU ------------------------

CHECKERS = {"monotonic": (tmonotonic, jmonotonic),
            "sequential": (tsequential, jsequential)}


@pytest.mark.parametrize("kind", ["monotonic", "sequential"])
def test_planted_runs_through_core_run(tmp_path, monkeypatch, kind):
    monkeypatch.setattr(chip_smoke, "WORKLOAD_RUN",
                        dict(concurrency=5, invocations=1_000))
    monkeypatch.setattr(chip_smoke, "RUN_NEMESIS_S", 1.0)
    monkeypatch.setattr(chip_smoke, "RUN_NEMESIS_CYCLE_S", 0.2)
    planted = chip_smoke.workload_client(kind, every=20, warmup=50)
    with tgen.fixed_rng(chip_smoke.SEED):
        t = chip_smoke.workload_run_test(kind, "cpu", str(tmp_path),
                                         chip_smoke.getent_remote(),
                                         client=planted)
        done = tcore.run(t)
    res = done["results"]["workload"]
    assert planted.planted >= 3
    assert res["valid?"] is False
    assert chip_smoke.WORKLOAD_ANOMALY[kind] in res["anomaly-types"]
    nem = {o["f"] for o in done["history"] if o["process"] == "nemesis"}
    assert nem == {"start", "stop"}
    stored = tstore.load_history(done)
    assert len(stored) == len(done["history"])
    port, jax_ = CHECKERS[kind]
    t_res = port.workload({"device": "cpu"})["checker"].check(
        {}, thistory(stored.ops), {})
    j_res = jax_.workload()["checker"].check({}, jhistory(stored.ops), {})
    assert t_res == j_res == res
