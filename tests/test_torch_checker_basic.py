"""The port's host checkers (`checker.basic`, `clock`, `timeline`,
`perf`) and its SVG plotter: every case of tests/test_perf_plots.py, run
on the port; then each checker of both packages over the same seeded
histories gives the same result and writes byte-equal SVG and HTML
files."""

import random
from pathlib import Path

import pytest

import torch_mirror
from jepsen_tpu import checker as jc
from jepsen_tpu import models as jm
from jepsen_tpu.checker import timeline as jtimeline
from jepsen_tpu.history import history as jhistory
from jepsen_tpu_torch import checker as tc
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.checker import timeline as ttimeline
from jepsen_tpu_torch.history import history as thistory

globals().update(torch_mirror.cases("test_perf_plots"))

JAX = dict(c=jc, m=jm, timeline=jtimeline, history=jhistory)
PORT = dict(c=tc, m=tm, timeline=ttimeline, history=thistory)

MS = 1_000_000


def _ops(kind: str, seed: int, n: int = 120) -> list:
    """A concurrent history of `kind` ops over 4 processes, with
    completions of every type, an exception on some :infos, a nemesis
    window and clock-offset checks."""
    rng = random.Random(seed)
    ops, t, open_ = [], 0, {}
    counter_total = 0
    added = []
    ids = iter(range(10**6))
    for i in range(n):
        t += rng.randint(1, 40) * MS
        p = rng.randrange(4)
        if p in open_:
            inv = open_.pop(p)
            typ = rng.choices(["ok", "fail", "info"], [8, 1, 1])[0]
            out = {**inv, "type": typ, "time": t}
            if typ == "info" and rng.random() < 0.5:
                out["exception"] = {"class": rng.choice(
                    ["TimeoutError", "IOError"]), "message": f"x{i}"}
            if typ == "ok":
                f = inv["f"]
                if f == "read" and kind == "register":
                    out["value"] = rng.randrange(5)
                elif f == "read" and kind == "set":
                    out["value"] = sorted(rng.sample(
                        added, k=min(len(added), 3)) + [-1] * (i == 90))
                elif f == "read" and kind == "counter":
                    out["value"] = counter_total + rng.choice([0, 0, 7])
                elif f == "add" and kind == "counter":
                    counter_total += inv["value"]
                elif f == "add":
                    added.append(inv["value"])
                elif f == "dequeue":
                    out["value"] = rng.choice(added) if added else None
                elif f == "drain":
                    out["value"] = list(added)
                elif f == "generate":
                    out["value"] = next(ids) if i != 70 else 3
            ops.append(out)
            continue
        f, v = {
            "register": lambda: rng.choice(
                [("read", None), ("write", rng.randrange(5)),
                 ("cas", [rng.randrange(5), rng.randrange(5)])]),
            "set": lambda: rng.choice([("add", i), ("add", i),
                                       ("read", None)]),
            "queue": lambda: rng.choice([("enqueue", i), ("enqueue", i),
                                         ("dequeue", None)]),
            "counter": lambda: rng.choice([("add", rng.randint(1, 3)),
                                           ("read", None)]),
            "ids": lambda: ("generate", None),
        }[kind]()
        if kind == "queue" and f == "enqueue":
            added.append(v)
        inv = {"type": "invoke", "f": f, "value": v, "process": p,
               "time": t}
        open_[p] = inv
        ops.append(inv)
    if kind == "queue":
        t += MS
        ops += [{"type": "invoke", "f": "drain", "value": None,
                 "process": 9, "time": t},
                {"type": "ok", "f": "drain", "value": list(added),
                 "process": 9, "time": t + MS}]
    mid = ops[len(ops) // 3]["time"]
    for j, (f, value) in enumerate([("start", None), ("start", "cut"),
                                    ("check-offsets", None),
                                    ("check-offsets", None),
                                    ("stop", None), ("stop", "healed")]):
        o = {"type": "invoke" if j % 2 == 0 else "info", "f": f,
             "value": value, "process": "nemesis",
             "time": mid + (j * 7 + 1) * MS}
        if f == "check-offsets" and j % 2:
            o["clock-offsets"] = {"n1": 0.25 * seed, "n2": -0.5}
        ops.append(o)
    ops.sort(key=lambda o: o["time"])
    return ops


CHECKERS = [
    ("stats", "register", lambda p: p["c"].stats()),
    ("unhandled-exceptions", "register",
     lambda p: p["c"].unhandled_exceptions()),
    ("set", "set", lambda p: p["c"].set_checker()),
    ("set-full", "set", lambda p: p["c"].set_full()),
    ("set-full-linearizable", "set",
     lambda p: p["c"].set_full(linearizable=True)),
    ("queue", "queue", lambda p: p["c"].queue(p["m"].unordered_queue())),
    ("total-queue", "queue", lambda p: p["c"].total_queue()),
    ("unique-ids", "ids", lambda p: p["c"].unique_ids()),
    ("counter", "counter", lambda p: p["c"].counter()),
    ("counter-plot", "counter", lambda p: p["c"].counter_plot()),
    ("perf", "register", lambda p: p["c"].perf_checker()),
    ("latency-graph", "set", lambda p: p["c"].latency_graph()),
    ("rate-graph", "queue", lambda p: p["c"].rate_graph()),
    ("clock-plot", "register", lambda p: p["c"].clock_plot()),
    ("timeline", "register", lambda p: p["timeline"].html()),
    ("compose", "counter", lambda p: p["c"].compose({
        "stats": p["c"].stats(), "counter": p["c"].counter(),
        "perf": p["c"].perf_checker(),
        "timeline": p["timeline"].html()})),
]


def _files(root: Path) -> dict:
    return {str(f.relative_to(root)): f.read_bytes()
            for f in sorted(root.rglob("*")) if f.is_file()}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name,kind,make", CHECKERS,
                         ids=[n for n, _, _ in CHECKERS])
def test_checker_matches_the_jax_package(tmp_path, name, kind, make, seed):
    ops = _ops(kind, seed)
    out = {}
    for pkg_name, pkg in (("port", PORT), ("jax", JAX)):
        test = {"name": "basic", "start-time": "t0",
                "nodes": ["n1", "n2"],
                "store-dir": str(tmp_path / pkg_name)}
        out[pkg_name] = make(pkg).check(
            test, pkg["history"](ops).index(), {})
    assert out["port"] == out["jax"]
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    if name in ("counter-plot", "perf", "clock-plot", "timeline"):
        assert files, name


def test_log_file_pattern_matches_the_jax_package(tmp_path):
    for node, text in (("n1", "ok\nPANIC: lost\n"), ("n2", "fine\n")):
        d = tmp_path / "store" / "basic" / "t0" / node
        d.mkdir(parents=True)
        (d / "db.log").write_text(text)
    test = {"name": "basic", "start-time": "t0", "nodes": ["n1", "n2"],
            "store-dir": str(tmp_path / "store")}
    t = tc.log_file_pattern("PANIC", "db.log").check(test, thistory([]), {})
    j = jc.log_file_pattern("PANIC", "db.log").check(test, jhistory([]), {})
    assert t == j and t["valid?"] is False
