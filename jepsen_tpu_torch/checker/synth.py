"""Synthetic histories with known verdicts, for kernel golden tests and
benchmarks (the reference's perf_test.clj generates synthetic histories the
same way: `jepsen/test/jepsen/perf_test.clj`, tag :perf).

`register_history` builds a *valid-by-construction* concurrent register
history: a simulated linearizable register applies each op's effect at a
random point inside its invocation window (we use the invoke point, which
is always a legal linearization), with real overlap between processes and
optional crashed ops. `corrupt` then breaks a valid history in a way the
checker must catch (stale read).

The port's own copy of the register generators of
`jepsen_tpu/checker/synth.py` (the port imports nothing of the JAX
package); tests/test_torch_host.py holds the two copies to the same
histories.
"""

from __future__ import annotations

import random
from typing import Any

from ..history import History


def register_history(n_ops: int, concurrency: int = 5, values: int = 5,
                     crash_rate: float = 0.02, cas: bool = True,
                     seed: int = 45100) -> History:
    """A valid concurrent read/write/cas register history.

    One logical process per concurrency slot; crashed processes are retired
    and replaced (process id += concurrency, mirroring the interpreter's
    process-retirement rule)."""
    rng = random.Random(seed)
    ops: list[dict] = []
    t = 0
    value = None  # the register's true value (linearize at invoke)
    process = {i: i for i in range(concurrency)}
    pending: dict[int, dict] = {}  # slot -> completion op to emit later
    emitted = 0

    def tick() -> int:
        nonlocal t
        t += rng.randint(1, 10)
        return t

    while emitted < n_ops or pending:
        slot = rng.randrange(concurrency)
        if slot in pending:
            # complete the in-flight op on this slot
            comp = pending.pop(slot)
            comp["time"] = tick()
            ops.append(comp)
            continue
        if emitted >= n_ops:
            # drain remaining slots
            for s in sorted(pending):
                comp = pending.pop(s)
                comp["time"] = tick()
                ops.append(comp)
            break
        p = process[slot]
        f = rng.choice(["read", "write", "cas"] if cas
                       else ["read", "write"])
        if f == "read":
            inv = {"type": "invoke", "f": "read", "value": None,
                   "process": p, "time": tick()}
            comp = {**inv, "type": "ok", "value": value}
        elif f == "write":
            v = rng.randrange(values)
            inv = {"type": "invoke", "f": "write", "value": v,
                   "process": p, "time": tick()}
            value = v  # linearization point at invoke
            comp = {**inv, "type": "ok"}
        else:
            old, new = rng.randrange(values), rng.randrange(values)
            inv = {"type": "invoke", "f": "cas", "value": (old, new),
                   "process": p, "time": tick()}
            if value == old:
                value = new
                comp = {**inv, "type": "ok"}
            else:
                comp = {**inv, "type": "fail"}
        ops.append(inv)
        emitted += 1
        if rng.random() < crash_rate and f != "read":
            # crash: op stays pending forever; its effect may or may not
            # have applied (we applied writes, which is legal), and the
            # process retires
            comp["type"] = "info"
            comp["time"] = tick()
            ops.append(comp)
            process[slot] = p + concurrency
        else:
            pending[slot] = comp
    return History(ops)


def adversarial_register_history(n_ops: int, concurrency: int = 6,
                                 crashed_writes: int = 9, values: int = 5,
                                 front_load: bool = False,
                                 seed: int = 45100) -> History:
    """A valid-by-construction register history engineered to explode
    sequential JIT-linearization search, the exact shape the reference
    calls out as the hours/32 GB case (`checker.clj:213-216`:
    crashed ops "hold slots forever").

    `crashed_writes` writes crash (:info) at evenly spaced points and
    their values are *never applied*: each such write may legally
    linearize at any later point or never, so every one permanently
    doubles the set of reachable configurations a checker must carry
    — after k crashes a sequential search juggles ~2^k × |states|
    configurations per completion, while the device frontier holds
    them as rows of one array. `concurrency` live slots keep real
    overlap on top.

    front_load=True crashes all writes in the first ~5% of the
    history, so the search runs at full configuration width for the
    remaining 95% — maximum sequential pain per unit of width."""
    rng = random.Random(seed)
    ops: list[dict] = []
    t = 0
    value = None
    process = {i: i for i in range(concurrency)}
    pending: dict[int, dict] = {}
    emitted = 0
    if front_load:
        gap = max(1, (n_ops // 20) // (crashed_writes + 1))
        crash_at = {(i + 1) * gap for i in range(crashed_writes)}
    else:
        crash_at = {round((i + 1) * n_ops / (crashed_writes + 1))
                    for i in range(crashed_writes)}

    def tick() -> int:
        nonlocal t
        t += rng.randint(1, 10)
        return t

    while emitted < n_ops or pending:
        slot = rng.randrange(concurrency)
        if slot in pending:
            comp = pending.pop(slot)
            comp["time"] = tick()
            ops.append(comp)
            continue
        if emitted >= n_ops:
            for s in sorted(pending):
                comp = pending.pop(s)
                comp["time"] = tick()
                ops.append(comp)
            break
        p = process[slot]
        if emitted in crash_at:
            # a crashed write whose value never takes effect: the op
            # stays pending forever and may linearize at any point
            v = rng.randrange(values)
            inv = {"type": "invoke", "f": "write", "value": v,
                   "process": p, "time": tick()}
            ops.append(inv)
            ops.append({**inv, "type": "info", "time": tick()})
            emitted += 1
            process[slot] = p + concurrency  # crashed process retires
            continue
        f = rng.choice(["read", "write", "cas"])
        if f == "read":
            inv = {"type": "invoke", "f": "read", "value": None,
                   "process": p, "time": tick()}
            comp = {**inv, "type": "ok", "value": value}
        elif f == "write":
            v = rng.randrange(values)
            inv = {"type": "invoke", "f": "write", "value": v,
                   "process": p, "time": tick()}
            value = v
            comp = {**inv, "type": "ok"}
        else:
            old, new = rng.randrange(values), rng.randrange(values)
            inv = {"type": "invoke", "f": "cas", "value": (old, new),
                   "process": p, "time": tick()}
            if value == old:
                value = new
                comp = {**inv, "type": "ok"}
            else:
                comp = {**inv, "type": "fail"}
        ops.append(inv)
        emitted += 1
        pending[slot] = comp
    return History(ops)


def corrupt(hist: History, seed: int = 7, value: Any = 10 ** 6) -> History:
    """Break a valid register history: rewrite one :ok read to a value that
    was never current at any point in its window (forced stale/phantom).

    value: the phantom read. The default lies far outside the generators'
    domain, which also widens the history's state range past the dense
    engine's DENSE_STATE_CAP; one past the domain (``value=values``) is
    just as illegal and keeps the dense table's state axis small."""
    rng = random.Random(seed)
    ops = [dict(o) for o in hist.ops]
    reads = [i for i, o in enumerate(ops)
             if o["type"] == "ok" and o["f"] == "read"]
    if not reads:
        raise ValueError("history has no ok reads to corrupt")
    i = rng.choice(reads)
    # a value outside the generator's domain can never be read legally
    # (NIL aside), so this must be caught
    ops[i]["value"] = value
    return History(ops)
