"""Deterministic in-memory execution of generators, for tests.

Mirrors the reference's simulator (`jepsen/src/jepsen/generator/test.clj:
50-182`): run a generator against a synthetic executor function
`complete(ctx, invoke) -> completion op`, with the module RNG pinned to
seed 45100 so op streams are exactly reproducible. The harnesses:

  quick        — every op succeeds instantly (zero latency)
  perfect      — every op succeeds in 10 ns
  perfect_info — every op crashes :info in 10 ns
  imperfect    — each thread cycles fail -> info -> ok, 10 ns each

The port's own copy of `jepsen_tpu/generator/simulate.py`.
"""

from __future__ import annotations

from typing import Callable, Optional

from . import (NEMESIS, PENDING, Context, context, fixed_rng,
               next_process, process_to_thread, validate)
from . import op as gen_op
from . import update as gen_update

DEFAULT_TEST: dict = {}
RAND_SEED = 45100
PERFECT_LATENCY = 10  # ns


def n_plus_nemesis_context(n: int) -> Context:
    return context({"concurrency": n})


def default_context() -> Context:
    return n_plus_nemesis_context(2)


def invocations(history: list) -> list:
    return [o for o in history if o.get("type") == "invoke"]


def simulate(ctx_or_gen, gen_or_complete, complete: Optional[Callable]
             = None, seed: int = RAND_SEED, test: dict = DEFAULT_TEST,
             max_ops: Optional[int] = None) -> list:
    """simulate([ctx,] gen, complete_fn) -> full history.

    Single-threaded discrete-event loop: take the generator's next
    invocation if it precedes every in-flight completion; otherwise apply
    the earliest completion first (freeing its thread, retiring crashed
    processes). Deterministic under the fixed seed. `test` is the test
    map handed to fn-generators; defaults to {} but suite-level
    simulations pass the real test map so generators that read test keys
    (nodes, concurrency, workload opts) behave as they would live.
    `max_ops` bounds the history: a generator whose state machine needs
    live client/nemesis side effects to advance (which a simulation
    cannot provide) would otherwise spin at a frozen virtual time.
    """
    if complete is None:
        ctx, gen, complete = default_context(), ctx_or_gen, gen_or_complete
    else:
        ctx, gen = ctx_or_gen, gen_or_complete

    with fixed_rng(seed):
        ops: list = []
        in_flight: list = []  # completions, kept sorted by time
        gen = validate(gen)
        def _finish():
            # in-flight sleeps/wakes stay out of the history, same as
            # the completion branch below and the interpreter's
            # goes_in_history()
            ops.extend(o for o in in_flight
                       if o.get("type") not in ("sleep", "log"))
            return ops

        while True:
            if max_ops is not None and len(ops) >= max_ops:
                return _finish()
            res = gen_op(gen, test, ctx)
            if res is None:
                return _finish()
            invoke, gen1 = res
            if invoke is not PENDING and (
                    not in_flight
                    or invoke["time"] <= in_flight[0]["time"]):
                # invocation precedes every in-flight completion
                thread = process_to_thread(ctx, invoke["process"])
                ctx = ctx.with_time(max(ctx.time, invoke["time"]))
                ctx = ctx.busy(thread)
                gen = gen_update(gen1, test, ctx, invoke)
                if invoke.get("type") == "sleep":
                    # mirror the interpreter (`interpreter.py:141-143`):
                    # the thread wakes value seconds later; sleeps stay
                    # out of the history
                    comp = dict(invoke)
                    comp["time"] = invoke["time"] + int(
                        invoke["value"] * 1e9)
                elif invoke.get("type") == "log":
                    comp = dict(invoke)
                else:
                    comp = complete(ctx, invoke)
                    ops.append(invoke)
                in_flight.append(comp)
                in_flight.sort(key=lambda o: o["time"])
            else:
                # must complete something first
                assert in_flight, \
                    "generator pending and nothing in flight"
                comp = in_flight.pop(0)
                thread = process_to_thread(ctx, comp["process"])
                ctx = ctx.with_time(max(ctx.time, comp["time"]))
                ctx = ctx.free(thread)
                gen = gen_update(gen, test, ctx, comp)
                if thread != NEMESIS and comp.get("type") == "info":
                    workers = dict(ctx.workers)
                    workers[thread] = next_process(ctx, thread)
                    ctx = ctx.with_workers(workers)
                if comp.get("type") not in ("sleep", "log"):
                    ops.append(comp)


def _ok(ctx, invoke):
    out = dict(invoke)
    out["type"] = "ok"
    return out


def quick_ops(ctx_or_gen, gen=None, test: dict = DEFAULT_TEST,
              max_ops: Optional[int] = None) -> list:
    if gen is None:
        ctx_or_gen, gen = default_context(), ctx_or_gen
    return simulate(ctx_or_gen, gen, _ok, test=test, max_ops=max_ops)


def quick(ctx_or_gen, gen=None) -> list:
    return invocations(quick_ops(ctx_or_gen, gen)
                       if gen is not None else quick_ops(ctx_or_gen))


def _latency(type_: str):
    def complete(ctx, invoke):
        out = dict(invoke)
        out["type"] = type_
        out["time"] = invoke["time"] + PERFECT_LATENCY
        return out
    return complete


def perfect_star(ctx_or_gen, gen=None) -> list:
    if gen is None:
        ctx_or_gen, gen = default_context(), ctx_or_gen
    return simulate(ctx_or_gen, gen, _latency("ok"))


def perfect(ctx_or_gen, gen=None) -> list:
    return invocations(perfect_star(ctx_or_gen, gen)
                       if gen is not None else perfect_star(ctx_or_gen))


def perfect_info(ctx_or_gen, gen=None) -> list:
    if gen is None:
        ctx_or_gen, gen = default_context(), ctx_or_gen
    return invocations(simulate(ctx_or_gen, gen, _latency("info")))


def imperfect(ctx_or_gen, gen=None) -> list:
    """Threads cycle fail -> info -> ok; returns the full history."""
    if gen is None:
        ctx_or_gen, gen = default_context(), ctx_or_gen
    state: dict = {}
    nxt = {None: "fail", "fail": "info", "info": "ok", "ok": "fail"}

    def complete(ctx, invoke):
        t = process_to_thread(ctx, invoke["process"])
        state[t] = nxt[state.get(t)]
        out = dict(invoke)
        out["type"] = state[t]
        out["time"] = invoke["time"] + PERFECT_LATENCY
        return out

    return simulate(ctx_or_gen, gen, complete)
