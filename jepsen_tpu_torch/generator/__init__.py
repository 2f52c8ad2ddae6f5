"""Pure-functional operation scheduler (the reference's generator system,
`jepsen/src/jepsen/generator.clj`).

A *generator* is a value that, given a test map and a scheduling context,
yields the next operation to perform and an evolved generator. Generators
are immutable: `op` and `update` return new generators, never mutate. This
purity is what makes the deterministic simulator (generator/simulate.py)
and the interpreter's single-threaded scheduler loop possible.

Anything op-shaped can be a generator (`generator.clj:545-590`):

  * a dict is a one-shot generator of itself (fields :type/:process/:time
    filled from the context),
  * a callable is called for the next generator each time an op is needed,
  * a list/tuple runs its elements in sequence,
  * None is the exhausted generator,
  * Gen subclasses implement the protocol directly.

Scheduling context (`generator.clj:453-464`): `Context(time, free_threads,
workers)` where threads are 0..concurrency-1 plus "nemesis", and workers
maps thread -> current process (processes are retired and replaced when
they crash; `next_process`, `generator.clj:519-527`).

Times are integer nanoseconds since the start of the test.

Randomness goes through this module's `rng` (a `random.Random`) so the
simulator and tests can pin a seed (`fixed_rng`), mirroring the
reference's `with-fixed-rand-int` test harness (`generator/test.clj:33-48`).

The port's own copy of `jepsen_tpu/generator/__init__.py`, host code with
no device path: the port imports nothing of the JAX package. Every draw
goes through the same `random.Random` calls in the same order as there,
so a seeded simulation gives the same history in both packages
(tests/test_torch_generator.py holds them to it).
"""

from __future__ import annotations

import builtins
import dataclasses
import inspect
import logging
import random
import threading
from typing import Any, Callable, Optional

LOG = logging.getLogger("jepsen_tpu_torch.generator")

NEMESIS = "nemesis"


class _Pending:
    """Sentinel: the generator has ops, but can't emit one right now."""

    def __repr__(self):
        return ":pending"


PENDING = _Pending()

_RNG_TLS = threading.local()
_DEFAULT_RNG = random.Random()


class _RngProxy:
    """`gen.rng`, made worker-safe: delegates every method to the
    calling thread's pinned stream (`fixed_rng`) or, unpinned, to one
    process-wide default. Pinning used to rebind the module global, so
    N concurrent `simulate()` workers shared (and clobbered) a single
    seed-45100 stream; with thread-local pinning each worker owns an
    independent deterministic stream and unrelated threads never see
    another worker's seed. Attribute lookup is the only indirection —
    call sites (`gen.rng.randrange(...)`) are unchanged."""

    @staticmethod
    def _current() -> random.Random:
        return getattr(_RNG_TLS, "rng", None) or _DEFAULT_RNG

    def __getattr__(self, name):
        return getattr(self._current(), name)

    def __repr__(self):
        pinned = getattr(_RNG_TLS, "rng", None) is not None
        return f"<generator.rng {'pinned' if pinned else 'default'}>"


rng = _RngProxy()


class fixed_rng:
    """Context manager pinning the *calling thread's* RNG to a seeded
    stream for deterministic simulation (reference seed 45100,
    test.clj:44-48). Reentrant — nesting saves and restores the outer
    pin — and thread-safe: concurrent workers each pin their own
    stream (the search driver runs hundreds of parallel `simulate()`
    calls; see search/driver.py)."""

    def __init__(self, seed: int = 45100):
        self.seed = seed

    def __enter__(self):
        self._saved = getattr(_RNG_TLS, "rng", None)
        r = random.Random(self.seed)
        _RNG_TLS.rng = r
        return r

    def __exit__(self, *exc):
        _RNG_TLS.rng = self._saved
        return False


def secs_to_nanos(s: float) -> int:
    return int(s * 1_000_000_000)


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Context:
    """time: ns; free_threads: ordered tuple of idle threads; workers:
    thread -> process currently assigned."""
    time: int
    free_threads: tuple
    workers: dict

    # Direct construction instead of dataclasses.replace: these run in
    # the interpreter's per-op hot path (>20k ops/s parity target,
    # `generator.clj:66-70`), and replace() re-walks the signature.

    def _share_workers_cache(self, c: "Context") -> "Context":
        # the pred -> filtered-workers memo depends only on `workers`,
        # so every transition that keeps the same workers dict (time,
        # busy, free) carries it forward — across a whole run the
        # filter is computed once per pred per workers generation, not
        # once per event
        try:
            object.__setattr__(c, "_workers_cache", self._workers_cache)
        except AttributeError:
            pass
        return c

    def with_time(self, t: int) -> "Context":
        return self._share_workers_cache(
            Context(t, self.free_threads, self.workers))

    def busy(self, thread) -> "Context":
        return self._share_workers_cache(Context(
            self.time,
            tuple(t for t in self.free_threads if t != thread),
            self.workers))

    def free(self, thread) -> "Context":
        if thread in self.free_threads:
            return self
        return self._share_workers_cache(Context(
            self.time, self.free_threads + (thread,), self.workers))

    def with_workers(self, workers: dict) -> "Context":
        # deliberately does NOT share the memo: workers changed
        return Context(self.time, self.free_threads, workers)

    def restrict(self, key, pred) -> "Context":
        """A view containing only threads satisfying pred. The workers
        filtering is memoized per pred and survives time/busy/free
        transitions (thread-routing combinators re-restrict evolving
        contexts on every event); only the free-thread filter — a
        handful of pred calls — runs per restriction. The restricted
        context gets a fresh memo of its own: its workers are a
        subset, so inherited entries would be wrong for nested
        restrictions."""
        try:
            cache = self._workers_cache
        except AttributeError:
            cache = {}
            object.__setattr__(self, "_workers_cache", cache)
        w = cache.get(key)
        if w is None:
            w = {t: p for t, p in self.workers.items() if pred(t)}
            cache[key] = w
        return Context(self.time,
                       tuple(t for t in self.free_threads if pred(t)),
                       w)


def context(test: dict) -> Context:
    """Initial context for a test map: `concurrency` client threads plus
    the nemesis, all free (`generator.clj:453-464`)."""
    threads = (NEMESIS,) + tuple(range(test.get("concurrency", 1)))
    return Context(0, threads, {t: t for t in threads})


def free_processes(ctx: Context) -> list:
    return [ctx.workers[t] for t in ctx.free_threads]


def some_free_process(ctx: Context):
    """A uniformly random free process — random, not first-fit, so quick
    threads can't starve the others (`generator.clj:440-450`)."""
    n = len(ctx.free_threads)
    if n == 0:
        return None
    return ctx.workers[ctx.free_threads[rng.randrange(n)]]


def all_processes(ctx: Context) -> list:
    return list(ctx.workers.values())


def all_threads(ctx: Context) -> list:
    return list(ctx.workers.keys())


def process_to_thread(ctx: Context, process):
    for t, p in ctx.workers.items():
        if p == process:
            return t
    return None


def thread_to_process(ctx: Context, thread):
    return ctx.workers.get(thread)


def next_process(ctx: Context, thread):
    """The replacement process for a crashed one: old process + number of
    numeric processes in the *global* context (`generator.clj:519-527`)."""
    if thread == NEMESIS:
        return thread
    numeric = [p for p in all_processes(ctx) if isinstance(p, int)]
    return ctx.workers[thread] + len(numeric)


def fill_in_op(op: dict, ctx: Context):
    """Fill :type/:process/:time from the context; PENDING if no process
    is free (`generator.clj:531-543`)."""
    p = some_free_process(ctx)
    if p is None:
        return PENDING
    out = dict(op)
    out.setdefault("time", ctx.time)
    out.setdefault("process", p)
    out.setdefault("type", "invoke")
    return out


# ---------------------------------------------------------------------------
# Protocol + lifting
# ---------------------------------------------------------------------------

class Gen:
    """The generator protocol (`generator.clj:382-390`)."""

    def op(self, test: dict, ctx: Context):
        """-> (op, gen') | (PENDING, gen') | None when exhausted."""
        raise NotImplementedError

    def update(self, test: dict, ctx: Context, event: dict) -> "Gen":
        return self


_UNPULLED = object()


class IterGen(Gen):
    """Lifts a Python iterator into a generator — the analog of the
    reference's lazy-seq generators (`generator.clj:545-590` seqs),
    enabling infinite op streams like the set workload's unique-add
    sequence. The head pull is memoized so repeated op() calls on the
    same value are idempotent; each emitted op hands back a fresh
    wrapper around the shared iterator tail."""

    def __init__(self, it):
        self.it = it
        self._head = _UNPULLED

    def _pull(self):
        if self._head is _UNPULLED:
            try:
                self._head = next(self.it)
            except StopIteration:
                self._head = None
        return self._head

    def op(self, test, ctx):
        while True:
            head = self._pull()
            if head is None:
                return None
            res = op(head, test, ctx)
            if res is None:
                # an exhausted sub-generator head: re-pull for the next
                # element (iteratively — a long run of empty heads must
                # not recurse)
                self._head = _UNPULLED
                continue
            o, g1 = res
            if o is PENDING:
                # memoize the (possibly wrapped/advanced) head so no
                # pulled element is lost when the interpreter re-asks
                self._head = g1
                return (o, self)
            tail = IterGen(self.it)
            return (o, [g1, tail] if g1 is not None else tail)

    def update(self, test, ctx, event):
        if self._head not in (_UNPULLED, None):
            self._head = update(self._head, test, ctx, event)
        return self


def op(gen, test: dict, ctx: Context):
    """Ask any liftable generator for its next operation."""
    while True:
        if gen is None:
            return None
        if isinstance(gen, Gen):
            return gen.op(test, ctx)
        if isinstance(gen, dict):
            o = fill_in_op(gen, ctx)
            return (o, gen if o is PENDING else None)
        if callable(gen):
            x = _call_fn_gen(gen, test, ctx)
            if x is None:
                return None
            if type(x) is dict:
                # fast path for the ubiquitous fn-gen -> op-dict case:
                # inline the [dict, fn] list+dict dispatch this would
                # otherwise recurse through (the >20k ops/s parity
                # target lives here, `generator.clj:66-70`)
                o = fill_in_op(x, ctx)
                return (o, [x, gen]) if o is PENDING else (o, gen)
            return op([x, gen], test, ctx)
        if isinstance(gen, (list, tuple)):
            if not gen:
                return None
            res = op(gen[0], test, ctx)
            if res is None:
                gen = list(gen[1:])
                continue
            o, g1 = res
            rest = list(gen[1:])
            return (o, [g1] + rest if rest else g1)
        if hasattr(gen, "__next__"):
            gen = IterGen(gen)
            continue
        raise TypeError(f"not a generator: {gen!r}")


def update(gen, test: dict, ctx: Context, event: dict):
    """Propagate a history event into a generator."""
    if gen is None:
        return None
    if isinstance(gen, Gen):
        return gen.update(test, ctx, event)
    if isinstance(gen, dict) or callable(gen):
        return gen
    if isinstance(gen, (list, tuple)):
        if not gen:
            return None
        return [update(gen[0], test, ctx, event)] + list(gen[1:])
    if hasattr(gen, "__next__"):
        return update(IterGen(gen), test, ctx, event)
    raise TypeError(f"not a generator: {gen!r}")


def _fn_gen_arity(f: Callable) -> int:
    """Required positional arity, memoized on the function object —
    signature inspection per emitted op dominates the hot loop."""
    n = getattr(f, "__gen_arity__", None)
    if n is None:
        try:
            sig = inspect.signature(f)
            n = len([p for p in sig.parameters.values()
                     if p.default is inspect.Parameter.empty
                     and p.kind in (p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD)])
        except (TypeError, ValueError):
            n = 0
        try:
            f.__gen_arity__ = n
        except (AttributeError, TypeError):
            pass
    return n


def _call_fn_gen(f: Callable, test: dict, ctx: Context):
    return f(test, ctx) if _fn_gen_arity(f) >= 2 else f()


# ---------------------------------------------------------------------------
# Wrappers: validate / friendly exceptions / trace
# ---------------------------------------------------------------------------

class InvalidOp(Exception):
    def __init__(self, problems, res, ctx):
        self.problems, self.res, self.ctx = problems, res, ctx
        super().__init__(
            "generator produced an invalid (op, gen') pair: "
            + "; ".join(problems) + f" — {res!r}")


@dataclasses.dataclass(frozen=True)
class Validate(Gen):
    """Asserts emitted ops are well-formed and their process is actually
    free (`generator.clj:622-676`)."""
    gen: Any

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        problems = []
        if not (isinstance(res, tuple) and len(res) == 2):
            problems.append("should return a pair of (op, gen')")
        else:
            o = res[0]
            if o is not PENDING:
                if not isinstance(o, dict):
                    problems.append("op should be PENDING or a dict")
                else:
                    if o.get("type") not in ("invoke", "info", "sleep",
                                             "log"):
                        problems.append(
                            ":type should be invoke, info, sleep or log")
                    if not isinstance(o.get("time"), int):
                        problems.append(":time should be an integer")
                    if o.get("process") is None:
                        problems.append("no :process")
                    elif o["process"] not in free_processes(ctx):
                        problems.append(
                            f"process {o['process']!r} is not free")
        if problems:
            raise InvalidOp(problems, res, ctx)
        return res[0], Validate(res[1])

    def update(self, test, ctx, event):
        return Validate(update(self.gen, test, ctx, event))


def validate(gen):
    return Validate(gen)


class GenException(Exception):
    def __init__(self, where, gen, ctx):
        super().__init__(
            f"generator raised during {where}; generator: {gen!r}")
        self.ctx = ctx


@dataclasses.dataclass(frozen=True)
class FriendlyExceptions(Gen):
    """Wraps underlying exceptions with the generator and context
    (`generator.clj:713-757`)."""
    gen: Any

    def op(self, test, ctx):
        try:
            res = op(self.gen, test, ctx)
        except GenException:
            raise
        except Exception as e:
            raise GenException("op", self.gen, ctx) from e
        if res is None:
            return None
        return res[0], FriendlyExceptions(res[1])

    def update(self, test, ctx, event):
        try:
            return FriendlyExceptions(update(self.gen, test, ctx, event))
        except GenException:
            raise
        except Exception as e:
            raise GenException("update", self.gen, ctx) from e


def friendly_exceptions(gen):
    return FriendlyExceptions(gen)


@dataclasses.dataclass(frozen=True)
class Trace(Gen):
    """Logs every op/update crossing this generator (`generator.clj:758`)."""
    k: Any
    gen: Any

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        LOG.info("%s op %r", self.k, None if res is None else res[0])
        if res is None:
            return None
        return res[0], Trace(self.k, res[1])

    def update(self, test, ctx, event):
        LOG.info("%s update %r", self.k, event)
        return Trace(self.k, update(self.gen, test, ctx, event))


def trace(k, gen):
    return Trace(k, gen)


# ---------------------------------------------------------------------------
# Transforms: map / f-map / filter / on-update
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Map(Gen):
    f: Callable
    gen: Any

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g1 = res
        return (o if o is PENDING else self.f(o)), Map(self.f, g1)

    def update(self, test, ctx, event):
        return Map(self.f, update(self.gen, test, ctx, event))


def map(f: Callable, gen):  # noqa: A001 — mirrors the reference name
    """Transform every op with f; PENDING/None pass through untouched
    (`generator.clj:782`)."""
    return Map(f, gen)


def f_map(fmap, gen):
    """Rewrite op :f fields through a mapping — the composed-nemesis
    helper (`generator.clj:790`)."""
    lookup = fmap.get if isinstance(fmap, dict) else fmap

    def transform(o):
        o = dict(o)
        o["f"] = lookup(o["f"])
        return o
    return Map(transform, gen)


@dataclasses.dataclass(frozen=True)
class Filter(Gen):
    f: Callable
    gen: Any

    def op(self, test, ctx):
        g = self.gen
        while True:
            res = op(g, test, ctx)
            if res is None:
                return None
            o, g1 = res
            if o is PENDING or self.f(o):
                return o, Filter(self.f, g1)
            g = g1

    def update(self, test, ctx, event):
        return Filter(self.f, update(self.gen, test, ctx, event))


def filter(f: Callable, gen):  # noqa: A001
    """Only ops satisfying f pass; PENDING bypasses (`generator.clj:812`)."""
    return Filter(f, gen)


@dataclasses.dataclass(frozen=True)
class IgnoreUpdates(Gen):
    gen: Any

    def op(self, test, ctx):
        return op(self.gen, test, ctx)

    def update(self, test, ctx, event):
        return self


def ignore_updates(gen):
    return IgnoreUpdates(gen)


@dataclasses.dataclass(frozen=True)
class OnUpdate(Gen):
    """Calls (f self test ctx event) on update; f returns the replacement
    generator (`generator.clj:836`)."""
    f: Callable
    gen: Any

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        return res[0], OnUpdate(self.f, res[1])

    def update(self, test, ctx, event):
        return self.f(self, test, ctx, event)


def on_update(f, gen):
    return OnUpdate(f, gen)


# ---------------------------------------------------------------------------
# Thread routing: on-threads / clients / nemesis / reserve / each-thread
# ---------------------------------------------------------------------------

def _restrict_ctx(pred: Callable, ctx: Context) -> Context:
    # the pred object itself is the key (identity equality for
    # functions) — keeping a reference also rules out id() reuse
    return ctx.restrict(pred, pred)


@dataclasses.dataclass(frozen=True)
class OnThreads(Gen):
    """Restricts a generator to threads satisfying pred; the inner
    generator only ever sees those threads (`generator.clj:875`)."""
    pred: Callable
    gen: Any

    def op(self, test, ctx):
        res = op(self.gen, test, _restrict_ctx(self.pred, ctx))
        if res is None:
            return None
        return res[0], OnThreads(self.pred, res[1])

    def update(self, test, ctx, event):
        t = process_to_thread(ctx, event.get("process"))
        if t is not None and self.pred(t):
            return OnThreads(
                self.pred,
                update(self.gen, test, _restrict_ctx(self.pred, ctx),
                       event))
        return self


def on_threads(pred, gen):
    if isinstance(pred, (set, frozenset)):
        s = pred
        pred = lambda t: t in s  # noqa: E731
    return OnThreads(pred, gen)


on = on_threads


def clients(client_gen, nemesis_gen=None):
    """Route client threads to client_gen (and, two-arity, the nemesis to
    nemesis_gen) (`generator.clj:1093`)."""
    c = on_threads(lambda t: t != NEMESIS, client_gen)
    if nemesis_gen is None:
        return c
    return any(c, nemesis(nemesis_gen))


def nemesis(nemesis_gen, client_gen=None):
    n = on_threads(lambda t: t == NEMESIS, nemesis_gen)
    if client_gen is None:
        return n
    return any(n, clients(client_gen))


def _soonest(m1: Optional[dict], m2: Optional[dict]) -> Optional[dict]:
    """Pick whichever op-map happens sooner; ties break randomly by weight
    (`soonest-op-map`, `generator.clj:887-927`)."""
    if m1 is None:
        return m2
    if m2 is None:
        return m1
    if m1["op"] is PENDING:
        return m2
    if m2["op"] is PENDING:
        return m1
    t1, t2 = m1["op"]["time"], m2["op"]["time"]
    if t1 == t2:
        w1 = m1.get("weight", 1)
        w2 = m2.get("weight", 1)
        winner = m1 if rng.randrange(w1 + w2) < w1 else m2
        winner = dict(winner)
        winner["weight"] = w1 + w2
        return winner
    return m1 if t1 < t2 else m2


@dataclasses.dataclass(frozen=True)
class Any(Gen):
    """Ops from whichever generator is soonest; updates go to all
    (`generator.clj:946`)."""
    gens: tuple

    def op(self, test, ctx):
        best = None
        for i, g in enumerate(self.gens):
            res = op(g, test, ctx)
            if res is not None:
                best = _soonest(best, {"op": res[0], "gen": res[1], "i": i})
        if best is None:
            return None
        gens = builtins.list(self.gens)
        gens[best["i"]] = best["gen"]
        return best["op"], Any(tuple(gens))

    def update(self, test, ctx, event):
        return Any(tuple(update(g, test, ctx, event) for g in self.gens))


def any(*gens):  # noqa: A001
    if len(gens) == 0:
        return None
    if len(gens) == 1:
        return gens[0]
    return Any(tuple(gens))


@dataclasses.dataclass(frozen=True)
class EachThread(Gen):
    """An independent copy of the generator per thread; each copy sees a
    single-thread context (`generator.clj:1001`)."""
    fresh: Any
    gens: tuple  # ((thread, gen), ...) — tuple for hashability

    def _gen_for(self, thread):
        for t, g in self.gens:
            if t == thread:
                return g
        return self.fresh

    def _with(self, thread, g):
        pairs = [(t, x) for t, x in self.gens if t != thread]
        return EachThread(self.fresh, tuple(pairs + [(thread, g)]))

    def op(self, test, ctx):
        best = None
        for thread in ctx.free_threads:
            sub = Context(ctx.time, (thread,),
                          {thread: ctx.workers[thread]})
            res = op(self._gen_for(thread), test, sub)
            if res is not None:
                best = _soonest(best, {"op": res[0], "gen": res[1],
                                       "thread": thread})
        if best is not None:
            return best["op"], self._with(best["thread"], best["gen"])
        if len(ctx.free_threads) != len(ctx.workers):
            return PENDING, self  # busy threads may still want ops
        return None  # every thread exhausted

    def update(self, test, ctx, event):
        thread = process_to_thread(ctx, event.get("process"))
        if thread is None:
            return self
        sub = Context(ctx.time,
                      tuple(t for t in ctx.free_threads if t == thread),
                      {thread: ctx.workers[thread]})
        return self._with(
            thread, update(self._gen_for(thread), test, sub, event))


def each_thread(gen):
    return EachThread(gen, ())


@dataclasses.dataclass(frozen=True)
class Reserve(Gen):
    """Dedicated thread ranges per generator, remainder to a default
    (`generator.clj:1056`). Ranges are *positional* within the current
    context's ordered thread list (integer threads in order, then the
    nemesis), so reserve composes with thread-restricting wrappers like
    on_threads and independent's concurrent groups."""
    counts: tuple     # threads per reserved range
    gens: tuple       # len(counts)+1; last is the default

    @staticmethod
    def _ordered_threads(ctx: Context) -> builtins.list:
        ints = sorted(t for t in ctx.workers if isinstance(t, int))
        rest = [t for t in ctx.workers if not isinstance(t, int)]
        return ints + rest

    def _range_sets(self, ctx: Context) -> builtins.list:
        """Per-range thread sets for this context, plus the remainder."""
        ordered = self._ordered_threads(ctx)
        sets = []
        n = 0
        for count in self.counts:
            sets.append(frozenset(ordered[n:n + count]))
            n += count
        sets.append(frozenset(ordered[n:]))
        return sets

    def op(self, test, ctx):
        best = None
        for i, threads in enumerate(self._range_sets(ctx)):
            # the frozenset itself is the memo key: a fresh lambda per
            # call would defeat (and unboundedly grow) the cache
            sub = ctx.restrict(threads, lambda t, s=threads: t in s)
            res = op(self.gens[i], test, sub)
            if res is not None:
                best = _soonest(best, {"op": res[0], "gen": res[1],
                                       "i": i, "weight": len(threads)})
        if best is None:
            return None
        gens = builtins.list(self.gens)
        gens[best["i"]] = best["gen"]
        return best["op"], Reserve(self.counts, tuple(gens))

    def update(self, test, ctx, event):
        thread = process_to_thread(ctx, event.get("process"))
        sets = self._range_sets(ctx)
        i = len(self.counts)
        for j, threads in enumerate(sets[:-1]):
            if thread in threads:
                i = j
                break
        gens = builtins.list(self.gens)
        gens[i] = update(gens[i], test, ctx, event)
        return Reserve(self.counts, tuple(gens))


def reserve(*args):
    """reserve(5, write_gen, 10, cas_gen, read_gen): first 5 threads run
    write_gen, next 10 cas_gen, the rest read_gen."""
    assert len(args) % 2 == 1, "reserve needs a trailing default generator"
    *pairs, default = args
    counts, gens = [], []
    for count, gen in zip(pairs[0::2], pairs[1::2]):
        counts.append(count)
        gens.append(gen)
    return Reserve(tuple(counts), tuple(gens) + (default,))


# ---------------------------------------------------------------------------
# Mixing and sequencing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mix(Gen):
    """Uniform random mixture; behaves as a sequence of one-shot randomly
    selected generators. Ignores updates (`generator.clj:1140`)."""
    i: int
    gens: tuple

    def op(self, test, ctx):
        i, gens = self.i, builtins.list(self.gens)
        while gens:
            res = op(gens[i], test, ctx)
            if res is not None:
                gens[i] = res[1]
                return res[0], Mix(rng.randrange(len(gens)), tuple(gens))
            del gens[i]
            if not gens:
                return None
            i = rng.randrange(len(gens))
        return None

    def update(self, test, ctx, event):
        return self


def mix(gens):
    gens = builtins.list(gens)
    if not gens:
        return None
    return Mix(rng.randrange(len(gens)), tuple(gens))


@dataclasses.dataclass(frozen=True)
class Limit(Gen):
    remaining: int
    gen: Any

    def op(self, test, ctx):
        if self.remaining <= 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        n = self.remaining if res[0] is PENDING else self.remaining - 1
        return res[0], Limit(n, res[1])

    def update(self, test, ctx, event):
        return Limit(self.remaining, update(self.gen, test, ctx, event))


def limit(n: int, gen):
    return Limit(n, gen)


def once(gen):
    return Limit(1, gen)


class Derefer(Gen):
    """Defer building a generator until it is first asked for an op —
    the reference's `gen/derefer` over a delay (`aerospike
    set.clj:63-72` uses it for final reads over keys only known at
    runtime). The built generator is memoized on this node (a delay
    caches its value), so a discarded poll re-polls the same state and
    nothing is lost; each emitted op hands the advanced tail to a
    fresh Derefer."""

    def __init__(self, build: Callable):
        self.build = build
        self._built = _UNPULLED

    def op(self, test, ctx):
        if self._built is _UNPULLED:
            self._built = self.build(test, ctx)
        res = op(self._built, test, ctx)
        if res is None:
            return None
        o, g1 = res
        nxt = Derefer(self.build)
        nxt._built = g1
        return o, nxt

    def update(self, test, ctx, event):
        if self._built is not _UNPULLED:
            self._built = update(self._built, test, ctx, event)
        return self


def derefer(build: Callable) -> Derefer:
    """build(test, ctx) -> generator (or None), called at most once."""
    return Derefer(build)


def log(msg):
    """A one-shot op that just logs a message (`generator.clj:1177`)."""
    return {"type": "log", "value": msg}


@dataclasses.dataclass(frozen=True)
class Repeat(Gen):
    """Re-emits from an unchanging generator; remaining < 0 means forever
    (`generator.clj:1196`)."""
    remaining: int
    gen: Any

    def op(self, test, ctx):
        if self.remaining == 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        n = self.remaining if res[0] is PENDING else self.remaining - 1
        return res[0], Repeat(n, self.gen)

    def update(self, test, ctx, event):
        return Repeat(self.remaining, update(self.gen, test, ctx, event))


def repeat(*args):
    """repeat(gen) forever, or repeat(n, gen) n times."""
    if len(args) == 1:
        return Repeat(-1, args[0])
    n, gen = args
    assert n >= 0
    return Repeat(n, gen)


@dataclasses.dataclass(frozen=True)
class Cycle(Gen):
    remaining: int
    original: Any
    gen: Any

    def op(self, test, ctx):
        remaining, gen = self.remaining, self.gen
        while remaining != 0:
            res = op(gen, test, ctx)
            if res is not None:
                return res[0], Cycle(remaining, self.original, res[1])
            remaining -= 1
            gen = self.original
        return None

    def update(self, test, ctx, event):
        return Cycle(self.remaining, self.original,
                     update(self.gen, test, ctx, event))


def cycle(*args):
    """cycle(gen) restarts gen forever when it exhausts; cycle(n, gen)
    runs it n times (`generator.clj:1228`)."""
    if len(args) == 1:
        return Cycle(-1, args[0], args[0])
    n, gen = args
    return Cycle(n, gen, gen)


# ---------------------------------------------------------------------------
# Bounding: process-limit / time-limit
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProcessLimit(Gen):
    """Emits ops for at most n distinct processes, counting every process
    that *could* run — prevents end-of-test trickle (`generator.clj:1253`)."""
    n: int
    procs: frozenset
    gen: Any

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g1 = res
        if o is PENDING:
            return o, ProcessLimit(self.n, self.procs, g1)
        procs = self.procs | frozenset(all_processes(ctx))
        if len(procs) > self.n:
            return None
        return o, ProcessLimit(self.n, procs, g1)

    def update(self, test, ctx, event):
        return ProcessLimit(self.n, self.procs,
                            update(self.gen, test, ctx, event))


def process_limit(n: int, gen):
    return ProcessLimit(n, frozenset(), gen)


@dataclasses.dataclass(frozen=True)
class TimeLimit(Gen):
    """Emits for `limit` ns after its first op (`generator.clj:1286`)."""
    limit: int
    cutoff: Optional[int]
    gen: Any

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g1 = res
        if o is PENDING:
            return o, TimeLimit(self.limit, self.cutoff, g1)
        cutoff = self.cutoff if self.cutoff is not None \
            else o["time"] + self.limit
        if o["time"] >= cutoff:
            return None
        return o, TimeLimit(self.limit, cutoff, g1)

    def update(self, test, ctx, event):
        return TimeLimit(self.limit, self.cutoff,
                         update(self.gen, test, ctx, event))


def time_limit(dt_secs: float, gen):
    return TimeLimit(secs_to_nanos(dt_secs), None, gen)


# ---------------------------------------------------------------------------
# Timing: stagger / delay / sleep
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stagger(Gen):
    """Schedules ops at uniformly random intervals in [0, dt); dt is
    2x the requested mean so the rate averages out. Applies globally, not
    per-thread (`generator.clj:1315-1340`)."""
    dt: int
    next_time: Optional[int]
    gen: Any

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g1 = res
        if o is PENDING:
            return o, self
        next_time = self.next_time if self.next_time is not None \
            else ctx.time
        if next_time <= o["time"]:
            return o, Stagger(self.dt, o["time"] + _rand_nanos(self.dt),
                              g1)
        o = dict(o)
        o["time"] = next_time
        return o, Stagger(self.dt, next_time + _rand_nanos(self.dt), g1)

    def update(self, test, ctx, event):
        return Stagger(self.dt, self.next_time,
                       update(self.gen, test, ctx, event))


def _rand_nanos(dt: int) -> int:
    return int(rng.random() * dt)


def stagger(dt_secs: float, gen):
    return Stagger(secs_to_nanos(2 * dt_secs), None, gen)


@dataclasses.dataclass(frozen=True)
class Delay(Gen):
    """Ops exactly dt apart (catching up if behind) (`generator.clj:1385`)."""
    dt: int
    next_time: Optional[int]
    gen: Any

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g1 = res
        if o is PENDING:
            return o, Delay(self.dt, self.next_time, g1)
        next_time = self.next_time if self.next_time is not None \
            else o["time"]
        if o["time"] < next_time:
            o = dict(o)
            o["time"] = next_time
        return o, Delay(self.dt, o["time"] + self.dt, g1)

    def update(self, test, ctx, event):
        return Delay(self.dt, self.next_time,
                     update(self.gen, test, ctx, event))


def delay(dt_secs: float, gen):
    return Delay(secs_to_nanos(dt_secs), None, gen)


def sleep(dt_secs: float):
    """One op telling its process to do nothing for dt seconds
    (`generator.clj:1397`)."""
    return {"type": "sleep", "value": dt_secs}


# ---------------------------------------------------------------------------
# Phasing: synchronize / phases / then
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Synchronize(Gen):
    """PENDING until every worker is free, then becomes the generator
    (`generator.clj:1420`)."""
    gen: Any

    def op(self, test, ctx):
        if len(ctx.free_threads) == len(ctx.workers) and \
                set(ctx.free_threads) == set(ctx.workers):
            return op(self.gen, test, ctx)
        return PENDING, self

    def update(self, test, ctx, event):
        return Synchronize(update(self.gen, test, ctx, event))


def synchronize(gen):
    return Synchronize(gen)


def phases(*gens):
    return [synchronize(g) for g in gens]


def then(a, b):
    """b, then (everyone idle), then a — argument order reads well in
    pipelines (`generator.clj:1432`)."""
    return [b, synchronize(a)]


# ---------------------------------------------------------------------------
# until-ok / flip-flop / cycle-times
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UntilOk(Gen):
    """Yields ops until one of them completes :ok (`generator.clj:1469`)."""
    gen: Any
    done: bool
    active: frozenset

    def op(self, test, ctx):
        if self.done:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g1 = res
        if o is PENDING:
            return o, UntilOk(g1, self.done, self.active)
        return o, UntilOk(g1, self.done, self.active | {o["process"]})

    def update(self, test, ctx, event):
        g1 = update(self.gen, test, ctx, event)
        p = event.get("process")
        if p in self.active:
            t = event.get("type")
            if t == "ok":
                return UntilOk(g1, True, self.active - {p})
            if t in ("info", "fail"):
                return UntilOk(g1, self.done, self.active - {p})
        return UntilOk(g1, self.done, self.active)


def until_ok(gen):
    return UntilOk(gen, False, frozenset())


@dataclasses.dataclass(frozen=True)
class FlipFlop(Gen):
    """A, then B, then A... stops when either exhausts; ignores updates
    (`generator.clj:1485`)."""
    gens: tuple
    i: int

    def op(self, test, ctx):
        res = op(self.gens[self.i], test, ctx)
        if res is None:
            return None
        gens = builtins.list(self.gens)
        gens[self.i] = res[1]
        nxt = self.i if res[0] is PENDING else (self.i + 1) % len(gens)
        return res[0], FlipFlop(tuple(gens), nxt)

    def update(self, test, ctx, event):
        return self


def flip_flop(a, b):
    return FlipFlop((a, b), 0)


@dataclasses.dataclass(frozen=True)
class CycleTimes(Gen):
    """Rotates between generators on a fixed schedule of windows,
    preserving each generator's state across cycles
    (`generator.clj:1557-1581`)."""
    period: int
    t0: Optional[int]
    intervals: tuple
    cutoffs: tuple     # cumulative interval sums (includes the last)
    gens: tuple

    def op(self, test, ctx):
        now = ctx.time
        t0 = self.t0 if self.t0 is not None else now
        in_period = (now - t0) % self.period
        cycle_start = now - in_period
        i = 0
        while i < len(self.cutoffs) - 1 and in_period >= self.cutoffs[i]:
            i += 1
        t = cycle_start + sum(self.intervals[:i])
        gens = builtins.list(self.gens)
        for _ in range(2 * len(gens)):  # bounded walk over the windows
            t_end = t + self.intervals[i]
            res = op(gens[i], test, ctx.with_time(max(now, t)))
            if res is None:
                return None
            o, g1 = res
            gens[i] = g1
            if o is PENDING:
                return PENDING, CycleTimes(self.period, t0,
                                           self.intervals, self.cutoffs,
                                           tuple(gens))
            if o["time"] < t_end:
                return o, CycleTimes(self.period, t0, self.intervals,
                                     self.cutoffs, tuple(gens))
            i = (i + 1) % len(gens)
            t = t_end
        return PENDING, CycleTimes(self.period, t0, self.intervals,
                                   self.cutoffs, tuple(gens))

    def update(self, test, ctx, event):
        return CycleTimes(self.period, self.t0, self.intervals,
                          self.cutoffs,
                          tuple(update(g, test, ctx, event)
                                for g in self.gens))


def cycle_times(*specs):
    """cycle_times(5, write_gen, 10, read_gen): writes for 5 s, reads for
    10 s, repeating. State persists across cycles."""
    if not specs:
        return None
    assert len(specs) % 2 == 0
    intervals = tuple(secs_to_nanos(s) for s in specs[0::2])
    gens = tuple(specs[1::2])
    cutoffs = []
    acc = 0
    for iv in intervals:
        acc += iv
        cutoffs.append(acc)
    return CycleTimes(sum(intervals), None, intervals, tuple(cutoffs),
                      gens)


def concat(*gens):
    """Sequence of generators as one (`generator.clj:777`)."""
    return builtins.list(gens)
