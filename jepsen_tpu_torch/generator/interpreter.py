"""The interpreter: turns a pure generator into a real concurrent history
(reference `jepsen/src/jepsen/generator/interpreter.clj`).

One worker thread per logical thread (concurrency clients + the nemesis),
each fed through a 1-slot queue; a single-threaded scheduler loop owns the
context and the generator, polls completions at microsecond granularity
(`max-pending-interval` 1000 us, `interpreter.clj:166-170`), asks the
generator for ops, dispatches them, and journals invocations and
completions into the history.

Worker behavior (`interpreter.clj:99-164`):
  * any Throwable from a client invoke becomes an :info op (the op is
    indeterminate — it may or may not have taken effect),
  * crashed (non-nemesis) processes are retired and replaced with fresh
    process ids (`:233-236`),
  * crashed clients are closed and reopened for the new process, unless
    the client is `reusable` (`ClientWorker`, `:33-67`),
  * :sleep and :log ops are handled in the worker and kept out of the
    history (`goes-in-history?`, `:171-178`).

Run survivability (beyond the reference):
  * every history op is appended to a write-ahead journal
    (store.Journal) as it happens, so a crashed or SIGKILL'd run
    leaves a replayable prefix on disk,
  * a test-level 'op-timeout' (seconds; per-op 'deadline' override)
    bounds every invoke: an overdue op gets a synthetic :info
    completion, its process is retired exactly like a crash, the
    wedged worker thread is abandoned and replaced, and the late real
    completion — should the abandoned worker ever answer — is
    discarded. A hung client can therefore never wedge the run.

Online verification (checker/streaming.py): when the test carries an
'online-checker', every history op is offered to it live — via the
journal's subscribe feed when a journal exists (op flow rides the WAL
append), directly from the recording hook otherwise — and the
scheduler polls should_abort() before asking the generator for more
work: a confirmed mid-run violation stops new ops, drains the
outstanding ones (op-timeouts still bound them), and returns the
history checked so far, saving the rest of the cluster time.
"""

from __future__ import annotations

import logging
import queue
import threading
import time as _time
from typing import Optional

from .. import client as jclient
from .. import store
from ..history import History
from ..util import relative_time_nanos, secs_to_nanos
from . import (NEMESIS, PENDING, context, friendly_exceptions,
               next_process, process_to_thread, validate)
from . import op as gen_op
from . import update as gen_update

LOG = logging.getLogger("jepsen_tpu_torch.interpreter")

MAX_PENDING_INTERVAL_US = 1000


class Worker:
    """Stateful per-thread executor; all calls come from one thread
    (`interpreter.clj:19-31`)."""

    def open(self, test: dict, wid) -> "Worker":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def close(self, test: dict) -> None:
        pass


class ClientWorker(Worker):
    """Owns the client for one thread; reopens it per fresh process unless
    the client is reusable (`interpreter.clj:33-67`)."""

    def __init__(self, node: str):
        self.node = node
        self.process = None
        self.client: Optional[jclient.Client] = None

    def invoke(self, test, op):
        while True:
            if self.process == op["process"] and self.client is not None:
                return self.client.invoke(test, op)
            if self.client is not None and \
                    jclient.is_reusable(self.client, test):
                self.process = op["process"]
                continue
            # new process, new client
            self.close(test)
            try:
                self.client = jclient.validate(test["client"]).open(
                    test, self.node)
                self.process = op["process"]
            except Exception as e:
                LOG.warning("error opening client: %s", e)
                self.client = None
                out = dict(op)
                out["type"] = "fail"
                out["error"] = ["no-client", str(e)]
                return out

    def close(self, test):
        if self.client is not None:
            try:
                self.client.close(test)
            finally:
                self.client = None


class NemesisWorker(Worker):
    """Validates completions so a misbehaving nemesis crashes its own op
    (becoming :info) instead of wedging the scheduler."""

    def invoke(self, test, op):
        from .. import nemesis as jnemesis
        return jnemesis.Validate(test["nemesis"]).invoke(test, op)


class RetiredNemesisWorker(Worker):
    """Seated when a nemesis invoke exceeds its deadline. There is only
    ONE nemesis object and it is single-threaded by contract — the
    wedged thread still owns it, so unlike a client (which gets a fresh
    connection) the nemesis cannot be reopened. Subsequent nemesis ops
    complete as :info without touching it: the run keeps terminating,
    fault injection honestly stops."""

    def invoke(self, test, op):
        out = dict(op)
        out["type"] = "info"
        out["error"] = ("nemesis-retired: a prior nemesis op exceeded "
                        "its deadline")
        return out


class ClientNemesisWorker(Worker):
    """Spawns ClientWorkers for integer ids (round-robin over nodes) and a
    NemesisWorker for the nemesis (`interpreter.clj:77-95`)."""

    def open(self, test, wid):
        if isinstance(wid, int):
            nodes = test.get("nodes") or ["local"]
            return ClientWorker(nodes[wid % len(nodes)]).open(test, wid)
        return NemesisWorker().open(test, wid)


def goes_in_history(op: dict) -> bool:
    return op.get("type") not in ("sleep", "log")


class _WorkerThread:
    """Completions are tagged with the emitting _WorkerThread so the
    scheduler can tell a live worker's answer from the late answer of
    an abandoned (timed-out) one and discard the latter."""

    def __init__(self, test: dict, out: queue.Queue, worker: Worker, wid):
        self.id = wid
        self.inbox: queue.Queue = queue.Queue(1)
        self.test = test
        self.out = out
        self.worker = worker
        self.abandoned = False
        self.thread = threading.Thread(
            target=self._run, name=f"jepsen-worker-{wid}", daemon=True)
        self.thread.start()

    def _run(self):
        test = self.test
        worker = self.worker.open(test, self.id)
        try:
            while True:
                op = self.inbox.get()
                t = op.get("type")
                if t == "exit":
                    return
                try:
                    if t == "sleep":
                        _time.sleep(op["value"])
                        self.out.put((self, op))
                    elif t == "log":
                        LOG.info("%s", op["value"])
                        self.out.put((self, op))
                    else:
                        self.out.put((self, worker.invoke(test, op)))
                except BaseException as e:
                    LOG.warning("process %r crashed: %s",
                                op.get("process"), e)
                    out = dict(op)
                    out["type"] = "info"
                    out["error"] = f"indeterminate: {e}"
                    self.out.put((self, out))
        finally:
            worker.close(test)


def _op_deadline(test: dict, op: dict, now: int):
    """(absolute-deadline-ns, timeout-s) for an op dispatched at `now`,
    or None when it is unbounded. The per-op 'deadline' key (seconds
    from dispatch) overrides the test-level 'op-timeout'; an explicit
    'deadline': None exempts one op (a deliberately long nemesis
    transition) from the test-level bound. Anchored at dispatch time,
    not the generator-scheduled op['time'], so scheduler lag never
    eats into the client's budget. :sleep/:log ops complete
    deterministically and are never deadlined."""
    if op.get("type") in ("sleep", "log"):
        return None
    t = op.get("deadline", test.get("op-timeout"))
    if t is None:
        return None
    return now + secs_to_nanos(t), t


def run(test: dict) -> History:
    """Evaluate all ops from test['generator'], applying them with
    test['client'] / test['nemesis']. Returns the history
    (`interpreter.clj:181-310`). History ops are journaled to
    journal.jsonl as they happen (when the test has a store identity),
    and in-flight ops are bounded by 'op-timeout' / per-op 'deadline'
    so a wedged client can't hang the run — see the module docstring."""
    ctx = context(test)
    completions: queue.Queue = queue.Queue()
    workers = {t: _WorkerThread(test, completions, ClientNemesisWorker(), t)
               for t in ctx.workers}
    gen = validate(friendly_exceptions(test.get("generator")))
    outstanding = 0
    poll_timeout_us = 0
    history: list = []
    # thread -> (op, absolute-deadline-ns, timeout-s); only ops that
    # actually carry a deadline are tracked, so runs without
    # 'op-timeout' pay nothing on the hot path
    deadlines: dict = {}
    op_timeout = test.get("op-timeout")
    journal = store.open_journal(test)
    online = test.get("online-checker")
    hook = None
    if online is not None:
        if journal is not None:
            # live ops ride the WAL append path (Journal.subscribe) —
            # one feed, shared with the crash-survivability journal
            journal.subscribe(online.offer)
        else:
            hook = online.offer
    aborted = False

    def record(o: dict) -> None:
        history.append(o)
        if journal is not None:
            journal.append(o)
        elif hook is not None:
            hook(o)

    def deadline_capped(us: int, now: int) -> int:
        # never sleep past the nearest in-flight deadline
        if not deadlines:
            return us
        nearest = min(dl for _, dl, _ in deadlines.values())
        return max(1, min(us, (nearest - now) // 1000))

    def settle(thread, op2: dict, now: int) -> dict:
        """The one completion transition, shared by real completions
        and synthetic op-timeout :infos so the two can never diverge:
        free the thread, update the generator, retire the process on
        :info, journal, decrement outstanding."""
        nonlocal ctx, gen, outstanding
        if deadlines:
            deadlines.pop(thread, None)
        op2 = dict(op2)
        op2["time"] = now
        ctx = ctx.with_time(now).free(thread)
        # update sees the free thread but the *old* process so
        # thread->process still resolves this event
        gen = gen_update(gen, test, ctx, op2)
        if thread != NEMESIS and op2.get("type") == "info":
            workers_map = dict(ctx.workers)
            workers_map[thread] = next_process(ctx, thread)
            ctx = ctx.with_workers(workers_map)
        if goes_in_history(op2):
            record(op2)
        outstanding -= 1
        return op2

    try:
        while True:
            # Completions first: they're latency-sensitive — waiting
            # introduces false concurrency.
            try:
                if poll_timeout_us > 0:
                    src, op2 = completions.get(
                        timeout=poll_timeout_us / 1e6)
                else:
                    src, op2 = completions.get_nowait()
            except queue.Empty:
                src = op2 = None

            if op2 is not None:
                if src.abandoned or src is not workers.get(src.id):
                    # a timed-out worker eventually answered: its op was
                    # already journaled as :info — the late result must
                    # be discarded, not double-completed
                    LOG.info("discarding late completion from retired "
                             "worker %r: %r", src.id, op2.get("f"))
                    poll_timeout_us = 0
                    continue
                settle(process_to_thread(ctx, op2["process"]), op2,
                       relative_time_nanos())
                poll_timeout_us = 0
                continue

            # Overdue ops — checked only once the completion queue is
            # drained, so an answer that beat its deadline is never
            # discarded in favor of a synthetic timeout. A wedged
            # worker still can't stall the run: an empty poll lands
            # here within MAX_PENDING_INTERVAL_US.
            if deadlines:
                now = relative_time_nanos()
                overdue = [(t, o, ts) for t, (o, dl, ts)
                           in deadlines.items() if now >= dl]
                if overdue:
                    for thread, op1, timeout_s in overdue:
                        LOG.warning(
                            "process %r exceeded its %.3gs op deadline; "
                            "recording :info and retiring worker %r",
                            op1.get("process"), timeout_s, thread)
                        settle(thread,
                               {**op1, "type": "info",
                                "error": ["op-timeout", timeout_s]},
                               now)
                        # abandon the wedged worker (its late answer is
                        # discarded above) and seat a replacement; if it
                        # ever unwedges, the queued exit lets it close.
                        # Clients reopen fresh for the new process; the
                        # single shared nemesis can't, so its
                        # replacement answers :info without touching it
                        old = workers[thread]
                        old.abandoned = True
                        # displace any undelivered op first (the worker
                        # may have wedged before dequeuing it) so the
                        # exit sentinel always lands and close() runs
                        try:
                            old.inbox.get_nowait()
                        except queue.Empty:
                            pass
                        try:
                            old.inbox.put_nowait({"type": "exit"})
                        except queue.Full:
                            pass
                        replacement = (RetiredNemesisWorker()
                                       if thread == NEMESIS
                                       else ClientNemesisWorker())
                        workers[thread] = _WorkerThread(
                            test, completions, replacement, thread)
                    poll_timeout_us = 0
                    continue

            now = relative_time_nanos()
            ctx = ctx.with_time(now)
            if online is not None and not aborted \
                    and online.should_abort():
                aborted = True
                LOG.warning(
                    "online checker confirmed a violation; aborting "
                    "the run early (%d ops outstanding will drain)",
                    outstanding)
            res = None if aborted else gen_op(gen, test, ctx)
            if res is None:
                if outstanding > 0:
                    poll_timeout_us = MAX_PENDING_INTERVAL_US
                    continue
                for w in workers.values():
                    w.inbox.put({"type": "exit"})
                for w in workers.values():
                    w.thread.join()
                return History(history)

            op, gen1 = res
            if op is PENDING:
                # keep the un-advanced generator, as the reference does
                # (interpreter.clj:263-265)
                poll_timeout_us = MAX_PENDING_INTERVAL_US
                continue
            if now < op["time"]:
                # not yet time for this op; sleep-poll until then
                poll_timeout_us = deadline_capped(
                    max(1, (op["time"] - now) // 1000), now)
                continue
            thread = process_to_thread(ctx, op["process"])
            workers[thread].inbox.put(op)
            ctx = ctx.with_time(op["time"]).busy(thread)
            gen = gen_update(gen1, test, ctx, op)
            if goes_in_history(op):
                record(op)
            if op_timeout is not None or "deadline" in op:
                dl = _op_deadline(test, op, now)
                if dl is not None:
                    deadlines[thread] = (op, dl[0], dl[1])
            outstanding += 1
            poll_timeout_us = 0
    except BaseException:
        LOG.info("shutting down workers after abnormal exit")
        for w in workers.values():
            # the 1-slot inbox may still hold an undelivered op; displace
            # it so the exit sentinel always lands
            try:
                w.inbox.get_nowait()
            except queue.Empty:
                pass
            try:
                w.inbox.put_nowait({"type": "exit"})
            except queue.Full:
                pass
        for w in workers.values():
            w.thread.join(timeout=5)
        raise
    finally:
        # flush + close the write-ahead journal on every exit path: the
        # on-disk prefix is the run's crash-surviving record
        if journal is not None:
            journal.close()
