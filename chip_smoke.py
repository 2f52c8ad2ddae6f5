#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (jepsen_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out REPORT.json]

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, in order; any failure raises and exits non-zero:

  1. print the card (torch's name, and nvidia-smi's name and power limit)
     and build every kernel under jepsen_tpu_torch/csrc with nvcc, one
     process per source, all at once;
  2. hold K1 (the dense closure round) bit-exact against its plain PyTorch
     version on the card over a shape matrix (P = 0 to 19), several rounds
     each, and on the real table and transitions of the concurrency-11
     history's dense walk after 1,500 steps, then time both with CUDA
     events at the main path's shapes and on the real table;
  3. hold K2 (the sort family's frontier hash dedup) bit-exact against its
     plain version on all four outputs over the main path's (N, F) shapes,
     full frontiers, both sides of the single-block cap (N = 8,192 and
     8,193) and edge cases, then time both, and torch.unique beside
     them, with the path each shape takes and the CUDA launches a call
     makes, and where both routes take a shape (N <= 8,192), each route
     in turns;
  4. drive the main path — `linearizable(model).check(...)` — on the dense
     family (the headline 10k-op register history, the adversarial
     crashed-writes history and the concurrency-11 history forced dense,
     a corrupted headline) and the sort family under engine="auto" (the
     headline with the default phantom read, a 10k-op counter history,
     the concurrency-11 history and the adversarial history, the last two
     under a wall-time budget), with every kernel's launch count set to 0
     just before and read just after (each dense walk launches K3, the
     dense step walk, whose reported rounds are the result's
     closure-rounds, and never K1 alone; K2 on the hash route); then hold
     verdicts, culprit ops, counts (a dense walk's host syncs are K3's,
     fewer than the CPU path's) and final carries against the port's
     own CPU path (run in a worker process from the end of phase 1 on),
     and trace the first 250 steps of four walks with torch.profiler for
     the device's busy share;
 4b. hold K3 against the eager walk, its plain version, on the card: the
     headline, the adversarial and concurrency-11 histories forced
     dense, the hazelcast batch's four dense groups (batched), the dense
     stream's first three chunks and a rabbitmq-shaped mutex (S = 4,
     P = 3), each with its final carry equal element for element and its
     rounds equal; each walk's wall both ways with host syncs and
     launches, and torch.profiler traces of the headline and the
     hazelcast batch's largest group (both ways on the profile prefix,
     K3 over the whole walk) for the device's busy share;
  5. hold K1 and K2 with a batch axis bit-exact against their plain
     versions (K1 at each dense group's (B, 8, 2^P) of the hazelcast batch
     and at P = 0-3 and 19 with B = 4; K2 on all four outputs at
     (32, 2048, 1024) and (32, 17408, 1024) and on edge rows, both
     routes), each row against the unbatched call on that row, and time
     each batched launch against B unbatched launches of the same rows,
     in turns;
  6. drive the batch path — `analysis_gpu_batch` and the independent
     checker over a key-sharded history — at full size: the hazelcast
     shape (100 keys of 500 register ops, three corrupted, dense groups
     P = 4-10, K3 batched) and 32 counter keys on the sort family's hash
     route (two corrupted, K2 batched on both routes), with every
     kernel's launch count set to 0 just before each run and read just
     after; then the dense batch again under an injected OOM (the
     ladder's split); then hold verdicts, culprit ops, counts and each
     group's final batched carry against the port's CPU path (run in a
     worker process from the end of phase 1 on), and trace
     the first 300 lockstep steps of each batch's largest group;
  7. the Elle phase: the batched SCC classifier on random 0/1 buckets
     (e = 8 to 1,024) against its CPU path and its numpy mirror, timed;
     the north-star list-append history (100,000 txns), valid with no
     classifier call, then with 64 injected G1c cycles, equal to the CPU
     path's result; the 10,000-txn rw-register history, plain and with
     the realtime and process graphs; three disjoint 4,000-node rings
     (G0, G-single, G2-item) in one 4,096-wide bucket, timed beside its
     bound, and 1,000-node rings against the CPU path; the G1c history
     again under an injected OOM (one retry, the same result);
  8. the streaming-and-tier phase, five runs at full size: the
     adversarial history streamed on the dense engine (16 slots, K3 at
     (8, 16)); a register history with a phantom read streamed op by op
     on the sort engine's hash route (K2) until the violation shows; the
     dense stream again with a checkpoint every 2 chunks under a device
     loss injected at its midpoint chunk (one retry, the same result);
     the 10,000-txn rw-register history through WrStream; and the
     headline at tier 'screen' (sample 0 and 1) and under the
     competition race. Every kernel's launch count is set to 0 just
     before each stream and read just after (K3 and K2 must launch);
     each WGL stream's final carry is held against the offline walk of
     its engine on the card, each result against the CPU path's (the
     dense stream through the first chunk of its full-size run), and feed,
     tail and offline walls are printed (the dense stream's CPU check
     runs in a worker process from the end of phase 1 on);
  9. the verification service on the card: one VerificationService, 16
     streams of a 1,000-op register history fed from 16 threads (streams
     0-7 dense, K3; 8-15 packed sort on the hash route, K2; streams 5 and
     13 invalid), every kernel's launch count set to 0 just before the
     16-stream run and read just after, each stream's own K3/K2 counts
     adding up to them, each result equal to the stream alone on the card
     and on the CPU path (in worker processes; the dense streams on their
     first 400 history ops, three chunks and a checkpoint); the wall and
     ops/s at 1, 4 and 16 streams, the device's busy share of a
     16-stream run, a rerun with a device loss on stream 3 and an OOM on
     stream 11 on the default adaptive service (both recover, every
     sibling equal to its clean run), a drain and a resume of stream 0,
     and two ServiceClients over the socket with /metrics and /healthz;
 10. the sharded phase: over a one-rank NCCL group on the card,
     check_batch_sharded of phase 6's hazelcast batch (per_key equal to
     phase 6's verdicts, the JAX package's group plan, K3 launched),
     of its counter batch (K2 launched) and of the hazelcast batch again
     under an injected OOM (the split), list_append.check of phase 7's
     G1c history over the mesh (equal to phase 7's result), and the
     closure of a 4,096-node ring with and without the mesh, every
     collective on CUDA tensors; then four gloo ranks sharing the card,
     each building both kernels afresh into one directory at once and
     walking its block of the hazelcast batch through K3 (every rank's
     result equal to the one-rank run's); dryrun_multichip(4) on the
     card; and entry() on the card against the CPU path;
 11. the search-and-chaos phase: the scenario search's pinned
     planted-bug find (phased-register, seed 2) with its batch
     escalation auditing clean histories through analysis_gpu_batch
     (dense groups, K3 batched), a register search escalating through an
     in-process VerificationService on the card, and run_chaos on both
     chaos workloads (every oracle green), every kernel's launch count
     set to 0 just before each run and read just after, each result
     equal to the CPU path's (in a worker process) but for its wall and
     each launch count equal to the CPU path's plain calls; then the
     chaos command (`python -m jepsen_tpu_torch chaos`) as a subprocess
     on the card, exiting 0 with the in-process run's result;
 12. the run path: the port's `core.run` as a user drives it, over the
     dummy remote, all on the card: the etcd suite's register test map
     (5 nodes, concurrency 10, 5,000 invocations over about 10 keys of
     500, a partition nemesis, the etcd checker compose) with an
     in-process keyed CAS client, its independent check launching K3
     batched; a 10,000-invocation single-register run with `online`,
     its dense stream launching K3 during the run and `analyze`
     reusing the streamed verdict; the same at 20,000 invocations with
     a lying client and `abort-on-violation`, stopping early; and the CLI's `test` and
     `analyze` on a 2,000-invocation register map, both exiting 0 with
     the same results. Every kernel's launch count is set to 0 just
     before each run and read just after; each run's verdict is held
     against the CPU path's check of its stored history in a worker
     process (the register run per key, with its batch-walk counts);
 13. the workloads: the tidb/cockroach suites' monotonic and sequential
     test maps through `core.run` as phase 12 runs etcd's (5 nodes,
     concurrency 10, 20,000 invocations, the partition nemesis, the std
     checker compose, the workload's Elle checker on the card), each
     with an in-process serializable store that plants a stale read now
     and then (one version back); the monotonic run must end invalid
     with G-single-realtime and the sequential one with
     G-single-process, each after at least one classifier call on the
     card and none of K1, K2 or K3, with the classifier's call count and
     every kernel's launch count set to 0 just before each run and read
     just after; each workload result is held, whole, against the CPU
     path's check of the run's stored history in a worker process;
 14. the suites: the etcd suite's register test map (5 nodes,
     concurrency 10, 11,000 invocations at 500 ops per key, the
     partition nemesis, the suite's checker compose) with its own
     EtcdClient against tests/fake_etcd.py over real HTTP, and the
     hazelcast suite's cas-register map (one register, concurrency 10,
     11,000 invocations, its partition nemesis) against the CP shim
     (`suites/cp_shim.py`), both through `core.run` over the dummy
     remote with `db.noop` and `os_.noop`, every kernel's launch count
     set to 0 just before each run and read just after (the etcd run's
     independent check launches K3 batched; the hazelcast run's single
     check K3 or K2); each workload result held, whole but for its
     device and duration, against the CPU path's check of the run's
     stored history in a worker process; then the port's web UI
     (`web.serve`) over the phase's store, whose home page lists both
     runs and whose results.json is the run's. The phase imports every
     module of the slice (the thirteen suite and protocol modules,
     `web`, `repl`, `cli.main`);
 15. the suites again: the dgraph suite's linearizable-register map
     (its HTTP transaction client against tests/fake_dgraph.py), the
     yugabyte suite's ycql/single-key-acid map (its CQL client against
     tests/fake_cql.py) and the faunadb suite's register map (its HTTP
     query client against tests/fake_fauna.py), each with its partition
     nemesis and checker compose, 5 nodes, concurrency 10, cut as phase
     14's (SUITE2_INVOCATIONS) and without the workloads' own pacing,
     through `core.run` on the card with every kernel's launch count
     set to 0 just before each run and read just after (dgraph's
     independent check launches K3 batched; yugabyte's and faunadb's
     composes walk each key alone); each workload result held against
     the CPU path's as in phase 14. The phase imports the seven
     modules of the slice;
 16. the suites a third time: the raftis suite's register map (one
     register, its RESP client against tests/fake_resp.py's FakeRedis),
     the rabbitmq suite's mutex map (the mutex model, its management-API
     client against tests/fake_rabbitmq.py) and the ignite suite's
     register map (keyed registers, its REST client against
     tests/fake_es_ignite.py's FakeIgnite), each with the partition
     nemesis of its `std_test` and its checker compose, cut as phase
     15's (SUITE3_INVOCATIONS), through `core.run` on the card with
     every kernel's launch count set to 0 just before each run and read
     just after (raftis's and rabbitmq's single checks launch K3
     unbatched, ignite's independent check K3 batched); each workload
     result held against the CPU path's as in phase 14. Phases 14-16 run
     each fake in a spawned child process of its own (`data_planes`), and
     hold their runs against the CPU path after phase 16's runs, so that
     the worker pool checks phase 14's and 15's beside the later runs.
     The phase imports the nineteen modules of the slice (zookeeper,
     consul and mongodb-smartos run only in the tests: their fakes
     import the JAX package);
 17. fail if any result other than the injected runs' carries a
     'recovered' or 'degraded' stamp, or if jax or the JAX package was
     imported; print one JSON line of per-kernel numbers, the
     nvidia-smi line, and last the line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or without the package beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # outside the tensor cores, FMA = 2 ops

SEED = 45100
HEADLINE = dict(n_ops=10_000, concurrency=5, values=5, crash_rate=0.0005,
                seed=SEED)
ADVERSARIAL = dict(n_ops=10_000, concurrency=6, crashed_writes=8,
                   front_load=True, seed=SEED)
AT_CAP = dict(ADVERSARIAL, concurrency=11)
COUNTER = dict(n_ops=10_000, seed=SEED)
# wall-time budgets of the two escalating sort runs (analysis_gpu's
# budget_s), and their chunk size, so that the budget is read often
AT_CAP_BUDGET_S = 90
# phase 4b: the rabbitmq-shaped mutex's ops (the suite's run holds about
# 12,000 history ops) and the dense stream's chunks K3 walks both ways
K3_MUTEX_OPS = 6_000
K3_STREAM_CHUNKS = 3
ADVERSARIAL_BUDGET_S = 150
BUDGET_CHUNK = 1024
# every P from 0 to 19: P <= 3 is the byte-per-thread path, P = 0-3
# inside a chunk are the byte butterflies; S = 3, 5, 24 and 30 are not
# multiples of 8
K1_MATRIX = [(3, 0), (4, 1), (5, 2), (8, 3), (30, 4), (8, 5), (16, 6),
             (8, 7), (8, 14), (8, 19), (16, 7), (30, 8), (8, 9), (256, 10),
             (24, 11), (512, 12), (8, 13), (8, 15), (64, 16), (8, 16),
             (8, 17), (16, 18)]
# the main path's shapes (headline, adversarial, at-cap), then the dense
# stream's (8, 16)
K1_TIMED = [(8, 7), (8, 14), (8, 19), (8, 16)]
PROFILE_STEPS = 1_500
# the profile phase traces the first 250 steps of its walks (1,500
# until the service phase needed its time, 1,000 until the search-and-
# chaos phase did, 500 until the workloads phase did)
PROFILE_WALK_STEPS = 250
# the batch path (bench.py:section_config4's hazelcast shape): 100 keys
# of register_history(500, concurrency=4, values=5, crash_rate=0.005,
# seed=1000 + i), keys 7, 42 and 77 with one read set to 5 (one past the
# value domain, so the batch stays dense); and 32 counter keys, keys 5
# and 20 with one read set to 999 and -999 (unreachable, and inside a
# state range that still packs at 16 slots, so the batch takes the hash
# dedup; 10**6 would not)
HAZELCAST = dict(n_ops=500, concurrency=4, values=5, crash_rate=0.005)
HAZELCAST_KEYS, HAZELCAST_BAD = 100, (7, 42, 77)
COUNTER_KEYS, COUNTER_BAD = 32, {5: 999, 20: -999}
BATCH_SLOTS = 16
BATCH_PROFILE_STEPS = 300
# K1 batched: the hazelcast groups' (B padded, P) at S = 8, then P = 0-3
# and 19 at B = 4; K2 batched: (B, N, F) of the counter batch's stage A
# and stage B at F = 1,024, P = 16
K1_BATCHED = [(32, 8, 4), (64, 8, 6), (16, 8, 8), (4, 8, 10), (4, 3, 0),
              (4, 4, 1), (4, 5, 2), (4, 8, 3), (4, 8, 19)]
K2_BATCHED = [(32, 2048, 1024), (32, 17408, 1024)]
ROUTES = ("single-block", "five-launch")       # K2's two routes
# K2's (N, F, keys): stage A (2F) and stage B (F(1+P), P = 8 and 16) at
# the main path's F = 256, and stage B at the adversarial run's escalated
# F, with keys shaped as `stage_keys` makes them; both sides of the
# single-block route's cap; then full frontiers (`frontier_keys`): stage
# A of the escalated passes at F = 1,024 and 4,096, and stage B at
# F = 256 just before the frontier overflows
K2_MATRIX = [(512, 256, "stage"), (2304, 256, "stage"),
             (4352, 256, "stage"), (17408, 1024, "stage"),
             (69632, 4096, "stage"), (278528, 16384, "stage"),
             (8192, 256, "stage"), (8193, 256, "stage"),
             (2048, 1024, "frontier"), (8192, 4096, "frontier"),
             (4352, 256, "frontier")]

# the Elle phase: the classifier's (e, B) buckets on random blocks; the
# north-star list-append history (BASELINE config 5, bench.py:697) with
# 64 injected G1c cycles; the rw-register history (BASELINE config 3,
# bench sections 3_elle_wr_10k and addgraphs_wr_10k); three disjoint
# rings per size (a pure ww ring, one rw edge, two rw edges)
ELLE_BUCKETS = [(8, 64), (64, 16), (256, 8), (1024, 2)]
ELLE_APPEND_TXNS, ELLE_G1C = 100_000, 64
ELLE_WR_TXNS = 10_000
ELLE_RING, ELLE_RING_SMALL = 4_000, 1_000
ELLE_FLAGS = ("G0", "G1c", "G-single", "G2-item")

# the streaming-and-tier phase (bench.py's streaming and recovery
# sections at N_OPS = 10,000): the adversarial history streamed on the
# dense engine with the register's state range declared up front and a
# concurrency hint of 12 (16 slots: K3 at (8, 16)); the register history
# corrupted by a phantom read of 10**6 streamed on the sort engine op by
# op until the violation shows, with the phantom inside the declared
# range so that the config packs at 8 slots and the dedup is the hash
# route (K2); the dense stream again with a checkpoint every 2 chunks
# and a device loss injected at its midpoint chunk; the rw-register
# history through WrStream; the headline history at tier 'screen' and
# under the competition race. The CPU path repeats each stream; the
# dense one only on the ops the card's full-size stream had been fed
# when it dispatched its first STREAM_CPU_DENSE_CHUNKS chunks (the
# carries there must be equal, and both prefixes, finished, give equal
# results and final carries), since the plain closure round at 2^16
# columns costs the CPU some 20 ms a round
STREAM_CHUNK = 1024
STREAM_DENSE = dict(engine="dense", state_range=(-1, 4), concurrency_hint=12,
                    chunk_entries=STREAM_CHUNK)
STREAM_ABORT_HIST = dict(n_ops=10_000, concurrency=5, values=5,
                         crash_rate=0.0, seed=SEED)
STREAM_ABORT = dict(engine="sort", state_range=(-1, 10 ** 6), slots=8,
                    chunk_entries=STREAM_CHUNK)
STREAM_CPU_DENSE_CHUNKS = 1
# the streams' busy share: the first STREAM_PROFILE_OPS ops of the dense
# and the sort stream, fed and finished, under torch.profiler (3,000
# until the workloads phase needed the time)
STREAM_PROFILE_OPS = 1_500
STREAM_VOLATILE = ("duration-ms", "tail-latency-ms", "device", "host-syncs",
                   "trace-id")
# the service phase (bench.py's service section, bench.py:762-902, at a
# size that reaches both kernels): one VerificationService on the card and
# 16 streams of register_history(1_000, concurrency=5, values=5,
# crash_rate=0.0005, seed=300 + i), fed from 16 threads; streams 0-7 dense
# (engine 'auto', state range [-1, 4], concurrency hint 5: S = 8, P = 16,
# K3), streams 8-15 packed sort on the hash route (state range
# [-1, 10**6], 8 slots: K2); streams 5 and 13 invalid by one read changed
# to 4 and to 999 (corrupt seeds 31 and 2: the changed reads are history
# ops 38 and 159). A checkpoint every 2 chunks; chunks of 64 steps, the
# bench's: the default 1,024 gives these 743-step histories one chunk,
# too few for a drain after a first checkpoint or a fault at a third
# dispatch
SERVICE_STREAMS = 16
SERVICE_HIST = dict(n_ops=1_000, concurrency=5, values=5, crash_rate=0.0005)
SERVICE_SEED = 300
SERVICE_BAD = {5: (31, 4), 13: (2, 999)}     # stream -> (corrupt seed, value)
SERVICE_CHUNK = 64
SERVICE_CKPT = 2
SERVICE_COUNTS = (1, 4, 16)
SERVICE_FAULTS = "device-lost@stream-chunk/s3:3,oom@stream-chunk/s11:3"
# the CPU path takes the dense streams' first 400 history ops (three
# chunks, a checkpoint after the second; the plain closure round at 2^16
# columns costs the CPU some 25 ms), the sort streams' whole histories,
# in worker processes beside the card's runs
SERVICE_CPU_DENSE_OPS = 400
# the busy share's run: 16 streams of each history's first 300 ops (a
# profile of the whole 16-stream run reads 1.14M device events; 300, not
# 600, keeps the script near half its limit with phase 12 added)
SERVICE_PROFILE_OPS = 300
SERVICE_TIMING = ("duration-ms", "tail-latency-ms", "violation-at-op")
SERVICE_COUNT_KEYS = ("closure-rounds", "dedup-launches", "host-syncs")
CPU_WORKERS = 2
CPU_WORKER_THREADS = 3
# the sharded phase (wgl.py:2424-2767, the Elle mesh path, the graft
# entries): the batches of phase 6 and the G1c history of phase 7 over a
# one-rank NCCL group on the card, then the hazelcast batch and the
# dryrun in four gloo ranks sharing the card; the JAX package's group
# plan for the hazelcast shape (dense P = 4/6/8/10 with 24/61/12/3 keys)
SHARDED_RANKS = 4
SHARDED_GROUPS = [{"family": "dense", "dedup": "dense-table", "keys": k,
                   "slots": p} for p, k in ((4, 24), (6, 61), (8, 12),
                                            (10, 3))]
SHARDED_RING = 4_096
SHARDED_JOIN_S = 300
# the search-and-chaos phase (jepsen_tpu/search/, jepsen_tpu/chaos/): the
# JAX package's pinned planted-bug find (seed 2 finds the kill-AND-
# partition lost write at simulation 56 of 78) with the batch escalation
# and an audit sample of clean histories, which analysis_gpu_batch walks
# in dense groups (K3 batched); a wall budget per escalation wide enough
# that neither the card nor the CPU path cuts a walk short, so both
# walk as many rounds; a small register search escalating through an
# in-process service on the card; the chaos harness on its fixed
# workload (sort engine, 8 slots, F = 128: the xla-sort route, as in the
# JAX package) for both workloads; and the chaos command as a user runs
# it, on the card. The CPU path repeats each in a worker process
SEARCH_BUG = dict(workload="phased-register", bug="lost-write-kill-partition",
                  generations=12, population=25, seed=2, max_sims=300)
SEARCH_RUNS = {
    "batch": dict(SEARCH_BUG, escalate="batch", sample=0.3,
                  host_budget_s=60.0),
    "service": dict(workload="register", generations=2, population=6, seed=5,
                    max_sims=12, escalate="service", sample=0.5),
}
CHAOS = dict(budget=6, ops=64, seed=23)
CHAOS_WORKLOADS = ("register", "register-corrupt")
CHAOS_CLI_S = 300

# Phase 12, the run path: the port's core.run as a Jepsen user drives it,
# over the dummy remote. The register run is the etcd suite's register
# test map (5 nodes, concurrency 10, the linearizable_register workload
# at 500 ops per key, a partition_random_halves nemesis cycling start and
# stop, the etcd checker compose) with an in-process keyed CAS client for
# EtcdClient and no stagger, cut to 5,000 invocations (about 10 keys:
# phase 14 drives the same map with the suite's own client, and the
# script's time needs the room) and its nemesis cycle from 5 s to 1 s,
# the nemesis schedule bounded to RUN_NEMESIS_S; the online and abort
# runs are the headline shape (one register, concurrency 5) through the
# streamed check; the CLI pair runs test then analyze on a
# 2,000-invocation register map
RUN_NODES = ["n1", "n2", "n3", "n4", "n5"]
RUN_REGISTER = dict(concurrency=10, per_key_limit=500, invocations=5_000)
RUN_NEMESIS_CYCLE_S = 1.0
RUN_NEMESIS_S = 4.0
RUN_ONLINE = dict(concurrency=5, invocations=10_000, state_range=[-1, 4])
# the abort run: the online run's shape at the JAX package's abort test's
# 20,000 invocations, so that its early stop shows with a margin (its
# stream reached the lie after 15,248 of 20,000 history ops once)
RUN_ABORT_INVOCATIONS = 20_000
RUN_LIE_AFTER = 150          # the lying client's first wrong read
RUN_ABORT_CHUNK = 256        # stream chunk of the abort run
RUN_CLI_INVOCATIONS = 2_000
RUN_PERF_FILES = ("latency-raw.svg", "latency-quantiles.svg", "rate.svg",
                  "timeline.html", "history.jsonl.gz", "results.json")
# Phase 13, the workloads: the tidb and cockroach suites' monotonic and
# sequential test maps (`suites/cockroach.py:500-535` through
# `suites/__init__.py: std_test`) cut as phase 12 cut etcd's, with an
# in-process serializable store for the suites' SQL clients, at
# concurrency 10 and 20,000 invocations. After WORKLOAD_WARMUP reads the
# store plants one stale read in every WORKLOAD_PLANT_EVERY: a key one
# version back (monotonic: the read's most recently written key,
# G-single-realtime) or a pair's first key before its write while the
# second shows (sequential: G-single-process). Staleness of one version keeps each
# cycle's SCC a few transactions, under analyze_edges' max_dense, so
# the classifier runs on the card
WORKLOAD_RUN = dict(concurrency=10, invocations=20_000)
WORKLOAD_WARMUP = 1_000
WORKLOAD_PLANT_EVERY = 500
WORKLOAD_ANOMALY = {"monotonic": "G-single-realtime",
                    "sequential": "G-single-process"}
# Phase 14, the suites: the etcd suite's register map
# (`suites/etcd.py: etcd_test`) against tests/fake_etcd.py over real
# HTTP, and the hazelcast suite's cas-register map
# (`suites/hazelcast.py: hazelcast_test`) against `suites/cp_shim.py`,
# each at 5 nodes and concurrency 10 with the suite's own client,
# nemesis and checker compose, `db.noop` and `os_.noop`; the map's
# time-limited, staggered generator replaced by SUITE_RUN's invocations
# of the same workload's generator beside the bounded nemesis schedule of
# phase 12. The fakes are linearizable, so both verdicts are valid.
# Neither fake serves 20,000 invocations in 40 s under ten clients (on
# the H100's host: tests/fake_etcd.py 582-686 and the CP shim 566-739
# history ops/s, one HTTP request per op), so each run is cut to the
# count the slower of them served in 40 s on the slowest host seen,
# rounded down to a thousand
SUITE_RUN = dict(concurrency=10, ops_per_key=500, invocations=11_000)
# phase 15: the dgraph, yugabyte and faunadb suites' register maps the
# same way, against tests/fake_dgraph.py, fake_cql.py and fake_fauna.py,
# without the workload's own pacing (`suite_run_test`). What each fake
# serves in about 20 s under ten clients (on the H100's host, with the
# fake in a child process: 583, 2,276 and 717 history ops/s) is 5,000,
# 22,000 and 7,000 invocations; the CPU path's checks of those (10.6,
# 181.2 and 125.9 s in the worker pool) took the script's phases to
# 1,013.7 s, so yugabyte's and faunadb's are cut to what keeps the whole
# under 800 s
SUITE2_INVOCATIONS = {"dgraph": 5_000, "yugabyte": 5_000, "faunadb": 2_000}
# phase 16: the raftis register (one register over RESP), the rabbitmq
# mutex (the mutex model, over the management HTTP API) and the ignite
# register (keyed registers over REST) maps the same way, against
# tests/fake_resp.py's FakeRedis, fake_rabbitmq.py and fake_es_ignite.py's
# FakeIgnite, each in a child process. What each fake serves in about
# 20 s under ten clients (on the H100's host: 3,759, 1,355 and 1,092
# history ops/s) is 37,000, 13,000 and 10,000 invocations. The CPU path
# checks the raftis register at 5.8-15.7 ms an invocation and ignite's
# keys at 2.6-8.1 ms in the worker pool, which still works through
# phases 14 and 15's checks, and the fakes slow down beside those
# checks (ignite 463 history ops/s in the whole script): at 5,000, 10,000
# and 8,000 the phase took 115.5 s and the script 939.0 s, so the counts
# are cut to keep the phase, its checks included, near 60 s
SUITE3_INVOCATIONS = {"raftis": 2_000, "rabbitmq": 6_000, "ignite": 4_000}
SUITE_WORKLOADS = {"etcd": "register", "hazelcast": "cas-register",
                   "dgraph": "linearizable-register",
                   "yugabyte": "ycql/single-key-acid", "faunadb": "register",
                   "raftis": "register", "rabbitmq": "mutex",
                   "ignite": "register"}
# the suites whose workload checks one object (a register, a mutex) with
# a bare linearizability checker; the others' are keyed
UNKEYED = ("hazelcast", "raftis", "rabbitmq")
# each suite's own options beside SUITE_WORKLOADS': its partition nemesis,
# and for faunadb and yugabyte no per-key pacing (0.1 s stagger and 0.5 s
# delay; a 1 s stagger); each key keeps the suite's own per-key limits
SUITE_OPTS = {
    "etcd": {"ops-per-key": SUITE_RUN["ops_per_key"], "nemesis": "partition"},
    "hazelcast": {"ops-per-key": SUITE_RUN["ops_per_key"],
                  "nemesis": "partition"},
    "dgraph": {"nemesis": ["partition-halves"]},
    "yugabyte": {"faults": ["partition"], "acid-stagger": 0},
    "faunadb": {"nemesis": ["single-node-partition"], "register-stagger": 0,
                "register-delay": 0},
    "raftis": {"faults": ["partition"]}, "rabbitmq": {"faults": ["partition"]},
    # ignite's keys take etcd's per-key limit: the workload's own default
    # (none) leaves one key for the whole run
    "ignite": {"faults": ["partition"],
               "per-key-limit": SUITE_RUN["ops_per_key"]}}
# the nemesis ops of each suite's bounded schedule (`cut_generator`), by
# their fs: phase 12's start and stop, whose nemeses pick their own cut,
# or, for the suites whose nemeses take a grudge, a start-partition of
# the nodes in halves (`nemesis_op`) and a stop-partition
SUITE_NEMESIS_FS = {
    "etcd": ("start", "stop"), "hazelcast": ("start", "stop"),
    **dict.fromkeys(("dgraph", "yugabyte", "faunadb", "raftis", "rabbitmq",
                     "ignite"), ("start-partition", "stop-partition"))}
# how long a fake's child process may take to start and to stop
DATA_PLANE_START_S = 120
DATA_PLANE_JOIN_S = 10
# the fields of a result that name where and how long it ran
SUITE_VOLATILE = ("device", "duration-ms")


def mutex_history(n_ops, concurrency=3, seed=SEED):
    """A valid mutex history shaped like the rabbitmq suite's: each of
    `concurrency` processes acquires, or releases what it holds; an
    acquire completes ok when the lock is free and fails when it is held
    (the suite's client fails it). States 0 and 1 (S = 4), P =
    concurrency."""
    import random

    from jepsen_tpu_torch.history import History
    rng = random.Random(seed)
    ops, t, holder, emitted = [], 0, None, 0
    inflight = [None] * concurrency
    while emitted < n_ops or any(f is not None for f in inflight):
        p = rng.randrange(concurrency)
        t += rng.randint(1, 10)
        f = inflight[p]
        if f is not None:
            ok = f == "release" or holder is None
            holder = (p if f == "acquire" else None) if ok else holder
            ops.append({"type": "ok" if ok else "fail", "f": f,
                        "value": None, "process": p, "time": t})
            inflight[p] = None
        elif emitted < n_ops:
            inflight[p] = "release" if holder == p else "acquire"
            ops.append({"type": "invoke", "f": inflight[p], "value": None,
                        "process": p, "time": t})
            emitted += 1
    return History(ops)


def zero_launches() -> None:
    """Set every kernel's launch count, and the closure rounds K3 ran, to
    0."""
    from jepsen_tpu_torch.checker import wgl_closure, wgl_dedup, wgl_walk
    wgl_closure.LAUNCHES = wgl_dedup.LAUNCHES = 0
    wgl_walk.LAUNCHES = wgl_walk.ROUNDS = 0


def launch_counts() -> dict:
    """The launch counts since `zero_launches`: K1's and K2's, K3's (the
    dense walk) and the closure rounds K3 ran, which stand for the dense
    walks' rounds (K1's launches before K3 took the walk)."""
    from jepsen_tpu_torch.checker import wgl_closure, wgl_dedup, wgl_walk
    return {"k1_launches": wgl_closure.LAUNCHES,
            "k2_launches": wgl_dedup.LAUNCHES,
            "k3_launches": wgl_walk.LAUNCHES, "k3_rounds": wgl_walk.ROUNDS}


class WalkSyncs:
    """The host reads of the dense walks in this process, by engine shape
    "s_lo,S,P": K3's walks (`DenseKernel._walk_k3`) and the eager walks
    (`run_range_eager`, `run_range_batch_eager`: the CPU path's, and the
    card's in the K3 phase). A K3 walk must read the host once to start
    and once at the end of each of its launches; `hold` refuses any walk
    that read otherwise. Launches are counted per thread, so walks in
    other threads do not blur a walk's count. Install with
    `walk_syncs()`."""

    def __init__(self, wgl, wgl_walk):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.k3 = collections.Counter()
        self.eager = collections.Counter()
        self.calls = self.launches = 0
        self.bad = []
        D = wgl.DenseKernel
        real_launch, real_k3 = wgl_walk.launch, D._walk_k3

        def launch(*a, **kw):
            out = real_launch(*a, **kw)
            self.local.n = getattr(self.local, "n", 0) + 1
            return out

        def walk_k3(k, *a):
            s0, self.local.n = k.syncs, 0
            out = real_k3(k, *a)
            reads, n = k.syncs - s0, self.local.n
            with self.lock:
                self.k3[self.shape(k)] += reads
                self.calls += 1
                self.launches += n
                if reads != 1 + n:
                    self.bad.append((self.shape(k), reads, n))
            return out

        def eager(real):
            def walk(k, *a):
                s0 = k.syncs
                out = real(k, *a)
                with self.lock:
                    self.eager[self.shape(k)] += k.syncs - s0
                return out
            return walk

        wgl_walk.launch = launch
        D._walk_k3 = walk_k3
        D.run_range_eager = eager(D.run_range_eager)
        D.run_range_batch_eager = eager(D.run_range_batch_eager)

    @staticmethod
    def shape(k) -> str:
        return f"{k.s_lo},{k.S},{k.P}"

    def snap(self) -> tuple:
        with self.lock:
            return (collections.Counter(self.k3),
                    collections.Counter(self.eager), self.calls,
                    self.launches)

    def since(self, snap) -> dict:
        """The reads, K3 calls and launches since `snap`: {"k3": {shape:
        reads}, "eager": {shape: reads}, "calls", "launches"}."""
        k3, eager, calls, launches = self.snap()
        return {"k3": dict(k3 - snap[0]), "eager": dict(eager - snap[1]),
                "calls": calls - snap[2], "launches": launches - snap[3]}

    def hold(self) -> None:
        if self.bad:
            raise AssertionError(f"K3 walks whose host reads are not one "
                                 f"to start and one a launch (shape, "
                                 f"reads, launches): {self.bad[:5]}")


_WALK_SYNCS = None


def walk_syncs() -> WalkSyncs:
    """This process's WalkSyncs, installed at the first call."""
    global _WALK_SYNCS
    if _WALK_SYNCS is None:
        from jepsen_tpu_torch.checker import wgl, wgl_walk
        _WALK_SYNCS = WalkSyncs(wgl, wgl_walk)
    return _WALK_SYNCS


def same_syncs_but_walks(label, g_syncs, g_k3, c_syncs, c_eager) -> None:
    """Hold a card result's host reads to the CPU path's: K3's walks read
    the host once to start and once a window (`WalkSyncs.hold`), the
    eager walks every round, and every other read is the same on both."""
    if g_syncs - g_k3 != c_syncs - c_eager or not g_syncs < c_syncs:
        raise AssertionError(f"{label}: {g_syncs} host syncs on the card "
                             f"({g_k3} in K3 walks), {c_syncs} on the CPU "
                             f"path ({c_eager} in eager walks)")


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_inputs(S, P, rng, dev, density=0.05):
    tb = torch.from_numpy(rng.random((S, 1 << P)) < density).to(dev)
    mft = torch.from_numpy(
        (rng.random((P, S, S)) < 0.15).astype(np.uint8)).to(dev)
    return tb, mft


def transition_inputs(S, P, rng, dev, density=0.3):
    """A table and transitions shaped like the main path's: each slot
    moves each state to at most one state (a deterministic model)."""
    tb = torch.from_numpy(rng.random((S, 1 << P)) < density).to(dev)
    mft = np.zeros((P, S, S), np.uint8)
    for p in range(P):
        for s in range(S):
            if rng.random() < 0.75:
                mft[p, rng.integers(S), s] = 1
    return tb, torch.from_numpy(mft).to(dev)


def time_ms(fn, iters, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters) -> float:
    """Time per call with `iters` calls captured in one CUDA graph and
    replayed: the device's time alone, with no host work between the
    launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    ms = time_ms(g.replay, 5, warmup=2) / iters
    del g
    return ms


def in_turns(timer, kernel, other, iters, share=4) -> tuple[float, float]:
    """Kernel and another version (the plain one, by default run a
    quarter as often) timed in turns (other, kernel, kernel, other),
    each the mean of its two turns."""
    o1 = timer(other, max(iters // share, 10))
    k1 = timer(kernel, iters)
    k2 = timer(kernel, iters)
    o2 = timer(other, max(iters // share, 10))
    return (k1 + k2) / 2, (o1 + o2) / 2


def k1_bound(S, P, mft) -> tuple[float, str, int, int]:
    """The least time an H100 could take for one round on these inputs:
    the larger of bytes (table read once and written once as uint8,
    plus mft) over HBM bandwidth and the AND-ORs the data needs (each
    set mft[p, q, s] against the C/2 columns with bit p set, an AND and
    an OR each) over the fp32 rate. This is compulsory traffic at the
    HBM rate, as for every kernel here; it is not K1's own limit. K1's
    table can stay in the 50 MB L2 between rounds, and the kernel loads
    more than the table from there (`k1_l2_bytes`); the data sheet gives
    no L2 rate, so no L2 bound is computed, and K1's distance to this
    bound overstates how much an L2-bound design could still gain."""
    C = 1 << P
    nbytes = 2 * S * C + P * S * S
    ops = 2 * int(mft.sum().item()) * (C // 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def k1_l2_bytes(S, P, mft) -> int:
    """The bytes K1's design loads and stores per round: each row's own
    table once, for each listed source entry (p, s) of row q the whole
    row s where p < 4 (in-chunk butterflies) or half of it where p >= 4
    (chunks with bit p - 4 set), and the output once. Below P = 4 every
    entry reads a whole row."""
    C = 1 << P
    nnz = mft.to(torch.int64).sum(dim=2)          # (P, S): entries of q
    low = int(nnz[:4].sum().item())
    high = int(nnz[4:].sum().item())
    return 2 * S * C + low * C + high * (C // 2 if P >= 4 else C)


def real_k1_inputs(wgl, model, hist, dev, steps, keep=8):
    """The (table, mft) pairs of the last `keep` closure rounds in the
    first `steps` merged steps of the dense walk (the eager walk, which
    launches K1 a round): real inputs of K1."""
    seen = collections.deque(maxlen=keep)
    kernel = wgl.closure_round

    def record(table, mft):
        seen.append((table.clone(), mft.clone()))
        return kernel(table, mft)

    wgl.closure_round = record
    try:
        prefix_walk(wgl, model, hist, dev, eager=True, engine="dense")(steps)
        torch.cuda.synchronize()
    finally:
        wgl.closure_round = kernel
    return list(seen)


def k1_rounds_exact(closure_round, plain, tb, mft, rounds, label) -> int:
    """Hold K1 bit-exact against the plain version over `rounds` rounds
    from tb (fewer once a fixpoint is reached); returns the largest
    absolute difference, 0."""
    max_err = 0
    for r in range(rounds):
        got = closure_round(tb, mft)
        want = plain(tb, mft)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - want.to(torch.int16))
                  .abs().max().item())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 != plain at {label} round {r}")
        if torch.equal(got, tb):
            break
        tb = got
    return max_err


def phase_k1(dev, wgl_closure, real) -> dict:
    closure_round = wgl_closure.closure_round
    plain = wgl_closure.closure_round_plain
    rng = np.random.default_rng(SEED)
    max_err = 0
    for S, P in K1_MATRIX:
        tb, mft = random_inputs(S, P, rng, dev)
        max_err = max(max_err, k1_rounds_exact(
            closure_round, plain, tb, mft, 4, f"S={S} P={P}"))
        log(f"K1 bit-exact vs plain: S={S} P={P}, up to 4 rounds")
    # the real table: each recorded round, then rounds to the fixpoint
    for i, (tb, mft) in enumerate(real):
        max_err = max(max_err, k1_rounds_exact(
            closure_round, plain, tb, mft, 1 if i else 64,
            f"the real table, recorded round {i}"))
    S, P = real[-1][0].shape[0], real[-1][1].shape[0]
    log(f"K1 bit-exact vs plain on {len(real)} real rounds of the dense "
        f"walk at S={S} P={P} ({int(real[-1][0].sum().item())} cells set, "
        f"{int(real[-1][1].sum().item())} transitions)")
    shapes = []
    timed = [(S, P, "shaped", *transition_inputs(S, P, rng, dev))
             for S, P in K1_TIMED]
    timed.append((S, P, f"real: dense walk, step {PROFILE_STEPS}",
                  *real[-1]))
    for S, P, inputs, tb, mft in timed:
        iters = 400 if P < 16 else 100

        def kernel():
            return closure_round(tb, mft)

        def plain_round():
            return plain(tb, mft)

        # device time alone (graph replay), and the time per call of an
        # eager loop, which the host's launch overhead can set
        ms, plain_ms = in_turns(graph_ms, kernel, plain_round, iters)
        eager_ms, plain_eager_ms = in_turns(time_ms, kernel, plain_round,
                                            iters)
        bound_ms, bound_by, nbytes, ops = k1_bound(S, P, mft)
        row = dict(S=S, P=P, inputs=inputs, ms=ms, plain_ms=plain_ms,
                   eager_ms=eager_ms, plain_eager_ms=plain_eager_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   and_or_ops=ops, l2_bytes=k1_l2_bytes(S, P, mft))
        shapes.append(row)
        log(f"K1 time S={S} P={P} ({inputs}): {ms:.6f} ms on the device "
            f"({eager_ms:.6f} ms per eager call); plain {plain_ms:.6f} ms "
            f"({plain_eager_ms:.6f} ms eager); bound {bound_ms:.6f} ms by "
            f"{bound_by} at the HBM rate; {row['l2_bytes']} bytes loaded "
            f"and stored by the design")
    return {"max_abs_err": max_err, "shapes": shapes}


def stage_keys(N, F, rng, live=0.5, legal=0.1):
    """Keys shaped like a dedup input on the main path: F old-frontier
    rows (a share `live` of them distinct keys, the rest EMPTY), then
    N - F candidates, mostly EMPTY (stage B's legality mask is sparse),
    the rest half duplicates of old keys and half new keys drawn from a
    small pool, so that they repeat too."""
    n_live = int(F * live)
    old = np.full(F, -1, np.int64)
    old[:n_live] = rng.choice(2 ** 31 - 1, n_live, replace=False)
    cand = np.full(N - F, -1, np.int64)
    hit = np.nonzero(rng.random(N - F) < legal)[0]
    dup = rng.random(hit.size) < 0.5
    if n_live:
        cand[hit[dup]] = rng.choice(old[:n_live], int(dup.sum()))
    pool = rng.integers(0, 2 ** 31 - 1, max(hit.size // 4, 1))
    cand[hit[~dup]] = rng.choice(pool, int((~dup).sum()))
    return np.concatenate([old, cand]).astype(np.int32)


def frontier_keys(N, F, rng, legal=0.5):
    """Keys shaped like a dedup input from a full frontier: F distinct
    old configurations, then N - F candidates in blocks of F, block m
    the old keys with pending bit m set where the op is legal (a share
    `legal`), else EMPTY. Every valid key is distinct, as in stage A,
    whose candidates all set the bit of the slot just filled."""
    blocks = (N - F) // F
    old = rng.choice(2 ** 31 >> blocks, F, replace=False) << blocks
    cand = [np.where(rng.random(F) < legal, old | (1 << m), -1)
            for m in range(blocks)]
    return np.concatenate([old, *cand]).astype(np.int32)


def k2_keys(N, F, kind, rng):
    return (frontier_keys if kind == "frontier" else stage_keys)(N, F, rng)


def k2_edge_cases(rng):
    """(label, keys, F): all EMPTY, all distinct (count > F, also at the
    single-block cap), N not a power of two, heavy duplicates."""
    return [("all-empty", np.full(512, -1, np.int32), 256),
            ("all-distinct", rng.permutation(4352).astype(np.int32), 256),
            ("all-distinct-8192", rng.permutation(8192).astype(np.int32),
             256),
            ("n-not-pow2", stage_keys(3000, 200, rng), 200),
            ("heavy-dups", rng.choice(np.array([0, 7, 2 ** 31 - 1, 99],
                                               np.int32), 4352), 256)]


def k2_bound(N, F, keys) -> tuple[float, str, int, int]:
    """The least time an H100 could take for one dedup of these keys:
    the larger of bytes (keys read once, the F keys and F flags and the
    count and digest written once) over HBM bandwidth, and the integer
    work the data needs (per valid key the murmur3 finaliser, the
    mask, one probe compare and the XOR: 10 operations; per EMPTY key
    one compare) over the fp32 rate (the guide lists no int32 rate; the
    operations bound is far below the bytes bound either way)."""
    nbytes = 4 * N + 5 * F + 8
    valid = int((keys != -1).sum().item())
    ops = 10 * valid + (N - valid)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def phase_k2(dev, wgl_dedup) -> dict:
    dedup, plain = wgl_dedup.dedup, wgl_dedup.dedup_plain
    rng = np.random.default_rng(SEED + 2)
    cases = [(f"{kind}-{N}-{F}", k2_keys(N, F, kind, rng), F)
             for N, F, kind in K2_MATRIX]
    cases += [(f"dense-{N}-{F}", stage_keys(N, F, rng, live=0.9,
                                            legal=0.6), F)
              for N, F, _kind in K2_MATRIX[:3]]
    cases += k2_edge_cases(rng)
    max_err = 0
    for label, k, F in cases:
        keys = torch.from_numpy(k).to(dev)
        got = dedup(keys, F)
        want = plain(keys, F)
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "new", "count", "digest"), got, want):
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()
                      .item())
            max_err = max(max_err, err)
            if a.dtype != b.dtype or a.shape != b.shape \
                    or not torch.equal(a, b):
                raise AssertionError(f"K2 != plain at {label} (N="
                                     f"{k.size}, F={F}): {name}")
        if k.size <= wgl_dedup.SINGLE_BLOCK_MAX_N:
            # the route `dedup` did not take, on the same keys
            other = [r for r in ROUTES if r != wgl_dedup.path(k.size)][0]
            for name, a, b in zip(("out", "new", "count", "digest"),
                                  wgl_dedup.launch(keys, F, other), want):
                if not torch.equal(a, b):
                    raise AssertionError(f"K2 != plain at {label} (N="
                                         f"{k.size}, F={F}) on the "
                                         f"{other} route: {name}")
        log(f"K2 bit-exact vs plain: {label} N={k.size} F={F} "
            f"({wgl_dedup.path(k.size)}), count {int(got[2].item())}")
    shapes = []
    for N, F, kind in K2_MATRIX:
        keys = torch.from_numpy(k2_keys(N, F, kind, rng)).to(dev)
        iters = 200 if N < 100_000 else 50
        route = wgl_dedup.path(N)
        before = wgl_dedup.cuda_launches()
        dedup(keys, F)
        torch.cuda.synchronize()
        per_call = wgl_dedup.cuda_launches() - before
        if per_call != (1 if route == "single-block" else 5):
            raise AssertionError(f"K2 at N={N}: {per_call} CUDA launches "
                                 f"a call on the {route} route")

        def kernel():
            return dedup(keys, F)

        def plain_dedup():
            return plain(keys, F)

        ms, plain_ms = in_turns(graph_ms, kernel, plain_dedup, iters)
        eager_ms, plain_eager_ms = in_turns(time_ms, kernel, plain_dedup,
                                            iters)
        # both routes where both take N, by graph replay in turns (this
        # route, the other, the other, this one)
        route_ms = {route: ms}
        if N <= wgl_dedup.SINGLE_BLOCK_MAX_N:
            other = [r for r in ROUTES if r != route][0]

            def other_route():
                return wgl_dedup.launch(keys, F, other)

            route_ms[route], route_ms[other] = in_turns(
                graph_ms, kernel, other_route, iters, share=1)
        # the nearest single PyTorch call: distinct keys in key order,
        # with no first-seen order, no new flags and no digest — not the
        # same function, and it reads its output size on the host
        unique_ms = time_ms(lambda: torch.unique(keys), max(iters // 4, 10))
        bound_ms, bound_by, nbytes, ops = k2_bound(N, F, keys)
        row = dict(N=N, F=F, keys=kind, path=route,
                   cuda_launches_per_call=per_call, ms=ms,
                   plain_ms=plain_ms, eager_ms=eager_ms,
                   plain_eager_ms=plain_eager_ms, route_ms=route_ms,
                   unique_ms=unique_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, int_ops=ops)
        shapes.append(row)
        log(f"K2 time N={N} F={F} {kind} keys ({route}, {per_call} CUDA "
            f"launches a call): {ms:.6f} ms on the device "
            f"({eager_ms:.6f} ms per eager call); plain {plain_ms:.6f} ms "
            f"({plain_eager_ms:.6f} ms eager); by route "
            f"{ {r: round(t, 6) for r, t in route_ms.items()} }; "
            f"torch.unique (not the same function) {unique_ms:.6f} ms "
            f"eager; bound {bound_ms:.6f} ms by {bound_by}")
    return {"max_abs_err": max_err, "shapes": shapes}


def exact(got, want, label) -> int:
    """Hold one kernel output bit-exact against the plain version's;
    returns the largest absolute difference, 0."""
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()
              .item()) if got.numel() else 0
    if got.dtype != want.dtype or got.shape != want.shape \
            or not torch.equal(got, want):
        raise AssertionError(f"kernel != plain at {label}")
    return err


def phase_k1_batched(dev, wgl_closure) -> dict:
    """K1 with a batch axis: bit-exact against the plain version and row
    by row against the unbatched kernel over up to four rounds, then the
    batched launch timed against B unbatched launches of the same rows,
    in turns, and the plain version."""
    closure_round = wgl_closure.closure_round
    plain = wgl_closure.closure_round_plain
    rng = np.random.default_rng(SEED + 4)
    max_err, shapes = 0, []
    for B, S, P in K1_BATCHED:
        rows = [transition_inputs(S, P, rng, dev, density=0.05)
                for _ in range(B)]
        tb = torch.stack([t for t, _m in rows])
        mft = torch.stack([m for _t, m in rows])
        t = tb
        for r in range(4):
            before = wgl_closure.LAUNCHES
            got = closure_round(t, mft)
            if wgl_closure.LAUNCHES != before + 1:
                raise AssertionError("a batched K1 call is one launch")
            label = f"K1 batched B={B} S={S} P={P} round {r}"
            max_err = max(max_err, exact(got, plain(t, mft), label))
            for b in range(B):
                exact(got[b], closure_round(t[b], mft[b]), f"{label} row {b}")
            if torch.equal(got, t):
                break
            t = got
        log(f"K1 batched bit-exact vs plain and vs each row's own launch: "
            f"B={B} S={S} P={P}")
        if P >= 19:
            continue
        iters = max(20, 2_000 // B)

        def batched():
            return closure_round(tb, mft)

        def one_by_one():
            return [closure_round(tb[b], mft[b]) for b in range(B)]

        ms, turns_ms = in_turns(graph_ms, batched, one_by_one, iters,
                                share=1)
        _ms, plain_ms = in_turns(graph_ms, batched,
                                 lambda: plain(tb, mft), iters)
        C = 1 << P
        nbytes = B * (2 * S * C + P * S * S)
        ops = 2 * int(mft.sum().item()) * (C // 2)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        row = dict(B=B, S=S, P=P, ms=ms, scalar_turns_ms=turns_ms,
                   plain_ms=plain_ms, bound_ms=max(t_b, t_o) * 1e3,
                   bound_by="bytes" if t_b >= t_o else "operations",
                   bytes=nbytes, and_or_ops=ops)
        shapes.append(row)
        log(f"K1 batched time B={B} S={S} P={P}: {ms:.6f} ms a batched "
            f"launch; {turns_ms:.6f} ms for {B} unbatched launches of the "
            f"same rows (in turns); plain {plain_ms:.6f} ms; bound "
            f"{row['bound_ms']:.6f} ms by {row['bound_by']}")
    return {"max_abs_err": max_err, "shapes": shapes}


def k2_batch_edge_rows(N, F, rng) -> np.ndarray:
    """Four rows: all EMPTY, all distinct, heavy duplicates, and keys
    shaped like a dedup input."""
    return np.stack([np.full(N, -1, np.int32),
                     rng.permutation(N).astype(np.int32),
                     rng.choice(np.array([0, 7, 2 ** 31 - 1, 99], np.int32),
                                N),
                     stage_keys(N, F, rng)])


def phase_k2_batched(dev, wgl_dedup) -> dict:
    """K2 with a batch axis: all four outputs bit-exact against the plain
    version and row by row against the unbatched kernel, on both routes
    where both take N, then the batched call timed against B unbatched
    calls of the same rows, in turns, and the plain version."""
    dedup, plain = wgl_dedup.dedup, wgl_dedup.dedup_plain
    rng = np.random.default_rng(SEED + 6)
    max_err, shapes = 0, []
    cases = [(f"stage-{B}x{N}-{F}",
              np.stack([stage_keys(N, F, rng) for _ in range(B)]), F)
             for B, N, F in K2_BATCHED]
    cases += [(f"edge-rows-{N}-{F}", k2_batch_edge_rows(N, F, rng), F)
              for _B, N, F in K2_BATCHED]
    for label, k, F in cases:
        B, N = k.shape
        keys = torch.from_numpy(k).to(dev)
        route = wgl_dedup.path(N)
        before = wgl_dedup.cuda_launches()
        got = dedup(keys, F)
        torch.cuda.synchronize()
        per_call = wgl_dedup.cuda_launches() - before
        if per_call != (1 if route == "single-block" else 5):
            raise AssertionError(f"K2 batched {label}: {per_call} CUDA "
                                 f"launches on the {route} route")
        want = plain(keys, F)
        for name, a, b in zip(("out", "new", "count", "digest"), got, want):
            max_err = max(max_err, exact(a, b, f"K2 batched {label} {name}"))
        for b in range(B):
            for name, a, o in zip(("out", "new", "count", "digest"), got,
                                  dedup(keys[b].contiguous(), F)):
                exact(a[b], o, f"K2 batched {label} row {b} {name}")
        if N <= wgl_dedup.SINGLE_BLOCK_MAX_N:
            for name, a, b in zip(("out", "new", "count", "digest"),
                                  wgl_dedup.launch(keys, F, "five-launch"),
                                  want):
                exact(a, b, f"K2 batched {label} five-launch {name}")
        log(f"K2 batched bit-exact vs plain and vs each row's own call: "
            f"{label} ({route}, {per_call} CUDA launches a call)")
    for B, N, F in K2_BATCHED:
        k = np.stack([stage_keys(N, F, rng) for _ in range(B)])
        keys = torch.from_numpy(k).to(dev)
        rows = [keys[b].contiguous() for b in range(B)]
        iters = 40

        def batched():
            return dedup(keys, F)

        def one_by_one():
            return [dedup(r, F) for r in rows]

        ms, turns_ms = in_turns(graph_ms, batched, one_by_one, iters,
                                share=1)
        _ms, plain_ms = in_turns(graph_ms, batched,
                                 lambda: plain(keys, F), iters)
        valid = int((keys != -1).sum().item())
        nbytes = B * (4 * N + 5 * F + 8)
        ops = 10 * valid + (B * N - valid)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        row = dict(B=B, N=N, F=F, path=wgl_dedup.path(N), ms=ms,
                   scalar_turns_ms=turns_ms, plain_ms=plain_ms,
                   bound_ms=max(t_b, t_o) * 1e3,
                   bound_by="bytes" if t_b >= t_o else "operations",
                   bytes=nbytes, int_ops=ops)
        shapes.append(row)
        log(f"K2 batched time B={B} N={N} F={F} ({row['path']}): "
            f"{ms:.6f} ms a batched call; {turns_ms:.6f} ms for {B} "
            f"unbatched calls of the same rows (in turns); plain "
            f"{plain_ms:.6f} ms; bound {row['bound_ms']:.6f} ms by "
            f"{row['bound_by']}")
    return {"max_abs_err": max_err, "shapes": shapes}


def batch_histories(models, synth):
    """The hazelcast-shape dense batch and the counter sort batch."""
    hz = [synth.register_history(**HAZELCAST, seed=1000 + i)
          for i in range(HAZELCAST_KEYS)]
    for i in HAZELCAST_BAD:
        hz[i] = synth.corrupt(hz[i], value=HAZELCAST["values"])
    cnt = [synth.counter_history(500, seed=2000 + i)
           for i in range(COUNTER_KEYS)]
    for i, v in COUNTER_BAD.items():
        cnt[i] = synth.corrupt(cnt[i], value=v)
    return (models.cas_register(), hz), (models.counter(), cnt)


def kv_history(independent, hists) -> list:
    """The per-key histories as one key-sharded history: values wrapped
    as (key, value) tuples, processes kept apart per key, ops merged by
    time (each key's ops keep their order)."""
    ops = []
    for k, h in enumerate(hists):
        for o in h.ops:
            ops.append(dict(o, value=independent.ktuple(k, o["value"]),
                            process=o["process"] + 1_000 * k))
    ops.sort(key=lambda o: o["time"])
    return ops


def walk_totals(results) -> dict:
    """The batch walks behind a list of batch results: each walk's
    'batch-walk' stamp once (the keys it decided share it)."""
    walks = {json.dumps(r["batch-walk"], sort_keys=True): r["batch-walk"]
             for r in results if "batch-walk" in r}
    return {"groups": [w["group"] + [w["keys"]] for w in walks.values()],
            "closure_rounds": sum(w["closure-rounds"] for w in walks.values()),
            "dedup_launches": sum(w["dedup-launches"] for w in walks.values()),
            "host_syncs": sum(w["host-syncs"] for w in walks.values())}


def no_stamps(label, results) -> None:
    """A fault the ladder absorbed must not pass unseen."""
    for i, r in enumerate(results):
        if r.get("recovered") or r.get("degraded"):
            raise AssertionError(f"{label} key {i}: recovered/degraded "
                                 f"{r.get('recovered')} {r.get('error')}")


def run_batch(label, fn, wgl, wgl_dedup, carry_to_numpy):
    """One run of the batch path with every kernel's launch count set to
    0 just before and read just after, and each group walk's final
    batched carry kept (host copies, in walk order)."""
    carries = []
    walk = wgl._batch_walk

    def record(*a, **k):
        carry = walk(*a, **k)
        carries.append(carry_to_numpy(carry))
        return carry

    wgl._batch_walk = record
    zero_launches()
    cuda0 = wgl_dedup.cuda_launches()
    snap = walk_syncs().snap()
    try:
        t = time.perf_counter()
        rs = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        wgl._batch_walk = walk
    tot = walk_totals(rs)
    rec = dict(wall_s=wall, **launch_counts(),
               walk_reads=walk_syncs().since(snap),
               k2_cuda_launches=wgl_dedup.cuda_launches() - cuda0,
               verdicts=[r["valid?"] for r in rs],
               invalid=[i for i, r in enumerate(rs) if r["valid?"] is False],
               op_index={i: r.get("op-index") for i, r in enumerate(rs)
                         if r["valid?"] is False}, **tot)
    log(f"batch {label}: {len(rs)} keys, wall {wall:.3f} s, K3 launches "
        f"{rec['k3_launches']} ({rec['k3_rounds']} rounds), K2 launches "
        f"{rec['k2_launches']} "
        f"({rec['k2_cuda_launches']} CUDA launches), host syncs "
        f"{tot['host_syncs']}, groups [kind, shape..., keys] "
        f"{tot['groups']}, invalid keys {rec['op_index']}")
    return rs, rec, carries


def check_batch(label, rs, rec, bad, dense) -> None:
    """Hold a batch run to what its histories are: the corrupted keys
    invalid with an op-index, the rest valid, K3 launched on the dense
    groups (its rounds the walks' count, K1 never alone) and K2 on the
    sort group's hash route as often as the walks counted."""
    if rec["invalid"] != sorted(bad) or any(
            not isinstance(rec["op_index"][i], int) for i in bad):
        raise AssertionError(f"{label}: invalid keys {rec['op_index']}")
    if any(v not in (True, False) for v in rec["verdicts"]):
        raise AssertionError(f"{label}: undecided keys")
    if any(r["analyzer"] != "gpu-wgl-batch" or r["device"] != "cuda"
           for r in rs):
        raise AssertionError(f"{label}: a key left the batch path")
    k1, k2, k3 = rec["k1_launches"], rec["k2_launches"], rec["k3_launches"]
    if dense:
        if k3 <= 0 or rec["k3_rounds"] != rec["closure_rounds"] or k1 != 0 \
                or k2 != 0 or any(g[0] != "dense" for g in rec["groups"]):
            raise AssertionError(f"{label}: K3 {k3} with {rec['k3_rounds']}"
                                 f" rounds for {rec['closure_rounds']}, K1 "
                                 f"{k1}, K2 {k2}")
        return
    singles = (5 * k2 - rec["k2_cuda_launches"]) // 4
    if k1 != 0 or k3 != 0 or k2 <= 0 or k2 != rec["dedup_launches"] \
            or singles <= 0 \
            or singles >= k2 or any(r["dedup"] != "pallas-hash" for r in rs):
        raise AssertionError(f"{label}: K1 {k1}, K2 {k2} "
                             f"({rec['k2_cuda_launches']} CUDA launches) for "
                             f"{rec['dedup_launches']} hash dedups")


BATCH_AGREE_KEYS = ("valid?", "op-index", "max-frontier", "dedup",
                    "analyzer", "op-count", "batch-walk")


def without_dense_syncs(fields: dict) -> dict:
    """A key's compared fields without its batch walk's host syncs where
    the walk is dense: K3 reads the host once a window, the CPU path's
    eager walk every round, so those counts differ by design, and every
    K3 walk on the card is held to its own count (`WalkSyncs.hold`, at
    each phase's end); every other walk count is the same on both."""
    walk = fields.get("batch-walk")
    if not walk or walk["group"][0] != "dense":
        return fields
    return dict(fields, **{"batch-walk": {k: v for k, v in walk.items()
                                          if k != "host-syncs"}})


def cpu_batch(kind: str) -> tuple:
    """Phase 6's CPU path in a worker process: the hazelcast ("dense") or
    the counter ("sort") batch through analysis_gpu_batch on the CPU,
    with each group walk's final batched carry. It needs nothing of the
    card's run. Returns each key's compared fields, the carries, the
    seconds it took and the host reads of its eager dense walks by
    engine shape."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.carry import carry_to_numpy
    from jepsen_tpu_torch.checker import synth, wgl
    t = time.perf_counter()
    dense, sort = batch_histories(models, synth)
    model, hists = dense if kind == "dense" else sort
    carries = []
    walk = wgl._batch_walk

    def record(*a, **k):
        carry = walk(*a, **k)
        carries.append(carry_to_numpy(carry))
        return carry

    wgl._batch_walk = record
    snap = walk_syncs().snap()
    rs = wgl.analysis_gpu_batch(model, hists, device="cpu",
                                slots=BATCH_SLOTS)
    return ([{k: r.get(k) for k in BATCH_AGREE_KEYS} for r in rs], carries,
            time.perf_counter() - t, walk_syncs().since(snap)["eager"])


def same_carries(label, a, b) -> None:
    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} group walks vs {len(b)}")
    for g, (ca, cb) in enumerate(zip(a, b)):
        for i, (x, y) in enumerate(zip(ca, cb)):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{label}: walk {g} carry element {i} "
                                     f"differs")


def phase_batch(dev, models, synth, wgl, wgl_dedup,
                independent, linearizable, platform, carry_to_numpy,
                cpu_batches) -> dict:
    """The batch path at full size on the card, under injection, and
    against the CPU path (`cpu_batches`: futures of `cpu_batch` for
    "dense" and "sort", run in worker processes since phase 1)."""
    (reg, hz), (counter, cnt) = batch_histories(models, synth)
    kw = dict(slots=BATCH_SLOTS)
    out = {}

    def run(label, fn):
        return run_batch(label, fn, wgl, wgl_dedup,
                         carry_to_numpy)

    dense_rs, out["dense"], dense_carries = run(
        "hazelcast (dense)", lambda: wgl.analysis_gpu_batch(reg, hz, **kw))
    check_batch("hazelcast", dense_rs, out["dense"], HAZELCAST_BAD, True)
    kv = kv_history(independent, hz)

    def independent_check():
        res = independent.checker(linearizable(reg, **kw)).check({}, kv, {})
        if res["valid?"] is not False \
                or sorted(res["failures"]) != sorted(HAZELCAST_BAD):
            raise AssertionError(f"independent: {res['valid?']} "
                                 f"{res['failures']}")
        return [res["results"][k] for k in range(len(hz))]

    ind, out["independent"], _c = run(
        "hazelcast through independent.checker", independent_check)
    check_batch("independent", ind, out["independent"], HAZELCAST_BAD, True)
    for i, (a, b) in enumerate(zip(dense_rs, ind)):
        for key in ("valid?", "max-frontier", "dedup", "batch-walk"):
            if a.get(key) != b.get(key):
                raise AssertionError(f"independent key {i}: {key} "
                                     f"{b.get(key)} != {a.get(key)}")
        if a["valid?"] is False:
            # the op-index of the key-sharded history names the same op
            x, y = kv[b["op-index"]], hz[i].ops[a["op-index"]]
            if (x["time"], x["f"], x["value"]) != \
                    (y["time"], y["f"], independent.ktuple(i, y["value"])):
                raise AssertionError(f"independent key {i}: op {x} != {y}")
    sort_rs, out["sort"], sort_carries = run(
        "counter (sort, hash dedup)",
        lambda: wgl.analysis_gpu_batch(counter, cnt, **kw))
    check_batch("counter", sort_rs, out["sort"], sorted(COUNTER_BAD), False)

    # the ladder on the card: an injected OOM at the first chunk dispatch
    # splits the group walking then (the cheapest dense group) in halves
    os.environ[platform.FAULT_INJECT_ENV] = "oom@batch:1"
    platform.reset_fault_injection()
    try:
        oom_rs, out["oom"], _c = run(
            "hazelcast under oom@batch:1",
            lambda: wgl.analysis_gpu_batch(reg, hz, **kw))
    finally:
        del os.environ[platform.FAULT_INJECT_ENV]
        platform.reset_fault_injection()
    first = min(g[3] for g in out["dense"]["groups"])   # smallest P
    split = [i for i, r in enumerate(oom_rs) if r.get("recovered")]
    want = [i for i, r in enumerate(dense_rs)
            if r["batch-walk"]["group"][3] == first]
    if [r["valid?"] for r in oom_rs] != out["dense"]["verdicts"] \
            or split != want or any(
                oom_rs[i]["recovered"] != {"faults": ["oom"], "retries": 1,
                                           "split": True} for i in split) \
            or any(r.get("degraded") for r in oom_rs):
        raise AssertionError(f"injected OOM: verdicts or stamps differ "
                             f"(split keys {split}, want {want})")
    out["oom"]["split_keys"] = len(split)
    log(f"injected OOM: the same {len(oom_rs)} verdicts; the {len(split)} "
        f"keys of the P={first} group walking at the fault carry "
        f"recovered {oom_rs[split[0]]['recovered']}")
    for label, rs in (("hazelcast", dense_rs), ("independent", ind),
                      ("counter", sort_rs)):
        no_stamps(label, rs)

    # the CPU path: verdicts, counts and each walk's final carry
    t0 = time.perf_counter()
    for label, kind, g_rs, g_carries in (
            ("hazelcast", "dense", dense_rs, dense_carries),
            ("counter", "sort", sort_rs, sort_carries)):
        c_rs, c_carries, cpu_s, c_eager = cpu_batches[kind].result()
        g_k3 = out[kind]["walk_reads"]["k3"]
        for i, (a, b) in enumerate(zip(g_rs, c_rs)):
            a, b = dict(a), dict(b)
            if kind == "dense":
                # K3 reads the host once a window, the CPU path's eager
                # walk at every round: every other read and walk count
                # is equal
                a["batch-walk"], b["batch-walk"] = (
                    dict(a["batch-walk"]), dict(b["batch-walk"]))
                ga, gb = (a["batch-walk"].pop("host-syncs"),
                          b["batch-walk"].pop("host-syncs"))
                shape = ",".join(map(str, a["batch-walk"]["group"][1:]))
                same_syncs_but_walks(f"{label} key {i}", ga,
                                     g_k3.get(shape, 0), gb,
                                     c_eager.get(shape, 0))
            for key in BATCH_AGREE_KEYS:
                if a.get(key) != b.get(key):
                    raise AssertionError(f"{label} key {i}: {key} gpu "
                                         f"{a.get(key)} != cpu {b.get(key)}")
        same_carries(label, g_carries, c_carries)
        out[f"{label}_cpu_s"] = cpu_s
        log(f"{label} batch: GPU and CPU agree on every key (verdict, "
            f"op-index, max-frontier, dedup, walk counts; host syncs but "
            f"for the walks' own) and on the final "
            f"batched carry of each of {len(g_carries)} group walks; CPU "
            f"path {cpu_s:.3f} s in a worker process")
    out["cpu_agreement_wait_s"] = time.perf_counter() - t0

    # where a batched walk's time goes: its largest group's first steps
    out["profiles"] = {}
    for label, model, hists in (("hazelcast", reg, hz),
                                ("counter", counter, cnt)):
        walk, keys = batch_prefix_walk(wgl, model, hists, dev)
        pr = profile_walk(walk, BATCH_PROFILE_STEPS)
        pr["keys"] = keys
        out["profiles"][label] = pr
        log(f"profile {label} batch, largest group ({keys} keys), first "
            f"{BATCH_PROFILE_STEPS} lockstep steps: wall "
            f"{pr['wall_s']:.4f} s, device busy {pr['device_busy_s']:.4f} s "
            f"({100 * pr['busy_share']:.2f}%), {pr['kernel_launches']} "
            f"kernel launches ({pr['kernel_launches'] / BATCH_PROFILE_STEPS:.1f}"
            f" per step); top {pr['top']}")
    return out


def batch_prefix_walk(wgl, model, hists, device, eager=False):
    """A function walking the first n lockstep steps of the batch's
    largest dispatch group, as analysis_gpu_batch's walk does (or with
    the eager walk, K3's plain version, where `eager`), and the group's
    key count."""
    pre = [wgl.encode_ops_for_model(model, h) for h in hists]
    srange = wgl._state_range(model.device_model, model, pre)
    dense, sort_idx = wgl._dispatch_groups(
        srange, [wgl.required_slots(o) for o in pre], "auto",
        n_events=max(wgl.event_count(o) for o in pre))
    d, idx = max(list(dense.values()) + [(None, sort_idx)],
                 key=lambda g: len(g[1]))
    slots = d[2] if d is not None else BATCH_SLOTS
    k = wgl._batch_kernel(model.device_model, d, srange, slots, 1024, device)
    x, ns = wgl._stack_steps([wgl.build_steps(pre[i], slots) for i in idx],
                             wgl._bucket(len(idx), lo=1))
    xs = wgl.stage_steps(x, device)
    init = [model.device_state()] * len(ns)
    walk = k.run_range_batch_eager if eager else k.check_chunk_batch
    return (lambda n: walk(xs, np.minimum(ns, n), k.init_carry_batch(init)),
            len(idx))


def prefix_walk(wgl, model, hist, device, eager=False, **kw):
    """A function walking the first n merged steps of `hist` on the
    engine `plan` picks (the sort family at frontier F), as
    analysis_gpu's walk does (or, on the dense engine where `eager`, with
    the eager walk, K3's plain version)."""
    pl = wgl.plan(model, hist, **kw)
    k = pl.kernel(device, kw.get("frontier", 256))
    steps = wgl.build_steps(pl.ops, pl.slots)
    xs = wgl.stage_steps(steps.x, device)
    init = model.device_state()
    walk = k.run_range_eager if eager else k.check_chunk
    return lambda n: walk(xs, min(n, steps.n), k.init_carry(init))


def profile_walk(walk, n) -> dict:
    """Where one walk's time goes: its wall time unprofiled, and the
    device time of every kernel in a torch.profiler trace of a second
    run (kernel durations are device-side, so the profiler's host
    overhead does not inflate them). Kernels run on one stream, so their
    sum is the device's busy time. The durations are summed from the
    trace's raw events: `key_averages()` builds an event tree that costs
    minutes for the sort walk's million events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walk(n)                  # warm: allocator and library load
    torch.cuda.synchronize()
    t = time.perf_counter()
    walk(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        walk(n)
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0, 0])   # count, ns
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = by_name[e.name()]
            row[0] += 1
            row[1] += e.duration_ns()
    busy_s = sum(ns for _c, ns in by_name.values()) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    k3 = [v for name, v in by_name.items() if "dense_walk" in name]
    return {"wall_s": wall, "device_busy_s": busy_s,
            "busy_share": busy_s / wall,
            "kernel_launches": sum(c for c, _ns in by_name.values()),
            "k3_launches": sum(c for c, _ns in k3),
            "k3_ms": sum(ns for _c, ns in k3) / 1e6,
            "top": [(name[:60], c, ns / 1e6) for name, (c, ns) in top]}


def k3_bound(S, P, keys, launches, steps, completions,
             pair_rounds) -> tuple[float, str]:
    """The least time an H100 could take for a K3 walk on these inputs,
    and what bounds it: the larger of bytes over the HBM rate and
    operations over the fp32 rate (the data sheet gives no INT32 rate; an
    SM issues no more INT32 than fp32 operations a clock).

    Bytes, each input read once and each output written once: at each
    launch every key's carry in and out (table S x 2^P bytes, e, att,
    count and max_count, three int32 slot words and an occupancy byte a
    slot) and its slots' next-state rows (int16 P x S), and at each step
    walked its row (5 int32) and next-state row (int16 S). The table
    stays on chip between passes, so its passes are no bytes here. Left
    out, which keeps this a floor: the per-step round maxima (4 bytes a
    window step) and the launch's scalar sums.

    Operations, 32-bit words of four cells each: a round ORs half a row
    into its row for each listed (source state, slot) pair, so the walk's
    pair rounds (K3 counts them: `wgl_walk.PAIR_ROUNDS`) times 2^P / 8
    ORs; each step's count pass a popcount a word, and each completion a
    gather a word. For a batch, `steps`, `completions` and `pair_rounds`
    sum over the keys."""
    C = 1 << P
    carry = 2 * (S * C + 16 + 13 * P) + 2 * P * S
    nbytes = launches * keys * carry + steps * (20 + 2 * S)
    ops = pair_rounds * C / 8 + (steps + completions) * S * C / 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def walk_pair(k3, ke, label, walk3, walke, carry_to_numpy) -> dict:
    """One walk with K3 (`walk3(k3)`) and with the eager walk
    (`walke(ke)`, K3's plain version) on the card, K3 first and last:
    the carries element for element and the rounds equal, K3's host
    syncs one per call and one per launch, each side's wall (K3 the
    later of its two), host syncs and launches, and K3's pair rounds."""
    from jepsen_tpu_torch.checker import wgl_walk
    ws = walk_syncs()

    def timed(fn, k):
        r0, s0, l0, p0 = (k.rounds, k.syncs, wgl_walk.LAUNCHES,
                          wgl_walk.PAIR_ROUNDS)
        snap = ws.snap()
        torch.cuda.synchronize()
        t = time.perf_counter()
        c = fn(k)
        torch.cuda.synchronize()
        return (time.perf_counter() - t, carry_to_numpy(c), k.rounds - r0,
                k.syncs - s0, wgl_walk.LAUNCHES - l0, ws.since(snap)["calls"],
                wgl_walk.PAIR_ROUNDS - p0)

    timed(walk3, k3)
    e = timed(walke, ke)
    g = timed(walk3, k3)
    err = max((int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
               if a.size else 0) for a, b in zip(g[1], e[1]))
    if err or g[2] != e[2] or any(
            a.dtype != b.dtype or a.shape != b.shape
            for a, b in zip(g[1], e[1])):
        raise AssertionError(f"K3 {label}: carry differs by {err}, rounds "
                             f"{g[2]} against the eager walk's {e[2]}")
    if g[3] != g[5] + g[4] or not g[3] < e[3]:
        raise AssertionError(f"K3 {label}: {g[3]} host syncs for {g[5]} "
                             f"calls and {g[4]} launches (the eager walk "
                             f"{e[3]})")
    return {"k3_wall_s": g[0], "eager_wall_s": e[0], "rounds": g[2],
            "k3_syncs": g[3], "eager_syncs": e[3], "k3_launches": g[4],
            "k3_calls": g[5], "pair_rounds": g[6], "max_abs_err": err,
            "carry": g[1]}


def dense_groups(wgl, model, hists, device):
    """The dense dispatch groups of a batch as analysis_gpu_batch forms
    them: (P, a kernel factory, staged (B, T, 5) steps, stops, initial
    states) each."""
    pre = [wgl.encode_ops_for_model(model, h) for h in hists]
    srange = wgl._state_range(model.device_model, model, pre)
    dense, _sort = wgl._dispatch_groups(
        srange, [wgl.required_slots(o) for o in pre], "auto",
        n_events=max(wgl.event_count(o) for o in pre))
    out = []
    for P, (d, idx) in sorted(dense.items()):
        x, ns = wgl._stack_steps([wgl.build_steps(pre[i], d[2]) for i in idx],
                                 wgl._bucket(len(idx), lo=1))
        out.append((P, lambda d=d: wgl.DenseKernel(model.device_model, *d,
                                                   device),
                    wgl.stage_steps(x, device), ns,
                    [model.device_state()] * len(ns)))
    return out


def stream_chunks(wgl, streaming, model, hist, device, n_chunks) -> tuple:
    """The first n_chunks chunks a dense stream (STREAM_DENSE) hands its
    engine: (kernel shape, [(step matrix, n, carry before) ...]), as the
    stream staged them, read by wrapping the engine's check_stream_chunk
    while the history is fed."""
    seen = []
    real = wgl.DenseKernel.check_stream_chunk

    def record(k, xs, n, carry):
        seen.append(((k.s_lo, k.S, k.P), xs.host.copy(), n,
                     tuple(t.clone() for t in carry)))
        return real(k, xs, n, carry)

    wgl.DenseKernel.check_stream_chunk = record
    try:
        s = streaming.WglStream(model, device=device, **STREAM_DENSE)
        for op in hist.ops:
            s.feed(op)
            if len(seen) >= n_chunks:
                break
    finally:
        wgl.DenseKernel.check_stream_chunk = real
    shapes = {c[0] for c in seen}
    if len(seen) < n_chunks or len(shapes) != 1:
        raise AssertionError(f"dense stream: {len(seen)} chunks, shapes "
                             f"{shapes}")
    return seen[0][0], [c[1:] for c in seen]


def phase_k3(dev, models, synth, wgl, streaming, carry_to_numpy,
             head) -> dict:
    """Phase 4b: K3 (the dense step walk) against the eager walk, its
    plain version, on the card: the headline, the forced-dense
    adversarial and at-cap histories, the four dense groups of the
    hazelcast batch, the dense stream's first three chunks and a
    rabbitmq-shaped mutex, each walked both ways with its carry equal
    element for element and its rounds equal, each wall timed both ways
    with host syncs and launches; torch.profiler traces of the headline
    and of the hazelcast batch's largest group, both ways on the profile
    prefix and K3 over the whole walk, for the card's busy share."""
    reg = models.cas_register()
    out = {"walks": {}, "profiles": {}}

    def record(label, row, S, P, steps, completions):
        bound_ms, bound_by = k3_bound(
            S, P, row.get("keys", 1), row["k3_launches"], steps,
            completions, row["pair_rounds"])
        row.update(S=S, P=P, steps=steps, completions=completions,
                   launches_per_step=row["k3_launches"] / max(steps, 1),
                   bound_ms=bound_ms, bound_by=bound_by)
        row.pop("carry")
        out["walks"][label] = row
        log(f"K3 {label} (S={S}, P={P}, {steps} steps): K3 "
            f"{row['k3_wall_s']:.4f} s, {row['k3_syncs']} host syncs, "
            f"{row['k3_launches']} launches "
            f"({row['launches_per_step']:.5f} a step); eager "
            f"{row['eager_wall_s']:.4f} s, {row['eager_syncs']} host "
            f"syncs; {row['rounds']} rounds both ways; carry equal; bound "
            f"{row['bound_ms']:.6f} ms by {row['bound_by']}; "
            f"{row['pair_rounds']} pair rounds")

    def done_steps(x, e_start, e_end):
        """Steps walked, and those with a completion, between two e's."""
        x = x.reshape(-1, x.shape[-2], x.shape[-1])
        e_start = np.broadcast_to(e_start, (x.shape[0],))
        e_end = np.broadcast_to(e_end, (x.shape[0],))
        comp = sum(int((x[b, e_start[b]:e_end[b], 0] != 0).sum())
                   for b in range(x.shape[0]))
        return int((e_end - e_start).sum()), comp

    # one key: the main path's dense histories and a rabbitmq-shaped mutex
    adv = synth.adversarial_register_history(**ADVERSARIAL)
    singles = [("headline", reg, head, {}),
               ("adversarial-dense", reg, adv, {"engine": "dense"}),
               ("at-cap-dense", reg, synth.adversarial_register_history(
                   **AT_CAP), {"engine": "dense"}),
               ("rabbitmq-mutex", models.mutex(),
                mutex_history(K3_MUTEX_OPS), {})]
    for label, model, hist, kw in singles:
        pl = wgl.plan(model, hist, **kw)
        _lo, S, P = pl.decision.dense
        steps = wgl.build_steps(pl.ops, pl.slots)
        xs = wgl.stage_steps(steps.x, dev)
        init = model.device_state()
        row = walk_pair(
            pl.kernel(dev, 256), pl.kernel(dev, 256), label,
            lambda k: k.check_chunk(xs, steps.n, k.init_carry(init)),
            lambda k: k.run_range_eager(xs, steps.n, k.init_carry(init)),
            carry_to_numpy)
        record(label, row, S, P, *done_steps(steps.x, 0, int(row["carry"][0])))
    if out["walks"]["rabbitmq-mutex"]["S"] != 4 \
            or out["walks"]["rabbitmq-mutex"]["P"] != 3:
        raise AssertionError(f"mutex: {out['walks']['rabbitmq-mutex']}")

    # the hazelcast batch's four dense groups, batched
    (_reg, hz), _ = batch_histories(models, synth)
    for P, make, xs, ns, init in dense_groups(wgl, reg, hz, dev):
        k3 = make()
        row = walk_pair(
            k3, make(), f"hazelcast P={P}",
            lambda k: k.check_chunk_batch(xs, ns, k.init_carry_batch(init)),
            lambda k: k.run_range_batch_eager(xs, ns,
                                              k.init_carry_batch(init)),
            carry_to_numpy)
        row["keys"] = len(ns)
        record(f"hazelcast P={P} ({len(ns)} rows)", row, k3.S, P,
               *done_steps(xs.host, 0, row["carry"][0]))

    # the dense stream's first three chunks, e rebased per chunk
    (s_lo, S, P), chunks = stream_chunks(wgl, streaming, reg, adv, dev,
                                         K3_STREAM_CHUNKS)

    def stream_walk(k, eager):
        carry = chunks[0][2]
        for x, n, _before in chunks:
            xs = wgl.stage_steps(x, dev)
            if eager:
                o = k.run_range_eager(xs, n, (k._i32(0),) + tuple(carry[1:]))
                carry = (o[0] + carry[0],) + tuple(o[1:])
            else:
                carry = k.check_stream_chunk(xs, n, carry)
        return carry

    def make():
        return wgl.DenseKernel(reg.device_model, s_lo, S, P, dev)

    row = walk_pair(make(), make(), "dense stream",
                    lambda k: stream_walk(k, False),
                    lambda k: stream_walk(k, True), carry_to_numpy)
    steps = sum(n for _x, n, _c in chunks)
    comp = sum(int((x[:n, 0] != 0).sum()) for x, n, _c in chunks)
    record(f"dense stream, first {len(chunks)} chunks", row, S, P, steps,
           comp)

    # where the time goes, both ways
    for label, walk3, walke, n_prefix, full in (
            ("headline", prefix_walk(wgl, reg, head, dev),
             prefix_walk(wgl, reg, head, dev, eager=True),
             PROFILE_WALK_STEPS, 10 ** 9),
            ("hazelcast largest group",
             batch_prefix_walk(wgl, reg, hz, dev)[0],
             batch_prefix_walk(wgl, reg, hz, dev, eager=True)[0],
             BATCH_PROFILE_STEPS, 10 ** 9)):
        prof = {"eager_prefix": profile_walk(walke, n_prefix),
                "k3_prefix": profile_walk(walk3, n_prefix),
                "k3_full": profile_walk(walk3, full)}
        out["profiles"][label] = prof
        for how, pr in prof.items():
            steps = n_prefix if how != "k3_full" else None
            log(f"K3 profile {label}, {how} ({steps or 'all'} steps): wall "
                f"{pr['wall_s']:.4f} s, device busy "
                f"{pr['device_busy_s']:.4f} s "
                f"({100 * pr['busy_share']:.2f}%), "
                f"{pr['kernel_launches']} kernel launches, K3 "
                f"{pr['k3_launches']} launches in {pr['k3_ms']:.3f} ms; "
                f"top {pr['top'][:3]}")
    return out


def final_carry(wgl, carry_to_numpy, model, hist, device, **kw):
    """The picked engine's carry after the whole merged stream."""
    pl = wgl.plan(model, hist, **kw)
    k = pl.kernel(device, kw.get("frontier", 256))
    steps = wgl.build_steps(pl.ops, pl.slots)
    carry = k.check_chunk(wgl.stage_steps(steps.x, device), steps.n,
                          k.init_carry(model.device_state()))
    return carry_to_numpy(carry)


def agreement_runs(models, synth, head=None):
    """(label, model, history, checker options) held against the CPU
    path after the main path: the headline at full size (its CPU result
    also stands for the tier phase's escalated check; `head` when the
    caller has it already); the others on 1,000-op histories of the same
    generators (the adversarial one under the sort engine on 2,000), the
    forced-dense adversarial one on 700 ops (its plain closure rounds at
    2^14 columns set the CPU path's pace; the front-loaded crashed
    writes keep it at P = 14)."""
    reg = models.cas_register()
    head = head or synth.register_history(**HEADLINE)
    head_small = synth.register_history(**dict(HEADLINE, n_ops=1_000))
    sort_small = dict(engine="sort", frontier=1024, max_frontier=1024)
    return [
        ("headline", reg, head, {}),
        ("corrupted-1k", reg,
         synth.corrupt(head_small, value=HEADLINE["values"]), {}),
        ("adversarial-700-dense", reg, synth.adversarial_register_history(
            **dict(ADVERSARIAL, n_ops=700)), {"engine": "dense"}),
        ("phantom-1k", reg, synth.corrupt(head_small), {}),
        ("counter-1k", models.counter(),
         synth.counter_history(**dict(COUNTER, n_ops=1_000)), {}),
        ("adversarial-2k-sort", reg, synth.adversarial_register_history(
            **dict(ADVERSARIAL, n_ops=2_000)), sort_small)]


def cpu_agreement() -> dict:
    """The agreement runs on the CPU path, in a worker process: label ->
    (result, final carry, seconds of the check, host reads of the check's
    eager dense walks)."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.carry import carry_to_numpy
    from jepsen_tpu_torch.checker import synth, wgl
    from jepsen_tpu_torch.checker.linear import linearizable
    ws = walk_syncs()
    out = {}
    for label, model, hist, kw in agreement_runs(models, synth):
        t, snap = time.perf_counter(), ws.snap()
        c = linearizable(model, device="cpu", **kw).check({}, hist, {})
        cpu_s = time.perf_counter() - t
        eager = sum(ws.since(snap)["eager"].values())
        ckw = {k: v for k, v in kw.items() if k != "max_frontier"}
        out[label] = (c, final_carry(wgl, carry_to_numpy, model, hist,
                                     "cpu", **ckw), cpu_s, eager)
    return out


def main_path_runs(models, synth):
    """(label, model, history, checker options, expectation) of the main
    path. The expectation holds the verdicts allowed, the analyzer, the
    dedup routes allowed and, for the dense runs, the table's P."""
    reg, counter = models.cas_register(), models.counter()
    head = synth.register_history(**HEADLINE)
    adv = synth.adversarial_register_history(**ADVERSARIAL)
    at_cap = synth.adversarial_register_history(**AT_CAP)
    dense, sort = "gpu-wgl-dense", "gpu-wgl"
    budget = dict(chunk_entries=BUDGET_CHUNK)
    return [
        ("headline", reg, head, {}, ((True,), dense, ("dense-table",), 7)),
        ("adversarial-dense", reg, adv, {"engine": "dense"},
         ((True,), dense, ("dense-table",), 14)),
        ("at-cap-dense", reg, at_cap, {"engine": "dense"},
         ((True,), dense, ("dense-table",), 19)),
        ("corrupted", reg, synth.corrupt(head, value=HEADLINE["values"]),
         {}, ((False,), dense, ("dense-table",), 7)),
        ("phantom", reg, synth.corrupt(head), {},
         ((False,), sort, ("pallas-hash",), None)),
        ("counter", counter, synth.counter_history(**COUNTER), {},
         ((True,), sort, ("pallas-hash",), None)),
        ("at-cap", reg, at_cap, dict(budget, budget_s=AT_CAP_BUDGET_S),
         ((True, "unknown"), sort, ("xla-sort",), None)),
        ("adversarial", reg, adv,
         dict(budget, budget_s=ADVERSARIAL_BUDGET_S),
         ((True, "unknown"), sort, ("pallas-hash", "xla-sort"), None)),
    ]


def check_run(label, r, launches, expect) -> None:
    """Hold one main-path result to its expectation and to the kernels'
    launch counts (`launch_counts` over its run): a dense walk launches
    K3, whose rounds are the result's, and never K1 alone."""
    verdicts, analyzer, dedups, p_want = expect
    k1, k2, k3 = (launches[k] for k in ("k1_launches", "k2_launches",
                                        "k3_launches"))
    dense = analyzer == "gpu-wgl-dense"
    if r["valid?"] not in verdicts or r["analyzer"] != analyzer \
            or r["dedup"] not in dedups:
        raise AssertionError(f"{label}: {r['valid?']} {r['analyzer']} "
                             f"{r['dedup']} {r.get('error')}")
    if r["valid?"] == "unknown" and not (
            "budget" in r["error"] or "overflowed" in r["error"]):
        raise AssertionError(f"{label}: unknown without a budget or an "
                             f"overflow: {r.get('error')}")
    if r["valid?"] is False and not isinstance(r.get("op-index"), int):
        raise AssertionError(f"{label}: no op-index")
    if k2 != r["dedup-launches"] or k1 != 0 or (k3 > 0) != dense \
            or launches["k3_rounds"] != (r["closure-rounds"] if dense
                                         else 0):
        raise AssertionError(f"{label}: K1 {k1} / K2 {k2} / K3 {k3} "
                             f"launches, K3 rounds {launches['k3_rounds']}, "
                             f"for {r['closure-rounds']} rounds and "
                             f"{r['dedup-launches']} hash dedups")
    if p_want is not None:
        if r["dense-shape"][1:] != [8, p_want]:
            raise AssertionError(f"{label}: shape {r['dense-shape']}")
    elif r["dedup"] == "pallas-hash" and k2 <= 0:
        raise AssertionError(f"{label}: no K2 launch on the hash route")


def elle_bucket(e, b, rng, density=0.4):
    """(ww, wr, rw) float32 0/1 stacks, each entry set with probability
    density / e, no self-loops: mostly sparse blocks, some cyclic."""
    mats = []
    for _ in range(3):
        m = (rng.random((b, e, e)) < density / e).astype(np.float32)
        m[:, np.arange(e), np.arange(e)] = 0.0
        mats.append(m)
    return tuple(mats)


def elle_bound(kernels, e, b) -> dict:
    """The least time the card could take for one classifier call on a
    (b, e, e) bucket: the larger of its products' operations over the
    float32 rate outside the tensor cores (the products run in float32,
    TF32 being off by default) and its bytes (three float32 stacks read
    once; four bool flags and an int64 residue per block written) over
    HBM bandwidth. A block takes 3 * ceil(log2 e) squarings and three
    more products, 2 e^3 operations each; the residues and
    elementwise work are O(e^2) a product and left out."""
    products = 3 * kernels._steps(e) + 3
    ops = b * products * 2 * e ** 3
    nbytes = 3 * b * e * e * 4 + 12 * b
    t_o, t_b = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_o, t_b) * 1e3,
                bound_by="operations" if t_o >= t_b else "bytes",
                products_per_block=products, ops=ops, bytes=nbytes)


def elle_time(kernels, stacks, dev, iters) -> tuple[float, float]:
    """Card time of one classifier call on a bucket by CUDA events, and
    the largest residue of that call (0, or the products were wrong)."""
    e = stacks[0].shape[-1]
    args = [torch.from_numpy(x).to(dev) for x in stacks]
    steps = kernels._steps(e)
    *_flags, res = kernels._flags_batch(*args, steps)
    worst = int(res.abs().max().item())
    ms = time_ms(lambda: kernels._flags_batch(*args, steps), iters,
                 warmup=1)
    return ms, worst


def elle_rings(n) -> tuple[int, dict, list]:
    """Three disjoint n-node rings, their edges, and the per-block flags
    their construction gives: a pure ww ring (G0, and so G1c), a ring
    with one rw edge (G-single), a ring with two (G2-item)."""
    edges = {}
    for r, rw_at in enumerate(((), (n // 3,), (n // 4, 3 * n // 4))):
        for k in range(n):
            edges[(r * n + k, r * n + (k + 1) % n)] = \
                {"rw"} if k in rw_at else {"ww"}
    want = [(True, True, False, False), (False, False, True, False),
            (False, False, False, True)]
    return 3 * n, edges, want


def same_elle(a, b, label) -> None:
    """Exact equality of two analyze_edges results (numpy arrays by
    dtype and value)."""
    if a.keys() != b.keys():
        raise AssertionError(f"{label}: keys differ")
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            ok = (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                  and x.dtype == y.dtype and np.array_equal(x, y))
        else:
            ok = x == y
        if not ok:
            raise AssertionError(f"{label}: {k} differs")


class ElleRecorder:
    """Wraps `_classify_batches` to keep each call's buckets and flags
    (the wrapped call still counts its launches), and both it and the
    host's `certificates` to keep each call's seconds (the classifier's
    flags come back to the host, so its calls end synchronised)."""

    def __init__(self, kernels):
        self.kernels, self.real = kernels, kernels._classify_batches
        self.real_certs = kernels.certificates
        self.calls, self.seconds, self.cert_seconds = [], [], []

    def __enter__(self):
        def record(buckets, **kw):
            t = time.perf_counter()
            flags = self.real(buckets, **kw)
            self.seconds.append(time.perf_counter() - t)
            self.calls.append((buckets, flags))
            return flags

        def certs(*a, **kw):
            t = time.perf_counter()
            try:
                return self.real_certs(*a, **kw)
            finally:
                self.cert_seconds.append(time.perf_counter() - t)

        self.kernels._classify_batches = record
        self.kernels.certificates = certs
        return self

    def __exit__(self, *exc):
        self.kernels._classify_batches = self.real
        self.kernels.certificates = self.real_certs


def phase_elle_classifier(dev, kernels) -> list:
    """Step 1: random buckets on the card against the CPU path and the
    numpy mirror, flags identical and residue 0, timed."""
    rng = np.random.default_rng(SEED + 8)
    rows = []
    for e, b in ELLE_BUCKETS:
        buckets = {e: elle_bucket(e, b, rng)}
        before = kernels.LAUNCHES
        got = kernels._classify_batches(buckets, device=dev)[e]
        if kernels.LAUNCHES != before + 1:
            raise AssertionError(f"elle bucket e={e}: a retry happened")
        t = time.perf_counter()
        cpu = kernels._classify_batches(buckets, device="cpu")[e]
        cpu_s = time.perf_counter() - t
        mirror = kernels._classify_batches_host(buckets)[e]
        for name, g, c, m in zip(ELLE_FLAGS, got, cpu, mirror):
            if not (np.array_equal(g, c) and np.array_equal(g, m)):
                raise AssertionError(f"elle bucket e={e} B={b}: {name} "
                                     f"differs (cuda {g}, cpu {c}, "
                                     f"mirror {m})")
        ms, worst = elle_time(kernels, buckets[e], dev, 20)
        if worst:
            raise AssertionError(f"elle bucket e={e}: residue {worst}")
        row = dict(e=e, B=b, ms=ms, cpu_s=cpu_s, residue=worst,
                   flags_set=[int(f.sum()) for f in got],
                   **elle_bound(kernels, e, b))
        rows.append(row)
        log(f"elle classifier e={e} B={b}: flags identical on CUDA, the "
            f"CPU path and the numpy mirror (set per flag "
            f"{row['flags_set']}), residue 0; card {ms:.6f} ms a call, "
            f"bound {row['bound_ms']:.6f} ms by {row['bound_by']}; CPU "
            f"path {cpu_s:.3f} s")
    return rows


def phase_elle(dev, synth, kernels, list_append, wr, platform) -> dict:
    """Steps 2-6 of the Elle phase (step 1: phase_elle_classifier)."""
    out = {"buckets": phase_elle_classifier(dev, kernels)}

    # 2. the north-star list-append history: valid, no classifier call
    t = time.perf_counter()
    eh = synth.append_history(ELLE_APPEND_TXNS, seed=SEED)
    gen_s = time.perf_counter() - t
    kernels.LAUNCHES = 0
    t = time.perf_counter()
    r = list_append.check(eh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if r["valid?"] is not True or r["txn-count"] != ELLE_APPEND_TXNS \
            or kernels.LAUNCHES != 0:
        raise AssertionError(f"append 100k: {r['valid?']} "
                             f"{r['anomaly-types']}, {kernels.LAUNCHES} "
                             f"classifier calls")
    out["append_valid"] = dict(wall_s=wall, generate_s=gen_s, launches=0)
    log(f"elle list-append {ELLE_APPEND_TXNS} txns (seed {SEED}): valid, "
        f"0 classifier calls, wall {wall:.3f} s (history made in "
        f"{gen_s:.3f} s)")

    # 3. the same history with 64 injected G1c cycles, against the CPU
    bad = synth.inject_append_cycles(eh, ELLE_G1C, "G1c")
    kernels.LAUNCHES = 0
    with ElleRecorder(kernels) as rec:
        t = time.perf_counter()
        g = list_append.check(bad)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    shapes = {e: list(s[0].shape) for bk, _f in rec.calls
              for e, s in bk.items()}
    if g["valid?"] is not False or "G1c" not in g["anomaly-types"] \
            or kernels.LAUNCHES != 1:
        raise AssertionError(f"append + G1c: {g['valid?']} "
                             f"{g['anomaly-types']}, {kernels.LAUNCHES} "
                             f"classifier calls")
    t = time.perf_counter()
    c = list_append.check(bad, device="cpu")
    cpu_s = time.perf_counter() - t
    if c != g:
        raise AssertionError("append + G1c: the CPU path's result differs")
    out["append_g1c"] = dict(wall_s=wall, cpu_s=cpu_s, launches=1,
                             buckets=shapes,
                             anomaly_types=g["anomaly-types"])
    log(f"elle list-append + {ELLE_G1C} G1c: invalid "
        f"{g['anomaly-types']}, 1 classifier call on bucket(s) [B, e, e] "
        f"{shapes}, wall {wall:.3f} s; the CPU path's result dict is equal "
        f"(certificates included, {cpu_s:.3f} s)")

    # 4. rw-register, plain and with the realtime and process graphs
    wh = synth.wr_history(ELLE_WR_TXNS, seed=SEED)
    out["wr"] = {}
    for label, graphs in (("plain", ()), ("graphs", ("realtime",
                                                      "process"))):
        kernels.LAUNCHES = 0
        t = time.perf_counter()
        r = wr.check(wh, additional_graphs=graphs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if r["valid?"] is not True or r["txn-count"] != ELLE_WR_TXNS:
            raise AssertionError(f"wr {label}: {r['valid?']} "
                                 f"{r['anomaly-types']}")
        out["wr"][label] = dict(wall_s=wall, launches=kernels.LAUNCHES)
        log(f"elle rw-register {ELLE_WR_TXNS} txns {label} {graphs}: valid, "
            f"{kernels.LAUNCHES} classifier calls, wall {wall:.3f} s")

    # 5. large SCCs: three rings in one bucket, flags by construction
    out["rings"] = {}
    for n in (ELLE_RING, ELLE_RING_SMALL):
        nodes, edges, want = elle_rings(n)
        kernels.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        with ElleRecorder(kernels) as rec:
            t = time.perf_counter()
            res = kernels.analyze_edges(nodes, edges)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        (buckets, flags), = rec.calls
        (e, stacks), = buckets.items()
        labels = res["scc-labels"]
        labs = sorted({int(labels[r * n]) for r in range(3)})
        got = [tuple(bool(f[ix]) for f in flags[e])
               for ix in range(stacks[0].shape[0])]
        by_ring = [got[labs.index(int(labels[r * n]))] for r in range(3)]
        if kernels.LAUNCHES != 1 or by_ring != want \
                or any(any(x) for x in got[3:]) \
                or not all(res[k] for k in ELLE_FLAGS):
            raise AssertionError(f"rings n={n}: flags {got}, "
                                 f"{kernels.LAUNCHES} classifier calls")
        ms, worst = elle_time(kernels, stacks, dev, 3)
        if worst:
            raise AssertionError(f"rings n={n}: residue {worst}")
        row = dict(nodes=n, bucket=list(stacks[0].shape), wall_s=wall,
                   ms=ms, peak_gb=peak_gb, residue=worst,
                   **elle_bound(kernels, e, stacks[0].shape[0]))
        if n == ELLE_RING_SMALL:
            t = time.perf_counter()
            same_elle(res, kernels.analyze_edges(nodes, edges,
                                                 device="cpu"),
                      f"rings n={n}")
            row["cpu_s"] = time.perf_counter() - t
        out["rings"][n] = row
        log(f"elle rings 3 x {n} nodes: bucket [B, e, e] {row['bucket']}, "
            f"per-ring flags (G0, G1c, G-single, G2-item) {by_ring}, "
            f"residue 0; analyze_edges wall {wall:.3f} s, card "
            f"{ms:.3f} ms a classifier call, bound {row['bound_ms']:.3f} ms "
            f"by {row['bound_by']} ({row['ops'] / 1e12:.3f} T operations, "
            f"{row['products_per_block']} products a block), peak "
            f"{peak_gb:.3f} GiB"
            + (f"; equal to the CPU path ({row['cpu_s']:.3f} s)"
               if "cpu_s" in row else ""))

    # 6. an injected OOM on step 3: one retry, the same result
    os.environ[platform.FAULT_INJECT_ENV] = "oom@elle:1"
    platform.reset_fault_injection()
    kernels.LAUNCHES = 0
    try:
        t = time.perf_counter()
        o = list_append.check(bad)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        dispatches = platform._fault_seq.get("elle")
    finally:
        del os.environ[platform.FAULT_INJECT_ENV]
        platform.reset_fault_injection()
    if o != g or kernels.LAUNCHES != 1 or dispatches != 2:
        raise AssertionError(f"injected OOM: result equal {o == g}, "
                             f"{kernels.LAUNCHES} classifier calls, "
                             f"{dispatches} dispatches")
    out["oom"] = dict(wall_s=wall, dispatches=dispatches)
    log(f"elle injected oom@elle:1: recovered after one retry (2 "
        f"dispatches, 1 classifier call), the same result, wall "
        f"{wall:.3f} s")
    log("elle: " + json.dumps(out, default=str))
    # the sharded phase checks the same history over a mesh
    out["g1c_history"], out["g1c_result"] = bad, g
    return out


def stream_run(streaming, model, hist, device, abort=False, snap=None,
               **kw):
    """One stream: feed every op (or, with abort=True, op by op until the
    stream reports a violation), then finish. Returns the stream, its
    result, the ops fed, and the feed and tail (finish) walls, each
    ending in a synchronise when the stream is on the card. With
    snap=n, also the ops fed and the carry on the host when the stream
    had first dispatched n chunks (None when it never did), else
    None."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    s = streaming.WglStream(model, device=device, **kw)
    t = time.perf_counter()
    fed = 0
    shot = None
    for op in hist.ops:
        s.feed(op)
        fed += 1
        if snap is not None and shot is None and s.chunks >= snap:
            shot = (fed, s.chunks, s.carry_host())
        if abort and s.violation:
            break
    sync()
    feed_s = time.perf_counter() - t
    t = time.perf_counter()
    r = s.finish()
    sync()
    return s, r, fed, feed_s, time.perf_counter() - t, shot


def cpu_worker_init() -> None:
    """A worker process of the CPU checks: a share of the host's cores."""
    torch.set_num_threads(CPU_WORKER_THREADS)


def cpu_dense_prefix() -> tuple:
    """Phase 8's dense stream on the CPU path, in a worker process: the
    adversarial history fed until the stream first dispatched
    STREAM_CPU_DENSE_CHUNKS chunks (the snapshot: the ops fed, the
    chunks and the carry then), and finished there, as a stream of that
    prefix is. It needs nothing of the card's run. Returns the result,
    the final carry, the snapshot and the seconds it took."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checker import streaming, synth
    t = time.perf_counter()
    adv = synth.adversarial_register_history(**ADVERSARIAL)
    sc = streaming.WglStream(models.cas_register(), device="cpu",
                             **STREAM_DENSE)
    shot = None
    for fed, op in enumerate(adv.ops, 1):
        sc.feed(op)
        if sc.chunks >= STREAM_CPU_DENSE_CHUNKS:
            shot = (fed, sc.chunks, sc.carry_host())
            break
    rc = sc.finish()
    return rc, sc.carry_host(), shot, time.perf_counter() - t


def cpu_abort_stream() -> tuple:
    """Phase 8's early-abort stream on the CPU path, in a worker process:
    its result, final carry, history ops and the seconds it took."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checker import streaming, synth
    t = time.perf_counter()
    bad = synth.corrupt(synth.register_history(**STREAM_ABORT_HIST), seed=11)
    sc, c, *_ = stream_run(streaming, models.cas_register(), bad, "cpu",
                           abort=True, **STREAM_ABORT)
    return c, sc.carry_host(), len(bad.ops), time.perf_counter() - t


def stream_offline_walk(wgl, carry_to_numpy, model, hist, s, device):
    """The stream's engine (family, F, P, pack and dedup route) walking
    the whole merged history offline in one range: its final carry and
    its wall."""
    ops = wgl.encode_ops_for_model(model, hist)
    steps = wgl.build_steps(ops, s.p)
    if s.engine == "dense":
        lo, S, P = s._dense_shape()
        k = wgl.DenseKernel(model.device_model, lo, S, P, device)
    else:
        k = wgl.SortKernel(model.device_model, s.frontier, s.p, s._pack,
                           wgl.dedup_engine(s.frontier, s.p, s._pack),
                           device)
    t = time.perf_counter()
    carry = k.run_range(wgl.stage_steps(steps.x, device), steps.n,
                        k.init_carry(model.device_state()))
    torch.cuda.synchronize()
    return carry_to_numpy(carry), time.perf_counter() - t


def same_results(label, a, b, skip=STREAM_VOLATILE) -> None:
    for key in sorted(set(a) | set(b)):
        if key not in skip and a.get(key) != b.get(key):
            raise AssertionError(f"{label}: {key} {a.get(key)} != "
                                 f"{b.get(key)}")


def same_carry(label, a, b) -> None:
    if len(a) != len(b):
        raise AssertionError(f"{label}: carries of {len(a)} and {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{label}: carry element {i} differs")


def phase_stream(dev, models, synth, wgl, streaming, screen, linear, wr,
                 platform, carry_to_numpy, cpu_headline, pool,
                 cpu_dense) -> dict:
    """The streaming-and-tier phase: five runs at full size on the card,
    each against the CPU path and (the WGL streams) against the offline
    walk of the same engine, with every kernel's launch count set to 0
    just before each stream and read just after. The dense stream's CPU
    check (`cpu_dense`, a future of `cpu_dense_prefix`) and the abort
    stream's run in worker processes of `pool` beside the card's runs."""
    reg = models.cas_register()
    out = {}

    def card_stream(label, hist, expect, abort=False, walk=None, snap=None,
                    **kw):
        """The stream on the card, its final carry against the offline
        walk of its engine (`walk`: one already made of the same
        history and engine); with snap=n, its carry after its first n
        chunks is kept under out[label]['snapshot']."""
        zero_launches()
        s, r, fed, feed_s, tail_s, shot = stream_run(
            streaming, reg, hist, dev, abort=abort, snap=snap, **kw)
        n = launch_counts()
        k1, k2, k3 = n["k1_launches"], n["k2_launches"], n["k3_launches"]
        if walk is None:
            walk = stream_offline_walk(wgl, carry_to_numpy, reg, hist, s,
                                       dev)
        same_carry(f"{label} vs the offline walk", s.carry_host(), walk[0])
        rec = dict(valid=r["valid?"], op_index=r.get("op-index"),
                   fed=fed, ops=len(hist.ops), feed_s=feed_s,
                   tail_s=tail_s, offline_walk_s=walk[1],
                   chunks=r["chunks"], checkpoints=s.checkpoint_seq,
                   slots=s.p, engine=s.engine, dedup=r["dedup"], **n,
                   closure_rounds=r["closure-rounds"],
                   dedup_launches=r["dedup-launches"],
                   host_syncs=r["host-syncs"],
                   violation_at_op=r.get("violation-at-op"),
                   recovered=r.get("recovered"))
        log(f"stream {label}: valid?={r['valid?']} op-index="
            f"{r.get('op-index')} fed {fed}/{len(hist.ops)} ops, feed "
            f"{feed_s:.3f} s, tail {tail_s:.3f} s, offline walk "
            f"{walk[1]:.3f} s, {r['chunks']} chunks, {s.checkpoint_seq} "
            f"checkpoints, engine {s.engine} P={s.p} dedup {r['dedup']}, "
            f"K3 launches {k3} ({n['k3_rounds']} rounds), K2 launches "
            f"{k2}, host syncs {r['host-syncs']}, recovered "
            f"{r.get('recovered')}; final "
            f"carry equals the offline walk's")
        if r["valid?"] is not expect \
                or s.device.type != torch.device(dev).type \
                or r["device"] != str(s.device):
            raise AssertionError(f"{label}: {r['valid?']} on {r['device']}")
        dense = s.engine == "dense"
        if k1 != 0 or (k3 > 0) != dense or k2 != r["dedup-launches"] \
                or n["k3_rounds"] != (r["closure-rounds"] if dense else 0):
            raise AssertionError(f"{label}: K1 {k1} / K2 {k2} / K3 {k3} "
                                 f"launches, K3 rounds {n['k3_rounds']}, for "
                                 f"{r['closure-rounds']} rounds and "
                                 f"{r['dedup-launches']} hash dedups")
        out[label] = rec
        if shot is not None:
            rec["snapshot"] = shot
        return s, r, walk

    # 1. the dense stream: K3 at (8, 16); the CPU path on the prefix the
    # card's stream had been fed when it dispatched its first chunk(s)
    adv = synth.adversarial_register_history(**ADVERSARIAL)
    s, dense_result, dense_walk = card_stream(
        "dense", adv, True, snap=STREAM_CPU_DENSE_CHUNKS, **STREAM_DENSE)
    if s.p != 16 or out["dense"]["k3_launches"] <= 0 \
            or "snapshot" not in out["dense"]:
        raise AssertionError(f"dense stream: P={s.p}, "
                             f"{out['dense']['k3_launches']} K3 launches, "
                             f"{s.chunks} chunks")
    snap_ops, snap_chunks, snap_carry = out["dense"].pop("snapshot")
    adv_cut = type(adv)(adv.ops[:snap_ops])
    # the CPU path on the prefix runs in a worker process (since before
    # phase 5); its result is held at the phase's end
    s_cut, rc, *_ = stream_run(streaming, reg, adv_cut, dev, **STREAM_DENSE)

    def dense_prefix_agrees():
        rc_cpu, cpu_carry, shot, cpu_s = cpu_dense.result()
        if shot is None or shot[:2] != (snap_ops, snap_chunks):
            raise AssertionError(f"dense stream: the CPU path dispatched "
                                 f"{shot and shot[:2]}, the card "
                                 f"{(snap_ops, snap_chunks)}")
        same_carry("dense: the full-size stream after its first "
                   f"{snap_chunks} chunk(s) vs the CPU path", snap_carry,
                   shot[2])
        same_results("dense prefix card vs CPU", rc, rc_cpu)
        same_carry("dense prefix card vs CPU", s_cut.carry_host(), cpu_carry)
        out["dense"].update(cpu_s=cpu_s, cpu_ops=snap_ops,
                            cpu_chunks=snap_chunks)
        log(f"stream dense: the full-size stream's carry after its first "
            f"{snap_chunks} chunk(s) ({snap_ops} of {len(adv.ops)} history "
            f"ops) equals the CPU path's; finished there, the prefix gives "
            f"the same result and final carry on the card and the CPU "
            f"({cpu_s:.3f} s in a worker process)")

    def stream_prefix(hist, **kw):
        """A function streaming the first n ops of `hist` on the card,
        fed and finished (the profile's walk)."""
        return lambda n: stream_run(streaming, reg,
                                    type(hist)(hist.ops[:n]), dev, **kw)

    out["dense"]["profile"] = pr = profile_walk(
        stream_prefix(adv, **STREAM_DENSE), STREAM_PROFILE_OPS)
    log(f"profile stream dense, first {STREAM_PROFILE_OPS} ops: wall "
        f"{pr['wall_s']:.4f} s, device busy {pr['device_busy_s']:.4f} s "
        f"({100 * pr['busy_share']:.2f}%), {pr['kernel_launches']} kernel "
        f"launches; top {pr['top']}")

    # 2. the sort stream, fed until the violation shows: K2
    plain = synth.register_history(**STREAM_ABORT_HIST)
    bad = synth.corrupt(plain, seed=11)
    bad_at = next(i for i, (a, b) in enumerate(zip(plain.ops, bad.ops))
                  if a != b)
    s, r, _walk = card_stream("sort-abort", bad, False, abort=True,
                              **STREAM_ABORT)
    rec = out["sort-abort"]
    rec["violation_injected_at_op"] = bad_at
    if rec["dedup"] != "pallas-hash" or rec["k2_launches"] <= 0 \
            or not rec["fed"] < len(bad.ops) \
            or not isinstance(rec["op_index"], int):
        raise AssertionError(f"sort-abort: {rec}")
    # the same stream on the CPU path, in a worker process: the same
    # result dict and the same final carry, held at the phase's end
    abort_cpu = pool.submit(cpu_abort_stream)
    abort_result, abort_carry = r, s.carry_host()

    def abort_agrees():
        c, cpu_carry, n_ops, cpu_s = abort_cpu.result()
        out["sort-abort"].update(cpu_s=cpu_s, cpu_ops=n_ops)
        same_results("sort-abort card vs CPU", abort_result, c)
        same_carry("sort-abort card vs CPU", abort_carry, cpu_carry)
        log(f"stream sort-abort: the CPU path agrees on {n_ops} history "
            f"ops, final carry included ({cpu_s:.3f} s in a worker "
            f"process)")
    rec["profile"] = pr = profile_walk(stream_prefix(bad, **STREAM_ABORT),
                                       STREAM_PROFILE_OPS)
    log(f"profile stream sort-abort, first {STREAM_PROFILE_OPS} ops: wall "
        f"{pr['wall_s']:.4f} s, device busy {pr['device_busy_s']:.4f} s "
        f"({100 * pr['busy_share']:.2f}%), {pr['kernel_launches']} kernel "
        f"launches; top {pr['top']}")

    # 3. the dense stream under a device loss at its midpoint chunk
    mid = max(2, dense_result["chunks"] // 2)
    platform.reset_fault_injection()
    os.environ[platform.FAULT_INJECT_ENV] = \
        f"device-lost@stream-chunk:{mid}"
    try:
        s, r, _walk = card_stream("dense-recovery", adv, True,
                                  walk=dense_walk,
                                  **dict(STREAM_DENSE, checkpoint_every=2))
    finally:
        del os.environ[platform.FAULT_INJECT_ENV]
        platform.reset_fault_injection()
    if (r.get("recovered") or {}).get("faults") != ["device-lost"] \
            or r["recovered"]["retries"] != 1:
        raise AssertionError(f"dense-recovery: {r.get('recovered')}")
    out["dense-recovery"]["fault_at_chunk"] = mid
    same_results("dense-recovery vs the unfaulted stream", r, dense_result,
                 skip=STREAM_VOLATILE + ("recovered", "attested",
                                         "closure-rounds"))

    # 4. the rw-register stream
    wh = synth.wr_history(ELLE_WR_TXNS, seed=SEED)
    res = {}
    for where in (dev, "cpu"):
        ws = streaming.WrStream(device=where)
        t = time.perf_counter()
        for op in wh.ops:
            ws.feed(op)
        feed_s = time.perf_counter() - t
        t = time.perf_counter()
        res[str(where)] = (ws.finish(), feed_s, time.perf_counter() - t)
    (gw, feed_s, tail_s), (cw, *_) = res[str(dev)], res["cpu"]
    same_results("wr stream card vs CPU", gw, cw)
    t = time.perf_counter()
    off = wr.check(wh, device=dev)
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t
    for key in ("valid?", "anomaly-types", "anomalies", "txn-count"):
        if gw[key] != off[key]:
            raise AssertionError(f"wr stream: {key} differs from wr.check")
    out["wr"] = dict(valid=gw["valid?"], txns=gw["txn-count"],
                     feed_s=feed_s, tail_s=tail_s, offline_s=off_s)
    log(f"stream wr: valid?={gw['valid?']} {gw['txn-count']} txns, feed "
        f"{feed_s:.3f} s, tail {tail_s:.3f} s, offline wr.check "
        f"{off_s:.3f} s; the CPU path and wr.check agree")

    # 5. the headline at tier 'screen', and the competition race
    head = synth.register_history(**HEADLINE)
    tier = {}
    for sample in (0, 1):
        test = {"tier": "screen", "screen-sample": sample}
        t = time.perf_counter()
        g = linear.linearizable(reg, device=dev).check(test, head, {})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if sample == 0:
            c = linear.linearizable(reg, device="cpu").check(test, head, {})
        else:
            # the escalated full check: the CPU path's headline check
            # (the agreement phase's) with the CPU's screen and pricing
            sc = screen.screen_history(reg, head)
            price = screen.price_escalation(reg, head)
            esc, why = screen.should_escalate(sc, sample=1,
                                              cost=price["cost"])
            c = dict(cpu_headline, tier=1,
                     escalated=screen.escalation_record(sc, why, price))
        same_results(f"tier sample {sample}", g, c,
                     skip=STREAM_VOLATILE + ("attested",))
        tier[sample] = dict(valid=g["valid?"], wall_s=wall,
                            escalated=g.get("escalated"),
                            screened=g.get("screened", False))
        log(f"tier screen, sample {sample}: valid?={g['valid?']} "
            f"escalated={g.get('escalated')} wall {wall:.3f} s; the CPU "
            f"path agrees")
    if tier[0]["escalated"] is not None or tier[1]["escalated"] is None \
            or tier[1]["escalated"]["why"] != "sampled":
        raise AssertionError(f"tier: {tier}")
    t = time.perf_counter()
    race = linear.linearizable(reg, algorithm="competition",
                               device=dev).check(
        {}, head, {})
    torch.cuda.synchronize()
    race_s = time.perf_counter() - t
    winner = race.get("competition-winner")
    # the winner's side alone on the CPU path: the host search, or the
    # CPU path's device search (the agreement phase's headline check)
    t = time.perf_counter()
    if winner == "host":
        alone = linear.analysis_host(reg, head)
        alone_s = time.perf_counter() - t
        skip = ("competition-winner", "duration-ms")
    elif winner == "gpu":
        alone = linear._truncate(dict(cpu_headline))
        alone_s = cpu_headline["duration-ms"] / 1e3
        skip = ("competition-winner", "attested") + STREAM_VOLATILE
    else:
        raise AssertionError(f"race: winner {winner!r}")
    same_results(f"race (won by {winner}) vs its side alone on the CPU",
                 race, alone, skip=skip)
    # the loser is cancelled and the race returns with the winner: the
    # sides share the interpreter's lock, so the winner may run at half
    # its own pace, and no more than that is allowed for
    if race_s > 4 * alone_s + 5.0:
        raise AssertionError(f"race: {race_s:.3f} s against {alone_s:.3f} "
                             f"s for its winner alone")
    out["tier"] = tier
    out["race"] = dict(valid=race["valid?"], wall_s=race_s,
                       winner=winner, winner_alone_s=alone_s,
                       analyzer=race.get("analyzer"))
    log(f"race: valid?={race['valid?']} winner {winner} "
        f"({race.get('analyzer')}) wall {race_s:.3f} s, its side alone on "
        f"the CPU {alone_s:.3f} s; the result equals that side's on every "
        f"key but {', '.join(skip)}")
    no_stamps("streams", [dense_result, abort_result, gw])
    dense_prefix_agrees()
    abort_agrees()
    return out


def service_stream_kw(i: int) -> dict:
    """Stream i's WglStream options, as the service builds it."""
    kw = dict(chunk_entries=SERVICE_CHUNK, checkpoint_every=SERVICE_CKPT)
    if i < SERVICE_STREAMS // 2:
        kw.update(engine="auto", state_range=(-1, 4), concurrency_hint=5)
    else:
        kw.update(engine="sort", state_range=(-1, 10 ** 6), slots=8)
    return kw


def service_spec(service, model, i: int) -> dict:
    """Stream i's targets spec, the wire form of `service_stream_kw`."""
    kw = service_stream_kw(i)
    sp = {"kind": "wgl", "model": service.model_spec(model),
          "chunk-entries": kw["chunk_entries"],
          "checkpoint-every": kw["checkpoint_every"],
          "engine": kw["engine"], "state-range": list(kw["state_range"])}
    if "slots" in kw:
        sp["slots"] = kw["slots"]
    if "concurrency_hint" in kw:
        sp["concurrency-hint"] = kw["concurrency_hint"]
    return {"linear": sp}


def service_history(synth, store, i: int) -> list:
    """Stream i's history ops in the journal's wire form."""
    h = synth.register_history(**SERVICE_HIST, seed=SERVICE_SEED + i)
    if i in SERVICE_BAD:
        cs, value = SERVICE_BAD[i]
        h = synth.corrupt(h, seed=cs, value=value)
    return [json.loads(json.dumps(op, default=store._json_default))
            for op in h.ops]


def solo_stream(streaming, model, ops, i, device) -> tuple:
    """Stream i alone (`streaming.stream_check`'s walk, keeping the
    stream): its result, final carry and wall."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    t = time.perf_counter()
    s = streaming.WglStream(model, device=device, **service_stream_kw(i))
    for op in ops:
        s.feed(op)
    r = s.finish()
    sync()
    return r, s.carry_host(), time.perf_counter() - t


def cpu_service_stream(i: int) -> tuple:
    """Stream i of the service phase on the CPU path, in a worker
    process: the dense streams' first SERVICE_CPU_DENSE_OPS history
    ops, the sort streams' whole history."""
    from jepsen_tpu_torch import models, store
    from jepsen_tpu_torch.checker import streaming, synth
    ops = service_history(synth, store, i)
    if i < SERVICE_STREAMS // 2:
        ops = ops[:SERVICE_CPU_DENSE_OPS]
    return solo_stream(streaming, models.cas_register(), ops, i, "cpu")


def service_run(service, model, dev, hists, idx, profile=False) -> dict:
    """One VerificationService on the card serving streams idx, each fed
    from its own thread through offer / seal / result. Returns the
    results, each stream's feed-to-verdict latency, the wall (ending in
    a synchronise), the final status, and with profile=True the device
    time of every kernel in a torch.profiler trace (CUDA activity only:
    16 threads' host events would swamp the trace)."""
    import threading
    svc = service.VerificationService(device=dev)
    for i in idx:
        svc.admit(f"s{i}", service_spec(service, model, i))
    res, lat = {}, {}

    def feed(i):
        t = time.perf_counter()
        for op in hists[i]:
            svc.offer(f"s{i}", op)
        svc.seal(f"s{i}")
        res[i] = svc.result(f"s{i}", timeout_s=600)
        lat[i] = time.perf_counter() - t

    ths = [threading.Thread(target=feed, args=(i,)) for i in idx]
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    t = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("service: a feeding thread hung")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    out = {"results": res, "lat": lat, "wall": wall, "status": svc.status()}
    svc.stop()
    if prof is not None:
        from torch.autograd import DeviceType
        prof.stop()
        t = time.perf_counter()
        ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
        out["device_busy_s"], out["device_events"] = sum(ns) / 1e9, len(ns)
        out["trace_read_s"] = time.perf_counter() - t
    for i in idx:
        if "linear" not in res.get(i, {}):
            raise AssertionError(f"service stream s{i}: no verdict "
                                 f"({res.get(i)})")
    return out


def phase_service(dev, models, synth, streaming,
                  service, store, telemetry, platform, pool) -> dict:
    """Phase 9: the verification service on the card. Sixteen streams
    (8 dense, K1; 8 packed sort, K2) in one service, each result held
    against the stream alone on the card and on the CPU path (the CPU
    path in worker processes of `pool`); every kernel's launch count set
    to 0 just before the 16-stream run and read just after, each
    stream's own counts adding up to them; throughput at 1, 4 and 16
    streams; the device's busy share of a 16-stream run; the isolation
    run (a device loss on stream 3, an OOM on stream 11); a drain and a
    resume; the socket with two ServiceClients, and /metrics and
    /healthz."""
    import tempfile
    import threading
    import urllib.request
    model = models.cas_register()
    n = SERVICE_STREAMS
    dense = range(n // 2)
    hists = [service_history(synth, store, i) for i in range(n)]
    total_ops = sum(len(h) for h in hists)
    cpu_jobs = {i: pool.submit(cpu_service_stream, i) for i in range(n)}
    out = {"streams": n, "ops": total_ops, "chunk": SERVICE_CHUNK,
           "section_s": {}}
    mark = [time.perf_counter()]

    def section(label):
        now = time.perf_counter()
        out["section_s"][label] = now - mark[0]
        mark[0] = now

    def strip(r, extra=()):
        """The result as the wire carries it (canonical JSON), without
        the timing fields and `extra`."""
        return json.loads(json.dumps(
            {k: v for k, v in r.items()
             if k not in SERVICE_TIMING + tuple(extra)},
            default=store._json_default, sort_keys=True))

    def same(label, a, b, extra=()):
        same_results(label, strip(a, extra), strip(b, extra), skip=())

    # each stream alone on the card (the first runs warm the kernels)
    solo, solo_s = {}, {}
    for i in range(n):
        solo[i], _carry, solo_s[i] = solo_stream(streaming, model, hists[i],
                                                 i, dev)
        want = i not in SERVICE_BAD
        if solo[i]["valid?"] is not want:
            raise AssertionError(f"s{i} alone: valid? {solo[i]['valid?']}")
    section("alone")
    log(f"service: 16 streams alone on the card: "
        f"{sum(solo_s.values()):.3f} s in all (s0 {solo_s[0]:.3f} s, s8 "
        f"{solo_s[8]:.3f} s)")

    # throughput at 1, 4 and 16 streams; the 16-stream run is the main
    # path's: every kernel's count set to 0 just before, read just after
    scaling = {}
    for m in SERVICE_COUNTS:
        idx = ([0] if m == 1 else [0, 1, 8, 9] if m == 4 else list(range(n)))
        if m == n:
            zero_launches()
        run = service_run(service, model, dev, hists, idx)
        if m == n:
            launches = launch_counts()
            clean = run
        ops = sum(len(hists[i]) for i in idx)
        scaling[m] = {"wall_s": run["wall"], "ops": ops,
                      "ops_per_s": ops / run["wall"],
                      "stream_s": {f"s{i}": run["lat"][i] for i in idx}}
        for i in idx:
            same(f"service s{i} ({m} streams) vs alone on the card",
                 run["results"][i]["linear"], solo[i])
        log(f"service: {m} stream(s) {idx}: wall {run['wall']:.3f} s, "
            f"{ops} history ops, {ops / run['wall']:.1f} ops/s; every "
            f"result equals its stream alone on the card")
    out["scaling"] = scaling
    section("1, 4 and 16 streams")
    res = {i: clean["results"][i]["linear"] for i in range(n)}
    k1 = sum(res[i]["closure-rounds"] for i in dense)
    k2 = sum(r["dedup-launches"] for r in res.values())
    for i in range(n):
        r = res[i]
        if i in dense and (r["analyzer"] != "gpu-wgl-dense-streaming"
                           or r["closure-rounds"] <= 0
                           or r["dedup-launches"] != 0):
            raise AssertionError(f"s{i}: not a dense stream on K3: {r}")
        if i not in dense and (r["dedup"] != "pallas-hash"
                               or r["dedup-launches"] <= 0):
            raise AssertionError(f"s{i}: not a hash stream on K2: {r}")
    if (k1, k2) != (launches["k3_rounds"], launches["k2_launches"]) \
            or launches["k1_launches"] != 0 or launches["k3_launches"] <= 0:
        raise AssertionError(f"service: streams count {k1} rounds / K2 "
                             f"{k2}, the kernels {launches}")
    st = clean["status"]
    if any(v["state"] != "verdict" for v in st["streams"].values()) \
            or st["budget"]["capacity"] != st["budget"]["initial"]:
        raise AssertionError(f"service status: {st['budget']} "
                             f"{[v['state'] for v in st['streams'].values()]}")
    out["launches"] = launches
    out["per_stream"] = {f"s{i}": {
        "valid": res[i]["valid?"], "op_index": res[i].get("op-index"),
        "engine": "dense" if i in dense else res[i]["dedup"],
        "chunks": res[i]["chunks"], "k1": res[i]["closure-rounds"]
        if i in dense else 0, "k2": res[i]["dedup-launches"],
        "host_syncs": res[i]["host-syncs"], "alone_s": solo_s[i],
        "served_s": clean["lat"][i]} for i in range(n)}
    out["calibration"] = st["calibration"]
    out["budget"] = st["budget"]
    out["isolation_overhead"] = {
        f"s{i}": clean["lat"][i] / solo_s[i] for i in (0, 8)}
    log(f"service: 16 streams: K3 {launches['k3_launches']} launches "
        f"with {launches['k3_rounds']} rounds (streams 0-7), K2 "
        f"{launches['k2_launches']} (streams 8-15), each "
        f"stream's own counts adding up to them; every stream in verdict, "
        f"budget at its initial capacity; s0 served {clean['lat'][0]:.3f} "
        f"s against {solo_s[0]:.3f} s alone "
        f"({out['isolation_overhead']['s0']:.2f}x), s8 {clean['lat'][8]:.3f}"
        f" s against {solo_s[8]:.3f} s "
        f"({out['isolation_overhead']['s8']:.2f}x); p95 chunk walk "
        f"{st['budget']['p95-chunk-latency-s']} s, p95 wait for the walk "
        f"{st['budget']['p95-walk-wait-s']} s; calibration "
        f"{st['calibration']['coefficients']}")

    # the device's busy share: 16 streams of each history's first
    # SERVICE_PROFILE_OPS ops, once unprofiled and once under the profiler
    heads = [h[:SERVICE_PROFILE_OPS] for h in hists]
    bare = service_run(service, model, dev, heads, list(range(n)))
    prof = service_run(service, model, dev, heads, list(range(n)),
                       profile=True)
    section("profile")
    out["profile"] = {"ops": SERVICE_PROFILE_OPS, "wall_s": bare["wall"],
                      "profiled_wall_s": prof["wall"],
                      "trace_read_s": prof["trace_read_s"],
                      "device_busy_s": prof["device_busy_s"],
                      "busy_share": prof["device_busy_s"] / bare["wall"],
                      "device_events": prof["device_events"]}
    log(f"service profile, 16 streams of {SERVICE_PROFILE_OPS} ops: device "
        f"busy {prof['device_busy_s']:.4f} s of the unprofiled wall "
        f"{bare['wall']:.3f} s ({100 * out['profile']['busy_share']:.2f}%)"
        f", {prof['device_events']} device events")

    # isolation: a device loss on stream 3, an OOM on stream 11
    platform.reset_fault_injection()
    os.environ[platform.FAULT_INJECT_ENV] = SERVICE_FAULTS
    try:
        iso = service_run(service, model, dev, hists, list(range(n)))
    finally:
        del os.environ[platform.FAULT_INJECT_ENV]
        platform.reset_fault_injection()
    for i in range(n):
        r = iso["results"][i]["linear"]
        if i in (3, 11):
            want = ["device-lost"] if i == 3 else ["oom"]
            if (r.get("recovered") or {}).get("faults") != want:
                raise AssertionError(f"s{i}: recovered {r.get('recovered')}")
            same(f"isolation: s{i} recovered vs its clean run", r, res[i],
                 ("recovered", "attested") + SERVICE_COUNT_KEYS)
        else:
            same(f"isolation: sibling s{i} vs its clean run", r, res[i])
    section("isolation")
    out["isolation"] = {"wall_s": iso["wall"],
                        "s3": iso["results"][3]["linear"]["recovered"],
                        "s11": iso["results"][11]["linear"]["recovered"],
                        "budget": iso["status"]["budget"]}
    log(f"service isolation: s3 {out['isolation']['s3']}, s11 "
        f"{out['isolation']['s11']}, same verdicts; the 14 siblings equal "
        f"their clean runs on the adaptive service (budget "
        f"{iso['status']['budget']}); wall {iso['wall']:.3f} s")

    # drain and resume: stream 0 with a store dir
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "svc", "s0")
        os.makedirs(run_dir)
        with open(os.path.join(run_dir, "journal.jsonl"), "w") as fh:
            for op in hists[0]:
                fh.write(json.dumps(op) + "\n")
        svc = service.VerificationService(device=dev)
        svc.admit("s0", service_spec(service, model, 0), store_dir=run_dir)
        for op in hists[0][:len(hists[0]) // 2]:
            svc.offer("s0", op)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            w = svc._worker("s0")
            if w.targets["linear"]._ckpt is not None and w.q.empty():
                break
            time.sleep(0.01)
        t = time.perf_counter()
        svc.drain()
        drain_s = time.perf_counter() - t
        svc.stop()
        ck = store.load_service_resume(run_dir)["checkpoints"]["linear"]
        import gzip
        with gzip.open(os.path.join(run_dir, "history.jsonl.gz"), "wt") as fh:
            for op in hists[0]:
                fh.write(json.dumps(op) + "\n")
        t = time.perf_counter()
        svc2 = service.VerificationService(device=dev)
        name = svc2.resume(run_dir)
        r = svc2.result(name, timeout_s=600)["linear"]
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
        from_chunk = svc2.status()["streams"][name]["chunks"]["linear"][
            "resumed-from-chunk"]
        svc2.stop()
    if from_chunk != ck["chunks"] or ck["chunks"] < 1:
        raise AssertionError(f"resume: from chunk {from_chunk}, manifest "
                             f"{ck['chunks']}")
    same("drain and resume of s0 vs its clean run", r, res[0],
         SERVICE_COUNT_KEYS)
    section("drain and resume")
    out["drain"] = {"drain_s": drain_s, "resume_to_verdict_s": resume_s,
                    "checkpoint_chunk": ck["chunks"],
                    "uninterrupted_s": clean["lat"][0]}
    log(f"service drain: s0 drained in {drain_s:.4f} s at chunk "
        f"{ck['chunks']}; a fresh service resumed it to the clean verdict "
        f"in {resume_s:.3f} s")

    # the socket: two ServiceClients, /metrics and /healthz
    with tempfile.TemporaryDirectory() as tmp:
        svc = service.VerificationService(device=dev)
        addr = svc.serve("127.0.0.1:0")
        msrv = telemetry.serve_metrics(0, healthz=svc.status)
        try:
            got = {}

            def client(i):
                c = service.ServiceClient(
                    addr, {"name": f"sock-s{i}", "start-time": "0",
                           "store-dir": tmp},
                    spec=service_spec(service, model, i), device=dev)
                for op in hists[i]:
                    c.offer(op)
                got[i] = c.finalize()
                c.close()

            ths = [threading.Thread(target=client, args=(i,)) for i in (1, 9)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=600)
            url = f"http://127.0.0.1:{msrv.server_address[1]}"
            with urllib.request.urlopen(url + "/metrics", timeout=30) as f:
                text = f.read().decode()
            with urllib.request.urlopen(url + "/healthz", timeout=30) as f:
                health = json.loads(f.read())
        finally:
            msrv.shutdown()
            msrv.server_close()
            svc.stop()
    for i in (1, 9):
        same(f"socket: s{i} through a ServiceClient vs in-process",
             got[i]["linear"], res[i])
    for name in ("jepsen_tpu_service_stream_events_total",
                 "jepsen_tpu_service_ops_total"):
        if name not in text:
            raise AssertionError(f"/metrics lacks {name}")
    if sorted(health.get("streams", {})) != ["sock-s1/0", "sock-s9/0"] \
            or health["calibration"]["platform"] != "cuda":
        raise AssertionError(f"/healthz: {sorted(health)}")
    section("socket")
    out["socket"] = {"streams": sorted(health["streams"]),
                     "metrics_bytes": len(text)}
    log("service socket: two ServiceClients (s1 dense, s9 sort) finalize "
        "to the in-process results; /metrics holds the stream-event and "
        "ops counters, /healthz returns status()")

    # the CPU path, from the worker processes
    t = time.perf_counter()
    for i in range(n):
        cpu_r, cpu_carry, cpu_s = cpu_jobs[i].result()
        if i in dense:
            g, g_carry, _s = solo_stream(streaming, model,
                                         hists[i][:SERVICE_CPU_DENSE_OPS], i,
                                         dev)
        else:
            g, g_carry = solo[i], None
        same_results(f"s{i} card vs CPU", g, cpu_r)
        if g_carry is not None:
            same_carry(f"s{i} prefix card vs CPU", g_carry, cpu_carry)
        out["per_stream"][f"s{i}"].update(cpu_s=cpu_s, cpu_ops=len(
            hists[i][:SERVICE_CPU_DENSE_OPS] if i in dense else hists[i]),
            cpu_chunks=cpu_r["chunks"])
    bad5 = cpu_jobs[5].result()[0]
    if bad5["valid?"] is not False:
        raise AssertionError(f"s5 prefix on the CPU: {bad5['valid?']}")
    log(f"service: the CPU path agrees with every stream alone on the card "
        f"(streams 0-7 on their first {SERVICE_CPU_DENSE_OPS} history ops, "
        f"chunks {[cpu_jobs[i].result()[0]['chunks'] for i in dense]}, "
        f"final carries included; 8-15 whole); waited "
        f"{time.perf_counter() - t:.3f} s for the workers")
    section("CPU path")
    log(f"service sections (s): {out['section_s']}")
    no_stamps("service", [res[i] for i in range(n)])
    return out


def sharded_rank(build_dir, mesh) -> dict:
    """One of the four gloo ranks sharing the card: build the kernels
    afresh into build_dir (the four ranks at once, so the builders race
    on the same files), then walk this rank's block of the hazelcast
    batch (dense: K3) and of the counter batch (hash route: K2) through
    check_batch_sharded. Returns each batch's result, launch counts (set
    to 0 just before its check) and wall, the rank's collectives and
    what it built."""
    from pathlib import Path

    import torch.distributed as dist
    from jepsen_tpu_torch import _build, models
    from jepsen_tpu_torch.checker import synth, wgl
    cuda = mesh.device.type == "cuda"
    _build.BUILD = Path(build_dir)
    t = time.perf_counter()
    built = sorted(_build.build()) if cuda else []
    build_s = time.perf_counter() - t
    out = dict(device=str(mesh.device), backend=dist.get_backend(),
               built=built, build_s=build_s)
    for label, (model, hists) in zip(("hazelcast", "counter"),
                                     batch_histories(models, synth)):
        zero_launches()
        t = time.perf_counter()
        ok, per_key, info = wgl.check_batch_sharded(model, hists, mesh,
                                                    slots=BATCH_SLOTS,
                                                    return_info=True)
        if cuda:
            torch.cuda.synchronize()
        out[label] = dict(all_ok=ok, per_key=per_key.tolist(), info=info,
                          wall_s=time.perf_counter() - t, **launch_counts())
    out["calls"] = {f"{op}/{d}": n for (op, d), n in mesh.calls.items()}
    return out


def ring_adjacency(n) -> np.ndarray:
    a = np.zeros((n, n), bool)
    a[np.arange(n), (np.arange(n) + 1) % n] = True
    return a


def phase_sharded(dev, models, synth, wgl, kernels,
                  list_append, platform, parallel, graft_entry, batch, elle,
                  smi) -> dict:
    """The sharded phase: check_batch_sharded, the Elle mesh path and the
    graft entries on the card, over one NCCL rank and four gloo ranks,
    held against the batch and Elle phases' results."""
    import functools
    import shutil
    import tempfile

    import torch.distributed as dist
    (reg, hz), (counter, cnt) = batch_histories(models, synth)
    want_hz = [v is True for v in batch["dense"]["verdicts"]]
    want_cnt = [v is True for v in batch["sort"]["verdicts"]]
    # the machine may have no network interface but the loopback one:
    # NCCL's and gloo's bootstraps use it
    for var in ("NCCL_SOCKET_IFNAME", "GLOO_SOCKET_IFNAME"):
        os.environ.setdefault(var, "lo")
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-sharded-")
    try:
        mesh = parallel.init(0, 1, f"file://{tmp}/rendezvous", device=dev)
        try:
            out["world1"] = sharded_world1(
                mesh, reg, hz, counter, cnt, want_hz, want_cnt, dev, wgl,
                kernels, list_append, platform,
                elle)
        finally:
            dist.destroy_process_group()
        log(f"sharded one-rank walls ({smi}): " + ", ".join(
            f"{k} {v['wall_s']:.3f} s" for k, v in out["world1"].items()))

        # four gloo ranks on the one card, each building the kernels
        t = time.perf_counter()
        ranks = parallel.spawn(
            functools.partial(sharded_rank, os.path.join(tmp, "build")),
            SHARDED_RANKS, device=dev, timeout_s=SHARDED_JOIN_S)
        wall = time.perf_counter() - t
        for r, rk in enumerate(ranks):
            for label in ("hazelcast", "counter"):
                got, w1 = rk[label], out["world1"][label]
                if got["per_key"] != w1["per_key"] \
                        or got["info"] != w1["info"] \
                        or got["all_ok"] is not False:
                    raise AssertionError(f"gloo rank {r}: {label} per_key "
                                         f"or info differ from the one-rank "
                                         f"run")
            hz_r, cnt_r = rk["hazelcast"], rk["counter"]
            if hz_r["k3_launches"] <= 0 or hz_r["k1_launches"] != 0 \
                    or hz_r["k2_launches"] != 0 \
                    or cnt_r["k2_launches"] <= 0 or rk["backend"] != "gloo" \
                    or torch.device(rk["device"]).type != dev.type:
                raise AssertionError(f"gloo rank {r}: {rk}")
        out["gloo4"] = dict(
            spawn_wall_s=wall,
            ranks=[{k: ({kk: vv for kk, vv in v.items()
                         if kk not in ("per_key", "info")}
                        if isinstance(v, dict) and "per_key" in v else v)
                    for k, v in rk.items()} for rk in ranks])
        for r, rk in enumerate(ranks):
            log(f"sharded gloo rank {r}/{SHARDED_RANKS} on {rk['device']}: "
                f"built {rk['built']} in {rk['build_s']:.3f} s, hazelcast "
                f"{rk['hazelcast']['wall_s']:.3f} s (K3 launches "
                f"{rk['hazelcast']['k3_launches']}), counter "
                f"{rk['counter']['wall_s']:.3f} s (K2 launches "
                f"{rk['counter']['k2_launches']}), collectives "
                f"{rk['calls']}; per_key and info equal to the one-rank "
                f"runs")
        log(f"sharded gloo x{SHARDED_RANKS}: spawn to join {wall:.3f} s "
            f"({smi})")

        t = time.perf_counter()
        line = graft_entry.dryrun_multichip(SHARDED_RANKS, device=dev,
                                            timeout_s=SHARDED_JOIN_S)
        out["dryrun"] = dict(line=line, wall_s=time.perf_counter() - t)
        log(f"dryrun_multichip({SHARDED_RANKS}): {line!r}, "
            f"{out['dryrun']['wall_s']:.3f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the single-device graft entry, against the CPU path
    fn, args = graft_entry.entry(dev)
    got = fn(*args)
    cfn, cargs = graft_entry.entry("cpu")
    want = cfn(*cargs)
    if got != want or got[0] is not True:
        raise AssertionError(f"entry(): {got} != the CPU path's {want}")
    out["entry"] = list(got)
    log(f"entry() on the card: {got}, equal to the CPU path's")
    return out


def sharded_world1(mesh, reg, hz, counter, cnt, want_hz, want_cnt, dev, wgl,
                   kernels, list_append, platform,
                   elle) -> dict:
    """The one-rank NCCL runs of the sharded phase."""
    out = {}

    def run(label, fn):
        zero_launches()
        kernels.LAUNCHES = 0
        calls = collections.Counter(mesh.calls)
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        rec = dict(wall_s=time.perf_counter() - t, **launch_counts(),
                   classifier_calls=kernels.LAUNCHES,
                   collectives={f"{op}/{d}": n for (op, d), n in
                                (mesh.calls - calls).items()})
        log(f"sharded {label}: wall {rec['wall_s']:.3f} s, K3 launches "
            f"{rec['k3_launches']}, K2 launches {rec['k2_launches']}, "
            f"classifier calls {rec['classifier_calls']}, collectives "
            f"{rec['collectives']}")
        return r, rec

    def sharded(model, hists):
        return wgl.check_batch_sharded(model, hists, mesh, slots=BATCH_SLOTS,
                                       return_info=True)

    (ok, pk, info), rec = run("hazelcast over 1 NCCL rank",
                              lambda: sharded(reg, hz))
    if ok is not False or pk.tolist() != want_hz \
            or info != {"groups": SHARDED_GROUPS,
                        "attested": {"steps": 4, "carry": 4}} \
            or rec["k3_launches"] <= 0 or rec["k1_launches"] != 0 \
            or rec["k2_launches"] != 0:
        raise AssertionError(f"sharded hazelcast: {ok} {info} {rec}")
    if not all(k.endswith("/" + dev.type) for k in rec["collectives"]) \
            or not rec["collectives"]:
        raise AssertionError(f"collectives off the device: {rec}")
    out["hazelcast"] = dict(rec, per_key=pk.tolist(), info=info)

    (ok, pk, info), rec = run("counter over 1 NCCL rank",
                              lambda: sharded(counter, cnt))
    if ok is not False or pk.tolist() != want_cnt or info["groups"] != [
            {"family": "sort", "dedup": "pallas-hash", "keys": COUNTER_KEYS,
             "slots": BATCH_SLOTS}] or rec["k2_launches"] <= 0:
        raise AssertionError(f"sharded counter: {ok} {info} {rec}")
    out["counter"] = dict(rec, per_key=pk.tolist(), info=info)

    os.environ[platform.FAULT_INJECT_ENV] = "oom@sharded:1"
    platform.reset_fault_injection()
    try:
        (ok, pk, info), rec = run("hazelcast under oom@sharded:1",
                                  lambda: sharded(reg, hz))
    finally:
        del os.environ[platform.FAULT_INJECT_ENV]
        platform.reset_fault_injection()
    if pk.tolist() != want_hz or info.get("recovered") != {
            "faults": ["oom"], "retries": 1, "split": True}:
        raise AssertionError(f"sharded OOM: {info}")
    out["oom"] = dict(rec, groups=info["groups"])

    g, rec = run("list-append + G1c over 1 NCCL rank",
                 lambda: list_append.check(elle["g1c_history"], mesh=mesh))
    if g != elle["g1c_result"] or rec["classifier_calls"] != 1:
        raise AssertionError("sharded Elle: the result differs from the "
                             "Elle phase's")
    out["elle"] = rec

    adj = ring_adjacency(SHARDED_RING)
    t = time.perf_counter()
    plain = kernels.transitive_closure(adj, device=dev)
    plain_s = time.perf_counter() - t
    closed, rec = run(f"transitive_closure of a {SHARDED_RING}-node ring",
                      lambda: kernels.transitive_closure(adj, mesh=mesh))
    if not (np.array_equal(closed, plain) and closed.all()):
        raise AssertionError("sharded transitive_closure differs")
    out["closure"] = dict(rec, plain_s=plain_s)
    log(f"sharded: per_key equal to the batch phase's, the group plan the "
        f"JAX package's {[(g['slots'], g['keys']) for g in SHARDED_GROUPS]}, "
        f"the OOM split, the Elle result equal to the Elle phase's, the "
        f"ring's closure equal without the mesh ({plain_s:.3f} s); all "
        f"collectives on {dev.type} tensors: {dict(mesh.calls)}")
    return out


def counting_plain():
    """Count the plain versions' calls of K1 and K2 in this (CPU) process:
    the K2 launches the card's run of the same work must make, and the
    closure rounds its K3 walks must report."""
    from jepsen_tpu_torch.checker import wgl_closure, wgl_dedup
    counts = {"k1": 0, "k2": 0}
    k1, k2 = wgl_closure.closure_round_plain, wgl_dedup.dedup_plain

    def closure_round_plain(*a, **k):
        counts["k1"] += 1
        return k1(*a, **k)

    def dedup_plain(*a, **k):
        counts["k2"] += 1
        return k2(*a, **k)

    wgl_closure.closure_round_plain = closure_round_plain
    wgl_dedup.dedup_plain = dedup_plain
    return counts


def cpu_search(kind: str) -> tuple:
    """Phase 11's CPU path in a worker process: one SEARCH_RUNS config on
    the CPU. Returns the result, the plain K1/K2 calls and the seconds
    it took."""
    from jepsen_tpu_torch.search import SearchConfig, run_search
    counts = counting_plain()
    t = time.perf_counter()
    r = run_search(SearchConfig(device="cpu", **SEARCH_RUNS[kind]))
    return r, counts, time.perf_counter() - t


def cpu_chaos(workload: str) -> tuple:
    """Phase 11's CPU path in a worker process: run_chaos on one chaos
    workload. Returns the result, the plain K1/K2 calls and the seconds
    it took."""
    from jepsen_tpu_torch.chaos import ChaosConfig, run_chaos
    counts = counting_plain()
    t = time.perf_counter()
    r = run_chaos(ChaosConfig(device="cpu", workload=workload, **CHAOS))
    return r, counts, time.perf_counter() - t


def cpu_search_chaos_jobs(pool) -> dict:
    return {**{f"search-{k}": pool.submit(cpu_search, k)
               for k in SEARCH_RUNS},
            **{f"chaos-{w}": pool.submit(cpu_chaos, w)
               for w in CHAOS_WORKLOADS}}


def same_but_wall(label, got, want) -> None:
    a = {k: v for k, v in got.items() if k != "wall-s"}
    b = {k: v for k, v in want.items() if k != "wall-s"}
    if a != b:
        diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        raise AssertionError(f"{label}: differs from the CPU path in {diff}")


def phase_search_chaos(dev, cpu_jobs) -> dict:
    """Phase 11: the scenario search and the self-chaos harness on the
    card. Every kernel's launch count set to 0 just before each run and
    read just after; each result equal to the CPU path's (in a worker
    process) but for its wall: the search with the batch escalation
    finds the planted bug and launches K3, whose rounds are the CPU
    path's plain K1 calls; the service search and both chaos workloads
    likewise, every chaos oracle green; then the chaos command as a
    subprocess on the card, exiting 0 with the in-process run's result."""
    import tempfile
    from jepsen_tpu_torch.chaos import ChaosConfig, run_chaos
    from jepsen_tpu_torch.search import SearchConfig, run_search
    out = {}

    def counted(label, fn):
        zero_launches()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rec = dict(wall_s=wall, **launch_counts())
        want, counts, cpu_s = cpu_jobs[label].result()
        same_but_wall(label, r, want)
        if (rec["k3_rounds"], rec["k2_launches"]) != (counts["k1"],
                                                      counts["k2"]) \
                or rec["k1_launches"] != 0:
            raise AssertionError(f"{label}: K3 rounds / K2 launches "
                                 f"{rec['k3_rounds']}/{rec['k2_launches']}"
                                 f" (K1 {rec['k1_launches']}), CPU path "
                                 f"{counts}")
        rec.update(cpu_s=cpu_s, result={k: v for k, v in r.items()
                                        if k not in ("violations",
                                                     "failures")})
        out[label] = rec
        return r, rec

    for kind, cfg in SEARCH_RUNS.items():
        r, rec = counted(f"search-{kind}", lambda: run_search(
            SearchConfig(device=str(dev), **cfg)))
        log(f"search {kind}: found {r['found']}, {r['simulations']} "
            f"simulations, {r['escalations']} escalations, wall "
            f"{rec['wall_s']:.3f} s (CPU path {rec['cpu_s']:.3f} s), K3 "
            f"launches {rec['k3_launches']} ({rec['k3_rounds']} rounds), "
            f"K2 launches {rec['k2_launches']}, equal to the CPU path")
        if kind == "batch" and (not r["found"] or rec["k3_launches"] <= 0):
            raise AssertionError(f"search batch: found {r['found']}, K3 "
                                 f"launches {rec['k3_launches']}")
    for w in CHAOS_WORKLOADS:
        r, rec = counted(f"chaos-{w}", lambda: run_chaos(
            ChaosConfig(device=str(dev), workload=w, **CHAOS)))
        log(f"chaos {w}: {r['schedules']} schedules, {r['coverage-bits']} "
            f"coverage bits, conjunction hits {r['conjunction-hits']}, "
            f"failures {len(r['failures'])}, wall {rec['wall_s']:.3f} s "
            f"(CPU path {rec['cpu_s']:.3f} s), K3 launches "
            f"{rec['k3_launches']}, K2 launches {rec['k2_launches']}, equal "
            f"to the CPU path")
        if r["failures"] or r["found"]:
            raise AssertionError(f"chaos {w}: oracle failures "
                                 f"{r['failures']}")
        if w == "register":
            inproc = r
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        argv = [sys.executable, "-m", "jepsen_tpu_torch", "chaos",
                "--budget", str(CHAOS["budget"]), "--ops",
                str(CHAOS["ops"]), "--seed", str(CHAOS["seed"]),
                "--store-dir", d]
        t = time.perf_counter()
        p = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                           timeout=CHAOS_CLI_S,
                           env=dict(os.environ, PYTHONPATH=root))
        wall = time.perf_counter() - t
    line = [x for x in p.stderr.splitlines() if x.startswith("chaos (")]
    log(f"chaos command on the card: exit {p.returncode} in {wall:.3f} s; "
        f"{line[-1] if line else p.stderr[-2000:]}")
    if p.returncode != 0 or not line:
        raise AssertionError(f"chaos command: exit {p.returncode}: "
                             f"{p.stderr[-2000:]}")
    same_but_wall("chaos command", json.loads(p.stdout), inproc)
    out["chaos-cli"] = dict(wall_s=wall, rc=p.returncode)
    return out


def run_clients():
    """Phase 12's in-process clients (defined here, not in the package):
    a keyed CAS register, one `testkit.AtomState` per key, in place of
    the etcd suite's EtcdClient; and the JAX package's lying atom client
    (tests/test_streaming.py), which reads 10^6 after RUN_LIE_AFTER ops."""
    from jepsen_tpu_torch import client, independent, testkit

    class KeyedAtomClient(client.Client):
        def __init__(self):
            self.cells = {}
            self.lock = threading.Lock()

        def open(self, test, node):
            return self

        def invoke(self, test, op):
            k, v = op["value"].key, op["value"].value
            with self.lock:
                cell = self.cells.setdefault(k, testkit.AtomState(None))
            out = dict(op)
            if op["f"] == "write":
                cell.reset(v)
                out["type"] = "ok"
            elif op["f"] == "cas":
                out["type"] = "ok" if cell.cas(*v) else "fail"
            else:
                out["type"] = "ok"
                out["value"] = independent.ktuple(k, cell.read())
            return out

        def reusable(self, test):
            return True

    class LyingClient(client.Client):
        def __init__(self, state, after):
            self.inner = testkit.atom_client(state, latency_s=0.0005)
            self.after = after
            self.count = [0]

        def open(self, test, node):
            c = LyingClient.__new__(LyingClient)
            c.inner = self.inner.open(test, node)
            c.after = self.after
            c.count = self.count
            return c

        def setup(self, test):
            self.inner.setup(test)

        def invoke(self, test, op):
            out = self.inner.invoke(test, op)
            self.count[0] += 1
            if self.count[0] > self.after and op["f"] == "read" \
                    and out["type"] == "ok":
                out = dict(out)
                out["value"] = 10 ** 6
            return out

        def teardown(self, test):
            self.inner.teardown(test)

        def close(self, test):
            self.inner.close(test)

    return KeyedAtomClient, LyingClient


def getent_remote():
    """The dummy remote, answering `getent ahosts nK` with 10.0.0.K so
    the partition nemesis resolves the nodes it cuts apart."""
    from jepsen_tpu_torch.control import dummy
    return dummy.DummyRemote(responses={r"getent ahosts": lambda c, a: {
        "out": f"10.0.0.{a['cmd'].split()[-1][-1]} STREAM x\n"}})


def cut_generator(client_gen, invocations, start=None, stop=None):
    """A suite map's generator as phases 12-15 cut it: invocations client
    ops of client_gen, no stagger, beside a partition nemesis cycling
    start and stop (ops, or generators of one op; by default f "start"
    and "stop") every RUN_NEMESIS_CYCLE_S for RUN_NEMESIS_S, then a
    final stop."""
    from jepsen_tpu_torch import generator as gen
    start = start or {"type": "info", "f": "start", "value": None}
    stop = stop or {"type": "info", "f": "stop", "value": None}
    cycle = gen.cycle(gen.phases(
        gen.sleep(RUN_NEMESIS_CYCLE_S), gen.once(start),
        gen.sleep(RUN_NEMESIS_CYCLE_S), gen.once(stop)))
    return gen.phases(
        gen.any(gen.clients(gen.limit(invocations, client_gen)),
                gen.nemesis(gen.time_limit(RUN_NEMESIS_S, cycle))),
        gen.nemesis(gen.once(stop)))


def suite_test_map(name, store_dir, remote, client, w, invocations,
                   concurrency) -> dict:
    """A suite's test map (`suites/__init__.py: std_test`) as phases 12
    and 13 cut it: the given in-process client and workload, a no-op
    DB, the debian OS, no stagger, invocations client ops beside a
    partition_random_halves nemesis cycling every RUN_NEMESIS_CYCLE_S
    for RUN_NEMESIS_S, and the std checker compose."""
    from jepsen_tpu_torch import checker, db, testkit
    from jepsen_tpu_torch.checker import timeline
    from jepsen_tpu_torch.nemesis import partition
    from jepsen_tpu_torch.os_ import debian
    return {**testkit.noop_test(), "name": name,
            "nodes": list(RUN_NODES), "ssh": {"dummy": True},
            "remote": remote, "store-dir": store_dir,
            "concurrency": concurrency, "os": debian.os,
            "db": db.noop, "client": client,
            "nemesis": partition.partition_random_halves(),
            "generator": cut_generator(w["generator"], invocations),
            "checker": checker.compose({
                "perf": checker.perf_checker(),
                "timeline": timeline.html(),
                "workload": w["checker"],
                "stats": checker.stats(),
                "exceptions": checker.unhandled_exceptions()})}


def register_run_test(dev, store_dir, remote) -> dict:
    """The etcd suite's register test map (`suites/etcd.py: etcd_test`)
    with the keyed atom client, cut as RUN_REGISTER says."""
    from jepsen_tpu_torch.workloads import linearizable_register
    keyed, _ = run_clients()
    w = linearizable_register.test({
        "nodes": RUN_NODES, "per-key-limit": RUN_REGISTER["per_key_limit"],
        "device": str(dev)})
    return suite_test_map("etcd-register", store_dir, remote, keyed(), w,
                          RUN_REGISTER["invocations"],
                          RUN_REGISTER["concurrency"])


def single_register_test(dev, store_dir, n, concurrency, client=None,
                         **extra) -> dict:
    """One CAS register over an atom (AtomDB zeroes it, so the model
    starts at 0) with the register workload's read/write/cas mix."""
    from jepsen_tpu_torch import models, testkit
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.checker.linear import linearizable
    from jepsen_tpu_torch.workloads import linearizable_register as lr
    state = testkit.AtomState()
    return {**testkit.noop_test(), "ssh": {"dummy": True},
            "store-dir": store_dir, "concurrency": concurrency,
            "db": testkit.atom_db(state),
            "client": (client(state) if client
                       else testkit.atom_client(state, latency_s=0.0)),
            "checker": linearizable(models.cas_register(0),
                                    device=str(dev)),
            "generator": gen.clients(gen.limit(n, gen.mix(
                [lr.r, lr.w, lr.cas]))), **extra}


def rekeyed(independent, hist) -> list:
    """A stored key-sharded history with its KVs back: the store writes
    a KV as a JSON [key, value] list (both packages; ROADMAP F6)."""
    return [dict(o, value=independent.ktuple(*o["value"]))
            if isinstance(o["process"], int)
            and isinstance(o.get("value"), list) else o for o in hist]


def cpu_run_check(kind: str, run_dir: str) -> tuple:
    """Phase 12's CPU path in a worker process: the stored history of a
    card run, read back from its run directory and checked on the CPU as
    the run's checker checks it. Returns the compared fields (per key for
    the register run) and the seconds it took."""
    from jepsen_tpu_torch import independent, models, store
    from jepsen_tpu_torch.checker.linear import linearizable
    t = time.perf_counter()
    hist = store.load_test(run_dir)["history"]
    if kind == "register":
        # phase 12's longest CPU check, the pool's only job for most of
        # its run: it takes the other worker's share of the cores too
        torch.set_num_threads(CPU_WORKERS * CPU_WORKER_THREADS)
        r = independent.checker(linearizable(
            models.cas_register(), device="cpu")).check(
                {}, rekeyed(independent, hist), {})
        got = r["results"]
    else:
        r = linearizable(models.cas_register(0), device="cpu").check(
            {}, hist, {})
        got = {f: r.get(f) for f in ("valid?", "op-index")}
    return got, time.perf_counter() - t


def run_stamps(label, results) -> None:
    """No 'recovered' or 'degraded' stamp anywhere in a run's results:
    nothing is injected in phase 12."""
    def walk(r, path):
        if isinstance(r, dict):
            if r.get("recovered") or r.get("degraded") \
                    or r.get("recovered-checkers") \
                    or r.get("degraded-checkers"):
                raise AssertionError(f"{label}: {path} stamped "
                                     f"{r.get('recovered')} "
                                     f"{r.get('error')}")
            for k, v in r.items():
                walk(v, f"{path}/{k}")
    walk(results, "results")


def interpreter_rate(hist) -> tuple[int, float]:
    """History ops, and the client ops' rate over the span of their op
    times (the interpreter's pace, without the nemesis's tail)."""
    ts = [o["time"] for o in hist if isinstance(o["process"], int)]
    span = (max(ts) - min(ts)) / 1e9 if ts else 0.0
    return len(hist), (len(ts) / span if span else 0.0)


def phase_run(dev, pool) -> dict:
    """Phase 12: the port's core.run on the card (register, online and
    abort runs, the CLI's test and analyze), each with every kernel's
    launch count set to 0 just before and read just after; each verdict
    held against the CPU path's check of the run's stored history in a
    worker process (the register run per key, with its batch-walk
    counts). The runs' stores live in a temporary directory."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="run-path-") as root:
        return run_path_runs(dev, pool, root)


def run_path_runs(dev, pool, root) -> dict:
    """`phase_run`'s runs, their stores under root."""
    from jepsen_tpu_torch import cli, core, models, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.checker import streaming, synth
    from jepsen_tpu_torch.checker.linear import linearizable
    _, lying = run_clients()
    out = {}

    def counted(label, fn):
        zero_launches()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rec = dict(wall_s=wall, **launch_counts())
        out[label] = rec
        return r, rec

    def run_dir(test):
        return os.path.dirname(store.path(test, "results.json"))

    # -- the register run ------------------------------------------------
    remote = getent_remote()
    with gen.fixed_rng(SEED):
        t = register_run_test(dev, os.path.join(root, "register"), remote)
    done, rec = counted("register", lambda: core.run(t))
    cpu_reg = pool.submit(cpu_run_check, "register", run_dir(done))
    res = done["results"]
    run_stamps("register run", res)
    n_ops, rate = interpreter_rate(done["history"])
    keyed = res["workload"]["results"]
    nem = [o for o in done["history"] if o["process"] == "nemesis"]
    d = run_dir(done)
    missing = [f for f in RUN_PERF_FILES
               if not os.path.exists(os.path.join(d, f))]
    cut = [a for _, _, a in remote.log if "iptables" in a.get("cmd", "")]
    tot = walk_totals(list(keyed.values()))
    rec.update(ops=n_ops, ops_per_s=rate, keys=len(keyed),
               nemesis_ops=len(nem), **tot)
    log(f"run register: valid?={res['valid?']}, {len(keyed)} keys, "
        f"{n_ops} history ops ({rate:.0f} ops/s in the interpreter), "
        f"{len(nem)} nemesis ops, {len(cut)} iptables commands, wall "
        f"{rec['wall_s']:.3f} s, K3 launches {rec['k3_launches']} "
        f"({rec['k3_rounds']} rounds), K2 launches {rec['k2_launches']}, "
        f"groups {tot['groups']}")
    if res["valid?"] is not True or any(
            r["valid?"] is not True or r["analyzer"] != "gpu-wgl-batch"
            or r["device"] != dev.type for r in keyed.values()):
        raise AssertionError(f"register run: {res['valid?']}, "
                             f"{res['workload'].get('failures')}")
    if n_ops != 2 * RUN_REGISTER["invocations"] + len(nem) or \
            {o["f"] for o in nem} != {"start", "stop"} or not cut:
        raise AssertionError(f"register run: {n_ops} ops, nemesis "
                             f"{sorted({o['f'] for o in nem})}, "
                             f"{len(cut)} iptables commands")
    if missing:
        raise AssertionError(f"register run: the store lacks {missing}")
    if rec["k3_launches"] <= 0 or rec["k1_launches"] != 0 or (
            rec["k3_rounds"], rec["k2_launches"]) != (
                tot["closure_rounds"], tot["dedup_launches"]):
        raise AssertionError(f"register run: K3 rounds / K2 launches "
                             f"{rec['k3_rounds']}/{rec['k2_launches']} "
                             f"(K1 {rec['k1_launches']}) for {tot}")

    # -- the online run ----------------------------------------------------
    with gen.fixed_rng(SEED):
        t = single_register_test(
            dev, os.path.join(root, "online"), RUN_ONLINE["invocations"],
            RUN_ONLINE["concurrency"], name="online-register", online=True,
            **{"online-state-range": RUN_ONLINE["state_range"]})
    done, rec = counted("online", lambda: core.run(t))
    cpu_online = pool.submit(cpu_run_check, "online", run_dir(done))
    res = done["results"]
    run_stamps("online run", res)
    n_ops, rate = interpreter_rate(done["history"])
    stored = store.load_history(done)
    t0 = time.perf_counter()
    offline = linearizable(models.cas_register(0), device=str(dev)).check(
        {}, stored, {})
    torch.cuda.synchronize()
    rec.update(ops=n_ops, ops_per_s=rate,
               offline_s=time.perf_counter() - t0,
               analyzer=res.get("analyzer"))
    log(f"run online: valid?={res['valid?']} ({res.get('analyzer')}, "
        f"streamed {res.get('streamed')}), {n_ops} history ops "
        f"({rate:.0f} ops/s in the interpreter), wall {rec['wall_s']:.3f} "
        f"s, K3 launches {rec['k3_launches']} ({rec['k3_rounds']} rounds), "
        f"K2 launches {rec['k2_launches']}; offline on the card "
        f"{offline['valid?']} "
        f"in {rec['offline_s']:.3f} s")
    if res.get("streamed") is not True or \
            res.get("analyzer") != "gpu-wgl-dense-streaming" or \
            done["streamed-results"]["linear"]["valid?"] is not True or \
            rec["k3_launches"] <= 0 or rec["k1_launches"] != 0 or \
            res["valid?"] != offline["valid?"]:
        raise AssertionError(f"online run: {res.get('analyzer')}, "
                             f"streamed {res.get('streamed')}, K3 "
                             f"{rec['k3_launches']}, offline "
                             f"{offline['valid?']}")

    # -- the abort run -------------------------------------------------------
    # the stream's range escape and unpacked sort walk warmed first, as
    # the JAX package's abort test does: their first use in a process
    # would otherwise let the run end before the stream reaches the lie
    t0 = time.perf_counter()
    streaming.stream_check(
        models.cas_register(0), synth.corrupt(synth.register_history(
            600, concurrency=RUN_ONLINE["concurrency"], values=5,
            crash_rate=0.0)), device=str(dev), chunk_entries=RUN_ABORT_CHUNK,
        state_range=RUN_ONLINE["state_range"],
        concurrency_hint=RUN_ONLINE["concurrency"])
    torch.cuda.synchronize()
    log(f"run abort: warm-up stream {time.perf_counter() - t0:.3f} s")
    with gen.fixed_rng(SEED):
        t = single_register_test(
            dev, os.path.join(root, "abort"), RUN_ABORT_INVOCATIONS,
            RUN_ONLINE["concurrency"],
            client=lambda state: lying(state, RUN_LIE_AFTER),
            name="abort-register", online=True,
            **{"online-state-range": RUN_ONLINE["state_range"],
               "online-chunk-entries": RUN_ABORT_CHUNK,
               "abort-on-violation": True})
    done, rec = counted("abort", lambda: core.run(t))
    cpu_abort = pool.submit(cpu_run_check, "abort", run_dir(done))
    res = done["results"]
    run_stamps("abort run", res)
    n_ops, rate = interpreter_rate(done["history"])
    rec.update(ops=n_ops, ops_per_s=rate, op_index=res.get("op-index"))
    log(f"run abort: valid?={res['valid?']} at op {res.get('op-index')}, "
        f"aborted {done.get('aborted-on-violation')}, {n_ops} of "
        f"{2 * RUN_ABORT_INVOCATIONS} history ops, wall "
        f"{rec['wall_s']:.3f} s, K3 launches {rec['k3_launches']}, K2 "
        f"launches {rec['k2_launches']}")
    if done.get("aborted-on-violation") is not True or res["valid?"] \
            is not False or n_ops >= 2 * RUN_ABORT_INVOCATIONS:
        raise AssertionError(f"abort run: aborted "
                             f"{done.get('aborted-on-violation')}, "
                             f"{res['valid?']}, {n_ops} ops")

    # -- the CLI: test, then analyze on the same store -------------------
    def test_fn(options):
        with gen.fixed_rng(SEED):
            return {**options, **single_register_test(
                options["device"], options["store-dir"],
                RUN_CLI_INVOCATIONS, options["concurrency"],
                name="cli-register")}

    cmds = cli.single_test_cmd({"test_fn": test_fn})
    argv = ["--no-ssh", "--store-dir", os.path.join(root, "cli"),
            "--concurrency", "5", "--device", str(dev)]
    codes = {}

    def command(cmd):
        try:
            cli.run(cmds, [cmd, *argv])
        except SystemExit as e:
            codes[cmd] = e.code
        with open(os.path.join(store.latest(os.path.join(root, "cli")),
                               "results.json")) as f:
            r = json.load(f)
        r.pop("duration-ms", None)
        return r

    first, rec = counted("cli-test", lambda: command("test"))
    again, rec2 = counted("cli-analyze", lambda: command("analyze"))
    log(f"run cli: test exit {codes.get('test')} in {rec['wall_s']:.3f} s "
        f"(K3 {rec['k3_launches']}, K2 {rec['k2_launches']}), analyze "
        f"exit {codes.get('analyze')} in {rec2['wall_s']:.3f} s (K3 "
        f"{rec2['k3_launches']}, K2 {rec2['k2_launches']}), valid? "
        f"{first['valid?']}, the same results: {first == again}")
    run_stamps("cli run", first)
    if codes != {"test": 0, "analyze": 0} or first != again or \
            first["valid?"] is not True or rec["k3_launches"] <= 0:
        raise AssertionError(f"cli: exits {codes}, results equal "
                             f"{first == again}, K3 {rec['k3_launches']}")

    # -- the CPU path on each stored history -------------------------------
    want, cpu_s = cpu_reg.result()

    def plain(per_key):
        return {str(k): json.loads(json.dumps(
            without_dense_syncs({f: r.get(f) for f in BATCH_AGREE_KEYS}),
            default=str)) for k, r in per_key.items()}

    got, want = plain(keyed), plain(want)
    if got != want:
        bad = sorted(set(got) ^ set(want)) or sorted(
            k for k in got if got[k] != want[k])
        raise AssertionError(f"register run: keys {bad} differ from the "
                             f"CPU path")
    out["register"]["cpu_s"] = cpu_s
    want, cpu_s = cpu_online.result()
    if want["valid?"] != offline["valid?"]:
        raise AssertionError(f"online run: CPU path {want}")
    out["online"]["cpu_s"] = cpu_s
    want, cpu_s = cpu_abort.result()
    if (want["valid?"], want["op-index"]) != (False,
                                              out["abort"]["op_index"]):
        raise AssertionError(f"abort run: op {out['abort']['op_index']}, "
                             f"CPU path {want}")
    out["abort"]["cpu_s"] = cpu_s
    log(f"run path: the CPU path agrees (register per key with its "
        f"batch-walk counts {out['register']['cpu_s']:.3f} s, online "
        f"{out['online']['cpu_s']:.3f} s, abort at op "
        f"{out['abort']['op_index']} {out['abort']['cpu_s']:.3f} s)")
    return out


def workload_client(kind, every=None, warmup=None):
    """Phase 13's in-process client (defined here, not in the package)
    for the tidb/cockroach suites' MonotonicClient and WrTxnClient: a
    serializable store, one lock and an integer per key, where a 'w'
    micro-op with a nil value writes its key's prior value + 1. Once
    `warmup` reads have run, one read in `every` whose keys all hold a
    value reports one key at its previous version. For `monotonic` that
    is the read's most recently written key: the read then closes a
    cycle only through a realtime or process edge, never a dependency
    cycle through a second read of the same keys (a G2 whose simple-path
    certificate search is slow on the host). For `sequential` it is the
    pair's first-written key (read second). Both default to
    WORKLOAD_PLANT_EVERY and WORKLOAD_WARMUP."""
    from jepsen_tpu_torch import client

    every = every or WORKLOAD_PLANT_EVERY
    warmup = WORKLOAD_WARMUP if warmup is None else warmup

    class PlantedTxnClient(client.Client):
        def __init__(self):
            self.lock = threading.Lock()
            self.data, self.prev, self.written = {}, {}, {}
            self.reads = self.due = self.planted = self.writes = 0

        def open(self, test, node):
            return self

        def invoke(self, test, op):
            out = []
            with self.lock:
                for f, k, v in op["value"]:
                    if f == "r":
                        out.append(["r", k, self.data.get(k)])
                    else:
                        x = v if v is not None else \
                            (self.data.get(k) or 0) + 1
                        self.prev[k] = self.data.get(k)
                        self.data[k] = x
                        self.writes += 1
                        self.written[k] = self.writes
                        out.append(["w", k, x])
                if op["f"] == "read":
                    self.reads += 1
                    if self.reads > warmup and self.reads % every == 0:
                        self.due += 1
                    if self.due and all(m[2] is not None for m in out):
                        m = 1 if kind == "sequential" else max(
                            range(len(out)),
                            key=lambda i: self.written[out[i][1]])
                        out[m][2] = self.prev.get(out[m][1])
                        self.due -= 1
                        self.planted += 1
            return {**op, "type": "ok", "value": out}

        def reusable(self, test):
            return True

    return PlantedTxnClient()


def workload_run_test(kind, dev, store_dir, remote, client=None) -> dict:
    """The tidb/cockroach suites' `kind` test map (`monotonic` or
    `sequential`, workload defaults, the checker on dev) with phase 13's
    planted store (or `client`), cut as WORKLOAD_RUN and
    `suite_test_map` say."""
    from jepsen_tpu_torch.workloads import monotonic, sequential
    w = {"monotonic": monotonic, "sequential": sequential}[kind].workload(
        {"device": str(dev)})
    return suite_test_map(f"cockroach-{kind}", store_dir, remote,
                          client or workload_client(kind), w,
                          WORKLOAD_RUN["invocations"],
                          WORKLOAD_RUN["concurrency"])


def cpu_workload_check(kind: str, run_dir: str) -> tuple:
    """Phase 13's CPU path in a worker process: a card run's stored
    history checked by its workload's checker on the CPU. Returns the
    result and the seconds it took."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.workloads import monotonic, sequential
    t = time.perf_counter()
    hist = store.load_test(run_dir)["history"]
    w = {"monotonic": monotonic, "sequential": sequential}[kind].workload(
        {"device": "cpu"})
    r = w["checker"].check({}, hist, {})
    return r, time.perf_counter() - t


def phase_workloads(dev, elle_kernels, pool) -> dict:
    """Phase 13: the monotonic and sequential test maps through the
    port's core.run on the card, with every kernel's launch count and
    the classifier's call count set to 0 just before each run and read
    just after; each workload result held, whole, against the CPU path's
    check of the run's stored history in a worker process. It also
    imports every module of the port's last host slice, so the
    script's closing guard covers them."""
    import tempfile

    from jepsen_tpu_torch import core, faketime, fs_cache, store, workloads
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.control import docker, k8s
    from jepsen_tpu_torch.nemesis import charybdefs, membership
    slice_modules = [m.__name__ for m in (faketime, fs_cache, docker, k8s,
                                          charybdefs, membership)]
    slice_modules += [f"{workloads.__name__}.{m}" for m in workloads.__all__]
    out, cpu = {"modules": slice_modules}, {}
    with tempfile.TemporaryDirectory(prefix="workloads-") as root:
        for kind in ("monotonic", "sequential"):
            remote = getent_remote()
            planted = workload_client(kind)
            with gen.fixed_rng(SEED):
                t = workload_run_test(kind, dev, os.path.join(root, kind),
                                      remote, client=planted)
            zero_launches()
            elle_kernels.LAUNCHES = 0
            with ElleRecorder(elle_kernels) as rec:
                t0 = time.perf_counter()
                done = core.run(t)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            run_dir = os.path.dirname(store.path(done, "results.json"))
            cpu[kind] = pool.submit(cpu_workload_check, kind, run_dir)
            res = done["results"]
            run_stamps(f"{kind} run", res)
            n_ops, rate = interpreter_rate(done["history"])
            nem = [o for o in done["history"] if o["process"] == "nemesis"]
            buckets = [{str(e): list(s[0].shape) for e, s in bk.items()}
                       for bk, _f in rec.calls]
            w = res["workload"]
            out[kind] = row = dict(
                wall_s=wall, ops=n_ops, ops_per_s=rate,
                nemesis_ops=len(nem), planted=planted.planted,
                classifier_calls=elle_kernels.LAUNCHES, buckets=buckets,
                classifier_s=sum(rec.seconds),
                certificates_s=sum(rec.cert_seconds), **launch_counts(),
                valid=w["valid?"],
                anomaly_types=w.get("anomaly-types"))
            log(f"workload {kind}: valid?={w['valid?']} "
                f"{w.get('anomaly-types')}, {n_ops} history ops "
                f"({rate:.0f} client ops/s), {len(nem)} nemesis ops, "
                f"{planted.planted} stale reads planted, wall {wall:.3f} "
                f"s, classifier calls {elle_kernels.LAUNCHES} in "
                f"{row['classifier_s']:.3f} s (buckets e: [B, e, e] "
                f"{buckets}), host certificates "
                f"{row['certificates_s']:.3f} s, K1 {row['k1_launches']}, "
                f"K2 {row['k2_launches']}, K3 {row['k3_launches']}")
            if res["valid?"] is not False or w["valid?"] is not False or \
                    WORKLOAD_ANOMALY[kind] not in w.get("anomaly-types", ()):
                raise AssertionError(f"{kind} run: {res['valid?']}, "
                                     f"{w.get('anomaly-types')}")
            if n_ops != 2 * WORKLOAD_RUN["invocations"] + len(nem) or \
                    {o["f"] for o in nem} != {"start", "stop"}:
                raise AssertionError(f"{kind} run: {n_ops} ops, nemesis "
                                     f"{sorted({o['f'] for o in nem})}")
            if row["classifier_calls"] < 1 or row["k1_launches"] or \
                    row["k2_launches"] or row["k3_launches"] or any(
                        int(e) > 4096 for bk in buckets for e in bk):
                raise AssertionError(f"{kind} run: classifier calls "
                                     f"{row['classifier_calls']} {buckets}, "
                                     f"K1/K2/K3 {row['k1_launches']}/"
                                     f"{row['k2_launches']}/"
                                     f"{row['k3_launches']}")
            out[kind]["workload"] = w
        for kind, job in cpu.items():
            want, cpu_s = job.result()
            got = out[kind].pop("workload")
            if got != want:
                bad = sorted(k for k in set(got) | set(want)
                             if got.get(k) != want.get(k))
                raise AssertionError(f"{kind} run: {bad} differ from the "
                                     f"CPU path")
            out[kind]["cpu_s"] = cpu_s
    log(f"workloads: each result equal to the CPU path's (monotonic "
        f"{out['monotonic']['cpu_s']:.3f} s, sequential "
        f"{out['sequential']['cpu_s']:.3f} s); {len(slice_modules)} "
        f"modules of the slice imported")
    return out


def fake_module(name: str):
    """tests/<name>.py, loaded from its file once (the fakes import only
    the standard library and tests/netutil.py)."""
    import importlib.util
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def start_data_plane(kind: str) -> tuple:
    """The fake data plane of a suite run, started in the calling
    process (`data_planes`' child): (its port, a function that stops
    it)."""
    if kind == "hazelcast":
        from jepsen_tpu_torch.suites import cp_shim
        server, port = cp_shim.serve()
        return port, server.shutdown
    if kind == "etcd":
        fake = fake_module("fake_etcd").FakeEtcd()
        return fake.start(), fake.stop
    if kind in ("yugabyte", "raftis"):
        # tests/fake_cql.py and fake_resp.py import tests/netutil.py
        fake_module("netutil")
    name, cls = {"yugabyte": ("fake_cql", "FakeCQLServer"),
                 "dgraph": ("fake_dgraph", "FakeDgraph"),
                 "faunadb": ("fake_fauna", "FakeFauna"),
                 "raftis": ("fake_resp", "FakeRedis"),
                 "rabbitmq": ("fake_rabbitmq", "FakeRabbitMQ"),
                 "ignite": ("fake_es_ignite", "FakeIgnite")}[kind]
    fake = getattr(fake_module(name), cls)()
    return fake.port, fake.stop


def data_plane_child(kind: str, conn) -> None:
    """A spawned child serving one suite run's data plane: it sends its
    port, and stops when the parent says so or goes away."""
    port, stop = start_data_plane(kind)
    conn.send(port)
    try:
        conn.recv()
    except EOFError:
        pass
    stop()


def data_planes(kinds) -> dict:
    """Each kind's data plane in a spawned child process of its own
    (`start_data_plane`; the fake's server threads then do not share the
    interpreter's lock with the clients), all started at once: {kind:
    (its port, a function that stops and joins it)}."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    children = {}

    def stopper(proc, parent):
        def stop():
            try:
                parent.send("stop")
            except OSError:
                pass
            proc.join(DATA_PLANE_JOIN_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
            parent.close()
        return stop

    for kind in kinds:
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=data_plane_child, args=(kind, child),
                           name=f"data-plane-{kind}", daemon=True)
        proc.start()
        child.close()
        children[kind] = parent, stopper(proc, parent)
    out = {}
    try:
        for kind, (parent, stop) in children.items():
            if not parent.poll(DATA_PLANE_START_S):
                raise RuntimeError(f"{kind} data plane: no port in "
                                   f"{DATA_PLANE_START_S} s")
            out[kind] = parent.recv(), stop
    except BaseException:
        for _, stop in children.values():
            stop()
        raise
    return out


def suite_module(kind: str):
    import importlib
    return importlib.import_module(f"jepsen_tpu_torch.suites.{kind}")


def suite_opts(kind, dev, store_dir) -> dict:
    """The options a user gives the suite's CLI for its phase 14, 15 or
    16 run: SUITE_WORKLOADS' workload, 5 nodes, concurrency 10, the
    suite's partition nemesis and SUITE_OPTS."""
    return {"nodes": list(RUN_NODES), "ssh": {"dummy": True},
            "concurrency": SUITE_RUN["concurrency"],
            "workload": SUITE_WORKLOADS[kind], "store-dir": store_dir,
            "device": str(dev), **SUITE_OPTS[kind]}


def suite_wire(kind, port) -> dict:
    """The options pointing the suite's client at its data plane."""
    host = "127.0.0.1"
    url_fns = {"etcd": "client-url-fn", "hazelcast": "shim-url-fn",
               "rabbitmq": "mgmt-url-fn", "ignite": "ignite-url-fn"}
    if kind in url_fns:
        url = f"http://{host}:{port}"
        return {url_fns[kind]: lambda node: url}
    if kind == "raftis":
        from jepsen_tpu_torch.suites import resp_proto
        return {"resp-conn-fn": lambda node: resp_proto.Conn(host, port)}
    mod = suite_module(kind)
    if kind == "dgraph":
        return {"dgraph-conn-fn": lambda node: mod.DgraphConn(host, port)}
    if kind == "yugabyte":
        return {"cql-conn-fn": lambda node: mod.CQLConn(host, port)}
    return {"fauna-conn-fn": lambda node, linearized=False: mod.FaunaConn(
        host, port, linearized=linearized)}


def nemesis_op(f: str):
    """The op of f in a suite's nemesis schedule (SUITE_NEMESIS_FS): a
    start-partition cuts the nodes into two halves, in the grudge the
    nemeses of phase 15's and 16's suites take."""
    from jepsen_tpu_torch.nemesis import partition
    if f != "start-partition":
        return {"type": "info", "f": f, "value": None}
    return lambda test, ctx: {
        "type": "info", "f": f, "value": partition.complete_grudge(
            partition.bisect(list(test["nodes"])))}


def perf_maps(plot: dict) -> dict:
    """A test map's plot options with a combined nemesis package's perf
    specs, (name, start fs, stop fs, color) tuples, as the maps the perf
    checker reads (`checker/perf.py: nemesis_ops`; ROADMAP F9)."""
    return {**plot, "nemeses": [
        n if isinstance(n, dict) else {"name": n[0], "start": set(n[1]),
                                       "stop": set(n[2]), "color": n[3]}
        for n in plot.get("nemeses") or ()]}


def suite_invocations(kind) -> int:
    return {**SUITE2_INVOCATIONS, **SUITE3_INVOCATIONS}.get(
        kind, SUITE_RUN["invocations"])


def suite_run_test(kind, dev, store_dir, remote, port) -> dict:
    """The suite's own test map for phases 14-16: its generator
    replaced by `suite_invocations` of the workload's own generator
    without its pacing (dgraph's `gen.stagger(1/100, ...)` is stripped;
    faunadb's and yugabyte's are options, SUITE_OPTS sets them to 0)
    beside the bounded nemesis schedule (`cut_generator`), the remote,
    `db.noop`, `os_.noop`, the data plane at port, and the perf specs of
    `std_test`'s nemesis package in the form the perf checker reads
    (`perf_maps`)."""
    from jepsen_tpu_torch import db, os_
    from jepsen_tpu_torch import generator as gen
    mod = suite_module(kind)
    opts = suite_opts(kind, dev, store_dir)
    t = getattr(mod, f"{kind}_test")(opts)
    w = mod.WORKLOADS[opts["workload"]](opts)
    g = w["generator"]
    if kind == "dgraph":
        assert isinstance(g, gen.Stagger), g
        g = g.gen
    start, stop = map(nemesis_op, SUITE_NEMESIS_FS[kind])
    t.update({"remote": remote, "db": db.noop, "os": os_.noop,
              "plot": perf_maps(t.get("plot") or {}),
              **suite_wire(kind, port),
              "generator": cut_generator(g, suite_invocations(kind),
                                         start=start, stop=stop)})
    return t


def clocked(checker, clock: dict, key: str):
    """`checker` with the seconds its check takes written to clock[key]."""
    from jepsen_tpu_torch.checker import Checker

    class Clocked(Checker):
        def check(self, test, hist, opts):
            t0 = time.perf_counter()
            try:
                return checker.check(test, hist, opts)
            finally:
                clock[key] = time.perf_counter() - t0

    return Clocked()


def strip_volatile(r):
    """A result without the fields that name where and how long it ran,
    and without a dense walk's host syncs: K3 reads the host once a
    window (each K3 walk held to that by `WalkSyncs.hold` on the card),
    the CPU path's eager walk every round."""
    if isinstance(r, dict):
        group = r.get("group")
        dense = str(r.get("analyzer", "")).startswith("gpu-wgl-dense") or (
            isinstance(group, list) and group[:1] == ["dense"])
        return {k: strip_volatile(v) for k, v in r.items()
                if k not in SUITE_VOLATILE
                and not (dense and k == "host-syncs")}
    return r


def cpu_suite_check(kind: str, run_dir: str) -> tuple:
    """Phases 14-16's CPU path in a worker process: a card run's
    stored history (a keyed run's KVs re-wrapped, ROADMAP F6) checked by
    the suite's own workload checker on the CPU (its timelines written
    to a scratch store). Returns the result without its volatile
    fields, and the seconds it took."""
    import tempfile

    from jepsen_tpu_torch import independent, store
    t = time.perf_counter()
    hist = store.load_test(run_dir)["history"]
    opts = suite_opts(kind, "cpu", None)
    threads = torch.get_num_threads()
    if kind not in UNKEYED:
        hist = rekeyed(independent, hist)
    if kind == "etcd":
        # the phase's last check, alone in the pool for most of its run:
        # the batched walk takes the other worker's share of the cores
        torch.set_num_threads(CPU_WORKERS * CPU_WORKER_THREADS)
    try:
        with tempfile.TemporaryDirectory(prefix="cpu-check-") as d:
            r = suite_module(kind).WORKLOADS[opts["workload"]](opts)[
                "checker"].check({"name": "cpu-check", "store-dir": d},
                                 hist, {})
    finally:
        torch.set_num_threads(threads)
    return strip_volatile(r), time.perf_counter() - t


def key_walks(results: dict) -> dict:
    """The kernel work behind an independent check's per-key results: a
    bare linearizability subchecker's keys share batched walks, each
    counted once (`walk_totals`); a compose's keys are walked one by
    one, and their linearizability results' counts add up."""
    lin = []
    for r in results.values():
        lin += [r] if "analyzer" in r else [
            s for s in r.values() if isinstance(s, dict) and "analyzer" in s]
    batched = [r for r in lin if "batch-walk" in r]
    alone = [r for r in lin if "batch-walk" not in r]
    tot = walk_totals(batched)
    for ours, theirs in (("closure_rounds", "closure-rounds"),
                         ("dedup_launches", "dedup-launches"),
                         ("host_syncs", "host-syncs")):
        tot[ours] += sum(r.get(theirs, 0) for r in alone)
    tot["keys_alone"] = len(alone)
    tot["analyzers"] = sorted({f"{r['analyzer']} {r.get('dedup')}"
                               for r in alone})
    return tot


def drive_suite(kind, dev, root, pool,
                port, stop) -> tuple:
    """One suite run of phases 14-16 through the port's core.run on
    the card against the data plane at port (stopped when the run
    ends), with every kernel's launch count set to 0 just before and
    read just after; its stored history goes to the CPU path in the
    pool. Returns the run's row (with its workload result) and the CPU
    path's job."""
    from jepsen_tpu_torch import core, store
    from jepsen_tpu_torch import generator as gen
    remote = getent_remote()
    try:
        with gen.fixed_rng(SEED):
            t = suite_run_test(kind, dev, root, remote, port)
        # the compose's check, and the workload's check on the card
        # within it, each on its own clock
        clock = {}
        compose = t["checker"]
        compose.checkers["workload"] = clocked(
            compose.checkers["workload"], clock, "workload_check_s")
        t["checker"] = clocked(compose, clock, "check_s")
        zero_launches()
        t0 = time.perf_counter()
        done = core.run(t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        t1 = time.perf_counter()
        stop()
        stop_s = time.perf_counter() - t1
    run_dir = os.path.dirname(store.path(done, "results.json"))
    job = pool.submit(cpu_suite_check, kind, run_dir)
    res = done["results"]
    run_stamps(f"{kind} suite run", res)
    n_ops, rate = interpreter_rate(done["history"])
    nem = [o for o in done["history"] if o["process"] == "nemesis"]
    cut = [a for _, _, a in remote.log if "iptables" in a.get("cmd", "")]
    w = res["workload"]
    # the interpreter's span on the run's own relative clock: its latest
    # history op's time
    interp_s = max(o["time"] for o in done["history"]) / 1e9
    row = dict(name=done["name"], run_dir=run_dir, wall_s=wall,
               interpreter_s=interp_s, check_s=clock["check_s"],
               workload_check_s=clock["workload_check_s"], ops=n_ops,
               ops_per_s=rate, nemesis_ops=len(nem), iptables=len(cut),
               **launches, valid=w["valid?"], plane_stop_s=stop_s)
    if kind in UNKEYED:
        row.update({f: w.get(f) for f in (
            "analyzer", "dedup", "frontier-size", "max-frontier",
            "dense-shape", "closure-rounds", "dedup-launches",
            "host-syncs")})
        detail = (f"{w.get('analyzer')} {w.get('dedup')}, frontier-size "
                  f"{w.get('frontier-size')}, max-frontier "
                  f"{w.get('max-frontier')}, shape {w.get('dense-shape')}")
        want = (w.get("closure-rounds"), w.get("dedup-launches"))
    else:
        tot = key_walks(w["results"])
        row.update(keys=len(w["results"]), **tot)
        detail = (f"{len(w['results'])} keys, batched groups "
                  f"{tot['groups']}, {tot['keys_alone']} keys walked "
                  f"alone {tot['analyzers']}")
        want = (tot["closure_rounds"], tot["dedup_launches"])
    # a run walks with K3 whichever family its keys go to, but the one
    # register of hazelcast's may go to the sort family; K3's rounds are
    # the walks' count, and K1 never launches alone
    walked = row["k3_launches"] > 0 or (kind == "hazelcast"
                                        and row["k2_launches"] > 0)
    launched = walked and row["k1_launches"] == 0 and (
        row["k3_rounds"], row["k2_launches"]) == want
    log(f"suite {kind}: valid?={res['valid?']} ({detail}), {n_ops} "
        f"history ops ({rate:.0f} client ops/s), {len(nem)} nemesis ops, "
        f"{len(cut)} iptables commands, wall {wall:.3f} s (interpreter "
        f"{interp_s:.3f} s, check {row['check_s']:.3f} s, of which the "
        f"workload's on the card {row['workload_check_s']:.3f} s), K3 "
        f"launches {row['k3_launches']} ({row['k3_rounds']} rounds), K2 "
        f"launches {row['k2_launches']}; "
        f"data plane stopped in {stop_s:.3f} s")
    if res["valid?"] is not True or w["valid?"] is not True:
        raise AssertionError(f"{kind} suite run: {res['valid?']}, "
                             f"workload {w['valid?']}")
    fs = set(SUITE_NEMESIS_FS[kind])
    if n_ops != 2 * suite_invocations(kind) + len(nem) or \
            {o["f"] for o in nem} != fs or not cut:
        raise AssertionError(f"{kind} suite run: {n_ops} ops, nemesis "
                             f"{sorted({o['f'] for o in nem})}, {len(cut)} "
                             f"iptables commands")
    if not launched:
        raise AssertionError(f"{kind} suite run: K1/K2/K3 launches "
                             f"{row['k1_launches']}/{row['k2_launches']}/"
                             f"{row['k3_launches']}, K3 rounds "
                             f"{row['k3_rounds']} ({detail})")
    row["workload"] = strip_volatile(w)
    return row, job


def same_as_cpu(out: dict, jobs: dict) -> None:
    """Each run's workload result against its CPU path's, whole."""
    for kind, job in jobs.items():
        want, cpu_s = job.result()
        got = out[kind].pop("workload")
        if got != want:
            bad = sorted(k for k in set(got) | set(want)
                         if got.get(k) != want.get(k))
            raise AssertionError(f"{kind} suite run: {bad} differ from "
                                 f"the CPU path")
        out[kind]["cpu_s"] = cpu_s
    log("suite runs equal to the CPU path's: " + ", ".join(
        f"{kind} ({out[kind]['cpu_s']:.3f} s)" for kind in jobs))


def drive_suites(kinds, dev, root, pool) -> tuple:
    """`drive_suite` for each kind in turn, every data plane started at
    once first: the rows, and the CPU path's jobs."""
    out, cpu = {}, {}
    t0 = time.perf_counter()
    planes = data_planes(kinds)
    log(f"data planes {', '.join(kinds)}: up in "
        f"{time.perf_counter() - t0:.3f} s")
    try:
        for kind in kinds:
            out[kind], cpu[kind] = drive_suite(
                kind, dev, root, pool,
                *planes.pop(kind))
    finally:
        for _, stop in planes.values():
            stop()
    return out, cpu


def phase_suites(dev, pool, root) -> tuple:
    """Phase 14: the etcd and hazelcast suites' own test maps through the
    port's core.run on the card against their fakes, their runs stored
    under root (`drive_suites`); then the port's web UI over root. It
    also imports every module of the slice, so the script's closing
    guard covers them. Returns the rows and the CPU path's jobs, which
    `same_as_cpu` holds the rows against after phase 16's runs (the
    pool works through them beside phases 15 and 16's runs)."""
    import urllib.request

    from jepsen_tpu_torch import cli, repl, web
    from jepsen_tpu_torch.suites import (aerospike, as_proto, bson_proto,
                                         cockroach, cp_shim, etcd,
                                         hazelcast, mongodb, mysql_proto,
                                         netutil, pg_proto, tidb)
    slice_modules = [m.__name__ for m in (
        aerospike, as_proto, bson_proto, cockroach, cp_shim, etcd,
        hazelcast, mongodb, mysql_proto, netutil, pg_proto, tidb, web,
        repl)] + [f"{cli.__name__}.{cli.main.__name__}"]
    # hazelcast first: its CPU check, one register walked on the plain
    # path, is the longer one
    out, cpu = drive_suites(("hazelcast", "etcd"), dev, root, pool)
    out["modules"] = slice_modules

    # -- the web UI over the phase's store -------------------------------
    server = web.serve({"host": "127.0.0.1", "port": 0, "store-dir": root})
    base = f"http://127.0.0.1:{server.server_address[1]}"
    run_dir = out["hazelcast"]["run_dir"]
    try:
        t0 = time.perf_counter()
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            page = r.read().decode()
        run = os.path.relpath(run_dir, root)
        with urllib.request.urlopen(
                f"{base}/files/{run}/results.json", timeout=30) as r:
            served = r.read()
        serve_s = time.perf_counter() - t0
    finally:
        server.shutdown()
    with open(os.path.join(run_dir, "results.json"), "rb") as f:
        stored = f.read()
    listed = [out[k]["name"] for k in ("etcd", "hazelcast")
              if out[k]["name"] in page]
    out["serve"] = dict(listed=listed, page_bytes=len(page),
                        results_bytes=len(served), wall_s=serve_s)
    log(f"suite serve: the home page ({len(page)} bytes) lists "
        f"{listed}; {run}/results.json served, {len(served)} bytes, "
        f"the run's: {served == stored}; {serve_s:.3f} s")
    if len(listed) != 2 or served != stored or \
            json.loads(served)["valid?"] is not True:
        raise AssertionError(f"serve: lists {listed}, results.json "
                             f"the run's: {served == stored}")
    log(f"suites: {len(slice_modules)} modules of the slice imported")
    return out, cpu


def phase_suites2(dev, pool, root) -> tuple:
    """Phase 15: the dgraph linearizable-register, yugabyte
    ycql/single-key-acid and faunadb register maps, each the suite's
    own (client, checker compose, partition nemesis), through the
    port's core.run on the card against tests/fake_dgraph.py,
    fake_cql.py and fake_fauna.py, their runs stored under root
    (`drive_suites`). It imports all seven modules of the slice, so the
    script's closing guard covers them. Returns the rows and the CPU
    path's jobs, as `phase_suites` does."""
    from jepsen_tpu_torch.suites import (cql_proto, dgraph, fauna_query,
                                         faunadb, reql_proto, rethinkdb,
                                         yugabyte)
    slice_modules = [m.__name__ for m in (
        cql_proto, yugabyte, fauna_query, faunadb, dgraph, reql_proto,
        rethinkdb)]
    # the longest CPU checks first, so that they run beside the later runs
    out, cpu = drive_suites(("faunadb", "yugabyte", "dgraph"), dev, root,
                            pool)
    out["modules"] = slice_modules
    log(f"suites2: {len(slice_modules)} modules of the slice imported")
    return out, cpu


def phase_suites3(dev, pool, root) -> tuple:
    """Phase 16: the raftis register, rabbitmq mutex and ignite register
    maps, each the suite's own (client, checker compose, partition
    nemesis), through the port's core.run on the card against
    tests/fake_resp.py's FakeRedis, fake_rabbitmq.py and
    fake_es_ignite.py's FakeIgnite, their runs stored under root
    (`drive_suites`). It imports all nineteen modules of the slice, so
    the script's closing guard covers them; zookeeper, consul and
    mongodb-smartos have fakes that import the JAX package, so they run
    only in the tests. Returns the rows and the CPU path's jobs, as
    `phase_suites` does."""
    from jepsen_tpu_torch.suites import (chronos, consul, crate, disque,
                                         elasticsearch, galera, ignite,
                                         logcabin, mongodb_smartos,
                                         mysql_cluster, percona,
                                         postgres_rds, rabbitmq, raftis,
                                         resp_proto, robustirc, stolon,
                                         zk_proto, zookeeper)
    slice_modules = [m.__name__ for m in (
        resp_proto, raftis, disque, rabbitmq, ignite, elasticsearch, crate,
        chronos, galera, percona, mysql_cluster, stolon, postgres_rds,
        logcabin, robustirc, mongodb_smartos, zk_proto, zookeeper,
        consul)]
    # the longest CPU checks first, so that they run beside the later runs
    out, cpu = drive_suites(("raftis", "ignite", "rabbitmq"), dev, root,
                            pool)
    out["modules"] = slice_modules
    log(f"suites3: {len(slice_modules)} modules of the slice imported")
    return out, cpu


def write_report(path, report) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, default=str)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import _build

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(f"nvidia-smi: {smi}")
    phase_s = {}
    mark = [time.perf_counter()]

    def phase_done(label):
        if _WALK_SYNCS is not None:
            _WALK_SYNCS.hold()
        now = time.perf_counter()
        phase_s[label] = now - mark[0]
        mark[0] = now
        log(f"phase {label}: {phase_s[label]:.1f} s")

    # -- phase 1: build -------------------------------------------------------
    build_logs = _build.build()
    for src, text in build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                        "spill", "error")):
                log(f"ptxas[{src}]: {line.strip()}")
    log(f"built {sorted(build_logs) or 'nothing (fresh)'}")
    phase_done("build")

    # the CPU checks of phases 4, 6, 8, 9 and 11-16 run in worker
    # processes (spawned: this process holds a CUDA context) beside the
    # card's runs; those that need nothing of the card's runs start now:
    # phase 8's dense stream, the main path's agreement runs and phase
    # 6's two batches
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=CPU_WORKERS, initializer=cpu_worker_init,
        mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_dense = pool.submit(cpu_dense_prefix)
        cpu_agree = pool.submit(cpu_agreement)
        cpu_batches = {kind: pool.submit(cpu_batch, kind)
                       for kind in ("dense", "sort")}
        return run_phases(args, dev, name, smi, phase_s, phase_done, pool,
                          cpu_dense, cpu_batches, cpu_agree)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_phases(args, dev, name, smi, phase_s, phase_done, pool, cpu_dense,
               cpu_batches, cpu_agree) -> int:
    """Phases 2-17 of `main`, given the worker pool and its first jobs."""
    from jepsen_tpu_torch import (_platform, graft_entry, independent,
                                  models, parallel, service, store,
                                  telemetry)
    from jepsen_tpu_torch.carry import carry_to_numpy
    from jepsen_tpu_torch.checker import (linear, screen, streaming, synth,
                                          wgl, wgl_closure, wgl_dedup,
                                          wgl_walk)
    from jepsen_tpu_torch.checker.elle import kernels as elle_kernels
    from jepsen_tpu_torch.checker.elle import list_append, wr
    from jepsen_tpu_torch.checker.linear import linearizable

    ws = walk_syncs()

    # -- phase 2: K1 against its plain version --------------------------------
    runs = main_path_runs(models, synth)
    hists = {label: (model, hist) for label, model, hist, *_ in runs}
    real = real_k1_inputs(wgl, *hists["at-cap-dense"], dev, PROFILE_STEPS)
    k1 = phase_k1(dev, wgl_closure, real)
    phase_done("K1 against its plain version")

    # -- phase 3: K2 against its plain version --------------------------------
    k2 = phase_k2(dev, wgl_dedup)
    phase_done("K2 against its plain version")
    del real

    # -- phase 4: the main path -------------------------------------------------
    results = {}
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    for label, model, hist, kw, expect in runs:
        before, snap = launch_counts(), ws.snap()
        t = time.perf_counter()
        r = linearizable(model, **kw).check({}, hist, {})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        results[label] = dict(r, wall_s=wall, walk_reads=ws.since(snap),
                              **launches)
        log(f"{label}: valid?={r['valid?']} op-index={r.get('op-index')} "
            f"analyzer={r['analyzer']} dedup={r['dedup']} frontier-size="
            f"{r['frontier-size']} shape={r.get('dense-shape')} "
            f"max-frontier={r['max-frontier']} wall={wall:.3f} s K1 "
            f"launches={launches['k1_launches']} K2 launches="
            f"{launches['k2_launches']} K3 launches="
            f"{launches['k3_launches']} (rounds {launches['k3_rounds']}) "
            f"closure rounds={r['closure-rounds']} host syncs="
            f"{r['host-syncs']} error={r.get('error')}")
        check_run(label, r, launches, expect)
    no_stamps("main path", list(results.values()))
    main_launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    phase_done("main path")

    # -- agreement with the port's CPU path -----------------------------------
    # (agreement_runs); the CPU path's checks and final carries ran in a
    # worker process from the end of phase 1 on
    cpu_results, cpu_side = {}, cpu_agree.result()
    for label, model, hist, kw in agreement_runs(models, synth,
                                                 hists["headline"][1]):
        t0 = time.perf_counter()
        g = results.get(label)
        if g is None:
            snap = ws.snap()
            g = dict(linearizable(model, **kw).check({}, hist, {}),
                     walk_reads=ws.since(snap))
        c, cc, cpu_s, c_eager = cpu_side[label]
        cpu_results[label] = c
        dense = c["analyzer"] == "gpu-wgl-dense"
        for key in ("valid?", "op-index", "max-frontier", "frontier-size",
                    "dedup", "analyzer", "dense-shape", "closure-rounds",
                    "dedup-launches") + (() if dense else ("host-syncs",)):
            if g.get(key) != c.get(key):
                raise AssertionError(f"{label}: {key} gpu {g.get(key)} "
                                     f"!= cpu {c.get(key)}")
        if dense:
            same_syncs_but_walks(label, g["host-syncs"],
                                 sum(g["walk_reads"]["k3"].values()),
                                 c["host-syncs"], c_eager)
        ckw = {k: v for k, v in kw.items() if k != "max_frontier"}
        cg = final_carry(wgl, carry_to_numpy, model, hist, dev, **ckw)
        for i, (a, b) in enumerate(zip(cg, cc)):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"{label}: carry element {i} differs")
        log(f"{label}: GPU and CPU agree (verdict {c['valid?']}, "
            f"op-index {c.get('op-index')}, max-frontier "
            f"{c['max-frontier']}, {c['analyzer']} {c['dedup']}, counts, "
            f"final carry of {len(cg)} elements; CPU path {cpu_s:.3f} s "
            f"in a worker process, label {time.perf_counter() - t0:.3f} "
            f"s)")
    phase_done("agreement with the CPU path")

    # -- where the time goes: the device's busy share ------------------------
    profiles = {}
    for label, kw in (("headline", {}),
                      ("adversarial-dense", {"engine": "dense"}),
                      ("at-cap-dense", {"engine": "dense"}),
                      ("phantom", {})):
        walk = prefix_walk(wgl, *hists[label], dev, **kw)
        profiles[label] = pr = profile_walk(walk, PROFILE_WALK_STEPS)
        log(f"profile {label}, first {PROFILE_WALK_STEPS} steps: wall "
            f"{pr['wall_s']:.4f} s, device busy "
            f"{pr['device_busy_s']:.4f} s ({100 * pr['busy_share']:.2f}"
            f"%), {pr['kernel_launches']} kernel launches "
            f"({pr['kernel_launches'] / PROFILE_WALK_STEPS:.1f} per step); top "
            f"{pr['top']}")
    phase_done("profile")

    # -- phase 4b: K3 against the eager walk, its plain version ------------
    k3 = phase_k3(dev, models, synth, wgl, streaming, carry_to_numpy,
                  hists["headline"][1])
    phase_done("K3 against the eager walk")

    # -- phase 5: K1 and K2 with a batch axis ---------------------------------
    k1b = phase_k1_batched(dev, wgl_closure)
    k2b = phase_k2_batched(dev, wgl_dedup)
    phase_done("batched K1 and K2 against their plain versions")

    # -- phase 6: the batch path, on the card and against the CPU -------------
    batch = phase_batch(dev, models, synth, wgl, wgl_dedup,
                        independent, linearizable, _platform, carry_to_numpy,
                        cpu_batches)
    phase_done("batch path")

    # -- phase 7: Elle ------------------------------------------------------------
    elle = phase_elle(dev, synth, elle_kernels, list_append, wr, _platform)
    phase_done("elle")

    # -- phase 8: streaming, the tier and the race ----------------------------
    streams = phase_stream(dev, models, synth, wgl, streaming, screen,
                           linear, wr, _platform, carry_to_numpy,
                           cpu_results["headline"], pool, cpu_dense)
    phase_done("streaming, tier and race")

    # -- phase 9: the verification service ------------------------------------
    svc = phase_service(dev, models, synth, streaming, service, store,
                        telemetry, _platform, pool)
    phase_done("verification service")

    # -- phase 10: key-sharded checking, the Elle mesh, the entries ---------
    sharded = phase_sharded(dev, models, synth, wgl, elle_kernels,
                            list_append, _platform, parallel,
                            graft_entry, batch, elle, smi)
    phase_done("sharded checking")

    # -- phase 11: the scenario search and the self-chaos harness ------------
    # the CPU runs take less time in the workers than the card's runs in
    # this process, so they start with the phase. The chaos harness
    # collects garbage before each schedule's resource snapshot: the
    # earlier phases' heap is frozen out of those collections, as a
    # chaos run on its own would not have it
    import gc
    gc.freeze()
    search_chaos = phase_search_chaos(dev, cpu_search_chaos_jobs(pool))
    phase_done("search and chaos")

    # -- phase 12: the run path -----------------------------------------------
    run_path = phase_run(dev, pool)
    phase_done("run path")

    # -- phase 13: the monotonic and sequential workloads -----------------
    run_path["workloads"] = phase_workloads(dev, elle_kernels, pool)
    phase_done("workloads")

    import tempfile
    with tempfile.TemporaryDirectory(prefix="suites-") as root:
        # -- phase 14: the etcd and hazelcast suites' own maps, the web UI -
        suites, suites_cpu = phase_suites(dev, pool,
                                          root)
        phase_done("suites")

        # -- phase 15: the dgraph, yugabyte and faunadb suites' registers --
        # phase 14's CPU checks run in the pool beside these runs
        suites2, suites2_cpu = phase_suites2(dev, pool, root)
        phase_done("suites 2")

        # -- phase 16: the raftis register, rabbitmq mutex, ignite register
        # phases 14 and 15's CPU checks run in the pool beside these runs;
        # the three phases' runs are held against theirs after them
        suites3, suites3_cpu = phase_suites3(dev, pool, root)
        same_as_cpu(suites, suites_cpu)
        same_as_cpu(suites2, suites2_cpu)
        same_as_cpu(suites3, suites3_cpu)
    phase_done("suites 3, and the three suite phases' CPU checks")
    log(f"phases: {sum(phase_s.values()):.1f} s in all")

    if any(m == "jax" or m.startswith("jax.") or m == "jepsen_tpu"
           or m.startswith("jepsen_tpu.") for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")

    k1_main = k1["shapes"][2]             # the at-cap shape, (8, 19)
    k1_real = k1["shapes"][-1]            # the real table at (8, 19)
    k2_main = k2["shapes"][2]             # stage B at F=256, P=16
    kernels = [{
        "name": "closure_round",
        "route": "cuda",
        "source": wgl_closure.SOURCE,
        "replaces": wgl_closure.REPLACES,
        # K1's standalone launches: on every walk its round runs inside
        # K3, so these are 0 wherever a walk is counted
        "launches": main_launches["k1_launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1_main["ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": None,
        "shape": [k1_main["S"], k1_main["P"]],
        "stream_launches": streams["dense"]["k1_launches"]
        + streams["dense-recovery"]["k1_launches"],
        "service_launches": svc["launches"]["k1_launches"],
        # phase 12's unbatched K1: the online and abort streams and the
        # CLI's single-register checks
        "run_launches": sum(run_path[r]["k1_launches"] for r in (
            "online", "abort", "cli-test", "cli-analyze")),
        # phase 14's single-register check (the hazelcast suite's map)
        "suite_launches": suites["hazelcast"]["k1_launches"],
        # phase 15's per-key checks walked alone (the yugabyte and
        # faunadb registers' composes)
        "suite2_launches": sum(suites2[k]["k1_launches"]
                               for k in ("yugabyte", "faunadb")),
        # phase 16's single-object checks (the raftis register and the
        # rabbitmq mutex)
        "suite3_launches": sum(suites3[k]["k1_launches"]
                               for k in ("raftis", "rabbitmq")),
        "stream_shape": [k1["shapes"][3]["S"], k1["shapes"][3]["P"]],
        "stream_shape_ms": k1["shapes"][3]["ms"],
        "stream_shape_bound_ms": k1["shapes"][3]["bound_ms"],
        "real_table_ms": k1_real["ms"],
        "real_table_bound_ms": k1_real["bound_ms"],
        "shapes": k1["shapes"],
    }, {
        "name": "dedup",
        "route": "cuda",
        "source": wgl_dedup.SOURCE,
        "replaces": wgl_dedup.REPLACES,
        "launches": main_launches["k2_launches"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2_main["ms"],
        "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"],
        "bound_by": k2_main["bound_by"],
        # torch.unique computes a different function (key order, no new
        # flags, no digest): no PyTorch call computes K2's
        "library_ms": None,
        "unique_ms": k2_main["unique_ms"],
        "stream_launches": streams["sort-abort"]["k2_launches"],
        "service_launches": svc["launches"]["k2_launches"],
        "run_launches": sum(run_path[r]["k2_launches"] for r in (
            "online", "abort", "cli-test", "cli-analyze")),
        "suite_launches": suites["hazelcast"]["k2_launches"],
        "suite2_launches": sum(suites2[k]["k2_launches"]
                               for k in ("yugabyte", "faunadb")),
        "suite3_launches": sum(suites3[k]["k2_launches"]
                               for k in ("raftis", "rabbitmq")),
        "shape": [k2_main["N"], k2_main["F"]],
        "shapes": k2["shapes"],
    }]
    # K3, the dense step walk: ms is its device time a launch (a window of
    # up to 1,024 steps) on the headline, plain_ms the eager walk's wall
    # over the same windows, bound_ms k3_bound's over the same windows
    hl = k3["walks"]["headline"]
    hp = k3["profiles"]["headline"]["k3_full"]
    kernels.append({
        "name": "dense_walk", "route": "cuda", "source": wgl_walk.SOURCE,
        "replaces": wgl_walk.REPLACES,
        "launches": main_launches["k3_launches"],
        "rounds": main_launches["k3_rounds"],
        "max_abs_err": max(w["max_abs_err"] for w in k3["walks"].values()),
        "ms": hp["k3_ms"] / hp["k3_launches"],
        "plain_ms": hl["eager_wall_s"] * 1e3 / hl["k3_launches"],
        "bound_ms": hl["bound_ms"] / hl["k3_launches"],
        "bound_by": hl["bound_by"], "library_ms": None,
        "shape": [hl["S"], hl["P"]],
        "walk_ms": hl["k3_wall_s"] * 1e3,
        "plain_walk_ms": hl["eager_wall_s"] * 1e3,
        "stream_launches": sum(streams[k]["k3_launches"]
                               for k in ("dense", "dense-recovery")),
        "service_launches": svc["launches"]["k3_launches"],
        "run_launches": sum(run_path[r]["k3_launches"] for r in (
            "online", "abort", "cli-test", "cli-analyze")),
        "suite_launches": suites["hazelcast"]["k3_launches"],
        "suite2_launches": sum(suites2[k]["k3_launches"]
                               for k in ("yugabyte", "faunadb")),
        "suite3_launches": sum(suites3[k]["k3_launches"]
                               for k in ("raftis", "rabbitmq")),
        "walks": k3["walks"]})
    # batched: the hazelcast batch's largest group (64 rows of 8 x 2^6)
    hb = max((w for w in k3["walks"].values() if "keys" in w),
             key=lambda w: w["keys"])
    hbp = k3["profiles"]["hazelcast largest group"]["k3_full"]
    kernels.append({
        "name": "dense_walk_batched", "route": "cuda",
        "source": wgl_walk.SOURCE,
        # the same walk under jax.vmap (check_chunk_batch)
        "replaces": wgl_walk.REPLACES,
        "launches": batch["dense"]["k3_launches"],
        "rounds": batch["dense"]["k3_rounds"],
        "max_abs_err": hb["max_abs_err"],
        "ms": hbp["k3_ms"] / hbp["k3_launches"],
        "plain_ms": hb["eager_wall_s"] * 1e3 / hb["k3_launches"],
        "bound_ms": hb["bound_ms"] / hb["k3_launches"],
        "bound_by": hb["bound_by"], "library_ms": None,
        "shape": [hb["keys"], hb["S"], hb["P"]],
        "walk_ms": hb["k3_wall_s"] * 1e3,
        "plain_walk_ms": hb["eager_wall_s"] * 1e3,
        "sharded_launches": sharded["world1"]["hazelcast"]["k3_launches"],
        "search_launches": search_chaos["search-batch"]["k3_launches"],
        "run_launches": run_path["register"]["k3_launches"],
        "suite_launches": suites["etcd"]["k3_launches"],
        "suite2_launches": suites2["dgraph"]["k3_launches"],
        "suite3_launches": suites3["ignite"]["k3_launches"]})
    # the batched launches: K1 at the hazelcast batch's largest group
    # (64 tables of 8 x 2^6), K2 at the counter batch's stage B
    k1b_main = next(r for r in k1b["shapes"] if r["B"] == 64)
    k2b_main = k2b["shapes"][-1]
    for kname, mod, row, err, launches, shape in (
            ("closure_round_batched", wgl_closure, k1b_main,
             k1b["max_abs_err"], batch["dense"]["k1_launches"],
             [k1b_main["B"], k1b_main["S"], k1b_main["P"]]),
            ("dedup_batched", wgl_dedup, k2b_main, k2b["max_abs_err"],
             batch["sort"]["k2_launches"],
             [k2b_main["B"], k2b_main["N"], k2b_main["F"]])):
        kernels.append({
            "name": kname, "route": "cuda", "source": mod.SOURCE,
            # the same TPU kernel, under jax.vmap in the batch entry
            "replaces": mod.REPLACES, "launches": launches,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "scalar_turns_ms": row["scalar_turns_ms"],
            "sharded_launches": sharded["world1"][
                "hazelcast" if mod is wgl_closure else "counter"][
                "k1_launches" if mod is wgl_closure else "k2_launches"],
            # the search's batch escalation (phase 11)
            "search_launches": search_chaos["search-batch"][
                "k1_launches" if mod is wgl_closure else "k2_launches"],
            # the register run's independent check (phase 12)
            "run_launches": run_path["register"][
                "k1_launches" if mod is wgl_closure else "k2_launches"],
            # the etcd suite's independent check (phase 14)
            "suite_launches": suites["etcd"][
                "k1_launches" if mod is wgl_closure else "k2_launches"],
            # the dgraph suite's independent check (phase 15)
            "suite2_launches": suites2["dgraph"][
                "k1_launches" if mod is wgl_closure else "k2_launches"],
            # the ignite suite's independent check (phase 16)
            "suite3_launches": suites3["ignite"][
                "k1_launches" if mod is wgl_closure else "k2_launches"],
            "shape": shape,
            "shapes": (k1b if mod is wgl_closure else k2b)["shapes"]})
    if args.out:
        write_report(args.out, {
            "device": name, "nvidia_smi": smi, "phase_s": phase_s,
            "peak_gb": peak_gb, "kernels": kernels,
            "profiles": profiles, "k3": k3, "batch": batch,
            "elle": {k: v for k, v in elle.items()
                     if not k.startswith("g1c_")},
            "streams": streams, "service": svc, "sharded": sharded,
            "search_chaos": search_chaos, "run_path": run_path,
            "suites": suites, "suites2": suites2, "suites3": suites3,
            "main_path": {k: {f: v for f, v in r.items()
                              if f not in ("configs", "final-paths", "op",
                                           "previous-ok")}
                          for k, r in results.items()}})
    log(f"peak device memory on the main path: {peak_gb:.3f} GiB")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
