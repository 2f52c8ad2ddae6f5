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
     dense step walk, and each sort walk K3-sort, the sort step walk,
     whose reported rounds and hash dedups are the result's
     closure-rounds and dedup-launches; never K1 or K2 alone); then hold
     verdicts, culprit ops, counts (a walk's host syncs are its
     kernel's, fewer than the CPU path's) and final carries against the
     port's own CPU path (run in a worker process from the end of phase
     1 on), and trace the first 250 steps of four walks with
     torch.profiler for the device's busy share; the adversarial and
     concurrency-11 escalations are printed pass by pass (F, route,
     path, steps, launches, wall and K3-sort's phase split:
     `SortPasses`);
 4b. hold K3 against the eager walk, its plain version, on the card: the
     headline, the adversarial and concurrency-11 histories forced
     dense, the hazelcast batch's four dense groups (batched), the dense
     stream's first three chunks and a rabbitmq-shaped mutex (S = 4,
     P = 3), each with its final carry equal element for element, its
     rounds equal and its tier the expected one (a warp a key: the
     headline, the mutex and the hazelcast groups up to P = 6; a block:
     the groups at P = 8 and 10, the adversarial walk and the dense
     stream; a thread-block cluster: the concurrency-11 walk); each
     walk's wall both ways with host syncs and
     launches, and torch.profiler traces of the headline and the
     hazelcast batch's largest group (both ways on the profile prefix,
     K3 over the whole walk) for the device's busy share; then K3-sort
     against the eager walk the same way (`phase_k3s`): the phantom and
     counter walks whole (hash route), the concurrency-11 history at
     F = 256 and 4,096 (lexicographic route) and the adversarial one's
     F = 65,536 pass on a prefix (packed sort), the counter batch's sort
     group (batched), the sort-abort stream's first three chunks and the
     chaos workload's shape (8 slots, F = 128), carries, rounds and hash
     dedups equal, walls, syncs and launches both ways, each walk's phase
     split (`wgl_sortwalk.PHASE_NS`: where each key's device time went,
     step by step) and `PASS_ROWS / ROWS`, the library yardstick
     (`torch.sort(stable=True)` of one dedup's keys at the adversarial
     and at-cap N, beside K3-sort's ms a dedup), and profiles of the
     phantom walk;
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
     route (two corrupted, K3-sort batched), with every
     kernel's launch count set to 0 just before each run and read just
     after; then the dense batch again under an injected OOM (the
     ladder's split); then hold verdicts, culprit ops, counts and each
     group's final batched carry against the port's CPU path (run in a
     worker process from the end of phase 1 on), and trace
     the first 300 lockstep steps of each batch's largest group;
  7. the Elle phase: the batched SCC classifier on random 0/1 buckets
     (e = 8 to 2,048) through K4 (one K4-small launch a bucket up to
     e = 256, K4-product's chain of bf16 tensor-core squarings above)
     against its CPU path, its numpy mirror and its plain chain on the
     card, every residue 0, K4 and the plain chain timed in turns (both
     K4 kernels at e = 256 and 512), the plain chain's device operations
     from a profiler trace, torch.bmm in bf16 of one product (the
     library yardstick) and the bound; one K4-product squaring of the
     rings' (4, 4,096) stack against the plain step; then, with K4's
     launch counts set to 0 just before and read just after (both K4
     kernels must launch): the north-star list-append history (100,000
     txns), valid with no classifier call, then with 64 injected G1c
     cycles, equal to the CPU path's result; the 10,000-txn rw-register
     history, plain and with the realtime and process graphs; three
     disjoint 4,000-node rings (G0, G-single, G2-item) in one 4,096-wide
     bucket, K4 and the plain chain timed beside the bound, and
     1,000-node rings against the CPU path; the G1c history again under
     an injected OOM (one retry, the same result);
  8. the streaming-and-tier phase, five runs at full size: the
     adversarial history streamed on the dense engine (16 slots, K3 at
     (8, 16)); a register history with a phantom read streamed op by op
     on the sort engine's hash route (K2) until the violation shows; the
     dense stream again with a checkpoint every 2 chunks under a device
     loss injected at its midpoint chunk (one retry, the same result);
     the 10,000-txn rw-register history through WrStream; and the
     headline at tier 'screen' (sample 0 and 1) and under the
     competition race. Every kernel's launch count is set to 0 just
     before each stream and read just after (K3 and K3-sort must
     launch; K2 never);
     each WGL stream's final carry is held against the offline walk of
     its engine on the card, each result against the CPU path's (the
     dense stream through the first chunk of its full-size run), and feed,
     tail and offline walls are printed (the dense stream's CPU check
     runs in a worker process from the end of phase 1 on);
  9. the verification service on the card: one VerificationService, 16
     streams of a 1,000-op register history fed from 16 threads (streams
     0-7 dense, K3; 8-15 packed sort on the hash route, K3-sort; streams
     5 and 13 invalid), every kernel's launch count set to 0 just before
     the 16-stream run and read just after, each stream's own rounds and
     hash dedups adding up to K3's and K3-sort's (K1 and K2 never
     launch), each result equal to the stream alone on the card
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
     of its counter batch (K3-sort launched) and of the hazelcast batch again
     under an injected OOM (the split), list_append.check of phase 7's
     G1c history over the mesh (equal to phase 7's result, classified
     by K4-small), and the closure of a 4,096-node ring with and without
     the mesh (12 K4-product launches each), every collective on CUDA
     tensors; then four gloo ranks sharing the card,
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
     equal to the CPU path's (in a worker process) but for its wall, K3's
     rounds and K3-sort's hash dedups equal to the CPU path's plain K1
     and K2 calls; then the
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
     card (a K4 launch a bucket) and none of K1, K2 or K3, with the
     classifier's call count and every kernel's launch count set to 0
     just before each run and read just after; each workload result is held, whole, against the CPU
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
BF16_OPS_PER_S = 989e12         # dense, on the tensor cores
# 32-bit integer operations (the data sheet gives no rate): 132 SMs of 64
# INT32 lanes each (NVIDIA's H100 architecture whitepaper) at the 1.98 GHz
# that the float32 peak's 132 x 128 lanes x 2 ops imply
INT32_OPS_PER_S = 132 * 64 * 1.98e9

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
# phase 4b's K3-sort walks: the at-cap history on the lexicographic route
# at two of its escalated passes' frontiers, each walked until it dies
# (at F = 4,096 after 3 windows of 124 steps); the adversarial history's
# last escalated pass at F = 65,536 cut to a prefix (16 windows of 15
# steps: the eager walk's time), the sort-abort stream's first 3 chunks;
# the chaos workload's shape (8 slots, F = 128, no declared range:
# unpacked) on a register history of K3S_CHAOS_OPS ops
K3S_AT_CAP_F = (256, 4096)
K3S_ADV_F = 65536
K3S_ADV_STEPS = 240
K3S_STREAM_CHUNKS = 3
K3S_CHAOS_OPS = 2_000
# the operations K3-sort's bound counts a dedup row, whatever implements
# the dedup: a hash insert is the murmur finaliser's 8 (two multiplies,
# three shifts, three XORs); a stable selection of the first F positions
# must at least look at every row's key once: its top digit extracted (a
# shift and a mask) and counted (an add), and the key held against the
# threshold (a compare), 4
HASH_ROW_OPS = 8
SORT_ROW_OPS = 4
# the library yardstick of one K3-sort dedup: torch.sort(stable=True) of
# its N keys, at the adversarial pass's F = 65,536 x (1 + 16) and at-cap's
# F = 4,096 x (1 + 32) rows
K3S_LIBRARY_N = (1_114_112, 135_168)
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
# K4 is held against the plain chain at ELLE_BUCKETS and on both
# sides of K4-small's line (k4.SMALL_MAX_E = 256)
ELLE_K4_BUCKETS = ELLE_BUCKETS + [(512, 4), (2048, 1)]
# one K4-product squaring timed alone, at the 4,000-node rings' bucket
ELLE_SQUARING = (4, 4096)
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
# the CPU checks' worker processes and the threads of each: 3 x 2 of the
# card host's 8 cores beside this process (the pool's checks, mostly
# interpreter-bound eager walks, set the script's wall once the sort
# escalations run on the card's grid path: 2 x 3 took longer)
CPU_WORKERS = 3
CPU_WORKER_THREADS = 2
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
    """Set every kernel's launch count, and the rounds and hash dedups
    the walk kernels ran, to 0."""
    from jepsen_tpu_torch.checker import (wgl_closure, wgl_dedup,
                                          wgl_sortwalk, wgl_walk)
    from jepsen_tpu_torch.checker.elle import k4
    k4.LAUNCHES = dict.fromkeys(k4.KERNELS, 0)
    k4.HELPER_LAUNCHES = k4.MEMSETS = 0
    wgl_closure.LAUNCHES = wgl_dedup.LAUNCHES = 0
    wgl_walk.LAUNCHES = wgl_walk.ROUNDS = 0
    wgl_sortwalk.LAUNCHES = wgl_sortwalk.ROUNDS = wgl_sortwalk.DEDUPS = 0
    wgl_sortwalk.ROWS = wgl_sortwalk.PASS_ROWS = 0
    wgl_sortwalk.SORTS = wgl_sortwalk.STEPS = 0
    wgl_sortwalk.PHASE_NS = dict.fromkeys(wgl_sortwalk.PHASES, 0)


def launch_counts() -> dict:
    """The launch counts since `zero_launches`: K1's and K2's, K3's (the
    dense walk) with the closure rounds it ran, which stand for the dense
    walks' rounds (K1's launches before K3 took the walk), K3-sort's
    (the sort walk) with the stage-B rounds and hash dedups it ran, which
    stand for the sort walks' (K2's launches before K3-sort took the
    walk), and K4's (the Elle classifier and closure: K4-small,
    K4-product, the product chain's helpers and its workspace's zero
    fills)."""
    from jepsen_tpu_torch.checker import (wgl_closure, wgl_dedup,
                                          wgl_sortwalk, wgl_walk)
    from jepsen_tpu_torch.checker.elle import k4
    return {"k4_small_launches": k4.LAUNCHES["small"],
            "k4_product_launches": k4.LAUNCHES["product"],
            "k4_helper_launches": k4.HELPER_LAUNCHES,
            "k4_memsets": k4.MEMSETS,
            "k1_launches": wgl_closure.LAUNCHES,
            "k2_launches": wgl_dedup.LAUNCHES,
            "k3_launches": wgl_walk.LAUNCHES, "k3_rounds": wgl_walk.ROUNDS,
            "k3s_launches": wgl_sortwalk.LAUNCHES,
            "k3s_rounds": wgl_sortwalk.ROUNDS,
            "k3s_dedups": wgl_sortwalk.DEDUPS}


class K4Uncounted:
    """Launches inside it (K4 timed or held against its plain version)
    leave K4's counts as they were before it."""

    def __enter__(self):
        from jepsen_tpu_torch.checker.elle import k4
        self.k4 = k4
        self.saved = dict(k4.LAUNCHES), k4.HELPER_LAUNCHES, k4.MEMSETS
        return self

    def __exit__(self, *exc):
        (self.k4.LAUNCHES, self.k4.HELPER_LAUNCHES,
         self.k4.MEMSETS) = self.saved


def walk_counts(rec) -> tuple:
    """(rounds, hash dedups) the walk kernels reported over a run: K3's
    closure rounds with K3-sort's stage-B rounds, and K3-sort's hash
    dedups, which are the results' closure-rounds and dedup-launches."""
    return rec["k3_rounds"] + rec["k3s_rounds"], rec["k3s_dedups"]


def walks_only(rec) -> bool:
    """K1 and K2 launched no time: every walk ran in K3 or K3-sort."""
    return rec["k1_launches"] == 0 and rec["k2_launches"] == 0


class WalkSyncs:
    """The host reads of the walks in this process, by engine shape
    "s_lo,S,P" (dense) or "sort,F,P": the kernels' walks
    (`DenseKernel._walk_k3`, K3; `SortKernel._walk_k3s`, K3-sort; under
    "k3") and the eager walks (`run_range_eager`, `run_range_batch_eager`
    of both families: the CPU path's, and the card's in phase 4b). A
    kernel walk must read the host once to start and once at the end of
    each of its launches; `hold` refuses any walk that read otherwise.
    Launches are counted per thread, so walks in other threads do not
    blur a walk's count. Install with `walk_syncs()`."""

    def __init__(self, wgl, wgl_walk, wgl_sortwalk):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.k3 = collections.Counter()
        self.eager = collections.Counter()
        self.calls = self.launches = 0
        self.bad = []

        def counted(real_launch):
            def launch(*a, **kw):
                out = real_launch(*a, **kw)
                self.local.n = getattr(self.local, "n", 0) + 1
                return out
            return launch

        def kernel_walk(real):
            def walk(k, *a):
                s0, self.local.n = k.syncs, 0
                out = real(k, *a)
                reads, n = k.syncs - s0, self.local.n
                with self.lock:
                    self.k3[self.shape(k)] += reads
                    self.calls += 1
                    self.launches += n
                    if reads != 1 + n:
                        self.bad.append((self.shape(k), reads, n))
                return out
            return walk

        def eager(real):
            def walk(k, *a):
                s0 = k.syncs
                out = real(k, *a)
                with self.lock:
                    self.eager[self.shape(k)] += k.syncs - s0
                return out
            return walk

        wgl_walk.launch = counted(wgl_walk.launch)
        wgl_sortwalk.launch = counted(wgl_sortwalk.launch)
        for cls, name in ((wgl.DenseKernel, "_walk_k3"),
                          (wgl.SortKernel, "_walk_k3s")):
            setattr(cls, name, kernel_walk(getattr(cls, name)))
            cls.run_range_eager = eager(cls.run_range_eager)
            cls.run_range_batch_eager = eager(cls.run_range_batch_eager)

    @staticmethod
    def shape(k) -> str:
        if hasattr(k, "S"):
            return f"{k.s_lo},{k.S},{k.P}"
        return f"sort,{k.F},{k.P}"

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
            raise AssertionError(f"kernel walks whose host reads are not "
                                 f"one to start and one a launch (shape, "
                                 f"reads, launches): {self.bad[:5]}")


_WALK_SYNCS = None


def walk_syncs() -> WalkSyncs:
    """This process's WalkSyncs, installed at the first call."""
    global _WALK_SYNCS
    if _WALK_SYNCS is None:
        from jepsen_tpu_torch.checker import wgl, wgl_sortwalk, wgl_walk
        _WALK_SYNCS = WalkSyncs(wgl, wgl_walk, wgl_sortwalk)
    return _WALK_SYNCS


class SortPasses:
    """The K3-sort walks of each SortKernel in this process, in the order
    their kernels first walked: an escalation's passes, one kernel each.
    Each pass: F, P, route, path, steps walked, launches, the host-clock
    wall of its walks (each ends in a host read) and its `k3s_work`.
    Install with `sort_passes()`; `take()` returns and forgets them."""

    def __init__(self, wgl, wgl_sortwalk):
        self.passes = {}
        real = wgl.SortKernel._walk_k3s

        def walk(k, x, stops, carry):
            w0, l0 = k3s_work(), wgl_sortwalk.LAUNCHES
            t = time.perf_counter()
            out = real(k, x, stops, carry)
            wall = time.perf_counter() - t
            w1 = k3s_work()
            if id(k) not in self.passes:
                self.passes[id(k)] = {
                    "kernel": k, "F": k.F, "P": k.P, "route": k.route,
                    "path": wgl_sortwalk.path(x.shape[0], k.F, k.P, k.route),
                    "wall_s": 0.0, "launches": 0,
                    "work": dict.fromkeys(w1, 0)}
            p = self.passes[id(k)]
            p["wall_s"] += wall
            p["launches"] += wgl_sortwalk.LAUNCHES - l0
            for a, v in w1.items():
                p["work"][a] += v - w0[a]
            return out

        wgl.SortKernel._walk_k3s = walk

    def take(self) -> list:
        out = [dict(p) for p in self.passes.values()]
        self.passes = {}
        for p in out:
            p.pop("kernel")
        return out


_SORT_PASSES = None


def sort_passes() -> SortPasses:
    """This process's SortPasses, installed at the first call."""
    global _SORT_PASSES
    if _SORT_PASSES is None:
        from jepsen_tpu_torch.checker import wgl, wgl_sortwalk
        _SORT_PASSES = SortPasses(wgl, wgl_sortwalk)
    return _SORT_PASSES


def log_passes(label, passes) -> None:
    for i, p in enumerate(passes):
        w = p["work"]
        log(f"{label} pass {i}: F={p['F']}, P={p['P']}, {p['route']}, "
            f"{p['path']} path, {w['steps_walked']} steps, "
            f"{p['launches']} launches, wall {p['wall_s']:.4f} s")
        log(f"{label} pass {i} {k3s_split(w)}")


def same_syncs_but_walks(label, g_syncs, g_k3, c_syncs, c_eager) -> None:
    """Hold a card result's host reads to the CPU path's: the kernels'
    walks (K3, K3-sort) read the host once to start and once a window
    (`WalkSyncs.hold`), the eager walks every round, and every other
    read is the same on both."""
    if g_syncs - g_k3 != c_syncs - c_eager or not g_syncs < c_syncs:
        raise AssertionError(f"{label}: {g_syncs} host syncs on the card "
                             f"({g_k3} in kernel walks), {c_syncs} on the "
                             f"CPU path ({c_eager} in eager walks)")


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
        f"{rec['k3_launches']} ({rec['k3_rounds']} rounds), K3-sort "
        f"launches {rec['k3s_launches']} ({rec['k3s_rounds']} rounds, "
        f"{rec['k3s_dedups']} hash dedups), K2 launches "
        f"{rec['k2_launches']} "
        f"({rec['k2_cuda_launches']} CUDA launches), host syncs "
        f"{tot['host_syncs']}, groups [kind, shape..., keys] "
        f"{tot['groups']}, invalid keys {rec['op_index']}")
    return rs, rec, carries


def check_batch(label, rs, rec, bad, dense) -> None:
    """Hold a batch run to what its histories are: the corrupted keys
    invalid with an op-index, the rest valid, K3 launched on the dense
    groups and K3-sort on the sort group's hash route, their rounds and
    hash dedups the walks' counts, K1 and K2 never alone."""
    if rec["invalid"] != sorted(bad) or any(
            not isinstance(rec["op_index"][i], int) for i in bad):
        raise AssertionError(f"{label}: invalid keys {rec['op_index']}")
    if any(v not in (True, False) for v in rec["verdicts"]):
        raise AssertionError(f"{label}: undecided keys")
    if any(r["analyzer"] != "gpu-wgl-batch" or r["device"] != "cuda"
           for r in rs):
        raise AssertionError(f"{label}: a key left the batch path")
    k3, k3s = rec["k3_launches"], rec["k3s_launches"]
    family = "dense" if dense else "sort"
    if not walks_only(rec) or rec["k2_cuda_launches"] != 0 \
            or (k3 > 0) != dense or (k3s > 0) == dense \
            or walk_counts(rec) != (rec["closure_rounds"],
                                    rec["dedup_launches"]) \
            or any(g[0] != family for g in rec["groups"]) \
            or (not dense and (rec["dedup_launches"] <= 0 or any(
                r["dedup"] != "pallas-hash" for r in rs))):
        raise AssertionError(f"{label}: K3 {k3} / K3-sort {k3s} launches, "
                             f"rounds and hash dedups {walk_counts(rec)} "
                             f"for {rec['closure_rounds']} and "
                             f"{rec['dedup_launches']}, K1 "
                             f"{rec['k1_launches']}, K2 {rec['k2_launches']}")


BATCH_AGREE_KEYS = ("valid?", "op-index", "max-frontier", "dedup",
                    "analyzer", "op-count", "batch-walk")


def without_walk_syncs(fields: dict) -> dict:
    """A key's compared fields without its batch walk's host syncs: the
    walk kernels (K3, K3-sort) read the host once a window, the CPU
    path's eager walks every round, so those counts differ by design, and
    every kernel walk on the card is held to its own count
    (`WalkSyncs.hold`, at each phase's end); every other walk count is
    the same on both."""
    walk = fields.get("batch-walk")
    if not walk:
        return fields
    return dict(fields, **{"batch-walk": {k: v for k, v in walk.items()
                                          if k != "host-syncs"}})


def cpu_batch(kind: str) -> tuple:
    """Phase 6's CPU path in a worker process: the hazelcast ("dense") or
    the counter ("sort") batch through analysis_gpu_batch on the CPU,
    with each group walk's final batched carry. It needs nothing of the
    card's run. Returns each key's compared fields, the carries, the
    seconds it took and the host reads of its eager walks by engine
    shape."""
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
            # K3 and K3-sort read the host once a window, the CPU path's
            # eager walks at every round: every other read and walk count
            # is equal
            a["batch-walk"], b["batch-walk"] = (
                dict(a["batch-walk"]), dict(b["batch-walk"]))
            ga, gb = (a["batch-walk"].pop("host-syncs"),
                      b["batch-walk"].pop("host-syncs"))
            group = a["batch-walk"]["group"]
            shape = ",".join(map(str, group[1:] if group[0] == "dense"
                                 else group))
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
            f" per step), {pr['h2d_copies']} host-to-device copies, of "
            f"which {pr['h2d_copies'] - pr['k3_launches'] - pr['k3s_launches']}"
            f" not a window's ends; top {pr['top']}")
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
    analysis_gpu's walk does (or, where `eager`, with the eager walk,
    the plain version of K3 or K3-sort)."""
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
    sum is the device's busy time. `kernel_launches` counts every device
    operation (kernels, copies, memsets), `h2d_copies` the copies from
    the host. The durations are summed from the
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
    k3s = [v for name, v in by_name.items() if "sort_walk" in name]
    return {"wall_s": wall, "device_busy_s": busy_s,
            "busy_share": busy_s / wall,
            "kernel_launches": sum(c for c, _ns in by_name.values()),
            "h2d_copies": sum(c for name, (c, _ns) in by_name.items()
                              if "HtoD" in name),
            "k3_launches": sum(c for c, _ns in k3),
            "k3_ms": sum(ns for _c, ns in k3) / 1e6,
            "k3s_launches": sum(c for c, _ns in k3s),
            "k3s_ms": sum(ns for _c, ns in k3s) / 1e6,
            "top": [(name[:60], c, ns / 1e6) for name, (c, ns) in top]}


def k3_bound(S, P, keys, launches, steps, completions,
             pair_rounds) -> tuple[float, str]:
    """The least time an H100 could take for a K3 walk on these inputs,
    and what bounds it: the larger of bytes over the HBM rate and its
    integer operations over the INT32 rate.

    Bytes, each input read once and each output written once: at each
    launch every key's carry in and out (table S x 2^P bool bytes, e,
    att, count and max_count, three int32 slot words and an occupancy
    byte a slot), and at each step walked its row (5 int32). The table
    stays on chip between passes, so its passes are no bytes here. Left
    out, which keeps this a floor: the per-step round maxima (8 bytes a
    window step) and the launch's scalar sums.

    Operations, counted by the cells they cover whatever the layout, 32
    cells a 32-bit operation: a round ORs half a row into its row for
    each listed (source state, slot) pair, so the walk's pair rounds (K3
    counts them: `wgl_walk.PAIR_ROUNDS`) times 2^P / 2 cells; each step's
    count S x 2^P cells, and each completion's gather as many. For a
    batch, `steps`, `completions` and `pair_rounds` sum over the keys."""
    C = 1 << P
    carry = 2 * (S * C + 16 + 13 * P)
    nbytes = launches * keys * carry + steps * 20
    ops = (pair_rounds * C / 2 + (steps + completions) * S * C) / 32
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k3s_work() -> dict:
    """K3-sort's work counts so far: rows, rows x passes, dedups, steps
    and each phase's nanoseconds (`wgl_sortwalk.PHASE_NS`)."""
    from jepsen_tpu_torch.checker import wgl_sortwalk as m
    with m._LAUNCH_LOCK:
        return dict({"rows": m.ROWS, "pass_rows": m.PASS_ROWS,
                     "sorts": m.SORTS, "steps_walked": m.STEPS},
                    **{f"ns_{k}": v for k, v in m.PHASE_NS.items()})


def k3s_split(work: dict) -> str:
    """One line of where K3-sort's device time went (`k3s_work`'s
    differences): each phase's ms and share, ms a step and a dedup, and
    PASS_ROWS / ROWS."""
    ns = {k[3:]: v for k, v in work.items() if k.startswith("ns_")}
    total = sum(ns.values()) or 1
    parts = ", ".join(f"{k} {v / 1e6:.3f} ({100 * v / total:.1f}%)"
                      for k, v in ns.items() if v)
    return (f"split over {work['steps_walked']} steps and {work['sorts']} "
            f"dedups: {total / 1e6:.3f} ms ({total / 1e6 / max(work['steps_walked'], 1):.5f} "
            f"a step, {total / 1e6 / max(work['sorts'], 1):.5f} a dedup): {parts}; "
            f"PASS_ROWS / ROWS {work['pass_rows'] / max(work['rows'], 1):.3f}")


def walk_pair(k3, ke, label, walk3, walke, carry_to_numpy,
              mod=None) -> dict:
    """One walk with its kernel (`walk3(k3)`: K3, or K3-sort where `mod`
    is `wgl_sortwalk`) and with the eager walk (`walke(ke)`, the kernel's
    plain version) on the card, the kernel first and last: the carries
    element for element, the rounds and hash dedups equal, the kernel's
    host syncs one per call and one per launch, each side's wall (the
    kernel the later of its two), host syncs and launches, and the work
    the kernel reported (K3's pair rounds; K3-sort's `k3s_work`: dedup
    rows, rows times passes, dedups, steps and the phase split)."""
    from jepsen_tpu_torch.checker import wgl_walk
    mod = mod or wgl_walk
    name = "K3" if mod is wgl_walk else "K3-sort"
    ws = walk_syncs()

    def work():
        if mod is not wgl_walk:
            return k3s_work()
        return {"pair_rounds": wgl_walk.PAIR_ROUNDS,
                **{f"tier_{t}": n for t, n in wgl_walk.TIER_LAUNCHES.items()}}

    def timed(fn, k):
        r0, d0, s0, l0 = k.rounds, k.dedups, k.syncs, mod.LAUNCHES
        w0 = work()
        snap = ws.snap()
        torch.cuda.synchronize()
        t = time.perf_counter()
        c = fn(k)
        torch.cuda.synchronize()
        return (time.perf_counter() - t, carry_to_numpy(c),
                (k.rounds - r0, k.dedups - d0), k.syncs - s0,
                mod.LAUNCHES - l0, ws.since(snap)["calls"],
                {a: v - w0[a] for a, v in work().items()})

    timed(walk3, k3)
    e = timed(walke, ke)
    g = timed(walk3, k3)
    err = max((int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
               if a.size else 0) for a, b in zip(g[1], e[1]))
    if err or g[2] != e[2] or any(
            a.dtype != b.dtype or a.shape != b.shape
            for a, b in zip(g[1], e[1])):
        raise AssertionError(f"{name} {label}: carry differs by {err}, "
                             f"rounds and hash dedups {g[2]} against the "
                             f"eager walk's {e[2]}")
    if g[3] != g[5] + g[4] or not g[3] < e[3]:
        raise AssertionError(f"{name} {label}: {g[3]} host syncs for "
                             f"{g[5]} calls and {g[4]} launches (the eager "
                             f"walk {e[3]})")
    out = {"k3_wall_s": g[0], "eager_wall_s": e[0], "rounds": g[2][0],
           "dedups": g[2][1], "k3_syncs": g[3], "eager_syncs": e[3],
           "k3_launches": g[4], "k3_calls": g[5], "max_abs_err": err,
           "carry": g[1]}
    out.update(g[6])
    return out


def k3s_bound(F, P, route, keys, launches, steps,
              rows) -> tuple[float, str]:
    """The least time an H100 could take for a K3-sort walk on these
    inputs, and what bounds it: the larger of bytes over the HBM rate and
    its integer operations over the INT32 rate.

    Bytes, each input read once and each output written once: at each
    launch every key's carry in and out (masks F x W and states F as
    int32, valid F bytes, three int32 slot words and an occupancy byte a
    slot, five int32 scalars), and at each step walked its row (W + 4
    int32). A dedup's rows, hash table and sort buffers stay on chip or
    in the key's scratch, which holds nothing the walk must move.

    Operations: the rows of every dedup, which K3-sort reports: on the
    hash route HASH_ROW_OPS a row (the insert's hash), on the sort routes
    SORT_ROW_OPS a row (one look at its key by a selection of the first F
    positions). The count is fixed a row, so the bound does not move with
    the radix passes an implementation runs. For a batch `steps` and
    `rows` sum over the keys."""
    W = (P + 31) // 32
    carry = 2 * (F * (4 * W + 5) + 13 * P + 20)
    nbytes = launches * keys * carry + steps * 4 * (W + 4)
    ops = rows * (HASH_ROW_OPS if route == "hash" else SORT_ROW_OPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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


def stream_chunks(wgl, streaming, model, hist, device, n_chunks,
                  sort=False) -> tuple:
    """The first n_chunks chunks a stream (STREAM_DENSE, or STREAM_ABORT
    where `sort`) hands its engine: (kernel shape, [(step matrix, n,
    carry before) ...]), as the stream staged them, read by wrapping the
    engine's check_stream_chunk while the history is fed. The shape is
    (s_lo, S, P) of the dense engine, (model, F, P, pack, route) of the
    sort engine."""
    seen = []
    cls = wgl.SortKernel if sort else wgl.DenseKernel
    real = cls.check_stream_chunk

    def record(k, xs, n, carry):
        shape = ((k.model_name, k.F, k.P,
                  (k.s_lo, k.sb_bits) if k.packed else None, k.dedup_route)
                 if sort else (k.s_lo, k.S, k.P))
        seen.append((shape, xs.host.copy(), n,
                     tuple(t.clone() for t in carry)))
        return real(k, xs, n, carry)

    cls.check_stream_chunk = record
    try:
        s = streaming.WglStream(model, device=device,
                                **(STREAM_ABORT if sort else STREAM_DENSE))
        for op in hist.ops:
            s.feed(op)
            if len(seen) >= n_chunks:
                break
    finally:
        cls.check_stream_chunk = real
    shapes = {c[0] for c in seen}
    if len(seen) < n_chunks or len(shapes) != 1:
        raise AssertionError(f"stream: {len(seen)} chunks, shapes {shapes}")
    return seen[0][0], [c[1:] for c in seen]


def phase_k3(dev, models, synth, wgl, streaming, carry_to_numpy,
             head) -> dict:
    """Phase 4b: K3 (the dense step walk) against the eager walk, its
    plain version, on the card: the headline, the forced-dense
    adversarial and at-cap histories, the four dense groups of the
    hazelcast batch, the dense stream's first three chunks and a
    rabbitmq-shaped mutex, each walked both ways with its carry equal
    element for element, its rounds equal and K3's tier the expected one
    (`wgl_walk.TIERS`), each wall timed both ways with host syncs and
    launches; torch.profiler traces of the headline
    and of the hazelcast batch's largest group, both ways on the profile
    prefix and K3 over the whole walk, for the card's busy share."""
    from jepsen_tpu_torch.checker import wgl_walk
    reg = models.cas_register()
    out = {"walks": {}, "profiles": {}}

    def record(label, row, S, P, steps, completions, want_tier):
        bound_ms, bound_by = k3_bound(
            S, P, row.get("keys", 1), row["k3_launches"], steps,
            completions, row["pair_rounds"])
        tiers = {t for t in wgl_walk.TIERS if row.pop(f"tier_{t}")}
        if tiers != {want_tier} or wgl_walk.tier(
                row.get("keys", 1), S, P) != want_tier:
            raise AssertionError(f"K3 {label}: walked on {tiers}, not on "
                                 f"the {want_tier} tier")
        row.update(S=S, P=P, steps=steps, completions=completions,
                   launches_per_step=row["k3_launches"] / max(steps, 1),
                   bound_ms=bound_ms, bound_by=bound_by, tier=want_tier)
        row.pop("carry")
        out["walks"][label] = row
        log(f"K3 {label} (S={S}, P={P}, {steps} steps, {want_tier} tier): "
            f"K3 {row['k3_wall_s']:.4f} s, {row['k3_syncs']} host syncs, "
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
    singles = [("headline", reg, head, {}, "warp"),
               ("adversarial-dense", reg, adv, {"engine": "dense"}, "block"),
               ("at-cap-dense", reg, synth.adversarial_register_history(
                   **AT_CAP), {"engine": "dense"}, "cluster"),
               ("rabbitmq-mutex", models.mutex(),
                mutex_history(K3_MUTEX_OPS), {}, "warp")]
    for label, model, hist, kw, want_tier in singles:
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
        record(label, row, S, P, *done_steps(steps.x, 0, int(row["carry"][0])),
               want_tier)
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
        # a warp a key up to 32 words (8 x 2^6 cells), a block above
        record(f"hazelcast P={P} ({len(ns)} rows)", row, k3.S, P,
               *done_steps(xs.host, 0, row["carry"][0]),
               "warp" if P <= 6 else "block")

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
           comp, "block")

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
                f"{pr['kernel_launches']} kernel launches "
                f"({pr['h2d_copies']} from the host), K3 "
                f"{pr['k3_launches']} launches in {pr['k3_ms']:.3f} ms; "
                f"top {pr['top'][:3]}")
    # a K3 window costs the host a handful of device operations (the
    # window ends' copy, the counts buffer, the launch, the fetch), and a
    # batch's initial carries one copy an element (nine)
    hp = out["profiles"]["headline"]["k3_full"]
    per_launch = hp["kernel_launches"] / max(hp["k3_launches"], 1)
    gp = out["profiles"]["hazelcast largest group"]["k3_full"]
    carry_copies = gp["h2d_copies"] - gp["k3_launches"]
    log(f"K3 device operations a launch on the headline's whole walk: "
        f"{per_launch:.2f}; the hazelcast largest group's initial-carry "
        f"copies: {carry_copies}")
    if per_launch > 8 or carry_copies > 9:
        raise AssertionError(f"K3: {per_launch:.2f} device operations a "
                             f"launch, {carry_copies} initial-carry copies")
    out["ops_per_launch"], out["carry_copies"] = per_launch, carry_copies
    return out


def sort_group(wgl, model, hists, device):
    """The sort dispatch group of a batch as analysis_gpu_batch forms it
    (F = 1,024, BATCH_SLOTS): a kernel factory, the staged (B, T, W+4)
    steps, the stops and the initial states."""
    pre = [wgl.encode_ops_for_model(model, h) for h in hists]
    srange = wgl._state_range(model.device_model, model, pre)
    _dense, idx = wgl._dispatch_groups(
        srange, [wgl.required_slots(o) for o in pre], "auto",
        n_events=max(wgl.event_count(o) for o in pre))
    x, ns = wgl._stack_steps([wgl.build_steps(pre[i], BATCH_SLOTS)
                              for i in idx], wgl._bucket(len(idx), lo=1))
    return (lambda: wgl._batch_kernel(model.device_model, None, srange,
                                      BATCH_SLOTS, 1024, device),
            wgl.stage_steps(x, device), ns,
            [model.device_state()] * len(ns))


def phase_k3s(dev, models, synth, wgl, streaming, carry_to_numpy,
              head) -> dict:
    """Phase 4b, K3-sort: the sort step walk against the eager walk, its
    plain version, on the card, on every route: the phantom and counter
    histories whole (hash), the at-cap history at F = 256 and 4,096 until
    the frontier dies (lexicographic, 32 slots), the adversarial
    history's last escalated pass at
    F = 65,536 on a prefix (packed sort), the counter batch's sort group
    batched (hash, F = 1,024), the sort-abort stream's first chunks
    (hash, 8 slots) and the chaos workload's shape (8 slots, F = 128,
    lexicographic), each walked both ways with its carry equal element
    for element and its rounds and hash dedups equal, each wall timed
    both ways with host syncs and launches, and K3-sort's phase split
    printed; the library yardstick (`k3s_library`); torch.profiler traces
    of the phantom walk, both ways on the profile prefix and K3-sort over
    the whole walk, for the card's busy share."""
    from jepsen_tpu_torch.checker import wgl_sortwalk
    reg = models.cas_register()
    out = {"walks": {}, "profiles": {}}

    def record(label, row, k, steps):
        keys = row.get("keys", 1)
        bound_ms, bound_by = k3s_bound(
            k.F, k.P, k.route, keys, row["k3_launches"], steps, row["rows"])
        ns = sum(v for a, v in row.items() if a.startswith("ns_"))
        row.update(F=k.F, P=k.P, route=k.route, steps=steps,
                   path=wgl_sortwalk.path(keys, k.F, k.P, k.route),
                   launches_per_step=row["k3_launches"] / max(steps, 1),
                   bound_ms=bound_ms, bound_by=bound_by,
                   device_ms=ns / 1e6,
                   dedup_ms=ns / 1e6 / max(row["sorts"], 1))
        row.pop("carry")
        out["walks"][label] = row
        log(f"K3-sort {label} (F={k.F}, P={k.P}, {row['route']}, "
            f"{row['path']} path, {steps} steps): K3-sort "
            f"{row['k3_wall_s']:.4f} s, "
            f"{row['k3_syncs']} host syncs, {row['k3_launches']} launches; "
            f"eager {row['eager_wall_s']:.4f} s, {row['eager_syncs']} host "
            f"syncs; {row['rounds']} rounds and {row['dedups']} hash "
            f"dedups both ways; carry equal; {row['rows']} dedup rows, "
            f"{row['pass_rows']} rows x passes "
            f"({row['pass_rows'] / max(row['rows'], 1):.3f} a row); bound "
            f"{row['bound_ms']:.6f} ms by {row['bound_by']}")
        log(f"K3-sort {label} {k3s_split(row)}")

    def pair(label, make, walk3, walke):
        return walk_pair(make(), make(), label, walk3, walke,
                         carry_to_numpy, wgl_sortwalk)

    def single(label, model, hist, prefix=None, frontier=256, **kw):
        pl = wgl.plan(model, hist, **kw)
        if pl.decision.dense is not None:
            raise AssertionError(f"K3-sort {label}: planned dense")
        steps = wgl.build_steps(pl.ops, pl.slots)
        stop = min(prefix or steps.n, steps.n)
        xs = wgl.stage_steps(steps.x, dev)
        init = model.device_state()
        row = pair(label, lambda: pl.kernel(dev, frontier),
                   lambda k: k.check_chunk(xs, stop, k.init_carry(init)),
                   lambda k: k.run_range_eager(xs, stop, k.init_carry(init)))
        k = pl.kernel(dev, frontier)
        record(label, row, k, int(row["carry"][0]))
        return k

    phantom = synth.corrupt(head)
    if single("phantom", reg, phantom).route != "hash":
        raise AssertionError("phantom: not the hash route")
    single("counter", models.counter(), synth.counter_history(**COUNTER))
    at_cap = synth.adversarial_register_history(**AT_CAP)
    for F in K3S_AT_CAP_F:
        if single(f"at-cap F={F}", reg, at_cap, frontier=F,
                  engine="sort").route != "lex":
            raise AssertionError("at-cap: not the lexicographic route")
    adv = synth.adversarial_register_history(**ADVERSARIAL)
    if single(f"adversarial F={K3S_ADV_F} prefix", reg, adv,
              prefix=K3S_ADV_STEPS, frontier=K3S_ADV_F,
              engine="sort").route != "packed":
        raise AssertionError("adversarial: not the packed sort route")

    # the counter batch's sort group, batched
    (_reg, _hz), (counter, cnt) = batch_histories(models, synth)
    make, xs, ns, init = sort_group(wgl, counter, cnt, dev)
    row = pair("counter batch", make,
               lambda k: k.check_chunk_batch(xs, ns, k.init_carry_batch(init)),
               lambda k: k.run_range_batch_eager(xs, ns,
                                                 k.init_carry_batch(init)))
    row["keys"] = len(ns)
    record(f"counter batch ({len(ns)} rows)", row, make(),
           int(np.asarray(row["carry"][0]).sum()))

    # the sort-abort stream's first chunks, e rebased per chunk
    bad = synth.corrupt(synth.register_history(**STREAM_ABORT_HIST), seed=11)
    (mname, F, P, pack, route), chunks = stream_chunks(
        wgl, streaming, reg, bad, dev, K3S_STREAM_CHUNKS, sort=True)

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

    def make_stream():
        return wgl.SortKernel(mname, F, P, pack, route, dev)

    row = pair("sort-abort stream", make_stream,
               lambda k: stream_walk(k, False),
               lambda k: stream_walk(k, True))
    record(f"sort-abort stream, first {len(chunks)} chunks", row,
           make_stream(), sum(n for _x, n, _c in chunks))

    # the chaos workload's shape: 8 slots, F = 128, no declared range
    ops = wgl.encode_ops_for_model(reg, synth.register_history(
        K3S_CHAOS_OPS, concurrency=5, values=5, crash_rate=0.0005,
        seed=SEED))
    steps = wgl.build_steps(ops, 8)
    xs1 = wgl.stage_steps(steps.x, dev)

    def make_chaos():
        return wgl.SortKernel(reg.device_model, 128, 8, None,
                              wgl.DEDUP_SORT, dev)

    row = pair("chaos shape", make_chaos,
               lambda k: k.check_chunk(xs1, steps.n,
                                       k.init_carry(reg.device_state())),
               lambda k: k.run_range_eager(xs1, steps.n,
                                           k.init_carry(reg.device_state())))
    record("chaos shape (8 slots, F=128)", row, make_chaos(),
           int(row["carry"][0]))

    out["library"] = k3s_library(dev, out["walks"])

    # where the time goes, both ways
    walk3 = prefix_walk(wgl, reg, phantom, dev)
    walke = prefix_walk(wgl, reg, phantom, dev, eager=True)
    prof = {"eager_prefix": profile_walk(walke, PROFILE_WALK_STEPS),
            "k3s_prefix": profile_walk(walk3, PROFILE_WALK_STEPS),
            "k3s_full": profile_walk(walk3, 10 ** 9)}
    out["profiles"]["phantom"] = prof
    for how, pr in prof.items():
        steps = PROFILE_WALK_STEPS if how != "k3s_full" else None
        log(f"K3-sort profile phantom, {how} ({steps or 'all'} steps): "
            f"wall {pr['wall_s']:.4f} s, device busy "
            f"{pr['device_busy_s']:.4f} s ({100 * pr['busy_share']:.2f}%), "
            f"{pr['kernel_launches']} kernel launches, K3-sort "
            f"{pr['k3s_launches']} launches in {pr['k3s_ms']:.3f} ms; "
            f"top {pr['top'][:3]}")
    return out


def k3s_library(dev, walks) -> dict:
    """The library yardstick of one K3-sort dedup: torch.sort(stable=True)
    over N 32-bit keys (uint32 keys with their sign bit flipped, as int32,
    so the order is the uint32 one; random from SEED), timed by CUDA
    events, at the adversarial pass's and at-cap's N (`K3S_LIBRARY_N`),
    printed beside K3-sort's device ms a dedup on those walks (the phase
    split's sum over its dedups). The port never calls it."""
    rng = np.random.default_rng(SEED)
    mine = {K3S_LIBRARY_N[0]: f"adversarial F={K3S_ADV_F} prefix",
            K3S_LIBRARY_N[1]: f"at-cap F={K3S_AT_CAP_F[-1]}"}
    out = {}
    for n in K3S_LIBRARY_N:
        keys = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)).to(dev)
        ms = time_ms(lambda: torch.sort(keys, stable=True), 20)
        walk = walks.get(mine[n], {})
        out[n] = {"library_ms": ms, "walk": mine[n],
                  "dedup_ms": walk.get("dedup_ms")}
        log(f"K3-sort library yardstick at N={n}: torch.sort(stable=True) "
            f"library_ms {ms:.6f}; K3-sort {walk.get('dedup_ms', 0):.6f} ms "
            f"a dedup on {mine[n]} (its whole dedups, from the split)")
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
    eager walks)."""
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
         (("unknown",), sort, ("xla-sort",), None)),
        ("adversarial", reg, adv,
         dict(budget, budget_s=ADVERSARIAL_BUDGET_S),
         ((True,), sort, ("pallas-hash", "xla-sort"), None)),
    ]


def check_run(label, r, launches, expect) -> None:
    """Hold one main-path result to its expectation and to the kernels'
    launch counts (`launch_counts` over its run): a dense walk launches
    K3, a sort walk K3-sort, whose rounds and hash dedups are the
    result's, and never K1 or K2 alone."""
    verdicts, analyzer, dedups, p_want = expect
    k3, k3s = launches["k3_launches"], launches["k3s_launches"]
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
    if not walks_only(launches) or (k3 > 0) != dense or (k3s > 0) == dense \
            or walk_counts(launches) != (r["closure-rounds"],
                                         r["dedup-launches"]):
        raise AssertionError(f"{label}: K1 {launches['k1_launches']} / K2 "
                             f"{launches['k2_launches']} / K3 {k3} / "
                             f"K3-sort {k3s} launches, rounds and hash "
                             f"dedups {walk_counts(launches)}, for "
                             f"{r['closure-rounds']} rounds and "
                             f"{r['dedup-launches']} hash dedups")
    if p_want is not None:
        if r["dense-shape"][1:] != [8, p_want]:
            raise AssertionError(f"{label}: shape {r['dense-shape']}")
    elif r["dedup"] == "pallas-hash" and r["dedup-launches"] <= 0:
        raise AssertionError(f"{label}: no hash dedup on the hash route")


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
    bf16 tensor-core rate (every operand is 0/1 and every count an
    integer <= e <= 4,096, so bf16 operands with float32 accumulation are
    exact) and its bytes (three float32 stacks read once; four bool flags
    and an int64 residue per block written) over HBM bandwidth. A block
    takes 3 * ceil(log2 e) squarings and three more products, 2 e^3
    operations each; the residues and elementwise work are O(e^2) a
    product and left out."""
    products = 3 * kernels._steps(e) + 3
    ops = b * products * 2 * e ** 3
    nbytes = 3 * b * e * e * 4 + 12 * b
    t_o, t_b = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_o, t_b) * 1e3,
                bound_by="operations" if t_o >= t_b else "bytes",
                products_per_block=products, ops=ops, bytes=nbytes)


def squaring_bound(b, e) -> dict:
    """The least time for one K4-product squaring of a (b, e, e) stack:
    2 b e^3 operations at the bf16 rate, against the bytes of the bf16
    stack read once, the next one written once and the two int32 column
    sums written."""
    ops = 2 * b * e ** 3
    nbytes = 2 * b * e * e * 2 + 2 * b * e * 4
    t_o, t_b = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_o, t_b) * 1e3,
                bound_by="operations" if t_o >= t_b else "bytes",
                ops=ops, bytes=nbytes)


def device_ops(fn) -> dict:
    """The device operations (kernels, copies, memsets) one call of fn
    makes, from a torch.profiler trace of a second call, and their
    summed device ms; the count by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    ns = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            by_name[ev.name()[:48]] += 1
            ns += ev.duration_ns()
    return {"ops": sum(by_name.values()), "device_ms": ns / 1e6,
            "by_name": dict(by_name.most_common(8))}


def elle_time(kernels, k4, stacks, dev, iters, plain_iters) -> dict:
    """Card time of one classifier call on a bucket by CUDA events, K4
    and the plain chain in turns (plain, K4, K4, plain), after holding
    K4's flags equal to the plain chain's; and the largest residue of
    either (0, or a count was wrong)."""
    e = stacks[0].shape[-1]
    args = [torch.from_numpy(x).to(dev) for x in stacks]
    steps = kernels._steps(e)

    def fast():
        return k4.classify(*args, steps)

    def plain():
        return kernels._flags_batch(*args, steps)

    flags, res = fast()
    *pflags, pres = plain()
    if not torch.equal(flags, torch.stack(pflags, 1).to(torch.int32)):
        raise AssertionError(f"elle e={e}: K4's flags differ from the plain "
                             f"chain's on the card")
    worst = max(int(res.abs().max().item()), int(pres.abs().max().item()))
    p1 = time_ms(plain, plain_iters, warmup=1)
    k1 = time_ms(fast, iters, warmup=1)
    k2 = time_ms(fast, iters, warmup=0)
    p2 = time_ms(plain, plain_iters, warmup=0)
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, residue=worst,
                turns_ms=[p1, k1, k2, p2])


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


def phase_elle_classifier(dev, kernels, k4) -> list:
    """Step 1: random buckets through `_classify_batches` on the card
    (K4: one K4-small launch a bucket up to k4.SMALL_MAX_E, K4-product's
    chain above), flags identical to the CPU path's, the numpy mirror's
    and the plain chain's on the card, every residue 0; K4 and the plain
    chain timed in turns, K4's launches, helper launches and zero fills
    a call from its counters, the plain chain's device operations from a
    profiler trace, and torch.bmm in bf16 for one product at the shape
    (the library call)."""
    rng = np.random.default_rng(SEED + 8)
    rows = []
    for e, b in ELLE_K4_BUCKETS:
        buckets = {e: elle_bucket(e, b, rng)}
        steps = kernels._steps(e)
        before, k_before = kernels.LAUNCHES, dict(k4.LAUNCHES)
        h_before, m_before = k4.HELPER_LAUNCHES, k4.MEMSETS
        got = kernels._classify_batches(buckets, device=dev)[e]
        route = k4.route(e)
        launched = {k: k4.LAUNCHES[k] - k_before[k] for k in k4.KERNELS}
        helpers = k4.HELPER_LAUNCHES - h_before
        memsets = k4.MEMSETS - m_before
        small = route == "small"
        want = ({"small": 1 if small else 0,
                 "product": 0 if small else 3 * steps + 3},
                # four stagings, a residue a squaring and the pair test
                0 if small else 4 + 3 * steps + 1, 0 if small else 1)
        if kernels.LAUNCHES != before + 1 \
                or (launched, helpers, memsets) != want:
            raise AssertionError(f"elle bucket e={e}: {launched} K4 "
                                 f"launches, {helpers} helper launches, "
                                 f"{memsets} zero fills: a retry or "
                                 f"another route")
        t = time.perf_counter()
        cpu = kernels._classify_batches(buckets, device="cpu")[e]
        cpu_s = time.perf_counter() - t
        mirror = kernels._classify_batches_host(buckets)[e]
        args = [torch.from_numpy(x).to(dev) for x in buckets[e]]
        *plain, _r = kernels._flags_batch(*args, steps)
        plain = [f.cpu().numpy() for f in plain]
        for name, g, c, m, p in zip(ELLE_FLAGS, got, cpu, mirror, plain):
            if not (np.array_equal(g, c) and np.array_equal(g, m)
                    and np.array_equal(g, p)):
                raise AssertionError(f"elle bucket e={e} B={b}: {name} "
                                     f"differs (K4 {g}, cpu {c}, mirror "
                                     f"{m}, plain on the card {p})")
        iters = 20 if e <= 1024 else 5
        tm = elle_time(kernels, k4, buckets[e], dev, iters,
                       max(iters // 4, 3))
        if tm["residue"]:
            raise AssertionError(f"elle bucket e={e}: residue "
                                 f"{tm['residue']}")
        a16 = args[0].to(torch.bfloat16)
        library_ms = time_ms(lambda: torch.bmm(a16, a16), iters, warmup=1)
        plain_ops = device_ops(lambda: kernels._flags_batch(*args, steps))
        row = dict(e=e, B=b, route=route, ms=tm["ms"],
                   plain_ms=tm["plain_ms"], turns_ms=tm["turns_ms"],
                   cpu_s=cpu_s, residue=0, launches=launched,
                   helper_launches=helpers, memsets=memsets,
                   library_ms=library_ms,
                   plain_device_ops=plain_ops["ops"],
                   plain_device_ms=plain_ops["device_ms"],
                   plain_top=plain_ops["by_name"],
                   flags_set=[int(f.sum()) for f in got],
                   **elle_bound(kernels, e, b))
        rows.append(row)
        log(f"elle classifier e={e} B={b}: flags identical for K4 "
            f"({route}: {launched}, {helpers} helper launches, {memsets} "
            f"zero fills), the CPU path, the numpy mirror and the plain "
            f"chain on the card (set per flag {row['flags_set']}), "
            f"residues 0; K4 {row['ms']:.6f} ms a call, plain chain "
            f"{row['plain_ms']:.6f} ms ({plain_ops['ops']} device ops, "
            f"{plain_ops['device_ms']:.6f} ms on the device), torch.bmm "
            f"bf16 one product {library_ms:.6f} ms, bound "
            f"{row['bound_ms']:.6f} ms by {row['bound_by']}; CPU path "
            f"{cpu_s:.3f} s")
    return rows


def phase_elle_squaring(dev, k4) -> dict:
    """One K4-product squaring alone at ELLE_SQUARING (the rings' bucket)
    on a random sparse stack, against the plain chain's squaring
    (torch.bmm in float32, add, clamp) and torch.bmm in bf16, in turns;
    the next stack and both column sums held exact against the plain
    step."""
    b, e = ELLE_SQUARING
    rng = np.random.default_rng(SEED + 19)
    a = torch.from_numpy((rng.random((b, e, e)) < 2.0 / e)
                         .astype(np.float32)).to(dev)
    a16 = a.to(torch.bfloat16)
    stats = torch.zeros((2, b, e), dtype=torch.int32, device=dev)
    nxt = k4.product(a16, a16, a16, stats=stats)
    p = torch.bmm(a, a)
    want = p.add(a).clamp_(max=1.0)
    lhs = p.sum(dim=1, dtype=torch.float64).to(torch.int64)
    if not (torch.equal(nxt.float(), want)
            and torch.equal(stats[0].long(), lhs)
            and torch.equal(stats[1].long(), want.sum(dim=1).long())):
        raise AssertionError("K4-product squaring differs from the plain "
                             "step")
    del p, want, lhs
    stats.zero_()

    def plain():
        return torch.bmm(a, a).add_(a).clamp_(max=1.0)

    p1 = time_ms(plain, 3, warmup=1)
    k1 = time_ms(lambda: k4.product(a16, a16, a16, stats=stats), 10,
                 warmup=1)
    k2 = time_ms(lambda: k4.product(a16, a16, a16, stats=stats), 10,
                 warmup=0)
    p2 = time_ms(plain, 3, warmup=0)
    library_ms = time_ms(lambda: torch.bmm(a16, a16), 10, warmup=1)
    out = dict(B=b, e=e, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
               turns_ms=[p1, k1, k2, p2], library_ms=library_ms,
               max_abs_err=0.0, **squaring_bound(b, e))
    log(f"elle K4-product squaring (B, e) = ({b}, {e}): the next stack "
        f"and both column sums exact against the plain step; K4 "
        f"{out['ms']:.6f} ms, plain {out['plain_ms']:.6f} ms, torch.bmm "
        f"bf16 {library_ms:.6f} ms, bound {out['bound_ms']:.6f} ms by "
        f"{out['bound_by']} (turns {out['turns_ms']})")
    return out


def phase_elle(dev, synth, kernels, k4, list_append, wr, platform) -> dict:
    """Steps 2-6 of the Elle phase (step 1: phase_elle_classifier and
    phase_elle_squaring). K4's launches are set to 0 just before step 2
    and read just after step 5: the Elle path's K4 launches."""
    out = {"buckets": phase_elle_classifier(dev, kernels, k4),
           "squaring": phase_elle_squaring(dev, k4)}
    zero_launches()

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
        with K4Uncounted():
            tm = elle_time(kernels, k4, stacks, dev, 3, 2)
        if tm["residue"]:
            raise AssertionError(f"rings n={n}: residue {tm['residue']}")
        row = dict(nodes=n, bucket=list(stacks[0].shape), wall_s=wall,
                   ms=tm["ms"], plain_ms=tm["plain_ms"],
                   turns_ms=tm["turns_ms"], peak_gb=peak_gb, residue=0,
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
            f"residue 0; analyze_edges wall {wall:.3f} s, K4 "
            f"{row['ms']:.3f} ms a classifier call, plain chain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
            f"by {row['bound_by']} ({row['ops'] / 1e12:.3f} T operations, "
            f"{row['products_per_block']} products a block), peak "
            f"{peak_gb:.3f} GiB"
            + (f"; equal to the CPU path ({row['cpu_s']:.3f} s)"
               if "cpu_s" in row else ""))

    out["k4_launches"] = {k: v for k, v in launch_counts().items()
                          if k.startswith("k4_")}
    if not (out["k4_launches"]["k4_small_launches"] > 0
            and out["k4_launches"]["k4_product_launches"] > 0):
        raise AssertionError(f"the Elle path missed a K4 kernel: "
                             f"{out['k4_launches']}")
    log(f"elle K4 launches over steps 2-5: {out['k4_launches']}")

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
        k3, k3s = n["k3_launches"], n["k3s_launches"]
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
            f"K3 launches {k3} ({n['k3_rounds']} rounds), K3-sort launches "
            f"{k3s} ({n['k3s_rounds']} rounds, {n['k3s_dedups']} hash "
            f"dedups), K2 launches {n['k2_launches']}, host syncs "
            f"{r['host-syncs']}, recovered "
            f"{r.get('recovered')}; final "
            f"carry equals the offline walk's")
        if r["valid?"] is not expect \
                or s.device.type != torch.device(dev).type \
                or r["device"] != str(s.device):
            raise AssertionError(f"{label}: {r['valid?']} on {r['device']}")
        dense = s.engine == "dense"
        if not walks_only(n) or (k3 > 0) != dense or (k3s > 0) == dense \
                or walk_counts(n) != (r["closure-rounds"],
                                      r["dedup-launches"]):
            raise AssertionError(f"{label}: K1 {n['k1_launches']} / K2 "
                                 f"{n['k2_launches']} / K3 {k3} / K3-sort "
                                 f"{k3s} launches, rounds and hash dedups "
                                 f"{walk_counts(n)}, for "
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

    # 2. the sort stream, fed until the violation shows: K3-sort
    plain = synth.register_history(**STREAM_ABORT_HIST)
    bad = synth.corrupt(plain, seed=11)
    bad_at = next(i for i, (a, b) in enumerate(zip(plain.ops, bad.ops))
                  if a != b)
    s, r, _walk = card_stream("sort-abort", bad, False, abort=True,
                              **STREAM_ABORT)
    rec = out["sort-abort"]
    rec["violation_injected_at_op"] = bad_at
    if rec["dedup"] != "pallas-hash" or rec["k3s_launches"] <= 0 \
            or rec["k3s_dedups"] <= 0 or rec["k2_launches"] != 0 \
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
                  service, store, telemetry, platform, pool,
                  cpu_jobs=None) -> dict:
    """Phase 9: the verification service on the card. Sixteen streams
    (8 dense, K3; 8 packed sort, K3-sort) in one service, each result
    held against the stream alone on the card and on the CPU path (the
    CPU path in worker processes of `pool`: `cpu_jobs`, futures of
    `cpu_service_stream` by stream, submitted here unless the caller
    started them earlier); every kernel's launch count set
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
    if cpu_jobs is None:
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
    sort_rounds = sum(res[i]["closure-rounds"] for i in range(n)
                      if i not in dense)
    k2 = sum(r["dedup-launches"] for r in res.values())
    for i in range(n):
        r = res[i]
        if i in dense and (r["analyzer"] != "gpu-wgl-dense-streaming"
                           or r["closure-rounds"] <= 0
                           or r["dedup-launches"] != 0):
            raise AssertionError(f"s{i}: not a dense stream on K3: {r}")
        if i not in dense and (r["dedup"] != "pallas-hash"
                               or r["dedup-launches"] <= 0):
            raise AssertionError(f"s{i}: not a hash stream on K3-sort: {r}")
    if (k1, sort_rounds, k2) != (launches["k3_rounds"],
                                 launches["k3s_rounds"],
                                 launches["k3s_dedups"]) \
            or not walks_only(launches) or launches["k3_launches"] <= 0 \
            or launches["k3s_launches"] <= 0:
        raise AssertionError(f"service: streams count {k1} dense rounds, "
                             f"{sort_rounds} sort rounds, {k2} hash "
                             f"dedups; the kernels {launches}")
    st = clean["status"]
    if any(v["state"] != "verdict" for v in st["streams"].values()) \
            or st["budget"]["capacity"] != st["budget"]["initial"]:
        raise AssertionError(f"service status: {st['budget']} "
                             f"{[v['state'] for v in st['streams'].values()]}")
    out["launches"] = launches
    out["per_stream"] = {f"s{i}": {
        "valid": res[i]["valid?"], "op_index": res[i].get("op-index"),
        "engine": "dense" if i in dense else res[i]["dedup"],
        "chunks": res[i]["chunks"], "rounds": res[i]["closure-rounds"],
        "hash_dedups": res[i]["dedup-launches"],
        "host_syncs": res[i]["host-syncs"], "alone_s": solo_s[i],
        "served_s": clean["lat"][i]} for i in range(n)}
    out["calibration"] = st["calibration"]
    out["budget"] = st["budget"]
    out["isolation_overhead"] = {
        f"s{i}": clean["lat"][i] / solo_s[i] for i in (0, 8)}
    log(f"service: 16 streams: K3 {launches['k3_launches']} launches "
        f"with {launches['k3_rounds']} rounds (streams 0-7), K3-sort "
        f"{launches['k3s_launches']} launches with "
        f"{launches['k3s_rounds']} rounds and {launches['k3s_dedups']} "
        f"hash dedups (streams 8-15), K1 and K2 none, each "
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
    batch (dense: K3) and of the counter batch (hash route: K3-sort) through
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
            if hz_r["k3_launches"] <= 0 or not walks_only(hz_r) \
                    or not walks_only(cnt_r) \
                    or cnt_r["k3s_launches"] <= 0 or rk["backend"] != "gloo" \
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
                f"{rk['counter']['wall_s']:.3f} s (K3-sort launches "
                f"{rk['counter']['k3s_launches']}), collectives "
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
            f"{rec['k3_launches']}, K3-sort launches {rec['k3s_launches']}, "
            f"K2 launches {rec['k2_launches']}, "
            f"classifier calls {rec['classifier_calls']}, K4 launches "
            f"(small, product, helpers) {rec['k4_small_launches']}, "
            f"{rec['k4_product_launches']}, {rec['k4_helper_launches']}, "
            f"collectives {rec['collectives']}")
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
             "slots": BATCH_SLOTS}] or rec["k3s_launches"] <= 0 \
            or not walks_only(rec):
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
    if g != elle["g1c_result"] or rec["classifier_calls"] != 1 \
            or rec["k4_small_launches"] < 1:
        raise AssertionError("sharded Elle: the result differs from the "
                             "Elle phase's, or K4 did not classify it")
    out["elle"] = rec

    adj = ring_adjacency(SHARDED_RING)
    steps = kernels._steps(SHARDED_RING)
    t = time.perf_counter()
    unsharded, nomesh = run(f"transitive_closure of a {SHARDED_RING}-node "
                            f"ring without the mesh",
                            lambda: kernels.transitive_closure(adj,
                                                               device=dev))
    nomesh_s = time.perf_counter() - t
    closed, rec = run(f"transitive_closure of a {SHARDED_RING}-node ring",
                      lambda: kernels.transitive_closure(adj, mesh=mesh))
    if not (np.array_equal(closed, unsharded) and closed.all()) or \
            rec["k4_product_launches"] != steps or \
            nomesh["k4_product_launches"] != steps:
        raise AssertionError(f"sharded transitive_closure differs, or did "
                             f"not take {steps} K4-product launches")
    out["closure"] = dict(rec, plain_s=nomesh_s, nomesh=nomesh)
    log(f"sharded: per_key equal to the batch phase's, the group plan the "
        f"JAX package's {[(g['slots'], g['keys']) for g in SHARDED_GROUPS]}, "
        f"the OOM split, the Elle result equal to the Elle phase's, the "
        f"ring's closure equal without the mesh ({nomesh_s:.3f} s), "
        f"{steps} K4-product launches each way; all collectives on "
        f"{dev.type} tensors: {dict(mesh.calls)}")
    return out


def counting_plain():
    """Count the plain versions' calls of K1 and K2 in this (CPU) process:
    the closure rounds and hash dedups the card's K3 and K3-sort walks
    of the same work must report."""
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
        if (rec["k3_rounds"], rec["k3s_dedups"]) != (counts["k1"],
                                                     counts["k2"]) \
                or not walks_only(rec):
            raise AssertionError(f"{label}: K3 rounds / K3-sort hash "
                                 f"dedups {rec['k3_rounds']}/"
                                 f"{rec['k3s_dedups']} (K1 "
                                 f"{rec['k1_launches']}, K2 "
                                 f"{rec['k2_launches']}), CPU path "
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
            f"K3-sort launches {rec['k3s_launches']}, K2 launches "
            f"{rec['k2_launches']}, equal to the CPU path")
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
            f"{rec['k3_launches']}, K3-sort launches {rec['k3s_launches']}, "
            f"K2 launches {rec['k2_launches']}, equal to the CPU path")
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
    if rec["k3_launches"] <= 0 or not walks_only(rec) or walk_counts(
            rec) != (tot["closure_rounds"], tot["dedup_launches"]):
        raise AssertionError(f"register run: rounds / hash dedups "
                             f"{walk_counts(rec)} (K1 {rec['k1_launches']}, "
                             f"K2 {rec['k2_launches']}) for {tot}")

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
        f"{rec['wall_s']:.3f} s, K3 launches {rec['k3_launches']}, "
        f"K3-sort launches {rec['k3s_launches']}, K2 launches "
        f"{rec['k2_launches']}")
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
            without_walk_syncs({f: r.get(f) for f in BATCH_AGREE_KEYS}),
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
                f"K2 {row['k2_launches']}, K3 {row['k3_launches']}, K4 "
                f"(small, product) {row['k4_small_launches']}, "
                f"{row['k4_product_launches']}")
            if res["valid?"] is not False or w["valid?"] is not False or \
                    WORKLOAD_ANOMALY[kind] not in w.get("anomaly-types", ()):
                raise AssertionError(f"{kind} run: {res['valid?']}, "
                                     f"{w.get('anomaly-types')}")
            if n_ops != 2 * WORKLOAD_RUN["invocations"] + len(nem) or \
                    {o["f"] for o in nem} != {"start", "stop"}:
                raise AssertionError(f"{kind} run: {n_ops} ops, nemesis "
                                     f"{sorted({o['f'] for o in nem})}")
            k4_calls = sum(len(bk) for bk in buckets)
            if row["classifier_calls"] < 1 or row["k1_launches"] or \
                    row["k2_launches"] or row["k3_launches"] or \
                    row["k3s_launches"] or any(
                        int(e) > 4096 for bk in buckets for e in bk) or \
                    row["k4_small_launches"] + row["k4_product_launches"] \
                    < k4_calls:
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
    # a run walks with K3, but the one register of hazelcast's may go to
    # the sort family, K3-sort; their rounds and hash dedups are the
    # walks' count, and K1 and K2 never launch alone
    walked = row["k3_launches"] > 0 or (kind == "hazelcast"
                                        and row["k3s_launches"] > 0)
    launched = walked and walks_only(row) and walk_counts(row) == want
    log(f"suite {kind}: valid?={res['valid?']} ({detail}), {n_ops} "
        f"history ops ({rate:.0f} client ops/s), {len(nem)} nemesis ops, "
        f"{len(cut)} iptables commands, wall {wall:.3f} s (interpreter "
        f"{interp_s:.3f} s, check {row['check_s']:.3f} s, of which the "
        f"workload's on the card {row['workload_check_s']:.3f} s), K3 "
        f"launches {row['k3_launches']} ({row['k3_rounds']} rounds), "
        f"K3-sort launches {row['k3s_launches']}, K2 launches "
        f"{row['k2_launches']}; "
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
    # phase 8's dense stream, the main path's agreement runs, phase 6's
    # two batches and phase 9's streams (the card's service
    # runs take seconds, and the phase waited on these)
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
        cpu_service = {i: pool.submit(cpu_service_stream, i)
                       for i in range(SERVICE_STREAMS)}
        return run_phases(args, dev, name, smi, phase_s, phase_done, pool,
                          cpu_dense, cpu_batches, cpu_agree, cpu_service)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_phases(args, dev, name, smi, phase_s, phase_done, pool, cpu_dense,
               cpu_batches, cpu_agree, cpu_service) -> int:
    """Phases 2-17 of `main`, given the worker pool and its first jobs."""
    from jepsen_tpu_torch import (_platform, graft_entry, independent,
                                  models, parallel, service, store,
                                  telemetry)
    from jepsen_tpu_torch.carry import carry_to_numpy
    from jepsen_tpu_torch.checker import (linear, screen, streaming, synth,
                                          wgl, wgl_closure, wgl_dedup,
                                          wgl_sortwalk, wgl_walk)
    from jepsen_tpu_torch.checker.elle import k4 as elle_k4
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
    passes = sort_passes()
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
                              sort_passes=passes.take(), **launches)
        log(f"{label}: valid?={r['valid?']} op-index={r.get('op-index')} "
            f"analyzer={r['analyzer']} dedup={r['dedup']} frontier-size="
            f"{r['frontier-size']} shape={r.get('dense-shape')} "
            f"max-frontier={r['max-frontier']} wall={wall:.3f} s K1 "
            f"launches={launches['k1_launches']} K2 launches="
            f"{launches['k2_launches']} K3 launches="
            f"{launches['k3_launches']} (rounds {launches['k3_rounds']}) "
            f"K3-sort launches={launches['k3s_launches']} (rounds "
            f"{launches['k3s_rounds']}, hash dedups "
            f"{launches['k3s_dedups']}) "
            f"closure rounds={r['closure-rounds']} host syncs="
            f"{r['host-syncs']} error={r.get('error')}")
        if label in ("adversarial", "at-cap"):
            log_passes(label, results[label]["sort_passes"])
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
        for key in ("valid?", "op-index", "max-frontier", "frontier-size",
                    "dedup", "analyzer", "dense-shape", "closure-rounds",
                    "dedup-launches"):
            if g.get(key) != c.get(key):
                raise AssertionError(f"{label}: {key} gpu {g.get(key)} "
                                     f"!= cpu {c.get(key)}")
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
    k3s = phase_k3s(dev, models, synth, wgl, streaming, carry_to_numpy,
                    hists["headline"][1])
    phase_done("K3-sort against the eager walk")

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
    elle = phase_elle(dev, synth, elle_kernels, elle_k4, list_append, wr,
                      _platform)
    phase_done("elle")

    # -- phase 8: streaming, the tier and the race ----------------------------
    streams = phase_stream(dev, models, synth, wgl, streaming, screen,
                           linear, wr, _platform, carry_to_numpy,
                           cpu_results["headline"], pool, cpu_dense)
    phase_done("streaming, tier and race")

    # -- phase 9: the verification service ------------------------------------
    svc = phase_service(dev, models, synth, streaming, service, store,
                        telemetry, _platform, pool, cpu_service)
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
    # K3-sort, the sort step walk: ms is its device time a launch on the
    # phantom walk (a window of up to 1,024 steps), plain_ms the eager
    # walk's wall over the same windows, bound_ms k3s_bound's over them;
    # its launches over the main path, then the other phases'
    ph = k3s["walks"]["phantom"]
    pp = k3s["profiles"]["phantom"]["k3s_full"]
    kernels.append({
        "name": "sort_walk", "route": "cuda", "source": wgl_sortwalk.SOURCE,
        "replaces": wgl_sortwalk.REPLACES,
        "launches": main_launches["k3s_launches"],
        "rounds": main_launches["k3s_rounds"],
        "hash_dedups": main_launches["k3s_dedups"],
        "max_abs_err": max(w["max_abs_err"] for w in k3s["walks"].values()),
        "ms": pp["k3s_ms"] / pp["k3s_launches"],
        "plain_ms": ph["eager_wall_s"] * 1e3 / ph["k3_launches"],
        "bound_ms": ph["bound_ms"] / ph["k3_launches"],
        "bound_by": ph["bound_by"], "library_ms": None,
        # no PyTorch call computes the walk; torch.sort(stable=True) of one
        # dedup's keys beside K3-sort's device ms a dedup (`k3s_library`)
        "sort_library_ms": {str(n): v for n, v in k3s["library"].items()},
        "shape": [ph["F"], ph["P"], ph["route"]],
        "walk_ms": ph["k3_wall_s"] * 1e3,
        "plain_walk_ms": ph["eager_wall_s"] * 1e3,
        "batch_launches": batch["sort"]["k3s_launches"],
        "stream_launches": streams["sort-abort"]["k3s_launches"],
        "service_launches": svc["launches"]["k3s_launches"],
        "sharded_launches": sharded["world1"]["counter"]["k3s_launches"],
        "search_launches": sum(v["k3s_launches"] for k, v in
                               search_chaos.items() if k != "chaos-cli"),
        "run_launches": sum(run_path[r]["k3s_launches"] for r in (
            "online", "abort", "cli-test", "cli-analyze")),
        "suite_launches": suites["hazelcast"]["k3s_launches"],
        "walks": k3s["walks"]})
    # K4, the Elle classifier and closure: K4-small's numbers are
    # one classifier call on the (8, 64) bucket (one launch), K4-product's
    # one squaring of the rings' (4, 4096) stack; launches over the Elle
    # phase's history checks (steps 2-5), then the other phases'. Flags,
    # counts and residues are compared exactly, so max_abs_err is 0
    eb = next(r for r in elle["buckets"] if (r["e"], r["B"]) == (8, 64))
    sq, rings = elle["squaring"], elle["rings"][ELLE_RING]
    wk = (run_path["workloads"]["monotonic"],
          run_path["workloads"]["sequential"])
    w1 = sharded["world1"]
    kernels.append({
        "name": "elle_small", "route": "cuda", "source": elle_k4.SOURCE,
        "replaces": elle_k4.REPLACES["small"],
        "launches": elle["k4_launches"]["k4_small_launches"],
        "max_abs_err": 0.0, "ms": eb["ms"], "plain_ms": eb["plain_ms"],
        "bound_ms": eb["bound_ms"], "bound_by": eb["bound_by"],
        # torch.bmm in bf16 of one of the call's products
        "library_ms": eb["library_ms"], "shape": [eb["B"], eb["e"]],
        "small_max_e": elle_k4.SMALL_MAX_E,
        "sharded_launches": w1["elle"]["k4_small_launches"],
        "workload_launches": sum(r["k4_small_launches"] for r in wk),
        "buckets": [{k: r[k] for k in (
            "e", "B", "route", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "launches", "helper_launches", "memsets",
            "plain_device_ops")}
            for r in elle["buckets"]]})
    kernels.append({
        "name": "elle_product", "route": "cuda", "source": elle_k4.SOURCE,
        "replaces": elle_k4.REPLACES["product"],
        "launches": elle["k4_launches"]["k4_product_launches"],
        "helper_launches": elle["k4_launches"]["k4_helper_launches"],
        "memsets": elle["k4_launches"]["k4_memsets"],
        "max_abs_err": 0.0, "ms": sq["ms"], "plain_ms": sq["plain_ms"],
        "bound_ms": sq["bound_ms"], "bound_by": sq["bound_by"],
        # torch.bmm in bf16: the same product without the epilogue
        "library_ms": sq["library_ms"], "shape": [sq["B"], sq["e"]],
        "rings_call_ms": rings["ms"], "rings_plain_call_ms":
        rings["plain_ms"], "rings_bound_ms": rings["bound_ms"],
        "sharded_launches": w1["closure"]["k4_product_launches"]
        + w1["closure"]["nomesh"]["k4_product_launches"],
        "workload_launches": sum(r["k4_product_launches"] for r in wk)})
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
            "profiles": profiles, "k3": k3, "k3s": k3s, "batch": batch,
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
