"""jepsen_tpu_torch — the PyTorch/CUDA port of jepsen_tpu's history checkers.

The port lives beside the JAX package and follows its layout module for
module, so each file here names its counterpart there. It imports
`torch` and never `jax`, and it imports nothing of `jepsen_tpu`: the host
modules it needs (`history`, `models`, the `abft` host digests, `synth`)
are its own copies.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (see `_platform`).

Ported so far: the offline linearizability check of a history
(`checker.wgl.analysis_gpu`) on both engine families, the dense
reachable-set table, whose closure round is the hand-written Hopper
kernel `csrc/closure_round.cu` and whose whole step walk runs on the
card as `csrc/dense_walk.cu` with that round inside, and the sort
frontier, whose hash dedup
is the hand-written Hopper kernel `csrc/dedup.cu`; the batched check of
many histories (`checker.wgl.analysis_gpu_batch`, both kernels with a
batch axis) behind the independent checker (`independent`); and the
recovery ladder with fault injection (`_platform`) around both entries;
Elle's transactional-cycle checks (`checker.elle`: list-append and
rw-register, their SCC classifier batched on the card); the tier-1
screen, the competition race and online streaming checks
(`checker.screen`, `checker.streaming`); and the persistent
verification service (`service`, with `calibrate`, `store` and
`reconnect`), whose daemon runs as ``python -m jepsen_tpu_torch
service``; key-sharded checking over a process group (`parallel`) and
the driver entries (`graft_entry`); and the generator package
(`generator`), the coverage-guided scenario search (`search`) and the
self-chaos harness (`chaos`), with their ``search`` and ``chaos``
commands; and the `core.run` path a test map runs through (`core`:
`control`, `os_`, `net`, `nemesis`, the interpreter in
`generator.interpreter`, `store`, the host checkers in `checker.basic`,
`clock`, `timeline` and `perf` with `plot`, `workloads`, and the
``test``, ``analyze`` and ``test-all`` commands in `cli`), whose final
check reaches both kernels.
"""

__version__ = "0.1.0"
