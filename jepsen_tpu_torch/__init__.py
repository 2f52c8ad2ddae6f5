"""jepsen_tpu_torch — the PyTorch/CUDA port of jepsen_tpu's history checkers.

The port lives beside the JAX package and follows its layout module for
module, so each file here names its counterpart there. It imports
`torch` and never `jax`, and it imports nothing of `jepsen_tpu`: the host
modules it needs (`history`, `models`, the `abft` host digests, `synth`)
are its own copies.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (see `_platform`).

This slice covers the offline linearizability check of a history on the
dense reachable-set engine (`checker.wgl.analysis_gpu`), whose closure
round is the hand-written Hopper kernel `csrc/closure_round.cu`.
"""

__version__ = "0.1.0"
