"""Key-sharded checking over a `torch.distributed` process group.

The port's counterpart of `jax.sharding.Mesh` and `jax.devices()`. The
JAX package shards a batch over a device mesh with `shard_map`: one
process drives every device and the psum runs inside one XLA program.
PyTorch's idiom is SPMD: one process per rank, each on its own device,
with explicit collectives. Every rank calls the same checking entry
with the same inputs, walks its own block of the keys, and gets back
the same result, equal to the JAX package's over a mesh of the same
size.

  * `Mesh` is a process group, the name of its axis and the device this
    rank computes on; `as_mesh` also takes a
    `torch.distributed.device_mesh.DeviceMesh` that names the axis.
  * `psum`, `pmax` and `all_gather_rows` are the collectives the
    sharded paths need, on tensors on the rank's device (NCCL on CUDA,
    gloo on the CPU and for ranks that share a card).
  * `agree` keeps a fault on one rank from leaving the others blocked in
    a collective: after each local dispatch every rank reduces a fault
    code (a MAX over the classified buckets), and when any rank faulted,
    every rank raises the same bucket into the same recovery rung.
  * `init` joins a process group with a timeout, so a collective that
    waits on a dead rank fails instead of hanging; `spawn` runs a
    function in n spawned ranks and joins them under a time limit,
    killing every rank when it expires.

NCCL runs one rank per card: on one card several ranks run only under
gloo (`default_backend`).
"""

from __future__ import annotations

import collections
import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ._platform import (FAULT_COMPILE, FAULT_CORRUPT, FAULT_DEVICE_LOST,
                        FAULT_OOM, FAULT_WEDGED, classify_backend_error,
                        resolve_device)

AXIS = "keys"
# a collective waits this long for its peers before it raises
PG_TIMEOUT_S = 120.0
# spawn's default join limit for all ranks together
SPAWN_TIMEOUT_S = 600.0
# after one rank raised, how long spawn waits for the others' reports
ERROR_GRACE_S = 30.0


class Mesh:
    """One axis of ranks: a process group (None: this process alone,
    with no process group, where every collective is the identity),
    the axis name and the device this rank computes on. `calls` counts
    the collectives run through it, by (op, device type)."""

    def __init__(self, group=None, axis: str = AXIS, device=None):
        self.group = group
        self.axis = axis
        self.device = resolve_device(device)
        self.calls: collections.Counter = collections.Counter()

    @property
    def size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n items padded up to a
        multiple of the axis size, as `PartitionSpec(axis)` places it."""
        per = -(-n // self.size)
        return slice(self.rank * per, (self.rank + 1) * per)

    def __repr__(self) -> str:
        return (f"Mesh(axis={self.axis!r}, size={self.size}, "
                f"rank={self.rank}, device={self.device})")


def as_mesh(mesh, axis: str | None = None) -> Mesh:
    """A `Mesh` from a `Mesh` or a `DeviceMesh`. axis names the mesh
    dimension to shard over (None: the mesh's first). A DeviceMesh
    computes on its device type's current device."""
    if isinstance(mesh, Mesh):
        if axis is not None and axis != mesh.axis:
            raise ValueError(f"the mesh's axis is {mesh.axis!r}, not "
                             f"{axis!r}")
        return mesh
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "mesh must be a jepsen_tpu_torch.parallel.Mesh or a "
            "torch.distributed.device_mesh.DeviceMesh, got "
            f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    axis = axis if axis is not None else (names[0] if names else AXIS)
    if axis not in names:
        raise ValueError(f"the DeviceMesh names no axis {axis!r} (its "
                         f"dimensions: {names})")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else mesh.device_type)
    return Mesh(mesh.get_group(axis), axis, dev)


def resolve(mesh, device=None, axis: str | None = None) -> tuple:
    """(Mesh or None, device) of an entry's mesh= and device= options.
    Without a mesh, device (None: CUDA); with one, the mesh's device,
    where its collectives run: a device= of another type raises."""
    if mesh is None:
        return None, resolve_device(device)
    m = as_mesh(mesh, axis)
    if device is not None and resolve_device(device).type != m.device.type:
        raise ValueError(f"device={device!r} is not the mesh's device type "
                         f"({m.device}): a rank computes on its mesh's "
                         f"device")
    return m, m.device


def local_mesh(device=None, axis: str = AXIS) -> Mesh:
    """The mesh of this process alone: world size 1, no collective."""
    return Mesh(None, axis, device)


def default_mesh(axis: str = AXIS, device=None) -> Mesh:
    """The counterpart of a mesh over `jax.devices()`: the default
    process group where one is initialized, else this process alone."""
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.group.WORLD, axis, device)
    return local_mesh(device, axis)


# -- collectives ------------------------------------------------------------

def _count(mesh: Mesh, op: str, t: torch.Tensor) -> None:
    mesh.calls[(op, t.device.type)] += 1


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the axis, on every rank (`jax.lax.psum`)."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM, "psum")


def pmax(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of t over the axis, on every rank."""
    return _all_reduce(mesh, t, dist.ReduceOp.MAX, "pmax")


def _all_reduce(mesh: Mesh, t: torch.Tensor, op, name: str) -> torch.Tensor:
    out = t.clone()
    if mesh.group is not None:
        _count(mesh, name, out)
        dist.all_reduce(out, op=op, group=mesh.group)
    return out


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of t (the same shape on each), concatenated in
    rank order along dim 0, on every rank."""
    if mesh.group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    _count(mesh, "all_gather", t)
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts)


# -- fault agreement ----------------------------------------------------------

# agreement codes, in increasing precedence: a fault the ladder re-raises
# (compile) beats one it retries, and an exception that is no device
# fault (a bug, UNCLASSIFIED) beats every fault
_FAULT_CODES = {FAULT_WEDGED: 1, FAULT_CORRUPT: 2, FAULT_OOM: 3,
                FAULT_DEVICE_LOST: 4, FAULT_COMPILE: 5}
_UNCLASSIFIED = 6
_CODE_KINDS = {c: k for k, c in _FAULT_CODES.items()}


class PeerFault(RuntimeError):
    """Another rank's local dispatch raised. `kind` is the agreed fault
    bucket, so `classify_backend_error` places this rank's copy in the
    same rung; None when the other rank's exception was no device fault,
    which the ladders re-raise."""

    def __init__(self, kind: str | None):
        super().__init__(
            f"a peer rank's dispatch raised a {kind} fault" if kind
            else "a peer rank's dispatch raised an exception that is no "
                 "device fault (see that rank's error)")
        self.kind = kind


def _code(exc: BaseException) -> int:
    kind = classify_backend_error(exc)
    return _FAULT_CODES[kind] if kind is not None else _UNCLASSIFIED


def agree(mesh: Mesh, exc: BaseException | None) -> None:
    """Called by every rank after its local dispatch with the exception
    it raised (None if none). When any rank raised, every rank raises:
    a rank whose own exception carries the agreed code re-raises it, the
    others raise `PeerFault` of the agreed bucket."""
    if mesh.group is None:
        if exc is not None:
            raise exc
        return
    code = 0 if exc is None else _code(exc)
    agreed = int(pmax(mesh, torch.tensor([code], dtype=torch.int32,
                                         device=mesh.device)).item())
    if agreed == 0:
        return
    if exc is not None and code == agreed:
        raise exc
    raise PeerFault(_CODE_KINDS.get(agreed))


# -- process groups and spawned ranks ----------------------------------------

def rank_device(device, rank: int) -> torch.device:
    """The device rank computes on: a CUDA request without an index maps
    rank r to card r mod the card count (several ranks share a card when
    there are fewer cards than ranks); anything else as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def default_backend(device, world: int) -> str:
    """gloo on the CPU; on CUDA, NCCL when every rank has its own card
    (NCCL refuses two ranks on one card), else gloo."""
    dev = resolve_device(device)
    own_card = world == 1 or (dev.index is None
                              and world <= torch.cuda.device_count())
    return "nccl" if dev.type == "cuda" and own_card else "gloo"


def init(rank: int, world: int, init_method: str, *,
         device=None) -> Mesh:
    """Join the default process group as `rank` of `world` at
    init_method (e.g. ``file:///tmp/x`` or ``tcp://localhost:PORT``)
    under `default_backend`, with collectives that raise after
    PG_TIMEOUT_S, and return the Mesh over it on this rank's device
    (`rank_device`; device None: CUDA, raising without it)."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        default_backend(device, world), init_method=init_method,
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return Mesh(dist.group.WORLD, AXIS, dev)


class RankError(RuntimeError):
    """One or more spawned ranks raised, died or outlived the join limit.
    `errors` maps each such rank to what it reported."""

    def __init__(self, errors: dict):
        self.errors = dict(sorted(errors.items()))
        super().__init__("; ".join(f"rank {r}: {e.strip().splitlines()[-1]}"
                                   for r, e in self.errors.items()))


def _rank_main(fn, rank, world, init_method, device, results) -> None:
    if resolve_device(device).type == "cpu":
        # the ranks share the host's cores: split them, not oversubscribe
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        mesh = init(rank, world, init_method, device=device)
        try:
            out = fn(mesh=mesh)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — the parent raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, *, device=None,
          timeout_s: float = SPAWN_TIMEOUT_S) -> list:
    """Run fn(mesh=mesh) in `world` spawned ranks joined at a ``file://``
    rendezvous in a fresh temporary directory, and return each rank's
    value in rank order. fn is pickled by its import path (a module-level
    function, or a functools.partial of one). device as in `init`.

    Raises RankError when a rank raises or dies, and when the ranks have
    not all returned within timeout_s; every rank still running is
    killed before it returns or raises."""
    resolve_device(device)  # no CUDA asked of a machine without it
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="jepsen-tpu-torch-ranks-")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True, name=f"jepsen-rank-{r}",
        args=(fn, r, world, init_method, device, results))
        for r in range(world)]
    values: dict = {}
    errors: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        dead_at: dict = {}
        while len(values) + len(errors) < world:
            now = time.monotonic()
            if now >= deadline:
                for r in range(world):
                    if r not in values and r not in errors:
                        errors[r] = (f"no result within the {timeout_s} s "
                                     f"join limit; killed")
                break
            try:
                r, ok, out = results.get(timeout=min(1.0, deadline - now))
            except queue.Empty:
                # a rank that died without reporting (a crash, a kill):
                # give its last words a second to arrive through the
                # queue, then count it
                for r, p in enumerate(procs):
                    if r in values or r in errors or p.exitcode is None:
                        continue
                    if now - dead_at.setdefault(r, now) > 1.0:
                        errors[r] = f"exited with code {p.exitcode}"
                continue
            (values if ok else errors)[r] = out
            if not ok:
                # the others raise too (`agree`) or are stuck waiting on
                # this rank: give them a grace period, not the whole limit
                deadline = min(deadline, time.monotonic() + ERROR_GRACE_S)
        for p in procs:
            p.join(max(0.0, min(5.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RankError(errors)
    return [values[r] for r in range(world)]


def in_order(fns, env: dict | None = None, *, mesh: Mesh) -> list:
    """A rank function for `spawn` that runs several: it sets env[rank]'s
    environment variables in this rank (a fault injected on one rank),
    then calls each of fns(mesh=mesh) in order on the one mesh and
    returns their values."""
    os.environ.update((env or {}).get(mesh.rank, {}))
    return [f(mesh=mesh) for f in fns]
