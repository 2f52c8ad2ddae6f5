"""K4: the Elle classifier and the transitive closure, hand-written for
Hopper.

Replaces the JAX package's device programs
`jepsen_tpu/checker/elle/kernels.py:175` (`_flags_batch_fn`, a jit of a
vmap whose three closures are each a `lax.scan` of squarings with a
column-checksum residue) and `:698` (`_closure_fn`, behind
`transitive_closure`). Their plain PyTorch versions stay in `kernels.py`:
`_closure` and `_flags_batch` (a chain of about ten torch launches a
squaring) and `transitive_closure`'s `torch.mm` loop.

Two kernels in `csrc/elle_closure.cu`:

  * K4-small classifies a whole (B, e, e) bucket in one launch for e up
    to `SMALL_MAX_E`: each SCC block's matrices bit-packed in shared
    memory, the path counts of a squaring by popcount, the residue's two
    sides and the four flags on chip;
  * K4-product is one squaring ``A_r <- min(A_r + A_r A, 1)`` of bf16 0/1
    matrices on the tensor cores (float32 accumulators: every count is an
    exact integer), its epilogue writing the next A and the column sums
    the residue needs. The buckets above `SMALL_MAX_E` run their
    classifier as a chain of it (3 ceil(log2 e) + 3 products a block)
    with three small helpers (the staged input, the residue's right
    side, the G2-item pair test); `transitive_closure` runs one a
    squaring, on a mesh on this rank's row block.

`classify` and `square_rows` are the entry points: on a CPU tensor they
run the plain version, on a CUDA tensor they launch the kernels or raise
(a refused launch raises `KernelLaunchError`; nothing falls back to the
plain chain). `LAUNCHES` counts each kernel's launches, `HELPER_LAUNCHES`
the helpers', `MEMSETS` the zero fills of the product chain's workspace
(one a call).

What bounds them on an H100, and what the design does about it, is in
the source's head note.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ... import _build
from ..._platform import KernelLaunchError

SOURCE = "jepsen_tpu_torch/csrc/elle_closure.cu"
REPLACES = {
    "small": "jepsen_tpu/checker/elle/kernels.py:175",
    "product": "jepsen_tpu/checker/elle/kernels.py:175, :698",
}
KERNELS = ("small", "product")
LAUNCHES = dict.fromkeys(KERNELS, 0)   # by `_launch`, and nothing else
HELPER_LAUNCHES = 0                    # prep, rhs and pair launches
MEMSETS = 0                            # zero fills of `_workspace`
# buckets up to this e classify in one K4-small launch; larger ones on
# K4-product's chain, which was the faster at 512 on an H100 (PERF.md)
SMALL_MAX_E = 256
FLAG_COUNT = 4                         # G0, G1c, G-single, G2-item
_LOCK = threading.Lock()


@functools.cache
def _lib():
    lib = _build.library("elle_closure")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jt_elle_small.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.jt_elle_product.argtypes = [p, ll, ll, p, ll, ll, p, ll, ll, p, ll,
                                    ll, p, p, ll, p, i, i, i, i, i, i, p]
    lib.jt_elle_prep.argtypes = [p, p, p, i, p, p, i, i, p]
    lib.jt_elle_rhs.argtypes = [p, p, p, p, i, i, p]
    lib.jt_elle_pair.argtypes = [p, p, i, i, i, p]
    for fn in (lib.jt_elle_small, lib.jt_elle_product, lib.jt_elle_prep,
               lib.jt_elle_rhs, lib.jt_elle_pair):
        fn.restype = ctypes.c_int
    lib.jt_error_string.argtypes = [ctypes.c_int]
    lib.jt_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(name: str, fn, *args, kernel: str | None = None) -> None:
    """Call a C entry with the current stream; raise on its CUDA error;
    count a kernel's launch under `kernel`, a helper's otherwise."""
    global HELPER_LAUNCHES
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        err = _lib().jt_error_string(code).decode()
        raise KernelLaunchError(f"elle_closure {name} launch failed: CUDA "
                                f"error {code} ({err})")
    with _LOCK:
        if kernel is None:
            HELPER_LAUNCHES += 1
        else:
            LAUNCHES[kernel] += 1


def _stacks(ww, wr, rw) -> tuple[int, int]:
    """(B, e) of a bucket's three stacks; raises on what K4 does not
    take."""
    ts = (ww, wr, rw)
    dev = ww.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"K4 takes every stack on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 or t.dim() != 3
           or t.shape != ww.shape or not t.is_contiguous() for t in ts) \
            or ww.shape[1] != ww.shape[2]:
        raise ValueError(f"K4 takes three contiguous float32 (B, e, e) "
                         f"stacks, got {[(t.dtype, tuple(t.shape)) for t in ts]}")
    b, e = ww.shape[0], ww.shape[1]
    if b < 1 or e < 1:
        raise ValueError(f"K4 takes B >= 1 and e >= 1, got B={b}, e={e}")
    return b, e


def route(e: int) -> str:
    """The kernel that classifies an e-wide bucket on the card."""
    return "small" if e <= SMALL_MAX_E else "product"


def classify(ww: torch.Tensor, wr: torch.Tensor, rw: torch.Tensor,
             steps: int) -> tuple:
    """Classify a bucket: (B, e, e) float32 0/1 ww/wr/rw stacks -> a (B,
    4) int32 flag tensor (G0, G1c, G-single, G2-item) and the (B,) int64
    residue, unfetched. On CPU tensors the plain `_flags_batch`; on CUDA
    tensors K4, by the bucket's `route`."""
    if ww.device.type == "cpu":
        from .kernels import _flags_batch
        *flags, res = _flags_batch(ww, wr, rw, steps)
        return torch.stack(flags, 1).to(torch.int32), res
    b, e = _stacks(ww, wr, rw)
    with torch.cuda.device(ww.device):
        if route(e) == "small":
            return _classify_small(ww, wr, rw, steps, b, e)
        return _classify_product(ww, wr, rw, steps, b, e)


def _classify_small(ww, wr, rw, steps, b, e) -> tuple:
    flags = torch.empty((b, FLAG_COUNT), dtype=torch.int32, device=ww.device)
    res = torch.empty(b, dtype=torch.int64, device=ww.device)
    _launch("small", _lib().jt_elle_small, ww.data_ptr(), wr.data_ptr(),
            rw.data_ptr(), flags.data_ptr(), res.data_ptr(), b, e, steps,
            kernel="small")
    return flags, res


def _prep(ww, wr, rw, mask: int, csum=None) -> torch.Tensor:
    """The bf16 0/1 OR of the stacks in mask (1 ww, 2 wr, 4 rw), adding
    its column sums into csum ((B, e) int32) when given."""
    b, e = ww.shape[0], ww.shape[1]
    out = torch.empty((b, e, e), dtype=torch.bfloat16, device=ww.device)
    _launch("prep", _lib().jt_elle_prep, ww.data_ptr(), wr.data_ptr(),
            rw.data_ptr(), mask, out.data_ptr(), _ptr(csum), e, b)
    return out


def product(left: torch.Tensor, right: torch.Tensor,
            add: torch.Tensor | None = None, *, out: bool = True,
            stats: torch.Tensor | None = None,
            flags: torch.Tensor | None = None, flag: int = -1,
            eye: bool = False) -> torch.Tensor | None:
    """One K4-product launch: (add + left @ right > 0) as bf16 0/1, for
    (M, K) and (K, N) bf16 0/1 operands, or (B, M, K) and (B, K, N)
    stacks; add (M, N) or None. stats, a zeroed (2, B, N) int32 tensor,
    gains the column sums of the integer counts (stats[0]) and of the
    result (stats[1]); flag >= 0 ORs 1 into flags[b, flag] where a
    diagonal entry of the result is set; eye ORs the identity into the
    result. Returns the result, or None with out=False."""
    batched = left.dim() == 3
    lb, rb = (left, right) if batched else (left[None], right[None])
    ab = None if add is None else (add if batched else add[None])
    dev = left.device
    ts = [t for t in (lb, rb, ab, stats, flags) if t is not None]
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("K4-product takes every tensor on one CUDA device")
    if any(t.dtype != torch.bfloat16 or t.dim() != 3 or not t.is_contiguous()
           for t in (lb, rb) + (() if ab is None else (ab,))):
        raise ValueError("K4-product takes contiguous bf16 operands")
    b, m, k = lb.shape
    n = rb.shape[2]
    if rb.shape[:2] != (b, k) or (ab is not None and ab.shape != (b, m, n)):
        raise ValueError(f"K4-product shapes {tuple(lb.shape)} @ "
                         f"{tuple(rb.shape)} + "
                         f"{None if ab is None else tuple(ab.shape)}")
    if k % 8 or n % 8:
        raise ValueError(f"K4-product takes K and N multiples of 8, got "
                         f"K={k}, N={n}")
    if stats is not None and (stats.dtype != torch.int32
                              or stats.shape != (2, b, n)):
        raise ValueError("stats must be a zeroed (2, B, N) int32 tensor")
    if flag >= 0 and (flags is None or flags.dtype != torch.int32
                      or flags.shape != (b, FLAG_COUNT)):
        raise ValueError("flag needs a (B, 4) int32 flags tensor")
    res = torch.empty((b, m, n), dtype=torch.bfloat16, device=dev) \
        if out else None
    with torch.cuda.device(dev):
        _launch("product", _lib().jt_elle_product,
                lb.data_ptr(), k, m * k, rb.data_ptr(), n, k * n,
                _ptr(ab), n, m * n, _ptr(res), n, m * n,
                None if stats is None else stats[0].data_ptr(),
                None if stats is None else stats[1].data_ptr(), n,
                _ptr(flags), flag, int(eye), m, n, k, b, kernel="product")
    if res is None or batched:
        return res
    return res[0]


def _workspace(n: int, dev) -> torch.Tensor:
    """n zeroed int32 on dev, in one fill (counted in `MEMSETS`)."""
    global MEMSETS
    ws = torch.zeros(n, dtype=torch.int32, device=dev)
    with _LOCK:
        MEMSETS += 1
    return ws


def _classify_product(ww, wr, rw, steps, b, e) -> tuple:
    """The classifier as a chain of K4-product launches and helpers: the
    closures (a squaring each, its residue formed beside it), then
    h1 = (ec rw > 0) ec's diagonal and p = (rw cr > 0), each as in
    `kernels._flags_batch`. Every counter it adds into (the residue, the
    flags, each closure's column sums by squaring) is a slice of one
    workspace, zeroed once."""
    lib, dev = _lib(), ww.device
    per = b * e * (1 + 2 * steps)       # a closure's colsum and stats
    ws = _workspace(6 * b + 3 * per, dev)
    res = ws[:2 * b].view(torch.int64)
    flags = ws[2 * b:6 * b].view(b, FLAG_COUNT)
    rw16 = _prep(ww, wr, rw, 4)

    def closure(n: int, mask: int, flag: int, eye: bool) -> torch.Tensor:
        part = ws[6 * b + n * per:6 * b + (n + 1) * per]
        cs = part[:b * e].view(b, e)
        stats = part[b * e:].view(steps, 2, b, e)
        a = _prep(ww, wr, rw, mask, cs)
        for s in range(steps):
            nxt = product(a, a, a, stats=stats[s], flags=flags, flag=flag,
                          eye=eye and s == steps - 1)
            _launch("rhs", lib.jt_elle_rhs, a.data_ptr(), cs.data_ptr(),
                    stats[s, 0].data_ptr(), res.data_ptr(), e, b)
            a, cs = nxt, stats[s, 1]
        return a

    closure(0, 1, 0, False)                       # G0
    ec = closure(1, 3, 1, True)                   # G1c; ec = c_wwr | I
    x = product(ec, rw16)                         # (ec rw > 0)
    product(x, ec, out=False, flags=flags, flag=2)   # diag(x ec): G-single
    del x, ec
    cr = closure(2, 7, -1, True)                  # cr = c_full | I
    p = product(rw16, cr)                         # (rw cr > 0)
    _launch("pair", lib.jt_elle_pair, p.data_ptr(), flags.data_ptr(), 3, e,
            b)                                    # p & p.T off the diagonal
    return flags, res


def closure_operand(a: torch.Tensor) -> torch.Tensor:
    """`transitive_closure`'s operand: float32 0/1 for the plain loop on
    the CPU, bf16 0/1 for K4-product on the card."""
    return a if a.device.type == "cpu" else a.to(torch.bfloat16)


def square_rows(a: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """One squaring of a closure by rows: min(a + a @ full, 1), with a
    this rank's (m, e) rows of the (e, e) matrix full. On CPU tensors the
    plain `torch.mm` step; on CUDA tensors (bf16) one K4-product
    launch."""
    if a.device.type == "cpu":
        return torch.mm(a, full).add_(a).clamp_(max=1.0)
    return product(a, full, a)
