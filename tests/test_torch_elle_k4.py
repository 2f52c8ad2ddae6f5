"""K4, the Elle classifier and transitive closure as CUDA kernels, on the
CPU: numpy emulations of both kernels' arithmetic against the JAX
package and the port's plain versions.

K4-small's emulation packs each SCC block's rows and columns into uint32
words as the kernel packs them (32 nodes a word, zero padded to the
kernel's width), takes a squaring's integer path counts as popcounts of
row & column words, closes by OR, sums both sides of the residue (the
counts' column sums against colsum(A).A) and reads the four flags as the
kernel does. It is held, on hypothesis-drawn buckets (zero padding
blocks included) and on rings, against the JAX package's
`_flags_batch_fn`, the port's plain `_flags_batch` and the numpy mirror
`_classify_batches_host`.

K4-product's emulation takes bf16 0/1 operands (checked exact in bf16)
and accumulates in float32 over k-slices of 16, in the kernel's order,
with its fused epilogue (the next A, the diagonal flag, the column sums)
and its helpers; it shows the counts and column sums exact at e = 512 to
4,096 and is held against the JAX package's classifier and
`transitive_closure` and the port's plain versions.

Every comparison is exact: flags, counts, column sums and residues are
integers far below float32's 2^24.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from jepsen_tpu.checker.elle import kernels as jk
from jepsen_tpu_torch.checker.elle import k4
from jepsen_tpu_torch.checker.elle import kernels as tk

REPO_JAX_KERNELS = "jepsen_tpu/checker/elle/kernels.py"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _popcount(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).astype(np.int64)


def _pack(m: np.ndarray) -> np.ndarray:
    """(E, E) bool -> (E, E / 32) uint32: row i's node c in bit c & 31 of
    word c >> 5, as the kernel's ballots build them."""
    e = m.shape[0]
    bits = m.reshape(e, e // 32, 32).astype(np.uint32)
    return (bits << np.arange(32, dtype=np.uint32)).sum(
        axis=2, dtype=np.uint32)


def _unpack(words: np.ndarray) -> np.ndarray:
    e = words.shape[0]
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(e, words.shape[1] * 32).astype(bool)


def _width(e: int) -> int:
    """The kernel's padded width for an e-wide bucket (its template)."""
    for w in (32, 64, 128, 256):
        if e <= w:
            return w
    raise ValueError(e)


def _counts(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """P[i, j] = popc(row_i & col_j) summed over the words."""
    return np.bitwise_count(rows[:, None, :] & cols[None, :, :]).sum(
        axis=2, dtype=np.int64)


def small_block(ww, wr, rw, steps) -> tuple:
    """K4-small on one (e, e) block: ((g0, g1c, single, g2), residue)."""
    e = ww.shape[0]
    E = _width(e)

    def padded(*ms):
        out = np.zeros((E, E), bool)
        out[:e, :e] = np.logical_or.reduce([m != 0 for m in ms])
        return out

    res = 0

    def closure(a):
        nonlocal res
        rows, cols = _pack(a), _pack(a.T)
        for _ in range(steps):
            p = _counts(rows, cols)                  # P = A.A
            am = _unpack(cols).T                     # A[k, j]: bit k of col j
            cs = _popcount(cols).sum(axis=1)         # colsum(A), by popcount
            lhs = p.sum(axis=0)
            rhs = (cs[:, None] * am).sum(axis=0)
            res += int(np.abs(lhs - rhs).sum())
            a = am | (p > 0)
            rows, cols = _pack(a), _pack(a.T)
        return rows, cols

    diag = np.arange(e)

    def diag_any(cols):
        return bool(((cols[diag, diag >> 5] >> (diag & 31)) & 1).any())

    def set_eye(words):
        words = words.copy()
        words[diag, diag >> 5] |= np.uint32(1) << (diag & 31).astype(
            np.uint32)
        return words

    _r, c_ww = closure(padded(ww))
    g0 = diag_any(c_ww)
    r_ec, c_ec = closure(padded(ww, wr))
    g1c = diag_any(c_ec)
    r_ec, c_ec = set_eye(r_ec), set_eye(c_ec)
    x_rows = _pack(_counts(r_ec, _pack(padded(rw).T)) > 0)   # ec.rw > 0
    single = bool((x_rows[diag] & c_ec[diag]).any())       # diag(x.ec)
    _r, c_cr = closure(padded(ww, wr, rw))
    c_cr = set_eye(c_cr)
    p = _counts(_pack(padded(rw)), c_cr) > 0
    p_rows, p_cols = _pack(p), _pack(p.T)
    both = p_rows[diag] & p_cols[diag]
    both[diag, diag >> 5] &= ~(np.uint32(1) << (diag & 31).astype(np.uint32))
    g2 = bool(both.any())
    return (g0, g1c, single, g2), res


def small_bucket(ww, wr, rw, steps) -> tuple:
    """K4-small on a (B, e, e) bucket: ((B, 4) bool flags, (B,) residue)."""
    out = [small_block(ww[s], wr[s], rw[s], steps) for s in range(len(ww))]
    return (np.array([f for f, _ in out], bool).reshape(len(ww), 4),
            np.array([r for _, r in out], np.int64))


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """x as the kernel stages it: bf16, a float32's upper 16 bits, which
    hold 0 and 1 exactly."""
    x = np.ascontiguousarray(x, np.float32)
    back = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    assert np.array_equal(back, x)
    return back


def product(left, right, add=None, eye=False) -> dict:
    """K4-product on one (M, K) x (K, N) pair: the float32 accumulators
    over k-slices of 16 in the kernel's order (two m16n8k16 slices a
    staged 32), then the epilogue."""
    left, right = _bf16_exact(left), _bf16_exact(right)
    m, k = left.shape
    slices = left.reshape(m, k // 16, 16).transpose(1, 0, 2).copy()
    acc = np.zeros((m, right.shape[1]), np.float32)
    for s in range(k // 16):
        acc += slices[s] @ right[16 * s:16 * s + 16]
    counts = acc.astype(np.int64)
    assert np.array_equal(acc, counts) and acc.max(initial=0) < 2 ** 24
    v = ((0 if add is None else add) + acc) > 0
    n = min(v.shape)
    diag = bool(v[np.arange(n), np.arange(n)].any())
    if eye:
        v[np.arange(n), np.arange(n)] = True
    return dict(out=v.astype(np.float32), counts=counts,
                lhs=counts.sum(axis=0), csum=v.sum(axis=0), diag=diag)


def product_bucket(ww, wr, rw, steps) -> tuple:
    """K4-product's classifier chain on a (B, e, e) bucket: ((B, 4) bool
    flags, (B,) residue), launch for launch as `k4._classify_product`."""
    flags = np.zeros((len(ww), 4), bool)
    res = np.zeros(len(ww), np.int64)
    for s in range(len(ww)):
        rw16 = (rw[s] != 0).astype(np.float32)

        def closure(a, flag, eye):
            cs = a.sum(axis=0).astype(np.int64)               # elle_prep
            for i in range(steps):
                r = product(a, a, a, eye=eye and i == steps - 1)
                if flag >= 0 and r["diag"]:
                    flags[s, flag] = True
                rhs = (cs[:, None] * (a != 0)).sum(axis=0)    # elle_rhs
                res[s] += int(np.abs(r["lhs"] - rhs).sum())
                a, cs = r["out"], r["csum"]
            return a

        closure((ww[s] != 0).astype(np.float32), 0, False)
        ec = closure(((ww[s] + wr[s]) != 0).astype(np.float32), 1, True)
        x = product(ec, rw16)["out"]
        flags[s, 2] = product(x, ec)["diag"]
        cr = closure(((ww[s] + wr[s] + rw[s]) != 0).astype(np.float32), -1,
                     True)
        p = product(rw16, cr)["out"] > 0                      # elle_pair
        q = p & p.T
        np.fill_diagonal(q, False)
        flags[s, 3] = bool(q.any())
    return flags, res


def _random_bucket(e, b, rng, density, pad=0):
    """(ww, wr, rw) float32 0/1 stacks, entries set with probability
    density / e, no self-loops, then `pad` zero blocks (analyze_edges
    pads B to a power of two)."""
    mats = []
    for _ in range(3):
        m = (rng.random((b, e, e)) < density / e).astype(np.float32)
        m[:, np.arange(e), np.arange(e)] = 0.0
        mats.append(np.concatenate([m, np.zeros((pad, e, e), np.float32)]))
    return tuple(mats)


def _rings(e, n) -> tuple:
    """Three blocks holding one n-node ring each: pure ww, one rw edge,
    two rw edges; and the flags their construction gives."""
    ww = np.zeros((3, e, e), np.float32)
    wr = np.zeros_like(ww)
    rw = np.zeros_like(ww)
    for s, rw_at in enumerate(((), (n // 3,), (n // 4, 3 * n // 4))):
        for k in range(n):
            (rw if k in rw_at else ww)[s, k, (k + 1) % n] = 1.0
    want = np.array([(True, True, False, False), (False, False, True, False),
                     (False, False, False, True)])
    return (ww, wr, rw), want


def _references(stacks, e) -> tuple:
    """(flags (B, 4), residue) of the JAX package's `_flags_batch_fn`,
    and the port's plain `_flags_batch` and the numpy mirror's flags."""
    steps = tk._steps(e)
    *jf, jres = jk._flags_batch_fn(e, steps)(*stacks)
    jflags = np.stack([np.asarray(f) for f in jf], 1)
    *tf, tres = tk._flags_batch(*(torch.from_numpy(x) for x in stacks),
                                steps)
    tflags = torch.stack(tf, 1).numpy()
    mirror = np.stack(tk._classify_batches_host({e: stacks})[e], 1)
    assert np.array_equal(jflags, tflags) and np.array_equal(tflags, mirror)
    assert np.asarray(jres).tolist() == tres.tolist() == [0] * len(stacks[0])
    return tflags


# -- K4-small -------------------------------------------------------------------

@settings(max_examples=24, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(e=st.sampled_from([8, 16, 32, 64, 128, 256]),
       density=st.sampled_from([0.3, 0.8, 1.5, 3.0]),
       b=st.integers(1, 3), seed=st.integers(0, 2 ** 16))
def test_small_emulation_matches_jax_plain_and_mirror(e, density, b, seed):
    pad = (1 << (b - 1).bit_length()) - b + (1 if b == 1 else 0)
    stacks = _random_bucket(e, b, np.random.default_rng(seed), density,
                            pad=pad)
    want = _references(stacks, e)
    flags, res = small_bucket(*stacks, tk._steps(e))
    assert np.array_equal(flags, want)
    assert res.tolist() == [0] * len(flags)
    assert not flags[b:].any()                   # the zero padding blocks


@pytest.mark.parametrize("e,n", [(8, 5), (16, 11), (32, 32), (64, 40),
                                 (128, 100), (256, 200), (256, 256)])
def test_small_emulation_on_rings(e, n):
    stacks, want = _rings(e, n)
    assert np.array_equal(_references(stacks, e), want)
    flags, res = small_bucket(*stacks, tk._steps(e))
    assert np.array_equal(flags, want) and res.tolist() == [0, 0, 0]


def test_small_emulation_residue_sees_a_wrong_count():
    """Both sides of the residue are live: a count off by one in one
    squaring (the left side) leaves a nonzero residue."""
    rows = _pack(np.eye(32, k=1, dtype=bool))
    p = _counts(rows, _pack(np.eye(32, k=1, dtype=bool).T))
    cs = _popcount(_pack(np.eye(32, k=1, dtype=bool).T)).sum(axis=1)
    am = np.eye(32, k=1, dtype=bool)
    rhs = (cs[:, None] * am).sum(axis=0)
    assert np.array_equal(p.sum(axis=0), rhs)
    p[3, 5] += 1
    assert np.abs(p.sum(axis=0) - rhs).sum() == 1


# -- K4-product -----------------------------------------------------------------

@pytest.mark.parametrize("e,rows,density,seed", [
    (512, 512, 0.05, 1), (512, 512, 0.6, 2), (1024, 1024, 0.01, 3),
    (2048, 128, 0.3, 4), (4096, 128, 0.002, 5), (4096, 128, 1.0, 6)])
def test_product_counts_and_column_sums_are_exact(e, rows, density, seed):
    """One K4-product squaring of a row block (the whole matrix, or the
    mesh path's (m x e).(e x e)): the float32 counts of bf16 0/1 operands
    equal the exact integer product, and so do both column sums."""
    rng = np.random.default_rng(seed)
    a = (rng.random((e, e)) < density).astype(np.float32)
    block = a[:rows]
    r = product(block, a, block)
    exact = (block.astype(np.float64) @ a.astype(np.float64)).astype(
        np.int64)
    assert np.array_equal(r["counts"], exact)
    assert np.array_equal(r["lhs"], exact.sum(axis=0))
    assert np.array_equal(r["csum"], ((block + exact) > 0).sum(axis=0))
    if density == 1.0:
        assert exact.max() == e                  # the largest count there is


@pytest.mark.parametrize("e,b,density,seed", [(256, 4, 1.2, 9),
                                              (512, 2, 1.2, 7),
                                              (512, 1, 4.0, 8)])
def test_product_classifier_emulation_matches_jax_plain_and_mirror(
        e, b, density, seed):
    """The product chain (which the card runs by name at 256 too) against
    the references, and against K4-small where that takes the width."""
    stacks = _random_bucket(e, b, np.random.default_rng(seed), density,
                            pad=1)
    want = _references(stacks, e)
    flags, res = product_bucket(*stacks, tk._steps(e))
    assert np.array_equal(flags, want) and res.tolist() == [0] * (b + 1)
    if e <= k4.SMALL_MAX_E:
        small, _ = small_bucket(*stacks, tk._steps(e))
        assert np.array_equal(small, flags)


def test_product_classifier_emulation_on_rings():
    stacks, want = _rings(512, 500)
    flags, res = product_bucket(*stacks, tk._steps(512))
    assert np.array_equal(flags, want) and res.tolist() == [0, 0, 0]


@pytest.mark.parametrize("n,density,seed", [(300, 0.004, 1), (700, 0.002, 2),
                                            (130, 0.02, 3)])
def test_product_closure_emulation_matches_jax_and_plain(n, density, seed):
    """`transitive_closure` as K4-product runs it, a squaring a launch:
    equal to the JAX package's and the port's plain loop."""
    adj = np.random.default_rng(seed).random((n, n)) < density
    e = -(-tk._bucket(n, lo=128) // 8) * 8
    a = np.zeros((e, e), np.float32)
    a[:n, :n] = adj
    for _ in range(tk._steps(n)):
        a = product(a, a, a)["out"]
    got = (a > 0)[:n, :n]
    assert np.array_equal(got, jk.transitive_closure(adj))
    assert np.array_equal(got, tk.transitive_closure(adj, device="cpu"))


# -- the wrapper ----------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    stacks = _random_bucket(16, 4, np.random.default_rng(3), 1.5)
    args = [torch.from_numpy(x) for x in stacks]
    before = dict(k4.LAUNCHES), k4.HELPER_LAUNCHES, k4.MEMSETS
    flags, res = k4.classify(*args, tk._steps(16))
    *plain, pres = tk._flags_batch(*args, tk._steps(16))
    assert flags.dtype == torch.int32 and flags.shape == (4, 4)
    assert torch.equal(flags, torch.stack(plain, 1).to(torch.int32))
    assert torch.equal(res, pres)
    a = torch.from_numpy(np.eye(16, k=1, dtype=np.float32))
    assert k4.closure_operand(a) is a
    assert torch.equal(k4.square_rows(a.clone(), a),
                       torch.mm(a, a).add_(a).clamp_(max=1.0))
    tk.transitive_closure(np.eye(9, k=1, dtype=bool), device="cpu")
    assert (dict(k4.LAUNCHES), k4.HELPER_LAUNCHES, k4.MEMSETS) == before
    assert set(k4.LAUNCHES) == set(k4.KERNELS) == {"small", "product"}


def test_the_kernel_entries_refuse_cpu_tensors():
    x = torch.zeros((1, 8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        k4.product(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        k4._stacks(*(torch.zeros((1, 8, 8)),) * 3)


def test_routes_and_replaces_name_the_jax_lines():
    assert [k4.route(e) for e in (8, 256, 257, 512, 4096)] == \
        ["small", "small", "product", "product", "product"]
    assert k4.SMALL_MAX_E == 256
    assert k4.SOURCE == "jepsen_tpu_torch/csrc/elle_closure.cu"
    lines = open(jk.__file__).read().splitlines()
    assert k4.REPLACES["small"] == f"{REPO_JAX_KERNELS}:175"
    assert k4.REPLACES["product"] == f"{REPO_JAX_KERNELS}:175, :698"
    assert lines[174].startswith("def _flags_batch_fn(")
    assert lines[697].startswith("def _closure_fn(")
    src = open(tk.__file__.replace("checker/elle/kernels.py", "") +
               "csrc/elle_closure.cu").read()
    assert "kernels.py:175" in src and ":698" in src
    assert math.ceil(math.log2(4096)) == tk._steps(4096) == 12
