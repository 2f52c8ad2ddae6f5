"""K2, the frontier hash dedup: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and a Python oracle on all four
outputs, the gate and helpers against the JAX package's, and the
wrapper's contract on the CPU. Exact: everything is integer. The CUDA
kernel itself is held against the plain version by
tests/test_torch_gpu.py and chip_smoke.py on a card."""

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import wgl_dedup as jdedup
from jepsen_tpu_torch import _build
from jepsen_tpu_torch.checker import abft as tabft
from jepsen_tpu_torch.checker import wgl_dedup
from jepsen_tpu_torch.checker.wgl_dedup import EMPTY, dedup, dedup_plain


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the
    other test workers' threads, which slows these tests tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle(keys, F):
    """First-seen order by a Python dict: the serial TPU loop's result."""
    seen = {}
    for i, k in enumerate(keys.tolist()):
        if k != EMPTY and k not in seen:
            seen[k] = i >= F
    items = list(seen.items())[:F]
    out = [k for k, _ in items] + [EMPTY] * (F - len(items))
    new = [n for _, n in items] + [False] * (F - len(items))
    dig = 0
    for k in seen:
        dig ^= k
    dig ^= (len(seen) * wgl_dedup.DIGEST_COUNT_MIX) & 0xFFFFFFFF
    dig &= 0xFFFFFFFF
    return out, new, len(seen), dig - (1 << 32) if dig >= 1 << 31 else dig


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "mixed":        # duplicates and EMPTY, as a stage-B input
        k = rng.integers(0, n // 3 + 1, n)
        k[rng.random(n) < 0.4] = EMPTY
    elif kind == "empty":
        k = np.full(n, EMPTY)
    elif kind == "distinct":   # count > F: the overflow signal
        k = rng.permutation(n) * 7919
    elif kind == "dups":       # a handful of keys, many times each
        k = rng.choice([3, 2 ** 31 - 1, 0, 12345], n)
    else:                      # wide 31-bit keys
        k = rng.integers(0, 2 ** 31 - 1, n)
        k[rng.random(n) < 0.2] = EMPTY
    return k.astype(np.int32)


# (kind, N, F): the main path's stage-A and stage-B shapes at a small F,
# plus edge cases; N = 77 and 300 are not powers of two
CASES = [("mixed", 64, 32), ("mixed", 272, 16), ("mixed", 300, 37),
         ("empty", 32, 8), ("distinct", 64, 8), ("distinct", 77, 77),
         ("dups", 96, 48), ("wide", 128, 64)]


@pytest.mark.parametrize("kind,N,F", CASES)
def test_plain_matches_pallas_interpret_on_all_four_outputs(kind, N, F):
    keys = _keys(kind, N, seed=N + F)
    j_out, j_new, j_cnt, j_dig = map(
        np.asarray, jdedup.dedup_fn(N, F, interpret=True)(keys))
    out, new, cnt, dig = dedup_plain(torch.from_numpy(keys), F)
    assert out.dtype == torch.int32 and new.dtype == torch.bool
    assert out.shape == new.shape == (F,)
    assert cnt.dtype == dig.dtype == torch.int32 and cnt.dim() == 0
    np.testing.assert_array_equal(out.numpy(), j_out)
    np.testing.assert_array_equal(new.numpy(), j_new)
    assert int(cnt) == int(j_cnt) and int(dig) == int(j_dig)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["mixed", "distinct", "dups", "wide"])
def test_plain_matches_oracle(kind, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 700))
    F = int(rng.integers(1, n + 2))
    keys = _keys(kind, max(n, 3), seed)[:n]
    out, new, cnt, dig = dedup_plain(torch.from_numpy(keys), F)
    want = _oracle(keys, F)
    assert out.tolist() == want[0] and new.tolist() == want[1]
    assert (int(cnt), int(dig)) == want[2:]


def test_wrapper_uses_the_plain_version_on_cpu_tensors():
    keys = torch.from_numpy(_keys("mixed", 256, 5))
    before = wgl_dedup.LAUNCHES
    got = dedup(keys, 64)
    assert wgl_dedup.LAUNCHES == before          # no kernel launched
    for a, b in zip(got, dedup_plain(keys, 64)):
        assert torch.equal(a, b)


def test_wrapper_raises_off_cpu_and_cuda_instead_of_falling_back():
    with pytest.raises(ValueError, match="CUDA"):
        dedup(torch.zeros(64, dtype=torch.int32, device="meta"), 8)


def test_gate_and_sizes_match_jax():
    for n in (1, 63, 64, 65, 512, 2304, 4352, 17408, 278528, 10 ** 6):
        assert wgl_dedup.table_size(n) == jdedup.table_size(n)
    for F in (16, 256, 1024, 4096, 16384, 65536):
        for P in (8, 16, 30, 32):
            assert wgl_dedup.eligible(F, P) == jdedup.eligible(F, P)
    assert wgl_dedup.DIGEST_COUNT_MIX == jdedup.DIGEST_COUNT_MIX
    assert wgl_dedup.EMPTY == jdedup.EMPTY
    assert wgl_dedup.MAX_VMEM_BYTES == jdedup.MAX_VMEM_BYTES


def test_xor_fold_and_wrap_match_numpy():
    rng = np.random.default_rng(9)
    x = rng.integers(-2 ** 31, 2 ** 31 - 1, 1000).astype(np.int32)
    want = int(np.bitwise_xor.reduce(x.view(np.uint32)))
    assert int(wgl_dedup.xor_fold(torch.from_numpy(x))) == want
    assert int(tabft.wrap_i32(torch.tensor(want))) == \
        int(np.uint32(want).view(np.int32))
    assert int(wgl_dedup.mix_count(torch.tensor(3, dtype=torch.int32))) \
        == (3 * wgl_dedup.DIGEST_COUNT_MIX) & 0xFFFFFFFF


@pytest.mark.parametrize("expand_max", [wgl_dedup.XOR_EXPAND_MAX, 0])
@pytest.mark.parametrize("shape", [(1000,), (3, 1001), (2, 1), (4, 0)])
def test_xor_fold_methods_match_numpy(shape, expand_max, monkeypatch):
    """Both of xor_fold's methods (bit expansion below XOR_EXPAND_MAX
    elements, folding halves above) on rows of even, odd, unit and zero
    length."""
    monkeypatch.setattr(wgl_dedup, "XOR_EXPAND_MAX", expand_max)
    rng = np.random.default_rng(10)
    x = rng.integers(-2 ** 31, 2 ** 31 - 1, shape).astype(np.int32)
    want = np.bitwise_xor.reduce(x.view(np.uint32), axis=-1)
    got = wgl_dedup.xor_fold(torch.from_numpy(x))
    assert got.dtype == torch.int64 and got.shape == shape[:-1]
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_build_command_and_c_interface():
    assert "dedup" in _build.sources()
    cmd = _build.command("dedup", _build.lib_path("dedup"))
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1].endswith("csrc/dedup.cu")
    # the translation unit: the source and the header it shares with
    # K3-sort, which holds the insert's atomics and the hash constants
    src = (_build.CSRC / "dedup.cu").read_text() + \
        (_build.CSRC / "dedup.cuh").read_text()
    assert '#include "dedup.cuh"' in src
    for name in ('extern "C" int jt_dedup(',
                 'extern "C" long long jt_dedup_scratch_ints(',
                 "cudaGetLastError", "atomicCAS", "atomicMin",
                 "0x85ebca6bu", "0xc2b2ae35u"):
        assert name in src, name
    # a hand kernel: no library kernel on the path
    for banned in ("cub::Device", "thrust", "#include <cub"):
        assert banned not in src


# -- the single-block path's phases, emulated in numpy -----------------------

SINGLE_THREADS = 1024


def _murmur(k):
    h = k ^ (k >> 16)
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _single_block(keys, F, seed):
    """K2's single-block path as csrc/dedup.cu runs it: thread t owns the
    per = ceil(N / 1024) consecutive keys [t * per, t * per + per) and
    takes them as a queue, one probe per turn; the threads' probes
    interleave in an order drawn from `seed` (warps run in any order);
    a key's first occurrence is the index holding its slot's atomicMin;
    an exclusive scan of the per-thread flag counts ranks them; ranks
    below F scatter; the digest XORs the table's claimed slots."""
    n = len(keys)
    H = wgl_dedup.table_size(n)
    table = np.full(H, EMPTY, np.int64)
    first = np.full(H, np.iinfo(np.int32).max, np.int64)
    per = -(-n // SINGLE_THREADS)
    slot = np.full(n, -1)
    rng = np.random.default_rng(seed)
    nxt = {t: t * per for t in range(SINGLE_THREADS) if t * per < n}
    at = {}                                              # 2. insert
    while nxt:
        live = list(nxt)
        for t in rng.permutation(live):                  # one turn each
            i = nxt[t]
            k = int(keys[i])
            done = k == EMPTY
            if not done:
                h = at.get(t, _murmur(k) & (H - 1))
                if table[h] in (EMPTY, k):               # the CAS
                    table[h] = k
                    first[h] = min(first[h], i)
                    slot[i] = h
                    done = True
                else:
                    at[t] = (h + 1) & (H - 1)
            if done:
                at.pop(t, None)
                if i + 1 < min(t * per + per, n):
                    nxt[t] = i + 1
                else:
                    del nxt[t]
    flags = np.zeros(SINGLE_THREADS * per, bool)         # 3. flags, ranks
    flags[:n] = (slot >= 0) & (first[slot] == np.arange(n))
    counts = flags.reshape(SINGLE_THREADS, per).sum(1)
    rank = np.cumsum(counts) - counts
    count = int(counts.sum())
    out = np.full(F, EMPTY, np.int32)                    # 4. scatter
    new = np.zeros(F, bool)
    for t in range(SINGLE_THREADS):
        r = rank[t]
        for i in np.nonzero(flags[t * per:(t + 1) * per])[0] + t * per:
            if r < F:
                out[r], new[r] = keys[i], i >= F
            r += 1
    x = 0                                                # 5. digest
    for v in table[table != EMPTY]:
        x ^= int(v)
    dig = (x ^ (count * wgl_dedup.DIGEST_COUNT_MIX)) & 0xFFFFFFFF
    return out, new, count, dig - (1 << 32) if dig >= 1 << 31 else dig


@pytest.mark.parametrize("kind", ["mixed", "dups", "empty", "distinct"])
@pytest.mark.parametrize("N", [1, 512, 4352, 8192])
def test_single_block_emulation_matches_plain_and_pallas(N, kind):
    assert N <= wgl_dedup.SINGLE_BLOCK_MAX_N
    F = min(256, max(N // 2, 1))
    keys = _keys(kind, max(N, 3), seed=N + 5)[:N]
    out, new, cnt, dig = _single_block(keys, F, seed=N)
    p_out, p_new, p_cnt, p_dig = dedup_plain(torch.from_numpy(keys), F)
    np.testing.assert_array_equal(out, p_out.numpy())
    np.testing.assert_array_equal(new, p_new.numpy())
    assert (cnt, dig) == (int(p_cnt), int(p_dig))
    j_out, j_new, j_cnt, j_dig = map(
        np.asarray, jdedup.dedup_fn(N, F, interpret=True)(keys))
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(new, j_new)
    assert (cnt, dig) == (int(j_cnt), int(j_dig))


def test_single_block_cap_matches_the_source():
    """The wrapper's path split is the kernel's: N <= 8,192 is one
    launch of one block with the table in shared memory."""
    src = (_build.CSRC / "dedup.cu").read_text()
    cap = wgl_dedup.SINGLE_BLOCK_MAX_N
    assert f"constexpr int kSingleMaxN = {cap};" in src
    assert "constexpr int kSingleThreads = 1024;" in src
    assert 'extern "C" long long jt_dedup_kernel_launches(' in src
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert wgl_dedup.table_size(cap) * 2 * 4 == 128 * 1024
    assert wgl_dedup.path(cap) == "single-block"
    assert wgl_dedup.path(cap + 1) == "five-launch"
