// K3-sort: the sort engine's step walk, for Hopper (sm_90a).
//
// Replaces the JAX package's on-device walk, jepsen_tpu/checker/wgl.py:864
// (`_kernel_cached.run_range`, a lax.while_loop under jax.jit whose stage
// B is a second while_loop, `expand_full` at :787, around the frontier
// dedup: the Pallas hash kernel wgl_dedup.py:215 through `dedup_hash`
// (:718), or a stable sort, `dedup_packed` (:702) and the lexicographic
// `dedup` (:755)) and its jax.vmap (`check_chunk_batch`, :958). One
// launch walks a window of steps [e, wend) of each key's (T, W + 4) step
// matrix [rm words (W) | slot | f | a | b] over the sort carry
// (e, masks int32[F][W], states int32[F], valid[F], slot_f, slot_a,
// slot_b int32[P], occ[P], overflow, att, count, max_count) and writes
// the whole carry back. Each step does the body of wgl.py:870-938, in
// order:
//   1. completion: drop every configuration that lacks a returned bit,
//      clear the bits, free the slots;
//   2. invoke (slot >= 0): write the slot's f, a, b and mark it occupied;
//      stage A: the 2F rows (the frontier, then each configuration with
//      the new op linearized) deduped into F; stage B: rounds of
//      F (1 + P) rows (the frontier, then each configuration expanded by
//      each slot, in f * P + p order), only the configurations the last
//      dedup added expanding, until no candidate is legal (a round with
//      no legal candidate runs no dedup and is not counted);
//   3. attestation: count the valid configurations holding a bit of an
//      unoccupied slot into att;
//   4. count and max count.
// The walk stops after the step that empties the frontier, so a dead
// carry's e is death + 1; a carry already dead or at wend is unchanged.
//
// The model lives in the kernel (sort_models.cuh, chosen by a model id):
// a packed carry may span 2^(31 - P) states, too many for next-state rows.
//
// The dedup. Three routes, each the eager walk's element for element,
// rows past the live configurations included (the carries are compared
// whole):
//   * hash (wgl.SortKernel._dedup_hash, K2's contract): the distinct valid
//     31-bit keys (state - s_lo) << P | mask, compacted in first-seen input
//     order; rows past them hold mask 0 and state s_lo; new = the first
//     occurrence's index >= F; overflow = distinct > F; with attestation,
//     the XOR of the table's claimed keys against that of the output
//     (when distinct <= F). The insert and rank are K2's (dedup.cuh):
//     every key inserts at once with atomicCAS and records its index with
//     atomicMin; a scan of first-occurrence flags in input order ranks
//     them.
//   * packed sort (`_dedup_packed`, W == 1 with a packed config): a stable
//     sort of ALL N uint32 keys invalid << 31 | (state - s_lo) << P | mask
//     (mod 2^32), keeping the first F positions of the sorted order, with
//     their duplicates marked invalid: invalid rows keep their decoded
//     bits. valid = not invalid and first of its run; new = valid and from
//     a candidate; overflow = a valid first-of-run at a position >= F.
//   * lexicographic sort (`_dedup_lex`): a stable sort of the rows by
//     (invalid, mask words as unsigned, state as signed), the first F rows
//     kept whole (garbage states of illegal candidates included).
// Both sorts are one stable LSD radix sort of the row indices, 8-bit
// digits from the least significant key word up, each word gathered once
// in the current order and carried beside the indices through its passes,
// a digit skipped when every key has the same value there. Warp g owns a
// contiguous segment of the order and takes it 32 rows at a time: a pass
// counts each (digit, warp) pair, ranks the pairs by one exclusive scan in
// digit-major order, and scatters each row to its pair's next place plus
// its rank among the lanes of its digit (__match_any_sync), so the sort is
// stable. Valid rows sort first, so a row's first-of-run test and the
// overflow test only look at the first max(F, valid rows) positions.
//
// Counts. The rounds of the invoke at a key's w-th step of the launch go
// into iter_rounds[w] by atomicMax, and iter_inv[w] is set, so that for a
// batch the caller's sums are the eager lockstep walk's counts (one
// batched round while any invoking key has a legal candidate: the max
// over the keys invoking at that step; one hash dedup per step with an
// invoking key, and one a round) and for one key its own. The launch also
// sums the rows of every dedup and, on the sort routes, rows times radix
// passes: the work of the caller's bound.
//
// Layout. Three paths, chosen by the host functions below:
//   * shared: one block of 1,024 threads per key (the grid's x is the
//     batch, B = 1 the unbatched walk), the key's working set (two
//     frontiers, the dedup's rows, its hash table or sort buffers) in
//     dynamic shared memory: the main path's F = 256 at P = 8, 16 and 32;
//   * global: one block per key, the working set in a per-key scratch in
//     device memory, for a batch of larger frontiers (the counter batch's
//     F = 1,024 at P = 16);
//   * grid: one key whose working set does not fit shared memory (the
//     escalations' F = 1,024-65,536) walks in one cooperative launch of one
//     block per SM. Every block runs the same control (row, slots,
//     occupancy) in its own shared memory; the frontier, rows, insert,
//     rank, sort passes and scatter are split over the whole grid; phases
//     meet at grid barriers; sums go through a rotation of three global
//     slots, scans and digit counts through per-block rows in the scratch.
//     Loads and stores of the working set go to L2 (__ldcg, __stcg), so a
//     block never reads another block's write from a stale L1 line.
//
// Bound on an H100: latency. The bytes it must move from device memory
// are each key's carry and window, read once and written once; the
// operations a few per row of each dedup (a hash insert, or a digit a
// radix pass). A step is a chain of dependent team-wide phases joined by
// barriers: the TPU ran it as a while_loop with no host in it; the eager
// walk ran it as 165-255 launches and one host read per stage-B round.
//
// The C entry point takes raw device pointers and the CUDA stream and
// returns the CUDA error of the launch, so a refused launch is reported to
// the caller (jepsen_tpu_torch/checker/wgl_sortwalk.py), which raises.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "dedup.cuh"
#include "sort_models.cuh"

namespace cg = cooperative_groups;

namespace {

using jt_hash::block_exclusive_scan;
using jt_hash::first_of;
using jt_hash::insert_run;
using jt_hash::kEmpty;
using jt_hash::kFull;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 256;            // the sort engine's domain
constexpr int kMaxWords = kMaxSlots / 32;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kOwn = kBins * kWarps / kThreads;  // (digit, warp) pairs a thread scans
constexpr int kPerDigit = kWarps / kOwn;         // threads a digit
constexpr size_t kStaticSmem = 8 * 1024;  // margin for the static arrays
constexpr unsigned kSign = 0x80000000u;

enum Route { kHash = 0, kPacked = 1, kLex = 2 };
enum Path { kSharedPath = 0, kGlobalPath = 1, kGridPath = 2 };
enum RedOp { kAdd, kOr, kXor };

struct SortWalk {
  const int32_t* x;          // (B, T, W + 4) step rows
  const int32_t* wend;       // (B,) end (exclusive) of each key's window
  const int32_t* sc_in;      // (5, B): e, att, count, max_count, overflow
  const int32_t* masks_in;   // (B, F, W)
  const int32_t* states_in;  // (B, F)
  const uint8_t* valid_in;   // (B, F)
  const int32_t* slot_in;    // (3, B, P): f, a, b
  const uint8_t* occ_in;     // (B, P)
  int32_t* sc_out;
  int32_t* masks_out;
  int32_t* states_out;
  uint8_t* valid_out;
  int32_t* slot_out;
  uint8_t* occ_out;
  uint8_t* scratch;          // (B, stride) bytes, or null: shared memory
  long long stride;
  int32_t* iter_rounds;      // (Wn,) zeroed: max over keys of step w's rounds
  int32_t* iter_inv;         // (Wn,) zeroed: 1 where a key invoked at w
  unsigned long long* work;  // (2,) zeroed: rows deduped, rows x passes
  int B, T, Wn, F, P, W, model, route, s_lo, sb_bits, H, attest;
};

__host__ __device__ constexpr size_t r16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Byte offsets of a key's working set: two frontiers (masks, states,
// valid, new), the dedup's rows (a key or a state each, and a valid byte),
// then the hash table (table, first, slots) or the sort's buffers (two
// index orders and two key-word copies), and on the grid path (G blocks)
// the reduction slots, two rows of block totals and the (G, kBins) digit
// counts. ts: the threads that share the key (a block, or the grid's).
struct Layout {
  size_t fm[2], fs[2], fv[2], fn[2];
  size_t rkey, rvalid, table, first, pos, ia, ib, ka, kb;
  size_t red, gtot, ghist, bytes;
};

__host__ __device__ inline Layout make_layout(int F, int P, int W, int route,
                                              int H, int ts, int G) {
  Layout L{};
  size_t o = 0;
  const size_t n = (size_t)F * (1 + P);
  // the hash route's rows sit in K2's strided layout: up to n + 2 ts
  const size_t nk = n + 2 * (size_t)ts;
  for (int k = 0; k < 2; ++k) {
    L.fm[k] = o;
    o += r16((size_t)F * W * 4);
    L.fs[k] = o;
    o += r16((size_t)F * 4);
    L.fv[k] = o;
    o += r16((size_t)F);
    L.fn[k] = o;
    o += r16((size_t)F);
  }
  L.rkey = o;
  o += r16((route == kHash ? nk : n) * 4);
  L.rvalid = o;
  o += r16(route == kLex ? n : 0);
  if (route == kHash) {
    L.table = o;
    o += r16((size_t)H * 4);
    L.first = o;
    o += r16((size_t)H * 4);
    L.pos = o;
    o += r16(nk * 4);
  } else {
    L.ia = o;
    o += r16(n * 4);
    L.ib = o;
    o += r16(n * 4);
    L.ka = o;
    o += r16(n * 4);
    L.kb = o;
    o += r16(n * 4);
  }
  if (G > 0) {
    L.red = o;
    o += r16(3 * 8);
    L.gtot = o;
    o += r16((size_t)2 * G * 4);
    L.ghist = o;
    o += r16((size_t)G * kBins * 4);
  }
  L.bytes = o;
  return L;
}

// A block's radix scratch in dynamic shared memory (after the key's
// working set on the shared path): the (digit, warp) counts, and on the
// grid path each digit's partial sums over the blocks before this one and
// over all (kThreads / kBins each), its start in this block and in the
// order.
__host__ __device__ constexpr size_t radix_smem(int route, bool grid) {
  return route == kHash ? 0
         : (size_t)kBins * kWarps * 4 +
               (grid ? (size_t)(2 * kThreads + 2 * kBins) * 4 : 0);
}

template <class T>
__device__ __forceinline__ T* at(uint8_t* base, size_t off) {
  return reinterpret_cast<T*>(base + off);
}

// Loads and stores of the key's working set: through L2 on the grid path,
// where other blocks wrote it.
template <bool kG, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kG) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

template <bool kG, class T>
__device__ __forceinline__ void st(T* p, T v) {
  if constexpr (kG) {
    __stcg(p, v);
  } else {
    *p = v;
  }
}

// The threads that share one key: a block, or the whole grid.
template <bool kG>
struct Team {
  __device__ __forceinline__ int rank() const {
    return kG ? (int)(blockIdx.x * kThreads + threadIdx.x)
              : (int)threadIdx.x;
  }
  __device__ __forceinline__ int size() const {
    return kG ? (int)(gridDim.x * kThreads) : kThreads;
  }
  __device__ __forceinline__ void sync() const {
    if constexpr (kG) {
      cg::this_grid().sync();
    } else {
      __syncthreads();
    }
  }
  // the one thread that writes a key's scalars
  __device__ __forceinline__ bool lead() const {
    return threadIdx.x == 0 && (!kG || blockIdx.x == 0);
  }
};

// The frontier a step reads and the one a dedup writes.
struct Frontier {
  int32_t* m;
  int32_t* s;
  uint8_t* v;
  uint8_t* n;
};

template <bool kG>
struct Ctx {
  const SortWalk* w;
  uint8_t* base;
  Layout L;
  int F, P, W, N;
  int sa;                   // stage A's slot, or -1 in stage B
  Frontier src, dst;
  const int* slot;          // (3, P) in shared memory
  const uint32_t* occw;     // (W,) in shared memory
  int* rs;                  // radix_smem, in shared memory
  unsigned long long* red;  // grid path: three reduction slots
  int* gtot;                // grid path: two rows of G block totals
  int* ghist;               // grid path: (G, kBins) digit counts
  int nred, nscan;          // reductions and scans so far (uniform)
  Team<kG> team;
};

template <int kOp>
__device__ __forceinline__ unsigned long long op64(unsigned long long a,
                                                  unsigned long long b) {
  return kOp == kAdd ? a + b : kOp == kOr ? (a | b) : (a ^ b);
}

// The team's reduction of v, returned to every thread; a barrier of the
// team (its writes before it are visible to every thread after it). Every
// thread calls it the same number of times: on the grid path the k-th
// call combines into slot k % 3 and clears slot (k + 1) % 3, which every
// thread read two calls ago, before the barrier of the call after it.
template <int kOp, bool kG>
__device__ unsigned long long reduce(Ctx<kG>& c, unsigned long long v) {
  __shared__ unsigned long long part[kWarps];
  __shared__ unsigned long long all;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) {
    v = op64<kOp>(v, __shfl_xor_sync(kFull, v, d));
  }
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = part[lane];
    for (int d = 16; d > 0; d >>= 1) {
      v = op64<kOp>(v, __shfl_xor_sync(kFull, v, d));
    }
    if (lane == 0) all = v;
  }
  __syncthreads();
  if constexpr (!kG) {
    v = all;
    __syncthreads();
    return v;
  } else {
    const int cur = c.nred % 3;
    const int nxt = (c.nred + 1) % 3;
    ++c.nred;
    if (threadIdx.x == 0) {
      if (kOp == kAdd) {
        atomicAdd(&c.red[cur], all);
      } else if (kOp == kOr) {
        atomicOr(&c.red[cur], all);
      } else {
        atomicXor(&c.red[cur], all);
      }
      if (blockIdx.x == 0) atomicExch(&c.red[nxt], 0ull);
    }
    cg::this_grid().sync();
    return *reinterpret_cast<volatile unsigned long long*>(&c.red[cur]);
  }
}

// Exclusive prefix sum of v over the team in rank order; *total gets the
// team's sum. A barrier of the team. On the grid path the block totals go
// through one of two rows in turn: the row a scan reads is written again
// two scans later, after the barrier of the scan between.
template <bool kG>
__device__ int scan(Ctx<kG>& c, int v, int* total) {
  int bt;
  const int r = block_exclusive_scan<kThreads>(v, &bt);
  if constexpr (!kG) {
    *total = bt;
    return r;
  } else {
    __shared__ int pre_s, tot_s;
    int* g = c.gtot + (c.nscan++ & 1) * (int)gridDim.x;
    if (threadIdx.x == 0) __stcg(&g[blockIdx.x], bt);
    cg::this_grid().sync();
    if (threadIdx.x < 32) {
      int p = 0, t = 0;
      for (int b = threadIdx.x; b < (int)gridDim.x; b += 32) {
        const int x = __ldcg(&g[b]);
        t += x;
        if (b < (int)blockIdx.x) p += x;
      }
      for (int d = 16; d > 0; d >>= 1) {
        p += __shfl_xor_sync(kFull, p, d);
        t += __shfl_xor_sync(kFull, t, d);
      }
      if (threadIdx.x == 0) {
        pre_s = p;
        tot_s = t;
      }
    }
    __syncthreads();
    *total = tot_s;
    const int out = r + pre_s;
    __syncthreads();
    return out;
  }
}

// Row i of a dedup's N rows: i < F the frontier's row i (p = -1), else the
// candidate of configuration f by slot p: stage A (sa >= 0, the invoked
// slot) f = i - F; stage B f = (i - F) / P, p = (i - F) % P.
__device__ __forceinline__ void row_src(int i, int F, int P, int sa, int* f,
                                        int* p) {
  if (i < F) {
    *f = i;
    *p = -1;
  } else if (sa >= 0) {
    *f = i - F;
    *p = sa;
  } else {
    *f = (i - F) / P;
    *p = (i - F) - *f * P;
  }
}

// Mask word k of row i: the source configuration's word, with the
// candidate's slot bit set.
template <bool kG>
__device__ __forceinline__ uint32_t row_word(const Frontier& fr, int W, int F,
                                             int P, int sa, int i, int k) {
  int f, p;
  row_src(i, F, P, sa, &f, &p);
  uint32_t m = (uint32_t)ld<kG>(fr.m + (size_t)f * W + k);
  if (p >= 0 && (p >> 5) == k) m |= 1u << (p & 31);
  return m;
}

// Build the dedup's rows from src: a key (hash, packed) or a state and a
// valid byte (lex) each. Returns, to every thread, the valid rows among
// the frontier's (low word) and among the candidates (high word). The
// hash route's rows go to K2's strided layout (thread r's keys
// [r * per, r * per + per) at [r * stride, r * stride + per), stride odd),
// each thread building its own, which its insert reads back.
template <bool kG>
__device__ unsigned long long build_rows(Ctx<kG>& c) {
  const SortWalk& w = *c.w;
  const int F = c.F, P = c.P, W = c.W, N = c.N;
  int32_t* rkey = at<int32_t>(c.base, c.L.rkey);
  uint8_t* rvalid = at<uint8_t>(c.base, c.L.rvalid);
  const int ts = c.team.size(), r0 = c.team.rank();
  const bool hash = w.route == kHash;
  const int per = (N + ts - 1) / ts;
  const int stride = per | 1;
  const int lo = hash ? min(N, r0 * per) : r0;
  const int hi = hash ? min(N, lo + per) : N;
  const int step = hash ? 1 : ts;
  unsigned vo = 0, vc = 0;
  for (int i = lo; i < hi; i += step) {
    int f, p;
    row_src(i, F, P, c.sa, &f, &p);
    int s = ld<kG>(c.src.s + f);
    bool val = ld<kG>(c.src.v + f) != 0;
    if (p >= 0) {
      int ns;
      const bool legal = jt_models::step(w.model, s, c.slot[p],
                                         c.slot[P + p], c.slot[2 * P + p],
                                         &ns);
      const bool had =
          ((uint32_t)ld<kG>(c.src.m + (size_t)f * W + (p >> 5)) >>
           (p & 31)) & 1u;
      if (c.sa >= 0) {
        val = val && legal && !had;
      } else {
        val = val && ld<kG>(c.src.n + f) && legal && !had &&
              ((c.occw[p >> 5] >> (p & 31)) & 1u);
      }
      s = ns;
      vc += val ? 1u : 0u;
    } else {
      vo += val ? 1u : 0u;
    }
    if (w.route == kLex) {
      st<kG>(rkey + i, (int32_t)s);
      st<kG>(rvalid + i, (uint8_t)(val ? 1 : 0));
    } else {
      const uint32_t m0 = row_word<kG>(c.src, W, F, P, c.sa, i, 0);
      const uint32_t k = (((uint32_t)s - (uint32_t)w.s_lo) << P) | m0;
      if (hash) {
        rkey[r0 * stride + (i - lo)] = val ? (int)k : kEmpty;
      } else {
        st<kG>(rkey + i, (int32_t)(k | (val ? 0u : kSign)));
      }
    }
  }
  return reduce<kAdd>(c, (unsigned long long)vc << 32 | vo);
}

// The hash dedup of the built rows into dst (K2's contract). Returns the
// overflow flag; *mism gets the attestation's digest mismatch. The table
// is claimed by atomics and read back volatile, and a thread's keys and
// slots are its own, so only the output goes through ld/st.
template <bool kG>
__device__ bool dedup_hash(Ctx<kG>& c, int* mism) {
  const SortWalk& w = *c.w;
  const int F = c.F, P = c.P, N = c.N, H = w.H;
  int* rkey = at<int>(c.base, c.L.rkey);
  int* table = at<int>(c.base, c.L.table);
  int* first = at<int>(c.base, c.L.first);
  int* pos = at<int>(c.base, c.L.pos);
  const int ts = c.team.size(), r0 = c.team.rank();
  for (int i = r0; i < H; i += ts) {
    st<kG>(table + i, kEmpty);
    st<kG>(first + i, INT_MAX);
  }
  c.team.sync();
  const int per = (N + ts - 1) / ts;
  const int stride = per | 1;
  const int base = r0 * per;
  const int mine = max(0, min(per, N - base));
  const int* my_key = rkey + (size_t)r0 * stride;
  int* my_pos = pos + (size_t)r0 * stride;
  insert_run(my_key, my_pos, mine, base, table, first, (unsigned)(H - 1));
  c.team.sync();
  int cnt = 0;
  for (int j = 0; j < mine; ++j) cnt += first_of(my_pos, first, base, j);
  int distinct;
  int r = scan(c, cnt, &distinct);
  const int pmask = (int)((1u << P) - 1u);
  unsigned xo = 0;
  for (int j = 0; j < mine; ++j) {
    if (!first_of(my_pos, first, base, j)) continue;
    if (r < F) {
      const int key = my_key[j];
      const bool ok = key >= 0;
      const int safe = ok ? key : 0;
      st<kG>(c.dst.m + r, (int32_t)(safe & pmask));
      st<kG>(c.dst.s + r, (int32_t)jt_models::wrap_add(safe >> P, w.s_lo));
      st<kG>(c.dst.v + r, (uint8_t)(ok ? 1 : 0));
      st<kG>(c.dst.n + r, (uint8_t)(ok && base + j >= F ? 1 : 0));
      xo ^= (unsigned)safe;
    }
    ++r;
  }
  for (int q = distinct + r0; q < F; q += ts) {
    st<kG>(c.dst.m + q, (int32_t)0);
    st<kG>(c.dst.s + q, (int32_t)w.s_lo);
    st<kG>(c.dst.v + q, (uint8_t)0);
    st<kG>(c.dst.n + q, (uint8_t)0);
  }
  unsigned xt = 0;
  for (int i = r0; i < H; i += ts) {
    const int v = reinterpret_cast<volatile int*>(table)[i];
    if (v != kEmpty) xt ^= (unsigned)v;
  }
  const unsigned long long x =
      reduce<kXor>(c, (unsigned long long)xt << 32 | xo);
  *mism = w.attest && (uint32_t)x != (uint32_t)(x >> 32) && distinct <= F
              ? 1
              : 0;
  return distinct > F;
}

// Key word k of row i on the sort routes, word 0 the most significant:
// packed, the row's key; lex, (invalid, mask words, state ^ sign).
template <bool kG>
__device__ __forceinline__ uint32_t key_word(const Ctx<kG>& c, int i, int k) {
  if (c.w->route == kPacked) {
    return (uint32_t)ld<kG>(at<int32_t>(c.base, c.L.rkey) + i);
  }
  if (k == 0) return ld<kG>(at<uint8_t>(c.base, c.L.rvalid) + i) ? 0u : 1u;
  if (k <= c.W) return row_word<kG>(c.src, c.W, c.F, c.P, c.sa, i, k - 1);
  return (uint32_t)ld<kG>(at<int32_t>(c.base, c.L.rkey) + i) ^ kSign;
}

// One stable pass of the LSD radix sort on the 8-bit digit at bit sh of
// the carried key word: (order, word) src, ksrc -> dst, kdst. Warp g of
// the team owns the rows [g * seg, g * seg + seg) of the order (seg a
// multiple of 32) and takes them 32 at a time, in order.
template <bool kG>
__device__ void radix_pass(Ctx<kG>& c, const int* src, int* dst,
                           const uint32_t* ksrc, uint32_t* kdst, int sh) {
  int* wc = c.rs;  // (kBins, kWarps)
  const int N = c.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = c.team.size() >> 5;
  const int seg = ((N + nw - 1) / nw + 31) & ~31;
  const int lo = min(N, (c.team.rank() >> 5) * seg);
  const int hi = min(N, lo + seg);
  const unsigned lt = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kBins * kWarps; i += kThreads) wc[i] = 0;
  __syncthreads();
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const unsigned d =
        i < hi ? (ld<kG>(ksrc + i) >> sh) & (kBins - 1) : (unsigned)kBins;
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < kBins && lane == __ffs(peers) - 1) {
      wc[d * kWarps + warp] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  // exclusive scan of the counts in (digit, warp) order: thread t owns
  // the pairs [t * kOwn, t * kOwn + kOwn), of digit t / kPerDigit
  int* mine = wc + threadIdx.x * kOwn;
  int s = 0;
  for (int j = 0; j < kOwn; ++j) s += mine[j];
  int total;
  int run = block_exclusive_scan<kThreads>(s, &total);
  if constexpr (kG) {
    // the digit's place in the whole order: the digits before it in every
    // block, then the digit in the blocks before this one
    int* tq = c.rs + kBins * kWarps;  // (kThreads / kBins, kBins)
    int* pq = tq + kThreads;
    int* ls = pq + kThreads;          // (kBins,) start in this block
    int* off = ls + kBins;            // (kBins,) start in the order
    const int dig = threadIdx.x / kPerDigit;
    int ds = s;
    for (int o = 1; o < kPerDigit; o <<= 1) {
      ds += __shfl_xor_sync(kFull, ds, o);
    }
    if (threadIdx.x % kPerDigit == 0) {
      ls[dig] = run;
      __stcg(&c.ghist[blockIdx.x * kBins + dig], ds);
    }
    cg::this_grid().sync();
    const int d2 = threadIdx.x % kBins, q = threadIdx.x / kBins;
    int pre = 0, tot = 0;
    for (int b = q; b < (int)gridDim.x; b += kThreads / kBins) {
      const int x = __ldcg(&c.ghist[b * kBins + d2]);
      tot += x;
      if (b < (int)blockIdx.x) pre += x;
    }
    tq[threadIdx.x] = tot;
    pq[threadIdx.x] = pre;
    __syncthreads();
    int dt = 0, dp = 0;
    if (threadIdx.x < kBins) {
      for (int k = 0; k < kThreads / kBins; ++k) {
        dt += tq[k * kBins + threadIdx.x];
        dp += pq[k * kBins + threadIdx.x];
      }
    }
    int all;
    const int start = block_exclusive_scan<kThreads>(dt, &all);
    if (threadIdx.x < kBins) off[threadIdx.x] = start + dp;
    __syncthreads();
    run += off[dig] - ls[dig];
  }
  for (int j = 0; j < kOwn; ++j) {
    const int v = mine[j];
    mine[j] = run;
    run += v;
  }
  __syncthreads();
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const bool in = i < hi;
    const uint32_t v = in ? ld<kG>(ksrc + i) : 0u;
    const unsigned d = in ? (v >> sh) & (kBins - 1) : (unsigned)kBins;
    const unsigned peers = __match_any_sync(kFull, d);
    if (in) {
      const int to = wc[d * kWarps + warp] + __popc(peers & lt);
      st<kG>(dst + to, ld<kG>(src + i));
      st<kG>(kdst + to, v);
    }
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) wc[d * kWarps + warp] += __popc(peers);
    __syncwarp();
  }
  c.team.sync();
}

// The sort routes' dedup of the built rows (V of them valid) into dst.
// Returns the overflow flag; *passes gets the radix passes run.
template <bool kG>
__device__ bool dedup_sort(Ctx<kG>& c, int V, int* passes) {
  const SortWalk& w = *c.w;
  const int F = c.F, P = c.P, W = c.W, N = c.N;
  const bool packed = w.route == kPacked;
  const int kw = packed ? 1 : W + 2;
  const int ts = c.team.size(), r0 = c.team.rank();
  int* ia = at<int>(c.base, c.L.ia);
  int* ib = at<int>(c.base, c.L.ib);
  uint32_t* ka = at<uint32_t>(c.base, c.L.ka);
  uint32_t* kb = at<uint32_t>(c.base, c.L.kb);
  for (int i = r0; i < N; i += ts) st<kG>(ia + i, i);
  int n_pass = 0;
  for (int k = kw - 1; k >= 0; --k) {
    // gather word k in the current order; the OR of the words (high) and
    // of their complements (low) give the bits where the keys differ
    unsigned long long o = 0;
    for (int r = r0; r < N; r += ts) {
      const uint32_t v = key_word(c, ld<kG>(ia + r), k);
      st<kG>(ka + r, v);
      o |= (unsigned long long)v << 32 | (uint32_t)~v;
    }
    o = reduce<kOr>(c, o);
    const uint32_t diff = (uint32_t)(o >> 32) & (uint32_t)o;
    for (int sh = 0; sh < 32; sh += kDigitBits) {
      if (((diff >> sh) & (kBins - 1)) == 0) continue;
      radix_pass(c, ia, ib, ka, kb, sh);
      int* ti = ia;
      ia = ib;
      ib = ti;
      uint32_t* tk = ka;
      ka = kb;
      kb = tk;
      ++n_pass;
    }
  }
  *passes = n_pass;
  // the first F positions, and the overflow: valid rows sort first, so a
  // row past V is invalid and no first of a valid run
  const unsigned pmask = (1u << (P & 31)) - 1u;
  const unsigned sbmask =
      w.sb_bits >= 32 ? 0xffffffffu : (1u << w.sb_bits) - 1u;
  const int lim = min(N, max(F, V));
  unsigned ov = 0;
  for (int r = r0; r < lim; r += ts) {
    const int i = ld<kG>(ia + r);
    bool vs = false;
    if (r < V) {
      vs = r == 0;
      if (!vs && packed) {
        vs = ld<kG>(ka + r) != ld<kG>(ka + r - 1);
      } else if (!vs) {
        const int j = ld<kG>(ia + r - 1);
        for (int k = 1; k < kw && !vs; ++k) {
          vs = key_word(c, i, k) != key_word(c, j, k);
        }
      }
    }
    if (r >= F) {
      ov |= vs ? 1u : 0u;
      continue;
    }
    if (packed) {
      const uint32_t key = ld<kG>(ka + r);
      st<kG>(c.dst.m + r, (int32_t)(key & pmask));
      st<kG>(c.dst.s + r, (int32_t)jt_models::wrap_add(
                              (int)((key >> P) & sbmask), w.s_lo));
    } else {
      for (int k = 0; k < W; ++k) {
        st<kG>(c.dst.m + (size_t)r * W + k,
               (int32_t)row_word<kG>(c.src, W, F, P, c.sa, i, k));
      }
      st<kG>(c.dst.s + r, ld<kG>(at<int32_t>(c.base, c.L.rkey) + i));
    }
    st<kG>(c.dst.v + r, (uint8_t)(vs ? 1 : 0));
    st<kG>(c.dst.n + r, (uint8_t)(vs && i >= F ? 1 : 0));
  }
  return reduce<kOr>(c, ov) != 0;
}

template <bool kG>
__global__ void __launch_bounds__(kThreads, 1) sort_walk(const SortWalk w) {
  extern __shared__ uint4 smem[];
  __shared__ int slot[3 * kMaxSlots];
  __shared__ uint32_t occw[kMaxWords];
  const int b = kG ? 0 : (int)blockIdx.x;
  const int t = (int)threadIdx.x;
  const int B = w.B, F = w.F, P = w.P, W = w.W;
  uint8_t* dyn = reinterpret_cast<uint8_t*>(smem);
  Ctx<kG> c;
  const Team<kG>& team = c.team;
  c.w = &w;
  c.base = w.scratch ? w.scratch + (size_t)b * w.stride : dyn;
  c.L = make_layout(F, P, W, w.route, w.H, team.size(),
                    kG ? (int)gridDim.x : 0);
  c.rs = reinterpret_cast<int*>(dyn + (w.scratch ? 0 : r16(c.L.bytes)));
  c.red = kG ? at<unsigned long long>(c.base, c.L.red) : nullptr;
  c.gtot = kG ? at<int>(c.base, c.L.gtot) : nullptr;
  c.ghist = kG ? at<int>(c.base, c.L.ghist) : nullptr;
  c.nred = c.nscan = 0;
  c.F = F;
  c.P = P;
  c.W = W;
  c.slot = slot;
  c.occw = occw;
  Frontier fr[2];
  for (int k = 0; k < 2; ++k) {
    fr[k] = {at<int32_t>(c.base, c.L.fm[k]), at<int32_t>(c.base, c.L.fs[k]),
             at<uint8_t>(c.base, c.L.fv[k]), at<uint8_t>(c.base, c.L.fn[k])};
  }
  const int r0 = team.rank(), ts = team.size();

  // the carry: scalars in every thread's registers, slots and occupancy
  // in each block's shared memory, the frontier in fr[0]
  int e = w.sc_in[b];
  int att = w.sc_in[B + b];
  int count = w.sc_in[2 * B + b];
  int maxc = w.sc_in[3 * B + b];
  bool ovf = w.sc_in[4 * B + b] != 0;
  const int e0 = e;
  const int wend = w.wend[b];
  for (int i = t; i < 3 * P; i += kThreads) {
    slot[i] = w.slot_in[((size_t)(i / P) * B + b) * P + i % P];
  }
  if (t < kMaxWords) occw[t] = 0;
  for (int i = r0; i < F * W; i += ts) {
    st<kG>(fr[0].m + i, w.masks_in[(size_t)b * F * W + i]);
  }
  for (int i = r0; i < F; i += ts) {
    st<kG>(fr[0].s + i, w.states_in[(size_t)b * F + i]);
    st<kG>(fr[0].v + i, (uint8_t)(w.valid_in[(size_t)b * F + i] != 0));
  }
  if (kG && team.lead()) {
    for (int k = 0; k < 3; ++k) atomicExch(&c.red[k], 0ull);
  }
  team.sync();
  for (int p = t; p < P; p += kThreads) {
    if (w.occ_in[(size_t)b * P + p]) atomicOr(&occw[p >> 5], 1u << (p & 31));
  }
  __syncthreads();

  int cur = 0;
  unsigned long long rows = 0, passes_rows = 0;
  const int rowlen = W + 4;
  while (e < wend && count > 0) {
    const int32_t* row = w.x + ((size_t)b * w.T + e) * rowlen;
    bool any_rm = false;
    for (int k = 0; k < W; ++k) any_rm |= row[k] != 0;
    if (any_rm) {
      const Frontier& f = fr[cur];
      for (int q = r0; q < F; q += ts) {
        bool have = true;
        for (int k = 0; k < W; ++k) {
          const uint32_t rm = (uint32_t)row[k];
          const uint32_t m = (uint32_t)ld<kG>(f.m + (size_t)q * W + k);
          have = have && (m & rm) == rm;
          st<kG>(f.m + (size_t)q * W + k, (int32_t)(m & ~rm));
        }
        if (!have) st<kG>(f.v + q, (uint8_t)0);
      }
      if (t < W) occw[t] &= ~(uint32_t)row[t];
      team.sync();
    }
    const int s = row[W];
    if (s >= 0) {
      if (t == 0) {
        slot[s] = row[W + 1];
        slot[P + s] = row[W + 2];
        slot[2 * P + s] = row[W + 3];
        occw[s >> 5] |= 1u << (s & 31);
      }
      __syncthreads();
      int rounds = 0;
      for (int stage = 0;; ++stage) {
        c.sa = stage == 0 ? s : -1;
        c.N = stage == 0 ? 2 * F : F * (1 + P);
        c.src = fr[cur];
        c.dst = fr[cur ^ 1];
        const unsigned long long nv = build_rows(c);
        const int vo = (int)(uint32_t)nv, vc = (int)(nv >> 32);
        if (stage > 0 && vc == 0) break;
        int mism = 0, passes = 0;
        // each dedup ends in a reduction: its output is visible to the
        // whole team after it
        const bool o = w.route == kHash ? dedup_hash(c, &mism)
                                        : dedup_sort(c, vo + vc, &passes);
        ovf = ovf || o;
        att = jt_models::wrap_add(att, mism);
        rows += (unsigned long long)c.N;
        passes_rows += (unsigned long long)c.N * passes;
        cur ^= 1;
        if (stage > 0) ++rounds;
      }
      if (team.lead()) {
        atomicMax(&w.iter_rounds[e - e0], rounds);
        w.iter_inv[e - e0] = 1;
      }
    }
    const Frontier& f = fr[cur];
    unsigned live = 0, bad = 0;
    for (int q = r0; q < F; q += ts) {
      if (!ld<kG>(f.v + q)) continue;
      ++live;
      if (w.attest) {
        for (int k = 0; k < W; ++k) {
          if ((uint32_t)ld<kG>(f.m + (size_t)q * W + k) & ~occw[k]) {
            ++bad;
            break;
          }
        }
      }
    }
    const unsigned long long lb =
        reduce<kAdd>(c, (unsigned long long)bad << 32 | live);
    count = (int)(uint32_t)lb;
    if (w.attest) att = jt_models::wrap_add(att, (int)(lb >> 32));
    maxc = max(maxc, count);
    ++e;
  }

  // write the carry back
  const Frontier& f = fr[cur];
  for (int i = r0; i < F * W; i += ts) {
    w.masks_out[(size_t)b * F * W + i] = ld<kG>(f.m + i);
  }
  for (int i = r0; i < F; i += ts) {
    w.states_out[(size_t)b * F + i] = ld<kG>(f.s + i);
    w.valid_out[(size_t)b * F + i] = ld<kG>(f.v + i);
  }
  if (!kG || blockIdx.x == 0) {
    for (int i = t; i < 3 * P; i += kThreads) {
      w.slot_out[((size_t)(i / P) * B + b) * P + i % P] = slot[i];
    }
    for (int p = t; p < P; p += kThreads) {
      w.occ_out[(size_t)b * P + p] =
          (uint8_t)((occw[p >> 5] >> (p & 31)) & 1u);
    }
  }
  if (team.lead()) {
    w.sc_out[b] = e;
    w.sc_out[B + b] = att;
    w.sc_out[2 * B + b] = count;
    w.sc_out[3 * B + b] = maxc;
    w.sc_out[4 * B + b] = ovf ? 1 : 0;
    if (rows) atomicAdd(&w.work[0], rows);
    if (passes_rows) atomicAdd(&w.work[1], passes_rows);
  }
}

bool valid_shape(int F, int P, int route, int H) {
  const int W = (P + 31) / 32;
  if (F < 1 || P < 1 || P > kMaxSlots || route < kHash || route > kLex) {
    return false;
  }
  if ((long long)F * (1 + P) > INT_MAX / 8) return false;
  if (route != kLex && (W != 1 || P > 30)) return false;
  if (route == kHash &&
      (H < 2 || (H & (H - 1)) != 0 || (long long)H / 2 < (long long)F * (1 + P))) {
    return false;
  }
  return true;
}

// How B keys at (F, P, route) walk on the current device: the path, the
// blocks of the launch, the scratch bytes a key needs (0 on the shared
// path) and the dynamic shared memory of a block.
struct Plan {
  int path, blocks;
  size_t bytes, smem;
};

cudaError_t make_plan(int B, int F, int P, int route, int H, Plan* pl) {
  const int W = (P + 31) / 32;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const Layout L = make_layout(F, P, W, route, H, kThreads, 0);
  const size_t rs = radix_smem(route, false);
  if (L.bytes + rs + kStaticSmem <= (size_t)optin) {
    *pl = {kSharedPath, B, 0, r16(L.bytes) + rs};
    return cudaSuccess;
  }
  if (B > 1) {
    *pl = {kGlobalPath, B, L.bytes, rs};
    return cudaSuccess;
  }
  const size_t gs = radix_smem(route, true);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sort_walk<true>, kThreads, gs);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long rows = (long long)F * (1 + P);
  long long g = (rows + kThreads - 1) / kThreads;
  if (g > (long long)per_sm * sms) g = (long long)per_sm * sms;
  const int G = (int)g;
  *pl = {kGridPath, G, make_layout(F, P, W, route, H, G * kThreads, G).bytes,
         gs};
  return cudaSuccess;
}

template <bool kG>
int launch(const SortWalk& w, const Plan& pl, cudaStream_t s) {
  const auto kernel = &sort_walk<kG>;
  if (pl.smem + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (kG) {
    void* args[] = {const_cast<SortWalk*>(&w)};
    return (int)cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel), dim3((unsigned)pl.blocks),
        dim3(kThreads), args, pl.smem, s);
  } else {
    kernel<<<(unsigned)pl.blocks, kThreads, pl.smem, s>>>(w);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// The scratch bytes one of B keys at (F, P, route) needs and the path it
// walks: 0 shared memory (the launch takes no scratch), 1 one block per
// key in device memory, 2 one key over the whole grid. Returns a CUDA
// error code (cudaErrorInvalidValue for a shape the kernel refuses).
extern "C" int jt_sort_walk_plan(int B, int F, int P, int route, int H,
                                 long long* bytes, int* path) {
  if (B <= 0 || !valid_shape(F, P, route, H)) {
    return (int)cudaErrorInvalidValue;
  }
  Plan pl;
  const cudaError_t err = make_plan(B, F, P, route, H, &pl);
  if (err != cudaSuccess) return (int)err;
  *bytes = (long long)pl.bytes;
  *path = pl.path;
  return 0;
}

// Walk B keys (B = 1: one key) over their windows in one launch. All
// tensors contiguous on the current device; scratch null when
// jt_sort_walk_plan said shared, else B x stride bytes (stride at least
// its bytes, a multiple of 16); iter_rounds and iter_inv zeroed (Wn x
// int32), work zeroed (2 x uint64). Returns the CUDA error of the launch
// (0 when it was taken).
extern "C" int jt_sort_walk(
    const void* x, int T, const void* wend, int Wn, const void* sc_in,
    const void* masks_in, const void* states_in, const void* valid_in,
    const void* slot_in, const void* occ_in, void* sc_out, void* masks_out,
    void* states_out, void* valid_out, void* slot_out, void* occ_out,
    void* scratch, long long stride, void* iter_rounds, void* iter_inv,
    void* work, int B, int F, int P, int model, int route, int s_lo,
    int sb_bits, int H, int attest, void* stream) {
  if (B <= 0 || T <= 0 || Wn <= 0 || model < 0 ||
      model >= jt_models::kModels || !valid_shape(F, P, route, H)) {
    return (int)cudaErrorInvalidValue;
  }
  Plan pl;
  const cudaError_t err = make_plan(B, F, P, route, H, &pl);
  if (err != cudaSuccess) return (int)err;
  if ((pl.path == kSharedPath) != (scratch == nullptr) ||
      (scratch != nullptr && (stride < (long long)pl.bytes || stride % 16))) {
    return (int)cudaErrorInvalidValue;
  }
  SortWalk w;
  w.x = static_cast<const int32_t*>(x);
  w.wend = static_cast<const int32_t*>(wend);
  w.sc_in = static_cast<const int32_t*>(sc_in);
  w.masks_in = static_cast<const int32_t*>(masks_in);
  w.states_in = static_cast<const int32_t*>(states_in);
  w.valid_in = static_cast<const uint8_t*>(valid_in);
  w.slot_in = static_cast<const int32_t*>(slot_in);
  w.occ_in = static_cast<const uint8_t*>(occ_in);
  w.sc_out = static_cast<int32_t*>(sc_out);
  w.masks_out = static_cast<int32_t*>(masks_out);
  w.states_out = static_cast<int32_t*>(states_out);
  w.valid_out = static_cast<uint8_t*>(valid_out);
  w.slot_out = static_cast<int32_t*>(slot_out);
  w.occ_out = static_cast<uint8_t*>(occ_out);
  w.scratch = static_cast<uint8_t*>(scratch);
  w.stride = stride;
  w.iter_rounds = static_cast<int32_t*>(iter_rounds);
  w.iter_inv = static_cast<int32_t*>(iter_inv);
  w.work = static_cast<unsigned long long*>(work);
  w.B = B;
  w.T = T;
  w.Wn = Wn;
  w.F = F;
  w.P = P;
  w.W = (P + 31) / 32;
  w.model = model;
  w.route = route;
  w.s_lo = s_lo;
  w.sb_bits = sb_bits;
  w.H = H;
  w.attest = attest ? 1 : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pl.path == kGridPath ? launch<true>(w, pl, s)
                              : launch<false>(w, pl, s);
}

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
