// K3: the dense engine's step walk, for Hopper (sm_90a).
//
// Replaces the JAX package's on-device walk, jepsen_tpu/checker/wgl.py:1150
// (`_dense_kernel_cached.run_range`, a lax.while_loop under jax.jit, with
// the closure fixpoint a second while_loop around the Pallas round at
// :1077-1095) and its jax.vmap (`check_chunk_batch`, :1220). One launch
// walks a window of steps [e, wend) of each key's (T, 5) step matrix
// [rm, slot, f, a, b] over the dense carry
// (e, table uint8[S][C], slot_f, slot_a, slot_b int32[P], occ[P], att,
// count, max_count), C = 2^P, and writes the whole carry back. Each step
// does the body of wgl.py:1167-1200, in order:
//   1. completion: table'[s][c] = table[s][c | rm] where c & rm == 0, and
//      the returned slots leave occ;
//   2. invoke (slot >= 0): write the slot's f, a, b, mark it occupied and
//      run closure rounds to the fixpoint;
//   3. attestation: add to att the true cells in columns holding a bit of
//      an unoccupied slot;
//   4. count = the table's popcount, max_count = max(max_count, count).
// The walk stops after the step that empties the table, so a dead carry's
// e is death + 1; a carry already dead or at wend comes back unchanged.
//
// Transitions. The kernel holds no model. The caller evaluates the model's
// own step once per launch and passes next-state rows: str0[p][s] for the
// carry's slots and itr[w][s] for the window's step w, each the index of
// the state that linearizing the op moves state s to, or -1 where the move
// is illegal or leaves the state range (exactly the information of the
// eager walk's transposed transitions mft). An invoke copies its step's
// row into its slot's row; an unoccupied slot's row is ignored.
//
// Closure rounds. A round is K1's Jacobi round (closure_round.cu, with the
// chunk arithmetic of closure_round.cuh): it reads one table and writes
// the other, and rounds repeat while the round changed the table. Rounds
// only add cells, so "any cell changed" is the eager walk's "the popcount
// moved", and the round count is the eager walk's. Before the rounds of an
// invoke, each block lists in shared memory, for every state q, the
// (source state s, slot p) pairs with str[p][s] = q over occupied slots (a
// counting sort), so a thread reads only the rows that can move into its
// row: for P >= 4 a thread owns 16-byte chunks and ORs in the butterflied
// chunk j of sources of slots p < 4 and the chunk j ^ 2^(p-4) of sources
// of slots p >= 4 where bit p - 4 of j is set; for P < 4 a thread owns
// single cells. The completion, count and attestation passes work on
// 32-bit words (bytes for P < 4).
//
// Round counts. The rounds of the invoke at a key's w-th step of the
// launch go into iter_rounds[w] by atomicMax, so that the caller's sum of
// iter_rounds is, for a batch, the eager lockstep walk's count (one
// batched round while any invoking key still moves: the max over the keys
// invoking at that lockstep step) and, for one key, the sum of its rounds.
// Every active key starts a launch at the same lockstep step, since they
// all advanced one step per step before it. The launch also sums, over
// every key's rounds, the (s, p) pairs listed for the round: a round ORs
// one half row per pair, so this is the closure's work (the operations of
// the caller's bound).
//
// Layout. The grid's x is the batch: one block per key, and B = 1 is the
// unbatched walk. Three paths, chosen by the host function below:
//   * shared: the table pair in shared memory when both copies and the
//     lists fit the opt-in limit (S * C up to about 110 KB: the headline's
//     8 x 128, the suites' registers and mutexes, the batches' groups);
//   * global: one block per key with the pair in device memory (the
//     output table and a scratch table; L2 holds them), for batches of
//     larger tables;
//   * grid: one key whose pair does not fit shared memory (the forced-dense
//     adversarial 8 x 16,384, at-cap 8 x 2^19, the dense stream's 8 x
//     65,536) walks in one cooperative launch of up to one 1,024-thread
//     block per SM: every block runs the same control (row, slots, lists)
//     in its own shared memory, the table passes are split over the whole
//     grid, and the passes meet at grid barriers, whose sums (moved cells,
//     count, attestation) go through a rotation of three global slots.
// In the global and grid paths table loads and stores go to L2 (__ldcg,
// __stcg), so a block never reads another block's write from a stale L1.
//
// Bound on an H100. The per-step work is a few passes over the table and
// one pass per round: 1 + nnz(sources of row q) 16-byte loads per chunk
// (K1's count), from shared memory or L2, so the bytes it must move from
// device memory are only each key's carry and window (read once, written
// once) and the operations are a few per table word per pass. The walk is
// latency bound: each step is a chain of dependent passes joined by
// barriers (block barriers, or grid barriers on the grid path), which the
// TPU program ran as a while_loop with no host in it, and which the eager
// walk ran as 49-57 host launches and at least one host read per step.
//
// The C entry point takes raw device pointers and the CUDA stream and
// returns the CUDA error of the launch, so a refused launch is reported to
// the caller (jepsen_tpu_torch/checker/wgl_walk.py), which raises.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "closure_round.cuh"

namespace cg = cooperative_groups;

namespace {

using jt_closure::butterfly_any;
using jt_closure::kChunkLog;
using jt_closure::or_into;

constexpr int kMaxThreads = 1024;
constexpr int kMaxSlots = 30;            // C = 2^P must fit an int
constexpr int kMaxStates = 512;          // the dense engine's state cap
constexpr long long kMaxCells = 1LL << 22;   // S * C on the dense engine
constexpr int kRowWords = 5;             // [rm, slot, f, a, b]
constexpr size_t kStaticSmem = 1024;     // margin for the static arrays

enum Mem { kShared = 0, kGlobal = 1, kGrid = 2 };

struct Walk {
  const int32_t* x;         // (B, T, 5) step rows
  const int32_t* wend;      // (B,) end (exclusive) of each key's window
  const int16_t* itr;       // (B, W, S) next-state rows of window steps
  const int16_t* str0;      // (B, P, S) next-state rows of the slots
  const int32_t* sc_in;     // (4, B): e, att, count, max_count
  const uint8_t* tb_in;     // (B, S, C)
  const int32_t* slot_in;   // (3, B, P): f, a, b
  const uint8_t* occ_in;    // (B, P)
  int32_t* sc_out;
  uint8_t* tb_out;
  int32_t* slot_out;
  uint8_t* occ_out;
  uint8_t* scratch;         // (B, S, C): the second table off chip
  int32_t* iter_rounds;     // (W,): max over keys of step w's rounds
  unsigned long long* red;  // (3,): the grid path's sums, zeroed
  unsigned long long* pairs;  // (1,): listed pairs x rounds, zeroed
  int B, T, W, S, P;
  int attest;
};

__host__ __device__ constexpr size_t r16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Shared memory of the control state: str (int16 P x S), the listed
// sources (uint32 P x S), start (S + 1), fill (S), slots (3 x P).
__host__ __device__ size_t ctrl_bytes(int S, int P) {
  return r16((size_t)P * S * 2) + r16((size_t)P * S * 4) +
         r16((size_t)(S + 1) * 4) + r16((size_t)S * 4) +
         r16((size_t)3 * P * 4);
}

template <int kMem, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kMem == kShared) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

template <int kMem, class T>
__device__ __forceinline__ void st(T* p, T v) {
  if constexpr (kMem == kShared) {
    *p = v;
  } else {
    __stcg(p, v);
  }
}

// The threads that share one key's table: a block, or the whole grid.
template <int kMem>
struct Team {
  __device__ __forceinline__ int rank() const {
    return kMem == kGrid ? (int)(blockIdx.x * blockDim.x + threadIdx.x)
                         : (int)threadIdx.x;
  }
  __device__ __forceinline__ int size() const {
    return kMem == kGrid ? (int)(gridDim.x * blockDim.x) : (int)blockDim.x;
  }
  __device__ __forceinline__ void sync() const {
    if constexpr (kMem == kGrid) {
      cg::this_grid().sync();
    } else {
      __syncthreads();
    }
  }
  // the one thread that writes a key's scalars
  __device__ __forceinline__ bool lead() const {
    return threadIdx.x == 0 && (kMem != kGrid || blockIdx.x == 0);
  }
};

// The team's sum of v, returned to every thread; also a barrier of the
// team. Every thread calls it the same number of times: the k-th call adds
// into slot k % 3 and clears slot (k + 1) % 3, which every thread read two
// calls ago, before the barrier of the call after it.
template <int kMem>
__device__ unsigned long long team_sum(unsigned long long v,
                                       unsigned long long* sh,
                                       unsigned long long* g, int& k) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int cur = k % 3;
  const int nxt = (k + 1) % 3;
  ++k;
  if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(&sh[cur], v);
  if (threadIdx.x == 0) sh[nxt] = 0;
  __syncthreads();
  if constexpr (kMem != kGrid) {
    return sh[cur];
  } else {
    if (threadIdx.x == 0) {
      const unsigned long long part = sh[cur];
      if (part != 0) atomicAdd(&g[cur], part);
      if (blockIdx.x == 0) g[nxt] = 0;
    }
    cg::this_grid().sync();
    return *reinterpret_cast<volatile unsigned long long*>(&g[cur]);
  }
}

// List, for every state q, the pairs (s, p) of an occupied slot p with
// str[p][s] = q: ent[start[q] .. start[q + 1]) = s << 5 | p, in any order
// (a round ORs them). Block-local: every thread of the block calls it.
__device__ void list_sources(const int16_t* str, uint32_t occ, int S, int P,
                             uint32_t* ent, int* start, int* fill) {
  for (int q = threadIdx.x; q < S; q += blockDim.x) fill[q] = 0;
  __syncthreads();
  const int n = P * S;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int q = str[i];
    if (q >= 0 && ((occ >> (i / S)) & 1u)) atomicAdd(&fill[q], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int at = 0;
    for (int q = 0; q < S; ++q) {
      start[q] = at;
      at += fill[q];
      fill[q] = 0;
    }
    start[S] = at;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = i / S;
    const int q = str[i];
    if (q >= 0 && ((occ >> p) & 1u)) {
      ent[start[q] + atomicAdd(&fill[q], 1)] = (uint32_t)(i - p * S) << 5 | p;
    }
  }
  __syncthreads();
}

// One Jacobi round on 16-byte chunks (P >= 4): K1's chunk formulation.
// Returns whether any cell changed.
template <int kMem>
__device__ bool round_chunks(const Team<kMem>& team, const uint4* a, uint4* b,
                             int S, int lg, const uint32_t* ent,
                             const int* start, unsigned long long* sh,
                             unsigned long long* g, int& k) {
  const int n = S << lg;
  const int jmask = (1 << lg) - 1;
  unsigned long long moved = 0;
  for (int i = team.rank(); i < n; i += team.size()) {
    const int q = i >> lg;
    const int j = i & jmask;
    const uint4 own = ld<kMem>(a + i);
    uint4 acc = own;
    for (int t = start[q]; t < start[q + 1]; ++t) {
      const uint32_t x = ent[t];
      const int p = (int)(x & 31u);
      const int s = (int)(x >> 5);
      if (p < kChunkLog) {
        or_into(acc, butterfly_any(p, ld<kMem>(a + (s << lg) + j)));
      } else if ((j >> (p - kChunkLog)) & 1) {
        or_into(acc, ld<kMem>(a + (s << lg) + (j ^ (1 << (p - kChunkLog)))));
      }
    }
    st<kMem>(b + i, acc);
    moved |= (acc.x != own.x) | (acc.y != own.y) | (acc.z != own.z) |
             (acc.w != own.w);
  }
  return team_sum<kMem>(moved, sh, g, k) != 0;
}

// One Jacobi round on single cells (P < 4, always in shared memory).
__device__ bool round_cells(const uint8_t* a, uint8_t* b, int S, int P,
                            const uint32_t* ent, const int* start,
                            unsigned long long* sh, int& k) {
  const int n = S << P;
  const int cmask = (1 << P) - 1;
  unsigned long long moved = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int q = i >> P;
    const int c = i & cmask;
    const uint8_t own = a[i];
    uint8_t v = own;
    for (int t = start[q]; t < start[q + 1]; ++t) {
      const uint32_t x = ent[t];
      const int p = (int)(x & 31u);
      if ((c >> p) & 1) v |= a[((int)(x >> 5) << P) + (c ^ (1 << p))];
    }
    b[i] = v;
    moved |= v != own;
  }
  return team_sum<kShared>(moved, sh, nullptr, k) != 0;
}

// The completion gather on 32-bit words (P >= 4, so a row has at least
// four): out[s][c] = in[s][c | rm] where c & rm == 0, else 0. Word k of a
// row holds columns 4k .. 4k + 3: bits 2 and up of rm pick the source
// word, bits 0-1 move bytes inside it.
template <int kMem>
__device__ void complete_words(const Team<kMem>& team, const uint32_t* a,
                               uint32_t* b, int S, int lg, int rm) {
  const int n = S << lg;
  const int kmask = (1 << lg) - 1;
  const int rl = rm & 3;
  const int rh = rm >> 2;
  for (int i = team.rank(); i < n; i += team.size()) {
    uint32_t v = 0;
    if (((i & kmask) & rh) == 0) {
      const uint32_t src = ld<kMem>(a + (i | rh));
      v = rl == 0 ? src
                  : rl == 1 ? (src >> 8) & 0x00FF00FFu
                            : rl == 2 ? src >> 16 : src >> 24;
    }
    st<kMem>(b + i, v);
  }
}

__device__ void complete_cells(const uint8_t* a, uint8_t* b, int S, int P,
                               int rm) {
  const int n = S << P;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    b[i] = (i & rm) != 0 ? 0 : a[i | rm];
  }
}

// The table's popcount (low word) and, with attestation, its true cells in
// columns that hold a bit of nb, the unoccupied slots (high word), summed
// over the team.
template <int kMem>
__device__ unsigned long long count_words(const Team<kMem>& team,
                                          const uint32_t* a, int S, int lg,
                                          uint32_t nb, int attest,
                                          unsigned long long* sh,
                                          unsigned long long* g, int& k) {
  const int n = S << lg;
  const int kmask = (1 << lg) - 1;
  // the bytes of a word whose in-word column bits (0-1) meet nb
  const uint32_t low = ((nb & 1u) ? 0xFF00FF00u : 0u) |
                       ((nb & 2u) ? 0xFFFF0000u : 0u);
  unsigned long long cnt = 0, bad = 0;
  for (int i = team.rank(); i < n; i += team.size()) {
    const uint32_t v = ld<kMem>(a + i);
    const int pc = __popc(v);
    cnt += pc;
    if (attest) {
      bad += (((uint32_t)(i & kmask) << 2) & nb) ? pc : __popc(v & low);
    }
  }
  return team_sum<kMem>(cnt | bad << 32, sh, g, k);
}

__device__ unsigned long long count_cells(const uint8_t* a, int S, int P,
                                          uint32_t nb, int attest,
                                          unsigned long long* sh, int& k) {
  const int n = S << P;
  const int cmask = (1 << P) - 1;
  unsigned long long cnt = 0, bad = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned v = a[i];
    cnt += v;
    if (attest && ((uint32_t)(i & cmask) & nb)) bad += v;
  }
  return team_sum<kShared>(cnt | bad << 32, sh, nullptr, k);
}

template <bool kChunks, int kMem>
__global__ void __launch_bounds__(kMaxThreads) dense_walk(const Walk w) {
  const Team<kMem> team{};
  const int b = kMem == kGrid ? 0 : (int)blockIdx.x;
  const int B = w.B, S = w.S, P = w.P;
  const size_t cells = (size_t)S << P;
  extern __shared__ uint4 smem[];
  __shared__ unsigned long long sh[3];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  uint8_t* ta;
  uint8_t* tb;
  size_t off = 0;
  if constexpr (kMem == kShared) {
    ta = base;
    tb = base + r16(cells);
    off = 2 * r16(cells);
  } else {
    ta = w.tb_out + b * cells;
    tb = w.scratch + b * cells;
  }
  int16_t* str = reinterpret_cast<int16_t*>(base + off);
  off += r16((size_t)P * S * 2);
  uint32_t* ent = reinterpret_cast<uint32_t*>(base + off);
  off += r16((size_t)P * S * 4);
  int* start = reinterpret_cast<int*>(base + off);
  off += r16((size_t)(S + 1) * 4);
  int* fill = reinterpret_cast<int*>(base + off);
  off += r16((size_t)S * 4);
  int32_t* slot = reinterpret_cast<int32_t*>(base + off);
  int k = 0;

  // the carry: scalars and occupancy in every thread's registers, slots
  // and slot rows in the block's shared memory, the table in ta
  int e = w.sc_in[b];
  int att = w.sc_in[B + b];
  int count = w.sc_in[2 * B + b];
  int maxc = w.sc_in[3 * B + b];
  const int e0 = e;
  const int wend = w.wend[b];
  uint32_t occ = 0;
  for (int p = 0; p < P; ++p) {
    occ |= (w.occ_in[(size_t)b * P + p] != 0 ? 1u : 0u) << p;
  }
  for (int i = threadIdx.x; i < 3 * P; i += blockDim.x) {
    slot[i] = w.slot_in[((size_t)(i / P) * B + b) * P + i % P];
  }
  for (int i = threadIdx.x; i < P * S; i += blockDim.x) {
    str[i] = w.str0[(size_t)b * P * S + i];
  }
  if (threadIdx.x < 3) sh[threadIdx.x] = 0;
  if constexpr (kChunks) {
    const uint4* src = reinterpret_cast<const uint4*>(w.tb_in + b * cells);
    for (int i = team.rank(); i < (int)(cells >> 4); i += team.size()) {
      st<kMem>(reinterpret_cast<uint4*>(ta) + i, src[i]);
    }
  } else {
    for (int i = threadIdx.x; i < (int)cells; i += blockDim.x) {
      ta[i] = w.tb_in[b * cells + i];
    }
  }
  __syncthreads();
  if constexpr (kMem == kGrid) team.sync();

  const uint32_t cmask = (1u << P) - 1u;
  const int16_t* itr = w.itr + (size_t)b * w.W * S;
  while (e < wend && count > 0) {
    const int32_t* row = w.x + ((size_t)b * w.T + e) * kRowWords;
    const int rm = row[0];
    const int inv = row[1];
    if (rm != 0) {
      if constexpr (kChunks) {
        complete_words<kMem>(team, reinterpret_cast<const uint32_t*>(ta),
                             reinterpret_cast<uint32_t*>(tb), S, P - 2, rm);
      } else {
        complete_cells(ta, tb, S, P, rm);
      }
      uint8_t* t = ta;
      ta = tb;
      tb = t;
      occ &= ~(uint32_t)rm;
      team.sync();
    }
    if (inv >= 0) {
      if (threadIdx.x == 0) {
        slot[inv] = row[2];
        slot[P + inv] = row[3];
        slot[2 * P + inv] = row[4];
      }
      const int16_t* nrow = itr + (size_t)(e - e0) * S;
      for (int i = threadIdx.x; i < S; i += blockDim.x) {
        str[inv * S + i] = nrow[i];
      }
      occ |= 1u << inv;
      __syncthreads();
      list_sources(str, occ, S, P, ent, start, fill);
      int rounds = 0;
      bool moved;
      do {
        if constexpr (kChunks) {
          moved = round_chunks<kMem>(team, reinterpret_cast<const uint4*>(ta),
                                     reinterpret_cast<uint4*>(tb), S,
                                     P - kChunkLog, ent, start, sh, w.red, k);
        } else {
          moved = round_cells(ta, tb, S, P, ent, start, sh, k);
        }
        uint8_t* t = ta;
        ta = tb;
        tb = t;
        ++rounds;
      } while (moved);
      if (team.lead()) {
        atomicMax(&w.iter_rounds[e - e0], rounds);
        atomicAdd(w.pairs, (unsigned long long)rounds * start[S]);
      }
    }
    unsigned long long cb;
    if constexpr (kChunks) {
      cb = count_words<kMem>(team, reinterpret_cast<const uint32_t*>(ta), S,
                             P - 2, ~occ & cmask, w.attest, sh, w.red, k);
    } else {
      cb = count_cells(ta, S, P, ~occ & cmask, w.attest, sh, k);
    }
    count = (int)(cb & 0xffffffffull);
    if (w.attest) att = (int)((uint32_t)att + (uint32_t)(cb >> 32));
    maxc = max(maxc, count);
    ++e;
  }

  // write the carry back; the last pass ended in a barrier of the team
  uint8_t* out = w.tb_out + b * cells;
  if (kMem == kShared || ta != out) {
    if constexpr (kChunks) {
      for (int i = team.rank(); i < (int)(cells >> 4); i += team.size()) {
        __stcg(reinterpret_cast<uint4*>(out) + i,
               ld<kMem>(reinterpret_cast<const uint4*>(ta) + i));
      }
    } else {
      for (int i = threadIdx.x; i < (int)cells; i += blockDim.x) {
        out[i] = ta[i];
      }
    }
  }
  if (team.lead()) {
    w.sc_out[b] = e;
    w.sc_out[B + b] = att;
    w.sc_out[2 * B + b] = count;
    w.sc_out[3 * B + b] = maxc;
  }
  __syncthreads();
  if (kMem != kGrid || blockIdx.x == 0) {
    for (int i = threadIdx.x; i < 3 * P; i += blockDim.x) {
      w.slot_out[((size_t)(i / P) * B + b) * P + i % P] = slot[i];
    }
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      w.occ_out[(size_t)b * P + p] = (uint8_t)((occ >> p) & 1u);
    }
  }
}

template <bool kChunks, int kMem>
int launch(const Walk& w, int blocks, int threads, size_t smem,
           cudaStream_t s) {
  const auto kernel = &dense_walk<kChunks, kMem>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (kMem == kGrid) {
    void* args[] = {const_cast<Walk*>(&w)};
    return (int)cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel), dim3((unsigned)blocks),
        dim3((unsigned)threads), args, smem, s);
  } else {
    kernel<<<(unsigned)blocks, threads, smem, s>>>(w);
    return (int)cudaGetLastError();
  }
}

int round_up32(long long n) {
  const long long t = ((n + 31) / 32) * 32;
  return (int)(t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

// Walk B keys (B = 1: one key) over their windows in one launch. All
// tensors contiguous on the current device; tb_in, tb_out and scratch
// 16-byte aligned when P >= 4; red zeroed (3 x uint64); iter_rounds zeroed
// (W x int32); pairs zeroed (1 x uint64). Returns the CUDA error of the
// launch (0 when it was taken).
extern "C" int jt_dense_walk(const void* x, int T, const void* wend,
                             const void* itr, int W, const void* str0,
                             const void* sc_in, const void* tb_in,
                             const void* slot_in, const void* occ_in,
                             void* sc_out, void* tb_out, void* slot_out,
                             void* occ_out, void* scratch, void* iter_rounds,
                             void* red, void* pairs, int B, int S, int P,
                             int attest, void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || S <= 0 || S > kMaxStates || P < 0 ||
      P > kMaxSlots || ((long long)S << P) > kMaxCells) {
    return (int)cudaErrorInvalidValue;
  }
  if (P >= kChunkLog &&
      (((uintptr_t)tb_in | (uintptr_t)tb_out | (uintptr_t)scratch) & 15u)) {
    return (int)cudaErrorMisalignedAddress;
  }
  Walk w;
  w.x = static_cast<const int32_t*>(x);
  w.wend = static_cast<const int32_t*>(wend);
  w.itr = static_cast<const int16_t*>(itr);
  w.str0 = static_cast<const int16_t*>(str0);
  w.sc_in = static_cast<const int32_t*>(sc_in);
  w.tb_in = static_cast<const uint8_t*>(tb_in);
  w.slot_in = static_cast<const int32_t*>(slot_in);
  w.occ_in = static_cast<const uint8_t*>(occ_in);
  w.sc_out = static_cast<int32_t*>(sc_out);
  w.tb_out = static_cast<uint8_t*>(tb_out);
  w.slot_out = static_cast<int32_t*>(slot_out);
  w.occ_out = static_cast<uint8_t*>(occ_out);
  w.scratch = static_cast<uint8_t*>(scratch);
  w.iter_rounds = static_cast<int32_t*>(iter_rounds);
  w.red = static_cast<unsigned long long*>(red);
  w.pairs = static_cast<unsigned long long*>(pairs);
  w.B = B;
  w.T = T;
  w.W = W;
  w.S = S;
  w.P = P;
  w.attest = attest ? 1 : 0;

  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)S << P;
  const size_t ctrl = ctrl_bytes(S, P);
  const size_t shared = 2 * r16((size_t)cells) + ctrl;
  const bool fits = shared + kStaticSmem <= (size_t)optin;
  if (P < kChunkLog) {
    // at most 512 x 8 cells: always fits
    if (!fits) return (int)cudaErrorInvalidConfiguration;
    return launch<false, kShared>(w, B, round_up32(cells), shared, s);
  }
  const long long words = cells >> 2;
  if (fits) {
    return launch<true, kShared>(w, B, round_up32(words), shared, s);
  }
  if (B > 1) {
    return launch<true, kGlobal>(w, B, kMaxThreads, ctrl, s);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dense_walk<true, kGrid>, kMaxThreads, ctrl);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (words + kMaxThreads - 1) / kMaxThreads;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  return launch<true, kGrid>(w, (int)blocks, kMaxThreads, ctrl, s);
}

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
