// K3: the dense engine's step walk, for Hopper (sm_90a).
//
// Replaces the JAX package's on-device walk, jepsen_tpu/checker/wgl.py:1150
// (`_dense_kernel_cached.run_range`, a lax.while_loop under jax.jit, with
// the closure fixpoint a second while_loop around the Pallas round at
// :1077-1095) and its jax.vmap (`check_chunk_batch`, :1220). One launch
// walks a window of steps [e, wend) of each key's (T, 5) step matrix
// [rm, slot, f, a, b] over the dense carry
// (e, table bool[S][C], slot_f, slot_a, slot_b int32[P], occ[P], att,
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
// Bit-packed tables. At launch start each key's bool table is packed into
// 32 cells a word (row s: words j = 0 .. max(C / 32, 1) - 1, cell c in bit
// c & 31 of word c >> 5; for P < 5 one word a row, its bits C and up never
// set), and unpacked into the carry's layout at the end. On words:
//   * a Jacobi round from source (s, p) into row q: for p < 5 a shift and
//     mask inside the word, (w << 2^p) & M_p, with M_p the bits whose
//     column has bit p set (0xAAAAAAAA, 0xCCCCCCCC, 0xF0F0F0F0,
//     0xFF00FF00, 0xFFFF0000); for p >= 5 an OR of word j ^ 2^(p-5) into
//     word j where bit p - 5 of j is set;
//   * the completion: word j takes word j | (rm >> 5), or 0 where
//     j & (rm >> 5) != 0, then for each set bit b of rm & 31,
//     x = (x >> 2^b) & ~M_b;
//   * the count is __popc, and the attestation __popc of the whole word
//     where j & (nb >> 5) != 0, else under the OR of M_b over the bits b
//     < 5 of nb, the unoccupied slots.
// Rounds stay Jacobi (each reads one table and writes the other, as the
// eager walk's K1 round), and only add cells, so a round moved the table
// exactly when its popcount grew: every pass that writes a table also
// sums its popcount and attestation, so a step needs no count pass of its
// own and the round count is the eager walk's.
//
// The model in the kernel. Each invoke computes its slot's next-state row
// itself: for every state s, the state that linearizing the op in state
// s_lo + s leads to, minus s_lo, or -1 where that is illegal or leaves
// [0, S) (csrc/sort_models.cuh, the six device models; the wrapper's
// `transition_rows` is the same row in torch). Launch start computes the
// rows of the carry's slots. Before an invoke's rounds one warp lists, for
// every state q, the (source state s, slot p) pairs of occupied slots
// whose row moves s to q (a counting sort), so a round reads only the
// rows that can move into its row.
//
// Tiers, chosen by the host function below from (B, S, P). All keep the
// table pair on chip:
//   * warp: one warp a key, up to four keys a block, the pair and the
//     lists in the warp's slice of shared memory, for tables of at most
//     `warp_max_words` words (the wrapper's 32, a word a lane, where the
//     warp stopped beating a block: the headline's 8 x 128 cells, the
//     mutex, the hazelcast groups up to P = 6). Lanes meet at __syncwarp
//     and warp reductions; no block barrier. The step rows are read 32
//     at a time, one a lane, and handed out by shuffle;
//   * block: one block a key with the pair in shared memory (up to about
//     200 KB: up to P = 16 at S = 8), a thread a word up to 1,024 words,
//     lanes meeting at block barriers;
//   * cluster: one key on a thread-block cluster of 2-8 blocks (at-cap
//     P = 19: 1 MB a pair, 128 KB a block). Block r owns words
//     [r * NW / n, (r + 1) * NW / n) of every row; a partner word in
//     another block is read through distributed shared memory
//     (map_shared_rank); the blocks meet at cluster barriers, and the
//     sums go through the lead block's shared memory. A batch is a grid
//     of clusters. Every block runs the same control (rows, slots, lists)
//     in its own shared memory.
// On the block and cluster tiers the window's step rows are copied into
// shared memory 128 steps at a time with cp.async, double-buffered, so no
// step waits on a dependent global load.
//
// Round counts. The rounds of the invoke at a key's w-th step of the
// launch go into rounds[w] by atomicMax, so that the caller's sum of them
// is, for a batch, the eager lockstep walk's count (one batched round
// while any invoking key still moves: the max over the keys invoking at
// that lockstep step) and, for one key, the sum of its rounds. Every
// active key starts a launch at the same lockstep step. The launch also
// sums, over every key's rounds, the (s, p) pairs listed for the round: a
// round ORs one half row per pair, so this is the closure's work (the
// operations of the caller's bound).
//
// Bound on an H100. The bytes the walk must move from device memory are
// each key's carry and window, read once and written once; the
// operations are a few per table word a pass. The walk is latency bound:
// each step is a chain of dependent passes (completion, each round) joined
// by barriers, which the TPU program ran as a while_loop with no host in
// it. The tiers shorten the chain's links: a warp's barrier is a
// __syncwarp, a block's a __syncthreads, and no tier goes through L2.
//
// The C entry point takes raw device pointers and the CUDA stream and
// returns the CUDA error of the launch, so a refused launch is reported to
// the caller (jepsen_tpu_torch/checker/wgl_walk.py), which raises.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "sort_models.cuh"

namespace cg = cooperative_groups;

namespace {

enum Tier : int { kWarp = 0, kBlock = 1, kCluster = 2 };

constexpr int kMaxThreads = 1024;
constexpr int kWarpKeys = 4;             // keys (warps) a warp-tier block
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kMaxSlots = 30;            // C = 2^P must fit an int
constexpr int kMaxStates = 512;          // the dense engine's state cap
constexpr long long kMaxCells = 1LL << 22;   // S * C on the dense engine
constexpr int kRowWords = 5;             // [rm, slot, f, a, b]
constexpr int kChunk = 128;              // steps a read-ahead buffer holds
constexpr size_t kStaticSmem = 1024;     // margin for the static arrays

struct Walk {
  const int32_t* x;         // (B, T, 5) step rows
  const int32_t* wend;      // (B,) end (exclusive) of each key's window
  const int32_t* sc_in;     // (4, B): e, att, count, max_count
  const uint8_t* tb_in;     // (B, S, C) bool
  const int32_t* slot_in;   // (3, B, P): f, a, b
  const uint8_t* occ_in;    // (B, P)
  int32_t* sc_out;
  uint8_t* tb_out;
  int32_t* slot_out;
  uint8_t* occ_out;
  // (2B + 1 + W), zeroed: each key's e, then count, the pair rounds, and
  // the max over the keys of the rounds at each window step
  unsigned long long* out;
  int B, T, W, S, P;
  int model, s_lo, attest;
  int lgb;                  // log2 of the words of a row one block holds
  size_t key_smem;          // shared bytes of one key's warp (warp tier)
};

__host__ __device__ constexpr size_t r16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Shared memory of a key's control: str (int16 P x S), the listed sources
// (uint32 P x S), start (S + 1), fill (S), slots (3 x P).
__host__ __device__ size_t ctrl_bytes(int S, int P) {
  return r16((size_t)P * S * 2) + r16((size_t)P * S * 4) +
         r16((size_t)(S + 1) * 4) + r16((size_t)S * 4) +
         r16((size_t)3 * P * 4);
}

// One key's shared memory: the table pair (S rows of 2^lgb words each),
// the control and, off the warp tier, the two step-row buffers.
__host__ __device__ size_t key_bytes(int S, int P, int lgb, bool rows) {
  return 2 * r16(((size_t)S << lgb) * 4) + ctrl_bytes(S, P) +
         (rows ? 2 * (size_t)kChunk * kRowWords * 4 : 0);
}

// M_b, b < 5: the bits of a word whose column has bit b set (selects, not
// a table: the lanes of a warp ask for different b at once)
__device__ __forceinline__ uint32_t mask_of(int b) {
  return b == 0   ? 0xAAAAAAAAu
         : b == 1 ? 0xCCCCCCCCu
         : b == 2 ? 0xF0F0F0F0u
         : b == 3 ? 0xFF00FF00u
                  : 0xFFFF0000u;
}

__device__ __forceinline__ int16_t next_state(int model, int s_lo, int S,
                                              int s, int f, int a, int b) {
  int out = 0;
  const bool legal = jt_models::step(model, s_lo + s, f, a, b, &out);
  const long long idx = (long long)out - s_lo;
  return legal && idx >= 0 && idx < S ? (int16_t)idx : (int16_t)-1;
}

// the attestation mask inside a word: the bits whose column holds one of
// the bits 0-4 of nb
__device__ __forceinline__ uint32_t low_mask(uint32_t nb) {
  uint32_t m = 0;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    if ((nb >> b) & 1u) m |= mask_of(b);
  }
  return m;
}

__device__ __forceinline__ uint32_t bad_in(uint32_t w, int j, uint32_t nb,
                                           uint32_t mlo) {
  return ((uint32_t)j & (nb >> 5)) ? __popc(w) : __popc(w & mlo);
}

// four bool bytes -> four bits, and back
__device__ __forceinline__ uint32_t nib(uint32_t v) {
  const uint32_t m = __vcmpne4(v, 0u);
  return (m & 1u) | ((m >> 7) & 2u) | ((m >> 14) & 4u) | ((m >> 21) & 8u);
}

__device__ __forceinline__ uint32_t spread(uint32_t n) {
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The threads of one key: a warp, a block, or the blocks of a cluster.
// rank and size count the threads that share this block's slice of the
// table; crank is the block's rank in its cluster (0 off the cluster).
template <int kTier>
struct Team {
  int rank, size;
  unsigned crank;

  __device__ Team() {
    if constexpr (kTier == kWarp) {
      rank = (int)(threadIdx.x & 31);
      size = 32;
      crank = 0;
    } else if constexpr (kTier == kBlock) {
      rank = (int)threadIdx.x;
      size = (int)blockDim.x;
      crank = 0;
    } else {
      rank = (int)threadIdx.x;
      size = (int)blockDim.x;
      crank = cg::this_cluster().block_rank();
    }
  }

  // the threads that share this block's control (rows, slots, lists)
  __device__ __forceinline__ void local_sync() const {
    if constexpr (kTier == kWarp) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }

  __device__ __forceinline__ bool lead() const {
    return rank == 0 && crank == 0;
  }

  // the thread that runs this block's control: one warp's lanes
  __device__ __forceinline__ bool control_warp() const {
    return kTier == kWarp || threadIdx.x < 32;
  }
};

// The warp's sum of v, in every lane.
__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The key's sum of (pc, bad), returned to every thread as bad << 32 | pc
// (each at most 2^22); also a barrier of the key's threads. No atomics:
// on the block tiers each warp writes its sum into slot k % 2 of `sh`
// (32 words a slot) and, after the block barrier, every warp adds the
// slot up; on a cluster each block then writes its sum into slot k % 2
// of every block's `part` (kMaxCluster words a slot), and after the
// cluster barrier every warp adds its own block's slot up. A slot is
// written again two calls later, after a barrier that every reader of
// the call before reached.
template <int kTier>
__device__ unsigned long long team_sum(uint32_t pc, uint32_t bad,
                                       unsigned long long* sh,
                                       unsigned long long* part, int& k) {
  if constexpr (kTier == kWarp) {
    __syncwarp();   // the lanes' table writes, ordered before any read
    const uint32_t a = __reduce_add_sync(0xffffffffu, pc);
    const uint32_t c = __reduce_add_sync(0xffffffffu, bad);
    return (unsigned long long)c << 32 | a;
  } else {
    const int lane = (int)(threadIdx.x & 31);
    const int cur = k & 1;
    ++k;
    unsigned long long v = warp_sum((unsigned long long)bad << 32 | pc);
    unsigned long long* ws = sh + 32 * cur;
    if (lane == 0) ws[threadIdx.x >> 5] = v;
    __syncthreads();
    v = warp_sum(lane < (int)(blockDim.x >> 5) ? ws[lane] : 0ull);
    if constexpr (kTier == kBlock) {
      return v;
    } else {
      cg::cluster_group cl = cg::this_cluster();
      const unsigned n = cl.num_blocks();
      unsigned long long* ps = part + kMaxCluster * cur;
      if (threadIdx.x < n) {
        *cl.map_shared_rank(ps + cl.block_rank(), threadIdx.x) = v;
      }
      cl.sync();
      return warp_sum(lane < (int)n ? ps[lane] : 0ull);
    }
  }
}

// Word j of row s of table a, wherever in the key's blocks it lies.
template <int kTier>
__device__ __forceinline__ uint32_t word_at(uint32_t* a, int s, int j,
                                            int lgb, unsigned crank) {
  const int i = (s << lgb) | (j & ((1 << lgb) - 1));
  if constexpr (kTier == kCluster) {
    const unsigned rb = (unsigned)(j >> lgb);
    if (rb != crank) return cg::this_cluster().map_shared_rank(a, rb)[i];
  }
  return a[i];
}

// The words of row s of table a that this block's word jl of a row is
// paired with by slot p >= 5 (d = 2^(p-5)): its own block's row for
// d < 2^lgb, else, on a cluster, that of block crank ^ (d >> lgb), through
// distributed shared memory.
template <int kTier>
__device__ __forceinline__ const uint32_t* partner_row(const uint32_t* a,
                                                       int s, int d, int lgb,
                                                       unsigned crank) {
  const uint32_t* row = a + (s << lgb);
  if constexpr (kTier == kCluster) {
    if (d >> lgb) {
      return cg::this_cluster().map_shared_rank(const_cast<uint32_t*>(row),
                                                crank ^ (d >> lgb));
    }
  }
  return row;
}

// One Jacobi round from ta into tb over this block's slice, with the
// popcount and attestation of what it wrote added to npc and nbad. Where
// a row's slice has at least as many words as the block has threads
// (wide), thread r's words of row q are r + m * size, and each listed
// pair is decoded once for kGroup of them; else (narrow) word i goes to
// thread i % size. Either way word i is thread i % size's.
constexpr int kGroup = 2;

template <int kTier>
__device__ __forceinline__ void round_pass(
    const Team<kTier>& team, const uint32_t* ta, uint32_t* tb, int S,
    int lgb, const uint32_t* ent, const int* start, uint32_t nb,
    uint32_t mlo, int attest, uint32_t& npc, uint32_t& nbad) {
  const int nwb = 1 << lgb;
  const int base = (int)(team.crank << lgb);
  // (a warp holds at most a word a lane: every table is narrow there)
  if (kTier != kWarp && nwb >= team.size) {
    const int wpr = nwb / team.size;
    for (int q = 0; q < S; ++q) {
      const int t0 = start[q], t1 = start[q + 1];
      for (int m0 = 0; m0 < wpr; m0 += kGroup) {
        uint32_t acc[kGroup];
        int jl[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          jl[u] = team.rank + (m0 + u) * team.size;
          acc[u] = m0 + u < wpr ? ta[(q << lgb) | jl[u]] : 0u;
        }
        for (int t = t0; t < t1; ++t) {
          const uint32_t xe = ent[t];
          const int p = (int)(xe & 31u);
          const int s = (int)(xe >> 5);
          if (p < 5) {
            const uint32_t* row = ta + (s << lgb);
            const int sh = 1 << p;
            const uint32_t m = mask_of(p);
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
              if (m0 + u < wpr) acc[u] |= (row[jl[u]] << sh) & m;
            }
          } else {
            const int d = 1 << (p - 5);
            if (d >= nwb && !(base & d)) continue;
            const uint32_t* row = partner_row<kTier>(ta, s, d, lgb,
                                                     team.crank);
            const int x = d & (nwb - 1);
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
              if (m0 + u < wpr && (d >= nwb || (jl[u] & d))) {
                acc[u] |= row[jl[u] ^ x];
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (m0 + u < wpr) {
            tb[(q << lgb) | jl[u]] = acc[u];
            npc += __popc(acc[u]);
            if (attest) nbad += bad_in(acc[u], base | jl[u], nb, mlo);
          }
        }
      }
    }
    return;
  }
  const int nw = S << lgb;
  for (int i = team.rank; i < nw; i += team.size) {
    const int q = i >> lgb;
    const int jl = i & (nwb - 1);
    const int j = base | jl;
    uint32_t acc = ta[i];
    for (int t = start[q]; t < start[q + 1]; ++t) {
      const uint32_t xe = ent[t];
      const int p = (int)(xe & 31u);
      const int s = (int)(xe >> 5);
      if (p < 5) {
        acc |= (ta[(s << lgb) | jl] << (1 << p)) & mask_of(p);
      } else if ((j >> (p - 5)) & 1) {
        const int d = 1 << (p - 5);
        const uint32_t* row = partner_row<kTier>(ta, s, d, lgb, team.crank);
        acc |= row[jl ^ (d & (nwb - 1))];
      }
    }
    tb[i] = acc;
    npc += __popc(acc);
    if (attest) nbad += bad_in(acc, j, nb, mlo);
  }
}

// List, for every state q, the pairs (s, p) of an occupied slot p with
// str[p][s] = q: ent[start[q] .. start[q + 1]) = s << 5 | p, in any order
// (a round ORs them). One warp; every lane calls it.
__device__ void list_sources(const int16_t* str, uint32_t occ, int S, int P,
                             uint32_t* ent, int* start, int* fill) {
  const int lane = (int)(threadIdx.x & 31);
  for (int q = lane; q < S; q += 32) fill[q] = 0;
  __syncwarp();
  const int n = P * S;
  for (int i = lane; i < n; i += 32) {
    const int q = str[i];
    if (q >= 0 && ((occ >> (i / S)) & 1u)) atomicAdd(&fill[q], 1);
  }
  __syncwarp();
  // an exclusive scan of fill: lane l sums states [l * ch, (l + 1) * ch)
  const int ch = (S + 31) >> 5;
  const int lo = min(lane * ch, S);
  const int hi = min(lo + ch, S);
  int mine = 0;
  for (int q = lo; q < hi; ++q) mine += fill[q];
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int at = incl - mine;
  for (int q = lo; q < hi; ++q) {
    start[q] = at;
    at += fill[q];
    fill[q] = 0;
  }
  if (lane == 31) start[S] = incl;
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const int p = i / S;
    const int q = str[i];
    if (q >= 0 && ((occ >> p) & 1u)) {
      ent[start[q] + atomicAdd(&fill[q], 1)] = (uint32_t)(i - p * S) << 5 | p;
    }
  }
  __syncwarp();
}

// A step row, or no step (rm 0, slot -1) past the window's end.
struct Row {
  int v[kRowWords] = {0, -1, 0, 0, 0};
};

__device__ __forceinline__ Row load_row(const Walk& w, int b, int st,
                                        int wend) {
  Row r;
  if (st < wend) {
    const int32_t* row = w.x + ((size_t)b * w.T + st) * kRowWords;
#pragma unroll
    for (int i = 0; i < kRowWords; ++i) r.v[i] = row[i];
  }
  return r;
}

template <int kTier>
__global__ void __launch_bounds__(kTier == kWarp ? 32 * kWarpKeys
                                                 : kMaxThreads)
    dense_walk(const Walk w) {
  const Team<kTier> team;
  int b;
  extern __shared__ uint4 smem[];
  // team_sum's slots: two of a word a warp, two of a word a block
  __shared__ unsigned long long sh[2 * 32];
  __shared__ unsigned long long part[2 * kMaxCluster];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  if constexpr (kTier == kWarp) {
    b = (int)(blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5));
    if (b >= w.B) return;            // a whole warp; no block barrier here
    base += (threadIdx.x >> 5) * w.key_smem;
  } else if constexpr (kTier == kCluster) {
    b = (int)(blockIdx.x / cg::this_cluster().num_blocks());
  } else {
    b = (int)blockIdx.x;
  }
  const int B = w.B, S = w.S, P = w.P, lgb = w.lgb;
  const int C = 1 << P;
  const int nw = S << lgb;                 // words of this block's slice
  const int wmask = (1 << lgb) - 1;
  const unsigned crank = team.crank;
  uint32_t* ta = reinterpret_cast<uint32_t*>(base);
  uint32_t* tb = ta + r16((size_t)nw * 4) / 4;
  size_t off = 2 * r16((size_t)nw * 4);
  int16_t* str = reinterpret_cast<int16_t*>(base + off);
  off += r16((size_t)P * S * 2);
  uint32_t* ent = reinterpret_cast<uint32_t*>(base + off);
  off += r16((size_t)P * S * 4);
  int* start = reinterpret_cast<int*>(base + off);
  off += r16((size_t)(S + 1) * 4);
  int* fill = reinterpret_cast<int*>(base + off);
  off += r16((size_t)S * 4);
  int32_t* slot = reinterpret_cast<int32_t*>(base + off);
  off += r16((size_t)3 * P * 4);
  int32_t* rows = reinterpret_cast<int32_t*>(base + off);  // off the warp
  int k = 0;

  // the carry: scalars and occupancy in every thread's registers, slots
  // and slot rows in shared memory, the table packed into ta
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
  const uint32_t cmask = (uint32_t)(C - 1);
  for (int i = team.rank; i < 3 * P; i += team.size) {
    slot[i] = w.slot_in[((size_t)(i / P) * B + b) * P + i % P];
  }
  if constexpr (kTier != kWarp) {
    if (e < wend) {
      // the first read-ahead buffer: steps [e0, e0 + kChunk)
      const int n = min(kChunk, wend - e0) * kRowWords;
      const int32_t* src = w.x + ((size_t)b * w.T + e0) * kRowWords;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        cp_async4(rows + i, src + i);
      }
    }
    cp_async_commit();
  }
  team.local_sync();
  for (int i = team.rank; i < P * S; i += team.size) {
    const int p = i / S;
    str[i] = next_state(w.model, w.s_lo, S, i - p * S, slot[p],
                        slot[P + p], slot[2 * P + p]);
  }
  if constexpr (kTier == kCluster) {
    cg::this_cluster().sync();   // every block running
  }

  // pack this block's slice, with its popcount and attestation
  const uint8_t* tin = w.tb_in + (size_t)b * S * C;
  uint32_t nb = ~occ & cmask;
  uint32_t mlo = low_mask(nb);
  uint32_t pc = 0, bad = 0;
  for (int i = team.rank; i < nw; i += team.size) {
    const int q = i >> lgb;
    const int j = (int)(crank << lgb) | (i & wmask);
    const uint8_t* src = tin + (size_t)q * C;
    uint32_t v = 0;
    if (P >= 5) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src + (size_t)j * 32);
      const uint4 u = s4[0], t = s4[1];
      v = nib(u.x) | nib(u.y) << 4 | nib(u.z) << 8 | nib(u.w) << 12 |
          nib(t.x) << 16 | nib(t.y) << 20 | nib(t.z) << 24 | nib(t.w) << 28;
    } else {
      for (int c = 0; c < C; ++c) v |= (src[c] != 0 ? 1u : 0u) << c;
    }
    ta[i] = v;
    pc += __popc(v);
    if (w.attest) bad += bad_in(v, j, nb, mlo);
  }
  unsigned long long cb = team_sum<kTier>(pc, bad, sh, part, k);
  pc = (uint32_t)cb;
  bad = w.attest ? (uint32_t)(cb >> 32) : 0u;

  // the warp's read-ahead: lane l holds the row of step rbase + l
  int rbase = e;
  Row r = kTier == kWarp ? load_row(w, b, rbase + team.rank, wend) : Row{};
  int chunk = 0;   // off the warp tier: read-ahead buffers started

  while (e < wend && count > 0) {
    int rm, inv, f, a, bv;
    if constexpr (kTier == kWarp) {
      if (e - rbase == 32) {
        rbase = e;
        r = load_row(w, b, rbase + team.rank, wend);
      }
      const int l = e - rbase;
      rm = __shfl_sync(0xffffffffu, r.v[0], l);
      inv = __shfl_sync(0xffffffffu, r.v[1], l);
      f = __shfl_sync(0xffffffffu, r.v[2], l);
      a = __shfl_sync(0xffffffffu, r.v[3], l);
      bv = __shfl_sync(0xffffffffu, r.v[4], l);
    } else {
      const int t = e - e0;
      if (t == chunk * kChunk) {
        // buffer `chunk` has landed; every thread is done with the other
        // one, so the next chunk's copy can go into it
        cp_async_wait_all();
        __syncthreads();
        const int lo = e0 + (chunk + 1) * kChunk;
        if (lo < wend) {
          const int n = min(kChunk, wend - lo) * kRowWords;
          const int32_t* src = w.x + ((size_t)b * w.T + lo) * kRowWords;
          int32_t* dst = rows + ((chunk + 1) & 1) * kChunk * kRowWords;
          for (int i = threadIdx.x; i < n; i += blockDim.x) {
            cp_async4(dst + i, src + i);
          }
        }
        cp_async_commit();
        ++chunk;
      }
      const int32_t* row = rows + ((chunk - 1) & 1) * kChunk * kRowWords +
                           (t - (chunk - 1) * kChunk) * kRowWords;
      rm = row[0];
      inv = row[1];
      f = row[2];
      a = row[3];
      bv = row[4];
    }
    if (rm != 0) {
      // completion into tb, counted under the new occupancy
      occ &= ~(uint32_t)rm;
      nb = ~occ & cmask;
      mlo = low_mask(nb);
      const int rh = rm >> 5;
      const int rl = rm & 31;
      pc = bad = 0;
      for (int i = team.rank; i < nw; i += team.size) {
        const int q = i >> lgb;
        const int j = (int)(crank << lgb) | (i & wmask);
        uint32_t v = 0;
        if ((j & rh) == 0) {
          v = word_at<kTier>(ta, q, j | rh, lgb, crank);
#pragma unroll
          for (int bit = 0; bit < 5; ++bit) {
            if ((rl >> bit) & 1) v = (v >> (1 << bit)) & ~mask_of(bit);
          }
        }
        tb[i] = v;
        pc += __popc(v);
        if (w.attest) bad += bad_in(v, j, nb, mlo);
      }
      cb = team_sum<kTier>(pc, bad, sh, part, k);
      pc = (uint32_t)cb;
      bad = w.attest ? (uint32_t)(cb >> 32) : 0u;
      uint32_t* t = ta;
      ta = tb;
      tb = t;
    }
    if (inv >= 0) {
      occ |= 1u << inv;
      nb = ~occ & cmask;
      mlo = low_mask(nb);
      if (team.control_warp()) {
        if (team.rank == 0) {
          slot[inv] = f;
          slot[P + inv] = a;
          slot[2 * P + inv] = bv;
        }
        for (int s = (int)(threadIdx.x & 31); s < S; s += 32) {
          str[inv * S + s] = next_state(w.model, w.s_lo, S, s, f, a, bv);
        }
        __syncwarp();
        list_sources(str, occ, S, P, ent, start, fill);
      }
      team.local_sync();
      int rounds = 0;
      bool moved;
      do {
        uint32_t npc = 0, nbad = 0;
        round_pass<kTier>(team, ta, tb, S, lgb, ent, start, nb, mlo,
                          w.attest, npc, nbad);
        cb = team_sum<kTier>(npc, nbad, sh, part, k);
        moved = (uint32_t)cb != pc;
        pc = (uint32_t)cb;
        bad = w.attest ? (uint32_t)(cb >> 32) : 0u;
        uint32_t* t = ta;
        ta = tb;
        tb = t;
        ++rounds;
      } while (moved);
      if (team.lead()) {
        atomicMax(&w.out[2 * B + 1 + (e - e0)], (unsigned long long)rounds);
        atomicAdd(&w.out[2 * B],
                  (unsigned long long)rounds * (unsigned long long)start[S]);
      }
    }
    count = (int)pc;
    if (w.attest) att = (int)((uint32_t)att + bad);
    maxc = max(maxc, count);
    ++e;
  }

  // unpack this block's slice into the carry's layout; the last pass
  // ended in a barrier of the key's threads
  uint8_t* tout = w.tb_out + (size_t)b * S * C;
  for (int i = team.rank; i < nw; i += team.size) {
    const int q = i >> lgb;
    const int j = (int)(crank << lgb) | (i & wmask);
    const uint32_t v = ta[i];
    uint8_t* dst = tout + (size_t)q * C;
    if (P >= 5) {
      uint4* d4 = reinterpret_cast<uint4*>(dst + (size_t)j * 32);
      d4[0] = make_uint4(spread(v & 15u), spread((v >> 4) & 15u),
                         spread((v >> 8) & 15u), spread((v >> 12) & 15u));
      d4[1] = make_uint4(spread((v >> 16) & 15u), spread((v >> 20) & 15u),
                         spread((v >> 24) & 15u), spread(v >> 28));
    } else {
      for (int c = 0; c < C; ++c) dst[c] = (uint8_t)((v >> c) & 1u);
    }
  }
  if (crank == 0) {
    if (team.rank == 0) {
      w.sc_out[b] = e;
      w.sc_out[B + b] = att;
      w.sc_out[2 * B + b] = count;
      w.sc_out[3 * B + b] = maxc;
      w.out[b] = (unsigned long long)(long long)e;
      w.out[B + b] = (unsigned long long)(long long)count;
    }
    for (int i = team.rank; i < 3 * P; i += team.size) {
      w.slot_out[((size_t)(i / P) * B + b) * P + i % P] = slot[i];
    }
    for (int p = team.rank; p < P; p += team.size) {
      w.occ_out[(size_t)b * P + p] = (uint8_t)((occ >> p) & 1u);
    }
  }
  if constexpr (kTier != kWarp) cp_async_wait_all();
  if constexpr (kTier == kCluster) {
    // no block leaves while another may still read its shared memory
    cg::this_cluster().sync();
  }
}

// Where B keys of S x 2^P cells walk on the current device: the tier, the
// cluster size (1 off the cluster tier), the threads a block and the
// dynamic shared memory a block.
struct Plan {
  int tier, cluster, threads, lgb;
  size_t smem;
};

int round_up32(long long n) {
  const long long t = ((n + 31) / 32) * 32;
  return (int)(t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t);
}

int plan_walk(int B, int S, int P, int warp_max_words, Plan* pl) {
  if (B <= 0 || S <= 0 || S > kMaxStates || P < 0 || P > kMaxSlots ||
      ((long long)S << P) > kMaxCells) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const size_t room = (size_t)optin - kStaticSmem;
  const int lgw = P > 5 ? P - 5 : 0;         // log2 of a row's words
  const long long words = (long long)S << lgw;
  if (words <= warp_max_words &&
      kWarpKeys * key_bytes(S, P, lgw, false) <= room) {
    const int keys = B < kWarpKeys ? B : kWarpKeys;
    *pl = {kWarp, 1, 32 * keys, lgw, keys * key_bytes(S, P, lgw, false)};
    return 0;
  }
  if (key_bytes(S, P, lgw, true) <= room) {
    *pl = {kBlock, 1, round_up32(words), lgw, key_bytes(S, P, lgw, true)};
    return 0;
  }
  for (int lgn = 1; (1 << lgn) <= kMaxCluster && lgn <= lgw; ++lgn) {
    if (key_bytes(S, P, lgw - lgn, true) <= room) {
      *pl = {kCluster, 1 << lgn, kMaxThreads, lgw - lgn,
             key_bytes(S, P, lgw - lgn, true)};
      return 0;
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

template <int kTier>
int launch(const Walk& w, const Plan& pl, cudaStream_t s) {
  const auto kernel = &dense_walk<kTier>;
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (kTier == kCluster) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(w.B * pl.cluster));
    cfg.blockDim = dim3((unsigned)pl.threads);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)pl.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // a cluster the card cannot place is refused, never run elsewhere
    int fit = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fit <= 0) return (int)cudaErrorLaunchOutOfResources;
    err = cudaLaunchKernelEx(&cfg, kernel, w);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  } else {
    const unsigned blocks =
        kTier == kWarp ? (unsigned)((w.B + pl.threads / 32 - 1) /
                                    (pl.threads / 32))
                       : (unsigned)w.B;
    kernel<<<blocks, pl.threads, pl.smem, s>>>(w);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// The plan of a launch of B keys at (S, P): tier (0 warp, 1 block, 2
// cluster), blocks a cluster, threads a block and dynamic shared bytes a
// block. Returns a CUDA error where the kernel does not take the shape.
extern "C" int jt_dense_walk_plan(int B, int S, int P, int warp_max_words,
                                  int* tier, int* cluster, int* threads,
                                  long long* smem) {
  Plan pl;
  const int err = plan_walk(B, S, P, warp_max_words, &pl);
  if (err != 0) return err;
  *tier = pl.tier;
  *cluster = pl.cluster;
  *threads = pl.threads;
  *smem = (long long)pl.smem;
  return 0;
}

// Walk B keys (B = 1: one key) over their windows in one launch. All
// tensors contiguous on the current device; tb_in and tb_out 16-byte
// aligned when P >= 5; out zeroed ((2B + 1 + W) x uint64). Writes the
// tier it launched on into *tier and returns the CUDA error of the launch
// (0 when it was taken).
extern "C" int jt_dense_walk(const void* x, int T, const void* wend, int W,
                             const void* sc_in, const void* tb_in,
                             const void* slot_in, const void* occ_in,
                             void* sc_out, void* tb_out, void* slot_out,
                             void* occ_out, void* out, int B, int S, int P,
                             int model, int s_lo, int attest,
                             int warp_max_words, int* tier, void* stream) {
  if (T <= 0 || W <= 0 || model < 0 || model >= jt_models::kModels) {
    return (int)cudaErrorInvalidValue;
  }
  Plan pl;
  const int err = plan_walk(B, S, P, warp_max_words, &pl);
  if (err != 0) return err;
  if (P >= 5 && (((uintptr_t)tb_in | (uintptr_t)tb_out) & 15u)) {
    return (int)cudaErrorMisalignedAddress;
  }
  Walk w;
  w.x = static_cast<const int32_t*>(x);
  w.wend = static_cast<const int32_t*>(wend);
  w.sc_in = static_cast<const int32_t*>(sc_in);
  w.tb_in = static_cast<const uint8_t*>(tb_in);
  w.slot_in = static_cast<const int32_t*>(slot_in);
  w.occ_in = static_cast<const uint8_t*>(occ_in);
  w.sc_out = static_cast<int32_t*>(sc_out);
  w.tb_out = static_cast<uint8_t*>(tb_out);
  w.slot_out = static_cast<int32_t*>(slot_out);
  w.occ_out = static_cast<uint8_t*>(occ_out);
  w.out = static_cast<unsigned long long*>(out);
  w.B = B;
  w.T = T;
  w.W = W;
  w.S = S;
  w.P = P;
  w.model = model;
  w.s_lo = s_lo;
  w.attest = attest ? 1 : 0;
  w.lgb = pl.lgb;
  w.key_smem = pl.tier == kWarp ? pl.smem / (pl.threads / 32) : pl.smem;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *tier = pl.tier;
  switch (pl.tier) {
    case kWarp: return launch<kWarp>(w, pl, s);
    case kBlock: return launch<kBlock>(w, pl, s);
    default: return launch<kCluster>(w, pl, s);
  }
}

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
