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
//   * packed sort (`_dedup_packed`, W == 1 with a packed config): the first
//     F positions of the stable sort of all N uint32 keys invalid << 31 |
//     (state - s_lo) << P | mask (mod 2^32), with their duplicates marked
//     invalid: invalid rows keep their decoded bits. valid = not invalid
//     and first of its run; new = valid and from a candidate; overflow = a
//     valid first-of-run at a position >= F.
//   * lexicographic sort (`_dedup_lex`): the same on the rows ordered by
//     (invalid, mask words as unsigned, state as signed), the first F rows
//     kept whole (garbage states of illegal candidates included).
// Both sorts select before they sort: only the first F of a dedup's N
// rows are sorted. Key word 0 is the invalid bit, then (packed) the key's
// other 31 bits or (lex) the mask words and the state with its sign
// flipped, so that unsigned word order is the key order.
//   1. Select. The row build counts the valid rows V and ORs each side's
//      word 1 and its complement, so the side holding position F - 1
//      (valid when V >= F) and the bits its rows share are known with no
//      read: the threshold starts as those bits. Then, level by level
//      below the known bits, the bucket (the rows that match the threshold
//      so far) is histogrammed by two digits: a fixed one (the next 8
//      bits) and a floating one (the remaining bits' top set bit and the 3
//      bits under it, which splits a bucket of small, skewed values that a
//      fixed window leaves in one bin). The level takes the digit whose bin
//      holding the position still needed is smaller: rows below the bin
//      are in, rows above out, and the bucket narrows to the bin, until it
//      is all in or the key runs out (then equal keys go lowest row first:
//      stability). The first histogram reads every row: where the side
//      shares only zeros above its differing bits it is the row build's
//      own histogram of word 1's floating digit (no read, no barrier of
//      its own). A bucket that shrank is compacted in row order and
//      refined over that list, and once it holds at most kLocal rows each
//      block finishes alone in its shared memory (the rows and their word,
//      compacted in place, the bits they share taken after each level): no
//      grid barrier.
//   2. Compact. One read of every row flags the selected ones (F of them)
//      with a bit a row, counts every 8-bit digit of every sort word of the
//      selected rows (an LSD digit's totals do not depend on the order),
//      and folds the overflow in: it holds exactly when position F - 1 is
//      valid (V >= F) and some valid row lies above the threshold. A scan
//      (by look-back on the grid path: no barrier) writes the selected
//      rows' indices and packed keys, or lex key words, in row order.
//   3. Sort. At most kRankGrid rows on the grid path (kRankBlock on one
//      block) are ranked: a row's place is the count of rows with a smaller
//      key or an equal key earlier in row order, one warp a row against
//      every key in shared memory, one team barrier. More rows take a
//      stable LSD radix sort, digits from the least significant word up, a
//      digit skipped when one value holds every row (read off the counts).
//      A pass takes the order in tiles (one a block, 1,024 rows a turn),
//      ranks each turn by digit in shared memory (one exclusive scan of the
//      (digit, warp) counts, a row's rank among the lanes of its digit by
//      __match_any_sync) and writes it out as one contiguous run a digit.
//      On the grid path a block learns the rows of each digit in the blocks
//      before it by decoupled look-back (each block publishes its tile's
//      digit counts tagged with the pass and reads its predecessors' as
//      they come), so a pass meets one grid barrier, at its end.
//   4. Extract the F outputs; a row's first-of-run test compares it with
//      the row before it.
//
// Counts. The rounds of the invoke at a key's w-th step of the launch go
// into iter_rounds[w] by atomicMax, and iter_inv[w] is set, so that for a
// batch the caller's sums are the eager lockstep walk's counts (one
// batched round while any invoking key has a legal candidate: the max
// over the keys invoking at that step; one hash dedup per step with an
// invoking key, and one a round) and for one key its own. The launch also
// sums the rows of every dedup; on the sort routes, the rows the
// selection's histograms, the ranking and the radix passes read (the row
// build, the compactions and the extraction, one read of every row each,
// are not counted); the dedups; the steps walked; and, on each key's lead
// thread, where the time went (`Phase`, from %globaltimer).
//
// Layout. Three paths, chosen by the host functions below:
//   * shared: one block of 1,024 threads per key (the grid's x is the
//     batch, B = 1 the unbatched walk), the key's working set (two
//     frontiers, the dedup's rows, its hash table or bucket lists and sort
//     buffers) in dynamic shared memory: the main path's F = 256 at P = 8,
//     16 and 32;
//   * global: one block per key, the working set in a per-key scratch in
//     device memory, for a batch of larger frontiers (the counter batch's
//     F = 1,024 at P = 16);
//   * grid: one key whose working set does not fit shared memory (the
//     escalations' F = 1,024-65,536) walks in one cooperative launch of one
//     block per SM. Every block runs the same control (row, slots,
//     occupancy, the selection's threshold) in its own shared memory; the
//     frontier, rows, insert, rank, histograms, compactions, sort passes
//     and extraction are split over the whole grid; phases meet at grid
//     barriers; sums go through a rotation of three global slots, scans
//     through per-block rows, histograms through three rotating global
//     rows of atomics, digit counts through two. Loads and stores of the
//     working set go to L2 (__ldcg, __stcg), so a block never reads
//     another block's write from a stale L1 line.
//
// Bound on an H100: latency. The bytes it must move from device memory
// are each key's carry and window, read once and written once; the
// operations a few per row of each dedup (a hash insert, or a look at the
// key by the selection). A step is a chain of dependent team-wide phases
// joined by barriers: the TPU ran it as a while_loop with no host in it;
// the eager walk ran it as 165-255 launches and one host read per stage-B
// round.
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
constexpr int kKeyWords = kMaxWords + 2;  // invalid, mask words, state
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kOwn = kBins * kWarps / kThreads;  // (digit, warp) pairs a thread scans
constexpr int kLocal = 4096;  // a bucket list each block refines alone
constexpr int kLook = 8;      // look-back loads in flight a thread
// the selected rows a team ranks by counting (`rank_sort`) instead of
// sorting by radix passes: on the grid path and on one block, and the key
// words that fit a block's sort scratch (aliased)
constexpr int kRankGrid = 4096;
constexpr int kRankBlock = 1024;
constexpr int kRankWords = 16384;
// a selection histogram: two digits' (fixed, floating) counts a bin
constexpr int kHist = 2;
constexpr size_t kStaticSmem = 8 * 1024;  // margin for the static arrays
constexpr unsigned kSign = 0x80000000u;

enum Route { kHash = 0, kPacked = 1, kLex = 2 };
enum Path { kSharedPath = 0, kGlobalPath = 1, kGridPath = 2 };
enum RedOp { kAdd, kOr, kXor };
// Where a step's time goes: the team's lead thread reads %globaltimer at
// each boundary and adds the time since the last one to the phase it
// leaves; time inside a grid barrier goes to kPhWait.
enum Phase {
  kPhCarry,     // the carry in and out
  kPhComplete,  // completion: drop configurations, free slots
  kPhRows,      // build a dedup's rows
  kPhGather,    // sort routes: write the selected rows in row order
  kPhSelect,    // sort routes: selection histograms, threshold, bucket lists
  kPhCount,     // sort routes: digit counts (the compaction's read, look-back)
  kPhWait,      // grid path: waiting at grid barriers
  kPhScatter,   // sort routes: ranking and scatter of a radix pass
  kPhExtract,   // sort routes: first-F extraction
  kPhInsert,    // hash route: table insert
  kPhRank,      // hash route: rank, output and digest
  kPhStep,      // the step's count and attestation
  kPhases
};
constexpr int kWork = 4;  // work[]: rows, pass rows, dedups, steps

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
  // (kWork + kPhases,) zeroed: rows deduped, rows the sorts' histograms
  // and passes read, dedups, steps walked, then each phase's nanoseconds
  // (summed over the keys)
  unsigned long long* work;
  int B, T, Wn, F, P, W, model, route, s_lo, sb_bits, H, attest;
};

__host__ __device__ constexpr size_t r16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// The 8-bit digits the sort routes count: packed, the four of the 32-bit
// key; lex, the invalid bit's one, then four a mask word and four for the
// state.
__host__ __device__ constexpr int n_digits(int route, int W) {
  return route == kPacked ? 4 : 4 * W + 5;
}

// Byte offsets of a key's working set: two frontiers (masks, states,
// valid, new), the dedup's rows (a key or a state each, and a valid byte),
// then the hash table (table, first, slots) or the sort's buffers (two
// bucket lists, a flag bit a row, two index orders and two key-word
// copies of F rows, and on the lex route the F selected rows' key words),
// and on the grid path (G blocks) the reduction slots,
// two rows of block totals and, on the sort routes, three rotating
// histograms (two digits' counts a bin), two rows of digit
// counts, the (G, kBins) look-back cells of the radix passes and the G of
// the scans, and two rotating rows of the row build's histograms. ts: the
// threads that share the key (a block, or the grid's).
struct Layout {
  size_t fm[2], fs[2], fv[2], fn[2];
  size_t rkey, rvalid, table, first, pos, la, lb, bits, ia, ib, ka, kb, kwd;
  size_t red, gtot, ghist, gdig, look, gscan, gfuse, bytes;
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
    L.la = o;
    o += r16(n * 4);
    L.lb = o;
    o += r16(n * 4);
    L.bits = o;
    o += r16((n + 31) / 32 * 4);
    L.ia = o;
    o += r16((size_t)F * 4);
    L.ib = o;
    o += r16((size_t)F * 4);
    L.ka = o;
    o += r16((size_t)F * 4);
    L.kb = o;
    o += r16((size_t)F * 4);
    L.kwd = o;
    o += r16(route == kLex ? (size_t)(W + 2) * F * 4 : 0);
  }
  if (G > 0) {
    L.red = o;
    o += r16(3 * 4 * 8);
    L.gtot = o;
    o += r16((size_t)2 * G * 4);
    if (route != kHash) {
      L.ghist = o;
      o += r16((size_t)3 * kHist * kBins * 4);
      L.gdig = o;
      o += r16((size_t)2 * n_digits(route, W) * kBins * 4);
      L.look = o;
      o += r16((size_t)G * kBins * 8);
      L.gscan = o;
      o += r16((size_t)2 * G * 8);
      L.gfuse = o;
      o += r16((size_t)2 * 2 * kBins * 4);
    }
  }
  L.bytes = o;
  return L;
}

// A block's sort scratch in dynamic shared memory (after the key's
// working set on the shared path): the (digit, warp) counts of a turn,
// the turn's rows staged in digit order (index, key word), each digit's
// next place in the order and its start, the selection's histograms, a
// bucket of up to kLocal rows with their key word, the digit counts of
// the selected rows, and the row build's histograms of each side.
__host__ __device__ constexpr size_t radix_smem(int route, int W) {
  return route == kHash
             ? 0
             : (size_t)(kBins * kWarps + 2 * kThreads + 2 * kBins +
                        kHist * kBins + 2 * kLocal +
                        n_digits(route, W) * kBins + 2 * kBins) * 4;
}

// rank_sort's keys alias the block's sort scratch up to its digit counts
static_assert(kRankWords <= kBins * kWarps + 2 * kThreads + 2 * kBins +
                                kHist * kBins + 2 * kLocal,
              "rank keys fit the sort scratch");

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

// The look-back cells: a relaxed store and load at device scope, so a
// spinning reader sees a cell once its writer has stored it.
__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
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

// A key's buffers, in each block's shared memory: its working set (in
// shared memory or its scratch) and the block's sort scratch.
struct Bufs {
  Frontier fr[2];
  int32_t* rkey;
  uint8_t* rvalid;
  int* table;
  int* first;
  int* pos;
  int* la;                    // bucket lists: row indices in row order
  int* lb;
  uint32_t* bits;             // a flag bit a row (or list entry)
  int* ia;                    // index orders of the selected rows
  int* ib;
  uint32_t* ka;               // their sort words
  uint32_t* kb;
  uint32_t* kwd;              // lex: (W + 2, F) the selected rows' key words
  unsigned long long* red;    // grid path: three reduction slots of 4
  int* gtot;                  // grid path: two rows of G block totals
  int* ghist;                 // grid path: three rotating (kHist, kBins)
                              // selection histograms
  int* gdig;                  // grid path: two rows of digit counts
  unsigned long long* look;   // grid path: (G, kBins) look-back cells
  unsigned long long* gscan;  // grid path: (2, G) look-back cells of scans
  int* wc;                    // block: (kBins, kWarps) counts of a turn
  int* stg_i;                 // block: a turn's rows in digit order
  uint32_t* stg_k;
  int* run;                   // block: (kBins) next place of each digit
  int* dstart;                // block: (kBins) a pass's digit starts
  int* hs;                    // block: (kHist, kBins) the selection's counts
  int* li;                    // block: (kLocal) a small bucket's rows
  uint32_t* lv;               // block: (kLocal) their key word S.kd
  int* tot;                   // block: (digits, kBins) counts of the selected
  int* hf;                    // block: (2, kBins) the row build's floating
                              // digits of word 1, valid rows then invalid
  int* gfuse;                 // grid path: two rotating rows of those
};

// The selection's state, in each block's shared memory (every block of a
// grid computes the same): the threshold's known bits (words [0, kd) and
// the bits >= lo of word kd), the rows still needed from the bucket, the
// bucket's rows and the list holding them (lst 0: every row, implicitly;
// 1 la, 2 lb, nl entries of which nb are in the bucket), whether the whole
// bucket is in, and, when the key ran out, the last row of the bucket in.
struct Sel {
  uint32_t thr[kKeyWords];
  int kd, lo, need, nb, nl, lst, full, cut;
  int dstar[2], below[2], cnt[2];  // each digit's bin holding the need-th row
  int kind;                        // the digit taken: 0 fixed, 1 floating
};

// A block's state of the walk, in its shared memory (registers are
// scarce at 1,024 threads): the launch, the key's buffers, the
// selection's state, the slots and occupancy, and the step's scalars.
// Thread 0 writes the step's scalars (and the lead its timers and sums)
// before a barrier; every block of a grid holds the same values.
struct Key {
  int F, P, W, N;
  int kw;                   // key words of the sort routes
  int packed;
  int sa;                   // stage A's slot, or -1 in stage B
  int cur;                  // the frontier a step reads: fr[cur]
  int ph;                   // lead thread: the phase being timed
  long long tlast;          // lead thread: the last boundary's time
  unsigned long long rows, pass_rows, dedups;  // thread 0: the launch's sums
  int e0, att, maxc, ovf;   // thread 0: the carry's scalars but e and count
};

__shared__ SortWalk sw;
__shared__ Bufs sb;
__shared__ Sel ssel;
__shared__ Key K;
__shared__ int sslot[3 * kMaxSlots];
__shared__ uint32_t soccw[kMaxWords];
__shared__ long long stns[kPhases];

__device__ __forceinline__ const Frontier& src_fr() { return sb.fr[K.cur]; }
__device__ __forceinline__ const Frontier& dst_fr() {
  return sb.fr[K.cur ^ 1];
}

// The uses so far of the grid path's rotating global rows (uniform over
// the team, in every thread's registers).
template <bool kG>
struct Ctx {
  int nred, nscan, nhist, ndig, npass, nlb, nfuse;
  Team<kG> team;
};

__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The lead thread's clock: the time since the last boundary goes to
// phase p.
__device__ __forceinline__ void tick(int p) {
  const long long t = gtime();
  stns[p] += t - K.tlast;
  K.tlast = t;
}

// A phase boundary: the lead thread adds the time since the last one to
// the phase it leaves.
template <bool kG>
__device__ __forceinline__ void phase(Ctx<kG>& c, int p) {
  if (c.team.lead()) {
    tick(K.ph);
    K.ph = p;
  }
}

// A barrier of the whole grid, its wait timed as kPhWait.
template <bool kG>
__device__ __forceinline__ void grid_sync(Ctx<kG>& c) {
  if (c.team.lead()) tick(K.ph);
  cg::this_grid().sync();
  if (c.team.lead()) tick(kPhWait);
}

// A barrier of the team: the grid's, or the block's.
template <bool kG>
__device__ __forceinline__ void team_sync(Ctx<kG>& c) {
  if constexpr (kG) {
    grid_sync(c);
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned long long op64(int op,
                                                   unsigned long long a,
                                                   unsigned long long b) {
  return op == kAdd ? a + b : op == kOr ? (a | b) : (a ^ b);
}

// The team's reductions of v[0..kN), v[j] by op[j], returned to every
// thread in v; a barrier of the team (its writes before it are visible to
// every thread after it). Every thread calls it the same number of times:
// on the grid path the k-th call combines into slot k % 3 and clears slot
// (k + 1) % 3, which every thread read two calls ago, before the barrier
// of the call after it.
template <bool kG, int kN>
__device__ void reduce_n(Ctx<kG>& c, unsigned long long (&v)[kN],
                         const int (&op)[kN]) {
  static_assert(kN <= 4, "four values a reduction");
  __shared__ unsigned long long part[kWarps][4];
  __shared__ unsigned long long all[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < kN; ++j) {
    for (int d = 16; d > 0; d >>= 1) {
      v[j] = op64(op[j], v[j], __shfl_xor_sync(kFull, v[j], d));
    }
    if (lane == 0) part[warp][j] = v[j];
  }
  __syncthreads();
  if (warp == 0) {
    for (int j = 0; j < kN; ++j) {
      unsigned long long x = part[lane][j];
      for (int d = 16; d > 0; d >>= 1) {
        x = op64(op[j], x, __shfl_xor_sync(kFull, x, d));
      }
      if (lane == 0) all[j] = x;
    }
  }
  __syncthreads();
  if constexpr (!kG) {
    for (int j = 0; j < kN; ++j) v[j] = all[j];
    __syncthreads();
  } else {
    unsigned long long* cur = sb.red + (c.nred % 3) * 4;
    unsigned long long* nxt = sb.red + ((c.nred + 1) % 3) * 4;
    ++c.nred;
    if (threadIdx.x == 0) {
      for (int j = 0; j < kN; ++j) {
        if (op[j] == kAdd) {
          atomicAdd(&cur[j], all[j]);
        } else if (op[j] == kOr) {
          atomicOr(&cur[j], all[j]);
        } else {
          atomicXor(&cur[j], all[j]);
        }
        if (blockIdx.x == 0) atomicExch(&nxt[j], 0ull);
      }
    }
    grid_sync(c);
    for (int j = 0; j < kN; ++j) {
      v[j] = reinterpret_cast<volatile unsigned long long*>(cur)[j];
    }
  }
}

template <int kOp, bool kG>
__device__ unsigned long long reduce(Ctx<kG>& c, unsigned long long v) {
  unsigned long long a[1] = {v};
  const int op[1] = {kOp};
  reduce_n(c, a, op);
  return a[0];
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
    int* g = sb.gtot + (c.nscan++ & 1) * (int)gridDim.x;
    if (threadIdx.x == 0) __stcg(&g[blockIdx.x], bt);
    grid_sync(c);
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

// Exclusive prefix sum of v over the team in rank order, with no team
// barrier: on the grid path each block publishes its total in its cell of
// b->gscan, tagged with the scan (a tag of c.npass's sequence), and sums
// its predecessors' as they come; *total gets the team's sum on a block
// path, and on the grid path scan_total() gives it after the next team
// barrier. The cells alternate between two rows: a row is written again
// two scans later, after the barrier that follows the scan between.
template <bool kG>
__device__ int scan_lb(Ctx<kG>& c, int v, int* total) {
  int bt;
  const int r = block_exclusive_scan<kThreads>(v, &bt);
  *total = bt;
  if constexpr (!kG) {
    return r;
  } else {
    __shared__ int pre_s;
    const unsigned long long tag = (unsigned long long)(++c.npass) << 32;
    const int blk = (int)blockIdx.x;
    unsigned long long* cells = sb.gscan + (c.nlb++ & 1) * gridDim.x;
    if (threadIdx.x == 0) st_relaxed(cells + blk, tag | (unsigned)bt);
    if (threadIdx.x < 32) {
      int p = 0;
      for (int q = threadIdx.x; q < blk; q += 32) {
        unsigned long long x;
        do {
          x = ld_relaxed(cells + q);
        } while ((x & ~0xffffffffull) != tag);
        p += (int)(uint32_t)x;
      }
      for (int d = 16; d > 0; d >>= 1) p += __shfl_xor_sync(kFull, p, d);
      if (threadIdx.x == 0) pre_s = p;
    }
    __syncthreads();
    const int out = r + pre_s;
    __syncthreads();
    return out;
  }
}

// The grid's total of its last scan_lb, after a team barrier.
template <bool kG>
__device__ int scan_total(Ctx<kG>& c) {
  __shared__ int tot_s;
  const unsigned long long* cells =
      sb.gscan + ((c.nlb - 1) & 1) * gridDim.x;
  if (threadIdx.x < 32) {
    int sum = 0;
    for (int q = threadIdx.x; q < (int)gridDim.x; q += 32) {
      sum += (int)(uint32_t)ld_relaxed(cells + q);
    }
    for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
    if (threadIdx.x == 0) tot_s = sum;
  }
  __syncthreads();
  const int out = tot_s;
  __syncthreads();
  return out;
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

// Mask word k of row i of a dedup over frontier fr: the source
// configuration's word, with the candidate's slot bit set.
template <bool kG>
__device__ __forceinline__ uint32_t row_word(const Frontier& fr, int W, int F,
                                             int P, int sa, int i, int k) {
  int f, p;
  row_src(i, F, P, sa, &f, &p);
  uint32_t m = (uint32_t)ld<kG>(fr.m + (size_t)f * W + k);
  if (p >= 0 && (p >> 5) == k) m |= 1u << (p & 31);
  return m;
}

// The same, in the current dedup.
template <bool kG>
__device__ __forceinline__ uint32_t row_word(const Ctx<kG>& c, int i, int k) {
  return row_word<kG>(src_fr(), K.W, K.F, K.P, K.sa, i, k);
}

__device__ __forceinline__ uint32_t below(int lo) {
  return lo >= 32 ? 0xffffffffu : (1u << lo) - 1u;
}

// A level's two digits of a bucket row's word v below bit lo (lo2 =
// max(0, lo - 8)): the fixed one, bits [lo2, lo); and the floating one of
// w = v's bits below lo: w itself under 8, else its top set bit h and the
// 3 bits below it, (h - 2) * 8 + mantissa. Both keep the order and fix a
// prefix of the word: the fixed one down to lo2, the floating one down to
// h - 3 (all of w under 8). The floating digit splits the skewed words a
// bucket of small values holds (few high bits set) where a fixed window
// leaves them in one bin.
__device__ __forceinline__ unsigned fixed_digit(uint32_t v, int lo, int lo2) {
  return (v >> lo2) & ((1u << (lo - lo2)) - 1u);
}
__device__ __forceinline__ unsigned float_digit(uint32_t v, int lo) {
  const uint32_t w = v & below(lo);
  if (w < 8) return w;
  const int h = 31 - __clz(w);
  return (unsigned)((h - 2) * 8) + ((w >> (h - 3)) & 7u);
}
// the bits of the word below lo that the digit fixes, and its new lo
__device__ __forceinline__ void digit_prefix(int kind, unsigned d, int lo2,
                                             uint32_t* bits, int* lo) {
  if (kind == 0) {
    *bits = d << lo2;
    *lo = lo2;
  } else if (d < 8) {
    *bits = d;
    *lo = 0;
  } else {
    const int h = (int)(d / 8) + 2;
    *bits = (1u << h) | ((d & 7u) << (h - 3));
    *lo = h - 3;
  }
}

// Build the dedup's rows from src: a key (hash, packed) or a state and a
// valid byte (lex) each. Returns, to every thread, the valid rows among
// the frontier's (low word) and among the candidates (high word); *dv and
// *di get, over the valid and the invalid rows, the OR of key word 1 (high
// word) and of its complement (low word), and b->hf (on the grid path the
// team's, in b->gfuse's row c.nfuse - 1 after the barrier) each side's
// histogram of word 1's floating digit: the selection's first level
// whenever the side's shared high bits are zero. The hash route's rows
// go to K2's strided layout (thread r's keys [r * per, r * per + per) at
// [r * stride, r * stride + per), stride odd), each thread building its
// own, which its insert reads back.
template <bool kG>
__device__ __noinline__ unsigned long long build_rows(
    Ctx<kG>& c, unsigned long long* dv, unsigned long long* di) {
  // the sizes in registers: the row stores may alias shared memory
  const SortWalk& w = sw;
  const int F = K.F, P = K.P, W = K.W, N = K.N, sa = K.sa;
  const int model = w.model, s_lo = w.s_lo;
  int32_t* rkey = sb.rkey;
  uint8_t* rvalid = sb.rvalid;
  const Frontier src = src_fr();
  const int ts = c.team.size(), r0 = c.team.rank();
  const bool hash = w.route == kHash, packed = w.route == kPacked;
  const int per = (N + ts - 1) / ts;
  const int stride = per | 1;
  const int lo = hash ? min(N, r0 * per) : r0;
  const int hi = hash ? min(N, lo + per) : N;
  const int step = hash ? 1 : ts;
  phase(c, kPhRows);
  if (!hash) {
    for (int j = threadIdx.x; j < 2 * kBins; j += kThreads) sb.hf[j] = 0;
    if (kG && blockIdx.x == 0) {
      // the other row, read by the last dedup's selection before barriers
      int* gn = sb.gfuse + ((c.nfuse + 1) & 1) * 2 * kBins;
      for (int j = threadIdx.x; j < 2 * kBins; j += kThreads) {
        __stcg(&gn[j], 0);
      }
    }
    __syncthreads();
  }
  unsigned vo = 0, vc = 0;
  uint32_t orv = 0, andv = ~0u, ori = 0, andi = ~0u;
  for (int i = lo; i < hi; i += step) {
    int f, p;
    row_src(i, F, P, sa, &f, &p);
    int s = ld<kG>(src.s + f);
    bool val = ld<kG>(src.v + f) != 0;
    if (p >= 0) {
      int ns;
      const bool legal = jt_models::step(model, s, sslot[p],
                                         sslot[P + p], sslot[2 * P + p],
                                         &ns);
      const bool had =
          ((uint32_t)ld<kG>(src.m + (size_t)f * W + (p >> 5)) >> (p & 31)) &
          1u;
      if (sa >= 0) {
        val = val && legal && !had;
      } else {
        val = val && ld<kG>(src.n + f) && legal && !had &&
              ((soccw[p >> 5] >> (p & 31)) & 1u);
      }
      s = ns;
      vc += val ? 1u : 0u;
    } else {
      vo += val ? 1u : 0u;
    }
    const uint32_t m0 = row_word<kG>(src, W, F, P, sa, i, 0);
    uint32_t u1 = m0;
    if (!hash && !packed) {
      st<kG>(rkey + i, (int32_t)s);
      st<kG>(rvalid + i, (uint8_t)(val ? 1 : 0));
    } else {
      const uint32_t k = (((uint32_t)s - (uint32_t)s_lo) << P) | m0;
      if (hash) {
        rkey[r0 * stride + (i - lo)] = val ? (int)k : kEmpty;
      } else {
        st<kG>(rkey + i, (int32_t)(k | (val ? 0u : kSign)));
      }
      u1 = k & ~kSign;
    }
    if (hash) continue;
    atomicAdd(&sb.hf[(val ? 0 : kBins) + float_digit(u1, 32)], 1);
    if (val) {
      orv |= u1;
      andv &= u1;
    } else {
      ori |= u1;
      andi &= u1;
    }
  }
  if (hash) return reduce<kAdd>(c, (unsigned long long)vc << 32 | vo);
  __syncthreads();
  if constexpr (kG) {
    int* g = sb.gfuse + (c.nfuse & 1) * 2 * kBins;
    for (int j = threadIdx.x; j < 2 * kBins; j += kThreads) {
      if (sb.hf[j]) atomicAdd(&g[j], sb.hf[j]);
    }
  }
  ++c.nfuse;   // the row the selection reads: c.nfuse - 1
  unsigned long long r[3] = {(unsigned long long)vc << 32 | vo,
                             (unsigned long long)orv << 32 | ~andv,
                             (unsigned long long)ori << 32 | ~andi};
  const int ops[3] = {kAdd, kOr, kOr};
  reduce_n(c, r, ops);
  *dv = r[1];
  *di = r[2];
  return r[0];
}

// The hash dedup of the built rows into dst (K2's contract). Returns the
// overflow flag; *mism gets the attestation's digest mismatch. The table
// is claimed by atomics and read back volatile, and a thread's keys and
// slots are its own, so only the output goes through ld/st.
template <bool kG>
__device__ __noinline__ bool dedup_hash(Ctx<kG>& c, int* mism) {
  const SortWalk& w = sw;
  const int F = K.F, P = K.P, N = K.N, H = w.H;
  int* rkey = sb.rkey;
  int* table = sb.table;
  int* first = sb.first;
  int* pos = sb.pos;
  const Frontier& dst = dst_fr();
  const int ts = c.team.size(), r0 = c.team.rank();
  phase(c, kPhInsert);
  for (int i = r0; i < H; i += ts) {
    st<kG>(table + i, kEmpty);
    st<kG>(first + i, INT_MAX);
  }
  team_sync(c);
  const int per = (N + ts - 1) / ts;
  const int stride = per | 1;
  const int base = r0 * per;
  const int mine = max(0, min(per, N - base));
  const int* my_key = rkey + (size_t)r0 * stride;
  int* my_pos = pos + (size_t)r0 * stride;
  insert_run(my_key, my_pos, mine, base, table, first, (unsigned)(H - 1));
  team_sync(c);
  phase(c, kPhRank);
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
      st<kG>(dst.m + r, (int32_t)(safe & pmask));
      st<kG>(dst.s + r, (int32_t)jt_models::wrap_add(safe >> P, w.s_lo));
      st<kG>(dst.v + r, (uint8_t)(ok ? 1 : 0));
      st<kG>(dst.n + r, (uint8_t)(ok && base + j >= F ? 1 : 0));
      xo ^= (unsigned)safe;
    }
    ++r;
  }
  for (int q = distinct + r0; q < F; q += ts) {
    st<kG>(dst.m + q, (int32_t)0);
    st<kG>(dst.s + q, (int32_t)w.s_lo);
    st<kG>(dst.v + q, (uint8_t)0);
    st<kG>(dst.n + q, (uint8_t)0);
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
// packed (invalid, the key's other 31 bits); lex (invalid, mask words,
// state ^ sign).
template <bool kG>
__device__ __forceinline__ uint32_t key_word(const Ctx<kG>& c, int i, int k) {
  if (K.packed) {
    const uint32_t key = (uint32_t)ld<kG>(sb.rkey + i);
    return k == 0 ? key >> 31 : key & ~kSign;
  }
  if (k == 0) return ld<kG>(sb.rvalid + i) ? 0u : 1u;
  if (k <= K.W) return row_word(c, i, k - 1);
  return (uint32_t)ld<kG>(sb.rkey + i) ^ kSign;
}

// Word k of row i as the sort passes order it: packed, the whole key (one
// word); lex, key word k.
template <bool kG>
__device__ __forceinline__ uint32_t sort_word(const Ctx<kG>& c, int i,
                                              int k) {
  return K.packed ? (uint32_t)ld<kG>(sb.rkey + i) : key_word(c, i, k);
}

// Sort word k's digits: the first one's row in Bufs::tot, and how many.
__device__ __forceinline__ int digit0(bool packed, int k) {
  return packed ? 0 : (k == 0 ? 0 : 1 + 4 * (k - 1));
}
__device__ __forceinline__ int digits_of(bool packed, int k) {
  return packed ? 4 : (k == 0 ? 1 : 4);
}

// Row i's key against the threshold's known bits: -1 below, 0 in the
// bucket, 1 above; *vkd, when given, gets the row's word S.kd (for a row
// in the bucket). Each word is read once.
template <bool kG>
__device__ __forceinline__ int prefix_cmp(const Ctx<kG>& c, const Sel& S,
                                          int i, uint32_t* vkd = nullptr) {
  const int kd = min(S.kd, K.kw);
  if (K.packed) {
    const uint32_t key = (uint32_t)ld<kG>(sb.rkey + i);
    const uint32_t u0 = key >> 31, u1 = key & ~kSign;
    if (vkd) *vkd = u1;
    if (u0 != S.thr[0]) return u0 < S.thr[0] ? -1 : 1;
    const int sh = kd >= 2 ? 0 : S.lo;
    if (sh < 32 && (u1 >> sh) != (S.thr[1] >> sh)) {
      return (u1 >> sh) < (S.thr[1] >> sh) ? -1 : 1;
    }
    return 0;
  }
  for (int k = 0; k < kd; ++k) {
    const uint32_t a = key_word(c, i, k), t = S.thr[k];
    if (a != t) return a < t ? -1 : 1;
  }
  if (kd < K.kw) {
    const uint32_t a = key_word(c, i, kd);
    if (vkd) *vkd = a;
    if (S.lo < 32 && (a >> S.lo) != (S.thr[kd] >> S.lo)) {
      return (a >> S.lo) < (S.thr[kd] >> S.lo) ? -1 : 1;
    }
  }
  return 0;
}

// A row's contribution to the block's histograms b->hs (each digit's
// count); every lane of the warp calls it, `in` false for a lane with no
// row.
__device__ __forceinline__ void hist_add(bool in, uint32_t v, int lo,
                                         int lo2) {
  const int lane = threadIdx.x & 31;
  for (int kind = 0; kind < 2; ++kind) {
    const unsigned d = !in ? (unsigned)kBins
                       : kind == 0 ? fixed_digit(v, lo, lo2)
                                   : float_digit(v, lo);
    const unsigned peers = __match_any_sync(kFull, d);
    if (in && lane == __ffs(peers) - 1) {
      atomicAdd(&sb.hs[kind * kBins + d], __popc(peers));
    }
  }
}

__device__ __forceinline__ void hist_clear() {
  for (int i = threadIdx.x; i < kHist * kBins; i += kThreads) sb.hs[i] = 0;
}

// Into b->hs: the team's histograms of the bucket's next digits (below the
// threshold's known bits of word S.kd), over every row or the list.
// Returns the rows (or list entries) read.
template <bool kG>
__device__ int bucket_hist(Ctx<kG>& c, int lo2) {
  const Sel& S = ssel;
  int* hs = sb.hs;
  const int t = threadIdx.x, lane = t & 31;
  const int lo = S.lo;
  hist_clear();
  __syncthreads();
  const int n = S.lst == 0 ? K.N : S.nl;
  const int* lst = S.lst == 1 ? sb.la : sb.lb;
  const bool listed = S.lst != 0;
  for (int b = c.team.rank() - lane; b < n; b += c.team.size()) {
    const int q = b + lane;
    const bool in = q < n;
    const int row = in ? (listed ? ld<kG>(lst + q) : q) : 0;
    uint32_t v = 0;
    const bool mem = in && prefix_cmp(c, S, row, &v) == 0;
    hist_add(mem, v, lo, lo2);
  }
  __syncthreads();
  if constexpr (kG) {
    // the blocks' histograms through one of three global rows: the row
    // reset here was read two histograms ago, before the last one's
    // barrier, and is next added to after this one's
    int* g = sb.ghist + (c.nhist % 3) * kHist * kBins;
    int* gn = sb.ghist + ((c.nhist + 1) % 3) * kHist * kBins;
    ++c.nhist;
    for (int i = t; i < kHist * kBins; i += kThreads) {
      if (hs[i]) atomicAdd(&g[i], hs[i]);
      if (blockIdx.x == 0) __stcg(&gn[i], 0);
    }
    grid_sync(c);
    for (int i = t; i < kHist * kBins; i += kThreads) hs[i] = __ldcg(&g[i]);
    __syncthreads();
  }
  return n;
}

// The threshold takes the bits a bucket's rows share below bit lo of word
// S.kd (their OR o and AND a): S.lo moves down past them, to 0 when they
// share every bit.
__device__ __forceinline__ void take_shared_bits(Sel& S, int lo, uint32_t o,
                                                 uint32_t a) {
  const uint32_t diff = (o ^ a) & below(lo);
  if (diff == 0) {
    S.thr[S.kd] |= o & below(lo);
    S.lo = 0;
  } else {
    const int top = 31 - __clz(diff);
    S.thr[S.kd] |= o & below(lo) & ~((2u << top) - 1u);
    S.lo = top + 1;
  }
}

// Each digit's bin in b->hs holding the bucket's need-th row; the level
// takes the digit whose bin holds fewer rows (the fixed one on a tie): the
// rows below the bin are in, and the threshold takes the bin's prefix.
template <bool kG>
__device__ void pick_digit(Ctx<kG>& c, int lo2, bool float_only = false) {
  Sel& S = ssel;
  const int t = threadIdx.x;
  // both digits' counts in one scan: the floating digit's rows start
  // after the fixed digit's nb
  const int x = float_only ? (t >= kBins && t < 2 * kBins ? sb.hs[t] : 0)
                           : (t < kHist * kBins ? sb.hs[t] : 0);
  int total;
  const int ex = block_exclusive_scan<kThreads>(x, &total) -
                 (t >= kBins && !float_only ? S.nb : 0);
  if (t < kHist * kBins && ex < S.need && S.need <= ex + x) {
    const int kind = t / kBins;
    S.dstar[kind] = t % kBins;
    S.below[kind] = ex;
    S.cnt[kind] = x;
  }
  __syncthreads();
  if (t == 0) {
    const int kind = float_only || S.cnt[1] < S.cnt[0] ? 1 : 0;
    uint32_t bits;
    digit_prefix(kind, (unsigned)S.dstar[kind], lo2, &bits, &S.lo);
    S.kind = kind;
    S.need -= S.below[kind];
    S.thr[S.kd] |= bits;
    S.full = S.cnt[kind] == S.need;
    S.nb = S.cnt[kind];
  }
  __syncthreads();
}

// The warp segments of n places: warp g of the team owns [g * seg,
// g * seg + seg), seg a multiple of 32, so a scan over the team's ranks
// keeps the places' order.
template <bool kG>
__device__ __forceinline__ void segment(const Ctx<kG>& c, int n, int* lo,
                                        int* hi) {
  const int nw = c.team.size() >> 5;
  const int seg = ((n + nw - 1) / nw + 31) & ~31;
  *lo = min(n, (c.team.rank() >> 5) * seg);
  *hi = min(n, *lo + seg);
}

// Compact the bucket's rows, in row order, from the current list (every
// row, or a list) into the other list.
template <bool kG>
__device__ void compact_bucket(Ctx<kG>& c) {
  Sel& S = ssel;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int n = S.lst == 0 ? K.N : S.nl;
  const bool listed = S.lst != 0;
  const int* src = S.lst == 1 ? sb.la : sb.lb;
  int* dst = S.lst == 1 ? sb.lb : sb.la;
  uint32_t* bits = sb.bits;
  int lo, hi;
  segment(c, n, &lo, &hi);
  int cnt = 0;
  for (int b = lo; b < hi; b += 32) {
    const int q = b + lane;
    const bool in = q < hi;
    const int row = in ? (listed ? ld<kG>(src + q) : q) : 0;
    const unsigned m =
        __ballot_sync(kFull, in && prefix_cmp(c, S, row) == 0);
    if (lane == 0) st<kG>(bits + (b >> 5), m);
    cnt += __popc(m);
  }
  int total;
  int start = scan_lb(c, lane == 0 ? cnt : 0, &total);
  start = __shfl_sync(kFull, start, 0);
  for (int b = lo; b < hi; b += 32) {
    const unsigned m = ld<kG>(bits + (b >> 5));
    const int q = b + lane;
    if ((m >> lane) & 1u) {
      st<kG>(dst + start + __popc(m & lt), listed ? ld<kG>(src + q) : q);
    }
    start += __popc(m);
  }
  team_sync(c);
  if constexpr (kG) total = scan_total(c);
  if (threadIdx.x == 0) {
    S.lst = S.lst == 1 ? 2 : 1;
    S.nl = S.nb = total;
  }
  __syncthreads();
}

// Exclusive prefix sum of v over the block in thread order, *total its
// sum, and the block's OR and AND of *o and *a (into both), with two
// barriers.
__device__ int scan_or_and(int v, int* total, uint32_t* o, uint32_t* a) {
  __shared__ int ws[kWarps];
  __shared__ uint32_t wo[kWarps], wa[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  uint32_t vo = *o, va = *a;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  vo = __reduce_or_sync(kFull, vo);
  va = __reduce_and_sync(kFull, va);
  if (lane == 31) ws[warp] = incl;
  if (lane == 0) {
    wo[warp] = vo;
    wa[warp] = va;
  }
  __syncthreads();
  int before = 0, sum = 0;
  uint32_t ao = 0, aa = 0xffffffffu;
  for (int w = 0; w < kWarps; ++w) {
    const int x = ws[w];
    before += w < warp ? x : 0;
    sum += x;
    ao |= wo[w];
    aa &= wa[w];
  }
  *total = sum;
  *o = ao;
  *a = aa;
  __syncthreads();
  return before + incl - v;
}

// The selection's end game, by each block alone in its shared memory: the
// bucket is the list's nl <= kLocal rows, copied to b->li with their word
// S.kd in b->lv; each level histograms b->lv and compacts the bucket in
// place (a thread owns kLocal / kThreads places, so a block scan keeps the
// row order). Returns the entries its histograms read.
template <bool kG>
__device__ __noinline__ unsigned long long local_refine(Ctx<kG>& c) {
  constexpr int kPer = kLocal / kThreads;
  Sel& S = ssel;
  int* li = sb.li;
  uint32_t* lv = sb.lv;
  const int t = threadIdx.x, lane = t & 31;
  const int* lst = S.lst == 1 ? sb.la : sb.lb;
  for (int q = t; q < S.nl; q += kThreads) li[q] = ld<kG>(lst + q);
  unsigned long long rows = 0;
  int loaded = -1;   // the word lv holds
  __syncthreads();
  while (true) {
    if (t == 0 && S.lo == 0) {
      ++S.kd;
      S.lo = 32;
    }
    __syncthreads();
    if (S.kd >= K.kw) break;  // the key ran out
    const int n = S.nl;
    if (loaded != S.kd) {
      // the bucket's next word: the bits its rows share are known at once
      uint32_t o = 0, a = 0xffffffffu;
      for (int q = t; q < n; q += kThreads) {
        const uint32_t v = key_word(c, li[q], S.kd);
        lv[q] = v;
        o |= v;
        a &= v;
      }
      o = jt_hash::block_all_reduce<kThreads>(o, jt_hash::Or());
      a = jt_hash::block_all_reduce<kThreads>(a, jt_hash::And());
      if (t == 0) take_shared_bits(S, S.lo, o, a);
      loaded = S.kd;
      __syncthreads();
      continue;
    }
    const int lo = S.lo, lo2 = max(0, lo - kDigitBits);
    hist_clear();
    __syncthreads();
    for (int b = t - lane; b < n; b += kThreads) {
      const int q = b + lane;
      hist_add(q < n, q < n ? lv[q] : 0u, lo, lo2);
    }
    __syncthreads();
    rows += (unsigned long long)n;
    pick_digit(c, lo2);
    if (S.full) return rows;
    // keep the digit's rows, in order
    const int kind = S.kind;
    const unsigned ds = (unsigned)S.dstar[kind];
    int ki[kPer];
    uint32_t kv[kPer];
    int cnt = 0;
    uint32_t o = 0, a = 0xffffffffu;
    for (int j = 0; j < kPer; ++j) {
      const int q = t * kPer + j;
      if (q < n && (kind == 0 ? fixed_digit(lv[q], lo, lo2)
                              : float_digit(lv[q], lo)) == ds) {
        ki[cnt] = li[q];
        kv[cnt] = lv[q];
        o |= kv[cnt];
        a &= kv[cnt];
        ++cnt;
      }
    }
    // the kept rows' places, and the bits they share below the digit's
    // prefix, in one block scan
    int total;
    const int at0 = scan_or_and(cnt, &total, &o, &a);
    for (int j = 0; j < cnt; ++j) {
      li[at0 + j] = ki[j];
      lv[at0 + j] = kv[j];
    }
    if (t == 0) {
      S.nl = total;
      take_shared_bits(S, S.lo, o, a);
    }
    __syncthreads();
  }
  // every row left has the same key: the first `need` in row order are in
  if (t == 0) S.cut = li[S.need - 1];
  __syncthreads();
  return rows;
}

// Step 1 of the sort routes' dedup: the threshold below which the first
// F positions of the stable order lie (`Sel`), from V (the valid rows) and
// the build's ORs of word 1 over the valid (dv) and invalid (di) rows.
// N > F. The team refines the bucket over every row or a list until it
// holds at most kLocal rows; each block then finishes alone
// (`local_refine`). Returns the rows its histograms read.
template <bool kG>
__device__ __noinline__ unsigned long long select_first(
    Ctx<kG>& c, int V, unsigned long long dv, unsigned long long di) {
  Sel& S = ssel;
  const int N = K.N, F = K.F, t = threadIdx.x;
  if (t == 0) {
    // the side of position F - 1, and the bits of word 1 its rows share
    const int side = V >= F ? 0 : 1;
    for (int k = 0; k < kKeyWords; ++k) S.thr[k] = 0;
    S.thr[0] = (uint32_t)side;
    S.need = side ? F - V : F;
    S.nb = S.nl = side ? N - V : V;
    S.lst = 0;
    S.full = S.nb == S.need;
    S.cut = INT_MAX;
    S.kd = 1;
    const unsigned long long d = side ? di : dv;
    take_shared_bits(S, 32, (uint32_t)(d >> 32), ~(uint32_t)d);
  }
  __syncthreads();
  unsigned long long rows = 0;
  if (!S.full && S.kd == 1 && S.lo > 0 && S.thr[1] == 0) {
    // the side shares only zeros above its differing bits, so the row
    // build's histogram of its floating digit is this level's
    const int side = (int)S.thr[0];
    const int* h = kG ? sb.gfuse + ((c.nfuse - 1) & 1) * 2 * kBins : sb.hf;
    for (int j = t; j < kBins; j += kThreads) {
      const int* x = &h[side * kBins + j];
      sb.hs[kBins + j] = kG ? __ldcg(x) : *x;
    }
    __syncthreads();
    rows += (unsigned long long)N;
    pick_digit(c, 0, true);
    if (!S.full && S.nb < S.nl) compact_bucket(c);
  }
  while (!S.full) {
    if (t == 0 && S.lo == 0) {
      ++S.kd;
      S.lo = 32;
    }
    __syncthreads();
    if (S.kd >= K.kw) break;  // the key ran out
    if (S.lst != 0 && S.nl <= kLocal) return rows + local_refine(c);
    const int lo2 = max(0, S.lo - kDigitBits);
    rows += (unsigned long long)bucket_hist(c, lo2);
    pick_digit(c, lo2);
    if (S.full) break;
    if (S.nb < S.nl) compact_bucket(c);
  }
  if (!S.full) {
    // every row of the bucket has the same key: the first `need` in row
    // order are in, up to row S.cut
    if (S.lst == 0) compact_bucket(c);
    if (t == 0) S.cut = ld<kG>((S.lst == 1 ? sb.la : sb.lb) + S.need - 1);
    __syncthreads();
  }
  return rows;
}

// One stable pass of the LSD radix sort of the n selected rows on the
// 8-bit digit at bit sh of sort word `word`: (order, word) si, sk -> di,
// dk, sk null to read the word off the rows (a lex word's first pass).
// Block b owns the tile [b * tile, b * tile + tile) of the order and takes
// it 1,024 rows a turn; b->dstart holds each digit's start in the order.
template <bool kG>
__device__ __noinline__ void radix_pass(Ctx<kG>& c, int n, const int* si,
                                        int* di,
                           const uint32_t* sk, uint32_t* dk, int word,
                           int sh) {
  const Bufs& B = sb;
  int* wc = B.wc;
  int* run = B.run;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int G = kG ? (int)gridDim.x : 1, blk = kG ? (int)blockIdx.x : 0;
  const int tile = (n + G - 1) / G;
  const int lo = min(n, blk * tile), hi = min(n, lo + tile);
  int x0 = 0;
  uint32_t v0 = 0;
  if constexpr (kG) {
    // this block's rows of each digit, published for the blocks after it
    phase(c, kPhCount);
    if (t < kBins) run[t] = 0;
    __syncthreads();
    for (int b = lo; b < hi; b += kThreads) {
      const int i = b + t;
      const bool in = i < hi;
      int x = 0;
      uint32_t v = 0;
      if (in) {
        x = ld<kG>(si + i);
        v = sk ? ld<kG>(sk + i) : sort_word(c, x, word);
      }
      if (b == lo) {
        x0 = x;
        v0 = v;
      }
      const unsigned d = in ? (v >> sh) & (kBins - 1) : (unsigned)kBins;
      const unsigned peers = __match_any_sync(kFull, d);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&run[d], __popc(peers));
    }
    __syncthreads();
    const unsigned long long tag = (unsigned long long)(++c.npass) << 32;
    if (t < kBins) {
      st_relaxed(B.look + (size_t)blk * kBins + t, tag | (unsigned)run[t]);
    }
    // the rows of each digit in the blocks before this one: four threads
    // a digit, kLook cells a round trip each
    const int d = t >> 2, j = t & 3;
    int s = 0;
    for (int q0 = j; q0 < blk; q0 += 4 * kLook) {
      unsigned long long cell[kLook];
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        const int q = q0 + 4 * u;
        cell[u] = q < blk ? ld_relaxed(B.look + (size_t)q * kBins + d) : tag;
      }
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        const int q = q0 + 4 * u;
        while ((cell[u] & ~0xffffffffull) != tag) {
          cell[u] = ld_relaxed(B.look + (size_t)q * kBins + d);
        }
        s += (int)(uint32_t)cell[u];
      }
    }
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    __syncthreads();
    if (j == 0) run[d] = B.dstart[d] + s;
  } else {
    if (t < kBins) run[t] = B.dstart[t];
  }
  __syncthreads();
  phase(c, kPhScatter);
  for (int b = lo; b < hi; b += kThreads) {
    const int i = b + t;
    const bool in = i < hi;
    int x = 0;
    uint32_t v = 0;
    if (kG && b == lo) {
      x = x0;
      v = v0;
    } else if (in) {
      x = ld<kG>(si + i);
      v = sk ? ld<kG>(sk + i) : sort_word(c, x, word);
    }
    const unsigned d = in ? (v >> sh) & (kBins - 1) : (unsigned)kBins;
    const unsigned peers = __match_any_sync(kFull, d);
    for (int q = t; q < kBins * kWarps; q += kThreads) wc[q] = 0;
    __syncthreads();
    if (in && lane == __ffs(peers) - 1) wc[d * kWarps + warp] = __popc(peers);
    __syncthreads();
    // the turn's (digit, warp) pairs ranked by one exclusive scan in
    // digit-major order: thread t owns the pairs [t * kOwn, t * kOwn + kOwn)
    int* mine = wc + t * kOwn;
    int s = 0;
    for (int q = 0; q < kOwn; ++q) s += mine[q];
    int total;
    int ex = block_exclusive_scan<kThreads>(s, &total);
    for (int q = 0; q < kOwn; ++q) {
      const int y = mine[q];
      mine[q] = ex;
      ex += y;
    }
    __syncthreads();
    if (in) {
      const int p = wc[d * kWarps + warp] + __popc(peers & lt);
      B.stg_i[p] = x;
      B.stg_k[p] = v;
    }
    __syncthreads();
    // the turn in digit order: each digit's rows go out as one run
    const int cn = min(kThreads, hi - b);
    if (t < cn) {
      const uint32_t vv = B.stg_k[t];
      const int dd = (int)((vv >> sh) & (kBins - 1));
      const int to = run[dd] + t - wc[dd * kWarps];
      st<kG>(di + to, B.stg_i[t]);
      st<kG>(dk + to, vv);
    }
    __syncthreads();
    if (t < kBins) {
      run[t] += (t + 1 < kBins ? wc[(t + 1) * kWarps] : cn) - wc[t * kWarps];
    }
    __syncthreads();
  }
  team_sync(c);
}

// Step 2 of the sort routes' dedup: one read of every row flags the
// selected ones (every row when all) into b->bits in row order, counts
// every digit of their sort words into b->tot (the team's, on every
// block; not when they are to be ranked) and folds the overflow into *ov;
// a scan writes their indices (and packed keys, or lex key words when
// ranked) in row order to b->ia (b->ka, b->kwd). Returns their count.
template <bool kG>
__device__ __noinline__ int compact_selected(Ctx<kG>& c, int V, bool all,
                                             bool rank, bool* ov) {
  const Sel& S = ssel;
  const int F = K.F;
  const bool packed = K.packed;
  const int nsw = packed ? 1 : K.W + 2;   // sort words
  const int nd = n_digits(sw.route, K.W);
  const int t = threadIdx.x, lane = t & 31;
  const unsigned lt = (1u << lane) - 1u;
  int* tot = sb.tot;
  for (int j = t; j < nd * kBins; j += kThreads) tot[j] = 0;
  int* gd = kG ? sb.gdig + (c.ndig & 1) * nd * kBins : nullptr;
  if (kG && blockIdx.x == 0) {
    // the other row, which the last dedup read before its barriers
    int* gn = sb.gdig + ((c.ndig + 1) & 1) * nd * kBins;
    for (int j = t; j < nd * kBins; j += kThreads) __stcg(&gn[j], 0);
  }
  __syncthreads();
  int lo, hi;
  segment(c, K.N, &lo, &hi);
  int cnt = 0;
  bool o = false;
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const bool inr = i < hi;
    const int cmp = !inr || all ? -1 : prefix_cmp(c, S, i);
    const bool sel =
        inr && (cmp < 0 || (cmp == 0 && (S.full || i <= S.cut)));
    if (inr && cmp > 0 && V >= F && key_word(c, i, 0) == 0) o = true;
    const unsigned m = __ballot_sync(kFull, sel);
    if (lane == 0) st<kG>(sb.bits + (b >> 5), m);
    cnt += __popc(m);
    if (m == 0 || rank) continue;
    for (int k = 0; k < nsw; ++k) {
      const uint32_t v = sel ? sort_word(c, i, k) : 0u;
      const int j0 = digit0(packed, k);
      for (int q = 0; q < digits_of(packed, k); ++q) {
        const unsigned d =
            sel ? (v >> (kDigitBits * q)) & (kBins - 1) : (unsigned)kBins;
        const unsigned peers = __match_any_sync(kFull, d);
        if (sel && lane == __ffs(peers) - 1) {
          atomicAdd(&tot[(j0 + q) * kBins + d], __popc(peers));
        }
      }
    }
  }
  *ov = o;
  __syncthreads();
  if (kG) {
    for (int j = t; j < nd * kBins; j += kThreads) {
      if (tot[j]) atomicAdd(&gd[j], tot[j]);
    }
  }
  int n_sel;
  int start = scan_lb(c, lane == 0 ? cnt : 0, &n_sel);
  start = __shfl_sync(kFull, start, 0);
  phase(c, kPhGather);
  for (int b = lo; b < hi; b += 32) {
    const unsigned m = ld<kG>(sb.bits + (b >> 5));
    const int i = b + lane;
    if ((m >> lane) & 1u) {
      const int p = start + __popc(m & lt);
      st<kG>(sb.ia + p, i);
      if (packed) {
        st<kG>(sb.ka + p, (uint32_t)ld<kG>(sb.rkey + i));
      } else if (rank) {
        for (int k = 0; k < nsw; ++k) {
          st<kG>(sb.kwd + (size_t)k * F + p, key_word(c, i, k));
        }
      }
    }
    start += __popc(m);
  }
  team_sync(c);
  if constexpr (kG) {
    n_sel = scan_total(c);
    for (int j = t; j < nd * kBins; j += kThreads) tot[j] = __ldcg(&gd[j]);
    ++c.ndig;
  }
  __syncthreads();
  return n_sel;
}

// Step 4 of the sort routes' dedup: the n_sel sorted rows (indices si,
// packed keys ks) into dst: valid = not invalid and first of its run.
template <bool kG>
__device__ __noinline__ void extract(Ctx<kG>& c, int n_sel, const int* si,
                                     const uint32_t* ks) {
  const int F = K.F, P = K.P, W = K.W;
  const Frontier& dst = dst_fr();
  const unsigned pmask = (1u << (P & 31)) - 1u;
  const unsigned sbmask =
      sw.sb_bits >= 32 ? 0xffffffffu : (1u << sw.sb_bits) - 1u;
  const int ts = c.team.size();
  for (int r = c.team.rank(); r < n_sel; r += ts) {
    const int i = ld<kG>(si + r);
    if (K.packed) {
      const uint32_t key = ld<kG>(ks + r);
      const bool vs =
          (key >> 31) == 0 && (r == 0 || key != ld<kG>(ks + r - 1));
      st<kG>(dst.m + r, (int32_t)(key & pmask));
      st<kG>(dst.s + r, (int32_t)jt_models::wrap_add(
                            (int)((key >> P) & sbmask), sw.s_lo));
      st<kG>(dst.v + r, (uint8_t)(vs ? 1 : 0));
      st<kG>(dst.n + r, (uint8_t)(vs && i >= F ? 1 : 0));
    } else {
      bool vs = key_word(c, i, 0) == 0;
      if (vs && r > 0) {
        const int j = ld<kG>(si + r - 1);
        bool d = false;
        for (int k = 0; k < K.kw && !d; ++k) {
          d = key_word(c, i, k) != key_word(c, j, k);
        }
        vs = d;
      }
      for (int k = 0; k < W; ++k) {
        st<kG>(dst.m + (size_t)r * W + k, (int32_t)row_word(c, i, k));
      }
      st<kG>(dst.s + r, ld<kG>(sb.rkey + i));
      st<kG>(dst.v + r, (uint8_t)(vs ? 1 : 0));
      st<kG>(dst.n + r, (uint8_t)(vs && i >= F ? 1 : 0));
    }
  }
}

// Step 3 for few selected rows: each row's place in the stable order is
// the count of rows before it (a smaller key, or an equal key earlier in
// row order), counted by one warp a row against every key in the block's
// shared memory (aliasing its sort scratch): (order, key) b->ia, b->ka
// (packed) or b->kwd (lex) -> di, dk. Block b ranks the rows [b * tile,
// b * tile + tile); one team barrier.
template <bool kG>
__device__ __noinline__ void rank_sort(Ctx<kG>& c, int n, int* di,
                                       uint32_t* dk) {
  const int F = K.F;
  const int nw = K.packed ? 1 : K.W + 2;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t* rk = reinterpret_cast<uint32_t*>(sb.wc);   // (nw, n)
  for (int x = t; x < nw * n; x += kThreads) {
    const int k = x / n, j = x - k * n;
    rk[x] = K.packed ? ld<kG>(sb.ka + j) : ld<kG>(sb.kwd + (size_t)k * F + j);
  }
  __syncthreads();
  const int G = kG ? (int)gridDim.x : 1, blk = kG ? (int)blockIdx.x : 0;
  const int tile = (n + G - 1) / G;
  const int lo = min(n, blk * tile), hi = min(n, lo + tile);
  for (int j = lo + warp; j < hi; j += kWarps) {
    int cnt = 0;
    for (int i = lane; i < n; i += 32) {
      int d = 0;   // the key of row i against row j's: -1, 0, 1
      for (int k = 0; k < nw && d == 0; ++k) {
        const uint32_t a = rk[k * n + i], b = rk[k * n + j];
        d = a < b ? -1 : a > b ? 1 : 0;
      }
      cnt += d < 0 || (d == 0 && i < j) ? 1 : 0;
    }
    for (int s = 16; s > 0; s >>= 1) cnt += __shfl_xor_sync(kFull, cnt, s);
    if (lane == 0) {
      st<kG>(di + cnt, ld<kG>(sb.ia + j));
      if (K.packed) st<kG>(dk + cnt, rk[j]);
    }
  }
  team_sync(c);
}

// The sort routes' dedup of the built rows (V of them valid) into dst:
// select the first F positions' rows, compact them, sort them (by rank
// when few, else by radix passes), extract.
// Returns the overflow flag; *pass_rows gets the rows the selection's
// histograms and the radix passes read.
template <bool kG>
__device__ __noinline__ bool dedup_sort(Ctx<kG>& c, int V,
                                        unsigned long long dv,
                                        unsigned long long di,
                                        unsigned long long* pass_rows) {
  const bool packed = K.packed;
  const int nsw = packed ? 1 : K.W + 2;   // sort words
  const int t = threadIdx.x;
  const bool all = K.N <= K.F;
  phase(c, kPhSelect);
  unsigned long long prow = all ? 0 : select_first(c, V, dv, di);
  phase(c, kPhCount);
  bool ov;
  const int n = min(K.N, K.F);   // the rows selected
  const bool rank = n <= (kG ? kRankGrid : kRankBlock) &&
                    n * (packed ? 1 : K.W + 2) <= kRankWords;
  const int n_sel = compact_selected(c, V, all, rank, &ov);

  // step 3: the LSD passes over the n_sel selected rows, or their ranks;
  // the order and keys are in (ia, ka) when cur is 0, else (ib, kb)
  int cur = 0;
  if (rank) {
    phase(c, kPhScatter);
    rank_sort(c, n_sel, sb.ib, sb.kb);
    cur = 1;
    prow += (unsigned long long)n_sel;
  }
  for (int k = rank ? -1 : nsw - 1; k >= 0; --k) {
    bool first = !packed;   // a lex word's first pass reads it off the rows
    const int j0 = digit0(packed, k);
    for (int q = 0; q < digits_of(packed, k); ++q) {
      phase(c, kPhCount);
      const int x = t < kBins ? sb.tot[(j0 + q) * kBins + t] : 0;
      if (__syncthreads_or(x == n_sel)) continue;  // one value holds every row
      int total;
      const int ex = block_exclusive_scan<kThreads>(x, &total);
      if (t < kBins) sb.dstart[t] = ex;
      __syncthreads();
      radix_pass(c, n_sel, cur ? sb.ib : sb.ia, cur ? sb.ia : sb.ib,
                 first ? nullptr : cur ? sb.kb : sb.ka,
                 cur ? sb.ka : sb.kb, k, kDigitBits * q);
      cur ^= 1;
      first = false;
      prow += (unsigned long long)n_sel;
    }
  }
  *pass_rows = prow;
  phase(c, kPhExtract);
  extract(c, n_sel, cur ? sb.ib : sb.ia, cur ? sb.kb : sb.ka);
  return reduce<kOr>(c, ov ? 1ull : 0ull) != 0;
}

template <bool kG>
__global__ void __launch_bounds__(kThreads, 1) sort_walk(const SortWalk wp) {
  extern __shared__ uint4 smem[];
  const int b = kG ? 0 : (int)blockIdx.x;
  const int t = (int)threadIdx.x;
  uint8_t* dyn = reinterpret_cast<uint8_t*>(smem);
  Ctx<kG> c;
  const Team<kG>& team = c.team;
  c.nred = c.nscan = c.nhist = c.ndig = c.npass = c.nlb = c.nfuse = 0;
  if (t == 0) {
    // the launch, the key's buffers and the step's scalars, once a block
    sw = wp;
    const int G = kG ? (int)gridDim.x : 0;
    const Layout L = make_layout(wp.F, wp.P, wp.W, wp.route, wp.H,
                                 kG ? G * kThreads : kThreads, G);
    uint8_t* base = wp.scratch ? wp.scratch + (size_t)b * wp.stride : dyn;
    for (int k = 0; k < 2; ++k) {
      sb.fr[k] = {at<int32_t>(base, L.fm[k]), at<int32_t>(base, L.fs[k]),
                  at<uint8_t>(base, L.fv[k]), at<uint8_t>(base, L.fn[k])};
    }
    sb.rkey = at<int32_t>(base, L.rkey);
    sb.rvalid = at<uint8_t>(base, L.rvalid);
    sb.table = at<int>(base, L.table);
    sb.first = at<int>(base, L.first);
    sb.pos = at<int>(base, L.pos);
    sb.la = at<int>(base, L.la);
    sb.lb = at<int>(base, L.lb);
    sb.bits = at<uint32_t>(base, L.bits);
    sb.ia = at<int>(base, L.ia);
    sb.ib = at<int>(base, L.ib);
    sb.ka = at<uint32_t>(base, L.ka);
    sb.kb = at<uint32_t>(base, L.kb);
    sb.kwd = at<uint32_t>(base, L.kwd);
    sb.red = kG ? at<unsigned long long>(base, L.red) : nullptr;
    sb.gtot = kG ? at<int>(base, L.gtot) : nullptr;
    sb.ghist = kG ? at<int>(base, L.ghist) : nullptr;
    sb.gdig = kG ? at<int>(base, L.gdig) : nullptr;
    sb.look = kG ? at<unsigned long long>(base, L.look) : nullptr;
    sb.gscan = kG ? at<unsigned long long>(base, L.gscan) : nullptr;
    int* rs = reinterpret_cast<int*>(dyn + (wp.scratch ? 0 : r16(L.bytes)));
    sb.wc = rs;
    sb.stg_i = rs + kBins * kWarps;
    sb.stg_k = reinterpret_cast<uint32_t*>(sb.stg_i + kThreads);
    sb.run = reinterpret_cast<int*>(sb.stg_k + kThreads);
    sb.dstart = sb.run + kBins;
    sb.hs = sb.dstart + kBins;
    sb.li = sb.hs + kHist * kBins;
    sb.lv = reinterpret_cast<uint32_t*>(sb.li + kLocal);
    sb.tot = reinterpret_cast<int*>(sb.lv + kLocal);
    sb.hf = sb.tot + n_digits(wp.route, wp.W) * kBins;
    sb.gfuse = kG ? at<int>(base, L.gfuse) : nullptr;
    K.F = wp.F;
    K.P = wp.P;
    K.W = wp.W;
    K.N = 0;
    K.sa = -1;
    K.packed = wp.route == kPacked;
    K.kw = K.packed ? 2 : wp.W + 2;
    K.cur = 0;
    K.ph = kPhCarry;
    K.tlast = gtime();
    K.rows = K.pass_rows = K.dedups = 0;
  }
  if (t < kPhases) stns[t] = 0;
  __syncthreads();
  // the carry: e and count in every thread's registers, the other
  // scalars in K, slots and occupancy in each block's shared memory, the
  // frontier in fr[0]
  int e = sw.sc_in[b];
  int count = sw.sc_in[2 * sw.B + b];
  {
    const int B = sw.B, F = sw.F, P = sw.P, W = sw.W;
    const int r0 = team.rank(), ts = team.size();
    if (t == 0) {
      K.e0 = e;
      K.att = sw.sc_in[B + b];
      K.maxc = sw.sc_in[3 * B + b];
      K.ovf = sw.sc_in[4 * B + b] != 0;
    }
    for (int i = t; i < 3 * P; i += kThreads) {
      sslot[i] = sw.slot_in[((size_t)(i / P) * B + b) * P + i % P];
    }
    if (t < kMaxWords) soccw[t] = 0;
    for (int i = r0; i < F * W; i += ts) {
      st<kG>(sb.fr[0].m + i, sw.masks_in[(size_t)b * F * W + i]);
    }
    for (int i = r0; i < F; i += ts) {
      st<kG>(sb.fr[0].s + i, sw.states_in[(size_t)b * F + i]);
      st<kG>(sb.fr[0].v + i, (uint8_t)(sw.valid_in[(size_t)b * F + i] != 0));
    }
    if constexpr (kG) {
      if (team.lead()) {
        for (int k = 0; k < 12; ++k) atomicExch(&sb.red[k], 0ull);
      }
      if (sw.route != kHash) {
        // the sort's global rows start at zero: the look-back cells (tag 0
        // matches no pass), the histograms and the digit counts
        for (int i = t; i < kBins; i += kThreads) {
          __stcg(&sb.look[(size_t)blockIdx.x * kBins + i], 0ull);
        }
        if (t < 2) __stcg(&sb.gscan[t * gridDim.x + blockIdx.x], 0ull);
        if (blockIdx.x == 0) {
          for (int i = t; i < 3 * kHist * kBins; i += kThreads) {
            __stcg(&sb.ghist[i], 0);
          }
          const int nd = n_digits(sw.route, W);
          for (int i = t; i < 2 * nd * kBins; i += kThreads) {
            __stcg(&sb.gdig[i], 0);
          }
          for (int i = t; i < 2 * 2 * kBins; i += kThreads) {
            __stcg(&sb.gfuse[i], 0);
          }
        }
      }
    }
    team_sync(c);
    for (int p = t; p < P; p += kThreads) {
      if (sw.occ_in[(size_t)b * P + p]) {
        atomicOr(&soccw[p >> 5], 1u << (p & 31));
      }
    }
    __syncthreads();
  }

  // the launch's sizes are read from shared memory at each use in the
  // walk, so nothing but e and count lives across its calls
  while (e < sw.wend[b] && count > 0) {
    const int32_t* row = sw.x + ((size_t)b * sw.T + e) * (sw.W + 4);
    bool any_rm = false;
    for (int k = 0; k < sw.W; ++k) any_rm |= row[k] != 0;
    phase(c, kPhComplete);
    if (any_rm) {
      const Frontier& f = src_fr();
      const int W = sw.W;
      for (int q = team.rank(); q < sw.F; q += team.size()) {
        bool have = true;
        for (int k = 0; k < W; ++k) {
          const uint32_t rm = (uint32_t)row[k];
          const uint32_t m = (uint32_t)ld<kG>(f.m + (size_t)q * W + k);
          have = have && (m & rm) == rm;
          st<kG>(f.m + (size_t)q * W + k, (int32_t)(m & ~rm));
        }
        if (!have) st<kG>(f.v + q, (uint8_t)0);
      }
      if (t < W) soccw[t] &= ~(uint32_t)row[t];
      team_sync(c);
    }
    const int s = row[sw.W];
    if (s >= 0) {
      phase(c, kPhRows);
      if (t == 0) {
        const int P = sw.P;
        sslot[s] = row[sw.W + 1];
        sslot[P + s] = row[sw.W + 2];
        sslot[2 * P + s] = row[sw.W + 3];
        soccw[s >> 5] |= 1u << (s & 31);
      }
      int rounds = 0;
      for (int stage = 0;; ++stage) {
        if (t == 0) {
          K.sa = stage == 0 ? s : -1;
          K.N = stage == 0 ? 2 * sw.F : sw.F * (1 + sw.P);
        }
        __syncthreads();
        unsigned long long dv, di;
        const unsigned long long nv = build_rows(c, &dv, &di);
        const int vo = (int)(uint32_t)nv, vc = (int)(nv >> 32);
        if (stage > 0 && vc == 0) break;
        int mism = 0;
        unsigned long long pr = 0;
        // each dedup ends in a reduction: its output is visible to the
        // whole team after it
        const bool o = sw.route == kHash
                           ? dedup_hash(c, &mism)
                           : dedup_sort(c, vo + vc, dv, di, &pr);
        if (t == 0) {
          K.ovf |= o ? 1 : 0;
          K.att = jt_models::wrap_add(K.att, mism);
          K.rows += (unsigned long long)K.N;
          K.pass_rows += pr;
          ++K.dedups;
          K.cur ^= 1;   // read again after the next stage's barrier
        }
        if (stage > 0) ++rounds;
      }
      if (team.lead()) {
        atomicMax(&sw.iter_rounds[e - K.e0], rounds);
        sw.iter_inv[e - K.e0] = 1;
      }
    }
    phase(c, kPhStep);
    const Frontier& f = src_fr();
    const int W = sw.W;
    unsigned live = 0, bad = 0;
    for (int q = team.rank(); q < sw.F; q += team.size()) {
      if (!ld<kG>(f.v + q)) continue;
      ++live;
      if (sw.attest) {
        for (int k = 0; k < W; ++k) {
          if ((uint32_t)ld<kG>(f.m + (size_t)q * W + k) & ~soccw[k]) {
            ++bad;
            break;
          }
        }
      }
    }
    const unsigned long long lb =
        reduce<kAdd>(c, (unsigned long long)bad << 32 | live);
    count = (int)(uint32_t)lb;
    if (t == 0) {
      if (sw.attest) K.att = jt_models::wrap_add(K.att, (int)(lb >> 32));
      K.maxc = max(K.maxc, count);
    }
    ++e;
  }

  // write the carry back
  phase(c, kPhCarry);
  const int B = sw.B, F = sw.F, P = sw.P, W = sw.W;
  const int r0 = team.rank(), ts = team.size();
  const Frontier& f = src_fr();
  for (int i = r0; i < F * W; i += ts) {
    sw.masks_out[(size_t)b * F * W + i] = ld<kG>(f.m + i);
  }
  for (int i = r0; i < F; i += ts) {
    sw.states_out[(size_t)b * F + i] = ld<kG>(f.s + i);
    sw.valid_out[(size_t)b * F + i] = ld<kG>(f.v + i);
  }
  if (!kG || blockIdx.x == 0) {
    for (int i = t; i < 3 * P; i += kThreads) {
      sw.slot_out[((size_t)(i / P) * B + b) * P + i % P] = sslot[i];
    }
    for (int p = t; p < P; p += kThreads) {
      sw.occ_out[(size_t)b * P + p] =
          (uint8_t)((soccw[p >> 5] >> (p & 31)) & 1u);
    }
  }
  // the lead's last boundary: its phases sum to its time in the launch
  phase(c, kPhCarry);
  if (team.lead()) {
    sw.sc_out[b] = e;
    sw.sc_out[B + b] = K.att;
    sw.sc_out[2 * B + b] = count;
    sw.sc_out[3 * B + b] = K.maxc;
    sw.sc_out[4 * B + b] = K.ovf;
    if (K.rows) atomicAdd(&sw.work[0], K.rows);
    if (K.pass_rows) atomicAdd(&sw.work[1], K.pass_rows);
    if (K.dedups) atomicAdd(&sw.work[2], K.dedups);
    if (e > K.e0) atomicAdd(&sw.work[3], (unsigned long long)(e - K.e0));
    for (int p = 0; p < kPhases; ++p) {
      if (stns[p] > 0) {
        atomicAdd(&sw.work[kWork + p], (unsigned long long)stns[p]);
      }
    }
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
  const size_t rs = radix_smem(route, W);
  if (L.bytes + rs + kStaticSmem <= (size_t)optin) {
    *pl = {kSharedPath, B, 0, r16(L.bytes) + rs};
    return cudaSuccess;
  }
  if (B > 1) {
    *pl = {kGlobalPath, B, L.bytes, rs};
    return cudaSuccess;
  }
  // the occupancy counts a block's dynamic shared memory only up to the
  // kernel's limit, 48 KB until it is raised
  if (rs + kStaticSmem > 48 * 1024) {
    err = cudaFuncSetAttribute(sort_walk<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)rs);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sort_walk<true>, kThreads, rs);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long rows = (long long)F * (1 + P);
  long long g = (rows + kThreads - 1) / kThreads;
  if (g > (long long)per_sm * sms) g = (long long)per_sm * sms;
  const int G = (int)g;
  *pl = {kGridPath, G, make_layout(F, P, W, route, H, G * kThreads, G).bytes,
         rs};
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
// int32), work zeroed ((4 + phases) x uint64: rows, pass rows, dedups,
// steps walked, each phase's ns). Returns the CUDA error of the launch
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

// The phases a launch times (the length of work past its first 4).
extern "C" int jt_sort_walk_phases() { return kPhases; }

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
