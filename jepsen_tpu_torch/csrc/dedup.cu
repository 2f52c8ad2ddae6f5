// K2: the sort family's frontier dedup, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jepsen_tpu/checker/wgl_dedup.py:129
// (dedup_fn). N packed 31-bit config keys go in, old frontier first,
// EMPTY = -1 for an invalid entry. Out come:
//
//   out[F]   the distinct keys in first-seen order, EMPTY past them;
//   nw[F]    1 where out[r]'s first occurrence has input index >= F;
//   tail[0]  count, the total of distinct keys (count > F: overflow);
//   tail[1]  digest = xor(keys claimed in the table) ^ count * 0x9E3779B9,
//            in wrapping 32-bit arithmetic.
//
// The TPU kernel inserts the keys one by one in a serial loop. Here every
// key inserts at once: murmur3 finaliser masked to H - 1 (the TPU
// kernel's constants), linear probing with atomicCAS(EMPTY -> key) until
// the slot holds the key, then atomicMin(first[slot], i). A key's first
// occurrence is the index i with first[slot of i] == i; an exclusive scan
// of those flags in input order gives each its rank r, and r < F writes
// out[r] and nw[r]. Atomics change where a key lands in the table, never
// the outputs: the order comes from the minimum index and the digest is a
// XOR over a set, so the outputs are bit-identical to the serial loop's.
// H = table_size(N) is at least 2N (load factor <= 1/2), so probing ends.
//
// Batch. B independent rows of N keys (B x N, row-major) dedup in one
// call, each row against its own table, with B x F outputs and a count
// and a digest per row: the vmapped TPU kernel's batch grid axis. The
// row is the grid's x on the single-block route (one block per row, so
// the batch fills B SMs where one row fills one) and the grid's y on
// each of the five launches (per-row tables and tile arrays in one
// scratch, a scan block per row). Row b of a batched call is exactly the
// call on row b alone; B = 1 is the unbatched call, and a batched call
// still counts one or five launches.
//
// Two routes; the caller picks by N (wgl_dedup.path):
//
//   N <= 8,192: one launch of one block of 1,024 threads, all its state
//   in dynamic shared memory (200 KB at most): table[H] and first[H]
//   (H <= 16,384), and a copy of the keys and their slots. Thread t owns
//   ceil(N / 1024) <= 8 consecutive keys, so thread order is input
//   order. It takes them as a queue, one probe per turn, so a warp
//   waits once for the lane with the most probes in all, not at every
//   key for that key's longest chain; with nearly distinct keys (a full
//   frontier) that wait is most of the insert. Phases, split by
//   __syncthreads(): fill; insert with shared atomics; flags ranked by
//   one block scan; scatter; count and the digest from a block XOR of
//   the claimed slots. No scratch in device memory. This takes every
//   call of the main path at F = 256 and stage A (N = 2F) of the
//   escalated passes at F = 1,024 and 4,096; it beat the five launches
//   on every shape both take, repeating keys or a full frontier
//   (chip_smoke.py times both).
//
//   N > 8,192 (stage B of the escalated passes and of the batch entry at
//   its F = 1,024, and stage A from F = 16,384): five launches on one
//   stream, with the table in the caller's scratch:
//     1. fill     table = EMPTY, first = INT_MAX, out = EMPTY, nw = 0;
//     2. insert   one thread per key; pos[i] = slot;
//     3. count    per tile of kTile keys, the number of first
//                 occurrences, and per block the XOR of a share of the
//                 table's claimed slots;
//     4. scan     one block: exclusive scan of the tile counts into tile
//                 offsets, the total count and the digest;
//     5. scatter  per tile, a block-local exclusive scan of the flags
//                 ranks each first occurrence.
//
// Bound on an H100: bytes, and at these sizes launches. The keys are read
// once and 2F outputs written: under 1.2 MB at the main path's
// N <= 278,528, well under a microsecond at 3.35 TB/s (H100 SXM data
// sheet, 700 W power limit). The integer work is a few operations per key.
// So one launch (a few microseconds) is the floor of the single-block
// route, and five launches that of the large one; on one block the
// shared-memory atomics and the issue rate of one SM add to it as N
// grows.
//
// The murmur finaliser, the block reductions and scan, and the
// single-block path's insert (`insert_run`) live in dedup.cuh, which
// K3-sort (sort_walk.cu) includes too: on CUDA every sort walk runs this
// insert and rank inside its step walk, and K2's own launches serve the
// eager walk and the measurements.
//
// The C entry points take raw device pointers and the CUDA stream and
// return the first nonzero cudaGetLastError(), so a refused launch is
// reported to the caller (jepsen_tpu_torch/checker/wgl_dedup.py), which
// raises. The large path's scratch is the caller's
// (jt_dedup_scratch_ints); jt_dedup_kernel_launches counts the kernels
// this library has launched.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "dedup.cuh"

namespace {

using jt_hash::Add;
using jt_hash::block_exclusive_scan;
using jt_hash::block_reduce;
using jt_hash::kCountMix;
using jt_hash::kEmpty;
using jt_hash::murmur_mix;
using jt_hash::Xor;

constexpr int kThreads = 256;              // fill, insert, count, scatter
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kScanThreads = 1024;          // the single-block scan
constexpr int kSingleThreads = 1024;       // the single-block path
constexpr int kSingleMaxN = 8192;
constexpr int kSinglePerThread = kSingleMaxN / kSingleThreads;
constexpr int kSingleMaxH = 2 * kSingleMaxN;   // table_size(kSingleMaxN)
// table and first (H each), and the keys and their slots (1,024 odd
// strides of at most 9 each): 200 KB at most
constexpr int kSingleMaxSmem =
    (2 * kSingleMaxH + 2 * kSingleThreads * (kSinglePerThread | 1)) *
    (int)sizeof(int);
constexpr int kMaxDevices = 64;
constexpr int kMaxBatch = 65535;           // grid.y of the five launches

std::atomic<long long> g_launches{0};
std::atomic<unsigned long long> g_smem_ready{0};   // a bit per device

__device__ __forceinline__ bool is_first(const int* pos, const int* first,
                                         int i) {
  const int p = pos[i];
  return p >= 0 && first[p] == i;
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(int* __restrict__ table, int* __restrict__ first, int H,
            int* __restrict__ out, uint8_t* __restrict__ nw, int F,
            long long stride) {
  const size_t row = blockIdx.y;
  table += row * stride;
  first += row * stride;
  out += row * F;
  nw += row * F;
  const int m = H > F ? H : F;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < m;
       i += gridDim.x * kThreads) {
    if (i < H) {
      table[i] = kEmpty;
      first[i] = INT_MAX;
    }
    if (i < F) {
      out[i] = kEmpty;
      nw[i] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
insert_kernel(const int* __restrict__ keys, int n, int* table, int* first,
              int* __restrict__ pos, unsigned mask, long long stride) {
  const size_t row = blockIdx.y;
  keys += row * n;
  table += row * stride;
  first += row * stride;
  pos += row * stride;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int k = keys[i];
  if (k == kEmpty) {
    pos[i] = -1;
    return;
  }
  unsigned h = murmur_mix((unsigned)k) & mask;
  for (;;) {
    const int old = atomicCAS(&table[h], kEmpty, k);
    if (old == kEmpty || old == k) break;
    h = (h + 1) & mask;
  }
  atomicMin(&first[h], i);
  pos[i] = (int)h;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ pos, const int* __restrict__ first,
             const int* __restrict__ table, int n, int H, int hchunk,
             int* __restrict__ tile_cnt, int* __restrict__ tile_xor,
             long long stride) {
  const size_t row = blockIdx.y;
  pos += row * stride;
  first += row * stride;
  table += row * stride;
  tile_cnt += row * stride;
  tile_xor += row * stride;
  const int base = blockIdx.x * kTile;
  unsigned c = 0;
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads + threadIdx.x;
    if (i < n && is_first(pos, first, i)) ++c;
  }
  unsigned x = 0;
  const int h0 = blockIdx.x * hchunk;
  const int h1 = h0 + hchunk < H ? h0 + hchunk : H;
  for (int h = h0 + threadIdx.x; h < h1; h += kThreads) {
    const int t = table[h];
    if (t != kEmpty) x ^= (unsigned)t;
  }
  c = block_reduce<kThreads>(c, Add());
  x = block_reduce<kThreads>(x, Xor());
  if (threadIdx.x == 0) {
    tile_cnt[blockIdx.x] = (int)c;
    tile_xor[blockIdx.x] = (int)x;
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ tile_cnt, const int* __restrict__ tile_xor,
            int tiles, int* __restrict__ tile_off, int* __restrict__ tail,
            long long stride) {
  const size_t row = blockIdx.x;
  tile_cnt += row * stride;
  tile_xor += row * stride;
  tile_off += row * stride;
  tail += row * 2;
  int carry = 0;
  unsigned x = 0;
  for (int b0 = 0; b0 < tiles; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const int v = b < tiles ? tile_cnt[b] : 0;
    if (b < tiles) x ^= (unsigned)tile_xor[b];
    int total;
    const int excl = block_exclusive_scan<kScanThreads>(v, &total);
    if (b < tiles) tile_off[b] = carry + excl;
    carry += total;
  }
  x = block_reduce<kScanThreads>(x, Xor());
  if (threadIdx.x == 0) {
    tail[0] = carry;
    tail[1] = (int)(x ^ ((unsigned)carry * kCountMix));
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ keys, const int* __restrict__ pos,
               const int* __restrict__ first, int n, int F,
               const int* __restrict__ tile_off, int* __restrict__ out,
               uint8_t* __restrict__ nw, long long stride) {
  const size_t row = blockIdx.y;
  keys += row * n;
  pos += row * stride;
  first += row * stride;
  tile_off += row * stride;
  out += row * F;
  nw += row * F;
  // thread t owns kPerThread consecutive keys, so thread order is input
  // order and the block scan ranks the flags in input order
  const int base = blockIdx.x * kTile + threadIdx.x * kPerThread;
  bool flag[kPerThread];
  int c = 0;
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j;
    flag[j] = i < n && is_first(pos, first, i);
    c += flag[j];
  }
  int total;
  int r = tile_off[blockIdx.x] + block_exclusive_scan<kThreads>(c, &total);
  for (int j = 0; j < kPerThread; ++j) {
    if (!flag[j]) continue;
    if (r < F) {
      out[r] = keys[base + j];
      nw[r] = base + j >= F;
    }
    ++r;
  }
}

__global__ void __launch_bounds__(kSingleThreads)
single_block_kernel(const int* __restrict__ keys, int n, int F, int H,
                    int* __restrict__ out, uint8_t* __restrict__ nw,
                    int* __restrict__ tail) {
  extern __shared__ int smem[];
  // one block per row of the batch
  const size_t row = blockIdx.x;
  keys += row * n;
  out += row * F;
  nw += row * F;
  tail += row * 2;
  int* table = smem;
  int* first = smem + H;
  // thread t owns keys [t * per, t * per + per), in input order. Their
  // copies sit in skey[] and their slots in pos[] from t * stride on:
  // an odd stride keeps a warp's lanes on distinct banks
  const int per = (n + kSingleThreads - 1) / kSingleThreads;
  const int stride = per | 1;
  int* skey = first + H;
  int* pos = skey + kSingleThreads * stride;
  const int t = threadIdx.x;

  // 1. fill, and the keys into shared memory (coalesced)
  for (int i = t; i < n; i += kSingleThreads) {
    skey[i + (i / per) * (stride - per)] = keys[i];
  }
  for (int i = t; i < H; i += kSingleThreads) {
    table[i] = kEmpty;
    first[i] = INT_MAX;
  }
  for (int r = t; r < F; r += kSingleThreads) {
    out[r] = kEmpty;
    nw[r] = 0;
  }
  __syncthreads();

  // 2. insert, each lane's keys as a queue (dedup.cuh)
  const int base = t * per;
  const int mine = max(0, min(per, n - base));
  const int* my_key = skey + t * stride;
  int* my_pos = pos + t * stride;
  jt_hash::insert_run(my_key, my_pos, mine, base, table, first,
                       (unsigned)(H - 1));
  __syncthreads();

  // 3. first-occurrence flags, ranked in input order
  unsigned flags = 0;
  int c = 0;
#pragma unroll
  for (int i = 0; i < kSinglePerThread; ++i) {
    if (i < mine) {
      const int p = my_pos[i];
      if (p >= 0 && first[p] == base + i) {
        flags |= 1u << i;
        ++c;
      }
    }
  }
  int count;
  int r = block_exclusive_scan<kSingleThreads>(c, &count);

  // 4. scatter the ranks below F
#pragma unroll
  for (int i = 0; i < kSinglePerThread; ++i) {
    if (!((flags >> i) & 1u)) continue;
    if (r < F) {
      out[r] = my_key[i];
      nw[r] = base + i >= F;
    }
    ++r;
  }

  // 5. count, and the digest over the table's claimed slots
  unsigned x = 0;
  for (int i = t; i < H; i += kSingleThreads) {
    const int v = table[i];
    if (v != kEmpty) x ^= (unsigned)v;
  }
  x = block_reduce<kSingleThreads>(x, Xor());
  if (t == 0) {
    tail[0] = count;
    tail[1] = (int)(x ^ ((unsigned)count * kCountMix));
  }
}

// Opt in to the single-block path's dynamic shared memory, once per
// device.
cudaError_t single_block_ready() {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < kMaxDevices ? 1ull << dev : 0ull;
  if (bit && (g_smem_ready.load() & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(single_block_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSingleMaxSmem);
  if (e == cudaSuccess) g_smem_ready.fetch_or(bit);
  return e;
}

bool single_block_fits(int n, int H) {
  return n <= kSingleMaxN && H <= kSingleMaxH;
}

int tiles_for(int n) { return (n + kTile - 1) / kTile; }

// Scratch ints of one row on the large path: pos[n], table[H], first[H],
// and three per-tile arrays.
long long row_scratch_ints(int n, int H) {
  return (long long)n + 2LL * H + 3LL * tiles_for(n);
}

}  // namespace

// Scratch ints the caller allocates for B rows of (n, H) on the chosen
// path: none on the single-block path; else B rows of pos[n], table[H],
// first[H], and three per-tile arrays.
extern "C" long long jt_dedup_scratch_ints(int B, int n, int H, int single) {
  if (single) return 0;
  return (long long)B * row_scratch_ints(n, H);
}

// Kernels launched by jt_dedup since the library was loaded.
extern "C" long long jt_dedup_kernel_launches() { return g_launches.load(); }

// B rows of n keys; out is B x F ints, nw B x F bytes, tail B x 2 ints
// (count, digest). single: 1 for the single-block path (n <= 8,192), 0
// for the five launches; the caller picks
// (jepsen_tpu_torch/checker/wgl_dedup.py).
extern "C" int jt_dedup(const void* keys, int B, int n, int F, int H,
                        int single, void* out, void* nw, void* tail,
                        void* scratch, void* stream) {
  if (B < 1 || B > kMaxBatch || n < 1 || F < 1 || H < 2 ||
      (H & (H - 1)) != 0 || H / 2 < n ||
      (single && !single_block_fits(n, H))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(keys);
  int* o = static_cast<int*>(out);
  uint8_t* w = static_cast<uint8_t*>(nw);
  int* t = static_cast<int*>(tail);
  cudaError_t e;

  if (single) {
    if ((e = single_block_ready()) != cudaSuccess) return (int)e;
    const int per = (n + kSingleThreads - 1) / kSingleThreads;
    const size_t smem = (2 * H + 2 * kSingleThreads * (per | 1)) *
                        sizeof(int);
    single_block_kernel<<<B, kSingleThreads, smem, s>>>(k, n, F, H, o, w,
                                                         t);
    ++g_launches;
    return (int)cudaGetLastError();
  }

  // row r's scratch starts at r * stride; the pointers below are row
  // 0's, and each kernel adds its row's offset
  const int tiles = tiles_for(n);
  const long long stride = row_scratch_ints(n, H);
  int* pos = static_cast<int*>(scratch);
  int* table = pos + n;
  int* first = table + H;
  int* tile_cnt = first + H;
  int* tile_xor = tile_cnt + tiles;
  int* tile_off = tile_xor + tiles;

  const int m = H > F ? H : F;
  int fill_blocks = (m + kThreads - 1) / kThreads;
  if (fill_blocks > 4096) fill_blocks = 4096;
  fill_kernel<<<dim3(fill_blocks, B), kThreads, 0, s>>>(table, first, H, o,
                                                        w, F, stride);
  ++g_launches;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  insert_kernel<<<dim3((n + kThreads - 1) / kThreads, B), kThreads, 0, s>>>(
      k, n, table, first, pos, (unsigned)(H - 1), stride);
  ++g_launches;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int hchunk = (H + tiles - 1) / tiles;
  count_kernel<<<dim3(tiles, B), kThreads, 0, s>>>(
      pos, first, table, n, H, hchunk, tile_cnt, tile_xor, stride);
  ++g_launches;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_kernel<<<B, kScanThreads, 0, s>>>(tile_cnt, tile_xor, tiles, tile_off,
                                         t, stride);
  ++g_launches;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scatter_kernel<<<dim3(tiles, B), kThreads, 0, s>>>(
      k, pos, first, n, F, tile_off, o, w, stride);
  ++g_launches;
  return (int)cudaGetLastError();
}

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
