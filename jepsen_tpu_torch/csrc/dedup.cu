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
// key inserts at once, and five launches on one stream do the rest:
//
//   1. fill     table[H] = EMPTY, first[H] = INT_MAX, out = EMPTY, nw = 0;
//   2. insert   one thread per key: murmur3 finaliser masked to H - 1
//               (the TPU kernel's constants), linear probing with
//               atomicCAS(EMPTY -> key) until the slot holds the key, then
//               atomicMin(first[slot], i); pos[i] = slot;
//   3. count    per tile of kTile keys, the number of first occurrences
//               (i with first[pos[i]] == i), and per block the XOR of a
//               share of the table's claimed slots;
//   4. scan     one block: exclusive scan of the tile counts into tile
//               offsets, the total count and the digest;
//   5. scatter  per tile, a block-local exclusive scan of the flags gives
//               each first occurrence its rank r; r < F writes out[r] and
//               nw[r].
//
// Atomics change where a key lands in the table, never the outputs: the
// order comes from the minimum index and the digest is a XOR over a set,
// so the outputs are bit-identical to the serial loop's. H is at least
// 2N (load factor <= 1/2), so probing ends.
//
// Bound on an H100: bytes. The keys are read once, the table and its
// index array (2H ints) written and read once, pos (N ints) written and
// read, 2F outputs written: under 12 MB at the main path's N <= 278,528,
// a few microseconds at the H100 SXM's 3.35 TB/s (data sheet, 700 W power
// limit). The integer work is a few operations per key. At these sizes
// the five launches are the floor.
//
// The C entry points take raw device pointers and the CUDA stream and
// return the first nonzero cudaGetLastError(), so a refused launch is
// reported to the caller (jepsen_tpu_torch/checker/wgl_dedup.py), which
// raises. The scratch buffer is the caller's (jt_dedup_scratch_ints).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kThreads = 256;              // fill, insert, count, scatter
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kScanThreads = 1024;          // the single-block scan
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kCountMix = 0x9E3779B9u;

__device__ __forceinline__ unsigned murmur_mix(unsigned k) {
  unsigned h = k ^ (k >> 16);
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

struct Add {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return a + b; }
};
struct Xor {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return a ^ b; }
};

// Reduce v over the block; the result is valid in every lane of warp 0.
// Every thread of the block must call it.
template <int THREADS, class Op>
__device__ unsigned block_reduce(unsigned v, Op op) {
  __shared__ unsigned part[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_xor_sync(kFull, v, d));
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? part[lane] : 0u;
    for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_xor_sync(kFull, v, d));
  }
  __syncthreads();
  return v;
}

// Exclusive prefix sum of v over the block in thread order; *total gets
// the block's sum. Every thread of the block must call it.
template <int THREADS>
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < THREADS / 32 ? sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < THREADS / 32) sums[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? sums[warp - 1] : 0;
  *total = sums[THREADS / 32 - 1];
  __syncthreads();
  return before + incl - v;
}

__device__ __forceinline__ bool is_first(const int* pos, const int* first,
                                         int i) {
  const int p = pos[i];
  return p >= 0 && first[p] == i;
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(int* __restrict__ table, int* __restrict__ first, int H,
            int* __restrict__ out, uint8_t* __restrict__ nw, int F) {
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
              int* __restrict__ pos, unsigned mask) {
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
             int* __restrict__ tile_cnt, int* __restrict__ tile_xor) {
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
            int tiles, int* __restrict__ tile_off, int* __restrict__ tail) {
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
               uint8_t* __restrict__ nw) {
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

int tiles_for(int n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Scratch ints the caller allocates for (n, H): pos[n], table[H],
// first[H], and three per-tile arrays.
extern "C" long long jt_dedup_scratch_ints(int n, int H) {
  return (long long)n + 2LL * H + 3LL * tiles_for(n);
}

extern "C" int jt_dedup(const void* keys, int n, int F, int H, void* out,
                        void* nw, void* tail, void* scratch, void* stream) {
  if (n < 1 || F < 1 || H < 2 || (H & (H - 1)) != 0 || H / 2 < n) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_for(n);
  int* pos = static_cast<int*>(scratch);
  int* table = pos + n;
  int* first = table + H;
  int* tile_cnt = first + H;
  int* tile_xor = tile_cnt + tiles;
  int* tile_off = tile_xor + tiles;
  const int* k = static_cast<const int*>(keys);
  int* o = static_cast<int*>(out);
  uint8_t* w = static_cast<uint8_t*>(nw);
  int* t = static_cast<int*>(tail);
  cudaError_t e;

  const int m = H > F ? H : F;
  int fill_blocks = (m + kThreads - 1) / kThreads;
  if (fill_blocks > 4096) fill_blocks = 4096;
  fill_kernel<<<fill_blocks, kThreads, 0, s>>>(table, first, H, o, w, F);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  insert_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      k, n, table, first, pos, (unsigned)(H - 1));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int hchunk = (H + tiles - 1) / tiles;
  count_kernel<<<tiles, kThreads, 0, s>>>(pos, first, table, n, H, hchunk,
                                          tile_cnt, tile_xor);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_kernel<<<1, kScanThreads, 0, s>>>(tile_cnt, tile_xor, tiles, tile_off,
                                         t);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scatter_kernel<<<tiles, kThreads, 0, s>>>(k, pos, first, n, F, tile_off, o,
                                            w);
  return (int)cudaGetLastError();
}

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
