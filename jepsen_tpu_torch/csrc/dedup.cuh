// The hash dedup's block-level pieces, shared by K2 (dedup.cu) and
// K3-sort (sort_walk.cu), which runs the same single-block insert and
// rank inside its step walk.
//
// A key hashes with the murmur3 finaliser (the TPU kernel's constants)
// into a table of H slots (a power of two), claims a slot with
// atomicCAS(EMPTY -> key) by linear probing, and records its input index
// there with atomicMin, so a key's first occurrence is the index that
// owns the minimum. Flagging those indices and ranking them with an
// exclusive block scan in input order gives the serial loop's first-seen
// order: atomics move where a key lands, never the ranks.
//
// The table may lie in shared or in device memory: the atomics take a
// generic pointer, and one block owns its table.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace jt_hash {

constexpr int kEmpty = -1;
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
struct Or {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return a | b; }
};
struct And {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return a & b; }
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

// As block_reduce, with the result in every thread of the block.
template <int THREADS, class Op>
__device__ unsigned block_all_reduce(unsigned v, Op op) {
  __shared__ unsigned all;
  v = block_reduce<THREADS>(v, op);
  if (threadIdx.x == 0) all = v;
  __syncthreads();
  v = all;
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

// Insert one thread's keys, input indices [base, base + mine), the j-th
// at my_key[j], into table/first (H = mask + 1 slots), writing its slot
// to my_pos[j] (-1 for EMPTY). The lane takes its keys as a queue, one
// probe per turn of the loop, so a long probe chain holds its warp up
// once: the warp's turns are the most probes one lane makes over all its
// keys, not the sum over its keys of the longest chain in the warp.
__device__ __forceinline__ void insert_run(const int* my_key, int* my_pos,
                                           int mine, int base, int* table,
                                           int* first, unsigned mask) {
  int j = 0, k = mine > 0 ? my_key[0] : kEmpty;
  unsigned h = murmur_mix((unsigned)k) & mask;
  while (j < mine) {
    bool done = k == kEmpty;
    if (!done) {
      const int old = atomicCAS(&table[h], kEmpty, k);
      done = old == kEmpty || old == k;
      if (done) atomicMin(&first[h], base + j);
    }
    if (done) {
      my_pos[j] = k == kEmpty ? -1 : (int)h;
      k = ++j < mine ? my_key[j] : kEmpty;
      h = murmur_mix((unsigned)k) & mask;
    } else {
      h = (h + 1) & mask;
    }
  }
}

// Whether input index base + j is its key's first occurrence. The load
// is volatile: atomicMin wrote first[] in L2, and a table in device
// memory must not be read from a stale L1 line.
__device__ __forceinline__ bool first_of(const int* my_pos, const int* first,
                                         int base, int j) {
  const int p = my_pos[j];
  return p >= 0 &&
         reinterpret_cast<const volatile int*>(first)[p] == base + j;
}

}  // namespace jt_hash
