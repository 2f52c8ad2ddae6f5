// K1: one Jacobi closure round of the dense WGL table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jepsen_tpu/checker/wgl_pallas.py:58
// (closure_round_fn). Computes, for the table tb (S states x C = 2^P
// pending masks, uint8 0/1) and the transposed transitions mft
// (P x S x S, uint8 0/1, mft[p][q][s] = "linearizing slot p moves state s
// to state q"):
//
//   out[q][c] = tb[q][c] | OR_{p : bit p of c} OR_s mft[p][q][s] & tb[s][c ^ 2^p]
//
// Reads tb and writes the separate buffer out, so the round is Jacobi,
// exactly as the TPU round reads tb and accumulates into acc.
//
// Batch. B independent tables (B x S x C) with their own transitions
// (B x P x S x S) take one launch: the batch index b is the grid's z (the
// cells kernel's y). A block reads the transitions of its table b, and
// lists each source state s as the global row b * S + s, so the loads
// that follow index the whole (B * S) x C buffer with no per-batch
// offset; row b of a batched round is exactly the unbatched round on
// table b. This is the vmapped TPU kernel's batch grid axis. B = 1 runs
// each kernel's unbatched instance (kBatched = false), where the batch
// index is the constant 0 and the code is the unbatched round's (the
// batched indexing alone made the unbatched round measurably slower).
//
// Sources. A block serves one state row q. It first lists, per slot p,
// the source states s with mft[p][q][s] set (one warp ballot per 32
// states) in shared memory as entries s << 5 | p (s a global row, see
// Batch), grouped by slot. For a
// deterministic model that is at most one source state per slot, so a
// thread then reads only the rows that can move into its row.
//
// Chunks (P >= 4). A thread owns one 16-byte chunk (uint4) of row q,
// columns [16j, 16j + 16). It loads its own chunk once, ORs in what moves
// into it and writes one uint4. Byte i of 32-bit word k of a chunk is
// column 16j + 4k + i (little-endian), so column bits 0-3 lie inside the
// chunk and bits 4 and up are bits of j:
//   * slot p >= 4: every column of the chunk has bit p equal to bit p - 4
//     of j. Where it is set, the moved columns are the aligned chunk
//     j ^ 2^(p-4) of each source row; where it is clear nothing moves and
//     the load is predicated off. No per-byte mask.
//   * slot p < 4: the source columns lie in the same chunk j of the
//     source row. A byte butterfly on the four words gives "byte i takes
//     byte i ^ 2^p where bit p of i is set, else 0", the TPU kernel's lane
//     roll plus iota mask (closure_round.cuh, which K3 shares).
// 0/1 bytes stay 0/1 under OR and AND, so there is no per-cell branch and
// no early exit: every lane of a warp runs the same entry list.
//
// Cells (P <= 3, C < 16). A row is less than a chunk, so one warp per row
// runs the same formulation one byte per thread, with the moved byte
// masked by bit p of c instead of predicated.
//
// Bound on an H100. The table is at most 4 MB (S * 2^P <= 2^22 on the
// dense engine) and stays in the 50 MB L2 from one round to the next, so
// the round is limited by L2 load instructions and their latency, not by
// HBM bytes: 1 + nnz(mft[0..3][q]) + nnz(mft[4..][q]) / 2 coalesced
// 16-byte loads per chunk of row q. The AND-ORs are a few per loaded
// word. No tensor cores: at the main path's S = 8 a 0/1 `mma` would
// multiply 8 x 8 tiles that are almost all zero; the round is data
// movement.
//
// The C entry points take raw device pointers and the CUDA stream and
// return cudaGetLastError(), so a refused launch is reported to the
// caller (jepsen_tpu_torch/checker/wgl_closure.py), which raises.

#include <cstdint>
#include <cuda_runtime.h>

#include "closure_round.cuh"

namespace {

using jt_closure::butterfly;
using jt_closure::kChunkLog;
using jt_closure::or_into;

constexpr int kThreads = 256;            // chunks per block (P >= 4)
constexpr int kMaxSlots = 30;            // C = 2^P must fit an int
constexpr int kMaxRows = 65535;          // grid.y
constexpr int kMaxBatch = 65535;         // grid.z (grid.y of the cells)
constexpr int kMaxSmem = 48 * 1024;      // static launch limit
constexpr unsigned kFull = 0xffffffffu;

// List row q's source states of every slot in ent, grouped by slot:
// ent[start[p] .. start[p + 1]) = (row0 + s) << 5 | p for each s with
// mft[p][q][s] set, row0 the first global row of the block's table
// (row0 + s < 2^27). Every thread of the block must call it.
template <int THREADS>
__device__ void list_sources(const uint8_t* __restrict__ mft, int S, int P,
                             int q, int row0, uint32_t* ent, int* start) {
  __shared__ int cnt[kMaxSlots];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = warp; p < P; p += THREADS / 32) {
    const uint8_t* row = mft + ((size_t)p * S + q) * S;
    int n = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {   // warp-uniform trip count
      const int s = s0 + lane;
      n += __popc(__ballot_sync(kFull, s < S && row[s] != 0));
    }
    if (lane == 0) cnt[p] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int at = 0;
    for (int p = 0; p < P; ++p) {
      start[p] = at;
      at += cnt[p];
    }
    start[P] = at;
  }
  __syncthreads();
  for (int p = warp; p < P; p += THREADS / 32) {
    const uint8_t* row = mft + ((size_t)p * S + q) * S;
    uint32_t* dst = ent + start[p];
    int n = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const bool hit = s < S && row[s] != 0;
      const unsigned bal = __ballot_sync(kFull, hit);
      if (hit) {
        dst[n + __popc(bal & ((1u << lane) - 1u))] =
            (uint32_t)(row0 + s) << 5 | p;
      }
      n += __popc(bal);
    }
  }
  __syncthreads();
}

template <int p>
__device__ __forceinline__ void in_chunk_slot(
    uint4& acc, const uint4* __restrict__ tb, const uint32_t* ent,
    const int* start, int nchunk, int j) {
  for (int e = start[p]; e < start[p + 1]; ++e) {
    or_into(acc, butterfly<p>(tb[(size_t)(ent[e] >> 5) * nchunk + j]));
  }
}

template <bool kBatched>
__global__ void __launch_bounds__(kThreads)
closure_round_chunks(const uint4* __restrict__ tb,
                     const uint8_t* __restrict__ mft,
                     uint4* __restrict__ out, int S, int P, int nchunk) {
  extern __shared__ uint32_t ent[];
  __shared__ int start[kMaxSlots + 1];
  const int q = blockIdx.y;
  const int b = kBatched ? (int)blockIdx.z : 0;
  const int row0 = b * S;
  list_sources<kThreads>(mft + (size_t)b * P * S * S, S, P, q, row0, ent,
                         start);

  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= nchunk) return;
  uint4 acc = tb[(size_t)(row0 + q) * nchunk + j];
  in_chunk_slot<0>(acc, tb, ent, start, nchunk, j);
  in_chunk_slot<1>(acc, tb, ent, start, nchunk, j);
  in_chunk_slot<2>(acc, tb, ent, start, nchunk, j);
  in_chunk_slot<3>(acc, tb, ent, start, nchunk, j);
  // slots p >= 4: chunk j ^ 2^(p-4), where bit p - 4 of j is set
#pragma unroll 4
  for (int e = start[kChunkLog]; e < start[P]; ++e) {
    const uint32_t x = ent[e];
    const int b = (int)(x & 31u) - kChunkLog;
    if ((j >> b) & 1) {
      or_into(acc, tb[(size_t)(x >> 5) * nchunk + (j ^ (1 << b))]);
    }
  }
  out[(size_t)(row0 + q) * nchunk + j] = acc;
}

template <bool kBatched>
__global__ void __launch_bounds__(32)
closure_round_cells(const uint8_t* __restrict__ tb,
                    const uint8_t* __restrict__ mft,
                    uint8_t* __restrict__ out, int S, int P, int C) {
  extern __shared__ uint32_t ent[];
  __shared__ int start[kMaxSlots + 1];
  const int q = blockIdx.x;
  const int b = kBatched ? (int)blockIdx.y : 0;
  const int row0 = b * S;
  list_sources<32>(mft + (size_t)b * P * S * S, S, P, q, row0, ent, start);

  const int c = threadIdx.x;
  if (c >= C) return;
  uint8_t v = tb[(size_t)(row0 + q) * C + c];
  for (int e = 0; e < start[P]; ++e) {
    const uint32_t x = ent[e];
    const int p = (int)(x & 31u);
    v |= tb[(size_t)(x >> 5) * C + (c ^ (1 << p))] & ((c >> p) & 1);
  }
  out[(size_t)(row0 + q) * C + c] = v;
}

}  // namespace

// B tables of S x C (C = 2^P) with B transition tensors of P x S x S, all
// contiguous; B = 1 is one table, on the kernels' unbatched instances.
extern "C" int jt_closure_round(const void* tb, const void* mft, void* out,
                                int B, int S, int P, int C, void* stream) {
  const size_t smem = (size_t)P * S * sizeof(uint32_t);
  if (B <= 0 || B > kMaxBatch || S <= 0 || S > kMaxRows || P < 0 ||
      P > kMaxSlots || C != (1 << P) || smem > (size_t)kMaxSmem ||
      (long long)B * S > (1LL << 27)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P >= kChunkLog) {
    if (((uintptr_t)tb | (uintptr_t)out) & 15u) {
      return (int)cudaErrorMisalignedAddress;
    }
    const int nchunk = C >> kChunkLog;
    const dim3 grid((unsigned)((nchunk + kThreads - 1) / kThreads),
                    (unsigned)S, (unsigned)B);
    const auto kernel = B == 1 ? &closure_round_chunks<false>
                               : &closure_round_chunks<true>;
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const uint4*>(tb), static_cast<const uint8_t*>(mft),
        static_cast<uint4*>(out), S, P, nchunk);
  } else {
    const auto kernel = B == 1 ? &closure_round_cells<false>
                               : &closure_round_cells<true>;
    kernel<<<dim3((unsigned)S, (unsigned)B), 32, smem, s>>>(
        static_cast<const uint8_t*>(tb), static_cast<const uint8_t*>(mft),
        static_cast<uint8_t*>(out), S, P, C);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
