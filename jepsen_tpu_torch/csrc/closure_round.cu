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
// Layout: a block holds 256 consecutive columns of one state row q
// (grid = C/256 x S). The block first compacts, per slot p, the source
// states s with mft[p][q][s] set into shared memory (one warp ballot per
// 32 states), so each thread then reads only the table cells that can
// move into its cell. For a deterministic model that is at most one
// source state per slot. A thread stops as soon as its cell is set.
//
// Bound on an H100: bytes. The table is read once and written once
// (2 * S * C bytes) and the AND-ORs the data needs are a few per cell,
// far under the card's integer rate.
//
// The C entry points take raw device pointers and the CUDA stream and
// return cudaGetLastError(), so a refused launch is reported to the
// caller (jepsen_tpu_torch/checker/wgl_closure.py), which raises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // columns per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 30;            // C = 2^P must fit an int
constexpr int kMaxSmem = 48 * 1024;      // static launch limit

__global__ void __launch_bounds__(kThreads)
closure_round_kernel(const uint8_t* __restrict__ tb,
                     const uint8_t* __restrict__ mft,
                     uint8_t* __restrict__ out, int S, int P, int C) {
  // pre[p * S + k], k < npre[p]: the source states of row q for slot p
  extern __shared__ uint16_t pre[];
  __shared__ int npre[kMaxSlots];

  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = warp; p < P; p += kWarps) {
    const uint8_t* row = mft + ((size_t)p * S + q) * S;
    uint16_t* dst = pre + (size_t)p * S;
    int n = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {   // warp-uniform trip count
      const int s = s0 + lane;
      const bool hit = s < S && row[s] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (hit) dst[n + __popc(bal & ((1u << lane) - 1u))] = (uint16_t)s;
      n += __popc(bal);
    }
    if (lane == 0) npre[p] = n;
  }
  __syncthreads();

  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const size_t at = (size_t)q * C + c;
  uint8_t v = tb[at] != 0;
  for (int p = 0; p < P && !v; ++p) {
    if (!((c >> p) & 1)) continue;
    const int src = c ^ (1 << p);
    const uint16_t* ps = pre + (size_t)p * S;
    const int n = npre[p];
    for (int k = 0; k < n; ++k) {
      if (tb[(size_t)ps[k] * C + src]) {
        v = 1;
        break;
      }
    }
  }
  out[at] = v;
}

}  // namespace

extern "C" int jt_closure_round(const void* tb, const void* mft, void* out,
                                int S, int P, int C, void* stream) {
  const size_t smem = (size_t)P * S * sizeof(uint16_t);
  if (S <= 0 || S > 65535 || P < 0 || P > kMaxSlots || C != (1 << P) ||
      smem > (size_t)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((C + kThreads - 1) / kThreads), (unsigned)S);
  closure_round_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tb), static_cast<const uint8_t*>(mft),
      static_cast<uint8_t*>(out), S, P, C);
  return (int)cudaGetLastError();
}

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
