// The closure round's chunk arithmetic, for K1 (closure_round.cu).
//
// A 16-byte chunk (uint4) of a table row holds columns [16j, 16j + 16):
// byte i of 32-bit word k is column 16j + 4k + i (little-endian), so
// column bits 0-3 lie inside the chunk and bits 4 and up are bits of j.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace jt_closure {

constexpr int kChunkLog = 4;             // 16 columns = one uint4

__device__ __forceinline__ void or_into(uint4& a, const uint4& b) {
  a.x |= b.x;
  a.y |= b.y;
  a.z |= b.z;
  a.w |= b.w;
}

// The in-chunk move of slot p < 4: byte i takes byte i ^ 2^p where bit p
// of i is set, else 0 (the TPU kernel's lane roll plus iota mask):
//   p = 0: (w << 8) & 0xFF00FF00 on each word
//   p = 1: (w << 16) & 0xFFFF0000 on each word
//   p = 2: words (x, y, z, w) -> (0, x, 0, z)
//   p = 3: words (x, y, z, w) -> (0, 0, x, y)
template <int p>
__device__ __forceinline__ uint4 butterfly(const uint4& v) {
  if (p == 0) {
    return make_uint4((v.x << 8) & 0xFF00FF00u, (v.y << 8) & 0xFF00FF00u,
                      (v.z << 8) & 0xFF00FF00u, (v.w << 8) & 0xFF00FF00u);
  }
  if (p == 1) {
    return make_uint4((v.x << 16) & 0xFFFF0000u, (v.y << 16) & 0xFFFF0000u,
                      (v.z << 16) & 0xFFFF0000u, (v.w << 16) & 0xFFFF0000u);
  }
  if (p == 2) return make_uint4(0u, v.x, 0u, v.z);
  return make_uint4(0u, 0u, v.x, v.y);
}

// butterfly<p> for a slot p < 4 known only at run time.
__device__ __forceinline__ uint4 butterfly_any(int p, const uint4& v) {
  switch (p) {
    case 0: return butterfly<0>(v);
    case 1: return butterfly<1>(v);
    case 2: return butterfly<2>(v);
    default: return butterfly<3>(v);
  }
}

}  // namespace jt_closure
