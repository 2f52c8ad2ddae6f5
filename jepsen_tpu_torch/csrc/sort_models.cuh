// The six device models' steps, for K3-sort (sort_walk.cu) and K3
// (dense_walk.cu).
//
// Each is a line-for-line transcription in int32 of the torch step of
// jepsen_tpu_torch/checker/wgl.py (`_register_step`, `_mutex_step`,
// `_counter_step`, `_gset_step`, `_uqueue_step`), itself the JAX
// package's jnp step: given (state, f, a, b) it returns whether
// linearizing the op in that state is legal, and writes the state it
// leads to, legal or not (the sort routes keep the illegal candidates'
// states as they are). Additions wrap around as torch's int32 tensors do
// (done in uint32), and `>>` is arithmetic, as torch's on int32.
// tests/test_torch_sortwalk.py holds a numpy transcription of this file
// against the torch steps.

#pragma once

#include <cstdint>

namespace jt_models {

// model ids: the order of wgl_sortwalk.MODELS
enum Model : int {
  kRegister = 0,
  kCasRegister = 1,
  kMutex = 2,
  kCounter = 3,
  kGSet = 4,
  kUQueue = 5,
  kModels = 6,
};

constexpr int kNil = -1;           // history.NIL
constexpr int kRead = 0;           // history.F_READ
constexpr int kWrite = 1;          // history.F_WRITE
constexpr int kCas = 2;            // history.F_CAS
constexpr int kGSetMax = 31;       // wgl.GSET_MAX_ELEMENTS
constexpr int kUqValues = 7;       // history.UQ_VALUES
constexpr int kUqCountMax = 15;    // history.UQ_COUNT_MAX

__device__ __forceinline__ int wrap_add(int x, int y) {
  return (int)((uint32_t)x + (uint32_t)y);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

__device__ __forceinline__ bool register_step(bool cas, int state, int f,
                                              int a, int b, int* out) {
  bool legal = (f == kRead) && (a == kNil || state == a);
  legal = legal || f == kWrite;
  if (cas) {
    const bool cas_ok = f == kCas && state == a;
    legal = legal || cas_ok;
    *out = f == kWrite ? a : (cas_ok ? b : state);
  } else {
    *out = f == kWrite ? a : state;
  }
  return legal;
}

// f: 0 = acquire, 1 = release
__device__ __forceinline__ bool mutex_step(int state, int f, int* out) {
  *out = f == 0 ? 1 : 0;
  return (f == 0 && state == 0) || (f == 1 && state == 1);
}

// f: 0 = read(a; b = 1 iff constrained), 1 = add(a)
__device__ __forceinline__ bool counter_step(int state, int f, int a, int b,
                                             int* out) {
  *out = f == 1 ? wrap_add(state, a) : state;
  return (f == 0 && (b == 0 || state == a)) || f == 1;
}

// f: 0 = read(membership mask a), 1 = add(element a)
__device__ __forceinline__ bool gset_step(int state, int f, int a, int* out) {
  const int shift = clampi(a, 0, kGSetMax - 1);
  *out = f == 1 ? (state | (1 << shift)) : state;
  return (f == 0 && (a == kNil || state == a)) || f == 1;
}

// f: 0 = dequeue(a), 1 = enqueue(a); 4-bit multiplicities per value
__device__ __forceinline__ bool uqueue_step(int state, int f, int a,
                                            int* out) {
  const int shift = 4 * clampi(a, 0, kUqValues - 1);
  const int cnt = (state >> shift) & kUqCountMax;
  const bool ok_a = a >= 0 && a < kUqValues;
  const bool legal = f == 1 ? (ok_a && cnt < kUqCountMax) : (ok_a && cnt > 0);
  const int one = 1 << shift;
  *out = legal && f == 1 ? wrap_add(state, one)
         : legal && f == 0 ? (int)((uint32_t)state - (uint32_t)one)
                           : state;
  return legal;
}

__device__ __forceinline__ bool step(int model, int state, int f, int a,
                                     int b, int* out) {
  switch (model) {
    case kRegister: return register_step(false, state, f, a, b, out);
    case kCasRegister: return register_step(true, state, f, a, b, out);
    case kMutex: return mutex_step(state, f, out);
    case kCounter: return counter_step(state, f, a, b, out);
    case kGSet: return gset_step(state, f, a, out);
    default: return uqueue_step(state, f, a, out);
  }
}

}  // namespace jt_models
