// K4: the Elle classifier and the transitive closure, for Hopper (sm_90a).
//
// Replaces the JAX package's device programs jepsen_tpu/checker/elle/
// kernels.py:175 (`_flags_batch_fn`: a jax.jit of a vmap whose three
// closures are each a lax.scan of squarings with a column-checksum
// residue, the anomaly flags read off diagonals) and :698 (`_closure_fn`,
// behind `transitive_closure` at :716). Neither is a Pallas kernel: on the
// TPU each call is one XLA program. Their plain PyTorch versions stay in
// jepsen_tpu_torch/checker/elle/kernels.py (`_closure`, `_flags_batch` and
// `transitive_closure`'s loop).
//
// What a classifier call computes, for each (e x e) 0/1 SCC block of a
// (B, e, e) bucket: the closures of ww, ww|wr and ww|wr|rw, each by
// `steps` squarings A <- A | (A.A > 0); G0 = a diagonal of the first,
// G1c of the second; ec = the second | I, G-single = a diagonal of
// (ec.rw > 0).ec; cr = the third | I, p = rw.cr > 0, G2-item = some
// i != j with p[i,j] and p[j,i]. Each squaring's residue: with
// P = A.A in integer path counts, lhs[j] = sum_i P[i,j] against
// rhs[j] = sum_k colsum(A)[k] A[k,j], an independent path with no
// product; the block's residue is the sum over squarings and columns of
// |lhs - rhs|, int64, 0 unless a count was corrupted. The closure step
// takes A | (P > 0) from the same counts the residue sums, so the residue
// guards the values the closure uses.
//
// Two kernels.
//
// K4-small (`elle_small`): a whole classifier bucket in one launch, for
// e up to 256. One team of threads an SCC block keeps everything on chip,
// bit-packed 32 nodes a word (W = e / 32 words a row, e rounded up to
// E = 32 W; zero padding is neutral: no path, no count, no flag): four
// E x W bit matrices in shared memory (rows R, columns C and two scratch
// ones: 4 E W 4 bytes, 32 KB at E = 256). E = 512 fits (128 KB) but its
// one team a block lost to K4-product's chain on an H100 (PERF.md), so the
// line is 256. A
// thread stands for a column j and one group of E / G rows. A squaring
// holds column j in registers and walks its rows i, reading row i from
// shared memory (one address a warp: a broadcast): P[i,j] =
// sum_w popc(R[i][w] & C[j][w]); lhs sums P and rhs sums colsum(A)[i]
// where A[i,j] (the column sums come from the columns' popcounts); the
// new bit A[i,j] | P > 0 goes to the new column in registers and, by a
// ballot over the warp's 32 columns, to word j / 32 of the new row i.
// Groups meet at a team barrier: two a squaring. Teams: a warp an SCC
// block (four to a block, barriers __syncwarp) for e <= 32; one block of
// E x G threads above (G = 2, 4, 4 at E = 64, 128, 256).
// The flag products reuse the same loop without counts; only the
// diagonal of (ec.rw > 0).ec is formed (row i of the first product
// against column i of ec).
// What bounds it: operations. A squaring is E^2 W word ANDs and
// popcounts (popc issues at a quarter of the integer rate), 24 squarings
// at e = 256; the card's bound for the same work on the tensor cores is
// far below (chip_smoke.elle_bound). At the buckets the classifier
// meets (e = 8-16 through an Elle run) the call was launch-bound as a
// chain of about ten torch launches a squaring; here it is one launch.
//
// K4-product (`elle_product`): one tiled product Out = (Add + L.R > 0) of
// bf16 0/1 matrices, batched, for the buckets above SMALL_MAX_E and for
// `transitive_closure` (a squaring of the whole matrix, or of this
// rank's row block (m x e).(e x e) on a mesh). Every operand is 0 or 1,
// exact in bf16, and every count is an integer <= e <= 2^24, exact in the
// float32 accumulators: so the tensor cores give the exact counts.
// mma.sync m16n8k16 (bf16 in, float32 accumulate) on 128 x 128 tiles of
// a block of 8 warps (64 x 32 a warp), k in slices of 32 staged in a
// three-deep cp.async ring with ldmatrix (transposed for the right
// operand) from padded rows. The epilogue is fused: it writes the next A
// (bf16 0/1, the identity ORed in on a closure's last squaring where the
// flags need it), raises the caller's flag where a diagonal entry is set,
// and atomically adds each tile's column sums of the integer counts (lhs)
// and of the written A (the next squaring's colsum) into int32 columns.
// Three small helpers beside it: `elle_prep` stages a closure's input
// (the OR of up to three float32 stacks, as bf16, with its column sums),
// `elle_rhs` forms rhs = colsum(A).A column by column and adds
// sum_j |lhs - rhs| to the block's residue, and `elle_pair` tests p and
// its transpose tile by tile for G2-item.
// What bounds it: operations on the tensor cores at e >= 1,024 (2 e^3 a
// product); wgmma and TMA, which reach the full bf16 rate, are later
// work.
//
// The C entry points take raw device pointers and the CUDA stream and
// return the CUDA error of the launch, so a refused launch is reported to
// the caller (jepsen_tpu_torch/checker/elle/k4.py), which raises. No
// kernel synchronises or allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// -- K4-small -----------------------------------------------------------------

constexpr int kWarpTeams = 4;     // SCC blocks a block when a team is a warp
constexpr int kSmallMaxE = 256;   // past it K4-product's chain is faster

struct Small {
  const float* ww;
  const float* wr;
  const float* rw;
  int32_t* flags;               // (B, 4): G0, G1c, G-single, G2-item
  long long* res;               // (B,)
  int B, e, steps;
};

template <int W, int G>
struct Cfg {
  static constexpr int E = 32 * W;          // nodes, padded
  static constexpr int T = E * G;           // threads a team
  static constexpr int RG = E / G;          // rows a group (a multiple of 32)
  static constexpr int RW = RG / 32;        // row words a group
  static constexpr int TEAMS = T == 32 ? kWarpTeams : 1;
  static constexpr int THREADS = T * TEAMS;
  static constexpr int MAT = E * W;         // words a bit matrix
  // R, C, X, Y; colsums, per-column lhs - rhs; flags; residue (8 bytes)
  static constexpr int WORDS = 4 * MAT + 2 * E + 8;
  static_assert(RG % 32 == 0, "a group's rows fill whole words");
};

template <int T>
__device__ __forceinline__ void team_sync() {
  if constexpr (T == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

struct Team {
  uint32_t* R;                  // rows of the current matrix
  uint32_t* C;                  // its columns
  uint32_t* X;                  // scratch: the next rows, a product's rows
  uint32_t* Y;                  // scratch
  int* cs;                      // column sums of the current matrix
  int* acc;                     // lhs - rhs of each column
  int* flg;                     // the block's four flags
  unsigned long long* res;      // the block's residue
  int j, grp, r0, lane, q;      // column, row group, first row, lane, word
};

// A <- the OR of the stacks in mask (1 ww, 2 wr, 4 rw) of block b, zero
// padded to E: rows (by ballot) into rows, and each column's words of this
// group's rows into cols (either may be null).
template <int W, int G>
__device__ void load_bits(const Small& a, int b, int mask, const Team& t,
                          uint32_t* rows, uint32_t* cols) {
  using K = Cfg<W, G>;
  const size_t base = (size_t)b * a.e * a.e;
  for (int k = 0; k < K::RW; ++k) {
    const int wk = (t.r0 >> 5) + k;
    uint32_t cw = 0;
    for (int bb = 0; bb < 32; ++bb) {
      const int i = wk * 32 + bb;
      bool bit = false;
      if (i < a.e && t.j < a.e) {
        const size_t o = base + (size_t)i * a.e + t.j;
        bit = ((mask & 1) && a.ww[o] != 0.0f) ||
              ((mask & 2) && a.wr[o] != 0.0f) ||
              ((mask & 4) && a.rw[o] != 0.0f);
      }
      const uint32_t word = __ballot_sync(0xffffffffu, bit);
      if (rows != nullptr && t.lane == 0) rows[i * W + t.q] = word;
      cw |= (uint32_t)bit << bb;
    }
    if (cols != nullptr) cols[t.j * W + wk] = cw;
  }
}

// One squaring A <- A | (A.A > 0) of the matrix in (R, C): the new rows
// go to X (the caller swaps R and X), the new columns over C. Returns this
// thread's part of the residue: |lhs[j] - rhs[j]| on group 0, else 0.
template <int W, int G>
__device__ long long square(const Team& t, const uint32_t* R, uint32_t* X) {
  using K = Cfg<W, G>;
  uint32_t col[W];
#pragma unroll
  for (int w = 0; w < W; ++w) col[w] = t.C[t.j * W + w];
  if (t.grp == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) s += __popc(col[w]);
    t.cs[t.j] = s;
    t.acc[t.j] = 0;
  }
  team_sync<K::T>();
  int d = 0;                    // lhs - rhs over this group's rows
  for (int k = 0; k < K::RW; ++k) {
    const int wk = (t.r0 >> 5) + k;
    const uint32_t aw = t.C[t.j * W + wk];   // A[i, j] of these 32 rows
    uint32_t pw = 0;
    for (int bb = 0; bb < 32; ++bb) {
      const int i = wk * 32 + bb;
      const uint32_t* ri = R + i * W;
      int p = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) p += __popc(ri[w] & col[w]);
      d += p;
      const bool a_ij = (aw >> bb) & 1u;
      if (a_ij) d -= t.cs[i];
      const uint32_t word = __ballot_sync(0xffffffffu, a_ij || p > 0);
      if (t.lane == 0) X[i * W + t.q] = word;
      pw |= (uint32_t)(p > 0) << bb;
    }
    t.C[t.j * W + wk] = aw | pw;      // only this thread reads this word
  }
  atomicAdd(&t.acc[t.j], d);
  team_sync<K::T>();
  if (t.grp != 0) return 0;
  const int v = t.acc[t.j];
  return v < 0 ? -v : v;
}

// Out = (L.M > 0) from the rows of L (Lr) and the columns of M (Mc): rows
// into Or (by ballot), this group's words of each column into Oc.
template <int W, int G>
__device__ void bool_product(const Team& t, const uint32_t* Lr,
                             const uint32_t* Mc, uint32_t* Or, uint32_t* Oc) {
  using K = Cfg<W, G>;
  uint32_t col[W];
#pragma unroll
  for (int w = 0; w < W; ++w) col[w] = Mc[t.j * W + w];
  for (int k = 0; k < K::RW; ++k) {
    const int wk = (t.r0 >> 5) + k;
    uint32_t pw = 0;
    for (int bb = 0; bb < 32; ++bb) {
      const int i = wk * 32 + bb;
      const uint32_t* ri = Lr + i * W;
      uint32_t any = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) any |= ri[w] & col[w];
      const uint32_t word = __ballot_sync(0xffffffffu, any != 0);
      if (Or != nullptr && t.lane == 0) Or[i * W + t.q] = word;
      pw |= (uint32_t)(any != 0) << bb;
    }
    if (Oc != nullptr) Oc[t.j * W + wk] = pw;
  }
}

// bit j of word j / 32 of row (or column) j
__device__ __forceinline__ uint32_t diag_bit(const uint32_t* M, int W, int j) {
  return (M[j * W + (j >> 5)] >> (j & 31)) & 1u;
}

template <int W, int G>
__global__ void __launch_bounds__(Cfg<W, G>::THREADS)
    elle_small(const Small a) {
  using K = Cfg<W, G>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int team = threadIdx.x / K::T;
  const int tt = threadIdx.x % K::T;
  const int b = blockIdx.x * K::TEAMS + team;
  if (b >= a.B) return;         // a whole team: a warp, or the block
  uint32_t* base = smem + team * K::WORDS;
  Team t;
  t.R = base;
  t.C = base + K::MAT;
  t.X = base + 2 * K::MAT;
  t.Y = base + 3 * K::MAT;
  t.cs = reinterpret_cast<int*>(base + 4 * K::MAT);
  t.acc = t.cs + K::E;
  t.flg = t.acc + K::E;
  t.res = reinterpret_cast<unsigned long long*>(t.flg + 4);
  t.j = tt % K::E;
  t.grp = tt / K::E;
  t.r0 = t.grp * K::RG;
  t.lane = tt & 31;
  t.q = t.j >> 5;
  const bool lead = t.grp == 0 && t.j < a.e;   // owns column j's checks
  if (tt < 4) t.flg[tt] = 0;
  if (tt == 0) *t.res = 0;
  long long res = 0;

  // the closure of ww, then of ww | wr, then of ww | wr | rw
  for (int c = 0; c < 3; ++c) {
    const int mask = c == 0 ? 1 : c == 1 ? 3 : 7;
    team_sync<K::T>();          // the last readers of R and C are done
    load_bits<W, G>(a, b, mask, t, t.R, t.C);
    team_sync<K::T>();
    for (int s = 0; s < a.steps; ++s) {
      res += square<W, G>(t, t.R, t.X);
      uint32_t* r = t.R;
      t.R = t.X;
      t.X = r;
    }
    // the squaring ended at a barrier: R and C are the closure
    if (c < 2 && lead && diag_bit(t.C, W, t.j)) atomicOr(&t.flg[c], 1);
    team_sync<K::T>();
    if (c == 0) continue;
    if (lead) {                 // ec = c_wwr | I, cr = c_full | I
      t.C[t.j * W + (t.j >> 5)] |= 1u << (t.j & 31);
      t.R[t.j * W + (t.j >> 5)] |= 1u << (t.j & 31);
    }
    team_sync<K::T>();
    if (c == 1) {
      // G-single: a diagonal of h1 = (ec.rw > 0).ec
      load_bits<W, G>(a, b, 4, t, nullptr, t.Y);        // rw's columns
      team_sync<K::T>();
      bool_product<W, G>(t, t.R, t.Y, t.X, nullptr);    // rows of ec.rw
      team_sync<K::T>();
      if (lead) {
        uint32_t hit = 0;
        for (int w = 0; w < W; ++w) hit |= t.X[t.j * W + w] & t.C[t.j * W + w];
        if (hit) atomicOr(&t.flg[2], 1);
      }
    } else {
      // G2-item: p = rw.cr > 0, some i != j with p[i,j] and p[j,i]
      load_bits<W, G>(a, b, 4, t, t.X, nullptr);        // rw's rows
      team_sync<K::T>();
      bool_product<W, G>(t, t.X, t.C, t.Y, t.R);        // p: rows, columns
      team_sync<K::T>();
      if (lead) {
        uint32_t hit = 0;
        for (int w = 0; w < W; ++w) {
          uint32_t x = t.Y[t.j * W + w] & t.R[t.j * W + w];
          if (w == (t.j >> 5)) x &= ~(1u << (t.j & 31));
          hit |= x;
        }
        if (hit) atomicOr(&t.flg[3], 1);
      }
    }
  }

  // the block's residue: over the team's lanes, then its warps
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) res += __shfl_down_sync(0xffffffffu, res, o);
  if (t.lane == 0 && res != 0) atomicAdd(t.res, (unsigned long long)res);
  team_sync<K::T>();
  if (tt < 4) a.flags[(size_t)b * 4 + tt] = t.flg[tt];
  if (tt == 0) a.res[b] = (long long)*t.res;
}

template <int W, int G>
int launch_small(const Small& a, cudaStream_t s) {
  using K = Cfg<W, G>;
  const auto kernel = &elle_small<W, G>;
  const size_t smem = (size_t)K::TEAMS * K::WORDS * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((a.B + K::TEAMS - 1) / K::TEAMS);
  kernel<<<blocks, K::THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// -- K4-product ---------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kPad = 8;
constexpr int kAS = kBK + kPad;          // elements a staged row of L
constexpr int kBS = kBN + kPad;          // elements a staged row of R
constexpr int kProdThreads = 256;        // 8 warps: 2 (rows) x 4 (columns)
constexpr size_t kProdSmem =
    (size_t)kStages * (kBM * kAS + kBK * kBS) * sizeof(uint16_t);
constexpr uint16_t kOne = 0x3f80;       // bf16 1.0

struct Prod {
  const uint16_t* L;            // (M, K) bf16 0/1, row stride ldL
  const uint16_t* R;            // (K, N)
  const uint16_t* add;          // (M, N) or null
  uint16_t* out;                // (M, N) or null
  long long ldL, ldR, ldAdd, ldOut;
  long long sL, sR, sAdd, sOut; // batch strides (elements)
  int* lhs;                     // (B, N) column sums of the counts, or null
  int* csum;                    // (B, N) column sums of out
  long long sStat;
  int32_t* flags;               // (B, 4), with flag >= 0
  int flag, eye;
  int M, N, K;
};

// Every kernel here runs on a one-dimensional grid of B Y X blocks, block
// t standing for tile (x, y) of batch entry b: the order an (X, Y, B) grid
// runs in (x fastest, one entry's tiles together), without the 65,535 its
// y and z extents stop at (a bucket's B may pass it).
struct Tile {
  int b, y, x;
};

__device__ __forceinline__ Tile tile_of(int X, int Y) {
  const int t = blockIdx.x;
  return {t / (X * Y), (t / X) % Y, t % X};
}

__host__ __forceinline__ bool grid_fits(long long B, long long X,
                                        long long Y) {
  return B * X * Y <= 0x7fffffffLL;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tiles (ceil(N / kBN), ceil(M / kBM)) a batch entry.
__global__ void __launch_bounds__(kProdThreads) elle_product(const Prod a) {
  extern __shared__ __align__(16) uint16_t psm[];
  uint16_t* As = psm;                               // [kStages][kBM][kAS]
  uint16_t* Bs = psm + kStages * kBM * kAS;         // [kStages][kBK][kBS]
  const Tile tl = tile_of((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM);
  const int b = tl.b;
  const int m0 = tl.y * kBM, n0 = tl.x * kBN;
  const uint16_t* L = a.L + (size_t)b * a.sL;
  const uint16_t* R = a.R + (size_t)b * a.sR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int ktiles = (a.K + kBK - 1) / kBK;

  auto stage = [&](int st, int kt) {
    const int k0 = kt * kBK;
    uint16_t* as = As + st * kBM * kAS;
    uint16_t* bs = Bs + st * kBK * kBS;
    for (int c = tid; c < kBM * kBK / 8; c += kProdThreads) {
      const int r = c >> 2, kc = (c & 3) * 8;
      const bool ok = m0 + r < a.M && k0 + kc < a.K;
      cp_async16(as + r * kAS + kc,
                 ok ? L + (size_t)(m0 + r) * a.ldL + k0 + kc : L, ok);
    }
    for (int c = tid; c < kBK * kBN / 8; c += kProdThreads) {
      const int r = c >> 4, nc = (c & 15) * 8;
      const bool ok = k0 + r < a.K && n0 + nc < a.N;
      cp_async16(bs + r * kBS + nc,
                 ok ? R + (size_t)(k0 + r) * a.ldR + n0 + nc : R, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][ni][x] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // tile kt landed; tile kt - 1 is consumed
    const int nk = kt + kStages - 1;
    if (nk < ktiles) stage(nk % kStages, nk);
    cp_async_commit();
    const uint16_t* as = As + (kt % kStages) * kBM * kAS;
    const uint16_t* bs = Bs + (kt % kStages) * kBK * kBS;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        ldsm_x4(af[mi], as + r * kAS + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int q = lane >> 3;
        const int kr = kk + (q & 1) * 8 + (lane & 7);
        const int nc = wn * 32 + np * 16 + (q >> 1) * 8;
        uint32_t t4[4];
        ldsm_x4_t(t4, bs + kr * kBS + nc);
        bf[2 * np][0] = t4[0];
        bf[2 * np][1] = t4[1];
        bf[2 * np + 1][0] = t4[2];
        bf[2 * np + 1][1] = t4[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();

  // the epilogue: out = (add + counts > 0), its diagonal, column sums
  const uint16_t* add = a.add ? a.add + (size_t)b * a.sAdd : nullptr;
  uint16_t* out = a.out ? a.out + (size_t)b * a.sOut : nullptr;
  bool diag = false;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;   // and col + 1
    int lp0 = 0, lp1 = 0, cv0 = 0, cv1 = 0;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + h * 8;
        if (row >= a.M || col >= a.N) continue;   // N is a multiple of 8
        const float p0 = acc[mi][ni][2 * h], p1 = acc[mi][ni][2 * h + 1];
        uint32_t a2 = 0;
        if (add != nullptr) {
          a2 = *reinterpret_cast<const uint32_t*>(
              add + (size_t)row * a.ldAdd + col);
        }
        bool v0 = p0 > 0.0f || (a2 & 0x7fffu) != 0;
        bool v1 = p1 > 0.0f || (a2 & 0x7fff0000u) != 0;
        diag |= (row == col && v0) || (row == col + 1 && v1);
        if (a.eye) {
          v0 |= row == col;
          v1 |= row == col + 1;
        }
        lp0 += (int)p0;
        lp1 += (int)p1;
        cv0 += v0;
        cv1 += v1;
        if (out != nullptr) {
          *reinterpret_cast<uint32_t*>(out + (size_t)row * a.ldOut + col) =
              (v0 ? (uint32_t)kOne : 0u) | (v1 ? (uint32_t)kOne << 16 : 0u);
        }
      }
    }
    if (a.lhs != nullptr) {
      // lanes with the same lane & 3 hold the same two columns
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        lp0 += __shfl_xor_sync(0xffffffffu, lp0, o);
        lp1 += __shfl_xor_sync(0xffffffffu, lp1, o);
        cv0 += __shfl_xor_sync(0xffffffffu, cv0, o);
        cv1 += __shfl_xor_sync(0xffffffffu, cv1, o);
      }
      if (lane < 4 && col < a.N) {
        int* lhs = a.lhs + (size_t)b * a.sStat + col;
        int* cs = a.csum + (size_t)b * a.sStat + col;
        if (lp0) atomicAdd(lhs, lp0);
        if (lp1) atomicAdd(lhs + 1, lp1);
        if (cv0) atomicAdd(cs, cv0);
        if (cv1) atomicAdd(cs + 1, cv1);
      }
    }
  }
  if (a.flag >= 0 && __any_sync(0xffffffffu, diag) && lane == 0) {
    atomicOr(a.flags + (size_t)b * 4 + a.flag, 1);
  }
}


// -- the helpers --------------------------------------------------------------

constexpr int kPrepRows = 64;

// out = the OR of the float32 stacks in mask as bf16 0/1; csum += the
// column sums of out (when not null). Tiles (ceil(e/256), ceil(e/64)) an
// entry.
__global__ void elle_prep(const float* ww, const float* wr, const float* rw,
                          int mask, uint16_t* out, int* csum, int e) {
  const Tile tl = tile_of((e + 255) / 256, (e + kPrepRows - 1) / kPrepRows);
  const int b = tl.b;
  const int j = tl.x * 256 + threadIdx.x;
  if (j >= e) return;
  const int i0 = tl.y * kPrepRows;
  const int i1 = i0 + kPrepRows < e ? i0 + kPrepRows : e;
  const size_t base = (size_t)b * e * e;
  int n = 0;
  for (int i = i0; i < i1; ++i) {
    const size_t o = base + (size_t)i * e + j;
    const bool bit = ((mask & 1) && ww[o] != 0.0f) ||
                     ((mask & 2) && wr[o] != 0.0f) ||
                     ((mask & 4) && rw[o] != 0.0f);
    out[o] = bit ? kOne : (uint16_t)0;
    n += bit;
  }
  if (csum != nullptr && n) atomicAdd(csum + (size_t)b * e + j, n);
}

// rhs[j] = sum_k cs[k] A[k,j]; res[b] += sum_j |lhs[j] - rhs[j]|. Tiles
// (ceil(e/256), 1) an entry, a thread a column.
__global__ void elle_rhs(const uint16_t* A, const int* cs, const int* lhs,
                         unsigned long long* res, int e) {
  __shared__ unsigned long long part[8];
  const Tile tl = tile_of((e + 255) / 256, 1);
  const int b = tl.b;
  const int j = tl.x * 256 + threadIdx.x;
  long long d = 0;
  if (j < e) {
    const uint16_t* col = A + (size_t)b * e * e + j;
    const int* c = cs + (size_t)b * e;
    long long r = 0;
#pragma unroll 8
    for (int k = 0; k < e; ++k) {
      if (col[(size_t)k * e] & 0x7fffu) r += c[k];
    }
    d = (long long)lhs[(size_t)b * e + j] - r;
    d = d < 0 ? -d : d;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_down_sync(0xffffffffu, d, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = (unsigned long long)d;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < 8; ++w) s += part[w];
    if (s) atomicAdd(res + b, s);
  }
}

// flags[b, flag] |= some i != j with p[i,j] and p[j,i]. Tiles
// (ceil(e/32), ceil(e/32)) an entry, block (32, 8): tile (ti, tj) against
// the transpose of tile (tj, ti).
__global__ void elle_pair(const uint16_t* p, int32_t* flags, int flag, int e) {
  __shared__ uint16_t t1[32][33], t2[32][33];
  const Tile tl = tile_of((e + 31) / 32, (e + 31) / 32);
  const int b = tl.b;
  const int ti = tl.y * 32, tj = tl.x * 32;
  const uint16_t* P = p + (size_t)b * e * e;
  const int x = threadIdx.x;
  for (int r = threadIdx.y; r < 32; r += 8) {
    t1[r][x] = (ti + r < e && tj + x < e) ? P[(size_t)(ti + r) * e + tj + x]
                                          : (uint16_t)0;
    t2[r][x] = (tj + r < e && ti + x < e) ? P[(size_t)(tj + r) * e + ti + x]
                                          : (uint16_t)0;
  }
  __syncthreads();
  int hit = 0;
  for (int r = threadIdx.y; r < 32; r += 8) {
    // (i, j) = (ti + r, tj + x): p[i,j] = t1[r][x], p[j,i] = t2[x][r]
    if (ti + r != tj + x && (t1[r][x] & 0x7fffu) && (t2[x][r] & 0x7fffu)) {
      hit = 1;
    }
  }
  if (__syncthreads_or(hit) && x == 0 && threadIdx.y == 0) {
    atomicOr(flags + (size_t)b * 4 + flag, 1);
  }
}

}  // namespace

// Classify a (B, e, e) bucket in one launch: ww, wr, rw float32 0/1,
// contiguous; flags (B, 4) int32 and res (B,) int64 written whole.
extern "C" int jt_elle_small(const void* ww, const void* wr, const void* rw,
                             void* flags, void* res, int B, int e, int steps,
                             void* stream) {
  if (B <= 0 || e <= 0 || e > kSmallMaxE || steps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Small a;
  a.ww = static_cast<const float*>(ww);
  a.wr = static_cast<const float*>(wr);
  a.rw = static_cast<const float*>(rw);
  a.flags = static_cast<int32_t*>(flags);
  a.res = static_cast<long long*>(res);
  a.B = B;
  a.e = e;
  a.steps = steps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e <= 32) return launch_small<1, 1>(a, s);
  if (e <= 64) return launch_small<2, 2>(a, s);
  if (e <= 128) return launch_small<4, 4>(a, s);
  return launch_small<8, 4>(a, s);
}

// out = (add + L.R > 0) over a batch of B: L (M, K), R (K, N), add and
// out (M, N), bf16 0/1 with the given row and batch strides (elements),
// K, N and every row stride multiples of 8, pointers 16-byte aligned;
// add, out, lhs (with csum) may be null. lhs/csum (B, N) int32 gain the
// column sums of the counts and of out; flag >= 0 ORs 1 into flags[b,
// flag] where a diagonal entry of out (before the identity) is set; eye
// ORs the identity into out.
extern "C" int jt_elle_product(const void* L, long long ldL, long long sL,
                               const void* R, long long ldR, long long sR,
                               const void* add, long long ldAdd,
                               long long sAdd, void* out, long long ldOut,
                               long long sOut, void* lhs, void* csum,
                               long long sStat, void* flags, int flag,
                               int eye, int M, int N, int K, int B,
                               void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || K <= 0 ||
      (N & 7) || (K & 7) || (ldL & 7) || (ldR & 7) ||
      (add != nullptr && (ldAdd & 7)) || (out != nullptr && (ldOut & 7)) ||
      (flag >= 0 && (flag > 3 || flags == nullptr)) ||
      (lhs != nullptr) != (csum != nullptr) ||
      !grid_fits(B, (N + kBN - 1) / kBN, (M + kBM - 1) / kBM)) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)L | (uintptr_t)R | (uintptr_t)add | (uintptr_t)out) & 15u) {
    return (int)cudaErrorMisalignedAddress;
  }
  Prod a;
  a.L = static_cast<const uint16_t*>(L);
  a.R = static_cast<const uint16_t*>(R);
  a.add = static_cast<const uint16_t*>(add);
  a.out = static_cast<uint16_t*>(out);
  a.ldL = ldL;
  a.ldR = ldR;
  a.ldAdd = ldAdd;
  a.ldOut = ldOut;
  a.sL = sL;
  a.sR = sR;
  a.sAdd = sAdd;
  a.sOut = sOut;
  a.lhs = static_cast<int*>(lhs);
  a.csum = static_cast<int*>(csum);
  a.sStat = sStat;
  a.flags = static_cast<int32_t*>(flags);
  a.flag = flag;
  a.eye = eye ? 1 : 0;
  a.M = M;
  a.N = N;
  a.K = K;
  const cudaError_t err = cudaFuncSetAttribute(
      elle_product, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kProdSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      (unsigned)B * ((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
  elle_product<<<grid, kProdThreads, kProdSmem,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// out (B, e, e) bf16 = the OR of the float32 stacks in mask (1 ww, 2 wr,
// 4 rw; the unused may be null); csum (B, e) int32, zeroed by the caller,
// gains its column sums when not null.
extern "C" int jt_elle_prep(const void* ww, const void* wr, const void* rw,
                            int mask, void* out, void* csum, int e, int B,
                            void* stream) {
  if (B <= 0 || e <= 0 || mask <= 0 || mask > 7 ||
      !grid_fits(B, (e + 255) / 256, (e + kPrepRows - 1) / kPrepRows) ||
      ((mask & 1) && ww == nullptr) || ((mask & 2) && wr == nullptr) ||
      ((mask & 4) && rw == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid =
      (unsigned)B * ((e + 255) / 256) * ((e + kPrepRows - 1) / kPrepRows);
  elle_prep<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ww), static_cast<const float*>(wr),
      static_cast<const float*>(rw), mask, static_cast<uint16_t*>(out),
      static_cast<int*>(csum), e);
  return (int)cudaGetLastError();
}

// res (B,) int64 += sum_j |lhs[b, j] - sum_k cs[b, k] A[b, k, j]|.
extern "C" int jt_elle_rhs(const void* A, const void* cs, const void* lhs,
                           void* res, int e, int B, void* stream) {
  if (B <= 0 || e <= 0 || !grid_fits(B, (e + 255) / 256, 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)B * ((e + 255) / 256);
  elle_rhs<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(A), static_cast<const int*>(cs),
      static_cast<const int*>(lhs), static_cast<unsigned long long*>(res), e);
  return (int)cudaGetLastError();
}

// flags[b, flag] |= some i != j with p[b, i, j] and p[b, j, i].
extern "C" int jt_elle_pair(const void* p, void* flags, int flag, int e,
                            int B, void* stream) {
  if (B <= 0 || e <= 0 || flag < 0 || flag > 3 ||
      !grid_fits(B, (e + 31) / 32, (e + 31) / 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)B * ((e + 31) / 32) * ((e + 31) / 32);
  elle_pair<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(p), static_cast<int32_t*>(flags), flag, e);
  return (int)cudaGetLastError();
}

extern "C" const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
