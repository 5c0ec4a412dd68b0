// Per-tower modular matrix product for Hopper (sm_90a):
//   out[t, d, b] = sum_a W[t, d, a] * X[t, a, b]  mod q_t,
// W, X words below 2^31, q_t odd below 2^31, A <= 2^15.
//
// Replaces the TPU kernel mod_matmul_tpu of openfhe_tpu/ops/modmatmul.py
// (pallas_call :138, body _mm_kernel), the two stage products of the 4-step
// NTT (ops/ntt4step.py) and of its sharded form (parallel/ntt_sharded.py).
//
// Two entries:
//   mod_matmul       the int8 tensor cores on byte limbs (below)
//   mod_matmul_simt  the former form: CUDA cores, each output two 64-bit
//                    sums of W times the 16-bit halves of X; its yardstick
//                    on the card, which no wrapper falls back to
//
// What bounds it on an H100: device-memory bytes. At the sharded NTT's
// stage shapes on the main path's Q basis (31 towers, D = A = 256, B = 256
// / L) one call moves 16.3 MB at L = 2 (4.9 us at 3.35 TB/s) for 2.6e8
// multiply-adds of 31-bit words. On the CUDA cores each is a 62-bit
// product and a 64-bit sum, about 6x the byte time at the 32-bit issue
// rate, and the tensor cores multiply no 32-bit integers. They do multiply
// unsigned bytes into exact int32 sums: a word below 2^31 is 4 byte limbs,
// W X = sum_{i,j} 2^(8 (i + j)) W_i X_j, and each of the 16 limb-pair sums
// over A terms is at most 255 * 255 * A < 2^31 for A <= 2^15. The 16
// products are 2 * 16 * D * A * B int8 operations a tower, 4.2 us at the
// card's dense 1,979 T op/s: the bytes stay the bound.
//
// Design (mod_matmul): a block computes a 64 x 32 tile of out (rows d,
// columns b) of one tower with 8 warps, each a 16 x 16 patch (two m16n8
// fragments), walking A in steps of 32, the K of
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32. Each step's W tile [64, 32] and
// X tile [32, 32] are read once from device memory as words, split into 4
// byte planes in the kernel (a 4 x 4 byte transpose by __byte_perm: each
// plane word holds one limb of 4 consecutive a, which is the fragments'
// register layout), and stored in shared memory, W's planes row-major [d,
// a] and X's transposed [b, a] (K contiguous per column), rows padded to 12
// words so that the fragment loads meet no bank conflict. Two stages: the
// words of step c + 1 are loaded into registers before step c's products
// and split into the other stage after them, one barrier a step. Each
// warp keeps the 16 (i, j) sums of its 2 fragments in s32 registers (128),
// exact to A = 2^15. W's planes are split in the kernel, not precomputed:
// the wrapper's signature (w, x, q) is the 4-step NTT's, and W is re-read
// B / 32 times from L2, not from device memory.
// Epilogue, once per output word: the sums are grouped by s = i + j (0-6),
// each group (< 2^33) reduced mod q (reduce_wide), multiplied by 2^(8 s)
// mod q with its Shoup companion (lazy, in [0, 2q)) and summed in 64 bits,
// then the sum reduced once. The per-tower constants (2^(8 s) mod q, their
// companions, the Basis.red64 row of q) come from the wrapper.

#include <cstdint>
#include <cuda_runtime.h>

#include "pconv_core.cuh"     // reduce_wide

namespace {

// ---------------------------------------------------------------------------
// mod_matmul: byte limbs on the int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int kLimbs = 4;
constexpr int kGroups = 2 * kLimbs - 1;        // limb weights s = i + j
constexpr int kConsts = 2 * kGroups + 3;       // pow, pow_sh, red64 row
constexpr int kTcTileD = 64;
constexpr int kTcTileB = 32;
constexpr int kTcTileK = 32;                   // the mma's K
constexpr int kTcWarpsD = kTcTileD / 16;       // warps along d
constexpr int kTcWarpsB = 2;                   // warps along b
constexpr int kTcFrags = kTcTileB / (8 * kTcWarpsB);  // m16n8 a warp
constexpr int kTcThreads = 32 * kTcWarpsD * kTcWarpsB;
constexpr int kKWords = kTcTileK / 4;          // plane words a row (8)
constexpr int kRowWords = kKWords + 4;         // padded: no bank conflicts
constexpr int kWGroups = kTcTileD * kKWords / kTcThreads;  // W's, a thread
static_assert(kWGroups >= 1 && kWGroups * kTcThreads == kTcTileD * kKWords &&
              kTcTileB * kKWords == kTcThreads && kTcFrags >= 1,
              "each thread stages whole groups of 4 words, one of X's");

struct TcStage {
  uint32_t w[kLimbs][kTcTileD][kRowWords];     // W's planes [d][a / 4]
  uint32_t x[kLimbs][kTcTileB][kRowWords];     // X's planes [b][a / 4]
};

// v[0..3] = the words of 4 consecutive a -> p[l] = their limb l, a byte
// each (a's lowest at byte 0).
__device__ __forceinline__ void byte_planes(const uint32_t (&v)[4],
                                            uint32_t (&p)[kLimbs]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  p[0] = __byte_perm(t0, t2, 0x5410);
  p[1] = __byte_perm(t0, t2, 0x7632);
  p[2] = __byte_perm(t1, t3, 0x5410);
  p[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma_u8(int32_t (&c)[4],
                                       const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The words one thread stages from a K step: kWGroups groups of 4
// consecutive a of a W row (group gi = tid + kTcThreads u: row gi / 8,
// words 4 (gi % 8) ..), and 4 consecutive a of one X column (column tid %
// kTcTileB, words 4 (tid / kTcTileB) ..: a warp reads 32 consecutive
// columns of a row). Words outside the matrices read as 0.
struct TcLoad {
  uint32_t w[kWGroups][4];
  uint32_t x[4];
};

__device__ __forceinline__ void tc_load(TcLoad& r,
                                        const uint32_t* __restrict__ wt,
                                        const uint32_t* __restrict__ xt,
                                        int d0, int b0, int a0, int d_dim,
                                        int a_dim, int b_dim, bool w_vec) {
#pragma unroll
  for (int u = 0; u < kWGroups; ++u) {
    const int gi = threadIdx.x + kTcThreads * u;
    const int d = d0 + gi / kKWords, a = a0 + 4 * (gi % kKWords);
    const uint32_t* src = wt + static_cast<size_t>(d) * a_dim + a;
    if (w_vec && d < d_dim && a + 3 < a_dim) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
      r.w[u][0] = v.x;
      r.w[u][1] = v.y;
      r.w[u][2] = v.z;
      r.w[u][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r.w[u][e] = d < d_dim && a + e < a_dim ? __ldg(src + e) : 0u;
    }
  }
  const int b = b0 + threadIdx.x % kTcTileB;
  const int a = a0 + 4 * (threadIdx.x / kTcTileB);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    r.x[e] = b < b_dim && a + e < a_dim
                 ? __ldg(xt + static_cast<size_t>(a + e) * b_dim + b) : 0u;
}

__device__ __forceinline__ void tc_store(TcStage& st, const TcLoad& r) {
  uint32_t p[kLimbs];
#pragma unroll
  for (int u = 0; u < kWGroups; ++u) {
    const int gi = threadIdx.x + kTcThreads * u;
    byte_planes(r.w[u], p);
#pragma unroll
    for (int l = 0; l < kLimbs; ++l)
      st.w[l][gi / kKWords][gi % kKWords] = p[l];
  }
  byte_planes(r.x, p);
#pragma unroll
  for (int l = 0; l < kLimbs; ++l)
    st.x[l][threadIdx.x % kTcTileB][threadIdx.x / kTcTileB] = p[l];
}

__global__ void __launch_bounds__(kTcThreads, 1)
mod_matmul_tc(const uint32_t* __restrict__ w, const uint32_t* __restrict__ x,
              const uint32_t* __restrict__ qs,
              const uint32_t* __restrict__ consts, uint32_t* __restrict__ out,
              int d_dim, int a_dim, int b_dim) {
  __shared__ TcStage stage[2];
  const int t = blockIdx.z;
  const int d0 = blockIdx.y * kTcTileD;
  const int b0 = blockIdx.x * kTcTileB;
  const uint32_t* wt = w + static_cast<size_t>(t) * d_dim * a_dim;
  const uint32_t* xt = x + static_cast<size_t>(t) * a_dim * b_dim;
  const bool w_vec = a_dim % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;      // the fragments' lane split
  const int wd = 16 * (warp % kTcWarpsD);     // the warp's patch in the tile
  const int wb = 8 * kTcFrags * (warp / kTcWarpsD);

  int32_t acc[kLimbs][kLimbs][kTcFrags][4];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i)
#pragma unroll
    for (int j = 0; j < kLimbs; ++j)
#pragma unroll
      for (int f = 0; f < kTcFrags; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][f][e] = 0;

  TcLoad next;
  tc_load(next, wt, xt, d0, b0, 0, d_dim, a_dim, b_dim, w_vec);
  tc_store(stage[0], next);
  __syncthreads();
  const int steps = (a_dim + kTcTileK - 1) / kTcTileK;
  for (int c = 0; c < steps; ++c) {
    if (c + 1 < steps)
      tc_load(next, wt, xt, d0, b0, (c + 1) * kTcTileK, d_dim, a_dim, b_dim,
              w_vec);
    // X's fragments of every limb (16 registers), then W's a limb at a
    // time (4), beside the 128 sums
    const TcStage& st = stage[c & 1];
    uint32_t fb[kLimbs][kTcFrags][2];
#pragma unroll
    for (int l = 0; l < kLimbs; ++l)
#pragma unroll
      for (int f = 0; f < kTcFrags; ++f) {
        fb[l][f][0] = st.x[l][wb + 8 * f + g][tq];
        fb[l][f][1] = st.x[l][wb + 8 * f + g][tq + 4];
      }
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
      const uint32_t fa[4] = {st.w[i][wd + g][tq], st.w[i][wd + g + 8][tq],
                              st.w[i][wd + g][tq + 4],
                              st.w[i][wd + g + 8][tq + 4]};
#pragma unroll
      for (int j = 0; j < kLimbs; ++j)
#pragma unroll
        for (int f = 0; f < kTcFrags; ++f) mma_u8(acc[i][j][f], fa, fb[j][f]);
    }
    if (c + 1 < steps) tc_store(stage[(c + 1) & 1], next);
    __syncthreads();
  }

  // epilogue: output (row g + 8 (e / 2), column 2 tq + e % 2) of fragment f
  const uint32_t* ct = consts + static_cast<size_t>(t) * kConsts;
  const uint32_t q = qs[t];
  const uint32_t r32 = ct[2 * kGroups], r32_sh = ct[2 * kGroups + 1];
  const uint32_t m32 = ct[2 * kGroups + 2];
#pragma unroll
  for (int f = 0; f < kTcFrags; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + wd + g + 8 * (e / 2);
      const int b = b0 + wb + 8 * f + 2 * tq + e % 2;
      uint64_t sum = 0;
#pragma unroll
      for (int s = 0; s < kGroups; ++s) {
        uint64_t grp = 0;
#pragma unroll
        for (int i = 0; i < kLimbs; ++i)
          if (s - i >= 0 && s - i < kLimbs)
            grp += static_cast<uint32_t>(acc[i][s - i][f][e]);
        const uint32_t red = reduce_wide(grp, q, r32, r32_sh, m32);
        sum += red * ct[s] - __umulhi(red, ct[kGroups + s]) * q;
      }
      if (d < d_dim && b < b_dim)
        out[(static_cast<size_t>(t) * d_dim + d) * b_dim + b] =
            reduce_wide(sum, q, r32, r32_sh, m32);
    }
}

// ---------------------------------------------------------------------------
// mod_matmul_simt: the former form, on the CUDA cores
// ---------------------------------------------------------------------------
//
// A GEMM tiling without tensor cores. A block computes a 64 x 64 tile of
// out (rows d, columns b) of one tower, walking A in steps of 32: the W
// tile (stored transposed, padded against bank conflicts) and the X tile
// are staged in shared memory, and each of the 256 threads keeps a 4 x 4
// patch of outputs as two 64-bit sums each in registers (W * x_lo < 2^47
// and W * x_hi < 2^47 for the 16-bit halves of X, exact for up to 2^15
// terms); one reduction per output at the end:
//   out = ((S_hi mod q) * 2^16 + S_lo mod q) mod q.

constexpr int kTileD = 64;
constexpr int kTileB = 64;
constexpr int kTileA = 32;
constexpr int kSide = 16;                   // threads along d and along b
constexpr int kPatch = kTileD / kSide;      // outputs a thread keeps per side
constexpr int kThreads = kSide * kSide;

__global__ void __launch_bounds__(kThreads)
mod_matmul_kernel(const uint32_t* __restrict__ w,
                  const uint32_t* __restrict__ x,
                  const uint32_t* __restrict__ qs, uint32_t* __restrict__ out,
                  int d_dim, int a_dim, int b_dim) {
  __shared__ uint32_t sw[kTileA][kTileD + 1];     // [a][d]
  __shared__ uint32_t sx[kTileA][kTileB];         // [a][b]
  const int t = blockIdx.z;
  const int d0 = blockIdx.y * kTileD;
  const int b0 = blockIdx.x * kTileB;
  const int tx = threadIdx.x % kSide;             // column of the patch
  const int ty = threadIdx.x / kSide;             // row of the patch
  const uint32_t* wt = w + static_cast<size_t>(t) * d_dim * a_dim;
  const uint32_t* xt = x + static_cast<size_t>(t) * a_dim * b_dim;
  uint64_t lo[kPatch][kPatch], hi[kPatch][kPatch];
#pragma unroll
  for (int i = 0; i < kPatch; ++i)
#pragma unroll
    for (int j = 0; j < kPatch; ++j) lo[i][j] = hi[i][j] = 0;

  for (int a0 = 0; a0 < a_dim; a0 += kTileA) {
    for (int i = threadIdx.x; i < kTileD * kTileA; i += kThreads) {
      const int dd = i / kTileA, aa = i % kTileA;
      const int d = d0 + dd, a = a0 + aa;
      sw[aa][dd] = d < d_dim && a < a_dim
                       ? wt[static_cast<size_t>(d) * a_dim + a] : 0u;
    }
    for (int i = threadIdx.x; i < kTileA * kTileB; i += kThreads) {
      const int aa = i / kTileB, bb = i % kTileB;
      const int a = a0 + aa, b = b0 + bb;
      sx[aa][bb] = a < a_dim && b < b_dim
                       ? xt[static_cast<size_t>(a) * b_dim + b] : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int aa = 0; aa < kTileA; ++aa) {
      uint32_t wv[kPatch], xl[kPatch], xh[kPatch];
#pragma unroll
      for (int i = 0; i < kPatch; ++i) wv[i] = sw[aa][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kPatch; ++j) {
        const uint32_t v = sx[aa][tx + kSide * j];
        xl[j] = v & 0xFFFFu;
        xh[j] = v >> 16;
      }
#pragma unroll
      for (int i = 0; i < kPatch; ++i)
#pragma unroll
        for (int j = 0; j < kPatch; ++j) {
          lo[i][j] += static_cast<uint64_t>(wv[i]) * xl[j];
          hi[i][j] += static_cast<uint64_t>(wv[i]) * xh[j];
        }
    }
    __syncthreads();
  }

  const uint64_t q = qs[t];
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const int d = d0 + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kPatch; ++j) {
      const int b = b0 + tx + kSide * j;
      if (d < d_dim && b < b_dim) {
        const uint64_t v = ((hi[i][j] % q) << 16) + lo[i][j] % q;
        out[(static_cast<size_t>(t) * d_dim + d) * b_dim + b] =
            static_cast<uint32_t>(v % q);
      }
    }
  }
}

bool bad_shape(int k, int d_dim, int a_dim, int b_dim, int tile_d) {
  return k < 1 || k > 65535 || d_dim < 1 || a_dim < 1 || a_dim > (1 << 15) ||
         b_dim < 1 || (d_dim + tile_d - 1) / tile_d > 65535;
}

}  // namespace

// w: [k, D, A] words < 2^31; x: [k, A, B] words < 2^31; q: [k] odd moduli
// < 2^31; consts: [k, 17] per tower, 2^(8 s) mod q for s = 0..6, their
// Shoup companions, then the Basis.red64 row of q (2^32 mod q, its
// companion, floor(2^32 / q)); out: [k, D, B]. One launch of the
// tensor-core kernel. Returns cudaGetLastError() after the launch.
extern "C" int mod_matmul(const void* w, const void* x, const void* q,
                          const void* consts, void* out, int k, int d_dim,
                          int a_dim, int b_dim, void* stream) {
  if (bad_shape(k, d_dim, a_dim, b_dim, kTcTileD))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((b_dim + kTcTileB - 1) / kTcTileB,
                  (d_dim + kTcTileD - 1) / kTcTileD, k);
  mod_matmul_tc<<<grid, kTcThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(x),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(consts),
      static_cast<uint32_t*>(out), d_dim, a_dim, b_dim);
  return static_cast<int>(cudaGetLastError());
}

// The arguments of mod_matmul without consts; one launch of the former
// CUDA-core kernel.
extern "C" int mod_matmul_simt(const void* w, const void* x, const void* q,
                               void* out, int k, int d_dim, int a_dim,
                               int b_dim, void* stream) {
  if (bad_shape(k, d_dim, a_dim, b_dim, kTileD))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((b_dim + kTileB - 1) / kTileB, (d_dim + kTileD - 1) / kTileD,
                  k);
  mod_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(x),
      static_cast<const uint32_t*>(q), static_cast<uint32_t*>(out), d_dim,
      a_dim, b_dim);
  return static_cast<int>(cudaGetLastError());
}
