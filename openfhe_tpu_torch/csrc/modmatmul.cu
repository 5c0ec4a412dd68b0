// Per-tower modular matrix product for Hopper (sm_90a):
//   out[t, d, b] = sum_a W[t, d, a] * X[t, a, b]  mod q_t.
//
// Replaces the TPU kernel mod_matmul_tpu of openfhe_tpu/ops/modmatmul.py
// (pallas_call :138, body _mm_kernel), the two stage products of the 4-step
// NTT (ops/ntt4step.py) and of its sharded form (parallel/ntt_sharded.py).
// The TPU kernel splits W and X into signed int8 limbs for the MXU, sums
// the 16 limb products in int32 and recombines them with Shoup multiplies
// by 2^(8 * weight). Here W and X stay 32-bit words: X is split into its
// 16-bit halves, so W * x_lo < 2^47 and W * x_hi < 2^47 and each half's
// 64-bit sum stays exact for up to 2^15 terms (W < 2^31 < 2^32); one
// reduction per output at the end:
//   out = ((S_hi mod q) * 2^16 + S_lo mod q) mod q.
//
// What bounds it on an H100: operations, the first of the port's kernels so
// bound. At the sharded NTT's stage shapes on the main path's Q basis (31
// towers, D = A = 256, B = 256 / L) one call is 31 * 256 * 256 * 256 / L
// multiply-adds (2.6e8 at L = 2), each at least a 62-bit product and a
// 64-bit sum, against 16 MB of words: about 3x longer at the card's 32-bit
// integer rate than at its memory rate. The tensor cores multiply no
// 32-bit integers; an int8-limb formulation on them (the MXU's scheme) is
// a later design.
//
// Design: a GEMM tiling without tensor cores. A block computes a 64 x 64
// tile of out (rows d, columns b) of one tower, walking A in steps of 32:
// the W tile (stored transposed, padded against bank conflicts) and the X
// tile are staged in shared memory, and each of the 256 threads keeps a
// 4 x 4 patch of outputs as two 64-bit sums each in registers. Loads are
// coalesced along the rows of W and X.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

// w: [k, D, A] words < 2^31; x: [k, A, B] words; q: [k] odd moduli < 2^31;
// out: [k, D, B]. Returns cudaGetLastError() after the launch.
extern "C" int mod_matmul(const void* w, const void* x, const void* q,
                          void* out, int k, int d_dim, int a_dim, int b_dim,
                          void* stream) {
  if (k < 1 || k > 65535 || d_dim < 1 || a_dim < 1 || a_dim > (1 << 15) ||
      b_dim < 1 || (d_dim + kTileD - 1) / kTileD > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((b_dim + kTileB - 1) / kTileB, (d_dim + kTileD - 1) / kTileD,
                  k);
  mod_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(x),
      static_cast<const uint32_t*>(q), static_cast<uint32_t*>(out), d_dim,
      a_dim, b_dim);
  return static_cast<int>(cudaGetLastError());
}
