// The lazy RNS base conversion, shared by ks_fused.cu (K2 over the
// digits read in place, K45's P -> Q_l conversion), sharded.cu (kernel n:
// K2 onto one shard's rows) and rowmod.cu (kernel k, one weight table for
// the whole batch):
//   out[b, j, n] = sum_{i < rows_b} y[b a_dim + i, n] * w_b[i, j] mod d_j.
// See pconv's comment below for the design, and reduce_wide, with which it
// (and ks_fused.cu's tensor products) reduces a 64-bit word. Each
// translation unit that includes this header gets its own resident-blocks
// cache (pconv_launch).

#pragma once

#include "ntt_cluster.cuh"     // csub, add_q, mul_shoup_q

namespace {

// x mod q for any 64-bit x = hi 2^32 + lo, q < 2^31: hi * (2^32 mod q) by
// a Shoup multiply (exact for any hi < 2^32) and lo by a Barrett step with
// m32 = floor(2^32 / q), each in [0, 2q) and then canonical, and their sum.
// r32, r32_sh, m32: a row of Basis.red64, computed on the host.
__device__ __forceinline__ uint32_t reduce_wide(uint64_t x, uint32_t q,
                                                uint32_t r32, uint32_t r32_sh,
                                                uint32_t m32) {
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  const uint32_t lo = static_cast<uint32_t>(x);
  return add_q(mul_shoup_q(hi, r32, r32_sh, q),
               csub(lo - __umulhi(lo, m32) * q, q), q);
}

// The first COLS of r0 .. r3 at p (COLS 4 and 2: one 16- or 8-byte store).
template <int COLS>
__device__ __forceinline__ void store_cols(uint32_t* p, uint32_t r0,
                                           uint32_t r1, uint32_t r2,
                                           uint32_t r3) {
  if constexpr (COLS == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(r0, r1, r2, r3);
  else if constexpr (COLS == 2)
    *reinterpret_cast<uint2*>(p) = make_uint2(r0, r1);
  else
    *p = r0;
}

// The conversion of K45 (P -> Q_l), K2 (each digit -> Q_l*P), kernel n
// (each digit -> a shard's Q_l*P rows) and kernel k (mod_matmul_rowmod: a
// batch of inputs over one table):
//   out[b, j, n] = sum_{i < rows_b} y[b a_dim + i, n] * w_b[i, j] mod d_j,
// y: [>= a_total, N] (batch b's rows b a_dim .. b a_dim + rows_b - 1,
// rows_b = min(a_dim, a_total - b a_dim), or none: a batch past a_total
// is all zeros), w_b(_sh) = w(_sh) + b w_stride: [a_dim, d_dim] (w_stride
// 0: one table for every batch), d: [d_dim], red: [d_dim, 3] (Basis.red64
// of d), out: [batch, d_dim, N]. Output row j is global row d_off + j.
// Batch b's own rows, the global rows [b a_dim, min((b + 1) a_dim,
// own_end)) that the output holds (K2's and n's digit rows, whose weights
// are zero), are written as zeros without a product; own_end 0: none
// (K45, kernel k). What
// bounds it is integer issue: rows_b * (d_dim - own rows) Shoup products
// a column. So each thread holds COLS consecutive columns of the batch's
// rows in registers (16-byte loads) and, for each output row, forms the
// lazy Shoup products x * w - floor(x * w_sh / 2^32) * d_j in [0, 2 d_j)
// (exact in 32 bits for any 32-bit x when w < d_j < 2^31) and sums them
// in 64 bits (a_dim < 2^32 of them cannot overflow), then reduces the sum
// once (reduce_wide). The weights (w, w_sh) and the per-row constants sit in
// shared memory; blockIdx.z takes an equal share of the batch's converted
// rows (and of its own rows) so that enough blocks fill the card.
constexpr int kConvThreads = 128;

template <int MAXA, int COLS>
__global__ void __launch_bounds__(kConvThreads)
    pconv(const uint32_t* __restrict__ y, const uint32_t* __restrict__ w,
          const uint32_t* __restrict__ w_sh,
          const uint32_t* __restrict__ d, const uint32_t* __restrict__ red,
          uint32_t* __restrict__ out, int a_dim, int a_total, int d_dim,
          int n, int w_stride, int d_off, int own_end) {
  extern __shared__ uint4 conv_sm[];
  uint4* consts = conv_sm;               // [d_dim]: d, 2^32 mod d, its
                                         // companion, floor(2^32 / d)
  uint2* sw = reinterpret_cast<uint2*>(conv_sm + d_dim);  // [rows, d_dim]
  const int b = blockIdx.y;
  const int rows = max(0, min(a_dim, a_total - b * a_dim));
  const uint32_t* wb = w + static_cast<size_t>(b) * w_stride;
  const uint32_t* wb_sh = w_sh + static_cast<size_t>(b) * w_stride;
  for (int x = threadIdx.x; x < rows * d_dim; x += blockDim.x)
    sw[x] = make_uint2(wb[x], wb_sh[x]);
  for (int x = threadIdx.x; x < d_dim; x += blockDim.x)
    consts[x] = make_uint4(d[x], red[3 * x], red[3 * x + 1], red[3 * x + 2]);
  __syncthreads();
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * COLS;
  if (col >= n) return;
  const uint32_t* yb = y + static_cast<size_t>(b) * a_dim * n + col;
  uint32_t* ob = out + static_cast<size_t>(b) * d_dim * n + col;
  // this block's share of the converted rows k < d_dim - n_own (row j =
  // k, or k + n_own past the own rows [own_lo, own_lo + n_own), in output
  // rows) and of the own rows
  const int own_lo = max(b * a_dim, d_off) - d_off;
  const int n_own = max(0, min(min((b + 1) * a_dim, own_end),
                               d_off + d_dim) - d_off - own_lo);
  const int m = d_dim - n_own, splits = gridDim.z, z = blockIdx.z;
  const int per = (m + splits - 1) / splits;
  const int per_own = (n_own + splits - 1) / splits;
  const int k1 = min(m, (z + 1) * per);
  const int o1 = min(n_own, (z + 1) * per_own);
  for (int k = z * per_own; k < o1; ++k)
    store_cols<COLS>(ob + static_cast<size_t>(own_lo + k) * n, 0u, 0u, 0u,
                     0u);
  if (z * per >= k1) return;
  uint32_t x[MAXA][COLS];
#pragma unroll
  for (int i = 0; i < MAXA; ++i) {
    if (i < rows) {
      const uint32_t* yi = yb + static_cast<size_t>(i) * n;
      if constexpr (COLS == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(yi);
        x[i][0] = v.x;
        x[i][1] = v.y;
        x[i][2] = v.z;
        x[i][3] = v.w;
      } else if constexpr (COLS == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(yi);
        x[i][0] = v.x;
        x[i][1] = v.y;
      } else {
        x[i][0] = *yi;
      }
    }
  }
  for (int k = z * per; k < k1; ++k) {
    const int j = k < own_lo ? k : k + n_own;
    const uint4 cj = consts[j];
    const uint32_t q = cj.x;
    uint64_t sum[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) sum[c] = 0;
#pragma unroll
    for (int i = 0; i < MAXA; ++i) {
      if (i < rows) {
        const uint2 wi = sw[i * d_dim + j];
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          sum[c] += x[i][c] * wi.x - __umulhi(x[i][c], wi.y) * q;
      }
    }
    uint32_t r[4] = {};
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      r[c] = reduce_wide(sum[c], q, cj.y, cj.z, cj.w);
    store_cols<COLS>(ob + static_cast<size_t>(j) * n, r[0], r[1], r[2],
                     r[3]);
  }
}

template <int MAXA, int COLS>
int pconv_launch(const uint32_t* y, const uint32_t* w, const uint32_t* w_sh,
                 const uint32_t* d, const uint32_t* red, uint32_t* out,
                 int batch, int a_dim, int a_total, int d_dim, int n,
                 int w_stride, int d_off, int own_end, cudaStream_t st) {
  const size_t smem = 16 * static_cast<size_t>(d_dim) +
                      8 * static_cast<size_t>(a_dim) * d_dim;
  // as many blocks as fit on the card at once: split the output rows. The
  // blocks an SM holds depend on smem, so a few sizes are remembered per
  // instantiation and translation unit (K2 and K45 alternate in every key
  // switch; kernel k's digit and mod-down tables in a hoisted rotation).
  struct Resident {
    size_t smem;
    int blocks;
  };
  static Resident seen[4] = {};
  Resident* hit = nullptr;
  for (Resident& r : seen)
    if (r.blocks && r.smem == smem) hit = &r;
  if (!hit) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pconv<MAXA, COLS>, kConvThreads, smem);
    hit = &seen[0];
    for (Resident& r : seen)
      if (!r.blocks) {
        hit = &r;
        break;
      }
    *hit = {smem, sms * (per_sm > 0 ? per_sm : 1)};
  }
  const int cols = kConvThreads * COLS;
  const int blocks = (n + cols - 1) / cols * batch;
  int splits = hit->blocks / blocks;
  splits = splits < 1 ? 1 : splits > d_dim ? d_dim : splits;
  const dim3 grid((n + cols - 1) / cols, batch, splits);
  pconv<MAXA, COLS><<<grid, kConvThreads, smem, st>>>(
      y, w, w_sh, d, red, out, a_dim, a_total, d_dim, n, w_stride, d_off,
      own_end);
  return 0;
}

// Checks the shape (the batches hold the a_total rows, own rows among
// them, the tables fit 48 KB of shared memory, rows of N a multiple of 4
// words on 16-byte boundaries) and launches; returns a CUDA error code, 0
// when launched.
int pconv_run(const uint32_t* y, const uint32_t* w, const uint32_t* w_sh,
              const uint32_t* d, const uint32_t* red, uint32_t* out,
              int batch, int a_dim, int a_total, int d_dim, int n,
              int w_stride, int d_off, int own_end, cudaStream_t st) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(out);
  if (batch < 1 || batch > 65535 || a_dim < 1 || a_dim > 64 || d_dim < 1 ||
      a_total < 1 || a_total > batch * a_dim || w_stride < 0 || d_off < 0 ||
      own_end < 0 || own_end > a_total || n < 4 || n % 4 != 0 ||
      align % 16 != 0 ||
      16 * d_dim + 8 * a_dim * d_dim > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a_dim <= 8)
    return pconv_launch<8, 4>(y, w, w_sh, d, red, out, batch, a_dim, a_total,
                              d_dim, n, w_stride, d_off, own_end, st);
  if (a_dim <= 16)
    return pconv_launch<16, 4>(y, w, w_sh, d, red, out, batch, a_dim,
                               a_total, d_dim, n, w_stride, d_off, own_end,
                               st);
  if (a_dim <= 32)
    return pconv_launch<32, 2>(y, w, w_sh, d, red, out, batch, a_dim,
                               a_total, d_dim, n, w_stride, d_off, own_end,
                               st);
  return pconv_launch<64, 1>(y, w, w_sh, d, red, out, batch, a_dim, a_total,
                             d_dim, n, w_stride, d_off, own_end, st);
}

}  // namespace
