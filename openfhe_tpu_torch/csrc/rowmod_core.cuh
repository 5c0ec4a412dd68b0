// The row-modulus base-conversion kernel, shared by rowmod.cu (one weight
// matrix for the whole batch) and ks_fused.cu (one weight matrix per
// digit, and the P -> Q conversion of the mod-down):
//   out[b, j, n] = sum_i y[b, i, n] * W_b[i, j]  mod d_j,
// with W_b = w + b * w_stride. See rowmod.cu's header for the design.

#pragma once

#include "ntt_core.cuh"     // mul_shoup

namespace {

constexpr int kRowmodThreads = 256;

template <int MAXA>
__global__ void rowmod(const uint32_t* __restrict__ y,
                       const uint32_t* __restrict__ w,
                       const uint32_t* __restrict__ w_sh,
                       const uint32_t* __restrict__ d,
                       uint32_t* __restrict__ out, int a_dim, int d_dim,
                       int n, size_t w_stride) {
  extern __shared__ uint32_t sm[];
  uint32_t* sw = sm;
  uint32_t* swsh = sm + a_dim * d_dim;
  uint32_t* sd = sm + 2 * a_dim * d_dim;
  const uint32_t* wb = w + blockIdx.y * w_stride;
  const uint32_t* wshb = w_sh + blockIdx.y * w_stride;
  for (int x = threadIdx.x; x < a_dim * d_dim; x += blockDim.x) {
    sw[x] = wb[x];
    swsh[x] = wshb[x];
  }
  for (int x = threadIdx.x; x < d_dim; x += blockDim.x) sd[x] = d[x];
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const uint32_t* yb = y + static_cast<size_t>(blockIdx.y) * a_dim * n + col;
  uint32_t* ob = out + static_cast<size_t>(blockIdx.y) * d_dim * n + col;
  uint32_t v[MAXA];
#pragma unroll
  for (int i = 0; i < MAXA; ++i)
    v[i] = i < a_dim ? yb[static_cast<size_t>(i) * n] : 0u;
  for (int j = 0; j < d_dim; ++j) {
    const uint32_t q = sd[j];
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < MAXA; ++i) {
      if (i < a_dim) {
        const uint32_t t = mul_shoup(v[i], sw[i * d_dim + j],
                                     swsh[i * d_dim + j], q);
        acc += t;                   // both < q < 2^31
        acc = acc >= q ? acc - q : acc;
      }
    }
    ob[static_cast<size_t>(j) * n] = acc;
  }
}

template <int MAXA>
void rowmod_launch(const uint32_t* y, const uint32_t* w, const uint32_t* w_sh,
                   const uint32_t* d, uint32_t* out, int batch, int a_dim,
                   int d_dim, int n, size_t w_stride, cudaStream_t st) {
  const size_t smem = (2 * static_cast<size_t>(a_dim) * d_dim + d_dim) *
                      sizeof(uint32_t);
  const dim3 grid((n + kRowmodThreads - 1) / kRowmodThreads, batch);
  rowmod<MAXA><<<grid, kRowmodThreads, smem, st>>>(y, w, w_sh, d, out, a_dim,
                                                   d_dim, n, w_stride);
}

// Checks the shape (the tables must fit the 48 KB of default shared
// memory) and launches; returns a CUDA error code, 0 when launched.
int rowmod_run(const uint32_t* y, const uint32_t* w, const uint32_t* w_sh,
               const uint32_t* d, uint32_t* out, int batch, int a_dim,
               int d_dim, int n, size_t w_stride, cudaStream_t st) {
  if (batch < 1 || batch > 65535 || a_dim < 1 || a_dim > 64 || d_dim < 1 ||
      n < 1 || (2 * a_dim + 1) * d_dim > 12 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a_dim <= 8)
    rowmod_launch<8>(y, w, w_sh, d, out, batch, a_dim, d_dim, n, w_stride, st);
  else if (a_dim <= 16)
    rowmod_launch<16>(y, w, w_sh, d, out, batch, a_dim, d_dim, n, w_stride, st);
  else if (a_dim <= 32)
    rowmod_launch<32>(y, w, w_sh, d, out, batch, a_dim, d_dim, n, w_stride, st);
  else
    rowmod_launch<64>(y, w, w_sh, d, out, batch, a_dim, d_dim, n, w_stride, st);
  return 0;
}

}  // namespace
