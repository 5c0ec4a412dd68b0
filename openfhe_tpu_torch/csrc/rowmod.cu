// RNS base conversion for Hopper (sm_90a):
//   out[b, j, n] = sum_i y[b, i, n] * W[i, j]  mod d_j.
//
// Replaces the TPU kernel mod_matmul_rowmod_tpu of
// openfhe_tpu/ops/modmatmul.py (body _mm_rowmod_kernel), which splits W
// and y into signed int8 limbs for the MXU and recombines the 16 limb
// products. Here W stays in canonical residues W[i, j] = [B/b_i]_{d_j}
// with Shoup companions: each term is one __umulhi-based multiply, reduced
// at once, so the sum never leaves 32 bits (16 unreduced products would
// overflow even 64 bits).
//
// What bounds it on an H100: close to balanced. At A = 16 inputs and
// D = 31 outputs per column it moves (A + D) * 4 bytes per column and does
// A * D Shoup multiply-adds (about 7 integer operations each), so bytes
// and operations take about the same time at the card's rates.
//
// Design: one thread per column n keeps its A input words in registers
// (MAXA is a compile-time bound, so the array is not spilled) and writes
// its D outputs; W, its companions and d sit in shared memory, read as
// broadcasts. Loads and stores are coalesced along n.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w,
                                              uint32_t w_sh, uint32_t q) {
  uint32_t hi = __umulhi(x, w_sh);
  uint32_t r = x * w - hi * q;
  return r >= q ? r - q : r;
}

template <int MAXA>
__global__ void rowmod(const uint32_t* __restrict__ y,
                       const uint32_t* __restrict__ w,
                       const uint32_t* __restrict__ w_sh,
                       const uint32_t* __restrict__ d,
                       uint32_t* __restrict__ out, int a_dim, int d_dim,
                       int n) {
  extern __shared__ uint32_t sm[];
  uint32_t* sw = sm;
  uint32_t* swsh = sm + a_dim * d_dim;
  uint32_t* sd = sm + 2 * a_dim * d_dim;
  for (int x = threadIdx.x; x < a_dim * d_dim; x += blockDim.x) {
    sw[x] = w[x];
    swsh[x] = w_sh[x];
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
void launch(const uint32_t* y, const uint32_t* w, const uint32_t* w_sh,
            const uint32_t* d, uint32_t* out, int batch, int a_dim,
            int d_dim, int n, cudaStream_t st) {
  const size_t smem = (2 * static_cast<size_t>(a_dim) * d_dim + d_dim) *
                      sizeof(uint32_t);
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  rowmod<MAXA><<<grid, kThreads, smem, st>>>(y, w, w_sh, d, out, a_dim,
                                             d_dim, n);
}

}  // namespace

// y: [batch, A, n] words; w, w_sh: [A, D]; d: [D]; out: [batch, D, n].
// Returns cudaGetLastError() after the launch.
extern "C" int mod_matmul_rowmod(const void* y, const void* w,
                                 const void* w_sh, const void* d, void* out,
                                 int batch, int a_dim, int d_dim, int n,
                                 void* stream) {
  // the tables must fit the 48 KB of static-default shared memory
  if (batch < 1 || batch > 65535 || a_dim < 1 || a_dim > 64 || d_dim < 1 ||
      n < 1 || (2 * a_dim + 1) * d_dim > 12 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const uint32_t*>(y);
  const auto* wp = static_cast<const uint32_t*>(w);
  const auto* whp = static_cast<const uint32_t*>(w_sh);
  const auto* dp = static_cast<const uint32_t*>(d);
  auto* op = static_cast<uint32_t*>(out);
  if (a_dim <= 8)
    launch<8>(yp, wp, whp, dp, op, batch, a_dim, d_dim, n, st);
  else if (a_dim <= 16)
    launch<16>(yp, wp, whp, dp, op, batch, a_dim, d_dim, n, st);
  else if (a_dim <= 32)
    launch<32>(yp, wp, whp, dp, op, batch, a_dim, d_dim, n, st);
  else
    launch<64>(yp, wp, whp, dp, op, batch, a_dim, d_dim, n, st);
  return static_cast<int>(cudaGetLastError());
}
