// Shared NTT building blocks for Hopper (sm_90a): modular arithmetic on
// canonical 32-bit residues, the device-memory stage kernels and the
// shared-memory tile passes of the negacyclic NTT, and the host-side
// launch sequences around them.
//
// Included by ntt.cu (the plain transforms) and ks_fused.cu (the fused key
// switch, whose kernels are these passes with a prologue or an epilogue).
// Everything lives in an anonymous namespace: each source is its own
// shared library with its own copy.
//
// The transform is the one of ntt.cu's header note: Cooley-Tukey DIT
// forward / Gentleman-Sande inverse with bit-reversed twiddles and Shoup
// companions. Stages whose butterfly span is at least a tile (T = min(N,
// 8192) words) run one launch each over device memory; the remaining
// log2(T) stages run in one shared-memory pass per tile.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTileLog = 13;     // 8192 words = 32 KB of shared memory
constexpr int kStageThreads = 256;
constexpr int kTileThreads = 1024;
// words of a tile each thread of a tile pass owns (8192 / 1024)
constexpr int kTileWords = (1 << kMaxTileLog) / kTileThreads;

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  uint32_t s = a + b;               // < 2q < 2^32
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  uint32_t d = a + q - b;           // < 2q < 2^32
  return d >= q ? d - q : d;
}

// x * w mod q with w_sh = floor(w * 2^32 / q): the quotient estimate is
// at most one short, so x*w - hi*q (mod 2^32) lies in [0, 2q).
__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w,
                                              uint32_t w_sh, uint32_t q) {
  uint32_t hi = __umulhi(x, w_sh);
  uint32_t r = x * w - hi * q;
  return r >= q ? r - q : r;
}

// a * b mod q for two variable residues: the exact 64-bit product reduced.
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return static_cast<uint32_t>(static_cast<uint64_t>(a) * b % q);
}

// The last log_tile forward stages of tile `tile` of one row, in shared
// memory s. psi / psi_sh point at the row's tower. Expects s loaded and
// the block synchronised; returns synchronised.
__device__ __forceinline__ void fwd_tile_stages(
    uint32_t* s, const uint32_t* __restrict__ psi,
    const uint32_t* __restrict__ psi_sh, uint32_t q, int log_n,
    int log_tile, uint32_t tile) {
  const uint32_t size = 1u << log_tile;
  for (int log_m = log_n - log_tile; log_m < log_n; ++log_m) {
    const int log_t = log_n - 1 - log_m;
    for (uint32_t b = threadIdx.x; b < size / 2; b += blockDim.x) {
      const uint32_t g = b >> log_t;
      const uint32_t lu = (g << (log_t + 1)) + (b & ((1u << log_t) - 1));
      const uint32_t lv = lu + (1u << log_t);
      const uint32_t tw = (1u << log_m) + (tile << (log_tile - 1 - log_t)) + g;
      const uint32_t u = s[lu];
      const uint32_t v = mul_shoup(s[lv], psi[tw], psi_sh[tw], q);
      s[lu] = add_mod(u, v, q);
      s[lv] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// The first log_tile inverse stages of tile `tile`, in shared memory; the
// same contract as fwd_tile_stages.
__device__ __forceinline__ void inv_tile_stages(
    uint32_t* s, const uint32_t* __restrict__ ipsi,
    const uint32_t* __restrict__ ipsi_sh, uint32_t q, int log_n,
    int log_tile, uint32_t tile) {
  const uint32_t size = 1u << log_tile;
  for (int log_m = log_n - 1; log_m >= log_n - log_tile; --log_m) {
    const int log_t = log_n - 1 - log_m;
    for (uint32_t b = threadIdx.x; b < size / 2; b += blockDim.x) {
      const uint32_t g = b >> log_t;
      const uint32_t lu = (g << (log_t + 1)) + (b & ((1u << log_t) - 1));
      const uint32_t lv = lu + (1u << log_t);
      const uint32_t tw = (1u << log_m) + (tile << (log_tile - 1 - log_t)) + g;
      const uint32_t u = s[lu];
      const uint32_t v = s[lv];
      s[lu] = add_mod(u, v, q);
      s[lv] = mul_shoup(sub_mod(u, v, q), ipsi[tw], ipsi_sh[tw], q);
    }
    __syncthreads();
  }
}

// One forward stage over device memory (span t = 2^log_t >= tile). Launch
// row r = blockIdx.y is row r of in/out, in tower r % k.
__global__ void fwd_stage(const uint32_t* in, uint32_t* out,
                          const uint32_t* __restrict__ psi,
                          const uint32_t* __restrict__ psi_sh,
                          const uint32_t* __restrict__ qs, int k, int log_n,
                          int log_m) {
  const uint32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (1u << (log_n - 1))) return;
  const int row = blockIdx.y;
  const int tower = row % k;
  const int log_t = log_n - 1 - log_m;
  const uint32_t i = b >> log_t;
  const uint32_t u_idx = (i << (log_t + 1)) + (b & ((1u << log_t) - 1));
  const uint32_t v_idx = u_idx + (1u << log_t);
  const size_t base = static_cast<size_t>(row) << log_n;
  const size_t tw = (static_cast<size_t>(tower) << log_n) + (1u << log_m) + i;
  const uint32_t q = qs[tower];
  const uint32_t u = in[base + u_idx];
  const uint32_t v = mul_shoup(in[base + v_idx], psi[tw], psi_sh[tw], q);
  out[base + u_idx] = add_mod(u, v, q);
  out[base + v_idx] = sub_mod(u, v, q);
}

// The last log_tile forward stages of one tile, in shared memory.
__global__ void fwd_tile(const uint32_t* in, uint32_t* out,
                         const uint32_t* __restrict__ psi,
                         const uint32_t* __restrict__ psi_sh,
                         const uint32_t* __restrict__ qs, int k, int log_n,
                         int log_tile) {
  __shared__ uint32_t s[1 << kMaxTileLog];
  const int row = blockIdx.y;
  const int tower = row % k;
  const uint32_t tile = blockIdx.x;
  const uint32_t size = 1u << log_tile;
  const size_t base = (static_cast<size_t>(row) << log_n) +
                      (static_cast<size_t>(tile) << log_tile);
  const size_t tw0 = static_cast<size_t>(tower) << log_n;
  for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) s[x] = in[base + x];
  __syncthreads();
  fwd_tile_stages(s, psi + tw0, psi_sh + tw0, qs[tower], log_n, log_tile,
                  tile);
  for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) out[base + x] = s[x];
}

// The first log_tile inverse stages of one tile, in shared memory; with
// `scale` set (no device-memory stage follows) the per-tower multiply by
// c too. Launch row r reads row (r / k) * in_stride + r % k of `in` (so
// it can pick k rows out of every in_stride) and writes row r of `out`.
__global__ void inv_tile(const uint32_t* in, int in_stride, uint32_t* out,
                         const uint32_t* __restrict__ ipsi,
                         const uint32_t* __restrict__ ipsi_sh,
                         const uint32_t* __restrict__ qs,
                         const uint32_t* __restrict__ c,
                         const uint32_t* __restrict__ c_sh, int k,
                         int log_n, int log_tile, int scale) {
  __shared__ uint32_t s[1 << kMaxTileLog];
  const int row = blockIdx.y;
  const int tower = row % k;
  const uint32_t tile = blockIdx.x;
  const uint32_t size = 1u << log_tile;
  const size_t col0 = static_cast<size_t>(tile) << log_tile;
  const size_t in_row = static_cast<size_t>(row / k) * in_stride + tower;
  const uint32_t* src = in + (in_row << log_n) + col0;
  uint32_t* dst = out + (static_cast<size_t>(row) << log_n) + col0;
  const size_t tw0 = static_cast<size_t>(tower) << log_n;
  const uint32_t q = qs[tower];
  for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) s[x] = src[x];
  __syncthreads();
  inv_tile_stages(s, ipsi + tw0, ipsi_sh + tw0, q, log_n, log_tile, tile);
  if (scale) {
    const uint32_t cv = c[tower], cv_sh = c_sh[tower];
    for (uint32_t x = threadIdx.x; x < size; x += blockDim.x)
      dst[x] = mul_shoup(s[x], cv, cv_sh, q);
  } else {
    for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) dst[x] = s[x];
  }
}

// One inverse stage over device memory (span t = 2^log_t >= tile); the
// last one (log_m == 0) also multiplies by the per-tower constant c.
__global__ void inv_stage(const uint32_t* in, uint32_t* out,
                          const uint32_t* __restrict__ ipsi,
                          const uint32_t* __restrict__ ipsi_sh,
                          const uint32_t* __restrict__ qs,
                          const uint32_t* __restrict__ c,
                          const uint32_t* __restrict__ c_sh, int k,
                          int log_n, int log_m) {
  const uint32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (1u << (log_n - 1))) return;
  const int row = blockIdx.y;
  const int tower = row % k;
  const int log_t = log_n - 1 - log_m;
  const uint32_t i = b >> log_t;
  const uint32_t u_idx = (i << (log_t + 1)) + (b & ((1u << log_t) - 1));
  const uint32_t v_idx = u_idx + (1u << log_t);
  const size_t base = static_cast<size_t>(row) << log_n;
  const size_t tw = (static_cast<size_t>(tower) << log_n) + (1u << log_m) + i;
  const uint32_t q = qs[tower];
  const uint32_t u = in[base + u_idx];
  const uint32_t v = in[base + v_idx];
  uint32_t lo = add_mod(u, v, q);
  uint32_t hi = mul_shoup(sub_mod(u, v, q), ipsi[tw], ipsi_sh[tw], q);
  if (log_m == 0) {
    const uint32_t cv = c[tower], cv_sh = c_sh[tower];
    lo = mul_shoup(lo, cv, cv_sh, q);
    hi = mul_shoup(hi, cv, cv_sh, q);
  }
  out[base + u_idx] = lo;
  out[base + v_idx] = hi;
}

// ---------------------------------------------------------------------------
// host side: pass geometry and launch sequences
// ---------------------------------------------------------------------------

inline int tile_log(int log_n) {
  return log_n < kMaxTileLog ? log_n : kMaxTileLog;
}

inline int tile_threads(int log_tile) {
  return (1 << (log_tile - 1)) < kTileThreads ? (1 << (log_tile - 1))
                                              : kTileThreads;
}

inline dim3 tile_grid(int log_n, int rows) {
  return dim3(1u << (log_n - tile_log(log_n)), rows);
}

int check_shape(int rows, int k, int log_n) {
  if (rows < 1 || rows > 65535 || k < 1 || rows % k != 0 || log_n < 1 ||
      log_n > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The forward device-memory stages (span >= tile) of `rows` rows: the
// first reads src and writes dst, the rest run in place on dst. Returns
// where the data is for the tile pass (src when there is no such stage).
const uint32_t* fwd_stages(const uint32_t* src, uint32_t* dst,
                           const uint32_t* psi, const uint32_t* psi_sh,
                           const uint32_t* qs, int rows, int k, int log_n,
                           cudaStream_t st) {
  const uint32_t half = 1u << (log_n - 1);
  const dim3 grid((half + kStageThreads - 1) / kStageThreads, rows);
  for (int log_m = 0; log_m < log_n - tile_log(log_n); ++log_m) {
    fwd_stage<<<grid, kStageThreads, 0, st>>>(src, dst, psi, psi_sh, qs, k,
                                              log_n, log_m);
    src = dst;
  }
  return src;
}

// The inverse device-memory stages, in place on x, after the tile pass;
// the last multiplies by the per-tower constant c.
void inv_stages(uint32_t* x, const uint32_t* ipsi, const uint32_t* ipsi_sh,
                const uint32_t* qs, const uint32_t* c, const uint32_t* c_sh,
                int rows, int k, int log_n, cudaStream_t st) {
  const uint32_t half = 1u << (log_n - 1);
  const dim3 grid((half + kStageThreads - 1) / kStageThreads, rows);
  for (int log_m = log_n - tile_log(log_n) - 1; log_m >= 0; --log_m)
    inv_stage<<<grid, kStageThreads, 0, st>>>(x, x, ipsi, ipsi_sh, qs, c,
                                              c_sh, k, log_n, log_m);
}

}  // namespace
