// Negacyclic NTT over RNS towers for Hopper (sm_90a).
//
// Replaces the TPU kernels ntt_fwd_fused / ntt_inv_fused of
// openfhe_tpu/ops/ntt_fused.py (one pallas_call site, bodies
// _ntt_fwd_kernel -> _fwd_core and _ntt_inv_kernel -> _inv_core). Those
// run the transform as two sqrt(N)-size int8 Karatsuba matmuls on the MXU;
// here it is the butterfly transform the JAX package's plain path
// computes (_ntt_fwd_vpu / _ntt_inv_vpu, ops/ntt.py), word for word:
//   forward: Cooley-Tukey DIT, for m = 1, 2, ..., N/2 with t = N/2m,
//            (u, v) -> (u + v*psi_br[m+i], u - v*psi_br[m+i]);
//   inverse: Gentleman-Sande with ipsi_br, m = N/2 .. 1, then * N^-1.
// Twiddles are multiplied with Shoup companions (__umulhi), which is exact
// and canonical for every odd q < 2^31.
//
// What bounds it on an H100: device-memory bytes. At N = 2^16 one tower is
// 256 KB of words and its two twiddle tables another 512 KB, and the
// butterflies cost about ten 32-bit integer operations each, so the
// operation count sits well under the byte count at the card's rates.
//
// Design: one tower does not fit a block's shared memory (227 KB at most),
// so the transform runs in two phases.
//   * Stages whose butterfly span t is at least a tile (T = min(N, 8192)
//     words, 32 KB) run one launch each over device memory, one thread
//     per butterfly, grid over (butterfly blocks, rows).
//   * The remaining log2(T) stages run in one launch: each block loads a
//     contiguous tile into shared memory, runs every stage there, and
//     writes the tile back once.
// The inverse runs the phases in the mirrored order and folds the N^-1
// multiply into its last pass. At N = 2^16 that is 4 passes over the data
// instead of 16; the data of one call (31 towers, 8 MB) mostly stays in
// the 50 MB L2 between passes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTileLog = 13;     // 8192 words = 32 KB of shared memory
constexpr int kStageThreads = 256;
constexpr int kTileThreads = 1024;

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

// One forward stage over device memory (span t = 2^log_t >= tile).
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
  const uint32_t q = qs[tower];
  for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) s[x] = in[base + x];
  __syncthreads();
  for (int log_m = log_n - log_tile; log_m < log_n; ++log_m) {
    const int log_t = log_n - 1 - log_m;
    for (uint32_t b = threadIdx.x; b < size / 2; b += blockDim.x) {
      const uint32_t g = b >> log_t;
      const uint32_t lu = (g << (log_t + 1)) + (b & ((1u << log_t) - 1));
      const uint32_t lv = lu + (1u << log_t);
      const uint32_t i = (tile << (log_tile - 1 - log_t)) + g;
      const size_t tw = tw0 + (1u << log_m) + i;
      const uint32_t u = s[lu];
      const uint32_t v = mul_shoup(s[lv], psi[tw], psi_sh[tw], q);
      s[lu] = add_mod(u, v, q);
      s[lv] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
  for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) out[base + x] = s[x];
}

// The first log_tile inverse stages of one tile, in shared memory; with
// `scale` set (no device-memory stage follows) the N^-1 multiply too.
__global__ void inv_tile(const uint32_t* in, uint32_t* out,
                         const uint32_t* __restrict__ ipsi,
                         const uint32_t* __restrict__ ipsi_sh,
                         const uint32_t* __restrict__ qs,
                         const uint32_t* __restrict__ ninv,
                         const uint32_t* __restrict__ ninv_sh, int k,
                         int log_n, int log_tile, int scale) {
  __shared__ uint32_t s[1 << kMaxTileLog];
  const int row = blockIdx.y;
  const int tower = row % k;
  const uint32_t tile = blockIdx.x;
  const uint32_t size = 1u << log_tile;
  const size_t base = (static_cast<size_t>(row) << log_n) +
                      (static_cast<size_t>(tile) << log_tile);
  const size_t tw0 = static_cast<size_t>(tower) << log_n;
  const uint32_t q = qs[tower];
  for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) s[x] = in[base + x];
  __syncthreads();
  for (int log_m = log_n - 1; log_m >= log_n - log_tile; --log_m) {
    const int log_t = log_n - 1 - log_m;
    for (uint32_t b = threadIdx.x; b < size / 2; b += blockDim.x) {
      const uint32_t g = b >> log_t;
      const uint32_t lu = (g << (log_t + 1)) + (b & ((1u << log_t) - 1));
      const uint32_t lv = lu + (1u << log_t);
      const uint32_t i = (tile << (log_tile - 1 - log_t)) + g;
      const size_t tw = tw0 + (1u << log_m) + i;
      const uint32_t u = s[lu];
      const uint32_t v = s[lv];
      s[lu] = add_mod(u, v, q);
      s[lv] = mul_shoup(sub_mod(u, v, q), ipsi[tw], ipsi_sh[tw], q);
    }
    __syncthreads();
  }
  if (scale) {
    const uint32_t c = ninv[tower], c_sh = ninv_sh[tower];
    for (uint32_t x = threadIdx.x; x < size; x += blockDim.x)
      out[base + x] = mul_shoup(s[x], c, c_sh, q);
  } else {
    for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) out[base + x] = s[x];
  }
}

// One inverse stage over device memory (span t = 2^log_t >= tile); the
// last one (log_m == 0) also multiplies by N^-1.
__global__ void inv_stage(const uint32_t* in, uint32_t* out,
                          const uint32_t* __restrict__ ipsi,
                          const uint32_t* __restrict__ ipsi_sh,
                          const uint32_t* __restrict__ qs,
                          const uint32_t* __restrict__ ninv,
                          const uint32_t* __restrict__ ninv_sh, int k,
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
    const uint32_t c = ninv[tower], c_sh = ninv_sh[tower];
    lo = mul_shoup(lo, c, c_sh, q);
    hi = mul_shoup(hi, c, c_sh, q);
  }
  out[base + u_idx] = lo;
  out[base + v_idx] = hi;
}

int check_shape(int rows, int k, int log_n) {
  if (rows < 1 || rows > 65535 || k < 1 || rows % k != 0 || log_n < 1 ||
      log_n > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// x, out: [rows, N] words, row r in tower r % k; tables [k, N] and [k].
// out may equal x. Returns cudaGetLastError() after the launches.
extern "C" int ntt_fwd(const void* x, void* out, const void* psi,
                       const void* psi_sh, const void* q, int rows, int k,
                       int log_n, void* stream) {
  if (int bad = check_shape(rows, k, log_n)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int log_tile = log_n < kMaxTileLog ? log_n : kMaxTileLog;
  const uint32_t* src = static_cast<const uint32_t*>(x);
  uint32_t* dst = static_cast<uint32_t*>(out);
  const auto* w = static_cast<const uint32_t*>(psi);
  const auto* w_sh = static_cast<const uint32_t*>(psi_sh);
  const auto* qs = static_cast<const uint32_t*>(q);
  const uint32_t half = 1u << (log_n - 1);
  const dim3 stage_grid((half + kStageThreads - 1) / kStageThreads, rows);
  for (int log_m = 0; log_m < log_n - log_tile; ++log_m) {
    fwd_stage<<<stage_grid, kStageThreads, 0, st>>>(src, dst, w, w_sh, qs, k,
                                                    log_n, log_m);
    src = dst;
  }
  const int tile_threads =
      (1 << (log_tile - 1)) < kTileThreads ? (1 << (log_tile - 1)) : kTileThreads;
  fwd_tile<<<dim3(1u << (log_n - log_tile), rows), tile_threads, 0, st>>>(
      src, dst, w, w_sh, qs, k, log_n, log_tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ntt_inv(const void* x, void* out, const void* ipsi,
                       const void* ipsi_sh, const void* q, const void* ninv,
                       const void* ninv_sh, int rows, int k, int log_n,
                       void* stream) {
  if (int bad = check_shape(rows, k, log_n)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int log_tile = log_n < kMaxTileLog ? log_n : kMaxTileLog;
  const auto* src = static_cast<const uint32_t*>(x);
  auto* dst = static_cast<uint32_t*>(out);
  const auto* w = static_cast<const uint32_t*>(ipsi);
  const auto* w_sh = static_cast<const uint32_t*>(ipsi_sh);
  const auto* qs = static_cast<const uint32_t*>(q);
  const auto* c = static_cast<const uint32_t*>(ninv);
  const auto* c_sh = static_cast<const uint32_t*>(ninv_sh);
  const int tile_threads =
      (1 << (log_tile - 1)) < kTileThreads ? (1 << (log_tile - 1)) : kTileThreads;
  const int stages = log_n - log_tile;
  inv_tile<<<dim3(1u << stages, rows), tile_threads, 0, st>>>(
      src, dst, w, w_sh, qs, c, c_sh, k, log_n, log_tile, stages == 0);
  const uint32_t half = 1u << (log_n - 1);
  const dim3 stage_grid((half + kStageThreads - 1) / kStageThreads, rows);
  for (int log_m = stages - 1; log_m >= 0; --log_m)
    inv_stage<<<stage_grid, kStageThreads, 0, st>>>(dst, dst, w, w_sh, qs, c,
                                                    c_sh, k, log_n, log_m);
  return static_cast<int>(cudaGetLastError());
}
