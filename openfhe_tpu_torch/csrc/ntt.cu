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
// the 50 MB L2 between passes. The stage and tile kernels live in
// ntt_core.cuh, which the fused key switch (ks_fused.cu) shares.

#include "ntt_core.cuh"

// x, out: [rows, N] words, row r in tower r % k; tables [k, N] and [k].
// out may equal x. Returns cudaGetLastError() after the launches.
extern "C" int ntt_fwd(const void* x, void* out, const void* psi,
                       const void* psi_sh, const void* q, int rows, int k,
                       int log_n, void* stream) {
  if (int bad = check_shape(rows, k, log_n)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* dst = static_cast<uint32_t*>(out);
  const auto* w = static_cast<const uint32_t*>(psi);
  const auto* w_sh = static_cast<const uint32_t*>(psi_sh);
  const auto* qs = static_cast<const uint32_t*>(q);
  const uint32_t* src = fwd_stages(static_cast<const uint32_t*>(x), dst, w,
                                   w_sh, qs, rows, k, log_n, st);
  const int log_tile = tile_log(log_n);
  fwd_tile<<<tile_grid(log_n, rows), tile_threads(log_tile), 0, st>>>(
      src, dst, w, w_sh, qs, k, log_n, log_tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ntt_inv(const void* x, void* out, const void* ipsi,
                       const void* ipsi_sh, const void* q, const void* ninv,
                       const void* ninv_sh, int rows, int k, int log_n,
                       void* stream) {
  if (int bad = check_shape(rows, k, log_n)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* dst = static_cast<uint32_t*>(out);
  const auto* w = static_cast<const uint32_t*>(ipsi);
  const auto* w_sh = static_cast<const uint32_t*>(ipsi_sh);
  const auto* qs = static_cast<const uint32_t*>(q);
  const auto* c = static_cast<const uint32_t*>(ninv);
  const auto* c_sh = static_cast<const uint32_t*>(ninv_sh);
  const int log_tile = tile_log(log_n);
  inv_tile<<<tile_grid(log_n, rows), tile_threads(log_tile), 0, st>>>(
      static_cast<const uint32_t*>(x), k, dst, w, w_sh, qs, c, c_sh, k, log_n,
      log_tile, log_tile == log_n);
  inv_stages(dst, w, w_sh, qs, c, c_sh, rows, k, log_n, st);
  return static_cast<int>(cudaGetLastError());
}
