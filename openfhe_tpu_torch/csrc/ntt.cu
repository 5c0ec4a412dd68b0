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
// operation count sits under the byte count at the card's rates.
//
// Two transforms, chosen by the ring alone (ops/ntt.py):
//   * ntt_fwd / ntt_inv, for 2^4 <= N <= 2^17: one launch, a tower per
//     thread-block cluster of at most 8 blocks, the words read from and
//     written to device memory once (ntt_cluster.cuh);
//   * ntt_fwd_staged / ntt_inv_staged, any N: the stages whose butterfly
//     span is at least a tile (8192 words) run one launch each over device
//     memory, the rest in one shared-memory pass per tile (ntt_core.cuh,
//     whose passes the fused key switch of ks_fused.cu shares): at
//     N = 2^16 four launches and four passes over the data. They serve
//     rings above 2^17 and are the yardstick the cluster transform is held
//     against on the card.

#include "ntt_cluster.cuh"
#include "ntt_core.cuh"

// x, out: [rows, N] words, row r in tower r % k; tables [k, N] and [k].
// out may equal x. Each entry returns cudaGetLastError() after its
// launches, or the error of a refused launch; ntt_fwd / ntt_inv refuse
// rings outside 2^4 .. 2^17 and x or out off a 16-byte boundary.

namespace {
int fwd_placeable[kMaxClusterLogN + 1], inv_placeable[kMaxClusterLogN + 1];
}

extern "C" int ntt_fwd(const void* x, void* out, const void* psi,
                       const void* psi_sh, const void* q, int rows, int k,
                       int log_n, void* stream) {
  if (int bad = check_cluster(x, out, rows, k, log_n)) return bad;
  return launch_cluster(fwd_kernel(log_n, ClusterRings{}),
                        &fwd_placeable[log_n], rows, log_n,
                        static_cast<cudaStream_t>(stream),
                        static_cast<const uint32_t*>(x),
                        static_cast<uint32_t*>(out),
                        static_cast<const uint32_t*>(psi),
                        static_cast<const uint32_t*>(psi_sh),
                        static_cast<const uint32_t*>(q), k);
}

extern "C" int ntt_inv(const void* x, void* out, const void* ipsi,
                       const void* ipsi_sh, const void* q, const void* ninv,
                       const void* ninv_sh, int rows, int k, int log_n,
                       void* stream) {
  if (int bad = check_cluster(x, out, rows, k, log_n)) return bad;
  return launch_cluster(inv_kernel(log_n, ClusterRings{}),
                        &inv_placeable[log_n], rows, log_n,
                        static_cast<cudaStream_t>(stream),
                        static_cast<const uint32_t*>(x),
                        static_cast<uint32_t*>(out),
                        static_cast<const uint32_t*>(ipsi),
                        static_cast<const uint32_t*>(ipsi_sh),
                        static_cast<const uint32_t*>(q),
                        static_cast<const uint32_t*>(ninv),
                        static_cast<const uint32_t*>(ninv_sh), k, k, 0);
}

extern "C" int ntt_fwd_staged(const void* x, void* out, const void* psi,
                              const void* psi_sh, const void* q, int rows,
                              int k, int log_n, void* stream) {
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

extern "C" int ntt_inv_staged(const void* x, void* out, const void* ipsi,
                              const void* ipsi_sh, const void* q,
                              const void* ninv, const void* ninv_sh, int rows,
                              int k, int log_n, void* stream) {
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
