// The key product of the HYBRID key switch on the cluster NTT, shared by
// ks_fused.cu (K3: all Q_l*P towers of one card, `ntt_keymul_acc`) and
// sharded.cu (kernel p: one shard's row range of them,
// `ntt_keymul_acc_rows`): the forward NTT of each extended digit, or the
// digit's own towers of c2 taken as they are, times the key rows, summed
// over the digits, in one launch.
//
// Row geometry: the launch covers `rows` towers, local row tau being
// global Q_l*P row g = tau0 + tau. Row g is digit g / alpha's own when
// g < own_end (the level's real Q tower count: P rows and pad rows past it
// are never own); an own row reads row g of c2. The key is indexed in
// place: local row tau reads key row tau below key_q and tau + key_shift
// from there on (the unsharded chain skips the Q towers above the level; a
// shard's key copy holds its own rows only and shifts nothing). K3 passes
// tau0 = 0 and own_end = key_q = kql.
//
// Each translation unit that includes this header gets its own
// `keymul_placeable` cache (one answer a ring size), as pconv_core.cuh's
// resident-blocks cache is per unit.

#pragma once

#include "ntt_cluster.cuh"

namespace {

// Cluster c takes local row tau = rows - 1 - c (the P towers, which
// transform every digit, start first). For each digit j, s_j is c2's row
// g on the digit's own rows, read at the words the transform would leave
// in each thread, else the forward transform of conv[j, tau]; the
// epilogue multiplies the thread's 16 words by the key rows' words at the
// same indices and adds them into the two sums, which stay in registers
// (128 a thread, so one block an SM) until the last digit writes ext. The
// own digit comes last. `own` depends on tau alone, so every block of a
// cluster takes the same branches and meets the same cluster barriers.
// conv: [nd, rows, N] COEFF; c2: [>= own_end, N] EVAL, indexed globally;
// bv, bv_sh, av, av_sh: [>= nd, key_rows, N]; ext: [2, rows, N];
// psi(_sh): [rows, N]; qs: [rows].
template <int LOG_N>
__global__ void __launch_bounds__(Geometry<LOG_N>::kThreads, 1)
    keymul_cluster(const uint32_t* conv, const uint32_t* c2,
                   const uint32_t* __restrict__ bv,
                   const uint32_t* __restrict__ bv_sh,
                   const uint32_t* __restrict__ av,
                   const uint32_t* __restrict__ av_sh, uint32_t* ext,
                   const uint32_t* __restrict__ psi,
                   const uint32_t* __restrict__ psi_sh,
                   const uint32_t* __restrict__ qs, int nd, int alpha,
                   int tau0, int own_end, int key_q, int rows, int key_rows,
                   int key_shift) {
  using G = Geometry<LOG_N>;
  extern __shared__ __align__(16) uint32_t tile[];
  const uint32_t rank = blockIdx.x & ((1u << G::kLogC) - 1);
  const int tau = rows - 1 - static_cast<int>(blockIdx.x >> G::kLogC);
  const int g = tau0 + tau;
  const uint32_t q = qs[tau];
  const size_t tw0 = static_cast<size_t>(tau) << LOG_N;
  const int krow = tau < key_q ? tau : tau + key_shift;
  const uint32_t x0 = fwd_out_word<LOG_N>(rank, threadIdx.x);
  const uint32_t* key[4] = {bv, bv_sh, av, av_sh};
  const int own_digit = g < own_end ? g / alpha : nd;     // nd: none
  uint32_t acc[2][kR];
  for (int i = 0; i < nd; ++i) {
    const int j = own_digit < nd ? (own_digit + 1 + i) % nd : i;
    const bool own = j == own_digit;
    const bool first = i == 0, last = i == nd - 1;
    const size_t kb = ((static_cast<size_t>(j) * key_rows + krow) << LOG_N) +
                      x0;
    // the key product on the thread's words a, row words x .. x + kR - 1
    auto keymul = [&](const uint32_t (&a)[kR], uint32_t x) {
#pragma unroll
      for (int v = 0; v < kR / 4; ++v) {
        uint4 kw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          kw[k] = __ldg(reinterpret_cast<const uint4*>(key[k] + kb) + v);
        const uint32_t w[2][4] = {{kw[0].x, kw[0].y, kw[0].z, kw[0].w},
                                  {kw[2].x, kw[2].y, kw[2].z, kw[2].w}};
        const uint32_t w_sh[2][4] = {{kw[1].x, kw[1].y, kw[1].z, kw[1].w},
                                     {kw[3].x, kw[3].y, kw[3].z, kw[3].w}};
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const int s = 4 * v + l;
            const uint32_t r = mul_shoup_q(a[s], w[e][l], w_sh[e][l], q);
            acc[e][s] = first ? r : add_q(acc[e][s], r, q);
          }
      }
      if (last) {
        store_words(ext + tw0 + x, acc[0]);
        store_words(ext + (static_cast<size_t>(rows + tau) << LOG_N) + x,
                    acc[1]);
      }
    };
    if (own) {
      uint32_t a[kR];
      load_words(a, c2 + (static_cast<size_t>(g) << LOG_N) + x0);
      keymul(a, x0);
    } else {
      fwd_cluster_row<LOG_N>(
          conv + ((static_cast<size_t>(j) * rows + tau) << LOG_N),
          psi + tw0, psi_sh + tw0, q, tile, keymul);
      if constexpr (G::kLogC == 0)
        __syncthreads();     // the next digit's transform rewrites the tile
    }
  }
}

using KeymulKernel = void (*)(const uint32_t*, const uint32_t*,
                              const uint32_t*, const uint32_t*,
                              const uint32_t*, const uint32_t*, uint32_t*,
                              const uint32_t*, const uint32_t*,
                              const uint32_t*, int, int, int, int, int, int,
                              int, int);

template <int... I>
KeymulKernel keymul_kernel(int log_n, std::integer_sequence<int, I...>) {
  static const KeymulKernel kernels[] = {
      keymul_cluster<kMinClusterLogN + I>...};
  return kernels[log_n - kMinClusterLogN];
}

int keymul_placeable[kMaxClusterLogN + 1];

// Checks the operands (a ring of 2^4 .. 2^17, `rows` a valid tower count,
// every operand on a 16-byte boundary, the digits and the row range
// consistent) and launches keymul_cluster over `rows` clusters; returns a
// CUDA error code, 0 when launched.
int keymul_launch(const void* conv, const void* c2, const void* bv,
                  const void* bv_sh, const void* av, const void* av_sh,
                  void* ext, const void* psi, const void* psi_sh,
                  const void* q, int nd, int alpha, int tau0, int own_end,
                  int key_q, int rows, int key_rows, int key_shift,
                  int log_n, cudaStream_t st) {
  if (int bad = check_cluster(conv, ext, rows, rows, log_n)) return bad;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(c2) | reinterpret_cast<uintptr_t>(bv) |
      reinterpret_cast<uintptr_t>(bv_sh) | reinterpret_cast<uintptr_t>(av) |
      reinterpret_cast<uintptr_t>(av_sh);
  if (nd < 1 || alpha < 1 || tau0 < 0 || own_end < 0 ||
      own_end > nd * alpha || key_q < 0 || key_shift < 0 ||
      key_rows < rows + key_shift || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  return launch_cluster(keymul_kernel(log_n, ClusterRings{}),
                        &keymul_placeable[log_n], rows, log_n, st, in(conv),
                        in(c2), in(bv), in(bv_sh), in(av), in(av_sh),
                        static_cast<uint32_t*>(ext), in(psi), in(psi_sh),
                        in(q), nd, alpha, tau0, own_end, key_q, rows,
                        key_rows, key_shift);
}

}  // namespace
