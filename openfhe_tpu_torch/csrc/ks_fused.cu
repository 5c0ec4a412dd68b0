// The fused HYBRID key switch for Hopper (sm_90a): seven entry points, one
// per TPU kernel of openfhe_tpu/pke/keyswitch/ks_fused.py (mult_relin_fused
// and keyswitch_core_fused), plus the former forms of six of them.
//
//   tensor_intt       replaces _tensor_intt (K1t, pallas_call :366) and
//                     _tensor_intt_single (:301): c2 = a1*b1 and
//                     y = INTT(c2) * (B_j/b_i)^-1
//   intt_scale        replaces _intt_scale_pairs (K1, :422) and
//                     _intt_scale (:476): out[e, tau] =
//                     INTT(x[e, in_off + tau]) * scale[tau], K1 on the
//                     Q_l rows of c2 or K4 on ext's P rows read in place
//   conv_digits       replaces _conv_digits (K2, :513): every digit of y
//                     extended to all Q_l*P towers, own rows zero
//   ntt_keymul_acc    replaces _ntt_keymul_acc (K3, :690): NTT of each
//                     extended digit (c2 on the digit's own towers) times
//                     the key halves, summed over the digits
//   intt_conv_p       replaces _intt_conv_p (K45, :618): INTT of ext's P
//                     rows * (P/p_i)^-1 * t^-1, then the P -> Q_l
//                     conversion (the function of _conv_p_to_q, K5, :549)
//   ntt_subscale      replaces _ntt_subscale (K6, :747):
//                     (ext - t * NTT(convq)) * P^-1, t = 1 for CKKS, plus
//                     an optional addend per element (the caller's final
//                     add of Relinearize, KeySwitch and the automorphisms)
//   ntt_submul_final  replaces _ntt_submul_final (K6f, :802):
//                     (ext - NTT(convq)) * P^-1 plus the tensor terms
//   tensor_intt_staged, ntt_keymul_acc_staged, intt_conv_p_staged,
//   ntt_subscale_staged, ntt_submul_final_staged:
//                     K1t, K3, K45, K6 and K6f on the staged NTT passes,
//                     for rings outside the cluster NTT's 2^4 .. 2^17 and
//                     as the yardstick on the card; conv_digits_rowmod: K2
//                     on rowmod_core.cuh over the zero-padded digits, the
//                     yardstick of conv_digits
//
// The TPU kernels multiply through int8 Karatsuba limbs and float
// quotients on the MXU; here every product is exact 32-bit modular
// arithmetic on canonical residues: Shoup with precomputed companions for
// a constant or key factor (every odd q < 2^31), and for a product of two
// variables (the tensor terms) the 64-bit product reduced by reduce_wide,
// with per-tower constants the host computes (Basis.red64); the staged
// forms' tile passes keep the former % reduction. Every output is
// canonical (< q).
//
// What bounds them on an H100: device-memory bytes, except the
// conversions (K2, K45's second half), whose products bound them by 32-bit
// integer operations. At the main path's shapes (kql 31, kp 16, 2 digits,
// N = 2^16) K3 reads the two key halves and their companions (98 MB) and
// the others move 8-65 MB each, against about ten integer operations per
// word and butterfly stage.
//
// Design: K1t, K3, K45, K6 and K6f run on the cluster NTT of
// ntt_cluster.cuh (a tower per thread-block cluster, the words through
// device memory once):
//   * K1t (tensor_intt_cluster) is one launch, a cluster per Q tower: the
//     inverse cluster transform whose load hook forms c2 = a1 * b1 on the
//     16 words each thread reads first (reduce_wide), writes c2 beside and
//     hands the words on; N^-1 (B_j/b_i)^-1 is its last multiply. 4
//     launches become 1.
//   * K3 (keymul_cluster) is one launch, a cluster per tower of Q_l*P:
//     the digit loop runs inside the cluster, a digit's own towers read
//     c2's row in place of the transform, and the key product is the
//     epilogue of the forward transform's last round, on the 16 words
//     each thread holds. The two sums stay in registers until the last
//     digit writes ext; nothing else reaches device memory.
//   * K45 is the inverse cluster transform of ext's 2 * kp P rows, read
//     in place, with N^-1 (P/p_i)^-1 t^-1 folded into its last multiply,
//     into a [2, kp, N] intermediate that stays in L2 (no block can wait
//     on another's output, so the conversion is a second launch), then
//     the conversion kernel pconv: weights in shared memory, 4 columns a
//     thread with 16-byte loads, lazy Shoup products in [0, 2q) summed in
//     64 bits and reduced once.
//   * K6 (subscale_cluster) and K6f (submul_cluster) are one launch each,
//     a cluster per element row (e, tau) of the output, the two elements
//     of a tower side by side: the forward transform of convq[e, tau],
//     then an epilogue on the thread's 16 output words that reads ext (and
//     K6f's inputs, K6's addend) at the same words with 16-byte loads and
//     writes out: K6 the optional t multiply, the mod-down and the addend,
//     K6f the element's tensor term and the mod-down. No scratch, 4
//     launches become 1.
//   * K2 is pconv too, a digit per blockIdx.y with its own weights: it
//     reads the digit's rows of y in place (no zero-padded copy) and
//     writes the digit's own rows as zeros without forming a product.
// intt_scale (K1, K4) and the former forms are the device-memory stage
// launches of ntt_core.cuh plus one shared-memory tile pass (one tower,
// 256 KB, is larger than a block's shared memory), each prologue or
// epilogue riding the pass that touches the data first (inverse) or last
// (forward):
//   * intt_scale is inv_tile, which picks k rows out of every in_rows (so
//     K4 reads ext's P rows in place), then the inverse stages with
//     (N^-1 * scale) folded into the last pass. The tower count is a
//     runtime argument: the TPU's tower pairs, and the garbage row they
//     pad an odd kql with, have no counterpart.
//   * K1t's staged form: a tile pass forms c2 from a1, b1 and writes it;
//     the inverse stages follow, the last folding (N^-1 * (B_j/b_i)^-1).
//   * K3's staged form runs the forward stages over all nd * kqlp rows of
//     the extended digits, then one tile pass per (tile, tower) that loops
//     over the digits, takes c2 on own towers, and keeps both key-product
//     sums in registers (keymul_core.cuh); K45's is intt_scale's K4 form
//     into the intermediate, then rowmod_core.cuh's conversion.
//   * K6's staged form runs the forward stages over both elements' 2 * kql
//     rows, then one tile pass per (tile, element row) whose epilogue is
//     the mod-down: an optional Shoup multiply by t, the subtraction from
//     ext's Q row, the Shoup multiply by P^-1 and the optional addend.
//   * K6f's staged form is the same stages, then one tile pass per (tile,
//     Q tower) that keeps c0 and c1 of its tile in registers and runs
//     both elements' tile stages.
// The key is indexed in place (key_row), not copied. There is no bucket
// padding: tower counts are runtime arguments.

#include "keymul_core.cuh"     // K3's tile pass, shared with sharded.cu
#include "ntt_cluster.cuh"
#include "ntt_core.cuh"
#include "rowmod_core.cuh"

namespace {

// K1t's staged tile pass: c2 = a1 * b1 for one (tile, tower), written
// out, then the first inverse stages; with `scale` (no device stage
// follows) the folded constant too.
__global__ void tensor_intt_tile(const uint32_t* __restrict__ a1,
                                 const uint32_t* __restrict__ b1,
                                 uint32_t* __restrict__ c2,
                                 uint32_t* __restrict__ y,
                                 const uint32_t* __restrict__ ipsi,
                                 const uint32_t* __restrict__ ipsi_sh,
                                 const uint32_t* __restrict__ qs,
                                 const uint32_t* __restrict__ c,
                                 const uint32_t* __restrict__ c_sh,
                                 int log_n, int log_tile, int scale) {
  __shared__ uint32_t s[1 << kMaxTileLog];
  const int tower = blockIdx.y;
  const uint32_t tile = blockIdx.x;
  const uint32_t size = 1u << log_tile;
  const size_t row = static_cast<size_t>(tower) << log_n;
  const size_t base = row + (static_cast<size_t>(tile) << log_tile);
  const uint32_t q = qs[tower];
  for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) {
    const uint32_t v = mul_mod(a1[base + x], b1[base + x], q);
    c2[base + x] = v;
    s[x] = v;
  }
  __syncthreads();
  inv_tile_stages(s, ipsi + row, ipsi_sh + row, q, log_n, log_tile, tile);
  if (scale) {
    const uint32_t cv = c[tower], cv_sh = c_sh[tower];
    for (uint32_t x = threadIdx.x; x < size; x += blockDim.x)
      y[base + x] = mul_shoup(s[x], cv, cv_sh, q);
  } else {
    for (uint32_t x = threadIdx.x; x < size; x += blockDim.x)
      y[base + x] = s[x];
  }
}

// K6f's staged tile pass, one (tile, Q tower) per block: c0 = a0 b0 and
// c1 = (a0 + a1)(b0 + b1) - c0 - a1 b1 in registers, then per element e
// the last forward stages of src[e, tau] and
// out[e] = c_e + (ext[e, tau] - NTT(convq[e])) * P^-1, ext: [2, ext_rows,
// N] from the first row read.
__global__ void submul_tile(const uint32_t* __restrict__ src,
                            const uint32_t* __restrict__ ext,
                            const uint32_t* __restrict__ a0,
                            const uint32_t* __restrict__ a1,
                            const uint32_t* __restrict__ b0,
                            const uint32_t* __restrict__ b1,
                            uint32_t* __restrict__ out,
                            const uint32_t* __restrict__ psi,
                            const uint32_t* __restrict__ psi_sh,
                            const uint32_t* __restrict__ qs,
                            const uint32_t* __restrict__ pinv,
                            const uint32_t* __restrict__ pinv_sh, int kql,
                            int ext_rows, int log_n, int log_tile) {
  __shared__ uint32_t s[1 << kMaxTileLog];
  const int tau = blockIdx.y;
  const uint32_t tile = blockIdx.x;
  const uint32_t size = 1u << log_tile;
  const size_t col0 = static_cast<size_t>(tile) << log_tile;
  const size_t tw0 = static_cast<size_t>(tau) << log_n;
  const size_t base = tw0 + col0;
  const uint32_t q = qs[tau];
  const uint32_t pv = pinv[tau], pv_sh = pinv_sh[tau];
  uint32_t cs[2][kTileWords];
#pragma unroll
  for (int w = 0; w < kTileWords; ++w) {
    const uint32_t x = threadIdx.x + w * blockDim.x;
    if (x < size) {
      const uint32_t x0 = a0[base + x], x1 = a1[base + x];
      const uint32_t y0 = b0[base + x], y1 = b1[base + x];
      const uint32_t c0 = mul_mod(x0, y0, q);
      const uint32_t c2 = mul_mod(x1, y1, q);
      const uint32_t cross = mul_mod(add_mod(x0, x1, q), add_mod(y0, y1, q), q);
      cs[0][w] = c0;
      cs[1][w] = sub_mod(sub_mod(cross, c0, q), c2, q);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const uint32_t* in =
        src + ((static_cast<size_t>(e) * kql + tau) << log_n) + col0;
    for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) s[x] = in[x];
    __syncthreads();
    fwd_tile_stages(s, psi + tw0, psi_sh + tw0, q, log_n, log_tile, tile);
    const uint32_t* xe =
        ext + ((static_cast<size_t>(e) * ext_rows + tau) << log_n) + col0;
    uint32_t* oe = out + ((static_cast<size_t>(e) * kql + tau) << log_n) + col0;
#pragma unroll
    for (int w = 0; w < kTileWords; ++w) {
      const uint32_t x = threadIdx.x + w * blockDim.x;
      if (x < size) {
        const uint32_t d = mul_shoup(sub_mod(xe[x], s[x], q), pv, pv_sh, q);
        oe[x] = add_mod(cs[e][w], d, q);
      }
    }
    __syncthreads();                 // s is reloaded for the next element
  }
}

// K6 tile pass, one (tile, element row e * kql + tau) per block: the last
// forward stages of src[e, tau], then
// out[e, tau] = (ext[e, tau] - t * NTT(convq[e, tau])) * P^-1, plus
// add_e[tau] where element e's addend is not null.
__global__ void subscale_tile(const uint32_t* __restrict__ src,
                              const uint32_t* __restrict__ ext,
                              uint32_t* __restrict__ out,
                              const uint32_t* __restrict__ psi,
                              const uint32_t* __restrict__ psi_sh,
                              const uint32_t* __restrict__ qs,
                              const uint32_t* __restrict__ t,
                              const uint32_t* __restrict__ t_sh,
                              const uint32_t* __restrict__ pinv,
                              const uint32_t* __restrict__ pinv_sh,
                              const uint32_t* __restrict__ add0,
                              const uint32_t* __restrict__ add1, int kql,
                              int kqlp, int t_mul, int log_n, int log_tile) {
  __shared__ uint32_t s[1 << kMaxTileLog];
  const int row = blockIdx.y;
  const int e = row / kql;
  const int tau = row % kql;
  const uint32_t tile = blockIdx.x;
  const uint32_t size = 1u << log_tile;
  const size_t col0 = static_cast<size_t>(tile) << log_tile;
  const size_t tw0 = static_cast<size_t>(tau) << log_n;
  const size_t base = (static_cast<size_t>(row) << log_n) + col0;
  const uint32_t q = qs[tau];
  for (uint32_t x = threadIdx.x; x < size; x += blockDim.x)
    s[x] = src[base + x];
  __syncthreads();
  fwd_tile_stages(s, psi + tw0, psi_sh + tw0, q, log_n, log_tile, tile);
  const uint32_t* xe =
      ext + ((static_cast<size_t>(e) * kqlp + tau) << log_n) + col0;
  const uint32_t tv = t[tau], tv_sh = t_sh[tau];
  const uint32_t pv = pinv[tau], pv_sh = pinv_sh[tau];
  const uint32_t* add = e ? add1 : add0;
  if (add) add += tw0 + col0;
  for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) {
    uint32_t v = s[x];
    if (t_mul) v = mul_shoup(v, tv, tv_sh, q);        // block-uniform
    v = mul_shoup(sub_mod(xe[x], v, q), pv, pv_sh, q);
    out[base + x] = add ? add_mod(v, add[x], q) : v;
  }
}

// out[e, tau] = INTT(x[e * in_rows + in_off + tau]) * c[tau] for tau < k
// and e < rows / k (c = N^-1 * scale per tower): the tile pass reads the
// rows in place, the device-memory stages run in place on out.
void intt_scale_run(const uint32_t* x, int in_rows, int in_off,
                    uint32_t* out, const uint32_t* ipsi,
                    const uint32_t* ipsi_sh, const uint32_t* qs,
                    const uint32_t* c, const uint32_t* c_sh, int rows, int k,
                    int log_n, cudaStream_t st) {
  const int log_tile = tile_log(log_n);
  inv_tile<<<tile_grid(log_n, rows), tile_threads(log_tile), 0, st>>>(
      x + (static_cast<size_t>(in_off) << log_n), in_rows, out, ipsi,
      ipsi_sh, qs, c, c_sh, k, log_n, log_tile, log_tile == log_n);
  inv_stages(out, ipsi, ipsi_sh, qs, c, c_sh, rows, k, log_n, st);
}

// K3 on the cluster NTT: cluster c takes tower tau = rows - 1 - c of
// Q_l*P (the P towers, which transform every digit, start first). For
// each digit j, s_j is c2's row on the digit's own towers (tau < kql and
// j = tau / alpha), read at the words the transform would leave in each
// thread, else the forward transform of conv[j, tau]; the epilogue
// multiplies the thread's 16 words by the key rows' words at the same
// indices and adds them into the two sums, which stay in registers (128 a
// thread, so one block an SM) until the last digit writes ext. The own
// digit comes last. `own` depends on tau alone, so every block of a
// cluster takes the same branches and meets the same cluster barriers.
// conv: [nd, rows, N] COEFF; c2: [kql, N] EVAL; bv, bv_sh, av, av_sh:
// [>= nd, key_rows, N]; ext: [2, rows, N]; psi(_sh): [rows, N]; qs: [rows].
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
                   int kql, int rows, int key_rows, int key_shift) {
  using G = Geometry<LOG_N>;
  extern __shared__ __align__(16) uint32_t tile[];
  const uint32_t rank = blockIdx.x & ((1u << G::kLogC) - 1);
  const int tau = rows - 1 - static_cast<int>(blockIdx.x >> G::kLogC);
  const uint32_t q = qs[tau];
  const size_t tw0 = static_cast<size_t>(tau) << LOG_N;
  const int krow = tau < kql ? tau : tau + key_shift;
  const uint32_t x0 = fwd_out_word<LOG_N>(rank, threadIdx.x);
  const uint32_t* key[4] = {bv, bv_sh, av, av_sh};
  const int own_digit = tau < kql ? tau / alpha : nd;     // nd: none
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
      load_words(a, c2 + tw0 + x0);
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
                              const uint32_t*, int, int, int, int, int, int);

template <int... I>
KeymulKernel keymul_kernel(int log_n, std::integer_sequence<int, I...>) {
  static const KeymulKernel kernels[] = {
      keymul_cluster<kMinClusterLogN + I>...};
  return kernels[log_n - kMinClusterLogN];
}

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

// Four words at p (16-byte aligned, read-only in the kernel) as an array.
struct Words4 {
  uint32_t v[4];
};

__device__ __forceinline__ Words4 load4(const uint32_t* p) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  return {{w.x, w.y, w.z, w.w}};
}

// K6f's operands: one kernel parameter, read in place (__grid_constant__).
struct SubmulArgs {
  const uint32_t* convq;     // [2, kql, N] COEFF
  const uint32_t* ext;       // [2, ext_rows, N] EVAL, rows ext_off + tau
  const uint32_t* a0;        // [kql, N] EVAL each
  const uint32_t* a1;
  const uint32_t* b0;
  const uint32_t* b1;
  uint32_t* out;             // [2, kql, N] EVAL
  const uint32_t* psi;       // [kql, N]
  const uint32_t* psi_sh;
  const uint32_t* qs;        // [kql]
  const uint32_t* pinv;      // [kql] P^-1 mod q_i
  const uint32_t* pinv_sh;
  const uint32_t* red;       // [kql, 3] Basis.red64
  int kql, ext_rows, ext_off;
};

// One element of K6f in a cluster: the forward transform of convq[E, tau]
// and the epilogue on each thread's kR consecutive output words a at row
// word x: out[E, tau] = c_E + (ext[E, ext_off + tau] - a) * P^-1, where
// c_0 = a0 b0 and c_1 = a0 b1 + a1 b0 (equal mod q to the Karatsuba form
// (a0 + a1)(b0 + b1) - a0 b0 - a1 b1 of the TPU kernel, which shares c0
// with element 0; here each element has its own cluster, and two
// products are fewer than three). Each product sum is below 2^63 and is
// reduced once (reduce_wide). What the epilogue needs (its addresses,
// P^-1, the reduction constants) it derives there, after the transform;
// its words go 4 at a time with 16-byte loads.
template <int E, int LOG_N>
__device__ __forceinline__ void submul_row(const SubmulArgs& p, int tau,
                                           uint32_t* tile) {
  const uint32_t q = p.qs[tau];
  auto epi = [&](const uint32_t (&a)[kR], uint32_t x) {
    const size_t row = static_cast<size_t>(tau) << LOG_N;
    const uint32_t* xe =
        p.ext +
        ((static_cast<size_t>(E) * p.ext_rows + p.ext_off + tau) << LOG_N);
    uint32_t* oe =
        p.out + ((static_cast<size_t>(E) * p.kql + tau) << LOG_N);
    const uint32_t pv = p.pinv[tau], pv_sh = p.pinv_sh[tau];
    const uint32_t r32 = p.red[3 * tau], r32_sh = p.red[3 * tau + 1],
                   m32 = p.red[3 * tau + 2];
#pragma unroll
    for (int v = 0; v < kR / 4; ++v) {
      const size_t at = row + x + 4 * v;
      const Words4 xv = load4(xe + x + 4 * v), p0 = load4(p.a0 + at),
                   q0 = load4(p.b0 + at);
      Words4 p1 = {}, q1 = {};
      if constexpr (E == 1) {
        p1 = load4(p.a1 + at);
        q1 = load4(p.b1 + at);
      }
      uint32_t r[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        uint64_t s;
        if constexpr (E == 0)
          s = static_cast<uint64_t>(p0.v[l]) * q0.v[l];
        else
          s = static_cast<uint64_t>(p0.v[l]) * q1.v[l] +
              static_cast<uint64_t>(p1.v[l]) * q0.v[l];
        const uint32_t c = reduce_wide(s, q, r32, r32_sh, m32);
        const uint32_t d =
            mul_shoup_q(sub_q(xv.v[l], a[4 * v + l], q), pv, pv_sh, q);
        r[l] = add_q(c, d, q);
      }
      *reinterpret_cast<uint4*>(oe + x + 4 * v) =
          make_uint4(r[0], r[1], r[2], r[3]);
    }
  };
  const size_t tw0 = static_cast<size_t>(tau) << LOG_N;
  fwd_cluster_row<LOG_N>(
      p.convq + ((static_cast<size_t>(E) * p.kql + tau) << LOG_N),
      p.psi + tw0, p.psi_sh + tw0, q, tile, epi);
}

// K6f on the cluster NTT: cluster c takes element e = c % 2 of Q tower
// tau = c / 2 (the two elements of a tower run side by side, so the
// second reads a0, b0 and the twiddles from L2). One transform a cluster:
// a cluster that ran both elements' transforms one after the other kept
// the first's twiddles in registers for the second (the compiler merges
// the identical read-only loads), spilling 500-900 bytes a thread at 64
// registers. One block of 512 threads holds 2^13 words up to N = 2^16, so
// at 64 registers two blocks share an SM: 62 clusters of 8 in two waves.
template <int LOG_N>
__global__ void __launch_bounds__(Geometry<LOG_N>::kThreads,
                                  Geometry<LOG_N>::kMinBlocks)
    submul_cluster(const __grid_constant__ SubmulArgs p) {
  extern __shared__ __align__(16) uint32_t tile[];
  const uint32_t c = blockIdx.x >> Geometry<LOG_N>::kLogC;
  const int tau = static_cast<int>(c >> 1);
  if (c & 1)
    submul_row<1, LOG_N>(p, tau, tile);
  else
    submul_row<0, LOG_N>(p, tau, tile);
}

using SubmulKernel = void (*)(const SubmulArgs);

template <int... I>
SubmulKernel submul_kernel(int log_n, std::integer_sequence<int, I...>) {
  static const SubmulKernel kernels[] = {
      submul_cluster<kMinClusterLogN + I>...};
  return kernels[log_n - kMinClusterLogN];
}

// K1t on the cluster NTT: cluster c takes Q tower tau = c; the inverse
// cluster transform (inv_cluster_row) whose load hook forms the tensor
// product c2 = a1 * b1 on each thread's kR consecutive words, 4 at a time
// with 16-byte loads, each 64-bit product reduced by reduce_wide with the
// tower's Basis.red64 row, writes c2 at the words it read (EVAL, as it
// came) as soon as it is formed, and hands the words to the transform; its
// last multiply folds N^-1 (B_j/b_i)^-1 (scale) in. a1, b1, c2, y: [kql, N];
// ipsi(_sh): [kql, N]; qs, scale(_sh): [kql]; red: [kql, 3].
template <int LOG_N>
__global__ void __launch_bounds__(Geometry<LOG_N>::kThreads,
                                  Geometry<LOG_N>::kMinBlocks)
    tensor_intt_cluster(const uint32_t* __restrict__ a1,
                        const uint32_t* __restrict__ b1,
                        uint32_t* __restrict__ c2, uint32_t* y,
                        const uint32_t* __restrict__ ipsi,
                        const uint32_t* __restrict__ ipsi_sh,
                        const uint32_t* __restrict__ qs,
                        const uint32_t* __restrict__ scale,
                        const uint32_t* __restrict__ scale_sh,
                        const uint32_t* __restrict__ red) {
  extern __shared__ __align__(16) uint32_t tile[];
  const int tau = static_cast<int>(blockIdx.x >> Geometry<LOG_N>::kLogC);
  const size_t row = static_cast<size_t>(tau) << LOG_N;
  const uint32_t q = qs[tau];
  auto load = [&](uint32_t (&a)[kR], uint32_t x) {
    const uint32_t r32 = red[3 * tau], r32_sh = red[3 * tau + 1],
                   m32 = red[3 * tau + 2];
#pragma unroll
    for (int v = 0; v < kR / 4; ++v) {
      const size_t at = row + x + 4 * v;
      const Words4 u = load4(a1 + at), w = load4(b1 + at);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        a[4 * v + l] = reduce_wide(static_cast<uint64_t>(u.v[l]) * w.v[l], q,
                                   r32, r32_sh, m32);
      *reinterpret_cast<uint4*>(c2 + at) =
          make_uint4(a[4 * v], a[4 * v + 1], a[4 * v + 2], a[4 * v + 3]);
    }
  };
  inv_cluster_row<LOG_N>(load, y + row, ipsi + row, ipsi_sh + row, q,
                         scale + tau, scale_sh + tau, tile);
}

using TensorInttKernel = void (*)(const uint32_t*, const uint32_t*,
                                  uint32_t*, uint32_t*, const uint32_t*,
                                  const uint32_t*, const uint32_t*,
                                  const uint32_t*, const uint32_t*,
                                  const uint32_t*);

template <int... I>
TensorInttKernel tensor_intt_kernel(int log_n,
                                    std::integer_sequence<int, I...>) {
  static const TensorInttKernel kernels[] = {
      tensor_intt_cluster<kMinClusterLogN + I>...};
  return kernels[log_n - kMinClusterLogN];
}

// K6's operands: one kernel parameter, read in place (__grid_constant__).
struct SubscaleArgs {
  const uint32_t* convq;     // [2, kql, N] COEFF
  const uint32_t* ext;       // [2, ext_rows, N] EVAL, rows tau < kql read
  const uint32_t* add0;      // [kql, N] EVAL, added to element 0, or null
  const uint32_t* add1;      // the same for element 1
  uint32_t* out;             // [2, kql, N] EVAL
  const uint32_t* psi;       // [kql, N]
  const uint32_t* psi_sh;
  const uint32_t* qs;        // [kql]
  const uint32_t* t;         // [kql] t mod q_i, read when t_mul
  const uint32_t* t_sh;
  const uint32_t* pinv;      // [kql] P^-1 mod q_i
  const uint32_t* pinv_sh;
  int kql, ext_rows, t_mul;
};

// K6 on the cluster NTT, in submul_cluster's shape: cluster c takes element
// e = c % 2 of Q tower tau = c / 2 (one transform a cluster), the forward
// transform of convq[e, tau], then an epilogue on each thread's kR
// consecutive output words a at row word x, 4 at a time with 16-byte
// loads: out[e, tau] = (ext[e, tau] - t a) * P^-1 (t a by a Shoup
// multiply, only when t_mul: the transform's words are canonical already),
// plus add_e[tau] where element e's addend is set (Relinearize's e0 / e1,
// an automorphism's or KeySwitch's c0: the caller's final add, in no extra
// launch). t_mul and the addend's pointer are uniform over the cluster.
template <int LOG_N>
__global__ void __launch_bounds__(Geometry<LOG_N>::kThreads,
                                  Geometry<LOG_N>::kMinBlocks)
    subscale_cluster(const __grid_constant__ SubscaleArgs p) {
  extern __shared__ __align__(16) uint32_t tile[];
  const uint32_t c = blockIdx.x >> Geometry<LOG_N>::kLogC;
  const int e = static_cast<int>(c & 1), tau = static_cast<int>(c >> 1);
  const uint32_t q = p.qs[tau];
  const size_t tw0 = static_cast<size_t>(tau) << LOG_N;
  auto epi = [&](const uint32_t (&a)[kR], uint32_t x) {
    const uint32_t* xe =
        p.ext + ((static_cast<size_t>(e) * p.ext_rows + tau) << LOG_N);
    uint32_t* oe = p.out + ((static_cast<size_t>(e) * p.kql + tau) << LOG_N);
    const uint32_t* add = e ? p.add1 : p.add0;
    const uint32_t pv = p.pinv[tau], pv_sh = p.pinv_sh[tau];
    uint32_t tv = 0, tv_sh = 0;
    if (p.t_mul) {
      tv = p.t[tau];
      tv_sh = p.t_sh[tau];
    }
#pragma unroll
    for (int v = 0; v < kR / 4; ++v) {
      const Words4 xv = load4(xe + x + 4 * v);
      Words4 av = {};
      if (add) av = load4(add + tw0 + x + 4 * v);
      uint32_t r[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        uint32_t w = a[4 * v + l];
        if (p.t_mul) w = mul_shoup_q(w, tv, tv_sh, q);
        r[l] = mul_shoup_q(sub_q(xv.v[l], w, q), pv, pv_sh, q);
        if (add) r[l] = add_q(r[l], av.v[l], q);
      }
      *reinterpret_cast<uint4*>(oe + x + 4 * v) =
          make_uint4(r[0], r[1], r[2], r[3]);
    }
  };
  fwd_cluster_row<LOG_N>(
      p.convq + ((static_cast<size_t>(e) * p.kql + tau) << LOG_N),
      p.psi + tw0, p.psi_sh + tw0, q, tile, epi);
}

using SubscaleKernel = void (*)(const SubscaleArgs);

template <int... I>
SubscaleKernel subscale_kernel(int log_n, std::integer_sequence<int, I...>) {
  static const SubscaleKernel kernels[] = {
      subscale_cluster<kMinClusterLogN + I>...};
  return kernels[log_n - kMinClusterLogN];
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

// The conversion of K45 (P -> Q_l) and K2 (each digit -> Q_l*P):
//   out[b, j, n] = sum_{i < rows_b} y[b a_dim + i, n] * w_b[i, j] mod d_j,
// y: [>= a_total, N] (batch b's rows b a_dim .. b a_dim + rows_b - 1,
// rows_b = min(a_dim, a_total - b a_dim)), w_b(_sh) = w(_sh) + b w_stride:
// [a_dim, d_dim] (w_stride 0: one table for every batch), d: [d_dim],
// red: [d_dim, 3] (Basis.red64 of d), out: [batch, d_dim, N]. With `own`,
// batch b's own rows (j in [b a_dim, b a_dim + rows_b), K2's digit rows,
// whose weights are zero) are written as zeros without a product. What
// bounds it is integer issue: rows_b * (d_dim - own rows) Shoup products
// a column. So each thread holds COLS consecutive columns of the batch's
// rows in registers (16-byte loads) and, for each output row, forms the
// lazy Shoup products x * w - floor(x * w_sh / 2^32) * d_j in [0, 2 d_j)
// (exact in 32 bits for d_j < 2^31) and sums them in 64 bits (a_dim <
// 2^32 of them cannot overflow), then reduces the sum once
// (reduce_wide). The weights (w, w_sh) and the per-row constants sit in
// shared memory; blockIdx.z takes an equal share of the batch's converted
// rows (and of its own rows) so that enough blocks fill the card.
constexpr int kConvThreads = 128;

template <int MAXA, int COLS>
__global__ void __launch_bounds__(kConvThreads)
    pconv(const uint32_t* __restrict__ y, const uint32_t* __restrict__ w,
          const uint32_t* __restrict__ w_sh,
          const uint32_t* __restrict__ d, const uint32_t* __restrict__ red,
          uint32_t* __restrict__ out, int a_dim, int a_total, int d_dim,
          int n, int w_stride, int own) {
  extern __shared__ uint4 conv_sm[];
  uint4* consts = conv_sm;               // [d_dim]: d, 2^32 mod d, its
                                         // companion, floor(2^32 / d)
  uint2* sw = reinterpret_cast<uint2*>(conv_sm + d_dim);  // [rows, d_dim]
  const int b = blockIdx.y;
  const int rows = min(a_dim, a_total - b * a_dim);
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
  // k, or k + n_own past the own rows) and of the own rows
  const int own_lo = b * a_dim, n_own = own ? rows : 0;
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
                 int w_stride, int own, cudaStream_t st) {
  const size_t smem = 16 * static_cast<size_t>(d_dim) +
                      8 * static_cast<size_t>(a_dim) * d_dim;
  // as many blocks as fit on the card at once: split the output rows. The
  // blocks an SM holds depend on smem, so a few sizes are remembered (K2
  // and K45 alternate in every key switch).
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
      y, w, w_sh, d, red, out, a_dim, a_total, d_dim, n, w_stride, own);
  return 0;
}

// Checks the shape (every batch has a row, the tables fit 48 KB of shared
// memory, rows of N a multiple of 4 words on 16-byte boundaries) and
// launches; returns a CUDA error code, 0 when launched.
int pconv_run(const uint32_t* y, const uint32_t* w, const uint32_t* w_sh,
              const uint32_t* d, const uint32_t* red, uint32_t* out,
              int batch, int a_dim, int a_total, int d_dim, int n,
              int w_stride, int own, cudaStream_t st) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(out);
  if (batch < 1 || batch > 65535 || a_dim < 1 || a_dim > 64 || d_dim < 1 ||
      a_total > batch * a_dim || a_total <= (batch - 1) * a_dim ||
      w_stride < 0 || n < 4 || n % 4 != 0 || align % 16 != 0 ||
      16 * d_dim + 8 * a_dim * d_dim > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a_dim <= 8)
    return pconv_launch<8, 4>(y, w, w_sh, d, red, out, batch, a_dim, a_total,
                              d_dim, n, w_stride, own, st);
  if (a_dim <= 16)
    return pconv_launch<16, 4>(y, w, w_sh, d, red, out, batch, a_dim,
                               a_total, d_dim, n, w_stride, own, st);
  if (a_dim <= 32)
    return pconv_launch<32, 2>(y, w, w_sh, d, red, out, batch, a_dim,
                               a_total, d_dim, n, w_stride, own, st);
  return pconv_launch<64, 1>(y, w, w_sh, d, red, out, batch, a_dim, a_total,
                             d_dim, n, w_stride, own, st);
}

int keymul_placeable[kMaxClusterLogN + 1],
    intt_p_placeable[kMaxClusterLogN + 1],
    submul_placeable[kMaxClusterLogN + 1],
    tensor_intt_placeable[kMaxClusterLogN + 1],
    subscale_placeable[kMaxClusterLogN + 1];

}  // namespace

// a1, b1, c2, y: [kql, N] words; ipsi(_sh): [kql, N] of the Q_l towers;
// q, scale(_sh): [kql] with scale = N^-1 * (B_j/b_i)^-1 mod q_i; red:
// [kql, 3] (Basis.red64 of Q_l). One launch of tensor_intt_cluster; refuses
// rings outside 2^4 .. 2^17 (tensor_intt_staged serves them) and operands
// off a 16-byte boundary.
extern "C" int tensor_intt(const void* a1, const void* b1, void* c2, void* y,
                           const void* ipsi, const void* ipsi_sh,
                           const void* q, const void* scale,
                           const void* scale_sh, const void* red, int kql,
                           int log_n, void* stream) {
  if (int bad = check_cluster(a1, y, kql, kql, log_n)) return bad;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(b1) | reinterpret_cast<uintptr_t>(c2);
  if (align % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  return launch_cluster(tensor_intt_kernel(log_n, ClusterRings{}),
                        &tensor_intt_placeable[log_n], kql, log_n,
                        static_cast<cudaStream_t>(stream), in(a1), in(b1),
                        static_cast<uint32_t*>(c2), static_cast<uint32_t*>(y),
                        in(ipsi), in(ipsi_sh), in(q), in(scale),
                        in(scale_sh), in(red));
}

// The same function on the staged NTT passes, any ring: tensor_intt_tile,
// then the inverse stages of ntt_core.cuh; the arguments of tensor_intt
// without red.
extern "C" int tensor_intt_staged(const void* a1, const void* b1, void* c2,
                                  void* y, const void* ipsi,
                                  const void* ipsi_sh, const void* q,
                                  const void* scale, const void* scale_sh,
                                  int kql, int log_n, void* stream) {
  if (int bad = check_shape(kql, kql, log_n)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* yp = static_cast<uint32_t*>(y);
  const auto* w = static_cast<const uint32_t*>(ipsi);
  const auto* w_sh = static_cast<const uint32_t*>(ipsi_sh);
  const auto* qs = static_cast<const uint32_t*>(q);
  const auto* c = static_cast<const uint32_t*>(scale);
  const auto* c_sh = static_cast<const uint32_t*>(scale_sh);
  const int log_tile = tile_log(log_n);
  tensor_intt_tile<<<tile_grid(log_n, kql), tile_threads(log_tile), 0, st>>>(
      static_cast<const uint32_t*>(a1), static_cast<const uint32_t*>(b1),
      static_cast<uint32_t*>(c2), yp, w, w_sh, qs, c, c_sh, log_n, log_tile,
      log_tile == log_n);
  inv_stages(yp, w, w_sh, qs, c, c_sh, kql, kql, log_n, st);
  return static_cast<int>(cudaGetLastError());
}

// x: [e, in_rows, N]; out: [e, k, N] COEFF with out[., tau] from row
// in_off + tau of each element; ipsi(_sh): [k, N] and q, scale(_sh): [k]
// of those k towers, with scale = N^-1 * (per-tower constant) mod q.
extern "C" int intt_scale(const void* x, void* out, const void* ipsi,
                          const void* ipsi_sh, const void* q,
                          const void* scale, const void* scale_sh, int e,
                          int k, int in_rows, int in_off, int log_n,
                          void* stream) {
  if (int bad = check_shape(e * k, k, log_n)) return bad;
  if (in_off < 0 || in_rows < in_off + k)
    return static_cast<int>(cudaErrorInvalidValue);
  intt_scale_run(static_cast<const uint32_t*>(x), in_rows, in_off,
                 static_cast<uint32_t*>(out),
                 static_cast<const uint32_t*>(ipsi),
                 static_cast<const uint32_t*>(ipsi_sh),
                 static_cast<const uint32_t*>(q),
                 static_cast<const uint32_t*>(scale),
                 static_cast<const uint32_t*>(scale_sh), e * k, k, log_n,
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// y: [kql, N] COEFF (digit j's rows j * alpha .. min((j + 1) * alpha,
// kql) - 1, read in place); w, w_sh: [nd, alpha, kqlp]; q: [kqlp]; red:
// [kqlp, 3] (Basis.red64 of Q_l*P); out: [nd, kqlp, N], zero on each
// digit's own rows. One launch of pconv.
extern "C" int conv_digits(const void* y, const void* w, const void* w_sh,
                           const void* q, const void* red, void* out, int nd,
                           int alpha, int kql, int kqlp, int n,
                           void* stream) {
  if (kql > kqlp || static_cast<long long>(alpha) * kqlp > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  if (int bad = pconv_run(in(y), in(w), in(w_sh), in(q), in(red),
                          static_cast<uint32_t*>(out), nd, alpha, kql, kqlp,
                          n, alpha * kqlp, 1,
                          static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// y: [nd, alpha, N] (each digit's rows, zero-padded to alpha); w, w_sh:
// [nd, alpha, kqlp]; q: [kqlp]; out: [nd, kqlp, N]. K2's former form:
// rowmod_core.cuh's conversion, every product of the padded rows formed.
extern "C" int conv_digits_rowmod(const void* y, const void* w,
                                  const void* w_sh, const void* q, void* out,
                                  int nd, int alpha, int kqlp, int n,
                                  void* stream) {
  if (int bad = rowmod_run(static_cast<const uint32_t*>(y),
                           static_cast<const uint32_t*>(w),
                           static_cast<const uint32_t*>(w_sh),
                           static_cast<const uint32_t*>(q),
                           static_cast<uint32_t*>(out), nd, alpha, kqlp, n,
                           static_cast<size_t>(alpha) * kqlp,
                           static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// conv: [nd, kqlp, N] COEFF; c2: [kql, N] EVAL; bv, bv_sh, av, av_sh:
// [>= nd, key_rows, N] with key_rows = k_q_full + kp; ext: [2, kqlp, N];
// psi(_sh): [kqlp, N]; q: [kqlp]. One launch of keymul_cluster; refuses
// rings outside 2^4 .. 2^17 (ntt_keymul_acc_staged serves them) and
// operands off a 16-byte boundary.
extern "C" int ntt_keymul_acc(const void* conv, const void* c2,
                              const void* bv, const void* bv_sh,
                              const void* av, const void* av_sh, void* ext,
                              const void* psi, const void* psi_sh,
                              const void* q, int nd, int alpha, int kql,
                              int kp, int k_q_full, int log_n,
                              void* stream) {
  const int rows = kql + kp;
  if (int bad = check_cluster(conv, ext, rows, rows, log_n)) return bad;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(c2) | reinterpret_cast<uintptr_t>(bv) |
      reinterpret_cast<uintptr_t>(bv_sh) | reinterpret_cast<uintptr_t>(av) |
      reinterpret_cast<uintptr_t>(av_sh);
  if (k_q_full < kql || kp < 0 || nd < 1 || alpha < 1 ||
      nd * alpha < kql || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  return launch_cluster(keymul_kernel(log_n, ClusterRings{}),
                        &keymul_placeable[log_n], rows, log_n,
                        static_cast<cudaStream_t>(stream), in(conv), in(c2),
                        in(bv), in(bv_sh), in(av), in(av_sh),
                        static_cast<uint32_t*>(ext), in(psi), in(psi_sh),
                        in(q), nd, alpha, kql, rows, k_q_full + kp,
                        k_q_full - kql);
}

// conv: [nd, kqlp, N] COEFF; c2: [kql, N] EVAL; bv, bv_sh, av, av_sh:
// [>= nd, key_rows, N] with key_rows = k_q_full + kp; scratch: [nd, kqlp,
// N]; ext: [2, kqlp, N]; psi(_sh): [kqlp, N]; q: [kqlp]. The forward
// stages of ntt_core.cuh over all nd * kqlp rows, then keymul_tile.
extern "C" int ntt_keymul_acc_staged(const void* conv,
                                     const void* c2,
                                     const void* bv, const void* bv_sh,
                                     const void* av, const void* av_sh,
                                     void* scratch, void* ext,
                                     const void* psi, const void* psi_sh,
                                     const void* q, int nd, int alpha,
                                     int kql, int kp, int k_q_full,
                                     int log_n, void* stream) {
  if (k_q_full < kql) return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  // all Q_l*P towers from row 0; the key skips the Q towers above the level
  if (int bad = keymul_run(in(conv), in(c2), in(bv), in(bv_sh), in(av),
                           in(av_sh), static_cast<uint32_t*>(scratch),
                           static_cast<uint32_t*>(ext), in(psi), in(psi_sh),
                           in(q), nd, alpha, kql, 0, kql + kp, k_q_full + kp,
                           kql, k_q_full - kql, log_n,
                           static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// ext: [2, kql + kp, N] EVAL; pc: [2, kp, N] scratch; out: [2, kql, N]
// COEFF. ipsi(_sh): [kp, N] and qp, scale(_sh): [kp] of the P towers, with
// scale = N^-1 * (P/p_i)^-1 * t^-1 mod p_i; w, w_sh: [kp, kql]; qq: [kql];
// red: [kql, 3] (Basis.red64 of Q_l). The inverse cluster transform of
// ext's P rows, read in place, with the scale as its last multiply, then
// pconv; refuses rings outside 2^4 .. 2^17 (intt_conv_p_staged serves
// them).
extern "C" int intt_conv_p(const void* ext, void* pc, void* out,
                           const void* ipsi, const void* ipsi_sh,
                           const void* qp, const void* scale,
                           const void* scale_sh, const void* w,
                           const void* w_sh, const void* qq, const void* red,
                           int kql, int kp, int log_n, void* stream) {
  if (int bad = check_cluster(ext, pc, 2 * kp, kp, log_n)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  auto* pcp = static_cast<uint32_t*>(pc);
  if (int bad = launch_cluster(inv_kernel(log_n, ClusterRings{}),
                               &intt_p_placeable[log_n], 2 * kp, log_n,
                               st, in(ext), pcp, in(ipsi), in(ipsi_sh),
                               in(qp), in(scale), in(scale_sh), kp, kql + kp,
                               kql))
    return bad;
  if (int bad = pconv_run(pcp, in(w), in(w_sh), in(qq), in(red),
                          static_cast<uint32_t*>(out), 2, kp, 2 * kp, kql,
                          1 << log_n, 0, 0, st))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// ext: [2, kql + kp, N] EVAL; pc: [2, kp, N] scratch; out: [2, kql, N]
// COEFF. ipsi(_sh): [kp, N] and qp, scale(_sh): [kp] of the P towers, with
// scale = N^-1 * (P/p_i)^-1 * t^-1 mod p_i; w, w_sh: [kp, kql]; qq: [kql].
// intt_scale's K4 form, then rowmod_core.cuh's conversion.
extern "C" int intt_conv_p_staged(const void* ext, void* pc, void* out,
                                  const void* ipsi, const void* ipsi_sh,
                                  const void* qp, const void* scale,
                                  const void* scale_sh, const void* w,
                                  const void* w_sh, const void* qq, int kql,
                                  int kp, int log_n, void* stream) {
  if (int bad = check_shape(2 * kp, kp, log_n)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pcp = static_cast<uint32_t*>(pc);
  intt_scale_run(static_cast<const uint32_t*>(ext), kql + kp, kql, pcp,
                 static_cast<const uint32_t*>(ipsi),
                 static_cast<const uint32_t*>(ipsi_sh),
                 static_cast<const uint32_t*>(qp),
                 static_cast<const uint32_t*>(scale),
                 static_cast<const uint32_t*>(scale_sh), 2 * kp, kp, log_n,
                 st);
  if (int bad = rowmod_run(pcp, static_cast<const uint32_t*>(w),
                           static_cast<const uint32_t*>(w_sh),
                           static_cast<const uint32_t*>(qq),
                           static_cast<uint32_t*>(out), 2, kp, kql,
                           1 << log_n, 0, st))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// convq: [2, kql, N] COEFF; ext: [2, kql + kp, N] EVAL; out: [2, kql, N];
// psi(_sh): [kql, N]; q, t(_sh), pinv(_sh): [kql] with t = ns_int mod q_i
// (multiplied only when t_mul) and pinv = P^-1 mod q_i; add0, add1: [kql,
// N] EVAL or null, added to element 0 / 1 of out. One launch of
// subscale_cluster; refuses rings outside 2^4 .. 2^17 (ntt_subscale_staged
// serves them) and operands off a 16-byte boundary.
extern "C" int ntt_subscale(const void* convq, const void* ext, void* out,
                            const void* psi, const void* psi_sh,
                            const void* q, const void* t, const void* t_sh,
                            const void* pinv, const void* pinv_sh,
                            const void* add0, const void* add1, int kql,
                            int kp, int t_mul, int log_n, void* stream) {
  if (int bad = check_cluster(convq, out, 2 * kql, kql, log_n)) return bad;
  const uintptr_t align = reinterpret_cast<uintptr_t>(ext) |
                          reinterpret_cast<uintptr_t>(add0) |
                          reinterpret_cast<uintptr_t>(add1);
  if (kp < 0 || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  const SubscaleArgs args = {in(convq), in(ext), in(add0), in(add1),
                             static_cast<uint32_t*>(out), in(psi),
                             in(psi_sh), in(q), in(t), in(t_sh), in(pinv),
                             in(pinv_sh), kql, kql + kp, t_mul};
  return launch_cluster(subscale_kernel(log_n, ClusterRings{}),
                        &subscale_placeable[log_n], 2 * kql, log_n,
                        static_cast<cudaStream_t>(stream), args);
}

// The same function on the staged NTT passes, any ring: the forward stages
// of ntt_core.cuh over both elements' rows into scratch ([2, kql, N]), then
// subscale_tile; the arguments of ntt_subscale with scratch before out.
extern "C" int ntt_subscale_staged(const void* convq, const void* ext,
                                   void* scratch, void* out, const void* psi,
                                   const void* psi_sh, const void* q,
                                   const void* t, const void* t_sh,
                                   const void* pinv, const void* pinv_sh,
                                   const void* add0, const void* add1,
                                   int kql, int kp, int t_mul, int log_n,
                                   void* stream) {
  if (int bad = check_shape(2 * kql, kql, log_n)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(psi);
  const auto* w_sh = static_cast<const uint32_t*>(psi_sh);
  const auto* qs = static_cast<const uint32_t*>(q);
  const uint32_t* src =
      fwd_stages(static_cast<const uint32_t*>(convq),
                 static_cast<uint32_t*>(scratch), w, w_sh, qs, 2 * kql, kql,
                 log_n, st);
  const int log_tile = tile_log(log_n);
  subscale_tile<<<tile_grid(log_n, 2 * kql), tile_threads(log_tile), 0,
                  st>>>(src, static_cast<const uint32_t*>(ext),
                        static_cast<uint32_t*>(out), w, w_sh, qs,
                        static_cast<const uint32_t*>(t),
                        static_cast<const uint32_t*>(t_sh),
                        static_cast<const uint32_t*>(pinv),
                        static_cast<const uint32_t*>(pinv_sh),
                        static_cast<const uint32_t*>(add0),
                        static_cast<const uint32_t*>(add1), kql, kql + kp,
                        t_mul, log_n, log_tile);
  return static_cast<int>(cudaGetLastError());
}

// convq: [2, kql, N] COEFF; ext: [2, ext_rows, N] EVAL, of which rows
// ext_off .. ext_off + kql - 1 are read (in place: the sharded path passes
// the gathered ext); a0, a1, b0, b1: [kql, N] EVAL; out: [2, kql, N];
// psi(_sh): [kql, N]; q, pinv(_sh): [kql] with pinv = P^-1 mod q_i; red:
// [kql, 3] (Basis.red64). One launch of submul_cluster; refuses rings
// outside 2^4 .. 2^17 (ntt_submul_final_staged serves them) and operands
// off a 16-byte boundary.
extern "C" int ntt_submul_final(const void* convq, const void* ext,
                                const void* a0, const void* a1,
                                const void* b0, const void* b1, void* out,
                                const void* psi, const void* psi_sh,
                                const void* q, const void* pinv,
                                const void* pinv_sh, const void* red,
                                int kql, int ext_rows, int ext_off,
                                int log_n, void* stream) {
  if (int bad = check_cluster(convq, out, 2 * kql, kql, log_n)) return bad;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(ext) | reinterpret_cast<uintptr_t>(a0) |
      reinterpret_cast<uintptr_t>(a1) | reinterpret_cast<uintptr_t>(b0) |
      reinterpret_cast<uintptr_t>(b1);
  if (ext_off < 0 || ext_rows < ext_off + kql || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  const SubmulArgs args = {in(convq), in(ext), in(a0), in(a1), in(b0),
                           in(b1), static_cast<uint32_t*>(out), in(psi),
                           in(psi_sh), in(q), in(pinv), in(pinv_sh), in(red),
                           kql, ext_rows, ext_off};
  return launch_cluster(submul_kernel(log_n, ClusterRings{}),
                        &submul_placeable[log_n], 2 * kql, log_n,
                        static_cast<cudaStream_t>(stream), args);
}

// The same function on the staged NTT passes, any ring: the forward
// stages of ntt_core.cuh over both elements' rows into scratch ([2, kql,
// N]), then submul_tile; the arguments of ntt_submul_final with scratch in
// place of red.
extern "C" int ntt_submul_final_staged(const void* convq, const void* ext,
                                       const void* a0, const void* a1,
                                       const void* b0, const void* b1,
                                       void* scratch, void* out,
                                       const void* psi, const void* psi_sh,
                                       const void* q, const void* pinv,
                                       const void* pinv_sh, int kql,
                                       int ext_rows, int ext_off, int log_n,
                                       void* stream) {
  if (int bad = check_shape(2 * kql, kql, log_n)) return bad;
  if (ext_off < 0 || ext_rows < ext_off + kql)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(psi);
  const auto* w_sh = static_cast<const uint32_t*>(psi_sh);
  const auto* qs = static_cast<const uint32_t*>(q);
  const uint32_t* src =
      fwd_stages(static_cast<const uint32_t*>(convq),
                 static_cast<uint32_t*>(scratch), w, w_sh, qs, 2 * kql, kql,
                 log_n, st);
  const int log_tile = tile_log(log_n);
  submul_tile<<<tile_grid(log_n, kql), tile_threads(log_tile), 0, st>>>(
      src,
      static_cast<const uint32_t*>(ext) +
          (static_cast<size_t>(ext_off) << log_n),
      static_cast<const uint32_t*>(a0), static_cast<const uint32_t*>(a1),
      static_cast<const uint32_t*>(b0), static_cast<const uint32_t*>(b1),
      static_cast<uint32_t*>(out), w, w_sh, qs,
      static_cast<const uint32_t*>(pinv),
      static_cast<const uint32_t*>(pinv_sh), kql, ext_rows, log_n, log_tile);
  return static_cast<int>(cudaGetLastError());
}
