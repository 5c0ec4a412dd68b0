// The limb-sharded HYBRID key switch for Hopper (sm_90a): the three kernels
// of openfhe_tpu/parallel/sharded_fused.py's mult_relin_fused_local that
// act on one shard's rows of the Q_l*P (or Q_l) tower axis. Each computes
// the function of an unsharded kernel of ks_fused.cu, restricted to the
// row range the shard owns:
//
//   conv_digits_rows     replaces _conv_digits_rows (n, pallas_call :318):
//                        every digit of the gathered y extended to the
//                        shard's Q_l*P rows, the digit's own rows zero (K2
//                        on the shard's weight columns)
//   conv_p_to_q_rows     replaces _conv_p_to_q_rows (o, :348): the P -> Q_l
//                        conversion of the mod-down onto the shard's Q rows
//                        (K45's conversion half)
//   ntt_keymul_acc_rows  replaces _ntt_keymul_acc_sharded (p, :396): K3 on
//                        the shard's Q_l*P rows, a row being a digit's own
//                        by its global tower index (tau0 + local row)
//
// The TPU kernels multiply int8 limbs on the MXU (the pair-layout weight
// stacks, an SMEM own-mask); here the weights are canonical residues with
// Shoup companions, and the device code is the unsharded kernels' own:
// rowmod_core.cuh's conversion with the shard's weight columns, and
// keymul_core.cuh's stages and tile pass with a global row offset.
//
// What bounds them on an H100: device-memory bytes, as for the unsharded
// kernels (ks_fused.cu's header): at the main path's shard shapes (level
// 1, limb 2: 15 Q and 23 Q_l*P rows a shard, N = 2^16) p reads its key
// rows and companions (48 MB), n and o move 16-20 MB each, at a few integer
// operations per word and butterfly stage. The row ranges are runtime
// arguments: one build serves every limb count and level.

#include "keymul_core.cuh"
#include "rowmod_core.cuh"

namespace {

inline const uint32_t* in(const void* p) {
  return static_cast<const uint32_t*>(p);
}

}  // namespace

// y: [nd, alpha, N] (every digit's rows, zero-padded to alpha); w, w_sh:
// [nd, alpha, rows], the digit weights of the shard's Q_l*P rows (zero on
// own rows and past the level's real towers); q: [rows]; out: [nd, rows, N].
extern "C" int conv_digits_rows(const void* y, const void* w,
                                const void* w_sh, const void* q, void* out,
                                int nd, int alpha, int rows, int n,
                                void* stream) {
  if (int bad = rowmod_run(in(y), in(w), in(w_sh), in(q),
                           static_cast<uint32_t*>(out), nd, alpha, rows, n,
                           static_cast<size_t>(alpha) * rows,
                           static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// x: [e, kp, N] COEFF (the scaled P rows); w, w_sh: [kp, rows], the P -> Q
// weights of the shard's Q rows; q: [rows]; out: [e, rows, N].
extern "C" int conv_p_to_q_rows(const void* x, const void* w,
                                const void* w_sh, const void* q, void* out,
                                int e, int kp, int rows, int n,
                                void* stream) {
  if (int bad = rowmod_run(in(x), in(w), in(w_sh), in(q),
                           static_cast<uint32_t*>(out), e, kp, rows, n, 0,
                           static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// conv: [nd, rows, N] COEFF, the shard's rows of every extended digit; c2:
// [>= own_end, N] EVAL, the gathered c2 of all Q_l rows; bv, bv_sh, av,
// av_sh: [nd, rows, N], the shard's key rows; scratch: [nd, rows, N]; ext:
// [2, rows, N]; psi(_sh): [rows, N] and q: [rows] of the shard's towers.
// Local row tau is global Q_l*P row tau0 + tau; own_end is the level's
// real Q tower count (the rows past it, padding and P, are never own).
extern "C" int ntt_keymul_acc_rows(const void* conv, const void* c2,
                                   const void* bv, const void* bv_sh,
                                   const void* av, const void* av_sh,
                                   void* scratch, void* ext, const void* psi,
                                   const void* psi_sh, const void* q, int nd,
                                   int alpha, int rows, int tau0, int own_end,
                                   int log_n, void* stream) {
  if (int bad = keymul_run(in(conv), in(c2), in(bv), in(bv_sh), in(av),
                           in(av_sh), static_cast<uint32_t*>(scratch),
                           static_cast<uint32_t*>(ext), in(psi), in(psi_sh),
                           in(q), nd, alpha, own_end, tau0, rows, rows, rows,
                           0, log_n, static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}
