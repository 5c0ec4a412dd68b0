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
//   conv_digits_rows_rowmod, conv_p_to_q_rows_rowmod,
//   ntt_keymul_acc_rows_staged: the former forms of n, o and p, their
//                        yardsticks on the card
//
// The TPU kernels multiply int8 limbs on the MXU (the pair-layout weight
// stacks, an SMEM own-mask); here the weights are canonical residues with
// Shoup companions, and the device code is the unsharded kernels' own:
//   * p is one launch of K3's keymul_cluster (keymul_cluster.cuh) over the
//     shard's rows, a tower per thread-block cluster with the digit loop
//     and the key product inside, given the shard's first global row tau0
//     and the level's real Q tower count (own rows by global row, c2 read
//     at the global row). No scratch: the words cross device memory once.
//   * n is one launch of K2's pconv (pconv_core.cuh), a digit per
//     blockIdx.y with the shard's weight columns: it reads the gathered y
//     in place (no zero-padded copy) and writes the own rows of each
//     digit that fall in the shard's output rows (d_off = tau0) as zeros
//     without a product. A digit past the gathered rows (a padded level
//     whose real chain has fewer digits) has no rows: its output is zeros.
//   * o is one launch of K45's conversion, pconv with one weight table for
//     both elements (w_stride 0, no own rows), on the shard's weight
//     columns and Q moduli with their Basis.red64 rows: each thread holds 4
//     columns of an element's kp rows, forms the lazy Shoup products, sums
//     them in 64 bits and reduces once, and blockIdx.z splits the shard's
//     Q rows so that a shard's few rows still fill the card.
// The former forms: p's is the forward device-memory stages over all
// nd * rows rows into scratch, then keymul_core.cuh's tile pass with the
// same row rule; n's and o's are rowmod_core.cuh's eager conversion (one
// thread a column, every product reduced at once), n's over the digits
// zero-padded to alpha rows.
//
// What bounds them on an H100: device-memory bytes for p and o, the
// conversion's 32-bit integer operations for n, as for the unsharded
// kernels (ks_fused.cu's header): at the main path's shard shapes (level
// 1, limb 2: 15 Q and 23 Q_l*P rows a shard, N = 2^16) p reads its key
// rows and companions (48 MB), n and o move 16-20 MB each. o does 16 lazy
// products an output word; at 7 Q rows a shard (limb 4) its byte and
// operation bounds are within a factor of two, so what the design buys is
// the lazy sum (5 operations a term, not the eager 7) and enough blocks in
// flight. The row ranges are runtime arguments: one build serves every
// limb count and level.

#include "keymul_cluster.cuh"
#include "keymul_core.cuh"
#include "pconv_core.cuh"
#include "rowmod_core.cuh"

namespace {

inline const uint32_t* in(const void* p) {
  return static_cast<const uint32_t*>(p);
}

}  // namespace

// y: [kql, N] COEFF, the gathered y (digit j's rows j * alpha ..
// min((j + 1) * alpha, kql) - 1, read in place); w, w_sh: [nd, alpha,
// rows], the digit weights of the shard's Q_l*P rows (zero on own rows and
// past the level's real towers); q: [rows]; red: [rows, 3] (Basis.red64 of
// the shard's towers); out: [nd, rows, N]. The shard's first row is global
// row tau0; own rows lie below own_end (the level's real Q tower count).
// One launch of pconv; refuses what pconv_run refuses (more than 64 rows a
// digit, tables above 48 KB, N not a multiple of 4, y or out off a 16-byte
// boundary).
extern "C" int conv_digits_rows(const void* y, const void* w,
                                const void* w_sh, const void* q,
                                const void* red, void* out, int nd,
                                int alpha, int kql, int rows, int tau0,
                                int own_end, int n, void* stream) {
  if (static_cast<long long>(alpha) * rows > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int bad = pconv_run(in(y), in(w), in(w_sh), in(q), in(red),
                          static_cast<uint32_t*>(out), nd, alpha, kql, rows,
                          n, alpha * rows, tau0, own_end,
                          static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// y: [nd, alpha, N] (every digit's rows, zero-padded to alpha); w, w_sh:
// [nd, alpha, rows]; q: [rows]; out: [nd, rows, N]. n's former form:
// rowmod_core.cuh's conversion, every product of the padded rows formed.
extern "C" int conv_digits_rows_rowmod(const void* y, const void* w,
                                       const void* w_sh, const void* q,
                                       void* out, int nd, int alpha,
                                       int rows, int n, void* stream) {
  if (int bad = rowmod_run(in(y), in(w), in(w_sh), in(q),
                           static_cast<uint32_t*>(out), nd, alpha, rows, n,
                           static_cast<size_t>(alpha) * rows,
                           static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// x: [e, kp, N] COEFF (the scaled P rows, read in place); w, w_sh: [kp,
// rows], the P -> Q weights of the shard's Q rows; q: [rows]; red: [rows,
// 3] (Basis.red64 of the shard's Q towers); out: [e, rows, N]. One launch
// of pconv (batch e, one table); refuses what pconv_run refuses (more than
// 64 P rows, tables above 48 KB, N not a multiple of 4, x or out off a
// 16-byte boundary).
extern "C" int conv_p_to_q_rows(const void* x, const void* w,
                                const void* w_sh, const void* q,
                                const void* red, void* out, int e, int kp,
                                int rows, int n, void* stream) {
  if (static_cast<long long>(e) * kp > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (int bad = pconv_run(in(x), in(w), in(w_sh), in(q), in(red),
                          static_cast<uint32_t*>(out), e, kp, e * kp, rows,
                          n, 0, 0, 0, static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// The arguments of conv_p_to_q_rows without red. o's former form:
// rowmod_core.cuh's eager conversion.
extern "C" int conv_p_to_q_rows_rowmod(const void* x, const void* w,
                                       const void* w_sh, const void* q,
                                       void* out, int e, int kp, int rows,
                                       int n, void* stream) {
  if (int bad = rowmod_run(in(x), in(w), in(w_sh), in(q),
                           static_cast<uint32_t*>(out), e, kp, rows, n, 0,
                           static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// conv: [nd, rows, N] COEFF, the shard's rows of every extended digit; c2:
// [>= own_end, N] EVAL, the gathered c2 of all Q_l rows; bv, bv_sh, av,
// av_sh: [nd, rows, N], the shard's key rows; ext: [2, rows, N];
// psi(_sh): [rows, N] and q: [rows] of the shard's towers. Local row tau
// is global Q_l*P row tau0 + tau; own_end is the level's real Q tower
// count (the rows past it, padding and P, are never own). One launch of
// keymul_cluster; refuses rings outside 2^4 .. 2^17 and operands off a
// 16-byte boundary.
extern "C" int ntt_keymul_acc_rows(const void* conv, const void* c2,
                                   const void* bv, const void* bv_sh,
                                   const void* av, const void* av_sh,
                                   void* ext, const void* psi,
                                   const void* psi_sh, const void* q, int nd,
                                   int alpha, int rows, int tau0, int own_end,
                                   int log_n, void* stream) {
  return keymul_launch(conv, c2, bv, bv_sh, av, av_sh, ext, psi, psi_sh, q,
                       nd, alpha, tau0, own_end, rows, rows, rows, 0, log_n,
                       static_cast<cudaStream_t>(stream));
}

// p's former form, any ring: the arguments of ntt_keymul_acc_rows with
// scratch ([nd, rows, N]) before ext. The forward device-memory stages of
// ntt_core.cuh over all nd * rows rows into scratch, then keymul_tile.
extern "C" int ntt_keymul_acc_rows_staged(
    const void* conv, const void* c2, const void* bv, const void* bv_sh,
    const void* av, const void* av_sh, void* scratch, void* ext,
    const void* psi, const void* psi_sh, const void* q, int nd, int alpha,
    int rows, int tau0, int own_end, int log_n, void* stream) {
  if (int bad = keymul_run(in(conv), in(c2), in(bv), in(bv_sh), in(av),
                           in(av_sh), static_cast<uint32_t*>(scratch),
                           static_cast<uint32_t*>(ext), in(psi), in(psi_sh),
                           in(q), nd, alpha, own_end, tau0, rows, rows, rows,
                           0, log_n, static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}
