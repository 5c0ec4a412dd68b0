// RNS base conversion for Hopper (sm_90a):
//   out[b, j, n] = sum_i y[b, i, n] * W[i, j]  mod d_j.
//
// Replaces the TPU kernel mod_matmul_rowmod_tpu of
// openfhe_tpu/ops/modmatmul.py (body _mm_rowmod_kernel), which splits W
// and y into signed int8 limbs for the MXU and recombines the 16 limb
// products. Here W stays in canonical residues W[i, j] = [B/b_i]_{d_j}
// with Shoup companions, and every product is exact 32-bit modular
// arithmetic on the words.
//
// What bounds it on an H100: 32-bit integer issue. At A = 16 inputs and
// D = 31 outputs per column it moves (A + D) * 4 bytes per column and does
// A * D Shoup products, so the operations take about twice as long as the
// bytes at the card's rates.
//
// Two entries:
//   mod_matmul_rowmod        pconv of pconv_core.cuh (K2's and K45's
//                            conversion): `batch` batches of a_dim rows
//                            over one table (w_stride 0, no own rows).
//                            Each thread holds 4 columns of its batch's
//                            rows (16-byte loads), forms lazy Shoup
//                            products in [0, 2 d_j), sums them in 64 bits
//                            and reduces once with red (Basis.red64 of the
//                            output moduli); blockIdx.z splits the output
//                            rows so that the card fills at batch 1.
//                            Refuses a_dim > 64, tables above 48 KB of
//                            shared memory, N not a multiple of 4 and y or
//                            out off a 16-byte boundary.
//   mod_matmul_rowmod_eager  the former form (rowmod_core.cuh): one thread
//                            per column, 4-byte loads, each product reduced
//                            at once with a compare so the sum never
//                            leaves 32 bits; its yardstick on the card,
//                            which no wrapper falls back to.

#include "pconv_core.cuh"
#include "rowmod_core.cuh"

// y: [batch, a_dim, n] words; w, w_sh: [a_dim, d_dim]; d: [d_dim]; red:
// [d_dim, 3] (Basis.red64 of d); out: [batch, d_dim, n]. One launch of
// pconv. Returns cudaGetLastError() after the launch.
extern "C" int mod_matmul_rowmod(const void* y, const void* w,
                                 const void* w_sh, const void* d,
                                 const void* red, void* out, int batch,
                                 int a_dim, int d_dim, int n, void* stream) {
  if (static_cast<long long>(batch) * a_dim > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  if (int bad = pconv_run(in(y), in(w), in(w_sh), in(d), in(red),
                          static_cast<uint32_t*>(out), batch, a_dim,
                          batch * a_dim, d_dim, n, 0, 0, 0,
                          static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}

// The arguments of mod_matmul_rowmod without red; one launch of rowmod.
extern "C" int mod_matmul_rowmod_eager(const void* y, const void* w,
                                       const void* w_sh, const void* d,
                                       void* out, int batch, int a_dim,
                                       int d_dim, int n, void* stream) {
  if (int bad = rowmod_run(static_cast<const uint32_t*>(y),
                           static_cast<const uint32_t*>(w),
                           static_cast<const uint32_t*>(w_sh),
                           static_cast<const uint32_t*>(d),
                           static_cast<uint32_t*>(out), batch, a_dim, d_dim,
                           n, 0, static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}
