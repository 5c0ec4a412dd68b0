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

// The kernel itself is in rowmod_core.cuh, shared with ks_fused.cu.

#include "rowmod_core.cuh"

// y: [batch, A, n] words; w, w_sh: [A, D]; d: [D]; out: [batch, D, n].
// Returns cudaGetLastError() after the launch.
extern "C" int mod_matmul_rowmod(const void* y, const void* w,
                                 const void* w_sh, const void* d, void* out,
                                 int batch, int a_dim, int d_dim, int n,
                                 void* stream) {
  if (int bad = rowmod_run(static_cast<const uint32_t*>(y),
                           static_cast<const uint32_t*>(w),
                           static_cast<const uint32_t*>(w_sh),
                           static_cast<const uint32_t*>(d),
                           static_cast<uint32_t*>(out), batch, a_dim, d_dim,
                           n, 0, static_cast<cudaStream_t>(stream)))
    return bad;
  return static_cast<int>(cudaGetLastError());
}
