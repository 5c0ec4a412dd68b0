// The key product of the HYBRID key switch (K3), shared by ks_fused.cu
// (all Q_l*P towers of one card) and sharded.cu (one shard's row range of
// them): the forward NTT of each extended digit, or the digit's own towers
// of c2 taken as they are, times the key rows, summed over the digits.
//
// Row geometry: the launch covers `rows` towers of Q_l*P, local row tau
// being global row tau0 + tau. A row is digit j's own when its global index
// lies in [j * alpha, min((j + 1) * alpha, own_end)), own_end being the
// level's real Q tower count; own rows read c2 at their global index. The
// key is indexed in place: local row tau reads key row tau below key_q and
// tau + key_shift from there on (the unsharded chain skips the Q towers
// above the level; a shard's key copy holds its own rows only).

#pragma once

#include "ntt_core.cuh"

namespace {

// K3 tile pass, one (tile, local row tau) per block: for each digit j, the
// last forward stages of src[j, tau] (or c2's row on the digit's own
// towers), times the key rows; both sums stay in registers.
__global__ void keymul_tile(const uint32_t* __restrict__ src,
                            const uint32_t* __restrict__ c2,
                            const uint32_t* __restrict__ bv,
                            const uint32_t* __restrict__ bv_sh,
                            const uint32_t* __restrict__ av,
                            const uint32_t* __restrict__ av_sh,
                            uint32_t* __restrict__ ext,
                            const uint32_t* __restrict__ psi,
                            const uint32_t* __restrict__ psi_sh,
                            const uint32_t* __restrict__ qs, int nd,
                            int alpha, int own_end, int tau0, int rows,
                            int key_rows, int key_q, int key_shift, int log_n,
                            int log_tile) {
  __shared__ uint32_t s[1 << kMaxTileLog];
  const int tau = blockIdx.y;
  const int tg = tau0 + tau;
  const uint32_t tile = blockIdx.x;
  const uint32_t size = 1u << log_tile;
  const size_t col0 = static_cast<size_t>(tile) << log_tile;
  const size_t tw0 = static_cast<size_t>(tau) << log_n;
  const uint32_t q = qs[tau];
  const int krow = tau < key_q ? tau : tau + key_shift;
  uint32_t acc0[kTileWords], acc1[kTileWords];
#pragma unroll
  for (int w = 0; w < kTileWords; ++w) acc0[w] = acc1[w] = 0;
  for (int j = 0; j < nd; ++j) {
    const int end = (j + 1) * alpha < own_end ? (j + 1) * alpha : own_end;
    const bool own = tg >= j * alpha && tg < end;        // block-uniform
    const uint32_t* in =
        own ? c2 + (static_cast<size_t>(tg) << log_n) + col0
            : src + ((static_cast<size_t>(j) * rows + tau) << log_n) + col0;
    for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) s[x] = in[x];
    __syncthreads();
    if (!own)
      fwd_tile_stages(s, psi + tw0, psi_sh + tw0, q, log_n, log_tile, tile);
    const size_t kb =
        ((static_cast<size_t>(j) * key_rows + krow) << log_n) + col0;
#pragma unroll
    for (int w = 0; w < kTileWords; ++w) {
      const uint32_t x = threadIdx.x + w * blockDim.x;
      if (x < size) {
        const uint32_t v = s[x];
        acc0[w] = add_mod(acc0[w], mul_shoup(v, bv[kb + x], bv_sh[kb + x], q),
                          q);
        acc1[w] = add_mod(acc1[w], mul_shoup(v, av[kb + x], av_sh[kb + x], q),
                          q);
      }
    }
    __syncthreads();                 // s is reloaded for the next digit
  }
  uint32_t* o0 = ext + tw0 + col0;
  uint32_t* o1 = ext + ((static_cast<size_t>(rows) + tau) << log_n) + col0;
#pragma unroll
  for (int w = 0; w < kTileWords; ++w) {
    const uint32_t x = threadIdx.x + w * blockDim.x;
    if (x < size) {
      o0[x] = acc0[w];
      o1[x] = acc1[w];
    }
  }
}

// conv: [nd, rows, N] COEFF; c2: EVAL rows indexed globally; bv, bv_sh,
// av, av_sh: [>= nd, key_rows, N]; scratch: [nd, rows, N]; ext: [2, rows,
// N]; psi(_sh): [rows, N] and q: [rows] of the launch's towers. The
// forward device-memory stages over all nd * rows rows, then the tile
// pass. Returns a CUDA error code, 0 when launched.
int keymul_run(const uint32_t* conv, const uint32_t* c2, const uint32_t* bv,
               const uint32_t* bv_sh, const uint32_t* av,
               const uint32_t* av_sh, uint32_t* scratch, uint32_t* ext,
               const uint32_t* psi, const uint32_t* psi_sh,
               const uint32_t* qs, int nd, int alpha, int own_end, int tau0,
               int rows, int key_rows, int key_q, int key_shift, int log_n,
               cudaStream_t st) {
  if (int bad = check_shape(nd * rows, rows, log_n)) return bad;
  if (nd < 1 || alpha < 1 || tau0 < 0 || own_end < 0 || own_end > nd * alpha)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* src =
      fwd_stages(conv, scratch, psi, psi_sh, qs, nd * rows, rows, log_n, st);
  const int log_tile = tile_log(log_n);
  keymul_tile<<<tile_grid(log_n, rows), tile_threads(log_tile), 0, st>>>(
      src, c2, bv, bv_sh, av, av_sh, ext, psi, psi_sh, qs, nd, alpha,
      own_end, tau0, rows, key_rows, key_q, key_shift, log_n, log_tile);
  return 0;
}

}  // namespace
