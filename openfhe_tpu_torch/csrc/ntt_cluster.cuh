// The negacyclic NTT of ntt.cu in one launch: a tower per thread-block
// cluster (Hopper, sm_90a).
//
// Replaces the TPU kernels ntt_fwd_fused / ntt_inv_fused of
// openfhe_tpu/ops/ntt_fused.py:205. There one grid program holds a whole
// [R, C] tower block in VMEM, transforms it and writes it back once. A
// tower at N = 2^16 is 256 KB of words, more than one block's shared
// memory (227 KB), so here a tower is split over a cluster of C = N / W
// blocks of W words, which read and write each other's shared memory
// (distributed shared memory, DSMEM): W = min(N, max(2^13, N / 8)), so
// C <= 8 (the portable cluster size), 32 KB a block at N <= 2^16 and
// 64 KB at N = 2^17. The words are those of the butterfly transform of
// ntt_core.cuh: Cooley-Tukey DIT forward, Gentleman-Sande inverse,
// bit-reversed twiddles with Shoup companions. At the butterfly of span
// t = 2^b that holds global word X the twiddle is psi[N / 2t + X / 2t],
// for every stage and both directions.
//
// Forward, in one launch of rows x C blocks:
//   1. a first round of kLogR = 4 stages in registers, whose 16 slots are
//      the global index bits [kLo1, kLo1 + 4): the log2(C) bits that pick
//      the block (spans >= W, pairing words of different blocks) and the
//      top 4 - log2(C) bits of the tile index. Thread tid of block r holds
//      words j + (s << kLo1), j = r W / 16 + tid (coalesced loads across
//      the threads), runs the 4 stages and writes slot (i, p) into block
//      i's shared memory at offset j + (p << kLo1). A cluster barrier
//      (release / acquire) makes the writes visible;
//   2. the tile's other stages run in rounds of 4: each thread holds 16
//      words in registers, the ones whose indices differ only in the
//      round's bits, and runs the round's stages on them between two
//      passes through shared memory (3 rounds and 2 block barriers at
//      N = 2^16); each round's twiddles are loaded into registers before
//      the barrier that precedes it, so their latency hides behind it;
//   3. the last round's slots are the low index bits, so each thread
//      holds 16 consecutive output words; an epilogue hook takes them
//      (fwd_cluster_row): ntt_fwd writes them straight to device memory,
//      ks_fused.cu's key product multiplies them by the key's words at the
//      same indices and runs the transform once per digit in one launch.
// The inverse is the mirror image: the first round takes 16 consecutive
// words a thread from a load hook (inv_cluster_row: ntt_inv reads them in
// place, ks_fused.cu's K1t forms them as the tensor product a1 * b1 and
// writes that beside), the tile's stages run from span 1 up, a cluster
// barrier, then block r gathers slot (i, p) from block i's shared memory,
// runs the last 4 stages and the N^-1 multiply (or N^-1 times a folded
// per-tower constant) in registers and writes the words; a last cluster
// barrier keeps every block's shared memory alive until the other blocks
// have read it.
//
// So the words cross device memory once each way, and each block reads the
// twiddles of its own tile's stages (about W pairs) once. What bounds it:
// the bytes at the card's rate come to about 10 us at [31, 2^16], and the
// butterflies' integer instructions at the SMs' integer issue rate to a
// few us; above both sits latency, of loads and barriers, which a lone
// block per SM leaves exposed. So the geometry is fixed at compile time (a
// kernel per ring size: shifts, shared-memory offsets and twiddle offsets
// are immediates), a conditional subtraction is an unsigned min, W = 2^13
// (512 threads) puts two blocks on an SM, each one's barriers hidden
// behind the other's work, the first round absorbs the cross-block
// stages, and twiddles are fetched a round ahead.
//
// Shared-memory banks: a round's threads would read words 2^lo apart; the
// tile is stored with bits 0-4 of each index XORed with bits 5-9 (`phys`,
// linear over the index bits, so a slot's word is phys(base) ^ a
// constant), and a warp's 32 lanes take index bits chosen so that the 32
// words of every access fall in 32 different banks (`thread_bit_pos`). A
// tile of fewer than 1024 words (N <= 512, at most 32 threads, all of them
// lanes of one warp) XORs bits 4-8 into bits 0-4 instead, which does the
// same for its rounds.
//
// The round helpers take a `Pass`: the threads that run one row's tile,
// their barrier and how they read a twiddle. The cluster transform's is
// BlockPass; ntt_small.cu runs several rows a block, a group of threads
// each, with its own.

#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "ntt_core.cuh"

namespace {

namespace cg = cooperative_groups;

// ops/ntt.py repeats the geometry constants below, and a test holds the
// two equal
constexpr int kClusterLogW = 13;                 // words a block
constexpr int kLogR = 4;                         // words a thread
constexpr int kR = 1 << kLogR;
constexpr int kMaxLogC = 3;                      // 8 blocks: portable
constexpr int kMinClusterLogN = kLogR;
constexpr int kMaxClusterLogN = 17;
constexpr int kSwizzleLog = 10;   // tiles of >= 1024 words are swizzled

// log2 of the words a block holds at ring 2^log_n.
__host__ __device__ constexpr int cluster_log_w(int log_n) {
  return log_n <= kClusterLogW             ? log_n
         : log_n - kMaxLogC > kClusterLogW ? log_n - kMaxLogC
                                           : kClusterLogW;
}

// Shared-memory word of tile index i.
template <int LOG_W>
__host__ __device__ constexpr uint32_t phys(uint32_t i) {
  return LOG_W >= kSwizzleLog ? i ^ ((i >> 5) & 31u) : i ^ ((i >> 4) & 31u);
}

// The tile index bit that thread bit t takes in a round whose slots are
// the index bits [lo, lo + kLogR): lane bit l goes to index bit l, or to
// l + 5 where l is a slot bit, so that bits 0-4 of phys() take all 32
// values over a warp; the other thread bits fill the free bits upwards.
__host__ __device__ constexpr int thread_bit_pos(int log_w, int lo, int t) {
  const uint32_t slots = ((1u << kLogR) - 1) << lo;
  uint32_t taken = slots;
  if (log_w >= kSwizzleLog) {
    for (int l = 0; l < 5; ++l) {
      const int pos = (slots >> l & 1u) ? l + 5 : l;
      if (l == t) return pos;
      taken |= 1u << pos;
    }
    t -= 5;
  }
  for (int pos = 0;; ++pos) {
    if (taken >> pos & 1u) continue;
    if (t-- == 0) return pos;
  }
}

// Tile index of slot 0 of thread `tid` in a round with slots [LO, LO +
// kLogR): thread bits T and up, scattered.
template <int LOG_W, int LO, int T = 0>
__device__ __forceinline__ uint32_t round_base(uint32_t tid) {
  if constexpr (T == LOG_W - kLogR) {
    return 0;
  } else {
    constexpr int kPos = thread_bit_pos(LOG_W, LO, T);
    return ((tid >> T & 1u) << kPos) | round_base<LOG_W, LO, T + 1>(tid);
  }
}

// Modular arithmetic on canonical residues, q < 2^31, with a conditional
// subtraction as an unsigned min (r - q wraps above r when r < q); the
// same words as add_mod / sub_mod / mul_shoup of ntt_core.cuh.
__device__ __forceinline__ uint32_t csub(uint32_t r, uint32_t q) {
  return min(r, r - q);
}

__device__ __forceinline__ uint32_t add_q(uint32_t a, uint32_t b,
                                          uint32_t q) {
  return csub(a + b, q);
}

__device__ __forceinline__ uint32_t sub_q(uint32_t a, uint32_t b,
                                          uint32_t q) {
  const uint32_t d = a - b;
  return min(d, d + q);
}

__device__ __forceinline__ uint32_t mul_shoup_q(uint32_t x, uint32_t w,
                                                uint32_t w_sh, uint32_t q) {
  return csub(x * w - __umulhi(x, w_sh) * q, q);
}

// The twiddle pairs of a round's stages, kept in registers: stage RB's
// slot group h at (1 << (kLogR - 1 - RB)) - 1 + h.
struct Twiddles {
  uint32_t w[kR - 1], w_sh[kR - 1];
};

// The threads that run one row's tile: thread tid() of them, sync() their
// barrier between rounds, twiddle(t, i0, h) the tower's twiddle t[i0 + h]
// (the bits of h are clear in i0). The cluster transform's: a block (of a
// cluster) a row, __syncthreads, the table read from device memory
// through the read-only cache.
struct BlockPass {
  __device__ __forceinline__ uint32_t tid() const { return threadIdx.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ uint32_t twiddle(const uint32_t* __restrict__ t,
                                              uint32_t i0, uint32_t h) const {
    return __ldg(t + i0 + h);
  }
};

// Load the twiddles of the stages of spans 2^(LO + RB) for RB = RB up to
// RB_HI, for a thread whose slot 0 is global word x0 (slot bits clear):
// the butterflies of slot group h of stage RB share
// psi[N / 2t + (x0 >> (b + 1)) + h], b = LO + RB.
template <int LOG_N, int LO, int RB, int RB_HI, typename Pass = BlockPass>
__device__ __forceinline__ void load_twiddles(
    Twiddles& tw, uint32_t x0, const uint32_t* __restrict__ psi,
    const uint32_t* __restrict__ psi_sh, const Pass& pass = Pass()) {
  constexpr int kB = LO + RB;
  constexpr int kAt = (1 << (kLogR - 1 - RB)) - 1;
  const uint32_t t0 = (1u << (LOG_N - 1 - kB)) + (x0 >> (kB + 1));
#pragma unroll
  for (int h = 0; h < (kR >> (RB + 1)); ++h) {
    tw.w[kAt + h] = pass.twiddle(psi, t0, h);
    tw.w_sh[kAt + h] = pass.twiddle(psi_sh, t0, h);
  }
  if constexpr (RB < RB_HI)
    load_twiddles<LOG_N, LO, RB + 1, RB_HI>(tw, x0, psi, psi_sh, pass);
}

// The forward (Cooley-Tukey) stages RB = RB_HI down to RB_LO of a round on
// a thread's slots: slot s pairs with s + 2^RB.
template <int RB_LO, int RB_HI>
__device__ __forceinline__ void fwd_butterflies(uint32_t (&a)[kR],
                                                const Twiddles& tw,
                                                uint32_t q) {
  constexpr int kAt = (1 << (kLogR - 1 - RB_HI)) - 1;
#pragma unroll
  for (int h = 0; h < (kR >> (RB_HI + 1)); ++h) {
    const uint32_t w = tw.w[kAt + h], w_sh = tw.w_sh[kAt + h];
#pragma unroll
    for (int l = 0; l < (1 << RB_HI); ++l) {
      const int s = (h << (RB_HI + 1)) | l;
      const uint32_t u = a[s];
      const uint32_t v = mul_shoup_q(a[s + (1 << RB_HI)], w, w_sh, q);
      a[s] = add_q(u, v, q);
      a[s + (1 << RB_HI)] = sub_q(u, v, q);
    }
  }
  if constexpr (RB_HI > RB_LO) fwd_butterflies<RB_LO, RB_HI - 1>(a, tw, q);
}

// The inverse (Gentleman-Sande) stages RB = RB_LO up to RB_HI.
template <int RB_LO, int RB_HI>
__device__ __forceinline__ void inv_butterflies(uint32_t (&a)[kR],
                                                const Twiddles& tw,
                                                uint32_t q) {
  constexpr int kAt = (1 << (kLogR - 1 - RB_LO)) - 1;
#pragma unroll
  for (int h = 0; h < (kR >> (RB_LO + 1)); ++h) {
    const uint32_t w = tw.w[kAt + h], w_sh = tw.w_sh[kAt + h];
#pragma unroll
    for (int l = 0; l < (1 << RB_LO); ++l) {
      const int s = (h << (RB_LO + 1)) | l;
      const uint32_t u = a[s];
      const uint32_t v = a[s + (1 << RB_LO)];
      a[s] = add_q(u, v, q);
      a[s + (1 << RB_LO)] = mul_shoup_q(sub_q(u, v, q), w, w_sh, q);
    }
  }
  if constexpr (RB_LO < RB_HI) inv_butterflies<RB_LO + 1, RB_HI>(a, tw, q);
}

// The block geometry at ring 2^LOG_N: W = 2^kLogW words a block, C =
// 2^kLogC blocks a tower, kThreads threads a block. The first step (the
// forward's, the inverse's last) is a round whose slots are the global
// index bits [kLo1, kLo1 + kLogR): the kLogC bits that pick the block and
// the top kLogR - kLogC bits of the tile index; a thread's slot 0 is word
// j = rank * kThreads + tid of the row.
template <int LOG_N>
struct Geometry {
  static constexpr int kLogW = cluster_log_w(LOG_N);
  static constexpr int kLogC = LOG_N - kLogW;
  static constexpr int kLo1 = kLogW - (kLogR - kLogC);
  static constexpr uint32_t kThreads = 1u << (kLogW - kLogR);
  // two blocks an SM where they fit (at most 64 registers a thread), so
  // that one block's barriers hide behind the other's work
  static constexpr int kMinBlocks = kThreads <= 512u ? 2 : 1;
  static_assert(kLogC <= kLogR && kLo1 >= 0, "cluster geometry");
  static_assert(kThreads <= 1024, "a block of more than 1024 threads");
  static_assert((sizeof(uint32_t) << kLogW) <= 232448,
                "a tile beyond a block's shared memory");
};

// The forward rounds from tile index bit HI down to 0, in shared memory;
// `tw` holds this round's twiddles on entry. The last round (slots on
// bits 0 .. kLogR - 1) hands its kR consecutive words, row words
// x_tile + base .. + kR - 1, to epi(a, x_tile + base).
template <int LOG_N, int HI, typename Epi, typename Pass = BlockPass>
__device__ __forceinline__ void fwd_rounds(uint32_t (&a)[kR], Twiddles& tw,
                                           uint32_t* tile, uint32_t tid,
                                           uint32_t x_tile, Epi& epi,
                                           const uint32_t* __restrict__ psi,
                                           const uint32_t* __restrict__ psi_sh,
                                           uint32_t q,
                                           const Pass& pass = Pass()) {
  constexpr int kLogW = Geometry<LOG_N>::kLogW;
  constexpr int kLo = HI >= kLogR ? HI - kLogR + 1 : 0;
  const uint32_t base = round_base<kLogW, kLo>(tid);
  const uint32_t pb = phys<kLogW>(base);
#pragma unroll
  for (int s = 0; s < kR; ++s)
    a[s] = tile[pb ^ phys<kLogW>(static_cast<uint32_t>(s) << kLo)];
  fwd_butterflies<0, HI - kLo>(a, tw, q);
  if constexpr (kLo == 0) {
    epi(a, x_tile + base);
  } else {
#pragma unroll
    for (int s = 0; s < kR; ++s)
      tile[pb ^ phys<kLogW>(static_cast<uint32_t>(s) << kLo)] = a[s];
    // the next round's twiddles, loaded while the block waits
    constexpr int kHi2 = kLo - 1;
    constexpr int kLo2 = kHi2 >= kLogR ? kHi2 - kLogR + 1 : 0;
    load_twiddles<LOG_N, kLo2, 0, kHi2 - kLo2>(
        tw, x_tile + round_base<kLogW, kLo2>(tid), psi, psi_sh, pass);
    pass.sync();
    fwd_rounds<LOG_N, kHi2>(a, tw, tile, tid, x_tile, epi, psi, psi_sh, q,
                            pass);
  }
}

// The slots [lo, lo + kLogR) and stages [LO_B, hi) of the inverse round
// that starts at tile index bit LO_B when the rounds end below bit TOP.
__host__ __device__ constexpr int inv_round_lo(int lo_b, int top) {
  return lo_b + kLogR <= top ? lo_b : (top > kLogR ? top - kLogR : 0);
}

__host__ __device__ constexpr int inv_round_hi(int lo_b, int top) {
  return lo_b + kLogR < top ? lo_b + kLogR : top;
}

// The inverse rounds from tile index bit LO_B up to Geometry::kLo1, in
// shared memory; `tw` holds this round's twiddles on entry, except in the
// first (LO_B = 0, slots on bits 0 .. kLogR - 1), which takes its kR
// consecutive words, row words x_tile + base .. + kR - 1, from the load
// hook, load(a, x_tile + base), and then loads its twiddles. Every round
// leaves its words in the tile.
template <int LOG_N, int LO_B, typename Load, typename Pass = BlockPass>
__device__ __forceinline__ void inv_rounds(uint32_t (&a)[kR], Twiddles& tw,
                                           uint32_t* tile, uint32_t tid,
                                           uint32_t x_tile, Load& load,
                                           const uint32_t* __restrict__ ipsi,
                                           const uint32_t* __restrict__ ipsi_sh,
                                           uint32_t q,
                                           const Pass& pass = Pass()) {
  using G = Geometry<LOG_N>;
  constexpr int kLo = inv_round_lo(LO_B, G::kLo1);
  constexpr int kHi = inv_round_hi(LO_B, G::kLo1);
  const uint32_t base = round_base<G::kLogW, kLo>(tid);
  const uint32_t pb = phys<G::kLogW>(base);
  if constexpr (LO_B == 0) {
    load(a, x_tile + base);
    load_twiddles<LOG_N, kLo, 0, kHi - 1 - kLo>(tw, x_tile + base, ipsi,
                                                ipsi_sh, pass);
  } else {
#pragma unroll
    for (int s = 0; s < kR; ++s)
      a[s] = tile[pb ^ phys<G::kLogW>(static_cast<uint32_t>(s) << kLo)];
  }
  inv_butterflies<LO_B - kLo, kHi - 1 - kLo>(a, tw, q);
#pragma unroll
  for (int s = 0; s < kR; ++s)
    tile[pb ^ phys<G::kLogW>(static_cast<uint32_t>(s) << kLo)] = a[s];
  if constexpr (kHi < G::kLo1) {
    constexpr int kLo2 = inv_round_lo(kHi, G::kLo1);
    constexpr int kHi2 = inv_round_hi(kHi, G::kLo1);
    load_twiddles<LOG_N, kLo2, kHi - kLo2, kHi2 - 1 - kLo2>(
        tw, x_tile + round_base<G::kLogW, kLo2>(tid), ipsi, ipsi_sh, pass);
    pass.sync();
    inv_rounds<LOG_N, kHi>(a, tw, tile, tid, x_tile, load, ipsi, ipsi_sh,
                           q, pass);
  }
}

// Load a thread's kR consecutive words a from src (16-byte aligned).
__device__ __forceinline__ void load_words(uint32_t (&a)[kR],
                                           const uint32_t* src) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int v = 0; v < kR / 4; ++v) {
    const uint4 w = s4[v];
    a[4 * v] = w.x;
    a[4 * v + 1] = w.y;
    a[4 * v + 2] = w.z;
    a[4 * v + 3] = w.w;
  }
}

// Store a thread's kR consecutive output words a at dst (16-byte aligned).
__device__ __forceinline__ void store_words(uint32_t* dst,
                                            const uint32_t (&a)[kR]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int v = 0; v < kR / 4; ++v)
    d[v] = make_uint4(a[4 * v], a[4 * v + 1], a[4 * v + 2], a[4 * v + 3]);
}

// The row word of the first of the kR consecutive output words that thread
// tid of block `rank` holds at the end of the forward transform: what
// fwd_cluster_row hands its epilogue.
template <int LOG_N>
__device__ __forceinline__ uint32_t fwd_out_word(uint32_t rank,
                                                 uint32_t tid) {
  using G = Geometry<LOG_N>;
  if constexpr (G::kLo1 == 0)
    return rank * G::kThreads + tid;
  else
    return (rank << G::kLogW) + round_base<G::kLogW, 0>(tid);
}

// The forward transform of one row (src, N = 2^LOG_N words, COEFF) in the
// cluster of this block, with the tower's twiddles psi / psi_sh and
// modulus q and the block's tile of 2^kLogW words of shared memory. Each
// thread ends holding kR consecutive output words (EVAL, bit-reversed
// positions) in registers and calls epi(a, x), x = fwd_out_word(rank,
// tid) their first row word: the epilogue hook (a store for ntt_fwd, the
// key product for ks_fused.cu's ntt_keymul_acc). Every block of the
// cluster must call it together: it holds two cluster barriers (one block
// barrier with a cluster of one), the first before any block writes into
// another's tile, so a cluster may call it again for another row once all
// its blocks are past their epilogues (with a cluster of one, after a
// block barrier).
template <int LOG_N, typename Epi>
__device__ __forceinline__ void fwd_cluster_row(
    const uint32_t* src, const uint32_t* __restrict__ psi,
    const uint32_t* __restrict__ psi_sh, uint32_t q, uint32_t* tile,
    Epi& epi) {
  using G = Geometry<LOG_N>;
  constexpr int kP = kLogR - G::kLogC;   // tile index bits in step 1
  const uint32_t rank = blockIdx.x & ((1u << G::kLogC) - 1);
  const uint32_t tid = threadIdx.x;
  const uint32_t j = rank * G::kThreads + tid;
  const uint32_t x_tile = rank << G::kLogW;
  uint32_t a[kR];
  Twiddles tw;

  // 1. the first kLogR stages on words j + (s << kLo1): the cross-block
  // ones and the tile's top kP, in registers
#pragma unroll
  for (int s = 0; s < kR; ++s) a[s] = src[j + (s << G::kLo1)];
  load_twiddles<LOG_N, G::kLo1, 0, kLogR - 1>(tw, j, psi, psi_sh);
  fwd_butterflies<0, kLogR - 1>(a, tw, q);
  if constexpr (G::kLo1 == 0) {
    // the whole tile was one round (N = 2^kLogR): its words are done
    epi(a, j);
  } else {
    constexpr int kHi = G::kLo1 - 1;
    constexpr int kLo = kHi >= kLogR ? kHi - kLogR + 1 : 0;
    // slot s = (i << kP) | p: word j + (p << kLo1) of block i's tile
    const uint32_t pj = phys<G::kLogW>(j);
    if constexpr (G::kLogC > 0) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();   // every block of the cluster has started
#pragma unroll
      for (int i = 0; i < (1 << G::kLogC); ++i) {
        uint32_t* to = cluster.map_shared_rank(tile, i);
#pragma unroll
        for (int p = 0; p < (1 << kP); ++p)
          to[pj ^ phys<G::kLogW>(static_cast<uint32_t>(p) << G::kLo1)] =
              a[(i << kP) | p];
      }
      load_twiddles<LOG_N, kLo, 0, kHi - kLo>(
          tw, x_tile + round_base<G::kLogW, kLo>(tid), psi, psi_sh);
      cluster.sync();   // release / acquire: the writes are visible
    } else {
#pragma unroll
      for (int s = 0; s < kR; ++s)
        tile[pj ^ phys<G::kLogW>(static_cast<uint32_t>(s) << G::kLo1)] =
            a[s];
      load_twiddles<LOG_N, kLo, 0, kHi - kLo>(
          tw, x_tile + round_base<G::kLogW, kLo>(tid), psi, psi_sh);
      __syncthreads();
    }
    // 2. and 3. the tile's other stages, kLogR a round from the top
    fwd_rounds<LOG_N, kHi>(a, tw, tile, tid, x_tile, epi, psi, psi_sh, q);
  }
}

// x, out: [rows, N] words, N = 2^LOG_N, row r in tower r % k; a grid of
// rows x C blocks in clusters of C, block rank r holding words
// [r W, (r + 1) W) of its row after step 1; out may equal x.
template <int LOG_N>
__global__ void __launch_bounds__(Geometry<LOG_N>::kThreads,
                                  Geometry<LOG_N>::kMinBlocks)
    fwd_cluster(const uint32_t* x, uint32_t* out,
                const uint32_t* __restrict__ psi,
                const uint32_t* __restrict__ psi_sh,
                const uint32_t* __restrict__ qs, int k) {
  using G = Geometry<LOG_N>;
  extern __shared__ __align__(16) uint32_t tile[];
  const uint32_t row = blockIdx.x >> G::kLogC;
  const int tower = row % k;
  const size_t tw0 = static_cast<size_t>(tower) << LOG_N;
  uint32_t* dst = out + (static_cast<size_t>(row) << LOG_N);
  auto store = [dst](const uint32_t (&a)[kR], uint32_t x0) {
    store_words(dst + x0, a);
  };
  fwd_cluster_row<LOG_N>(x + (static_cast<size_t>(row) << LOG_N), psi + tw0,
                         psi_sh + tw0, qs[tower], tile, store);
}

// The inverse transform of one row (N = 2^LOG_N words, EVAL) in the
// cluster of this block, times the tower's constant c[0] (c_sh[0] its
// companion: N^-1, or N^-1 times a scale folded in), into dst (COEFF), with
// the tower's twiddles ipsi / ipsi_sh, modulus q and the block's tile. The
// input comes from the load hook, the mirror of fwd_cluster_row's epilogue:
// load(a, x) fills a thread's kR consecutive words from row word x on (x a
// multiple of kR), once per thread, before any other read of the row (a
// read in place for ntt_inv and K45, the tensor product for ks_fused.cu's
// K1t). Every block of the cluster must call it together; it ends with a
// cluster barrier, so that no block's tile is read after the block exits.
// With one block a row (kLogC = 0) the row's threads may be any `pass`
// (ntt_small.cu's groups).
template <int LOG_N, typename Load, typename Pass = BlockPass>
__device__ __forceinline__ void inv_cluster_row(
    Load& load, uint32_t* dst, const uint32_t* __restrict__ ipsi,
    const uint32_t* __restrict__ ipsi_sh, uint32_t q,
    const uint32_t* __restrict__ c, const uint32_t* __restrict__ c_sh,
    uint32_t* tile, const Pass& pass = Pass()) {
  using G = Geometry<LOG_N>;
  constexpr int kP = kLogR - G::kLogC;
  const uint32_t rank = blockIdx.x & ((1u << G::kLogC) - 1);
  const uint32_t tid = pass.tid();
  const uint32_t j = rank * G::kThreads + tid;
  const uint32_t x_tile = rank << G::kLogW;
  uint32_t a[kR];
  Twiddles tw;

  // 1. the tile's stages below bit kLo1, kLogR a round from the bottom
  if constexpr (G::kLo1 > 0)
    inv_rounds<LOG_N, 0>(a, tw, tile, tid, x_tile, load, ipsi, ipsi_sh, q,
                         pass);

  // 2. the last kLogR stages on words j + (s << kLo1): the tile's top kP
  // and the cross-block ones, then the constant
  if constexpr (G::kLo1 == 0) {
    // the whole row is one round (N = 2^kLogR): its words are the input
    load(a, j);
    load_twiddles<LOG_N, G::kLo1, 0, kLogR - 1>(tw, j, ipsi, ipsi_sh, pass);
  } else {
    load_twiddles<LOG_N, G::kLo1, 0, kLogR - 1>(tw, j, ipsi, ipsi_sh, pass);
    const uint32_t pj = phys<G::kLogW>(j);
    if constexpr (G::kLogC > 0) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();   // every tile is done and visible
#pragma unroll
      for (int i = 0; i < (1 << G::kLogC); ++i) {
        const uint32_t* from = cluster.map_shared_rank(tile, i);
#pragma unroll
        for (int p = 0; p < (1 << kP); ++p)
          a[(i << kP) | p] =
              from[pj ^ phys<G::kLogW>(static_cast<uint32_t>(p) << G::kLo1)];
      }
    } else {
      pass.sync();
#pragma unroll
      for (int s = 0; s < kR; ++s)
        a[s] = tile[pj ^ phys<G::kLogW>(static_cast<uint32_t>(s) << G::kLo1)];
    }
  }
  inv_butterflies<0, kLogR - 1>(a, tw, q);
  const uint32_t cv = c[0], cv_sh = c_sh[0];
#pragma unroll
  for (int s = 0; s < kR; ++s)
    dst[j + (s << G::kLo1)] = mul_shoup_q(a[s], cv, cv_sh, q);
  if constexpr (G::kLogC > 0)
    cg::this_cluster().sync();   // no block's tile is read after it exits
}

// The inverse, times a per-tower constant (ninv, ninv_sh: N^-1, or N^-1
// times a scale folded in); the layout and launch of fwd_cluster, except
// that output row r reads input row (r / k) * in_rows + in_off + r % k, so
// that k rows of every in_rows are read in place (in_rows = k, in_off = 0
// for a plain transform).
template <int LOG_N>
__global__ void __launch_bounds__(Geometry<LOG_N>::kThreads,
                                  Geometry<LOG_N>::kMinBlocks)
    inv_cluster(const uint32_t* x, uint32_t* out,
                const uint32_t* __restrict__ ipsi,
                const uint32_t* __restrict__ ipsi_sh,
                const uint32_t* __restrict__ qs,
                const uint32_t* __restrict__ ninv,
                const uint32_t* __restrict__ ninv_sh, int k, int in_rows,
                int in_off) {
  using G = Geometry<LOG_N>;
  extern __shared__ __align__(16) uint32_t tile[];
  const uint32_t row = blockIdx.x >> G::kLogC;
  const int tower = row % k;
  const size_t tw0 = static_cast<size_t>(tower) << LOG_N;
  const uint32_t* src =
      x + (static_cast<size_t>(row / k * in_rows + in_off + tower) << LOG_N);
  auto load = [src](uint32_t (&a)[kR], uint32_t x0) {
    load_words(a, src + x0);
  };
  inv_cluster_row<LOG_N>(load, out + (static_cast<size_t>(row) << LOG_N),
                         ipsi + tw0, ipsi_sh + tw0, qs[tower], ninv + tower,
                         ninv_sh + tower, tile);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Whether the cluster transform takes a ring of 2^log_n; the staged
// transform of ntt_core.cuh serves the others.
inline bool cluster_takes(int log_n) {
  return log_n >= kMinClusterLogN && log_n <= kMaxClusterLogN;
}

using FwdKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                           const uint32_t*, const uint32_t*, int);
using InvKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                           const uint32_t*, const uint32_t*, const uint32_t*,
                           const uint32_t*, int, int, int);

// The kernel of each ring the cluster transform takes, by log2 N.
template <int... I>
FwdKernel fwd_kernel(int log_n, std::integer_sequence<int, I...>) {
  static const FwdKernel kernels[] = {fwd_cluster<kMinClusterLogN + I>...};
  return kernels[log_n - kMinClusterLogN];
}

template <int... I>
InvKernel inv_kernel(int log_n, std::integer_sequence<int, I...>) {
  static const InvKernel kernels[] = {inv_cluster<kMinClusterLogN + I>...};
  return kernels[log_n - kMinClusterLogN];
}

using ClusterRings =
    std::make_integer_sequence<int, kMaxClusterLogN - kMinClusterLogN + 1>;

// Launch kernel on `rows` rows of a ring of 2^log_n words, in clusters of
// N / W blocks; the first launch of each (kernel, ring) with a cluster of
// more than one block asks cudaOccupancyMaxActiveClusters whether a
// cluster can be placed at all (*placeable caches the answer) and refuses
// the launch if not.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int* placeable, int rows,
                   int log_n, cudaStream_t st, Args... args) {
  const int log_w = cluster_log_w(log_n);
  const int log_c = log_n - log_w;
  const size_t smem = sizeof(uint32_t) << log_w;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) << log_c);
  cfg.blockDim = dim3(1u << (log_w - kLogR));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = log_c > 0 ? 1 : 0;     // one block a tower: no cluster
  if (log_c > 0 && !*placeable) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    *placeable = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int check_cluster(const void* x, const void* out, int rows, int k,
                  int log_n) {
  if (int bad = check_shape(rows, k, log_n)) return bad;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out);
  if (!cluster_takes(log_n) || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace
