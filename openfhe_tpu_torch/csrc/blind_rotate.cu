// BinFHE blind rotation for Hopper (sm_90a): the whole n-step loop of one
// gate in one thread block, for the three step forms GINX (CGGI), AP (DM)
// and LMKCDEY.
//
// Replaces, on the narrow ring (one tower, Q < 2^31, 128 <= N <= 2048):
// * the TPU kernel _mat_call of openfhe_tpu/ops/ntt_small.py:157 (kernel
//   m), which runs each of a step's transforms as a dense [B, N] x [N, N]
//   product of int8 limbs on the MXU, two calls a step;
// * the three lax.scan loops around it in openfhe_tpu/binfhe/rgsw.py
//   (eval_acc_cggi :198, eval_acc_dm :357, eval_acc_lmkcdey_scan :571),
//   whose every step the TPU compiles into one program. Run eagerly on a
//   card, a step is some 56 launches (two transforms and the plain ops
//   around them), and the host's launch cost, not the card, bounds it.
//
// What bounds it on an H100: 32-bit integer operations at batch >= 132
// (one gate-step is 8 transforms of N/2 * log2 N butterflies at N = 1024,
// d2 = 6, plus the decomposition and some 26k modular products; the key
// slice of a step, 98 KB for GINX, is shared by every gate through L2), and
// one SM's latency at batch 1, where a gate's n steps run one after another
// on one block. Design:
// * grid = the batch, one block a gate; the block loops over the steps
//   [lo, hi) and keeps the accumulator pair in shared memory, loaded once
//   and stored once;
// * shared memory also holds the d2 digit rows, the forward and inverse
//   twiddles with their Shoup companions (staged once per block, as
//   ntt_small.cu does) and, for GINX, the 2N powers of psi of the
//   monomials: (8 + d2) N words for GINX (56 KB at N = 1024, d2 = 6),
//   (6 + d2) N for AP and LMKCDEY, so the launch raises the block's
//   dynamic shared memory limit first;
// * a step: the inverse transform of both accumulator halves (one
//   __syncthreads per stage for both rows), N^-1 and the balanced base-2^g
//   decomposition with the first digit dropped in int32 exactly as the JAX
//   package does it ((d << (32 - g)) >> (32 - g)), the forward transform of
//   the d2 digit rows (one __syncthreads per stage for all of them), then
//   the key product and the form's epilogue column by column, key words
//   read straight from device memory (L2-resident across the batch), sums
//   over digits kept in 64 bits below 2^63 and reduced once;
// * LMKCDEY's permute-only steps (the initial conjugation, the no-ops that
//   pad a gate's schedule) gather and skip the transforms, whose result
//   they would discard;
// * every step is exact modular arithmetic on words below Q, so the words
//   equal the per-step loop's whatever the order of the sums.
// Later work: a cluster per gate so that a batch of 1 spreads its digit
// rows over several SMs, cp.async prefetch of the next step's key slice,
// stages in registers.
//
// The composite-Q ring (blind_rotate_cggi_wide): GINX over Q = q1 q2, two
// towers below 2^29 at N = 2048 for the STD192-class sets. Replaces kernel
// m (_mat_call, openfhe_tpu/ops/ntt_small.py:157) inside the lax.scan of
// openfhe_tpu/binfhe/rgsw_wide.py eval_acc_cggi_wide (:273), where a step
// is two transforms a tower, a Garner lift to the 64-bit coefficient and
// the key product; run eagerly on a card, a step was two kernel-m
// launches and some 40 plain ones.
// What bounds it: 32-bit operations, 3.3x a narrow step's butterflies at
// N = 2048 and d2 = 4, plus the 64-bit Garner lift and digits. Design:
// * a cluster of 2 blocks a gate, block rank t holding tower t: its
//   accumulator pair, d2 digit rows, twiddles and 2N psi powers, the
//   narrow GINX block's (8 + d2) N words (96 KB at N = 2048 and d2 = 4, so
//   two blocks fit an SM); the grid is 2B blocks;
// * a step: each block runs the inverse transform of its tower's pair;
//   behind a cluster barrier every thread reads, for its columns, both
//   halves in its own tower and in the other block's (distributed shared
//   memory) into registers, N^-1 applied there; behind a second barrier
//   (the other block has read this one's rows) both blocks lift every
//   coefficient by Garner in 64 bits, centre it and cut the same balanced
//   digits, each reducing them into its own tower's digit rows; then the
//   forward transform of the d2 rows and the key product and monomial
//   epilogue of the narrow GINX block, on this tower's key words;
// * every step is exact modular arithmetic, so the words equal the
//   per-step loop's (rgsw_wide.py _wide_step).

#include <cooperative_groups.h>

#include "ntt_core.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMinLog = 7;           // N >= 128
constexpr int kMaxLog = 11;          // N <= 2048
constexpr int kThreads = 512;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

enum Form { kCggi = 0, kDm = 1, kLmk = 2 };

struct Args {
  const uint32_t* acc0;      // [B, N] in
  const uint32_t* acc1;
  uint32_t* out0;            // [B, N] out
  uint32_t* out1;
  const uint32_t* keys;      // CGGI [n, 2, d2, 2, N]; DM, LMK [rows, d2, 2, N]
  const int32_t* sel;        // CGGI idx [n, B]; DM row [steps, B];
                             // LMK sched [L, B, 5]
  const int32_t* perm;       // LMK perm table [w + 2, N]
  const uint32_t* psi;       // [N] forward twiddles, bit-reversed
  const uint32_t* psi_sh;
  const uint32_t* ipsi;      // [N] inverse twiddles
  const uint32_t* ipsi_sh;
  const uint32_t* q;         // [1]
  const uint32_t* ninv;      // [1] N^-1 and its companion
  const uint32_t* ninv_sh;
  const uint32_t* psi_pow;   // CGGI [2N] powers of psi
  int batch, log_n, d2, g_bits, lo, hi;
};

size_t smem_words(int form, int log_n, int d2) {
  return static_cast<size_t>(2 + d2 + 4 + (form == kCggi ? 2 : 0)) << log_n;
}

// Stages of `rows` rows of N words in shared memory (row stride N): each
// stage runs every row's butterflies, then one __syncthreads. The
// butterflies are ntt_core.cuh's tile stages with the tile the whole row.
__device__ __forceinline__ void fwd_rows(uint32_t* s, int rows,
                                         const uint32_t* w,
                                         const uint32_t* w_sh, uint32_t q,
                                         int log_n) {
  const uint32_t half = 1u << (log_n - 1);
  const uint32_t total = rows * half;
  for (int log_m = 0; log_m < log_n; ++log_m) {
    const int log_t = log_n - 1 - log_m;
    for (uint32_t x = threadIdx.x; x < total; x += blockDim.x) {
      uint32_t* row = s + ((x >> (log_n - 1)) << log_n);
      const uint32_t b = x & (half - 1);
      const uint32_t g = b >> log_t;
      const uint32_t lu = (g << (log_t + 1)) + (b & ((1u << log_t) - 1));
      const uint32_t lv = lu + (1u << log_t);
      const uint32_t tw = (1u << log_m) + g;
      const uint32_t u = row[lu];
      const uint32_t v = mul_shoup(row[lv], w[tw], w_sh[tw], q);
      row[lu] = add_mod(u, v, q);
      row[lv] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void inv_rows(uint32_t* s, int rows,
                                         const uint32_t* w,
                                         const uint32_t* w_sh, uint32_t q,
                                         int log_n) {
  const uint32_t half = 1u << (log_n - 1);
  const uint32_t total = rows * half;
  for (int log_m = log_n - 1; log_m >= 0; --log_m) {
    const int log_t = log_n - 1 - log_m;
    for (uint32_t x = threadIdx.x; x < total; x += blockDim.x) {
      uint32_t* row = s + ((x >> (log_n - 1)) << log_n);
      const uint32_t b = x & (half - 1);
      const uint32_t g = b >> log_t;
      const uint32_t lu = (g << (log_t + 1)) + (b & ((1u << log_t) - 1));
      const uint32_t lv = lu + (1u << log_t);
      const uint32_t tw = (1u << log_m) + g;
      const uint32_t u = row[lu];
      const uint32_t v = row[lv];
      row[lu] = add_mod(u, v, q);
      row[lv] = mul_shoup(sub_mod(u, v, q), w[tw], w_sh[tw], q);
    }
    __syncthreads();
  }
}

// The balanced low base-2^g digit of d (sign-extended low g bits) and the
// rest, in int32 as the JAX package computes it.
__device__ __forceinline__ int32_t low_digit(int32_t& d, int g_bits) {
  const int sh = 32 - g_bits;
  const int32_t r = static_cast<int32_t>(static_cast<uint32_t>(d) << sh) >> sh;
  d = (d - r) >> g_bits;
  return r;
}

// Writes the digitsG - 1 digits of c after the dropped first one into rows
// which, which + 2, ... of dig (column j).
__device__ __forceinline__ void decompose(uint32_t c, uint32_t q, int g_bits,
                                          int d2, uint32_t* dig, int which,
                                          uint32_t j, int log_n) {
  int32_t d = static_cast<int32_t>(c) -
              (c >= (q >> 1) ? static_cast<int32_t>(q) : 0);
  low_digit(d, g_bits);
  for (int r = which; r < d2; r += 2) {
    const int32_t v = low_digit(d, g_bits);
    dig[(static_cast<uint32_t>(r) << log_n) + j] =
        static_cast<uint32_t>(v < 0 ? v + static_cast<int32_t>(q) : v);
  }
}

// s + x for a 64-bit sum kept below 2^63: x < 2^62 (a product of two
// words), `big` a multiple of q in [2^63 - q, 2^63].
__device__ __forceinline__ uint64_t add_wide(uint64_t s, uint64_t x,
                                             uint64_t big) {
  s += x;
  return s >= (1ull << 63) ? s - big : s;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads, 2)
    blind_rotate_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  const int log_n = a.log_n;
  const uint32_t n = 1u << log_n;
  const int d2 = a.d2;
  uint32_t* acc0 = smem;
  uint32_t* acc1 = smem + n;
  uint32_t* dig = smem + 2 * n;                  // [d2, N]
  uint32_t* w = dig + (static_cast<size_t>(d2) << log_n);
  uint32_t* w_sh = w + n;
  uint32_t* iw = w + 2 * n;
  uint32_t* iw_sh = w + 3 * n;
  uint32_t* pows = w + 4 * n;                    // [2N], CGGI
  const int gate = blockIdx.x;
  const uint32_t q = *a.q;
  const uint32_t ninv = *a.ninv, ninv_sh = *a.ninv_sh;
  const uint64_t big = (0x8000000000000000ull / q) * q;
  const size_t key_rows = static_cast<size_t>(d2) * 2 << log_n;

  for (uint32_t x = threadIdx.x; x < n; x += blockDim.x) {
    w[x] = a.psi[x];
    w_sh[x] = a.psi_sh[x];
    iw[x] = a.ipsi[x];
    iw_sh[x] = a.ipsi_sh[x];
    if (kForm == kCggi) {
      pows[x] = a.psi_pow[x];
      pows[x + n] = a.psi_pow[x + n];
    }
  }
  {
    const size_t base = static_cast<size_t>(gate) << log_n;
    const uint4* s0 = reinterpret_cast<const uint4*>(a.acc0 + base);
    const uint4* s1 = reinterpret_cast<const uint4*>(a.acc1 + base);
    uint4* d0 = reinterpret_cast<uint4*>(acc0);
    uint4* d1 = reinterpret_cast<uint4*>(acc1);
    for (uint32_t x = threadIdx.x; x < n / 4; x += blockDim.x) {
      d0[x] = s0[x];
      d1[x] = s1[x];
    }
  }
  __syncthreads();

  for (int step = a.lo; step < a.hi; ++step) {
    // prologue: the step's operands, and the pair to transform in dig's
    // rows 0 and 1
    const uint32_t* key;
    uint32_t ix = 0;
    int pass0 = 0, use_sum = 1, add_b = 0;
    if (kForm == kLmk) {
      const int32_t* f =
          a.sel + (static_cast<size_t>(step) * a.batch + gate) * 5;
      const int32_t* perm = a.perm + (static_cast<size_t>(f[0]) << log_n);
      key = a.keys + static_cast<size_t>(f[1]) * key_rows;
      pass0 = f[2];
      use_sum = f[3];
      add_b = f[4];
      // the gather reads other threads' columns of the last epilogue
      __syncthreads();
      for (uint32_t j = threadIdx.x; j < n; j += blockDim.x) {
        const int32_t p = perm[j];
        dig[j] = acc0[p];
        dig[n + j] = acc1[p];
      }
      __syncthreads();
      const bool permute_only = pass0 && !use_sum;
      for (uint32_t j = threadIdx.x; j < n; j += blockDim.x) {
        acc0[j] = dig[j];
        acc1[j] = add_b ? dig[n + j] : 0u;
      }
      if (permute_only) continue;   // the result needs no transform
      __syncthreads();
    } else {
      if (kForm == kCggi) {
        key = a.keys + static_cast<size_t>(step) * 2 * key_rows;
        ix = static_cast<uint32_t>(
            a.sel[static_cast<size_t>(step) * a.batch + gate]);
      } else {
        key = a.keys + static_cast<size_t>(
            a.sel[static_cast<size_t>(step) * a.batch + gate]) * key_rows;
      }
      for (uint32_t j = threadIdx.x; j < n; j += blockDim.x) {
        dig[j] = acc0[j];
        dig[n + j] = acc1[j];
      }
      __syncthreads();
    }

    // INTT of both halves, N^-1 and the digits (rows 2i from acc0, 2i + 1
    // from acc1), then the forward transform of every digit row
    inv_rows(dig, 2, iw, iw_sh, q, log_n);
    for (uint32_t j = threadIdx.x; j < n; j += blockDim.x) {
      const uint32_t p0 = mul_shoup(dig[j], ninv, ninv_sh, q);
      const uint32_t p1 = mul_shoup(dig[n + j], ninv, ninv_sh, q);
      decompose(p0, q, a.g_bits, d2, dig, 0, j, log_n);
      decompose(p1, q, a.g_bits, d2, dig, 1, j, log_n);
    }
    __syncthreads();
    fwd_rows(dig, d2, w, w_sh, q, log_n);

    // key product and epilogue, column by column (each thread its own
    // columns, as in every column pass above)
    for (uint32_t j = threadIdx.x; j < n; j += blockDim.x) {
      if (kForm == kCggi) {
        // acc += sum_k (sum_r dct_r * key[k, r]) * (X^{+-ix} - 1)
        uint64_t t[2][2] = {{0, 0}, {0, 0}};
        for (int r = 0; r < d2; ++r) {
          const uint64_t dv = dig[(static_cast<uint32_t>(r) << log_n) + j];
          for (int k = 0; k < 2; ++k)
            for (int c = 0; c < 2; ++c)
              t[k][c] = add_wide(
                  t[k][c],
                  dv * key[((static_cast<size_t>(k) * d2 + r) * 2 + c) * n + j],
                  big);
        }
        const uint32_t two_n_mask = 2 * n - 1;
        const uint32_t e = 2 * (__brev(j) >> (32 - log_n)) + 1;
        const uint32_t mono[2] = {
            pows[(ix * e) & two_n_mask],
            pows[(((2 * n - ix) & two_n_mask) * e) & two_n_mask]};
        uint32_t* accs[2] = {acc0, acc1};
        for (int c = 0; c < 2; ++c) {
          uint64_t s = accs[c][j];
          for (int k = 0; k < 2; ++k)
            s += (t[k][c] % q) * static_cast<uint64_t>(mono[k] - 1);
          accs[c][j] = static_cast<uint32_t>(s % q);
        }
      } else {
        uint64_t s0 = 0, s1 = 0;
        for (int r = 0; r < d2; ++r) {
          const uint64_t dv = dig[(static_cast<uint32_t>(r) << log_n) + j];
          const uint32_t* kr = key + (static_cast<size_t>(r) * 2 << log_n);
          s0 = add_wide(s0, dv * kr[j], big);
          s1 = add_wide(s1, dv * kr[n + j], big);
        }
        const uint32_t v0 = static_cast<uint32_t>(s0 % q);
        const uint32_t v1 = static_cast<uint32_t>(s1 % q);
        if (kForm == kDm) {
          acc0[j] = v0;
          acc1[j] = v1;
        } else {
          // acc0 = pass0 ? a_g : s0; acc1 = (use_sum ? s1 : 0) + (add_b ?
          // b_g : 0), acc1 already holding the masked b_g
          if (!pass0) acc0[j] = v0;
          if (use_sum) acc1[j] = add_mod(acc1[j], v1, q);
        }
      }
    }
  }
  __syncthreads();
  {
    const size_t base = static_cast<size_t>(gate) << log_n;
    uint4* d0 = reinterpret_cast<uint4*>(a.out0 + base);
    uint4* d1 = reinterpret_cast<uint4*>(a.out1 + base);
    const uint4* s0 = reinterpret_cast<const uint4*>(acc0);
    const uint4* s1 = reinterpret_cast<const uint4*>(acc1);
    for (uint32_t x = threadIdx.x; x < n / 4; x += blockDim.x) {
      d0[x] = s0[x];
      d1[x] = s1[x];
    }
  }
}

// The composite-Q form: accumulators [B, 2, N] (tower, slots), key
// [n, 2, d2, 2, 2, N] (coordinate, CMUX key, gadget row, (a, b), tower,
// slots), the basis' tables [2, N] and constants [2], psi powers [2, 2N].
struct WideArgs {
  const uint32_t* acc0;
  const uint32_t* acc1;
  uint32_t* out0;
  uint32_t* out1;
  const uint32_t* keys;
  const int32_t* idx;        // [n, B]
  const uint32_t* psi;
  const uint32_t* psi_sh;
  const uint32_t* ipsi;
  const uint32_t* ipsi_sh;
  const uint32_t* q;
  const uint32_t* ninv;
  const uint32_t* ninv_sh;
  const uint32_t* psi_pow;
  uint32_t q1_inv;           // q1^-1 mod q2
  int batch, log_n, d2, g_bits, lo, hi;
};

// the columns a thread owns: N / min(N / 2, kThreads) <= 4
constexpr int kMaxCols = (1 << kMaxLog) / kThreads;

// The balanced low base-2^g digit of x (sign-extended low g bits) and the
// rest, in int64: rgsw_wide.signed_digits' r = ((x & mask) ^ half) - half,
// x = (x - r) >> g.
__device__ __forceinline__ int64_t low_digit64(int64_t& x, int g_bits) {
  const int sh = 64 - g_bits;
  const int64_t r =
      static_cast<int64_t>(static_cast<uint64_t>(x) << sh) >> sh;
  x = (x - r) >> g_bits;
  return r;
}

// Writes the digits after the dropped first one of the coefficient with
// residues (x1, x2) mod (q1, q2) into rows which, which + 2, ... of dig
// (column j), reduced into this block's tower q: Garner's x = x1 + q1 ((x2
// - x1) q1^-1 mod q2) in [0, Q), centred to x - Q where x >= Q / 2.
__device__ __forceinline__ void decompose_wide(
    uint32_t x1, uint32_t x2, uint32_t q1, uint32_t q2, uint32_t q1_inv,
    uint64_t big_q, uint32_t q, int g_bits, int d2, uint32_t* dig,
    int which, uint32_t j, int log_n) {
  const uint32_t x1m = x1 % q2;
  const uint32_t diff = x2 >= x1m ? x2 - x1m : x2 + (q2 - x1m);
  const uint64_t t = static_cast<uint64_t>(diff) * q1_inv % q2;
  const uint64_t x = x1 + static_cast<uint64_t>(q1) * t;
  int64_t c = static_cast<int64_t>(x) -
              (x >= (big_q >> 1) ? static_cast<int64_t>(big_q) : 0);
  low_digit64(c, g_bits);
  for (int r = which; r < d2; r += 2) {
    const int64_t v = low_digit64(c, g_bits);
    dig[(static_cast<uint32_t>(r) << log_n) + j] =
        static_cast<uint32_t>(v < 0 ? v + q : v);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    blind_rotate_wide_kernel(const WideArgs a) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tower = static_cast<int>(cluster.block_rank());
  const int other = tower ^ 1;
  const int log_n = a.log_n;
  const uint32_t n = 1u << log_n;
  const int d2 = a.d2;
  uint32_t* acc0 = smem;
  uint32_t* acc1 = smem + n;
  uint32_t* dig = smem + 2 * n;                  // [d2, N]
  uint32_t* w = dig + (static_cast<size_t>(d2) << log_n);
  uint32_t* w_sh = w + n;
  uint32_t* iw = w + 2 * n;
  uint32_t* iw_sh = w + 3 * n;
  uint32_t* pows = w + 4 * n;                    // [2N]
  const uint32_t* peer = cluster.map_shared_rank(dig, other);
  const int gate = blockIdx.x >> 1;
  const uint32_t q = a.q[tower], q_other = a.q[other];
  const uint32_t q1 = a.q[0], q2 = a.q[1];
  const uint64_t big_q = static_cast<uint64_t>(q1) * q2;
  const uint32_t ninv = a.ninv[tower], ninv_sh = a.ninv_sh[tower];
  const uint32_t ninv_o = a.ninv[other], ninv_sh_o = a.ninv_sh[other];
  const uint64_t big = (0x8000000000000000ull / q) * q;
  const size_t tw_off = static_cast<size_t>(tower) << log_n;
  // words of a step's key (both towers); row (k, r, c) of this tower at
  // ((k d2 + r) 2 + c) 2N + tw_off
  const size_t key_step = static_cast<size_t>(8 * d2) << log_n;

  for (uint32_t x = threadIdx.x; x < n; x += blockDim.x) {
    w[x] = a.psi[tw_off + x];
    w_sh[x] = a.psi_sh[tw_off + x];
    iw[x] = a.ipsi[tw_off + x];
    iw_sh[x] = a.ipsi_sh[tw_off + x];
    pows[x] = a.psi_pow[2 * tw_off + x];
    pows[x + n] = a.psi_pow[2 * tw_off + n + x];
  }
  const size_t base = (static_cast<size_t>(gate) * 2 + tower) << log_n;
  {
    const uint4* s0 = reinterpret_cast<const uint4*>(a.acc0 + base);
    const uint4* s1 = reinterpret_cast<const uint4*>(a.acc1 + base);
    uint4* d0 = reinterpret_cast<uint4*>(acc0);
    uint4* d1 = reinterpret_cast<uint4*>(acc1);
    for (uint32_t x = threadIdx.x; x < n / 4; x += blockDim.x) {
      d0[x] = s0[x];
      d1[x] = s1[x];
    }
  }
  __syncthreads();

  for (int step = a.lo; step < a.hi; ++step) {
    const uint32_t* key = a.keys + static_cast<size_t>(step) * key_step +
                          tw_off;
    const uint32_t ix = static_cast<uint32_t>(
        a.idx[static_cast<size_t>(step) * a.batch + gate]);
    for (uint32_t j = threadIdx.x; j < n; j += blockDim.x) {
      dig[j] = acc0[j];
      dig[n + j] = acc1[j];
    }
    __syncthreads();
    inv_rows(dig, 2, iw, iw_sh, q, log_n);

    // both towers' coefficients of this thread's columns, N^-1 applied
    uint32_t mine[kMaxCols][2], theirs[kMaxCols][2];
    cluster.sync();                 // both blocks' transforms are done
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const uint32_t j = threadIdx.x + c * blockDim.x;
      if (j < n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mine[c][h] = mul_shoup(dig[h * n + j], ninv, ninv_sh, q);
          theirs[c][h] = mul_shoup(peer[h * n + j], ninv_o, ninv_sh_o,
                                   q_other);
        }
      }
    }
    cluster.sync();                 // the other block has read these rows
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const uint32_t j = threadIdx.x + c * blockDim.x;
      if (j < n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t x1 = tower == 0 ? mine[c][h] : theirs[c][h];
          const uint32_t x2 = tower == 0 ? theirs[c][h] : mine[c][h];
          decompose_wide(x1, x2, q1, q2, a.q1_inv, big_q, q, a.g_bits, d2,
                         dig, h, j, log_n);
        }
      }
    }
    __syncthreads();
    fwd_rows(dig, d2, w, w_sh, q, log_n);

    // acc += sum_k (sum_r dct_r * key[k, r]) * (X^{+-ix} - 1), this tower
    for (uint32_t j = threadIdx.x; j < n; j += blockDim.x) {
      uint64_t t[2][2] = {{0, 0}, {0, 0}};
      for (int r = 0; r < d2; ++r) {
        const uint64_t dv = dig[(static_cast<uint32_t>(r) << log_n) + j];
        for (int k = 0; k < 2; ++k)
          for (int c = 0; c < 2; ++c)
            t[k][c] = add_wide(
                t[k][c],
                dv * key[(((static_cast<size_t>(k) * d2 + r) * 2 + c)
                          << (log_n + 1)) + j],
                big);
      }
      const uint32_t two_n_mask = 2 * n - 1;
      const uint32_t e = 2 * (__brev(j) >> (32 - log_n)) + 1;
      const uint32_t mono[2] = {
          pows[(ix * e) & two_n_mask],
          pows[(((2 * n - ix) & two_n_mask) * e) & two_n_mask]};
      uint32_t* accs[2] = {acc0, acc1};
      for (int c = 0; c < 2; ++c) {
        uint64_t s = accs[c][j];
        for (int k = 0; k < 2; ++k)
          s += (t[k][c] % q) * static_cast<uint64_t>(mono[k] - 1);
        accs[c][j] = static_cast<uint32_t>(s % q);
      }
    }
  }
  __syncthreads();
  {
    uint4* d0 = reinterpret_cast<uint4*>(a.out0 + base);
    uint4* d1 = reinterpret_cast<uint4*>(a.out1 + base);
    const uint4* s0 = reinterpret_cast<const uint4*>(acc0);
    const uint4* s1 = reinterpret_cast<const uint4*>(acc1);
    for (uint32_t x = threadIdx.x; x < n / 4; x += blockDim.x) {
      d0[x] = s0[x];
      d1[x] = s1[x];
    }
  }
}

int launch_wide(const WideArgs& a, int steps, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.acc0) |
                          reinterpret_cast<uintptr_t>(a.acc1) |
                          reinterpret_cast<uintptr_t>(a.out0) |
                          reinterpret_cast<uintptr_t>(a.out1);
  const size_t smem = smem_words(kCggi, a.log_n, a.d2) * sizeof(uint32_t);
  if (a.batch < 1 || a.log_n < kMinLog || a.log_n > kMaxLog || a.d2 < 2 ||
      a.d2 > 16 || a.d2 % 2 != 0 || a.g_bits < 1 || a.g_bits > 31 ||
      a.lo < 0 || a.hi < a.lo || a.hi > steps || align % 16 != 0 ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 1 << a.log_n;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;     // the two towers of a gate
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2u * static_cast<unsigned>(a.batch));
  cfg.blockDim = dim3(n / 2 < kThreads ? n / 2 : kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, blind_rotate_wide_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kForm>
int launch(const Args& a, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.acc0) |
                          reinterpret_cast<uintptr_t>(a.acc1) |
                          reinterpret_cast<uintptr_t>(a.out0) |
                          reinterpret_cast<uintptr_t>(a.out1);
  const size_t smem = smem_words(kForm, a.log_n, a.d2) * sizeof(uint32_t);
  if (a.batch < 1 || a.log_n < kMinLog || a.log_n > kMaxLog || a.d2 < 2 ||
      a.d2 % 2 != 0 || a.g_bits < 1 || a.g_bits > 31 || a.lo < 0 ||
      a.hi < a.lo || align % 16 != 0 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel<kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 1 << a.log_n;
  const int threads = n / 2 < kThreads ? n / 2 : kThreads;
  blind_rotate_kernel<kForm><<<a.batch, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* acc0, const void* acc1, void* out0, void* out1,
               const void* keys, const void* sel, const void* perm,
               const void* psi, const void* psi_sh, const void* ipsi,
               const void* ipsi_sh, const void* q, const void* ninv,
               const void* ninv_sh, const void* psi_pow, int batch,
               int log_n, int d2, int g_bits, int lo, int hi) {
  return Args{static_cast<const uint32_t*>(acc0),
              static_cast<const uint32_t*>(acc1),
              static_cast<uint32_t*>(out0),
              static_cast<uint32_t*>(out1),
              static_cast<const uint32_t*>(keys),
              static_cast<const int32_t*>(sel),
              static_cast<const int32_t*>(perm),
              static_cast<const uint32_t*>(psi),
              static_cast<const uint32_t*>(psi_sh),
              static_cast<const uint32_t*>(ipsi),
              static_cast<const uint32_t*>(ipsi_sh),
              static_cast<const uint32_t*>(q),
              static_cast<const uint32_t*>(ninv),
              static_cast<const uint32_t*>(ninv_sh),
              static_cast<const uint32_t*>(psi_pow),
              batch, log_n, d2, g_bits, lo, hi};
}

}  // namespace

// Common arguments: acc0, acc1 [B, N] EVAL words in, out0, out1 [B, N]
// out (all 16-byte aligned); psi, psi_sh, ipsi, ipsi_sh [N] the basis'
// bit-reversed twiddles and companions; q, ninv, ninv_sh [1]; d2 digit
// rows of g_bits bits; steps [lo, hi). Each returns cudaGetLastError()
// after the launch, or the error of a refused launch.

// GINX: bskey [n, 2, d2, 2, N]; idx [n, B] = ((q - a) mod q) * (2N / q);
// psi_pow [2N].
extern "C" int blind_rotate_cggi(const void* acc0, const void* acc1,
                                 void* out0, void* out1, const void* bskey,
                                 const void* idx, const void* psi,
                                 const void* psi_sh, const void* ipsi,
                                 const void* ipsi_sh, const void* q,
                                 const void* ninv, const void* ninv_sh,
                                 const void* psi_pow, int batch, int log_n,
                                 int d2, int g_bits, int lo, int hi,
                                 void* stream) {
  return launch<kCggi>(make_args(acc0, acc1, out0, out1, bskey, idx, nullptr,
                                 psi, psi_sh, ipsi, ipsi_sh, q, ninv, ninv_sh,
                                 psi_pow, batch, log_n, d2, g_bits, lo, hi),
                       stream);
}

// AP: keys [n * dR * baseR, d2, 2, N]; row [n * dR, B] the key row of each
// step and gate.
extern "C" int blind_rotate_dm(const void* acc0, const void* acc1, void* out0,
                               void* out1, const void* keys, const void* row,
                               const void* psi, const void* psi_sh,
                               const void* ipsi, const void* ipsi_sh,
                               const void* q, const void* ninv,
                               const void* ninv_sh, int batch, int log_n,
                               int d2, int g_bits, int lo, int hi,
                               void* stream) {
  return launch<kDm>(make_args(acc0, acc1, out0, out1, keys, row, nullptr,
                               psi, psi_sh, ipsi, ipsi_sh, q, ninv, ninv_sh,
                               nullptr, batch, log_n, d2, g_bits, lo, hi),
                     stream);
}

// LMKCDEY: key_bank [rows, d2, 2, N]; perm [w + 2, N]; sched [L, B, 5]
// (perm_sel, key_sel, pass0, use_sum, add_b) per step and gate.
extern "C" int blind_rotate_lmkcdey(const void* acc0, const void* acc1,
                                    void* out0, void* out1,
                                    const void* key_bank, const void* perm,
                                    const void* sched, const void* psi,
                                    const void* psi_sh, const void* ipsi,
                                    const void* ipsi_sh, const void* q,
                                    const void* ninv, const void* ninv_sh,
                                    int batch, int log_n, int d2, int g_bits,
                                    int lo, int hi, void* stream) {
  return launch<kLmk>(make_args(acc0, acc1, out0, out1, key_bank, sched, perm,
                                psi, psi_sh, ipsi, ipsi_sh, q, ninv, ninv_sh,
                                nullptr, batch, log_n, d2, g_bits, lo, hi),
                      stream);
}

// GINX on the composite-Q ring: acc0, acc1 [B, 2, N] in, out0, out1 [B,
// 2, N] out (all 16-byte aligned); bskey [n, 2, d2, 2, 2, N]; idx [n, B];
// psi .. ipsi_sh [2, N], q, ninv, ninv_sh [2] the 2-tower basis; psi_pow
// [2, 2N]; q1_inv = q1^-1 mod q2; steps [lo, hi) of the key's `steps`.
extern "C" int blind_rotate_cggi_wide(
    const void* acc0, const void* acc1, void* out0, void* out1,
    const void* bskey, const void* idx, const void* psi, const void* psi_sh,
    const void* ipsi, const void* ipsi_sh, const void* q, const void* ninv,
    const void* ninv_sh, const void* psi_pow, int q1_inv, int batch,
    int log_n, int d2, int g_bits, int lo, int hi, int steps,
    void* stream) {
  const WideArgs a{static_cast<const uint32_t*>(acc0),
                   static_cast<const uint32_t*>(acc1),
                   static_cast<uint32_t*>(out0),
                   static_cast<uint32_t*>(out1),
                   static_cast<const uint32_t*>(bskey),
                   static_cast<const int32_t*>(idx),
                   static_cast<const uint32_t*>(psi),
                   static_cast<const uint32_t*>(psi_sh),
                   static_cast<const uint32_t*>(ipsi),
                   static_cast<const uint32_t*>(ipsi_sh),
                   static_cast<const uint32_t*>(q),
                   static_cast<const uint32_t*>(ninv),
                   static_cast<const uint32_t*>(ninv_sh),
                   static_cast<const uint32_t*>(psi_pow),
                   static_cast<uint32_t>(q1_inv),
                   batch, log_n, d2, g_bits, lo, hi};
  return launch_wide(a, steps, stream);
}
