// Small-ring negacyclic NTT (128 <= N <= 2048, k <= 4 towers) for Hopper
// (sm_90a): kernel m, BinFHE's transforms outside the blind rotation (the
// test vector, the extraction, keygen, the host-scheduled loops), the
// lattice toolbox's at n <= 2048 and every other transform of such a ring
// with at most 4 towers.
//
// Replaces the TPU kernel _mat_call of openfhe_tpu/ops/ntt_small.py:157
// (body _ntt_mat_kernel), which runs each transform as one dense [B, N] x
// [N, N] product of int8 limbs on the MXU. That costs N^2 multiply-adds
// against N log N and exists only for the MXU; Hopper's tensor cores have
// no 32-bit integer product. Here it is the butterfly transform of
// ntt_cluster.cuh (Cooley-Tukey DIT forward, Gentleman-Sande inverse with
// N^-1 folded into the last round, bit-reversed twiddles with Shoup
// companions), whose words equal the dense product's: COEFF natural order
// <-> EVAL bit-reversed order with the basis' own roots.
//
// What bounds it on an H100: at a gate batch's digits ([1536, 1024]) the
// bytes, each 4 KB row read and written once (3.8 us at 3.35 TB/s), with
// the butterflies' 32-bit operations close behind (about ten a butterfly,
// 2.4 us at the SMs' integer issue rate); at one ring element ([1, 1024])
// latency: the launch, a row's trip from device memory and back, and the
// barriers between its rounds on one SM.
//
// Design, against what held the first form (one row at a time a block,
// a block barrier after each of the log2 N stages, every butterfly through
// shared memory, the geometry a run-time argument) back:
// * a kernel for each ring, N = 2^7 .. 2^11, so shifts, shared offsets and
//   twiddle offsets are immediates;
// * a row belongs to a group of N / 16 threads, each holding 16 words in
//   registers; the stages run in rounds of 4 between passes through the
//   group's shared memory (ntt_cluster.cuh's fwd_rounds, inv_rounds and
//   inv_cluster_row, their round_base lanes and `phys` swizzle: every
//   access by a warp falls in 32 banks): 3 rounds at N = 512 .. 2048, 2
//   below, and 3 or 4 group barriers a row, against 12 block barriers at
//   N = 1024 before;
// * a block holds up to 128 threads (2 groups at N = 1024, 16 at N = 128,
//   one at 2048), each group on its own barrier: a named barrier for a
//   group of 2 or 4 warps, __syncwarp over its lanes for a warp or less,
//   so one row's exchange never waits for another's; groups that share a
//   warp (N = 128, 256) start their buffers a group's width of banks
//   apart;
// * a block serves one tower (blockIdx.y): it copies the tower's twiddles
//   and companions into shared memory once (8 KB at N = 1024), each at
//   phys<kSwizzleLog>(i), where the reads of every round fall in distinct
//   banks; its groups then take the tower's rows, k rows apart in memory,
//   group g of the launch rows g, g + G, ... of its tower (G groups in
//   all);
// * each group has two row buffers: the next row is copied in with
//   cp.async, a word at a time straight to its swizzled place (so the
//   buffer is the tile the rounds run in), while this row's rounds run;
// * both directions read and write device memory coalesced, each warp
//   128 bytes a copy or a store: the forward's last round writes its 16
//   consecutive words a thread back into the tile, and the row leaves a
//   word a lane (16-byte stores of 16 consecutive words a thread, as
//   ntt.cu's epilogue does them, each warp's spread over 2 KB, kept the
//   forward behind the inverse on an H100);
// * the grid is as many groups as the card holds at once (4 blocks an
//   SM), each with the same share of its tower's rows: [1536, 1024] is
//   384 blocks of 2 groups, each group 2 rows in turn; [1, 1024] one block
//   of one group.

#include <utility>

#include "ntt_cluster.cuh"

namespace {

// ops/ntt_small.py repeats the geometry constants below, and a test holds
// the two equal
constexpr int kMinLog = 7;           // N >= 128
constexpr int kMaxLog = 11;          // N <= 2048
constexpr int kMaxTowers = 4;
constexpr int kBlockThreads = 128;   // at most: fewer when rows are few
constexpr int kBlocksPerSm = 4;      // at up to 128 registers a thread

// The words of a group's region at ring 2^log_n: its two row buffers, and
// for groups that share a warp a group's width of padding, so that the
// next group's buffers start that many banks on.
__host__ __device__ constexpr uint32_t group_words(int log_n) {
  return (2u << log_n) +
         ((1u << (log_n - kLogR)) < 32 ? (1u << (log_n - kLogR)) : 0);
}

// The threads of one group (a row) as the round helpers see them (a Pass,
// ntt_cluster.cuh): thread t of group `group` of its block.
template <int LOG_N>
struct GroupPass {
  static constexpr uint32_t kThreads = Geometry<LOG_N>::kThreads;
  uint32_t t, group;

  __device__ __forceinline__ uint32_t tid() const { return t; }

  __device__ __forceinline__ void sync() const {
    if constexpr (kThreads >= 64) {
      // named barrier group + 1 (0 is __syncthreads') over the group's warps
      asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(kThreads)
                   : "memory");
    } else if constexpr (kThreads == 32) {
      __syncwarp();
    } else {
      __syncwarp(((1u << kThreads) - 1) << (threadIdx.x & 31u &
                                            ~(kThreads - 1)));
    }
  }

  // the block's copy of the tower's table holds word i at phys(i)
  __device__ __forceinline__ uint32_t twiddle(const uint32_t* table,
                                              uint32_t i0, uint32_t h) const {
    return table[phys<kSwizzleLog>(i0) ^ h];
  }
};

__device__ __forceinline__ void copy_word_async(uint32_t* to,
                                                const uint32_t* from) {
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(at),
               "l"(from)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The transform of rows p * k + blockIdx.y, p < polys, of x into out (N =
// 2^LOG_N words a row), by groups of N / 16 threads. tw / tw_sh: [k, N]
// bit-reversed twiddles and companions (the inverse's with c / c_sh: [k]
// N^-1 and its companion, the last round's multiply).
template <int LOG_N, bool kInverse>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSm)
    ntt_small_group(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ tw,
                    const uint32_t* __restrict__ tw_sh,
                    const uint32_t* __restrict__ qs,
                    const uint32_t* __restrict__ c,
                    const uint32_t* __restrict__ c_sh, int polys, int k) {
  using G = Geometry<LOG_N>;
  static_assert(G::kLogC == 0 && G::kLo1 > 0, "one group a row");
  static_assert(G::kThreads < 64 || kBlockThreads / G::kThreads < 16,
                "a named barrier a group");
  constexpr uint32_t kN = 1u << LOG_N;
  constexpr uint32_t kT = G::kThreads;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_tw = smem;
  uint32_t* s_tw_sh = smem + kN;
  const GroupPass<LOG_N> pass{threadIdx.x % kT, threadIdx.x / kT};
  uint32_t* buf = smem + 2 * kN + pass.group * group_words(LOG_N);
  const uint32_t tower = blockIdx.y;
  const size_t tw0 = static_cast<size_t>(tower) << LOG_N;

  for (uint32_t i = threadIdx.x; i < kN; i += blockDim.x) {
    const uint32_t at = phys<kSwizzleLog>(i);
    copy_word_async(s_tw + at, tw + tw0 + i);
    copy_word_async(s_tw_sh + at, tw_sh + tw0 + i);
  }
  // row p of the tower into a buffer, word i at phys(i); thread t copies
  // words t + v kT (each warp 128 consecutive bytes a copy)
  auto fetch = [&](uint32_t p, uint32_t* to) {
    const uint32_t* src = x + ((static_cast<size_t>(p) * k + tower) << LOG_N);
#pragma unroll
    for (uint32_t v = 0; v < kR; ++v) {
      const uint32_t i = pass.t + v * kT;
      copy_word_async(to + phys<LOG_N>(i), src + i);
    }
  };
  const uint32_t groups = blockDim.x / kT;
  const uint32_t stride = gridDim.x * groups;
  uint32_t p = blockIdx.x * groups + pass.group;
  if (p < static_cast<uint32_t>(polys)) fetch(p, buf);
  copies_commit();
  const uint32_t q = qs[tower];
  for (uint32_t turn = 0;; ++turn, p += stride) {
    // this row is in; every thread of the group is past the last row's
    // reads of the other buffer (and, the first time, of the block's
    // twiddles)
    copies_wait();
    if (turn == 0)
      __syncthreads();
    else
      pass.sync();
    if (p >= static_cast<uint32_t>(polys)) break;
    uint32_t* tile = buf + (turn & 1) * kN;
    if (p + stride < static_cast<uint32_t>(polys))
      fetch(p + stride, buf + ((turn + 1) & 1) * kN);
    copies_commit();
    uint32_t* dst = out + ((static_cast<size_t>(p) * k + tower) << LOG_N);
    if constexpr (kInverse) {
      // the first round's 16 consecutive words a thread, read in place
      auto load = [tile](uint32_t (&a)[kR], uint32_t x0) {
        const uint32_t at = phys<LOG_N>(x0);
#pragma unroll
        for (uint32_t s = 0; s < kR; ++s) a[s] = tile[at ^ s];
      };
      inv_cluster_row<LOG_N>(load, dst, s_tw, s_tw_sh, q, c + tower,
                             c_sh + tower, tile, pass);
    } else {
      // the last round's 16 consecutive words a thread go back where they
      // were read, then out a word a lane, each warp 128 bytes a store
      auto keep = [tile](const uint32_t (&a)[kR], uint32_t x0) {
        const uint32_t at = phys<LOG_N>(x0);
#pragma unroll
        for (uint32_t s = 0; s < kR; ++s) tile[at ^ s] = a[s];
      };
      uint32_t a[kR];
      Twiddles w;
      load_twiddles<LOG_N, G::kLo1, 0, kLogR - 1>(w, pass.t, s_tw, s_tw_sh,
                                                   pass);
      fwd_rounds<LOG_N, LOG_N - 1>(a, w, tile, pass.t, 0, keep, s_tw,
                                   s_tw_sh, q, pass);
      pass.sync();
#pragma unroll
      for (uint32_t v = 0; v < kR; ++v) {
        const uint32_t i = pass.t + v * kT;
        dst[i] = tile[phys<LOG_N>(i)];
      }
    }
  }
}

using Kernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                        const uint32_t*, const uint32_t*, const uint32_t*,
                        const uint32_t*, int, int);

// The kernel of each ring, by log2 N.
template <bool kInverse, int... I>
Kernel small_kernel(int log_n, std::integer_sequence<int, I...>) {
  static const Kernel kernels[] = {ntt_small_group<kMinLog + I, kInverse>...};
  return kernels[log_n - kMinLog];
}

using Rings = std::make_integer_sequence<int, kMaxLog - kMinLog + 1>;

template <bool kInverse>
int launch(const void* x, void* out, const void* tw, const void* tw_sh,
           const void* q, const void* c, const void* c_sh, int rows, int k,
           int log_n, void* stream) {
  if (rows < 1 || k < 1 || k > kMaxTowers || rows % k != 0 ||
      log_n < kMinLog || log_n > kMaxLog ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
          16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // ops/ntt_small.py launch_geometry: as many groups as the card holds at
  // once, each the same share of its tower's rows
  const long long polys = rows / k;
  const int threads = 1 << (log_n - kLogR);
  const int per_block = kBlockThreads / threads;
  const long long slots = static_cast<long long>(sms) * kBlocksPerSm *
                          per_block;
  const long long per_group = (polys * k + slots - 1) / slots;
  const long long groups = (polys + per_group - 1) / per_group;
  const int gpb = static_cast<int>(groups < per_block ? groups : per_block);
  const dim3 grid(static_cast<unsigned>((groups + gpb - 1) / gpb), k);
  const size_t smem = sizeof(uint32_t) *
                      ((2u << log_n) + gpb * group_words(log_n));
  const Kernel kernel = small_kernel<kInverse>(log_n, Rings());
  kernel<<<grid, gpb * threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tw_sh),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(c),
      static_cast<const uint32_t*>(c_sh), static_cast<int>(polys), k);
  return static_cast<int>(cudaGetLastError());
}

// at most 48 KB (N = 2048: 16 KB of twiddles and one group's 16 KB), so
// no launch raises the dynamic shared-memory limit
static_assert(sizeof(uint32_t) * ((2u << kMaxLog) +
                                  (kBlockThreads >> (kMaxLog - kLogR)) *
                                      group_words(kMaxLog)) <= 48 * 1024,
              "shared memory above the default limit");

}  // namespace

// x, out: [rows, N] words (16-byte aligned, out != x), row r in tower
// r % k; psi / psi_sh: [k, N] bit-reversed twiddles and companions; q:
// [k]. Returns cudaGetLastError() after the launch.
extern "C" int ntt_small_fwd(const void* x, void* out, const void* psi,
                             const void* psi_sh, const void* q, int rows,
                             int k, int log_n, void* stream) {
  return launch<false>(x, out, psi, psi_sh, q, nullptr, nullptr, rows, k,
                       log_n, stream);
}

// The inverse, with ninv / ninv_sh: [k] N^-1 and its companion.
extern "C" int ntt_small_inv(const void* x, void* out, const void* ipsi,
                             const void* ipsi_sh, const void* q,
                             const void* ninv, const void* ninv_sh, int rows,
                             int k, int log_n, void* stream) {
  return launch<true>(x, out, ipsi, ipsi_sh, q, ninv, ninv_sh, rows, k,
                      log_n, stream);
}
