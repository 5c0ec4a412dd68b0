// Small-ring negacyclic NTT (128 <= N <= 2048, k <= 4 towers) for Hopper
// (sm_90a): BinFHE's transforms outside the blind rotation (the test
// vector, the extraction, keygen, the host-scheduled LMKCDEY loop) and
// those of the per-step loop that blind_rotate.cu, which runs a whole
// blind rotation in one launch, is held against.
//
// Replaces the TPU kernel _mat_call of openfhe_tpu/ops/ntt_small.py (body
// _ntt_mat_kernel), which runs each transform as one dense [B, N] x [N, N]
// product of int8 limbs on the MXU. That costs N^2 multiply-adds against
// N log N and exists only for the MXU; Hopper's tensor cores have no
// 32-bit integer product. Here it is the butterfly transform of ntt.cu
// (Cooley-Tukey DIT forward, Gentleman-Sande inverse with N^-1 folded
// into the store, bit-reversed twiddles with Shoup companions), whose
// words equal the dense product's: COEFF natural order <-> EVAL
// bit-reversed order with the basis' own roots.
//
// What bounds it on an H100: device-memory bytes. A GINX step transforms
// B * d2 rows of 4 KB (N = 1024): each row is read once and written once,
// and its 5120 butterflies cost about ten 32-bit operations each, so a
// row's work sits under its bytes at the card's rates.
//
// Design: ntt.cu's tile pass serves one row per block with 1024 threads
// and reads a twiddle from device memory for every butterfly. Here a
// block belongs to one tower (blockIdx.y) and stages that tower's
// twiddles and their companions in shared memory once (8 KB at N = 1024,
// 16 KB at N = 2048); it then walks `per_block` whole rows of that tower,
// each loaded into shared memory with 16-byte coalesced accesses, run
// through all log2 N stages there, and stored once. The stage loops are
// ntt_core.cuh's tile stages over a tile that is the whole row.

#include "ntt_core.cuh"

namespace {

constexpr int kMinLog = 7;           // N >= 128
constexpr int kMaxLog = 11;          // N <= 2048
constexpr int kMaxTowers = 4;
constexpr int kMaxThreads = 512;
// enough blocks for four of them on each of the 132 SMs
constexpr int kTargetBlocks = 4 * 132;

// One block: tower blockIdx.y, rows p * k + tower for p in
// [blockIdx.x * per_block, ... + per_block). Shared memory: twiddles [N],
// companions [N], one row [N]. With `scale` the store multiplies by
// c[tower] (the inverse's N^-1).
template <bool kInverse>
__global__ void ntt_small_kernel(const uint32_t* __restrict__ in,
                                 uint32_t* __restrict__ out,
                                 const uint32_t* __restrict__ tw,
                                 const uint32_t* __restrict__ tw_sh,
                                 const uint32_t* __restrict__ qs,
                                 const uint32_t* __restrict__ c,
                                 const uint32_t* __restrict__ c_sh,
                                 int polys, int k, int log_n, int per_block) {
  extern __shared__ uint32_t smem[];
  const uint32_t n = 1u << log_n;
  uint32_t* w = smem;
  uint32_t* w_sh = smem + n;
  uint32_t* s = smem + 2 * n;
  const int tower = blockIdx.y;
  const size_t tw0 = static_cast<size_t>(tower) << log_n;
  for (uint32_t x = threadIdx.x; x < n; x += blockDim.x) {
    w[x] = tw[tw0 + x];
    w_sh[x] = tw_sh[tw0 + x];
  }
  const uint32_t q = qs[tower];
  uint32_t cv = 0, cv_sh = 0;
  if (kInverse) {
    cv = c[tower];
    cv_sh = c_sh[tower];
  }
  const int p0 = blockIdx.x * per_block;
  const int p1 = min(p0 + per_block, polys);
  const uint32_t vecs = n / 4;
  uint4* s4 = reinterpret_cast<uint4*>(s);
  for (int p = p0; p < p1; ++p) {
    const size_t row = static_cast<size_t>(p) * k + tower;
    const uint4* src = reinterpret_cast<const uint4*>(in + (row << log_n));
    uint4* dst = reinterpret_cast<uint4*>(out + (row << log_n));
    for (uint32_t x = threadIdx.x; x < vecs; x += blockDim.x) s4[x] = src[x];
    __syncthreads();
    if (kInverse) {
      inv_tile_stages(s, w, w_sh, q, log_n, log_n, 0);
      for (uint32_t x = threadIdx.x; x < vecs; x += blockDim.x) {
        uint4 v = s4[x];
        v.x = mul_shoup(v.x, cv, cv_sh, q);
        v.y = mul_shoup(v.y, cv, cv_sh, q);
        v.z = mul_shoup(v.z, cv, cv_sh, q);
        v.w = mul_shoup(v.w, cv, cv_sh, q);
        dst[x] = v;
      }
    } else {
      fwd_tile_stages(s, w, w_sh, q, log_n, log_n, 0);
      for (uint32_t x = threadIdx.x; x < vecs; x += blockDim.x) dst[x] = s4[x];
    }
    __syncthreads();      // the row is stored before the next one loads
  }
}

template <bool kInverse>
int launch(const void* x, void* out, const void* tw, const void* tw_sh,
           const void* q, const void* c, const void* c_sh, int rows, int k,
           int log_n, void* stream) {
  if (rows < 1 || k < 1 || k > kMaxTowers || rows % k != 0 ||
      log_n < kMinLog || log_n > kMaxLog ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
          16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int polys = rows / k;
  const int n = 1 << log_n;
  const int threads = n / 2 < kMaxThreads ? n / 2 : kMaxThreads;
  const int per_tower = (kTargetBlocks + k - 1) / k;
  const int per_block = (polys + per_tower - 1) / per_tower;
  const dim3 grid((polys + per_block - 1) / per_block, k);
  const size_t smem = 3 * static_cast<size_t>(n) * sizeof(uint32_t);
  ntt_small_kernel<kInverse><<<grid, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tw_sh),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(c),
      static_cast<const uint32_t*>(c_sh), polys, k, log_n, per_block);
  return static_cast<int>(cudaGetLastError());
}

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
