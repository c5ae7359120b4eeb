// Exact per-row k-selection (k <= 256), smallest first.
//
// Replaces: raft_tpu/ops/pallas_select_k.py:_select_kernel (entry
// select_k_pallas). Contract kept: the k smallest values of each row,
// sorted ascending, ties to the lower column; a slot holding +inf comes back
// with id -1. NaN inputs are read as +inf.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): bytes. The function
// reads the (m, n) matrix once and writes (m, k) values and ids; at the
// coarse-phase shapes, (128, 1024) and (128, 4096), that is 0.2-0.7 us at
// 3.35 TB/s, so the kernel is bound by its latency: a few passes over a
// row that sits in shared memory. The all-pairs rank merge it replaces
// took 0.105-0.426 ms there, 4.7-11.8x torch.topk (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py).
//
// Design: radix select, one 256-thread block per row (the reference's
// topk/radix_topk.cuh applied per row).
//  - Keys: each value maps to an order-preserving uint32; NaN takes the key
//    of +inf and -0.0 that of +0.0 (a stable sort treats the two zeros as
//    equal, so only the column orders them). A row of up to kStageMax
//    values is staged in shared memory as keys; a longer row is re-read
//    from global memory (L2) on every pass.
//  - The k-th key: 8-bit digit passes from the top. Each pass counts the
//    digits of the entries that still match the prefix found so far in
//    per-warp histograms (lanes with the same digit add once, through
//    __match_any_sync: coarse scores crowd into a few top digits), and a
//    block scan of the 256 bins finds the digit holding the k-th entry.
//    When every entry of that digit is needed the passes stop early.
//  - Survivors: every entry whose key prefix is below the k-th's is kept;
//    entries equal to it are kept in column order (a block-wide prefix sum
//    over ballots) until k are held, which reproduces the tie rule.
//  - The k <= 256 survivors are bitonic-sorted in shared memory by
//    (key, column), and values (read back from the row) and ids written.
//    The wrapper's host path is kept short too: at ~10 us of device time a
//    call, a Python launch costs as much as the kernel.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;  // 8-bit digits
constexpr int kMaxK = 256;
constexpr int kStageMax = 16384;  // staged row: 64 KB of keys

__device__ __forceinline__ unsigned key_of(float x) {
  unsigned u = __float_as_uint(x);
  if (isnan(x)) u = 0x7f800000u;     // NaN reads as +inf
  if (u == 0x80000000u) u = 0u;      // -0.0 is +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <bool STAGED>
__global__ __launch_bounds__(kThreads) void radix_select_kernel(
    const float* __restrict__ v, int n, int k, float* __restrict__ out_v,
    int* __restrict__ out_i) {
  extern __shared__ unsigned stage[];
  __shared__ unsigned hist[kWarps][kBins];
  __shared__ unsigned long long surv[kMaxK];
  __shared__ unsigned wsum[kWarps];
  __shared__ unsigned s_digit, s_krem, s_cnt;
  __shared__ int s_nless, s_neq;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* vr = v + row * static_cast<size_t>(n);
  if constexpr (STAGED) {
    for (int j = tid; j < n; j += kThreads) stage[j] = key_of(vr[j]);
  }
  auto key_at = [&](int j) -> unsigned {
    if constexpr (STAGED) return stage[j];
    else return key_of(vr[j]);
  };

  // find the k-th key: after the loop, the entries with (key >> shift) <
  // prefix are all taken and krem more are needed among those equal to it
  unsigned prefix = 0, krem = static_cast<unsigned>(k), cnt = 0;
  int shift = 32;
  while (shift > 0) {
    shift -= 8;
    for (int e = tid; e < kWarps * kBins; e += kThreads)
      (&hist[0][0])[e] = 0u;
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += kThreads) {  // uniform trip count
      const int j = j0 + tid;
      unsigned digit = kBins;  // no bin: out of the row or off the prefix
      if (j < n) {
        const unsigned key = key_at(j);
        if (shift == 24 || (key >> (shift + 8)) == prefix)
          digit = (key >> shift) & (kBins - 1);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit < kBins && lane == __ffs(peers) - 1)
        atomicAdd(&hist[warp][digit], __popc(peers));
    }
    __syncthreads();
    // thread tid owns bin tid: inclusive block scan of the counts
    unsigned c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += hist[w][tid];
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += wsum[w];
    const unsigned excl = incl - c;
    if (excl < krem && krem <= incl) {
      s_digit = tid;
      s_krem = krem - excl;
      s_cnt = c;
    }
    __syncthreads();
    prefix = (prefix << 8) | s_digit;
    krem = s_krem;
    cnt = s_cnt;
    if (cnt == krem) break;  // every entry of this prefix is needed
  }

  // collect the survivors: all below the prefix, then the first krem
  // equal to it in column order
  if (tid == 0) {
    s_nless = 0;
    s_neq = 0;
  }
  if (tid < kMaxK) surv[tid] = ~0ull;  // sorts last
  __syncthreads();
  const int n_less = k - static_cast<int>(krem);
  const bool all_eq = cnt == krem;
  unsigned taken = 0;  // equal entries before this stretch of columns
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + tid;
    unsigned key = 0;
    bool less = false, eq = false;
    if (j < n) {
      key = key_at(j);
      less = (key >> shift) < prefix;
      eq = (key >> shift) == prefix;
    }
    const unsigned long long e =
        (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(j);
    if (less) surv[atomicAdd(&s_nless, 1)] = e;
    if (all_eq) {
      if (eq) surv[n_less + atomicAdd(&s_neq, 1)] = e;
    } else if (taken < krem) {  // uniform: taken is the same everywhere
      const unsigned ballot = __ballot_sync(0xffffffffu, eq);
      if (lane == 0) wsum[warp] = __popc(ballot);
      __syncthreads();
      unsigned before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? wsum[w] : 0u;
        total += wsum[w];
      }
      const unsigned slot =
          taken + before + __popc(ballot & ((1u << lane) - 1u));
      if (eq && slot < krem) surv[n_less + slot] = e;
      taken += total;
      __syncthreads();  // wsum is rewritten by the next stretch
    }
  }
  __syncthreads();

  // bitonic sort of the first sort_n slots (k rounded up to a power of
  // two; the rest hold the ~0 padding) by (key, column)
  int sort_n = 1;
  while (sort_n < k) sort_n <<= 1;
  for (int size = 2; size <= sort_n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int partner = tid ^ stride;
      if (tid < sort_n && partner > tid) {
        const unsigned long long a = surv[tid], b = surv[partner];
        const bool up = (tid & size) == 0;
        if ((a > b) == up) {
          surv[tid] = b;
          surv[partner] = a;
        }
      }
      __syncthreads();
    }
  }

  if (tid < k) {
    const int col = static_cast<int>(surv[tid] & 0xffffffffu);
    float x = vr[col];
    if (isnan(x)) x = CUDART_INF_F;
    out_v[row * k + tid] = x;
    out_i[row * k + tid] = (x == CUDART_INF_F) ? -1 : col;
  }
}

}  // namespace

extern "C" int raft_select_k(const float* v, int m, int n, int k,
                             float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > kMaxK || k > n) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kStageMax) {
    // the staged row may exceed 48 KB: raise the limit once per device
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || !raised[dev]) {
      err = cudaFuncSetAttribute(radix_select_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kStageMax * static_cast<int>(sizeof(unsigned)));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) raised[dev] = true;
    }
    const int smem = n * static_cast<int>(sizeof(unsigned));
    radix_select_kernel<true><<<m, kThreads, smem, s>>>(v, n, k, out_v, out_i);
  } else {
    radix_select_kernel<false><<<m, kThreads, 0, s>>>(v, n, k, out_v, out_i);
  }
  return static_cast<int>(cudaGetLastError());
}
