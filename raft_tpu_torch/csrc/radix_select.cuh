// Exact per-row k-selection (k <= 256), smallest first, shared by
// select_k.cu (kernel 2: the coarse phase's probes) and, carrying ids as
// payload, by the fused scans as their pass B: list_scan_tc.cuh (kernels 3
// and 11), ivf_pq_scan.cu (kernel 9) and fused_knn.cu (kernels 5 and 6).
//
// Replaces: raft_tpu/ops/pallas_select_k.py:_select_kernel (kernel 2) and
// the resident-state merge of the TPU's fused scan kernels
// (raft_tpu/ops/pallas_ivf_scan.py:_merge_state, pallas_fused_knn.py's
// k rounds of extract-min). Contract kept: the k smallest values of each
// row, ascending, ties to the lower column; NaN reads as +inf; a slot
// holding +inf comes back with id -1. A pass A writes each query's
// candidates in (list id, bin) order (IVF) or row order (brute force), so
// ranking the row by (value, column) is the TPU's walk in which the
// resident state wins ties. Payload mode: the id written is cand_i[col],
// not col; a row of n < k entries fills the rest with (+inf, -1); sqrt is
// applied last.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): bytes. The row is read
// once and k values and ids written: at the coarse shapes (128, 1024-4096)
// 0.2-0.7 us, at the fused scans' (128, 16384) 8.4 us, at the fused brute
// force's (1000, 156250) 0.19 ms. Staged rows (n <= kRsStageMax) are read
// from device memory once; longer rows twice by the filter. Without the
// filter a long row was re-read by every digit pass (2-4 at these shapes)
// and the survivors' pass: 2.16 ms at (1000, 156250), k = 32, against
// torch.topk's 1.98 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py).
//
// Design: radix select, one 256-thread block per row (the reference's
// topk/radix_topk.cuh applied per row).
//  - Keys: each value maps to an order-preserving uint32; NaN takes the key
//    of +inf and -0.0 that of +0.0 (a stable sort treats the two zeros as
//    equal, so only the column orders them). A row of up to kRsStageMax
//    values is staged in shared memory as keys. A longer row is first
//    filtered (rs_filter: two reads of the row, no digit pass) and takes
//    the digit passes below only when ties crowd the filter.
//  - The k-th key: 8-bit digit passes from the top. Each pass counts the
//    digits of the entries that still match the prefix found so far in
//    per-warp histograms (lanes with the same digit add once, through
//    __match_any_sync: scores crowd into a few top digits), and a block
//    scan of the 256 bins finds the digit holding the k-th entry. When
//    every entry of that digit is needed the passes stop early; a row of
//    n <= k entries needs no pass.
//  - Survivors: every entry whose key prefix is below the k-th's is kept;
//    entries equal to it are kept in column order (a block-wide prefix sum
//    over ballots) until k are held, which reproduces the tie rule.
//  - The k <= 256 survivors are bitonic-sorted in shared memory by
//    (key, column); values (read back from the row) and ids written.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace raft_tpu_torch {
namespace {

constexpr int kRsThreads = 256;
constexpr int kRsWarps = kRsThreads / 32;
constexpr int kRsBins = 256;           // 8-bit digits
constexpr int kRsMaxK = 256;
constexpr int kRsStageMax = 16384;     // staged row: 64 KB of keys
constexpr int kRsFilterMax = 4096;     // a long row's filtered entries

__device__ __forceinline__ unsigned rs_key(float x) {
  unsigned u = __float_as_uint(x);
  if (isnan(x)) u = 0x7f800000u;     // NaN reads as +inf
  if (u == 0x80000000u) u = 0u;      // -0.0 is +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Ascending bitonic sort of a[0, n), n a power of two, by the whole 64-bit
// word ((key, column) entries); every thread of the block calls it.
__device__ __forceinline__ void rs_bitonic(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n; i += kRsThreads) {
        const int partner = i ^ stride;
        if (partner > i) {
          const unsigned long long x = a[i], y = a[partner];
          if ((x > y) == ((i & size) == 0)) {
            a[i] = y;
            a[partner] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// A long row's k smallest by a filter, two reads of the row: thread t's
// minimum over the columns t, t + 256, ...; the k-th smallest of the 256
// minima, tau, has at least k entries at or below it, so the k smallest
// are among the entries with key <= tau, gathered (as (key, column)) into
// cand and sorted. Into surv[0, k) when they are at most kRsFilterMax
// (true), else nothing (false: many ties at tau; the digit passes
// follow). Block-uniform result.
__device__ __forceinline__ bool rs_filter(const float* __restrict__ vr,
                                          int n, int k,
                                          unsigned long long* surv,
                                          unsigned long long* cand,
                                          int* count) {
  const int tid = threadIdx.x;
  unsigned mk = 0xffffffffu;
  for (int j = tid; j < n; j += kRsThreads) mk = min(mk, rs_key(vr[j]));
  surv[tid] = (static_cast<unsigned long long>(mk) << 32) | tid;
  if (tid == 0) *count = 0;
  __syncthreads();
  rs_bitonic(surv, kRsThreads);
  const unsigned tau = static_cast<unsigned>(surv[k - 1] >> 32);
  for (int j = tid; j < n; j += kRsThreads) {
    const unsigned key = rs_key(vr[j]);
    if (key <= tau) {
      const int at = atomicAdd(count, 1);
      if (at < kRsFilterMax)
        cand[at] = (static_cast<unsigned long long>(key) << 32) |
                   static_cast<unsigned>(j);
    }
  }
  __syncthreads();
  const int total = *count;
  if (total > kRsFilterMax) return false;
  int sort_n = 1;
  while (sort_n < total) sort_n <<= 1;
  for (int i = total + tid; i < sort_n; i += kRsThreads) cand[i] = ~0ull;
  __syncthreads();
  rs_bitonic(cand, sort_n);
  surv[tid] = tid < k ? cand[tid] : ~0ull;  // total >= k
  __syncthreads();
  return true;
}

// Row blockIdx.x of v (m, n): its k smallest into out_v/out_i (m, k).
// ids == nullptr: the ids written are the columns (kernel 2, n >= k);
// otherwise ids[row * n + col] (-1 at +inf), sqrt last when do_sqrt.
template <bool STAGED>
__global__ __launch_bounds__(kRsThreads) void radix_select_kernel(
    const float* __restrict__ v, const int* __restrict__ ids, int n, int k,
    int do_sqrt, float* __restrict__ out_v, int* __restrict__ out_i) {
  // STAGED: the row's keys; else the filter's entries (kRsFilterMax)
  extern __shared__ unsigned stage[];
  __shared__ unsigned hist[kRsWarps][kRsBins];
  __shared__ unsigned long long surv[kRsMaxK];
  __shared__ unsigned wsum[kRsWarps];
  __shared__ unsigned s_digit, s_krem, s_cnt;
  __shared__ int s_nless, s_neq, s_count;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* vr = v + row * static_cast<size_t>(n);
  if constexpr (STAGED) {
    for (int j = tid; j < n; j += kRsThreads) stage[j] = rs_key(vr[j]);
  }
  auto key_at = [&](int j) -> unsigned {
    if constexpr (STAGED) return stage[j];
    else return rs_key(vr[j]);
  };

  bool filtered = false;
  if constexpr (!STAGED) {
    filtered = rs_filter(vr, n, k, surv,
                         reinterpret_cast<unsigned long long*>(stage),
                         &s_count);
  }

  // find the k-th key: after the loop, the entries with (key >> shift) <
  // prefix are all taken and krem more are needed among those equal to it.
  // n <= k: every entry is taken (no key reaches the prefix ~0).
  unsigned prefix = 0, krem = static_cast<unsigned>(k), cnt = 0;
  int shift = 32;
  if (filtered) {
    shift = 0;  // no pass; surv holds the k best
  } else if (n <= k) {
    prefix = 0xffffffffu;
    shift = 0;
    krem = static_cast<unsigned>(k - n);
    cnt = krem;
  }
  while (shift > 0) {
    shift -= 8;
    for (int e = tid; e < kRsWarps * kRsBins; e += kRsThreads)
      (&hist[0][0])[e] = 0u;
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += kRsThreads) {  // uniform trip count
      const int j = j0 + tid;
      unsigned digit = kRsBins;  // no bin: out of the row or off the prefix
      if (j < n) {
        const unsigned key = key_at(j);
        if (shift == 24 || (key >> (shift + 8)) == prefix)
          digit = (key >> shift) & (kRsBins - 1);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit < kRsBins && lane == __ffs(peers) - 1)
        atomicAdd(&hist[warp][digit], __popc(peers));
    }
    __syncthreads();
    // thread tid owns bin tid: inclusive block scan of the counts
    unsigned c = 0;
#pragma unroll
    for (int w = 0; w < kRsWarps; ++w) c += hist[w][tid];
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
  // equal to it in column order; sort them
  if (!filtered) {
    if (tid == 0) {
      s_nless = 0;
      s_neq = 0;
    }
    if (tid < kRsMaxK) surv[tid] = ~0ull;  // sorts last; never a real entry
    __syncthreads();
    const int n_less = k - static_cast<int>(krem);
    const bool all_eq = cnt == krem;
    unsigned taken = 0;  // equal entries before this stretch of columns
    for (int j0 = 0; j0 < n; j0 += kRsThreads) {
      const int j = j0 + tid;
      unsigned key = 0;
      bool less = false, eq = false;
      if (j < n) {
        key = key_at(j);
        less = (key >> shift) < prefix;
        eq = (key >> shift) == prefix;
      }
      const unsigned long long e =
          (static_cast<unsigned long long>(key) << 32) |
          static_cast<unsigned>(j);
      if (less) surv[atomicAdd(&s_nless, 1)] = e;
      if (all_eq) {
        if (eq) surv[n_less + atomicAdd(&s_neq, 1)] = e;
      } else if (taken < krem) {  // uniform: taken is the same everywhere
        const unsigned ballot = __ballot_sync(0xffffffffu, eq);
        if (lane == 0) wsum[warp] = __popc(ballot);
        __syncthreads();
        unsigned before = 0, total = 0;
  #pragma unroll
        for (int w = 0; w < kRsWarps; ++w) {
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
    rs_bitonic(surv, sort_n);
  }

  if (tid < k) {
    const unsigned long long e = surv[tid];
    float x = CUDART_INF_F;
    int id = -1;
    if (e != ~0ull) {  // a slot past n (n < k) stays (+inf, -1)
      const int col = static_cast<int>(e & 0xffffffffu);
      x = vr[col];
      if (isnan(x)) x = CUDART_INF_F;
      if (x != CUDART_INF_F) id = ids ? ids[row * n + col] : col;
    }
    if (ids) {
      if (id < 0) x = CUDART_INF_F;
      else if (do_sqrt) x = sqrtf(fmaxf(x, 0.f));
    }
    out_v[row * k + tid] = x;
    out_i[row * k + tid] = id;
  }
}

// The k smallest of each row of v (m, n) into out_v/out_i (m, k), k <= 256;
// ids (m, n) as payload or nullptr (then n >= k and the ids are the
// columns); returns the launch's cudaError.
inline int launch_radix_select(const float* v, const int* ids, int m, int n,
                               int k, int do_sqrt, float* out_v, int* out_i,
                               cudaStream_t s) {
  if (k < 1 || k > kRsMaxK || n < 0 || (ids == nullptr && k > n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  if (n <= kRsStageMax) {
    // the staged row may exceed 48 KB: raise the limit once per device
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || !raised[dev]) {
      err = cudaFuncSetAttribute(
          radix_select_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          kRsStageMax * static_cast<int>(sizeof(unsigned)));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) raised[dev] = true;
    }
    const int smem = n * static_cast<int>(sizeof(unsigned));
    radix_select_kernel<true><<<m, kRsThreads, smem, s>>>(v, ids, n, k,
                                                          do_sqrt, out_v,
                                                          out_i);
  } else {
    radix_select_kernel<false>
        <<<m, kRsThreads, kRsFilterMax * sizeof(unsigned long long), s>>>(
            v, ids, n, k, do_sqrt, out_v, out_i);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace raft_tpu_torch
