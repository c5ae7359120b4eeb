// Per-query top-k over candidate rows, shared by ivf_flat_scan.cu (kernel
// 3), ivf_pq_scan.cu (kernel 9), ivf_bq_scan.cu (kernel 11) and
// fused_knn.cu (kernel 5): the second pass of the fused scans, whose first
// pass writes each query's candidates in (list id, bin) order.
//
// Replaces the resident-state merge of the TPU's fused scan kernels
// (raft_tpu/ops/pallas_ivf_scan.py:_merge_state): k rounds of "take the
// minimum, ties to the lowest row of [state; tile]" over lists in ascending
// id. Ranking each query's candidate row by (value, column) gives the same
// k, in the same order, because the columns are in (list id, bin) order.
//
// Design: select_k.cu's tile walk with the rank merge of topk_merge.cuh,
// carrying the candidate ids as payload. Each 1024-wide tile is first
// compacted, in column order, to the entries below the current k-th best
// (a block-wide prefix sum), so once the state holds good candidates a merge
// ranks k + a few entries instead of k + 1024.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk_merge.cuh"

namespace raft_tpu_torch {
namespace {

constexpr int kTopThreads = 256;
constexpr int kTopTile = 1024;
constexpr int kTopMaxK = 256;
constexpr int kTopMaxE = (kTopMaxK + kTopTile + kTopThreads - 1) / kTopThreads;
constexpr int kTopPer = kTopTile / kTopThreads;  // columns per thread
constexpr int kTopWarps = kTopThreads / 32;

// Per query: the k smallest of its n candidates (ties to the lower column),
// carrying the candidate ids; (+inf, -1) where none reaches; sqrt last.
__global__ __launch_bounds__(kTopThreads) void candidate_topk_kernel(
    const float* __restrict__ cand_d, const int* __restrict__ cand_i, int n,
    int k, int do_sqrt, float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float cat_v[kTopMaxK + kTopTile];
  __shared__ int cat_i[kTopMaxK + kTopTile];
  __shared__ float st_v[kTopMaxK];
  __shared__ int st_i[kTopMaxK];
  __shared__ int wsum[kTopWarps];

  const size_t row = blockIdx.x;
  const float* vr = cand_d + row * static_cast<size_t>(n);
  const int* ir = cand_i + row * static_cast<size_t>(n);
  for (int r = threadIdx.x; r < k; r += kTopThreads) {
    st_v[r] = CUDART_INF_F;
    st_i[r] = -1;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < n; c0 += kTopTile) {
    // only entries below the k-th best can enter the state (an equal
    // one ranks after it, a +inf one never fills a slot the final
    // (+inf, -1) would not): keep those, in column order, so their
    // concat positions keep the tie order
    const float kth = st_v[k - 1];
    float xv[kTopPer];
    int xi[kTopPer];
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < kTopPer; ++t) {
      const int j = c0 + threadIdx.x * kTopPer + t;
      float x = CUDART_INF_F;
      int id = -1;
      if (j < n) {
        x = vr[j];
        if (isnan(x)) x = CUDART_INF_F;
        id = ir[j];
      }
      xv[t] = x;
      xi[t] = id;
      cnt += (x < kth);
    }
    int incl = cnt;  // block-wide exclusive scan of the kept counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    for (int r = threadIdx.x; r < k; r += kTopThreads) {
      cat_v[r] = st_v[r];
      cat_i[r] = st_i[r];
    }
    __syncthreads();
    int before = 0, kept = 0;
#pragma unroll
    for (int w = 0; w < kTopWarps; ++w) {
      before += (w < warp) ? wsum[w] : 0;
      kept += wsum[w];
    }
    int pos = k + before + incl - cnt;
#pragma unroll
    for (int t = 0; t < kTopPer; ++t) {
      if (xv[t] < kth) {
        cat_v[pos] = xv[t];
        cat_i[pos] = xi[t];
        ++pos;
      }
    }
    __syncthreads();
    if (kept == 0) continue;  // block-uniform
    merge_ranked<kTopThreads, kTopMaxE>(cat_v, cat_i, k + kept, k, st_v,
                                        st_i);
    __syncthreads();
  }

  for (int r = threadIdx.x; r < k; r += kTopThreads) {
    const float v = st_v[r];
    const int id = (v == CUDART_INF_F) ? -1 : st_i[r];
    out_i[row * k + r] = id;
    out_d[row * k + r] =
        id >= 0 ? (do_sqrt ? sqrtf(fmaxf(v, 0.f)) : v) : CUDART_INF_F;
  }
}

// cand_d/cand_i (nq, n) -> out_d/out_i (nq, k), k <= 256; returns the
// launch's cudaError.
inline int launch_candidate_topk(const float* cand_d, const int* cand_i,
                                 int nq, int n, int k, int do_sqrt,
                                 float* out_d, int* out_i, cudaStream_t s) {
  if (k < 1 || k > kTopMaxK || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  candidate_topk_kernel<<<nq, kTopThreads, 0, s>>>(cand_d, cand_i, n, k,
                                                   do_sqrt, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace raft_tpu_torch
