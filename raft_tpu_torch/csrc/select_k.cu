// Exact per-row k-selection (k <= 256), smallest first.
//
// Replaces: raft_tpu/ops/pallas_select_k.py:_select_kernel (entry
// select_k_pallas). Contract kept: the k smallest values of each row,
// sorted ascending, ties to the lower column; a slot holding +inf comes back
// with id -1 (the state starts as (+inf, -1) and a +inf input never beats
// it). NaN inputs are read as +inf.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): bytes. The function
// reads the (m, n) matrix once and writes (m, k) values and ids; at the
// coarse-phase shape (128, 1024), k=96 that is ~0.6 MB, under a microsecond
// at 3.35 TB/s, so in practice the kernel is bound by its own instruction
// count: the rank merge costs (k + 1024)^2 compares per row. Measured
// 0.106 ms there, torch.topk 0.023 ms (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_smoke.py).
//
// Design: one block per row keeps the sorted k-state in shared memory and
// walks the row in tiles of 1024 columns. A tile that holds no value below
// the current k-th best is skipped (the TPU kernel's filtered merge; it
// cannot change the result). Otherwise the tile is merged with
// merge_ranked (topk_merge.cuh): each entry's rank under the key
// (value, position in [state; tile]) is counted directly, which reproduces
// the TPU kernel's "k rounds of (min value, then min position)" tie order by
// construction, with no data-dependent control flow.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int kMaxK = 256;
constexpr int kMaxE = (kMaxK + kTile + kThreads - 1) / kThreads;

__global__ __launch_bounds__(kThreads) void select_k_kernel(
    const float* __restrict__ v, int n, int k, float* __restrict__ out_v,
    int* __restrict__ out_i) {
  __shared__ float cat_v[kMaxK + kTile];
  __shared__ int cat_i[kMaxK + kTile];
  __shared__ float st_v[kMaxK];
  __shared__ int st_i[kMaxK];

  const size_t row = blockIdx.x;
  const float* vr = v + row * static_cast<size_t>(n);
  for (int r = threadIdx.x; r < k; r += kThreads) {
    st_v[r] = CUDART_INF_F;
    st_i[r] = -1;
  }
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += kTile) {
    const int cnt = min(kTile, n - c0);
    const float kth = st_v[k - 1];
    int improves = 0;
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      float x = vr[c0 + j];
      if (isnan(x)) x = CUDART_INF_F;
      cat_v[k + j] = x;
      cat_i[k + j] = c0 + j;
      improves |= (x < kth);
    }
    for (int r = threadIdx.x; r < k; r += kThreads) {
      cat_v[r] = st_v[r];
      cat_i[r] = st_i[r];
    }
    // one barrier: publishes cat and agrees on the skip decision
    if (!__syncthreads_or(improves)) continue;
    raft_tpu_torch::merge_ranked<kThreads, kMaxE>(cat_v, cat_i, k + cnt, k,
                                                  st_v, st_i);
    __syncthreads();
  }

  for (int r = threadIdx.x; r < k; r += kThreads) {
    const float x = st_v[r];
    out_v[row * k + r] = x;
    out_i[row * k + r] = (x == CUDART_INF_F) ? -1 : st_i[r];
  }
}

}  // namespace

extern "C" int raft_select_k(const float* v, int m, int n, int k,
                             float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > kMaxK || k > n) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  select_k_kernel<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, n, k, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}
