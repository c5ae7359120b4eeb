// Block-wide exact top-k merge shared by select_k.cu and ivf_flat_scan.cu.
//
// The TPU kernels (raft_tpu/ops/pallas_select_k.py:_select_kernel and
// raft_tpu/ops/pallas_ivf_scan.py:_merge_state) keep a sorted k-state and
// merge each tile of candidates with k rounds of "take the minimum value,
// ties to the lowest row of the concatenation [state; tile]". The result of
// those rounds is fully determined by the key (value, concat position): the
// merged state is the k smallest concat entries under that key, in key
// order. This header computes the same thing without rounds: every entry's
// rank is the number of entries with a smaller key, and an entry whose rank
// is below k is written to slot `rank`. Keys are distinct (positions are), so
// the k slots are filled exactly once each. NaN has no order; callers map it
// to +inf before it gets here.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace raft_tpu_torch {

// Merge the concatenation cat_v/cat_i[0, total) — state first, in slots
// [0, k), then the candidates — into st_v/st_i[0, k). All THREADS threads of
// the block must call it; MAXE * THREADS must be >= total. The caller
// synchronises before (cat written) and after (st read).
template <int THREADS, int MAXE>
__device__ __forceinline__ void merge_ranked(const float* cat_v,
                                             const int* cat_i, int total,
                                             int k, float* st_v, int* st_i) {
  float mine[MAXE];
  int rank[MAXE];
#pragma unroll
  for (int j = 0; j < MAXE; ++j) {
    const int e = threadIdx.x + j * THREADS;
    mine[j] = e < total ? cat_v[e] : CUDART_INF_F;
    rank[j] = 0;
  }
  for (int e2 = 0; e2 < total; ++e2) {
    const float v2 = cat_v[e2];  // same address across the block: broadcast
#pragma unroll
    for (int j = 0; j < MAXE; ++j) {
      const int e = threadIdx.x + j * THREADS;
      rank[j] += (v2 < mine[j]) || (v2 == mine[j] && e2 < e);
    }
  }
#pragma unroll
  for (int j = 0; j < MAXE; ++j) {
    const int e = threadIdx.x + j * THREADS;
    if (e < total && rank[j] < k) {
      st_v[rank[j]] = mine[j];
      st_i[rank[j]] = cat_i[e];
    }
  }
}

}  // namespace raft_tpu_torch
