// IVF-Flat fine phase with the per-query top-k kept on chip: scan every
// probed list, bin its rows, merge the bins into a sorted k-state.
//
// Replaces: raft_tpu/ops/pallas_ivf_scan.py:_fused_list_scan_kernel (with
// _flat_list_candidates, _merge_state, _init_state, _finish_fused; entry
// ivf_list_scan_pallas(fused=True)). Contract kept, per query:
//   * score of list row r: L2 = max((norm_r + |q|^2) - 2 q.x_r, 0), or
//     IP = -(q.x_r) (not clamped); pad rows (id < 0, or r >= max_list inside
//     the bins-padded length) score +inf with id -1;
//   * row r of a list goes to the strided bin r % bins; a bin's candidate is
//     its minimum, ties to the smallest id;
//   * lists merge in ascending list id, bins in ascending order, and on an
//     equal score the resident state beats a newcomer: the result is the k
//     smallest candidates under the key (score, list id, bin index);
//   * a (query, probe) pair whose slot in the list's inverted table is >= cap
//     is skipped (the caller passes it as -1), the TPU kernel's drop rule when
//     a cached cap overflows;
//   * a slot no candidate reached ends as (+inf, -1); sqrt is applied last.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): bytes. The function needs
// each probed list read once per batch: ~5.1 GB, ~1.5 ms at 3.35 TB/s at
// the served point (10M x 128, 1024 lists, 96 probes, 128 queries). This
// query-major kernel reads each probed list once per probing query, about
// nq*n_probes/n_lists = 12x more on uniform queries; on the benchmark's
// clustered queries 21.7x (214.6M rows, 110 GB: the queries crowd into the
// 606 biggest lists). Measured 76.9 ms per 128-query batch, 1.43 TB/s
// effective (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py). Redesigning
// for list-major reuse is later work.
//
// Design (simple first): one block of 512 threads per query. The query sits
// in shared memory. For each probed list and each chunk of up to 512 bins,
// each thread owns one bin's running (min, id) in registers; the block
// scores up to 2048 rows per step (warp-cooperative dot products, 8 rows in
// flight per warp, lanes split the dimension, coalesced reads), parks the
// scores in shared memory, and the bin owners fold them in. The chunk's
// candidates then merge into the sorted k-state with merge_ranked
// (topk_merge.cuh), skipped when none beats the k-th best.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 256;
constexpr int kStepRows = 2048;
constexpr int kILP = 8;
constexpr int kMaxE = (kMaxK + kThreads + kThreads - 1) / kThreads;

template <bool kVec4>
__global__ __launch_bounds__(kThreads) void ivf_flat_scan_kernel(
    const float* __restrict__ queries, const int* __restrict__ probes,
    int n_probes, const float* __restrict__ data,
    const float* __restrict__ norms, const int* __restrict__ ids,
    int max_list, int d, int bins, int mlp, int k, int metric_ip,
    int do_sqrt, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float q_s[];  // d floats
  __shared__ float dt[kStepRows];
  __shared__ int di[kStepRows];
  __shared__ float cat_v[kMaxK + kThreads];
  __shared__ int cat_i[kMaxK + kThreads];
  __shared__ float st_v[kMaxK];
  __shared__ int st_i[kMaxK];
  __shared__ float red[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t qi = blockIdx.x;

  float part = 0.f;
  for (int j = tid; j < d; j += kThreads) {
    const float a = queries[qi * d + j];
    q_s[j] = a;
    part = fmaf(a, a, part);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) red[warp] = part;
  for (int r = tid; r < k; r += kThreads) {
    st_v[r] = CUDART_INF_F;
    st_i[r] = -1;
  }
  __syncthreads();
  float qq = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) qq += red[w];

  const int bc_max = min(bins, kThreads);
  const int n_w = mlp / bins;                       // rows per bin
  const int group = max(1, kStepRows / bc_max);     // bin-rows per step

  for (int p = 0; p < n_probes; ++p) {
    const int l = probes[qi * n_probes + p];
    if (l < 0) continue;  // dropped pair (uniform across the block)
    const size_t lbase = static_cast<size_t>(l) * max_list;
    for (int b0 = 0; b0 < bins; b0 += bc_max) {
      const int bc = min(bc_max, bins - b0);
      float bd = CUDART_INF_F;
      int bi = INT_MAX;
      for (int w0 = 0; w0 < n_w; w0 += group) {
        const int rows = min(group, n_w - w0) * bc;
        for (int s0 = warp * kILP; s0 < rows; s0 += kWarps * kILP) {
          float acc[kILP];
          int rid[kILP];
          size_t roff[kILP];
#pragma unroll
          for (int t = 0; t < kILP; ++t) {
            acc[t] = 0.f;
            rid[t] = -1;
            roff[t] = 0;
            const int s = s0 + t;
            if (s < rows) {
              const int r = (w0 + s / bc) * bins + b0 + s % bc;
              if (r < max_list) {
                const int id = ids[lbase + r];
                if (id >= 0) {
                  rid[t] = id;
                  roff[t] = (lbase + r) * static_cast<size_t>(d);
                }
              }
            }
          }
          if (kVec4) {
            for (int j = lane * 4; j < d; j += 128) {
              const float4 qv = *reinterpret_cast<const float4*>(&q_s[j]);
#pragma unroll
              for (int t = 0; t < kILP; ++t) {
                if (rid[t] >= 0) {
                  const float4 xv =
                      *reinterpret_cast<const float4*>(&data[roff[t] + j]);
                  acc[t] = fmaf(qv.x, xv.x, acc[t]);
                  acc[t] = fmaf(qv.y, xv.y, acc[t]);
                  acc[t] = fmaf(qv.z, xv.z, acc[t]);
                  acc[t] = fmaf(qv.w, xv.w, acc[t]);
                }
              }
            }
          } else {
            for (int j = lane; j < d; j += 32) {
              const float qv = q_s[j];
#pragma unroll
              for (int t = 0; t < kILP; ++t)
                if (rid[t] >= 0) acc[t] = fmaf(qv, data[roff[t] + j], acc[t]);
            }
          }
#pragma unroll
          for (int t = 0; t < kILP; ++t) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
          }
#pragma unroll
          for (int t = 0; t < kILP; ++t) {
            const int s = s0 + t;
            if (lane == t && s < rows) {
              float dist = CUDART_INF_F;
              if (rid[t] >= 0) {
                if (metric_ip) {
                  dist = -acc[t];
                } else {
                  const float nr = norms[roff[t] / d];
                  dist = fmaxf((nr + qq) - 2.0f * acc[t], 0.f);
                }
              }
              dt[s] = dist;
              di[s] = rid[t];
            }
          }
        }
        __syncthreads();
        if (tid < bc) {
          for (int s = tid; s < rows; s += bc) {
            const float v = dt[s];
            const int i = di[s];
            if (v < bd || (v == bd && i < bi)) {
              bd = v;
              bi = i;
            }
          }
        }
        __syncthreads();
      }
      // merge this chunk's bin candidates, in bin order, after the state
      const float kth = st_v[k - 1];
      if (tid < bc) {
        cat_v[k + tid] = bd;
        cat_i[k + tid] = bi;
      }
      for (int r = tid; r < k; r += kThreads) {
        cat_v[r] = st_v[r];
        cat_i[r] = st_i[r];
      }
      if (__syncthreads_or(tid < bc && bd < kth)) {
        raft_tpu_torch::merge_ranked<kThreads, kMaxE>(cat_v, cat_i, k + bc,
                                                      k, st_v, st_i);
        __syncthreads();
      }
    }
  }

  for (int r = tid; r < k; r += kThreads) {
    const int id = st_i[r];
    const float v = st_v[r];
    out_i[qi * k + r] = id;
    out_d[qi * k + r] =
        id >= 0 ? (do_sqrt ? sqrtf(fmaxf(v, 0.f)) : v) : CUDART_INF_F;
  }
}

template <bool kVec4>
int launch(const float* queries, int nq, int d, const int* probes,
           int n_probes, const float* data, const float* norms,
           const int* ids, int max_list, int bins, int mlp, int k,
           int metric_ip, int do_sqrt, float* out_d, int* out_i,
           cudaStream_t s) {
  const size_t dyn = static_cast<size_t>(d) * sizeof(float);
  if (dyn > 16 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ivf_flat_scan_kernel<kVec4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ivf_flat_scan_kernel<kVec4><<<nq, kThreads, dyn, s>>>(
      queries, probes, n_probes, data, norms, ids, max_list, d, bins, mlp, k,
      metric_ip, do_sqrt, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// probes: (nq, n_probes) list ids, each row ascending, -1 = skip the pair.
// data (n_lists, max_list, d), norms/ids (n_lists, max_list); bins divides
// mlp >= max_list. vec4 != 0 requires d % 4 == 0 and 16-byte aligned
// queries and data.
extern "C" int raft_ivf_flat_scan(const float* queries, int nq, int d,
                                  const int* probes, int n_probes,
                                  const float* data, const float* norms,
                                  const int* ids, int max_list, int bins,
                                  int mlp, int k, int metric_ip, int do_sqrt,
                                  int vec4, float* out_d, int* out_i,
                                  void* stream) {
  if (k < 1 || k > kMaxK || bins < 1 || mlp < max_list || mlp % bins != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    return launch<true>(queries, nq, d, probes, n_probes, data, norms, ids,
                        max_list, bins, mlp, k, metric_ip, do_sqrt, out_d,
                        out_i, s);
  return launch<false>(queries, nq, d, probes, n_probes, data, norms, ids,
                       max_list, bins, mlp, k, metric_ip, do_sqrt, out_d,
                       out_i, s);
}
