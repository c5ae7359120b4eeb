// IVF-BQ fine phase straight from the 1-bit sign codes: for each (query,
// probed list) pair, a scan of the list's bit rows into strided bins, and
// (fused tier) the per-query top-k over every pair's bins.
//
// Replaces: raft_tpu/ops/pallas_ivf_scan.py:_bq_scan_kernel (unfused, kernel
// 10; entry ivf_bq_scan_pallas(fused=False)) and :_fused_bq_scan_kernel
// (fused, kernel 11; with _merge_state, _init_state, _finish_fused), both
// built on _bq_list_candidates. Contract kept, per pair (query q, list l):
//   * qsub = q_rot[q] (IP) or q_rot[q] - centers_rot[l] (L2), in f32;
//     |qsub|^2 and the IP centre term from the unrounded qsub; the estimator
//     product from qsub rounded to bf16 (round to nearest): the TPU feeds a
//     bf16 query and a +-1 bf16 decode tile to the MXU with f32
//     accumulation, and a product of +-1 and a bf16 value is exact, so the
//     two differ only in the f32 summation order;
//   * ip(row) = sum_j s_j * bf16(qsub_j), s_j = +1 where bit j of the row's
//     words is set (the residual's sign >= 0), else -1; bit j lives in word
//     j / 32 at bit j % 32 (int32 words read as unsigned), bits past d
//     ignored;
//   * estimate: L2 = (norms2 + |qsub|^2) - 2 * scale * ip, IP = -(scale * ip),
//     NOT clamped at 0 (the 1-bit estimator overshoots near true neighbours;
//     a negative estimate is a strong candidate); a row with id < 0, or
//     beyond max_list inside the bins-padded length mlp, scores +inf, id -1;
//   * row r goes to bin r % bins; a bin keeps its minimum, ties to the
//     smallest id; an empty bin is (+inf, -1);
//   * unfused (kernel 10): one pair per (list, table slot), the slot's query
//     from qmap (-1 = empty slot, all bins (+inf, -1)), written cap-major as
//     (n_lists, cap, bins); the IP centre term is the caller's;
//   * fused (kernel 11): one pair per (query, probe), the probes of each
//     query sorted by list id with dropped pairs (table slot >= cap) as -1;
//     the IP centre term sum_j qsub_j * centers_rot[l][j] (f32) is
//     subtracted from each bin minimum; then candidate_topk_kernel
//     (candidate_topk.cuh, shared with the PQ scan) keeps per query the k
//     smallest candidates under the key (score, list id, bin): the TPU's
//     list-ascending walk in which the resident state wins ties. Slots no
//     candidate reaches end as (+inf, -1).
//
// Bound on the H100 SXM (data-sheet rates, 700 W): operations. A scored
// (pair, row) costs d sign-flipped adds of the bf16 query against d/8 bytes
// of codes plus 12 B of norm, scale and id: at d = 128 about 5 operations a
// byte read once, so the rows' bytes, read once per batch, are the smaller
// bound only when a list is scored by few pairs. At the served point (10M x
// 128, 1024 lists, 128 probes, a 128-query batch) the clustered queries probe
// most lists many times; chip_smoke.py computes both bounds from the batch.
// This design reads each probed list once per probing query (pair-major),
// mostly from the 50 MB L2, as the PQ scan does.
//
// Design (simple first): bq_pairs_kernel runs one 256-thread block per pair.
// The block puts the pair's bf16-rounded qsub in shared memory (read by every
// thread at the same address: a broadcast) and reduces |qsub|^2 and the
// centre term. Then it scans the list: with bins < 256, 256 / bins threads
// share a bin and combine their partial minima through shared memory;
// neighbouring threads read neighbouring rows' words (16-byte vectors when
// the row holds a multiple of four words). A row's product keeps one f32
// partial sum per 32-bit word, added in word order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "candidate_topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQueryBytes = 160 * 1024;  // the qsub row, dynamic smem

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// sum_s (bit s of wv ? qs[s] : -qs[s]) over the n <= 32 entries of one word
__device__ __forceinline__ float word_ip(const float* qs, uint32_t wv,
                                         int n) {
  float part = 0.f;
  if (n == 32) {
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      const float v = qs[s];
      part += ((wv >> s) & 1u) ? v : -v;
    }
  } else {
    for (int s = 0; s < n; ++s) {
      const float v = qs[s];
      part += ((wv >> s) & 1u) ? v : -v;
    }
  }
  return part;
}

template <bool kVec4>
__device__ __forceinline__ float row_ip(const float* qs,
                                        const uint32_t* __restrict__ wrow,
                                        int words, int d) {
  float acc = 0.f;
  if (kVec4) {
    for (int w0 = 0; w0 < words; w0 += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(wrow + w0);
      const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j0 = (w0 + t) * 32;
        acc += word_ip(qs + j0, wv[t], min(32, d - j0));
      }
    }
  } else {
    for (int wi = 0; wi < words; ++wi)
      acc += word_ip(qs + wi * 32, wrow[wi], min(32, d - wi * 32));
  }
  return acc;
}

template <bool kVec4>
__global__ __launch_bounds__(kThreads) void bq_pairs_kernel(
    const float* __restrict__ q_rot, const float* __restrict__ centers_rot,
    const uint32_t* __restrict__ bits, const float* __restrict__ norms2,
    const float* __restrict__ scales, const int* __restrict__ ids,
    const int* __restrict__ qsel, const int* __restrict__ lsel, int div,
    int d, int words, int max_list, int bins, int mlp, int metric_ip,
    int center_term, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float qs[];  // d
  __shared__ float part_d[kThreads];
  __shared__ int part_i[kThreads];
  __shared__ float red[2][kWarps];

  const int tid = threadIdx.x;
  const size_t pair = blockIdx.x;
  const int q = qsel ? qsel[pair] : static_cast<int>(pair / div);
  const int l = lsel ? lsel[pair] : static_cast<int>(pair / div);
  float* od = out_d + pair * bins;
  int* oi = out_i + pair * bins;
  if (q < 0 || l < 0) {  // empty table slot or dropped pair (block-uniform)
    for (int b = tid; b < bins; b += kThreads) {
      od[b] = CUDART_INF_F;
      oi[b] = -1;
    }
    return;
  }

  // the pair's query row: |qsub|^2 and the IP centre term from the
  // unrounded values, the estimator operand rounded to bf16
  float p_sq = 0.f, p_c = 0.f;
  for (int j = tid; j < d; j += kThreads) {
    const float a = q_rot[static_cast<size_t>(q) * d + j];
    const float c = centers_rot[static_cast<size_t>(l) * d + j];
    const float s = metric_ip ? a : a - c;
    p_sq = fmaf(s, s, p_sq);
    p_c = fmaf(s, c, p_c);
    qs[j] = round_bf16(s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p_sq += __shfl_xor_sync(0xffffffffu, p_sq, o);
    p_c += __shfl_xor_sync(0xffffffffu, p_c, o);
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = p_sq;
    red[1][tid >> 5] = p_c;
  }
  __syncthreads();
  float qq = 0.f, corr = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    qq += red[0][w];
    corr += red[1][w];
  }

  const size_t lbase = static_cast<size_t>(l) * max_list;
  const int n_w = mlp / bins;  // rows per bin
  // strided bins: bin b owns rows b, b + bins, ...; this thread walks the
  // rows w = w0, w0 + wstep, ... of its bin
  auto bin_min = [&](int b, int w0, int wstep, float& bd, int& bi) {
    bd = CUDART_INF_F;
    bi = INT_MAX;
    for (int w = w0; w < n_w; w += wstep) {
      const int r = w * bins + b;
      if (r >= max_list) break;
      const int id = ids[lbase + r];
      if (id < 0) continue;
      const float ip = row_ip<kVec4>(
          qs, bits + (lbase + r) * static_cast<size_t>(words), words, d);
      const float sc = scales[lbase + r];
      const float est =
          metric_ip ? -(sc * ip)
                    : (norms2[lbase + r] + qq) - __fmul_rn(2.0f * sc, ip);
      if (est < bd || (est == bd && id < bi)) {
        bd = est;
        bi = id;
      }
    }
  };
  auto emit = [&](int b, float bd, int bi) {
    if (bi == INT_MAX) bi = -1;
    if (center_term && metric_ip) bd -= corr;  // +inf stays +inf
    od[b] = bd;
    oi[b] = bi;
  };

  if (bins >= kThreads) {
    for (int b = tid; b < bins; b += kThreads) {
      float bd;
      int bi;
      bin_min(b, 0, 1, bd, bi);
      emit(b, bd, bi);
    }
  } else {
    const int g = kThreads / bins;  // threads sharing one bin
    float bd = CUDART_INF_F;
    int bi = INT_MAX;
    if (tid < g * bins) bin_min(tid % bins, tid / bins, g, bd, bi);
    part_d[tid] = bd;
    part_i[tid] = bi;
    __syncthreads();
    if (tid < bins) {
      for (int u = 1; u < g; ++u) {
        const float v = part_d[u * bins + tid];
        const int i = part_i[u * bins + tid];
        if (v < bd || (v == bd && i < bi)) {
          bd = v;
          bi = i;
        }
      }
      emit(tid, bd, bi);
    }
  }
}

template <bool kVec4>
int launch_pairs(int n_pairs, size_t dyn, cudaStream_t s, const float* q_rot,
                 const float* centers_rot, const uint32_t* bits,
                 const float* norms2, const float* scales, const int* ids,
                 const int* qsel, const int* lsel, int div, int d, int words,
                 int max_list, int bins, int mlp, int metric_ip,
                 int center_term, float* out_d, int* out_i) {
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bq_pairs_kernel<kVec4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bq_pairs_kernel<kVec4><<<n_pairs, kThreads, dyn, s>>>(
      q_rot, centers_rot, bits, norms2, scales, ids, qsel, lsel, div, d,
      words, max_list, bins, mlp, metric_ip, center_term, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pair p scores list lsel ? lsel[p] : p / div against query
// qsel ? qsel[p] : p / div (-1 = write (+inf, -1) bins) into
// out_d/out_i[p * bins, (p + 1) * bins). q_rot (nq, d), centers_rot
// (n_lists, d) f32; bits (n_lists, max_list, words) int32 bit patterns,
// words = ceil(d / 32); norms2/scales/ids (n_lists, max_list). vec4 != 0
// requires words % 4 == 0 and 16-byte aligned bits.
extern "C" int raft_ivf_bq_scan(const float* q_rot, const float* centers_rot,
                                const int* bits, const float* norms2,
                                const float* scales, const int* ids,
                                const int* qsel, const int* lsel, int n_pairs,
                                int div, int d, int words, int max_list,
                                int bins, int mlp, int metric_ip,
                                int center_term, int vec4, float* out_d,
                                int* out_i, void* stream) {
  const size_t dyn = static_cast<size_t>(d) * sizeof(float);
  if (bins < 1 || mlp < max_list || mlp % bins != 0 || div < 1 || d < 1 ||
      words != (d + 31) / 32 || dyn > kMaxQueryBytes ||
      (vec4 && words % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(bits);
  if (vec4)
    return launch_pairs<true>(n_pairs, dyn, s, q_rot, centers_rot, w, norms2,
                              scales, ids, qsel, lsel, div, d, words,
                              max_list, bins, mlp, metric_ip, center_term,
                              out_d, out_i);
  return launch_pairs<false>(n_pairs, dyn, s, q_rot, centers_rot, w, norms2,
                             scales, ids, qsel, lsel, div, d, words, max_list,
                             bins, mlp, metric_ip, center_term, out_d, out_i);
}

// cand_d/cand_i (nq, n) -> out_d/out_i (nq, k), k <= 256.
extern "C" int raft_ivf_bq_topk(const float* cand_d, const int* cand_i,
                                int nq, int n, int k, float* out_d,
                                int* out_i, void* stream) {
  return raft_tpu_torch::launch_candidate_topk(
      cand_d, cand_i, nq, n, k, 0, out_d, out_i,
      static_cast<cudaStream_t>(stream));
}
