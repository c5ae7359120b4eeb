// IVF-PQ fine phase straight from the u8 codes: for each (query, probed list)
// pair, a table of subspace inner products in shared memory, a scan of the
// list's codes into strided bins, and (fused tier) the per-query top-k over
// every pair's bins.
//
// Replaces: raft_tpu/ops/pallas_ivf_scan.py:_pq_scan_kernel (unfused; entry
// ivf_pq_code_scan_pallas(fused=False)) and :_fused_pq_scan_kernel (fused;
// with _merge_state, _init_state, _finish_fused), both built on
// _pq_cell_candidates. Contract kept, per pair (query q, list l):
//   * qsub = q_rot[q] (IP) or q_rot[q] - centers_rot[l] (L2), in f32;
//   * ip(row) = sum_s sum_j op(qsub[s*pq_len + j]) * op(book[c_s][j]), f32
//     accumulation, with book = books[s] (per subspace) or books[l] (per
//     cluster) and c_s the row's u8 code of subspace s. op is the LUT tier:
//     the wrapper passes the books already rounded (bf16, or fp8 e4m3 widened
//     exactly), and round_q rounds the query to bf16 here (bf16 and fp8
//     tiers). The TPU decodes with a one-hot x codebook matmul; here the same
//     sum is regrouped as LUT[s][c] = sum_j op(qsub_s,j) * op(book[c][j]) and
//     the row's score is sum_s LUT[s][c_s] (the reference's shared-memory LUT,
//     ivf_pq_search.cuh:593), so the two differ only in f32 summation order;
//   * score: L2 = max((|qsub|^2 + code_norm) - 2 ip, 0) with |qsub|^2 from
//     the unrounded qsub; IP = -ip; a row with id < 0, or beyond max_list
//     inside the bins-padded length mlp, scores +inf with id -1;
//   * row r goes to bin r % bins; a bin keeps its minimum, ties to the
//     smallest id; an empty bin is (+inf, -1);
//   * unfused (kernel 8): one pair per (list, table slot), the slot's query
//     from qmap (-1 = empty slot, all bins (+inf, -1)); scores optionally
//     rounded to bf16 (internal_distance_dtype); the IP centre term is the
//     caller's;
//   * fused (kernel 9): one pair per (query, probe), the probes of each query
//     sorted by list id with dropped pairs (table slot >= cap) as -1; the IP
//     centre term sum_j qsub_j * centers_rot[l][j] (f32) is subtracted from
//     each bin minimum; then candidate_topk_kernel keeps per query the k
//     smallest candidates under the key (score, list id, bin): the TPU's
//     list-ascending walk in which the resident state wins ties. Slots no
//     candidate reaches end as (+inf, -1); sqrt is applied last.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): bytes and operations about
// equally. At the served point (10M x 128, 4096 lists, pq_dim 32 x 8 bits,
// 128 probes, a 128-query batch) the batch needs its 6.8M probed rows' codes,
// norms and ids once (40 B a row, 0.081 ms at 3.35 TB/s), and 1.1 GFLOP of
// table builds plus 4.4G row-sum adds (0.082 ms at the fp32 rate).
// This design reads each probed list once per probing query (pair-major):
// at the served point's clustered queries 138.7M (pair, row) scores against
// 6.8M rows once, 20x, mostly from the 50 MB L2. Measured per 128-query
// batch (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): fused 3.32 ms
// (pq_pairs_kernel ~2.3 ms + the top-k pass ~0.6 ms) against a 0.082 ms
// bound; unfused (kk = 512) 2.57 ms against 0.162 ms.
//
// Design (simple first): pq_pairs_kernel runs one 256-thread block per pair,
// so even a 1-row batch has n_probes blocks to spread over the 132 SMs. The
// block builds the (pq_dim, n_codes) f32 table in dynamic shared memory
// (32 KB at the served point, so several blocks share an SM), then scans the
// list: with bins < 256, 256 / bins threads share a bin and combine their
// partial minima through shared memory; each thread reads a row's pq_dim codes
// as 16-byte vectors (pq_dim % 16 == 0), neighbouring threads on
// neighbouring rows. candidate_topk_kernel (candidate_topk.cuh, shared with
// the IVF-BQ scan) is the per-query merge; its tie order by concat position
// is the key above because each query's candidates lie in (list id, bin)
// order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "candidate_topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLutBytes = 160 * 1024;  // table + query row, dynamic smem


__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kVec16>
__device__ __forceinline__ float row_ip(const float* lut,
                                        const uint8_t* __restrict__ crow,
                                        int pq_dim, int n_codes) {
  float acc = 0.f;
  if (kVec16) {
    for (int s0 = 0; s0 < pq_dim; s0 += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(crow + s0);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int c = (w[t >> 2] >> ((t & 3) * 8)) & 0xFF;
        acc += lut[(s0 + t) * n_codes + c];
      }
    }
  } else {
    for (int s = 0; s < pq_dim; ++s) acc += lut[s * n_codes + crow[s]];
  }
  return acc;
}

template <bool kVec16>
__global__ __launch_bounds__(kThreads) void pq_pairs_kernel(
    const float* __restrict__ q_rot, const float* __restrict__ centers_rot,
    const float* __restrict__ books, const uint8_t* __restrict__ codes,
    const float* __restrict__ norms, const int* __restrict__ ids,
    const int* __restrict__ qsel, const int* __restrict__ lsel, int div,
    int rot_dim, int pq_dim, int pq_len, int n_codes, int max_list, int bins,
    int mlp, int metric_ip, int per_cluster, int round_q, int center_term,
    int round_out, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* lut = smem;                        // pq_dim * n_codes
  float* qs = smem + pq_dim * n_codes;      // rot_dim
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
  // unrounded values, the table operand rounded as the tier says
  float p_sq = 0.f, p_c = 0.f;
  for (int j = tid; j < rot_dim; j += kThreads) {
    const float a = q_rot[static_cast<size_t>(q) * rot_dim + j];
    const float c = centers_rot[static_cast<size_t>(l) * rot_dim + j];
    const float s = metric_ip ? a : a - c;
    p_sq = fmaf(s, s, p_sq);
    p_c = fmaf(s, c, p_c);
    qs[j] = round_q ? round_bf16(s) : s;
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
  float rr = 0.f, corr = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    rr += red[0][w];
    corr += red[1][w];
  }

  // LUT[s][c] = sum_j op(qsub[s*pq_len + j]) * op(book[c][j])
  const int n_lut = pq_dim * n_codes;
  for (int e = tid; e < n_lut; e += kThreads) {
    const int s = e / n_codes;
    const int c = e - s * n_codes;
    const float* bk = books + (static_cast<size_t>(per_cluster ? l : s) *
                                   n_codes + c) * pq_len;
    const float* qv = qs + s * pq_len;
    float acc = 0.f;
    for (int j = 0; j < pq_len; ++j) acc = fmaf(qv[j], bk[j], acc);
    lut[e] = acc;
  }
  __syncthreads();

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
      const float ip = row_ip<kVec16>(
          lut, codes + (lbase + r) * static_cast<size_t>(pq_dim), pq_dim,
          n_codes);
      const float dist =
          metric_ip ? -ip : fmaxf((rr + norms[lbase + r]) - 2.0f * ip, 0.f);
      if (dist < bd || (dist == bd && id < bi)) {
        bd = dist;
        bi = id;
      }
    }
  };
  auto emit = [&](int b, float bd, int bi) {
    if (bi == INT_MAX) bi = -1;
    if (center_term && metric_ip) bd -= corr;  // +inf stays +inf
    if (round_out) bd = round_bf16(bd);
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

template <bool kVec16>
int launch_pairs(int n_pairs, size_t dyn, cudaStream_t s, const float* q_rot,
                 const float* centers_rot, const float* books,
                 const uint8_t* codes, const float* norms, const int* ids,
                 const int* qsel, const int* lsel, int div, int rot_dim,
                 int pq_dim, int pq_len, int n_codes, int max_list, int bins,
                 int mlp, int metric_ip, int per_cluster, int round_q,
                 int center_term, int round_out, float* out_d, int* out_i) {
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_pairs_kernel<kVec16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pq_pairs_kernel<kVec16><<<n_pairs, kThreads, dyn, s>>>(
      q_rot, centers_rot, books, codes, norms, ids, qsel, lsel, div, rot_dim,
      pq_dim, pq_len, n_codes, max_list, bins, mlp, metric_ip, per_cluster,
      round_q, center_term, round_out, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pair p scores list lsel ? lsel[p] : p / div against query
// qsel ? qsel[p] : p / div (-1 = write (+inf, -1) bins) into
// out_d/out_i[p * bins, (p + 1) * bins). books hold (pq_dim or n_lists,
// n_codes, pq_len) f32 values already rounded to the LUT tier; codes
// (n_lists, max_list, pq_dim) u8; norms/ids (n_lists, max_list). vec16 != 0
// requires pq_dim % 16 == 0 and 16-byte aligned codes.
extern "C" int raft_ivf_pq_scan(
    const float* q_rot, const float* centers_rot, const float* books,
    const unsigned char* codes, const float* norms, const int* ids,
    const int* qsel, const int* lsel, int n_pairs, int div, int rot_dim,
    int pq_dim, int pq_len, int n_codes, int max_list, int bins, int mlp,
    int metric_ip, int per_cluster, int round_q, int center_term,
    int round_out, int vec16, float* out_d, int* out_i, void* stream) {
  const size_t dyn =
      (static_cast<size_t>(pq_dim) * n_codes + rot_dim) * sizeof(float);
  if (bins < 1 || mlp < max_list || mlp % bins != 0 || div < 1 ||
      pq_dim * pq_len != rot_dim || dyn > kMaxLutBytes ||
      (vec16 && pq_dim % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = reinterpret_cast<const uint8_t*>(codes);
  if (vec16)
    return launch_pairs<true>(n_pairs, dyn, s, q_rot, centers_rot, books, c,
                              norms, ids, qsel, lsel, div, rot_dim, pq_dim,
                              pq_len, n_codes, max_list, bins, mlp, metric_ip,
                              per_cluster, round_q, center_term, round_out,
                              out_d, out_i);
  return launch_pairs<false>(n_pairs, dyn, s, q_rot, centers_rot, books, c,
                             norms, ids, qsel, lsel, div, rot_dim, pq_dim,
                             pq_len, n_codes, max_list, bins, mlp, metric_ip,
                             per_cluster, round_q, center_term, round_out,
                             out_d, out_i);
}

// cand_d/cand_i (nq, n) -> out_d/out_i (nq, k), k <= 256.
extern "C" int raft_ivf_pq_topk(const float* cand_d, const int* cand_i,
                                int nq, int n, int k, int do_sqrt,
                                float* out_d, int* out_i, void* stream) {
  return raft_tpu_torch::launch_candidate_topk(
      cand_d, cand_i, nq, n, k, do_sqrt, out_d, out_i,
      static_cast<cudaStream_t>(stream));
}
