// IVF-Flat fine phase on the tensor cores: one list-major pass A, used by
//   * kernel 3 (raft_ivf_flat_scan): pass A writes each query's binned
//     candidates into a per-query row, then pass B, the payload radix
//     select (radix_select.cuh), keeps the k best — the fused scan;
//   * kernel 4 (raft_ivf_list_scan): pass A alone, writing (n_lists, cap,
//     bins) candidate blocks, merged afterwards by the caller (k > 256).
//
// Replaces: raft_tpu/ops/pallas_ivf_scan.py:_fused_list_scan_kernel (with
// _flat_list_candidates, _merge_state, _init_state, _finish_fused; entry
// ivf_list_scan_pallas(fused=True)) and :_list_scan_kernel (entry
// ivf_list_scan_pallas(fused=False)), f32 storage. Contract kept:
//   * score of list row r: L2 = max((norm_r + |q|^2) - 2 q.x_r, 0), or
//     IP = -(q.x_r) (not clamped); pad rows (id < 0, or r >= max_list inside
//     the bins-padded length) score +inf with id -1; the products q.x_r are
//     the TPU kernel's bf16x3 (wgmma_bf16x3.cuh), the norms those of the
//     unrounded rows;
//   * row r of a list goes to the strided bin r % bins; a bin's candidate is
//     its minimum, ties to the smallest id; an empty bin is (+inf, -1);
//   * kernel 3: the k smallest candidates under the key (score, list id,
//     bin index); a (query, probe) pair whose slot in the list's inverted
//     table is >= cap is skipped (absent from qmap, -1 in the sorted kept
//     probes), the TPU kernel's drop rule when a cached cap overflows; a
//     slot no candidate reached ends as (+inf, -1); sqrt is applied last;
//   * kernel 4: cap-major blocks (list, slot, bin), the layout _Layout.merge
//     swaps the TPU's (list, bin, slot) blocks to; an empty slot (qmap -1)
//     is all (+inf, -1); scores f32, or bf16 rounded to nearest for
//     internal_distance_dtype=bfloat16.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): each probed list read
// once per batch, ~5.1 GB at the served point (10M x 128, 1024 lists, 96
// probes, 128 clustered queries: 9.9M rows), 1.5 ms at 3.35 TB/s; the
// bf16x3 products, 3 x 2 x pairs x d at 989 TFLOP/s, take less. The
// query-major f32 kernel this replaces read each list once per probing
// query (214.5M rows scored, 76.7 ms per batch; kernel 4 68.3 ms).
//
// Design: the list-major pass A of list_scan_tc.cuh (one block per (list,
// tile of up to 64 probing table slots), lists longest first, strided
// bins in the accumulator's layout; see its note) with FlatRows below: the
// A rows are the tile's queries, split once into resident bf16 hi/lo tiles
// (streamed with the rows when d > 256); the B tiles are the list's f32
// rows split on the fly into hi/lo; products bf16x3 (three wgmma passes);
// the row term is the norm (L2) and the score L2 max((norm + |q|^2) -
// 2 acc, 0), IP -acc.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "list_scan_tc.cuh"

namespace raft_tpu_torch {
namespace {

// IVF-Flat lists: f32 rows, bf16x3 products, the row's norm as its term
struct FlatRows : RowsBase, NormScore {
  static constexpr int kPasses = 3;
  static constexpr bool kCentreTerm = false;
  static constexpr int kMinBlocks = 1;  // 132 KB of tiles a block at d 128
  using RowSlice = tc::Slice;

  template <bool IP>
  __device__ static void put_queries(const ListArgs& a, const int* row_q,
                                     int, int k0, unsigned char* hi,
                                     unsigned char* lo) {
#pragma unroll
    for (int s = 0; s < tc::kUnits; ++s) {
      const int u = threadIdx.x + s * tc::kThreads;
      float v[8];
      tc::fetch_row_unit(v, a.queries, row_q[u >> 3], a.d, k0 + 8 * (u & 7),
                         a.vec4 != 0);
      tc::put_unit<3>(v, u, hi, lo);
    }
  }
  template <bool IP>
  __device__ static void query_terms(const ListArgs& a, int q, int,
                                     float& qq, float& corr) {
    const float* qrow = a.queries + static_cast<long long>(q) * a.d;
    qq = 0.f;
#pragma unroll 8
    for (int j = 0; j < a.d; ++j) qq = fmaf(qrow[j], qrow[j], qq);
    corr = 0.f;
  }
  __device__ static void fetch_rows(RowSlice& f, const ListArgs& a,
                                    long long lbase, int r0, int rlim,
                                    int k0) {
    tc::fetch(f, a.data + lbase * a.d, r0, rlim, a.d, k0, a.vec4 != 0);
  }
  __device__ static void put_rows(const RowSlice& f, const ListArgs&,
                                  const unsigned char*, unsigned char* hi,
                                  unsigned char* lo) {
    tc::put<3>(f, hi, lo);
  }
};

}  // namespace
}  // namespace raft_tpu_torch

// Kernel 3 for queries [q_begin, q_end): qmap (n_lists, cap) query ids (-1
// = empty slot), kp (nq, n_probes) each query's kept probed lists sorted
// ascending (-1 = dropped); data (n_lists, max_list, d), norms/ids
// (n_lists, max_list); cand_d/cand_i scratch of (q_end - q_begin) x
// n_probes * bins, lists_scratch of 2 x n_lists ints; out_d/out_i (nq, k),
// k <= 256, rows [q_begin, q_end) written. vec4 != 0 requires d % 4 == 0
// and 16-byte aligned queries and data.
extern "C" int raft_ivf_flat_scan(const float* queries, int d,
                                  const int* qmap, int n_lists, int cap,
                                  const int* kp, int n_probes, int q_begin,
                                  int q_end, const float* data,
                                  const float* norms, const int* ids,
                                  int max_list, int bins, int k,
                                  int metric_ip, int do_sqrt, int vec4,
                                  float* cand_d, int* cand_i,
                                  int* lists_scratch, float* out_d,
                                  int* out_i, void* stream) {
  raft_tpu_torch::ListArgs a{};
  a.queries = queries;
  a.qmap = qmap;
  a.cap = cap;
  a.q_begin = q_begin;
  a.q_end = q_end;
  a.ids = ids;
  a.max_list = max_list;
  a.d = d;
  a.bins = bins;
  a.kp = kp;
  a.n_probes = n_probes;
  a.ncols = static_cast<long long>(n_probes) * bins;
  a.data = data;
  a.norms = norms;
  a.vec4 = vec4;
  return raft_tpu_torch::list_scan_fused<raft_tpu_torch::FlatRows>(
      a, n_lists, k, do_sqrt, cand_d, cand_i, lists_scratch, out_d, out_i,
      metric_ip != 0, static_cast<cudaStream_t>(stream));
}

// Kernel 4: qmap (n_lists, cap) query ids, -1 = empty slot. data (n_lists,
// max_list, d), norms/ids (n_lists, max_list). out_d (n_lists, cap, bins)
// f32, or bf16 when out_bf16 != 0; out_i the same int32; lists_scratch 2 x
// n_lists ints. vec4 as above.
extern "C" int raft_ivf_list_scan(const float* queries, int d,
                                  const int* qmap, int n_lists, int cap,
                                  const float* data, const float* norms,
                                  const int* ids, int max_list, int bins,
                                  int metric_ip, int vec4, int out_bf16,
                                  void* out_d, int* out_i,
                                  int* lists_scratch, void* stream) {
  if (bins < 1 || cap < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  raft_tpu_torch::ListArgs a{};
  a.queries = queries;
  a.qmap = qmap;
  a.cap = cap;
  a.q_end = 0x7fffffff;
  a.ids = ids;
  a.max_list = max_list;
  a.d = d;
  a.bins = bins;
  a.out_d = out_d;
  a.out_i = out_i;
  a.out_bf16 = out_bf16;
  a.data = data;
  a.norms = norms;
  a.vec4 = vec4;
  return raft_tpu_torch::launch_list_pass_a<raft_tpu_torch::FlatRows>(
      a, n_lists, lists_scratch, metric_ip != 0,
      static_cast<cudaStream_t>(stream));
}
