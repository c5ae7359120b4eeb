// IVF-BQ fine phase straight from the 1-bit sign codes, list-major on the
// tensor cores: one pass A, used by
//   * kernel 10 (raft_ivf_bq_scan): pass A alone, writing (n_lists, cap,
//     bins) candidate blocks, merged afterwards by the caller (kk > 256);
//   * kernel 11 (raft_ivf_bq_scan_fused): pass A into per-query candidate
//     rows, IP centre term included, then pass B, the payload radix select
//     (radix_select.cuh), keeps the k best.
//
// Replaces: raft_tpu/ops/pallas_ivf_scan.py:_bq_scan_kernel (unfused, kernel
// 10; entry ivf_bq_scan_pallas(fused=False)) and :_fused_bq_scan_kernel
// (fused, kernel 11; with _merge_state, _init_state, _finish_fused), both
// built on _bq_list_candidates (:686), which scores a whole list against its
// probing queries on the MXU. Contract kept, per pair (query q, list l):
//   * qsub = q_rot[q] (IP) or q_rot[q] - centers_rot[l] (L2), in f32;
//     |qsub|^2 and the IP centre term from the unrounded qsub; the estimator
//     product from qsub rounded to bf16 (round to nearest) against the +-1
//     decode of the row's bits, accumulated in f32: the TPU's one bf16 MXU
//     pass. A product of +-1 and a bf16 value is exact, so the kernel and
//     the plain version differ only in the f32 summation order;
//   * s_j = +1 where bit j of the row's words is set (the residual's sign
//     >= 0), else -1; bit j lives in word j / 32 at bit j % 32 (int32 words
//     read as unsigned), bits past d ignored;
//   * estimate: L2 = (norms2 + |qsub|^2) - 2 * scale * ip, IP = -(scale *
//     ip), NOT clamped at 0 (the 1-bit estimator overshoots near true
//     neighbours; a negative estimate is a strong candidate); a row with id
//     < 0, or beyond max_list inside the bins-padded length, scores +inf,
//     id -1;
//   * row r goes to the strided bin r % bins; a bin keeps its minimum, ties
//     to the smallest id; an empty bin is (+inf, -1);
//   * kernel 10: cap-major blocks (list, slot, bin); an empty slot (qmap -1)
//     is all (+inf, -1); the IP centre term is the caller's;
//   * kernel 11: a (query, probe) pair whose table slot is >= cap is
//     dropped; the IP centre term sum_j qsub_j * centers_rot[l][j] (f32) is
//     subtracted from each bin minimum (after the minimum: subtracting
//     first could make new ties); per query the k smallest candidates under
//     the key (score, list id, bin): the TPU's list-ascending walk in which
//     the resident state wins ties. Slots no candidate reaches end as
//     (+inf, -1).
//
// Bound on the H100 SXM (data-sheet rates, 700 W): each probed list's codes,
// norms, scales and ids read once per batch (d/8 + 12 bytes a row) and the
// products, 2 x pairs x rows x d at the 989 TFLOP/s bf16 tensor rate;
// chip_smoke.py computes both from the batch (~0.08-0.10 ms at the served
// point, 10M x 128, 1024 lists, 128 probes). The pair-major kernel this
// replaces read each probed list once per probing query (5.08 ms per
// 128-query batch for kernel 11, 4.24 ms for kernel 10; NVIDIA H100 80GB
// HBM3, 700.00 W; chip_smoke.py).
//
// Design: the list-major pass A of list_scan_tc.cuh (one block per (list,
// tile of up to 64 probing table slots), lists longest first, strided
// bins in the accumulator's layout; see its note) with BqRows below: the A
// rows are the tile's bf16(qsub), formed per list at tile setup, with
// |qsub|^2 and the centre term per row in shared memory (resident for d <=
// 256, else streamed with the codes); a B tile slice is 128 rows x 64
// features of the codes, 128 x 2 words, unpacked to +-1 bf16 straight into
// the swizzled layout (each thread decodes one word; 0 past d, so the
// zero-padded query columns add nothing); one wgmma pass (PASSES = 1); the
// row terms are (norms2, 2 scale); two blocks an SM.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "list_scan_tc.cuh"

namespace raft_tpu_torch {
namespace {

// IVF-BQ lists: sign codes, one bf16 pass against the +-1 decode, the
// row's (norms2, scale) as its terms
struct BqRows : ResidualQueries {
  static constexpr int kPasses = 1;
  static constexpr bool kCentreTerm = true;
  // 72 KB of shared memory a block at d <= 128, 105 KB at d <= 256: two
  // blocks an SM hide each other's latencies (128 registers a thread)
  static constexpr int kMinBlocks = 2;
  // a B tile slice (128 rows x 64 features) is 128 x 2 sign words: thread
  // t holds word t % 2 of row t / 2, and a mask of its features below d
  struct RowSlice {
    uint32_t w, valid;
  };

  __device__ static void fetch_rows(RowSlice& f, const ListArgs& a,
                                    long long lbase, int r0, int rlim,
                                    int k0) {
    const int r = r0 + (threadIdx.x >> 1);
    const int word = (k0 >> 5) + (threadIdx.x & 1);
    f.w = 0;
    f.valid = 0;
    if (r < rlim && word * 32 < a.d) {
      f.w = a.bits[(lbase + r) * a.words + word];
      const int nv = a.d - word * 32;
      f.valid = nv >= 32 ? 0xffffffffu : (1u << nv) - 1u;
    }
  }
  // the word's 32 features as bf16 +-1 pairs, four 8-feature units at
  // put()'s swizzled positions (byte r * 128 + ((g ^ (r % 8)) * 16)): both
  // halves of a pair start at -1 (0xBF80) and a set bit clears the sign;
  // features past d are zero
  __device__ static void put_rows(const RowSlice& f, const ListArgs&,
                                  const unsigned char*, unsigned char* hi,
                                  unsigned char*) {
    const int r = threadIdx.x >> 1, g0 = 4 * (threadIdx.x & 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t m = f.w >> (8 * q);
      uint32_t h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = 0xBF80BF80u ^ ((m << (15 - 2 * e)) & 0x8000u) ^
               ((m << (30 - 2 * e)) & 0x80000000u);
      if (f.valid != 0xffffffffu) {
        const uint32_t vm = f.valid >> (8 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] &= (((vm >> (2 * e)) & 1u) ? 0x0000ffffu : 0u) |
                  (((vm >> (2 * e + 1)) & 1u) ? 0xffff0000u : 0u);
      }
      *reinterpret_cast<uint4*>(hi + r * 128 + (((g0 + q) ^ (r & 7)) << 4)) =
          make_uint4(h[0], h[1], h[2], h[3]);
    }
  }
  template <bool IP>
  __device__ static void stage(const ListArgs& a, long long i, float& sa,
                               float& sb) {
    sa = IP ? 0.f : a.norms2[i];
    sb = IP ? a.scales[i] : 2.0f * a.scales[i];
  }
  // L2 (norms2 + |qsub|^2) - 2 scale ip (one rounding of the product and
  // the difference, where the plain version rounds each), IP -(scale ip);
  // pads (sa = +inf, sb = 0) score +inf. The stage holds 2 scale (L2).
  template <bool IP>
  __device__ static float score(float acc, float sa, float sb, float qq) {
    return IP ? (sa == 0.f ? -(sb * acc) : CUDART_INF_F)
              : fmaf(-sb, acc, sa + qq);
  }
};

ListArgs bq_args(const float* q_rot, int d, const int* qmap, int cap,
                 const float* centers_rot, const int* bits, int words,
                 const float* norms2, const float* scales, const int* ids,
                 int max_list, int bins) {
  ListArgs a{};
  a.queries = q_rot;
  a.qmap = qmap;
  a.cap = cap;
  a.ids = ids;
  a.max_list = max_list;
  a.d = d;
  a.bins = bins;
  a.centers = centers_rot;
  a.bits = reinterpret_cast<const uint32_t*>(bits);
  a.norms2 = norms2;
  a.scales = scales;
  a.words = words;
  return a;
}

}  // namespace
}  // namespace raft_tpu_torch

// Kernel 11 for queries [q_begin, q_end): q_rot (nq, d) and centers_rot
// (n_lists, d) f32; qmap (n_lists, cap) query ids (-1 = empty slot); kp (nq,
// n_probes) each query's kept probed lists sorted ascending (-1 =
// dropped); bits (n_lists, max_list, words) int32 bit patterns, words =
// ceil(d / 32); norms2/scales/ids (n_lists, max_list); cand_d/cand_i
// scratch of (q_end - q_begin) x n_probes * bins, lists_scratch of 2 x
// n_lists ints; out_d/out_i (nq, k), k <= 256, rows [q_begin, q_end)
// written.
extern "C" int raft_ivf_bq_scan_fused(
    const float* q_rot, int d, const int* qmap, int n_lists, int cap,
    const int* kp, int n_probes, int q_begin, int q_end,
    const float* centers_rot, const int* bits, int words,
    const float* norms2, const float* scales, const int* ids, int max_list,
    int bins, int k, int metric_ip, float* cand_d, int* cand_i,
    int* lists_scratch, float* out_d, int* out_i, void* stream) {
  if (words != (d + 31) / 32) return static_cast<int>(cudaErrorInvalidValue);
  raft_tpu_torch::ListArgs a = raft_tpu_torch::bq_args(
      q_rot, d, qmap, cap, centers_rot, bits, words, norms2, scales, ids,
      max_list, bins);
  a.q_begin = q_begin;
  a.q_end = q_end;
  a.kp = kp;
  a.n_probes = n_probes;
  a.ncols = static_cast<long long>(n_probes) * bins;
  a.center_term = 1;
  return raft_tpu_torch::list_scan_fused<raft_tpu_torch::BqRows>(
      a, n_lists, k, 0, cand_d, cand_i, lists_scratch, out_d, out_i,
      metric_ip != 0, static_cast<cudaStream_t>(stream));
}

// Kernel 10: the same inputs; out_d/out_i (n_lists, cap, bins) f32 and
// int32, no IP centre term; lists_scratch 2 x n_lists ints.
extern "C" int raft_ivf_bq_scan(const float* q_rot, int d, const int* qmap,
                                int n_lists, int cap,
                                const float* centers_rot, const int* bits,
                                int words, const float* norms2,
                                const float* scales, const int* ids,
                                int max_list, int bins, int metric_ip,
                                float* out_d, int* out_i,
                                int* lists_scratch, void* stream) {
  if (bins < 1 || cap < 1 || d < 1 || words != (d + 31) / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  raft_tpu_torch::ListArgs a = raft_tpu_torch::bq_args(
      q_rot, d, qmap, cap, centers_rot, bits, words, norms2, scales, ids,
      max_list, bins);
  a.q_end = 0x7fffffff;
  a.out_d = out_d;
  a.out_i = out_i;
  return raft_tpu_torch::launch_list_pass_a<raft_tpu_torch::BqRows>(
      a, n_lists, lists_scratch, metric_ip != 0,
      static_cast<cudaStream_t>(stream));
}
