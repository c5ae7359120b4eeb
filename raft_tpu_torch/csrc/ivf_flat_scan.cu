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
// ivf_list_scan_pallas(fused=False)), in all three list storages of
// _flat_list_candidates (:56-99). Contract kept:
//   * the product q.x_r of list row r: f32 rows as the TPU kernel's bf16x3
//     (wgmma_bf16x3.cuh); bf16 rows (:68-71) as one bf16 product of the
//     rows and the queries rounded to bf16 (to nearest); int8 rows (:72-78)
//     taken as bf16 (exact for |v| <= 127), the same product with the
//     queries rounded to bf16, then ip = scale * acc. Products are exact in
//     f32 and summed in f32;
//   * score: L2 = max((norm_r + |q|^2) - 2 ip, 0), |q|^2 from the f32
//     queries and norm_r that of the stored row (rounded or dequantized:
//     the caller's norms), or IP = -ip (not clamped); pad rows (id < 0, or
//     r >= max_list inside the bins-padded length) score +inf with id -1;
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
// once per batch. At the served point (10M x 128, 1024 lists, 96 probes,
// 128 clustered queries: 9.9M rows) f32 rows take ~5.1 GB, 1.5 ms at 3.35
// TB/s; bf16 rows (256 B + 8 B of norm and id) ~0.78 ms, int8 rows (128 B +
// 8 B) ~0.40 ms; the products (bf16x3: 3 x 2 x pairs x d, else 2 x pairs x
// d, at 989 TFLOP/s) take less. The query-major f32 kernel this replaces
// read each list once per probing query (214.5M rows scored, 76.7 ms per
// batch; kernel 4 68.3 ms).
//
// Design: the list-major pass A of list_scan_tc.cuh (one block per (list,
// tile of up to 64 probing table slots), lists longest first, strided
// bins in the accumulator's layout; see its note), with one row policy a
// storage:
//   * FlatRows: the A rows are the tile's queries, split once into
//     resident bf16 hi/lo tiles (streamed with the rows when d > 256); the
//     B tiles are the list's f32 rows split on the fly into hi/lo;
//     products bf16x3 (three wgmma passes); one block an SM (132 KB of
//     tiles at d 128);
//   * Bf16Rows: the A tiles hold the queries rounded to bf16; the bf16 rows
//     go to the swizzled B tiles as they are loaded (no conversion); one
//     wgmma pass; two blocks an SM at 128 registers;
//   * Int8Rows: as Bf16Rows, each int8 row converted to bf16 in registers
//     on its way to the B tile; the score folds scale in before the norm
//     term, in the plain version's rounding order.
// Rows load 16 bytes a thread (4 f32, 8 bf16 or 16 int8 features) where d
// and the base's alignment allow it, else feature by feature.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "list_scan_tc.cuh"

namespace raft_tpu_torch {
namespace {

// The A rows of every IVF-Flat policy: the tile's f32 queries, split into
// hi/lo (PASSES = 3) or rounded to bf16 (PASSES = 1); |q|^2 from the f32
// queries, no centre term.
template <int PASSES>
struct FlatQueries : RowsBase {
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
      tc::put_unit<PASSES>(v, u, hi, lo);
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
};

// f32 rows, bf16x3 products, the row's norm as its term
struct FlatRows : FlatQueries<3>, NormScore {
  static constexpr int kPasses = 3;
  static constexpr bool kCentreTerm = false;
  static constexpr int kMinBlocks = 1;  // 132 KB of tiles a block at d 128
  using RowSlice = tc::Slice;

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

// bf16 rows, one bf16 pass, the row's norm as its term. A B tile slice is
// what tc::Slice holds for f32 (unit u of the block: row u / 8, features
// 8 (u % 8) .. + 7), as 16 bytes of bf16 a unit, stored as loaded.
struct Bf16Rows : FlatQueries<1>, NormScore {
  static constexpr int kPasses = 1;
  static constexpr bool kCentreTerm = false;
  // 64 KB of tiles a block at d 128, 96 KB at d 256: two blocks an SM
  static constexpr int kMinBlocks = 2;
  struct RowSlice {
    uint4 v[tc::kUnits];
  };

  __device__ static void fetch_rows(RowSlice& f, const ListArgs& a,
                                    long long lbase, int r0, int rlim,
                                    int k0) {
#pragma unroll
    for (int s = 0; s < tc::kUnits; ++s) {
      const int u = threadIdx.x + s * tc::kThreads;
      const int row = r0 + (u >> 3);
      const int kk = k0 + 8 * (u & 7);
      const unsigned short* p = reinterpret_cast<const unsigned short*>(
          a.data_bf16 + (lbase + row) * a.d + kk);
      if (row < rlim && a.vec_rows && kk + 8 <= a.d) {
        f.v[s] = *reinterpret_cast<const uint4*>(p);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t lo16 =
              (row < rlim && kk + 2 * e < a.d) ? p[2 * e] : 0u;
          const uint32_t hi16 =
              (row < rlim && kk + 2 * e + 1 < a.d) ? p[2 * e + 1] : 0u;
          w[e] = lo16 | (hi16 << 16);
        }
        f.v[s] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  __device__ static void put_rows(const RowSlice& f, const ListArgs&,
                                  const unsigned char*, unsigned char* hi,
                                  unsigned char*) {
#pragma unroll
    for (int s = 0; s < tc::kUnits; ++s) {
      const int u = threadIdx.x + s * tc::kThreads;
      const int r = u >> 3, g = u & 7;
      *reinterpret_cast<uint4*>(hi + r * 128 + ((g ^ (r & 7)) << 4)) = f.v[s];
    }
  }
};

// int8 rows, converted to bf16 in registers (exact for |v| <= 127), one
// bf16 pass; ip = scale * acc. A B tile slice (128 rows x 64 features) is
// 512 chunks of 16 features: thread t holds chunks t and t + 256, chunk c
// at row c / 4, features 16 (c % 4) .. + 15 (two put_unit units).
struct Int8Rows : FlatQueries<1> {
  static constexpr int kPasses = 1;
  static constexpr bool kCentreTerm = false;
  static constexpr int kMinBlocks = 2;
  static constexpr int kChunks = tc::kBN * tc::kBK / 16 / tc::kThreads;
  struct RowSlice {
    uint4 v[kChunks];
  };

  __device__ static void fetch_rows(RowSlice& f, const ListArgs& a,
                                    long long lbase, int r0, int rlim,
                                    int k0) {
#pragma unroll
    for (int s = 0; s < kChunks; ++s) {
      const int c = threadIdx.x + s * tc::kThreads;
      const int row = r0 + (c >> 2);
      const int kk = k0 + 16 * (c & 3);
      const int8_t* p = a.data_i8 + (lbase + row) * a.d + kk;
      if (row < rlim && a.vec_rows && kk + 16 <= a.d) {
        f.v[s] = *reinterpret_cast<const uint4*>(p);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[e] = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = kk + 4 * e + j;
            const uint32_t b =
                (row < rlim && kj < a.d) ? static_cast<uint8_t>(p[4 * e + j])
                                         : 0u;
            w[e] |= b << (8 * j);
          }
        }
        f.v[s] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  __device__ static void put_rows(const RowSlice& f, const ListArgs&,
                                  const unsigned char*, unsigned char* hi,
                                  unsigned char* lo) {
#pragma unroll
    for (int s = 0; s < kChunks; ++s) {
      const int c = threadIdx.x + s * tc::kThreads;
      const uint32_t w[4] = {f.v[s].x, f.v[s].y, f.v[s].z, f.v[s].w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = static_cast<float>(
              static_cast<int8_t>(w[2 * h + (e >> 2)] >> (8 * (e & 3))));
        // unit (row c / 4, features 16 (c % 4) + 8 h ..): u = 8 row + group
        tc::put_unit<1>(v, (c >> 2) * 8 + 2 * (c & 3) + h, hi, lo);
      }
    }
  }
  // the stage holds (norm, scale) (L2) or (0, scale) (IP)
  template <bool IP>
  __device__ static void stage(const ListArgs& a, long long i, float& sa,
                               float& sb) {
    sa = IP ? 0.f : a.norms[i];
    sb = a.scale;
  }
  // ip = scale * acc, then L2 max((norm + |q|^2) - 2 ip, 0) with one
  // rounding of the difference (2 ip is exact), IP -ip: the plain version's
  // order; pads (sa = +inf, sb = 0) score +inf
  template <bool IP>
  __device__ static float score(float acc, float sa, float sb, float qq) {
    const float ip = sb * acc;
    return IP ? (sa == 0.f ? -ip : CUDART_INF_F)
              : fmaxf(fmaf(-2.0f, ip, sa + qq), 0.f);
  }
};

// The list storages of ivf_flat.Index: 0 f32, 1 bf16, 2 int8
enum Storage { kF32 = 0, kBf16 = 1, kInt8 = 2 };

ListArgs flat_args(const float* queries, int d, const int* qmap, int cap,
                   const void* data, int storage, float scale,
                   const float* norms, const int* ids, int max_list,
                   int bins, int vec4, int vec_rows) {
  ListArgs a{};
  a.queries = queries;
  a.qmap = qmap;
  a.cap = cap;
  a.ids = ids;
  a.max_list = max_list;
  a.d = d;
  a.bins = bins;
  a.data = storage == kF32 ? static_cast<const float*>(data) : nullptr;
  a.data_bf16 = storage == kBf16 ? static_cast<const __nv_bfloat16*>(data)
                                 : nullptr;
  a.data_i8 = storage == kInt8 ? static_cast<const int8_t*>(data) : nullptr;
  a.scale = scale;
  a.norms = norms;
  a.vec4 = vec4;
  a.vec_rows = vec_rows;
  return a;
}

}  // namespace
}  // namespace raft_tpu_torch

// Kernel 3 for queries [q_begin, q_end): qmap (n_lists, cap) query ids (-1
// = empty slot), kp (nq, n_probes) each query's kept probed lists sorted
// ascending (-1 = dropped); data (n_lists, max_list, d) in `storage` (0
// f32, 1 bf16, 2 int8 with its scale), norms/ids (n_lists, max_list);
// cand_d/cand_i scratch of (q_end - q_begin) x n_probes * bins,
// lists_scratch of 2 x n_lists ints; out_d/out_i (nq, k), k <= 256, rows
// [q_begin, q_end) written. vec4 != 0 requires d % 4 == 0 and 16-byte
// aligned queries (and f32 data); vec_rows != 0 16-byte aligned bf16 data
// with d % 8 == 0, or int8 data with d % 16 == 0.
extern "C" int raft_ivf_flat_scan(const float* queries, int d,
                                  const int* qmap, int n_lists, int cap,
                                  const int* kp, int n_probes, int q_begin,
                                  int q_end, const void* data, int storage,
                                  float scale, const float* norms,
                                  const int* ids, int max_list, int bins,
                                  int k, int metric_ip, int do_sqrt, int vec4,
                                  int vec_rows, float* cand_d, int* cand_i,
                                  int* lists_scratch, float* out_d,
                                  int* out_i, void* stream) {
  raft_tpu_torch::ListArgs a =
      raft_tpu_torch::flat_args(queries, d, qmap, cap, data, storage, scale,
                                norms, ids, max_list, bins, vec4, vec_rows);
  a.q_begin = q_begin;
  a.q_end = q_end;
  a.kp = kp;
  a.n_probes = n_probes;
  a.ncols = static_cast<long long>(n_probes) * bins;
  const bool ip = metric_ip != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case raft_tpu_torch::kF32:
      return raft_tpu_torch::list_scan_fused<raft_tpu_torch::FlatRows>(
          a, n_lists, k, do_sqrt, cand_d, cand_i, lists_scratch, out_d,
          out_i, ip, s);
    case raft_tpu_torch::kBf16:
      return raft_tpu_torch::list_scan_fused<raft_tpu_torch::Bf16Rows>(
          a, n_lists, k, do_sqrt, cand_d, cand_i, lists_scratch, out_d,
          out_i, ip, s);
    case raft_tpu_torch::kInt8:
      return raft_tpu_torch::list_scan_fused<raft_tpu_torch::Int8Rows>(
          a, n_lists, k, do_sqrt, cand_d, cand_i, lists_scratch, out_d,
          out_i, ip, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 4: qmap (n_lists, cap) query ids, -1 = empty slot. data (n_lists,
// max_list, d) in `storage` as above, norms/ids (n_lists, max_list). out_d
// (n_lists, cap, bins) f32, or bf16 when out_bf16 != 0; out_i the same
// int32; lists_scratch 2 x n_lists ints. vec4 and vec_rows as above.
extern "C" int raft_ivf_list_scan(const float* queries, int d,
                                  const int* qmap, int n_lists, int cap,
                                  const void* data, int storage, float scale,
                                  const float* norms, const int* ids,
                                  int max_list, int bins, int metric_ip,
                                  int vec4, int vec_rows, int out_bf16,
                                  void* out_d, int* out_i,
                                  int* lists_scratch, void* stream) {
  if (bins < 1 || cap < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  raft_tpu_torch::ListArgs a =
      raft_tpu_torch::flat_args(queries, d, qmap, cap, data, storage, scale,
                                norms, ids, max_list, bins, vec4, vec_rows);
  a.q_end = 0x7fffffff;
  a.out_d = out_d;
  a.out_i = out_i;
  a.out_bf16 = out_bf16;
  const bool ip = metric_ip != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case raft_tpu_torch::kF32:
      return raft_tpu_torch::launch_list_pass_a<raft_tpu_torch::FlatRows>(
          a, n_lists, lists_scratch, ip, s);
    case raft_tpu_torch::kBf16:
      return raft_tpu_torch::launch_list_pass_a<raft_tpu_torch::Bf16Rows>(
          a, n_lists, lists_scratch, ip, s);
    case raft_tpu_torch::kInt8:
      return raft_tpu_torch::launch_list_pass_a<raft_tpu_torch::Int8Rows>(
          a, n_lists, lists_scratch, ip, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
