// IVF-PQ fine phase straight from the u8 codes, two routes:
//   * the bf16 and fp8 LUT tiers (round_q): list-major on the tensor cores,
//     the pass A of list_scan_tc.cuh with PqRows below; kernel 8
//     (raft_ivf_pq_list_scan) writes (n_lists, cap, bins) candidate blocks,
//     kernel 9 (raft_ivf_pq_list_scan_fused) per-query candidate rows, the
//     IP centre term included, then pass B, the payload radix select of
//     radix_select.cuh, keeps the k best;
//   * the float32 tier (the f32 body): pair-major, pq_pairs_kernel below,
//     one block per (query, probed list) pair building an f32 table of
//     subspace inner products; kernel 9's pass B (raft_ivf_pq_topk) is the
//     same payload radix select.
//
// Replaces: raft_tpu/ops/pallas_ivf_scan.py:_pq_scan_kernel (unfused; entry
// ivf_pq_code_scan_pallas(fused=False)) and :_fused_pq_scan_kernel (fused;
// with _merge_state, _init_state, _finish_fused), both built on
// _pq_cell_candidates (:892), which decodes a list's rows (one-hot x
// codebook, so each decoded value is one codebook entry in the operand
// dtype) and scores all the list's probing queries against the decoded tile
// in one matmul. Contract kept, per pair (query q, list l):
//   * qsub = q_rot[q] (IP) or q_rot[q] - centers_rot[l] (L2), in f32;
//   * ip(row) = sum_s sum_j op(qsub[s*pq_len + j]) * op(book[c_s][j]), f32
//     accumulation, with book = books[s] (per subspace) or books[l] (per
//     cluster) and c_s the row's u8 code of subspace s. op is the LUT tier:
//     the wrapper passes the books already rounded (bf16, or fp8 e4m3 widened
//     exactly), and round_q rounds the query to bf16 (bf16 and fp8 tiers).
//     List-major: the row decoded to bf16 codebook values (exact: every book
//     value is a bf16 or fp8 value) against bf16(qsub) in one bf16 wgmma
//     pass, so each product is exact and only the f32 summation order
//     differs from the plain version (the TPU's bf16 MXU pass with f32
//     accumulation). Pair-major f32 body: the same sum regrouped as LUT[s][c]
//     = sum_j qsub_s,j * book[c][j], the row's score sum_s LUT[s][c_s] (the
//     reference's shared-memory LUT, ivf_pq_search.cuh:593): the TPU
//     computes that tier at HIGHEST, which one bf16 pass would not match;
//   * score: L2 = max((|qsub|^2 + code_norm) - 2 ip, 0) with |qsub|^2 from
//     the unrounded qsub; IP = -ip; a row with id < 0, or beyond max_list
//     inside the bins-padded length mlp, scores +inf with id -1;
//   * row r goes to bin r % bins; a bin keeps its minimum, ties to the
//     smallest id; an empty bin is (+inf, -1);
//   * unfused (kernel 8): one pair per (list, table slot), the slot's query
//     from qmap (-1 = empty slot, all bins (+inf, -1)); scores optionally
//     rounded to bf16 after the minimum (internal_distance_dtype); the IP
//     centre term is the caller's;
//   * fused (kernel 9): a (query, probe) pair whose table slot is >= cap is
//     dropped; the IP centre term sum_j qsub_j * centers_rot[l][j] (f32) is
//     subtracted from each bin minimum (after the minimum); then per query
//     the k smallest candidates under the key (score, list id, bin): the
//     TPU's list-ascending walk in which the resident state wins ties. Slots
//     no candidate reaches end as (+inf, -1); sqrt is applied last.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): bytes. At the served
// point (10M x 128, 4096 lists, pq_dim 32 x 8 bits, 128 probes, a 128-query
// batch) the batch needs its 6.8M probed rows' codes, norms and ids once
// (40 B a row, 0.081 ms at 3.35 TB/s); the list-major products, 2 x
// 138.7M pair-rows x 128 at the 989 TFLOP/s bf16 rate, take 0.036 ms. The
// pair-major design read each probed list once per probing query (138.7M
// (pair, row) scores, 20x the rows, mostly from the 50 MB L2): fused 3.28
// ms (pq_pairs_kernel ~2.3 ms + pass B ~0.6 ms), unfused (kk = 512) 2.60
// ms per 128-query batch (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py).
//
// Design, list-major (PqRows): one block per (list, tile of up to 64
// probing table slots), lists longest first, strided bins in the
// accumulator's layout (list_scan_tc.cuh's note). The A rows are the
// tile's bf16(qsub), formed per list at tile setup, with |qsub|^2 and the
// centre term per row in shared memory (resident for rot_dim <= 256, else
// streamed with the rows). A B tile slice is 128 rows x 64 features; a
// thread takes 32 features of one row (a warp 32 rows, the same features):
// it loads their u8 codes (<= 16 bytes from pq_len 2 up) as aligned words
// into registers a step ahead, past L1, and decodes them the next step,
// while the products run, through the codebook into the swizzled bf16 tile
// (0 past rot_dim): one pq_len-wide vector per subspace where pq_len is 1,
// 2, 4 or a multiple of 8, else value by value (a unit of 8 features may
// straddle two subspaces, pq_len 3). Two blocks an SM (~71 KB each at the
// served point): the second block's steps hide the first's latencies, as
// for BqRows. The books arrive as bf16 (the fp8 tier's widened exactly);
// a per-cluster book, the list's own (2 KB at pq_len 4), is staged in
// shared memory per block, and per-subspace books where they fit beside
// the tiles at two blocks an SM (pq_bits 4); larger ones (64 KB at the
// served point) are read through L1, which holds them: staged instead, at
// one block an SM, the scan ran slower. Row terms: the code norm (L2).
// With parts cut out, the scan showed its pace set by the pass A's own
// per-step cost (as for IVF-BQ), then by the codes' loads, then by the
// decode's book reads. Tried and not kept: the books staged at one block
// an SM, or shared by two halves of a 512-thread block, and the codes
// loaded two steps ahead in registers (spills) or three ahead by
// asynchronous copies into shared memory: none ran faster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "list_scan_tc.cuh"

namespace raft_tpu_torch {
namespace {

// A block's shared memory at two blocks an SM: the SM's 228 KB less 1 KB
// reserved a block, halved
constexpr size_t kPqBlockSmem = (233472 - 2 * 1024) / 2;

// IVF-PQ lists: u8 codes decoded through the codebook, one bf16 pass,
// the code norm as the row term
struct PqRows : ResidualQueries, NormScore {
  static constexpr int kPasses = 1;
  static constexpr bool kCentreTerm = true;
  // two blocks an SM hide each other's latencies (128 registers a
  // thread); the books are staged only where they fit that budget
  static constexpr int kMinBlocks = 2;
  // a B tile slice (128 rows x 64 features): thread t decodes row 32 (w /
  // 2) + lane of warp w, features kk0 + [0, 32) with kk0 = k0 + 32 (w %
  // 2), four 8-feature units (a warp's 32 lanes gather from the same
  // subspaces, so from fewer cache lines of the books). c: for pq_len >=
  // 2 the codes of the subspaces from s0 = kk0 /
  // pq_len on (<= 16 bytes); for pq_len 1 the address of the row's code
  // kk0, read when decoding. meta: bit 0 a real row with features below
  // d, bits 1.. kk0.
  struct RowSlice {
    uint32_t c[4];
    uint32_t meta;
  };

  // the thread's row of the slice and its half of the features
  __device__ static int row_of() {
    return 32 * (threadIdx.x >> 6) + (threadIdx.x & 31);
  }
  __device__ static int half_of() { return (threadIdx.x >> 5) & 1; }

  // the books as bf16: the list's own (per cluster) or every subspace's
  __host__ __device__ static size_t book_bytes(const ListArgs& a) {
    const size_t per = static_cast<size_t>(a.n_codes) * a.pq_len * 2;
    return a.per_cluster ? per : per * a.pq_dim;
  }
  __host__ __device__ static size_t extra_smem(const ListArgs& a) {
    return a.book_res ? book_bytes(a) : 0;
  }
  // the books (the list's own, per cluster) into shared memory;
  // n_codes % 8 == 0, so both ends are 16-byte aligned
  __device__ static void setup(const ListArgs& a, int l, unsigned char* ext) {
    if (!a.book_res) return;
    const long long per = static_cast<long long>(a.n_codes) * a.pq_len;
    const long long n = a.per_cluster ? per : per * a.pq_dim;
    const uint4* src = reinterpret_cast<const uint4*>(
        a.books + (a.per_cluster ? static_cast<long long>(l) * per : 0));
    uint4* dst = reinterpret_cast<uint4*>(ext);
    for (long long i = threadIdx.x; i < n / 8; i += kThreads) dst[i] = src[i];
  }
  __device__ static void fetch_rows(RowSlice& f, const ListArgs& a,
                                    long long lbase, int r0, int rlim,
                                    int k0) {
    const int r = r0 + row_of();
    const int kk0 = k0 + 32 * half_of();
    const bool real = r < rlim && kk0 < a.d;
    f.meta = (static_cast<uint32_t>(kk0) << 1) | (real ? 1u : 0u);
    f.c[0] = f.c[1] = f.c[2] = f.c[3] = 0u;
    if (!real) return;
    const int pl = a.pq_len;
    const uint8_t* row = a.codes + (lbase + r) * a.pq_dim;
    if (pl == 1) {
      const uint64_t p = reinterpret_cast<uint64_t>(row + kk0);
      f.c[0] = static_cast<uint32_t>(p);
      f.c[1] = static_cast<uint32_t>(p >> 32);
      return;
    }
    // the window's bytes by aligned words (a word holding a byte of the
    // tensor lies in its allocation), shifted down to s0; read past L1
    // (ld.global.cg), which keeps the books
    const int s0 = kk0 / pl;
    const int n = min(kk0 + 31, a.d - 1) / pl - s0 + 1;  // <= 16
    const uint64_t p = reinterpret_cast<uint64_t>(row + s0);
    const int mis = static_cast<int>(p & 3u);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p - mis);
    const int nw = (mis + n + 3) >> 2;  // <= 5
    uint32_t t[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) t[j] = j < nw ? __ldcg(w + j) : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) f.c[j] = __funnelshift_r(t[j], t[j + 1],
                                                         8 * mis);
  }
  // the 32 features as bf16 codebook values (zeros past d and for rows
  // past rlim), stored at put_unit()'s swizzled positions (units 4 half +
  // q of the thread's row); the books from shared memory (staged) or
  // through L1
  __device__ static void put_rows(const RowSlice& f, const ListArgs& a,
                                  const unsigned char* ext, unsigned char* hi,
                                  unsigned char*) {
    const __nv_bfloat16* bk =
        a.book_res ? reinterpret_cast<const __nv_bfloat16*>(ext) : a.books;
    const int pl = a.pq_len, nc = a.n_codes, d = a.d;
    const int r = row_of(), g0 = 4 * half_of();
    const int kk0 = static_cast<int>(f.meta >> 1);
    const bool real = (f.meta & 1u) != 0;
    // the subspace of a book entry: 0 for a per-cluster book (the list's
    // own, staged), else its own
    const int sub_mul = a.per_cluster ? 0 : 1;
    const int s0 = pl > 1 ? kk0 / pl : kk0;
    auto at = [&](int sub, int c, int el) {  // entry (sub, c), element el
      return bk + (static_cast<long long>(sub_mul * sub) * nc + c) * pl + el;
    };
    // code of subspace s0 + j (j < 16)
    auto code = [&](int j) {
      uint32_t w = f.c[0];
      w = (j >> 2) == 1 ? f.c[1] : w;
      w = (j >> 2) == 2 ? f.c[2] : w;
      w = (j >> 2) == 3 ? f.c[3] : w;
      return static_cast<int>((w >> (8 * (j & 3))) & 0xffu);
    };
    auto bf = [&](const __nv_bfloat16* e) {
      return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(e));
    };
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = kk0 + 8 * q;
      uint32_t h[4] = {0u, 0u, 0u, 0u};
      if (real && kk < d) {
        if (pl == 4) {
          // two whole subspaces (d is a multiple of pq_len: a subspace
          // is in or out as a whole)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (kk + 4 * i < d) {
              const uint2 v = *reinterpret_cast<const uint2*>(
                  at(s0 + 2 * q + i, code(2 * q + i), 0));
              h[2 * i] = v.x;
              h[2 * i + 1] = v.y;
            }
          }
        } else if (pl == 2) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (kk + 2 * i < d)
              h[i] = *reinterpret_cast<const uint32_t*>(
                  at(s0 + 4 * q + i, code(4 * q + i), 0));
        } else if (pl % 8 == 0) {
          // the unit lies in one subspace: 16 aligned bytes of its entry
          const int sub = kk / pl;
          const uint4 v = *reinterpret_cast<const uint4*>(
              at(sub, code(sub - s0), kk - sub * pl));
          h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
        } else if (pl == 1) {
          // one subspace a feature: the codes read here
          const uint8_t* p = reinterpret_cast<const uint8_t*>(
              static_cast<uint64_t>(f.c[0]) |
              (static_cast<uint64_t>(f.c[1]) << 32)) + 8 * q;
          uint32_t e[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            e[i] = kk + i < d ? bf(at(kk + i, p[i], 0)) : 0u;
#pragma unroll
          for (int i = 0; i < 4; ++i) h[i] = e[2 * i] | (e[2 * i + 1] << 16);
        } else {
          // any other pq_len: feature by feature, the subspace stepped
          int sub = kk / pl, el = kk - sub * pl;
          uint32_t e[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            e[i] = kk + i < d ? bf(at(sub, code(sub - s0), el)) : 0u;
            if (++el == pl) {
              el = 0;
              ++sub;
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) h[i] = e[2 * i] | (e[2 * i + 1] << 16);
        }
      }
      *reinterpret_cast<uint4*>(hi + r * 128 + (((g0 + q) ^ (r & 7)) << 4)) =
          make_uint4(h[0], h[1], h[2], h[3]);
    }
  }
};

// The list-major scans' arguments; the books sit in shared memory when
// they fit beside the tiles at two blocks an SM (a per-cluster book
// always must), else they are read through L1.
int pq_args(ListArgs& a, const float* q_rot, int rot_dim, const int* qmap,
            int cap, const float* centers_rot, const void* books,
            const unsigned char* codes, int pq_dim, int pq_len, int n_codes,
            int per_cluster, const float* norms, const int* ids,
            int max_list, int bins) {
  if (bins < 1 || cap < 1 || rot_dim < 1 || pq_len < 1 ||
      pq_dim * pq_len != rot_dim || n_codes < 8 || n_codes % 8 != 0 ||
      n_codes > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  a = ListArgs{};
  a.queries = q_rot;
  a.qmap = qmap;
  a.cap = cap;
  a.ids = ids;
  a.max_list = max_list;
  a.d = rot_dim;
  a.bins = bins;
  a.norms = norms;
  a.centers = centers_rot;
  a.codes = reinterpret_cast<const uint8_t*>(codes);
  a.books = static_cast<const __nv_bfloat16*>(books);
  a.pq_dim = pq_dim;
  a.pq_len = pq_len;
  a.n_codes = n_codes;
  a.per_cluster = per_cluster;
  a.book_res = 1;
  a.book_res = list_smem_bytes<PqRows>(a) <= kPqBlockSmem;
  if (per_cluster && !a.book_res)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The f32 body (the float32 LUT tier): pq_pairs_kernel runs one
// 256-thread block per pair, so even a 1-row batch has n_probes blocks to
// spread over the 132 SMs. The block builds the (pq_dim, n_codes) f32 table
// in dynamic shared memory (32 KB at the served point, so several blocks
// share an SM), then scans the list: with bins < 256, 256 / bins threads
// share a bin and combine their partial minima through shared memory; each
// thread reads a row's pq_dim codes as 16-byte vectors (pq_dim % 16 == 0),
// neighbouring threads on neighbouring rows.
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
}  // namespace raft_tpu_torch

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
      pq_dim * pq_len != rot_dim || dyn > raft_tpu_torch::kMaxLutBytes ||
      (vec16 && pq_dim % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = reinterpret_cast<const uint8_t*>(codes);
  if (vec16)
    return raft_tpu_torch::launch_pairs<true>(
        n_pairs, dyn, s, q_rot, centers_rot, books, c, norms, ids, qsel, lsel,
        div, rot_dim, pq_dim, pq_len, n_codes, max_list, bins, mlp, metric_ip,
        per_cluster, round_q, center_term, round_out, out_d, out_i);
  return raft_tpu_torch::launch_pairs<false>(
      n_pairs, dyn, s, q_rot, centers_rot, books, c, norms, ids, qsel, lsel,
      div, rot_dim, pq_dim, pq_len, n_codes, max_list, bins, mlp, metric_ip,
      per_cluster, round_q, center_term, round_out, out_d, out_i);
}

// The f32 body's pass B: cand_d/cand_i (nq, n) -> out_d/out_i (nq, k),
// k <= 256 (the payload radix select).
extern "C" int raft_ivf_pq_topk(const float* cand_d, const int* cand_i,
                                int nq, int n, int k, int do_sqrt,
                                float* out_d, int* out_i, void* stream) {
  return raft_tpu_torch::launch_radix_select(
      cand_d, cand_i, nq, n, k, do_sqrt, out_d, out_i,
      static_cast<cudaStream_t>(stream));
}

// Kernel 9, list-major (bf16 and fp8 tiers), for queries [q_begin, q_end):
// q_rot (nq, rot_dim) and centers_rot (n_lists, rot_dim) f32; qmap
// (n_lists, cap) query ids (-1 = empty slot); kp (nq, n_probes) each
// query's kept probed lists sorted ascending (-1 = dropped); books (pq_dim,
// or n_lists when per_cluster, n_codes, pq_len) bf16 (fp8 books widened);
// codes (n_lists, max_list, pq_dim) u8; norms/ids (n_lists, max_list);
// cand_d/cand_i scratch of (q_end - q_begin) x n_probes * bins,
// lists_scratch of 2 x n_lists ints; out_d/out_i (nq, k), k <= 256, rows
// [q_begin, q_end) written. n_codes % 8 == 0.
extern "C" int raft_ivf_pq_list_scan_fused(
    const float* q_rot, int rot_dim, const int* qmap, int n_lists, int cap,
    const int* kp, int n_probes, int q_begin, int q_end,
    const float* centers_rot, const void* books, const unsigned char* codes,
    int pq_dim, int pq_len, int n_codes, int per_cluster, const float* norms,
    const int* ids, int max_list, int bins, int k, int metric_ip,
    int do_sqrt, float* cand_d, int* cand_i, int* lists_scratch,
    float* out_d, int* out_i, void* stream) {
  raft_tpu_torch::ListArgs a;
  int rc = raft_tpu_torch::pq_args(a, q_rot, rot_dim, qmap, cap, centers_rot,
                                   books, codes, pq_dim, pq_len, n_codes,
                                   per_cluster, norms, ids, max_list, bins);
  if (rc != 0) return rc;
  a.q_begin = q_begin;
  a.q_end = q_end;
  a.kp = kp;
  a.n_probes = n_probes;
  a.ncols = static_cast<long long>(n_probes) * bins;
  a.center_term = 1;
  return raft_tpu_torch::list_scan_fused<raft_tpu_torch::PqRows>(
      a, n_lists, k, do_sqrt, cand_d, cand_i, lists_scratch, out_d, out_i,
      metric_ip != 0, static_cast<cudaStream_t>(stream));
}

// Kernel 8, list-major: the same inputs; out_d/out_i (n_lists, cap, bins)
// f32 (rounded to bf16 when round_out) and int32, no IP centre term;
// lists_scratch 2 x n_lists ints.
extern "C" int raft_ivf_pq_list_scan(
    const float* q_rot, int rot_dim, const int* qmap, int n_lists, int cap,
    const float* centers_rot, const void* books, const unsigned char* codes,
    int pq_dim, int pq_len, int n_codes, int per_cluster, const float* norms,
    const int* ids, int max_list, int bins, int metric_ip, int round_out,
    float* out_d, int* out_i, int* lists_scratch, void* stream) {
  raft_tpu_torch::ListArgs a;
  int rc = raft_tpu_torch::pq_args(a, q_rot, rot_dim, qmap, cap, centers_rot,
                                   books, codes, pq_dim, pq_len, n_codes,
                                   per_cluster, norms, ids, max_list, bins);
  if (rc != 0) return rc;
  a.q_end = 0x7fffffff;
  a.out_d = out_d;
  a.out_i = out_i;
  a.round_out = round_out;
  return raft_tpu_torch::launch_list_pass_a<raft_tpu_torch::PqRows>(
      a, n_lists, lists_scratch, metric_ip != 0,
      static_cast<cudaStream_t>(stream));
}
