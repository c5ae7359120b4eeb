// IVF-PQ fine phase straight from the u8 codes, two routes:
//   * the bf16 and fp8 LUT tiers (round_q): list-major on the tensor cores,
//     the pass A of list_scan_tc.cuh with PqRows below; kernel 8
//     (raft_ivf_pq_list_scan) writes (n_lists, cap, bins) candidate blocks,
//     kernel 9 (raft_ivf_pq_list_scan_fused) per-query candidate rows, the
//     IP centre term included, then pass B, the payload radix select of
//     radix_select.cuh, keeps the k best;
//   * the float32 tier (the f32 body): list-major on the CUDA cores,
//     pq_f32_kernel below, one block per (list, tile of up to 32 probing
//     table slots), walking the bins 64 at a time, decoding the list's
//     rows once per tile into f32 codebook values and scoring every slot
//     of the tile against them; kernel 9's pass B (raft_ivf_pq_topk) is
//     the same payload radix select.
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
//     accumulation). The f32 body: the same sum regrouped per subspace,
//     t_s = sum_j qsub_s,j * book[c_s][j] (the table entry LUT[s][c_s] of
//     the reference's shared-memory LUT, ivf_pq_search.cuh:593) and ip =
//     sum_s t_s, in f32: the TPU computes that tier at HIGHEST, which one
//     bf16 pass would not match;
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
// 138.7M pair-rows x 128 at the 989 TFLOP/s bf16 rate, take 0.036 ms; the
// f32 body's least work, a table per pair and a pq_dim-term sum per (pair,
// row), is bound by bytes too, but the body it has does 4 FMAs and an add
// per (pair, row, subspace) on the CUDA cores: 22.2G fp32 operations, 0.66
// ms at 67 TFLOP/s. The first f32 body, pair-major (one block per (query,
// list) pair building the (pq_dim, n_codes) table in shared memory, then
// pq_dim random lookups per (pair, row) with bank conflicts), took 2.57 ms
// (kk = 512) and 2.74 (kk = 256, with pass B) per 128-query batch, and
// refused tables over 160 KB (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_smoke.py).
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

// The f32 body (the float32 LUT tier): pq_f32_kernel, list-major on the
// CUDA cores, one 256-thread block per (list, tile of up to kF32Slots table
// slots), lists longest first (the pre-pass of list_scan_tc.cuh). The block
// compacts the tile's valid slots into groups of kF32Group and computes
// their query terms once, then walks the list's bins in segments of up to
// kF32Bins; a thread scores 1, 2 or 4 rows (as the block holds 1, 2 or 4
// groups, so every thread works) of one bin against the 8 slots of its
// group. A segment's stripes (rows w * bins + b) go in tiles of at most
// kF32Rows rows and the features in steps of kF32K:
//  - decode: a tile row's codes are read a step ahead into registers, and
//    each (row, subspace) of a step is copied from its codebook entry (f32,
//    through L1) by cp.async into the shared decoded tile, a step ahead of
//    its products, so every slot group reads the row decoded once; qsub of
//    the step's features is staged beside it; one barrier a step;
//  - products: t = fmaf(qsub[s*pl + j], book[c_s][j], t) over ascending j
//    from 0, then ip = __fadd_rn(ip, t) over ascending s from 0: the
//    parent's table entry and its row sum, so every score is bit for bit the
//    first (pair-major) f32 body's (the table, summed per row, regrouped per
//    subspace); |qsub|^2 and the IP centre term in its reduction order (256
//    strided lanes, the xor tree, warps in order), a warp a slot;
//  - bins: a thread keeps its bin's (value, id) minimum per slot in shared
//    memory across the tiles, updated once a tile from the row ids and
//    norms the decoders staged (lexicographic, so order-free: ids are
//    unique in a list); the threads of a bin's other stripes fold in at the
//    end. Registers then hold the 8 x R sums and one subspace's operands:
//    128 a thread, two blocks an SM.
// Nothing holds a whole table, so any pq_dim and pq_bits run. pq_len 1, 2
// and 4 (with rot_dim a multiple of the step) take whole subspaces a step
// with vector copies; any other pq_len the generic path, feature by
// feature (forced at the served point, about 3x slower). The parts, timed
// by tools/ab_pq_f32.py --parts from edited copies of this source, are in
// PERF.md section 6: a per-step skeleton, the products, then the copies.
constexpr int kWarps = kThreads / 32;
constexpr int kF32Slots = 32;         // table slots a block
constexpr int kF32Group = 8;          // slots a thread
constexpr int kF32Rows = 256;         // rows a tile, at most
constexpr int kF32Bins = 64;          // bins a segment
constexpr int kF32K = 16;             // features a step (a multiple of 8)
static_assert(kF32Bins <= kThreads / 4, "a bin needs a thread a group");
static_assert(kF32Slots <= 32, "a warp compacts the slots");
static_assert(kF32K % 8 == 0 && kF32K * kF32Slots % kThreads == 0, "step");
// floats a decoded row: an odd number of 16-byte units, so 8 consecutive
// rows' 16-byte reads fall in 8 distinct bank groups
constexpr int kF32Pitch = kF32K + (kF32K / 4 % 2 == 0 ? 4 : 0);
// qsub elements a thread stages a step
constexpr int kF32Qs = kF32K * kF32Slots / kThreads;

struct F32Args {
  const float* q_rot;    // (nq, rot_dim)
  const float* centers;  // (n_lists, rot_dim)
  const float* books;    // (pq_dim or n_lists, n_codes, pq_len)
  const uint8_t* codes;  // (n_lists, max_list, pq_dim)
  const float* norms;    // (n_lists, max_list)
  const int* ids;        // (n_lists, max_list), -1 = pad
  const int* qmap;       // (n_lists, cap) query ids, -1 = empty slot
  const int* kp;         // fused: (nq, n_probes) sorted kept probes
  const int* extent;     // (n_lists) one past each list's last row
  const int* order;      // (n_lists) the lists, longest first
  int rot_dim, pq_dim, pq_len, n_codes, per_cluster;
  int max_list, bins, cap, tpl, nseg, n_probes;  // nseg: bin segments
  long long ncols;       // fused: candidate row width, n_probes * bins
  int metric_ip, round_out;
  float* out_d;
  int* out_i;
};

// dynamic shared memory (66 KB at 16 features a step)
struct __align__(16) F32Smem {
  float dec[2][kF32Rows * kF32Pitch];  // decoded rows, two steps
  float qs[2][kF32Slots * kF32K];      // qsub, slot-major, two steps
  int rid[2][kF32Rows];                // a tile's row ids (-1: pad), and
  float rnorm[2][kF32Rows];            // norms, two tiles
  float best_v[kF32Group][kThreads];   // a thread's bin minima per slot
  int best_i[kF32Group][kThreads];
  long long col[kF32Slots];            // a slot's output offset at bin 0
  float rr[kF32Slots], corr[kF32Slots];
  int q[kF32Slots];                    // compacted slots' queries, -1 past
  int n_valid;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(N)
               : "memory");
}

// N floats from 16-byte aligned (N = 4), 8-byte (2) or 4-byte (1) shared
// memory in one load
template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

// a step of a walk: its tile T and its feature slice ks of the tile's
// ks_n
struct F32Step {
  int T, ks;
  __device__ __forceinline__ F32Step next(int ks_n) const {
    return ks + 1 == ks_n ? F32Step{T + 1, 0} : F32Step{T, ks + 1};
  }
};

// The walk of a block with R slot groups (R rows a thread).
template <int PL, int R>
__device__ __forceinline__ void pq_f32_walk(const F32Args& a, F32Smem& sm,
                                            int l, int extent, int nw,
                                            int b0, int nb, int n_valid) {
  constexpr int P = kThreads / R;       // threads a slot group
  constexpr int SPS = PL > 0 ? kF32K / PL : 0;  // subspaces a step
  const int tid = threadIdx.x;
  const int g = tid / P, p = tid - g * P;
  const int H = P / nb;                 // a bin's row phases
  const int h = p / nb, b = p - h * nb;
  const int Wt = R * H;                 // stripes a tile
  const int Rt = Wt * nb;               // rows a tile
  const bool scorer = h < H && g * kF32Group < n_valid;
  const bool ip = a.metric_ip != 0;
  const bool fused = a.kp != nullptr;
  const int bins = a.bins, rot = a.rot_dim;
  const int pl = PL > 0 ? PL : a.pq_len;
  const int ks_n = (rot + kF32K - 1) / kF32K;
  const int steps = ((nw + Wt - 1) / Wt) * ks_n;
  const long long lbase = static_cast<long long>(l) * a.max_list;
  // decoding: tile row tid (stripe dw of the tile, bin b0 + db)
  const int dw = tid / nb, db = tid - dw * nb;
  const bool decoder = tid < Rt;
  const float* cl = a.centers + static_cast<long long>(l) * rot;

  // the decoded row of a step's tile (-1: none)
  auto dec_row = [&](F32Step st) -> int {
    const int r = (st.T * Wt + dw) * bins + b0 + db;
    return decoder && r < extent ? r : -1;
  };
  // fast path: the step's codes (kF32K / PL bytes) of the decoded row
  auto fetch = [&](F32Step st) -> uint4 {
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (PL > 0) {
      const int r = dec_row(st);
      if (r >= 0) {
        const uint8_t* pc = a.codes + (lbase + r) * a.pq_dim + st.ks * SPS;
        // past L1 (ld.global.cg), which keeps the codebooks
        if constexpr (SPS == 16) {
          c = __ldcg(reinterpret_cast<const uint4*>(pc));
        } else if constexpr (SPS == 8) {
          const uint2 v = __ldcg(reinterpret_cast<const uint2*>(pc));
          c.x = v.x;
          c.y = v.y;
        } else if constexpr (SPS == 4) {
          c.x = __ldcg(reinterpret_cast<const unsigned int*>(pc));
        } else if constexpr (SPS == 2) {
          c.x = __ldcg(reinterpret_cast<const unsigned short*>(pc));
        }
      }
    }
    return c;
  };
  // a step's rows decoded into dec[its parity] (pad rows left as they
  // are); at a tile's first step its rows' ids and norms too
  auto issue = [&](F32Step st, int par, uint4 c) {
    const int r = dec_row(st);
    if (st.ks == 0 && decoder) {
      if (r >= 0) {
        cp_async<4>(&sm.rid[st.T & 1][tid], a.ids + lbase + r);
        cp_async<4>(&sm.rnorm[st.T & 1][tid], a.norms + lbase + r);
      } else {
        sm.rid[st.T & 1][tid] = -1;
      }
    }
    if (r < 0) return;
    float* dst = sm.dec[par] + tid * kF32Pitch;
    if constexpr (PL > 0) {
      const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int u = 0; u < SPS; ++u) {
        const int sub = st.ks * SPS + u;
        const int code = (w[u >> 2] >> (8 * (u & 3))) & 0xff;
        const float* src =
            a.books + (static_cast<long long>(a.per_cluster ? l : sub) *
                           a.n_codes + code) * PL;
        cp_async<4 * PL>(dst + u * PL, src);
      }
    } else {
      const uint8_t* pc = a.codes + (lbase + r) * a.pq_dim;
#pragma unroll
      for (int kk = 0; kk < kF32K; ++kk) {
        const int k = st.ks * kF32K + kk;
        if (k < rot) {
          const int sub = k / pl;
          const int code = __ldg(pc + sub);
          cp_async<4>(dst + kk,
                      a.books + (static_cast<long long>(
                                     a.per_cluster ? l : sub) * a.n_codes +
                                 code) * pl + (k - sub * pl));
        }
      }
    }
  };
  // a step's qsub elements of this thread (slot e / kF32K, feature e %
  // kF32K of the step, e = tid + j * kThreads)
  auto load_q = [&](F32Step st, float (&x)[kF32Qs]) {
#pragma unroll
    for (int j = 0; j < kF32Qs; ++j) {
      const int e = tid + j * kThreads;
      const int q = sm.q[e / kF32K];
      const int k = st.ks * kF32K + e % kF32K;
      x[j] = 0.f;
      if (q >= 0 && k < rot) {
        const float v = a.q_rot[static_cast<long long>(q) * rot + k];
        x[j] = ip ? v : v - cl[k];
      }
    }
  };
  auto put_q = [&](int par, const float (&x)[kF32Qs]) {
#pragma unroll
    for (int j = 0; j < kF32Qs; ++j) sm.qs[par][tid + j * kThreads] = x[j];
  };

  float acc[R][kF32Group], tt[PL > 0 ? 1 : R][kF32Group];
#pragma unroll
  for (int s = 0; s < kF32Group; ++s) {
    sm.best_v[s][tid] = CUDART_INF_F;
    sm.best_i[s][tid] = INT_MAX;
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i][s] = 0.f;
#pragma unroll
    for (int i = 0; i < (PL > 0 ? 1 : R); ++i) tt[i][s] = 0.f;
  }

  // prologue: step 0 decoded and staged, step 1's codes and qsub loading
  F32Step cur{0, 0};
  float qx[kF32Qs];
  uint4 cn = fetch(cur);
  issue(cur, 0, cn);
  load_q(cur, qx);
  put_q(0, qx);
  if (steps > 1) {
    cn = fetch(cur.next(ks_n));
    load_q(cur.next(ks_n), qx);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    const int T = cur.T, ks = cur.ks;
    const F32Step s1 = cur.next(ks_n);  // the next step
    if (t + 1 < steps) {
      issue(s1, buf ^ 1, cn);
      put_q(buf ^ 1, qx);
      if (t + 2 < steps) {
        cn = fetch(s1.next(ks_n));
        load_q(s1.next(ks_n), qx);
      }
    }
    const int w0 = T * Wt + R * h;      // the thread's first stripe
    if (scorer && w0 < nw) {
      const float* dq = sm.qs[buf] + g * kF32Group * kF32K;
      const float* dr = sm.dec[buf] + (R * h * nb + b) * kF32Pitch;
      if constexpr (PL > 0) {
        // unrolled (faster at the served pq_len 4), but not at pq_len
        // 1: its 16 subspaces a step, unrolled, spill past 128 registers
#pragma unroll(PL <= 1 ? 1 : SPS)
        for (int u = 0; u < SPS; ++u) {
          float rv[R][PL];
#pragma unroll
          for (int i = 0; i < R; ++i)
            load_vec<PL>(rv[i], dr + i * nb * kF32Pitch + u * PL);
#pragma unroll
          for (int s = 0; s < kF32Group; ++s) {
            float qv[PL];
            load_vec<PL>(qv, dq + s * kF32K + u * PL);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              float e = 0.f;
#pragma unroll
              for (int j = 0; j < PL; ++j) e = fmaf(qv[j], rv[i][j], e);
              acc[i][s] = __fadd_rn(acc[i][s], e);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kF32K; ++kk) {
          const int k = ks * kF32K + kk;
          if (k < rot) {
            float rv[R];
#pragma unroll
            for (int i = 0; i < R; ++i) rv[i] = dr[i * nb * kF32Pitch + kk];
#pragma unroll
            for (int s = 0; s < kF32Group; ++s) {
              const float qv = dq[s * kF32K + kk];
#pragma unroll
              for (int i = 0; i < R; ++i) tt[i][s] = fmaf(qv, rv[i], tt[i][s]);
            }
            if ((k + 1) % pl == 0) {  // the subspace's last feature
#pragma unroll
              for (int i = 0; i < R; ++i)
#pragma unroll
                for (int s = 0; s < kF32Group; ++s) {
                  acc[i][s] = __fadd_rn(acc[i][s], tt[i][s]);
                  tt[i][s] = 0.f;
                }
            }
          }
        }
      }
    }
    if (ks == ks_n - 1 && scorer && w0 < nw) {
      // the tile's scores into the bins' running minima
      int rid[R];
      float rn[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        rid[i] = sm.rid[T & 1][(R * h + i) * nb + b];
        rn[i] = sm.rnorm[T & 1][(R * h + i) * nb + b];
      }
#pragma unroll
      for (int s = 0; s < kF32Group; ++s) {
        const int slot = g * kF32Group + s;
        const float rr = sm.rr[slot];
        float bv = sm.best_v[s][tid];
        int bi = sm.best_i[s][tid];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float x = acc[i][s];
          acc[i][s] = 0.f;
          if (slot >= n_valid || rid[i] < 0) continue;
          const float dist =
              ip ? -x : fmaxf(fmaf(-2.0f, x, __fadd_rn(rr, rn[i])), 0.f);
          if (dist < bv || (dist == bv && rid[i] < bi)) {
            bv = dist;
            bi = rid[i];
          }
        }
        sm.best_v[s][tid] = bv;
        sm.best_i[s][tid] = bi;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    cur = s1;
  }

  // a bin's other row phases (threads tid + hh nb) fold into phase 0 (the
  // last step's barrier published their minima)
  if (scorer && h == 0) {
#pragma unroll
    for (int s = 0; s < kF32Group; ++s) {
      const int slot = g * kF32Group + s;
      if (slot >= n_valid) continue;
      float v = sm.best_v[s][tid];
      int id = sm.best_i[s][tid];
      for (int hh = 1; hh < H; ++hh) {
        const float ov = sm.best_v[s][tid + hh * nb];
        const int oi = sm.best_i[s][tid + hh * nb];
        if (ov < v || (ov == v && oi < id)) {
          v = ov;
          id = oi;
        }
      }
      if (id == INT_MAX) id = -1;
      if (fused && ip) v -= sm.corr[slot];  // +inf stays +inf
      if (a.round_out) v = round_bf16(v);
      const long long at = sm.col[slot] + b0 + b;
      a.out_d[at] = v;
      a.out_i[at] = id;
    }
  }
}

template <int PL>
__global__ __launch_bounds__(kThreads, 2) void pq_f32_kernel(F32Args a) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  F32Smem& sm = *reinterpret_cast<F32Smem*>(f32_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x % a.tpl;
  const int l = a.order[blockIdx.x / a.tpl];
  const int s0 = tile * kF32Slots;
  const int ns = min(kF32Slots, a.cap - s0);
  const int* qm = a.qmap + static_cast<long long>(l) * a.cap + s0;
  const bool fused = a.kp != nullptr;
  const bool ip = a.metric_ip != 0;

  // the tile's valid slots, compacted in slot order, with their output
  // offsets at bin 0: unfused (list, slot, bin); fused the query's
  // candidate row at the list's rank among its kept probes (= its probe
  // position p)
  if (warp == 0) {
    const int q = lane < ns ? qm[lane] : -1;
    const unsigned bal = __ballot_sync(0xffffffffu, q >= 0);
    if (q >= 0) {
      const int pos = __popc(bal & ((1u << lane) - 1u));
      sm.q[pos] = q;
      long long col;
      if (fused) {
        int rank = 0;
        const int* kr = a.kp + static_cast<long long>(q) * a.n_probes;
#pragma unroll 8
        for (int pp = 0; pp < a.n_probes; ++pp) rank += kr[pp] < l;
        col = q * a.ncols + static_cast<long long>(rank) * a.bins;
      } else {
        col = (static_cast<long long>(l) * a.cap + s0 + lane) * a.bins;
      }
      sm.col[pos] = col;
    }
    if (lane < kF32Slots && lane >= __popc(bal)) sm.q[lane] = -1;
    if (lane == 0) sm.n_valid = __popc(bal);
  }
  if (!fused) {  // unfused: empty slots are (+inf, -1) over the bins
    const long long base = (static_cast<long long>(l) * a.cap + s0) * a.bins;
    for (long long e = tid; e < static_cast<long long>(ns) * a.bins;
         e += kThreads) {
      if (qm[e / a.bins] < 0) {
        a.out_d[base + e] = CUDART_INF_F;
        a.out_i[base + e] = -1;
      }
    }
  }
  __syncthreads();
  const int n_valid = sm.n_valid;
  if (n_valid == 0) return;  // block-uniform
  const int extent = a.extent[l];

  // |qsub|^2 and the IP centre term of each slot, a warp a slot, in the
  // first f32 body's order: thread j % 256 of 256 sums features j, j +
  // 256, ... by fmaf; the xor tree in each warp; the eight warps in order
  const float* cl = a.centers + static_cast<long long>(l) * a.rot_dim;
  for (int s = warp; s < n_valid; s += kWarps) {
    const float* qp = a.q_rot + static_cast<long long>(sm.q[s]) * a.rot_dim;
    float p_sq[kWarps], p_c[kWarps];
#pragma unroll
    for (int v = 0; v < kWarps; ++v) p_sq[v] = p_c[v] = 0.f;
    for (int j0 = 0; j0 < a.rot_dim; j0 += kThreads) {
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int j = j0 + 32 * v + lane;
        if (j < a.rot_dim) {
          const float x = qp[j], c = cl[j];
          const float d = ip ? x : x - c;
          p_sq[v] = fmaf(d, d, p_sq[v]);
          p_c[v] = fmaf(d, c, p_c[v]);
        }
      }
    }
    float rr = 0.f, corr = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        p_sq[v] += __shfl_xor_sync(0xffffffffu, p_sq[v], o);
        p_c[v] += __shfl_xor_sync(0xffffffffu, p_c[v], o);
      }
      rr += p_sq[v];
      corr += p_c[v];
    }
    if (lane == 0) {
      sm.rr[s] = rr;
      sm.corr[s] = corr;
    }
  }

  const int groups = (n_valid + kF32Group - 1) / kF32Group;
  for (int seg = 0; seg < a.nseg; ++seg) {
    const int b0 = seg * kF32Bins;
    const int nb = min(kF32Bins, a.bins - b0);
    // stripes holding a row of the segment below the extent
    const int nw = extent > b0 ? (extent - b0 + a.bins - 1) / a.bins : 0;
    if (nw == 0) {  // no row: unfused bins (+inf, -1), fused the +inf fill
      if (!fused)
        for (int e = tid; e < n_valid * nb; e += kThreads) {
          const long long at = sm.col[e / nb] + b0 + e % nb;
          a.out_d[at] = CUDART_INF_F;
          a.out_i[at] = -1;
        }
      continue;
    }
    // (the walk's prologue barrier publishes rr and corr, and the one
    // after it frees the minima for the next segment)
    if (groups == 1)
      pq_f32_walk<PL, 1>(a, sm, l, extent, nw, b0, nb, n_valid);
    else if (groups == 2)
      pq_f32_walk<PL, 2>(a, sm, l, extent, nw, b0, nb, n_valid);
    else
      pq_f32_walk<PL, kF32Slots / kF32Group>(a, sm, l, extent, nw, b0, nb,
                                             n_valid);
    __syncthreads();
  }
}

// The pre-pass (extents, lists longest first) into lists_scratch, then the
// f32 body over every (list, slot tile, bin segment). pq_len 1, 2 and 4 with
// rot_dim % 8 == 0 and aligned codes and books take the vector path.
int launch_pq_f32(F32Args a, int n_lists, int* lists_scratch,
                  cudaStream_t s) {
  if (n_lists == 0) return 0;
  list_extent_kernel<<<n_lists, 256, 0, s>>>(a.ids, a.max_list,
                                             lists_scratch);
  list_order_kernel<<<1, 256, 0, s>>>(lists_scratch, n_lists, a.max_list,
                                      lists_scratch + n_lists);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  a.extent = lists_scratch;
  a.order = lists_scratch + n_lists;
  a.tpl = (a.cap + kF32Slots - 1) / kF32Slots;
  a.nseg = (a.bins + kF32Bins - 1) / kF32Bins;
  const long long blocks = static_cast<long long>(n_lists) * a.tpl;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = a.rot_dim % kF32K == 0 &&
                   reinterpret_cast<uintptr_t>(a.codes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.books) % 16 == 0;
  const int sps = kF32K / a.pq_len;  // 2 to 16 code bytes a step
  const int pl = vec && sps >= 2 && sps <= 16 ? a.pq_len : 0;
  auto kernel = pl == 4   ? pq_f32_kernel<4>
                : pl == 2 ? pq_f32_kernel<2>
                : pl == 1 ? pq_f32_kernel<1>
                          : pq_f32_kernel<0>;
  constexpr int smem = sizeof(F32Smem);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int f32_args(F32Args& a, const float* q_rot, int rot_dim, const int* qmap,
             int cap, const float* centers_rot, const float* books,
             const unsigned char* codes, int pq_dim, int pq_len, int n_codes,
             int per_cluster, const float* norms, const int* ids,
             int max_list, int bins, int metric_ip) {
  if (bins < 1 || cap < 1 || rot_dim < 1 || pq_len < 1 || max_list < 0 ||
      pq_dim * pq_len != rot_dim || n_codes < 1 || n_codes > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  a = F32Args{};
  a.q_rot = q_rot;
  a.centers = centers_rot;
  a.books = books;
  a.codes = reinterpret_cast<const uint8_t*>(codes);
  a.norms = norms;
  a.ids = ids;
  a.qmap = qmap;
  a.rot_dim = rot_dim;
  a.pq_dim = pq_dim;
  a.pq_len = pq_len;
  a.n_codes = n_codes;
  a.per_cluster = per_cluster;
  a.max_list = max_list;
  a.bins = bins;
  a.cap = cap;
  a.metric_ip = metric_ip;
  return 0;
}

}  // namespace
}  // namespace raft_tpu_torch

// Kernel 8's f32 body: q_rot (nq, rot_dim) and centers_rot (n_lists,
// rot_dim) f32; qmap (n_lists, cap) query ids (-1 = empty slot); books
// (pq_dim, or n_lists when per_cluster, n_codes, pq_len) f32; codes
// (n_lists, max_list, pq_dim) u8; norms/ids (n_lists, max_list); out_d/out_i
// (n_lists, cap, bins), rounded to bf16 when round_out; lists_scratch 2 x
// n_lists ints. No IP centre term.
extern "C" int raft_ivf_pq_scan_f32(
    const float* q_rot, int rot_dim, const int* qmap, int n_lists, int cap,
    const float* centers_rot, const float* books, const unsigned char* codes,
    int pq_dim, int pq_len, int n_codes, int per_cluster, const float* norms,
    const int* ids, int max_list, int bins, int metric_ip, int round_out,
    float* out_d, int* out_i, int* lists_scratch, void* stream) {
  raft_tpu_torch::F32Args a;
  const int rc = raft_tpu_torch::f32_args(
      a, q_rot, rot_dim, qmap, cap, centers_rot, books, codes, pq_dim, pq_len,
      n_codes, per_cluster, norms, ids, max_list, bins, metric_ip);
  if (rc != 0) return rc;
  a.round_out = round_out;
  a.out_d = out_d;
  a.out_i = out_i;
  return raft_tpu_torch::launch_pq_f32(a, n_lists, lists_scratch,
                                       static_cast<cudaStream_t>(stream));
}

// Kernel 9's f32 body, pass A: the same inputs, kp (nq, n_probes) each
// query's kept probed lists sorted ascending (-1 = dropped); cand_d/cand_i
// (nq, n_probes * bins) filled with +inf, then each kept pair's bin minima
// at its probe position, the IP centre term subtracted. Pass B is
// raft_ivf_pq_topk.
extern "C" int raft_ivf_pq_scan_f32_fused(
    const float* q_rot, int rot_dim, const int* qmap, int n_lists, int cap,
    const int* kp, int n_probes, int nq, const float* centers_rot,
    const float* books, const unsigned char* codes, int pq_dim, int pq_len,
    int n_codes, int per_cluster, const float* norms, const int* ids,
    int max_list, int bins, int metric_ip, float* cand_d, int* cand_i,
    int* lists_scratch, void* stream) {
  raft_tpu_torch::F32Args a;
  const int rc = raft_tpu_torch::f32_args(
      a, q_rot, rot_dim, qmap, cap, centers_rot, books, codes, pq_dim, pq_len,
      n_codes, per_cluster, norms, ids, max_list, bins, metric_ip);
  if (rc != 0 || n_probes < 1 || nq < 0)
    return rc != 0 ? rc : static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  a.kp = kp;
  a.n_probes = n_probes;
  a.ncols = static_cast<long long>(n_probes) * bins;
  a.out_d = cand_d;
  a.out_i = cand_i;
  raft_tpu_torch::fill_inf_kernel<<<1024, 256, 0, s>>>(cand_d,
                                                       a.ncols * nq);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return raft_tpu_torch::launch_pq_f32(a, n_lists, lists_scratch, s);
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
