// The list-major pass A on the tensor cores, shared by ivf_flat_scan.cu
// (kernels 3 and 4: f32 lists at bf16x3, bf16 and int8 lists at one bf16
// pass), ivf_bq_scan.cu (kernels 10 and 11, 1-bit sign codes, one bf16
// pass) and ivf_pq_scan.cu (kernels 8 and 9, u8 PQ codes decoded to bf16
// codebook values, one bf16 pass): one block per (list, tile of up to 64 of
// the table slots that probe it), each probed list read once per query
// tile. A policy R says what a list row is (see FlatRows, Bf16Rows and
// Int8Rows in ivf_flat_scan.cu, BqRows in ivf_bq_scan.cu and PqRows in
// ivf_pq_scan.cu; RowsBase, ResidualQueries and NormScore below hold what
// they share):
//   * R::kPasses: 3 (bf16x3: hi.lo + lo.hi + hi.hi) or 1 (hi.hi);
//   * R::kMinBlocks: the blocks an SM should hold (the register budget);
//   * R::kCentreTerm: whether the written bin minima subtract a per (query,
//     list) term (IVF-BQ's IP centre term, applied after the minimum: it is
//     constant per slot, and subtracting first could make new ties);
//   * R::put_queries<IP>(a, row_q, l, k0, hi, lo): the A rows' features
//     [k0, k0 + 64) (zeros for row -1) into the A tiles, a unit of 8 at a
//     time (put_unit());
//     R::query_terms<IP>(a, q, l, qq, corr): an A row's |q|^2 (of the
//     unrounded rows) and its centre term;
//   * R::extra_smem(a) bytes of shared memory the policy keeps beside the
//     tiles (at `ext`, 16-byte aligned), filled by R::setup(a, l, ext) once
//     a block has rows to score;
//   * R::RowSlice, R::fetch_rows(f, a, lbase, r0, rlim, k0) and
//     R::put_rows(f, a, ext, hi, lo): a B tile slice from registers into
//     the swizzled layout the wgmma descriptors read (zeros past rlim and
//     d);
//   * R::stage<IP>(a, i, sa, sb) the terms of real row i of the lists, and
//     R::score<IP>(acc, sa, sb, qq) its score; a pad row is staged as (sa,
//     sb) = (+inf, 0), which every score maps to +inf.
//
// Contract (both storages): row r of a list goes to the strided bin r %
// bins; a bin's candidate is its minimum, ties to the smallest id; an empty
// bin is (+inf, -1); pad rows (id < 0, or past the list) never enter.
//   * fused (kernels 3 and 11): the binned candidates of query q's pair with
//     list l go to column rank * bins + b of q's candidate row, rank being
//     l's position among q's kept probes in ascending order; a (query,
//     probe) pair whose table slot is >= cap is skipped (the TPU kernel's
//     drop rule); columns no tile writes keep the caller's +inf fill; then
//     pass B, the payload radix select of radix_select.cuh, keeps per query
//     the k smallest under (score, column = (list id, bin)), the TPU's
//     list-ascending merge;
//   * unfused (kernels 4, 8 and 10): cap-major blocks (list, slot, bin); an
//     empty slot (qmap -1) and bins past the list's extent are (+inf, -1);
//     scores f32, bf16 (out_bf16) or f32 rounded to bf16 (round_out).
//
// Design: a pre-pass finds each list's extent (one past its last row with
// an id) and orders the lists longest first (a counting sort on 64
// buckets), so the longest lists start in the first wave. The block
// compacts the tile's scored slots into the 64 A rows (the wgmma M side)
// and keeps them as resident bf16 tiles when d <= 256 (four 64-feature
// slices), otherwise streams them with the rows. It walks the list's rows
// up to its extent once, as 128-row B tiles in 64-feature slices, in a
// two-stage ring: step t + 1's slice is stored while step t's products
// run, and step t + 2's loaded into registers behind them. The two
// warpgroups share the A rows and split each tile: warpgroup w multiplies
// its columns [64 w, 64 w + 64) (wgmma m64n64k16), so both issue products
// and each scores half of the tile (the epilogue, not the products, sets
// the pace at the served shapes). Tiles follow the strided bins, so the
// epilogue needs no shuffle:
//   * STRIPE (G = 0: bins >= 128, exact bins, any bins not a power of two):
//     tile (chunk c, stripe w) holds rows w * bins + 128 c + j, so column j
//     is bin 128 c + j; each thread keeps the running minimum of its 32
//     accumulator elements and the stripe it came from (16 bits) across the
//     chunk's stripes and writes the chunk's bins after its last stripe (an
//     id is read back from the stripe; a tie reads the older id, off the
//     hot loop);
//   * FOLD (G = bins / 8, 1 for bins < 8: bins a power of two <= 64): tiles
//     are 128 consecutive rows, so column j is bin j % bins; the thread's
//     8-column groups fold into group n8 % G in registers, warpgroup 1's
//     candidates into warpgroup 0's through shared memory, bins < 8 by two
//     quad shuffles at the end.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "radix_select.cuh"
#include "wgmma_bf16x3.cuh"

namespace raft_tpu_torch {
namespace {

using namespace tc;

// candidates of one fused launch: bounds the caller's buffer
constexpr long long kListMaxCand = 1ll << 28;
// query slices kept resident: four (d <= 256) fit beside the row ring at 3
// passes (hi and lo tiles); above, the queries stream with the rows
constexpr int kListResident = 4;
// table slots (A rows) a block scores: the two warpgroups share them and
// split each 128-row tile of the list (64 columns each)
constexpr int kListM = 64;

struct ListArgs {
  const float* queries;  // (nq, d): the queries (IVF-BQ: rotated)
  const int* qmap;       // (n_lists, cap) query ids, -1 = empty slot
  int cap, tpl;          // tpl: kListM-slot tiles per list
  int q_begin, q_end;    // only queries in [q_begin, q_end) are scored
  const int* ids;        // (n_lists, max_list), -1 = pad
  int max_list, d, bins;
  const int* extent;     // (n_lists) one past each list's last row
  const int* order;      // (n_lists) the lists, longest first
  const int* kp;         // fused: (nq, n_probes) sorted kept probes
  int n_probes;
  long long ncols;       // fused: candidate row width, n_probes * bins
  void* out_d;           // f32, or bf16 when out_bf16
  int* out_i;
  int out_bf16;
  int round_out;         // f32 scores rounded to bf16 (to nearest)
  // IVF-Flat lists, in one of three storages (data, data_bf16, data_i8)
  const float* data;     // (n_lists, max_list, d) f32
  const __nv_bfloat16* data_bf16;  // (n_lists, max_list, d) bf16
  const int8_t* data_i8;           // (n_lists, max_list, d) int8
  float scale;           // int8: a row's value is its code times scale
  const float* norms;    // (n_lists, max_list)
  int vec4;              // 16-byte loads of the queries (and f32 data)
  int vec_rows;          // 16-byte loads of bf16 / int8 rows
  // IVF-BQ and IVF-PQ lists: residuals against the rotated centres
  const float* centers;  // (n_lists, d) rotated centres
  int center_term;       // fused IP: subtract qsub . centre (R::kCentreTerm)
  // IVF-BQ lists
  const uint32_t* bits;  // (n_lists, max_list, words) sign bits
  const float* norms2;   // (n_lists, max_list)
  const float* scales;   // (n_lists, max_list)
  int words;
  // IVF-PQ lists (norms: the code norms)
  const uint8_t* codes;  // (n_lists, max_list, pq_dim)
  const __nv_bfloat16* books;  // (pq_dim or n_lists, n_codes, pq_len)
  int pq_dim, pq_len, n_codes, per_cluster;
  int book_res;          // the books staged in shared memory (else via L1)
};

// Shared memory (bytes, from a 1024-aligned base): query hi tiles [qt],
// query lo tiles [qt] (3 passes), row hi tiles [2], row lo tiles [2] (3
// passes), the row stage (sa, sb, id) [2][kBN], then per A row its output
// offset, query, |q|^2 and centre term, 16 words of scratch, and the
// policy's own R::extra_smem(a) bytes. qt is the number of slices
// (resident queries) or 2 (a ring with the rows).
template <class R>
__host__ __device__ inline size_t list_tiles_bytes(int ks) {
  const size_t planes = R::kPasses == 3 ? 2 : 1;
  const size_t qt = ks <= kListResident ? ks : 2;
  return 1024 + planes * (qt + 2) * kTile + 2 * kBN * 12 + kBM * 20 + 64;
}

// What every policy may leave out: no shared memory of its own, no setup.
struct RowsBase {
  __host__ __device__ static size_t extra_smem(const ListArgs&) { return 0; }
  __device__ static void setup(const ListArgs&, int, unsigned char*) {}
};

// A rows that are residuals of rotated queries (IVF-BQ, IVF-PQ): qsub =
// q_rot[q] (IP) or q_rot[q] - centers[l] (L2), in f32; the A tiles hold it
// rounded to bf16 (round to nearest), |qsub|^2 and the IP centre term
// qsub . centers[l] come from the unrounded values.
struct ResidualQueries : RowsBase {
  // qsub's features [k0, k0 + 64) of the A rows (zeros for row -1 and past
  // d), rounded to bf16 by put_unit<1>
  template <bool IP>
  __device__ static void put_queries(const ListArgs& a, const int* row_q,
                                     int l, int k0, unsigned char* hi,
                                     unsigned char* lo) {
    const float* c = a.centers + static_cast<long long>(l) * a.d;
#pragma unroll
    for (int s = 0; s < kUnits; ++s) {
      const int u = threadIdx.x + s * kThreads;
      const int row = row_q[u >> 3];
      const int kk = k0 + 8 * (u & 7);
      const float* p =
          a.queries + static_cast<long long>(row < 0 ? 0 : row) * a.d;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = kk + e;
        v[e] = (row >= 0 && j < a.d) ? (IP ? p[j] : p[j] - c[j]) : 0.f;
      }
      put_unit<1>(v, u, hi, lo);
    }
  }
  template <bool IP>
  __device__ static void query_terms(const ListArgs& a, int q, int l,
                                     float& qq, float& corr) {
    const float* p = a.queries + static_cast<long long>(q) * a.d;
    const float* c = a.centers + static_cast<long long>(l) * a.d;
    qq = 0.f;
    corr = 0.f;
#pragma unroll 8
    for (int j = 0; j < a.d; ++j) {
      const float s = IP ? p[j] : p[j] - c[j];
      qq = fmaf(s, s, qq);
      corr = fmaf(s, c[j], corr);
    }
    if (!(IP && a.center_term)) corr = 0.f;
  }
};

// The row term is a norm (IVF-Flat's row norms, IVF-PQ's code norms):
// L2 max((norm + |q|^2) - 2 acc, 0) with one rounding of the difference,
// as the plain versions' (2 acc is exact), IP -acc; pads (sa = +inf) stay
// +inf.
struct NormScore {
  template <bool IP>
  __device__ static void stage(const ListArgs& a, long long i, float& sa,
                               float& sb) {
    sa = IP ? 0.f : a.norms[i];
    sb = 0.f;
  }
  template <bool IP>
  __device__ static float score(float acc, float sa, float, float qq) {
    return IP ? (sa == 0.f ? -acc : CUDART_INF_F)
              : fmaxf(fmaf(-2.0f, acc, sa + qq), 0.f);
  }
};

template <class R>
__host__ __device__ inline size_t list_smem_bytes(const ListArgs& a) {
  return list_tiles_bytes<R>((a.d + kBK - 1) / kBK) + R::extra_smem(a);
}

struct ListCand {
  float v;
  int id;
};

// the better of two candidates: smaller value, then smaller id
__device__ __forceinline__ ListCand better(ListCand a, ListCand b) {
  return (b.v < a.v || (b.v == a.v && b.id < a.id)) ? b : a;
}

__device__ __forceinline__ ListCand shfl_xor(ListCand c, int mask) {
  return {__shfl_xor_sync(0xffffffffu, c.v, mask),
          __shfl_xor_sync(0xffffffffu, c.id, mask)};
}

__device__ __forceinline__ void put_out(const ListArgs& a, long long at,
                                        float v, int id) {
  if (a.round_out) v = __bfloat162float(__float2bfloat16_rn(v));
  if (a.out_bf16)
    static_cast<__nv_bfloat16*>(a.out_d)[at] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(a.out_d)[at] = v;
  a.out_i[at] = v == CUDART_INF_F ? -1 : id;
}

// The blocks an SM holds: R's, but one at G = 8 (its 32 candidates a
// thread do not fit the register budget of two), and one at G = 4 when R's
// row slice takes more than 8 registers (Bf16Rows' 16 spilled there)
template <class R, int G>
constexpr int list_min_blocks() {
  return G == 8 || (G == 4 && sizeof(typename R::RowSlice) > 32)
             ? 1
             : R::kMinBlocks;
}

// G = 0: STRIPE; G = bins / 8 (1 for bins < 8): FOLD (see the note).
template <class R, int G, bool IP>
__global__ __launch_bounds__(kThreads, (list_min_blocks<R, G>())) void
    list_scan_tc_kernel(ListArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + ((1024 - (raw_s & 1023)) & 1023);
  const uint32_t base_s = static_cast<uint32_t>(__cvta_generic_to_shared(base));

  constexpr int kPlanes = R::kPasses == 3 ? 2 : 1;
  const int d = a.d, bins = a.bins;
  const int ks_n = (d + kBK - 1) / kBK;
  const bool qres = ks_n <= kListResident;
  const int qt = qres ? ks_n : 2;
  const int q_hi = 0, q_lo = qt * kTile;
  const int y_hi = kPlanes * qt * kTile, y_lo = y_hi + 2 * kTile;
  float* st_a = reinterpret_cast<float*>(base + kPlanes * (qt + 2) * kTile);
  float* st_b = st_a + 2 * kBN;
  int* st_i = reinterpret_cast<int*>(st_b + 2 * kBN);
  long long* row_col = reinterpret_cast<long long*>(st_i + 2 * kBN);
  int* row_q = reinterpret_cast<int*>(row_col + kBM);
  float* row_qq = reinterpret_cast<float*>(row_q + kBM);
  float* row_corr = row_qq + kBM;
  int* scratch = reinterpret_cast<int*>(row_corr + kBM);
  unsigned char* ext = reinterpret_cast<unsigned char*>(scratch + 16);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane & 3, wg = tid >> 7;
  const int l = a.order[blockIdx.x / a.tpl];
  const int s0 = (blockIdx.x % a.tpl) * kListM;
  const int ns = min(kListM, a.cap - s0);
  const int* qm = a.qmap + static_cast<long long>(l) * a.cap + s0;
  const long long lbase = static_cast<long long>(l) * a.max_list;
  const bool fused = a.kp != nullptr;

  // the tile's scored slots, compacted in slot order into the A rows
  const int q = tid < ns ? qm[tid] : -1;
  const bool valid = q >= a.q_begin && q < a.q_end;
  const unsigned bal = __ballot_sync(0xffffffffu, valid);
  if (lane == 0 && warp < 2) scratch[warp] = __popc(bal);
  __syncthreads();
  const int before = warp == 1 ? scratch[0] : 0;
  const int n_valid = scratch[0] + scratch[1];
  if (valid) {
    const int pos = before + __popc(bal & ((1u << lane) - 1));
    row_q[pos] = q;
    float qq, corr;
    R::template query_terms<IP>(a, q, l, qq, corr);
    row_qq[pos] = qq;
    row_corr[pos] = corr;
    if (fused) {
      int rank = 0;
      const int* kr = a.kp + static_cast<long long>(q) * a.n_probes;
#pragma unroll 8
      for (int p = 0; p < a.n_probes; ++p) rank += kr[p] < l;
      row_col[pos] = (q - a.q_begin) * a.ncols +
                     static_cast<long long>(rank) * bins;
    } else {
      row_col[pos] = (static_cast<long long>(l) * a.cap + s0 + tid) * bins;
    }
  }
  // A rows past the scored ones (up to the 128 of a staged tile) are zero
  if (tid < kBM && tid >= n_valid) {
    row_q[tid] = -1;
    row_qq[tid] = 0.f;
  }
  if (!fused) {  // unfused: empty slots are all (+inf, -1)
    for (int s = 0; s < ns; ++s) {
      if (qm[s] >= 0) continue;
      const long long at = (static_cast<long long>(l) * a.cap + s0 + s) * bins;
      for (int b = tid; b < bins; b += kThreads) put_out(a, at + b,
                                                         CUDART_INF_F, -1);
    }
  }
  if (n_valid == 0) return;  // block-uniform
  R::setup(a, l, ext);
  __syncthreads();
  const int extent = a.extent[l];

  // tiles: STRIPE (chunk c, stripe w) -> rows w * bins + 128 c + [0, bc);
  // FOLD tile T -> rows 128 T + [0, 128); rows >= extent read as pads
  const int n_ch = G == 0 ? (min(bins, extent) + kBN - 1) / kBN : 1;
  const int nw = G == 0 ? (extent + bins - 1) / bins : (extent + kBN - 1) / kBN;
  const int n_tiles = extent > 0 ? n_ch * nw : 0;
  const int steps = n_tiles * ks_n;
  auto tile_rows = [&](int T, int& r0, int& rlim) {
    if (G == 0) {
      const int c = T / nw, w = T - c * nw;
      r0 = w * bins + c * kBN;
      rlim = min(extent, r0 + min(kBN, bins - c * kBN));
    } else {
      r0 = T * kBN;
      rlim = extent;
    }
  };
  // a row's stage: R's terms, (+inf, 0) for pads and rows past rlim. The
  // id and the terms are loaded together and the pad chosen after, so the
  // prefetch issues them at once (a branch on the id would wait for it)
  auto stage_of = [&](int r0, int rlim, float& sa, float& sb, int& si) {
    const int r = r0 + tid;
    si = -1;
    sa = CUDART_INF_F;
    sb = 0.f;
    if (r < rlim) {
      float ta, tb;
      R::template stage<IP>(a, lbase + r, ta, tb);
      si = a.ids[lbase + r];
      sa = si >= 0 ? ta : CUDART_INF_F;
      sb = si >= 0 ? tb : 0.f;
      si = si >= 0 ? si : -1;
    }
  };

  // the fragment's two A rows (of the 64) and this warpgroup's 64 columns
  // of each 128-row tile
  const int rbase = ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int cw = wg * 64;
  // fragment row i's bin b (a scored row only): the minimum v written at
  // its output offset less the row's centre term (+inf stays +inf); the
  // row's terms are read from shared memory here, not kept in registers
  // across the walk
  auto write_bin = [&](int i, int b, float v, int id) {
    const int r = rbase + 8 * i;
    if constexpr (R::kCentreTerm) v -= row_corr[r];
    put_out(a, row_col[r] + b, v, id);
  };

  // STRIPE: per accumulator element its running minimum and the stripe it
  // came from (16 bits each, j = 0 low; the id is read back when written);
  // FOLD: per (row, group, column) the best candidate
  float bv[2][8][2];
  uint32_t bw[2][8];
  ListCand fs[2][G > 0 ? G : 1][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      bv[i][n8][0] = bv[i][n8][1] = CUDART_INF_F;
      bw[i][n8] = 0;
    }
#pragma unroll
    for (int g = 0; g < (G > 0 ? G : 1); ++g)
      fs[i][g][0] = fs[i][g][1] = {CUDART_INF_F, -1};
  }

  if (steps > 0) {
    if (qres) {
      for (int s = 0; s < ks_n; ++s)
        R::template put_queries<IP>(a, row_q, l, s * kBK,
                                    base + q_hi + s * kTile,
                                    base + q_lo + s * kTile);
    } else {
      R::template put_queries<IP>(a, row_q, l, 0, base + q_hi, base + q_lo);
    }
    typename R::RowSlice rs;
    int r0, rlim;
    tile_rows(0, r0, rlim);
    R::fetch_rows(rs, a, lbase, r0, rlim, 0);
    R::put_rows(rs, a, ext, base + y_hi, base + y_lo);
    if (tid < kBN) stage_of(r0, rlim, st_a[tid], st_b[tid], st_i[tid]);
    // step t + 1's rows (and stage) in flight in registers
    float spa = CUDART_INF_F, spb = 0.f;
    int ipre = -1;
    auto prefetch = [&](int t) {
      const int T = t / ks_n, k = t - T * ks_n;
      int p0, plim;
      tile_rows(T, p0, plim);
      R::fetch_rows(rs, a, lbase, p0, plim, k * kBK);
      if (k == 0 && tid < kBN) stage_of(p0, plim, spa, spb, ipre);
    };
    if (steps > 1) prefetch(1);
    fence_proxy_async();
    __syncthreads();

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    for (int t = 0; t < steps; ++t) {
      const int T = t / ks_n, ks = t - T * ks_n, st = t & 1;
      const int qi = qres ? ks : st;
      // both warpgroups take the same 64 A rows, each its half of the tile
      const uint32_t a_hi = base_s + q_hi + qi * kTile;
      const uint32_t a_lo = base_s + q_lo + qi * kTile;
      const uint32_t b_hi = base_s + y_hi + st * kTile + cw * 128;
      const uint32_t b_lo = base_s + y_lo + st * kTile + cw * 128;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int accumulate = (ks == 0 && kk == 0) ? 0 : 1;
        const uint32_t o = kk * 32;
        if constexpr (R::kPasses == 3) {
          // dot_nt_f32's order: hi.lo, lo.hi, hi.hi
          wgmma_m64n64k16(acc, desc_sw128(a_hi + o), desc_sw128(b_lo + o),
                          accumulate);
          wgmma_m64n64k16(acc, desc_sw128(a_lo + o), desc_sw128(b_hi + o), 1);
          wgmma_m64n64k16(acc, desc_sw128(a_hi + o), desc_sw128(b_hi + o), 1);
        } else {
          wgmma_m64n64k16(acc, desc_sw128(a_hi + o), desc_sw128(b_hi + o),
                          accumulate);
        }
      }
      wgmma_commit();
      // store step t + 1 in the other half of the ring while they run,
      // then load step t + 2
      if (t + 1 < steps) {
        const int nT = (t + 1) / ks_n, nks = t + 1 - nT * ks_n, nst = st ^ 1;
        R::put_rows(rs, a, ext, base + y_hi + nst * kTile,
                    base + y_lo + nst * kTile);
        if (nks == 0 && tid < kBN) {
          st_a[(nT & 1) * kBN + tid] = spa;
          st_b[(nT & 1) * kBN + tid] = spb;
          st_i[(nT & 1) * kBN + tid] = ipre;
        }
        if (!qres)
          R::template put_queries<IP>(a, row_q, l, nks * kBK,
                                      base + q_hi + nst * kTile,
                                      base + q_lo + nst * kTile);
        fence_proxy_async();
        if (t + 2 < steps) prefetch(t + 2);
      }
      wgmma_wait_all();
      fence_acc(acc);

      if (ks == ks_n - 1) {
        // epilogue: fragment element (i, n8, j) = acc[4 n8 + 2 i + j] is A
        // row rbase + 8 i against tile column cw + 8 n8 + 2 quad + j
        const float* sa = st_a + (T & 1) * kBN + cw;
        const float* sb = st_b + (T & 1) * kBN + cw;
        const int* si = st_i + (T & 1) * kBN + cw;
        const int c = G == 0 ? T / nw : 0, w = G == 0 ? T - c * nw : 0;
        const float xq[2] = {row_qq[rbase], row_qq[rbase + 8]};
        // STRIPE: elements equal to their running minimum (bit 4 n8 + 2 i
        // + j), resolved by id after the loop: rare, and a branch with a
        // load per element would cost the loop its scheduling
        uint32_t ties = 0;
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int col = 8 * n8 + 2 * quad;
          const float ya[2] = {sa[col], sa[col + 1]};
          const float yb[2] = {sb[col], sb[col + 1]};
          const int yi[2] = {si[col], si[col + 1]};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float v = R::template score<IP>(acc[4 * n8 + 2 * i + j],
                                                    ya[j], yb[j], xq[i]);
              if constexpr (G == 0) {
                float& b = bv[i][n8][j];
                if (v < b) {
                  b = v;
                  bw[i][n8] = (bw[i][n8] & (0xffffu << (16 - 16 * j))) |
                              (static_cast<uint32_t>(w) << (16 * j));
                } else if (v == b && v != CUDART_INF_F) {
                  ties |= 1u << (4 * n8 + 2 * i + j);
                }
              } else {
                fs[i][n8 % G][j] = better(fs[i][n8 % G][j],
                                          ListCand{v, yi[j]});
              }
            }
          }
        }
        if (G == 0 && ties != 0) {  // a tie: the smaller id wins
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                if ((ties >> (4 * n8 + 2 * i + j)) & 1) {
                  const int col = 8 * n8 + 2 * quad + j;
                  const int wb = (bw[i][n8] >> (16 * j)) & 0xffff;
                  if (si[col] < a.ids[lbase +
                                      static_cast<long long>(wb) * bins +
                                      c * kBN + cw + col])
                    bw[i][n8] = (bw[i][n8] & (0xffffu << (16 - 16 * j))) |
                                (static_cast<uint32_t>(w) << (16 * j));
                }
              }
            }
          }
        }
        if (G == 0 && w == nw - 1) {  // the chunk's last stripe: write
          const int bc = min(kBN, bins - c * kBN);
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int col = cw + 8 * n8 + 2 * quad + j;
                const float v = bv[i][n8][j];
                if (rbase + 8 * i < n_valid && col < bc) {
                  const int bin = c * kBN + col;
                  const int wb = (bw[i][n8] >> (16 * j)) & 0xffff;
                  write_bin(i, bin, v,
                            v == CUDART_INF_F
                                ? -1
                                : a.ids[lbase +
                                        static_cast<long long>(wb) * bins +
                                        bin]);
                }
                bv[i][n8][j] = CUDART_INF_F;
              }
              bw[i][n8] = 0;
            }
          }
        }
      }
      __syncthreads();
    }

    if constexpr (G > 0) {
      // both warpgroups hold candidates of the same bins: warpgroup 1
      // hands its own to warpgroup 0 through the (now idle) row ring
      ListCand* xch = reinterpret_cast<ListCand*>(base + y_hi);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              xch[((i * G + g) * 2 + j) * 128 + (tid & 127)] = fs[i][g][j];
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              fs[i][g][j] = better(fs[i][g][j],
                                   xch[((i * G + g) * 2 + j) * 128 + tid]);
        if (G == 1 && bins < 8) {  // columns 2 quad + j fold to bins < 8
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (bins <= 4) fs[i][0][j] = better(fs[i][0][j],
                                                  shfl_xor(fs[i][0][j], 2));
              if (bins <= 2) fs[i][0][j] = better(fs[i][0][j],
                                                  shfl_xor(fs[i][0][j], 1));
            }
            if (bins == 1) fs[i][0][0] = better(fs[i][0][0], fs[i][0][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int bin = 8 * g + 2 * quad + j;
              if (rbase + 8 * i < n_valid && bin < bins)
                write_bin(i, bin, fs[i][g][j].v, fs[i][g][j].id);
            }
          }
        }
      }
    }
  }

  // unfused: bins no tile reached (past the extent) are (+inf, -1)
  if (!fused) {
    const int covered = G == 0 ? min(bins, n_ch * kBN) : (n_tiles > 0 ? bins
                                                                      : 0);
    const int rest = bins - covered;
    for (long long e = tid; e < static_cast<long long>(n_valid) * rest;
         e += kThreads) {
      const int r = static_cast<int>(e / rest);
      put_out(a, row_col[r] + covered + e % rest, CUDART_INF_F, -1);
    }
  }
}

// The pre-pass, one block per list: one past the list's last row with an
// id.
__global__ __launch_bounds__(256) void list_extent_kernel(
    const int* __restrict__ ids, int max_list, int* __restrict__ extent) {
  __shared__ int part[8];
  const long long lbase = static_cast<long long>(blockIdx.x) * max_list;
  int ext = 0;
#pragma unroll 8
  for (int r = threadIdx.x; r < max_list; r += 256)
    ext = ids[lbase + r] >= 0 ? r + 1 : ext;
  ext = __reduce_max_sync(0xffffffffu, ext);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ext;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < 8; ++w) ext = max(ext, part[w]);
    extent[blockIdx.x] = ext;
  }
}

// One block: the lists by descending extent, a counting sort on kBuckets
// buckets of the extent (the order inside a bucket is the atomics'; no
// result depends on the order of the blocks).
constexpr int kBuckets = 64;
__global__ __launch_bounds__(256) void list_order_kernel(
    const int* __restrict__ extent, int n_lists, int max_list,
    int* __restrict__ order) {
  __shared__ int cnt[kBuckets];
  auto bucket = [&](int e) {
    return min(kBuckets - 1, static_cast<int>(static_cast<long long>(e) *
                                              kBuckets / (max_list + 1)));
  };
  if (threadIdx.x < kBuckets) cnt[threadIdx.x] = 0;
  __syncthreads();
  for (int l = threadIdx.x; l < n_lists; l += 256)
    atomicAdd(&cnt[bucket(extent[l])], 1);
  __syncthreads();
  if (threadIdx.x == 0) {  // each bucket's first position, longest first
    int at = 0;
    for (int b = kBuckets - 1; b >= 0; --b) {
      const int c = cnt[b];
      cnt[b] = at;
      at += c;
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < n_lists; l += 256)
    order[atomicAdd(&cnt[bucket(extent[l])], 1)] = l;
}

// the fused candidate rows start at +inf: the columns of dropped probes
// and of bins past a list's extent are never written
__global__ void fill_inf_kernel(float* p, long long n) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x)
    p[e] = CUDART_INF_F;
}

template <class R, int G, bool IP>
int launch_list_g(const ListArgs& a, int n_lists, size_t smem,
                  cudaStream_t s) {
  auto kernel = list_scan_tc_kernel<R, G, IP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(n_lists) * a.tpl;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Pass A: the pre-pass into lists_scratch (2 x n_lists ints: extents,
// order), then the scan, its fold mode from bins (see the note).
template <class R>
int launch_list_pass_a(ListArgs a, int n_lists, int* lists_scratch, bool ip,
                       cudaStream_t s) {
  if (n_lists == 0) return 0;
  list_extent_kernel<<<n_lists, 256, 0, s>>>(a.ids, a.max_list,
                                             lists_scratch);
  list_order_kernel<<<1, 256, 0, s>>>(lists_scratch, n_lists, a.max_list,
                                      lists_scratch + n_lists);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  a.extent = lists_scratch;
  a.order = lists_scratch + n_lists;
  a.tpl = (a.cap + kListM - 1) / kListM;
  const size_t smem = list_smem_bytes<R>(a);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int b = a.bins;
  const int g = (b & (b - 1)) != 0 || b > 64 ? 0 : (b < 8 ? 1 : b / 8);
  if (g == 0 && (a.max_list + b - 1) / b > 65536)  // 16-bit stripes
    return static_cast<int>(cudaErrorInvalidValue);
#define RAFT_LIST_G(GV)                                             \
  if (g == GV)                                                      \
    return ip ? launch_list_g<R, GV, true>(a, n_lists, smem, s)     \
              : launch_list_g<R, GV, false>(a, n_lists, smem, s);
  RAFT_LIST_G(0)
  RAFT_LIST_G(1)
  RAFT_LIST_G(2)
  RAFT_LIST_G(4)
  RAFT_LIST_G(8)
#undef RAFT_LIST_G
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused scan for queries [a.q_begin, a.q_end) (a.kp, a.n_probes and
// a.ncols set): the +inf fill of cand_d ((q_end - q_begin) x ncols), pass A
// into it, then pass B, the payload radix select of each candidate row,
// into out_d/out_i rows [q_begin, q_end) of (nq, k), k <= 256.
template <class R>
int list_scan_fused(ListArgs a, int n_lists, int k, int do_sqrt,
                    float* cand_d, int* cand_i, int* lists_scratch,
                    float* out_d, int* out_i, bool ip, cudaStream_t s) {
  const int rows = a.q_end - a.q_begin;
  if (k < 1 || k > kRsMaxK || a.bins < 1 || a.cap < 1 || a.d < 1 ||
      rows < 0 || a.ncols * rows > kListMaxCand || a.ncols > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  fill_inf_kernel<<<1024, 256, 0, s>>>(cand_d, a.ncols * rows);
  a.out_d = cand_d;
  a.out_i = cand_i;
  a.out_bf16 = 0;
  a.round_out = 0;
  int rc = static_cast<int>(cudaGetLastError());
  if (rc == 0) rc = launch_list_pass_a<R>(a, n_lists, lists_scratch, ip, s);
  if (rc != 0) return rc;
  return launch_radix_select(
      cand_d, cand_i, rows, static_cast<int>(a.ncols), k, do_sqrt,
      out_d + static_cast<long long>(a.q_begin) * k,
      out_i + static_cast<long long>(a.q_begin) * k, s);
}

}  // namespace
}  // namespace raft_tpu_torch
