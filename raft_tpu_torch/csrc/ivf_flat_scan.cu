// IVF-Flat fine phase on the tensor cores: one list-major pass A, used by
//   * kernel 3 (raft_ivf_flat_scan): pass A writes each query's binned
//     candidates into a per-query row, then candidate_topk_kernel
//     (candidate_topk.cuh) keeps the k best — the fused scan;
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
// Design: a pre-pass finds each list's extent (one past its last row with
// an id) and orders the lists longest first (a counting sort on 64
// buckets), so the longest lists start in the first wave and do not set
// the tail. Then one 256-thread block (two warpgroups) per (list, tile of
// up to 128 of the table slots that probe it), in that order. The block
// compacts the tile's queries into the A rows (M = 64 when at most 64,
// and the second warpgroup then issues no products), splits them once
// into resident bf16 hi/lo tiles (streamed with the rows when d > 256).
// It streams the list's rows up to its extent
// once as 128-row B tiles (the wgmma N side) in 64-wide feature slices,
// split on the fly in a two-stage ring, as fused_knn_tc.cu does. Tiles
// follow the strided bins, so the epilogue needs no shuffle:
//   * STRIPE (bins >= 128, exact bins, and any bins that is not a power of
//     two): tile (chunk c, stripe w) holds rows w * bins + 128 c + j, so
//     its column j is bin 128 c + j; each thread keeps the running minimum
//     of its 64 accumulator elements and the stripe it came from (16 bits),
//     across the stripes of the chunk, and writes the chunk's bins after
//     its last stripe (an id is read back from the stripe; a tie reads the
//     older id);
//   * FOLD (bins a power of two <= 64): tiles are 128 consecutive rows, so
//     column j is bin j % bins: the thread's 8-column groups n8 fold into
//     group n8 % (bins / 8) in registers, bins < 8 by two quad shuffles at
//     the end.
// Kernel 3's pass A writes bin b of list l for query q at column rank *
// bins + b of q's candidate row, rank being l's position among q's kept
// probes in ascending order; columns of dropped probes keep the +inf fill,
// so pass B ranks by (value, column) = (value, list id, bin).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "candidate_topk.cuh"
#include "wgmma_bf16x3.cuh"

namespace {

using namespace raft_tpu_torch::tc;

// candidates of one kernel-3 launch: bounds the caller's buffer
constexpr long long kMaxCand = 1ll << 28;

struct Args {
  const float* queries;  // (nq, d)
  const int* qmap;       // (n_lists, cap) query ids, -1 = empty slot
  int cap, tpl;          // tpl: 128-slot tiles per list
  int q_begin, q_end;    // only queries in [q_begin, q_end) are scored
  const float* data;     // (n_lists, max_list, d)
  const float* norms;    // (n_lists, max_list)
  const int* ids;        // (n_lists, max_list), -1 = pad
  int max_list, d, bins, vec4, qres;
  const int* extent;     // (n_lists) one past each list's last row
  const int* order;      // (n_lists) the lists, longest first
  const int* kp;         // kernel 3: (nq, n_probes) sorted kept probes
  int n_probes;
  long long ncols;       // kernel 3: candidate row width, n_probes * bins
  void* out_d;           // f32, or bf16 when out_bf16
  int* out_i;
  int out_bf16;
};

// Shared memory (bytes, from a 1024-aligned base): query hi tiles [qt],
// query lo tiles [qt], row hi tiles [2], row lo tiles [2], the row stage
// (term, id) [2][kBN], then per A row its output offset, query and |q|^2,
// and 16 words of scratch. qt is the number of slices (resident queries)
// or 2 (a ring with the rows).
__host__ __device__ inline int q_tiles(bool qres, int ks) {
  return qres ? ks : 2;
}
__host__ __device__ inline size_t smem_bytes(bool qres, int ks) {
  return 1024 + 2 * static_cast<size_t>(q_tiles(qres, ks) + 2) * kTile +
         2 * kBN * 8 + kBM * 16 + 64;
}

struct Cand {
  float v;
  int id;
};

// the better of two candidates: smaller value, then smaller id
__device__ __forceinline__ Cand better(Cand a, Cand b) {
  return (b.v < a.v || (b.v == a.v && b.id < a.id)) ? b : a;
}

__device__ __forceinline__ Cand shfl_xor(Cand c, int mask) {
  return {__shfl_xor_sync(0xffffffffu, c.v, mask),
          __shfl_xor_sync(0xffffffffu, c.id, mask)};
}

__device__ __forceinline__ void put_out(const Args& a, long long at, float v,
                                        int id) {
  if (a.out_bf16)
    static_cast<__nv_bfloat16*>(a.out_d)[at] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(a.out_d)[at] = v;
  a.out_i[at] = v == CUDART_INF_F ? -1 : id;
}

// G = 0: STRIPE; G = bins / 8 (1 for bins < 8): FOLD (see the note).
template <int G, bool IP>
__global__ __launch_bounds__(kThreads, 1) void list_scan_tc_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + ((1024 - (raw_s & 1023)) & 1023);
  const uint32_t base_s = static_cast<uint32_t>(__cvta_generic_to_shared(base));

  const int d = a.d, bins = a.bins;
  const int ks_n = (d + kBK - 1) / kBK;
  const bool qres = a.qres != 0, vec4 = a.vec4 != 0;
  const int qt = q_tiles(qres, ks_n);
  const int q_hi = 0, q_lo = qt * kTile;
  const int y_hi = 2 * qt * kTile, y_lo = y_hi + 2 * kTile;
  float* st_s = reinterpret_cast<float*>(base + 2 * (qt + 2) * kTile);
  int* st_i = reinterpret_cast<int*>(st_s + 2 * kBN);
  long long* row_col = reinterpret_cast<long long*>(st_i + 2 * kBN);
  int* row_q = reinterpret_cast<int*>(row_col + kBM);
  float* row_qq = reinterpret_cast<float*>(row_q + kBM);
  int* scratch = reinterpret_cast<int*>(row_qq + kBM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane & 3, wg = tid >> 7;
  const int l = a.order[blockIdx.x / a.tpl];
  const int s0 = (blockIdx.x % a.tpl) * kBM;
  const int ns = min(kBM, a.cap - s0);
  const int* qm = a.qmap + static_cast<long long>(l) * a.cap + s0;
  const long long lbase = static_cast<long long>(l) * a.max_list;
  const bool fused = a.kp != nullptr;

  // the tile's scored slots, compacted in slot order into the A rows
  const int q = tid < ns ? qm[tid] : -1;
  const bool valid = q >= a.q_begin && q < a.q_end;
  const unsigned bal = __ballot_sync(0xffffffffu, valid);
  if (lane == 0 && warp < 4) scratch[warp] = __popc(bal);
  __syncthreads();
  int before = 0, n_valid = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    before += w < warp ? scratch[w] : 0;
    n_valid += scratch[w];
  }
  if (valid) {
    const int pos = before + __popc(bal & ((1u << lane) - 1));
    row_q[pos] = q;
    float qq = 0.f;
    const float* qrow = a.queries + static_cast<long long>(q) * d;
#pragma unroll 8
    for (int j = 0; j < d; ++j) qq = fmaf(qrow[j], qrow[j], qq);
    row_qq[pos] = qq;
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
  if (tid < kBM && tid >= n_valid) row_q[tid] = -1;
  if (!fused) {  // kernel 4: empty slots are all (+inf, -1)
    for (int s = 0; s < ns; ++s) {
      if (qm[s] >= 0) continue;
      const long long at = (static_cast<long long>(l) * a.cap + s0 + s) * bins;
      for (int b = tid; b < bins; b += kThreads) put_out(a, at + b,
                                                         CUDART_INF_F, -1);
    }
  }
  if (n_valid == 0) return;  // block-uniform
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
  const float* ldata = a.data + lbase * d;
  // a row's stage: L2 its norm (IP 0), +inf for pads and rows past rlim
  auto stage_of = [&](int r0, int rlim, float& sv, int& si) {
    const int r = r0 + tid;
    sv = CUDART_INF_F;
    si = -1;
    if (r < rlim) {
      const int id = a.ids[lbase + r];
      if (id >= 0) {
        si = id;
        sv = IP ? 0.f : a.norms[lbase + r];
      }
    }
  };

  const bool mine = wg == 0 || n_valid > 64;  // this warpgroup has queries
  const int rbase = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  float xq[2];
  bool qok[2];
  long long cb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rbase + 8 * i;
    qok[i] = r < n_valid;
    xq[i] = (!IP && qok[i]) ? row_qq[r] : 0.f;
    cb[i] = qok[i] ? row_col[r] : 0;
  }

  // STRIPE: per accumulator element the running minimum and its stripe
  // (16 bits each, j = 0 low); FOLD: per (row, group, column) the best
  // candidate
  float bv[2][16][2];
  uint32_t bw[2][16];
  Cand fs[2][G > 0 ? G : 1][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
      bv[i][n8][0] = bv[i][n8][1] = CUDART_INF_F;
      bw[i][n8] = 0;
    }
#pragma unroll
    for (int g = 0; g < (G > 0 ? G : 1); ++g)
      fs[i][g][0] = fs[i][g][1] = {CUDART_INF_F, -1};
  }

  if (steps > 0) {
    Slice f;
    if (qres) {
      for (int s = 0; s < ks_n; ++s) {
        fetch_rows(f, a.queries, row_q, d, s * kBK, vec4);
        put<3>(f, base + q_hi + s * kTile, base + q_lo + s * kTile);
      }
    } else {
      fetch_rows(f, a.queries, row_q, d, 0, vec4);
      put<3>(f, base + q_hi, base + q_lo);
    }
    int r0, rlim;
    tile_rows(0, r0, rlim);
    fetch(f, ldata, r0, rlim, d, 0, vec4);
    put<3>(f, base + y_hi, base + y_lo);
    if (tid < kBN) stage_of(r0, rlim, st_s[tid], st_i[tid]);
    // step t + 1's rows (and stage) in flight in registers
    float spre = CUDART_INF_F;
    int ipre = -1;
    auto prefetch = [&](int t) {
      const int T = t / ks_n, k = t - T * ks_n;
      int p0, plim;
      tile_rows(T, p0, plim);
      fetch(f, ldata, p0, plim, d, k * kBK, vec4);
      if (k == 0 && tid < kBN) stage_of(p0, plim, spre, ipre);
    };
    if (steps > 1) prefetch(1);
    fence_proxy_async();
    __syncthreads();

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int t = 0; t < steps; ++t) {
      const int T = t / ks_n, ks = t - T * ks_n, st = t & 1;
      const int qi = qres ? ks : st;
      const uint32_t a_hi = base_s + q_hi + qi * kTile + wg * 64 * 128;
      const uint32_t a_lo = base_s + q_lo + qi * kTile + wg * 64 * 128;
      const uint32_t b_hi = base_s + y_hi + st * kTile;
      const uint32_t b_lo = base_s + y_lo + st * kTile;
      if (mine) {
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const int accumulate = (ks == 0 && kk == 0) ? 0 : 1;
          const uint32_t o = kk * 32;
          // dot_nt_f32's order: hi.lo, lo.hi, hi.hi
          wgmma_m64n128k16(acc, desc_sw128(a_hi + o), desc_sw128(b_lo + o),
                           accumulate);
          wgmma_m64n128k16(acc, desc_sw128(a_lo + o), desc_sw128(b_hi + o),
                           1);
          wgmma_m64n128k16(acc, desc_sw128(a_hi + o), desc_sw128(b_hi + o),
                           1);
        }
        wgmma_commit();
      }
      // store step t + 1 in the other half of the ring while they run,
      // then load step t + 2
      if (t + 1 < steps) {
        const int nT = (t + 1) / ks_n, nks = t + 1 - nT * ks_n, nst = st ^ 1;
        put<3>(f, base + y_hi + nst * kTile, base + y_lo + nst * kTile);
        if (nks == 0 && tid < kBN) {
          st_s[(nT & 1) * kBN + tid] = spre;
          st_i[(nT & 1) * kBN + tid] = ipre;
        }
        if (!qres) {
          fetch_rows(f, a.queries, row_q, d, nks * kBK, vec4);
          put<3>(f, base + q_hi + nst * kTile, base + q_lo + nst * kTile);
        }
        fence_proxy_async();
        if (t + 2 < steps) prefetch(t + 2);
      }
      if (mine) {
        wgmma_wait_all();
        fence_acc(acc);
      }

      if (ks == ks_n - 1 && mine) {
        // epilogue: fragment element (i, n8, j) = acc[4 n8 + 2 i + j] is A
        // row rbase + 8 i against tile column 8 n8 + 2 quad + j
        const float* sv = st_s + (T & 1) * kBN;
        const int* si = st_i + (T & 1) * kBN;
        const int c = G == 0 ? T / nw : 0, w = G == 0 ? T - c * nw : 0;
#pragma unroll
        for (int n8 = 0; n8 < 16; ++n8) {
          const int col = 8 * n8 + 2 * quad;
          const float yv[2] = {sv[col], sv[col + 1]};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float x = acc[4 * n8 + 2 * i + j];
              // (norm + |q|^2) - 2 acc with one rounding of the difference,
              // as the plain version's (2 acc is exact); pads stay +inf
              const float v =
                  IP ? (yv[j] == 0.f ? -x : CUDART_INF_F)
                     : fmaxf(fmaf(-2.0f, x, yv[j] + xq[i]), 0.f);
              if constexpr (G == 0) {
                float& b = bv[i][n8][j];
                bool take = v < b;
                if (!take && v == b && v != CUDART_INF_F) {  // a tie: ids
                  const int wb = (bw[i][n8] >> (16 * j)) & 0xffff;
                  take = si[col + j] <
                         a.ids[lbase + static_cast<long long>(wb) * bins +
                               c * kBN + col + j];
                }
                if (take) {
                  b = v;
                  bw[i][n8] = (bw[i][n8] & (0xffffu << (16 - 16 * j))) |
                              (static_cast<uint32_t>(w) << (16 * j));
                }
              } else {
                fs[i][n8 % G][j] = better(fs[i][n8 % G][j],
                                          Cand{v, si[col + j]});
              }
            }
          }
        }
        if (G == 0 && w == nw - 1) {  // the chunk's last stripe: write
          const int bc = min(kBN, bins - c * kBN);
#pragma unroll
          for (int n8 = 0; n8 < 16; ++n8) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int col = 8 * n8 + 2 * quad + j;
                const float v = bv[i][n8][j];
                if (qok[i] && col < bc) {
                  const int bin = c * kBN + col;
                  const int wb = (bw[i][n8] >> (16 * j)) & 0xffff;
                  put_out(a, cb[i] + bin, v,
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
      if (mine) {
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
              if (qok[i] && bin < bins)
                put_out(a, cb[i] + bin, fs[i][g][j].v, fs[i][g][j].id);
            }
          }
        }
      }
    }
  }

  // kernel 4: bins no tile reached (past the extent) are (+inf, -1)
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

// kernel 3's candidate rows start at +inf: the columns of dropped probes
// and of bins past a list's extent are never written
__global__ void fill_inf_kernel(float* p, long long n) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x)
    p[e] = CUDART_INF_F;
}

template <int G, bool IP>
int launch_g(const Args& a, int n_lists, size_t smem, cudaStream_t s) {
  auto kernel = list_scan_tc_kernel<G, IP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(n_lists) * a.tpl;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// pass A: the pre-pass into lists_scratch (2 x n_lists ints: extents,
// order), the fold mode from bins (see the note), the query residency from
// the shared memory it needs
int launch_pass_a(Args a, int n_lists, int* lists_scratch, bool ip,
                  cudaStream_t s) {
  list_extent_kernel<<<n_lists, 256, 0, s>>>(a.ids, a.max_list,
                                             lists_scratch);
  list_order_kernel<<<1, 256, 0, s>>>(lists_scratch, n_lists, a.max_list,
                                      lists_scratch + n_lists);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  a.extent = lists_scratch;
  a.order = lists_scratch + n_lists;
  const int ks_n = (a.d + kBK - 1) / kBK;
  a.qres = smem_bytes(true, ks_n) <= static_cast<size_t>(kMaxSmem);
  a.tpl = (a.cap + kBM - 1) / kBM;
  const size_t smem = smem_bytes(a.qres != 0, ks_n);
  const int b = a.bins;
  const int g = (b & (b - 1)) != 0 || b > 64 ? 0 : (b < 8 ? 1 : b / 8);
  if (g == 0 && (a.max_list + b - 1) / b > 65536)  // 16-bit stripes
    return static_cast<int>(cudaErrorInvalidValue);
#define RAFT_G(GV)                                                  \
  if (g == GV)                                                      \
    return ip ? launch_g<GV, true>(a, n_lists, smem, s)             \
              : launch_g<GV, false>(a, n_lists, smem, s);
  RAFT_G(0)
  RAFT_G(1)
  RAFT_G(2)
  RAFT_G(4)
  RAFT_G(8)
#undef RAFT_G
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

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
  const long long ncols = static_cast<long long>(n_probes) * bins;
  const int rows = q_end - q_begin;
  if (k < 1 || k > raft_tpu_torch::kTopMaxK || bins < 1 || cap < 1 ||
      d < 1 || rows < 0 || ncols * rows > kMaxCand || ncols > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_inf_kernel<<<1024, 256, 0, s>>>(cand_d, ncols * rows);
  Args a{queries, qmap, cap, 0, q_begin, q_end, data, norms, ids, max_list,
         d, bins, vec4, 0, nullptr, nullptr, kp, n_probes, ncols, cand_d,
         cand_i, 0};
  int rc = static_cast<int>(cudaGetLastError());
  if (rc == 0 && n_lists > 0)
    rc = launch_pass_a(a, n_lists, lists_scratch, metric_ip, s);
  if (rc != 0) return rc;
  return raft_tpu_torch::launch_candidate_topk(
      cand_d, cand_i, rows, static_cast<int>(ncols), k, do_sqrt,
      out_d + static_cast<long long>(q_begin) * k,
      out_i + static_cast<long long>(q_begin) * k, s);
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
  if (n_lists == 0) return 0;
  Args a{queries, qmap, cap, 0, 0, 0x7fffffff, data, norms, ids, max_list,
         d, bins, vec4, 0, nullptr, nullptr, nullptr, 0, 0, out_d, out_i,
         out_bf16};
  return launch_pass_a(a, n_lists, lists_scratch, metric_ip,
                       static_cast<cudaStream_t>(stream));
}
