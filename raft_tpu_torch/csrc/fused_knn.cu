// Fused brute-force k-NN with binned partial top-k: for every query, the k
// best (value, row) pairs among the bin minima of the database, without the
// (m, n) distance matrix.
//
// Replaces: raft_tpu/ops/pallas_fused_knn.py:_knn_kernel (kernel 5, d <=
// 4096) and :_knn_kernel_ktiled (kernel 6, d > 4096), entry
// fused_knn_pallas. Contract kept:
//  - distances: L2 is max((|y|^2 + |x|^2) - 2 x.y, 0), the square root taken
//    after selection; IP is -x.y inside, negated back by the wrapper;
//  - binning: each db tile of tn rows, counted from row 0, is cut into
//    l_bins contiguous bins of b = tn / l_bins rows; each bin gives one
//    candidate, its minimum with the lowest row among equal values (the
//    strict '<' walk below). Bins never cross a tile (tn % b == 0), so the
//    bin of row r is column r / b of the candidate matrix;
//  - the merge: the TPU kernel keeps a sorted (k, TM) state across the
//    sequential db grid and merges each tile's candidates by k rounds of
//    extract-min, ties to the lower position in [state | candidates]. The
//    state holds earlier tiles, so lower rows: the result is the k smallest
//    bin candidates ranked by (value, row). Here pass A writes every bin's
//    candidate, in row order, and pass B ranks each query's row of them by
//    (value, column) with the payload radix select of radix_select.cuh
//    (k <= 256; above that the wrapper ranks with a stable sort). The TPU's filtered merge changes no
//    result and has no counterpart. Padded rows never enter: a bin with no
//    finite value keeps (+inf, -1), and pass B writes -1 for every +inf slot.
//  - precision: f32 products (kernel_precision "highest", kernels 5 and
//    6). Both kernels' bf16x3 (the card's default) and bf16 tiers run on
//    the tensor cores, in fused_knn_tc.cu.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): operations. The TPU
// kernel computes its 2*m*n*d products as bf16x3 (three bf16 passes), so
// the bound counts 3*2*m*n*d at the 989 TFLOP/s bf16 tensor rate: 7.8 ms at
// 1000 x 10M x 128 (the database's 5.1 GB take 1.53 ms). This kernel runs
// on the CUDA cores in f32, where 2*m*n*d alone takes 38 ms at 67 TFLOP/s.
// Measured 77.6 ms there, 1.07x the card's own f32 torch.mm of the same
// product, and 4.76 ms at kernel 6's 1000 x 10k x 8192 (bound 2.45 ms)
// (NVIDIA H100 80GB HBM3, 700.00 W; rows fused_knn@highest and
// fused_knn_ktiled@highest of chip_smoke.py; the simple first body took
// 120.3 and 21.0).
//
// Design: pass A takes f32_tile.cuh's product loop (8 x 8 register tiles
// of a 128-query x 128-row block tile, a ring of k-major stages loaded by
// cp.async, one barrier a stage). Every dot product is one fmaf chain over
// ascending features, as the simple first body of PR 4 took it, so each
// distance, and so each candidate, is bit for bit that body's. The grid
// cuts the database into segments of whole bins (a multiple of b and of
// the 128-row chunk): bins never cross a block, and there are enough
// blocks for the 132 SMs (kTargetBlocks: 632 at kernel 6's 1000 x 10k,
// 2112 at kernel 5's 1000 x 10M). Blocks are ordered query-block fastest,
// so the blocks that share a segment run together and read it from L2.
// The bin minima are taken in registers where a thread's 4-row column
// groups fit the bins (b a power of two up to 64, or a multiple of 64):
// the strict '<' walk over the group's rows, then a lexicographic
// (value, row) min over the lanes of the bin with shuffles, which equals
// the walk; bins of b >= 128 carry their open minimum across halves and
// chunks in lane i of the row group. Any other b takes a general epilogue:
// the chunk's 128 x 128 distances go to shared memory and every thread
// walks one (query, bin segment) pair (two threads a pair when the chunk
// holds one bin), carrying a bin's open minimum to the next chunk in
// shared memory. Kernel 5 takes the row norms from a prologue; kernel 6
// (the d > 4096 launch, tn = 1024) accumulates them from the staged
// features inside its product loop, Kahan-compensated over the features
// in ascending order, padding included, as the first body did.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "f32_tile.cuh"
#include "radix_select.cuh"
#include "row_norms.cuh"

namespace {

namespace ft = raft_tpu_torch::f32t;

// blocks a launch aims for: 8 waves of two blocks an SM
constexpr long long kTargetBlocks = 132 * 2 * 8;
// the general epilogue's distance tile (a padded row a query) and the
// open bins' (value, row) of two consecutive chunks
constexpr int kDistPitch = ft::kTile + 1;
constexpr int kGeneralBytes =
    ft::kRingBytes + ft::kTile * kDistPitch * 4 + 2 * ft::kTile * 8;

// b in registers: a power of two up to 64 (bins inside a 64-row half), or
// a multiple of 64 (halves inside a bin)
__host__ __device__ constexpr bool register_bins(int b) {
  return (b <= 64 && (b & (b - 1)) == 0) || b % 64 == 0;
}

template <bool KTILED, bool IP, bool GENERAL>
__global__ __launch_bounds__(ft::kThreads, 2) void knn_bins_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ xx, const float* __restrict__ yy, int m, int n,
    int d, int b, int seg, int q_blocks, long long nb,
    float* __restrict__ cand_d, int* __restrict__ cand_i) {
  extern __shared__ float4 smem4[];
  __shared__ float xn[ft::kTile];  // kernel 6: norms of the block's queries
  __shared__ float yn[ft::kTile];  // kernel 6: norms of the chunk's rows
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // chunk rows c_of(j, tx)
  const int ty = tid >> 4;  // queries q_of(i, ty)
  const int row0 = static_cast<int>(blockIdx.x % q_blocks) * ft::kTile;
  const int s0 = static_cast<int>(blockIdx.x / q_blocks) * seg;
  const int s1 = min(s0 + seg, n);  // a multiple of b, or n
  const int lb = __ffs(b) - 1;      // log2(b) where b is a power of two

  // kernel 6: thread tid < 128 sums query tid's norm (first chunk only),
  // tid >= 128 row tid - 128's of each chunk, Kahan-compensated: 8192
  // sequential terms would otherwise round to ~0.04 at |y|^2 ~ 8192,
  // enough to reorder near neighbours
  float nrm = 0.f, nrm_c = 0.f;
  // bins of b >= 128: lane tx < 8 holds query q_of(tx, ty)'s open bin
  float open_v = CUDART_INF_F;
  int open_i = -1;
  int parity = 0;  // the general epilogue's carry slot

  float acc[8][8];
  ft::zero(acc);
  ft::Ring ring(smem, x, row0, min(row0 + ft::kTile, m), y, s0, s1, d);
  for (int c0 = s0; c0 < s1; c0 += ft::kTile) {
    for (int ks = 0; ks < ring.nks; ++ks) {
      const float* st = ring.next();
      ft::mma_slice(st, ty, tx, acc);
      if constexpr (KTILED && !IP) {
        if (tid >= ft::kTile || c0 == s0) {  // warp-uniform
          const float* col = st + (tid < ft::kTile
                                       ? tid
                                       : ft::kK * ft::kPitch + tid -
                                             ft::kTile);
#pragma unroll
          for (int kk = 0; kk < ft::kK; ++kk) {
            const float v = col[kk * ft::kPitch];
            const float term = v * v - nrm_c;
            const float sum = nrm + term;
            nrm_c = (sum - nrm) - term;
            nrm = sum;
          }
        }
      }
    }

    // the chunk's distances in place, +inf past its last row
    const int cend = min(c0 + ft::kTile, s1);
    if constexpr (KTILED && !IP) {
      if (tid >= ft::kTile) {
        yn[tid - ft::kTile] = nrm;
        nrm = nrm_c = 0.f;
      } else if (c0 == s0) {
        xn[tid] = nrm;
      }
      __syncthreads();
    }
    float xq[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + ft::q_of(i, ty);
      xq[i] = KTILED ? xn[ft::q_of(i, ty)]
                     : ((!IP && r < m) ? xx[r] : 0.f);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + ft::c_of(j, tx);
      float ycc = 0.f;
      if constexpr (!IP) {
        if constexpr (KTILED) ycc = yn[ft::c_of(j, tx)];
        else ycc = c < cend ? yy[c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v;
        if constexpr (IP) {
          v = -acc[i][j];
        } else {
          v = fmaxf((ycc + xq[i]) - 2.0f * acc[i][j], 0.f);
        }
        acc[i][j] = c < cend ? v : CUDART_INF_F;
      }
    }

    if constexpr (GENERAL) {
      float* dist = smem + ft::kRingBytes / 4;
      float* carry_v = dist + ft::kTile * kDistPitch;
      int* carry_i = reinterpret_cast<int*>(carry_v + 2 * ft::kTile);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dist[ft::q_of(i, ty) * kDistPitch + ft::c_of(j, tx)] = acc[i][j];
      __syncthreads();
      const int first = c0 / b;
      const int nseg = (cend - 1) / b - first + 1;
      const int parts = nseg == 1 ? 2 : 1;  // every thread a part
      const int pairs = ft::kTile * nseg * parts;
      const float* in_v = carry_v + parity * ft::kTile;
      const int* in_i = carry_i + parity * ft::kTile;
      float* out_v = carry_v + (parity ^ 1) * ft::kTile;
      int* out_i = carry_i + (parity ^ 1) * ft::kTile;
      for (int p = tid; p < pairs; p += ft::kThreads) {
        const int q = p / (nseg * parts);
        const int rem = p - q * nseg * parts;
        const int part = rem % parts;
        const int bin = first + rem / parts;
        const int lo = max(bin * b, c0), hi = min(bin * b + b, cend);
        const int mid = lo + (hi - lo + 1) / 2;
        const int r0 = parts == 1 || part == 0 ? lo : mid;
        const int r1 = parts == 1 || part == 1 ? hi : mid;
        float v = CUDART_INF_F;
        int vi = -1;
        for (int r = r0; r < r1; ++r) {
          const float dv = dist[q * kDistPitch + (r - c0)];
          if (dv < v) {
            v = dv;
            vi = r;
          }
        }
        if (parts == 2) {  // the pair's lanes are p and p ^ 1
          ft::lex_min(v, vi, __shfl_xor_sync(0xffffffffu, v, 1),
                      __shfl_xor_sync(0xffffffffu, vi, 1));
        }
        if (part == 0) {
          // the bin began in an earlier chunk: its open minimum
          if (bin * b < c0) ft::lex_min(v, vi, in_v[q], in_i[q]);
          if (min(bin * b + b, n) <= cend) {  // the bin closes here
            if (row0 + q < m) {
              const long long o = static_cast<long long>(row0 + q) * nb + bin;
              cand_d[o] = v;
              cand_i[o] = vi;
            }
          } else {
            out_v[q] = v;
            out_i[q] = vi;
          }
        }
      }
      parity ^= 1;
    } else if (b <= 64) {
      // bins inside a half: the strict walk over a thread's 4-row group
      // (or its pairs, or each row), then lex_min over the bin's lanes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g0 = c0 + h * 64 + tx * 4;  // the group's first row
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = row0 + ft::q_of(i, ty);
          const long long o = static_cast<long long>(row) * nb;
          if (b == 1) {  // a row a bin
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float v = acc[i][4 * h + j];
              const bool ok = v < CUDART_INF_F;
              if (row < m && g0 + j < cend) {
                cand_d[o + g0 + j] = ok ? v : CUDART_INF_F;
                cand_i[o + g0 + j] = ok ? g0 + j : -1;
              }
            }
          } else if (b == 2) {
#pragma unroll
            for (int j = 0; j < 4; j += 2) {
              float v = CUDART_INF_F;
              int vi = -1;
              if (acc[i][4 * h + j] < v) {
                v = acc[i][4 * h + j];
                vi = g0 + j;
              }
              if (acc[i][4 * h + j + 1] < v) {
                v = acc[i][4 * h + j + 1];
                vi = g0 + j + 1;
              }
              if (row < m && g0 + j < cend) {
                cand_d[o + ((g0 + j) >> 1)] = v;
                cand_i[o + ((g0 + j) >> 1)] = vi;
              }
            }
          } else {
            float v = CUDART_INF_F;
            int vi = -1;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (acc[i][4 * h + j] < v) {
                v = acc[i][4 * h + j];
                vi = g0 + j;
              }
            }
            ft::lex_min_lanes(v, vi, b >> 2);
            if (row < m && (tx & ((b >> 2) - 1)) == 0 && g0 < cend) {
              cand_d[o + (g0 >> lb)] = v;
              cand_i[o + (g0 >> lb)] = vi;
            }
          }
        }
      }
    } else {
      // halves inside a bin: each half's minimum over its 16 lanes, kept
      // by lane i for query i until the bin closes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int hs = c0 + h * 64;
        if (hs >= cend) break;  // uniform: the last bin closed at n
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = CUDART_INF_F;
          int vi = -1;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (acc[i][4 * h + j] < v) {
              v = acc[i][4 * h + j];
              vi = hs + tx * 4 + j;
            }
          }
          ft::lex_min_lanes(v, vi, 16);
          if (tx == i) ft::lex_min(open_v, open_i, v, vi);
        }
        if ((hs + 64) % b == 0 || hs + 64 >= n) {  // the bin closes
          const int row = row0 + ft::q_of(tx, ty);
          if (tx < 8 && row < m) {
            const long long o = static_cast<long long>(row) * nb + hs / b;
            cand_d[o] = open_v;
            cand_i[o] = open_i;
          }
          open_v = CUDART_INF_F;
          open_i = -1;
        }
      }
    }
    ft::zero(acc);
  }
  ring.drain();
}

template <bool KTILED, bool IP, bool GENERAL>
int launch_bins(const float* x, const float* y, const float* xx,
                const float* yy, int m, int n, int d, int b, long long nb,
                float* cand_d, int* cand_i, cudaStream_t s) {
  const int q_blocks = (m + ft::kTile - 1) / ft::kTile;
  // segments of whole bins: a multiple of b, and of the chunk where the
  // bins fit inside a half
  const long long unit =
      GENERAL ? b : (b <= 64 ? ft::kTile : static_cast<long long>(b));
  const long long want = (kTargetBlocks + q_blocks - 1) / q_blocks;
  const long long per = (static_cast<long long>(n) + want - 1) / want;
  const long long seg = (per + unit - 1) / unit * unit;
  const long long blocks =
      static_cast<long long>(q_blocks) * ((n + seg - 1) / seg);
  if (blocks > 0x7fffffffLL || seg > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = GENERAL ? kGeneralBytes : ft::kRingBytes;
  auto kernel = knn_bins_kernel<KTILED, IP, GENERAL>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), ft::kThreads, smem, s>>>(
      x, y, xx, yy, m, n, d, b, static_cast<int>(seg), q_blocks, nb, cand_d,
      cand_i);
  return static_cast<int>(cudaGetLastError());
}

template <bool KTILED, bool IP>
int launch_bins_any(const float* x, const float* y, const float* xx,
                    const float* yy, int m, int n, int d, int b, long long nb,
                    float* cand_d, int* cand_i, cudaStream_t s) {
  return register_bins(b)
             ? launch_bins<KTILED, IP, false>(x, y, xx, yy, m, n, d, b, nb,
                                              cand_d, cand_i, s)
             : launch_bins<KTILED, IP, true>(x, y, xx, yy, m, n, d, b, nb,
                                             cand_d, cand_i, s);
}

}  // namespace

// out (rows,) = squared L2 norms of the rows of x (rows, d).
extern "C" int raft_fused_knn_norms(const float* x, long long rows, int d,
                                    float* out, void* stream) {
  return raft_tpu_torch::launch_row_norms(x, rows, d, out,
                                          static_cast<cudaStream_t>(stream));
}

// Pass A in f32 (kernel 5, or kernel 6 with ktiled): x (m, d) queries, y
// (n, d) database, xx/yy their norms (kernel 5, L2 only; else unused) ->
// cand_d / cand_i (m, nb), nb = ceil(n / b), each bin's (minimum, row).
extern "C" int raft_fused_knn_bins(const float* x, const float* y,
                                   const float* xx, const float* yy, int m,
                                   int n, int d, int tn, int b, int ktiled,
                                   int ip, long long nb,
                                   float* cand_d, int* cand_i, void* stream) {
  if (m == 0) return 0;
  if (n < 1 || d < 1 || tn < 1 || b < 1 || tn % b != 0 ||
      nb != (n + b - 1) / b)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ktiled)
    return ip ? launch_bins_any<true, true>(x, y, xx, yy, m, n, d, b, nb,
                                            cand_d, cand_i, s)
              : launch_bins_any<true, false>(x, y, xx, yy, m, n, d, b, nb,
                                             cand_d, cand_i, s);
  return ip ? launch_bins_any<false, true>(x, y, xx, yy, m, n, d, b, nb,
                                           cand_d, cand_i, s)
            : launch_bins_any<false, false>(x, y, xx, yy, m, n, d, b, nb,
                                            cand_d, cand_i, s);
}

// Pass B (k <= 256): each query's k best candidates by (value, column),
// sqrt last; (+inf, -1) where none reaches.
extern "C" int raft_fused_knn_topk(const float* cand_d, const int* cand_i,
                                   int nq, long long nb, int k, int do_sqrt,
                                   float* out_d, int* out_i, void* stream) {
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return raft_tpu_torch::launch_radix_select(
      cand_d, cand_i, nq, static_cast<int>(nb), k, do_sqrt, out_d, out_i,
      static_cast<cudaStream_t>(stream));
}
