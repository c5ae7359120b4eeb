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
//
// Design (simple first): pass A gives each 256-thread block 64 queries and
// one db tile, walked in 64-row chunks; a chunk's dot products are staged
// through shared memory in 16-wide feature slices, each thread holding a
// 4 x 4 register tile (fused_l2_nn.cu's product loop); the chunk's 64 x 64
// distances go to shared memory, and one thread per query walks its row in
// ascending order carrying the open bin's (min, row) across chunks,
// writing each bin's candidate when the bin closes. Blocks are ordered
// query-block fastest, so the blocks that share a db tile run together and
// read it from L2. Kernel 5 takes the row norms from a prologue; kernel 6
// (the d > 4096 launch, tn = 1024) accumulates them from the staged slices
// inside its product loop, as the TPU kernel keeps them in scratch.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "radix_select.cuh"
#include "row_norms.cuh"

namespace {

constexpr int kTM = 64;  // queries per block
constexpr int kTN = 64;  // db rows per chunk
constexpr int kTK = 16;  // feature slice staged in shared memory
constexpr int kThreads = 256;

template <bool KTILED, bool IP>
__global__ __launch_bounds__(kThreads) void knn_bins_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ xx, const float* __restrict__ yy, int m, int n,
    int d, int tn, int b, int q_blocks, long long nb,
    float* __restrict__ cand_d, int* __restrict__ cand_i) {
  __shared__ __align__(16) float xs[kTK][kTM + 4];
  __shared__ __align__(16) float ys[kTK][kTN + 4];
  __shared__ float dist[kTM][kTN + 1];
  __shared__ float xn[kTM];  // kernel 6: norms of the block's queries
  __shared__ float yn[kTN];  // kernel 6: norms of the chunk's rows

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // chunk rows tx*4 .. tx*4+3
  const int ty = tid / 16;  // queries ty*4 .. ty*4+3
  const long long row0 = static_cast<long long>(blockIdx.x % q_blocks) * kTM;
  const long long t0 = static_cast<long long>(blockIdx.x / q_blocks) * tn;
  const long long t1 = min(t0 + tn, static_cast<long long>(n));

  float xxr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty * 4 + i;
    xxr[i] = (!KTILED && !IP && r < m) ? xx[r] : 0.f;
  }
  // the walk of thread tid < kTM over query row0 + tid: the open bin's
  // (min, row), its column and its last row (t0 is a multiple of b)
  float cur = CUDART_INF_F;
  int cur_i = -1;
  long long col = t0 / b, close = t0 + b - 1;

  for (long long c0 = t0; c0 < t1; c0 += kTN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // kernel 6: tid < 64 a query's norm, < 128 a row's, summed with
    // Kahan compensation: 8192 sequential terms would otherwise round to
    // ~0.04 at |y|^2 ~ 8192, enough to reorder near neighbours
    float nrm = 0.f, nrm_c = 0.f;

    for (int k0 = 0; k0 < d; k0 += kTK) {
      for (int e = tid; e < kTM * kTK; e += kThreads) {
        const int r = e / kTK, kk = e % kTK;
        const int gk = k0 + kk;
        const long long gr = row0 + r, gc = c0 + r;
        xs[kk][r] = (gr < m && gk < d) ? x[gr * d + gk] : 0.f;
        ys[kk][r] = (gc < t1 && gk < d) ? y[gc * d + gk] : 0.f;
      }
      __syncthreads();
      if constexpr (KTILED && !IP) {
        if (tid < kTM + kTN) {
#pragma unroll
          for (int kk = 0; kk < kTK; ++kk) {
            const float v = tid < kTM ? xs[kk][tid] : ys[kk][tid - kTM];
            const float term = v * v - nrm_c;
            const float sum = nrm + term;
            nrm_c = (sum - nrm) - term;
            nrm = sum;
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        const float4 bb = *reinterpret_cast<const float4*>(&ys[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    if constexpr (KTILED && !IP) {
      if (tid < kTM) xn[tid] = nrm;
      else if (tid < kTM + kTN) yn[tid - kTM] = nrm;
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = c0 + tx * 4 + j;
      float ycc = 0.f;
      if constexpr (!IP) {
        if constexpr (KTILED) ycc = yn[tx * 4 + j];
        else ycc = c < t1 ? yy[c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v;
        if constexpr (IP) {
          v = -acc[i][j];
        } else {
          const float xq = KTILED ? xn[ty * 4 + i] : xxr[i];
          v = fmaxf((ycc + xq) - 2.0f * acc[i][j], 0.f);
        }
        dist[ty * 4 + i][tx * 4 + j] = v;
      }
    }
    __syncthreads();
    // the next chunk's first barrier keeps dist until every walk is done
    if (tid < kTM && row0 + tid < m) {
      const long long c1 = min(c0 + kTN, t1);
      float* od = cand_d + (row0 + tid) * nb;
      int* oi = cand_i + (row0 + tid) * nb;
      for (long long r = c0; r < c1; ++r) {
        const float v = dist[tid][r - c0];
        if (v < cur) {
          cur = v;
          cur_i = static_cast<int>(r);
        }
        if (r == close || r + 1 == t1) {  // the bin closes
          od[col] = cur;
          oi[col] = cur_i;
          cur = CUDART_INF_F;
          cur_i = -1;
          ++col;
          close += b;
        }
      }
    }
  }
}

template <bool KTILED, bool IP>
int launch_bins(const float* x, const float* y, const float* xx,
                const float* yy, int m, int n, int d, int tn, int b,
                long long nb, float* cand_d, int* cand_i, cudaStream_t s) {
  const int q_blocks = (m + kTM - 1) / kTM;
  const long long blocks =
      static_cast<long long>(q_blocks) * ((n + tn - 1) / tn);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  knn_bins_kernel<KTILED, IP><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(
      x, y, xx, yy, m, n, d, tn, b, q_blocks, nb, cand_d, cand_i);
  return static_cast<int>(cudaGetLastError());
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
    return ip ? launch_bins<true, true>(x, y, xx, yy, m, n, d, tn, b, nb,
                                        cand_d, cand_i, s)
              : launch_bins<true, false>(x, y, xx, yy, m, n, d, tn, b, nb,
                                         cand_d, cand_i, s);
  return ip ? launch_bins<false, true>(x, y, xx, yy, m, n, d, tn, b, nb,
                                       cand_d, cand_i, s)
            : launch_bins<false, false>(x, y, xx, yy, m, n, d, tn, b, nb,
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
