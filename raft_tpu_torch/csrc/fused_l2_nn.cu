// Fused L2 nearest neighbour: for each row of x, the index and squared-L2
// distance of its nearest row of y (optionally sqrt'd), without the (m, n)
// distance matrix.
//
// Replaces: raft_tpu/ops/pallas_fused_l2_nn.py:_nn_kernel (entry
// fused_l2_nn_pallas). Contract kept: d = max((|y|^2 + |x|^2) - 2 x.y, 0),
// walked over y in ascending order with a strict '<' from the state
// (+inf, index 0), so among equal minima the lowest index wins and a row
// that never improves on +inf reports index 0.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): operations. 2*m*n*d fp32
// FLOPs against (m + n)*d*4 bytes read; at the k-means shape
// (262144 x 128) x (1024 x 128) that is 68.7 GFLOP over 135 MB, ~1.03 ms at
// the 67 TFLOP/s fp32 (non-tensor-core) peak versus 0.04 ms for the bytes.
// Measured 1.96 ms there, 1.18x the card's own f32 torch.mm of the same
// product and 1.9x the bound (NVIDIA H100 80GB HBM3, 700.00 W; row
// fused_l2_nn@highest of chip_smoke.py; the simple first body took 3.07).
//
// Design: a prologue kernel computes the row norms of x and y (one warp per
// row). The main kernel gives each block 128 rows of x and walks all of y
// in 128-row chunks through f32_tile.cuh's product loop (8 x 8 register
// tiles, a ring of k-major stages loaded by cp.async, one barrier a
// stage; every dot product one fmaf chain over ascending features, as
// the simple first body of PR 1 took it, so distances and indices are
// bit for bit that body's). The argmin runs in registers: after each
// chunk a thread walks its 8 columns in ascending order with the strict
// '<', the 16 lanes of a row group combine (distance, index) pairs
// lexicographically with shuffles, which equals the sequential walk, and
// lane i of the group keeps row i's running minimum across chunks. Every
// block sees all of y, so there is no cross-block reduction (2048 blocks
// at the k-means shape, 78125 at the 10M-row predict); wgmma/TF32 are
// deliberately not used: the contract is fp32.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "f32_tile.cuh"
#include "row_norms.cuh"

namespace {

namespace ft = raft_tpu_torch::f32t;

__global__ __launch_bounds__(ft::kThreads, 2) void fused_l2_nn_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ xx, const float* __restrict__ yy, int m, int n,
    int d, int do_sqrt, int* __restrict__ out_i, float* __restrict__ out_d) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns c_of(j, tx) of each chunk
  const int ty = tid >> 4;  // rows q_of(i, ty) of the block
  const int row0 = blockIdx.x * ft::kTile;

  // lane tx < 8 of a row group: row q_of(tx, ty)'s nearest y row so far
  float best_d = CUDART_INF_F;
  int best_i = -1;
  float acc[8][8];
  ft::zero(acc);
  ft::Ring ring(reinterpret_cast<float*>(smem4), x, row0,
                min(row0 + ft::kTile, m), y, 0, n, d);
  for (int c0 = 0; c0 < n; c0 += ft::kTile) {
    for (int ks = 0; ks < ring.nks; ++ks)
      ft::mma_slice(ring.next(), ty, tx, acc);

    const int cend = min(c0 + ft::kTile, n);
    float xq[8], ycc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + ft::q_of(i, ty);
      xq[i] = r < m ? xx[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + ft::c_of(j, tx);
      ycc[j] = c < cend ? yy[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = CUDART_INF_F;
      int vi = -1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // ascending columns
        const int c = c0 + ft::c_of(j, tx);
        const float dd = fmaxf((ycc[j] + xq[i]) - 2.0f * acc[i][j], 0.f);
        if (c < cend && dd < v) {
          v = dd;
          vi = c;
        }
      }
      ft::lex_min_lanes(v, vi, 16);
      if (tx == i) ft::lex_min(best_d, best_i, v, vi);
    }
    ft::zero(acc);
  }
  ring.drain();

  if (tx < 8) {
    const int r = row0 + ft::q_of(tx, ty);
    if (r < m) {
      out_i[r] = best_i < 0 ? 0 : best_i;
      out_d[r] = do_sqrt ? sqrtf(best_d) : best_d;
    }
  }
}

}  // namespace

// xx (m,) and yy (n,) are caller-allocated scratch for the row norms.
extern "C" int raft_fused_l2_nn(const float* x, const float* y, float* xx,
                                float* yy, int m, int n, int d, int do_sqrt,
                                int* out_i, float* out_d, void* stream) {
  if (m == 0) return 0;
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = raft_tpu_torch::launch_row_norms(x, m, d, xx, s);
  if (rc == 0) rc = raft_tpu_torch::launch_row_norms(y, n, d, yy, s);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_l2_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ft::kRingBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_l2_nn_kernel<<<(m + ft::kTile - 1) / ft::kTile, ft::kThreads,
                       ft::kRingBytes, s>>>(x, y, xx, yy, m, n, d, do_sqrt,
                                            out_i, out_d);
  return static_cast<int>(cudaGetLastError());
}
