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
// Measured 3.10 ms there (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py).
//
// Design (simple first): a prologue kernel computes the row norms of x and
// y (one warp per row). The main kernel gives each block a 64-row tile of x
// and walks all of y in 64-row tiles, staging 16-wide K-slices of both
// through shared memory; each of the 256 threads accumulates a 4x4 register
// tile of dot products in fp32 FMA. The argmin epilogue runs in registers:
// each thread scans its 4 columns in ascending order, then the 16 threads
// that share a row combine (distance, index) pairs lexicographically with
// warp shuffles, which equals the sequential strict-'<' walk. Every block
// sees all of y, so there is no cross-block reduction. With 1024 centres
// this is enough parallelism (4096 blocks at the k-means shape); wgmma/TF32
// are deliberately not used: the contract is fp32.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kTM = 64;
constexpr int kTN = 64;
constexpr int kTK = 16;
constexpr int kThreads = 256;

__global__ void row_norms_kernel(const float* __restrict__ x, long long rows,
                                 int d, float* __restrict__ out) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;  // uniform per warp
  const float* xr = x + warp * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float a = xr[j];
    s = fmaf(a, a, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[warp] = s;
}

__global__ __launch_bounds__(kThreads) void fused_l2_nn_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ xx, const float* __restrict__ yy, int m, int n,
    int d, int do_sqrt, int* __restrict__ out_i, float* __restrict__ out_d) {
  __shared__ __align__(16) float xs[kTK][kTM + 4];
  __shared__ __align__(16) float ys[kTK][kTN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: tile columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // row group: tile rows ty*4 .. ty*4+3
  const long long row0 = static_cast<long long>(blockIdx.x) * kTM;

  float xxr[4], best_d[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty * 4 + i;
    xxr[i] = r < m ? xx[r] : 0.f;
    best_d[i] = CUDART_INF_F;
    best_i[i] = INT_MAX;
  }

  for (int c0 = 0; c0 < n; c0 += kTN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kTK) {
      for (int e = tid; e < kTM * kTK; e += kThreads) {
        const int r = e / kTK, kk = e % kTK;
        const long long gr = row0 + r;
        const int gk = k0 + kk;
        xs[kk][r] = (gr < m && gk < d) ? x[gr * d + gk] : 0.f;
        const long long gc = static_cast<long long>(c0) + r;
        ys[kk][r] = (gc < n && gk < d) ? y[gc * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&ys[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c >= n) break;
      const float ycc = yy[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dd = fmaxf((ycc + xxr[i]) - 2.0f * acc[i][j], 0.f);
        if (dd < best_d[i]) {
          best_d[i] = dd;
          best_i[i] = c;
        }
      }
    }
  }

  // the 16 threads of a row group are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best_d[i], o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[i], o);
      if (od < best_d[i] || (od == best_d[i] && oi < best_i[i])) {
        best_d[i] = od;
        best_i[i] = oi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long r = row0 + ty * 4 + i;
      if (r < m) {
        out_i[r] = best_i[i] == INT_MAX ? 0 : best_i[i];
        out_d[r] = do_sqrt ? sqrtf(best_d[i]) : best_d[i];
      }
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
  const int warps_per_block = kThreads / 32;
  row_norms_kernel<<<(m + warps_per_block - 1) / warps_per_block, kThreads,
                     0, s>>>(x, m, d, xx);
  row_norms_kernel<<<(n + warps_per_block - 1) / warps_per_block, kThreads,
                     0, s>>>(y, n, d, yy);
  fused_l2_nn_kernel<<<(m + kTM - 1) / kTM, kThreads, 0, s>>>(
      x, y, xx, yy, m, n, d, do_sqrt, out_i, out_d);
  return static_cast<int>(cudaGetLastError());
}
