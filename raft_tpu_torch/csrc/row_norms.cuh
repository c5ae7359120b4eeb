// Squared L2 norm of every row, one warp per row: the prologue of
// fused_l2_nn.cu and fused_knn.cu.
#pragma once

#include <cuda_runtime.h>

namespace raft_tpu_torch {
namespace {

constexpr int kNormThreads = 256;

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

// out (rows,) = |x_r|^2 of x (rows, d); returns the launch's cudaError.
inline int launch_row_norms(const float* x, long long rows, int d,
                            float* out, cudaStream_t s) {
  if (rows == 0) return 0;
  const long long warps_per_block = kNormThreads / 32;
  row_norms_kernel<<<static_cast<unsigned>((rows + warps_per_block - 1) /
                                           warps_per_block),
                     kNormThreads, 0, s>>>(x, rows, d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace raft_tpu_torch
