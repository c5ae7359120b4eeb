// Exact per-row k-selection (k <= 256), smallest first: kernel 2 and the
// fused scans' pass B on their own (radix_select.cuh, which holds the
// kernel, its contract, bound and design).
//
// Replaces: raft_tpu/ops/pallas_select_k.py:_select_kernel (entry
// select_k_pallas). Measured before the radix select, the all-pairs rank
// merge took 0.105-0.426 ms at the coarse shapes (128, 1024) and (128,
// 4096), 4.7-11.8x torch.topk (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_smoke.py). The wrapper's host path is kept short: at ~10 us of
// device time a call, a Python launch costs as much as the kernel.
#include <cuda_runtime.h>

#include "radix_select.cuh"

// v (m, n) -> out_v/out_i (m, k), ids the columns; 1 <= k <= min(256, n).
extern "C" int raft_select_k(const float* v, int m, int n, int k,
                             float* out_v, int* out_i, void* stream) {
  return raft_tpu_torch::launch_radix_select(
      v, nullptr, m, n, k, 0, out_v, out_i,
      static_cast<cudaStream_t>(stream));
}

// Pass B alone: v/ids (m, n) candidate rows -> out_v/out_i (m, k), k <= 256,
// any n >= 0; (+inf, -1) where no candidate reaches; sqrt last.
extern "C" int raft_select_k_payload(const float* v, const int* ids, int m,
                                     int n, int k, int do_sqrt, float* out_v,
                                     int* out_i, void* stream) {
  if (ids == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return raft_tpu_torch::launch_radix_select(
      v, ids, m, n, k, do_sqrt, out_v, out_i,
      static_cast<cudaStream_t>(stream));
}
