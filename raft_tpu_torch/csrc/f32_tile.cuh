// The f32 product loop shared by the CUDA-core bodies of kernel 1
// (fused_l2_nn.cu) and kernels 5 and 6 (fused_knn.cu, "highest"): one
// 256-thread block computes the dot products of 128 rows of x against y
// walked in chunks of 128 rows, each thread an 8 x 8 register tile.
//
// Arithmetic: every dot product is one fmaf chain over ascending feature
// index from +0 (no split over features, no reordering), so its value does
// not depend on the tiling.
//
// Design for Hopper's CUDA cores (bound: fp32 FMAs, 67 TFLOP/s):
//  - 8 x 8 register tiles: 64 FFMAs for 16 floats read from shared memory
//    (four LDS.128) a feature;
//  - operands staged k-major (stage[k][row], a feature's 128 rows
//    contiguous), kK = 16 features a stage, in a ring of kStages stages:
//    the copies of stage s + kStages - 1 are issued before stage s's FFMAs,
//    one barrier a stage. The copies are 4-byte cp.async, each thread
//    moving one float of a row to its k-major slot, so the transpose costs
//    no register and any d or row alignment takes the same path; a warp
//    copies 8 consecutive features of 4 rows (32-byte runs of global
//    memory) into 32 distinct banks (the pitch of 132 floats puts feature
//    k at bank 4k);
//  - a thread's queries are ty*4 + {0..3} and 64 + ty*4 + {0..3} and its
//    rows tx*4 + {0..3} and 64 + tx*4 + {0..3} (ty = tid / 16, tx = tid %
//    16): the LDS.128 of a warp read two query vectors (a broadcast) and
//    16 consecutive row vectors (two wavefronts, no conflict). The 16
//    threads of a query group are 16 lanes of one warp, so a row's
//    reduction over the chunk is a few shuffles.
#pragma once

#include <cuda_runtime.h>

namespace raft_tpu_torch {
namespace f32t {

constexpr int kTile = 128;         // rows of x a block; rows of y a chunk
constexpr int kK = 16;             // features a stage
constexpr int kPitch = kTile + 4;  // floats a staged feature (16-byte rows)
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStageFloats = 2 * kK * kPitch;  // x's slice, then y's
constexpr int kRingBytes = kStages * kStageFloats * 4;

// the query (x row) and the y row of a thread's accumulator acc[i][j],
// relative to the block's first query and the chunk's first row
__device__ __forceinline__ int q_of(int i, int ty) {
  return (i < 4 ? 0 : 64 - 4) + ty * 4 + i;
}
__device__ __forceinline__ int c_of(int j, int tx) {
  return (j < 4 ? 0 : 64 - 4) + tx * 4 + j;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// Copies features [k0, k0 + kK) of x's rows [a0, a0 + kTile) and y's rows
// [b0, b0 + kTile) into stage st, k-major; zeros at rows past a1 / b1 and
// features past d (they add fmaf(0, 0, acc) = acc to every chain).
__device__ __forceinline__ void stage_slice(float* st,
                                            const float* __restrict__ x,
                                            int a0, int a1,
                                            const float* __restrict__ y,
                                            int b0, int b1, int d, int k0,
                                            int tid) {
  const int kl = tid & 7, r = tid >> 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + kl + 8 * h;
    float* sa = st + (kl + 8 * h) * kPitch + r;
    float* sb = sa + kK * kPitch;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int ra = a0 + r + 32 * v, rb = b0 + r + 32 * v;
      const bool pa = k < d && ra < a1, pb = k < d && rb < b1;
      cp_async4(sa + 32 * v, pa ? x + static_cast<size_t>(ra) * d + k : x,
                pa);
      cp_async4(sb + 32 * v, pb ? y + static_cast<size_t>(rb) * d + k : y,
                pb);
    }
  }
}

// acc[i][j] = fmaf(x_q(i)[k], y_c(j)[k], acc[i][j]) for the stage's kK
// features in ascending order
__device__ __forceinline__ void mma_slice(const float* st, int ty, int tx,
                                          float (&acc)[8][8]) {
  const float* sa = st;
  const float* sb = st + kK * kPitch;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(sa + kk * kPitch +
                                                       ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(sa + kk * kPitch +
                                                       64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * kPitch +
                                                       tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * kPitch +
                                                       64 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// The ring of stages over y's rows [b0, b1) in chunks of kTile rows and
// ceil(d / kK) stages a chunk: construct it, then call next() once a
// stage, in order, and drain() after the last.
struct Ring {
  float* base;
  const float* x;
  const float* y;
  int a0, a1, b1, d, nks;
  int ib, iks, ist, cst;  // the next stage to copy (row, slice, slot);
                          // the next slot to read

  __device__ __forceinline__ Ring(float* smem, const float* x_, int a0_,
                                  int a1_, const float* y_, int b0, int b1_,
                                  int d_)
      : base(smem), x(x_), y(y_), a0(a0_), a1(a1_), b1(b1_), d(d_),
        nks((d_ + kK - 1) / kK), ib(b0), iks(0), ist(0), cst(0) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue();
  }

  __device__ __forceinline__ void issue() {
    if (ib < b1) {
      stage_slice(base + ist * kStageFloats, x, a0, a1, y, ib,
                  min(ib + kTile, b1), d, iks * kK, threadIdx.x);
      if (++iks == nks) {
        iks = 0;
        ib += kTile;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    ist = ist + 1 == kStages ? 0 : ist + 1;
  }

  // The next stage, landed for every thread; the copy kStages - 1 stages
  // ahead is in flight. The barrier also frees the slot read last, which
  // that copy refills.
  __device__ __forceinline__ const float* next() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    issue();
    const float* st = base + cst * kStageFloats;
    cst = cst + 1 == kStages ? 0 : cst + 1;
    return st;
  }

  __device__ __forceinline__ void drain() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
};

// (v, i) <- the smaller of (v, i) and (ov, oi) by value, then by index, -1
// the largest index: the result of a strict '<' walk over both parts in
// ascending order, when each part is one (a finite value and its row, or
// (+inf, -1))
__device__ __forceinline__ void lex_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && static_cast<unsigned>(oi) <
                                static_cast<unsigned>(i))) {
    v = ov;
    i = oi;
  }
}

// lex_min over the lanes whose tx differ in the bits below `lanes` (a
// power of two <= 16): every such lane ends with the group's result
__device__ __forceinline__ void lex_min_lanes(float& v, int& i, int lanes) {
  for (int o = 1; o < lanes; o <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    lex_min(v, i, ov, oi);
  }
}

}  // namespace f32t
}  // namespace raft_tpu_torch
