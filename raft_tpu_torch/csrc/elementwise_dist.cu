// Pairwise distances of the elementwise (non-matmul) family: for every
// (row of x, row of y), a per-coordinate core reduced over the feature axis
// and a finishing op. Nine cores, one template instantiation each: l1,
// l2unexp (+sqrt), linf, canberra, minkowski (runtime p), hamming,
// jensen_shannon, kl, braycurtis.
//
// Replaces: raft_tpu/ops/pallas_elementwise_dist.py:_elt_kernel (entry
// elementwise_dist_pallas). Contract kept: the cores of
// raft_tpu/distance/_elementwise_cores.py term for term (the port's copy is
// raft_tpu_torch/distance/_elementwise_cores.py): canberra's zero
// denominator gives 0; jensen_shannon guards a, b and m and finishes with
// sqrt(max(0.5 d, 0)); kl reads b <= 0 as 1; hamming divides by the
// unpadded dim; minkowski sums |a-b|^p and takes the 1/p root; braycurtis
// keeps two sums and reads a zero denominator as 1; linf reduces by max.
// logf, powf and '/' are the accurate versions (no fast intrinsics). The
// TPU kernel zero-pads the feature dim and relies on every core mapping
// (0, 0) to 0; this kernel masks the ragged chunk instead.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): instructions. The
// 67 TFLOP/s fp32 peak counts an FMA as two operations, so the card issues
// 33.5e12 fp32 instructions a second (128 lanes x 132 SMs x 1.98 GHz), and
// 4.2e12 special-function results (16 a clock per SM, the CUDA C++
// Programming Guide's throughput table for compute capability 9.0). L1 at
// 8192 x 8192 x 256 is 1.72e10 (i, j, dim) elements at ~2 instructions
// each (a subtract, an add of its absolute value): ~1.0 ms; the output's
// 268 MB take 0.08 ms. chip_smoke.py prints each core's bound and time.
//
// Design (simple first): one 256-thread block per 64 x 64 output tile;
// x and y rows staged through shared memory in 32-wide feature chunks,
// transposed so each thread reads its 4 rows of x and 4 rows of y as two
// float4 loads; each thread accumulates a 4 x 4 register tile (two tiles
// for braycurtis). The metric is a template parameter, so the inner loop
// holds only its own core.
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 64;
constexpr int kTN = 64;
constexpr int kTK = 32;
constexpr int kThreads = 256;

// the tags of raft_tpu_torch/ops/elementwise_dist.py:METRIC_IDS
enum Metric {
  kL1 = 0,
  kL2Unexp = 1,
  kLinf = 2,
  kCanberra = 3,
  kMinkowski = 4,
  kHamming = 5,
  kJensenShannon = 6,
  kKL = 7,
  kBrayCurtis = 8,
};

template <int M>
__device__ __forceinline__ void accum(float& s, float& t, float a, float b,
                                      float p) {
  if constexpr (M == kL1) {
    s += fabsf(a - b);
  } else if constexpr (M == kL2Unexp) {
    const float d = a - b;
    s += d * d;
  } else if constexpr (M == kLinf) {
    s = fmaxf(s, fabsf(a - b));
  } else if constexpr (M == kCanberra) {
    const float num = fabsf(a - b);
    const float den = fabsf(a) + fabsf(b);
    s += den == 0.f ? 0.f : num / den;
  } else if constexpr (M == kMinkowski) {
    s += powf(fabsf(a - b), p);
  } else if constexpr (M == kHamming) {
    s += (a != b) ? 1.f : 0.f;
  } else if constexpr (M == kJensenShannon) {
    const float m = 0.5f * (a + b);
    const float safe_m = m > 0.f ? m : 1.f;
    const float ta = a > 0.f ? a * logf(a / safe_m) : 0.f;
    const float tb = b > 0.f ? b * logf(b / safe_m) : 0.f;
    s += ta + tb;
  } else if constexpr (M == kKL) {
    const float den = b > 0.f ? b : 1.f;
    s += a > 0.f ? a * logf(a / den) : 0.f;
  } else {  // kBrayCurtis
    s += fabsf(a - b);
    t += fabsf(a + b);
  }
}

template <int M>
__device__ __forceinline__ float finish(float s, float t, float p, int dim,
                                        int do_sqrt) {
  if constexpr (M == kBrayCurtis) return s / (t == 0.f ? 1.f : t);
  if constexpr (M == kL2Unexp) return do_sqrt ? sqrtf(fmaxf(s, 0.f)) : s;
  if constexpr (M == kMinkowski) return powf(s, 1.f / p);
  if constexpr (M == kHamming) return s / static_cast<float>(dim);
  if constexpr (M == kJensenShannon) return sqrtf(fmaxf(0.5f * s, 0.f));
  return s;
}

template <int M>
__device__ __forceinline__ void chunk_step(float (*xs)[kTM + 4],
                                           float (*ys)[kTN + 4],
                                           int kk, int tx, int ty,
                                           float (&s)[4][4], float (&t)[4][4],
                                           float p) {
  const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
  const float4 b = *reinterpret_cast<const float4*>(&ys[kk][tx * 4]);
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accum<M>(s[i][j], t[i][j], av[i], bv[j], p);
}

template <int M>
__global__ __launch_bounds__(kThreads) void elementwise_dist_kernel(
    const float* __restrict__ x, const float* __restrict__ y, int m, int n,
    int d, float p, int do_sqrt, float* __restrict__ out) {
  __shared__ __align__(16) float xs[kTK][kTM + 4];
  __shared__ __align__(16) float ys[kTK][kTN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3
  const long long row0 = static_cast<long long>(blockIdx.y) * kTM;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTN;

  float s[4][4], t[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kTK) {
    const int kc = min(kTK, d - k0);
    for (int e = tid; e < kTM * kTK; e += kThreads) {
      const int r = e / kTK, kk = e % kTK;
      const long long gr = row0 + r, gc = col0 + r;
      xs[kk][r] = (gr < m && kk < kc) ? x[gr * d + k0 + kk] : 0.f;
      ys[kk][r] = (gc < n && kk < kc) ? y[gc * d + k0 + kk] : 0.f;
    }
    __syncthreads();
    if (kc == kTK) {
#pragma unroll 8
      for (int kk = 0; kk < kTK; ++kk)
        chunk_step<M>(xs, ys, kk, tx, ty, s, t, p);
    } else {  // the ragged last chunk: only its real coordinates
      for (int kk = 0; kk < kc; ++kk)
        chunk_step<M>(xs, ys, kk, tx, ty, s, t, p);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty * 4 + i;
    if (r >= m) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = col0 + tx * 4 + j;
      if (c < n) out[r * n + c] = finish<M>(s[i][j], t[i][j], p, d, do_sqrt);
    }
  }
}

template <int M>
int launch(const float* x, const float* y, int m, int n, int d, float p,
           int do_sqrt, float* out, cudaStream_t s) {
  const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
  elementwise_dist_kernel<M><<<grid, kThreads, 0, s>>>(x, y, m, n, d, p,
                                                       do_sqrt, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, d), y (n, d) f32 row-major -> out (m, n); m <= 65535 * 64 (the
// wrapper splits larger x). Returns the launch's cudaError.
extern "C" int raft_elementwise_dist(const float* x, const float* y, int m,
                                     int n, int d, int metric, float p,
                                     int do_sqrt, float* out, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (d < 1 || (m + kTM - 1) / kTM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL1: return launch<kL1>(x, y, m, n, d, p, do_sqrt, out, s);
    case kL2Unexp: return launch<kL2Unexp>(x, y, m, n, d, p, do_sqrt, out, s);
    case kLinf: return launch<kLinf>(x, y, m, n, d, p, do_sqrt, out, s);
    case kCanberra: return launch<kCanberra>(x, y, m, n, d, p, do_sqrt, out, s);
    case kMinkowski:
      return launch<kMinkowski>(x, y, m, n, d, p, do_sqrt, out, s);
    case kHamming: return launch<kHamming>(x, y, m, n, d, p, do_sqrt, out, s);
    case kJensenShannon:
      return launch<kJensenShannon>(x, y, m, n, d, p, do_sqrt, out, s);
    case kKL: return launch<kKL>(x, y, m, n, d, p, do_sqrt, out, s);
    case kBrayCurtis:
      return launch<kBrayCurtis>(x, y, m, n, d, p, do_sqrt, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
