// Pairwise distances of the elementwise (non-matmul) family: for every
// (row of x, row of y), a per-coordinate core reduced over the feature axis
// and a finishing op. Nine cores, one template instantiation each: l1,
// l2unexp (+sqrt), linf, canberra, minkowski (runtime p), hamming,
// jensen_shannon, kl, braycurtis.
//
// Replaces: raft_tpu/ops/pallas_elementwise_dist.py:_elt_kernel (entry
// elementwise_dist_pallas). Contract kept: the cores of
// raft_tpu/distance/_elementwise_cores.py (the port's copy is
// raft_tpu_torch/distance/_elementwise_cores.py), with their guards:
// canberra's zero denominator gives 0; jensen_shannon reads m <= 0 as 1
// and a <= 0 (b <= 0) as a zero term, and finishes with sqrt(max(0.5 d,
// 0)); kl reads a <= 0 as a zero term and b <= 0 as 1; hamming counts
// exactly and divides by the unpadded dim; minkowski sums |a-b|^p and
// takes the 1/p root; braycurtis keeps two sums and reads a zero
// denominator as 1; linf reduces by max. The TPU kernel zero-pads the
// feature dim; this kernel masks the ragged chunk instead.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): instructions. The
// 67 TFLOP/s fp32 peak counts an FMA as two operations, so the card issues
// 33.5e12 fp32 instructions a second (128 lanes x 132 SMs x 1.98 GHz), and
// 4.2e12 special-function results (16 a clock per SM, the CUDA C++
// Programming Guide's throughput table for compute capability 9.0). Per
// (i, j, dim) element the least work is (fp32 instructions, special-
// function results): l1, l2unexp, linf, hamming, kl (2, 0); braycurtis
// (4, 0); canberra (5, 1); minkowski (3, 2); jensen_shannon (8, 1)
// (chip_smoke.py's ELT_WORK). L1 at 8192 x 8192 x 256 is 1.72e10 elements
// at 2 instructions each: ~1.0 ms; the output's 268 MB take 0.08 ms.
//
// Design, from that bound:
// - Per-operand work at staging. Each staged element of x is reused by
//   every column of the block's tile and each element of y by every row,
//   so logs of a and b are taken once per staged element. kl stages
//   (a > 0 ? a : 0, a > 0 ? log2 a : 0) for x and (b > 0 ? log2 b : 0)
//   for y, sums pa (la - lb), two instructions a pair, and multiplies by
//   ln 2 at the finish; its staged logs are the accurate log2f and its
//   chunks fold into Kahan-compensated totals, because its terms change
//   sign and their f32 sum cancels (see Cfg). jensen_shannon stages
//   (v, v > 0 ? v : 0, v > 0 ? lg2(v + v) : 0) on both sides, so log(a / m)
//   is lg2(a + a) - lg2(a + b) in base 2: one lg2 a pair, no halving, and
//   m <= 0 (read as 1) is a + b read as 2. The staged and the per-pair
//   logs go through the same lg2.approx.f32 on the same sums, so equal
//   inputs cancel exactly: x against itself has a zero diagonal, as in the
//   reference.
// - The special-function unit for the per-pair work: minkowski is
//   ex2(p lg2|a - b|), and keeps powf(s, 1/p) at the finish, once an
//   output; canberra is __fdividef(num, max(den, 2^-149)), one rcp.approx
//   (a zero den reads as the least subnormal, over which a zero num stays
//   0). lg2, ex2 and the reciprocal are the forms without .ftz, and the
//   build sets no fast math: a subnormal m must not read as 0. Each costs
//   three fp32 instructions of range fix-up beside its special-function
//   result.
// - A register-tiled body (tiles in Cfg): 256 threads a block. Features
//   are staged in chunks of 16: each thread loads its share as 16-byte
//   loads when d % 4 == 0 and both pointers are 16-byte aligned (scalar
//   loads otherwise), applies the per-operand transform and stores it
//   transposed, [plane][k][row], rows padded by 4 floats, which keeps the
//   stores free of bank conflicts; a thread's rows of x and columns of y
//   are read as float4s.
// - Overlapped staging: chunk c + 1 is loaded into registers before chunk
//   c's pairs, then transformed into the other of two shared buffers; one
//   __syncthreads a chunk. Registers, not cp.async or TMA, because the
//   logs and guards are applied on the way in.
// The metric is a template parameter, so the inner loop holds only its own
// core; a second one, whether the rows take 16-byte loads.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBK = 16;        // features a staged chunk
constexpr float kLn2 = 0.69314718055994530942f;
// canberra's floor of |a| + |b|: the least nonzero value, so a zero
// denominator reads as one over which a zero numerator stays 0
constexpr float kCanberraFloor = 0x1p-149f;

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

// Per-metric tile. Each thread sums a TM x TN tile of outputs over PX / PY
// staged planes of x / y; the block's 16 x 16 threads cover 16 TM rows and
// 16 TN columns.
// - The two-instruction differences (l1, l2unexp, linf, hamming): 8 x 8 at
//   two blocks an SM, the chunk loop not unrolled (unrolled, it spills).
// - braycurtis (two sums) and kl: 8 x 4. kl's terms change sign, and on
//   data with negative values its f32 sum over many features cancels to a
//   small result: each chunk's sums fold into Kahan-compensated totals
//   (kFold), and its staged logs are the accurate log2f. (lg2.approx, or
//   a fold every two chunks, missed the card test's tolerance at d = 5000.)
// - The special-function cores (canberra, minkowski, jensen_shannon):
//   4 x 4 at four blocks an SM (three for jensen_shannon's six planes):
//   their per-pair chains are long, and more warps hide them.
template <int M>
struct Cfg {
  static constexpr bool kFold = M == kKL;
  static constexpr bool kSfu =
      M == kCanberra || M == kMinkowski || M == kJensenShannon;
  static constexpr bool kDiff =
      M == kL1 || M == kL2Unexp || M == kLinf || M == kHamming;
  static constexpr int kTM = kSfu ? 4 : 8;
  static constexpr int kTN = kDiff ? 8 : 4;
  static constexpr int kMinBlocks = M == kJensenShannon ? 3 : kSfu ? 4 : 2;
  static constexpr int kUnroll = kDiff ? 1 : 4;
  static constexpr int kBM = 16 * kTM;
  static constexpr int kBN = 16 * kTN;
  static constexpr int kPX = M == kJensenShannon ? 3 : M == kKL ? 2 : 1;
  static constexpr int kPY = M == kJensenShannon ? 3 : 1;
  static constexpr int kSX = kBM + 4;  // padded row strides of the planes
  static constexpr int kSY = kBN + 4;
  static constexpr int kXFloats = kPX * kBK * kSX;  // one buffer's x planes
  static constexpr int kBufFloats = kXFloats + kPY * kBK * kSY;
  // the fold's compensations: TM x TN floats a thread
  static constexpr int kFoldFloats = kFold ? kTM * kTN * kThreads : 0;
  static constexpr int kSmemBytes = (2 * kBufFloats + kFoldFloats) * 4;
};

__device__ __forceinline__ float lg2(float v) {
  float r;
  asm("lg2.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// The planes one staged value v becomes, written at `at`, `at + plane`, ...
// A masked (zero) value gives zeros on every plane.
template <int M, bool X>
__device__ __forceinline__ void put(float v, float* at, int plane) {
  if constexpr (M == kKL) {
    const bool pos = v > 0.f;
    const float l = pos ? log2f(v) : 0.f;  // accurate: see Cfg
    if constexpr (X) {
      at[0] = pos ? v : 0.f;
      at[plane] = l;
    } else {
      at[0] = l;
    }
  } else if constexpr (M == kJensenShannon) {
    const bool pos = v > 0.f;
    at[0] = v;
    at[plane] = pos ? v : 0.f;
    at[2 * plane] = pos ? lg2(v + v) : 0.f;
  } else {
    at[0] = v;
  }
}

// One operand's share of a chunk in registers: ROWS rows x kBK features
// as ROWS / 64 float4 groups a thread. Group g holds row (g / 2) % ROWS,
// features 4 * ((g & 1) + 2 * (g / (2 ROWS))) .. + 3: two threads read a
// row's 32 contiguous bytes. A warp stores 16 consecutive rows at two
// features 4 apart, whose padded rows (ROWS + 4 = 4 mod 32 floats) sit 16
// banks apart: its transposed stores of one feature hit 32 distinct banks.
template <int ROWS>
struct Chunk {
  static constexpr int kGroups = ROWS / 64;
  static constexpr int kStride = ROWS + 4;
  float4 v[kGroups];

  __device__ __forceinline__ static int row(int g) { return (g >> 1) % ROWS; }
  __device__ __forceinline__ static int quad(int g) {
    return (g & 1) + 2 * (g / (2 * ROWS));
  }

  // Features k0 .. k0 + kBK - 1 of the first `rows` rows at `base`
  // (32-bit offsets: d < 2^24). VEC: d % 4 == 0 and 16-byte aligned rows,
  // so a group is all in range or all out, and one 16-byte load.
  template <bool VEC>
  __device__ __forceinline__ void load(const float* __restrict__ base,
                                       int rows, int d, int k0) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int g = threadIdx.x + i * kThreads;
      const int k = k0 + 4 * quad(g);
      const bool in = row(g) < rows;
      const float* q = base + (in ? row(g) * d : 0) + k;
      if constexpr (VEC) {
        v[i] = in && k < d ? __ldg(reinterpret_cast<const float4*>(q))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        v[i].x = in && k < d ? __ldg(q) : 0.f;
        v[i].y = in && k + 1 < d ? __ldg(q + 1) : 0.f;
        v[i].z = in && k + 2 < d ? __ldg(q + 2) : 0.f;
        v[i].w = in && k + 3 < d ? __ldg(q + 3) : 0.f;
      }
    }
  }

  // transposed into the planes at `dst`: [plane][k][row], stride kStride
  template <int M, bool X>
  __device__ __forceinline__ void store(float* dst) const {
    constexpr int plane = kBK * kStride;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int g = threadIdx.x + i * kThreads;
      float* at = dst + 4 * quad(g) * kStride + row(g);
      put<M, X>(v[i].x, at, plane);
      put<M, X>(v[i].y, at + kStride, plane);
      put<M, X>(v[i].z, at + 2 * kStride, plane);
      put<M, X>(v[i].w, at + 3 * kStride, plane);
    }
  }
};

template <int M, int PX, int PY, int TM, int TN>
__device__ __forceinline__ void accum(float& s, float& t,
                                      const float (&a)[PX][TM],
                                      const float (&b)[PY][TN], int i, int j,
                                      float p) {
  const float a0 = a[0][i], b0 = b[0][j];
  if constexpr (M == kL1) {
    s += fabsf(a0 - b0);
  } else if constexpr (M == kL2Unexp) {
    const float d = a0 - b0;
    s += d * d;
  } else if constexpr (M == kLinf) {
    s = fmaxf(s, fabsf(a0 - b0));
  } else if constexpr (M == kCanberra) {
    // one rcp.approx; a subnormal den is scaled up first, as
    // __fdividef does without flush to zero
    const float den = fmaxf(fabsf(a0) + fabsf(b0), kCanberraFloor);
    s += __fdividef(fabsf(a0 - b0), den);
  } else if constexpr (M == kMinkowski) {
    // |a - b| = 0: lg2 gives -inf and ex2 0, as powf(0, p) for p > 0 (at
    // p = 0 the term is NaN where powf gives 1: no norm has p = 0)
    s += ex2(p * lg2(fabsf(a0 - b0)));
  } else if constexpr (M == kHamming) {
    s += (a0 != b0) ? 1.f : 0.f;
  } else if constexpr (M == kJensenShannon) {
    // planes: v, v > 0 ? v : 0, v > 0 ? lg2(v + v) : 0; log(a / m) is
    // lg2(a + a) - lg2(a + b) in base 2, and m <= 0 reads m as 1, that
    // is a + b as 2
    const float ab = a0 + b0;
    const float lab = lg2(ab > 0.f ? ab : 2.f);
    s = fmaf(a[1][i], a[2][i] - lab, s);
    s = fmaf(b[1][j], b[2][j] - lab, s);
  } else if constexpr (M == kKL) {
    // planes: x (pa, la), y (lb)
    s = fmaf(a0, a[1][i] - b0, s);
  } else {  // kBrayCurtis
    s += fabsf(a0 - b0);
    t += fabsf(a0 + b0);
  }
}

template <int M>
__device__ __forceinline__ float finish(float s, float t, float p, int dim,
                                        int do_sqrt) {
  if constexpr (M == kBrayCurtis) return s / (t == 0.f ? 1.f : t);
  if constexpr (M == kL2Unexp) return do_sqrt ? sqrtf(fmaxf(s, 0.f)) : s;
  if constexpr (M == kMinkowski) return powf(s, 1.f / p);
  if constexpr (M == kHamming) return s / static_cast<float>(dim);
  if constexpr (M == kJensenShannon)
    return sqrtf(fmaxf(0.5f * kLn2 * s, 0.f));
  if constexpr (M == kKL) return kLn2 * s;
  return s;
}

// One feature kk of a staged buffer: the thread's TM rows of x (ty * 4 ..
// + 3, and 64 + ty * 4 .. + 3 at TM = 8) and TN columns of y (tx * 4 ..
// + 3, and 64 + tx * 4 .. + 3 at TN = 8), every plane, as float4s.
template <int M>
__device__ __forceinline__ void step(const float* xs, const float* ys, int kk,
                                     int tx, int ty,
                                     float (&s)[Cfg<M>::kTM][Cfg<M>::kTN],
                                     float (&t)[Cfg<M>::kTM][Cfg<M>::kTN],
                                     float p) {
  using C = Cfg<M>;
  float a[C::kPX][C::kTM], b[C::kPY][C::kTN];
#pragma unroll
  for (int q = 0; q < C::kPX; ++q)
#pragma unroll
    for (int h = 0; h < C::kTM / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(
          xs + (q * kBK + kk) * C::kSX + h * 64 + ty * 4);
      a[q][4 * h] = v.x;
      a[q][4 * h + 1] = v.y;
      a[q][4 * h + 2] = v.z;
      a[q][4 * h + 3] = v.w;
    }
#pragma unroll
  for (int q = 0; q < C::kPY; ++q)
#pragma unroll
    for (int h = 0; h < C::kTN / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(
          ys + (q * kBK + kk) * C::kSY + h * 64 + tx * 4);
      b[q][4 * h] = v.x;
      b[q][4 * h + 1] = v.y;
      b[q][4 * h + 2] = v.z;
      b[q][4 * h + 3] = v.w;
    }
#pragma unroll
  for (int i = 0; i < C::kTM; ++i)
#pragma unroll
    for (int j = 0; j < C::kTN; ++j)
      accum<M>(s[i][j], t[i][j], a, b, i, j, p);
}

// Kahan summation of a chunk's sums s into the totals t, the lost low
// parts kept in this thread's slots of shared memory (float4 q at
// comp[q * kThreads]); s restarts at 0.
__device__ __forceinline__ void kahan(float& s, float& t, float& c) {
  const float y = s - c;
  const float sum = t + y;
  c = (sum - t) - y;
  t = sum;
  s = 0.f;
}

template <int TM, int TN>
__device__ __forceinline__ void fold(float (&s)[TM][TN], float (&t)[TM][TN],
                                     float4* comp) {
#pragma unroll
  for (int q = 0; q < TM * TN / 4; ++q) {  // outputs 4q .. 4q + 3
    float4 c = comp[q * kThreads];
    const int i = 4 * q / TN, j = 4 * q % TN;
    kahan(s[i][j], t[i][j], c.x);
    kahan(s[i][j + 1], t[i][j + 1], c.y);
    kahan(s[i][j + 2], t[i][j + 2], c.z);
    kahan(s[i][j + 3], t[i][j + 3], c.w);
    comp[q * kThreads] = c;
  }
}

template <int M, bool VEC>
__global__ __launch_bounds__(kThreads, Cfg<M>::kMinBlocks) void
elementwise_dist_kernel(
    const float* __restrict__ x, const float* __restrict__ y, int m, int n,
    int d, float p, int do_sqrt, int vec_out, float* __restrict__ out) {
  using C = Cfg<M>;
  constexpr int TM = C::kTM, TN = C::kTN;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long row0 = static_cast<long long>(blockIdx.y) * C::kBM;
  const long long col0 = static_cast<long long>(blockIdx.x) * C::kBN;

  // s: the running sums (with kFold, the current chunk's); t: braycurtis'
  // second sum, or with kFold the running total
  float s[TM][TN], t[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = t[i][j] = 0.f;
  float4* const comp = smem4 + 2 * C::kBufFloats / 4 + threadIdx.x;
  if constexpr (C::kFold) {
#pragma unroll
    for (int q = 0; q < TM * TN / 4; ++q)
      comp[q * kThreads] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  Chunk<C::kBM> xc;
  Chunk<C::kBN> yc;
  // this block's rows of x and of y, and how many of them exist
  const float* const xb = x + row0 * d;
  const float* const yb = y + col0 * d;
  const int xrows = static_cast<int>(min(m - row0, 1LL * C::kBM));
  const int yrows = static_cast<int>(min(n - col0, 1LL * C::kBN));
  xc.template load<VEC>(xb, xrows, d, 0);
  yc.template load<VEC>(yb, yrows, d, 0);
  xc.template store<M, true>(smem);
  yc.template store<M, false>(smem + C::kXFloats);
  __syncthreads();

  const int chunks = (d + kBK - 1) / kBK;
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks;
    if (more) {  // chunk c + 1 into registers, in flight over c's products
      xc.template load<VEC>(xb, xrows, d, (c + 1) * kBK);
      yc.template load<VEC>(yb, yrows, d, (c + 1) * kBK);
    }
    const float* xs = smem + (c & 1) * C::kBufFloats;
    const float* ys = xs + C::kXFloats;
    const int kc = min(kBK, d - c * kBK);
    if (kc == kBK) {
#pragma unroll (C::kUnroll)
      for (int kk = 0; kk < kBK; ++kk) step<M>(xs, ys, kk, tx, ty, s, t, p);
    } else {  // the ragged last chunk: only its real features
#pragma unroll 1
      for (int kk = 0; kk < kc; ++kk) step<M>(xs, ys, kk, tx, ty, s, t, p);
    }
    if constexpr (C::kFold) fold<TM, TN>(s, t, comp);
    if (more) {
      float* nx = smem + ((c + 1) & 1) * C::kBufFloats;
      xc.template store<M, true>(nx);
      yc.template store<M, false>(nx + C::kXFloats);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const long long c0 = col0 + h * 64 + tx * 4;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = finish<M>(C::kFold ? t[i][4 * h + j] : s[i][4 * h + j],
                         t[i][4 * h + j], p, d, do_sqrt);
      float* q = out + r * n + c0;
      if (vec_out && c0 + 3 < n) {
        *reinterpret_cast<float4*>(q) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < n) q[j] = o[j];
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15) == 0;
}

template <int M, bool VEC>
int launch_as(const float* x, const float* y, int m, int n, int d, float p,
              int do_sqrt, float* out, cudaStream_t s) {
  using C = Cfg<M>;
  const int vec_out = n % 4 == 0 && aligned16(out);
  const cudaError_t e = cudaFuncSetAttribute(
      elementwise_dist_kernel<M, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + C::kBN - 1) / C::kBN, (m + C::kBM - 1) / C::kBM);
  elementwise_dist_kernel<M, VEC><<<grid, kThreads, C::kSmemBytes, s>>>(
      x, y, m, n, d, p, do_sqrt, vec_out, out);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch(const float* x, const float* y, int m, int n, int d, float p,
           int do_sqrt, float* out, cudaStream_t s) {
  if ((m + Cfg<M>::kBM - 1) / Cfg<M>::kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d % 4 == 0 && aligned16(x) && aligned16(y))
    return launch_as<M, true>(x, y, m, n, d, p, do_sqrt, out, s);
  return launch_as<M, false>(x, y, m, n, d, p, do_sqrt, out, s);
}

}  // namespace

// x (m, d), y (n, d) f32 row-major -> out (m, n); m <= 65535 * 64 (the
// wrapper splits larger x), d < 2^24. Returns the launch's cudaError.
extern "C" int raft_elementwise_dist(const float* x, const float* y, int m,
                                     int n, int d, int metric, float p,
                                     int do_sqrt, float* out, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (d < 1 || d >= (1 << 24)) return static_cast<int>(cudaErrorInvalidValue);
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
