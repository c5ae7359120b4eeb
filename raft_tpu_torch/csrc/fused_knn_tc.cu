// Pass A of the fused brute-force k-NN (kernels 5 and 6) on the tensor
// cores: every bin's (minimum, row) of the expanded L2 or inner-product
// scores, with the products taken as bf16x3 (or one bf16 pass) by wgmma.
//
// Replaces: raft_tpu/ops/pallas_fused_knn.py:_knn_kernel (kernel 5, d <=
// 4096) and :_knn_kernel_ktiled (kernel 6, d > 4096: the contraction
// tiled in KT = 2048 slices, each slice's products added in f32 into a
// scratch accumulator; here each slice's products sum in the wgmma
// accumulator and are then added in f32 into partial sums in shared
// memory), whose products are dot_nt_f32(y, x, "bf16x3")
// (raft_tpu/ops/_util.py:21-50): each f32 operand is split into hi =
// bf16(v) and lo = bf16(v - hi), and hi.lo + lo.hi + hi.hi are summed in
// f32. PASSES = 3 takes the same three products (each exact in f32) into
// one f32 accumulator; PASSES = 1 takes hi.hi alone, the bf16 tier (both
// operands rounded, the product exact). Norms come from the unrounded f32
// rows (row_norms.cuh, as the TPU kernel sums x*x). Distances and binning
// are fused_knn.cu's: L2 max((|y|^2 + |x|^2) - 2 acc, 0), IP -acc; each bin
// of b = tn / l_bins rows of a tn tile gives its minimum, the lowest row
// among equal values; padded rows never enter; a bin with no finite value
// writes (+inf, -1). Pass B (radix_select.cuh) is fused_knn.cu's.
//
// Bound on the H100 SXM (data-sheet rates, 700 W): operations, 3 x 2mnd
// at the 989 TFLOP/s bf16 tensor rate: 7.8 ms at 1000 x 10M x 128 (the
// database's 5.1 GB take 1.53 ms); 0.497 ms at kernel 6's 1000 x 10k x
// 8192. The f32 body it replaces on the main path took 122.9 ms there
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py), 3.1x its own 38.2 ms
// floor on the CUDA cores; at 1000 x 10k x 8192 the f32 body took 20.9 ms.
//
// Design: a 256-thread block = two warpgroups owns 128 queries (64 each,
// the wgmma M side) and one db tile, walked in chunks of 128 rows (the N
// side) and 64-wide feature slices (128 bytes of bf16, one 128-byte
// swizzle row). The queries' hi/lo slices stay in shared memory for the
// whole tile when they fit (d <= 320, 3 passes); otherwise they stream
// with the rows (kernel 6's d > 4096 always: 197 KB of shared memory with
// its partial sums, 199 KB with the WALK distances they share, whatever
// d). Rows are split on the fly: the
// f32 slice for step t + 2 is loaded into registers behind the wgmmas of
// step t (and the epilogue and barrier after them), and split and stored
// in the swizzled K-major layout the wgmma descriptors read one step later
// (a two-stage ring, one barrier a step). Pre-splitting the database once
// a call instead would read and write 10 GB more at 10M x 128 and hold 5
// GB more of device memory. The epilogue reads the accumulator
// fragment: for a power-of-two b >= 8 (REG; the default geometry's b = 64)
// bins are reduced in registers (the column pair, then this thread's
// 8-column groups of a bin, lower rows first, then quad shuffles on what
// is left), a bin wider than a chunk carried across chunks, each result
// stored as its bin closes; the metric and this mode are template
// parameters, so the epilogue is straight-line code (a runtime b == 1 /
// ip branch in it cost more than the products). For any other b (WALK) the
// chunk's distances go through shared memory and one thread per query
// walks them in row order (fused_knn.cu's walk). The grid keeps the query
// block fastest, so the blocks sharing a db tile read it from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wgmma_bf16x3.cuh"

namespace {

using namespace raft_tpu_torch::tc;

constexpr int kDistLd = kBN + 1;

// ---- bins ----

struct Cand {
  float v;
  int r;
};

// the better of two candidates: smaller value, then lower row
__device__ __forceinline__ Cand better(Cand a, Cand b) {
  return (b.v < a.v || (b.v == a.v && b.r < a.r)) ? b : a;
}

// the better of a and b when b holds the higher rows: b only if smaller
__device__ __forceinline__ Cand lower_first(Cand a, Cand b) {
  return b.v < a.v ? b : a;
}

__device__ __forceinline__ Cand shfl_xor(Cand c, int mask) {
  return {__shfl_xor_sync(0xffffffffu, c.v, mask),
          __shfl_xor_sync(0xffffffffu, c.r, mask)};
}

__device__ __forceinline__ void write_cand(float* od, int* oi, long long col,
                                           Cand c) {
  od[col] = c.v;
  oi[col] = c.v == CUDART_INF_F ? -1 : c.r;
}

// Shared-memory layout (bytes, from a 1024-aligned base): query hi tiles
// [qt], query lo tiles [qt] (3 passes), row hi tiles [2], row lo tiles [2]
// (3 passes), the chunk norms [2][kBN] floats, then (WALK) the chunk
// distances [kBM][kDistLd] floats, which kernel 6 shares with its partial
// sums [64][kThreads] floats (REG: the partial sums alone). qt is the
// number of slices (resident queries) or 2 (a ring with the rows).
__host__ __device__ inline int q_tiles(bool qres, int ks) {
  return qres ? ks : 2;
}
__host__ __device__ inline size_t smem_bytes(int passes, bool qres, bool reg,
                                             int ks, bool kt) {
  const size_t planes = passes == 3 ? 2 : 1;
  return 1024 + planes * (q_tiles(qres, ks) + 2) * kTile + 2 * kBN * 4 +
         (!reg  ? static_cast<size_t>(kBM) * kDistLd * 4
          : kt ? static_cast<size_t>(kBM) * kBN * 4
               : 0);
}

}  // namespace

namespace {

// REG: b is a power of two >= 8, reduced in registers; otherwise the
// chunk's distances go through shared memory and a walk (WALK). KT
// (kernel 6): the products of each kt_steps slices (KT features)
// accumulate on their own and are added, in f32, into partial sums in
// shared memory, as the TPU kernel adds each KT step into its scratch (a
// template parameter: kernel 5's loop carries none of it).
template <int PASSES, bool QRES, bool IP, bool REG, bool KT>
__global__ __launch_bounds__(kThreads, 1) void knn_bins_tc_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ xx, const float* __restrict__ yy, int m, int n,
    int d, int tn, int b, int kt_steps, int q_blocks, long long nb,
    float* __restrict__ cand_d, int* __restrict__ cand_i) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + ((1024 - (raw_s & 1023)) & 1023);
  const uint32_t base_s = static_cast<uint32_t>(__cvta_generic_to_shared(base));

  const int ks_n = (d + kBK - 1) / kBK;
  const int qt = q_tiles(QRES, ks_n);
  constexpr int kPlanes = PASSES == 3 ? 2 : 1;
  // byte offsets of the tiles (see smem_bytes)
  const int q_hi = 0, q_lo = qt * kTile;
  const int y_hi = kPlanes * qt * kTile, y_lo = y_hi + 2 * kTile;
  float* ysn = reinterpret_cast<float*>(base + kPlanes * (qt + 2) * kTile);
  float* dist = ysn + 2 * kBN;
  float* part = dist;  // kernel 6's partial sums: element i at [i][tid]

  const int tid = threadIdx.x, lane = tid & 31, quad = lane & 3;
  const int wg = tid >> 7;
  const long long q0 = static_cast<long long>(blockIdx.x % q_blocks) * kBM;
  const long long t0 = static_cast<long long>(blockIdx.x / q_blocks) * tn;
  const long long t1 = min(t0 + tn, static_cast<long long>(n));
  const int steps = static_cast<int>((t1 - t0 + kBN - 1) / kBN) * ks_n;
  const bool vec4 = (d & 3) == 0;

  // the two query rows of this thread's accumulator fragment (local), and
  // their rows of the candidate matrix
  const int rbase = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  float xq[2];
  bool qok[2];
  float* od[2];
  int* oi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long q = q0 + rbase + 8 * i;
    qok[i] = q < m;
    xq[i] = (!IP && qok[i]) ? xx[q] : 0.f;
    od[i] = cand_d + (qok[i] ? q : 0) * nb;
    oi[i] = cand_i + (qok[i] ? q : 0) * nb;
  }

  // step 0 (and the resident queries)
  Slice f;
  if constexpr (QRES) {
    for (int s = 0; s < ks_n; ++s) {
      fetch(f, x, q0, m, d, s * kBK, vec4);
      put<PASSES>(f, base + q_hi + s * kTile, base + q_lo + s * kTile);
    }
  } else {
    fetch(f, x, q0, m, d, 0, vec4);
    put<PASSES>(f, base + q_hi, base + q_lo);
  }
  fetch(f, y, t0, t1, d, 0, vec4);
  put<PASSES>(f, base + y_hi, base + y_lo);
  if (tid < kBN) ysn[tid] = (!IP && t0 + tid < t1) ? yy[t0 + tid] : 0.f;
  // step 1's rows (and norms) in flight in registers: step t + 1 is stored
  // while the wgmmas of step t run, and step t + 2 loaded behind them, so
  // the loads' latency hides behind the products, the epilogue and the
  // barrier
  float ypre = 0.f;
  auto prefetch = [&](int t) {
    const int c = t / ks_n, k = t - c * ks_n;
    const long long r0n = t0 + static_cast<long long>(c) * kBN;
    fetch(f, y, r0n, t1, d, k * kBK, vec4);
    if (!IP && k == 0 && tid < kBN && r0n + tid < t1) ypre = yy[r0n + tid];
    else ypre = 0.f;
  };
  if (steps > 1) prefetch(1);
  fence_proxy_async();
  __syncthreads();

  // REG: log2(b), the 8-column groups of a bin (<= 16) less one, and the
  // open bin of a b > kBN carried across chunks. WALK: the walk of thread
  // tid < kBM over query q0 + tid.
  const int bshift = __ffs(b) - 1;
  const int gmask = min(b >> 3, 16) - 1;
  Cand carry[2] = {{CUDART_INF_F, -1}, {CUDART_INF_F, -1}};
  Cand cur = {CUDART_INF_F, -1};
  long long wcol = t0 / b, wclose = t0 + b - 1;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int t = 0; t < steps; ++t) {
    const int chunk = t / ks_n, ks = t - chunk * ks_n, st = t & 1;
    const int qi = QRES ? ks : st;
    const uint32_t a_hi = base_s + q_hi + qi * kTile + wg * 64 * 128;
    const uint32_t a_lo = base_s + q_lo + qi * kTile + wg * 64 * 128;
    const uint32_t b_hi = base_s + y_hi + st * kTile;
    const uint32_t b_lo = base_s + y_lo + st * kTile;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // a chunk's (kernel 6: a KT slice's) first product starts afresh
      const int accumulate =
          (kk == 0 && (KT ? ks % kt_steps : ks) == 0) ? 0 : 1;
      const uint32_t o = kk * 32;  // 16 bf16 along K inside the swizzle row
      if constexpr (PASSES == 3) {
        // dot_nt_f32's order: hi.lo, lo.hi, hi.hi
        wgmma_m64n128k16(acc, desc_sw128(a_hi + o), desc_sw128(b_lo + o),
                         accumulate);
        wgmma_m64n128k16(acc, desc_sw128(a_lo + o), desc_sw128(b_hi + o), 1);
        wgmma_m64n128k16(acc, desc_sw128(a_hi + o), desc_sw128(b_hi + o), 1);
      } else {
        wgmma_m64n128k16(acc, desc_sw128(a_hi + o), desc_sw128(b_hi + o),
                         accumulate);
      }
    }
    wgmma_commit();
    // store step t + 1 in the other half of the ring while they run, then
    // load step t + 2
    if (t + 1 < steps) {
      const int nc = (t + 1) / ks_n, nks = t + 1 - nc * ks_n, ns = st ^ 1;
      put<PASSES>(f, base + y_hi + ns * kTile, base + y_lo + ns * kTile);
      if (nks == 0 && tid < kBN) ysn[(nc & 1) * kBN + tid] = ypre;
      if constexpr (!QRES) {
        Slice fq;
        fetch(fq, x, q0, m, d, nks * kBK, vec4);
        put<PASSES>(fq, base + q_hi + ns * kTile, base + q_lo + ns * kTile);
      }
      fence_proxy_async();
      if (t + 2 < steps) prefetch(t + 2);
    }
    wgmma_wait_all();
    fence_acc(acc);
    // kernel 6: a KT slice ends (the last one is added in the epilogue)
    if constexpr (KT) {
      if (ks != ks_n - 1 && (ks + 1) % kt_steps == 0) {
        const bool first = ks + 1 == kt_steps;
#pragma unroll
        for (int i = 0; i < 64; ++i)
          part[i * kThreads + tid] =
              first ? acc[i] : part[i * kThreads + tid] + acc[i];
      }
    }

    if (ks == ks_n - 1) {
      if constexpr (KT) {
        if (ks_n > kt_steps) {
          // the earlier slices' sum plus the last slice's products
#pragma unroll
          for (int i = 0; i < 64; ++i)
            acc[i] = part[i * kThreads + tid] + acc[i];
          if constexpr (!REG) __syncthreads();  // the distances reuse part
        }
      }
      // epilogue: fragment element (i, n8, j) = acc[4 n8 + 2 i + j] is
      // query rbase + 8 i against chunk column 8 n8 + 2 quad + j
      const long long c0 = t0 + static_cast<long long>(chunk) * kBN;
      const int lim = static_cast<int>(min(t1 - c0, static_cast<long long>(kBN)));
      const bool full = lim == kBN;
      const int r0 = static_cast<int>(c0);  // rows are below n < 2^31
      const float* yn = ysn + (chunk & 1) * kBN;
      Cand c[2][16];
#pragma unroll
      for (int n8 = 0; n8 < 16; ++n8) {
        const int col = 8 * n8 + 2 * quad;
        float yv[2] = {0.f, 0.f};
        if constexpr (!IP) {
          yv[0] = yn[col];
          yv[1] = yn[col + 1];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float a = acc[4 * n8 + 2 * i + j];
            // (|y|^2 + |x|^2) - 2 acc with one rounding of the difference,
            // as the plain version's (2 acc is exact)
            v[j] = IP ? -a : fmaxf(fmaf(-2.0f, a, yv[j] + xq[i]), 0.f);
            // padded rows never win; an empty bin's id becomes -1 when
            // written (its value is +inf)
            if (!full && col + j >= lim) v[j] = CUDART_INF_F;
          }
          if constexpr (REG) {
            c[i][n8] = v[1] < v[0] ? Cand{v[1], r0 + col + 1}
                                   : Cand{v[0], r0 + col};
          } else {
            dist[(rbase + 8 * i) * kDistLd + col] = v[0];
            dist[(rbase + 8 * i) * kDistLd + col + 1] = v[1];
          }
        }
      }
      if constexpr (REG) {
        // first across this thread's 8-column groups of a bin (lower rows
        // first), then across the quad's four threads on each bin's first
        // group only
#pragma unroll
        for (int s = 1; s < 16; s <<= 1) {
          if (b >= 16 * s) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int n8 = 0; n8 < 16; n8 += 2 * s)
                c[i][n8] = lower_first(c[i][n8], c[i][n8 + s]);
          }
        }
#pragma unroll
        for (int n8 = 0; n8 < 16; ++n8) {
          if ((n8 & gmask) == 0) {  // uniform across the warp
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              c[i][n8] = better(c[i][n8], shfl_xor(c[i][n8], 1));
              c[i][n8] = better(c[i][n8], shfl_xor(c[i][n8], 2));
            }
          }
        }
        if (b <= kBN) {
          if (quad == 0) {
#pragma unroll
            for (int n8 = 0; n8 < 16; ++n8)
              if ((n8 & gmask) == 0 && (full || 8 * n8 < lim)) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
                  if (qok[i])
                    write_cand(od[i], oi[i], (r0 + 8 * n8) >> bshift,
                               c[i][n8]);
              }
          }
        } else {
          const bool closes = (c0 + kBN - t0) % b == 0 || c0 + kBN >= t1;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            carry[i] = better(carry[i], c[i][0]);
            if (closes) {
              if (quad == 0 && qok[i])
                write_cand(od[i], oi[i], c0 >> bshift, carry[i]);
              carry[i] = {CUDART_INF_F, -1};
            }
          }
        }
      } else {
        __syncthreads();
        if (tid < kBM && q0 + tid < m) {
          const long long c1 = min(c0 + kBN, t1);
          float* wd = cand_d + (q0 + tid) * nb;
          int* wi = cand_i + (q0 + tid) * nb;
          for (long long r = c0; r < c1; ++r) {
            const float v = dist[tid * kDistLd + (r - c0)];
            if (v < cur.v) cur = {v, static_cast<int>(r)};
            if (r == wclose || r + 1 == t1) {  // the bin closes
              write_cand(wd, wi, wcol, cur);
              cur = {CUDART_INF_F, -1};
              ++wcol;
              wclose += b;
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int PASSES, bool QRES, bool IP, bool REG, bool KT>
int launch_tc(const float* x, const float* y, const float* xx,
              const float* yy, int m, int n, int d, int tn, int b,
              int kt_steps, long long nb, float* cand_d, int* cand_i,
              cudaStream_t s) {
  const size_t smem = smem_bytes(PASSES, QRES, REG, (d + kBK - 1) / kBK, KT);
  auto kernel = knn_bins_tc_kernel<PASSES, QRES, IP, REG, KT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_blocks = (m + kBM - 1) / kBM;
  const long long blocks =
      static_cast<long long>(q_blocks) * ((n + tn - 1) / tn);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      x, y, xx, yy, m, n, d, tn, b, kt_steps, q_blocks, nb, cand_d, cand_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass A of kernels 5 and 6 on the tensor cores: x (m, d) queries, y (n,
// d) database, xx/yy their norms (L2 only; else unused), passes 3 (bf16x3)
// or 1 (bf16), kt 0 (kernel 5) or the KT features a slice (kernel 6, a
// multiple of 64) -> cand_d / cand_i (m, nb), nb = ceil(n / b), each bin's
// (minimum, row). Any d: above 320 the queries stream with the rows.
extern "C" int raft_fused_knn_bins_tc(const float* x, const float* y,
                                      const float* xx, const float* yy, int m,
                                      int n, int d, int tn, int b, int ip,
                                      int passes, int kt, long long nb,
                                      float* cand_d, int* cand_i,
                                      void* stream) {
  if (m == 0) return 0;
  if (n < 1 || d < 1 || tn < 1 || b < 1 || tn % b != 0 ||
      nb != (n + b - 1) / b || (passes != 1 && passes != 3) || kt < 0 ||
      kt % kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool reg = (b & (b - 1)) == 0 && b >= 8;
  const int ks_n = (d + kBK - 1) / kBK, kt_steps = kt / kBK;
  // kernel 6 streams its queries (d > 4096 never fits them resident)
  const bool kts = kt > 0;
  const bool qres =
      !kts && smem_bytes(passes, true, reg, ks_n, false) <= kMaxSmem;
  const bool is_ip = ip != 0;
#define RAFT_TC(P, Q, I, R, K)                                              \
  if (passes == P && qres == Q && is_ip == I && reg == R && kts == K)       \
    return launch_tc<P, Q, I, R, K>(x, y, xx, yy, m, n, d, tn, b, kt_steps, \
                                    nb, cand_d, cand_i, s);
  RAFT_TC(3, true, false, true, false)
  RAFT_TC(3, true, false, false, false)
  RAFT_TC(3, true, true, true, false)
  RAFT_TC(3, true, true, false, false)
  RAFT_TC(3, false, false, true, false)
  RAFT_TC(3, false, false, false, false)
  RAFT_TC(3, false, true, true, false)
  RAFT_TC(3, false, true, false, false)
  RAFT_TC(3, false, false, true, true)
  RAFT_TC(3, false, false, false, true)
  RAFT_TC(3, false, true, true, true)
  RAFT_TC(3, false, true, false, true)
  RAFT_TC(1, true, false, true, false)
  RAFT_TC(1, true, false, false, false)
  RAFT_TC(1, true, true, true, false)
  RAFT_TC(1, true, true, false, false)
  RAFT_TC(1, false, false, true, false)
  RAFT_TC(1, false, false, false, false)
  RAFT_TC(1, false, true, true, false)
  RAFT_TC(1, false, true, false, false)
  RAFT_TC(1, false, false, true, true)
  RAFT_TC(1, false, false, false, true)
  RAFT_TC(1, false, true, true, true)
  RAFT_TC(1, false, true, false, true)
#undef RAFT_TC
  return static_cast<int>(cudaErrorInvalidValue);
}
