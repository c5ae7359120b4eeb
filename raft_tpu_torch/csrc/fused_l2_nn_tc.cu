// Fused L2 nearest neighbour on the tensor cores: for each row of x, the
// index and squared-L2 distance of its nearest row of y (the k-means
// centres), optionally sqrt'd, with the products taken as bf16x3 (or one
// bf16 pass) by wgmma.
//
// Replaces: raft_tpu/ops/pallas_fused_l2_nn.py:_nn_kernel (entry
// fused_l2_nn_pallas) at its card precisions: dot_nt_f32(y, x, mode)
// (raft_tpu/ops/_util.py:21-50) for mode "bf16x3" (PASSES = 3: each f32
// operand split into hi = bf16(v) and lo = bf16(v - hi), hi.lo + lo.hi +
// hi.hi summed in f32, each product exact) and "bf16"/"default" (PASSES =
// 1: hi.hi alone). Contract kept: d = max((|y|^2 + |x|^2) - 2 x.y, 0) with
// the norms of the unrounded f32 rows; the argmin over y with ties to the
// lowest index; a row that never improves on +inf reports index 0; sqrt
// last. fused_l2_nn.cu stays the f32 body ("highest").
//
// Bound on the H100 SXM (data-sheet rates, 700 W): operations, 3 x 2mnd at
// the 989 TFLOP/s bf16 tensor rate (1 x for bf16): at the k-means shape
// (262144 x 128) x (1024 x 128) 0.21 ms against 0.04 ms for the bytes; the
// 10M-row predict after the sweeps 8.1 ms (1024 centres), 32.6 ms (4096).
// The f32 body took 3.07 ms at the k-means shape (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py).
//
// Design: the centres are few (1024-4096 x d: 0.5-2 MB), so a prologue
// splits them once per call into the swizzled K-major bf16 tiles the
// wgmma descriptors read ([chunk of 128 centres][64-feature slice][hi,
// lo]), with their norms padded by +inf to a whole chunk (a padded centre
// never wins). A 256-thread block = two warpgroups owns 128 rows of x (64
// each, the wgmma M side), split once into resident hi/lo tiles when they
// fit beside the ring (d <= 256 at 3 passes, d <= 704 at 1), otherwise
// streamed slice by slice (split on the fly, as fused_knn_tc.cu does), and
// walks every centre chunk (the N side) in ascending order. A step's
// centre tiles are ready bytes: cp.async copies them into a three-stage
// ring two steps ahead, so no block re-splits a centre. The epilogue keeps
// a running (minimum, index) per accumulator row: each thread scans its
// columns in ascending order with a strict '<', and the quad's four
// threads combine lexicographically at the end, which equals the TPU's
// sequential strict-'<' walk. Every block sees all of y: no cross-block
// reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

#include "row_norms.cuh"
#include "wgmma_bf16x3.cuh"

namespace {

using namespace raft_tpu_torch::tc;

constexpr int kStages = 3;  // the centre tiles' cp.async ring

__device__ __forceinline__ void cp_async16(uint32_t saddr, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The prologue: y (n, d) -> tiles [chunk][slice][plane] of 128 rows x 64
// features, each group of 8 features at byte r * 128 + ((g ^ (r % 8)) *
// 16) of its tile (put()'s layout); plane 0 hi, plane 1 (3 passes) lo;
// zeros past n and d. One thread per (chunk, slice, row, group). It also
// sets the norms of the padded centres [n, n_chunks * 128) to +inf.
template <int PASSES>
__global__ void split_centres_kernel(const float* __restrict__ y, int n,
                                     int d, int ks_n, long long units,
                                     unsigned char* __restrict__ tiles,
                                     float* __restrict__ yyp) {
  constexpr int kPlanes = PASSES == 3 ? 2 : 1;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= units) return;
  const int g = static_cast<int>(e & 7), r = static_cast<int>((e >> 3) & 127);
  const long long cs = e >> 10;  // chunk * ks_n + slice
  const int c = static_cast<int>(cs / ks_n), s = static_cast<int>(cs % ks_n);
  const int row = c * kBN + r, k0 = s * kBK + 8 * g;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = (row < n && k0 + j < d)
               ? y[static_cast<long long>(row) * d + k0 + j]
               : 0.f;
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 hv = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    h[j] = pack2(hv);
    if constexpr (PASSES == 3)
      l[j] = pack2(__floats2bfloat162_rn(v[2 * j] - __low2float(hv),
                                         v[2 * j + 1] - __high2float(hv)));
  }
  unsigned char* t = tiles + cs * kPlanes * kTile + r * 128 +
                     ((g ^ (r & 7)) << 4);
  *reinterpret_cast<uint4*>(t) = make_uint4(h[0], h[1], h[2], h[3]);
  if constexpr (PASSES == 3)
    *reinterpret_cast<uint4*>(t + kTile) = make_uint4(l[0], l[1], l[2], l[3]);
  if (s == 0 && g == 0 && row >= n) yyp[row] = CUDART_INF_F;
}

// Shared memory (bytes, from a 1024-aligned base): the rows' hi tiles
// [qt], their lo tiles [qt] (3 passes), then the ring of kStages steps,
// each a step's centre tiles as the prologue laid them out (hi, lo). qt is
// the number of slices (resident rows) or 2 (a ring with the steps).
__host__ __device__ inline size_t smem_bytes(int passes, bool qres, int ks) {
  const size_t planes = passes == 3 ? 2 : 1;
  return 1024 + planes * ((qres ? ks : 2) + kStages) * kTile;
}

template <int PASSES, bool QRES>
__global__ __launch_bounds__(kThreads, 1) void fused_l2_nn_tc_kernel(
    const float* __restrict__ x, const float* __restrict__ xx,
    const unsigned char* __restrict__ tiles, const float* __restrict__ yyp,
    int m, int n_chunks, int d, int vec4_rows, int do_sqrt,
    int* __restrict__ out_i, float* __restrict__ out_d) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + ((1024 - (raw_s & 1023)) & 1023);
  const uint32_t base_s = static_cast<uint32_t>(__cvta_generic_to_shared(base));

  constexpr int kPlanes = PASSES == 3 ? 2 : 1;
  constexpr int kStep = kPlanes * kTile;  // one step's centre tiles
  const int ks_n = (d + kBK - 1) / kBK;
  const int qt = QRES ? ks_n : 2;
  const int q_hi = 0, q_lo = qt * kTile, ring = kPlanes * qt * kTile;
  const int steps = n_chunks * ks_n;
  const bool vec4 = vec4_rows != 0;

  const int tid = threadIdx.x, lane = tid & 31, quad = lane & 3;
  const int wg = tid >> 7;
  const long long q0 = static_cast<long long>(blockIdx.x) * kBM;
  // the two rows of this thread's accumulator fragment
  const int rbase = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  float xq[2], bv[2];
  int bc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long r = q0 + rbase + 8 * i;
    xq[i] = r < m ? xx[r] : 0.f;
    bv[i] = CUDART_INF_F;
    bc[i] = INT_MAX;
  }

  // step t's centre tiles into ring slot t % kStages (a group per call,
  // empty past the last step, so the wait counts stay uniform)
  auto issue = [&](int t) {
    if (t < steps) {
      const unsigned char* src = tiles + static_cast<long long>(t) * kStep;
      const uint32_t dst = base_s + ring + (t % kStages) * kStep;
      for (int o = tid * 16; o < kStep; o += kThreads * 16)
        cp_async16(dst + o, src + o);
    }
    cp_async_commit();
  };

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
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int t = 0; t < steps; ++t) {
    const int c = t / ks_n, ks = t - c * ks_n;
    // step t's tiles have landed (this thread's copies), the rows' tiles
    // are stored, and every warpgroup is done with step t - 1's slot
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    issue(t + kStages - 1);
    const int qi = QRES ? ks : (t & 1);
    const uint32_t a_hi = base_s + q_hi + qi * kTile + wg * 64 * 128;
    const uint32_t a_lo = base_s + q_lo + qi * kTile + wg * 64 * 128;
    const uint32_t b_hi = base_s + ring + (t % kStages) * kStep;
    const uint32_t b_lo = b_hi + kTile;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int accumulate = (ks == 0 && kk == 0) ? 0 : 1;
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
    if constexpr (!QRES) {
      // the next step's slice of the rows, into the other half of their
      // ring, while the products run
      if (t + 1 < steps) {
        const int nq = (t + 1) & 1;
        fetch(f, x, q0, m, d, ((t + 1) % ks_n) * kBK, vec4);
        put<PASSES>(f, base + q_hi + nq * kTile, base + q_lo + nq * kTile);
      }
    }
    wgmma_wait_all();
    fence_acc(acc);

    if (ks == ks_n - 1) {
      // fragment element (i, n8, j) = acc[4 n8 + 2 i + j] is row rbase +
      // 8 i against centre c * 128 + 8 n8 + 2 quad + j: ascending in (n8,
      // j), so a strict '<' keeps the lowest index among equal values
      const int c0 = c * kBN;
      const float2* yp = reinterpret_cast<const float2*>(yyp + c0);
#pragma unroll
      for (int n8 = 0; n8 < 16; ++n8) {
        const float2 yv = __ldg(yp + 4 * n8 + quad);
        const int col = c0 + 8 * n8 + 2 * quad;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // (|y|^2 + |x|^2) - 2 acc with one rounding of the difference,
          // as the plain version's (2 acc is exact); padded centres +inf
          const float v0 =
              fmaxf(fmaf(-2.0f, acc[4 * n8 + 2 * i], yv.x + xq[i]), 0.f);
          const float v1 =
              fmaxf(fmaf(-2.0f, acc[4 * n8 + 2 * i + 1], yv.y + xq[i]), 0.f);
          if (v0 < bv[i]) {
            bv[i] = v0;
            bc[i] = col;
          }
          if (v1 < bv[i]) {
            bv[i] = v1;
            bc[i] = col + 1;
          }
        }
      }
    }
  }

  // the quad's four threads hold the same rows: (value, index)
  // lexicographically
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], o);
      const int oc = __shfl_xor_sync(0xffffffffu, bc[i], o);
      if (ov < bv[i] || (ov == bv[i] && oc < bc[i])) {
        bv[i] = ov;
        bc[i] = oc;
      }
    }
  }
  if (quad == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long r = q0 + rbase + 8 * i;
      if (r < m) {
        out_i[r] = bc[i] == INT_MAX ? 0 : bc[i];
        out_d[r] = do_sqrt ? sqrtf(bv[i]) : bv[i];
      }
    }
  }
}

template <int PASSES, bool QRES>
int launch_tc(const float* x, const float* xx, const unsigned char* tiles,
              const float* yyp, int m, int n_chunks, int d, int vec4,
              int do_sqrt, int* out_i, float* out_d, cudaStream_t s) {
  const size_t smem = smem_bytes(PASSES, QRES, (d + kBK - 1) / kBK);
  auto kernel = fused_l2_nn_tc_kernel<PASSES, QRES>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(m + kBM - 1) / kBM, kThreads, smem, s>>>(
      x, xx, tiles, yyp, m, n_chunks, d, vec4, do_sqrt, out_i, out_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, d) rows, y (n, d) centres (f32); passes 3 (bf16x3) or 1 (bf16).
// Scratch: xx (m,) floats, tiles of ceil(n / 128) chunks x ceil(d / 64)
// slices x (2 planes at 3 passes, else 1) x 16 KB (16-byte aligned), yyp
// ceil(n / 128) * 128 floats. vec4 !=
// 0 requires d % 4 == 0 and a 16-byte aligned x. -> out_i, out_d (m,).
extern "C" int raft_fused_l2_nn_tc(const float* x, const float* y, float* xx,
                                   int m, int n, int d, int passes,
                                   int do_sqrt, int vec4,
                                   unsigned char* tiles, float* yyp,
                                   int* out_i, float* out_d, void* stream) {
  if (m == 0) return 0;
  if (n < 1 || d < 1 || (passes != 1 && passes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ks_n = (d + kBK - 1) / kBK;
  const int n_chunks = (n + kBN - 1) / kBN;
  int rc = raft_tpu_torch::launch_row_norms(x, m, d, xx, s);
  if (rc == 0) rc = raft_tpu_torch::launch_row_norms(y, n, d, yyp, s);
  if (rc != 0) return rc;
  const long long units = static_cast<long long>(n_chunks) * ks_n * kBN * 8;
  const unsigned blocks = static_cast<unsigned>((units + 255) / 256);
  if (passes == 3)
    split_centres_kernel<3><<<blocks, 256, 0, s>>>(y, n, d, ks_n, units,
                                                   tiles, yyp);
  else
    split_centres_kernel<1><<<blocks, 256, 0, s>>>(y, n, d, ks_n, units,
                                                   tiles, yyp);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const bool qres = smem_bytes(passes, true, ks_n) <= kMaxSmem;
  if (passes == 3)
    return qres ? launch_tc<3, true>(x, xx, tiles, yyp, m, n_chunks, d, vec4,
                                     do_sqrt, out_i, out_d, s)
                : launch_tc<3, false>(x, xx, tiles, yyp, m, n_chunks, d,
                                      vec4, do_sqrt, out_i, out_d, s);
  return qres ? launch_tc<1, true>(x, xx, tiles, yyp, m, n_chunks, d, vec4,
                                   do_sqrt, out_i, out_d, s)
              : launch_tc<1, false>(x, xx, tiles, yyp, m, n_chunks, d, vec4,
                                    do_sqrt, out_i, out_d, s);
}
