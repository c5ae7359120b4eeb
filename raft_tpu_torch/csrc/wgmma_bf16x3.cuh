// bf16x3 products on Hopper's tensor cores, shared by fused_knn_tc.cu
// (kernel 5's pass A), fused_l2_nn_tc.cu (kernel 1) and list_scan_tc.cuh
// (kernels 3, 4, 10, 11): wgmma m64n128k16 and m64n64k16 (bf16 in, f32
// accumulate) from 128-byte-swizzled K-major shared tiles, and the staging
// that splits f32 rows into those tiles.
//
// A product a.b of f32 operands is taken as dot_nt_f32(a, b, "bf16x3")
// (raft_tpu/ops/_util.py:21-50): each operand split into hi = bf16(v) and
// lo = bf16(v - hi) (round to nearest), and hi.lo + lo.hi + hi.hi summed
// in f32 (PASSES = 3); PASSES = 1 takes hi.hi alone (the bf16 tier). A
// block of kThreads = two warpgroups stages 128-row x 64-feature slices:
// each thread loads kUnits groups of 8 consecutive features (fetch, or
// fetch_row_unit for gathered rows) into registers and stores them split
// (put, put_unit) at the swizzled position the descriptors (desc_sw128)
// read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A named namespace (not an unnamed one): a source that defines its
// kernels in its own unnamed namespace brings these names in with a
// using-directive, which nvcc's generated stub would otherwise find
// ambiguous.
namespace raft_tpu_torch {
namespace tc {

constexpr int kThreads = 256;
constexpr int kBM = 128;    // A rows per block (two warpgroups of 64)
constexpr int kBN = 128;    // B rows per chunk (the wgmma N side)
constexpr int kBK = 64;     // features per slice (128 bytes of bf16)
constexpr int kTile = kBN * kBK * 2;  // bytes of one swizzled bf16 tile
constexpr int kUnits = kBN * kBK / 8 / kThreads;  // 8-float groups a thread
constexpr int kMaxSmem = 232448;  // the H100's opt-in limit per block

// ---- wgmma helpers (PTX ISA, warpgroup-level matrix multiply) ----

// Descriptor of a K-major tile of 64-wide rows (128 bytes) with the
// 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(16 >> 4) << 16;    // leading offset (unused)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride: 8 rows x 128 B
  d |= 1ull << 62;                               // 128-byte swizzle
  return d;
}

// d (64 x 128 f32 fragment) = a (64 x 16) . b (128 x 16)^T [+ d]
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32 fragment) = a (64 x 16) . b (64 x 16)^T [+ d]
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy shared-memory writes made visible to the wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- staging: f32 rows -> swizzled bf16 hi / lo tiles ----

// One thread's share of a 128-row x 64-feature f32 slice: kUnits groups of
// 8 consecutive features, group u of the block at row u / 8, features
// 8 (u % 8) .. + 7; zeros beyond the valid rows and features.
struct Slice {
  float v[kUnits][8];
};

__device__ __forceinline__ void fetch(Slice& f, const float* __restrict__ src,
                                      long long r0, long long rlim, int d,
                                      int k0, bool vec4) {
#pragma unroll
  for (int s = 0; s < kUnits; ++s) {
    const int u = threadIdx.x + s * kThreads;
    const long long row = r0 + (u >> 3);
    const int kk = k0 + 8 * (u & 7);
    const float* p = src + row * d + kk;
    if (row < rlim && vec4 && kk + 8 <= d) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      f.v[s][0] = a.x; f.v[s][1] = a.y; f.v[s][2] = a.z; f.v[s][3] = a.w;
      f.v[s][4] = b.x; f.v[s][5] = b.y; f.v[s][6] = b.z; f.v[s][7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f.v[s][e] = (row < rlim && kk + e < d) ? p[e] : 0.f;
    }
  }
}

// fetch() for one unit of rows gathered by index: the 8 features [kk, kk +
// 8) of source row `row` (< 0 reads zeros).
__device__ __forceinline__ void fetch_row_unit(float (&v)[8],
                                               const float* __restrict__ src,
                                               int row, int d, int kk,
                                               bool vec4) {
  const float* p = src + static_cast<long long>(row < 0 ? 0 : row) * d + kk;
  if (row >= 0 && vec4 && kk + 8 <= d) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (row >= 0 && kk + e < d) ? p[e] : 0.f;
  }
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Split unit u (8 features) into hi (and, for 3 passes, lo) and store both
// at the 128-byte-swizzled K-major position of its group: byte r * 128 +
// ((g ^ (r % 8)) * 16) of its tile, r = u / 8, g = u % 8.
template <int PASSES>
__device__ __forceinline__ void put_unit(const float (&v)[8], int u,
                                         unsigned char* hi,
                                         unsigned char* lo) {
  const int r = u >> 3, g = u & 7;
  const int off = r * 128 + ((g ^ (r & 7)) << 4);
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float a = v[2 * e], b = v[2 * e + 1];
    const __nv_bfloat162 hv = __floats2bfloat162_rn(a, b);
    h[e] = pack2(hv);
    if constexpr (PASSES == 3)
      l[e] = pack2(__floats2bfloat162_rn(a - __low2float(hv),
                                         b - __high2float(hv)));
  }
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  if constexpr (PASSES == 3)
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Split the slice into hi (and, for 3 passes, lo) tiles (put_unit()).
template <int PASSES>
__device__ __forceinline__ void put(const Slice& f, unsigned char* hi,
                                    unsigned char* lo) {
#pragma unroll
  for (int s = 0; s < kUnits; ++s)
    put_unit<PASSES>(f.v[s], threadIdx.x + s * kThreads, hi, lo);
}

}  // namespace tc
}  // namespace raft_tpu_torch
