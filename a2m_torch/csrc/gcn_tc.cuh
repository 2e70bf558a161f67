// Tensor-core helpers shared by the GCN stack kernels that run on Hopper's
// wgmma (gcn_stack.cu: the dense forward and the forward with stash in bf16
// mode; gcn_stack_edge.cu: the edge-form forward in bf16 mode): bf16
// packing, the 128-byte-swizzled operand layout and its shared-memory
// descriptor, the m64n64k16 products, and the k-order recomputation of
// near-tie roundings.

#pragma once

#include <stdint.h>

#include "gcn_common.cuh"

namespace {

constexpr int kFp = 64;                    // features, zero-padded
constexpr int kBlock = kFp * kFp * 2;      // one 64 x 64 bf16 weight block
constexpr size_t kBlockShared = 232448;    // 227 KB, a block's most
#ifndef A2M_TC_TIE_ULPS                     // -1: never recompute
#define A2M_TC_TIE_ULPS 8
#endif
constexpr int kTieUlps = A2M_TC_TIE_ULPS;  // see near_tie

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// Byte offset of (row, feature) in a K-major 64-wide bf16 operand tile with
// the 128-byte swizzle: row r's 16-byte chunk c lies at chunk c ^ (r % 8).
__device__ __forceinline__ int swz(int r, int f) {
  return r * 128 + ((((f >> 3) ^ r) & 7) << 4) + (f & 7) * 2;
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile whose
// 8-row groups lie 1024 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16) @ B (16 x 64), both from shared memory, f32 sums.
__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
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
// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d = A (64 x 64 K-major tile at a) @ B (64 x 64 K-major block at b):
// four k steps of 16, 32 bytes apart in the swizzled rows.  Issued, not
// waited for.
__device__ __forceinline__ void product(float (&d)[32], const void* a,
                                        const void* b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
  fence_operands(d);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_k16(d, da + 2 * k, db + 2 * k);
}

// Element (row, col) of the product of an operand tile (rows of 64 bf16,
// swizzled) with a weight block, as a sequential f32 sum in k order,
// fmaf(a_k, b_k, s) from s = 0: the rounding of a product on the CUDA cores
// and of cuBLAS's f32 GEMM at these shapes (the plain version's).
__device__ __noinline__ float k_order_dot(const uint8_t* a_tile, int row,
                                          const uint8_t* b_block, int col) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint4 a = *reinterpret_cast<const uint4*>(
        a_tile + row * 128 + (((c ^ row) & 7) << 4));
    const uint4 b = *reinterpret_cast<const uint4*>(
        b_block + col * 128 + (((c ^ col) & 7) << 4));
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
    const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 av = unpack_bf16(aw[q]), bv = unpack_bf16(bw[q]);
      s = fmaf(av.x, bv.x, s);
      s = fmaf(av.y, bv.y, s);
    }
  }
  return s;
}

// x / H (a2m's head mean): a product with 1 / H where that is exact (H a
// power of two), else the division, out of line.
__device__ __noinline__ float div_rn(float x, float y) { return x / y; }
__device__ __forceinline__ float div_heads(float x, int H, float inv_h) {
  return (H & (H - 1)) == 0 ? x * inv_h : div_rn(x, (float)H);
}

// Whether v's rounding to bf16 is too close to call: v lies within
// kTieUlps f32 ulps of a bf16 midpoint, where wgmma's sum (its own order,
// truncated) may round otherwise than a sequential sum; there the value is
// recomputed in k order.
__device__ __forceinline__ bool near_tie(float v) {
  const int lo = (int)(__float_as_uint(v) & 0xffffu);
  return abs(lo - 0x8000) <= kTieUlps;
}

// Accumulator k of a thread holds row wrow + 8 (k & 2) / 2 of the M tile,
// column 8 (k / 4) + 2 tig + (k & 1).
__device__ __forceinline__ int acc_row(int k, int wrow) {
  return wrow + (k & 2) * 4;
}
__device__ __forceinline__ int acc_col(int k, int tig) {
  return 8 * (k / 4) + 2 * tig + (k & 1);
}

}  // namespace
