// Device helpers shared by the GCN stack kernels (gcn_stack.cu: the forward
// and the forward with stash; gcn_stack_bwd.cu: the backward;
// gcn_stack_edge.cu: the forward in edge form).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kSlope = 0.2f;
constexpr float kLnEps = 1e-6f;

template <bool kPrecise>
__device__ __forceinline__ float op(float v) {
  if (kPrecise) return v;
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kPrecise>
__device__ __forceinline__ float4 op4(float4 v) {
  return make_float4(op<kPrecise>(v.x), op<kPrecise>(v.y), op<kPrecise>(v.z),
                     op<kPrecise>(v.w));
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : kSlope * v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[r, c] (+)= sum_k A[r, k] * op(W[k, c]) for r < R, c < C.
// A is in shared memory (row stride lda) and already holds matmul operands
// (rounded once when written); W is in device memory, K rows of C columns
// with row stride ldw (a column slice of a wider matrix when ldw > C).
// A thread owns a micro-tile of kRowBlock rows (8 unless the caller
// narrows it for a small C) x 4 columns: per 4 k it
// reads kRowBlock float4 of A (a broadcast: a warp shares its rows) and 4
// float4 of W (coalesced), for 16 * kRowBlock FMAs.  The same thread owns
// the same outputs on every call with equal (R, C), so a second call with
// accumulate=true needs no barrier in between.  K, C, lda and ldw are
// multiples of 4.
template <bool kPrecise, int kRowBlock = 8>
__device__ void mm_strided(const float* A, int lda,
                           const float* __restrict__ W, int ldw, int K,
                           int C, int R, float* out, int ldo,
                           bool accumulate) {
  const int groups = C / 4;
  const int row_blocks = (R + kRowBlock - 1) / kRowBlock;
  for (int item = threadIdx.x; item < groups * row_blocks;
       item += blockDim.x) {
    const int c = (item % groups) * 4;
    const int r0 = (item / groups) * kRowBlock;
    const float* rows[kRowBlock];
#pragma unroll
    for (int i = 0; i < kRowBlock; ++i) rows[i] = A + min(r0 + i, R - 1) * lda;
    float acc[kRowBlock][4];
#pragma unroll
    for (int i = 0; i < kRowBlock; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int k = 0; k < K; k += 4) {
      float4 w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = op4<kPrecise>(__ldg(reinterpret_cast<const float4*>(
            W + (size_t)(k + q) * ldw + c)));
#pragma unroll
      for (int i = 0; i < kRowBlock; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(rows[i] + k);
        fma4(acc[i], a.x, w[0]);
        fma4(acc[i], a.y, w[1]);
        fma4(acc[i], a.z, w[2]);
        fma4(acc[i], a.w, w[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowBlock; ++i) {
      if (r0 + i < R) {
        float4* o = reinterpret_cast<float4*>(out + (r0 + i) * ldo + c);
        float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (accumulate) {
          const float4 prev = *o;
          v.x += prev.x; v.y += prev.y; v.z += prev.z; v.w += prev.w;
        }
        *o = v;
      }
    }
  }
}

// The same product for a dense (K, C) W.
template <bool kPrecise, int kRowBlock = 8>
__device__ __forceinline__ void mm(const float* A, int lda,
                                   const float* __restrict__ W, int K, int C,
                                   int R, float* out, int ldo,
                                   bool accumulate) {
  mm_strided<kPrecise, kRowBlock>(A, lda, W, C, K, C, R, out, ldo,
                                  accumulate);
}

// The end of every layer, one warp per row of F <= 64 features:
// x[r] = LeakyReLU(LayerNorm(out[r] + bias) * ln_scale + ln_bias) + x[r].
__device__ __forceinline__ void bias_norm_leaky_residual(
    const float* out_s, float* x_s, int R, int F,
    const float* __restrict__ bias, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float pb[2], ps[2], pl[2];              // this lane's f = lane, lane + 32
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int f = lane + 32 * u;
    pb[u] = f < F ? __ldg(bias + f) : 0.f;
    ps[u] = f < F ? __ldg(ln_scale + f) : 0.f;
    pl[u] = f < F ? __ldg(ln_bias + f) : 0.f;
  }
  for (int r = warp; r < R; r += blockDim.x / 32) {
    const float* o = out_s + r * F;
    float v[2] = {0.f, 0.f};
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = lane + 32 * u;
      if (f < F) {
        v[u] = o[f] + pb[u];
        s += v[u];
      }
    }
    const float mean = warp_sum(s) / (float)F;
    float q = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float d = v[u] - mean;
      if (lane + 32 * u < F) q = fmaf(d, d, q);
    }
    const float rs = rsqrtf(warp_sum(q) / (float)F + kLnEps);
    float* xr = x_s + r * F;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = lane + 32 * u;
      if (f < F) xr[f] = leaky((v[u] - mean) * rs * ps[u] + pl[u]) + xr[f];
    }
  }
}

}  // namespace
