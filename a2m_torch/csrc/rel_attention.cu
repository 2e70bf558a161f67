// K6: attention with WavLM's gated relative-position bias, fused, CUDA C++
// for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no speech tower.  It was added
// for a2m_torch/nn/wavlm.py, whose every layer computes, per stream b and
// head h,
//
//     S[t, s] = q[t] . k[s] * scale + g[b, h, t] * E[h, s - t + T - 1]
//     out[t]  = softmax_s(S[t, :]) @ v
//
// with E the (H, 2T - 1) table of the layer-0 embedding read at the T5
// bucket of every offset s - t, and g a gate per query.  Written out as the
// published code writes it, the bias is a (B * H, T, T) tensor: 4.6 GB in f32
// a layer for 8 streams of 60 s (T = 2,999).
//
// Bound on the H100: at T = 2,999 the kernel is bound by its operations,
// 4 B H T^2 D for QK^T and PV (294.7 GFLOP for B = 8, H = 16, D = 64; 0.298
// ms at the bf16 rate), against q, k, v in bf16, the gates and the table
// read once and the f32 output written once (~248 MB, 0.074 ms).  What the
// design does about it:
// - flash attention's forward: a block of 128 queries (8 warps of 16 rows)
//   walks over key steps of 64, QK^T and PV as mma.sync m16n8k16 (bf16
//   operands, f32 sums), P rounded to bf16 for its product straight from
//   the registers of QK^T's sums, the online softmax in f32 and base 2;
//   nothing of size T^2 reaches device memory;
// - K and V steps come through cp.async into a two-stage ring in shared
//   memory, rows of 128 bytes under an XOR swizzle of their 16-byte chunks
//   so that ldmatrix reads them without bank conflicts; the next step's
//   copy runs under the current step's products;
// - the bias: each step copies the 191 table values its (query, key) pairs
//   can reach (offsets n0 - m0 - 127 .. n0 - m0 + 63) into shared memory
//   beside K and V, and each score adds g * seg[s - t + 127]; a step whose
//   every offset lies beyond the caller's flat distance (T5's buckets
//   saturate at their maximum distance: |s - t| >= 778 for 320 buckets and
//   distance 800, about half the steps at T = 2,999) adds g times the
//   table's end value instead;
// - q is read once, straight into its mma fragments; 2 blocks an SM.
// Warp-group products (wgmma) with TMA and a producer warp are later work.
//
// Layout: q, k, v (B, T, H, 64) bf16 with the strides given (in elements,
// the last one 1; rows 16-byte aligned); gates (B, T, H) f32 with the
// strides given; table (H, 2T - 1) f32 contiguous; out (B, T, H, 64) f32
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;                 // queries a block
constexpr int kBlockN = 64;                  // keys a step
constexpr int kHead = 64;                    // head size
constexpr int kWarps = kBlockM / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSeg = kBlockM + kBlockN - 1;  // table values a step reaches
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  __nv_bfloat16 k[2][kBlockN * kHead];
  __nv_bfloat16 v[2][kBlockN * kHead];
  float seg[2][kSeg + 1];
};

// element offset of (row r, 16-byte chunk c) in a tile of 64-wide rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * kHead + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 bytes (4 with cp_async4); src-size 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) @ b (16x8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__global__ void __launch_bounds__(kThreads, 2)
rel_attn_k6_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ gates,
                   const float* __restrict__ table, float* __restrict__ out,
                   long long sqb, long long sqt, long long sqh,
                   long long skb, long long skt, long long skh,
                   long long svb, long long svt, long long svh,
                   long long sgb, long long sgt, long long sgh, int T, int H,
                   int flat, float qk_scale) {
  __shared__ __align__(128) Smem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const __nv_bfloat16* kb = k + b * skb + h * skh;
  const __nv_bfloat16* vb = v + b * svb + h * svh;
  const float* tab = table + (long long)h * (2 * T - 1);
  const int n_steps = (T + kBlockN - 1) / kBlockN;

  // the copies of step `step` into stage `buf`: K and V rows, and the table
  // values at offsets n0 - m0 - (kBlockM - 1) + i, i < kSeg
  auto load = [&](int step, int buf) {
    const int n0 = step * kBlockN;
#pragma unroll
    for (int i = 0; i < kBlockN * 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 3, c = idx & 7;
      const bool ok = n0 + r < T;
      const long long row = ok ? n0 + r : 0;
      cp_async16(&sm.k[buf][swz(r, c)], kb + row * skt + c * 8, ok);
      cp_async16(&sm.v[buf][swz(r, c)], vb + row * svt + c * 8, ok);
    }
    if (tid < kSeg) {
      const int at = n0 - m0 - (kBlockM - 1) + tid + T - 1;
      const bool ok = at >= 0 && at < 2 * T - 1;
      cp_async4(&sm.seg[buf][tid], tab + (ok ? at : 0), ok);
    }
  };

  load(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  // q's fragments (rows r0 and r0 + 8 of the warp, 16 columns a k-step)
  const int r0 = m0 + warp * 16 + g;
  uint32_t qa[kHead / 16][4];
  {
    const bool ok0 = r0 < T, ok1 = r0 + 8 < T;
    const __nv_bfloat16* q0 = q + b * sqb + h * sqh + (long long)r0 * sqt;
    const __nv_bfloat16* q1 = q0 + 8 * sqt;
#pragma unroll
    for (int kk = 0; kk < kHead / 16; ++kk) {
      const int c = kk * 16 + 2 * tig;
      qa[kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
      qa[kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(q1 + c) : 0u;
      qa[kk][2] = ok0 ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
      qa[kk][3] = ok1 ? *reinterpret_cast<const uint32_t*>(q1 + c + 8) : 0u;
    }
  }
  // the gates in base 2: exp2 of (q.k * scale + g * e) * log2(e)
  const float* gp = gates + b * sgb + h * sgh;
  const float g0 = r0 < T ? gp[(long long)r0 * sgt] * kLog2e : 0.f;
  const float g1 = r0 + 8 < T ? gp[(long long)(r0 + 8) * sgt] * kLog2e : 0.f;
  const float e_lo = tab[0], e_hi = tab[2 * T - 2];

  float acc[kHead / 8][4];
#pragma unroll
  for (int j = 0; j < kHead / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_0 = -INFINITY, m_1 = -INFINITY, l_0 = 0.f, l_1 = 0.f;

  // ldmatrix's lane roles: which 8x8 matrix a lane addresses, and its row
  const int mat = lane >> 3, rin = lane & 7;

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1, n0 = step * kBlockN;
    if (step + 1 < n_steps) load(step + 1, buf ^ 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    // S = q k^T: 16 rows by 64 keys a warp, as 8 tiles of 8 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHead / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kBlockN / 16; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, &sm.k[buf][swz(16 * jp + (mat >> 1) * 8 + rin,
                                  2 * kk + (mat & 1))]);
        mma(s[2 * jp], qa[kk], r[0], r[1]);
        mma(s[2 * jp + 1], qa[kk], r[2], r[3]);
      }
    }

    // the scaled scores plus the gated bias, in base 2
    const bool left = n0 + kBlockN - 1 - m0 <= -flat;
    const bool right = n0 - m0 - (kBlockM - 1) >= flat;
    const bool tail = n0 + kBlockN > T;
    const float* seg = sm.seg[buf];
    const int rw = warp * 16 + g;          // the thread's first row, in block
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * tig + (c & 1);
        const int row = rw + (c >> 1) * 8;
        const float e = left    ? e_lo
                        : right ? e_hi
                                : seg[col - row + kBlockM - 1];
        float x = s[j][c] * qk_scale + (c >> 1 ? g1 : g0) * e;
        if (tail && n0 + col >= T) x = -INFINITY;
        s[j][c] = x;
      }
    }

    // the online softmax: each row's max over the quad of lanes holding it
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m_0, mx0), mn1 = fmaxf(m_1, mx1);
    const float a0 = exp2_approx(m_0 - mn0), a1 = exp2_approx(m_1 - mn1);
    m_0 = mn0;
    m_1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = exp2_approx(s[j][0] - mn0);
      s[j][1] = exp2_approx(s[j][1] - mn0);
      s[j][2] = exp2_approx(s[j][2] - mn1);
      s[j][3] = exp2_approx(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l_0 = l_0 * a0 + sum0;
    l_1 = l_1 * a1 + sum1;
#pragma unroll
    for (int j = 0; j < kHead / 8; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }

    // acc += P v: P's bf16 fragments are QK^T's sums, 16 keys a k-step
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kHead / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_t(r, &sm.v[buf][swz(16 * kk + (mat & 1) * 8 + rin,
                                    2 * dp + (mat >> 1))]);
        mma(acc[2 * dp], pa, r[0], r[1]);
        mma(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_0 += __shfl_xor_sync(0xffffffffu, l_0, o);
    l_1 += __shfl_xor_sync(0xffffffffu, l_1, o);
  }
  const float i0 = 1.f / l_0, i1 = 1.f / l_1;
  const long long ot = (long long)H * kHead;
  float* o0 = out + ((long long)b * T * H + h) * kHead + (long long)r0 * ot;
#pragma unroll
  for (int j = 0; j < kHead / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    if (r0 < T)
      *reinterpret_cast<float2*>(o0 + c) =
          make_float2(acc[j][0] * i0, acc[j][1] * i0);
    if (r0 + 8 < T)
      *reinterpret_cast<float2*>(o0 + 8 * ot + c) =
          make_float2(acc[j][2] * i1, acc[j][3] * i1);
  }
}

}  // namespace

extern "C" {

// K6: (B, T, H, 64) bf16 q, k, v, (B, T, H) f32 gates, (H, 2T - 1) f32
// table -> (B, T, H, 64) f32; strides in elements; qk_scale in base 2
int a2m_rel_attention(const void* q, const void* k, const void* v,
                      const void* gates, const void* table, void* out,
                      int sqb, int sqt, int sqh, int skb, int skt, int skh,
                      int svb, int svt, int svh, int sgb, int sgt, int sgh,
                      int batch, int T, int H, int flat, float qk_scale,
                      void* stream) {
  const dim3 grid((T + kBlockM - 1) / kBlockM, batch * H);
  rel_attn_k6_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)gates, (const float*)table,
      (float*)out, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sgb, sgt,
      sgh, T, H, flat, qk_scale);
  return (int)cudaGetLastError();
}

const char* a2m_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
