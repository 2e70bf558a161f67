// Backward of the 5-layer GAT/GraphConv stack, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel a2m/nn/pallas_gcn.py::_bwd_kernel (called by
// _bwd_call; helpers _ln_bwd, _gat_bwd / _gat_bwd_rolled, _graph_conv_bwd).
// Per graph it walks the layers L..1: recompute the layer from its stored
// input (x0 for the first layer, xs[l - 2] for layer l), LayerNorm forward,
// d_y = g * leaky'(y), LayerNorm backward, then the GAT or GraphConv
// backward, and g <- g + d_x for the residual.  It returns dx (N, J, F) and
// the gradient of every parameter, flat, in the order of the parameters.
//
// Bound on the H100: at the main-path shapes (N = 8192, J = 42 and 10,
// F = 64, H = 4) the function reads x0, the four stored inputs and g and
// writes dx: 764 MB for both stacks, ~0.23 ms at 3.35 TB/s, above what its
// ~180 GFLOP would take at the bf16 tensor-core rate, so it is bound by the
// bytes.  This kernel runs on the CUDA cores in fp32 FMAs, like the forward
// (gcn_stack.cu), and is bound by their rate and by shared-memory traffic.
//
// What the design does, where the TPU kernel's cannot carry over:
// * The TPU grid runs in order and adds every tile's parameter gradients into
//   the same output blocks.  Here blocks run in no order, so the grid is a
//   fixed number of persistent blocks (as many as fit the card at once), each
//   striding over the tiles of graphs and adding its tiles' gradients into a
//   row of its own in a scratch buffer (blocks x P floats, at most 264 x
//   272 KB, which lives mostly in L2).  Inside a block every scratch entry
//   has one owner thread per step and the steps are separated by barriers;
//   the tile order per block is fixed.  A second kernel then adds the rows
//   in block order.  So the result is deterministic: the same inputs give
//   bit-equal gradients.  No float atomics.
// * One head's d_XW at a time: XW for all heads stays in shared memory from
//   the recomputation (the attention needs it), but d_XW is formed, used for
//   d_x and d_W, and dropped head by head, which keeps a block at ~112 KB of
//   shared memory (two blocks per SM at J = 42).
// * The softmax backward d_e = alpha (d_alpha - sum alpha d_alpha) is zero
//   off the skeleton's edges, like alpha itself, so d_alpha, d_e, the
//   attention products and A^T @ d_neigh loop over per-node edge lists (and
//   their transposes, built once per block), not over dense (J, J) tiles.
// * The matrix products with W^T read a transposed copy of the weights, made
//   by a small kernel in the same launch, so they reuse the forward's
//   register-tiled matmul with coalesced weight loads.
// * A ragged N needs no padding: the last tile holds fewer graphs.
//
// Precision: kPrecise=false rounds both operands of every matrix product to
// bf16 where a2m's _mm / dot_general do with mm_dtype=bf16 (x, XW, alpha,
// d_h / H, d_XW, the neighbour sums, d_h, d_neigh, the weights) and
// accumulates in f32; logits, softmax, LayerNorm, the att_src/att_dst sums
// and every gradient accumulation stay f32.  kPrecise=true is plain f32.
//
// Layout: x0, g, dx (N, J, F) and xs (L - 1, N, J, F) f32 contiguous; params
// and dparams as in gcn_stack.cu; scratch holds (blocks + 1) * P floats: the
// per-block partial gradients, then the transposed weights.

#include "gcn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int gat_size(int F, int H) {
  return F * H * F + 2 * H * F + 3 * F;
}
__host__ __device__ inline int conv_size(int F) { return 2 * F * F + 3 * F; }
__host__ __device__ inline int layer_offset(int layer, int F, int H) {
  return ((layer + 1) / 2) * gat_size(F, H) + (layer / 2) * conv_size(F);
}

// out[k, c] += sum_r A[r, k] * B[r, c] for k < Ka, c < Cb, out in device
// memory with row stride ldo.  A and B are in shared memory and already hold
// matmul operands.  A thread owns 4 x 4 outputs.
__device__ void mm_tn(const float* A, int lda, const float* B, int ldb, int R,
                      int Ka, int Cb, float* out, int ldo) {
  const int cgroups = Cb / 4;
  for (int item = threadIdx.x; item < (Ka / 4) * cgroups;
       item += blockDim.x) {
    const int k0 = (item / cgroups) * 4, c0 = (item % cgroups) * 4;
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k0);
      const float4 b = *reinterpret_cast<const float4*>(B + r * ldb + c0);
      fma4(acc[0], a.x, b);
      fma4(acc[1], a.y, b);
      fma4(acc[2], a.z, b);
      fma4(acc[3], a.w, b);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4* o = reinterpret_cast<float4*>(out + (size_t)(k0 + q) * ldo + c0);
      float4 v = *o;
      v.x += acc[q][0]; v.y += acc[q][1]; v.z += acc[q][2]; v.w += acc[q][3];
      *o = v;
    }
  }
}

// Transposed weights: for a GAT layer Wt (H*F, F) with Wt[hF + c, k] =
// W[k, hF + c]; for a GraphConv layer W_rel^T and W_root^T.  The other
// entries of params_t stay unused.
__global__ void transpose_weights_kernel(const float* __restrict__ params,
                                         float* __restrict__ params_t, int F,
                                         int H, int L) {
  const int HF = H * F;
  for (int layer = 0; layer < L; ++layer) {
    const float* p = params + layer_offset(layer, F, H);
    float* t = params_t + layer_offset(layer, F, H);
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (layer % 2 == 0) {
      if (idx < F * HF) {
        const int k = idx / HF, c = idx % HF;
        t[c * F + k] = p[idx];
      }
    } else if (idx < 2 * F * F) {
      const int m = idx / (F * F), rest = idx % (F * F);
      const int k = rest / F, c = rest % F;
      t[m * F * F + c * F + k] = p[idx];
    }
  }
}

// dparams[p] = sum over blocks, in block order, of partial[block, p].
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dparams, int blocks,
                                       int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += partial[(size_t)b * P + p];
  dparams[p] = sum;
}

struct Smem {
  float *x, *g, *xo, *h, *xw, *dxw, *alpha, *de, *as, *ad, *das, *dad;
  float *cw, *ctw;
  int *gcnt, *ccnt, *tcnt, *ctcnt, *gsrc, *csrc, *tdst, *tpos, *ctdst;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory words of a block holding G graphs.
__host__ __device__ inline size_t smem_words(int J, int F, int H, int G,
                                             int D) {
  const size_t RF = (size_t)G * J * F, RH = (size_t)G * J * H;
  return 4 * RF + RF * imax(H, 2) + imax((int)RF, kWarps * 3 * F)
         + 2 * RH * D + 4 * RH + 4 * (size_t)J + 7 * (size_t)J * D;
}

__device__ inline Smem carve(float* base, int J, int F, int H, int G, int D) {
  const size_t RF = (size_t)G * J * F, RH = (size_t)G * J * H;
  Smem s;
  float* p = base;
  s.x = p; p += RF;                       // (R, F) layer input, f32
  s.g = p; p += RF;                       // (R, F) cotangent of the layer out
  s.xo = p; p += RF;                      // (R, F) x as a matmul operand
  s.h = p; p += RF;                       // (R, F) pre-LN output, then d_h
  s.xw = p; p += RF * imax(H, 2);         // (R, H*F) XW | neigh, d_neigh
  s.dxw = p; p += imax((int)RF, kWarps * 3 * F);   // (R, F) one head's d_XW
  s.alpha = p; p += RH * D;               // (R, H, D) attention weights, f32
  s.de = p; p += RH * D;                  // (R, H, D) d_alpha, then d_e
  s.as = p; p += RH;                      // (R, H) a_src
  s.ad = p; p += RH;                      // (R, H) a_dst
  s.das = p; p += RH;                     // (R, H) d_a_src
  s.dad = p; p += RH;                     // (R, H) d_a_dst
  s.cw = p; p += J * D;                   // GraphConv in-edge weights
  s.ctw = p; p += J * D;                  // ... of the out-edges
  int* q = reinterpret_cast<int*>(p);
  s.gcnt = q; q += J;                     // GAT sources per dst (self first)
  s.ccnt = q; q += J;                     // GraphConv in-edges per dst
  s.tcnt = q; q += J;                     // GAT dsts per source
  s.ctcnt = q; q += J;                    // GraphConv out-edges per source
  s.gsrc = q; q += J * D;
  s.csrc = q; q += J * D;
  s.tdst = q; q += J * D;                 // dst i attending this source ...
  s.tpos = q; q += J * D;                 // ... and its slot in i's list
  s.ctdst = q; q += J * D;
  return s;
}

// Bias, LayerNorm forward, d_y = g * leaky'(y), LayerNorm backward; one warp
// per row.  On entry s.h holds the layer's output before the bias; on exit
// it holds d_h as the operand the layer's backward takes: op(d_h * scale_h).
// Adds this tile's d_ln_scale, d_ln_bias and d_bias into the block's
// partials (warps summed in order).
template <bool kPrecise>
__device__ void norm_backward(const Smem& s, int R, int F, float scale_h,
                              const float* bias, const float* ln_scale,
                              const float* ln_bias, float* d_bias,
                              float* d_ln_scale, float* d_ln_bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float pb[2], ps[2], pl[2];
  float acc_s[2] = {0.f, 0.f}, acc_l[2] = {0.f, 0.f}, acc_b[2] = {0.f, 0.f};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int f = lane + 32 * u;
    pb[u] = f < F ? __ldg(bias + f) : 0.f;
    ps[u] = f < F ? __ldg(ln_scale + f) : 0.f;
    pl[u] = f < F ? __ldg(ln_bias + f) : 0.f;
  }
  for (int r = warp; r < R; r += kWarps) {
    float* o = s.h + r * F;
    const float* gr = s.g + r * F;
    float v[2] = {0.f, 0.f};
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = lane + 32 * u;
      if (f < F) {
        v[u] = o[f] + pb[u];
        sum += v[u];
      }
    }
    const float mean = warp_sum(sum) / (float)F;
    float q = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float d = v[u] - mean;
      if (lane + 32 * u < F) q = fmaf(d, d, q);
    }
    const float rs = rsqrtf(warp_sum(q) / (float)F + kLnEps);
    float xh[2] = {0.f, 0.f}, dxh[2] = {0.f, 0.f};
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = lane + 32 * u;
      if (f < F) {
        xh[u] = (v[u] - mean) * rs;
        const float y = xh[u] * ps[u] + pl[u];
        const float dy = gr[f] * (y >= 0.f ? 1.f : kSlope);
        acc_s[u] = fmaf(dy, xh[u], acc_s[u]);
        acc_l[u] += dy;
        dxh[u] = dy * ps[u];
        s1 += dxh[u];
        s2 = fmaf(dxh[u], xh[u], s2);
      }
    }
    const float m1 = warp_sum(s1) / (float)F;
    const float m2 = warp_sum(s2) / (float)F;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = lane + 32 * u;
      if (f < F) {
        const float dh = rs * (dxh[u] - m1 - xh[u] * m2);
        acc_b[u] += dh;
        o[f] = op<kPrecise>(dh * scale_h);
      }
    }
  }
  // sum the warps' column sums in warp order: red[q][warp][f] in s.dxw
  float* red = s.dxw;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int f = lane + 32 * u;
    if (f < F) {
      red[(0 * kWarps + warp) * F + f] = acc_s[u];
      red[(1 * kWarps + warp) * F + f] = acc_l[u];
      red[(2 * kWarps + warp) * F + f] = acc_b[u];
    }
  }
  __syncthreads();
  for (int item = threadIdx.x; item < 3 * F; item += blockDim.x) {
    const int q = item / F, f = item % F;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[(q * kWarps + w) * F + f];
    float* dst = q == 0 ? d_ln_scale : (q == 1 ? d_ln_bias : d_bias);
    dst[f] += sum;
  }
  __syncthreads();
}

template <bool kPrecise>
__global__ void __launch_bounds__(kThreads, 2)
gcn_stack_bwd_kernel(const float* __restrict__ x0,
                     const float* __restrict__ xs,
                     const float* __restrict__ gout,
                     const float* __restrict__ params,
                     const float* __restrict__ params_t,
                     const float* __restrict__ adj, float* __restrict__ dx,
                     float* __restrict__ partial, int n, int J, int F, int H,
                     int L, int G, int D, int P) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, J, F, H, G, D);
  const int HF = H * F;
  const int F4 = F / 4;
  float* part = partial + (size_t)blockIdx.x * P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) part[i] = 0.f;

  // Edge lists, once per block.  GAT attends over the self-loop and the
  // in-edges with A[i, j] > 0; GraphConv sums over every A[i, j] != 0.
  for (int i = threadIdx.x; i < J; i += blockDim.x) {
    int c = 0, d = 0;
    s.gsrc[i * D + c++] = i;
    for (int j = 0; j < J; ++j) {
      const float a = adj[i * J + j];
      if (a > 0.f && j != i && c < D) s.gsrc[i * D + c++] = j;
      if (a != 0.f && d < D) {
        s.csrc[i * D + d] = j;
        s.cw[i * D + d] = a;
        ++d;
      }
    }
    s.gcnt[i] = c;
    s.ccnt[i] = d;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    int k = 0, m = 0;
    for (int i = 0; i < J; ++i) {
      for (int c = 0; c < s.gcnt[i]; ++c) {
        if (s.gsrc[i * D + c] == j && k < D) {
          s.tdst[j * D + k] = i;
          s.tpos[j * D + k] = c;
          ++k;
        }
      }
      for (int d = 0; d < s.ccnt[i]; ++d) {
        if (s.csrc[i * D + d] == j && m < D) {
          s.ctdst[j * D + m] = i;
          s.ctw[j * D + m] = s.cw[i * D + d];
          ++m;
        }
      }
    }
    s.tcnt[j] = k;
    s.ctcnt[j] = m;
  }
  __syncthreads();

  const int tiles = (n + G - 1) / G;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * G;
    const int gn = min(G, n - g0);
    const int R = gn * J;
    const size_t tile_off = (size_t)g0 * J * F;
    for (int i = threadIdx.x; i < R * F; i += blockDim.x)
      s.g[i] = gout[tile_off + i];

    for (int layer = L - 1; layer >= 0; --layer) {
      const bool gat = layer % 2 == 0;
      const int off = layer_offset(layer, F, H);
      const float* p = params + off;
      const float* pt = params_t + off;
      float* dp = part + off;
      const float* xin =
          (layer == 0 ? x0 : xs + (size_t)(layer - 1) * n * J * F) + tile_off;
      for (int i = threadIdx.x; i < R * F; i += blockDim.x) {
        const float v = xin[i];
        s.x[i] = v;
        s.xo[i] = op<kPrecise>(v);
      }
      __syncthreads();

      if (gat) {
        // ---- GAT: recompute -------------------------------------------
        const float* W = p;
        const float* att_src = W + F * HF;
        const float* att_dst = att_src + HF;
        const float* bias = att_dst + HF;
        const float* ln_scale = bias + F;
        const float* ln_bias = ln_scale + F;
        float* dW = dp;
        float* d_att_src = dW + F * HF;
        float* d_att_dst = d_att_src + HF;
        float* d_bias = d_att_dst + HF;
        float* d_ln_scale = d_bias + F;
        float* d_ln_bias = d_ln_scale + F;

        mm<kPrecise>(s.xo, F, W, F, HF, R, s.xw, HF, false);
        __syncthreads();
        for (int item = threadIdx.x; item < R * H; item += blockDim.x) {
          const int r = item / H, h = item % H;
          const float4* v =
              reinterpret_cast<const float4*>(s.xw + r * HF + h * F);
          const float4* as4 = reinterpret_cast<const float4*>(att_src + h * F);
          const float4* ad4 = reinterpret_cast<const float4*>(att_dst + h * F);
          float a[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
          for (int q = 0; q < F4; ++q) {
            const float4 xv = v[q], sa = __ldg(as4 + q), sd = __ldg(ad4 + q);
            a[0] = fmaf(xv.x, sa.x, a[0]); a[1] = fmaf(xv.y, sa.y, a[1]);
            a[2] = fmaf(xv.z, sa.z, a[2]); a[3] = fmaf(xv.w, sa.w, a[3]);
            d[0] = fmaf(xv.x, sd.x, d[0]); d[1] = fmaf(xv.y, sd.y, d[1]);
            d[2] = fmaf(xv.z, sd.z, d[2]); d[3] = fmaf(xv.w, sd.w, d[3]);
          }
          s.as[item] = (a[0] + a[1]) + (a[2] + a[3]);
          s.ad[item] = (d[0] + d[1]) + (d[2] + d[3]);
        }
        __syncthreads();
        // alpha, f32: the softmax over each dst's sources, self-loop first
        for (int item = threadIdx.x; item < R * H; item += blockDim.x) {
          const int r = item / H, h = item % H;
          const int g = r / J, i = r % J;
          float* row = s.alpha + (size_t)item * D;
          const int* src = s.gsrc + i * D;
          const int cnt = s.gcnt[i];
          const float dst = s.ad[item];
          float mx = -INFINITY;
          for (int c = 0; c < cnt; ++c) {
            const float e = leaky(dst + s.as[(g * J + src[c]) * H + h]);
            row[c] = e;
            mx = fmaxf(mx, e);
          }
          float sum = 0.f;
          for (int c = 0; c < cnt; ++c) {
            const float ex = expf(row[c] - mx);
            row[c] = ex;
            sum += ex;
          }
          for (int c = 0; c < cnt; ++c) row[c] = row[c] / sum;
        }
        __syncthreads();
        // h = (sum_h alpha_h @ XW_h) / H over the edges
        for (int item = threadIdx.x; item < R * F4; item += blockDim.x) {
          const int r = item / F4, f = (item % F4) * 4;
          const int g = r / J, i = r % J;
          const int* src = s.gsrc + i * D;
          const int cnt = s.gcnt[i];
          float total[4] = {0.f, 0.f, 0.f, 0.f};
          for (int h = 0; h < H; ++h) {
            const float* a = s.alpha + (size_t)(r * H + h) * D;
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            for (int c = 0; c < cnt; ++c)
              fma4(acc, op<kPrecise>(a[c]),
                   op4<kPrecise>(*reinterpret_cast<const float4*>(
                       s.xw + (g * J + src[c]) * HF + h * F + f)));
#pragma unroll
            for (int q = 0; q < 4; ++q) total[q] += acc[q];
          }
          *reinterpret_cast<float4*>(s.h + r * F + f) =
              make_float4(total[0] / (float)H, total[1] / (float)H,
                          total[2] / (float)H, total[3] / (float)H);
        }
        __syncthreads();

        // ---- LayerNorm backward: s.h <- op(d_h / H) --------------------
        norm_backward<kPrecise>(s, R, F, 1.f / (float)H, bias, ln_scale,
                                ln_bias, d_bias, d_ln_scale, d_ln_bias);

        // ---- GAT backward ----------------------------------------------
        // d_alpha over the edges, then d_e = alpha (d_alpha - sum alpha
        // d_alpha) leaky'(e), and d_a_dst = sum over the sources
        for (int item = threadIdx.x; item < R * H; item += blockDim.x) {
          const int r = item / H, h = item % H;
          const int g = r / J, i = r % J;
          const float* a = s.alpha + (size_t)item * D;
          float* de = s.de + (size_t)item * D;
          const int* src = s.gsrc + i * D;
          const int cnt = s.gcnt[i];
          const float4* doh = reinterpret_cast<const float4*>(s.h + r * F);
          float sdot = 0.f;
          for (int c = 0; c < cnt; ++c) {
            const float4* v = reinterpret_cast<const float4*>(
                s.xw + (g * J + src[c]) * HF + h * F);
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            for (int q = 0; q < F4; ++q) {
              const float4 dv = doh[q], xv = op4<kPrecise>(v[q]);
              acc[0] = fmaf(dv.x, xv.x, acc[0]);
              acc[1] = fmaf(dv.y, xv.y, acc[1]);
              acc[2] = fmaf(dv.z, xv.z, acc[2]);
              acc[3] = fmaf(dv.w, xv.w, acc[3]);
            }
            const float da = (acc[0] + acc[1]) + (acc[2] + acc[3]);
            de[c] = da;
            sdot = fmaf(a[c], da, sdot);
          }
          const float dst = s.ad[item];
          float sum = 0.f;
          for (int c = 0; c < cnt; ++c) {
            const float e = dst + s.as[(g * J + src[c]) * H + h];
            const float v = a[c] * (de[c] - sdot) * (e >= 0.f ? 1.f : kSlope);
            de[c] = v;
            sum += v;
          }
          s.dad[item] = sum;
        }
        __syncthreads();
        // d_a_src = sum over the dsts that attend this source
        for (int item = threadIdx.x; item < R * H; item += blockDim.x) {
          const int r = item / H, h = item % H;
          const int g = r / J, j = r % J;
          float sum = 0.f;
          for (int k = 0; k < s.tcnt[j]; ++k)
            sum += s.de[(size_t)((g * J + s.tdst[j * D + k]) * H + h) * D
                        + s.tpos[j * D + k]];
          s.das[item] = sum;
        }
        __syncthreads();
        // d_att_src[h, f] += sum_r XW[r, h, f] d_a_src[r, h]; d_att_dst alike
        for (int item = threadIdx.x; item < HF; item += blockDim.x) {
          const int h = item / F;
          float a = 0.f, d = 0.f;
          for (int r = 0; r < R; ++r) {
            const float v = s.xw[r * HF + item];
            a = fmaf(v, s.das[r * H + h], a);
            d = fmaf(v, s.dad[r * H + h], d);
          }
          d_att_src[item] += a;
          d_att_dst[item] += d;
        }
        for (int h = 0; h < H; ++h) {
          // d_XW_h[j] = sum_i alpha_h[i, j] d_out[i] + d_a_src[j] att_src_h
          //             + d_a_dst[j] att_dst_h, rounded as an operand
          for (int item = threadIdx.x; item < R * F4; item += blockDim.x) {
            const int r = item / F4, f = (item % F4) * 4;
            const int g = r / J, j = r % J;
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            for (int k = 0; k < s.tcnt[j]; ++k) {
              const int ri = g * J + s.tdst[j * D + k];
              const float a = op<kPrecise>(
                  s.alpha[(size_t)(ri * H + h) * D + s.tpos[j * D + k]]);
              fma4(acc, a, *reinterpret_cast<const float4*>(s.h + ri * F + f));
            }
            fma4(acc, s.das[r * H + h],
                 __ldg(reinterpret_cast<const float4*>(att_src + h * F + f)));
            fma4(acc, s.dad[r * H + h],
                 __ldg(reinterpret_cast<const float4*>(att_dst + h * F + f)));
            *reinterpret_cast<float4*>(s.dxw + r * F + f) = op4<kPrecise>(
                make_float4(acc[0], acc[1], acc[2], acc[3]));
          }
          __syncthreads();
          // g += d_XW_h @ W_h^T;  dW[:, h] += x^T @ d_XW_h
          mm<kPrecise, 4>(s.dxw, F, pt + h * F * F, F, F, R, s.g, F, true);
          mm_tn(s.xo, F, s.dxw, F, R, F, F, dW + h * F, HF);
          __syncthreads();
        }
      } else {
        // ---- GraphConv: recompute ----------------------------------------
        const float* W_rel = p;
        const float* W_root = W_rel + F * F;
        const float* bias = W_root + F * F;
        const float* ln_scale = bias + F;
        const float* ln_bias = ln_scale + F;
        float* dW_rel = dp;
        float* dW_root = dW_rel + F * F;
        float* d_bias = dW_root + F * F;
        float* d_ln_scale = d_bias + F;
        float* d_ln_bias = d_ln_scale + F;
        float* nb = s.xw;                 // (R, F) neighbour sums A @ X
        float* dn = s.xw + G * J * F;     // (R, F) d_neigh

        for (int item = threadIdx.x; item < R * F4; item += blockDim.x) {
          const int r = item / F4, f = (item % F4) * 4;
          const int g = r / J, i = r % J;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int k = 0; k < s.ccnt[i]; ++k)
            fma4(acc, s.cw[i * D + k],
                 *reinterpret_cast<const float4*>(
                     s.xo + (g * J + s.csrc[i * D + k]) * F + f));
          *reinterpret_cast<float4*>(nb + r * F + f) =
              op4<kPrecise>(make_float4(acc[0], acc[1], acc[2], acc[3]));
        }
        __syncthreads();
        mm<kPrecise>(nb, F, W_rel, F, F, R, s.h, F, false);
        mm<kPrecise>(s.xo, F, W_root, F, F, R, s.h, F, true);
        __syncthreads();

        // ---- LayerNorm backward: s.h <- op(d_h) ------------------------
        norm_backward<kPrecise>(s, R, F, 1.f, bias, ln_scale, ln_bias, d_bias,
                                d_ln_scale, d_ln_bias);

        // ---- GraphConv backward ------------------------------------------
        mm_tn(nb, F, s.h, F, R, F, F, dW_rel, F);
        mm_tn(s.xo, F, s.h, F, R, F, F, dW_root, F);
        mm<kPrecise, 4>(s.h, F, pt, F, F, R, dn, F, false);
        mm<kPrecise, 4>(s.h, F, pt + F * F, F, F, R, s.g, F, true);
        __syncthreads();
        // g += A^T @ op(d_neigh) over the out-edges
        for (int item = threadIdx.x; item < R * F4; item += blockDim.x) {
          const int r = item / F4, f = (item % F4) * 4;
          const int g = r / J, j = r % J;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int k = 0; k < s.ctcnt[j]; ++k)
            fma4(acc, s.ctw[j * D + k],
                 op4<kPrecise>(*reinterpret_cast<const float4*>(
                     dn + (g * J + s.ctdst[j * D + k]) * F + f)));
          float4* o = reinterpret_cast<float4*>(s.g + r * F + f);
          float4 v = *o;
          v.x += acc[0]; v.y += acc[1]; v.z += acc[2]; v.w += acc[3];
          *o = v;
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < R * F; i += blockDim.x)
      dx[tile_off + i] = s.g[i];
    __syncthreads();
  }
}

// Graphs per block: about 42 node rows, which keeps two blocks on an SM.
int graphs_per_block(int J) { return J >= 42 ? 1 : 42 / J; }

template <bool kPrecise>
int max_blocks(int n, int J, int F, int H, int D) {
  const int G = graphs_per_block(J);
  const size_t bytes = smem_words(J, F, H, G, D) * sizeof(float);
  if (cudaFuncSetAttribute(gcn_stack_bwd_kernel<kPrecise>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gcn_stack_bwd_kernel<kPrecise>, kThreads, bytes) !=
          cudaSuccess ||
      per_sm < 1) {
    cudaGetLastError();
    return -1;
  }
  const int tiles = (n + G - 1) / G;
  const int blocks = sms * per_sm;
  return tiles < 1 ? 1 : (tiles < blocks ? tiles : blocks);
}

template <bool kPrecise>
int launch(const float* x0, const float* xs, const float* g,
           const float* params, const float* adj, float* dx, float* dparams,
           float* scratch, int n, int J, int F, int H, int L, int D,
           int blocks, cudaStream_t stream) {
  const int G = graphs_per_block(J);
  const int P = layer_offset(L, F, H);
  const size_t bytes = smem_words(J, F, H, G, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_bwd_kernel<kPrecise>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* partial = scratch;
  float* params_t = scratch + (size_t)blocks * P;
  const int widest = F * (H * F > 2 * F ? H * F : 2 * F);
  transpose_weights_kernel<<<(widest + 255) / 256, 256, 0, stream>>>(
      params, params_t, F, H, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gcn_stack_bwd_kernel<kPrecise><<<blocks, kThreads, bytes, stream>>>(
      x0, xs, g, params, params_t, adj, dx, partial, n, J, F, H, L, G, D, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(P + 255) / 256, 256, 0, stream>>>(
      partial, dparams, blocks, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the persistent grid for these shapes (the rows of scratch the
// caller allocates, plus one), or -1 if a block does not fit the card.
int a2m_gcn_stack_bwd_blocks(int n, int J, int F, int H, int D, int precise) {
  if (F % 4 != 0 || F > 64 || D < 1) return -1;
  return precise ? max_blocks<true>(n, J, F, H, D)
                 : max_blocks<false>(n, J, F, H, D);
}

int a2m_gcn_stack_bwd(const void* x0, const void* xs, const void* g,
                      const void* params, const void* adj, void* dx,
                      void* dparams, void* scratch, int n, int J, int F, int H,
                      int L, int D, int blocks, int precise, void* stream) {
  if (F % 4 != 0 || F > 64 || D < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return precise
             ? launch<true>((const float*)x0, (const float*)xs,
                            (const float*)g, (const float*)params,
                            (const float*)adj, (float*)dx, (float*)dparams,
                            (float*)scratch, n, J, F, H, L, D, blocks, st)
             : launch<false>((const float*)x0, (const float*)xs,
                             (const float*)g, (const float*)params,
                             (const float*)adj, (float*)dx, (float*)dparams,
                             (float*)scratch, n, J, F, H, L, D, blocks, st);
}

const char* a2m_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
