// Backward of the 5-layer GAT/GraphConv stack, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel a2m/nn/pallas_gcn.py::_bwd_kernel (called by
// _bwd_call; helpers _ln_bwd, _gat_bwd / _gat_bwd_rolled, _graph_conv_bwd).
// Per graph it walks the layers L..1: recompute the layer from its stored
// input (x0 for the first layer, xs[l - 2] for layer l), LayerNorm forward,
// d_y = g * leaky'(y), LayerNorm backward, then the GAT or GraphConv
// backward, and g <- g + d_x for the residual.  It returns dx (N, J, F) and
// the gradient of every parameter, flat, in the order of the parameters.
// Two designs, one for each mode: a2m_gcn_stack_bwd_tc (bf16 operands,
// mm_dtype=bf16: every g_step) on the tensor cores, and a2m_gcn_stack_bwd
// (f32 operands, the parity route, held to the plain version at 2e-4 / 5e-4)
// on the CUDA cores.
//
// Bound on the H100: at the main-path shapes (N = 8192, J = 42 and 10,
// F = 64, H = 4) the function reads x0, the four stored inputs and g and
// writes dx: 764 MB for both stacks, ~0.23 ms at 3.35 TB/s, above what its
// ~181 GFLOP take at the bf16 tensor-core rate (~0.18 ms), so it is bound
// by the bytes.  On the CUDA cores the same operations take >= 2.7 ms at
// the fp32 rate before any memory cost.
//
// The tensor-core design (bf16 mode):
// * the dense forward's tiles (gcn_dense_tc.cuh): T whole graphs in
//   graph-major rows, zero-padded to 128 rows, two 64-row M tiles, one
//   warpgroup each (T = 3 at J = 42, 12 at J = 10), features padded to 64;
//   the plan is the wrapper's (nn/gcn_kernel.py::dense_bwd_tc_plan) and
//   this file refuses one it does not reproduce.  One persistent block of
//   256 threads an SM walks tiles, and per tile the layers L..1;
// * every product is wgmma.m64n64k16 (bf16 operands, f32 sums).  The
//   recompute is the forward's (XW_h = X @ W_h, the apply sum_h alpha_h @
//   XW_h and A @ X as block-diagonal products with A built in registers,
//   neigh @ W_rel + X @ W_root).  The backward's products: d_XW_h =
//   alpha_h^T @ d_outh and d_x += A^T @ d_neigh, block-diagonal with the
//   transposed A operand built in registers from the slot table, B the
//   d_outh or d_neigh tile read MN-major; g += d_XW_h @ W_h^T, d_neigh =
//   d_h @ W_rel^T and g += d_h @ W_root^T with the same packed weight blocks
//   read MN-major (tnspB: no transposed copy); dW_h = X^T @ d_XW_h, dW_rel
//   = neigh^T @ d_h and dW_root = X^T @ d_h with both operand tiles read
//   MN-major (tnspA, tnspB), K the tile's 128 rows, the heads split
//   between the warpgroups;
// * the cotangent g stays in shared memory across the five layers (f32, a
//   thread's accumulator elements side by side) and is loaded into the
//   accumulators' layout only where it is used: LayerNorm's backward and
//   the products that add into it; d_h is masked to zero on pad rows and
//   dead graphs, so nothing of theirs reaches a gradient;
// * the edge-sparse pieces stay on the CUDA cores over shared-memory tiles:
//   d_alpha over each row's 4-6 slots (a lane per head, 64-wide dots of the
//   d_outh and XW_h tiles), the softmax backward, d_a_dst over the slots,
//   d_a_src over the transposed lists.  They are ~2 E F H operations a
//   graph against ~1.4 MFLOP of X @ W, and dense they would be (128 x 128)
//   products of which a few percent is wanted.  d_att_src[h] = W_h^T (X^T
//   d_a_src) is summed as X^T d_a_src (64 x H) per block and multiplied by
//   W_h^T once at the end;
// * only the current layer's weights and W_h att are in shared memory: the
//   next layer's stream from L2 (cp.async) into their room while the
//   weight gradients run; x's bf16 tile, XW_h (then d_XW_h) a tile a head,
//   d_outh or d_h, g, alpha, d_e and the per-layer vectors all live in
//   shared memory (219 KB at J = 42), none of them in L1.  The dynamic
//   shared memory is declared 1024-aligned, so that every region is the
//   base plus a constant: with a run-time aligned base the compiler spilled
//   the regions' pointers (376 B of spills a thread, 160 B once aligned;
//   at J = 42 5.47 -> 5.13 ms on an H100 80GB HBM3 at 700 W);
// * parameter gradients are deterministic and free of float atomics: each
//   block adds its tiles' gradients into a row of its own in a scratch
//   buffer, in tile order (a weight block's slice is loaded into the
//   accumulators before the barrier that precedes its product, which adds
//   onto it, and stored back; the column sums of d_h, d_y xhat and d_y are
//   reduced over lanes and warps in a fixed order; L2 evict-last hints keep
//   the rows before the streamed inputs), and a second kernel adds the rows
//   in block order.
//
// What holds it back (utils/edge_probe.py --bwd, PERF.md): one block of 8
// warps an SM at 255 registers, so every phase is a latency chain.  At
// J = 42 the block-diagonal d_XW_h products take the most cycles (~1K a k
// step, whether or not the next step is in flight: as K1's apply), then
// the recompute (K1's forward), LayerNorm and its backward, the attention
// backward, and the partial-row adds (~7%).  A layer-major schedule would
// keep a layer's dW on chip across a block's tiles, but a warpgroup's two
// GAT heads need 64 more registers a thread or 64 KB of shared memory, and
// g would go to device memory and back per layer (~0.9 GB, ~0.26 ms at
// N = 8192).

// Matching the plain version's roundings (nn/gcn_kernel.py::
// gcn_stack_bwd_plain, after a2m's _bwd_kernel): bf16 operands at x, W,
// XW_h (for d_alpha), alpha, d_outh = d_h / H, d_XW_h after the att terms,
// neigh, d_h and d_neigh; f32 logits, softmax, LayerNorm and att sums.
// wgmma sums in its own order and truncates where the plain version's
// products (cuBLAS) are k-order chains, so an XW_h, d_XW_h or d_neigh
// element within kTieUlps of a bf16 midpoint is recomputed in k order
// (neigh is a sum of a few bf16 values of a 0/1 skeleton, exact in f32).
//
// The CUDA-core design (f32 mode):
// * the TPU grid runs in order and adds every tile's parameter gradients
//   into the same output blocks.  Here blocks run in no order, so the grid
//   is a fixed number of persistent blocks (as many as fit the card at
//   once), each striding over the tiles of graphs and adding its tiles'
//   gradients into a row of its own in a scratch buffer (blocks x P floats,
//   at most 264 x 272 KB, which lives mostly in L2).  Inside a block every
//   scratch entry has one owner thread per step and the steps are
//   separated by barriers; the tile order per block is fixed.  A second
//   kernel then adds the rows in block order, so the same inputs give
//   bit-equal gradients.  No float atomics;
// * one head's d_XW at a time: XW for all heads stays in shared memory
//   from the recomputation (the attention needs it), but d_XW is formed,
//   used for d_x and d_W, and dropped head by head, which keeps a block at
//   ~112 KB of shared memory (two blocks per SM at J = 42);
// * the softmax backward d_e = alpha (d_alpha - sum alpha d_alpha) is zero
//   off the skeleton's edges, like alpha itself, so d_alpha, d_e, the
//   attention products and A^T @ d_neigh loop over per-node edge lists (and
//   their transposes, built once per block), not over dense (J, J) tiles;
// * the matrix products with W^T read a transposed copy of the weights,
//   made by a small kernel in the same launch, so they reuse the forward's
//   register-tiled matmul with coalesced weight loads;
// * a ragged N needs no padding: the last tile holds fewer graphs.
//
// Layout: x0, g, dx (N, J, F) and xs (L - 1, N, J, F) f32 contiguous
// (16-byte aligned for the tensor-core entry); params and dparams as in
// gcn_stack.cu, wpack, watt, route and conv_w as its tensor-core entries
// take them.  Scratch: (blocks + 1) x P floats in f32 mode (the per-block
// partial gradients, then the transposed weights), grid x P in bf16 mode.

#include "gcn_dense_tc.cuh"

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
// it holds d_h * scale_h, the operand the layer's backward takes.
// Adds this tile's d_ln_scale, d_ln_bias and d_bias into the block's
// partials (warps summed in order).
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
        o[f] = dh * scale_h;
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
        s.xo[i] = v;
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

        mm<true>(s.xo, F, W, F, HF, R, s.xw, HF, false);
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
              fma4(acc, a[c],
                   *reinterpret_cast<const float4*>(
                       s.xw + (g * J + src[c]) * HF + h * F + f));
#pragma unroll
            for (int q = 0; q < 4; ++q) total[q] += acc[q];
          }
          *reinterpret_cast<float4*>(s.h + r * F + f) =
              make_float4(total[0] / (float)H, total[1] / (float)H,
                          total[2] / (float)H, total[3] / (float)H);
        }
        __syncthreads();

        // ---- LayerNorm backward: s.h <- d_h / H ------------------------
        norm_backward(s, R, F, 1.f / (float)H, bias, ln_scale, ln_bias,
                      d_bias, d_ln_scale, d_ln_bias);

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
              const float4 dv = doh[q], xv = v[q];
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
              const float a = 
                  s.alpha[(size_t)(ri * H + h) * D + s.tpos[j * D + k]];
              fma4(acc, a, *reinterpret_cast<const float4*>(s.h + ri * F + f));
            }
            fma4(acc, s.das[r * H + h],
                 __ldg(reinterpret_cast<const float4*>(att_src + h * F + f)));
            fma4(acc, s.dad[r * H + h],
                 __ldg(reinterpret_cast<const float4*>(att_dst + h * F + f)));
            *reinterpret_cast<float4*>(s.dxw + r * F + f) = 
                make_float4(acc[0], acc[1], acc[2], acc[3]);
          }
          __syncthreads();
          // g += d_XW_h @ W_h^T;  dW[:, h] += x^T @ d_XW_h
          mm<true, 4>(s.dxw, F, pt + h * F * F, F, F, R, s.g, F, true);
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
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        }
        __syncthreads();
        mm<true>(nb, F, W_rel, F, F, R, s.h, F, false);
        mm<true>(s.xo, F, W_root, F, F, R, s.h, F, true);
        __syncthreads();

        // ---- LayerNorm backward: s.h <- d_h ----------------------------
        norm_backward(s, R, F, 1.f, bias, ln_scale, ln_bias, d_bias,
                      d_ln_scale, d_ln_bias);

        // ---- GraphConv backward ------------------------------------------
        mm_tn(nb, F, s.h, F, R, F, F, dW_rel, F);
        mm_tn(s.xo, F, s.h, F, R, F, F, dW_root, F);
        mm<true, 4>(s.h, F, pt, F, F, R, dn, F, false);
        mm<true, 4>(s.h, F, pt + F * F, F, F, R, s.g, F, true);
        __syncthreads();
        // g += A^T @ op(d_neigh) over the out-edges
        for (int item = threadIdx.x; item < R * F4; item += blockDim.x) {
          const int r = item / F4, f = (item % F4) * 4;
          const int g = r / J, j = r % J;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int k = 0; k < s.ctcnt[j]; ++k)
            fma4(acc, s.ctw[j * D + k],
                 *reinterpret_cast<const float4*>(
                     dn + (g * J + s.ctdst[j * D + k]) * F + f));
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

int max_blocks(int n, int J, int F, int H, int D) {
  const int G = graphs_per_block(J);
  const size_t bytes = smem_words(J, F, H, G, D) * sizeof(float);
  if (cudaFuncSetAttribute(gcn_stack_bwd_kernel,
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
          &per_sm, gcn_stack_bwd_kernel, kThreads, bytes) !=
          cudaSuccess ||
      per_sm < 1) {
    cudaGetLastError();
    return -1;
  }
  const int tiles = (n + G - 1) / G;
  const int blocks = sms * per_sm;
  return tiles < 1 ? 1 : (tiles < blocks ? tiles : blocks);
}

int launch(const float* x0, const float* xs, const float* g,
           const float* params, const float* adj, float* dx, float* dparams,
           float* scratch, int n, int J, int F, int H, int L, int D,
           int blocks, cudaStream_t stream) {
  const int G = graphs_per_block(J);
  const int P = layer_offset(L, F, H);
  const size_t bytes = smem_words(J, F, H, G, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_bwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* partial = scratch;
  float* params_t = scratch + (size_t)blocks * P;
  const int widest = F * (H * F > 2 * F ? H * F : 2 * F);
  transpose_weights_kernel<<<(widest + 255) / 256, 256, 0, stream>>>(
      params, params_t, F, H, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gcn_stack_bwd_kernel<<<blocks, kThreads, bytes, stream>>>(
      x0, xs, g, params, params_t, adj, dx, partial, n, J, F, H, L, G, D, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(P + 255) / 256, 256, 0, stream>>>(
      partial, dparams, blocks, P);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 mode: tensor cores
// ---------------------------------------------------------------------------

// The shared-memory layout of a plan, in bytes from a 1024-aligned base;
// nn/gcn_kernel.py::dense_bwd_tc_plan computes the same.
struct BwdLayout {
  int T, R, S;   // graphs a tile, their rows, attention slots a row (<= 8)
  int off_xo, off_t, off_do, off_g, off_watt, off_att, off_vec, off_asrc,
      off_adst,
      off_dsrc, off_ddst, off_alpha, off_de, off_u, off_red, off_aval,
      off_lut, off_nbr, off_tnbr, off_tslot, off_deg, off_tdeg, bytes;
};

BwdLayout bwd_layout(int J, int H, int L, int S) {
  BwdLayout s;
  s.T = kTcRows / J;
  s.R = s.T * J;
  s.S = S;
  const int gat = (L + 1) / 2, tiles = imax(H, 2);
  // one layer's weight blocks (H for a GAT layer, 2 for GraphConv) at 0
  s.off_xo = tiles * kBlock;                   // x, bf16 operand tile
  // XW_h then d_XW_h, one tile a head; GraphConv: neigh and d_neigh
  s.off_t = s.off_xo + kTile;
  s.off_do = s.off_t + tiles * kTile;          // d_h / H (GAT) or d_h, bf16
  s.off_g = s.off_do + kTile;                  // (16, 256) float2: g
  s.off_watt = s.off_g + kTcRows * kFp * 4;    // (H, 2, 64) f64, a layer's
  s.off_att = s.off_watt + H * 2 * kFp * 8;    // (gat, H, 2, 64) f32
  s.off_vec = s.off_att + gat * H * 2 * kFp * 4;    // (L, 3, 64) f32
  s.off_asrc = s.off_vec + L * 3 * kFp * 4;    // (128, 4) f32 each: a_src,
  s.off_adst = s.off_asrc + kTcRows * kMaxHeads * 4;   // a_dst, d_a_src,
  s.off_dsrc = s.off_adst + kTcRows * kMaxHeads * 4;   // d_a_dst
  s.off_ddst = s.off_dsrc + kTcRows * kMaxHeads * 4;
  s.off_alpha = s.off_ddst + kTcRows * kMaxHeads * 4;  // (128, S, 4) bf16
  s.off_de = s.off_alpha + kTcRows * S * kMaxHeads * 2;   // (128, S, 4) f32
  s.off_u = s.off_de + kTcRows * S * kMaxHeads * 4;  // (gat, H, 64, 2) f32
  s.off_red = s.off_u + gat * H * kFp * 2 * 4; // (8 warps, 3, 64) f32
  s.off_aval = s.off_red + kTcThreads / 32 * 3 * kFp * 4;   // (J, J) bf16
  s.off_lut = s.off_aval + round16(J * J * 2); // (J, J) u8
  s.off_nbr = s.off_lut + round16(J * J);      // (J, 8) u8
  s.off_tnbr = s.off_nbr + J * kMaxSlots;      // (J, 8) u8
  s.off_tslot = s.off_tnbr + J * kMaxSlots;    // (J, 8) u8
  s.off_deg = s.off_tslot + J * kMaxSlots;     // (J) u8
  s.off_tdeg = s.off_deg + round16(J);         // (J) u8
  s.bytes = s.off_tdeg + round16(J) + 1024;
  return s;
}

// The bf16 alpha of head h transposed, this thread's A fragment at k step
// s: row j (this thread's, a source), column i (a destination in the
// tile): alpha_h[i, the slot of j in i's list], zeros off the graph and its
// edges.
__device__ __forceinline__ void alpha_t_fragment(
    uint32_t (&a)[4], const uint16_t* alpha_s, const uint8_t* lut_s,
    const int (&rbase)[2], const int (&rj)[2], int s, int tig, int J, int S,
    int h) {
  uint32_t e[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 16 * s + 2 * tig + (q & 1) + 8 * (q >> 1);
      const unsigned ji = (unsigned)(i - rbase[half]);
      const int slot = ji < (unsigned)J ? lut_s[ji * J + rj[half]] : kNoSlot;
      e[half][q] =
          slot != kNoSlot ? alpha_s[(i * S + slot) * kMaxHeads + h] : 0u;
    }
  }
  a[0] = e[0][0] | e[0][1] << 16;
  a[1] = e[1][0] | e[1][1] << 16;
  a[2] = e[0][2] | e[0][3] << 16;
  a[3] = e[1][2] | e[1][3] << 16;
}

// A^T's bf16 entries, this thread's A fragment at k step s: A[i, j] at row
// j, column i.
__device__ __forceinline__ void adjacency_t_fragment(
    uint32_t (&a)[4], const uint16_t* aval_s, const int (&rbase)[2],
    const int (&rj)[2], int s, int tig, int J) {
  uint32_t e[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned ji = (unsigned)(16 * s + 2 * tig + (q & 1)
                                     + 8 * (q >> 1) - rbase[half]);
      e[half][q] = ji < (unsigned)J ? aval_s[ji * J + rj[half]] : 0u;
    }
  }
  a[0] = e[0][0] | e[0][1] << 16;
  a[1] = e[1][0] | e[1][1] << 16;
  a[2] = e[0][2] | e[0][3] << 16;
  a[3] = e[1][2] | e[1][3] << 16;
}

__device__ __forceinline__ float bf16_at(const uint8_t* tile, int r, int f) {
  return __uint_as_float(
      (uint32_t)*reinterpret_cast<const uint16_t*>(tile + swz(r, f)) << 16);
}

// Element (row, col) of an operand tile's row times a weight block read
// MN-major (row @ block^T's transpose: sum_k a[row, k] block[k, col]), as a
// sequential f32 sum in k order: the plain version's d_h @ W^T.  For
// near-tie recomputation.
__device__ __noinline__ float k_order_dot_t(const uint8_t* a_tile, int row,
                                            const uint8_t* b_block, int col) {
  float s = 0.f;
  for (int k = 0; k < kFp; ++k)
    s = fmaf(bf16_at(a_tile, row, k), bf16_at(b_block, k, col), s);
  return s;
}

// Element (row, col) of alpha_h^T @ d_outh as a sequential f32 sum over the
// destinations that attend the row's node, in ascending order (tn, ts:
// their rows' joints and the node's slot in their lists): the order of the
// plain version's product (einsum over the destinations); masked entries
// add exact zeros there.  For near-tie recomputation.
__device__ __noinline__ float d_xw_dot(const uint16_t* alpha_s,
                                       const uint8_t* do_s, const uint8_t* tn,
                                       const uint8_t* ts, int deg, int rbase,
                                       int col, int S, int h) {
  float s = 0.f;
  for (int k = 0; k < deg; ++k) {
    const int i = rbase + tn[k];
    const float a = __uint_as_float(
        (uint32_t)alpha_s[(i * S + ts[k]) * kMaxHeads + h] << 16);
    s = fmaf(a, bf16_at(do_s, i, col), s);
  }
  return s;
}

// v (the accumulators of M tile mt, complete) into an operand tile: bf16,
// rows of 64 features, swizzled; an element within kTieUlps of a bf16
// midpoint is taken again from redo(half, col) (in the plain version's
// order) before it is rounded.
template <typename Redo>
__device__ __forceinline__ void store_tile(const float (&v)[32],
                                           uint8_t* tile, int mt, int wrow,
                                           int tig, Redo redo) {
  uint32_t ties = 0;
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    ties |= (uint32_t)near_tie(v[k]) << k
            | (uint32_t)near_tie(v[k + 1]) << (k + 1);
    *reinterpret_cast<uint32_t*>(
        tile + swz(mt * 64 + acc_row(k, wrow), acc_col(k, tig))) =
        pack_bf16(v[k], v[k + 1]);
  }
  for (; ties; ties &= ties - 1) {
    const int k = __ffs(ties) - 1;
    *reinterpret_cast<__nv_bfloat16*>(
        tile + swz(mt * 64 + acc_row(k, wrow), acc_col(k, tig))) =
        __float2bfloat16_rn(redo((k >> 1) & 1, acc_col(k, tig)));
  }
}

// v / H, a product where 1 / H is exact (H a power of two), else the
// division: one branch for all, so that the path not taken is code apart.
__device__ __forceinline__ void divide_heads(float (&v)[32], int H,
                                             float inv_h) {
  if ((H & (H - 1)) == 0) {
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] *= inv_h;
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = div_rn(v[k], (float)H);
  }
}

// v (f32, the accumulators' layout) into an operand tile, bf16, every row.
__device__ __forceinline__ void store_plain(const float (&v)[32],
                                            uint8_t* tile, int mt, int wrow,
                                            int tig) {
#pragma unroll
  for (int k = 0; k < 32; k += 2)
    *reinterpret_cast<uint32_t*>(
        tile + swz(mt * 64 + acc_row(k, wrow), acc_col(k, tig))) =
        pack_bf16(v[k], v[k + 1]);
}

// The end of a layer and its backward, in the accumulators' layout (a quad
// of lanes holds a row).  On entry v is the layer's pre-norm output, bias
// included, g the cotangent of the layer's output; LayerNorm as the plain
// version takes it (LayerNorm's sums in float64, each step rounded as its
// separate operations round it), y = xhat ln_scale + ln_bias, d_y = g
// leaky'(y), d_xhat = d_y ln_scale and d_h = inv ((d_xhat - mean d_xhat) -
// xhat mean(d_xhat xhat)).  On exit v holds d_h, zero on rows that are not
// live and on columns >= F, so that no pad row reaches a gradient (a zero
// row's LayerNorm has inv = 1000).  The column sums of d_h, d_y xhat and
// d_y over this warp's rows go to red (warp, 3, 64), in a fixed order.
__device__ __forceinline__ void norm_backward_tc(
    float (&v)[32], const float (&g)[32], const float* ln_scale,
    const float* ln_bias, int F, int tig, const bool (&live)[2], float* red,
    int warp, int lane) {
  const double inv_f = 1.0 / F;
  float cs[48];                            // column sums, q * 16 + i
#pragma unroll
  for (int i = 0; i < 48; ++i) cs[i] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s += (double)v[4 * i + 2 * half] + v[4 * i + 2 * half + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mean = (float)(s * inv_f);
    float xh[16];
    double sq = 0.0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = 4 * (i / 2) + 2 * half + i % 2;
      xh[i] = acc_col(k, tig) < F ? __fsub_rn(v[k], mean) : 0.f;
      sq = fma((double)xh[i], (double)xh[i], sq);
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float rs = rsqrtf((float)(sq * inv_f) + kLnEps);
    float dxh[16];
    double s1 = 0.0, s2 = 0.0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = 4 * (i / 2) + 2 * half + i % 2, col = acc_col(k, tig);
      xh[i] = __fmul_rn(xh[i], rs);
      const float y = __fadd_rn(__fmul_rn(xh[i], ln_scale[col]),
                                ln_bias[col]);
      const float dy =
          live[half] && col < F ? __fmul_rn(g[k], y >= 0.f ? 1.f : kSlope)
                                : 0.f;
      cs[16 + i] += __fmul_rn(dy, xh[i]);
      cs[32 + i] += dy;
      dxh[i] = __fmul_rn(dy, ln_scale[col]);
      s1 += dxh[i];
      s2 += __fmul_rn(dxh[i], xh[i]);
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    const float m1 = (float)(s1 * inv_f), m2 = (float)(s2 * inv_f);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = 4 * (i / 2) + 2 * half + i % 2;
      const float dh =
          live[half] && acc_col(k, tig) < F
              ? __fmul_rn(rs, __fsub_rn(__fsub_rn(dxh[i], m1),
                                        __fmul_rn(xh[i], m2)))
              : 0.f;
      cs[i] += dh;
      v[k] = dh;
    }
  }
  // the warp's eight row groups (lanes 4 apart): a reduce-scatter, each
  // step halving the sums a lane holds (48 -> 24 -> 12 -> 6: 42 shuffles
  // where a reduction of each would take 144); each lane then writes its 6
  float a24[24], a12[12], a6[6];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int m = 0; m < 24; ++m) {
    a24[m] = (b4 ? cs[m + 24] : cs[m])
             + __shfl_xor_sync(0xffffffffu, b4 ? cs[m] : cs[m + 24], 16);
  }
#pragma unroll
  for (int m = 0; m < 12; ++m) {
    a12[m] = (b3 ? a24[m + 12] : a24[m])
             + __shfl_xor_sync(0xffffffffu, b3 ? a24[m] : a24[m + 12], 8);
  }
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    a6[m] = (b2 ? a12[m + 6] : a12[m])
            + __shfl_xor_sync(0xffffffffu, b2 ? a12[m] : a12[m + 6], 4);
  }
  const int first = 24 * b4 + 12 * b3 + 6 * b2;
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const int idx = first + m, q = idx / 16, i = idx % 16;
    red[(warp * 3 + q) * kFp + acc_col(4 * (i / 2) + i % 2, tig)] = a6[m];
  }
}

// red's column sums, warps in order, added to prev (the partial row's
// value, loaded earlier) into the partial row: d_bias, d_ln_scale,
// d_ln_bias (F each, in that order from dp).  After a barrier.
__device__ __forceinline__ void add_column_sums(const float* red, float* dp,
                                                float prev, int F, int tid) {
  if (tid < 3 * F) {
    const int q = tid / F, col = tid % F;
    float s = 0.f;
    for (int w = 0; w < kTcThreads / 32; ++w) s += red[(w * 3 + q) * kFp + col];
    dp[tid] = prev + s;
  }
}

// The attention backward of one (row, head), a lane per head: alpha again
// as attend takes it (f32: max, the sum of the exps in source order, exp /
// sum), d_alpha over the slots = d_outh[row] . XW_h[source] (bf16 operands,
// f32 sums), then d_e = alpha (d_alpha - sum alpha d_alpha) leaky'(e) into
// de (the row's slots, 4 heads each; d_alpha waits there); returns d_a_dst,
// the sum of d_e over the slots in source order.  The slot loops are
// rolled: the kernel's code is what its time follows.
__device__ __forceinline__ float attend_backward(
    const float* asrc_s, float ad, uint2 nb, int deg, int rbase, int h,
    const uint8_t* do_s, int row, const uint8_t* xw, float* de) {
  auto source = [&](int q) {
    return rbase + (int)(((q < 4 ? nb.x : nb.y) >> (8 * (q % 4))) & 0xff);
  };
  auto logit = [&](int q) {
    return ad + asrc_s[source(q) * kMaxHeads + h];
  };
  float mx = -INFINITY;
#pragma unroll 1
  for (int q = 0; q < deg; ++q) mx = fmaxf(mx, leaky(logit(q)));
  float sum = 0.f;
#pragma unroll 1
  for (int q = 0; q < deg; ++q) sum += expf(leaky(logit(q)) - mx);
  uint4 dv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    dv[c] = *reinterpret_cast<const uint4*>(do_s + row * 128
                                            + (((c ^ row) & 7) << 4));
  float sdot = 0.f;
#pragma unroll 1
  for (int q = 0; q < deg; ++q) {
    const int sr = source(q);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint4 xv = *reinterpret_cast<const uint4*>(
          xw + sr * 128 + (((c ^ sr) & 7) << 4));
      const uint32_t dw[4] = {dv[c].x, dv[c].y, dv[c].z, dv[c].w};
      const uint32_t xw4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 a = unpack_bf16(dw[w]), b = unpack_bf16(xw4[w]);
        acc[2 * w] = fmaf(a.x, b.x, acc[2 * w]);
        acc[2 * w + 1] = fmaf(a.y, b.y, acc[2 * w + 1]);
      }
    }
    const float da = ((acc[0] + acc[1]) + (acc[2] + acc[3]))
                     + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
    de[q * kMaxHeads + h] = da;
    sdot = __fadd_rn(sdot,
                     __fmul_rn(expf(leaky(logit(q)) - mx) / sum, da));
  }
  float dsum = 0.f;
#pragma unroll 1
  for (int q = 0; q < deg; ++q) {
    const float e = logit(q);
    const float v = __fmul_rn(
        __fmul_rn(expf(leaky(e) - mx) / sum,
                  __fsub_rn(de[q * kMaxHeads + h], sdot)),
        e >= 0.f ? 1.f : kSlope);
    de[q * kMaxHeads + h] = v;
    dsum += v;
  }
  return dsum;
}

// The partial rows (272 KB a block at F = 64, H = 4) are read and written
// once a tile each; the L2 keeps them before the streamed x, xs and g.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ float2 ld_keep(const float* p, uint64_t policy) {
  float2 v;
  asm volatile("ld.global.cg.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ void st_keep(float* p, float2 v,
                                        uint64_t policy) {
  asm volatile("st.global.cg.L2::cache_hint.v2.f32 [%0], {%1, %2}, %3;"
               ::"l"(p), "f"(v.x), "f"(v.y), "l"(policy)
               : "memory");
}

// The partial row's slice of a weight gradient (64 input features x 64
// output features at dw, row stride ld) into the accumulators, so that the
// product adds onto it: the loads are issued here and waited for by the
// product, so that what comes between hides their latency.  Zeros past F.
__device__ __forceinline__ void load_weight_grad(float (&d)[32],
                                                 const float* dw, int ld,
                                                 int F, int wrow, int tig,
                                                 uint64_t keep) {
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    const int m = acc_row(k, wrow), c = acc_col(k, tig);
    const float2 v = m < F && c < F ? ld_keep(dw + m * ld + c, keep)
                                    : make_float2(0.f, 0.f);
    d[k] = v.x;
    d[k + 1] = v.y;
  }
}

// ... and the sum back.
__device__ __forceinline__ void store_weight_grad(const float (&d)[32],
                                                  float* dw, int ld, int F,
                                                  int wrow, int tig,
                                                  uint64_t keep) {
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    const int m = acc_row(k, wrow), c = acc_col(k, tig);
    if (m < F && c < F)
      st_keep(dw + m * ld + c, make_float2(d[k], d[k + 1]), keep);
  }
}

// d += A^T @ B over the tile's kd k steps of 16 rows, A and B operand
// tiles (rows of 64 values), both read MN-major: the gradient of a weight,
// K the tile's rows.
__device__ __forceinline__ void product_tn(float (&d)[32], const uint8_t* a,
                                           const uint8_t* b, int kd) {
  fence_operands(d);
  wgmma_fence();
#pragma unroll 1
  for (int s = 0; s < kd; ++s)
    wgmma_ss_k16<1, 1>(d, sw128_desc(a + s * kStep),
                       sw128_desc(b + s * kStep));
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(d);
}

// d += A (this M tile's rows of an operand tile, K-major) @ B^T (a weight
// block read MN-major: the product with the transpose of the layer's
// weight).  Issued, not waited for.
__device__ __forceinline__ void product_wt(float (&d)[32], const uint8_t* a,
                                           const uint8_t* w) {
  const uint64_t da = sw128_desc(a);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_ss_k16<0, 1>(d, da + 2 * k, sw128_desc(w + k * kStep));
}

// A layer's weight blocks into w_s and, for a GAT layer, its W_h att
// (float64) into watt_s: issued, not waited for.
__device__ __forceinline__ void fetch_weights(uint8_t* w_s, double* watt_s,
                                              const uint4* wpack,
                                              const double* watt, int layer,
                                              int H, int tid) {
  const int blocks = layer % 2 == 0 ? H : 2;
  const uint4* src =
      wpack + (size_t)((layer + 1) / 2 * H + layer / 2 * 2) * kBlock / 16;
  for (int i = tid; i < blocks * kBlock / 16; i += kTcThreads)
    cp_async16(w_s + 16 * i, src + i);
  if (layer % 2 == 0) {
    const double* a = watt + (size_t)layer / 2 * H * 2 * kFp;
    for (int i = tid; i < H * kFp; i += kTcThreads)
      cp_async16(watt_s + 2 * i, a + 2 * i);
  }
}

// The cotangent g between its uses: each thread's 32 accumulator elements,
// pair k / 2 at g_s[(k / 2) * 256 + tid] (no bank conflicts), so that it
// takes no registers through the phases that do not touch it.
__device__ __forceinline__ void load_g(float (&g)[32], const float2* g_s,
                                       int tid) {
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    const float2 v = g_s[(k / 2) * kTcThreads + tid];
    g[k] = v.x;
    g[k + 1] = v.y;
  }
}
__device__ __forceinline__ void store_g(const float (&g)[32], float2* g_s,
                                        int tid) {
#pragma unroll
  for (int k = 0; k < 32; k += 2)
    g_s[(k / 2) * kTcThreads + tid] = make_float2(g[k], g[k + 1]);
}

__global__ void __launch_bounds__(kTcThreads, 1)
gcn_stack_bwd_tc_kernel(const float* __restrict__ x0,
                        const float* __restrict__ xs,
                        const float* __restrict__ gout,
                        const float* __restrict__ params,
                        const uint4* __restrict__ wpack,
                        const double* __restrict__ watt,
                        const int* __restrict__ route,
                        const float* __restrict__ conv_w,
                        float* __restrict__ dx, float* __restrict__ partial,
                        int n, int J, int F, int H, int L, int E, int Ec,
                        int P, BwdLayout lay) {
  // 1024-aligned (the swizzle's period): the offset below then folds to 0
  // and every region's address is the base plus a constant of the layout
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw
      + ((1024 - (__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int mt = warp / 4;                  // a warpgroup's M tile
  const int wrow = (warp % 4) * 16 + lane / 4;   // accumulator row in it
  const int tig = lane % 4;                 // accumulator column pair
  const int row0 = mt * 64 + wrow;          // this thread's rows: row0, +8
  const int T = lay.T, R = lay.R, S = lay.S;
  const int HF = H * F, gat = (L + 1) / 2;
  const float inv_h = 1.f / (float)H;       // exact where H is 2^k

  uint8_t* w_s = base;                      // this layer's weight blocks
  uint8_t* xo_s = base + lay.off_xo;
  uint8_t* t_s = base + lay.off_t;          // tile i at t_s + i * kTile
  uint8_t* do_s = base + lay.off_do;
  float2* g_s = reinterpret_cast<float2*>(base + lay.off_g);
  double* watt_s = reinterpret_cast<double*>(base + lay.off_watt);
  float* att_s = reinterpret_cast<float*>(base + lay.off_att);
  float* vec_s = reinterpret_cast<float*>(base + lay.off_vec);
  float* asrc_s = reinterpret_cast<float*>(base + lay.off_asrc);
  float* adst_s = reinterpret_cast<float*>(base + lay.off_adst);
  float* dsrc_s = reinterpret_cast<float*>(base + lay.off_dsrc);
  float* ddst_s = reinterpret_cast<float*>(base + lay.off_ddst);
  uint16_t* alpha_s = reinterpret_cast<uint16_t*>(base + lay.off_alpha);
  float* de_s = reinterpret_cast<float*>(base + lay.off_de);
  float* u_s = reinterpret_cast<float*>(base + lay.off_u);
  float* red_s = reinterpret_cast<float*>(base + lay.off_red);
  uint16_t* aval_s = reinterpret_cast<uint16_t*>(base + lay.off_aval);
  uint8_t* lut_s = base + lay.off_lut;      // (J, J): slot of (dst, src)
  uint8_t* nbr_s = base + lay.off_nbr;      // (J, 8): source of a slot
  uint8_t* tnbr_s = base + lay.off_tnbr;    // (J, 8): dsts of a source
  uint8_t* tslot_s = base + lay.off_tslot;  // (J, 8): its slot there
  uint8_t* deg_s = base + lay.off_deg;      // (J): slots of a joint
  uint8_t* tdeg_s = base + lay.off_tdeg;    // (J): dsts of a joint
  float* part = partial + (size_t)blockIdx.x * P;
  const uint64_t keep = l2_evict_last();    // for the partial row

  // once per block: the first layer's weights in flight, the partial row
  // zeroed, every GAT layer's att_src, att_dst, every
  // layer's bias, ln_scale and ln_bias zero-padded to 64, zeros in the
  // operand tiles (pad rows of x stay zero) and the attention sums, and the
  // skeleton's tables from route
  fetch_weights(w_s, watt_s, wpack, watt, L - 1, H, tid);
  for (int i = tid; i < P; i += kTcThreads) part[i] = 0.f;
  {
    const float* p = params;
    for (int l = 0; l < L; ++l) {
      if (l % 2 == 0) {
        const float* att = p + F * HF;         // att_src (H, F), att_dst
        for (int i = tid; i < H * 2 * kFp; i += kTcThreads) {
          const int h = i / (2 * kFp), w = i / kFp % 2, f = i % kFp;
          att_s[(l / 2 * H * 2) * kFp + i] =
              f < F ? __ldg(att + w * HF + h * F + f) : 0.f;
        }
        p += F * HF + 2 * HF;
      } else {
        p += 2 * F * F;
      }
      for (int i = tid; i < 3 * kFp; i += kTcThreads)
        vec_s[l * 3 * kFp + i] =
            i % kFp < F ? __ldg(p + i / kFp * F + i % kFp) : 0.f;
      p += 3 * F;
    }
  }
  for (int i = tid; i < kTile / 16; i += kTcThreads)
    reinterpret_cast<uint4*>(xo_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < 4 * kTcRows * kMaxHeads; i += kTcThreads)
    asrc_s[i] = 0.f;                       // a_src .. d_a_dst, contiguous
  for (int i = tid; i < gat * H * kFp * 2; i += kTcThreads) u_s[i] = 0.f;
  for (int i = tid; i < J * J; i += kTcThreads) {
    lut_s[i] = kNoSlot;
    aval_s[i] = 0;
  }
  __syncthreads();
  {
    const int* src = route;
    const int* ptr = route + 2 * E;
    const int* csrc = ptr + J + 1;
    const int* cptr = csrc + Ec;
    for (int j = tid; j < J; j += kTcThreads) {
      deg_s[j] = (uint8_t)(ptr[j + 1] - ptr[j]);
      for (int e = ptr[j]; e < ptr[j + 1]; ++e) {
        lut_s[j * J + src[e]] = (uint8_t)(e - ptr[j]);
        nbr_s[j * kMaxSlots + e - ptr[j]] = (uint8_t)src[e];
      }
      for (int e = cptr[j]; e < cptr[j + 1]; ++e)
        aval_s[j * J + csrc[e]] =
            __bfloat16_as_ushort(__float2bfloat16_rn(conv_w[e]));
    }
  }
  __syncthreads();
  // the transposed lists: the dsts that attend source j, ascending, and
  // j's slot in each one's list
  for (int j = tid; j < J; j += kTcThreads) {
    int k = 0;
    for (int i = 0; i < J; ++i) {
      const int slot = lut_s[i * J + j];
      if (slot != kNoSlot && k < kMaxSlots) {
        tnbr_s[j * kMaxSlots + k] = (uint8_t)i;
        tslot_s[j * kMaxSlots + k] = (uint8_t)slot;
        ++k;
      }
    }
    tdeg_s[j] = (uint8_t)k;
  }
  fence_async_smem();
  __syncthreads();

  // this thread's rows: their graph's first row (far below 0 for a pad
  // row, so that no other row falls in its graph), joint and graph
  int rbase[2], rj[2], rg[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    rg[half] = r < R ? r / J : T;
    rbase[half] = r < R ? rg[half] * J : -(1 << 20);
    rj[half] = r < R ? r - rbase[half] : 0;
  }
  // the k steps of the block-diagonal products: the rows of the graphs
  // this warpgroup's rows touch; of the weight gradients: the tile's rows
  const int last = min(mt * 64 + 63, R - 1);
  const int ks0 = (mt * 64 / J * J) / 16;
  const int ks1 = ((last / J + 1) * J + 15) / 16;
  const int kd = (R + 15) / 16;

  const int tiles = (n + T - 1) / T;
#ifdef A2M_TC_PROFILE
  long long t_prev_ = clock64();
#endif
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * T;
    const size_t grow0 = (size_t)g0 * J;    // device row of tile row 0
    const bool live[2] = {rg[0] < T && g0 + rg[0] < n,
                          rg[1] < T && g0 + rg[1] < n};
    // the cotangent of the stack's output, f32, in the accumulators'
    // layout; it stays in registers through the layers
    // this thread's two rows, as offsets into an (N, J, F) array
    const size_t roff[2] = {(grow0 + row0) * F, (grow0 + row0 + 8) * F};
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int half = (k >> 1) & 1, col = acc_col(k, tig);
      float2 v = make_float2(0.f, 0.f);
      if (live[half] && col < F)
        v = __ldcs(reinterpret_cast<const float2*>(gout + roff[half] + col));
      g_s[(k / 2) * kTcThreads + tid] = v;
    }

    for (int layer = L - 1; layer >= 0; --layer) {
      // x of the layer into its operand tile (bf16; its f32 value is not
      // needed: the residual's gradient is g itself)
      const float* xin = layer == 0 ? x0 : xs + (size_t)(layer - 1) * n * J * F;
      const float* xrow[2] = {xin + roff[0], xin + roff[1]};
#pragma unroll
      for (int k = 0; k < 32; k += 2) {
        const int half = (k >> 1) & 1, col = acc_col(k, tig);
        const int r = row0 + 8 * half;
        float2 v = make_float2(0.f, 0.f);
        if (live[half] && col < F)
          v = __ldcs(reinterpret_cast<const float2*>(xrow[half] + col));
        if (r < R)
          *reinterpret_cast<uint32_t*>(xo_s + swz(r, col)) =
              pack_bf16(v.x, v.y);
      }
      cp_async_wait_all();                  // this layer's weights
      fence_async_smem();
      __syncthreads();
      PROF(0)
      const float* bias = vec_s + layer * 3 * kFp;
      const float* ln_scale = bias + kFp;
      const float* ln_bias = ln_scale + kFp;
      float* dp = part + layer_offset(layer, F, H);
      const bool gat = layer % 2 == 0;
      // the partial row's d_bias, d_ln_scale, d_ln_bias, in flight
      float* dvec = dp + (gat ? F * HF + 2 * HF : 2 * F * F);
      const float vec_prev = tid < 3 * F ? dvec[tid] : 0.f;
      float d[32];
      if (gat) {
        // ---- GAT: recompute ---------------------------------------------
        // (a) XW_h of this warpgroup's rows, every head, into its tile;
        // the logits while the tensor cores run
#pragma unroll 1
        for (int h = 0; h < H; ++h) {
          const uint8_t* wh = w_s + h * kBlock;
          product(d, xo_s + mt * 64 * 128, wh);
          head_logits(xo_s, watt_s + h * 2 * kFp, asrc_s, adst_s, h, row0,
                      tig);
          wgmma_commit();
          wgmma_wait_all();
          fence_operands(d);
          store_head(d, xo_s, wh, t_s + h * kTile, mt, wrow, tig);
        }
        fence_async_smem();
        __syncthreads();
        // (b) alpha of this thread's rows, a lane per head
        if (tig < H) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row0 + 8 * half;
            if (r < R)
              attend(asrc_s, adst_s[r * kMaxHeads + tig],
                     *reinterpret_cast<const uint2*>(
                         nbr_s + rj[half] * kMaxSlots),
                     deg_s[rj[half]], rbase[half], tig,
                     alpha_s + r * S * kMaxHeads);
          }
        }
        __syncwarp();
        // (c) the layer's output again: sum_h alpha_h @ XW_h, per k step
        // the block-diagonal alpha of every head in registers
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        {
          uint2 v[2][4];
          alpha_elements(v, alpha_s, lut_s, rbase, rj, row0, ks0, tig, J, S);
#pragma unroll 1
          for (int s = ks0; s < ks1; ++s) {
            uint32_t a[kMaxHeads][4];
#pragma unroll
            for (int h = 0; h < kMaxHeads; ++h) {
              const unsigned sel = h & 1 ? 0x7632 : 0x5410;
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const uint2 lo = v[u & 1][2 * (u >> 1)];
                const uint2 hi = v[u & 1][2 * (u >> 1) + 1];
                a[h][u] = __byte_perm(h < 2 ? lo.x : lo.y,
                                      h < 2 ? hi.x : hi.y, sel);
              }
            }
            fence_operands(d);
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < kMaxHeads; ++h)
              if (h < H)
                wgmma_rs_k16<1>(d, a[h],
                                sw128_desc(t_s + h * kTile + s * kStep));
            wgmma_commit();
            if (s + 1 < ks1)
              alpha_elements(v, alpha_s, lut_s, rbase, rj, row0, s + 1, tig,
                             J, S);
            wgmma_wait_all();
            fence_operands(d);
#pragma unroll
            for (int h = 0; h < kMaxHeads; ++h) fence_fragment(a[h]);
          }
        }
        divide_heads(d, H, inv_h);
#pragma unroll
        for (int k = 0; k < 32; ++k)
          d[k] = __fadd_rn(d[k], bias[acc_col(k, tig)]);
      } else {
        // ---- GraphConv: recompute ---------------------------------------
        const uint8_t* w_rel = w_s;
        const uint8_t* w_root = w_s + kBlock;
        uint8_t* nb_t = t_s;                // neigh, bf16
        // (a) neigh = A @ X: per k step the block-diagonal A in registers
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        {
          uint32_t e[2][4];
          adjacency_elements(e, aval_s, rbase, rj, ks0, tig, J);
#pragma unroll 1
          for (int s = ks0; s < ks1; ++s) {
            uint32_t a[4] = {e[0][0] | e[0][1] << 16, e[1][0] | e[1][1] << 16,
                             e[0][2] | e[0][3] << 16, e[1][2] | e[1][3] << 16};
            fence_operands(d);
            wgmma_fence();
            wgmma_rs_k16<1>(d, a, sw128_desc(xo_s + s * kStep));
            wgmma_commit();
            if (s + 1 < ks1)
              adjacency_elements(e, aval_s, rbase, rj, s + 1, tig, J);
            wgmma_wait_all();
            fence_operands(d);
            fence_fragment(a);
          }
        }
        // (b) neigh rounded to bf16: the A operand of neigh @ W_rel, and
        // its tile for dW_rel; the output = neigh @ W_rel + X @ W_root
        uint32_t na[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            na[ks][u] = pack_bf16(d[8 * ks + 2 * u], d[8 * ks + 2 * u + 1]);
#pragma unroll
        for (int k = 0; k < 32; k += 2)
          *reinterpret_cast<uint32_t*>(
              nb_t + swz(mt * 64 + acc_row(k, wrow), acc_col(k, tig))) =
              na[k / 8][(k % 8) / 2];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        fence_operands(d);
        wgmma_fence();
        {
          const uint64_t drel = sw128_desc(w_rel);
          const uint64_t dxo = sw128_desc(xo_s + mt * 64 * 128);
          const uint64_t droot = sw128_desc(w_root);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_rs_k16<0>(d, na[ks], drel + 2 * ks);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_k16(d, dxo + 2 * ks, droot + 2 * ks);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(d);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) fence_fragment(na[ks]);
#pragma unroll
        for (int k = 0; k < 32; ++k)
          d[k] = __fadd_rn(d[k], bias[acc_col(k, tig)]);
      }
      PROF(1)
      // LayerNorm and its backward: d <- d_h; d_h / H (GAT) or d_h, bf16,
      // into its tile (every row: zeros past the live ones); the column
      // sums into the partial row
      {
        float gr[32];
        load_g(gr, g_s, tid);
        norm_backward_tc(d, gr, ln_scale, ln_bias, F, tig, live, red_s, warp,
                         lane);
      }
      if (gat) divide_heads(d, H, inv_h);
      store_plain(d, do_s, mt, wrow, tig);
      fence_async_smem();
      __syncthreads();
      add_column_sums(red_s, dvec, vec_prev, F, tid);
      PROF(2)
      if (gat) {
        const int gl = layer / 2;
        const float* att_src = att_s + gl * H * 2 * kFp;   // (H, 2, 64)
        // (e) the softmax backward, a lane per head: d_e over each row's
        // slots and d_a_dst; then d_a_src over the transposed lists
        if (tig < H) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row0 + 8 * half;
            if (r < R)
              ddst_s[r * kMaxHeads + tig] = attend_backward(
                  asrc_s, adst_s[r * kMaxHeads + tig],
                  *reinterpret_cast<const uint2*>(nbr_s
                                                  + rj[half] * kMaxSlots),
                  deg_s[rj[half]], rbase[half], tig, do_s, r,
                  t_s + tig * kTile, de_s + r * S * kMaxHeads);
          }
        }
        __syncthreads();
        if (tig < H) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row0 + 8 * half;
            if (r < R) {
              const uint8_t* tn = tnbr_s + rj[half] * kMaxSlots;
              const uint8_t* ts = tslot_s + rj[half] * kMaxSlots;
              float sum = 0.f;
              for (int k = 0; k < tdeg_s[rj[half]]; ++k)
                sum += de_s[((rbase[half] + tn[k]) * S + ts[k]) * kMaxHeads
                            + tig];
              dsrc_s[r * kMaxHeads + tig] = sum;
            }
          }
        }
        __syncwarp();
        PROF(3)
        // (f) per head: d_XW_h = alpha_h^T @ d_outh + d_a_src att_src_h +
        // d_a_dst att_dst_h, bf16, into the head's tile (XW_h is read);
        // then g += d_XW_h @ W_h^T
#pragma unroll 1
        for (int h = 0; h < H; ++h) {
#pragma unroll
          for (int i = 0; i < 32; ++i) d[i] = 0.f;
          uint32_t an[4];
          alpha_t_fragment(an, alpha_s, lut_s, rbase, rj, ks0, tig, J, S, h);
#pragma unroll 1
          for (int s = ks0; s < ks1; ++s) {
            uint32_t a[4] = {an[0], an[1], an[2], an[3]};
            fence_operands(d);
            wgmma_fence();
            wgmma_rs_k16<1>(d, a, sw128_desc(do_s + s * kStep));
            wgmma_commit();
            if (s + 1 < ks1)
              alpha_t_fragment(an, alpha_s, lut_s, rbase, rj, s + 1, tig, J,
                               S, h);
            wgmma_wait_all();
            fence_operands(d);
            fence_fragment(a);
          }
          PROF(12)
          const float* as = att_src + h * 2 * kFp;
          const float* ad = as + kFp;
          float das[2], dad[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            das[half] = dsrc_s[(row0 + 8 * half) * kMaxHeads + h];
            dad[half] = ddst_s[(row0 + 8 * half) * kMaxHeads + h];
          }
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int half = (k >> 1) & 1, col = acc_col(k, tig);
            d[k] = __fadd_rn(__fadd_rn(d[k], __fmul_rn(das[half], as[col])),
                             __fmul_rn(dad[half], ad[col]));
          }
          uint8_t* th = t_s + h * kTile;
          store_tile(d, th, mt, wrow, tig, [&](int half, int col) {
            // selects, not run-time indices: those would put the arrays in
            // local memory
            const int r = row0 + 8 * half, j = half ? rj[1] : rj[0];
            return __fadd_rn(
                __fadd_rn(d_xw_dot(alpha_s, do_s, tnbr_s + j * kMaxSlots,
                                   tslot_s + j * kMaxSlots,
                                   r < R ? tdeg_s[j] : 0,
                                   half ? rbase[1] : rbase[0], col, S, h),
                          __fmul_rn(half ? das[1] : das[0], as[col])),
                __fmul_rn(half ? dad[1] : dad[0], ad[col]));
          });
          PROF(13)
        }
        PROF(4)
        fence_async_smem();
        warpgroup_sync(mt);
        {
          float gr[32];
          load_g(gr, g_s, tid);
          fence_operands(gr);
          wgmma_fence();
#pragma unroll
          for (int h = 0; h < kMaxHeads; ++h)
            if (h < H)
              product_wt(gr, t_s + h * kTile + mt * 64 * 128,
                         w_s + h * kBlock);
          wgmma_commit();
          wgmma_wait_all();
          fence_operands(gr);
          store_g(gr, g_s, tid);
        }
        // (g) dW_h += x^T @ d_XW_h over the tile's rows, the heads split
        // between the warpgroups, on the partial row's slice (its loads in
        // flight across the barrier); the block's sums x^T d_a_src,
        // x^T d_a_dst (64 x H each) for d_att_src, d_att_dst
        if (mt < H) load_weight_grad(d, dp + mt * F, HF, F, wrow, tig, keep);
        PROF(5)
        fence_async_smem();
        __syncthreads();                    // the weights are read
        fetch_weights(w_s, watt_s, wpack, watt, layer > 0 ? layer - 1 : L - 1,
                      H, tid);
        PROF(6)
#pragma unroll 1
        for (int h = mt; h < H; h += 2) {
          if (h != mt) load_weight_grad(d, dp + h * F, HF, F, wrow, tig, keep);
          product_tn(d, xo_s, t_s + h * kTile, kd);
          PROF(7)
          store_weight_grad(d, dp + h * F, HF, F, wrow, tig, keep);
          PROF(8)
        }
        {
          const int kf = tid % kFp, h = tid / kFp;
          if (h < H && kf < F) {
            float su = 0.f, sd = 0.f;
            for (int r = 0; r < R; ++r) {
              const float xv = bf16_at(xo_s, r, kf);
              su = fmaf(xv, dsrc_s[r * kMaxHeads + h], su);
              sd = fmaf(xv, ddst_s[r * kMaxHeads + h], sd);
            }
            float* u = u_s + ((gl * H + h) * kFp + kf) * 2;
            u[0] += su;
            u[1] += sd;
          }
        }
        PROF(9)
        __syncthreads();
        PROF(10)
      } else {
        // ---- GraphConv: the backward ------------------------------------
        const uint8_t* w_rel = w_s;
        const uint8_t* w_root = w_s + kBlock;
        uint8_t* nb_t = t_s;                // neigh, bf16
        uint8_t* dn_t = t_s + kTile;        // d_neigh, bf16
        // (d) d_neigh = d_h @ W_rel^T, bf16 into its tile; g += d_h @
        // W_root^T
        float gr[32];
        load_g(gr, g_s, tid);
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        fence_operands(d);
        fence_operands(gr);
        wgmma_fence();
        product_wt(d, do_s + mt * 64 * 128, w_rel);
        product_wt(gr, do_s + mt * 64 * 128, w_root);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(d);
        fence_operands(gr);
        store_tile(d, dn_t, mt, wrow, tig, [&](int half, int col) {
          return k_order_dot_t(do_s, row0 + 8 * half, w_rel, col);
        });
        // the partial row's slice of dW_rel (warpgroup 0) or dW_root (1),
        // its loads in flight across the barrier and A^T @ d_neigh
        load_weight_grad(d, dp + mt * F * F, F, F, wrow, tig, keep);
        PROF(4)
        fence_async_smem();
        __syncthreads();                    // d_neigh's tile; weights read
        fetch_weights(w_s, watt_s, wpack, watt, layer - 1, H, tid);
        PROF(6)
        // (e) g += A^T @ d_neigh: the block-diagonal A^T in registers
        {
          uint32_t an[4];
          adjacency_t_fragment(an, aval_s, rbase, rj, ks0, tig, J);
#pragma unroll 1
          for (int s = ks0; s < ks1; ++s) {
            uint32_t a[4] = {an[0], an[1], an[2], an[3]};
            fence_operands(gr);
            wgmma_fence();
            wgmma_rs_k16<1>(gr, a, sw128_desc(dn_t + s * kStep));
            wgmma_commit();
            if (s + 1 < ks1)
              adjacency_t_fragment(an, aval_s, rbase, rj, s + 1, tig, J);
            wgmma_wait_all();
            fence_operands(gr);
            fence_fragment(a);
          }
        }
        store_g(gr, g_s, tid);
        PROF(5)
        // (f) dW_rel += neigh^T @ d_h (warpgroup 0), dW_root += x^T @ d_h
        // (warpgroup 1)
        product_tn(d, mt == 0 ? nb_t : xo_s, do_s, kd);
        PROF(7)
        store_weight_grad(d, dp + mt * F * F, F, F, wrow, tig, keep);
        PROF(8)
        __syncthreads();
        PROF(10)
      }
    }

#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int half = (k >> 1) & 1, col = acc_col(k, tig);
      if (live[half] && col < F)
        __stcs(reinterpret_cast<float2*>(dx + roff[half] + col),
               g_s[(k / 2) * kTcThreads + tid]);
    }
    PROF(11)
  }
  cp_async_wait_all();                      // the prefetch past the end
  __syncthreads();
  // d_att_src[h] = W_h^T (x^T d_a_src) of the block's tiles (W_h the
  // rounded weights xw was computed with), d_att_dst alike
  for (int item = tid; item < gat * H * kFp; item += kTcThreads) {
    const int gl = item / (H * kFp), h = item / kFp % H, f = item % kFp;
    if (f >= F) continue;
    const uint8_t* blk = reinterpret_cast<const uint8_t*>(
        wpack + (size_t)(gl * (H + 2) + h) * kBlock / 16);
    const float* u = u_s + (gl * H + h) * kFp * 2;
    float ss = 0.f, sd = 0.f;
    for (int k = 0; k < F; ++k) {
      const float w = __uint_as_float(
          (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(
              blk + swz(f, k))) << 16);
      ss = fmaf(w, u[2 * k], ss);
      sd = fmaf(w, u[2 * k + 1], sd);
    }
    float* dp = part + layer_offset(2 * gl, F, H) + F * HF;
    dp[h * F + f] += ss;
    dp[HF + h * F + f] += sd;
  }
}

int launch_tc(const void* x0, const void* xs, const void* g,
              const void* params, const void* wpack, const void* watt,
              const void* route, const void* conv_w, void* dx, void* dparams,
              void* scratch, int n, int J, int F, int H, int L, int E, int Ec,
              int T, int S, int smem_bytes, int grid, cudaStream_t stream) {
  if (F % 4 != 0 || F < 4 || F > kFp || H < 1 || H > kMaxHeads || J < 1
      || J > kTcRows || L < 1 || S < 1 || S > J || S > kMaxSlots
      || grid < 1 || T != kTcRows / J)
    return (int)cudaErrorInvalidValue;
  const BwdLayout lay = bwd_layout(J, H, L, S);
  if (lay.bytes != smem_bytes || (size_t)lay.bytes > kBlockShared)
    return (int)cudaErrorInvalidValue;
  const int P = layer_offset(L, F, H);
  if (n <= 0)
    return (int)cudaMemsetAsync(dparams, 0, (size_t)P * sizeof(float),
                                stream);
  cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.bytes);
  if (err != cudaSuccess) return (int)err;
  gcn_stack_bwd_tc_kernel<<<grid, kTcThreads, lay.bytes, stream>>>(
      (const float*)x0, (const float*)xs, (const float*)g,
      (const float*)params, (const uint4*)wpack, (const double*)watt,
      (const int*)route, (const float*)conv_w, (float*)dx, (float*)scratch,
      n, J, F, H, L, E, Ec, P, lay);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(P + 255) / 256, 256, 0, stream>>>(
      (const float*)scratch, (float*)dparams, grid, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 mode (CUDA cores): blocks of the persistent grid for these shapes
// (the rows of scratch the caller allocates, plus one), or -1 if a block
// does not fit the card.
int a2m_gcn_stack_bwd_blocks(int n, int J, int F, int H, int D) {
  if (F % 4 != 0 || F > 64 || D < 1) return -1;
  return max_blocks(n, J, F, H, D);
}

// f32 mode (CUDA cores); bf16 operands run a2m_gcn_stack_bwd_tc.
int a2m_gcn_stack_bwd(const void* x0, const void* xs, const void* g,
                      const void* params, const void* adj, void* dx,
                      void* dparams, void* scratch, int n, int J, int F, int H,
                      int L, int D, int blocks, void* stream) {
  if (F % 4 != 0 || F > 64 || D < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  return launch((const float*)x0, (const float*)xs, (const float*)g,
                (const float*)params, (const float*)adj, (float*)dx,
                (float*)dparams, (float*)scratch, n, J, F, H, L, D, blocks,
                (cudaStream_t)stream);
}

// bf16 mode (tensor cores), on the wrapper's plan: T graphs a tile, S
// attention slots a row, smem_bytes of shared memory, grid persistent
// blocks, scratch (grid, P) f32; wpack and watt from
// nn/gcn_kernel.py::edge_tc_weights, route and conv_w from edge_routing.
// A plan this file does not reproduce is refused.
int a2m_gcn_stack_bwd_tc(const void* x0, const void* xs, const void* g,
                         const void* params, const void* wpack,
                         const void* watt, const void* route,
                         const void* conv_w, void* dx, void* dparams,
                         void* scratch, int n, int J, int F, int H, int L,
                         int E, int Ec, int T, int S, int smem_bytes,
                         int grid, void* stream) {
  return launch_tc(x0, xs, g, params, wpack, watt, route, conv_w, dx,
                   dparams, scratch, n, J, F, H, L, E, Ec, T, S, smem_bytes,
                   grid, (cudaStream_t)stream);
}

// The tensor-core kernel as built: out[0] registers a thread, out[1] local
// (spill) bytes a thread, out[2] blocks an SM at smem_bytes, out[3]
// threads a block.
int a2m_gcn_stack_bwd_tc_info(int smem_bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gcn_stack_bwd_tc_kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gcn_stack_bwd_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gcn_stack_bwd_tc_kernel, kTcThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = kTcThreads;
  return 0;
}

#ifdef A2M_TC_PROFILE
// The phase counters (1024 blocks x 16 phases, cycles) into out; reset.
int a2m_gcn_stack_bwd_tc_profile(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
int a2m_gcn_stack_bwd_tc_profile_reset() {
  static unsigned long long zero[1024][16];
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif

const char* a2m_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
