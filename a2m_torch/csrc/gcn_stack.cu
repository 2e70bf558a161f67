// Fused forward of the 5-layer GAT/GraphConv stack, CUDA C++ for sm_90a, with
// two entry points.
//
// a2m_gcn_stack replaces the Pallas TPU kernel a2m/nn/pallas_gcn.py::_kernel
// (called by _fused_impl / fused_gcn_stack, rolled variant _gat_rolled): one
// launch runs every layer of the stack for a tile of skeleton graphs.
// a2m_gcn_stack_fwd replaces a2m/nn/pallas_gcn.py::_fwd_kernel (called by
// _fwd_with_residuals): the same forward under autograd, which also stores
// the input of layers 2..L for the backward kernel (gcn_stack_bwd.cu).  It
// writes L - 1 more (N, J, F) tensors, 654 MB against 219 MB for both stacks
// of the flagship at N = 8192, all of it bytes on top of the same
// arithmetic; the stores leave from the pass that already rounds x for the
// layer's matmuls.
//   GAT layers (1, 3, 5):  XW = X @ W; per head a_src = XW_h . att_src[h],
//     a_dst = XW_h . att_dst[h]; e[i, j] = LeakyReLU_0.2(a_dst[i] + a_src[j])
//     masked to adjacency + self-loops; softmax over j; out = mean_h(alpha_h
//     @ XW_h) + bias.
//   GraphConv layers (2, 4): out = (A @ X) @ W_rel + X @ W_root + b.
//   Every layer: LayerNorm (eps 1e-6), LeakyReLU 0.2, + residual.
//
// Bound on the H100: at the main-path shapes (N = 8192 graphs, J = 42 or 10,
// F = 64, H = 4) the hand stack needs ~49 GFLOP (attention and A @ X over
// the skeleton's edges) against 176 MB of x in and y out, so at the bf16
// tensor-core rate it would be bound by the bytes (~0.05 ms at 3.35 TB/s).
// This kernel runs on the CUDA cores in fp32 FMAs and is bound by their
// rate and by shared-memory traffic.  What the design does about it:
// * like the Pallas kernel keeps x in VMEM, a block keeps its tile of x in
//   shared memory in f32 across all five layers, so x makes one trip from
//   device memory and one back; XW, the attention weights and each layer's
//   output never leave shared memory; the weights (~270 KB per stack) are
//   read through L1/L2;
// * the dense matmuls (X @ W, @ W_rel, @ W_root) give each thread an
//   8-row x 4-column register tile fed by float4 loads;
// * the skeleton graphs are trees, so each block lists every node's
//   in-edges once, and the softmax, alpha @ XW and A @ X loop over those
//   edges only (the Pallas kernel's -inf mask and zero adjacency entries
//   contribute exact zeros, so the function is the same);
// * matmul operands are rounded once, where they are written.
// Tensor cores (wgmma over several graphs packed into one 64-row tile) are
// later work.
//
// Precision: kPrecise=false rounds the matmul operands where a2m's
// mm_dtype=bf16 does, with __float2bfloat16_rn, and accumulates the
// products (exact in f32) in f32.  The attention logits, softmax and
// LayerNorm stay f32, as in the Pallas kernel.  kPrecise=true is plain f32.
//
// Layout: x and y are (N, J, F) f32 contiguous; params is one f32 buffer,
// per layer in kernel order (see a2m_torch/nn/gcn_kernel.py::pack_params):
//   GAT:       W (F, H*F), att_src (H, F), att_dst (H, F), bias (F),
//              ln_scale (F), ln_bias (F)
//   GraphConv: W_rel (F, F), W_root (F, F), bias (F), ln_scale (F),
//              ln_bias (F)
// adj is (J, J) f32, A[dst, src], without self-loops.

#include "gcn_common.cuh"

namespace {

constexpr int kThreads = 256;

// kStash selects the forward with stash (a2m's _fwd_kernel): the same
// forward, and the f32 input of every layer after the first also goes to
// xs (L - 1, N, J, F) for the backward kernel.  Without it xs is unused and
// the instantiation is the gradient-free forward as it was.
template <bool kPrecise, bool kStash>
__global__ void __launch_bounds__(kThreads, 2)
gcn_stack_kernel(const float* __restrict__ x, float* __restrict__ y,
                 float* __restrict__ xs, const float* __restrict__ params,
                 const float* __restrict__ adj, int n, int J, int F, int H,
                 int L, int G) {
  extern __shared__ __align__(16) float smem[];
  const int HF = H * F;
  const int F4 = F / 4;
  const int g0 = blockIdx.x * G;
  const int gn = min(G, n - g0);          // graphs in this (ragged) tile
  const int R = gn * J;                   // node rows in this tile
  float* x_s = smem;                      // (G*J, F)  layer input, f32
  float* out_s = x_s + G * J * F;         // (G*J, F)  layer output
  float* xw_s = out_s + G * J * F;        // (G*J, H*F) XW
  float* alpha_s = xw_s + G * J * HF;     // (G, H, J, <=J) attention weights
  float* as_s = alpha_s + G * H * J * J;  // (G*J, H) a_src
  float* ad_s = as_s + G * J * H;         // (G*J, H) a_dst
  float* nbw_s = ad_s + G * J * H;        // (J, J) edge weights A[i, j] != 0
  int* nbi_s = reinterpret_cast<int*>(nbw_s + J * J);   // (J, J) their j
  int* deg_s = nbi_s + J * J;             // (J) edges per node

  const float* xg = x + (size_t)g0 * J * F;
  for (int i = threadIdx.x; i < R * F; i += blockDim.x) x_s[i] = xg[i];
  // the skeleton graphs are sparse: each node keeps the list of its
  // in-edges (j, A[i, j]); GraphConv sums over it, GAT attends over the
  // positive ones plus the self-loop
  for (int i = threadIdx.x; i < J; i += blockDim.x) {
    int d = 0;
    for (int j = 0; j < J; ++j) {
      const float a = adj[i * J + j];
      if (a != 0.f) {
        nbi_s[i * J + d] = j;
        nbw_s[i * J + d] = a;
        ++d;
      }
    }
    deg_s[i] = d;
  }
  __syncthreads();

  const float* p = params;
  for (int layer = 0; layer < L; ++layer) {
    const bool gat = layer % 2 == 0;
    // x as a matmul operand, rounded once: GAT keeps it in out_s until the
    // attention apply overwrites it, GraphConv in the first F columns of
    // xw_s (the neighbour sums take the next F)
    float* xo = gat ? out_s : xw_s;
    if (kStash && layer > 0) {
      float* stash = xs + ((size_t)(layer - 1) * n + g0) * J * F;
      for (int i = threadIdx.x; i < R * F; i += blockDim.x) {
        const float v = x_s[i];
        stash[i] = v;
        xo[i] = op<kPrecise>(v);
      }
    } else {
      for (int i = threadIdx.x; i < R * F; i += blockDim.x)
        xo[i] = op<kPrecise>(x_s[i]);
    }
    __syncthreads();

    const float* bias;
    const float* ln_scale;
    const float* ln_bias;
    if (gat) {
      // ---- GAT --------------------------------------------------------
      const float* W = p;
      const float* att_src = W + F * HF;
      const float* att_dst = att_src + HF;
      bias = att_dst + HF;
      ln_scale = bias + F;
      ln_bias = ln_scale + F;
      p = ln_bias + F;

      mm<kPrecise>(xo, F, W, F, HF, R, xw_s, HF, false);
      __syncthreads();
      // a_src, a_dst per (node, head) from the f32 XW
      for (int item = threadIdx.x; item < R * H; item += blockDim.x) {
        const int r = item / H, h = item % H;
        const float4* v = reinterpret_cast<const float4*>(xw_s + r * HF
                                                          + h * F);
        const float4* as4 = reinterpret_cast<const float4*>(att_src + h * F);
        const float4* ad4 = reinterpret_cast<const float4*>(att_dst + h * F);
        float s[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int q = 0; q < F4; ++q) {
          const float4 xv = v[q], a = __ldg(as4 + q), b = __ldg(ad4 + q);
          s[0] = fmaf(xv.x, a.x, s[0]); s[1] = fmaf(xv.y, a.y, s[1]);
          s[2] = fmaf(xv.z, a.z, s[2]); s[3] = fmaf(xv.w, a.w, s[3]);
          d[0] = fmaf(xv.x, b.x, d[0]); d[1] = fmaf(xv.y, b.y, d[1]);
          d[2] = fmaf(xv.z, b.z, d[2]); d[3] = fmaf(xv.w, b.w, d[3]);
        }
        as_s[item] = (s[0] + s[1]) + (s[2] + s[3]);
        ad_s[item] = (d[0] + d[1]) + (d[2] + d[3]);
      }
      __syncthreads();
      // softmax over the source nodes j of each (graph, head, dst i): the
      // self-loop first, then the in-edges with A[i, j] > 0; alpha is
      // stored in that order, already an operand of alpha @ XW.  Then XW
      // becomes an operand in place.
      for (int item = threadIdx.x; item < R * H; item += blockDim.x) {
        const int h = item % H, r = item / H;
        const int g = r / J, i = r % J;
        float* row = alpha_s + ((g * H + h) * J + i) * J;
        const int* nb = nbi_s + i * J;
        const float* w = nbw_s + i * J;
        const float* src = as_s + (g * J) * H + h;
        const float dst = ad_s[r * H + h];
        float mx = leaky(dst + src[i * H]);
        row[0] = mx;
        int c = 1;
        for (int k = 0; k < deg_s[i]; ++k) {
          if (w[k] > 0.f && nb[k] != i) {
            const float e = leaky(dst + src[nb[k] * H]);
            row[c++] = e;
            mx = fmaxf(mx, e);
          }
        }
        float sum = 0.f;
        for (int k = 0; k < c; ++k) {
          const float ex = expf(row[k] - mx);
          row[k] = ex;
          sum += ex;
        }
        for (int k = 0; k < c; ++k) row[k] = op<kPrecise>(row[k] / sum);
      }
      if (!kPrecise) {
        for (int i = threadIdx.x; i < R * HF / 4; i += blockDim.x) {
          float4* v = reinterpret_cast<float4*>(xw_s) + i;
          *v = op4<kPrecise>(*v);
        }
      }
      __syncthreads();
      // out = (sum_h alpha_h @ XW_h) / H over the same edges; a thread owns
      // one node x 4 features
      for (int item = threadIdx.x; item < R * F4; item += blockDim.x) {
        const int r = item / F4, f = (item % F4) * 4;
        const int g = r / J, i = r % J;
        const int* nb = nbi_s + i * J;
        const float* w = nbw_s + i * J;
        const float* xg_s = xw_s + (g * J) * HF + f;
        float total[4] = {0.f, 0.f, 0.f, 0.f};
        for (int h = 0; h < H; ++h) {
          const float* a = alpha_s + ((g * H + h) * J + i) * J;
          const float* v = xg_s + h * F;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          fma4(acc, a[0], *reinterpret_cast<const float4*>(v + i * HF));
          int c = 1;
          for (int k = 0; k < deg_s[i]; ++k) {
            if (w[k] > 0.f && nb[k] != i)
              fma4(acc, a[c++],
                   *reinterpret_cast<const float4*>(v + nb[k] * HF));
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) total[q] += acc[q];
        }
        float4 o;
        o.x = total[0] / (float)H; o.y = total[1] / (float)H;
        o.z = total[2] / (float)H; o.w = total[3] / (float)H;
        *reinterpret_cast<float4*>(out_s + r * F + f) = o;
      }
    } else {
      // ---- GraphConv --------------------------------------------------
      const float* W_rel = p;
      const float* W_root = W_rel + F * F;
      bias = W_root + F * F;
      ln_scale = bias + F;
      ln_bias = ln_scale + F;
      p = ln_bias + F;

      float* nb_s = xw_s + G * J * F;     // (G*J, F) neighbour sums A @ X
      for (int item = threadIdx.x; item < R * F4; item += blockDim.x) {
        const int r = item / F4, f = (item % F4) * 4;
        const int g = r / J, i = r % J;
        const int* nb = nbi_s + i * J;
        const float* w = nbw_s + i * J;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < deg_s[i]; ++k)
          fma4(acc, w[k], *reinterpret_cast<const float4*>(
                              xo + (g * J + nb[k]) * F + f));
        *reinterpret_cast<float4*>(nb_s + r * F + f) =
            op4<kPrecise>(make_float4(acc[0], acc[1], acc[2], acc[3]));
      }
      __syncthreads();
      mm<kPrecise>(nb_s, F, W_rel, F, F, R, out_s, F, false);
      mm<kPrecise>(xo, F, W_root, F, F, R, out_s, F, true);
    }
    __syncthreads();

    // ---- bias, LayerNorm, LeakyReLU, residual: one warp per row ---------
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float pb[2], ps[2], pl[2];            // this lane's f = lane, lane + 32
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = lane + 32 * u;
      pb[u] = f < F ? __ldg(bias + f) : 0.f;
      ps[u] = f < F ? __ldg(ln_scale + f) : 0.f;
      pl[u] = f < F ? __ldg(ln_bias + f) : 0.f;
    }
    for (int r = warp; r < R; r += blockDim.x / 32) {
      float* o = out_s + r * F;
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
    __syncthreads();
  }

  float* yg = y + (size_t)g0 * J * F;
  for (int i = threadIdx.x; i < R * F; i += blockDim.x) yg[i] = x_s[i];
}

size_t smem_floats(int J, int F, int H, int G) {
  return (size_t)G * J * F * 2 + (size_t)G * J * H * F
         + (size_t)G * H * J * J + (size_t)G * J * H * 2
         + (size_t)J * J * 2 + J;
}

template <bool kPrecise, bool kStash>
int launch(const float* x, float* y, float* xs, const float* params,
           const float* adj, int n, int J, int F, int H, int L, int G,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(J, F, H, G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_kernel<kPrecise, kStash>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + G - 1) / G;
  gcn_stack_kernel<kPrecise, kStash><<<blocks, kThreads, bytes, stream>>>(
      x, y, xs, params, adj, n, J, F, H, L, G);
  return (int)cudaGetLastError();
}

// Graphs per block: one at J = 42, several at small J, so a block's tile
// holds about 64 node rows.
int graphs_per_block(int J) { return J >= 64 ? 1 : 64 / J; }

}  // namespace

extern "C" {

int a2m_gcn_stack(const void* x, void* y, const void* params,
                  const void* adj, int n, int J, int F, int H, int L,
                  int precise, void* stream) {
  if (n <= 0) return 0;
  // float4 tiles; one LayerNorm row per warp holds F <= 64
  if (F % 4 != 0 || F > 64) return (int)cudaErrorInvalidValue;
  const int G = graphs_per_block(J);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* pp = (const float*)params;
  const float* ap = (const float*)adj;
  return precise ? launch<true, false>(xp, (float*)y, nullptr, pp, ap, n, J,
                                       F, H, L, G, s)
                 : launch<false, false>(xp, (float*)y, nullptr, pp, ap, n, J,
                                        F, H, L, G, s);
}

// The forward with stash: y as a2m_gcn_stack, and xs (L - 1, N, J, F).
int a2m_gcn_stack_fwd(const void* x, void* y, void* xs, const void* params,
                      const void* adj, int n, int J, int F, int H, int L,
                      int precise, void* stream) {
  if (n <= 0) return 0;
  if (F % 4 != 0 || F > 64) return (int)cudaErrorInvalidValue;
  const int G = graphs_per_block(J);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* pp = (const float*)params;
  const float* ap = (const float*)adj;
  return precise ? launch<true, true>(xp, (float*)y, (float*)xs, pp, ap, n,
                                      J, F, H, L, G, s)
                 : launch<false, true>(xp, (float*)y, (float*)xs, pp, ap, n,
                                       J, F, H, L, G, s);
}

const char* a2m_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
