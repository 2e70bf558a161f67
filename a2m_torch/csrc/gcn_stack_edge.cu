// Forward of the 5-layer GAT/GraphConv stack in edge form, CUDA C++ for
// sm_90a.
//
// a2m_gcn_stack_edge replaces the Pallas TPU kernel
// a2m/nn/pallas_gcn.py::_kernel_edge (helpers _gat_edge, _graph_conv_edge;
// called by _fused_impl_edge with the constants of edge_matrices): the
// gradient-free forward of the stack that gcn_stack.cu also computes, with
// the message routing of the fixed skeleton written as constant operators
// shared by a tile of graphs, and with its own rounding points.
//   Layout: a block owns a tile of T graphs in joint-major order, row
//     j * T + t for node j of graph t, so X @ W is one product over J * T
//     rows and every routing step is one operator applied to the tile.
//   GAT layers (1, 3, 5), per head h: XW_h = X @ W[:, h]; a_src, a_dst from
//     the f32 XW_h; per destination (j, t) the softmax statistics m (max)
//     and denom over its in-edges; per edge e alpha[e, t] =
//     exp(LeakyReLU_0.2(a_src[src e] + a_dst[dst e]) - m[dst e]) /
//     denom[dst e]; the value path gathers XW_h by source, weights it by
//     alpha, rounds the product, and sums it by destination; heads are
//     added, then / H + bias.
//   GraphConv layers (2, 4): neigh = A @ X once for the tile, then
//     neigh @ W_rel + X @ W_root + b.
//   Every layer: LayerNorm (eps 1e-6), LeakyReLU 0.2, + residual.
// The Pallas kernel routes with 0/1 incidence matrices S, D (E, J) and D^T
// on the matrix unit; a product with a matrix that has one 1 per row is a
// gather, and a product with D^T a sum over a destination's edges, which
// is how the CUDA cores run them here: the wrapper reads the src/dst lists
// off S and D (edges sorted by destination) and the kernel indexes with
// them.
//
// Bound on the H100: at the serving shapes (N = 13,824 graphs, J = 42 or
// 10, F = 64, H = 4) both stacks need ~102 GFLOP against 369 MB of x in
// and y out: by bytes ~0.11 ms at 3.35 TB/s, the same at the bf16
// tensor-core rate.  This kernel runs fp32 FMAs on the CUDA cores and is
// bound by their rate and by shared-memory traffic, like gcn_stack.cu.
// What the design does about it:
// * the tile is this kernel's own choice (the Pallas EDGE_TILE = 64 is
//   sized for VMEM): as many graphs as keep four (J * T, F) f32 buffers
//   (x, its rounded copy, one head's XW_h, the layer's output), the (J, T)
//   statistics and the (E, T) alpha under half an SM's shared memory, and
//   at most 96 rows: T = 2 at J = 42 (90 KB), T = 9 at J = 10;
// * the (N, J, F) <-> (J, T, F) relayout is folded into the tile's loads
//   and stores (float4, coalesced along F), so x makes one trip from
//   device memory and y one back, with no transposed copy in between;
// * X @ W_h, @ W_rel and @ W_root use the register-tiled product of
//   gcn_common.cuh, with the row block sized so that one pass covers the
//   tile's rows;
// * operands are rounded once, where they are written.
// The sum over a destination's edges runs in edge order, heads in head
// order: the same inputs give bit-equal outputs.  Tensor cores (the
// incidence products as real GEMMs beside wgmma over the J * T rows) are
// later work.
//
// Precision: kPrecise=false rounds where a2m's mm_dtype=bf16 does in
// _kernel_edge, which is not where _kernel does: x and W for X @ W; XW_h
// for the gather; the product XW_h[src] * alpha (f32) on its way into the
// sum, alpha itself is never rounded; x for A @ X, the neighbour sums, and
// W_rel, W_root.  Statistics, exp, the division and LayerNorm are f32
// (IEEE expf, division and rsqrtf: no fast-math flag).  kPrecise=true is
// plain f32.
//
// Layout: x and y are (N, J, F) f32 contiguous, 16-byte aligned; params as
// gcn_stack.cu; route is one int32 buffer [src (E), dst (E), ptr (J + 1),
// conv_src (Ec), conv_ptr (J + 1)]: the E edges of A + I sorted by
// destination with ptr their per-destination ranges, and the Ec nonzero
// entries of A likewise; conv_w (Ec) f32 their values.

#include "gcn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 96;               // J * T rows a tile aims for
constexpr size_t kHalfSmShared = 115712;   // (228 KB - 2 x 1 KB) / 2
constexpr size_t kBlockShared = 232448;    // 227 KB

template <bool kPrecise, int kRowBlock>
__global__ void __launch_bounds__(kThreads, 2)
gcn_stack_edge_kernel(const float* __restrict__ x, float* __restrict__ y,
                      const float* __restrict__ params,
                      const int* __restrict__ route,
                      const float* __restrict__ conv_w, int n, int J, int F,
                      int H, int L, int T, int E, int Ec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int HF = H * F;
  const int F4 = F / 4;
  const int R = J * T;                     // rows of the tile, j * T + t
  const int g0 = blockIdx.x * T;
  float* x_s = smem;                       // (R, F) layer input, f32
  float* xo_s = x_s + R * F;               // (R, F) x as a matmul operand
  float* xwh_s = xo_s + R * F;             // (R, F) XW_h, or A @ X
  float* out_s = xwh_s + R * F;            // (R, F) layer output
  float* asrc_s = out_s + R * F;           // (J, T) a_src
  float* adst_s = asrc_s + R;              // (J, T) a_dst
  float* m_s = adst_s + R;                 // (J, T) softmax max
  float* den_s = m_s + R;                  // (J, T) softmax denominator
  float* alpha_s = den_s + R;              // (E, T) attention per edge
  float* cw_s = alpha_s + E * T;           // (Ec) values of A
  int* src_s = reinterpret_cast<int*>(cw_s + Ec);   // (E)
  const int* dst_s = src_s + E;            // (E)
  const int* ptr_s = dst_s + E;            // (J + 1)
  const int* csrc_s = ptr_s + J + 1;       // (Ec)
  const int* cptr_s = csrc_s + Ec;         // (J + 1)

  // tile load with the relayout: graph-major in device memory, joint-major
  // rows here; graphs past n read as zeros and are never stored
  const int per_graph = J * F4;
  for (int i = tid; i < T * per_graph; i += blockDim.x) {
    const int t = i / per_graph, rem = i % per_graph;
    const int j = rem / F4, q = rem % F4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g0 + t < n)
      v = __ldg(reinterpret_cast<const float4*>(
                    x + ((size_t)(g0 + t) * J + j) * F) + q);
    reinterpret_cast<float4*>(x_s + (j * T + t) * F)[q] = v;
  }
  for (int i = tid; i < 2 * E + Ec + 2 * (J + 1); i += blockDim.x)
    src_s[i] = route[i];
  for (int i = tid; i < Ec; i += blockDim.x)
    cw_s[i] = op<kPrecise>(conv_w[i]);
  __syncthreads();

  const float* p = params;
  for (int layer = 0; layer < L; ++layer) {
    const bool gat = layer % 2 == 0;
    for (int i = tid; i < R * F4; i += blockDim.x) {
      reinterpret_cast<float4*>(xo_s)[i] =
          op4<kPrecise>(reinterpret_cast<const float4*>(x_s)[i]);
      if (gat)
        reinterpret_cast<float4*>(out_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    const float* bias;
    const float* ln_scale;
    const float* ln_bias;
    if (gat) {
      // ---- GAT ----------------------------------------------------------
      const float* W = p;
      const float* att_src = W + F * HF;
      const float* att_dst = att_src + HF;
      bias = att_dst + HF;
      ln_scale = bias + F;
      ln_bias = ln_scale + F;
      p = ln_bias + F;

      for (int h = 0; h < H; ++h) {
        // XW_h: one product over the J * T rows, columns h of W
        mm_strided<kPrecise, kRowBlock>(xo_s, F, W + h * F, HF, F, F, R,
                                        xwh_s, F, false);
        __syncthreads();
        // a_src, a_dst from the f32 XW_h: a warp per row
        const int warp = tid / 32, lane = tid % 32;
        for (int r = warp; r < R; r += blockDim.x / 32) {
          float s = 0.f, d = 0.f;
          for (int f = lane; f < F; f += 32) {
            const float v = xwh_s[r * F + f];
            s = fmaf(v, __ldg(att_src + h * F + f), s);
            d = fmaf(v, __ldg(att_dst + h * F + f), d);
          }
          s = warp_sum(s);
          d = warp_sum(d);
          if (lane == 0) {
            asrc_s[r] = s;
            adst_s[r] = d;
          }
        }
        __syncthreads();
        // softmax statistics per destination (j, t) over its in-edges;
        // meanwhile XW_h becomes an operand in place
        for (int item = tid; item < R; item += blockDim.x) {
          const int j = item / T, t = item % T;
          const float ad = adst_s[item];
          float mx = -INFINITY;
          for (int e = ptr_s[j]; e < ptr_s[j + 1]; ++e)
            mx = fmaxf(mx, leaky(ad + asrc_s[src_s[e] * T + t]));
          float sum = 0.f;
          for (int e = ptr_s[j]; e < ptr_s[j + 1]; ++e)
            sum += expf(leaky(ad + asrc_s[src_s[e] * T + t]) - mx);
          m_s[item] = mx;
          den_s[item] = sum;
        }
        if (!kPrecise) {
          for (int i = tid; i < R * F4; i += blockDim.x) {
            float4* v = reinterpret_cast<float4*>(xwh_s) + i;
            *v = op4<kPrecise>(*v);
          }
        }
        __syncthreads();
        // alpha per edge, from the statistics of its destination
        for (int item = tid; item < E * T; item += blockDim.x) {
          const int e = item / T, t = item % T;
          const int d = dst_s[e] * T + t;
          const float logit = leaky(asrc_s[src_s[e] * T + t] + adst_s[d]);
          alpha_s[item] = expf(logit - m_s[d]) / den_s[d];
        }
        __syncthreads();
        // value path: gather by source, weight, round, sum by destination
        // in edge order; a thread owns one row x 4 features
        for (int item = tid; item < R * F4; item += blockDim.x) {
          const int r = item / F4, q = item % F4;
          const int j = r / T, t = r % T;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int e = ptr_s[j]; e < ptr_s[j + 1]; ++e) {
            const float a = alpha_s[e * T + t];
            const float4 z = reinterpret_cast<const float4*>(
                xwh_s + (src_s[e] * T + t) * F)[q];
            acc[0] += op<kPrecise>(z.x * a);
            acc[1] += op<kPrecise>(z.y * a);
            acc[2] += op<kPrecise>(z.z * a);
            acc[3] += op<kPrecise>(z.w * a);
          }
          float4* o = reinterpret_cast<float4*>(out_s + r * F) + q;
          float4 v = *o;
          v.x += acc[0]; v.y += acc[1]; v.z += acc[2]; v.w += acc[3];
          if (h == H - 1) {
            v.x /= (float)H; v.y /= (float)H;
            v.z /= (float)H; v.w /= (float)H;
          }
          *o = v;
        }
        __syncthreads();
      }
    } else {
      // ---- GraphConv ------------------------------------------------------
      const float* W_rel = p;
      const float* W_root = W_rel + F * F;
      bias = W_root + F * F;
      ln_scale = bias + F;
      ln_bias = ln_scale + F;
      p = ln_bias + F;

      // neigh = A @ X for the whole tile, over the entries of A
      for (int item = tid; item < R * F4; item += blockDim.x) {
        const int r = item / F4, q = item % F4;
        const int j = r / T, t = r % T;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int e = cptr_s[j]; e < cptr_s[j + 1]; ++e)
          fma4(acc, cw_s[e], reinterpret_cast<const float4*>(
                                 xo_s + (csrc_s[e] * T + t) * F)[q]);
        reinterpret_cast<float4*>(xwh_s + r * F)[q] =
            op4<kPrecise>(make_float4(acc[0], acc[1], acc[2], acc[3]));
      }
      __syncthreads();
      mm<kPrecise, kRowBlock>(xwh_s, F, W_rel, F, F, R, out_s, F, false);
      mm<kPrecise, kRowBlock>(xo_s, F, W_root, F, F, R, out_s, F, true);
      __syncthreads();
    }

    bias_norm_leaky_residual(out_s, x_s, R, F, bias, ln_scale, ln_bias);
    __syncthreads();
  }

  for (int i = tid; i < T * per_graph; i += blockDim.x) {
    const int t = i / per_graph, rem = i % per_graph;
    const int j = rem / F4, q = rem % F4;
    if (g0 + t < n)
      reinterpret_cast<float4*>(y + ((size_t)(g0 + t) * J + j) * F)[q] =
          reinterpret_cast<const float4*>(x_s + (j * T + t) * F)[q];
  }
}

size_t smem_bytes(int J, int F, int T, int E, int Ec) {
  const size_t R = (size_t)J * T;
  return sizeof(float) * (4 * R * F + 4 * R + (size_t)E * T + Ec)
         + sizeof(int) * (2 * (size_t)E + Ec + 2 * ((size_t)J + 1));
}

// Graphs per block: the most that keep the tile under half an SM's shared
// memory and within kMaxRows rows; one graph in a whole block's shared
// memory when even that does not fit half; 0 when one graph does not fit.
int pick_tile(int J, int F, int E, int Ec) {
  int T = 0;
  while ((T + 1) * J <= kMaxRows
         && smem_bytes(J, F, T + 1, E, Ec) <= kHalfSmShared)
    ++T;
  if (T == 0 && smem_bytes(J, F, 1, E, Ec) <= kBlockShared) T = 1;
  return T;
}

template <bool kPrecise, int kRowBlock>
int launch(const float* x, float* y, const float* params, const int* route,
           const float* conv_w, int n, int J, int F, int H, int L, int T,
           int E, int Ec, cudaStream_t stream) {
  const size_t bytes = smem_bytes(J, F, T, E, Ec);
  cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_edge_kernel<kPrecise, kRowBlock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + T - 1) / T;
  gcn_stack_edge_kernel<kPrecise, kRowBlock>
      <<<blocks, kThreads, bytes, stream>>>(x, y, params, route, conv_w, n,
                                            J, F, H, L, T, E, Ec);
  return (int)cudaGetLastError();
}

// The matmul's row block: F / 4 column groups x ceil(rows / block) row
// blocks should fill the 256 threads in one pass.
template <bool kPrecise>
int launch_rows(const float* x, float* y, const float* params,
                const int* route, const float* conv_w, int n, int J, int F,
                int H, int L, int T, int E, int Ec, cudaStream_t stream) {
  const int rows = J * T;
  if (rows <= 80)
    return launch<kPrecise, 5>(x, y, params, route, conv_w, n, J, F, H, L, T,
                               E, Ec, stream);
  if (rows <= 96)
    return launch<kPrecise, 6>(x, y, params, route, conv_w, n, J, F, H, L, T,
                               E, Ec, stream);
  return launch<kPrecise, 8>(x, y, params, route, conv_w, n, J, F, H, L, T, E,
                             Ec, stream);
}

}  // namespace

extern "C" {

// Graphs per block for this skeleton (0: one graph does not fit).
int a2m_gcn_stack_edge_tile(int J, int F, int E, int Ec) {
  return pick_tile(J, F, E, Ec);
}

int a2m_gcn_stack_edge(const void* x, void* y, const void* params,
                       const void* route, const void* conv_w, int n, int J,
                       int F, int H, int L, int E, int Ec, int precise,
                       void* stream) {
  if (n <= 0) return 0;
  // float4 tiles; one LayerNorm row per warp holds F <= 64
  if (F % 4 != 0 || F > 64) return (int)cudaErrorInvalidValue;
  const int T = pick_tile(J, F, E, Ec);
  if (T == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* pp = (const float*)params;
  const int* rp = (const int*)route;
  const float* cp = (const float*)conv_w;
  return precise ? launch_rows<true>(xp, (float*)y, pp, rp, cp, n, J, F, H,
                                     L, T, E, Ec, s)
                 : launch_rows<false>(xp, (float*)y, pp, rp, cp, n, J, F, H,
                                      L, T, E, Ec, s);
}

const char* a2m_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
