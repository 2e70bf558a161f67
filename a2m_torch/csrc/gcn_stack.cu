// Fused forward of the 5-layer GAT/GraphConv stack, CUDA C++ for sm_90a:
// one launch runs every layer of the stack for its graphs.  Two functions,
// each in two designs, one for each mode:
// * a2m_gcn_stack_tc (bf16 operands, mm_dtype=bf16: the one-window path,
//   d_step and eval_step) and a2m_gcn_stack (f32 operands, the parity route)
//   replace the Pallas TPU kernel a2m/nn/pallas_gcn.py::_kernel (called by
//   _fused_impl / fused_gcn_stack, rolled variant _gat_rolled);
// * a2m_gcn_stack_fwd_tc and a2m_gcn_stack_fwd replace _fwd_kernel (called
//   by _fwd_with_residuals): the same forward under autograd (g_step), which
//   also stores the f32 input of layers 2..L in xs for the backward kernel
//   (gcn_stack_bwd.cu).  Each is its forward's kernel with kStash, so the
//   two give bit-equal y.
// The bf16 mode runs on the tensor cores (wgmma); the f32 mode on the CUDA
// cores, held to the plain version at 2e-5, which TF32 cannot meet.
//   GAT layers (1, 3, 5):  XW = X @ W; per head a_src = XW_h . att_src[h],
//     a_dst = XW_h . att_dst[h]; e[i, j] = LeakyReLU_0.2(a_dst[i] + a_src[j])
//     masked to adjacency + self-loops; softmax over j; out = mean_h(alpha_h
//     @ XW_h) + bias.
//   GraphConv layers (2, 4): out = (A @ X) @ W_rel + X @ W_root + b.
//   Every layer: LayerNorm (eps 1e-6), LeakyReLU 0.2, + residual.
//
// Bound on the H100: at the main-path shapes (N = 8192 graphs, J = 42 or 10,
// F = 64, H = 4) both stacks need ~60 GFLOP (attention and A @ X over the
// skeleton's edges) against 219 MB of x in and y out (655 MB with the
// stash): bound by the bytes, ~0.065 ms (0.196 with the stash) at
// 3.35 TB/s; at the bf16 tensor-core rate the operations take ~0.061 ms.
//
// The tensor-core design (bf16 mode), and what it does about the bound:
// * a tile is T whole graphs in graph-major rows (row t * J + j: graph t's
//   rows lie together, so x and y move as one contiguous block), zero-padded
//   to 128 rows, two 64-row M tiles, one warpgroup each: T = 3 at J = 42
//   (126 rows), T = 12 at J = 10 (120).  Features are zero-padded to 64.
//   Pad rows belong to no graph, feed no real row and are never stored; the
//   wrapper's plan (nn/gcn_kernel.py::dense_tc_plan) fixes T and the
//   shared-memory layout, and this file refuses a plan it does not
//   reproduce;
// * every product is wgmma.m64n64k16 (bf16 operands, f32 accumulators):
//   X @ W_h and X @ W_root with both operands in shared memory, K-major with
//   the 128-byte swizzle, the weights rounded and packed once by the
//   wrapper (edge_tc_weights, the layout K5 reads).  One persistent block
//   of 256 threads an SM walks tiles; it holds the GAT layers' weights
//   (96 KB at F = 64, H = 4), their W_h att and every layer's bias and
//   LayerNorm vectors in shared memory for the whole launch, and streams a
//   GraphConv layer's W_rel and W_root from L2 (cp.async, one copy a
//   warpgroup) into the room of the XW_h tiles while the neighbour sums
//   run.  The small parameters must not live in L1: with 213 KB of shared
//   memory L1 keeps ~28 KB, which the streamed x and the register spills
//   overrun, and every miss then stalls a phase for an L2 round trip (they
//   took a third of the kernel's time when they did); x is loaded and y
//   stored with evict-first hints;
// * the attention apply sum_h alpha_h @ XW_h and A @ X are block-diagonal
//   products over the tile: the A operand (alpha of every head, or A) is
//   built in registers for each k step from the skeleton's tables (zeros
//   off a row's graph and edges: a2m's -inf mask gives exact zeros), the B
//   operand is the bf16 XW_h tile or x's operand tile read MN-major (rows
//   of 64 features, one per source row), one f32 accumulator takes every
//   head, and a warpgroup runs only the k steps of the graphs its rows
//   touch (6 of 8 at J = 42, 5 at J = 10);
// * neigh = A @ X never leaves the registers: rounded to bf16 it is the A
//   operand of neigh @ W_rel; LayerNorm, LeakyReLU and the residual run in
//   the accumulators' layout, and x itself lives in registers (f32, the
//   accumulators' layout) across all layers of a tile: it is loaded from
//   device memory once, stored once (and for the stash, once per layer);
// * the attention statistics of a row are taken by the quad of lanes that
//   holds the row (a lane per head, its logits in registers), so that
//   nothing but XW_h, a_src and a_dst crosses warps: two block barriers per
//   GAT layer, one per GraphConv layer; the next k step's operand entries
//   are loaded while the tensor cores run the current one.
// What holds it back (utils/edge_probe.py --dense, PERF.md): one block of 8
// warps an SM at 255 registers a thread (a few spills), so every phase is a
// latency chain; the XW_h products with their epilogue take the most
// cycles, then LayerNorm, the apply and the attention.  The tensor cores
// are busy ~10% of the time; the near-tie recomputation costs ~10%.
//
// Matching the plain version's roundings (nn/gcn_kernel.py::_pre_norm, after
// a2m's _kernel).  _kernel rounds x and W for X @ W; XW_h and alpha (f32
// softmax) for the apply; x for A @ X and the neighbour sums for @ W_rel;
// a_src, a_dst, the softmax and LayerNorm are f32.  wgmma sums in its own
// order and truncates, where the plain version's f32 products (cuBLAS at
// these shapes) are sequential k-order chains, so a bf16 rounding near a
// tie can fall the other way.  So: an XW_h element within kTieUlps of a
// bf16 midpoint is recomputed in k order (k_order_dot), and likewise a new
// x whose rounding into the next layer's operand is that close, from the
// layer's pre-norm output in the plain version's order (the apply: sources
// ascending, heads within a source, as the einsum over (j, h) sums); a_src
// and a_dst are x . (W_h att) in float64 (the logit of the unrounded XW_h,
// rounded once); the softmax is the plain version's sequence (max, the sum
// of exps in source order, exp / sum); LayerNorm's sums are float64 and its
// steps are rounded one by one as the plain version's separate operations
// round them.
//
// The CUDA-core design (f32 mode): like the Pallas kernel keeps x in VMEM, a
// block keeps its tile of x in shared memory in f32 across all five layers
// (one graph at J = 42, several at small J: about 64 rows); the dense
// products give each thread an 8-row x 4-column register tile fed by float4
// loads; the softmax, alpha @ XW and A @ X loop over per-node edge lists.
//
// Layout: x and y are (N, J, F) f32 contiguous (16-byte aligned for the
// tensor-core entries); params is one f32 buffer, per layer in kernel order
// (see nn/gcn_kernel.py::pack_params):
//   GAT:       W (F, H*F), att_src (H, F), att_dst (H, F), bias (F),
//              ln_scale (F), ln_bias (F)
//   GraphConv: W_rel (F, F), W_root (F, F), bias (F), ln_scale (F),
//              ln_bias (F)
// adj is (J, J) f32, A[dst, src], without self-loops.  The tensor-core
// entries read the skeleton from route (int32 [src (E), dst (E), ptr
// (J + 1), conv_src (Ec), conv_ptr (J + 1)]: the E edges of A + I sorted by
// destination, then source, and the Ec entries of A) and conv_w (Ec) f32;
// wpack holds, layer by layer, one 64 x 64 bf16 block per GAT head
// (W[:, h]^T) and two per GraphConv layer (W_rel^T, W_root^T), zero-padded,
// row n's 16-byte chunk c at chunk c ^ (n % 8); watt (GAT layers, H, 2, 64)
// float64 holds W_h att_src and W_h att_dst of the rounded W_h.

#include "gcn_dense_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 mode: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

// kStash selects the forward with stash (a2m's _fwd_kernel): the same
// forward, and the f32 input of every layer after the first also goes to
// xs (L - 1, N, J, F) for the backward kernel.  Without it xs is unused and
// the instantiation is the gradient-free forward as it was.
template <bool kStash>
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
    // x as a matmul operand, a copy beside the residual: GAT keeps it in
    // out_s until the attention apply overwrites it, GraphConv in the first
    // F columns of xw_s (the neighbour sums take the next F)
    float* xo = gat ? out_s : xw_s;
    if (kStash && layer > 0) {
      float* stash = xs + ((size_t)(layer - 1) * n + g0) * J * F;
      for (int i = threadIdx.x; i < R * F; i += blockDim.x) {
        const float v = x_s[i];
        stash[i] = v;
        xo[i] = v;
      }
    } else {
      for (int i = threadIdx.x; i < R * F; i += blockDim.x)
        xo[i] = x_s[i];
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

      mm<true>(xo, F, W, F, HF, R, xw_s, HF, false);
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
      // stored in that order, already an operand of alpha @ XW.
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
        for (int k = 0; k < c; ++k) row[k] = row[k] / sum;
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
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
      __syncthreads();
      mm<true>(nb_s, F, W_rel, F, F, R, out_s, F, false);
      mm<true>(xo, F, W_root, F, F, R, out_s, F, true);
    }
    __syncthreads();

    // ---- bias, LayerNorm, LeakyReLU, residual: one warp per row ---------
    bias_norm_leaky_residual(out_s, x_s, R, F, bias, ln_scale, ln_bias);
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

template <bool kStash>
int launch(const float* x, float* y, float* xs, const float* params,
           const float* adj, int n, int J, int F, int H, int L, int G,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(J, F, H, G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_kernel<kStash>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + G - 1) / G;
  gcn_stack_kernel<kStash><<<blocks, kThreads, bytes, stream>>>(
      x, y, xs, params, adj, n, J, F, H, L, G);
  return (int)cudaGetLastError();
}

// Graphs per block: one at J = 42, several at small J, so a block's tile
// holds about 64 node rows.
int graphs_per_block(int J) { return J >= 64 ? 1 : 64 / J; }

// ---------------------------------------------------------------------------
// bf16 mode: tensor cores
// ---------------------------------------------------------------------------

// The shared-memory layout of a plan, in bytes from a 1024-aligned base;
// nn/gcn_kernel.py::dense_tc_plan computes the same.
struct DenseLayout {
  int T, R, S;   // graphs a tile, their rows, attention slots a row (<= 8)
  int wbytes, off_xo, off_xw, off_watt, off_vec, off_asrc, off_adst,
      off_alpha, off_aval, off_lut, off_nbr, off_deg, bytes;
};

DenseLayout dense_layout(int J, int H, int L, int S) {
  DenseLayout s;
  s.T = kTcRows / J;
  s.R = s.T * J;
  s.S = S;
  const int gat = (L + 1) / 2;                 // GAT layers
  s.wbytes = gat * H * kBlock;                 // the GAT layers' weights
  s.off_xo = s.wbytes;                         // x, bf16 operand tile
  // XW_h, H operand tiles; in a GraphConv layer the rounded neighbour sums
  // and each warpgroup's copy of W_rel and W_root (3 tiles' room)
  s.off_xw = s.off_xo + kTile;
  s.off_watt = s.off_xw + (H > 3 ? H : 3) * kTile;   // (gat, H, 2, 64) f64
  s.off_vec = s.off_watt + gat * H * 2 * kFp * 8;    // (L, 3, 64) f32
  s.off_asrc = s.off_vec + L * 3 * kFp * 4;    // (128, 4) f32
  s.off_adst = s.off_asrc + kTcRows * kMaxHeads * 4;   // (128, 4) f32
  s.off_alpha = s.off_adst + kTcRows * kMaxHeads * 4;  // (128, S, 4) bf16
  s.off_aval = s.off_alpha + kTcRows * S * kMaxHeads * 2;   // (J, J) bf16
  s.off_lut = s.off_aval + round16(J * J * 2); // (J, J) u8
  s.off_nbr = s.off_lut + round16(J * J);      // (J, 8) u8
  s.off_deg = s.off_nbr + J * kMaxSlots;       // (J) u8
  s.bytes = s.off_deg + round16(J) + 1024;
  return s;
}

// Element (row, col) of sum_h alpha_h @ XW_h as a sequential f32 sum over
// the row's sources in ascending order and, within a source, its heads:
// the order of the plain version's product (einsum over (j, h)); masked
// entries add exact zeros there.  For near-tie recomputation.
__device__ __noinline__ float gat_out_dot(const uint16_t* al,
                                          const uint8_t* xw_s,
                                          const uint8_t* nb, int deg,
                                          int rbase, int col, int H) {
  float s = 0.f;
  for (int q = 0; q < deg; ++q) {
    const int k = rbase + nb[q];
    for (int h = 0; h < H; ++h) {
      const float a = __uint_as_float((uint32_t)al[kMaxHeads * q + h] << 16);
      const float v = __uint_as_float(
          (uint32_t)*reinterpret_cast<const uint16_t*>(
              xw_s + h * kTile + swz(k, col))
          << 16);
      s = fmaf(a, v, s);
    }
  }
  return s;
}

// The end of a layer in the accumulators' layout (a quad of lanes holds a
// row): v is the pre-norm output, bias included; x = LeakyReLU(LayerNorm(v)
// * ln_scale + ln_bias) + x, each step rounded as the plain version's
// separate operations round it (no contraction into FMAs), LayerNorm's
// sums in float64; ln_scale and ln_bias in shared memory, zero past F.  An
// element whose new x lies near a bf16 tie (it is the
// next layer's operand) is taken again from redo(half, col), the pre-norm
// value recomputed in the plain version's order.
template <typename Redo>
__device__ __forceinline__ void norm_residual(
    const float (&v)[32], float (&xr)[32], const float* ln_scale,
    const float* ln_bias, int F, int tig, int row0, int R, Redo redo) {
  const double inv_f = 1.0 / F;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s += (double)v[4 * i + 2 * half] + v[4 * i + 2 * half + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mean = (float)(s * inv_f);
    float dv[16];
    double sq = 0.0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = 4 * (i / 2) + 2 * half + i % 2;
      dv[i] = acc_col(k, tig) < F ? __fsub_rn(v[k], mean) : 0.f;
      sq = fma((double)dv[i], (double)dv[i], sq);
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float rs = rsqrtf((float)(sq * inv_f) + kLnEps);
    const int row = row0 + 8 * half;
    uint32_t ties = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = 4 * (i / 2) + 2 * half + i % 2, col = acc_col(k, tig);
      float o = 0.f;
      if (col < F) {
        o = __fadd_rn(leaky(__fadd_rn(__fmul_rn(__fmul_rn(dv[i], rs),
                                                ln_scale[col]),
                                      ln_bias[col])),
                      xr[k]);
        if (row < R) ties |= (uint32_t)near_tie(o) << i;
      }
      dv[i] = o;
    }
    for (uint32_t t = ties; t; t &= t - 1) {
      // element i of 16, selected by compile-time indices: an array read or
      // written at a run-time index would live in local memory
      const int i = __ffs(t) - 1;
      const int col = acc_col(4 * (i / 2) + 2 * half + i % 2, tig);
      float res = 0.f;
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (q == i) res = xr[4 * (q / 2) + 2 * half + q % 2];
      const float e = __fsub_rn(redo(half, col), mean);
      const float o = __fadd_rn(leaky(__fadd_rn(__fmul_rn(__fmul_rn(e, rs),
                                                          ln_scale[col]),
                                                ln_bias[col])),
                                res);
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (q == i) dv[q] = o;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) xr[4 * (i / 2) + 2 * half + i % 2] = dv[i];
  }
}

// x (f32, the accumulators' layout) into the operand tile, bf16, rows < R.
__device__ __forceinline__ void store_operand(uint8_t* xo_s,
                                              const float (&xr)[32],
                                              int row0, int tig, int R) {
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    const int r = row0 + (k & 2) * 4;
    if (r < R)
      *reinterpret_cast<uint32_t*>(xo_s + swz(r, acc_col(k, tig))) =
          pack_bf16(xr[k], xr[k + 1]);
  }
}

template <bool kStash>
__global__ void __launch_bounds__(kTcThreads, 1)
gcn_stack_tc_kernel(const float* __restrict__ x, float* __restrict__ y,
                    float* __restrict__ xs, const float* __restrict__ params,
                    const uint4* __restrict__ wpack,
                    const double* __restrict__ watt,
                    const int* __restrict__ route,
                    const float* __restrict__ conv_w, int n, int J, int F,
                    int H, int L, int E, int Ec, DenseLayout lay) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw
      + ((1024 - (__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int mt = warp / 4;                  // a warpgroup's M tile
  const int wrow = (warp % 4) * 16 + lane / 4;   // accumulator row in it
  const int tig = lane % 4;                 // accumulator column pair
  const int row0 = mt * 64 + wrow;          // this thread's rows: row0, +8
  const int T = lay.T, R = lay.R, S = lay.S;
  const float inv_h = 1.f / (float)H;       // exact where H is 2^k

  const uint8_t* w_s = base;
  uint8_t* xo_s = base + lay.off_xo;
  uint8_t* xw_s = base + lay.off_xw;        // XW_h tiles, or neigh
  double* watt_s = reinterpret_cast<double*>(base + lay.off_watt);
  float* vec_s = reinterpret_cast<float*>(base + lay.off_vec);
  float* asrc_s = reinterpret_cast<float*>(base + lay.off_asrc);
  float* adst_s = reinterpret_cast<float*>(base + lay.off_adst);
  uint16_t* alpha_s = reinterpret_cast<uint16_t*>(base + lay.off_alpha);
  uint16_t* aval_s = reinterpret_cast<uint16_t*>(base + lay.off_aval);
  uint8_t* lut_s = base + lay.off_lut;      // (J, J): slot of (dst, src)
  uint8_t* nbr_s = base + lay.off_nbr;      // (J, 8): source of a slot
  uint8_t* deg_s = base + lay.off_deg;      // (J): slots of a joint

  // once per block: the GAT layers' weights (wpack holds every layer's
  // blocks in order), their W_h att, every layer's bias, ln_scale and
  // ln_bias zero-padded to 64, zeros in the operand tile (pad rows stay
  // zero), and the skeleton's tables from route (edges of A + I sorted by
  // destination, then source) and the entries of A
  for (int g = 0; g < (L + 1) / 2; ++g)
    for (int i = tid; i < H * kBlock / 16; i += kTcThreads)
      reinterpret_cast<uint4*>(base)[g * H * kBlock / 16 + i] =
          __ldg(wpack + g * (H + 2) * kBlock / 16 + i);
  for (int i = tid; i < (L + 1) / 2 * H * kFp; i += kTcThreads)
    reinterpret_cast<double2*>(watt_s)[i] =
        __ldg(reinterpret_cast<const double2*>(watt) + i);
  {
    const float* p = params;
    for (int l = 0; l < L; ++l) {
      p += l % 2 == 0 ? F * H * F + 2 * H * F : 2 * F * F;   // to the bias
      for (int i = tid; i < 3 * kFp; i += kTcThreads)
        vec_s[l * 3 * kFp + i] =
            i % kFp < F ? __ldg(p + i / kFp * F + i % kFp) : 0.f;
      p += 3 * F;
    }
  }
  for (int i = tid; i < kTile / 16; i += kTcThreads)
    reinterpret_cast<uint4*>(xo_s)[i] = make_uint4(0u, 0u, 0u, 0u);
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
  fence_async_smem();
  __syncthreads();

  // this thread's rows: their graph's first row (far below 0 for a pad
  // row, so that no source falls in its graph), joint and graph
  int rbase[2], rj[2], rg[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    rg[half] = r < R ? r / J : T;
    rbase[half] = r < R ? rg[half] * J : -(1 << 20);
    rj[half] = r < R ? r - rbase[half] : 0;
  }
  // the k steps of this warpgroup: the rows of the graphs its rows touch
  const int last = min(mt * 64 + 63, R - 1);
  const int ks0 = (mt * 64 / J * J) / 16;
  const int ks1 = ((last / J + 1) * J + 15) / 16;

  const int tiles = (n + T - 1) / T;
#ifdef A2M_TC_PROFILE
  long long t_prev_ = clock64();
#endif
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * T;
    const size_t grow0 = (size_t)g0 * J;    // device row of tile row 0
    const bool live[2] = {rg[0] < T && g0 + rg[0] < n,
                          rg[1] < T && g0 + rg[1] < n};
    // x of this thread's accumulator elements, f32, all 16 loads in flight
    float xr[32];
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int half = (k >> 1) & 1, col = acc_col(k, tig);
      float2 v = make_float2(0.f, 0.f);
      if (live[half] && col < F)
        v = __ldcs(reinterpret_cast<const float2*>(
            x + (grow0 + row0 + 8 * half) * F + col));
      xr[k] = v.x;
      xr[k + 1] = v.y;
    }
    store_operand(xo_s, xr, row0, tig, R);
    fence_async_smem();
    warpgroup_sync(mt);
    PROF(0)

    for (int layer = 0; layer < L; ++layer) {
      const float* bias = vec_s + layer * 3 * kFp;
      const float* ln_scale = bias + kFp;
      const float* ln_bias = ln_scale + kFp;
      if (kStash && layer > 0) {
        float* stash = xs + (size_t)(layer - 1) * n * J * F;
#pragma unroll
        for (int k = 0; k < 32; k += 2) {
          const int half = (k >> 1) & 1, col = acc_col(k, tig);
          if (live[half] && col < F)
            __stcs(reinterpret_cast<float2*>(
                       stash + (grow0 + row0 + 8 * half) * F + col),
                   make_float2(xr[k], xr[k + 1]));
        }
      }
      float d[32];
      if (layer % 2 == 0) {
        // ---- GAT --------------------------------------------------------
        // (a) XW_h of this warpgroup's rows, every head; the logits while
        // the tensor cores run
#pragma unroll 1
        for (int h = 0; h < H; ++h) {
          const uint8_t* wh = w_s + (layer / 2 * H + h) * kBlock;
          product(d, xo_s + mt * 64 * 128, wh);
          head_logits(xo_s, watt_s + (layer / 2 * H + h) * 2 * kFp, asrc_s,
                      adst_s, h, row0, tig);
          wgmma_commit();
          wgmma_wait_all();
          fence_operands(d);
          store_head(d, xo_s, wh, xw_s + h * kTile, mt, wrow, tig);
        }
        PROF(1)
        fence_async_smem();
        __syncthreads();
        PROF(2)
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
        PROF(3)
        // (c) sum_h alpha_h @ XW_h, one accumulator: per k step the
        // block-diagonal alpha of every head, built in registers (zeros
        // off the graph and its edges), against the heads' XW_h tiles
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        uint2 v[2][4];                      // the next step's elements
        alpha_elements(v, alpha_s, lut_s, rbase, rj, row0, ks0, tig, J, S);
#pragma unroll 1
        for (int s = ks0; s < ks1; ++s) {
          uint32_t a[kMaxHeads][4];
#pragma unroll
          for (int h = 0; h < kMaxHeads; ++h) {
            const unsigned sel = h & 1 ? 0x7632 : 0x5410;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              // a[h][u]: row half u & 1, columns 8 (u >> 1) + 2 tig, + 1
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
                              sw128_desc(xw_s + h * kTile + s * kStep));
          wgmma_commit();
          if (s + 1 < ks1)                  // while the tensor cores run
            alpha_elements(v, alpha_s, lut_s, rbase, rj, row0, s + 1, tig,
                           J, S);
          wgmma_wait_all();
          fence_operands(d);
#pragma unroll
          for (int h = 0; h < kMaxHeads; ++h) fence_fragment(a[h]);
        }
        PROF(4)
        // (d) / H + bias, LayerNorm, LeakyReLU, residual
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int col = acc_col(k, tig);
          d[k] = __fadd_rn(div_heads(d[k], H, inv_h), bias[col]);
        }
        norm_residual(d, xr, ln_scale, ln_bias, F, tig, row0, R,
                      [&](int half, int col) {
                        const int r = row0 + 8 * half;
                        return __fadd_rn(
                            div_heads(gat_out_dot(
                                          alpha_s + r * S * kMaxHeads, xw_s,
                                          nbr_s + rj[half] * kMaxSlots,
                                          deg_s[rj[half]], rbase[half], col,
                                          H),
                                      H, inv_h),
                            bias[col]);
                      });
        PROF(5)
        store_operand(xo_s, xr, row0, tig, R);
        fence_async_smem();
        __syncthreads();
        PROF(6)
      } else {
        // ---- GraphConv --------------------------------------------------
        // the layer's W_rel and W_root: one copy a warpgroup, streamed from
        // L2 into the free XW room while the neighbour sums run
        uint8_t* w_rel = xw_s + kTile + mt * 2 * kBlock;
        const uint8_t* w_root = w_rel + kBlock;
        {
          const uint4* src = wpack + (size_t)((layer + 1) / 2 * H
                                              + layer / 2 * 2) * kBlock / 16;
          for (int i = tid % 128; i < 2 * kBlock / 16; i += 128)
            cp_async16(w_rel + 16 * i, src + i);
        }
        // (a) neigh = A @ X: per k step the block-diagonal A (bf16, exact
        // for a 0/1 skeleton) in registers against x's operand tile
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        uint32_t e[2][4];                   // the next step's entries
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
        PROF(7)
        // (b) neigh rounded to bf16: the A operand of neigh @ W_rel straight
        // from the accumulators (k step ks: features 16 ks..16 ks + 15), and
        // a copy of this thread's rows for the near-tie recomputation
        uint32_t na[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            na[ks][u] = pack_bf16(d[8 * ks + 2 * u], d[8 * ks + 2 * u + 1]);
#pragma unroll
        for (int k = 0; k < 32; k += 2)
          *reinterpret_cast<uint32_t*>(
              xw_s + swz(mt * 64 + acc_row(k, wrow), acc_col(k, tig))) =
              na[k / 8][(k % 8) / 2];
        // (c) neigh @ W_rel and X @ W_root: two f32 results, added
        cp_async_wait_all();
        fence_async_smem();
        warpgroup_sync(mt);
        float dt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        fence_operands(d);
        wgmma_fence();
        const uint64_t drel = sw128_desc(w_rel);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs_k16<0>(d, na[ks], drel + 2 * ks);
        product(dt, xo_s + mt * 64 * 128, w_root);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(d);
        fence_operands(dt);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) fence_fragment(na[ks]);
        __syncwarp();
        PROF(8)
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int col = acc_col(k, tig);
          d[k] = __fadd_rn(__fadd_rn(d[k], dt[k]), bias[col]);
        }
        norm_residual(d, xr, ln_scale, ln_bias, F, tig, row0, R,
                      [&](int half, int col) {
                        const int r = row0 + 8 * half;
                        return __fadd_rn(
                            __fadd_rn(k_order_dot(xw_s, r, w_rel, col),
                                      k_order_dot(xo_s, r, w_root, col)),
                            bias[col]);
                      });
        PROF(9)
        // x's operand tile is read across M tiles above: replaced after
        // both warpgroups are done with it
        __syncthreads();
        store_operand(xo_s, xr, row0, tig, R);
        fence_async_smem();
        warpgroup_sync(mt);
        PROF(10)
      }
    }

#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int half = (k >> 1) & 1, col = acc_col(k, tig);
      if (live[half] && col < F)
        __stcs(reinterpret_cast<float2*>(y + (grow0 + row0 + 8 * half) * F
                                         + col),
               make_float2(xr[k], xr[k + 1]));
    }
    PROF(11)
  }
}

template <bool kStash>
int launch_tc(const void* x, void* y, void* xs, const void* params,
              const void* wpack, const void* watt, const void* route,
              const void* conv_w, int n, int J, int F, int H, int L, int E,
              int Ec, int T, int S, int smem_bytes, int grid,
              void* stream) {
  if (n <= 0) return 0;
  if (F % 4 != 0 || F < 4 || F > kFp || H < 1 || H > kMaxHeads || J < 1
      || J > kTcRows || L < 1 || S < 1 || S > J || S > kMaxSlots
      || grid < 1 || T != kTcRows / J)
    return (int)cudaErrorInvalidValue;
  const DenseLayout lay = dense_layout(J, H, L, S);
  if (lay.bytes != smem_bytes || (size_t)lay.bytes > kBlockShared)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_tc_kernel<kStash>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  gcn_stack_tc_kernel<kStash><<<grid, kTcThreads, lay.bytes,
                                (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, (float*)xs, (const float*)params,
      (const uint4*)wpack, (const double*)watt, (const int*)route,
      (const float*)conv_w, n, J, F, H, L, E, Ec, lay);
  return (int)cudaGetLastError();
}

template <bool kStash>
int tc_info(int smem_bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gcn_stack_tc_kernel<kStash>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gcn_stack_tc_kernel<kStash>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gcn_stack_tc_kernel<kStash>, kTcThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = kTcThreads;
  return 0;
}

}  // namespace

extern "C" {

// f32 mode (CUDA cores); bf16 operands run a2m_gcn_stack_tc.
int a2m_gcn_stack(const void* x, void* y, const void* params,
                  const void* adj, int n, int J, int F, int H, int L,
                  void* stream) {
  if (n <= 0) return 0;
  // float4 tiles; one LayerNorm row per warp holds F <= 64
  if (F % 4 != 0 || F > 64) return (int)cudaErrorInvalidValue;
  return launch<false>((const float*)x, (float*)y, nullptr,
                       (const float*)params, (const float*)adj, n, J, F, H,
                       L, graphs_per_block(J), (cudaStream_t)stream);
}

// The forward with stash in f32 mode: y as a2m_gcn_stack, and xs
// (L - 1, N, J, F).
int a2m_gcn_stack_fwd(const void* x, void* y, void* xs, const void* params,
                      const void* adj, int n, int J, int F, int H, int L,
                      void* stream) {
  if (n <= 0) return 0;
  if (F % 4 != 0 || F > 64) return (int)cudaErrorInvalidValue;
  return launch<true>((const float*)x, (float*)y, (float*)xs,
                      (const float*)params, (const float*)adj, n, J, F, H, L,
                      graphs_per_block(J), (cudaStream_t)stream);
}

// bf16 mode (tensor cores), on the wrapper's plan: T graphs a tile, S
// attention slots a row, smem_bytes of shared memory, grid persistent
// blocks; wpack and watt from nn/gcn_kernel.py::edge_tc_weights, route and
// conv_w from edge_routing.  A plan this file does not reproduce is refused.
int a2m_gcn_stack_tc(const void* x, void* y, const void* params,
                     const void* wpack, const void* watt, const void* route,
                     const void* conv_w, int n, int J, int F, int H, int L,
                     int E, int Ec, int T, int S, int smem_bytes, int grid,
                     void* stream) {
  return launch_tc<false>(x, y, nullptr, params, wpack, watt, route, conv_w,
                          n, J, F, H, L, E, Ec, T, S, smem_bytes, grid,
                          stream);
}

// The forward with stash in bf16 mode: y as a2m_gcn_stack_tc, and xs.
int a2m_gcn_stack_fwd_tc(const void* x, void* y, void* xs,
                         const void* params, const void* wpack,
                         const void* watt, const void* route,
                         const void* conv_w, int n, int J, int F, int H,
                         int L, int E, int Ec, int T, int S, int smem_bytes,
                         int grid, void* stream) {
  return launch_tc<true>(x, y, xs, params, wpack, watt, route, conv_w, n, J,
                         F, H, L, E, Ec, T, S, smem_bytes, grid, stream);
}

// The tensor-core kernel as built (the forward, or with stash): out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] blocks an
// SM at smem_bytes, out[3] threads a block.
int a2m_gcn_stack_tc_info(int stash, int smem_bytes, int* out) {
  return stash ? tc_info<true>(smem_bytes, out)
               : tc_info<false>(smem_bytes, out);
}

#ifdef A2M_TC_PROFILE
// The phase counters (1024 blocks x 16 phases, cycles) into out; reset.
int a2m_gcn_stack_tc_profile(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
int a2m_gcn_stack_tc_profile_reset() {
  static unsigned long long zero[1024][16];
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif

const char* a2m_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
