// Forward of the 5-layer GAT/GraphConv stack in edge form, CUDA C++ for
// sm_90a.
//
// Both entries replace the Pallas TPU kernel a2m/nn/pallas_gcn.py::
// _kernel_edge (helpers _gat_edge, _graph_conv_edge; called by
// _fused_impl_edge with the constants of edge_matrices): the gradient-free
// forward of the stack that gcn_stack.cu also computes, with the message
// routing of the fixed skeleton written as constant operators shared by a
// tile of graphs, and with its own rounding points.  One design for each
// mode:
// * a2m_gcn_stack_edge_tc, bf16 operands (mm_dtype=bf16, the serving
//   default): products on the tensor cores (wgmma), weights resident in
//   shared memory, one persistent block per SM;
// * a2m_gcn_stack_edge, f32 operands (the parity route, held to
//   gcn_stack.cu at 2e-5, which TF32 tensor cores cannot meet): products on
//   the CUDA cores, register-tiled.
// What both compute, on a tile of T graphs in joint-major order (row
// j * T + t for node j of graph t), so that X @ W is one product over the
// J * T rows and every routing step is one operator applied to the tile:
//   GAT layers (1, 3, 5), per head h: XW_h = X @ W[:, h]; a_src, a_dst from
//     the f32 XW_h; per destination (j, t) the softmax statistics m (max)
//     and denom over its in-edges; per edge e alpha[e, t] =
//     exp(LeakyReLU_0.2(a_src[src e] + a_dst[dst e]) - m[dst e]) /
//     denom[dst e]; the value path gathers XW_h by source, weights it by
//     alpha, rounds the product, and sums it by destination; heads are
//     added, then / H + bias.
//   GraphConv layers (2, 4): neigh = A @ X once for the tile, then
//     neigh @ W_rel + X @ W_root + b (two f32 products, then added).
//   Every layer: LayerNorm (eps 1e-6), LeakyReLU 0.2, + residual.
// The Pallas kernel routes with 0/1 incidence matrices S, D (E, J) and D^T
// on the matrix unit; a product with a matrix that has one 1 per row is a
// gather, and a product with D^T a sum over a destination's edges, which
// is how the CUDA cores run them here: the wrapper reads the src/dst lists
// off S and D (edges sorted by destination) and the kernels index with
// them.  Sums over a destination's edges run in edge order, heads in head
// order, with no atomics: the same inputs give bit-equal outputs, and a
// row's result depends on its own graph alone, not on T or N.
//
// Bound on the H100: at the serving shapes (N = 13,824 graphs, J = 42 or
// 10, F = 64, H = 4) both stacks need ~102 GFLOP against 369 MB of x in
// and y out: by bytes ~0.11 ms at 3.35 TB/s, ~0.10 ms at the bf16
// tensor-core rate.  ~94 of the 102 GFLOP are the dense products X @ W,
// neigh @ W_rel and X @ W_root.
//
// The tensor-core design (bf16 mode), and what it does about the bound:
// * the products run as wgmma.m64n64k16 (bf16 operands, f32 accumulators)
//   from shared memory: A is x (or neigh) of one 64-row M tile, B one
//   head's W (or W_rel, W_root), both K-major with the 128-byte swizzle;
// * the tile is T whole graphs in joint-major rows, zero-padded to a
//   multiple of 64 rows (at most 128): T = 3 at J = 42 (126 of 128 rows),
//   T = 12 at J = 10 (120 of 128).  Features are zero-padded to 64, so one
//   layout serves every F <= 64.  Pad rows are in no edge list, feed no
//   real row and are never stored; the wrapper's plan (nn/gcn_kernel.py::
//   edge_tc_plan) picks T and the shared-memory layout, and this file
//   refuses a plan it does not reproduce;
// * the weights are rounded to bf16 and packed in the swizzled B layout
//   once, by the wrapper; each block copies the GAT layers' weights (96 KB
//   at F = 64, H = 4) into shared memory once and then walks tiles
//   (blockIdx.x, + gridDim.x, ...), one block of 256 threads (two
//   warpgroups, one per M tile) per SM, 235-239 registers, no spill; a
//   GraphConv layer's two weight blocks (16 KB) are loaded from L2 for each
//   tile while the neighbour sums run;
// * GAT heads run in one chunk of up to four (HC, the plan's choice): each
//   warpgroup runs the chunk's heads one by one on its M tile; while the
//   tensor cores work it computes a_src, a_dst; the epilogue stores XW_h
//   rounded once, as bf16.  Then one pass computes the softmax statistics
//   and alpha per (node, head), two items a thread side by side, and one
//   pass, eight lanes a row and four rows a warp at a time, gathers,
//   weights, rounds and sums the chunk's heads into registers (code
//   specialised on HC, so that an edge's loads for all heads issue
//   together); after the last chunk the same lanes apply bias, LayerNorm,
//   LeakyReLU and the residual and write x in f32 and its bf16 operand
//   copy for the next layer.  GraphConv: the same lanes sum A @ X into the
//   bf16 neigh tile; each warpgroup then runs both products of its M tile
//   and LayerNorm in the accumulators' layout;
// * the (N, J, F) <-> (J, T, F) relayout is folded into the tile's loads
//   (all of a thread's loads in flight at once) and stores; x makes one
//   trip from device memory and y one back;
// * the code is kept small (edge loops not unrolled, divisions by H and F
//   by reciprocals, near-tie recomputation out of line): the tile loop's
//   code is larger than the instruction cache, and each phase's time
//   followed its code size.
// What holds it back (utils/edge_probe.py, PERF.md): every phase is a
// latency chain between barriers, one block an SM; the XW_h products'
// epilogues (near-tie recomputation included), the value path and
// LayerNorm take most of the cycles, the tensor cores few.
//
// Matching the plain version's roundings.  wgmma sums a product in its own
// order and truncates, while the plain version's f32 GEMM (cuBLAS at these
// shapes) rounds as a sequential k-order FMA chain; so a bf16 rounding that
// lies near a tie can fall the other way.  The kernel therefore
// * recomputes an XW_h element whose f32 value lies within kTieUlps ulps of
//   a bf16 midpoint as the k-order chain (k_order_dot), so that its
//   rounding is the plain version's, and likewise a GraphConv output x
//   whose rounding into the next layer's operand is that close;
// * takes a_src = x . (W_h att_src) and a_dst in float64 from x and the
//   wrapper's W_h att (float64 from the rounded W_h): the logit of the
//   unrounded XW_h, rounded once, so that alpha carries no error of its
//   own; the softmax denominators and LayerNorm's sums are float64 too.
//
// The CUDA-core design (f32 mode): a block owns T graphs (T from the
// shared-memory budget, at most 96 rows: T = 2 at J = 42, T = 9 at J =
// 10); X @ W_h, @ W_rel and @ W_root use the register-tiled product of
// gcn_common.cuh, with the row block sized so that one pass covers the
// tile's rows; four (J * T, F) f32 buffers (x, its copy, one head's XW_h,
// the layer's output), the (J, T) statistics and the (E, T) alpha.
//
// Precision: the bf16 mode rounds where a2m's mm_dtype=bf16 does in
// _kernel_edge, which is not where _kernel does: x and W for X @ W; XW_h
// for the gather (a_src, a_dst are read before that rounding); the product
// XW_h[src] * alpha (f32) on its way into the sum, alpha itself is never
// rounded; x for A @ X, the neighbour sums, and W_rel, W_root.  Statistics,
// exp, the division and LayerNorm are f32 (IEEE expf, division and rsqrtf:
// no fast-math flag; the bf16 mode's sums of them in float64, above).  The
// f32 mode is plain f32.
//
// Layout: x and y are (N, J, F) f32 contiguous, 16-byte aligned; params as
// gcn_stack.cu; route is one int32 buffer [src (E), dst (E), ptr (J + 1),
// conv_src (Ec), conv_ptr (J + 1)]: the E edges of A + I sorted by
// destination with ptr their per-destination ranges, and the Ec nonzero
// entries of A likewise; conv_w (Ec) f32 their values.  wpack (bf16 mode)
// holds, layer by layer, one 64 x 64 bf16 block per GAT head (W[:, h]^T)
// and two per GraphConv layer (W_rel^T, W_root^T), zero-padded to 64 x 64,
// row n's 16-byte chunk c stored at chunk c ^ (n % 8); watt (GAT layers,
// H, 2, 64) float64 holds W_h att_src and W_h att_dst of the rounded W_h.

#include "gcn_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 96;               // J * T rows a tile aims for
constexpr size_t kHalfSmShared = 115712;   // (228 KB - 2 x 1 KB) / 2

// ---------------------------------------------------------------------------
// f32 mode: CUDA cores
// ---------------------------------------------------------------------------

template <int kRowBlock>
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
  for (int i = tid; i < Ec; i += blockDim.x) cw_s[i] = conv_w[i];
  __syncthreads();

  const float* p = params;
  for (int layer = 0; layer < L; ++layer) {
    const bool gat = layer % 2 == 0;
    for (int i = tid; i < R * F4; i += blockDim.x) {
      reinterpret_cast<float4*>(xo_s)[i] =
          reinterpret_cast<const float4*>(x_s)[i];
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
        mm_strided<true, kRowBlock>(xo_s, F, W + h * F, HF, F, F, R, xwh_s,
                                    F, false);
        __syncthreads();
        // a_src, a_dst from XW_h: a warp per row
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
        // softmax statistics per destination (j, t) over its in-edges
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
        __syncthreads();
        // alpha per edge, from the statistics of its destination
        for (int item = tid; item < E * T; item += blockDim.x) {
          const int e = item / T, t = item % T;
          const int d = dst_s[e] * T + t;
          const float logit = leaky(asrc_s[src_s[e] * T + t] + adst_s[d]);
          alpha_s[item] = expf(logit - m_s[d]) / den_s[d];
        }
        __syncthreads();
        // value path: gather by source, weight, sum by destination in edge
        // order; a thread owns one row x 4 features
        for (int item = tid; item < R * F4; item += blockDim.x) {
          const int r = item / F4, q = item % F4;
          const int j = r / T, t = r % T;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int e = ptr_s[j]; e < ptr_s[j + 1]; ++e) {
            const float a = alpha_s[e * T + t];
            const float4 z = reinterpret_cast<const float4*>(
                xwh_s + (src_s[e] * T + t) * F)[q];
            acc[0] += z.x * a;
            acc[1] += z.y * a;
            acc[2] += z.z * a;
            acc[3] += z.w * a;
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
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
      __syncthreads();
      mm<true, kRowBlock>(xwh_s, F, W_rel, F, F, R, out_s, F, false);
      mm<true, kRowBlock>(xo_s, F, W_root, F, F, R, out_s, F, true);
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

template <int kRowBlock>
int launch(const float* x, float* y, const float* params, const int* route,
           const float* conv_w, int n, int J, int F, int H, int L, int T,
           int E, int Ec, cudaStream_t stream) {
  const size_t bytes = smem_bytes(J, F, T, E, Ec);
  cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_edge_kernel<kRowBlock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + T - 1) / T;
  gcn_stack_edge_kernel<kRowBlock><<<blocks, kThreads, bytes, stream>>>(
      x, y, params, route, conv_w, n, J, F, H, L, T, E, Ec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 mode: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;            // two warpgroups, one per M tile
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcMaxRows = 128;            // two 64-row M tiles
constexpr int kTcRowsPerWarp = kTcMaxRows / kTcWarps;
constexpr int kTcGroups = kTcRowsPerWarp / 4;   // of four rows a warp
constexpr int kXStride = 72;               // f32 row stride of x_s
constexpr int kLoads = 8;                  // float4 loads in flight a thread
constexpr int kConvLoads = 2 * kBlock / 16 / kTcThreads;
constexpr int kMaxHC = 4;                  // heads a chunk
constexpr int kStatItems = kTcMaxRows * kMaxHC / kTcThreads;  // a thread

// The shared-memory layout of a plan, in bytes from a 1024-aligned base;
// nn/gcn_kernel.py::edge_tc_plan computes the same.
struct TcLayout {
  int T, R, Rp, HC, xw_stride;   // graphs, rows, padded rows, heads a
                                 // chunk, XW row stride (bf16 values)
  int wbytes, off_xo, off_xw, off_x, off_asrc, off_adst, off_alpha, off_cw,
      off_route, bytes;
};

TcLayout tc_layout(int J, int H, int L, int E, int Ec, int T, int Rp,
                   int HC) {
  TcLayout s;
  s.T = T;
  s.R = J * T;
  s.Rp = Rp;
  s.HC = HC;
  s.xw_stride = HC * kFp + 8;            // + 16 B: conflict-free epilogue
  s.wbytes = (L + 1) / 2 * H * kBlock;         // the GAT layers' weights
  s.off_xo = s.wbytes;                         // (Rp, 64) bf16, swizzled
  s.off_xw = s.off_xo + Rp * kFp * 2;          // XW chunk, or neigh and
  const int xw_bytes = Rp * s.xw_stride * 2;   // the GraphConv weights
  const int conv_bytes = Rp * kFp * 2 + 2 * kBlock;
  s.off_x = s.off_xw + (xw_bytes > conv_bytes ? xw_bytes : conv_bytes);
  s.off_asrc = s.off_x + s.R * kXStride * 4;   // (R, HC) f32
  s.off_adst = s.off_asrc + s.R * HC * 4;      // (R, HC) f32
  s.off_alpha = s.off_adst + s.R * HC * 4;     // (E, T, HC) f32
  s.off_cw = s.off_alpha + E * T * HC * 4;     // (Ec) f32
  s.off_route = s.off_cw + Ec * 4;             // route, int32
  s.bytes = s.off_route + (2 * E + Ec + 2 * (J + 1)) * 4 + 1024;
  return s;
}

// One GAT head's product on one warpgroup: XW_h of M tile mt, stored as
// bf16 in column block hc of the chunk (near-tie elements recomputed in k
// order), and a_src, a_dst of its rows: a_src = x . (W_h att_src) in
// float64 (watt: W_h att_src, W_h att_dst from the wrapper), the unrounded
// XW_h's logit to within the final rounding; a quad of lanes holds a row.
__device__ __forceinline__ void gat_head(
    const uint8_t* xo_s, const uint8_t* w_block, uint8_t* xw_s,
    float* asrc_s, float* adst_s, const double* __restrict__ watt, int hc,
    int HC, int mt, int wrow, int tig, int R, int XWS) {
  float d[32];
  product(d, xo_s + mt * 64 * 128, w_block);
  const int row = mt * 64 + wrow;
  // the logits while the tensor cores run
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    double sa = 0.0, da = 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = 8 * i + 2 * tig;
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          xo_s + swz(row + 8 * half, f)));
      sa = fma((double)xv.y, __ldg(watt + f + 1),
               fma((double)xv.x, __ldg(watt + f), sa));
      da = fma((double)xv.y, __ldg(watt + kFp + f + 1),
               fma((double)xv.x, __ldg(watt + kFp + f), da));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      da += __shfl_xor_sync(0xffffffffu, da, o);
    }
    const int r = row + 8 * half;
    if (tig == 0 && r < R) {
      asrc_s[r * HC + hc] = (float)sa;
      adst_s[r * HC + hc] = (float)da;
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(d);
  uint32_t ties = 0;
  uint8_t* xw = xw_s + hc * kFp * 2;
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    ties |= (uint32_t)near_tie(d[k]) << k | (uint32_t)near_tie(d[k + 1])
                                                << (k + 1);
    *reinterpret_cast<uint32_t*>(
        xw + ((mt * 64 + acc_row(k, wrow)) * XWS + acc_col(k, tig)) * 2) =
        pack_bf16(d[k], d[k + 1]);
  }
  for (; ties; ties &= ties - 1) {
    const int k = __ffs(ties) - 1;
    const int r = mt * 64 + acc_row(k, wrow), col = acc_col(k, tig);
    *reinterpret_cast<__nv_bfloat16*>(xw + (r * XWS + col) * 2) =
        __float2bfloat16_rn(k_order_dot(xo_s, r, w_block, col));
  }
}

// The value path of a chunk of kHC heads for a warp's rows (16 warp + 4 g
// + sub, g < kTcGroups; eight lanes a row, features 8 fg..8 fg + 7): per
// head, gather XW_h by source, weight by alpha, round, and sum by
// destination in edge order; then add the heads to out in head order.  A
// head count fixed at compile time lets every head's loads of an edge
// issue together.
template <int kHC>
__device__ __forceinline__ void value_rows(
    float (&out)[kTcGroups][8], const uint8_t* xw_s, const float* alpha_s,
    const int* src_s, const int* ptr_s, int warp, int sub, int fg, int R,
    int T, int XWS) {
#pragma unroll
  for (int g = 0; g < kTcGroups; ++g) {
    const int r = kTcRowsPerWarp * warp + 4 * g + sub;
    if (r >= R) continue;
    const int j = r / T, t = r % T;
    float hs[kHC][8];
#pragma unroll
    for (int hc = 0; hc < kHC; ++hc)
#pragma unroll
      for (int q = 0; q < 8; ++q) hs[hc][q] = 0.f;
#pragma unroll 1
    for (int e = ptr_s[j]; e < ptr_s[j + 1]; ++e) {
      const float* al = alpha_s + (e * T + t) * kHC;
      const uint8_t* zr = xw_s + ((src_s[e] * T + t) * XWS + 8 * fg) * 2;
      float a[kHC];
      uint4 z[kHC];
#pragma unroll
      for (int hc = 0; hc < kHC; ++hc) {
        a[hc] = al[hc];
        z[hc] = *reinterpret_cast<const uint4*>(zr + hc * kFp * 2);
      }
#pragma unroll
      for (int hc = 0; hc < kHC; ++hc) {
        const uint32_t zw[4] = {z[hc].x, z[hc].y, z[hc].z, z[hc].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 zf = unpack_bf16(zw[q]);
          const float2 za =
              unpack_bf16(pack_bf16(zf.x * a[hc], zf.y * a[hc]));
          hs[hc][2 * q] += za.x;
          hs[hc][2 * q + 1] += za.y;
        }
      }
    }
#pragma unroll
    for (int hc = 0; hc < kHC; ++hc)
#pragma unroll
      for (int q = 0; q < 8; ++q) out[g][q] += hs[hc][q];
  }
}

// -DA2M_TC_PROFILE (utils/edge_probe.py): thread 0 of each block adds the
// clock cycles from one barrier to the next to its phase's counter.
#ifdef A2M_TC_PROFILE
__device__ unsigned long long g_prof[1024][8];
#define PROF(ph)                                                    \
  if (tid == 0 && blockIdx.x < 1024) {                              \
    const long long now_ = clock64();                               \
    g_prof[blockIdx.x][ph] += now_ - t_prev_;                       \
    t_prev_ = now_;                                                 \
  }
#else
#define PROF(ph)
#endif

__global__ void __launch_bounds__(kTcThreads, 1)
gcn_stack_edge_tc_kernel(const float* __restrict__ x, float* __restrict__ y,
                         const float* __restrict__ params,
                         const uint4* __restrict__ wpack,
                         const double* __restrict__ watt,
                         const int* __restrict__ route,
                         const float* __restrict__ conv_w, int n, int J,
                         int F, int H, int L, int E, int Ec, TcLayout lay) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw
      + ((1024 - (__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int mt = warp / 4;                  // a warpgroup's M tile
  const int wrow = (warp % 4) * 16 + lane / 4;   // accumulator row in it
  const int tig = lane % 4;                 // accumulator column pair
  const int sub = lane / 8, fg = lane % 8;  // row of 4, features 8 fg..+7
  const int T = lay.T, R = lay.R, HC = lay.HC, XWS = lay.xw_stride;
  const bool mma_rows = mt * 64 < lay.Rp;   // this warpgroup has a tile
  const int F4 = F / 4;
  const double inv_f = 1.0 / F;             // LayerNorm's means, float64
  const float inv_h = 1.f / (float)H;       // exact where H is 2^k

  const uint8_t* w_s = base;
  uint8_t* xo_s = base + lay.off_xo;
  uint8_t* xw_s = base + lay.off_xw;        // bf16 (Rp, XWS), or neigh
  float* x_s = reinterpret_cast<float*>(base + lay.off_x);
  float* asrc_s = reinterpret_cast<float*>(base + lay.off_asrc);
  float* adst_s = reinterpret_cast<float*>(base + lay.off_adst);
  float* alpha_s = reinterpret_cast<float*>(base + lay.off_alpha);
  float* cw_s = reinterpret_cast<float*>(base + lay.off_cw);
  int* src_s = reinterpret_cast<int*>(base + lay.off_route);   // (E)
  const int* ptr_s = src_s + 2 * E;        // (J + 1)
  const int* csrc_s = ptr_s + J + 1;       // (Ec)
  const int* cptr_s = csrc_s + Ec;         // (J + 1)

  // once per block: the GAT layers' weights (wpack holds every layer's
  // blocks in order), the routing lists, zeros in the pad rows and pad
  // features of x and its operand copy (never written again)
  for (int l = 0, gb = 0, sb = 0; l < L; gb += l % 2 == 0 ? H : 2, ++l) {
    if (l % 2) continue;
    for (int i = tid; i < H * kBlock / 16; i += kTcThreads)
      reinterpret_cast<uint4*>(base + sb * kBlock)[i] =
          __ldg(wpack + gb * kBlock / 16 + i);
    sb += H;
  }
  for (int i = tid; i < 2 * E + Ec + 2 * (J + 1); i += kTcThreads)
    src_s[i] = route[i];
  for (int i = tid; i < Ec; i += kTcThreads) cw_s[i] = bf16r(conv_w[i]);
  for (int i = tid; i < lay.Rp * kFp * 2 / 16; i += kTcThreads)
    reinterpret_cast<uint4*>(xo_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < R * kXStride / 4; i += kTcThreads)
    reinterpret_cast<float4*>(x_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_async_smem();
  __syncthreads();

  const int q = lane % 16;                  // a lane's float4 of a row
  const int tiles = (n + T - 1) / T;
#ifdef A2M_TC_PROFILE
  long long t_prev_ = clock64();
#endif
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * T;
    // tile load with the relayout: a half-warp per row (graph t, joint j,
    // in device-memory order), a lane per float4; a thread's kLoads loads
    // are in flight together; graphs past n read as zeros
    for (int r0 = 2 * warp + lane / 16; r0 < T * J;
         r0 += kLoads * 2 * kTcWarps) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int rg = r0 + u * 2 * kTcWarps;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (rg < T * J && q < F4 && g0 + rg / J < n)
          v[u] = __ldg(reinterpret_cast<const float4*>(x)
                       + ((size_t)g0 * J + rg) * F4 + q);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int rg = r0 + u * 2 * kTcWarps;
        if (rg < T * J && q < F4) {
          const int t = rg / J, r = (rg - t * J) * T + t;
          *reinterpret_cast<float4*>(x_s + r * kXStride + 4 * q) = v[u];
          *reinterpret_cast<uint2*>(xo_s + swz(r, 4 * q)) = make_uint2(
              pack_bf16(v[u].x, v[u].y), pack_bf16(v[u].z, v[u].w));
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    PROF(0)

    const float* p = params;
    int woff = 0;                           // GAT weights in shared memory
    int wblock = 0;                         // the layer's first in wpack
    for (int layer = 0; layer < L; ++layer) {
      if (layer % 2 == 0) {
        // ---- GAT --------------------------------------------------------
        const float* bias = p + F * H * F + 2 * H * F;
        const float* ln_scale = bias + F;
        const float* ln_bias = ln_scale + F;
        p = ln_bias + F;

        // sum over heads of the value path: rows 16 warp + 4 g + sub,
        // features 8 fg + q
        float out[kTcGroups][8];
#pragma unroll
        for (int g = 0; g < kTcGroups; ++g)
#pragma unroll
          for (int q = 0; q < 8; ++q) out[g][q] = 0.f;

        for (int c = 0; c < H / HC; ++c) {
          // (a) XW of the chunk's heads, a warpgroup per M tile
          if (mma_rows) {
            for (int hc = 0; hc < HC; ++hc) {
              const int h = c * HC + hc;
              gat_head(xo_s, w_s + woff + h * kBlock, xw_s, asrc_s, adst_s,
                       watt + (layer / 2 * H + h) * 2 * kFp, hc, HC, mt,
                       wrow, tig, R, XWS);
            }
          }
          __syncthreads();
          PROF(1)
          // (b) softmax statistics per (destination, head) over its
          // in-edges, then alpha of each of them: a thread's items side by
          // side, each edge's logit gathered once (alpha holds it, then its
          // exp, then alpha)
#pragma unroll
          for (int u = 0; u < kStatItems; ++u) {
            const int item = tid + u * kTcThreads;
            if (item < R * HC) {
              const int r = item / HC, hc = item % HC;
              const int j = r / T, t = r % T;
              const float ad = adst_s[item];
              float* al = alpha_s + t * HC + hc;      // edge e at e T HC
              float mx = -INFINITY;
#pragma unroll 1
              for (int e = ptr_s[j]; e < ptr_s[j + 1]; ++e) {
                const float logit =
                    leaky(ad + asrc_s[(src_s[e] * T + t) * HC + hc]);
                al[e * T * HC] = logit;
                mx = fmaxf(mx, logit);
              }
              double sum = 0.0;
#pragma unroll 1
              for (int e = ptr_s[j]; e < ptr_s[j + 1]; ++e) {
                const float ex = expf(al[e * T * HC] - mx);
                al[e * T * HC] = ex;
                sum += ex;
              }
              const float den = (float)sum;
#pragma unroll 1
              for (int e = ptr_s[j]; e < ptr_s[j + 1]; ++e)
                al[e * T * HC] /= den;
            }
          }
          __syncthreads();
          PROF(2)
          // (c) value path, four rows a warp at a time, eight lanes a row
          if (HC == 4)
            value_rows<4>(out, xw_s, alpha_s, src_s, ptr_s, warp, sub, fg,
                          R, T, XWS);
          else if (HC == 2)
            value_rows<2>(out, xw_s, alpha_s, src_s, ptr_s, warp, sub, fg,
                          R, T, XWS);
          else
            value_rows<1>(out, xw_s, alpha_s, src_s, ptr_s, warp, sub, fg,
                          R, T, XWS);
          if (c == H / HC - 1) {
            // / H + bias, LayerNorm, LeakyReLU, residual; x and its bf16
            // operand copy for the next layer (pad rows are computed, not
            // stored)
            float b[8], gs[8], lb[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int f = 8 * fg + q;
              b[q] = f < F ? __ldg(bias + f) : 0.f;
              gs[q] = f < F ? __ldg(ln_scale + f) : 0.f;
              lb[q] = f < F ? __ldg(ln_bias + f) : 0.f;
            }
#pragma unroll
            for (int g = 0; g < kTcGroups; ++g) {
              const int r = kTcRowsPerWarp * warp + 4 * g + sub;
              float v[8];
              double s = 0.0;
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                v[q] = div_heads(out[g][q], H, inv_h) + b[q];
                s += v[q];
              }
#pragma unroll
              for (int o = 1; o < 8; o <<= 1)
                s += __shfl_xor_sync(0xffffffffu, s, o);
              const float mean = (float)(s * inv_f);
              double sq = 0.0;
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                v[q] = 8 * fg + q < F ? v[q] - mean : 0.f;
                sq = fma((double)v[q], (double)v[q], sq);
              }
#pragma unroll
              for (int o = 1; o < 8; o <<= 1)
                sq += __shfl_xor_sync(0xffffffffu, sq, o);
              const float rs = rsqrtf((float)(sq * inv_f) + kLnEps);
              if (r < R) {
                float4* xr = reinterpret_cast<float4*>(x_s + r * kXStride
                                                       + 8 * fg);
                const float4 r0 = xr[0], r1 = xr[1];
                const float res[8] = {r0.x, r0.y, r0.z, r0.w,
                                      r1.x, r1.y, r1.z, r1.w};
                float o[8];
#pragma unroll
                for (int q = 0; q < 8; ++q)
                  o[q] = 8 * fg + q < F
                             ? leaky(v[q] * rs * gs[q] + lb[q]) + res[q]
                             : 0.f;
                xr[0] = make_float4(o[0], o[1], o[2], o[3]);
                xr[1] = make_float4(o[4], o[5], o[6], o[7]);
                *reinterpret_cast<uint4*>(xo_s + swz(r, 8 * fg)) =
                    make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                               pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
              }
            }
          }
          fence_async_smem();
          __syncthreads();
          PROF(3)
        }
        woff += H * kBlock;
        wblock += H;
      } else {
        // ---- GraphConv --------------------------------------------------
        const float* bias = p + 2 * F * F;
        const float* ln_scale = bias + F;
        const float* ln_bias = ln_scale + F;
        p = ln_bias + F;
        // the layer's W_rel and W_root: loaded now, stored after the
        // neighbour sums, beside the neigh tile
        uint8_t* w_rel = xw_s + lay.Rp * kFp * 2;
        const uint8_t* w_root = w_rel + kBlock;
        uint4 wv[kConvLoads];
#pragma unroll
        for (int u = 0; u < kConvLoads; ++u)
          wv[u] = __ldg(wpack + wblock * kBlock / 16 + tid + u * kTcThreads);
        wblock += 2;

        // (a) neigh = A @ X over the entries of A, four rows a warp at a
        // time, rounded into its operand tile; pad rows are zeros
#pragma unroll
        for (int g = 0; g < kTcGroups; ++g) {
          const int r = kTcRowsPerWarp * warp + 4 * g + sub;
          if (r < lay.Rp) {
            float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (r < R) {
              const int j = r / T, t = r % T;
#pragma unroll 1
              for (int e = cptr_s[j]; e < cptr_s[j + 1]; ++e) {
                const float w = cw_s[e];
                const float4* xr = reinterpret_cast<const float4*>(
                    x_s + (csrc_s[e] * T + t) * kXStride + 8 * fg);
                const float4 v0 = xr[0], v1 = xr[1];
                const float xv[8] = {v0.x, v0.y, v0.z, v0.w,
                                     v1.x, v1.y, v1.z, v1.w};
#pragma unroll
                for (int q = 0; q < 8; q += 2) {
                  const float2 xr =
                      unpack_bf16(pack_bf16(xv[q], xv[q + 1]));
                  acc[q] = fmaf(w, xr.x, acc[q]);
                  acc[q + 1] = fmaf(w, xr.y, acc[q + 1]);
                }
              }
            }
            *reinterpret_cast<uint4*>(xw_s + swz(r, 8 * fg)) =
                make_uint4(pack_bf16(acc[0], acc[1]),
                           pack_bf16(acc[2], acc[3]),
                           pack_bf16(acc[4], acc[5]),
                           pack_bf16(acc[6], acc[7]));
          }
        }
#pragma unroll
        for (int u = 0; u < kConvLoads; ++u)
          reinterpret_cast<uint4*>(w_rel)[tid + u * kTcThreads] = wv[u];
        fence_async_smem();
        __syncthreads();
        PROF(4)
        // (b) neigh @ W_rel and X @ W_root, a warpgroup per M tile, added
        // as two f32 results, + bias, then LayerNorm, LeakyReLU and the
        // residual in the accumulators' layout: a quad of lanes holds a row
        if (mma_rows) {
          float d[32], dt[32];
          product(d, xw_s + mt * 64 * 128, w_rel);
          product(dt, xo_s + mt * 64 * 128, w_root);
          // this thread's 16 columns: bias, LayerNorm scale and bias
          float cb[16], cg[16], cl[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int col = acc_col(4 * (i / 2) + i % 2, tig);
            cb[i] = col < F ? __ldg(bias + col) : 0.f;
            cg[i] = col < F ? __ldg(ln_scale + col) : 0.f;
            cl[i] = col < F ? __ldg(ln_bias + col) : 0.f;
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_operands(d);
          fence_operands(dt);
#pragma unroll
          for (int k = 0; k < 32; ++k)
            d[k] = d[k] + dt[k] + cb[2 * (k / 4) + k % 2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = mt * 64 + wrow + 8 * half;
            double s = 0.0;
#pragma unroll
            for (int i = 0; i < 8; ++i)
              s += (double)d[4 * i + 2 * half] + d[4 * i + 2 * half + 1];
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            const float mean = (float)(s * inv_f);
            double sq = 0.0;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int k = 4 * i + 2 * half + u;
                dt[k] = 8 * i + 2 * tig + u < F ? d[k] - mean : 0.f;
                sq = fma((double)dt[k], (double)dt[k], sq);
              }
            }
            sq += __shfl_xor_sync(0xffffffffu, sq, 1);
            sq += __shfl_xor_sync(0xffffffffu, sq, 2);
            const float rs = rsqrtf((float)(sq * inv_f) + kLnEps);
            // the new x; its near-tie elements recomputed from the k-order
            // products (the row's old x is still in xo_s) and stored in
            // x_s, which the writes below then take them from
            float o[16];
            uint32_t ties = 0;
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int k = 4 * (i / 2) + 2 * half + i % 2;
              const int col = acc_col(k, tig);
              o[i] = 0.f;
              if (row < R && col < F) {
                o[i] = leaky(dt[k] * rs * cg[i] + cl[i])
                       + x_s[row * kXStride + col];
                ties |= (uint32_t)near_tie(o[i]) << i;
              }
            }
            for (uint32_t t = ties; t; t &= t - 1) {
              const int i = __ffs(t) - 1;
              const int col = acc_col(4 * (i / 2) + i % 2, tig);
              const float e = k_order_dot(xw_s, row, w_rel, col)
                              + k_order_dot(xo_s, row, w_root, col)
                              + __ldg(bias + col) - mean;
              x_s[row * kXStride + col] =
                  leaky(e * rs * __ldg(ln_scale + col) + __ldg(ln_bias + col))
                  + x_s[row * kXStride + col];
            }
            __syncwarp();
#pragma unroll
            for (int i = 0; i < 16; ++i)
              if (ties >> i & 1) o[i] = x_s[row * kXStride + acc_col(
                                                  4 * (i / 2) + i % 2, tig)];
            if (row < R) {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int col = 8 * i + 2 * tig;
                *reinterpret_cast<float2*>(x_s + row * kXStride + col) =
                    make_float2(o[2 * i], o[2 * i + 1]);
                *reinterpret_cast<uint32_t*>(xo_s + swz(row, col)) =
                    pack_bf16(o[2 * i], o[2 * i + 1]);
              }
            }
          }
        }
        fence_async_smem();
        __syncthreads();
        PROF(5)
      }
    }

#pragma unroll 1
    for (int rg = 2 * warp + lane / 16; rg < T * J; rg += 2 * kTcWarps) {
      const int t = rg / J, r = (rg - t * J) * T + t;
      if (q < F4 && g0 + t < n)
        reinterpret_cast<float4*>(y)[((size_t)g0 * J + rg) * F4 + q] =
            *reinterpret_cast<const float4*>(x_s + r * kXStride + 4 * q);
    }
    __syncthreads();                        // x_s is the next tile's
    PROF(6)
  }
}

}  // namespace

extern "C" {

// f32 mode: graphs per block for this skeleton (0: one graph does not fit).
int a2m_gcn_stack_edge_tile(int J, int F, int E, int Ec) {
  return pick_tile(J, F, E, Ec);
}

// f32 mode (CUDA cores).
int a2m_gcn_stack_edge(const void* x, void* y, const void* params,
                       const void* route, const void* conv_w, int n, int J,
                       int F, int H, int L, int E, int Ec, void* stream) {
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
  // the matmul's row block: F / 4 column groups x ceil(rows / block) row
  // blocks should fill the 256 threads in one pass
  const int rows = J * T;
  if (rows <= 80)
    return launch<5>(xp, (float*)y, pp, rp, cp, n, J, F, H, L, T, E, Ec, s);
  if (rows <= 96)
    return launch<6>(xp, (float*)y, pp, rp, cp, n, J, F, H, L, T, E, Ec, s);
  return launch<8>(xp, (float*)y, pp, rp, cp, n, J, F, H, L, T, E, Ec, s);
}

// bf16 mode (tensor cores), on the wrapper's plan: T graphs a tile,
// padded_rows rows, head_chunk heads a chunk, smem_bytes of shared memory,
// grid persistent blocks.  A plan this file does not reproduce is refused.
int a2m_gcn_stack_edge_tc(const void* x, void* y, const void* params,
                          const void* wpack, const void* watt,
                          const void* route,
                          const void* conv_w, int n, int J, int F, int H,
                          int L, int E, int Ec, int T, int padded_rows,
                          int head_chunk, int smem_bytes, int grid,
                          void* stream) {
  if (n <= 0) return 0;
  if (F % 4 != 0 || F > kFp || T < 1 || L < 1 || grid < 1
      || (head_chunk != 1 && head_chunk != 2 && head_chunk != 4)
      || H % head_chunk != 0
      || padded_rows != (J * T + 63) / 64 * 64 || padded_rows > kTcMaxRows)
    return (int)cudaErrorInvalidValue;
  const TcLayout lay = tc_layout(J, H, L, E, Ec, T, padded_rows, head_chunk);
  if (lay.bytes != smem_bytes || (size_t)lay.bytes > kBlockShared)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_edge_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.bytes);
  if (err != cudaSuccess) return (int)err;
  gcn_stack_edge_tc_kernel<<<grid, kTcThreads, lay.bytes,
                             (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, (const float*)params, (const uint4*)wpack,
      (const double*)watt, (const int*)route, (const float*)conv_w, n, J, F,
      H, L, E, Ec, lay);
  return (int)cudaGetLastError();
}

// The tensor-core kernel as built: out[0] registers a thread, out[1] local
// (spill) bytes a thread, out[2] blocks an SM at smem_bytes, out[3] threads
// a block.
int a2m_gcn_stack_edge_tc_info(int smem_bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gcn_stack_edge_tc_kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gcn_stack_edge_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gcn_stack_edge_tc_kernel, kTcThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = kTcThreads;
  return 0;
}

#ifdef A2M_TC_PROFILE
// The phase counters (1024 blocks x 8 phases, cycles) into out; reset.
int a2m_gcn_stack_edge_tc_profile(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
int a2m_gcn_stack_edge_tc_profile_reset() {
  static unsigned long long zero[1024][8];
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif

const char* a2m_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
