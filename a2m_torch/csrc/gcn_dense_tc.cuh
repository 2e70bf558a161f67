// The graph-major tiles of the dense GCN stack kernels on Hopper's wgmma
// (gcn_stack.cu: the forward and the forward with stash in bf16 mode;
// gcn_stack_bwd.cu: the backward in bf16 mode): a tile is whole graphs in
// graph-major rows, zero-padded to 128 rows (two 64-row M tiles, one
// warpgroup each) and 64 features.  The tile's constants, the wgmma
// operand variants (A in registers, either operand MN-major), the
// warpgroup barrier, cp.async, and the forward's pieces both kernels run:
// the logits, XW_h into its operand tile, the softmax, and the A fragments
// of the block-diagonal alpha and A.

#pragma once

#include "gcn_tc.cuh"

namespace {

constexpr int kTcThreads = 256;            // two warpgroups, one per M tile
constexpr int kTcRows = 128;               // rows of a tile: two M tiles
constexpr int kMaxHeads = 4;               // heads the apply holds at once
constexpr int kMaxSlots = 8;               // edges into a node, self-loop in
constexpr int kTile = kTcRows * kFp * 2;   // one (128, 64) bf16 operand tile
constexpr int kStep = 16 * kFp * 2;        // 16 of its rows: one k step
constexpr int kNoSlot = 0xff;              // lut: no edge

constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// d += A (64 x 16, four bf16 pairs a thread in registers) @ B (16 x 64 from
// shared memory), f32 sums; B is K-major (kTnspB = 0) or MN-major, its
// rows of 64 features one per k (kTnspB = 1).
template <int kTnspB>
__device__ __forceinline__ void wgmma_rs_k16(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(kTnspB),
        "r"(1));
}

// d += A (64 x 16) @ B (16 x 64), both from shared memory, f32 sums; each
// K-major (0) or MN-major (1: its rows of 64 values one per k, as the
// operand tiles are laid out), so that a tile of rows serves as A^T or B.
template <int kTnspA, int kTnspB>
__device__ __forceinline__ void wgmma_ss_k16(float (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(kTnspA), "n"(kTnspB));
}

// An A fragment in registers stays live, unchanged, until the wgmma that
// reads it has completed (called after the wait).
__device__ __forceinline__ void fence_fragment(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// the four warps of warpgroup mt, not the other
__device__ __forceinline__ void warpgroup_sync(int mt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + mt), "n"(128) : "memory");
}

// 16 bytes from device memory to shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// a_src and a_dst of this thread's rows for one GAT head: x . (W_h att) in
// float64 (watt: the wrapper's, in shared memory), the logit of the
// unrounded XW_h rounded once; a quad of lanes holds a row.
__device__ __forceinline__ void head_logits(const uint8_t* xo_s,
                                            const double* watt,
                                            float* asrc_s, float* adst_s,
                                            int h, int row, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    double sa = 0.0, da = 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = 8 * i + 2 * tig;
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          xo_s + swz(row + 8 * half, f)));
      sa = fma((double)xv.y, watt[f + 1], fma((double)xv.x, watt[f], sa));
      da = fma((double)xv.y, watt[kFp + f + 1],
               fma((double)xv.x, watt[kFp + f], da));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      da += __shfl_xor_sync(0xffffffffu, da, o);
    }
    if (tig == 0) {
      asrc_s[(row + 8 * half) * kMaxHeads + h] = (float)sa;
      adst_s[(row + 8 * half) * kMaxHeads + h] = (float)da;
    }
  }
}

// XW_h of M tile mt (d, complete) into its operand tile xw: bf16, rows of
// 64 features, swizzled (the B operand of the apply); near-tie elements
// recomputed in k order from x and the head's weight block.
__device__ __forceinline__ void store_head(const float (&d)[32],
                                           const uint8_t* xo_s,
                                           const uint8_t* w_block,
                                           uint8_t* xw, int mt, int wrow,
                                           int tig) {
  uint32_t ties = 0;
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    ties |= (uint32_t)near_tie(d[k]) << k | (uint32_t)near_tie(d[k + 1])
                                                << (k + 1);
    *reinterpret_cast<uint32_t*>(
        xw + swz(mt * 64 + acc_row(k, wrow), acc_col(k, tig))) =
        pack_bf16(d[k], d[k + 1]);
  }
  for (; ties; ties &= ties - 1) {
    const int k = __ffs(ties) - 1;
    const int r = mt * 64 + acc_row(k, wrow), col = acc_col(k, tig);
    *reinterpret_cast<__nv_bfloat16*>(xw + swz(r, col)) =
        __float2bfloat16_rn(k_order_dot(xo_s, r, w_block, col));
  }
}

// The attention of one (row, head) over its slots, the sources of its
// in-edges and itself in ascending order (nb: 8 of them, deg used): the
// masked softmax of a2m's _attn_stats as the plain version's takes it (max,
// then the sum of the exps in source order, then exp / sum), rounded to
// bf16 as _kernel rounds alpha for the apply.  al holds the row's slots, 4
// heads each.  The logits stay in registers, their loads all in flight.
__device__ __forceinline__ void attend(const float* asrc_s, float ad,
                                       uint2 nb, int deg, int rbase, int h,
                                       uint16_t* al) {
  const uint32_t src[2] = {nb.x, nb.y};
  float l[kMaxSlots];
  float mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < kMaxSlots; ++q) {
    if (q < deg) {
      const int s = (src[q / 4] >> (8 * (q % 4))) & 0xff;
      l[q] = leaky(ad + asrc_s[(rbase + s) * kMaxHeads + h]);
      mx = fmaxf(mx, l[q]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxSlots; ++q) {
    if (q < deg) {
      l[q] = expf(l[q] - mx);
      sum += l[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxSlots; ++q)
    if (q < deg)
      al[kMaxHeads * q + h] =
          __bfloat16_as_ushort(__float2bfloat16_rn(l[q] / sum));
}

// The four heads' bf16 alpha of this thread's A fragment elements at k step
// s (rows half, columns 2 tig + (q & 1) + 8 (q >> 1)): zeros off the row's
// graph and edges.
__device__ __forceinline__ void alpha_elements(
    uint2 (&v)[2][4], const uint16_t* alpha_s, const uint8_t* lut_s,
    const int (&rbase)[2], const int (&rj)[2], int row0, int s, int tig,
    int J, int S) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned jk = (unsigned)(16 * s + 2 * tig + (q & 1)
                                     + 8 * (q >> 1) - rbase[half]);
      const int slot = jk < (unsigned)J ? lut_s[rj[half] * J + jk] : kNoSlot;
      v[half][q] = make_uint2(0u, 0u);
      if (slot != kNoSlot)
        v[half][q] = *reinterpret_cast<const uint2*>(
            alpha_s + ((row0 + 8 * half) * S + slot) * kMaxHeads);
    }
  }
}

// A's bf16 entries of this thread's A fragment elements at k step s.
__device__ __forceinline__ void adjacency_elements(
    uint32_t (&e)[2][4], const uint16_t* aval_s, const int (&rbase)[2],
    const int (&rj)[2], int s, int tig, int J) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned jk = (unsigned)(16 * s + 2 * tig + (q & 1)
                                     + 8 * (q >> 1) - rbase[half]);
      e[half][q] = jk < (unsigned)J ? aval_s[rj[half] * J + jk] : 0u;
    }
  }
}

// -DA2M_TC_PROFILE (utils/edge_probe.py --dense, --bwd): thread 0 of each
// block adds the clock cycles from one point to the next to its phase's
// counter (a point after a barrier times the block, any other warp 0
// alone).
#ifdef A2M_TC_PROFILE
__device__ unsigned long long g_prof[1024][16];
#define PROF(ph)                                                    \
  if (tid == 0 && blockIdx.x < 1024) {                              \
    const long long now_ = clock64();                               \
    g_prof[blockIdx.x][ph] += now_ - t_prev_;                       \
    t_prev_ = now_;                                                 \
  }
#else
#define PROF(ph)
#endif

}  // namespace
