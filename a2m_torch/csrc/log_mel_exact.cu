// K2x: the exact-mode log-mel of feature extraction, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel a2m/audio/pallas_mel.py::_kernel with
// exact=True (:96-125: hi/lo-split f32 matrices at HIGHEST precision,
// precise_sqrt and precise_log, within 1e-5 of the float64 golden): framing
// of the waveform (centred and reflect-padded, or as it is) -> window ->
// real DFT of n_fft points -> power, or magnitude -> mel over the
// filterbank's nonzeros -> log(max(mel, c)) or log(mel + c).  f32 samples
// in, f32 out; the window, twiddles, FFT, split, power, mel and log in
// double (no fast math; CUDA's double log and sqrt are within an ulp or
// two, so a2m's precise_log and precise_sqrt need no counterpart).  K2, the
// fast mode, is log_mel.cu.
//
// Bound on the H100 at the data path's shapes (32 intervals of 60 s at
// 45.6 kHz: 171,008 frames of 2048, 128 mels over 2,013 nonzeros): ~11.2
// GFLOP by a real FFT, 0.167 ms at the 67 TFLOP/s fp64 rate of the tensor
// cores (the bound chip_smoke.py states) and 0.33 ms at the 34 TFLOP/s of
// the fp64 pipes outside them, which an FFT uses (as a product, a 16- or
// 32-point DFT costs ~10x its operations); ~438 MB of samples and output
// take 0.13 ms.  Bound by operations.  K2's radix-2 template run in double
// took 4.33 ms here: five shared-memory passes a frame of 2048 with
// conflicting twiddle and point accesses, one frame a block in 44 KB.  The
// design here:
// - a Stockham FFT of the m = n_fft / 2 packed complex points (even
//   samples real, odd imaginary) whose butterflies run in registers: a
//   thread holds 16 points (m / 16 threads a frame), passes of radix 16
//   and a last of radix 2, 4 or 8 (1024 = 16 x 16 x 4: two exchanges
//   through shared memory a frame);
// - the last pass hands each thread sub-butterflies i and p - i (p = m / R)
//   and so bins k and m - k: the real-input split and its post-twiddle run
//   from registers, each register giving its own bin; thread 0 holds the
//   self-paired 0 and p / 2 (a select of its partner registers, no branch);
// - twiddles: float64 tables built on the host (mel_kernel.exact_twiddles)
//   and held in shared memory, laid out so that consecutive threads read
//   consecutive entries: pass q reads exp(-2 pi i j k / (p R)) at
//   (j - 1) p + k; the split's exp(-pi i k / m) at the sub-butterfly,
//   times a constant exp(-pi i j / R);
// - exchanges of 16-byte points: the first (pass 1 writes points 16
//   apart) pads one slot every 16 points; later exchanges (the last pass
//   reads half its slots backwards, across those pads) are linear: every
//   8-thread wavefront hits 8 bank groups (tests/test_torch_mel_exact_fft
//   .py counts them), and a thread's addresses are a base plus constants;
// - a block of up to 6 groups of 64 threads, one block an SM, each group
//   64 / (m / 16) frames at a time (one at n_fft 2048, four at 512), with
//   named barriers of its own; each frame's lane walks a contiguous range
//   of the frames of all rows, so consecutive frames of one row follow one
//   another: the hop of samples the next frame adds (or all of it, where
//   hop >= frame_len) comes in by cp.async into a ring of frame_len + hop
//   floats (10 KB at n_fft 2048: six groups fit) while the current frame
//   transforms, or the whole frame where the ring is free; frames that
//   reach the reflect pad or the signal's end, and a row's first where the
//   frame before it is still in the ring, take the index path;
// - the mel over the filterbank's nonzeros by a fixed schedule built on the
//   host (mel_kernel.mel_schedule): each of a frame's threads sums the
//   nonzeros of its m / TPF bins (8 steps' loads in flight) into partial
//   sums, which each mel adds in order; the bins sit one pad double every
//   16, so threads reading bins ~16 apart hit distinct banks.  No
//   atomics; every frame's bits depend only on its samples, reruns are
//   bit-equal.
//
// Layout: y (B, n_samples) f32; window (n_fft,) double, the window as the
// frame of n_fft points sees it; twiddle (exact_twiddles(n_fft)) double
// pairs; sched_w, sched_i (rows, a multiple of 8; m / 16 or 1) double and
// int32 (the bin's padded slot k + k / 16, the mel's parity at bit 15,
// (piece + 1) << 16 where a partial sum ends); pieces (n_mels + 1,) int32;
// out (B, n_frames, n_mels) f32.  n_fft a power of two from 4 to 2048,
// frame_len <= n_fft, n_mels <= 128.  Frame t starts at t * hop in the
// signal padded by `pad` samples of numpy's repeated reflection.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_mel_common.cuh"

namespace {

constexpr int kGroup = 64;        // threads of a group: two warps
constexpr int kMaxGroups = 6;     // groups of the block an SM holds
constexpr int kMaxFFT = 2048;
constexpr int kMaxMels = 128;

// the plan of mel_kernel.exact_plan for m = 2^L complex points
__host__ __device__ constexpr int n_passes(int L) {
  return L <= 4 ? 1 : L / 4 + 1;
}
__host__ __device__ constexpr int radix(int L, int q) {
  return L <= 4 ? 1 << L
         : L % 4 == 0 ? (q < L / 4 - 1 ? 16 : 4)
                      : (q < L / 4 ? 16 : 1 << (L % 4));
}
__host__ __device__ constexpr int points(int L) { return L < 4 ? 1 << L : 16; }
__host__ __device__ constexpr int tpf(int L) { return (1 << L) / points(L); }
// radices of the passes before pass q multiplied
__host__ __device__ constexpr int span(int L, int q) {
  int p = 1;
  for (int i = 0; i < q; ++i) p *= radix(L, i);
  return p;
}
// first entry of pass q's twiddle table (q = n_passes: the split's)
__host__ __device__ constexpr int tw_offset(int L, int q) {
  int o = 0;
  for (int i = 1; i < q; ++i) o += (radix(L, i) - 1) * span(L, i);
  return o;
}
__host__ __device__ constexpr int tw_entries(int L) {
  return tw_offset(L, n_passes(L)) +
         (1 << L) / radix(L, n_passes(L) - 1);
}

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return double2{a.x + b.x, a.y + b.y};
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return double2{a.x - b.x, a.y - b.y};
}
__device__ __forceinline__ double2 cmul(double2 a, double2 w) {
  return double2{a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x};
}

// exp(-2 pi i e / 32), symmetric by construction
__device__ __forceinline__ double2 w32(int e) {
  switch (e & 31) {
    case 1: return double2{0.9807852804032304, -0.19509032201612825};
    case 2: return double2{0.9238795325112867, -0.3826834323650898};
    case 3: return double2{0.8314696123025452, -0.5555702330196022};
    case 4: return double2{0.7071067811865476, -0.7071067811865476};
    case 5: return double2{0.5555702330196022, -0.8314696123025452};
    case 6: return double2{0.3826834323650898, -0.9238795325112867};
    case 7: return double2{0.19509032201612825, -0.9807852804032304};
    case 9: return double2{-0.19509032201612825, -0.9807852804032304};
    case 10: return double2{-0.3826834323650898, -0.9238795325112867};
    case 11: return double2{-0.5555702330196022, -0.8314696123025452};
    case 12: return double2{-0.7071067811865476, -0.7071067811865476};
    case 13: return double2{-0.8314696123025452, -0.5555702330196022};
    case 14: return double2{-0.9238795325112867, -0.3826834323650898};
    case 15: return double2{-0.9807852804032304, -0.19509032201612825};
    case 17: return double2{-0.9807852804032304, 0.19509032201612825};
    case 18: return double2{-0.9238795325112867, 0.3826834323650898};
    case 19: return double2{-0.8314696123025452, 0.5555702330196022};
    case 20: return double2{-0.7071067811865476, 0.7071067811865476};
    case 21: return double2{-0.5555702330196022, 0.8314696123025452};
    case 22: return double2{-0.3826834323650898, 0.9238795325112867};
    case 23: return double2{-0.19509032201612825, 0.9807852804032304};
    case 25: return double2{0.19509032201612825, 0.9807852804032304};
    case 26: return double2{0.3826834323650898, 0.9238795325112867};
    case 27: return double2{0.5555702330196022, 0.8314696123025452};
    case 28: return double2{0.7071067811865476, 0.7071067811865476};
    case 29: return double2{0.8314696123025452, 0.5555702330196022};
    case 30: return double2{0.9238795325112867, 0.3826834323650898};
    case 31: return double2{0.9807852804032304, 0.19509032201612825};
  }
  return double2{1.0, 0.0};
}

// a * exp(-2 pi i e / 32); exact for e a multiple of 8 (e is a constant
// after unrolling, so the branches fold)
__device__ __forceinline__ double2 rot32(double2 a, int e) {
  e &= 31;
  if (e == 0) return a;
  if (e == 8) return double2{a.y, -a.x};
  if (e == 16) return double2{-a.x, -a.y};
  if (e == 24) return double2{-a.y, a.x};
  return cmul(a, w32(e));
}

// DFT of R points in registers, natural order in and out
template <int R>
struct Dft {  // R = 8 or 16: R1-point DFTs, twiddles, R2-point DFTs
  __device__ __forceinline__ static void run(double2* a) {
    constexpr int R1 = R == 16 ? 4 : 2, R2 = R / R1;
    double2 b[R];
#pragma unroll
    for (int n2 = 0; n2 < R2; ++n2) {
      double2 c[R1];
#pragma unroll
      for (int n1 = 0; n1 < R1; ++n1) c[n1] = a[R2 * n1 + n2];
      Dft<R1>::run(c);
#pragma unroll
      for (int k1 = 0; k1 < R1; ++k1)
        b[n2 * R1 + k1] = rot32(c[k1], (32 / R) * n2 * k1);
    }
#pragma unroll
    for (int k1 = 0; k1 < R1; ++k1) {
      double2 c[R2];
#pragma unroll
      for (int n2 = 0; n2 < R2; ++n2) c[n2] = b[n2 * R1 + k1];
      Dft<R2>::run(c);
#pragma unroll
      for (int k2 = 0; k2 < R2; ++k2) a[k1 + R1 * k2] = c[k2];
    }
  }
};
template <>
struct Dft<1> {
  __device__ __forceinline__ static void run(double2*) {}
};
template <>
struct Dft<2> {
  __device__ __forceinline__ static void run(double2* a) {
    const double2 t = a[0];
    a[0] = cadd(t, a[1]);
    a[1] = csub(t, a[1]);
  }
};
template <>
struct Dft<4> {
  __device__ __forceinline__ static void run(double2* a) {
    const double2 t0 = cadd(a[0], a[2]), t1 = csub(a[0], a[2]);
    const double2 t2 = cadd(a[1], a[3]), t3 = csub(a[1], a[3]);
    a[0] = cadd(t0, t2);
    a[2] = csub(t0, t2);
    a[1] = double2{t1.x + t3.y, t1.y - t3.x};
    a[3] = double2{t1.x - t3.y, t1.y + t3.x};
  }
};

// sub-butterfly of slot s of frame-thread t (tests/test_torch_mel_exact_fft
// .py::sub): t + tpf s before the last pass; in the last pass slot 2v is
// t + 2 tpf v and slot 2v + 1 is p - t - 2 tpf v, thread 0's 2 tpf v and
// tpf (S - 1 - 2v)
template <int L, bool kLast>
__device__ __forceinline__ int sub_butterfly(int t, int s) {
  constexpr int TPF = tpf(L);
  if constexpr (!kLast || TPF == 1) {
    return t + TPF * s;
  } else {
    constexpr int R = radix(L, n_passes(L) - 1), p = (1 << L) / R;
    constexpr int S = points(L) / R;
    const int v = s >> 1;
    if (s & 1) return t ? p - t - 2 * TPF * v : TPF * (S - 1 - 2 * v);
    return t + 2 * TPF * v;
  }
}

// 16-byte slot of point a in an exchange (see the design notes above):
// the first pads one slot every 16 points, later ones are linear (both
// keep a thread's addresses a base plus constants)
template <bool kFirst>
__device__ __forceinline__ int xslot(int a) {
  return kFirst ? a + (a >> 4) : a;
}

// the register (s2, j2) of the same thread that holds bin m - k
template <int S, int R, bool kT0>
__device__ __forceinline__ void partner(int s, int j, int& s2, int& j2) {
  j2 = R - 1 - j;
  if (!kT0) {
    s2 = S > 1 ? s ^ 1 : s;
  } else if (s & 1) {
    s2 = 2 * (S / 2 - 1 - (s >> 1)) + 1;
  } else if (s == 0) {
    s2 = 0;
    j2 = (R - j) % R;
  } else {
    s2 = 2 * (S / 2 - (s >> 1));
  }
}

// power (or magnitude) of bin k from a = Z[k], c = Z[m - k], w = W^k
__device__ __forceinline__ double bin_power(double2 a, double2 c, double2 w,
                                            int magnitude) {
  const double er = 0.5 * (a.x + c.x), ei = 0.5 * (a.y - c.y);
  const double o_r = 0.5 * (a.y + c.y), o_i = -0.5 * (a.x - c.x);
  const double xr = er + (w.x * o_r - w.y * o_i);
  const double xi = ei + (w.x * o_i + w.y * o_r);
  const double p = xr * xr + xi * xi;
  return magnitude ? sqrt(p) : p;
}

__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kGroup) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// slot x of a ring of `cap` floats, for x < 2 cap
__device__ __forceinline__ int wrap(int x, int cap) {
  return x < cap ? x : x - cap;
}

// copy n samples from src into ring slots r0, r0 + 1, ... (mod cap, a
// multiple of 4) by the TPF threads of a frame: 16-byte copies where src
// and the slot share their place in 16 bytes, single samples at the ends
// and elsewhere
template <int TPF>
__device__ __forceinline__ void copy_span(float* ring, int cap, int r0,
                                          const float* src, int n, int t) {
  const int phase = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  int head = n;
  if (((phase - r0) & 3) == 0) head = min((4 - phase) & 3, n);
  for (int i = t; i < head; i += TPF)
    cp_async4(ring + wrap(r0 + i, cap), src + i);
  if (head == n) return;
  const int body = (n - head) >> 2;
  for (int c = t; c < body; c += TPF)
    cp_async16(ring + wrap(r0 + head + 4 * c, cap), src + head + 4 * c);
  for (int i = head + 4 * body + t; i < n; i += TPF)
    cp_async4(ring + wrap(r0 + i, cap), src + i);
}

struct Params {
  const float* y;
  float* out;
  const double* window;
  const double2* twiddle;
  const double* sched_w;
  const int* sched_i;
  const int* pieces;
  long long n_rows;  // frames of all rows
  int n_frames, n_samples, frame_len, hop, pad, n_mels, sched_rows;
  int magnitude, log_offset;
  double log_const;
  // shared memory: tables, then `groups` groups of rings (`ring` floats a
  // frame) and exchanges (`region` doubles a frame)
  int groups, ring, region, off_tw, off_sw, off_si, off_pc, off_groups;
  int ring_bytes, group_bytes;
};

// where frame tf of a row starts in its signal, and whether all its
// samples lie inside the signal
struct Loc {
  int row, tf;
  long long st;
  bool inside;
};
__device__ __forceinline__ Loc locate(int row, int tf, const Params& a) {
  const long long st = (long long)tf * a.hop - a.pad;
  return Loc{row, tf, st, st >= 0 && st + a.frame_len <= a.n_samples};
}
// the frame after l in the frames of all rows
__device__ __forceinline__ Loc next_frame(const Loc& l, const Params& a) {
  return l.tf + 1 < a.n_frames ? locate(l.row, l.tf + 1, a)
                               : locate(l.row + 1, 0, a);
}

// windowed sample n of a frame starting at st in the signal (the index
// path: the reflect pad and the zeros past the padded end or frame_len)
__device__ __forceinline__ double windowed(const float* __restrict__ yrow,
                                           double w, long long st, int n,
                                           const Params& a) {
  const long long s = st + n;
  if (n >= a.frame_len || s >= (long long)a.n_samples + a.pad) return 0.0;
  const long idx = (s < 0 || s >= a.n_samples) ? reflect(s, a.n_samples) : s;
  return (double)__ldg(yrow + idx) * w;
}

// -DA2M_MEL_PROFILE (utils/mel_probe.py): thread 0 of each block adds the
// clock cycles from one point of its frame loop to the next to a counter
// per phase (after a group barrier: the group's time; else thread 0's)
#ifdef A2M_MEL_PROFILE
__device__ unsigned long long g_prof[1024][8];
#define PROF(ph)                                                    \
  if (threadIdx.x == 0 && blockIdx.x < 1024) {                      \
    const long long now_ = clock64();                               \
    g_prof[blockIdx.x][ph] += now_ - t_prev_;                       \
    t_prev_ = now_;                                                 \
  }
#else
#define PROF(ph)
#endif

// pass Q > 0: read the exchange into registers (slot s, point j of the
// sub-butterfly at v[s R + j])
template <int L, int Q>
__device__ __forceinline__ void read_pass(double2* v, const double2* xc,
                                          int t) {
  constexpr int R = radix(L, Q), m = 1 << L, S = points(L) / R;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = sub_butterfly<L, Q == n_passes(L) - 1>(t, s);
#pragma unroll
    for (int j = 0; j < R; ++j)
      v[s * R + j] = xc[xslot<Q == 1>(i + (m / R) * j)];
  }
}

// pass Q > 0: twiddles from the table, then the DFTs
template <int L, int Q>
__device__ __forceinline__ void twiddle_dft(double2* v, const double2* tw,
                                            int t) {
  constexpr int R = radix(L, Q), p = span(L, Q), S = points(L) / R;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = sub_butterfly<L, Q == n_passes(L) - 1>(t, s) & (p - 1);
#pragma unroll
    for (int j = 1; j < R; ++j)
      v[s * R + j] =
          cmul(v[s * R + j], tw[tw_offset(L, Q) + (j - 1) * p + k]);
    Dft<R>::run(v + s * R);
  }
}

// pass Q (not the last): Stockham's output order into exchange Q
template <int L, int Q>
__device__ __forceinline__ void write_pass(const double2* v, double2* xc,
                                           int t) {
  constexpr int R = radix(L, Q), p = span(L, Q), S = points(L) / R;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = t + tpf(L) * s, k = i & (p - 1);
    const int base = (i - k) * R + k;
#pragma unroll
    for (int j = 0; j < R; ++j)
      xc[xslot<Q == 0>(base + j * p)] = v[s * R + j];
  }
}

// slot of bin k among the m + 1 bins: one pad double every 16 bins, so
// that the mel's threads, which read bins ~16 apart step by step, hit distinct
// banks (the schedule's indices carry the padded slot)
__device__ __forceinline__ int bin_slot(int k) { return k + (k >> 4); }

// the real-input split from registers: every register's bin k, X[k] = E +
// W^k O with E = (Z[k] + conj Z[m-k]) / 2, O = (Z[k] - conj Z[m-k]) / 2i,
// W = exp(-pi i / m), Z[m - k] in the register `partner` names (thread 0's
// own pairing picked by a select, not a branch); then power or magnitude
// into pw; thread 0 also writes bin m from Z[0]
template <int L>
__device__ __forceinline__ void split(const double2* v, const double2* tw,
                                      double* pw, int t, int magnitude) {
  constexpr int m = 1 << L, R = radix(L, n_passes(L) - 1), p = m / R;
  constexpr int S = points(L) / R;
  const bool t0 = t == 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = sub_butterfly<L, true>(t, s);
    const double2 ws = tw[tw_offset(L, n_passes(L)) + i];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      int s0, j0, s1, j1;
      partner<S, R, true>(s, j, s0, j0);
      partner<S, R, false>(s, j, s1, j1);
      const double2 c = t0 ? v[s0 * R + j0] : v[s1 * R + j1];
      const double2 w = rot32(ws, 16 / R * j);  // W^k = W^i exp(-pi i j/R)
      pw[bin_slot(i + p * j)] = bin_power(v[s * R + j], c, w, magnitude);
    }
  }
  if (t0)
    pw[bin_slot(m)] = bin_power(v[0], v[0], double2{-1.0, 0.0}, magnitude);
}

template <int L>
__global__ void __launch_bounds__(kGroup* kMaxGroups, 1)
    log_mel_exact_kernel(const Params a) {
  constexpr int m = 1 << L, n_fft = 2 * m, P = points(L), TPF = tpf(L);
  constexpr int LANES = kGroup / TPF, NP = n_passes(L);
  static_assert(NP <= 3, "n_fft above 2048");
  extern __shared__ __align__(16) unsigned char smem[];
  double* win = reinterpret_cast<double*>(smem);
  double2* tw = reinterpret_cast<double2*>(smem + a.off_tw);
  double* schw = reinterpret_cast<double*>(smem + a.off_sw);
  int* schi = reinterpret_cast<int*>(smem + a.off_si);
  int* pieces = reinterpret_cast<int*>(smem + a.off_pc);
  const int tid = threadIdx.x;
  for (int i = tid; i < n_fft; i += blockDim.x) win[i] = a.window[i];
  for (int i = tid; i < tw_entries(L); i += blockDim.x) tw[i] = a.twiddle[i];
  for (int i = tid; i < a.sched_rows * TPF; i += blockDim.x) {
    schw[i] = a.sched_w[i];
    schi[i] = a.sched_i[i];
  }
  for (int i = tid; i <= a.n_mels; i += blockDim.x) pieces[i] = a.pieces[i];
  __syncthreads();

  const int g = tid / kGroup, lane = tid % kGroup / TPF, t = tid % TPF;
  unsigned char* gb = smem + a.off_groups + g * a.group_bytes;
  const int cap = a.ring;
  float* ring = reinterpret_cast<float*>(gb) + lane * cap;
  double* xs = reinterpret_cast<double*>(gb + a.ring_bytes) + lane * a.region;
  double2* xc = reinterpret_cast<double2*>(xs);
  // partial mel sums after the m + 1 bins (padded, see bin_slot)
  double* part = xs + bin_slot(m) + 1;

  // this lane's contiguous range of the frames of all rows
  const long long lanes = (long long)gridDim.x * a.groups * LANES;
  const long long w = ((long long)blockIdx.x * a.groups + g) * LANES + lane;
  const long long f_begin = w * a.n_rows / lanes;
  const long long f_end = (w + 1) * a.n_rows / lanes;
  const int iters = (int)((a.n_rows + lanes - 1) / lanes);

  // the current frame (the range's first: one division, then steps), the
  // ring slot of its first sample, and whether the ring holds it
  const int row0 = (int)(f_begin / a.n_frames);
  Loc cur = locate(row0, (int)(f_begin - (long long)row0 * a.n_frames), a);
  int r_cur = 0;
  bool ring_cur = false;
  if (f_begin < f_end && cur.inside && a.frame_len >= 2) {
    copy_span<TPF>(ring, cap, 0,
                   a.y + (size_t)cur.row * a.n_samples + cur.st,
                   a.frame_len, t);
    ring_cur = true;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#ifdef A2M_MEL_PROFILE
  long long t_prev_ = clock64();
#endif

  for (int it = 0; it < iters; ++it) {
    const long long f = f_begin + it;
    const bool active = f < f_end;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    group_sync(g);
    PROF(0)
    const float* yrow = a.y + (size_t)(active ? cur.row : 0) * a.n_samples;
    const Loc nx = next_frame(cur, a);

    // the next frame's samples come in while this one transforms: the hop
    // it adds to this frame's (the ring holds frame_len + hop), or all of
    // its frame_len where the ring is free or holds two frames (hop >=
    // frame_len); else (a row's first frame after one in the ring) it
    // takes the index path
    int r_next = r_cur;
    bool ring_next = false;
    if (active && f + 1 < f_end && nx.inside && a.frame_len >= 2) {
      if (ring_cur && nx.row == cur.row && a.hop < a.frame_len) {
        r_next = wrap(r_cur + a.hop, cap);
        copy_span<TPF>(ring, cap, wrap(r_cur + a.frame_len, cap),
                       yrow + cur.st + a.frame_len, a.hop, t);
        ring_next = true;
      } else if (!ring_cur || cap >= 2 * a.frame_len) {
        r_next = ring_cur ? wrap(r_cur + a.frame_len, cap) : 0;
        copy_span<TPF>(ring, cap, r_next,
                       a.y + (size_t)nx.row * a.n_samples + nx.st,
                       a.frame_len, t);
        ring_next = true;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // gather: thread t's points t + TPF c, windowed, packed
    double2 v[P];
    if (!active) {
#pragma unroll
      for (int c = 0; c < P; ++c) v[c] = double2{0.0, 0.0};
    } else if (ring_cur) {
      // loads from slots inside the frame's samples (n0 clamped to the
      // last pair), zeros past frame_len chosen after them
      const int last = (a.frame_len - 2) & ~1;
      float2 q[P];
      if (!(r_cur & 1)) {  // sample pairs are float2
#pragma unroll
        for (int c = 0; c < P; ++c) {
          const int n0 = min(2 * (t + TPF * c), last);
          q[c] = *reinterpret_cast<const float2*>(ring + wrap(r_cur + n0, cap));
        }
      } else {
#pragma unroll
        for (int c = 0; c < P; ++c) {
          const int n0 = min(2 * (t + TPF * c), last);
          q[c] = float2{ring[wrap(r_cur + n0, cap)],
                        ring[wrap(r_cur + n0 + 1, cap)]};
        }
      }
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const int n0 = 2 * (t + TPF * c);
        const double2 wn = *reinterpret_cast<const double2*>(win + n0);
        v[c] = double2{n0 < a.frame_len ? (double)q[c].x * wn.x : 0.0,
                       n0 + 1 < a.frame_len ? (double)q[c].y * wn.y : 0.0};
      }
    } else {
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const int n0 = 2 * (t + TPF * c);
        v[c] = double2{windowed(yrow, win[n0], cur.st, n0, a),
                       windowed(yrow, win[n0 + 1], cur.st, n0 + 1, a)};
      }
    }
    PROF(1)

    Dft<radix(L, 0)>::run(v);
    if constexpr (NP >= 2) {
      write_pass<L, 0>(v, xc, t);
      group_sync(g);
      PROF(2)
      read_pass<L, 1>(v, xc, t);
      group_sync(g);
      twiddle_dft<L, 1>(v, tw, t);
      if constexpr (NP == 3) {
        write_pass<L, 1>(v, xc, t);
        group_sync(g);
        PROF(3)
        read_pass<L, 2>(v, xc, t);
        group_sync(g);
        twiddle_dft<L, 2>(v, tw, t);
      }
    }
    PROF(4)

    split<L>(v, tw, xs, t, a.magnitude);
    group_sync(g);
    PROF(5)

    // the mel: this thread's bins' nonzeros, two running sums picked by
    // the mel's parity (a bin lies in at most two adjacent filters), a
    // partial sum stored where a mel's last nonzero in these bins lies; 8
    // steps' loads in flight at a time (the schedule's rows come in
    // multiples of 8)
    if (active) {
      double acc0 = 0.0, acc1 = 0.0;
      for (int q0 = 0; q0 < a.sched_rows; q0 += 8) {
        int idx[8];
        double wt[8], pv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          idx[u] = schi[(q0 + u) * TPF + t];
          wt[u] = schw[(q0 + u) * TPF + t];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) pv[u] = xs[idx[u] & 0x7fff];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const bool odd = idx[u] & 0x8000;
          const double sum = fma(pv[u], wt[u], odd ? acc1 : acc0);
          const int end = idx[u] >> 16;
          if (end) part[end - 1] = sum;
          const double next = end ? 0.0 : sum;
          acc0 = odd ? acc0 : next;
          acc1 = odd ? next : acc1;
        }
      }
    }
    group_sync(g);
    PROF(6)
    if (active) {  // mels t and t + TPF at a time: two logs in flight
      for (int j = t; j < a.n_mels; j += 2 * TPF) {
        const int j2 = j + TPF < a.n_mels ? j + TPF : j;
        double mel = 0.0, mel2 = 0.0;
        for (int k = pieces[j]; k < pieces[j + 1]; ++k) mel += part[k];
        for (int k = pieces[j2]; k < pieces[j2 + 1]; ++k) mel2 += part[k];
        mel = a.log_offset ? log(mel + a.log_const)
                           : log(fmax(mel, a.log_const));
        mel2 = a.log_offset ? log(mel2 + a.log_const)
                            : log(fmax(mel2, a.log_const));
        a.out[(size_t)f * a.n_mels + j] = (float)mel;
        a.out[(size_t)f * a.n_mels + j2] = (float)mel2;
      }
    }
    PROF(7)
    cur = nx;
    r_cur = r_next;
    ring_cur = ring_next;
  }
}

__host__ int align16(int bytes) { return (bytes + 15) & ~15; }

// shared-memory layout and groups a block for m = 2^L points (groups 0:
// the most that fit, else as given)
template <int L>
Params layout(int n_mels, int sched_rows, int frame_len, int hop,
              int max_smem) {
  constexpr int m = 1 << L, TPF = tpf(L), LANES = kGroup / TPF;
  Params a{};
  // a frame and the hop the next one adds, or two frames
  a.ring = (frame_len + (hop < frame_len ? hop : frame_len) + 3) & ~3;
  a.off_tw = align16(8 * 2 * m);
  a.off_sw = a.off_tw + align16(16 * tw_entries(L));
  a.off_si = a.off_sw + align16(8 * sched_rows * TPF);
  a.off_pc = a.off_si + align16(4 * sched_rows * TPF);
  a.off_groups = a.off_pc + align16(4 * (n_mels + 1));
  // padded bins and partial sums (at most n_mels + 2 (TPF - 1) pieces)
  // after the FFT
  const int bins = m + 1 + (m >> 4) + n_mels + 2 * TPF;
  const int points2 = 2 * (m + (m >> 4));  // the padded first exchange
  const int region = points2 > bins ? points2 : bins;
  a.region = (region + 1) & ~1;
  a.ring_bytes = LANES * a.ring * 4;
  a.group_bytes = a.ring_bytes + LANES * a.region * 8;
  int groups = (max_smem - a.off_groups) / a.group_bytes;
  a.groups = groups < kMaxGroups ? groups : kMaxGroups;
  return a;
}

template <int L>
int smem_bytes(const Params& a) {
  return a.off_groups + a.groups * a.group_bytes;
}

// the launch plan of m = 2^L: groups and shared bytes a block, blocks an
// SM, and the card's SMs
template <int L>
int plan(int n_mels, int sched_rows, int frame_len, int hop, Params* a,
         int* sms, int* per_sm) {
  static int dev_sms = 0, max_smem = 0;
  if (!dev_sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&dev_sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaError_t err = cudaFuncSetAttribute(
        log_mel_exact_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_smem);
    if (err != cudaSuccess) {
      dev_sms = 0;
      return (int)err;
    }
  }
  *a = layout<L>(n_mels, sched_rows, frame_len, hop, max_smem);
  *per_sm = 0;
  while (a->groups >= 1) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, log_mel_exact_kernel<L>, a->groups * kGroup, smem_bytes<L>(*a));
    if (err != cudaSuccess) return (int)err;
    if (*per_sm > 0) break;
    --a->groups;
  }
  if (a->groups < 1) return (int)cudaErrorInvalidConfiguration;
  *sms = dev_sms;
  return 0;
}

template <int L>
int launch(Params a, int batch, cudaStream_t stream) {
  constexpr int LANES = kGroup / tpf(L);
  Params p;
  int sms = 0, per_sm = 0;
  const int err = plan<L>(a.n_mels, a.sched_rows, a.frame_len, a.hop, &p,
                          &sms, &per_sm);
  if (err) return err;
  a.groups = p.groups;
  a.ring = p.ring;
  a.region = p.region;
  a.off_tw = p.off_tw;
  a.off_sw = p.off_sw;
  a.off_si = p.off_si;
  a.off_pc = p.off_pc;
  a.off_groups = p.off_groups;
  a.ring_bytes = p.ring_bytes;
  a.group_bytes = p.group_bytes;
  a.n_rows = (long long)batch * a.n_frames;
  const long long per_block = (long long)a.groups * LANES;
  const long long need = (a.n_rows + per_block - 1) / per_block;
  const int grid = need < sms ? (int)need : sms;
  log_mel_exact_kernel<L><<<grid, a.groups * kGroup, smem_bytes<L>(a),
                            stream>>>(a);
  return (int)cudaGetLastError();
}

template <int L>
int info(int n_mels, int sched_rows, int frame_len, int hop, int* out) {
  Params a;
  int sms = 0, per_sm = 0;
  const int err = plan<L>(n_mels, sched_rows, frame_len, hop, &a, &sms,
                          &per_sm);
  if (err) return err;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, log_mel_exact_kernel<L>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.groups * (kGroup / tpf(L));  // frames a block at a time
  out[1] = a.groups * kGroup;             // threads a block
  out[2] = smem_bytes<L>(a);              // dynamic shared bytes
  out[3] = per_sm;                        // blocks an SM
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;      // spills
  out[6] = sms;                           // blocks (at most) a launch
  out[7] = tpf(L);                        // threads a frame
  return 0;
}

#define A2M_FOR_L(F, ...)                  \
  switch (log2m) {                         \
    case 1: return F<1>(__VA_ARGS__);      \
    case 2: return F<2>(__VA_ARGS__);      \
    case 3: return F<3>(__VA_ARGS__);      \
    case 4: return F<4>(__VA_ARGS__);      \
    case 5: return F<5>(__VA_ARGS__);      \
    case 6: return F<6>(__VA_ARGS__);      \
    case 7: return F<7>(__VA_ARGS__);      \
    case 8: return F<8>(__VA_ARGS__);      \
    case 9: return F<9>(__VA_ARGS__);      \
    case 10: return F<10>(__VA_ARGS__);    \
  }                                        \
  return (int)cudaErrorInvalidValue;

int check_fft(int n_fft, int n_mels, int sched_rows) {
  if (n_fft < 4 || n_fft > kMaxFFT || (n_fft & (n_fft - 1)) || n_mels < 1 ||
      n_mels > kMaxMels || sched_rows < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// K2x: f32 samples in, float64 tables and arithmetic, f32 out
int a2m_log_mel_exact(const void* y, void* out, const void* window,
                      const void* twiddle, const void* sched_w,
                      const void* sched_i, const void* pieces, int batch,
                      int n_samples, int frame_len, int hop, int pad,
                      int n_frames, int n_fft, int n_mels, int sched_rows,
                      int magnitude, int log_offset, double log_const,
                      void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  if (check_fft(n_fft, n_mels, sched_rows) || frame_len < 1 ||
      frame_len > n_fft || n_samples < 1 || pad < 0 || hop < 0 ||
      (long long)batch * n_frames > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params a{};
  a.y = (const float*)y;
  a.out = (float*)out;
  a.window = (const double*)window;
  a.twiddle = (const double2*)twiddle;
  a.sched_w = (const double*)sched_w;
  a.sched_i = (const int*)sched_i;
  a.pieces = (const int*)pieces;
  a.n_frames = n_frames;
  a.n_samples = n_samples;
  a.frame_len = frame_len;
  a.hop = hop;
  a.pad = pad;
  a.n_mels = n_mels;
  a.sched_rows = sched_rows;
  a.magnitude = magnitude;
  a.log_offset = log_offset;
  a.log_const = log_const;
  const int log2m = __builtin_ctz(n_fft) - 1;
  A2M_FOR_L(launch, a, batch, (cudaStream_t)stream)
}

// K2x's launch plan at n_fft, frame_len and hop: out[8] = frames a block,
// threads a block, dynamic shared bytes, blocks an SM, registers, local
// (spill) bytes, blocks a launch at most, threads a frame
int a2m_log_mel_exact_info(int n_fft, int n_mels, int sched_rows,
                           int frame_len, int hop, void* out) {
  if (check_fft(n_fft, n_mels, sched_rows) || frame_len < 1 ||
      frame_len > n_fft || hop < 0)
    return (int)cudaErrorInvalidValue;
  const int log2m = __builtin_ctz(n_fft) - 1;
  A2M_FOR_L(info, n_mels, sched_rows, frame_len, hop, (int*)out)
}

#ifdef A2M_MEL_PROFILE
// The phase counters (1024 blocks x 8 phases, cycles) into out; reset.
int a2m_log_mel_exact_profile(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
int a2m_log_mel_exact_profile_reset() {
  static unsigned long long zero[1024][8];
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif

const char* a2m_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
