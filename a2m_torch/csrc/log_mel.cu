// K2: the fused log-mel frontend of serving by FFT, CUDA C++ for sm_90a, in
// float (the kernel template's one instantiation).
//
// Replaces the Pallas TPU kernel a2m/audio/pallas_mel.py::_kernel (called by
// pallas_log_mel) in its fast mode (exact=False): framing of the waveform
// (centred and reflect-padded, or as it is) -> window -> real DFT of n_fft
// points -> power re^2 + im^2, or its square root (magnitude) -> mel
// projection -> log(max(mel, c)) or log(mel + c).  The Pallas kernel runs the DFT as two
// dense products because the TPU has no FFT; here it is a radix-2 FFT in
// shared memory.  It covers the three frontend families: log_mel_512
// (n_fft 2048, 1025 bins, 128 mels, power, eps log), log_mel_400 (frames of
// 512 with the window of 400 centred inside, 257 bins, 64 mels, magnitude,
// eps log) and VGGish (frames of 400 zero-padded to 512, htk mels, offset
// log).  A stack of frames cut by the client is a signal with hop =
// frame_len and no pad, and gives the same bits as the waveform it was cut
// from: a frame's arithmetic depends only on its samples.
//
// Bound on the H100: at the main-path shapes (B = 128, T = 64 frames of
// n_fft = 2048, 128 mels over 2,013 filterbank nonzeros) the function needs
// ~0.54 GFLOP (real FFT, window, power, mel over its nonzeros, log; 0.008 ms
// at the 67 TFLOP/s fp32 rate) against ~71 MB of frame samples and output
// (0.021 ms at 3.35 TB/s): it is bound by device memory.  The direct DFT of
// the Pallas kernel did ~71 GFLOP (~130x).  What the design does about it:
// - neither the frames nor the spectrum go to device memory; the waveform
//   is read once (frames that overlap share it through L1/L2) and the
//   (T, n_mels) output written once;
// - a frame of n_fft real samples is packed into n_fft/2 complex points
//   (even samples real, odd imaginary), gathered straight from the unpadded
//   waveform (float2 loads where the frame lies inside the signal; at its
//   ends the reflect pad is index arithmetic, and samples past the padded
//   end or past frame_len read as zero) into bit-reversed order, then
//   log2(n_fft/2) radix-2 decimation-in-time stages in shared memory, two
//   stages a pass over 4 points a thread (5 passes and barriers at n_fft
//   2048), then the real-input split with the post-twiddle gives bins
//   0..n_fft/2, a thread taking bins k and n_fft/2 - k together;
// - the twiddles exp(-2 pi i k / n_fft), k < n_fft/2, are a table built in
//   float64 on the host and rounded to f32 (no __sinf/__cosf, no fast
//   math): the tolerance is 1e-4 in log units; the stage of half-size h
//   reads entry j * n_fft / (2h);
// - complex points sit in shared memory under an XOR swizzle inside runs of
//   16 (sw below), which keeps the bit-reversed stores and the passes free
//   of bank conflicts;
// - the mel projection runs over each mel's nonzero bins only (a first bin,
//   a count and an offset into the weights, taken bit for bit from the
//   dense f32 matrix), summed in bin order: no atomics, bit-equal reruns;
// - a block of 256 threads holds 1024 complex points, i.e. one frame at
//   n_fft 2048 and four at 512 (frames of any batch row, in row-major
//   order), and walks over groups of frames with a grid stride, so the
//   twiddle table is loaded into shared memory once per block; 8 blocks an
//   SM (32 registers a thread), and the grid is the card's resident block
//   count or the number of groups, whichever is smaller.
// More stages a pass (8 points a thread), spreading a long mel over two
// threads, and the FFT's work across the card at B = 1 are later work.
//
// K2x, the exact mode (exact=True), is a kernel of its own designed for
// float64: log_mel_exact.cu.
//
// Layout: y (B, n_samples) f32; window (n_fft,) T, the window as the frame
// of n_fft points sees it (zero outside it); twiddle (n_fft/2,) T complex
// pairs; mel_bins (n_mels, 3) int32: first bin, bin count, offset into
// mel_weights (nnz,) T; out (B, n_frames, n_mels) f32; T is float.  n_fft
// is a power of two from 4 to 2048, frame_len <= n_fft, n_mels <= 128.  Frame t starts at t * hop in the signal padded by
// `pad` samples of reflection on each side (pad may be 0 or longer than the
// signal, hop smaller or larger than frame_len).  The reflection is numpy's
// mode='reflect': once the pad outgrows the signal it reflects again, with
// period 2 (n - 1), and a signal of one sample repeats.

#include <cuda_runtime.h>
#include <math.h>

#include "log_mel_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 1024;              // complex points per block
constexpr int kMaxFFT = 2048;
constexpr int kMaxMels = 128;

// the compute type: its complex pair, its blocks an SM and its math
template <typename T> struct Real;
template <> struct Real<float> {
  using T2 = float2;
  static constexpr int kBlocksPerSM = 8;   // 32 registers a thread
  __device__ static float log(float x) { return ::logf(x); }
  __device__ static float sqrt(float x) { return ::sqrtf(x); }
  __device__ static float fma(float a, float b, float c) {
    return ::fmaf(a, b, c);
  }
  __device__ static float max(float a, float b) { return ::fmaxf(a, b); }
};

// log(mel + c) for the offset log, log(max(mel, c)) for the eps log
template <typename T>
__device__ __forceinline__ T take_log(T mel, int log_offset, T log_const) {
  return Real<T>::log(log_offset ? mel + log_const
                                 : Real<T>::max(mel, log_const));
}

// windowed sample n of the frame starting at s0 in the padded signal
template <typename T>
__device__ __forceinline__ T windowed(const float* __restrict__ yb,
                                      const T* __restrict__ window, long s0,
                                      int n, int frame_len, long padded,
                                      int pad, int n_samples) {
  long s = s0 + n;
  if (n >= frame_len || s >= padded) return T(0);
  s -= pad;
  if (s < 0 || s >= n_samples) s = reflect(s, n_samples);
  return (T)__ldg(yb + s) * __ldg(window + n);
}

// slot of complex point i in shared memory: a permutation inside each run
// of 16 points that keeps the bit-reversed stores, the stages' loads and
// stores and the split's reads free of bank conflicts (for K2's 8-byte
// points)
__device__ __forceinline__ int sw(int i) {
  return (i & ~15) | ((i ^ (i >> 2) ^ (i >> 6)) & 15);
}

template <typename T2>
__device__ __forceinline__ T2 cmul(T2 a, T2 w) {
  return T2{a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x};
}

template <typename T2>
__device__ __forceinline__ T2 cadd(T2 a, T2 b) {
  return T2{a.x + b.x, a.y + b.y};
}

template <typename T2>
__device__ __forceinline__ T2 csub(T2 a, T2 b) {
  return T2{a.x - b.x, a.y - b.y};
}

// power (or magnitude) of bin k from a = Z[k], c = Z[m - k] and w = W^k
template <typename T, typename T2>
__device__ __forceinline__ T bin_power(T2 a, T2 c, T2 w, int magnitude) {
  const T half = T(0.5);
  const T er = half * (a.x + c.x), ei = half * (a.y - c.y);
  const T o_r = half * (a.y + c.y), o_i = -half * (a.x - c.x);
  const T xr = er + (w.x * o_r - w.y * o_i);
  const T xi = ei + (w.x * o_i + w.y * o_r);
  const T p = xr * xr + xi * xi;
  return magnitude ? Real<T>::sqrt(p) : p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Real<T>::kBlocksPerSM)
log_mel_fft_kernel(const float* __restrict__ y, float* __restrict__ out,
                   const T* __restrict__ window,
                   const typename Real<T>::T2* __restrict__ twiddle,
                   const int* __restrict__ mel_bins,
                   const T* __restrict__ mel_weights, int n_rows,
                   int n_frames, int n_samples, int frame_len, int hop,
                   int pad, int log2m, int n_mels, int magnitude,
                   int log_offset, T log_const) {
  using T2 = typename Real<T>::T2;
  __shared__ T2 z[kPoints];                // packed frames, then spectra
  __shared__ T2 tw[kMaxFFT / 2];
  __shared__ T pw[kPoints + kPoints / 2];  // fb * (m + 1) bins
  const int tid = threadIdx.x;
  const int m = 1 << log2m;                // complex points per frame
  const int fb = kPoints >> log2m;         // frames per block
  const int k_bins = m + 1;
  const long padded = (long)n_samples + 2L * pad;
  const int groups = (n_rows + fb - 1) / fb;

  for (int i = tid; i < m; i += kThreads) tw[i] = twiddle[i];

  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int row0 = g * fb;
    // gather, window, pack even/odd samples as complex, bit-reversed
    for (int i = tid; i < fb * m; i += kThreads) {
      const int f = i >> log2m, p = i & (m - 1);
      const int row = row0 + f;
      T2 v{T(0), T(0)};
      if (row < n_rows) {
        const int b = row / n_frames, t = row - b * n_frames;
        const float* yb = y + (size_t)b * n_samples;
        const long s0 = (long)t * hop;
        const long st = s0 - pad;          // frame start in the signal
        if (st >= 0 && st + frame_len <= n_samples && !(frame_len & 1) &&
            !(reinterpret_cast<size_t>(yb + st) & 7)) {
          // inside the signal, sample pairs 8-byte aligned: float2 loads
          if (2 * p < frame_len) {
            const float2 x = __ldg(reinterpret_cast<const float2*>(yb + st)
                                   + p);
            const T2 w = __ldg(reinterpret_cast<const T2*>(window) + p);
            v = T2{(T)x.x * w.x, (T)x.y * w.y};
          }
        } else {
          v.x = windowed(yb, window, s0, 2 * p, frame_len, padded, pad,
                         n_samples);
          v.y = windowed(yb, window, s0, 2 * p + 1, frame_len, padded, pad,
                         n_samples);
        }
      }
      z[sw((f << log2m) + (__brev(p) >> (32 - log2m)))] = v;
    }
    __syncthreads();

    // radix-2 decimation-in-time stages, half-size h = 2^s; stages s and
    // s + 1 run as one pass over 4 points (the same operations in the
    // same order), after a lone first stage when log2(m) is odd
    int s = 0;
    if (log2m & 1) {                       // stage 0 alone: h = 1, W^0
      for (int i = tid; i < fb * m / 2; i += kThreads) {
        const T2 a = z[sw(2 * i)];
        const T2 c = cmul(z[sw(2 * i + 1)], tw[0]);
        z[sw(2 * i)] = cadd(a, c);
        z[sw(2 * i + 1)] = csub(a, c);
      }
      __syncthreads();
      s = 1;
    }
    for (; s < log2m; s += 2) {
      const int h = 1 << s;
      for (int i = tid; i < fb * m / 4; i += kThreads) {
        const int f = i >> (log2m - 2), q = i & (m / 4 - 1);
        const int j = q & (h - 1);
        const int i0 = (f << log2m) + ((q >> s) << (s + 2)) + j;
        const T2 w1 = tw[j << (log2m - s)];
        const T2 w2 = tw[j << (log2m - s - 1)];
        const T2 w3 = tw[(j + h) << (log2m - s - 1)];
        const T2 a0 = z[sw(i0)];
        const T2 a1 = cmul(z[sw(i0 + h)], w1);
        const T2 a2 = z[sw(i0 + 2 * h)];
        const T2 a3 = cmul(z[sw(i0 + 3 * h)], w1);
        const T2 b0 = cadd(a0, a1);
        const T2 b1 = csub(a0, a1);
        const T2 b2 = cmul(cadd(a2, a3), w2);
        const T2 b3 = cmul(csub(a2, a3), w3);
        z[sw(i0)] = cadd(b0, b2);
        z[sw(i0 + 2 * h)] = csub(b0, b2);
        z[sw(i0 + h)] = cadd(b1, b3);
        z[sw(i0 + 3 * h)] = csub(b1, b3);
      }
      __syncthreads();
    }

    // real-input split: X[k] = E[k] + W^k O[k], E = (Z[k] + conj Z[m-k]) / 2,
    // O = (Z[k] - conj Z[m-k]) / 2i, indices mod m, W^m = -1; then power.
    // A thread takes bins k and m - k, which read the same two points.
    for (int i = tid; i < fb * (m / 2 + 1); i += kThreads) {
      int f = i >> (log2m - 1);            // i / (m / 2 + 1) without a divide
      while (f * (m / 2 + 1) > i) --f;
      const int k = i - f * (m / 2 + 1);
      const int zf = f << log2m;
      const T2 a = z[sw(zf + (k & (m - 1)))];
      const T2 c = z[sw(zf + ((m - k) & (m - 1)))];
      T* pf = pw + f * k_bins;
      pf[k] = bin_power<T>(a, c, tw[k], magnitude);
      if (k != m - k)
        pf[m - k] = bin_power<T>(c, a, k ? tw[m - k] : T2{T(-1), T(0)},
                                 magnitude);
    }
    __syncthreads();

    // mel projection over each mel's nonzero bins, in bin order; log
    for (int i = tid; i < fb * n_mels; i += kThreads) {
      const int f = i / n_mels, mel = i - f * n_mels;
      const int row = row0 + f;
      if (row >= n_rows) continue;
      const int first = __ldg(mel_bins + 3 * mel);
      const int count = __ldg(mel_bins + 3 * mel + 1);
      const T* wt = mel_weights + __ldg(mel_bins + 3 * mel + 2);
      const T* pf = pw + f * k_bins + first;
      T acc = T(0);
      for (int j = 0; j < count; ++j)
        acc = Real<T>::fma(pf[j], __ldg(wt + j), acc);
      out[(size_t)row * n_mels + mel] =
          (float)take_log<T>(acc, log_offset, log_const);
    }
    // the next group's split writes pw only after its gather and stages,
    // each followed by a barrier, so no barrier is needed here
  }
}

template <typename T>
int launch(const void* y, void* out, const void* window, const void* twiddle,
           const void* mel_bins, const void* mel_weights, int batch,
           int n_samples, int frame_len, int hop, int pad, int n_frames,
           int n_fft, int n_mels, int magnitude, int log_offset, T log_const,
           void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  if (n_fft < 4 || n_fft > kMaxFFT || (n_fft & (n_fft - 1)) ||
      frame_len < 1 || frame_len > n_fft || n_mels < 1 ||
      n_mels > kMaxMels || n_samples < 1 || pad < 0 ||
      (long)batch * n_frames > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  static int resident = 0;                 // blocks the card holds at once
  if (!resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  log_mel_fft_kernel<T>,
                                                  kThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int log2m = __builtin_ctz(n_fft) - 1;
  const int n_rows = batch * n_frames;
  const int fb = kPoints >> log2m;
  const int groups = (n_rows + fb - 1) / fb;
  const int grid = groups < resident ? groups : resident;
  log_mel_fft_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)y, (float*)out, (const T*)window,
      (const typename Real<T>::T2*)twiddle, (const int*)mel_bins,
      (const T*)mel_weights, n_rows, n_frames, n_samples, frame_len, hop,
      pad, log2m, n_mels, magnitude, log_offset, log_const);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: f32 tables, f32 arithmetic
int a2m_log_mel(const void* y, void* out, const void* window,
                const void* twiddle, const void* mel_bins,
                const void* mel_weights, int batch, int n_samples,
                int frame_len, int hop, int pad, int n_frames, int n_fft,
                int n_mels, int magnitude, int log_offset, float log_const,
                void* stream) {
  return launch<float>(y, out, window, twiddle, mel_bins, mel_weights, batch,
                       n_samples, frame_len, hop, pad, n_frames, n_fft,
                       n_mels, magnitude, log_offset, log_const, stream);
}

const char* a2m_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
