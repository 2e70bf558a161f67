// Fused log-mel frontend, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel a2m/audio/pallas_mel.py::_kernel (called by
// pallas_log_mel), fast mode: framing of the waveform (centred and
// reflect-padded, or as it is) -> window-folded DFT (re and im products) ->
// power re^2 + im^2, or its square root (magnitude) -> mel projection
// accumulated over the bin tiles -> log(max(mel, c)) or log(mel + c).
// Neither the frames nor the (T, K) spectrum go to device memory.  It
// covers the three frontend families: log_mel_512 (frames of 2048, 1025
// bins, 128 mels, power, eps log), log_mel_400 (frames of 512, 257 bins, 64
// mels, magnitude, eps log) and VGGish (frames of 400 whose DFT matrix
// absorbs the zero-padding to 512, htk mels, offset log).  A stack of
// frames cut by the client is a signal with hop = frame_len and no pad.
//
// Bound on the H100: at the main-path shapes (B = 128, T = 64 frames of
// n_fft = 2048, K = 1025 bins, 128 mels) the function needs ~2.7 GFLOP by
// FFT (real FFT plus the mel projection) against ~72 MB of frame samples
// and output: ~0.04 ms at the 67 TFLOP/s fp32 rate.  This kernel runs the
// direct DFT of the Pallas kernel instead, ~71 GFLOP (~27x), and is bound
// by the fp32 FMA rate at ~1 ms (no TF32: the tolerance is 1e-4 in log
// units).  What the design does about it: the DFT is a tiled SGEMM.  A
// block takes one batch row, a tile of 64 frames and a range of 64-bin
// tiles; a thread owns 4 frames x 4 bins of both the re and im sums, so a
// 16-sample chunk of frames and of the two DFT matrices, staged in shared
// memory (double-buffered through registers), feeds 32 FMAs per thread per
// sample for three shared loads.  Frames are gathered with plain loads
// straight from the unpadded waveform (the reflect pad is index arithmetic;
// the hop-chunk concat of the Pallas kernel is a VMEM workaround and is not
// carried over).  The power of a bin tile goes to shared memory and is
// folded into the mel sums at once, which stay in registers.  When the
// batch is too small to fill the card, the bin tiles are split over blocks
// and a second small kernel sums their partial mel sums and takes the log.
// An FFT-based kernel, or tensor cores (3xTF32 or split-bf16 GEMMs), are
// later work.
//
// Layout: y (B, n_samples) f32; dr, di (frame_len, K) f32 window-folded DFT
// matrices; mel (K, n_mels) f32, n_mels <= 128 (a thread pair owns one of
// 128 mel columns; those past n_mels idle); out (B, n_frames, n_mels) f32;
// part (groups, B, n_frames, n_mels) f32 scratch when groups > 1.  Frame t
// starts at t * hop in the signal padded by `pad` samples of reflection on
// each side (pad may be 0, hop smaller or larger than frame_len); samples
// past the padded end read as zero.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 64;                // frames per block
constexpr int kBins = 64;                  // bins per tile
constexpr int kChunk = 16;                 // samples per staged chunk
constexpr int kMels = 128;
constexpr int kAStride = kFrames + 4;      // transposed frame chunk row
constexpr int kPStride = kBins + 4;        // power tile row
constexpr int kPerThread = kChunk * kFrames / kThreads;   // 4 staged values

struct Shared {
  float a[2][kChunk][kAStride];            // frames, sample-major
  float br[2][kChunk][kBins];              // DFT re columns of the tile
  float bi[2][kChunk][kBins];              // DFT im columns of the tile
  float p[kFrames][kPStride];              // power of the tile
};

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// log(mel + c) for the offset log, log(max(mel, c)) for the eps log
__device__ __forceinline__ float take_log(float mel, int log_offset,
                                          float log_const) {
  return logf(log_offset ? mel + log_const : fmaxf(mel, log_const));
}

__global__ void __launch_bounds__(kThreads, 2)
log_mel_kernel(const float* __restrict__ y, float* __restrict__ out,
               float* __restrict__ part, const float* __restrict__ dr,
               const float* __restrict__ di, const float* __restrict__ mel,
               int batch, int n_samples, int frame_len, int hop, int pad,
               int n_frames, int K, int n_mels, int groups, int magnitude,
               int log_offset, float log_const) {
  __shared__ __align__(16) Shared sh;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, n_frames - t0);
  const int tiles = (K + kBins - 1) / kBins;
  const int tile_begin = blockIdx.z * tiles / groups;
  const int tile_end = (blockIdx.z + 1) * tiles / groups;
  const float* yb = y + (size_t)b * n_samples;
  const long padded = (long)n_samples + 2L * pad;
  const int chunks = frame_len / kChunk;

  const int fg = tid / 16, bg = tid % 16;  // DFT micro-tile: 4 frames x 4 bins
  const int mcol = tid % kMels;            // mel stage: one mel column
  const int mhalf = tid / kMels;           //   x 32 frames
  float macc[kFrames / 2];
#pragma unroll
  for (int i = 0; i < kFrames / 2; ++i) macc[i] = 0.f;

  float sa[kPerThread], sr[kPerThread], si[kPerThread];
  auto load_chunk = [&](int c, int b0) {
    const int n0 = c * kChunk;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int idx = tid + q * kThreads;
      const int m = idx / kChunk, kk = idx % kChunk;
      float v = 0.f;
      long s = (long)(t0 + m) * hop + n0 + kk;   // index in padded signal
      if (m < nf && s < padded) {
        s -= pad;
        if (s < 0) s = -s;
        else if (s >= n_samples) s = 2L * (n_samples - 1) - s;
        v = __ldg(yb + s);
      }
      sa[q] = v;
      const int kr = idx / kBins, bin = b0 + idx % kBins;
      const size_t o = (size_t)(n0 + kr) * K + bin;
      sr[q] = bin < K ? __ldg(dr + o) : 0.f;
      si[q] = bin < K ? __ldg(di + o) : 0.f;
    }
  };
  auto store_chunk = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int idx = tid + q * kThreads;
      sh.a[buf][idx % kChunk][idx / kChunk] = sa[q];
      sh.br[buf][idx / kBins][idx % kBins] = sr[q];
      sh.bi[buf][idx / kBins][idx % kBins] = si[q];
    }
  };

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int b0 = tile * kBins;
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) re[i][c] = im[i][c] = 0.f;

    load_chunk(0, b0);
    store_chunk(0);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < chunks) load_chunk(c + 1, b0);   // in flight meanwhile
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float4 a =
            *reinterpret_cast<const float4*>(sh.a[buf][k] + 4 * fg);
        const float4 r =
            *reinterpret_cast<const float4*>(sh.br[buf][k] + 4 * bg);
        const float4 m =
            *reinterpret_cast<const float4*>(sh.bi[buf][k] + 4 * bg);
        fma4(re[0], a.x, r); fma4(im[0], a.x, m);
        fma4(re[1], a.y, r); fma4(im[1], a.y, m);
        fma4(re[2], a.z, r); fma4(im[2], a.z, m);
        fma4(re[3], a.w, r); fma4(im[3], a.w, m);
      }
      if (c + 1 < chunks) store_chunk(buf ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 pw;
      pw.x = re[i][0] * re[i][0] + im[i][0] * im[i][0];
      pw.y = re[i][1] * re[i][1] + im[i][1] * im[i][1];
      pw.z = re[i][2] * re[i][2] + im[i][2] * im[i][2];
      pw.w = re[i][3] * re[i][3] + im[i][3] * im[i][3];
      if (magnitude) {
        pw.x = sqrtf(pw.x); pw.y = sqrtf(pw.y);
        pw.z = sqrtf(pw.z); pw.w = sqrtf(pw.w);
      }
      *reinterpret_cast<float4*>(&sh.p[4 * fg + i][4 * bg]) = pw;
    }
    __syncthreads();
    const int kn = min(kBins, K - b0);
    for (int kk = 0; kk < kn; ++kk) {
      const float w = mcol < n_mels
          ? __ldg(mel + (size_t)(b0 + kk) * n_mels + mcol) : 0.f;
#pragma unroll
      for (int i = 0; i < kFrames / 2; ++i)
        macc[i] = fmaf(sh.p[mhalf * (kFrames / 2) + i][kk], w, macc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFrames / 2; ++i) {
    const int t = mhalf * (kFrames / 2) + i;
    if (t >= nf || mcol >= n_mels) continue;
    const size_t o = ((size_t)b * n_frames + t0 + t) * n_mels + mcol;
    if (groups == 1)
      out[o] = take_log(macc[i], log_offset, log_const);
    else
      part[(size_t)blockIdx.z * batch * n_frames * n_mels + o] = macc[i];
  }
}

// out = the log of the sum over groups of part
__global__ void log_mel_finish(const float* __restrict__ part,
                               float* __restrict__ out, size_t size,
                               int groups, int log_offset, float log_const) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < size;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[(size_t)g * size + i];
    out[i] = take_log(s, log_offset, log_const);
  }
}

}  // namespace

extern "C" {

// Bin-tile groups per (batch row, frame tile): enough blocks for two per SM.
int a2m_log_mel_groups(int batch, int n_frames, int n_bins, int sms) {
  const int tiles = (n_bins + kBins - 1) / kBins;
  const int blocks = batch * ((n_frames + kFrames - 1) / kFrames);
  const int g = blocks > 0 ? 2 * sms / blocks : 1;
  return g < 1 ? 1 : (g > tiles ? tiles : g);
}

int a2m_log_mel(const void* y, void* out, void* part, const void* dr,
                const void* di, const void* mel, int batch, int n_samples,
                int frame_len, int hop, int pad, int n_frames, int n_bins,
                int n_mels, int groups, int magnitude, int log_offset,
                float log_const, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  if (n_mels < 1 || n_mels > kMels || frame_len % kChunk != 0 || groups < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch, groups);
  log_mel_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)y, (float*)out, (float*)part, (const float*)dr,
      (const float*)di, (const float*)mel, batch, n_samples, frame_len, hop,
      pad, n_frames, n_bins, n_mels, groups, magnitude, log_offset,
      log_const);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  const size_t size = (size_t)batch * n_frames * n_mels;
  const int blocks = (int)((size + kThreads - 1) / kThreads);
  log_mel_finish<<<blocks, kThreads, 0, s>>>((const float*)part,
                                              (float*)out, size, groups,
                                              log_offset, log_const);
  return (int)cudaGetLastError();
}

const char* a2m_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
