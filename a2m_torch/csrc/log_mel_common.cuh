// Device helpers shared by the log-mel kernels (log_mel.cu: K2, fast mode;
// log_mel_exact.cu: K2x, exact mode).

#pragma once

namespace {

// index in the signal of index s in its endless reflection (numpy's
// mode='reflect'): reflect at either end until it lies inside.  Only the
// frames at the ends of a signal shorter than the pad loop more than once;
// a loop keeps K2 within its 32 registers, where a modulo spilled.
__device__ __forceinline__ long reflect(long s, int n_samples) {
  if (n_samples == 1) return 0;
  while (s < 0 || s >= n_samples) s = s < 0 ? -s : 2L * (n_samples - 1) - s;
  return s;
}

}  // namespace
