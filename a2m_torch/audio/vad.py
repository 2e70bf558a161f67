"""Host-side GMM voice-activity detection (webrtcvad-grade stand-in).

The port's own copy of ``a2m/audio/vad.py``, numpy only.  The reference
runs webrtcvad (a GMM classifier over sub-band energies) at aggressiveness
3 over 10 ms sub-frames and stores a two-entries-per-window silence stream
(`pats/data_loading/audio.py:128-172`); this is the same shape of
algorithm:

* 10 ms frames -> 6 sub-band log-energies (the bands webrtcvad models:
  80-250, 250-500, 500-1k, 1-2k, 2-3k, 3-4k Hz), via a precomputed DFT-bin
  assignment;
* an unsupervised 2-component diagonal GMM (EM, k-means init) over the
  feature frames classifies each frame speech/noise: the component with the
  higher total energy is "speech";
* decisions are aggregated into the reference's float-boundary 1/15 s
  windows with the <=50% rule and the interleaved trailing zero.

It feeds ``data.modalities.Audio.silence`` in offline preprocessing.
"""

from __future__ import annotations

import functools

import numpy as np

#: webrtcvad's six sub-bands (Hz)
BANDS = ((80, 250), (250, 500), (500, 1000), (1000, 2000), (2000, 3000),
         (3000, 4000))


@functools.lru_cache(maxsize=4)
def _band_matrix(frame_len: int, sr: int) -> np.ndarray:
    """(n_bins, 6) 0/1 assignment of rfft bins to the webrtc sub-bands."""
    freqs = np.fft.rfftfreq(frame_len, 1.0 / sr)
    m = np.zeros((len(freqs), len(BANDS)))
    for b, (lo, hi) in enumerate(BANDS):
        m[(freqs >= lo) & (freqs < hi), b] = 1.0
    return m


def band_log_energies(y: np.ndarray, sr: int = 16000,
                      frame_ms: int = 10) -> np.ndarray:
    """(n_frames, 6) log sub-band energies of 10 ms frames."""
    frame_len = sr * frame_ms // 1000
    n = len(y) // frame_len
    frames = y[:n * frame_len].reshape(n, frame_len)
    spec = np.abs(np.fft.rfft(frames * np.hanning(frame_len), axis=-1)) ** 2
    band = spec @ _band_matrix(frame_len, sr)
    return np.log(band + 1e-12)


def _gmm_em(x: np.ndarray, n_iter: int = 25, seed: int = 0):
    """2-component diagonal GMM via EM; returns responsibilities of comp 1."""
    # k-means-style init: split on total energy median
    total = x.sum(axis=1)
    hi = total > np.median(total)
    if hi.all() or not hi.any():
        # constant-energy signal: no bimodal structure to fit (an empty
        # component would make the EM means NaN) — classify every frame by
        # absolute level instead: speech iff the mean band energy exceeds a
        # -120 dB noise floor
        loud = total / x.shape[1] > np.log(1e-12)
        return np.where(loud, 1.0, 0.0)
    mus = np.stack([x[~hi].mean(axis=0), x[hi].mean(axis=0)])
    var = np.stack([x[~hi].var(axis=0), x[hi].var(axis=0)]) + 1e-3
    pis = np.array([float((~hi).mean()), float(hi.mean())])
    for _ in range(n_iter):
        # E step (log domain)
        logp = -0.5 * (((x[:, None, :] - mus[None]) ** 2 / var[None])
                       + np.log(2 * np.pi * var[None])).sum(axis=2)
        logp = logp + np.log(pis + 1e-12)[None]
        logp -= logp.max(axis=1, keepdims=True)
        r = np.exp(logp)
        r /= r.sum(axis=1, keepdims=True)
        # M step
        nk = r.sum(axis=0) + 1e-9
        mus = (r.T @ x) / nk[:, None]
        var = (r.T @ (x ** 2)) / nk[:, None] - mus ** 2 + 1e-3
        pis = nk / len(x)
    # "speech" = component with higher mean total energy
    speech_comp = int(np.argmax(mus.sum(axis=1)))
    return r[:, speech_comp]


def gmm_frame_decisions(y: np.ndarray, sr: int = 16000,
                        frame_ms: int = 10,
                        threshold: float = 0.5) -> np.ndarray:
    """Per-10 ms-frame speech decisions (1 = speech), GMM-classified."""
    feats = band_log_energies(y, sr, frame_ms)
    if len(feats) < 4:
        return np.ones(len(feats), dtype=np.int64)
    resp = _gmm_em(feats)
    return (resp > threshold).astype(np.int64)


def silence_stream(y: np.ndarray, sr: int = 16000, fs_new: int = 15,
                   frame_ms: int = 10) -> np.ndarray:
    """Reference-format silence stream from GMM decisions.

    Float-boundary 1/fs_new-second windows over 10 ms sub-frames, window
    silent when <=50% of its sub-frames are speech, trailing 0 interleaved
    after every window (audio.py:138-172) -> int64 (2 * n_windows,).
    """
    is_speech = gmm_frame_decisions(y, sr, frame_ms)
    sub = sr * frame_ms // 1000
    step = sr / fs_new
    ranges = np.arange(0, y.shape[0], step)
    out = []
    for start, end in zip(ranges[:-1], ranges[1:]):
        sub_ranges = np.arange(start, end, sub)
        idx = (sub_ranges[:-1] // sub).astype(int)
        idx = idx[idx < len(is_speech)]
        frac = is_speech[idx].mean() if len(idx) else 0.0
        out.append(int(frac <= 0.5))
        out.append(0)
    return np.asarray(out, dtype=np.int64)
