"""Float64 numpy reference of the audio frontends, numpy and scipy only.

The port's own copy of ``a2m/audio/mel_np.py``: ``periodic_hann``, framing
and the STFTs (``:28-90``), the librosa-compatible Slaney mel filterbank
and the HTK (VGGish) mel filterbank, the resamplers (``resample_poly``,
librosa's ``kaiser_best`` re-implemented from resampy's published filter,
``:186-280``) and the float64 goldens ``log_mel_512``, ``log_mel_400`` and
``vggish_log_mel`` (``:282-329``) that the exact-mode frontend is held to
within 1e-5.
"""

from __future__ import annotations

import numpy as np


def periodic_hann(window_length: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window, as librosa and VGGish use."""
    n = np.arange(window_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length)


def frame(data: np.ndarray, window_length: int, hop_length: int) -> np.ndarray:
    """Split a (num_samples, ...) array into (num_frames, window_length,
    ...) frames; incomplete trailing frames are dropped (no padding)."""
    num_samples = data.shape[0]
    num_frames = 1 + int(np.floor((num_samples - window_length) / hop_length))
    idx = (np.arange(num_frames)[:, None] * hop_length
           + np.arange(window_length)[None, :])
    return data[idx]


def stft_magnitude(signal: np.ndarray, fft_length: int, hop_length: int,
                   window_length: int) -> np.ndarray:
    """|rfft| of periodic-Hann-windowed, uncentred frames: (num_frames,
    fft_length // 2 + 1)."""
    frames = frame(signal, window_length, hop_length)
    window = periodic_hann(window_length)
    return np.abs(np.fft.rfft(frames * window, int(fft_length)))


def stft_librosa(y: np.ndarray, n_fft: int, hop_length: int,
                 win_length: int | None = None, center: bool = True,
                 pad_mode: str = 'reflect') -> np.ndarray:
    """librosa-convention complex STFT, shape (1 + n_fft // 2, num_frames):
    ``center`` pads the signal by n_fft // 2 on both sides; the window is a
    periodic Hann of win_length zero-padded (centred) to n_fft."""
    if win_length is None:
        win_length = n_fft
    window = periodic_hann(win_length)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    if center:
        y = np.pad(y, n_fft // 2, mode=pad_mode)
    frames = frame(y, n_fft, hop_length)            # (T, n_fft)
    return np.fft.rfft(frames * window, n_fft).T    # (n_fft//2+1, T)


_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def hertz_to_mel_htk(f):
    """HTK mel scale: 1127 * ln(1 + f / 700)."""
    return _MEL_HIGH_FREQUENCY_Q * np.log1p(np.asarray(f, dtype=np.float64)
                                            / _MEL_BREAK_FREQUENCY_HERTZ)


def mel_matrix_htk(num_mel_bins: int, num_spectrogram_bins: int,
                   sample_rate: float, lower_edge_hertz: float,
                   upper_edge_hertz: float) -> np.ndarray:
    """HTK-style triangular mel weight matrix, shape (num_spectrogram_bins,
    num_mel_bins), DC bin zeroed.  Post-multiplies a (frames, bins)
    spectrogram."""
    nyquist = sample_rate / 2.0
    if not (0.0 <= lower_edge_hertz < upper_edge_hertz <= nyquist):
        raise ValueError('bad mel band edges '
                         f'[{lower_edge_hertz}, {upper_edge_hertz}] @ '
                         f'{sample_rate}')
    bins_mel = hertz_to_mel_htk(np.linspace(0.0, nyquist,
                                            num_spectrogram_bins))[:, None]
    edges_mel = np.linspace(hertz_to_mel_htk(lower_edge_hertz),
                            hertz_to_mel_htk(upper_edge_hertz),
                            num_mel_bins + 2)
    lower = edges_mel[:-2][None, :]     # (1, M)
    center = edges_mel[1:-1][None, :]
    upper = edges_mel[2:][None, :]
    lower_slope = (bins_mel - lower) / (center - lower)
    upper_slope = (upper - bins_mel) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0                 # HTK excludes the DC bin
    return weights


def hertz_to_mel_slaney(f):
    """Slaney (auditory toolbox) mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, min_log_hz)
                                         / min_log_hz) / logstep,
                    f / f_sp)


def mel_to_hertz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_matrix_slaney(num_mel_bins: int, n_fft: int, sample_rate: float,
                      fmin: float = 0.0, fmax: float | None = None,
                      norm: str | None = 'slaney') -> np.ndarray:
    """librosa-compatible mel filterbank, shape (num_mel_bins, 1 + n_fft//2).
    With ``norm='slaney'`` each triangle is area-normalised by 2/(band width
    in Hz)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_f = mel_to_hertz_slaney(np.linspace(hertz_to_mel_slaney(fmin),
                                            hertz_to_mel_slaney(fmax),
                                            num_mel_bins + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]      # (M+2, K)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == 'slaney':
        enorm = 2.0 / (mel_f[2:num_mel_bins + 2] - mel_f[:num_mel_bins])
        weights *= enorm[:, None]
    return weights


# ---------------------------------------------------------------------------
# Resampling (polyphase FIR, the deterministic stand-in for librosa.resample)
# ---------------------------------------------------------------------------


def resample_poly(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling via scipy (kaiser window): the fast
    alternative to :func:`resample_kaiser_best`."""
    from math import gcd

    from scipy.signal import resample_poly as _rp
    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    if up == down:
        return np.asarray(y, dtype=np.float64)
    return _rp(np.asarray(y, dtype=np.float64), up, down)


# resampy's published ``kaiser_best`` filter parameters (the spec of
# librosa's default resampler)
_KB_NUM_ZEROS = 64
_KB_BETA = 14.769656459379492
_KB_ROLLOFF = 0.9475937167399596
_KB_DENSITY = 8192              # table samples per zero crossing (resampy
                                # uses 512; denser is closer to the filter)


def _kaiser_best_table() -> np.ndarray:
    """Right half of the Kaiser-windowed sinc, densely sampled."""
    from scipy.special import i0
    t = np.linspace(0, _KB_NUM_ZEROS, _KB_NUM_ZEROS * _KB_DENSITY + 1)
    sinc_part = _KB_ROLLOFF * np.sinc(_KB_ROLLOFF * t)
    taper = i0(_KB_BETA * np.sqrt(np.clip(
        1.0 - (t / _KB_NUM_ZEROS) ** 2, 0.0, 1.0))) / i0(_KB_BETA)
    return sinc_part * taper


def resample_kaiser_best(y: np.ndarray, orig_sr: int, target_sr: int,
                         chunk: int = 16384) -> np.ndarray:
    """librosa's default ``kaiser_best`` resampler, from the published
    spec: a 64-zero-crossing Kaiser(beta=14.7697)-windowed sinc with
    rolloff 0.9476, scaled by min(1, ratio) for anti-aliasing on
    downsample, output length ceil(n * ratio); the filter table is linearly
    interpolated between its samples."""
    y = np.asarray(y, dtype=np.float64)
    ratio = float(target_sr) / float(orig_sr)
    if ratio == 1.0:
        return y
    n_in = y.shape[-1]
    n_out = int(np.ceil(n_in * ratio))
    scale = min(1.0, ratio)
    table = _kaiser_best_table()
    half = _KB_NUM_ZEROS / scale                 # support in input samples
    k = int(2 * half) + 2                        # taps per output sample
    offs = np.arange(k)
    out = np.empty(n_out, np.float64)
    for s in range(0, n_out, chunk):
        t = np.arange(s, min(s + chunk, n_out), dtype=np.float64) / ratio
        left = np.ceil(t - half).astype(np.int64)
        idx = left[:, None] + offs[None, :]      # input sample indices
        pos = np.abs(t[:, None] - idx) * scale * _KB_DENSITY
        base = np.minimum(pos.astype(np.int64), len(table) - 1)
        nxt = np.minimum(base + 1, len(table) - 1)
        frac = pos - base
        w = (table[base] + frac * (table[nxt] - table[base])) * scale
        w[pos >= len(table) - 1] = 0.0           # outside filter support
        valid = (idx >= 0) & (idx < n_in)
        xi = y[np.clip(idx, 0, n_in - 1)]
        out[s:s + len(t)] = np.einsum('ok,ok->o', np.where(valid, xi, 0.0),
                                      w)
    return out


def resample(y: np.ndarray, orig_sr: int, target_sr: int,
             method: str = 'kaiser_best') -> np.ndarray:
    """Resampler dispatch: 'kaiser_best' (librosa's algorithm, the
    default) or 'polyphase' (scipy, faster)."""
    if method == 'kaiser_best':
        return resample_kaiser_best(y, orig_sr, target_sr)
    if method == 'polyphase':
        return resample_poly(y, orig_sr, target_sr)
    raise ValueError(f'unknown resample method {method!r}')


# ---------------------------------------------------------------------------
# Float64 goldens of the three frontends
# ---------------------------------------------------------------------------


def log_mel_512(y: np.ndarray, sr: int, eps: float = 1e-10) -> np.ndarray:
    """librosa-parameterized log-mel (reference audio.py:58-75): power
    spectrogram of the centred reflect-padded STFT (n_fft 2048, hop 512),
    Slaney mels (128), zeros replaced by ``eps``, natural log; (frames,
    128)."""
    S = np.abs(stft_librosa(y, n_fft=2048, hop_length=512)) ** 2   # (1025, T)
    mel = mel_matrix_slaney(128, 2048, sr) @ S                     # (128, T)
    mel = np.where(mel == 0, eps, mel)
    return np.log(mel).T.astype(np.float64)


def log_mel_400(y: np.ndarray, sr: int, eps: float = 1e-6,
                resample_method: str = 'kaiser_best') -> np.ndarray:
    """16 kHz 64-bin log-mel with uncentred 400/160 frames in 512 points
    (reference audio.py:86-120): magnitude spectrogram, Slaney-scale mels
    with ``norm=None`` from 125 to 7500 Hz, after a kaiser_best resample to
    16 kHz."""
    y = resample(y, sr, 16000, method=resample_method)
    window = periodic_hann(400)
    pad = (512 - 400) // 2
    window = np.pad(window, (pad, pad))
    fr = frame(y.reshape(-1), 512, 160)
    S = np.abs(np.fft.rfft(fr * window, 512)).T                     # (257, T)
    mel = mel_matrix_slaney(64, 512, 16000, fmin=125.0, fmax=7500.0,
                            norm=None) @ S                          # (64, T)
    mel = np.where(mel == 0, eps, mel)
    return np.log(mel).T.astype(np.float64)


def vggish_log_mel(y: np.ndarray, sr: int = 16000, log_offset: float = 0.01,
                   window_secs: float = 0.025, hop_secs: float = 0.010,
                   n_mels: int = 64, fmin: float = 125.0,
                   fmax: float = 7500.0) -> np.ndarray:
    """VGGish log-mel (reference mel_features.py:192-223): 25 ms
    periodic-Hann windows, 10 ms hop, fft 2^ceil(log2(win)), magnitude
    spectrogram, HTK mels, log(mel + 0.01)."""
    win = int(round(sr * window_secs))
    hop = int(round(sr * hop_secs))
    fft_length = 2 ** int(np.ceil(np.log(win) / np.log(2.0)))
    spec = stft_magnitude(y, fft_length, hop, win)                  # (T, K)
    melmat = mel_matrix_htk(n_mels, spec.shape[1], sr, fmin, fmax)  # (K, M)
    return np.log(spec @ melmat + log_offset)
