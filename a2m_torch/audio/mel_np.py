"""Window and mel filterbank constants, numpy only.

The port's own copy of ``periodic_hann``, the librosa-compatible Slaney
mel filterbank and the HTK (VGGish) mel filterbank from
``a2m/audio/mel_np.py`` (float64 construction).
"""

from __future__ import annotations

import numpy as np


def periodic_hann(window_length: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window, as librosa and VGGish use."""
    n = np.arange(window_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length)


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
