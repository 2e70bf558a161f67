"""Log-mel frontend of the audio->pose path (fast mode).

Counterpart of ``a2m/audio/frontend.py``: the :class:`MelSpec` dataclass,
``spec_log_mel_512``, ``strided_spec`` (``:240-248``), the window-folded DFT
and mel matrices (``dft_matrices``, ``:91-135``; the f32 "hi" parts only),
the centred reflect pad and integer-PCM scaling, and :func:`log_mel`, which
runs the fused log-mel kernel (:mod:`a2m_torch.audio.mel_kernel`) on CUDA.

The direct windowed DFT computes the same function as a2m's fast path,
which takes the radix route (``frontend.py:207-237``); the two agree to
f32 rounding.  Exact mode (hi/lo split matrices, precise log) and the 400 /
VGGish specs belong to the data-pipeline slice.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from a2m_torch.audio import mel_kernel, mel_np


@dataclass(frozen=True)
class MelSpec:
    """Static spectrogram/mel parameters (hashable)."""
    sr: int
    n_fft: int
    hop_length: int
    win_length: int
    n_mels: int
    power: float          # 1.0 (magnitude) or 2.0 (power)
    fmin: float
    fmax: float | None
    mel_norm: str | None  # 'slaney' or None
    mel_scale: str        # 'slaney' or 'htk'
    center: bool
    pad_mode: str = 'reflect'
    log_mode: str = 'eps'
    log_const: float = 1e-10
    frame_style: str = 'librosa'


def spec_log_mel_512(sr: int) -> MelSpec:
    return MelSpec(sr=sr, n_fft=2048, hop_length=512, win_length=2048,
                   n_mels=128, power=2.0, fmin=0.0, fmax=None,
                   mel_norm='slaney', mel_scale='slaney', center=True,
                   log_mode='eps', log_const=1e-10)


def strided_spec(spec: MelSpec, stride: int) -> MelSpec:
    """Fold a keep-every-``stride``-th-frame resampling into the hop, so
    only the kept frames are computed: frame i of the result is frame
    ``i * stride`` of ``spec``."""
    return dataclasses.replace(spec, hop_length=spec.hop_length * stride)


def _check_supported(spec: MelSpec) -> None:
    if (spec.power != 2.0 or spec.log_mode != 'eps'
            or spec.frame_style != 'librosa' or spec.mel_scale != 'slaney'
            or spec.n_mels != mel_kernel.N_MELS
            or (spec.center and spec.pad_mode != 'reflect')):
        raise NotImplementedError(
            f'a2m_torch log_mel supports the log_mel_512 family only, '
            f'got {spec}')


@functools.lru_cache(maxsize=16)
def dft_matrices(spec: MelSpec) -> dict:
    """Window-folded real/imag DFT matrices (n_fft, K) and the mel matrix
    (K, n_mels), built in float64 and stored as float32.  The window sits
    centred inside the n_fft frame when win_length < n_fft (librosa)."""
    _check_supported(spec)
    n_fft, win, k_bins = spec.n_fft, spec.win_length, spec.n_fft // 2 + 1
    w_full = np.zeros(n_fft)
    off = (n_fft - win) // 2 if win < n_fft else 0
    w_full[off:off + win] = mel_np.periodic_hann(win)
    n = np.arange(n_fft)[:, None]
    k = np.arange(k_bins)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    mel = mel_np.mel_matrix_slaney(spec.n_mels, n_fft, spec.sr,
                                   fmin=spec.fmin, fmax=spec.fmax,
                                   norm=spec.mel_norm).T
    f32 = np.float32
    return dict(frame_len=n_fft, K=k_bins,
                dr=(np.cos(ang) * w_full[:, None]).astype(f32),
                di=(np.sin(ang) * w_full[:, None]).astype(f32),
                mel=mel.astype(f32))


@functools.lru_cache(maxsize=8)
def _device_matrices(spec: MelSpec, device: torch.device):
    m = dft_matrices(spec)
    return tuple(torch.from_numpy(m[k]).to(device)
                 for k in ('dr', 'di', 'mel'))


def _pcm_to_float(y: torch.Tensor) -> torch.Tensor:
    """Integer PCM -> [-1, 1) float32, scaled by 1 / 2^(bits-1) like
    librosa's ``buf_to_float``; floats are cast to float32."""
    if not y.dtype.is_floating_point:
        return y.float() / float(torch.iinfo(y.dtype).max + 1)
    return y.float()


def num_frames(spec: MelSpec, n_samples: int) -> int:
    if spec.center:
        return 1 + n_samples // spec.hop_length
    return 1 + (n_samples - spec.n_fft) // spec.hop_length


def log_mel(y: torch.Tensor, spec: MelSpec,
            n_frames: int | None = None) -> torch.Tensor:
    """Fast-mode log-mel: (..., N) waveform (float or integer PCM) ->
    (..., T, n_mels) float32, on ``y``'s device (the kernel on CUDA)."""
    _check_supported(spec)
    lead = y.shape[:-1]
    y = _pcm_to_float(y).reshape(-1, y.shape[-1])
    if n_frames is None:
        n_frames = num_frames(spec, y.shape[-1])
    dr, di, mel = _device_matrices(spec, y.device)
    pad = spec.n_fft // 2 if spec.center else 0
    out = mel_kernel.log_mel(y, dr, di, mel, spec.hop_length, pad, n_frames,
                             spec.log_const)
    return out.reshape(*lead, n_frames, spec.n_mels)
