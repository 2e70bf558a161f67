"""Log-mel frontend of the audio->pose and serving paths (fast mode).

Counterpart of ``a2m/audio/frontend.py``: the :class:`MelSpec` dataclass,
the three spec families (``spec_log_mel_512``, ``spec_log_mel_400``,
``spec_vggish``, ``:58-77``), ``strided_spec`` (``:240-248``), the
window-folded DFT and mel matrices (``dft_matrices``, ``:91-135``; the f32
"hi" parts only), ``num_frames``, the centred reflect pad and integer-PCM
scaling, :func:`log_mel` and :func:`log_mel_frames`, which run the fused
log-mel kernel (:mod:`a2m_torch.audio.mel_kernel`) on CUDA, and the
client-side :func:`frame_for_wire` (numpy).

The direct windowed DFT computes the same function as a2m's fast path,
which takes the radix route (``frontend.py:207-237``); the two agree to
f32 rounding.  Exact mode (hi/lo split matrices, precise log), which only
the data pipeline calls, and ``pad_mode='constant'`` are not ported yet.
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
    log_mode: str = 'eps'  # 'eps': log(max(x, c)); 'offset': log(x + c)
    log_const: float = 1e-10
    # 'librosa': frames are n_fft long, window zero-padded centred inside;
    # 'vggish': frames are win_length long, the DFT zero-pads to n_fft
    frame_style: str = 'librosa'


def spec_log_mel_512(sr: int) -> MelSpec:
    return MelSpec(sr=sr, n_fft=2048, hop_length=512, win_length=2048,
                   n_mels=128, power=2.0, fmin=0.0, fmax=None,
                   mel_norm='slaney', mel_scale='slaney', center=True,
                   log_mode='eps', log_const=1e-10)


def spec_log_mel_400() -> MelSpec:
    return MelSpec(sr=16000, n_fft=512, hop_length=160, win_length=400,
                   n_mels=64, power=1.0, fmin=125.0, fmax=7500.0,
                   mel_norm=None, mel_scale='slaney', center=False,
                   log_mode='eps', log_const=1e-6)


def spec_vggish() -> MelSpec:
    # win = 400, hop = 160 at 16 kHz; fft = 2^ceil(log2(400)) = 512
    return MelSpec(sr=16000, n_fft=512, hop_length=160, win_length=400,
                   n_mels=64, power=1.0, fmin=125.0, fmax=7500.0,
                   mel_norm=None, mel_scale='htk', center=False,
                   log_mode='offset', log_const=0.01, frame_style='vggish')


def strided_spec(spec: MelSpec, stride: int) -> MelSpec:
    """Fold a keep-every-``stride``-th-frame resampling into the hop, so
    only the kept frames are computed: frame i of the result is frame
    ``i * stride`` of ``spec``."""
    return dataclasses.replace(spec, hop_length=spec.hop_length * stride)


def _check_supported(spec: MelSpec) -> None:
    """Raise for what the port's fast mode does not cover yet."""
    if (spec.power not in (1.0, 2.0)
            or spec.log_mode not in ('eps', 'offset')
            or spec.frame_style not in ('librosa', 'vggish')
            or spec.mel_scale not in ('slaney', 'htk')
            or spec.n_mels > mel_kernel.MAX_MELS
            or (spec.center and spec.pad_mode != 'reflect')):
        raise NotImplementedError(
            f'a2m_torch log_mel: power 1 or 2, eps or offset log, librosa '
            f'or vggish frames, at most {mel_kernel.MAX_MELS} mels and a '
            f'reflect pad are supported, got {spec}')


@functools.lru_cache(maxsize=16)
def dft_matrices(spec: MelSpec) -> dict:
    """Window-folded real/imag DFT matrices (frame_len, K) and the mel
    matrix (K, n_mels), built in float64 and stored as float32.  The window
    sits centred inside the n_fft frame when win_length < n_fft (librosa);
    with VGGish framing the frame is win_length long and the matrices are
    the first win_length rows of the n_fft-point DFT, which absorbs the
    zero-padding to n_fft."""
    _check_supported(spec)
    n_fft, win, k_bins = spec.n_fft, spec.win_length, spec.n_fft // 2 + 1
    window = mel_np.periodic_hann(win)
    if spec.frame_style == 'librosa':
        frame_len = n_fft
        w_full = np.zeros(n_fft)
        off = (n_fft - win) // 2 if win < n_fft else 0
        w_full[off:off + win] = window
    else:
        frame_len, w_full = win, window
    n = np.arange(frame_len)[:, None]
    k = np.arange(k_bins)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    if spec.mel_scale == 'htk':
        mel = mel_np.mel_matrix_htk(spec.n_mels, k_bins, spec.sr, spec.fmin,
                                    spec.fmax if spec.fmax else spec.sr / 2)
    else:
        mel = mel_np.mel_matrix_slaney(spec.n_mels, n_fft, spec.sr,
                                       fmin=spec.fmin, fmax=spec.fmax,
                                       norm=spec.mel_norm).T
    f32 = np.float32
    return dict(frame_len=frame_len, K=k_bins,
                dr=(np.cos(ang) * w_full[:, None]).astype(f32),
                di=(np.sin(ang) * w_full[:, None]).astype(f32),
                mel=np.ascontiguousarray(mel.astype(f32)))


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
    frame_len = dft_matrices(spec)['frame_len']
    return 1 + (n_samples - frame_len) // spec.hop_length


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
                             spec.log_const, spec.power, spec.log_mode)
    return out.reshape(*lead, n_frames, spec.n_mels)


def frame_for_wire(y: np.ndarray, spec: MelSpec,
                   n_frames: int | None = None,
                   tail_value: float = 0) -> np.ndarray:
    """Client-side framing for the framed serving wire format (numpy).

    Cuts exactly the (..., T, frame_len) sample frames that :func:`log_mel`
    reads from the waveform: the same centred reflect padding, hop grid and
    zero tail, so ``log_mel_frames(frame_for_wire(y, spec), spec)`` equals
    ``log_mel(y, spec)`` bit for bit.  At pose rate the hop (3072) exceeds
    the frame length (2048), so a third of the samples are never read, and
    shipping frames instead of the waveform saves those bytes.  The dtype
    is kept (int16 in, int16 frames out); ``tail_value`` is the code of a
    zero sample for a wire that is already encoded (mu-law: 128)."""
    y = np.asarray(y)
    _check_supported(spec)
    frame_len, hop = dft_matrices(spec)['frame_len'], spec.hop_length
    lead = [(0, 0)] * (y.ndim - 1)
    if spec.center:
        pad = spec.n_fft // 2
        y = np.pad(y, lead + [(pad, pad)], mode='reflect')
    if n_frames is None:
        n_frames = 1 + (y.shape[-1] - frame_len) // hop
    needed = (n_frames - 1) * hop + frame_len
    if y.shape[-1] < needed:
        y = np.pad(y, lead + [(0, needed - y.shape[-1])],
                   constant_values=tail_value)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_len)[None, :]
    return y[..., idx]


def log_mel_frames(frames: torch.Tensor, spec: MelSpec) -> torch.Tensor:
    """Framed-wire entry: (..., T, frame_len) sample frames (float or
    integer PCM, see :func:`frame_for_wire`) -> (..., T, n_mels) log-mel,
    identical to :func:`log_mel` on the waveform they were cut from."""
    _check_supported(spec)
    lead, (t, frame_len) = frames.shape[:-2], frames.shape[-2:]
    dr, di, mel = _device_matrices(spec, frames.device)
    out = mel_kernel.log_mel_framed(
        _pcm_to_float(frames).reshape(-1, t, frame_len), dr, di, mel,
        spec.log_const, spec.power, spec.log_mode)
    return out.reshape(*lead, t, spec.n_mels)
