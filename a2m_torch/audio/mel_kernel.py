"""Fused log-mel: CUDA kernel wrapper, its plain version, its cost model.

The kernel (``a2m_torch/csrc/log_mel.cu``) replaces the Pallas TPU kernel
``a2m/audio/pallas_mel.py::_kernel`` (called by ``pallas_log_mel``,
``:68-232``) in fast mode: framing of the waveform (centred and
reflect-padded, or unpadded), window-folded DFT, power or magnitude, mel
projection onto up to 128 mels, and ``log(max(mel, c))`` or ``log(mel + c)``.
A stack of frames cut by the client goes through the same kernel as a
signal with ``hop = frame_len`` and no pad (:func:`log_mel_framed`).

:func:`log_mel` launches the kernel for CUDA tensors and runs
:func:`log_mel_plain` for CPU tensors, and for nothing else.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MAX_MELS = 128    # the kernel's mel width (one column per thread pair)


def frames_of(y: torch.Tensor, frame_len: int, hop: int, pad: int,
              n_frames: int) -> torch.Tensor:
    """(B, N) -> (B, n_frames, frame_len), contiguous: frame t starts at
    t * hop in the signal reflect-padded by ``pad`` on each side, zero past
    its end.  (A copy, not a strided view: the products that follow then
    do not depend on how the frames lay in the signal.)"""
    if pad:
        y = F.pad(y, (pad, pad), mode='reflect')
    needed = (n_frames - 1) * hop + frame_len
    if y.shape[-1] < needed:
        y = F.pad(y, (0, needed - y.shape[-1]))
    return y.unfold(-1, frame_len, hop)[:, :n_frames].contiguous()


def log_mel_plain(y: torch.Tensor, dr: torch.Tensor, di: torch.Tensor,
                  mel: torch.Tensor, hop: int, pad: int, n_frames: int,
                  log_const: float, power: float = 2.0,
                  log_mode: str = 'eps') -> torch.Tensor:
    """Plain PyTorch version: ``frames @ dr``, ``frames @ di``, power (or
    its square root when ``power`` is 1), ``@ mel``, log, in f32."""
    frames = frames_of(y, dr.shape[0], hop, pad, n_frames)
    re, im = frames @ dr, frames @ di
    p = re * re + im * im
    if power == 1.0:
        p = torch.sqrt(p)
    if log_mode == 'offset':
        return torch.log(p @ mel + log_const)
    return torch.log(torch.clamp_min(p @ mel, log_const))


def log_mel(y: torch.Tensor, dr: torch.Tensor, di: torch.Tensor,
            mel: torch.Tensor, hop: int, pad: int, n_frames: int,
            log_const: float, power: float = 2.0,
            log_mode: str = 'eps') -> torch.Tensor:
    """(B, N) f32 waveform -> (B, n_frames, n_mels) f32 log-mel.

    ``dr``/``di`` (frame_len, K) window-folded DFT matrices, ``mel``
    (K, n_mels) with at most 128 mels; ``power`` 2 or 1 (magnitude);
    ``log_mode`` ``'eps'`` (``log(max(mel, log_const))``) or ``'offset'``
    (``log(mel + log_const)``).  CUDA tensors launch the kernel, CPU tensors
    run :func:`log_mel_plain`."""
    frame_len, k = dr.shape
    n_mels = mel.shape[-1]
    if power not in (1.0, 2.0) or log_mode not in ('eps', 'offset'):
        raise ValueError(f'log_mel: power {power} / log_mode {log_mode!r} '
                         f'not in (1, 2) / (eps, offset)')
    if y.ndim != 2:
        raise ValueError(f'log_mel: waveform must be (B, N), got '
                         f'{tuple(y.shape)}')
    if any(t.dtype != torch.float32 for t in (y, dr, di, mel)):
        raise TypeError('log_mel: waveform and matrices must be float32')
    if di.shape != (frame_len, k) or mel.shape != (k, n_mels) \
            or not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f'log_mel: dr {tuple(dr.shape)}, di '
                         f'{tuple(di.shape)}, mel {tuple(mel.shape)} do not '
                         f'fit (frame_len, K), (K, n_mels <= {MAX_MELS})')
    if pad and pad >= y.shape[-1]:
        raise ValueError(f'log_mel: reflect pad {pad} needs more than '
                         f'{y.shape[-1]} samples')
    if not all(t.device == y.device for t in (dr, di, mel)):
        raise ValueError('log_mel: tensors on different devices')
    if y.device.type == 'cpu':
        return log_mel_plain(y, dr, di, mel, hop, pad, n_frames, log_const,
                             power, log_mode)
    if y.device.type != 'cuda':
        raise ValueError(f'log_mel: no kernel for device {y.device}')
    if frame_len % 16:
        raise ValueError(f'log_mel: frame_len {frame_len} must be a '
                         f'multiple of 16')
    from a2m_torch import _build
    y, dr, di, mel = (t.contiguous() for t in (y, dr, di, mel))
    batch = y.shape[0]
    out = torch.empty(batch, n_frames, n_mels, device=y.device)
    lib = _build.load('log_mel')
    groups = bin_groups(batch, n_frames, k, y.device)
    part = (torch.empty(groups, batch, n_frames, n_mels, device=y.device)
            if groups > 1 else out)
    code = lib.a2m_log_mel(
        y.data_ptr(), out.data_ptr(), part.data_ptr(), dr.data_ptr(),
        di.data_ptr(), mel.data_ptr(), batch, y.shape[1], frame_len, hop,
        pad, n_frames, k, n_mels, groups, int(power == 1.0),
        int(log_mode == 'offset'), log_const,
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, code, 'log_mel')
    log_mel.launches += 1
    return out


#: kernel launches since the count was last set to 0.  One launch is one
#: device kernel, ``log_mel_kernel``, or two when ``bin_groups`` > 1:
#: ``log_mel_finish`` then sums the partial mel sums and takes the log.
log_mel.launches = 0


def log_mel_framed(frames: torch.Tensor, dr: torch.Tensor,
                   di: torch.Tensor, mel: torch.Tensor, log_const: float,
                   power: float = 2.0, log_mode: str = 'eps'
                   ) -> torch.Tensor:
    """(B, T, frame_len) f32 sample frames -> (B, T, n_mels): the frames
    laid end to end are a signal whose frames start every ``frame_len``
    samples, so this is :func:`log_mel` with ``hop = frame_len`` and no
    pad, on either device."""
    batch, n_frames, frame_len = frames.shape
    if frame_len != dr.shape[0]:
        raise ValueError(f'log_mel_framed: frames of {frame_len} samples, '
                         f'DFT matrices of {dr.shape[0]}')
    return log_mel(frames.reshape(batch, n_frames * frame_len), dr, di, mel,
                   frame_len, 0, n_frames, log_const, power, log_mode)


def bin_groups(batch: int, n_frames: int, k: int, device) -> int:
    """Blocks the bin tiles of one (batch row, frame tile) are split over
    on this card: more than 1 when the batch is too small to fill it."""
    from a2m_torch import _build
    return _build.load('log_mel').a2m_log_mel_groups(
        batch, n_frames, k,
        torch.cuda.get_device_properties(device).multi_processor_count)


def log_mel_flops(batch: int, n_frames: int, n_fft: int, k: int,
                  n_mels: int = MAX_MELS) -> int:
    """Operations the log-mel function needs, counted by its cheapest
    algorithm: window, a real FFT of ``n_fft`` points (2.5 n log2 n, half
    of a complex radix-2 FFT's 5 n log2 n), power, mel projection, log."""
    fft = round(2.5 * n_fft * math.log2(n_fft))
    return batch * n_frames * (n_fft + fft + 3 * k + 2 * k * n_mels + n_mels)


def direct_dft_flops(batch: int, n_frames: int, frame_len: int, k: int,
                     n_mels: int = MAX_MELS) -> int:
    """Operations of the direct-DFT algorithm the kernel runs (``frames @
    dr``, ``frames @ di``, power, mel projection, log): ~27x
    :func:`log_mel_flops` at n_fft 2048."""
    rows = batch * n_frames
    return rows * (2 * 2 * frame_len * k + 3 * k + 2 * k * n_mels + n_mels)


def log_mel_bytes(batch: int, n_samples: int, n_frames: int, frame_len: int,
                  hop: int, k: int, n_mels: int = MAX_MELS) -> int:
    """Bytes the log-mel function must move: the samples its frames cover
    and the window and mel matrix, each read once, and the output written
    once.  The window-folded DFT matrices (``2 * frame_len * k`` floats)
    are operands of the direct DFT, not of the function, and are left
    out."""
    covered = min(n_frames * min(frame_len, hop) + max(frame_len - hop, 0),
                  n_samples)
    return 4 * (batch * covered + frame_len + k * n_mels
                + batch * n_frames * n_mels)
