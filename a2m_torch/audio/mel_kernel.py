"""Fused log-mel: CUDA kernel wrapper, its plain version, its cost model.

The kernel (``a2m_torch/csrc/log_mel.cu``) replaces the Pallas TPU kernel
``a2m/audio/pallas_mel.py::_kernel`` (called by ``pallas_log_mel``,
``:68-232``): framing of the waveform (centred and reflect-padded, or
unpadded), window, real FFT of ``n_fft`` points, power or magnitude, mel
projection over the filterbank's nonzeros onto up to 128 mels, and
``log(max(mel, c))`` or ``log(mel + c)``.  A stack of frames cut by the
client goes through the same kernel as a signal with ``hop = frame_len``
and no pad (:func:`log_mel_framed`).  It has two instantiations, picked by
the tables' type: K2 (f32 tables, f32 arithmetic: a2m's fast mode) and K2x
(float64 tables, double arithmetic: a2m's exact mode, ``:96-125``, within
1e-5 of the float64 golden).

:func:`log_mel` launches the kernel for CUDA tensors and runs
:func:`log_mel_plain`, the direct windowed DFT in the tables' type, for
CPU tensors, and for nothing else.  What either reads besides the waveform
is a :class:`MelTables` (built by ``frontend.mel_tables``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

MAX_MELS = 128    # the kernel's mel width
MAX_FFT = 2048    # the kernel's largest FFT (1024 complex points a block)


@dataclass(frozen=True, eq=False)
class MelTables:
    """The log-mel's constants on one device, all float32 (fast mode, K2)
    or all float64 (exact mode, K2x) but ``mel_bins``.

    The kernel's: ``window`` (n_fft,), the window as the frame of ``n_fft``
    points sees it (zero outside it); ``twiddle`` (n_fft/2, 2), ``exp(-2 pi
    i k / n_fft)`` as (re, im), built in float64; ``mel_bins`` (n_mels, 3)
    int32, each mel's first nonzero bin, bin count and offset into
    ``mel_weights`` (nnz,), the dense filterbank's entries.  The plain
    version's: ``dr``, ``di`` (frame_len, K) window-folded DFT matrices and
    ``mel`` (K, n_mels); None on a CUDA device, where only the kernel reads
    the tables."""
    frame_len: int
    window: torch.Tensor
    twiddle: torch.Tensor
    mel_bins: torch.Tensor
    mel_weights: torch.Tensor
    dr: torch.Tensor | None = None
    di: torch.Tensor | None = None
    mel: torch.Tensor | None = None

    @property
    def n_fft(self) -> int:
        return self.window.shape[0]

    @property
    def n_mels(self) -> int:
        return self.mel_bins.shape[0]

    @property
    def exact(self) -> bool:
        return self.window.dtype == torch.float64

    def tensors(self) -> tuple:
        return tuple(t for t in (self.window, self.twiddle, self.mel_bins,
                                 self.mel_weights, self.dr, self.di, self.mel)
                     if t is not None)


def reflect_index(s: torch.Tensor, n: int) -> torch.Tensor:
    """Indices ``s`` (any integers) of a signal of ``n`` samples extended by
    endless reflection, folded into ``[0, n)``: numpy's ``mode='reflect'``,
    which reflects again once the pad outgrows the signal (period 2 (n - 1);
    a signal of one sample repeats)."""
    if n == 1:
        return torch.zeros_like(s)
    period = 2 * (n - 1)
    s = s.abs() % period
    return torch.where(s < n, s, period - s)


def frames_of(y: torch.Tensor, frame_len: int, hop: int, pad: int,
              n_frames: int) -> torch.Tensor:
    """(B, N) -> (B, n_frames, frame_len), contiguous: frame t starts at
    t * hop in the signal reflect-padded by ``pad`` on each side (see
    :func:`reflect_index`), zero past its end.  (A copy, not a strided
    view: the products that follow then do not depend on how the frames
    lay in the signal.)"""
    if pad:
        n = y.shape[-1]
        y = y[:, reflect_index(torch.arange(-pad, n + pad, device=y.device),
                               n)]
    needed = (n_frames - 1) * hop + frame_len
    if y.shape[-1] < needed:
        y = F.pad(y, (0, needed - y.shape[-1]))
    return y.unfold(-1, frame_len, hop)[:, :n_frames].contiguous()


def log_mel_plain(y: torch.Tensor, dr: torch.Tensor, di: torch.Tensor,
                  mel: torch.Tensor, hop: int, pad: int, n_frames: int,
                  log_const: float, power: float = 2.0,
                  log_mode: str = 'eps') -> torch.Tensor:
    """Plain PyTorch version: ``frames @ dr``, ``frames @ di``, power (or
    its square root when ``power`` is 1), ``@ mel``, log, in the type of
    ``y`` and the matrices (f32 for fast mode, float64 for exact mode)."""
    frames = frames_of(y, dr.shape[0], hop, pad, n_frames)
    re, im = frames @ dr, frames @ di
    p = re * re + im * im
    if power == 1.0:
        p = torch.sqrt(p)
    if log_mode == 'offset':
        return torch.log(p @ mel + log_const)
    return torch.log(torch.clamp_min(p @ mel, log_const))


def check_kernel_shapes(n_fft: int, frame_len: int, n_mels: int) -> None:
    """Raise ``ValueError`` for what the kernel does not take: an ``n_fft``
    that is not a power of two from 4 to :data:`MAX_FFT`, frames longer
    than ``n_fft``, more than :data:`MAX_MELS` mels.  Both instantiations
    take the same shapes: K2x's float64 points, twiddles and bins take 44 KB
    of shared memory at n_fft 2048, inside the 48 KB of a static block."""
    if not 4 <= n_fft <= MAX_FFT or n_fft & (n_fft - 1):
        raise ValueError(f'log_mel: n_fft {n_fft} is not a power of two '
                         f'from 4 to {MAX_FFT}')
    if not 1 <= frame_len <= n_fft:
        raise ValueError(f'log_mel: frames of {frame_len} samples do not fit '
                         f'n_fft {n_fft}')
    if not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f'log_mel: {n_mels} mels, the kernel takes 1 to '
                         f'{MAX_MELS}')


def log_mel(y: torch.Tensor, tables: MelTables, hop: int, pad: int,
            n_frames: int, log_const: float, power: float = 2.0,
            log_mode: str = 'eps') -> torch.Tensor:
    """(B, N) f32 waveform -> (B, n_frames, n_mels) f32 log-mel.

    ``power`` 2 or 1 (magnitude); ``log_mode`` ``'eps'``
    (``log(max(mel, log_const))``) or ``'offset'`` (``log(mel +
    log_const)``).  f32 tables give the fast mode, float64 tables the exact
    mode.  CUDA tensors launch the kernel (K2 or K2x), CPU tensors run
    :func:`log_mel_plain` on the tables' dense matrices, in float64 for
    exact tables."""
    if power not in (1.0, 2.0) or log_mode not in ('eps', 'offset'):
        raise ValueError(f'log_mel: power {power} / log_mode {log_mode!r} '
                         f'not in (1, 2) / (eps, offset)')
    if y.ndim != 2:
        raise ValueError(f'log_mel: waveform must be (B, N), got '
                         f'{tuple(y.shape)}')
    if y.dtype != torch.float32:
        raise TypeError('log_mel: the waveform must be float32')
    if y.shape[-1] < 1:
        raise ValueError('log_mel: an empty waveform')
    if not all(t.device == y.device for t in tables.tensors()):
        raise ValueError('log_mel: tensors on different devices')
    exact = tables.exact
    if y.device.type == 'cpu':
        if tables.dr is None:
            raise ValueError('log_mel: CPU tables without the dense matrices')
        out = log_mel_plain(y.double() if exact else y, tables.dr, tables.di,
                            tables.mel, hop, pad, n_frames, log_const, power,
                            log_mode)
        return out.float()
    if y.device.type != 'cuda':
        raise ValueError(f'log_mel: no kernel for device {y.device}')
    n_fft, n_mels = tables.n_fft, tables.n_mels
    check_kernel_shapes(n_fft, tables.frame_len, n_mels)
    dtype = torch.float64 if exact else torch.float32
    if (tables.twiddle.shape != (n_fft // 2, 2)
            or tables.mel_bins.shape != (n_mels, 3)
            or tables.mel_bins.dtype != torch.int32
            or any(t.dtype != dtype for t in (
                tables.window, tables.twiddle, tables.mel_weights))
            or not all(t.is_contiguous() for t in tables.tensors())):
        raise ValueError('log_mel: tables of the wrong shape, type or '
                         'layout for the kernel')
    from a2m_torch import _build
    y = y.contiguous()
    batch = y.shape[0]
    out = torch.empty(batch, n_frames, n_mels, device=y.device)
    lib = _build.load('log_mel')
    entry = lib.a2m_log_mel_exact if exact else lib.a2m_log_mel
    code = entry(
        y.data_ptr(), out.data_ptr(), tables.window.data_ptr(),
        tables.twiddle.data_ptr(), tables.mel_bins.data_ptr(),
        tables.mel_weights.data_ptr(), batch, y.shape[1], tables.frame_len,
        hop, pad, n_frames, n_fft, n_mels, int(power == 1.0),
        int(log_mode == 'offset'), log_const,
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, code, 'log_mel_exact' if exact else 'log_mel')
    if exact:
        log_mel.exact_launches += 1
    else:
        log_mel.launches += 1
    return out


#: kernel launches since the count was last set to 0 (one launch is one
#: device kernel, ``log_mel_fft_kernel``): K2 (fast mode) and K2x (exact)
log_mel.launches = 0
log_mel.exact_launches = 0


def log_mel_framed(frames: torch.Tensor, tables: MelTables,
                   log_const: float, power: float = 2.0,
                   log_mode: str = 'eps') -> torch.Tensor:
    """(B, T, frame_len) f32 sample frames -> (B, T, n_mels): the frames
    laid end to end are a signal whose frames start every ``frame_len``
    samples, so this is :func:`log_mel` with ``hop = frame_len`` and no
    pad, on either device."""
    batch, n_frames, frame_len = frames.shape
    if frame_len != tables.frame_len:
        raise ValueError(f'log_mel_framed: frames of {frame_len} samples, '
                         f'tables for {tables.frame_len}')
    return log_mel(frames.reshape(batch, n_frames * frame_len), tables,
                   frame_len, 0, n_frames, log_const, power, log_mode)


def log_mel_flops(batch: int, n_frames: int, n_fft: int, nnz: int,
                  n_mels: int) -> int:
    """Operations the log-mel function needs, counted by its cheapest
    algorithm: window, a real FFT of ``n_fft`` points (2.5 n log2 n, half
    of a complex radix-2 FFT's 5 n log2 n), power of the n_fft/2 + 1 bins,
    mel projection over the filterbank's ``nnz`` nonzeros, log.  The same
    count for both modes: K2 does them in f32 (67 TFLOP/s on the H100),
    K2x in float64 (34 TFLOP/s)."""
    fft = round(2.5 * n_fft * math.log2(n_fft))
    k = n_fft // 2 + 1
    return batch * n_frames * (n_fft + fft + 3 * k + 2 * nnz + n_mels)


def fft_kernel_flops(batch: int, n_frames: int, n_fft: int, nnz: int,
                     n_mels: int) -> int:
    """Operations the kernel runs: window, a complex radix-2 FFT of n_fft/2
    points (n_fft/4 butterflies of 10 operations per stage), the real-input
    split (16 per bin), power, mel over the nonzeros, log."""
    m = n_fft // 2
    k = m + 1
    fft = 5 * m * round(math.log2(m))
    return batch * n_frames * (n_fft + fft + 16 * k + 3 * k + 2 * nnz
                               + n_mels)


def log_mel_bytes(batch: int, n_samples: int, n_frames: int, frame_len: int,
                  hop: int, n_fft: int, nnz: int, n_mels: int,
                  table_bytes: int = 4) -> int:
    """Bytes the log-mel function must move: the f32 samples its frames
    cover, the window and the filterbank's nonzeros (``table_bytes`` each:
    4 in fast mode, 8 in exact mode) and, per mel, first bin, count and
    offset (int32), each read once, and the f32 output written once.  The
    twiddle table (and the direct DFT's matrices) are operands of an
    algorithm, not of the function, and are left out."""
    covered = min(n_frames * min(frame_len, hop) + max(frame_len - hop, 0),
                  n_samples)
    return (4 * (batch * covered + 3 * n_mels + batch * n_frames * n_mels)
            + table_bytes * (n_fft + nnz))
