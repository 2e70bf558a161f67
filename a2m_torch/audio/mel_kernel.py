"""Fused log-mel: CUDA kernel wrappers, their plain version, their cost
model.

Two kernels replace the Pallas TPU kernel ``a2m/audio/pallas_mel.py::
_kernel`` (called by ``pallas_log_mel``, ``:68-232``): framing of the
waveform (centred and reflect-padded, or unpadded), window, real FFT of
``n_fft`` points, power or magnitude, mel projection over the filterbank's
nonzeros onto up to 128 mels, and ``log(max(mel, c))`` or ``log(mel +
c)``.  The tables' type picks one: K2 (``a2m_torch/csrc/log_mel.cu``; f32
tables, f32 arithmetic: a2m's fast mode) or K2x
(``a2m_torch/csrc/log_mel_exact.cu``; float64 tables and arithmetic:
a2m's exact mode, ``:96-125``, within 1e-5 of the float64 golden).  A
stack of frames cut by the client goes through the same kernels as a
signal with ``hop = frame_len`` and no pad (:func:`log_mel_framed`).

:func:`log_mel` launches a kernel for CUDA tensors and runs
:func:`log_mel_plain`, the direct windowed DFT in the tables' type, for
CPU tensors, and for nothing else.  It calls the registered torch op
``a2m_torch::log_mel``, which takes the tables as their tensors: the plain
version is the op's CPU kernel, the launch its CUDA kernel, and a fake
kernel gives the output's shape, so ``torch.export`` traces the log-mel as
one node that runs the CUDA kernel in the exported program.  What either
reads besides the waveform is a :class:`MelTables` (built by
``frontend.mel_tables``); K2x's FFT plan,
twiddle tables and mel schedule are :func:`exact_plan`,
:func:`exact_twiddles` and :func:`mel_schedule`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

MAX_MELS = 128    # the kernel's mel width
MAX_FFT = 2048    # the kernel's largest FFT (1024 complex points a block)
#: K2x: threads of one group, which transforms 64 / tpf frames at a time
#: (tpf threads a frame, see :func:`exact_plan`)
EXACT_GROUP = 64


@dataclass(frozen=True, eq=False)
class MelTables:
    """The log-mel's constants on one device, all float32 (fast mode, K2)
    or all float64 (exact mode, K2x) but the int32 index tables.

    The kernel's: ``window`` (n_fft,), the window as the frame of ``n_fft``
    points sees it (zero outside it); ``twiddle`` (n, 2) as (re, im), built
    in float64: K2's ``exp(-2 pi i k / n_fft)`` for k < n_fft/2, K2x's
    per-pass and split tables of :func:`exact_twiddles`; ``mel_bins``
    (n_mels, 3) int32, each mel's first nonzero bin, bin count and offset
    into ``mel_weights`` (nnz,), the dense filterbank's entries.  K2x's mel
    runs by the schedule of :func:`mel_schedule`: ``sched_weights`` (Q,
    tpf) float64, ``sched_index`` (Q, tpf) int32, ``mel_pieces`` (n_mels +
    1,) int32 (None in fast mode).  The plain version's: ``dr``, ``di``
    (frame_len, K) window-folded DFT matrices and ``mel`` (K, n_mels); None
    on a CUDA device, where only the kernel reads the tables."""
    frame_len: int
    window: torch.Tensor
    twiddle: torch.Tensor
    mel_bins: torch.Tensor
    mel_weights: torch.Tensor
    sched_weights: torch.Tensor | None = None
    sched_index: torch.Tensor | None = None
    mel_pieces: torch.Tensor | None = None
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
                                 self.mel_weights, self.sched_weights,
                                 self.sched_index, self.mel_pieces, self.dr,
                                 self.di, self.mel)
                     if t is not None)


def exact_plan(n_fft: int) -> dict:
    """K2x's FFT of the ``m = n_fft / 2`` complex points of a frame: a
    Stockham FFT of radix-16 passes and a last pass of radix 2, 4 or 8
    (``radices``), each thread holding ``points`` (16, or m when m < 16) in
    registers, ``tpf = m / points`` threads a frame, ``lanes = 64 / tpf``
    frames a group of :data:`EXACT_GROUP` threads.  At n_fft 2048: 16 x 16
    x 4, 64 threads a frame; at 512: 16 x 4 x 4, 16 threads a frame, 4
    frames a group.  The last pass's radix is 2, 4 or 8 whenever a frame
    spans threads, so that each thread ends holding both bins k and m - k
    of the real-input split (see ``log_mel_exact.cu``)."""
    m = n_fft // 2
    log2m = m.bit_length() - 1
    if log2m <= 4:
        radices = (m,)
    elif log2m % 4 == 0:
        radices = (16,) * (log2m // 4 - 1) + (4, 4)
    else:
        radices = (16,) * (log2m // 4) + (1 << log2m % 4,)
    points = min(16, m)
    tpf = m // points
    spans = [math.prod(radices[:q]) for q in range(len(radices))]
    twiddles = (sum((r - 1) * p for r, p in zip(radices[1:], spans[1:]))
                + m // radices[-1])
    return dict(m=m, radices=radices, points=points, tpf=tpf,
                lanes=EXACT_GROUP // tpf, twiddles=twiddles)


def exact_twiddles(n_fft: int) -> np.ndarray:
    """K2x's twiddle tables, (n, 2) float64 (re, im), concatenated in pass
    order.  Pass q > 0 of radix R after passes whose radices multiply to p
    reads ``exp(-2 pi i j k / (p R))`` at ``(j - 1) p + k`` (j in [1, R), k
    in [0, p)): a thread's k are consecutive with its index, so a warp
    reads consecutive entries.  Then the split's ``exp(-pi i k / m)`` for k
    in [0, m / R_last); bin k = k0 + (m / R_last) j of the split takes it
    at k0 times the constant ``exp(-pi i j / R_last)``."""
    plan = exact_plan(n_fft)
    m, radices = plan['m'], plan['radices']
    parts, p = [], radices[0]
    for r in radices[1:]:
        j, k = np.meshgrid(np.arange(1, r), np.arange(p), indexing='ij')
        parts.append((-2.0 * np.pi * (j * k) / (p * r)).ravel())
        p *= r
    parts.append(-np.pi * np.arange(m // radices[-1]) / m)
    ang = np.concatenate(parts)
    return np.stack([np.cos(ang), np.sin(ang)], -1)


def mel_schedule(mel_bins: np.ndarray, mel_weights: np.ndarray,
                 n_fft: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """K2x's mel over the filterbank's nonzeros, spread over the ``tpf``
    threads of a frame (:func:`exact_plan`) by bin: thread t takes the
    nonzeros of bins [t B, (t + 1) B) (B = m / tpf for the m + 1 bins, the
    last thread also bin m), in bin order and, within a bin, mel order.  A
    bin lies in at most two filters, adjacent ones, so a thread keeps two
    running sums picked by the mel's parity, and stores one as a partial sum
    (a piece) at its mel's last nonzero in the thread's bins; mel j is then
    the sum, in order, of its pieces ``pieces[j]:pieces[j + 1]`` (in thread
    order).  A thread holds at most 2 B nonzeros (ceil(nnz / tpf) at
    log_mel_512).  Returns ``weights`` (rows, tpf) float64, ``index``
    (rows, tpf) int32 and ``pieces`` (n_mels + 1,) int32, rows being the
    most a thread holds rounded up to a multiple of 8 (the kernel loads 8
    steps at a time; the padding has weight 0).  ``index`` holds the bin's
    slot among the kernel's bins, k + k // 16 (a pad every 16 bins: step by
    step the threads read bins ~B apart, which the pad sends to distinct
    banks), the mel's parity at bit 15 and (piece + 1) << 16 where a piece
    ends.  A fixed schedule: every frame's sums run in the same order."""
    plan = exact_plan(n_fft)
    threads, width = plan['tpf'], plan['m'] // plan['tpf']
    first, count, offset = (mel_bins[:, c].astype(np.int64)
                            for c in range(3))
    n_mels, nnz = len(count), int(count.sum())
    mel_of = np.repeat(np.arange(n_mels), count)
    bin_of = first[mel_of] + np.arange(nnz) - offset[mel_of]
    if nnz and np.bincount(bin_of).max() > 2:
        raise ValueError('mel_schedule: a bin lies in more than two filters')
    thread_of = np.minimum(bin_of // width, threads - 1)
    runs = [sorted(np.flatnonzero(thread_of == t),
                   key=lambda n: (bin_of[n], mel_of[n]))
            for t in range(threads)]
    rows = -(-max(1, max(len(r) for r in runs)) // 8) * 8
    weights = np.zeros((rows, threads))
    index = np.zeros((rows, threads), np.int64)
    ends = []                        # (mel, thread, row) of each piece
    for t, run in enumerate(runs):
        for q, n in enumerate(run):
            weights[q, t] = mel_weights[n]
            index[q, t] = (bin_of[n] + (bin_of[n] >> 4)
                           + ((mel_of[n] & 1) << 15))
            if all(mel_of[r] != mel_of[n] for r in run[q + 1:]):
                ends.append((mel_of[n], t, q))
    ends.sort()
    for piece, (_, t, q) in enumerate(ends):
        index[q, t] += (piece + 1) << 16
    per_mel = np.bincount([e[0] for e in ends], minlength=n_mels)
    pieces = np.concatenate([[0], np.cumsum(per_mel)]).astype(np.int32)
    return weights, index.astype(np.int32), pieces


def exact_launch(n_fft: int, n_mels: int, sched_rows: int, frame_len: int,
                 hop: int) -> dict:
    """K2x's launch plan on the current CUDA device, from the kernel's own
    ``a2m_log_mel_exact_info``: frames and threads a block, dynamic shared
    bytes, blocks an SM, registers, spill bytes, the card's SMs (the most
    blocks a launch takes) and threads a frame."""
    from a2m_torch import _build
    lib = _build.load('log_mel_exact')
    out = np.zeros(8, np.int32)
    _build.check(lib, lib.a2m_log_mel_exact_info(
        n_fft, n_mels, sched_rows, frame_len, hop, out.ctypes.data),
        'log_mel_exact_info')
    return dict(zip(('frames_a_block', 'threads', 'smem_bytes',
                     'blocks_per_sm', 'registers', 'spill_bytes', 'sms',
                     'threads_a_frame'), map(int, out)))


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
    than ``n_fft``, more than :data:`MAX_MELS` mels.  K2 and K2x take the
    same shapes."""
    if not 4 <= n_fft <= MAX_FFT or n_fft & (n_fft - 1):
        raise ValueError(f'log_mel: n_fft {n_fft} is not a power of two '
                         f'from 4 to {MAX_FFT}')
    if not 1 <= frame_len <= n_fft:
        raise ValueError(f'log_mel: frames of {frame_len} samples do not fit '
                         f'n_fft {n_fft}')
    if not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f'log_mel: {n_mels} mels, the kernel takes 1 to '
                         f'{MAX_MELS}')


def _check_log_mel_args(y: torch.Tensor, tables: MelTables, power: float,
                        log_mode: str, exact: bool) -> None:
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
    if y.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'log_mel: no kernel for device {y.device}')
    if exact != tables.exact:
        raise ValueError(f'log_mel: exact={exact} with '
                         f'{tables.window.dtype} tables')


def _tables(window, twiddle, mel_bins, mel_weights, sched_weights,
            sched_index, mel_pieces, dr, di, mel, frame_len) -> MelTables:
    return MelTables(frame_len, window, twiddle, mel_bins, mel_weights,
                     sched_weights, sched_index, mel_pieces, dr, di, mel)


@torch.library.custom_op('a2m_torch::log_mel', mutates_args=(),
                         device_types='cpu')
def _log_mel_op(y: torch.Tensor, window: torch.Tensor,
                twiddle: torch.Tensor, mel_bins: torch.Tensor,
                mel_weights: torch.Tensor,
                sched_weights: torch.Tensor | None,
                sched_index: torch.Tensor | None,
                mel_pieces: torch.Tensor | None, dr: torch.Tensor | None,
                di: torch.Tensor | None, mel: torch.Tensor | None,
                frame_len: int, hop: int, pad: int, n_frames: int,
                log_const: float, power: float, log_mode: str,
                exact: bool) -> torch.Tensor:
    """The op's CPU kernel: :func:`log_mel_plain` on the tables' dense
    matrices, in float64 for exact tables."""
    tables = _tables(window, twiddle, mel_bins, mel_weights, sched_weights,
                     sched_index, mel_pieces, dr, di, mel, frame_len)
    _check_log_mel_args(y, tables, power, log_mode, exact)
    if dr is None:
        raise ValueError('log_mel: CPU tables without the dense matrices')
    out = log_mel_plain(y.double() if exact else y, dr, di, mel, hop, pad,
                        n_frames, log_const, power, log_mode)
    return out.float()


@_log_mel_op.register_fake
def _log_mel_fake(y, window, twiddle, mel_bins, mel_weights, sched_weights,
                  sched_index, mel_pieces, dr, di, mel, frame_len, hop, pad,
                  n_frames, log_const, power, log_mode, exact):
    tables = _tables(window, twiddle, mel_bins, mel_weights, sched_weights,
                     sched_index, mel_pieces, dr, di, mel, frame_len)
    _check_log_mel_args(y, tables, power, log_mode, exact)
    return y.new_empty((y.shape[0], n_frames, mel_bins.shape[0]))


def log_mel(y: torch.Tensor, tables: MelTables, hop: int, pad: int,
            n_frames: int, log_const: float, power: float = 2.0,
            log_mode: str = 'eps') -> torch.Tensor:
    """(B, N) f32 waveform -> (B, n_frames, n_mels) f32 log-mel.

    ``power`` 2 or 1 (magnitude); ``log_mode`` ``'eps'``
    (``log(max(mel, log_const))``) or ``'offset'`` (``log(mel +
    log_const)``).  f32 tables give the fast mode, float64 tables the exact
    mode.  CUDA tensors launch the kernel (K2 or K2x), CPU tensors run
    :func:`log_mel_plain` on the tables' dense matrices, in float64 for
    exact tables.  Calls the op ``a2m_torch::log_mel``."""
    t = tables
    return torch.ops.a2m_torch.log_mel(
        y, t.window, t.twiddle, t.mel_bins, t.mel_weights, t.sched_weights,
        t.sched_index, t.mel_pieces, t.dr, t.di, t.mel, t.frame_len, hop,
        pad, n_frames, log_const, power, log_mode, t.exact)


@_log_mel_op.register_kernel('cuda')
def _log_mel_cuda(y, window, twiddle, mel_bins, mel_weights, sched_weights,
                  sched_index, mel_pieces, dr, di, mel, frame_len, hop, pad,
                  n_frames, log_const, power, log_mode, exact):
    """The op's CUDA kernel: K2's launch, or K2x's for exact tables."""
    tables = _tables(window, twiddle, mel_bins, mel_weights, sched_weights,
                     sched_index, mel_pieces, dr, di, mel, frame_len)
    _check_log_mel_args(y, tables, power, log_mode, exact)
    n_fft, n_mels = tables.n_fft, tables.n_mels
    check_kernel_shapes(n_fft, tables.frame_len, n_mels)
    from a2m_torch import _build
    y = y.contiguous()
    batch = y.shape[0]
    out = torch.empty(batch, n_frames, n_mels, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    if exact:
        check_exact_tables(tables)
        lib = _build.load('log_mel_exact')
        code = lib.a2m_log_mel_exact(
            y.data_ptr(), out.data_ptr(), tables.window.data_ptr(),
            tables.twiddle.data_ptr(), tables.sched_weights.data_ptr(),
            tables.sched_index.data_ptr(), tables.mel_pieces.data_ptr(),
            batch, y.shape[1], tables.frame_len, hop, pad, n_frames, n_fft,
            n_mels, tables.sched_weights.shape[0], int(power == 1.0),
            int(log_mode == 'offset'), log_const, stream)
        _build.check(lib, code, 'log_mel_exact')
        log_mel.exact_launches += 1
        return out
    if (tables.twiddle.shape != (n_fft // 2, 2)
            or tables.mel_bins.shape != (n_mels, 3)
            or tables.mel_bins.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in (
                tables.window, tables.twiddle, tables.mel_weights))
            or not all(t.is_contiguous() for t in tables.tensors())):
        raise ValueError('log_mel: tables of the wrong shape, type or '
                         'layout for the kernel')
    lib = _build.load('log_mel')
    code = lib.a2m_log_mel(
        y.data_ptr(), out.data_ptr(), tables.window.data_ptr(),
        tables.twiddle.data_ptr(), tables.mel_bins.data_ptr(),
        tables.mel_weights.data_ptr(), batch, y.shape[1], tables.frame_len,
        hop, pad, n_frames, n_fft, n_mels, int(power == 1.0),
        int(log_mode == 'offset'), log_const, stream)
    _build.check(lib, code, 'log_mel')
    log_mel.launches += 1
    return out


def check_exact_tables(tables: MelTables) -> None:
    """Raise ``ValueError`` unless ``tables`` are what K2x reads: float64
    window and twiddles of :func:`exact_twiddles`, a float64 / int32
    schedule of :func:`mel_schedule` for the plan's threads a frame, int32
    pieces, all contiguous."""
    plan = exact_plan(tables.n_fft)
    sched = (tables.sched_weights, tables.sched_index, tables.mel_pieces)
    if (any(t is None for t in sched)
            or tables.twiddle.shape != (plan['twiddles'], 2)
            or tables.sched_weights.ndim != 2
            or tables.sched_weights.shape[1] != plan['tpf']
            or tables.sched_index.shape != tables.sched_weights.shape
            or tables.mel_pieces.shape != (tables.n_mels + 1,)
            or any(t.dtype != torch.float64 for t in (
                tables.window, tables.twiddle, tables.sched_weights))
            or any(t.dtype != torch.int32 for t in (
                tables.sched_index, tables.mel_pieces))
            or not all(t.is_contiguous() for t in tables.tensors())):
        raise ValueError('log_mel: tables of the wrong shape, type or '
                         'layout for the exact kernel')


#: kernel launches since the count was last set to 0 (one launch is one
#: device kernel): K2 (fast mode, ``log_mel_fft_kernel``) and K2x (exact,
#: ``log_mel_exact_kernel``)
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
    count for both modes.  On the H100 K2 does them in f32 (67 TFLOP/s)
    and K2x in float64: its bound takes the 67 TFLOP/s of the fp64 tensor
    cores, the card's peak fp64 rate; an FFT runs on the fp64 pipes outside
    them, at 34 TFLOP/s (twice the bound's time, K2x's floor)."""
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
