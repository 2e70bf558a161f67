"""Log-mel frontend of the port: fast mode for serving, exact mode for
feature extraction.

Counterpart of ``a2m/audio/frontend.py``: the :class:`MelSpec` dataclass,
the three spec families (``spec_log_mel_512``, ``spec_log_mel_400``,
``spec_vggish``, ``:58-77``), ``strided_spec`` (``:240-248``), the
window-folded DFT and mel matrices (``dft_matrices``, ``:91-135``),
``num_frames``, the centred pad (reflect or constant) and integer-PCM
scaling, :func:`log_mel` and :func:`log_mel_frames`, which run the fused
log-mel kernel (:mod:`a2m_torch.audio.mel_kernel`) on CUDA, the wrappers
:func:`log_mel_512`, :func:`log_mel_400` and :func:`vggish_log_mel`
(``:398-411``), the client-side :func:`frame_for_wire` (numpy), and the
energy VAD :func:`silence_mask` (``:420-466``).

As in a2m, ``exact=True`` is the default: within 1e-5 of the float64
golden (``mel_np``), for feature extraction; the serving paths pass
``exact=False``.  On CUDA a kernel runs a real FFT (a2m's fast path takes
the same function by a two-stage radix DFT, ``frontend.py:138-237``) and
reads the tables of :func:`fft_tables`: the window, the twiddles and the
filterbank over its nonzeros, in f32 (K2, fast mode) or float64 (K2x,
exact mode, with its own twiddle tables and mel schedule; a2m's hi/lo
split matrices and precise log need no counterpart there).  On the CPU the
plain version runs the direct windowed DFT on :func:`dft_matrices`, in f32
or float64.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

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
    """Raise for what the port's frontend does not cover."""
    if (spec.power not in (1.0, 2.0)
            or spec.log_mode not in ('eps', 'offset')
            or spec.frame_style not in ('librosa', 'vggish')
            or spec.mel_scale not in ('slaney', 'htk')
            or spec.n_mels > mel_kernel.MAX_MELS
            or spec.pad_mode not in ('reflect', 'constant')):
        raise NotImplementedError(
            f'a2m_torch log_mel: power 1 or 2, eps or offset log, librosa '
            f'or vggish frames, at most {mel_kernel.MAX_MELS} mels and a '
            f'reflect or constant pad are supported, got {spec}')


def _window(spec: MelSpec) -> np.ndarray:
    """(n_fft,) float64: the periodic Hann window of win_length as the frame
    of n_fft points sees it, centred inside n_fft for librosa frames, first
    for VGGish frames (whose samples past win_length are the zero pad)."""
    window = np.zeros(spec.n_fft)
    off = ((spec.n_fft - spec.win_length) // 2
           if spec.frame_style == 'librosa' and spec.win_length < spec.n_fft
           else 0)
    window[off:off + spec.win_length] = mel_np.periodic_hann(spec.win_length)
    return window


@functools.lru_cache(maxsize=16)
def dft_matrices(spec: MelSpec, exact: bool = False) -> dict:
    """Window-folded real/imag DFT matrices (frame_len, K) and the mel
    matrix (K, n_mels), built in float64 and stored as float32 (the f32
    "hi" parts of a2m's, bit for bit), or kept in float64 when ``exact``
    (what a2m's hi + lo pairs stand for).  The window
    sits centred inside the n_fft frame when win_length < n_fft (librosa);
    with VGGish framing the frame is win_length long and the matrices are
    the first win_length rows of the n_fft-point DFT, which absorbs the
    zero-padding to n_fft."""
    _check_supported(spec)
    n_fft, k_bins = spec.n_fft, spec.n_fft // 2 + 1
    frame_len = n_fft if spec.frame_style == 'librosa' else spec.win_length
    w_full = _window(spec)[:frame_len]
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
    dtype = np.float64 if exact else np.float32
    return dict(frame_len=frame_len, K=k_bins,
                dr=(np.cos(ang) * w_full[:, None]).astype(dtype),
                di=(np.sin(ang) * w_full[:, None]).astype(dtype),
                mel=np.ascontiguousarray(mel.astype(dtype)))


def sparse_mel(mel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense (K, n_mels) filterbank -> (``mel_bins`` (n_mels, 3) int32:
    first nonzero bin, bin count, offset into the weights; ``weights``
    (nnz,)), the dense matrix's entries bit for bit.  A mel's bins run from
    its first nonzero to its last, zeros between them included, so the
    tables rebuild the dense matrix exactly."""
    bins, weights, offset = np.zeros((mel.shape[1], 3), np.int32), [], 0
    for j in range(mel.shape[1]):
        nz = np.flatnonzero(mel[:, j])
        first, count = (nz[0], nz[-1] - nz[0] + 1) if nz.size else (0, 0)
        bins[j] = first, count, offset
        weights.append(mel[first:first + count, j])
        offset += count
    return bins, np.concatenate(weights)


def twiddles(n_fft: int, dtype=np.float32) -> np.ndarray:
    """(n_fft // 2, 2): ``exp(-2 pi i k / n_fft)`` as (re, im), built in
    float64 and rounded once to ``dtype`` (or kept in float64)."""
    ang = -2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], -1).astype(dtype)


@functools.lru_cache(maxsize=16)
def fft_tables(spec: MelSpec, exact: bool = False) -> dict:
    """What the FFT kernels read besides the waveform: the window as the
    frame of n_fft points sees it (centred inside n_fft for librosa frames;
    VGGish's frames of win_length are zero-padded to n_fft), the twiddles,
    and the filterbank of :func:`dft_matrices` over its nonzeros; f32, or
    float64 when ``exact`` (never rounded through f32).  ``exact`` adds
    K2x's own tables: ``fft_twiddle`` (``mel_kernel.exact_twiddles``) and
    the mel schedule ``sched_weights``, ``sched_index``, ``mel_pieces``
    (``mel_kernel.mel_schedule``)."""
    dtype = np.float64 if exact else np.float32
    m = dft_matrices(spec, exact)
    bins, weights = sparse_mel(m['mel'])
    out = dict(frame_len=m['frame_len'], window=_window(spec).astype(dtype),
               twiddle=twiddles(spec.n_fft, dtype), mel_bins=bins,
               mel_weights=weights)
    if exact:
        sched = mel_kernel.mel_schedule(bins, weights, spec.n_fft)
        out.update(fft_twiddle=mel_kernel.exact_twiddles(spec.n_fft),
                   sched_weights=sched[0], sched_index=sched[1],
                   mel_pieces=sched[2])
    return out


#: (spec, device, exact) -> MelTables, the 16 newest
_mel_tables: dict = {}


def mel_tables(spec: MelSpec, device: torch.device | str,
               exact: bool = False) -> mel_kernel.MelTables:
    """The log-mel's tables on ``device``, f32 or (``exact``) float64: the
    kernel's on every device, and on the CPU also the plain version's dense
    matrices.  Built once and kept, except inside a ``torch.export`` trace:
    tensors made there are fake (the exported program holds them as
    constants, copied to the device on every call), so an exporter builds
    the tables before it traces."""
    device = torch.device(device)
    key = (spec, device, exact)
    tables = _mel_tables.get(key)
    if tables is None:
        tables = _build_mel_tables(spec, device, exact)
        if not torch.compiler.is_exporting():
            if len(_mel_tables) >= 16:
                _mel_tables.pop(next(iter(_mel_tables)))
            _mel_tables[key] = tables
    return tables


def _build_mel_tables(spec: MelSpec, device: torch.device,
                      exact: bool) -> mel_kernel.MelTables:
    t = fft_tables(spec, exact)

    def put(a):
        return torch.from_numpy(a).to(device)

    extra = {}
    if device.type == 'cpu':
        m = dft_matrices(spec, exact)
        extra = {k: put(m[k]) for k in ('dr', 'di', 'mel')}
    if exact:
        extra.update({k: put(t[k]) for k in ('sched_weights', 'sched_index',
                                              'mel_pieces')})
    return mel_kernel.MelTables(
        frame_len=t['frame_len'], window=put(t['window']),
        twiddle=put(t['fft_twiddle' if exact else 'twiddle']),
        mel_bins=put(t['mel_bins']), mel_weights=put(t['mel_weights']),
        **extra)


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


def log_mel(y: torch.Tensor, spec: MelSpec, exact: bool = True,
            n_frames: int | None = None) -> torch.Tensor:
    """Batched log-mel: (..., N) waveform (float or integer PCM) -> (...,
    T, n_mels) float32, on ``y``'s device (the kernel on CUDA).
    ``exact=True`` is within 1e-5 of the float64 golden (K2x, float64
    arithmetic); ``exact=False`` is the single-f32 fast path (K2)."""
    _check_supported(spec)
    lead = y.shape[:-1]
    y = _pcm_to_float(y).reshape(-1, y.shape[-1])
    if n_frames is None:
        n_frames = num_frames(spec, y.shape[-1])
    pad = spec.n_fft // 2 if spec.center else 0
    if pad and spec.pad_mode == 'constant':
        y, pad = F.pad(y, (pad, pad)), 0
    out = mel_kernel.log_mel(y, mel_tables(spec, y.device, exact),
                             spec.hop_length, pad, n_frames, spec.log_const,
                             spec.power, spec.log_mode)
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
        y = np.pad(y, lead + [(pad, pad)], mode=spec.pad_mode)
    if n_frames is None:
        n_frames = 1 + (y.shape[-1] - frame_len) // hop
    needed = (n_frames - 1) * hop + frame_len
    if y.shape[-1] < needed:
        y = np.pad(y, lead + [(0, needed - y.shape[-1])],
                   constant_values=tail_value)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_len)[None, :]
    return y[..., idx]


def log_mel_frames(frames: torch.Tensor, spec: MelSpec,
                   exact: bool = True) -> torch.Tensor:
    """Framed-wire entry: (..., T, frame_len) sample frames (float or
    integer PCM, see :func:`frame_for_wire`) -> (..., T, n_mels) log-mel,
    identical to :func:`log_mel` on the waveform they were cut from."""
    _check_supported(spec)
    lead, (t, frame_len) = frames.shape[:-2], frames.shape[-2:]
    out = mel_kernel.log_mel_framed(
        _pcm_to_float(frames).reshape(-1, t, frame_len),
        mel_tables(spec, frames.device, exact), spec.log_const, spec.power,
        spec.log_mode)
    return out.reshape(*lead, t, spec.n_mels)


def log_mel_512(y: torch.Tensor, sr: int, exact: bool = True
                ) -> torch.Tensor:
    """librosa-parameterized log_mel_512 (reference audio.py:58-75) of a
    waveform tensor, computed on its device."""
    return log_mel(y, spec_log_mel_512(sr), exact=exact)


def log_mel_400(y: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """log_mel_400 of a 16 kHz waveform tensor (resample on the host
    first; reference audio.py:86-120)."""
    return log_mel(y, spec_log_mel_400(), exact=exact)


def vggish_log_mel(y: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """VGGish 64-bin log-mel of a 16 kHz waveform tensor (reference
    mel_features.py:192-223)."""
    return log_mel(y, spec_vggish(), exact=exact)


# ---------------------------------------------------------------------------
# Silence / VAD (energy-based stand-in for webrtcvad)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _silence_assignment(n_samples: int, fs_old: int, fs_new: int,
                        frame_ms: int) -> tuple[np.ndarray, int, int]:
    """Static (n_win, n_sub) row-normalized assignment of 10 ms sub-frames to
    1/fs_new-second windows, mirroring the reference's float window
    boundaries (audio.py:138-149)."""
    sub = fs_old * frame_ms // 1000
    step = fs_old / fs_new
    n_ranges = int(np.ceil(n_samples / step))        # np.arange(0, N, step)
    n_win = n_ranges - 1
    n_sub = n_samples // sub
    starts = np.arange(n_win) * step
    ends = starts + step
    sub_starts = np.arange(n_sub) * sub
    # sub-frame s belongs to window w when it fits wholly inside [start, end)
    a = ((sub_starts[None, :] >= starts[:, None])
         & (sub_starts[None, :] + sub <= ends[:, None])).astype(np.float32)
    a /= np.maximum(a.sum(axis=1, keepdims=True), 1.0)
    return a, n_win, n_sub


def silence_mask(y: torch.Tensor, fs_old: int = 16000, fs_new: int = 15,
                 frame_ms: int = 10, energy_db_floor: float = -40.0
                 ) -> torch.Tensor:
    """Silence detection in the reference's output format, on ``y``'s
    device (a2m's ``frontend.py:441-466``).

    The reference runs webrtcvad over 10 ms sub-frames of float-boundary
    1/15 s windows, marks a window silent when <=50% of sub-frames contain
    speech, and appends a literal 0 after every window entry
    (audio.py:129-172), so the stored `audio/silence` stream has TWO entries
    per window.  The speech decision here is a vectorized energy VAD (10 ms
    RMS above ``energy_db_floor`` dB relative to the clip peak).  ``y``:
    (..., N) float samples.  Returns int32 (..., 2 * n_windows).
    """
    a, n_win, n_sub = _silence_assignment(y.shape[-1], fs_old, fs_new,
                                          frame_ms)
    sub = fs_old * frame_ms // 1000
    y = y.float()
    frames = y[..., :n_sub * sub].reshape(*y.shape[:-1], n_sub, sub)
    rms = torch.sqrt(torch.mean(frames * frames, dim=-1) + 1e-12)
    peak = torch.amax(rms, dim=-1, keepdim=True)
    is_speech = (20.0 * torch.log10(rms / (peak + 1e-12) + 1e-12)
                 > energy_db_floor).float()
    frac = is_speech @ torch.from_numpy(a).to(y.device).T   # (..., n_win)
    silent = (frac <= 0.5).int()
    # interleave the reference's trailing zero per window
    out = torch.stack([silent, torch.zeros_like(silent)], dim=-1)
    return out.reshape(*silent.shape[:-1], 2 * n_win)
