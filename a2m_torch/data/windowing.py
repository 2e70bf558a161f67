"""Sliding-window index arithmetic.

The port's own copy of ``a2m/data/windowing.py``.  Exact reproduction of
the reference's per-modality windowing (`pats/data_loading/
dataUtils.py:585-620`): window = int(time * fs) source rows, resampling to
fs_new by stride slicing with ratio round(fs / fs_new), hop of window_hop
* ratio source rows; and the drift-free :class:`ExactWindowIndex`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class WindowIndex:
    starts: np.ndarray     # (n_windows,) start row in source array
    window: int            # source rows per window
    stride: int            # fs_ratio: source rows per output frame
    out_len: int           # output frames per window  == ceil(window/stride)

    def __len__(self) -> int:
        return len(self.starts)

    def slice(self, data: np.ndarray, idx: int) -> np.ndarray:
        s = int(self.starts[idx])
        return data[s:s + self.window:self.stride]


@dataclass(frozen=True)
class ExactWindowIndex:
    """Drift-free windowing (a2m extension, ``DataLoader(exact_windows=True)``).

    The reference resamples by stride slicing with the ROUNDED ratio
    round(fs/fs_new) (dataUtils.py:585-620): window k, output frame i reads
    source row hop*k + stride*i, so whenever fs/fs_new is fractional the
    audio grid drifts off the pose grid by k*(stride - fs/fs_new)/fs seconds
    per window — 1.3 s over a 120 s interval for log_mel_512 (89/15), enough
    to destroy frame-diff predictability (LEARNING.md "fixture drift").

    Exact mode instead defines windows on the OUTPUT (fs_new) frame grid and
    gathers, per frame, the nearest source row ``round(j * fs / fs_new)``:
    worst-case timestamp error is half a source sample, independent of
    window index.  ``fs`` may be a float (e.g. 45600/512 = 89.0625) for
    zero systematic drift on real PATS rates.
    """
    start_frames: np.ndarray   # (n_windows,) output-grid start frame
    fs: float
    fs_new: int
    out_len: int
    n_rows: int

    def __len__(self) -> int:
        return len(self.start_frames)

    def slice(self, data: np.ndarray, idx: int) -> np.ndarray:
        j = self.start_frames[idx] + np.arange(self.out_len)
        rows = np.rint(j * (self.fs / self.fs_new)).astype(np.int64)
        return data[np.minimum(rows, self.n_rows - 1)]

    def start_time(self, idx: int) -> float:
        return float(self.start_frames[idx]) / self.fs_new

    # -- WindowIndex-compatible views (text fields, meta timestamps) --------
    @property
    def stride(self) -> int:
        return round(self.fs / self.fs_new)

    @property
    def window(self) -> int:
        return self.out_len * self.stride

    @property
    def starts(self) -> np.ndarray:
        return np.rint(self.start_frames
                       * (self.fs / self.fs_new)).astype(np.int64)


def exact_window_index(n_rows: int, fs: float, fs_new: int, time: float,
                       window_hop: int = 0) -> ExactWindowIndex:
    """Drift-free counterpart of :func:`window_index` (same hop semantics:
    windows advance by ``window_hop`` output frames, or tile back-to-back
    when 0; the final flush window is likewise dropped)."""
    out_len = len(range(0, int(time * fs), round(fs / fs_new)))
    hop = window_hop if window_hop else out_len
    ratio = fs / fs_new
    # keep every window whose last gathered row exists
    max_start = (n_rows - 1) / ratio - (out_len - 1)
    n = max(int(np.floor(max_start / hop)), 0)   # excludes the flush window
    starts = np.arange(n, dtype=np.int64) * hop
    return ExactWindowIndex(start_frames=starts, fs=float(fs),
                            fs_new=fs_new, out_len=out_len, n_rows=n_rows)


def window_index(n_rows: int, fs: int, fs_new: int, time: float,
                 window_hop: int = 0) -> WindowIndex:
    """Window starts for one modality of one interval.

    With window_hop == 0, windows tile back-to-back; otherwise they advance
    by ``window_hop`` *output* frames (= window_hop * fs_ratio source rows).
    Mirrors reference arithmetic including its exclusive range end (the
    final window starting exactly at n_rows - window is dropped).
    """
    window = int(time * fs)
    assert window_hop < window, (
        f'hop size {window_hop} must be less than window size {window}')
    fs_ratio = round(fs / fs_new)
    if not window_hop:
        starts = np.arange(0, max(n_rows - window, 0), window, dtype=np.int64)
    else:
        starts = np.arange(0, max(n_rows - window, 0),
                           int(window_hop * fs_ratio), dtype=np.int64)
    out_len = len(range(0, window, fs_ratio))
    return WindowIndex(starts=starts, window=window, stride=fs_ratio,
                       out_len=out_len)
