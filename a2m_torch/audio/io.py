"""Audio file I/O and feature extraction from a wav file.

The port's own copy of ``a2m/audio/io.py`` (capability parity with
`pose_video/audio_lib.py:25-64`): wav read/write through scipy, resampling
(:mod:`a2m_torch.audio.mel_np`), ffmpeg audio extraction from video when
ffmpeg is present, and :func:`wav_to_features`, which runs the exact-mode
frontend on the card (the log-mel kernel K2x) unless the caller asks for
the CPU.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np
import torch

from a2m_torch.audio import frontend, mel_np
from a2m_torch.device import resolve_device


def save_wav(path, y: np.ndarray, sr: int) -> None:
    """Write float waveform in [-1, 1] (or int16) to a wav file."""
    from scipy.io import wavfile
    y = np.asarray(y)
    if y.dtype.kind == 'f':
        y = np.clip(y, -1.0, 1.0)
        y = (y * 32767.0).astype(np.int16)
    wavfile.write(str(path), int(sr), y)


def load_wav(path) -> tuple[np.ndarray, int]:
    """Read a wav file -> (float64 waveform in [-1, 1], sample_rate)."""
    from scipy.io import wavfile
    sr, y = wavfile.read(str(path))
    if y.dtype.kind == 'i':
        y = y.astype(np.float64) / np.iinfo(y.dtype).max
    elif y.dtype.kind == 'u':
        info = np.iinfo(y.dtype)
        y = (y.astype(np.float64) - (info.max + 1) / 2) / ((info.max + 1) / 2)
    else:
        y = y.astype(np.float64)
    return y, int(sr)


def resample(y: np.ndarray, orig_sr: int, target_sr: int,
             method: str = 'kaiser_best') -> np.ndarray:
    """Resampling (audio_lib.py / librosa kaiser_best parity by default)."""
    return mel_np.resample(y, orig_sr, target_sr, method=method)


def extract_audio_from_video(video_path, wav_path, sr: int = 16000) -> None:
    """ffmpeg audio extraction (audio_lib.py:25-35); requires ffmpeg."""
    if shutil.which('ffmpeg') is None:
        raise RuntimeError('ffmpeg not available for audio extraction')
    subprocess.call(
        f'ffmpeg -loglevel panic -i "{video_path}" -ar {sr} -ac 1 '
        f'"{wav_path}" -y', shell=True)


def wav_to_features(path, method: str = 'log_mel_512',
                    device='cuda') -> np.ndarray:
    """One-call wav -> exact-mode log-mel features (T, n_mels) float32,
    computed on ``device`` (the log-mel kernel K2x on CUDA, its float64
    plain version on the CPU).  'log_mel_400' and 'vggish' resample to
    16 kHz first (kaiser_best)."""
    dev = resolve_device(device)
    y, sr = load_wav(path)
    if method == 'log_mel_512':
        y32 = torch.from_numpy(y.astype(np.float32)).to(dev)
        return frontend.log_mel_512(y32, sr).cpu().numpy()
    if method not in ('log_mel_400', 'vggish'):
        raise ValueError(f'unknown method {method!r}')
    y16 = torch.from_numpy(resample(y, sr, 16000).astype(np.float32)).to(dev)
    if method == 'log_mel_400':
        return frontend.log_mel_400(y16).cpu().numpy()
    return frontend.vggish_log_mel(y16).cpu().numpy()
