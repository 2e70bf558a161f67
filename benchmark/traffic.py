"""The benchmark's one traffic generator: seeded inputs from the parameters
of a cell's ``traffic`` block, made on the device in a few large calls.

Every seed gives the same sizes (streams, lengths, batches); the seed draws
only the content and the order of the calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds from one run seed of any size."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64) >> 1]


def speech_like(seed: int, streams: int, n_samples: int, sr: int,
                p: dict, device) -> torch.Tensor:
    """(streams, n_samples) f32 waveforms: a harmonic voice of ``harmonics``
    partials at a pitch drawn from ``f0_hz``, under a syllable envelope at
    a rate drawn from ``syllable_hz``, plus white noise at ``noise`` of the
    voice, scaled to a peak drawn from ``peak``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(lo_hi, *shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(*shape, generator=gen,
                                           device=device, dtype=torch.float64)

    t = torch.arange(n_samples, device=device, dtype=torch.float64) / sr
    f0 = uniform(p['f0_hz'], streams, 1)
    rate = uniform(p['syllable_hz'], streams, 1)
    phase = uniform((0.0, 2 * math.pi), streams, p['harmonics'] + 1)
    voice = torch.zeros(streams, n_samples, device=device,
                        dtype=torch.float64)
    for h in range(1, p['harmonics'] + 1):
        cycles = torch.frac(f0 * h * t)
        voice += torch.sin(2 * math.pi * cycles + phase[:, h:h + 1]) / h
    env = (0.5 + 0.5 * torch.sin(2 * math.pi * torch.frac(rate * t)
                                 + phase[:, :1])) ** 2
    noise = torch.randn(streams, n_samples, generator=gen, device=device,
                        dtype=torch.float32)
    y = (env * voice).float() + p['noise'] * noise
    peak = uniform(p['peak'], streams, 1).float()
    return y * (peak / y.abs().amax(dim=1, keepdim=True))


def pose_tracks(seed: int, clips: int, frames: int, fps: int
                ) -> np.ndarray:
    """(clips, frames, 104) float32 block-layout poses: the rest pose plus
    per-coordinate sinusoids of 0.2-1.5 Hz and 2-18 px (a frozen copy of
    the port's synthetic skeleton generator), so that bone lengths and
    joint angles are those of a skeleton."""
    from reference.audio2motion import rest_pose
    rng = np.random.default_rng(seed)
    rest = rest_pose()
    t = np.arange(frames)[None, :, None, None] / fps
    freq = rng.uniform(0.2, 1.5, (clips, 1, 2, 52))
    phase = rng.uniform(0, 2 * np.pi, (clips, 1, 2, 52))
    amp = rng.uniform(2.0, 18.0, (clips, 1, 2, 52))
    pose = rest[None, None] + amp * np.sin(2 * np.pi * freq * t + phase)
    return pose.reshape(clips, frames, 104).astype(np.float32)
