"""Legacy pose encode/decode with per-speaker statistics.

The port's own copy of ``a2m/data/pose_codec.py``, with its data asset
(``assets/legacy_speaker_stats.json``, the same bytes).  Capability parity
with `pose_video/pose_logic_lib.py` (the Speech2Gesture lineage codecs the
reference vendors): relative-to-root encoding,
per-speaker standardization, denormalize + optional scale-to-reference-
speaker + translate, face-keypoint removal, conditioned-timestep slicing.

Differences, deliberate:
* works for any keypoint count (the legacy code pins 49/98); defaults to the
  52-joint PATS skeleton;
* speaker statistics are computed from data
  (:class:`SpeakerStats`) rather than hardcoded constants
  (`pose_video/consts.py:39-604` hardcodes 10 speakers);
* pure numpy — the TF variant (`pose_logic_lib.py:17-23`) is subsumed by
  `preprocess_to_relative`, which also takes torch tensors unchanged.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_EPS = np.finfo(float).eps

#: model_23 OpenPose face keypoints in the legacy 52/49-joint layouts
FACE_KEYPOINTS = [7, 8, 9]


@dataclass
class SpeakerStats:
    """Per-speaker mean/std/scale registry (replaces SPEAKERS_CONFIG)."""
    stats: dict = field(default_factory=dict)

    @classmethod
    def compute(cls, batcher_by_speaker: dict, key: str = 'pose/data',
                reference_speaker: str | None = None) -> 'SpeakerStats':
        """Compute neck-relative mean/std per speaker from data batchers;
        scale_factor maps each speaker's shoulder span to the reference
        speaker's (the legacy 'scale to jon')."""
        from a2m_torch.data.normalization import get_mean_std_necksub
        stats = {}
        for speaker, batcher in batcher_by_speaker.items():
            mean, std = get_mean_std_necksub(batcher, key=key)
            # per-feature median over a sample of frames (the reference's
            # per-speaker configs carry mean/median/std, consts.py:39-604)
            frames = []
            for batch in batcher:
                p = batch[key][batch['mask'] > 0] if 'mask' in batch \
                    else batch[key]
                frames.append(p.reshape(-1, p.shape[-1]))
                if sum(f.shape[0] for f in frames) > 50000:
                    break
            median = np.median(np.concatenate(frames), axis=0)
            stats[speaker] = dict(mean=mean.tolist(), std=std.tolist(),
                                  median=median.tolist(), scale_factor=1.0)
        if reference_speaker and reference_speaker in stats:
            def span(s):
                m = np.asarray(s['mean'])
                # shoulder distance in x between joints 1 (RShoulder) and 4
                return abs(m[1] - m[4]) + _EPS
            ref = span(stats[reference_speaker])
            for sp in stats:
                stats[sp]['scale_factor'] = float(ref / span(stats[sp]))
        return cls(stats)

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.stats))

    @classmethod
    def load(cls, path) -> 'SpeakerStats':
        return cls(json.loads(Path(path).read_text()))

    @classmethod
    def load_legacy(cls) -> 'SpeakerStats':
        """The reference's published 10-speaker constants
        (`pose_video/consts.py:39-604`: mean/median/std + scale-to-jon per
        speaker, 98-dim legacy 49-joint layout), shipped as a data asset so
        legacy decodes (:func:`decode_pose_normalized_keypoints` with
        ``num_keypoints=49``) bit-match reference renders."""
        return cls.load(Path(__file__).parent / 'assets'
                        / 'legacy_speaker_stats.json')

    def mean(self, speaker: str) -> np.ndarray:
        return np.asarray(self.stats[speaker]['mean'])

    def std(self, speaker: str) -> np.ndarray:
        return np.asarray(self.stats[speaker]['std'])

    def median(self, speaker: str) -> np.ndarray:
        return np.asarray(self.stats[speaker]['median'])

    def scale_factor(self, speaker: str) -> float:
        return float(self.stats[speaker].get('scale_factor', 1.0))


def preprocess_to_relative(k, reshape: bool = True, num_keypoints: int = 52):
    """Root-relative encoding (pose_logic_lib.py:9-15): subtract joint 0."""
    reshaped = k.reshape((-1, 2, num_keypoints))
    relative = reshaped - reshaped[:, :, 0:1]
    if reshape:
        return relative.reshape((-1, num_keypoints * 2))
    return relative


def normalize_relative_keypoints(k, speaker: str, stats: SpeakerStats):
    """(pose_logic_lib.py:5-6)"""
    return (k - stats.mean(speaker)) / (stats.std(speaker) + _EPS)


def de_normalize_relative_keypoints(k, speaker: str, stats: SpeakerStats,
                                    scale_to_ref: bool = False):
    """(pose_logic_lib.py:26-30)"""
    keypoints = k * (stats.std(speaker) + _EPS) + stats.mean(speaker)
    if scale_to_ref:
        keypoints = stats.scale_factor(speaker) * keypoints
    return keypoints


def translate_keypoints(keypoints, shift):
    """(pose_logic_lib.py:46-47)"""
    return keypoints + np.reshape(shift, (1, 2, 1))


def decode_pose_normalized_keypoints(encoded, shift, speaker: str,
                                     stats: SpeakerStats,
                                     scale_to_ref: bool = True,
                                     num_keypoints: int = 52):
    """Full decode: zero the root, denormalize, translate
    (pose_logic_lib.py:33-40)."""
    encoded = np.array(encoded).reshape((-1, 2, num_keypoints))
    encoded[:, :, 0] = 0.0
    flat = encoded.reshape((-1, num_keypoints * 2))
    den = de_normalize_relative_keypoints(flat, speaker, stats, scale_to_ref)
    return translate_keypoints(den.reshape((-1, 2, num_keypoints)), shift)


def delete_face_keypoints(k, axis: int = 1):
    """Drop nose/eyes (pose_logic_lib.py:50-56)."""
    return np.delete(k, FACE_KEYPOINTS, axis=axis)


def conditioned_timesteps(train_ratio: float, num_timesteps: int) -> int:
    """(pose_logic_lib.py:76-77)"""
    return int(train_ratio * num_timesteps)


def get_sample_output_by_config(x, train_ratio: float | None):
    """Slice off conditioning timesteps (pose_logic_lib.py:69-73)."""
    if train_ratio is None:
        return x
    return x[:, conditioned_timesteps(train_ratio, x.shape[1]):]
