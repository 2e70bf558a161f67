"""Pose normalization statistics.

The port's own copy of ``a2m/data/normalization.py``.  Reproduces
`normalization_tools.py:8-45`: dataset-level mean/std computed as a mean of
per-batch moments (the reference averages batch means rather than sample
means, preserved for numeric parity), plus the neck-subtracted variant with
the neck std pinned to 1.  Also provides the batch normalization that the
train steps apply on the device, fixing the reference's pairing-by-batch-
index fragility (it pre-normalizes into a list and indexes it by batch
position while the loader shuffles, version5_model_train.py:298-337).
"""

from __future__ import annotations

import numpy as np

from a2m_torch import constants


def neck_subtract(pose: np.ndarray) -> np.ndarray:
    """Subtract the Neck (joint 0) from every joint.

    pose: (..., T, 104) in block layout [x0..x51, y0..y51].
    """
    shape = pose.shape
    p = pose.reshape(*shape[:-1], 2, constants.NUM_JOINTS)
    neck = p[..., :, 0:1]
    return (p - neck).reshape(shape)


def get_mean_std(batcher, key: str = 'pose/data'
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Mean/std over the train set (reference normalization_tools.py:8-20).

    Averages per-batch moments (weighting the final ragged batch equally, as
    the reference does).  Masked batches from
    :class:`a2m_torch.data.dataset.Batcher` are handled by excluding pad
    rows.
    """
    mean_sum = np.zeros(constants.POSE_FEATS, dtype=np.float64)
    sq_sum = np.zeros(constants.POSE_FEATS, dtype=np.float64)
    batch_num = 0
    for batch_num, batch in enumerate(batcher, 1):
        pose, mask = batch[key], batch.get('mask')
        if mask is not None:
            pose = pose[mask > 0]
        mean_sum += pose.mean(axis=(0, 1))
        sq_sum += (pose.astype(np.float64) ** 2).mean(axis=(0, 1))
    mean = mean_sum / batch_num
    std = np.sqrt(np.maximum(sq_sum / batch_num - mean ** 2, 0.0))
    return mean.astype(np.float32), std.astype(np.float32)


def get_moments_necksub(batcher, key: str = 'pose/data'
                        ) -> tuple[np.ndarray, np.ndarray, int]:
    """Summable neck-subtracted moments ``(mean_sum, sq_sum, batch_num)``.

    The reference's estimator (normalization_tools.py:24-45) is a plain sum
    of per-batch moments divided by the batch count — so per-host partial
    sums from disjoint data slices combine exactly by addition
    (a multi-process run adds them across processes before
    :func:`finalize_moments_necksub`)."""
    mean_sum = np.zeros(constants.POSE_FEATS, dtype=np.float64)
    sq_sum = np.zeros(constants.POSE_FEATS, dtype=np.float64)
    batch_num = 0
    for batch_num, batch in enumerate(batcher, 1):
        pose, mask = batch[key], batch.get('mask')
        if mask is not None:
            pose = pose[mask > 0]
        pose = neck_subtract(pose)
        mean_sum += pose.mean(axis=(0, 1))
        sq_sum += (pose.astype(np.float64) ** 2).mean(axis=(0, 1))
    return mean_sum, sq_sum, batch_num


def finalize_moments_necksub(mean_sum, sq_sum, batch_num
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Moments -> (mean, std) with the neck std pinned to 1."""
    mean = np.asarray(mean_sum) / batch_num
    std = np.sqrt(np.maximum(np.asarray(sq_sum) / batch_num - mean ** 2,
                             0.0))
    # neck x/y stats are exactly 0 after subtraction; pin std to 1
    std[0] = 1.0
    std[constants.NUM_JOINTS] = 1.0
    return mean.astype(np.float32), std.astype(np.float32)


def get_mean_std_necksub(batcher, key: str = 'pose/data'
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Neck-subtracted mean/std with neck std pinned to 1 (reference
    normalization_tools.py:24-45)."""
    return finalize_moments_necksub(*get_moments_necksub(batcher, key))


def normalize_pose(pose, mean, std):
    """Neck-subtract then standardize; works on numpy arrays and torch
    tensors (the train steps normalise on the device)."""
    shape = pose.shape
    p = pose.reshape(*shape[:-1], 2, constants.NUM_JOINTS)
    neck = p[..., :, 0:1]
    p = (p - neck).reshape(shape)
    return (p - mean) / std


def denormalize_pose(pose, mean, std):
    """Inverse of standardization (neck offset is not restored — generated
    poses are neck-rooted, reference generate_motion_video.py:259-260)."""
    return pose * std + mean
