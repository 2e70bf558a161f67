"""Evaluation metrics: PCK and L2 (``a2m/eval/metrics.py``)."""

from __future__ import annotations

import numpy as np
import torch


def pck_radius(gt: torch.Tensor, alpha: float) -> torch.Tensor:
    """alpha * max(bbox height, bbox width) per sample.

    gt: (N, 2, K) keypoints (row 0 = x, row 1 = y)."""
    width = (gt[:, 0].amax(dim=-1) - gt[:, 0].amin(dim=-1)).abs()
    height = (gt[:, 1].amax(dim=-1) - gt[:, 1].amin(dim=-1)).abs()
    return torch.maximum(width, height) * alpha


def compute_pck(pred: torch.Tensor, gt: torch.Tensor, alpha: float = 0.2
                ) -> torch.Tensor:
    """Fraction of keypoints within alpha * person-scale of ground truth.
    pred/gt: (N, 2, K); returns (N,) per-sample PCK."""
    radius = pck_radius(gt, alpha)[:, None]
    dist = torch.linalg.norm(gt - pred, dim=1)          # (N, K)
    return (dist <= radius).float().mean(dim=1)


def compute_pck_np(pred: np.ndarray, gt: np.ndarray, alpha: float = 0.2
                   ) -> np.ndarray:
    """NumPy twin of :func:`compute_pck` for host-side analysis."""
    width = np.abs(gt[:, 0].max(axis=-1) - gt[:, 0].min(axis=-1))
    height = np.abs(gt[:, 1].max(axis=-1) - gt[:, 1].min(axis=-1))
    radius = (np.maximum(width, height) * alpha)[:, None]
    dist = np.linalg.norm(gt - pred, axis=1)
    return (dist <= radius).mean(axis=1)


def l2_pose_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean per-joint L2 error.  pred/gt: (..., 2, K) keypoints or flat
    (..., 2K) block-layout vectors."""
    if pred.dim() < 2 or pred.shape[-2] != 2:
        k = pred.shape[-1] // 2
        pred = pred.reshape(*pred.shape[:-1], 2, k)
        gt = gt.reshape(*gt.shape[:-1], 2, k)
    return torch.linalg.norm(gt - pred, dim=-2).mean()


def pose_blocks_to_keypoints(pose: np.ndarray) -> np.ndarray:
    """(..., 104) block layout -> (..., 2, 52) keypoint layout for PCK."""
    return np.asarray(pose).reshape(*pose.shape[:-1], 2, 52)
