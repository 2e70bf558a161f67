"""Motion and kinematic losses (``a2m/models/losses.py``).

Every function reads a 104-vector as the block layout ``[x0..x51, y0..y51]``
-> ``(..., 2, 52)``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from a2m_torch import constants
from a2m_torch.parallel import mesh


def pos_to_motion(pose: torch.Tensor) -> torch.Tensor:
    """First-order temporal difference: (B, T, F) -> (B, T - 1, F)."""
    return pose[:, 1:] - pose[:, :-1]


def safe_norm(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """L2 norm with a zero (not NaN) gradient at ``x == 0``.

    Temporal differences of generated motion do hit exact zeros, the more
    so where the pose is computed in bf16 (neighbouring frames round to
    one value; ``tests/test_torch_bf16.py``).  The inner
    ``where`` replaces the argument of ``sqrt`` before it is taken:
    ``where(c, 0, sqrt(sq))`` alone would still send NaN back through the
    dead branch.  The primal is exact everywhere."""
    sq = (x * x).sum(dim=axis)
    is_zero = sq == 0
    root = torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq))
    return torch.where(is_zero, torch.zeros_like(sq), root)


def temporal_smoothness_loss(motion: torch.Tensor) -> torch.Tensor:
    """Mean L2 norm of the acceleration."""
    accel = motion[:, 1:] - motion[:, :-1]
    return safe_norm(accel, axis=-1).mean()


def jerk_loss(motion: torch.Tensor) -> torch.Tensor:
    """Mean L2 norm of the jerk."""
    accel = motion[:, 1:] - motion[:, :-1]
    jerk = accel[:, 1:] - accel[:, :-1]
    return safe_norm(jerk, axis=-1).mean()


def to_joints(pose: torch.Tensor) -> torch.Tensor:
    """(..., 104) block layout -> (..., 52, 2) joint positions."""
    p = pose.reshape(*pose.shape[:-1], 2, constants.NUM_JOINTS)
    return p.transpose(-1, -2)


@functools.lru_cache(maxsize=1)
def _bone_indices() -> tuple[np.ndarray, np.ndarray]:
    """(child, parent) index pairs within JOINT_SUBSET space, roots
    excluded."""
    parents = constants.subset_parents()
    child = np.nonzero(parents != -1)[0].astype(np.int64)
    return child, parents[child].astype(np.int64)


#: (index values, device) -> their long tensor on that device
_indices: dict = {}


def _index(values, device) -> torch.Tensor:
    """``values`` as a long index tensor on ``device``, built once per
    device and kept: a step reads its joint and bone indices without a
    host-to-device copy, which would wait for the card (and which a CUDA
    graph cannot hold)."""
    values = np.asarray(values, dtype=np.int64)
    key = (values.tobytes(), torch.device(device))
    hit = _indices.get(key)
    if hit is None:
        hit = _indices[key] = torch.as_tensor(values, device=device)
    return hit


def bone_lengths(pose: torch.Tensor) -> torch.Tensor:
    """Per-bone 2-D lengths averaged over time: (B, T, 104) -> (B, n_bones),
    subset joints only."""
    child, parent = _bone_indices()
    dev = pose.device
    joints = to_joints(pose)[..., _index(constants.JOINT_SUBSET, dev), :]
    vec = joints[..., _index(child, dev), :] - joints[..., _index(parent, dev),
                                                      :]
    return safe_norm(vec, axis=-1).mean(dim=1)


def bone_length_loss(real_pose: torch.Tensor, gen_pose: torch.Tensor
                     ) -> torch.Tensor:
    """MSE between generated and real time-averaged bone lengths."""
    return ((bone_lengths(gen_pose) - bone_lengths(real_pose)) ** 2).mean()


def _signed_angles(joints: torch.Tensor, triples: np.ndarray) -> torch.Tensor:
    """Signed 2-D angle at j for each (parent, joint, child) triple:
    atan2(cross, dot) of (j - p) and (c - j).  joints (..., J, 2).

    atan2's gradient divides by cross^2 + dot^2, NaN when a limb degenerates
    to a point.  There dot is replaced by 1 before atan2 is taken: angle 0,
    gradient 0, primal unchanged elsewhere."""
    dev = joints.device
    p, j, c = (_index(triples[:, k], dev) for k in range(3))
    vec_pj = joints[..., j, :] - joints[..., p, :]
    vec_jc = joints[..., c, :] - joints[..., j, :]
    dot = (vec_pj * vec_jc).sum(dim=-1)
    cross = vec_pj[..., 0] * vec_jc[..., 1] - vec_pj[..., 1] * vec_jc[..., 0]
    degen = (dot == 0) & (cross == 0)
    angle = torch.atan2(cross, torch.where(degen, torch.ones_like(dot), dot))
    return torch.where(degen, torch.zeros_like(angle), angle)


def hand_joint_angle_loss(gen_pose: torch.Tensor) -> torch.Tensor:
    """ReLU range penalty on hand joint angles outside [0, pi]."""
    joints = to_joints(gen_pose)[..., 10:52, :]
    angles = _signed_angles(joints, constants.hand_triples())
    return (F.relu(0.0 - angles) + F.relu(angles - math.pi)).mean()


def body_joint_angle_loss(gen_pose: torch.Tensor) -> torch.Tensor:
    """ReLU range penalty on body joint angles outside [-pi/2, pi]."""
    triples = constants.body_triples()
    if len(triples) == 0:
        return gen_pose.new_zeros(())
    joints = to_joints(gen_pose)[..., :10, :]
    angles = _signed_angles(joints, triples)
    return (F.relu(-math.pi / 2 - angles) + F.relu(angles - math.pi)).mean()


def comprehensive_angle_loss(gen_pose: torch.Tensor) -> torch.Tensor:
    """0.7 * hand + 0.3 * body."""
    return (0.7 * hand_joint_angle_loss(gen_pose)
            + 0.3 * body_joint_angle_loss(gen_pose))


def generator_internal_losses(gen_pose: torch.Tensor,
                              real_pose: torch.Tensor | None = None
                              ) -> list[torch.Tensor]:
    """The generator's internal loss list: [bone (iff real given), angle]."""
    out = []
    if real_pose is not None:
        out.append(bone_length_loss(real_pose, gen_pose))
    out.append(comprehensive_angle_loss(gen_pose))
    return out


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def masked_mean(per_sample: torch.Tensor, mask: torch.Tensor | None
                ) -> torch.Tensor:
    """Mean over the batch excluding padded rows (mask 0).  per_sample is
    (B, ...); each sample is first reduced to a scalar mean.

    Inside :func:`a2m_torch.parallel.mesh.global_batch` the batch is the
    global one: this rank's masked sum over the global mask sum, so that
    the ranks' terms add up to the mean over all ranks' rows (averaging the
    ranks' own means would weigh a rank's rows by its own mask sum, which
    differs across ranks whenever a batch is wrap-padded)."""
    if mask is None and mesh.active() is None:
        return per_sample.mean()
    flat = per_sample.reshape(per_sample.shape[0], -1).mean(dim=1)
    if mask is None:
        mask = flat.new_ones(flat.shape[0])
    return (flat * mask).sum() / mesh.mask_sum(mask).clamp_min(1e-8)
