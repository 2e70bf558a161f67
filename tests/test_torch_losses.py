"""Losses and metrics of the port (a2m_torch/models/losses.py,
a2m_torch/eval/metrics.py) against a2m's, within 1e-5 (relative to the
value where it is large), and the zero-gradient rule of ``safe_norm`` and
the angle losses at exact zeros and degenerate limbs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a2m.eval import metrics as jmetrics
from a2m.models import losses as jlosses
from a2m.train import train_step as jsteps
from a2m_torch.eval import metrics
from a2m_torch.models import losses
from a2m_torch.train import train_step as steps


@pytest.fixture(scope='module')
def poses():
    rng = np.random.default_rng(11)
    real = (rng.standard_normal((4, 16, 104)) * 10 + 300).astype(np.float32)
    fake = (real + rng.standard_normal(real.shape) * 3).astype(np.float32)
    return real, fake


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


UNARY = ['pos_to_motion', 'temporal_smoothness_loss', 'jerk_loss',
         'to_joints', 'bone_lengths', 'hand_joint_angle_loss',
         'body_joint_angle_loss', 'comprehensive_angle_loss']


@pytest.mark.parametrize('name', UNARY)
def test_unary_losses_match_a2m(poses, name):
    _, fake = poses
    got = getattr(losses, name)(torch.from_numpy(fake))
    _close(got.numpy(), getattr(jlosses, name)(jnp.asarray(fake)))


def test_binary_losses_match_a2m(poses):
    real, fake = poses
    tr, tf = torch.from_numpy(real), torch.from_numpy(fake)
    jr, jf = jnp.asarray(real), jnp.asarray(fake)
    _close(losses.bone_length_loss(tr, tf), jlosses.bone_length_loss(jr, jf))
    _close(losses.l1_loss(tr, tf), jlosses.l1_loss(jr, jf))
    _close(losses.mse_loss(tr, tf), jlosses.mse_loss(jr, jf))
    _close(losses.safe_norm(tr - tf, axis=-1),
           jlosses.safe_norm(jr - jf, axis=-1))
    for got, ref in zip(losses.generator_internal_losses(tf, tr),
                        jlosses.generator_internal_losses(jf, jr)):
        _close(got, ref)
    assert len(losses.generator_internal_losses(tf)) == 1
    mask = np.array([1, 1, 0, 1], np.float32)
    per = np.abs(real - fake)
    _close(losses.masked_mean(torch.from_numpy(per), torch.from_numpy(mask)),
           jlosses.masked_mean(jnp.asarray(per), jnp.asarray(mask)))
    _close(losses.masked_mean(torch.from_numpy(per), None),
           jlosses.masked_mean(jnp.asarray(per), None))


def test_masked_motion_losses_and_normalize_match_a2m(poses):
    real, fake = poses
    rng = np.random.default_rng(12)
    mean = (rng.standard_normal(104) * 5).astype(np.float32)
    std = rng.uniform(5, 15, 104).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    tn = steps.normalize_pose_device(*map(torch.from_numpy,
                                          (real, mean, std)))
    jn = jsteps.normalize_pose_device(*map(jnp.asarray, (real, mean, std)))
    _close(tn, jn)
    tfk = steps.normalize_pose_device(*map(torch.from_numpy,
                                           (fake, mean, std)))
    jfk = jnp.asarray(tfk.numpy())
    got = steps.masked_motion_losses(tn, losses.pos_to_motion(tn), tfk,
                                     losses.pos_to_motion(tfk),
                                     torch.from_numpy(mask))
    ref = jsteps.masked_motion_losses(jn, jlosses.pos_to_motion(jn), jfk,
                                      jlosses.pos_to_motion(jfk),
                                      jnp.asarray(mask))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])


def test_smooth_labels_clip_and_are_exact_without_noise():
    gen = torch.Generator().manual_seed(0)
    real = steps.smooth_labels(gen, 4, 7, 0.93, 0.0, is_real=True)
    fake = steps.smooth_labels(gen, 4, 7, 0.07, 0.0, is_real=False)
    assert real.shape == (4, 7)
    np.testing.assert_allclose(real.numpy(), 0.93, atol=1e-7)
    np.testing.assert_allclose(fake.numpy(), 0.07, atol=1e-7)
    noisy = steps.smooth_labels(gen, 64, 7, 0.93, 0.2, is_real=True)
    assert 0.85 <= noisy.min() and noisy.max() <= 1.0
    assert (noisy == 1.0).any() and (noisy == 0.85).any()
    noisy = steps.smooth_labels(gen, 64, 7, 0.07, 0.2, is_real=False)
    assert 0.0 <= noisy.min() and noisy.max() <= 0.15
    ref = jsteps.smooth_labels(jax.random.PRNGKey(0), 4, 7, 0.93, 0.0, True)
    np.testing.assert_allclose(real.numpy(), np.asarray(ref), atol=1e-7)


def test_metrics_match_a2m(poses):
    real, fake = poses
    gt = real.reshape(-1, 2, 52)
    pred = fake.reshape(-1, 2, 52)
    tg, tp = torch.from_numpy(gt), torch.from_numpy(pred)
    _close(metrics.pck_radius(tg, 0.2), jmetrics.pck_radius(jnp.asarray(gt),
                                                            0.2))
    for alpha in (0.1, 0.2):
        ref = np.asarray(jmetrics.compute_pck(jnp.asarray(pred),
                                              jnp.asarray(gt), alpha=alpha))
        _close(metrics.compute_pck(tp, tg, alpha), ref)
        _close(metrics.compute_pck_np(pred, gt, alpha), ref)
    _close(metrics.l2_pose_error(tp, tg),
           jmetrics.l2_pose_error(jnp.asarray(pred), jnp.asarray(gt)))
    _close(metrics.l2_pose_error(torch.from_numpy(fake),
                                 torch.from_numpy(real)),
           jmetrics.l2_pose_error(jnp.asarray(fake), jnp.asarray(real)))
    np.testing.assert_array_equal(metrics.pose_blocks_to_keypoints(real),
                                  jmetrics.pose_blocks_to_keypoints(real))


def test_safe_norm_gradient_is_zero_at_zero():
    x = torch.zeros(3, 5, requires_grad=True)
    losses.safe_norm(x).sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]], requires_grad=True)
    n = losses.safe_norm(x)
    n.sum().backward()
    np.testing.assert_allclose(n.detach().numpy(), [5.0, 0.0])
    np.testing.assert_allclose(x.grad.numpy(), [[0.6, 0.8], [0.0, 0.0]])
    ref = jax.grad(lambda a: jlosses.safe_norm(a).sum())(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-7)


@pytest.mark.parametrize('name', ['temporal_smoothness_loss', 'jerk_loss',
                                  'comprehensive_angle_loss',
                                  'bone_lengths'])
def test_gradients_finite_and_zero_on_degenerate_pose(name):
    """A constant pose: every temporal difference is exactly zero and every
    limb collapses to a point."""
    pose = torch.full((2, 8, 104), 3.0, requires_grad=True)
    getattr(losses, name)(pose).sum().backward()
    assert torch.equal(pose.grad, torch.zeros_like(pose))


def test_angle_gradient_finite_with_one_degenerate_limb(poses):
    _, fake = poses
    fake = fake.copy()
    j = fake.reshape(4, 16, 2, 52)
    j[:, :, :, 11:15] = j[:, :, :, 10:11]       # a finger collapsed to a point
    pose = torch.from_numpy(j.reshape(4, 16, 104)).requires_grad_()
    losses.comprehensive_angle_loss(pose).backward()
    assert bool(torch.isfinite(pose.grad).all())
    ref = jax.grad(jlosses.comprehensive_angle_loss)(
        jnp.asarray(pose.detach().numpy()))
    np.testing.assert_allclose(pose.grad.numpy(), np.asarray(ref), atol=1e-6)
