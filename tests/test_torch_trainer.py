"""Port training loop (a2m_torch/train/loop.py) and controller copy
(a2m_torch/train/controller.py) against a2m's controller.

``Trainer.train_epoch`` reads each batch's losses one batch late (so that
a step never waits for the device); fed the same loss sequence it must make
the decisions of a synchronous loop around a2m's ``DynamicGANTraining``:
the same numbers of G and D steps per batch, the same skipped D, the same
learning rates and label parameters."""

import numpy as np
import pytest
import torch

from a2m.config import ControllerConfig as JaxControllerConfig
from a2m.train.controller import DynamicGANTraining as JaxController
from a2m_torch.config import ControllerConfig, TrainConfig
from a2m_torch.train.controller import DynamicGANTraining
from a2m_torch.train.loop import Trainer

N_EPOCHS, N_BATCHES = 6, 7


def _losses(epoch: int, batch: int) -> tuple[float, float]:
    """Scripted (g_loss, d_loss) that walk the controller through its
    branches: a strong D (skip-D, D frequency down, learning rates moved),
    then a weak D (frequency up), then balance."""
    if epoch in (1, 2):
        return 1.0 + 0.01 * batch, 0.05
    if epoch in (3, 4):
        return 0.2, 0.9 + 0.01 * batch
    return 0.8, 0.5


def _reference_decisions():
    """Synchronous loop around a2m's controller: batch i's losses enter the
    history right after batch i."""
    ctrl = JaxController(JaxControllerConfig())
    log = []
    for epoch in range(N_EPOCHS):
        g_freq, d_freq = ctrl.adjust_training_frequency(epoch)
        g_lr, d_lr = ctrl.adjust_learning_rates(epoch)
        real = ctrl.label_params(epoch, True)
        fake = ctrl.label_params(epoch, False)
        last_d = 0.0
        for i in range(N_BATCHES):
            g_loss, d_loss = _losses(epoch, i)
            train_d = ctrl.should_train_discriminator()
            if train_d:
                last_d = d_loss
            log.append((epoch, i, g_freq, d_freq if train_d else 0, g_lr,
                        d_lr, real.smooth_real, fake.smooth_fake,
                        real.noise_std))
            ctrl.update_loss_history(last_d, g_loss)
    return log, ctrl


class _Param(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.p = torch.nn.Parameter(torch.zeros(1))


def test_train_epoch_makes_a2ms_decisions():
    calls = []

    def g_step(g_state, d_state, audio, pose, mean, std, smooth, noise_std,
               key, style=None, mask=None):
        epoch, i = int(audio[0]), int(audio[1])
        calls.append(('g', epoch, i, g_state.optimizer.param_groups[0]['lr'],
                      d_state.optimizer.param_groups[0]['lr'], smooth,
                      noise_std))
        return g_state, d_state, {'g_loss': torch.tensor(
            _losses(epoch, i)[0], dtype=torch.float64)}

    def d_step(g_state, d_state, audio, pose, mean, std, smooth_r, smooth_f,
               noise_std, key, style=None, mask=None):
        epoch, i = int(audio[0]), int(audio[1])
        calls.append(('d', epoch, i, smooth_r, smooth_f, noise_std))
        return d_state, g_state, {'d_loss': torch.tensor(
            _losses(epoch, i)[1], dtype=torch.float64)}

    trainer = Trainer(_Param(), _Param(), TrainConfig(log_every_batches=3),
                      log=lambda line: None, steps=(g_step, d_step, None))
    got = []
    for epoch in range(N_EPOCHS):
        trainer.train_batches = [
            (torch.tensor([float(epoch), float(i)]), torch.zeros(1), None,
             torch.ones(1)) for i in range(N_BATCHES)]
        calls.clear()
        last_g, last_d = trainer.train_epoch(epoch)
        for i in range(N_BATCHES):
            g_calls = [c for c in calls if c[0] == 'g' and c[2] == i]
            d_calls = [c for c in calls if c[0] == 'd' and c[2] == i]
            _, _, _, g_lr, d_lr, smooth_real, noise = g_calls[0]
            smooth_fake = d_calls[0][4] if d_calls else None
            got.append((epoch, i, len(g_calls), len(d_calls), g_lr, d_lr,
                        smooth_real, smooth_fake, noise))
            # G steps of a batch come before its D steps
            order = [c[0] for c in calls if c[2] == i]
            assert order == sorted(order, key='gd'.index)
        assert last_g == pytest.approx(_losses(epoch, N_BATCHES - 1)[0])
    ref, ref_ctrl = _reference_decisions()
    assert len(got) == len(ref)
    skipped = 0
    for g, r in zip(got, ref):
        assert g[:4] == r[:4], (g, r)
        np.testing.assert_allclose(g[4:7], r[4:7], rtol=1e-12)
        if g[3]:
            assert g[7] == pytest.approx(r[7], rel=1e-12)
        skipped += r[3] == 0
        assert g[8] == pytest.approx(r[8], rel=1e-12)
    # the script did reach the branches
    assert skipped > 3
    assert len({r[2] for r in ref}) > 1 and len({r[3] for r in ref}) > 2
    assert len({r[4] for r in ref}) > 1
    assert trainer.controller.state_dict() == ref_ctrl.state_dict()
    assert len(trainer.loss_history['train_g']) == N_EPOCHS * (N_BATCHES // 3)


def test_controller_copy_equals_a2ms():
    rng = np.random.default_rng(41)
    kw = dict(dynamic_smooth=True, g_lr_max=1e-3, d_lr_min=2e-4)
    a, b = (DynamicGANTraining(ControllerConfig(**kw)),
            JaxController(JaxControllerConfig(**kw)))
    for epoch in range(12):
        assert (a.adjust_training_frequency(epoch)
                == b.adjust_training_frequency(epoch))
        assert a.adjust_learning_rates(epoch) == b.adjust_learning_rates(epoch)
        for is_real in (True, False):
            assert (vars(a.label_params(epoch, is_real))
                    == vars(b.label_params(epoch, is_real)))
        for _ in range(15):
            d, g = rng.uniform(0, 0.3 if epoch % 3 else 1.5), rng.uniform(0, 2)
            assert (a.should_train_discriminator()
                    == b.should_train_discriminator())
            a.update_loss_history(d, g)
            b.update_loss_history(d, g)
        assert a.get_recent_avg_loss() == b.get_recent_avg_loss()
    assert a.state_dict() == b.state_dict()
    c = DynamicGANTraining(ControllerConfig(**kw))
    c.load_state_dict(a.state_dict())
    assert c.state_dict() == b.state_dict()
    assert len(a.d_loss_history) == 100


def test_validate_and_fit_average_the_eval_metrics():
    seen = []

    def eval_step(g_state, d_state, audio, pose, mean, std, mask, style=None):
        seen.append(float(audio[0]))
        return {'val_g': audio[0] * 2, 'val_d': audio[0] + 1}

    def g_step(g_state, d_state, *a, **k):
        return g_state, d_state, {'g_loss': torch.tensor(1.0)}

    def d_step(g_state, d_state, *a, **k):
        return d_state, g_state, {'d_loss': torch.tensor(0.5)}

    batches = [(torch.tensor([float(v)]), torch.zeros(1), None, torch.ones(1))
               for v in (1, 2, 6)]
    trainer = Trainer(_Param(), _Param(), TrainConfig(), batches[:2], batches,
                      log=lambda line: None, steps=(g_step, d_step, eval_step))
    assert trainer.validate() == {'val_g': 6.0, 'val_d': 4.0}
    history = trainer.fit(2)
    assert history['val_g'] == [6.0, 6.0] and history['val_d'] == [4.0, 4.0]
    assert seen == [1, 2, 6] * 3
    empty = Trainer(_Param(), _Param(), log=lambda line: None,
                    steps=(g_step, d_step, eval_step))
    assert empty.validate() == {}
