"""Training loop: the controller-driven GAN schedule
(``a2m/train/loop.py:424-528``) and validation (``:569-585``).

:class:`Trainer` runs over any iterable of ``(audio, pose, style, mask)``
batches: ``audio`` (B, T, 128) log-mel, ``pose`` (B, T, 104) raw keypoints in
block layout, ``style`` (B,) speaker ids or None, ``mask`` (B,) 1/0 weights
of wrap-padded rows.  Tensors that do not lie on the trainer's device are
moved there.
"""

from __future__ import annotations

import time

import torch

from a2m_torch.config import TrainConfig
from a2m_torch.train.controller import DynamicGANTraining
from a2m_torch.train.train_step import (init_states, make_train_steps,
                                        set_lr)


class Trainer:
    """``train_epoch(epoch)``, ``validate()`` and ``fit(n_epochs)`` around
    ``g_step``/``d_step``/``eval_step``.

    ``mean``/``std`` (104,) normalise the pose inside the steps.  ``steps``
    replaces the ``(g_step, d_step, eval_step)`` of
    :func:`make_train_steps` (tests script the losses with it)."""

    def __init__(self, g_model, d_model, cfg: TrainConfig = TrainConfig(),
                 train_batches=(), dev_batches=(), mean=None, std=None,
                 seed: int = 0, log=print, steps=None):
        self.cfg = cfg
        self.device = next(g_model.parameters()).device
        self.controller = DynamicGANTraining(cfg.controller)
        self.g_state, self.d_state = init_states(
            g_model, d_model, cfg.controller.g_lr, cfg.controller.d_lr)
        self.g_step, self.d_step, self.eval_step = (
            steps or make_train_steps(g_model, d_model, cfg))
        self.train_batches, self.dev_batches = train_batches, dev_batches
        self.mean = self._put(torch.zeros(104) if mean is None else mean)
        self.std = self._put(torch.ones(104) if std is None else std)
        #: label noise; dropout draws from the device's default generator
        self.key = torch.Generator(device=self.device).manual_seed(seed)
        self.log = log
        self.loss_history: dict[str, list] = {
            'train_g': [], 'train_d': [], 'val_g': [], 'val_d': []}

    def _put(self, t):
        if t is None:
            return None
        return torch.as_tensor(t).to(self.device)

    def _batch(self, batch):
        audio, pose, style, mask = batch
        return (self._put(audio).float(), self._put(pose).float(),
                self._put(style), self._put(mask))

    def train_epoch(self, epoch: int) -> tuple[float, float]:
        """One pass over ``train_batches``.  Per epoch the controller sets
        the G/D frequencies, the learning rates and the label parameters;
        per batch ``g_freq`` G steps, then ``d_freq`` D steps unless the
        controller skips D.  Returns the last (g_loss, d_loss)."""
        ctrl = self.controller
        g_freq, d_freq = ctrl.adjust_training_frequency(epoch)
        g_lr, d_lr = ctrl.adjust_learning_rates(epoch)
        set_lr(self.g_state.optimizer, g_lr)
        set_lr(self.d_state.optimizer, d_lr)
        real_lp = ctrl.label_params(epoch, is_real=True)
        fake_lp = ctrl.label_params(epoch, is_real=False)
        last_g = last_d = 0.0
        # Deferred metric drain: reading a loss waits for the device, and
        # the controller's per-batch decision only needs the history through
        # the previous batch (a synchronous loop also appends batch i's
        # losses after batch i).  So batch i - 1's metrics are read while
        # batch i's G updates are in flight, and the controller sees the
        # same loss sequence as a synchronous loop.
        pending = None                  # previous batch's (gm, dm | None)

        def drain(p) -> None:
            nonlocal last_g, last_d
            gm_p, dm_p = p
            last_g = float(gm_p['g_loss'])
            if dm_p is not None:
                last_d = float(dm_p['d_loss'])
            ctrl.update_loss_history(last_d, last_g)

        log_every = self.cfg.log_every_batches
        for i, batch in enumerate(self.train_batches):
            audio, pose, style, mask = self._batch(batch)
            for _ in range(g_freq):
                self.g_state, self.d_state, gm = self.g_step(
                    self.g_state, self.d_state, audio, pose, self.mean,
                    self.std, real_lp.smooth_real, real_lp.noise_std,
                    self.key, style=style, mask=mask)
            if pending is not None:
                drain(pending)
            dm = None
            if ctrl.should_train_discriminator():
                for _ in range(d_freq):
                    self.d_state, self.g_state, dm = self.d_step(
                        self.g_state, self.d_state, audio, pose, self.mean,
                        self.std, real_lp.smooth_real, fake_lp.smooth_fake,
                        real_lp.noise_std, self.key, style=style, mask=mask)
            # else dm stays None: the drain reuses the last d_loss
            pending = (gm, dm)
            if i % log_every == log_every - 1:
                # last_g/last_d lag one batch behind the display
                rd, rg = ctrl.get_recent_avg_loss()
                self.log(f'[Epoch {epoch}] [Batch {i + 1}] '
                         f'[D {last_d:.4f}] [G {last_g:.4f}] '
                         f'[recent D {rd:.4f} G {rg:.4f}] '
                         f'[freq G{g_freq}/D{d_freq}]')
                self.loss_history['train_g'].append(last_g)
                self.loss_history['train_d'].append(last_d)
        if pending is not None:
            drain(pending)              # the final batch completes the history
        return last_g, last_d

    def validate(self) -> dict[str, float]:
        """Mean of ``eval_step``'s metrics over ``dev_batches``."""
        sums: dict[str, float] = {}
        steps = 0
        for batch in self.dev_batches:
            audio, pose, style, mask = self._batch(batch)
            metrics = self.eval_step(self.g_state, self.d_state, audio, pose,
                                     self.mean, self.std, mask, style=style)
            # one transfer for the whole metric dict
            values = torch.stack([v.float() for v in metrics.values()]).cpu()
            for k, v in zip(metrics, values.tolist()):
                sums[k] = sums.get(k, 0.0) + v
            steps += 1
        return {k: v / max(steps, 1) for k, v in sums.items()}

    def fit(self, n_epochs: int | None = None) -> dict:
        """``n_epochs`` of ``train_epoch`` + ``validate``; returns the loss
        history."""
        n_epochs = self.cfg.n_epochs if n_epochs is None else n_epochs
        for epoch in range(n_epochs):
            t0 = time.perf_counter()
            self.train_epoch(epoch)
            val = self.validate()
            self.loss_history['val_g'].append(val.get('val_g', 0.0))
            self.loss_history['val_d'].append(val.get('val_d', 0.0))
            self.log(f'[Validation] Epoch {epoch}/{n_epochs} | '
                     f'G {val.get("val_g", 0):.4f} '
                     f'D {val.get("val_d", 0):.4f} | '
                     f'bone {val.get("bone", 0):.4f} '
                     f'angle {val.get("angle", 0):.4f} '
                     f'smooth {val.get("smooth", 0):.4f} '
                     f'jerk {val.get("jerk", 0):.4f} | '
                     f'{time.perf_counter() - t0:.1f}s')
        return self.loss_history
