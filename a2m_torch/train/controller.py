"""Dynamic GAN training controller (host-side).

The port's own copy of ``a2m/train/controller.py`` (numpy only): rolling
loss history (cap 100), window-10 means, skip-D rule, G/D frequency
adaptation, multiplicative LR adaptation, and annealed smooth-label
parameters.

All data-dependent branching lives here on the host; the controller only
emits scalars (g_freq, d_freq, g_lr, d_lr, label params) that feed the train
steps.  Labels are sampled on the device from those scalars
(:func:`a2m_torch.train.train_step.smooth_labels`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from a2m_torch.config import ControllerConfig


@dataclass
class LabelParams:
    """Scalars defining the on-device smooth-label distribution."""
    smooth_real: float
    smooth_fake: float
    noise_std: float


@dataclass
class DynamicGANTraining:
    cfg: ControllerConfig = field(default_factory=ControllerConfig)

    def __post_init__(self):
        c = self.cfg
        self.g_lr_initial = c.g_lr
        self.d_lr_initial = c.d_lr
        self.g_lr_current = c.g_lr
        self.d_lr_current = c.d_lr
        self.d_loss_history: list[float] = []
        self.g_loss_history: list[float] = []
        self.d_train_freq = c.init_d_freq
        self.g_train_freq = c.init_g_freq

    # -- history ---------------------------------------------------------

    def update_loss_history(self, d_loss: float, g_loss: float) -> None:
        self.d_loss_history.append(float(d_loss))
        self.g_loss_history.append(float(g_loss))
        if len(self.d_loss_history) > self.cfg.history_cap:
            self.d_loss_history.pop(0)
            self.g_loss_history.pop(0)

    def get_recent_avg_loss(self, window: int | None = None
                            ) -> tuple[float, float]:
        window = window or self.cfg.window
        if len(self.d_loss_history) < window:
            return (float(np.mean(self.d_loss_history)),
                    float(np.mean(self.g_loss_history)))
        return (float(np.mean(self.d_loss_history[-window:])),
                float(np.mean(self.g_loss_history[-window:])))

    # -- decisions -------------------------------------------------------

    def should_train_discriminator(self) -> bool:
        if not self.d_loss_history:
            return True
        recent_d, recent_g = self.get_recent_avg_loss()
        if (recent_d < self.cfg.d_strong_threshold
                and recent_g > self.cfg.g_weak_threshold):
            return False
        return True

    def adjust_training_frequency(self, epoch: int) -> tuple[int, int]:
        c = self.cfg
        if len(self.d_loss_history) < c.window:
            return self.g_train_freq, self.d_train_freq
        recent_d, recent_g = self.get_recent_avg_loss()
        loss_ratio = recent_d / (recent_g + 1e-8)
        if loss_ratio < 0.15 or recent_d < 0.1:
            self.d_train_freq = max(c.min_d_freq, self.d_train_freq - 1)
            self.g_train_freq = min(c.max_g_freq, self.g_train_freq + 1)
        elif loss_ratio > 2.5:
            self.d_train_freq = min(c.max_d_freq, self.d_train_freq + 1)
            self.g_train_freq = max(c.min_g_freq, self.g_train_freq - 1)
        return self.g_train_freq, self.d_train_freq

    def adjust_learning_rates(self, epoch: int) -> tuple[float, float]:
        """Returns (g_lr, d_lr), which the train loop writes into the
        optimisers' parameter groups."""
        c = self.cfg
        if len(self.d_loss_history) < c.window:
            self.g_lr_current = self.g_lr_initial
            self.d_lr_current = self.d_lr_initial
        else:
            recent_d, recent_g = self.get_recent_avg_loss()
            if recent_d < c.d_strong_threshold:
                self.d_lr_current *= 0.9
                self.g_lr_current *= 1.05
            elif recent_d > 0.65 and recent_g < 0.3:
                self.d_lr_current *= 1.05
                self.g_lr_current *= 0.9
        # a2m extension, off by default (ControllerConfig docstring): the
        # reference law is unbounded and diverges at full scale
        # (LEARNING.md run B — g_lr compounds 26x over 80 epochs)
        if c.g_lr_max > 0:
            self.g_lr_current = min(self.g_lr_current, c.g_lr_max)
        if c.d_lr_min > 0:
            self.d_lr_current = max(self.d_lr_current, c.d_lr_min)
        return self.g_lr_current, self.d_lr_current

    # -- smooth labels ---------------------------------------------------

    def label_params(self, epoch: int, is_real: bool) -> LabelParams:
        c = self.cfg
        if epoch < c.anneal_start_epoch:
            progress, noise = 0.0, c.max_noise_std
        elif epoch > c.anneal_end_epoch:
            progress, noise = 1.0, c.min_noise_std
        else:
            progress = ((epoch - c.anneal_start_epoch)
                        / (c.anneal_end_epoch - c.anneal_start_epoch))
            noise = c.max_noise_std - progress * (c.max_noise_std
                                                  - c.min_noise_std)
        offset = c.max_smooth_offset * (1 - progress)
        if is_real:
            smooth = c.real_label_smooth - offset
        else:
            smooth = c.fake_label_smooth + offset

        if c.dynamic_smooth and len(self.d_loss_history) >= c.window:
            recent_d, recent_g = self.get_recent_avg_loss()
            if is_real and recent_d < c.d_strong_threshold:
                smooth = max(0.97, smooth - 0.1)
                noise = noise + 0.01
            elif not is_real and recent_g < c.g_strong_threshold:
                smooth = min(0.03, smooth + 0.1)
                noise = noise + 0.01
        return LabelParams(smooth_real=smooth if is_real else 0.0,
                           smooth_fake=0.0 if is_real else smooth,
                           noise_std=noise)

    # -- persistence -------------------------------------------------------

    def state_dict(self) -> dict:
        return dict(g_lr_current=self.g_lr_current,
                    d_lr_current=self.d_lr_current,
                    d_loss_history=list(self.d_loss_history),
                    g_loss_history=list(self.g_loss_history),
                    d_train_freq=self.d_train_freq,
                    g_train_freq=self.g_train_freq)

    def load_state_dict(self, state: dict) -> None:
        self.g_lr_current = float(state['g_lr_current'])
        self.d_lr_current = float(state['d_lr_current'])
        self.d_loss_history = [float(x) for x in state['d_loss_history']]
        self.g_loss_history = [float(x) for x in state['g_loss_history']]
        self.d_train_freq = int(state['d_train_freq'])
        self.g_train_freq = int(state['g_train_freq'])
