"""Configuration of the port: the generator, the discriminator, the GAN
controller and the train steps.

Own copies of the dataclasses of ``a2m/config.py`` (``GeneratorConfig``
``:73-107``, ``DiscriminatorConfig`` ``:111-130``, ``ControllerConfig``
``:134-166``, and of ``TrainConfig`` ``:170-244`` the fields that the steps
and the loop read), plus the GCN kernel switches (``fused_gcn``,
``fused_edge``, ``fused_precise``).  The knobs that exist only for the TPU
(``remat``, ``rng_impl``, ``donate_buffers``, ``log_mfu``, ``fused_tile``:
each kernel here picks its own tile) have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class GeneratorConfig:
    time_steps: int = 64
    in_channels: int = 256
    out_channels: int = 256
    out_feats: int = 104
    body_feats: int = 20
    num_body_joints: int = 10
    num_hand_joints: int = 42
    joint_feat_dim: int = 64
    dropout: float = 0.2
    gat_heads: int = 4
    #: > 0 adds a learned speaker embedding to the encoder features
    num_style_speakers: int = 0
    #: run both 5-layer GCN stacks through the fused stack kernels
    #: (a2m_torch/nn/gcn_kernel.py) instead of the eager layers: the
    #: forward kernel without a gradient, the stash-forward and backward
    #: kernels under autograd
    fused_gcn: bool = False
    #: ignored; accepted so that a2m's configs carry over: a2m's rolled
    #: head loop is the same math, and the port has one kernel for both
    fused_rolled: bool = False
    #: with ``fused_gcn``, route the gradient-free forwards through the
    #: edge-form kernel (a2m's ``_kernel_edge``: tiles of graphs in
    #: joint-major order, routing over constant edge lists) instead of the
    #: dense one; forwards under autograd keep the stash-forward and
    #: backward kernels.  Without ``fused_gcn`` it changes nothing.
    fused_edge: bool = False
    #: fused kernel's matmul operands in f32 instead of bf16 (a2m's
    #: ``fused_gcn_stack(precise=True)``)
    fused_precise: bool = False


@dataclass(frozen=True)
class DiscriminatorConfig:
    in_channels: int = 104
    out_channels: int = 64
    n_downsampling: int = 2
    dropout: float = 0.3
    groups: int = 1
    aux_classes: int = 10
    #: the aux gesture-type classifier head is dead compute unless its CE
    #: loss is applied (``TrainConfig.lambda_aux > 0``); off by default
    use_aux_classifier: bool = False
    out_shape: int = 1
    joint_feat_dim: int = 64
    gat_heads: int = 4
    #: condition D on the batch's log-mel features, adaptive-pooled onto D's
    #: time axis and concatenated before the logits conv
    audio_fusion: bool = False


@dataclass(frozen=True)
class ControllerConfig:
    """DynamicGANTraining parameters."""
    g_lr: float = 5e-4
    d_lr: float = 1e-3
    d_strong_threshold: float = 0.20
    g_weak_threshold: float = 0.80
    g_strong_threshold: float = 0.10
    init_d_freq: int = 1
    init_g_freq: int = 3
    min_d_freq: int = 1
    max_d_freq: int = 2
    min_g_freq: int = 2
    max_g_freq: int = 6
    real_label_smooth: float = 0.98
    fake_label_smooth: float = 0.02
    dynamic_smooth: bool = False
    history_cap: int = 100
    window: int = 10
    # label noise annealing
    max_noise_std: float = 0.01
    min_noise_std: float = 0.002
    anneal_start_epoch: int = 0
    anneal_end_epoch: int = 60
    max_smooth_offset: float = 0.05
    #: bounds on the multiplicative LR adaptation; 0.0 disables either
    g_lr_max: float = 0.0
    d_lr_min: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    n_epochs: int = 500
    lambda_d: float = 1.0
    lambda_gan: float = 1.0
    lambda_smooth: float = 0.1
    lambda_jerk: float = 0.05
    #: aux classifier CE on D's real branch; needs
    #: ``DiscriminatorConfig.use_aux_classifier``
    lambda_aux: float = 0.0
    #: L1 on the absolute normalised pose (0 = frame differences only)
    lambda_pos: float = 0.0
    log_every_batches: int = 200
    controller: ControllerConfig = field(default_factory=ControllerConfig)
    #: route the gradient-free generator forwards (the fake generation in
    #: ``d_step``, and ``eval_step``) through the fused forward kernel while
    #: ``g_step`` keeps the generator's own setting.  None = on when the
    #: models lie on a CUDA device.
    fused_gcn_eval: Optional[bool] = None
    #: global-norm gradient clipping; 0 disables
    grad_clip_norm: float = 0.0
