"""GAN train and eval steps (``a2m/train/train_step.py:92-390``).

Two fixed steps (``g_step``, ``d_step``) and ``eval_step``; the controller's
data-dependent branching (skip-D, variable frequencies, learning rates)
stays on the host in :mod:`a2m_torch.train.loop` and only feeds scalars.

Where a2m's steps are pure functions of immutable states, these update in
place: a :class:`NetState` holds a module (parameters and BatchNorm buffers)
and its optimiser, and a step mutates both and returns the same objects in
a2m's order.  Metrics come back as 0-dim tensors on the models' device, so a
step does not wait for the device.

Semantics kept from a2m:

* every forward inside ``g_step`` and ``d_step`` runs in train mode and
  updates the BatchNorm statistics, including D inside the G loss (D's
  parameters get no gradient and no update there) and the gradient-free G
  forward inside ``d_step``; the moments are mask-aware
  (:mod:`a2m_torch.nn.masking`), so wrap-padded rows are inert;
* ``d_step`` runs D on the fake motion first, then on the real motion;
* the label width comes from D's output; real labels are clipped to
  [0.85, 1], fake ones to [0, 0.15];
* Adam with betas (0.9, 0.999), eps 1e-8 and a learning rate set from the
  host; optional global-norm clipping by optax's rule.

On one card (CUDA, no process group) ``g_step`` and ``d_step`` run as CUDA
graphs (:mod:`a2m_torch.train.graphs`), and Adam is capturable on CUDA
(its step counts and learning rate on the card) whether a step is a graph
or not.

Label noise draws from the explicit ``torch.Generator`` a step is given;
dropout draws from the device's default generator, as ``nn.Dropout`` does.

When a process group is up, every step runs inside
:func:`a2m_torch.parallel.mesh.global_batch` and takes a2m's multi-process
semantics: BatchNorm moments and losses over the global
batch, gradients summed over the ranks before clipping (so the norm is the
global one) and Adam, the metrics summed over the ranks (every rank returns
the global values), and the label noise drawn at the global batch's shape
with each rank taking its own rows, so that every rank's labels are those
rows of a one-process run's.  Dropout stays per data rank (each rank's
default generator; the trainer seeds it with ``seed + data rank``).

Under tensor parallelism (a model sharded by
:func:`a2m_torch.parallel.mesh.shard_module`) the global batch is the data
group's, and the optimiser step's gradients take one more all-reduce, over
the model group (``parallel.tensor.sum_partial_grads``): the replicated
parameters each rank uses on its channel slice only (the sharded layers'
biases and BatchNorm scales, the attention's value bias and gate) have a
partial gradient on each rank and are summed; every other replicated one
is whole, and bit-equal, on each rank and is left as it is (a sum would
double it); a sliced parameter's gradient is its rank's own.  The global
norm counts a sliced parameter's squares over the model group and a
replicated one's once.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from a2m_torch import constants
from a2m_torch.config import TrainConfig
from a2m_torch.eval.metrics import pck_radius
from a2m_torch.models import losses as L
from a2m_torch.models.discriminator import aux_cross_entropy
from a2m_torch.nn import masking
from a2m_torch.nn.graph import GCNStack
from a2m_torch.parallel import mesh
from a2m_torch.parallel import tensor as tp_ops
from a2m_torch.train import graphs
from a2m_torch.utils.profiling import trace_annotation


@dataclass
class NetState:
    model: nn.Module
    optimizer: torch.optim.Optimizer


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """Adam as a2m configures optax's: betas (0.9, 0.999), eps 1e-8 added
    outside the square root, no weight decay.  On CUDA it is capturable
    (:func:`place_adam`), so that a CUDA graph of a step can hold it and
    an eager step computes as the graph does."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    place_adam(opt)
    return opt


def place_adam(optimizer: torch.optim.Optimizer) -> None:
    """Adam's settings for its parameters' device, whatever a restored
    ``state_dict`` carried: on CUDA capturable, with the step counts and
    a 0-dim learning rate on the card (the bias corrections computed
    there, no host scalar in a kernel); on the CPU the default, with host
    step counts and a float learning rate."""
    from torch.optim.optimizer import _get_scalar_dtype
    for group in optimizer.param_groups:
        dev = group['params'][0].device
        on = dev.type == 'cuda'
        group['capturable'] = on
        lr = group['lr']
        if on and not (isinstance(lr, torch.Tensor) and lr.device == dev):
            group['lr'] = torch.full((), float(lr), device=dev)
        elif not on and isinstance(lr, torch.Tensor):
            group['lr'] = float(lr)
        for p in group['params']:
            state = optimizer.state.get(p, {})
            if 'step' in state:
                state['step'] = state['step'].to(
                    device=dev if on else 'cpu', dtype=_get_scalar_dtype())


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Overwrite the learning rate of every parameter group (in place where
    it is a device tensor, which a CUDA graph of the step reads)."""
    for group in optimizer.param_groups:
        if isinstance(group['lr'], torch.Tensor):
            group['lr'].fill_(float(lr))
        else:
            group['lr'] = float(lr)


def clip_by_global_norm(params, max_norm: float, sliced=(),
                        group=None) -> None:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: scale by ``max_norm / norm`` only when ``norm > max_norm``.
    ``sliced`` are the parameters of ``params`` that each rank of the
    model ``group`` holds a slice of: their squares are summed over the
    group."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    if not sliced:
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
    else:
        import torch.distributed as dist
        own = {id(p) for p in sliced}
        parts = [(id(p) in own, (p.grad * p.grad).sum()) for p in params
                 if p.grad is not None]
        split = sum(sq for is_sliced, sq in parts if is_sliced)
        dist.all_reduce(split, group=group)
        norm = torch.sqrt(sum(sq for is_sliced, sq in parts
                              if not is_sliced) + split)
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
    for g in grads:
        g.mul_(scale)


def init_states(g_model: nn.Module, d_model: nn.Module, g_lr: float = 5e-4,
                d_lr: float = 1e-3) -> tuple[NetState, NetState]:
    """The two nets with a fresh Adam each.  (The modules initialise their
    parameters when they are built; a2m's ``init_states`` also did that.)"""
    return (NetState(g_model, make_optimizer(g_model.parameters(), g_lr)),
            NetState(d_model, make_optimizer(d_model.parameters(), d_lr)))


def normalize_pose_device(pose, mean, std):
    """Neck-subtract and standardise on the device (block layout)."""
    b, t, f = pose.shape
    p = pose.reshape(b, t, 2, -1)
    p = p - p[..., 0:1]
    return (p.reshape(b, t, f) - mean) / std


def smooth_labels(generator: torch.Generator | None, batch_size: int,
                  out_dim: int, smooth, noise_std, is_real: bool,
                  device=None) -> torch.Tensor:
    """Annealed smooth labels sampled on ``device``: ``smooth`` plus
    ``noise_std`` * N(0, 1) from ``generator``, clipped to [0.85, 1] for
    real and [0, 0.15] for fake labels.  Inside
    :func:`~a2m_torch.parallel.mesh.global_batch` the noise is drawn for
    the global batch and this rank's ``batch_size`` rows are returned."""
    batch = mesh.active()
    if batch is None:
        noise = torch.randn(batch_size, out_dim, generator=generator,
                            device=device)
    else:
        first, rows = batch.rows(batch_size)
        noise = torch.randn(rows, out_dim, generator=generator,
                            device=device)[first:first + batch_size]
    noisy = smooth + noise_std * noise
    return noisy.clamp(0.85, 1.0) if is_real else noisy.clamp(0.0, 0.15)


def _per_sample_angles(pose, hand: bool):
    """Per-sample mean angle range penalty (for masked breakdowns)."""
    if hand:
        joints = L.to_joints(pose)[..., 10:52, :]
        triples, lo = constants.hand_triples(), 0.0
    else:
        joints = L.to_joints(pose)[..., :10, :]
        triples, lo = constants.body_triples(), -math.pi / 2
    angles = L._signed_angles(joints, triples)
    pen = F.relu(lo - angles) + F.relu(angles - math.pi)
    return pen.reshape(pose.shape[0], -1).mean(dim=1)


def masked_motion_losses(real_pose, real_motion, fake_pose, fake_motion,
                         mask) -> dict:
    """Masked kinematic loss breakdown (L1 motion, L1 position, smoothness,
    jerk, bone, angle): the single definition shared by ``g_step`` and
    ``eval_step``.  Per-sample means weighted by ``mask`` (all ones == the
    global means)."""
    def mm(x):
        return L.masked_mean(x, mask)

    accel = fake_motion[:, 1:] - fake_motion[:, :-1]
    jerk = accel[:, 1:] - accel[:, :-1]
    return dict(
        reg=mm((real_motion - fake_motion).abs()),
        pos=mm((real_pose - fake_pose).abs()),
        smooth=mm(L.safe_norm(accel, axis=-1)),
        jerk=mm(L.safe_norm(jerk, axis=-1)),
        bone=mm((L.bone_lengths(fake_pose) - L.bone_lengths(real_pose)) ** 2),
        angle=mm(0.7 * _per_sample_angles(fake_pose, hand=True)
                 + 0.3 * _per_sample_angles(fake_pose, hand=False)),
    )


@contextlib.contextmanager
def _fused_stacks(model: nn.Module, on: bool):
    """Route every GCN stack of ``model`` through the fused kernels within
    the context (the ``fused_gcn_eval`` switch)."""
    stacks = [m for m in model.modules() if isinstance(m, GCNStack)] \
        if on else []
    before = [m.fused for m in stacks]
    for m in stacks:
        m.fused = True
    try:
        yield
    finally:
        for m, was in zip(stacks, before):
            m.fused = was


@contextlib.contextmanager
def _frozen(model: nn.Module):
    """No gradient for ``model``'s parameters within the context."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _reported(metrics: dict) -> dict:
    """The metrics a step returns: detached, and summed over the ranks
    (the global batch's values)."""
    return mesh.sum_metrics({k: v.detach() for k, v in metrics.items()})


def make_train_steps(g_model: nn.Module, d_model: nn.Module,
                     cfg: TrainConfig):
    """Build ``(g_step, d_step, eval_step)`` for the two models.  Each
    rank passes its own rows of the global batch (``data.batch_size`` rows
    a rank) when a process group is up."""
    fused_eval = cfg.fused_gcn_eval
    if fused_eval is None:
        # the fused forward kernel exists on the card only
        fused_eval = next(g_model.parameters()).device.type == 'cuda'
    if cfg.lambda_aux > 0 and not d_model.config.use_aux_classifier:
        raise ValueError('TrainConfig.lambda_aux > 0 requires '
                         'DiscriminatorConfig.use_aux_classifier')
    use_audio = d_model.config.audio_fusion

    def d_audio(audio):
        return audio if use_audio else None

    def step_optimizer(state: NetState) -> None:
        params = list(state.model.parameters())
        mesh.all_reduce_grads(params)       # the global batch's gradient
        plan = tp_ops.plan_of(state.model)
        sliced, group = (), None
        if plan is not None:
            tp_ops.sum_partial_grads(state.model)
            named = dict(state.model.named_parameters())
            sliced = [p for k, p in named.items() if k in plan.state]
            group = plan.shard.group
        if cfg.grad_clip_norm and cfg.grad_clip_norm > 0:
            clip_by_global_norm(params, cfg.grad_clip_norm, sliced, group)
        state.optimizer.step()

    @mesh.global_batch()
    def g_step(g_state: NetState, d_state: NetState, audio, pose, mean, std,
               smooth, noise_std, key, style=None, mask=None):
        """One generator update.  Returns ``(g_state, d_state, metrics)``:
        G's parameters, BatchNorm statistics and optimiser moved; of D only
        the BatchNorm statistics (its forward runs in train mode).
        ``style``: optional (B,) speaker ids; ``mask``: optional (B,) 1/0
        weights of wrap-padded rows; ``key``: the ``torch.Generator`` of the
        label noise.  Its spans: ``a2m.g_step.forward`` (to the total
        loss), ``.backward`` and ``.optimizer``."""
        with trace_annotation('a2m.g_step.forward'):
            g, d = g_state.model.train(), d_state.model.train()
            real_pose = normalize_pose_device(pose, mean, std)
            real_motion = L.pos_to_motion(real_pose)
            g_state.optimizer.zero_grad(set_to_none=True)
            with masking.batch_mask(mask), _frozen(d):
                fake_pose = g(audio, speaker_ids=style)
                fake_motion = L.pos_to_motion(fake_pose)
                fake_d, _ = d(fake_motion, d_audio(audio))
            valid = smooth_labels(key, audio.shape[0], fake_d.shape[-1],
                                  smooth, noise_std, is_real=True,
                                  device=audio.device)
            kin = masked_motion_losses(real_pose, real_motion, fake_pose,
                                       fake_motion, mask)
            g_loss = (kin['reg'] + cfg.lambda_gan
                      * L.masked_mean((fake_d - valid) ** 2, mask))
            total = (g_loss + cfg.lambda_smooth * kin['smooth']
                     + cfg.lambda_jerk * kin['jerk'] + kin['bone']
                     + kin['angle'] + cfg.lambda_pos * kin['pos'])
        with trace_annotation('a2m.g_step.backward'):
            total.backward()
        with trace_annotation('a2m.g_step.optimizer'):
            step_optimizer(g_state)
        metrics = dict(g_loss=total, g_gan=g_loss, smooth=kin['smooth'],
                       jerk=kin['jerk'], bone=kin['bone'], angle=kin['angle'])
        return g_state, d_state, _reported(metrics)

    @mesh.global_batch()
    def d_step(g_state: NetState, d_state: NetState, audio, pose, mean, std,
               smooth_r, smooth_f, noise_std, key, style=None, mask=None):
        """One discriminator update.  Returns ``(d_state, g_state,
        metrics)``: D moved; of G only the BatchNorm statistics (its
        gradient-free forward runs in train mode, dropout on).  With
        ``cfg.lambda_aux > 0`` and ``style`` labels the aux classifier CE on
        the real branch is added.  Its spans: ``a2m.d_step.forward`` (to
        the total loss), ``.backward`` and ``.optimizer``."""
        with trace_annotation('a2m.d_step.forward'):
            g, d = g_state.model.train(), d_state.model.train()
            real_pose = normalize_pose_device(pose, mean, std)
            real_motion = L.pos_to_motion(real_pose)
            with torch.no_grad(), masking.batch_mask(mask), \
                    _fused_stacks(g, fused_eval):
                fake_motion = L.pos_to_motion(g(audio, speaker_ids=style))
            d_state.optimizer.zero_grad(set_to_none=True)
            with masking.batch_mask(mask):
                fake_d, _ = d(fake_motion, d_audio(audio))
                real_d, aux_real = d(real_motion, d_audio(audio))
            dev = audio.device
            valid = smooth_labels(key, audio.shape[0], real_d.shape[-1],
                                  smooth_r, noise_std, is_real=True,
                                  device=dev)
            fake = smooth_labels(key, audio.shape[0], fake_d.shape[-1],
                                 smooth_f, noise_std, is_real=False,
                                 device=dev)
            real_loss = L.masked_mean((real_d - valid) ** 2, mask)
            fake_loss = L.masked_mean((fake_d - fake) ** 2, mask)
            total = real_loss + cfg.lambda_d * fake_loss
            metrics = dict(d_loss=total, d_real=real_loss, d_fake=fake_loss)
            if cfg.lambda_aux > 0 and style is not None:
                aux_l = aux_cross_entropy(aux_real, style, mask)
                total = total + cfg.lambda_aux * aux_l
                metrics = dict(metrics, d_loss=total, d_aux=aux_l)
        with trace_annotation('a2m.d_step.backward'):
            total.backward()
        with trace_annotation('a2m.d_step.optimizer'):
            step_optimizer(d_state)
        return d_state, g_state, _reported(metrics)

    @mesh.global_batch()
    def eval_step(g_state: NetState, d_state: NetState, audio, pose, mean,
                  std, mask, style=None) -> dict:
        """Validation pass: eval mode, hard 1/0 labels, masked means, the
        loss breakdown and ``val_pck`` (PCK@0.2 on the denormalised
        keypoints)."""
        g, d = g_state.model.eval(), d_state.model.eval()
        with torch.no_grad(), _fused_stacks(g, fused_eval):
            real_pose = normalize_pose_device(pose, mean, std)
            real_motion = L.pos_to_motion(real_pose)
            fake_pose = g(audio, speaker_ids=style)
            fake_motion = L.pos_to_motion(fake_pose)
            fake_d, _ = d(fake_motion, d_audio(audio))
            real_d, _ = d(real_motion, d_audio(audio))
            kin = masked_motion_losses(real_pose, real_motion, fake_pose,
                                       fake_motion, mask)
            g_gan = L.masked_mean((fake_d - 1.0) ** 2, mask)
            d_loss = (L.masked_mean((real_d - 1.0) ** 2, mask)
                      + cfg.lambda_d * L.masked_mean(fake_d ** 2, mask))
            b, t, f = pose.shape
            gen_kp = (fake_pose * std + mean).reshape(b * t, 2, f // 2)
            gt_kp = (real_pose * std + mean).reshape(b * t, 2, f // 2)
            radius = pck_radius(gt_kp, 0.2)[:, None]
            dist = torch.sqrt(((gt_kp - gen_kp) ** 2).sum(dim=1))
            per_clip = ((dist <= radius).float().mean(dim=1)
                        .reshape(b, t).mean(dim=1))
            val_pck = L.masked_mean(per_clip, mask)
        return mesh.sum_metrics(dict(
            val_g=kin['reg'] + cfg.lambda_gan * g_gan, val_d=d_loss,
            reg=kin['reg'], pos=kin['pos'], gan=g_gan, bone=kin['bone'],
            angle=kin['angle'], smooth=kin['smooth'], jerk=kin['jerk'],
            val_pck=val_pck))

    pool: list = []                 # the graphs' one memory pool
    return (graphs.GraphedStep(g_step, 'g', pool),
            graphs.GraphedStep(d_step, 'd', pool), eval_step)
