"""Mask-aware BatchNorm with a2m's variable layout.

Counterpart of ``a2m/nn/masking.py`` (``:38-106``): normalise over the last
(channel) axis, eps 1e-5, in f32 at least: a bf16 input (a2m's
``dtype=jnp.bfloat16``) is normalised in f32 and comes out f32, and the
running statistics stay f32.  Eval mode uses the running statistics.
Train mode uses the batch moments, weighted by the per-sample (B,) mask of
the enclosing :func:`batch_mask` context so that wrap-padded rows of a ragged
final batch are inert, and moves the running statistics with flax's
momentum 0.9 towards the batch mean and the **biased** batch variance
(``torch.nn.BatchNorm`` would take the unbiased one).

Inside :func:`a2m_torch.parallel.mesh.global_batch` the train-mode moments
are those of the global batch, as in a2m's one global program: each rank
all-reduces its masked sums Σw·x and Σw, then Σw·(x − mean)², through a
differentiable all-reduce, so the moments, the running statistics and the
gradients equal a one-process run on the concatenated batch.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn

from a2m_torch.parallel import mesh

#: flax's BatchNorm momentum as a2m sets it: the share of the old statistic
MOMENTUM = 0.9

_mask_var: contextvars.ContextVar = contextvars.ContextVar(
    'a2m_torch_batch_mask', default=None)


@contextlib.contextmanager
def batch_mask(mask):
    """Make ``mask`` ((B,) 1/0 weights or None) visible to every
    :class:`MaskedBatchNorm` that runs in train mode within the context."""
    token = _mask_var.set(mask)
    try:
        yield
    finally:
        _mask_var.reset(token)


def current_batch_mask():
    return _mask_var.get()


class MaskedBatchNorm(nn.Module):
    """``y = (x - mean) * rsqrt(var + eps) * weight + bias`` over the last
    axis of a channel-last tensor; ``mean``/``var`` are the running
    statistics in eval mode and the (masked) batch moments in train mode."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # half types compute in f32; f64 (a test's reference) stays f64
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            mask = current_batch_mask()
            if mask is None and mesh.active() is None:
                mean = x.mean(axes)
                var = ((x - mean) ** 2).mean(axes)
            else:
                mean, var = _masked_moments(x, mask, axes)
            with torch.no_grad():
                m = MOMENTUM
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


def _masked_moments(x: torch.Tensor, mask, axes: tuple):
    """The masked two-pass moments over the batch, the global one inside
    :func:`~a2m_torch.parallel.mesh.global_batch` (all ranks' rows; a
    missing mask weighs every row 1)."""
    if mask is None:
        mask = x.new_ones(x.shape[0])
    w = mask.to(x.dtype).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    spatial = x[0].numel() // x.shape[-1]
    sums = mesh.all_reduce_sum(torch.cat([(x * w).sum(axes),
                                          (w.sum() * spatial).reshape(1)]))
    denom = sums[-1]
    mean = sums[:-1] / denom
    var = mesh.all_reduce_sum((((x - mean) ** 2) * w).sum(axes)) / denom
    return mean, var
