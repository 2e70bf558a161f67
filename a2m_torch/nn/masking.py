"""Eval-mode BatchNorm with a2m's variable layout.

Counterpart of ``a2m/nn/masking.py::MaskedBatchNorm`` (``:84-106``) in eval
mode: normalise over the last (channel) axis with the running statistics,
eps 1e-5, in f32.  Train mode (mask-weighted biased variance, momentum 0.9)
belongs to the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """``y = (x - running_mean) * rsqrt(running_var + eps) * weight + bias``
    over the last axis of a channel-last tensor."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                'MaskedBatchNorm: only eval mode is ported')
        x = x.float()
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias
