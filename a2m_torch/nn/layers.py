"""Core building blocks, channel-last at every module boundary.

Counterparts of ``a2m/nn/layers.py`` (``:30-222``).  Each module takes and
returns a2m's channel-last layout, ``(B, T, C)`` or ``(B, H, W, C)``; the
convolutions permute to PyTorch's channel-first views internally (for 2-D
the permuted view is channels_last memory, which cuDNN runs without a copy).
Attribute names follow a2m's flax scopes so that weights carry across by a
rename (see :mod:`a2m_torch.weights`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from a2m_torch.nn.masking import MaskedBatchNorm


def torch_pad(kernel_size, stride):
    """Reference padding rule ``int((k - s) / 2)`` per spatial axis
    (``a2m/nn/layers.py:30-43``)."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,)
    if isinstance(stride, int):
        stride = (stride,) * len(kernel_size)
    return tuple(int((k - s) / 2) for k, s in zip(kernel_size, stride))


class ConvNormRelu(nn.Module):
    """Conv -> Dropout -> BatchNorm -> (Leaky)ReLU
    (``a2m/nn/layers.py:46-94``).  ``downsample`` selects k4/s2, else k3/s1."""

    def __init__(self, in_channels: int, out_channels: int, type: str = '1d',
                 leaky: bool = False, downsample: bool = False,
                 kernel_size=None, stride=None, p: float = 0.0):
        super().__init__()
        ndim = 1 if type == '1d' else 2
        k, s = kernel_size, stride
        if k is None and s is None:
            k, s = (4, 2) if downsample else (3, 1)
        if isinstance(k, int):
            k = (k,) * ndim
        if isinstance(s, int):
            s = (s,) * ndim
        conv = nn.Conv1d if ndim == 1 else nn.Conv2d
        self.conv = conv(in_channels, out_channels, tuple(k), tuple(s),
                         padding=torch_pad(tuple(k), tuple(s)))
        self.dropout = nn.Dropout(p)
        self.norm = MaskedBatchNorm(out_channels)
        self.leaky = leaky

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.movedim(-1, 1)).movedim(1, -1)
        x = self.norm(self.dropout(x))
        return F.leaky_relu(x, 0.2) if self.leaky else F.relu(x)


class SelfAttention(nn.Module):
    """SAGAN-style self-attention, UNSCALED logits (no 1/sqrt(d)), with a
    learnable scalar gate (``a2m/nn/layers.py:97-113``).  Input (B, T, C)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.query = nn.Linear(in_channels, in_channels // 8)
        self.key = nn.Linear(in_channels, in_channels // 8)
        self.value = nn.Linear(in_channels, in_channels)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)
        attn = torch.softmax(q @ k.transpose(1, 2), dim=-1)   # (B, T, T)
        return self.gamma * (attn @ v) + x


class ChannelAttention(nn.Module):
    """SE-style channel gate with a shared MLP over mean and max pools
    (``a2m/nn/layers.py:116-133``).  Input (B, T, C).  The MLP layers keep
    flax's auto names ``Dense_0`` / ``Dense_1``."""

    def __init__(self, channel: int, reduction: int = 8):
        super().__init__()
        self.Dense_0 = nn.Linear(channel, channel // reduction)
        self.Dense_1 = nn.Linear(channel // reduction, channel)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self._mlp(x.mean(dim=1))
                             + self._mlp(x.amax(dim=1)))
        return x * gate[:, None, :]


class ResBlock(nn.Module):
    """2x ConvNormRelu + SelfAttention + residual
    (``a2m/nn/layers.py:136-154``)."""

    def __init__(self, channels: int, type: str = '1d', p: float = 0.1):
        super().__init__()
        self.conv1 = ConvNormRelu(channels, channels, type=type, leaky=True,
                                  p=p)
        self.conv2 = ConvNormRelu(channels, channels, type=type, leaky=True,
                                  p=p)
        self.attention = SelfAttention(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention(self.conv2(self.conv1(x))) + x


class ConvTranspose1D(nn.Module):
    """Transposed conv (k3, s2, p1, op1: exactly doubles T) + BN + ReLU
    (``a2m/nn/layers.py:157-194``).

    a2m flips its ``(k, in, out)`` kernel and runs an lhs-dilated
    correlation; that is ``conv_transpose1d`` with
    ``weight[i, o, k] = kernel[k, i, o]`` and NO flip (held by
    ``tests/test_torch_layers.py``).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 2, padding: int = 1,
                 output_padding: int = 1):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.bn = MaskedBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias,
                               stride=self.stride, padding=self.padding,
                               output_padding=self.output_padding)
        return F.relu(self.bn(y.transpose(1, 2)))


def interpolate_bilinear(x: torch.Tensor, size: tuple[int, int]
                         ) -> torch.Tensor:
    """``F.interpolate(bilinear, align_corners=False)`` on channel-last
    (B, H, W, C); equals a2m's ``jax.image.resize(bilinear,
    antialias=False)`` (``a2m/nn/layers.py:216-222``) at the
    (8, 15) -> (64, 1) resize of the audio encoder."""
    y = F.interpolate(x.movedim(-1, 1), size=size, mode='bilinear',
                      align_corners=False)
    return y.movedim(1, -1)
