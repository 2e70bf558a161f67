"""Encoders and decoders (``a2m/nn/encoders.py``), channel-last (B, T, C)
at their boundaries.

AudioEncoder and UNet1D (``:19-114``) are the generator's; the others
(``:117-359``) are a2m's counterparts of the reference's remaining
``model_layers.py`` modules, which no a2m path calls.  Each takes a2m's
compute ``dtype`` (see :mod:`a2m_torch.nn.layers`).

flax infers a convolution's input width from the first call; PyTorch
builds it.  The port follows the reference's grouped-conv convention (a
``ConvNormRelu(in, out, groups=g)`` reads ``in * g`` channels), which fixes
every layer but a decoder's first: ``PoseDecoder`` and ``StyleDecoder``
take ``in_features``, the width of their input.
"""

from __future__ import annotations

import torch
from torch import nn

from a2m_torch.nn.layers import (Conv1d, ConvNormRelu, ConvTranspose1D,
                                 Linear, SelfAttention, interpolate_bilinear)


class AudioEncoder(nn.Module):
    """2-D conv stack over the (T, F) log-mel -> (B, T, 4b).

    Channels 1 -> b -> 2b -> 4b -> 8b -> 4b with three stride-2 downsamples
    ((64, 128) -> (8, 16)) and a final (3, 8) kernel -> (8, 15); bilinear
    resize to (T, 1)."""

    def __init__(self, base_channels: int = 64, input_channels: int = 1,
                 p: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        b = base_channels
        common = dict(type='2d', leaky=True, p=p, dtype=dtype)
        self.conv0 = ConvNormRelu(input_channels, b, downsample=True,
                                  **common)
        self.conv1 = ConvNormRelu(b, b * 2, downsample=True, **common)
        self.conv2 = ConvNormRelu(b * 2, b * 4, downsample=True, **common)
        self.conv3 = ConvNormRelu(b * 4, b * 8, **common)
        self.conv4 = ConvNormRelu(b * 8, b * 4, kernel_size=(3, 8), stride=1,
                                  **common)

    def forward(self, x: torch.Tensor,
                time_steps: int | None = None) -> torch.Tensor:
        if time_steps is None:
            time_steps = x.shape[1]
        x = x[..., None]                                # (B, T, F, 1)
        for conv in (self.conv0, self.conv1, self.conv2, self.conv3,
                     self.conv4):
            x = conv(x)
        return interpolate_bilinear(x, (time_steps, 1))[:, :, 0, :]


class UNet1D(nn.Module):
    """Depth-2 1-D U-Net with a bottleneck attention and one up-path
    attention sized at C * 8.  Input/output (B, T, C)."""

    def __init__(self, input_channels: int, output_channels: int,
                 p: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = input_channels
        common = dict(type='1d', leaky=True, p=p, dtype=dtype)
        self.down0 = ConvNormRelu(c, c * 2, **common)
        self.down1 = ConvNormRelu(c * 2, c * 2, downsample=True, **common)
        self.down2 = ConvNormRelu(c * 2, c * 4, **common)
        self.down3 = ConvNormRelu(c * 4, c * 4, downsample=True, **common)
        self.bottleneck = ConvNormRelu(c * 4, c * 8, **common)
        self.bottleneck_attention = SelfAttention(c * 8, dtype=dtype)
        self.up0 = ConvTranspose1D(c * 8, c * 4, dtype=dtype)
        self.up_attention = SelfAttention(c * 8, dtype=dtype)
        self.up1 = ConvNormRelu(c * 8, c * 4, **common)
        self.up2 = ConvTranspose1D(c * 4, c * 2, dtype=dtype)
        self.up3 = ConvNormRelu(c * 4, c * 2, **common)
        self.final_conv = Linear(c * 2, output_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip1 = x = self.down0(x)
        skip2 = x = self.down2(self.down1(x))
        x = self.bottleneck_attention(self.bottleneck(self.down3(x)))
        x = self.up_attention(torch.cat([self.up0(x), skip2], dim=-1))
        x = self.up2(self.up1(x))
        x = self.up3(torch.cat([x, skip1], dim=-1))
        return self.final_conv(x)


class UNet1DFirstVersion(nn.Module):
    """Legacy U-Net: nearest-neighbour 2x upsample and additive skips
    (``a2m/nn/encoders.py:117-160``).  T must be a multiple of
    ``2 ** max_depth``."""

    def __init__(self, input_channels: int, output_channels: int,
                 max_depth: int = 5, p: float = 0.0, groups: int = 1,
                 kernel_size=None, stride=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_depth = max_depth
        common = dict(type='1d', leaky=True, kernel_size=kernel_size,
                      stride=stride, p=p, groups=groups, dtype=dtype)
        c = output_channels
        self.pre0 = ConvNormRelu(input_channels, c, **common)
        self.pre1 = ConvNormRelu(c, c, **common)
        for i in range(max_depth):
            setattr(self, f'conv1_{i}',
                    ConvNormRelu(c, c, downsample=True, **common))
            setattr(self, f'conv2_{i}', ConvNormRelu(c, c, **common))

    def forward(self, x: torch.Tensor, return_bottleneck: bool = False):
        t, depth = x.shape[1], self.max_depth
        if t % (2 ** depth):
            raise ValueError(f'input T={t} must be a multiple of 2^{depth}')
        x = self.pre1(self.pre0(x))
        residuals = [x]
        for i in range(depth):
            x = getattr(self, f'conv1_{i}')(x)
            if i < depth - 1:
                residuals.append(x)
        bottleneck = x
        for i in range(depth):
            x = x.repeat_interleave(2, dim=1) + residuals[depth - i - 1]
            x = getattr(self, f'conv2_{i}')(x)
        return (x, bottleneck) if return_bottleneck else x


class _ConvStack1D(nn.Module):
    """A sequence of 1-D ConvNormRelu stages ``conv<i>``, ``channels`` being
    ((in, out, downsample), ...)."""

    def __init__(self, channels, p: float = 0.0, groups: int = 1,
                 kernel_size=None, stride=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = len(channels)
        for i, (ci, co, ds) in enumerate(channels):
            setattr(self, f'conv{i}', ConvNormRelu(
                ci, co, type='1d', leaky=True, downsample=ds,
                kernel_size=kernel_size, stride=stride, p=p, groups=groups,
                dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f'conv{i}')(x)
        return x


def _six_stages(input_channels: int) -> tuple:
    """in -> 64 -> 64 -> 128 -> 128 -> 256 -> 256, no downsampling."""
    return ((input_channels, 64, False), (64, 64, False), (64, 128, False),
            (128, 128, False), (128, 256, False), (256, 256, False))


class _SixStageEncoder(nn.Module):
    """(B, T, input_channels * groups) -> (B, T, 256 * groups): the stack
    of PoseEncoder, TextEncoder1D and AudioEncoder1D."""

    def __init__(self, output_feats: int = 64, input_channels: int = 96,
                 p: float = 0.0, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stack = _ConvStack1D(_six_stages(input_channels), p=p,
                                  groups=groups, dtype=dtype)

    def forward(self, x: torch.Tensor,
                time_steps: int | None = None) -> torch.Tensor:
        return self.stack(x)


class PoseEncoder(_SixStageEncoder):
    """(B, T, pose_feats) -> (B, T, 256) (``a2m/nn/encoders.py:184-201``)."""


class TextEncoder1D(_SixStageEncoder):
    """(B, T, 300) -> (B, T, 256) (``a2m/nn/encoders.py:227-244``)."""

    def __init__(self, output_feats: int = 64, input_channels: int = 300,
                 p: float = 0.0, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(output_feats, input_channels, p, groups, dtype)


class AudioEncoder1D(_SixStageEncoder):
    """(B, T, 128) -> (B, T, 256) (``a2m/nn/encoders.py:247-264``)."""

    def __init__(self, output_feats: int = 64, input_channels: int = 128,
                 p: float = 0.0, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(output_feats, input_channels, p, groups, dtype)


class PoseStyleEncoder(nn.Module):
    """Pose -> speaker logits (B, num_speakers): a conv stack with six
    stride-2 downsamples, then the mean over T
    (``a2m/nn/encoders.py:204-224``)."""

    def __init__(self, output_feats: int = 64, input_channels: int = 96,
                 num_speakers: int = 4, p: float = 0.0, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = ((input_channels, 64, False), (64, 64, True), (64, 128, True),
              (128, 128, True), (128, 256, True), (256, 256, True),
              (256, num_speakers, True))
        self.stack = _ConvStack1D(ch, p=p, groups=groups, dtype=dtype)

    def forward(self, x: torch.Tensor,
                time_steps: int | None = None) -> torch.Tensor:
        return self.stack(x).mean(dim=1)


def _grouped_logits(in_channels: int, out_channels: int, groups: int,
                    dtype: torch.dtype) -> Conv1d:
    """a2m's grouped 1x1 ``nn.Conv`` head."""
    return Conv1d(in_channels, out_channels, 1, groups=groups, dtype=dtype)


def _channel_last(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.movedim(-1, 1)).movedim(1, -1)


class PoseDecoder(nn.Module):
    """Grouped-conv pose decoder that re-concatenates each group's style
    block between its layers (``a2m/nn/encoders.py:267-297``).  Input
    (B, T, in_features): ``num_clusters`` groups whose last ``style_dim``
    channels are the style; ``in_features`` defaults to the reference's
    ``(input_channels + style_dim) * num_clusters``.  Output (B, T,
    out_feats * num_clusters)."""

    def __init__(self, input_channels: int = 256, style_dim: int = 10,
                 num_clusters: int = 8, out_feats: int = 96, p: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 in_features: int | None = None):
        super().__init__()
        c, g = input_channels, num_clusters
        if in_features is None:
            in_features = (c + style_dim) * g
        self.style_dim, self.groups = style_dim, g
        common = dict(type='1d', leaky=True, p=p, groups=g, dtype=dtype)
        for i in range(4):
            width = in_features // g if i == 0 else c + style_dim
            setattr(self, f'dec{i}', ConvNormRelu(width, c, **common))
        self.pose_logits = _grouped_logits(c * g, out_feats * g, g, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        style = x.unflatten(-1, (g, -1))[..., -self.style_dim:]
        for i in range(4):
            x = getattr(self, f'dec{i}')(x)
            if i < 3:
                x = torch.cat([x.unflatten(-1, (g, -1)), style],
                              dim=-1).flatten(-2)
        return _channel_last(self.pose_logits, x)


class StyleDecoder(nn.Module):
    """Grouped decoder without style injection
    (``a2m/nn/encoders.py:300-319``).  Input (B, T, in_features), by
    default the reference's ``input_channels * num_clusters``."""

    def __init__(self, input_channels: int = 256, num_clusters: int = 10,
                 out_feats: int = 96, p: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 in_features: int | None = None):
        super().__init__()
        c, g = input_channels, num_clusters
        if in_features is None:
            in_features = c * g
        common = dict(type='1d', leaky=True, p=p, groups=g, dtype=dtype)
        self.dec0 = ConvNormRelu(in_features // g, c, **common)
        self.dec1 = ConvNormRelu(c, c, **common)
        self.pose_logits = _grouped_logits(c * g, out_feats * g, g, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _channel_last(self.pose_logits, self.dec1(self.dec0(x)))


class LatentEncoder(nn.Module):
    """Bottleneck conv encoder in -> hidden x3 -> out
    (``a2m/nn/encoders.py:322-338``)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int = 2, p: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = hidden_channels
        ch = ((in_channels, h, False), (h, h, False), (h, h, False),
              (h, out_channels, False))
        self.enc = _ConvStack1D(ch, p=p, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.enc(x)


class ClusterClassify(nn.Module):
    """(B, T, input_channels * groups) -> per-frame cluster logits
    (B, T, num_clusters * groups) (``a2m/nn/encoders.py:341-359``)."""

    def __init__(self, num_clusters: int = 8, input_channels: int = 256,
                 p: float = 0.0, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = ((input_channels, 256, False),) + ((256, 256, False),) * 5
        self.stack = _ConvStack1D(ch, p=p, groups=groups, dtype=dtype)
        self.logits = _grouped_logits(256 * groups, num_clusters * groups,
                                      groups, dtype)

    def forward(self, x: torch.Tensor,
                time_steps: int | None = None) -> torch.Tensor:
        return _channel_last(self.logits, self.stack(x))
