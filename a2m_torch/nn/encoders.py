"""Main-path encoders: AudioEncoder and UNet1D (``a2m/nn/encoders.py:
19-114``), channel-last (B, T, C) at their boundaries."""

from __future__ import annotations

import torch
from torch import nn

from a2m_torch.nn.layers import (ConvNormRelu, ConvTranspose1D,
                                 SelfAttention, interpolate_bilinear)


class AudioEncoder(nn.Module):
    """2-D conv stack over the (T, F) log-mel -> (B, T, 4b).

    Channels 1 -> b -> 2b -> 4b -> 8b -> 4b with three stride-2 downsamples
    ((64, 128) -> (8, 16)) and a final (3, 8) kernel -> (8, 15); bilinear
    resize to (T, 1)."""

    def __init__(self, base_channels: int = 64, input_channels: int = 1,
                 p: float = 0.0):
        super().__init__()
        b = base_channels
        common = dict(type='2d', leaky=True, p=p)
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
                 p: float = 0.0):
        super().__init__()
        c = input_channels
        common = dict(type='1d', leaky=True, p=p)
        self.down0 = ConvNormRelu(c, c * 2, **common)
        self.down1 = ConvNormRelu(c * 2, c * 2, downsample=True, **common)
        self.down2 = ConvNormRelu(c * 2, c * 4, **common)
        self.down3 = ConvNormRelu(c * 4, c * 4, downsample=True, **common)
        self.bottleneck = ConvNormRelu(c * 4, c * 8, **common)
        self.bottleneck_attention = SelfAttention(c * 8)
        self.up0 = ConvTranspose1D(c * 8, c * 4)
        self.up_attention = SelfAttention(c * 8)
        self.up1 = ConvNormRelu(c * 8, c * 4, **common)
        self.up2 = ConvTranspose1D(c * 4, c * 2)
        self.up3 = ConvNormRelu(c * 4, c * 2, **common)
        self.final_conv = nn.Linear(c * 2, output_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip1 = x = self.down0(x)
        skip2 = x = self.down2(self.down1(x))
        x = self.bottleneck_attention(self.bottleneck(self.down3(x)))
        x = self.up_attention(torch.cat([self.up0(x), skip2], dim=-1))
        x = self.up2(self.up1(x))
        x = self.up3(torch.cat([x, skip1], dim=-1))
        return self.final_conv(x)
