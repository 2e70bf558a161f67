"""Gesture generator (``a2m/models/generator.py:38-169``), eval and train
mode (``model.train()`` turns on dropout and the BatchNorm updates).

Audio (B, T, 128) -> AudioEncoder -> UNet1D -> body decoder (J = 10) and
hand decoder (J = 42), each around a 5-layer GCN stack -> pose (B, T, 104)
in block layout ``[x0..x51, y0..y51]``.
"""

from __future__ import annotations

import torch
from torch import nn

from a2m_torch import constants
from a2m_torch.config import GeneratorConfig
from a2m_torch.nn.encoders import AudioEncoder, UNet1D
from a2m_torch.nn.graph import GCNStack
from a2m_torch.nn.layers import (ChannelAttention, ConvNormRelu, ResBlock,
                                 SelfAttention)


class _PartDecoder(nn.Module):
    """Body/hand decoder trunk around the GCN stack.  The body runs
    ChannelAttention -> SelfAttention before the stack, the hand the
    reverse plus an extra ChannelAttention at the end."""

    def __init__(self, channels: int, num_joints: int, joint_feat_dim: int,
                 adjacency, out_feats: int, p: float, heads: int,
                 attention_first: bool, extra_post_channel_attn: bool,
                 fused_gcn: bool = False, fused_precise: bool = False):
        super().__init__()
        c, j, f = channels, num_joints, joint_feat_dim
        self.num_joints, self.joint_feat_dim = j, f
        self.attention_first = attention_first
        self.pre_res = ResBlock(c, p=p)
        self.pre_conv = ConvNormRelu(c, c, type='1d', leaky=True, p=p)
        self.pre_chattn = ChannelAttention(c)
        self.pre_attn = SelfAttention(c)
        self.proj_in = nn.Linear(c, j * f)
        self.gcn = GCNStack(f, adjacency, num_layers=5, heads=heads,
                            dropout=p, fused=fused_gcn,
                            precise=fused_precise)
        self.proj_out = nn.Linear(j * f, c)
        self.norm = nn.LayerNorm(c, eps=1e-6)
        self.post_res = ResBlock(c, p=p)
        self.post_conv = ConvNormRelu(c, c, type='1d', leaky=True, p=p)
        self.post_attn = SelfAttention(c)
        self.post_chattn = (ChannelAttention(c) if extra_post_channel_attn
                            else None)
        self.logits = nn.Linear(c, out_feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_conv(self.pre_res(x))
        if self.attention_first:
            x = self.pre_attn(self.pre_chattn(x))
        else:
            x = self.pre_chattn(self.pre_attn(x))
        b, t, _ = x.shape
        x = self.proj_in(x).view(b, t, self.num_joints, self.joint_feat_dim)
        x = self.gcn(x).reshape(b, t, -1)
        x = self.norm(self.proj_out(x))
        x = self.post_attn(self.post_conv(self.post_res(x)))
        if self.post_chattn is not None:
            x = self.post_chattn(x)
        return self.logits(x)


class Generator(nn.Module):
    """Audio (B, T, 128) -> pose (B, T, 104), block layout."""

    def __init__(self, config: GeneratorConfig = GeneratorConfig()):
        super().__init__()
        cfg = self.config = config
        self.audio_encoder = AudioEncoder(base_channels=cfg.in_channels // 4,
                                          p=cfg.dropout)
        if cfg.num_style_speakers > 0:
            # additive speaker-style bias over the encoder features
            self.style_emb = nn.Embedding(cfg.num_style_speakers,
                                          cfg.in_channels)
        self.unet = UNet1D(cfg.in_channels, cfg.out_channels, p=cfg.dropout)
        body_adj = constants.adjacency_from_edges(constants.body_edges(),
                                                  cfg.num_body_joints)
        hand_adj = constants.adjacency_from_edges(constants.hand_edges(),
                                                  cfg.num_hand_joints)
        common = dict(p=cfg.dropout, heads=cfg.gat_heads,
                      fused_gcn=cfg.fused_gcn,
                      fused_precise=cfg.fused_precise)
        self.body_decoder = _PartDecoder(
            cfg.out_channels, cfg.num_body_joints, cfg.joint_feat_dim,
            body_adj, cfg.body_feats, attention_first=True,
            extra_post_channel_attn=False, **common)
        self.hand_decoder = _PartDecoder(
            cfg.out_channels, cfg.num_hand_joints, cfg.joint_feat_dim,
            hand_adj, cfg.out_feats - cfg.body_feats, attention_first=False,
            extra_post_channel_attn=True, **common)

    def forward(self, audio: torch.Tensor, time_steps: int | None = None,
                speaker_ids: torch.Tensor | None = None) -> torch.Tensor:
        feats = self.audio_encoder(audio, time_steps)
        if self.config.num_style_speakers > 0:
            if speaker_ids is None:
                speaker_ids = torch.zeros(audio.shape[0], dtype=torch.long,
                                          device=audio.device)
            feats = feats + self.style_emb(speaker_ids.long())[:, None, :]
        feats = self.unet(feats)
        body = self.body_decoder(feats)
        hand = self.hand_decoder(feats)
        nb, nh = self.config.num_body_joints, self.config.num_hand_joints
        # body = [x0..x9 | y0..y9], hand = [x10..x51 | y10..y51]
        return torch.cat([body[..., :nb], hand[..., :nh],
                          body[..., nb:], hand[..., nh:]], dim=-1)
