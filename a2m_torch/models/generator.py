"""Gesture generator (``a2m/models/generator.py:38-169``), eval and train
mode (``model.train()`` turns on dropout and the BatchNorm updates).

Audio (B, T, 128) -> AudioEncoder -> UNet1D -> body decoder (J = 10) and
hand decoder (J = 42), each around a 5-layer GCN stack -> pose (B, T, 104)
in block layout ``[x0..x51, y0..y51]``.  ``dtype`` is a2m's compute dtype
(``Generator(dtype=jnp.bfloat16)``; see :mod:`a2m_torch.nn.layers`): the
parameters stay f32 and the pose comes out in f32.

With ``GeneratorConfig.tower`` the audio stage is a WavLM speech tower
(:class:`~a2m_torch.nn.wavlm.SpeechTower`, ``generator.tower``) that runs
once over each whole 16 kHz stream, and the generator's ``forward`` takes
windows of its (B, T, in_channels) features: the per-window stage alone
(:meth:`Generator.window_stage`), with no ``AudioEncoder``.
"""

from __future__ import annotations

import torch
from torch import nn

from a2m_torch import constants
from a2m_torch.config import GeneratorConfig
from a2m_torch.nn.encoders import AudioEncoder, UNet1D
from a2m_torch.nn.graph import GCNStack
from a2m_torch.nn.layers import (ChannelAttention, ConvNormRelu, Linear,
                                 ResBlock, SelfAttention, cast, f32)


class _PartDecoder(nn.Module):
    """Body/hand decoder trunk around the GCN stack.  The body runs
    ChannelAttention -> SelfAttention before the stack, the hand the
    reverse plus an extra ChannelAttention at the end.  The projections
    and the head run in ``dtype``, the LayerNorm ``norm`` in f32, its output
    cast back (``a2m/models/generator.py:75-97``)."""

    def __init__(self, channels: int, num_joints: int, joint_feat_dim: int,
                 adjacency, out_feats: int, p: float, heads: int,
                 attention_first: bool, extra_post_channel_attn: bool,
                 fused_gcn: bool = False, fused_precise: bool = False,
                 fused_edge: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, j, f = channels, num_joints, joint_feat_dim
        self.num_joints, self.joint_feat_dim = j, f
        self.attention_first, self.dtype = attention_first, dtype
        common = dict(dtype=dtype)
        self.pre_res = ResBlock(c, p=p, **common)
        self.pre_conv = ConvNormRelu(c, c, type='1d', leaky=True, p=p,
                                     **common)
        self.pre_chattn = ChannelAttention(c, **common)
        self.pre_attn = SelfAttention(c, **common)
        self.proj_in = Linear(c, j * f, **common)
        self.gcn = GCNStack(f, adjacency, num_layers=5, heads=heads,
                            dropout=p, fused=fused_gcn,
                            precise=fused_precise, fused_edge=fused_edge,
                            **common)
        self.proj_out = Linear(j * f, c, **common)
        self.norm = nn.LayerNorm(c, eps=1e-6)
        self.post_res = ResBlock(c, p=p, **common)
        self.post_conv = ConvNormRelu(c, c, type='1d', leaky=True, p=p,
                                      **common)
        self.post_attn = SelfAttention(c, **common)
        self.post_chattn = (ChannelAttention(c, **common)
                            if extra_post_channel_attn else None)
        self.logits = Linear(c, out_feats, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_conv(self.pre_res(x))
        if self.attention_first:
            x = self.pre_attn(self.pre_chattn(x))
        else:
            x = self.pre_chattn(self.pre_attn(x))
        b, t, _ = x.shape
        x = self.proj_in(x).view(b, t, self.num_joints, self.joint_feat_dim)
        x = self.gcn(x).reshape(b, t, -1)
        x = cast(self.norm(f32(self.proj_out(x))), self.dtype)
        x = self.post_attn(self.post_conv(self.post_res(x)))
        if self.post_chattn is not None:
            x = self.post_chattn(x)
        return self.logits(x)


class Generator(nn.Module):
    """Audio (B, T, 128) -> pose (B, T, 104), block layout, f32."""

    def __init__(self, config: GeneratorConfig = GeneratorConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        if cfg.tower is None:
            self.tower = None
            self.audio_encoder = AudioEncoder(
                base_channels=cfg.in_channels // 4, p=cfg.dropout,
                dtype=dtype)
        else:
            from a2m_torch.nn.wavlm import SpeechTower
            self.tower = SpeechTower(cfg.tower, cfg.in_channels)
        if cfg.num_style_speakers > 0:
            # additive speaker-style bias over the encoder features
            self.style_emb = nn.Embedding(cfg.num_style_speakers,
                                          cfg.in_channels)
        self.unet = UNet1D(cfg.in_channels, cfg.out_channels, p=cfg.dropout,
                           dtype=dtype)
        body_adj = constants.adjacency_from_edges(constants.body_edges(),
                                                  cfg.num_body_joints)
        hand_adj = constants.adjacency_from_edges(constants.hand_edges(),
                                                  cfg.num_hand_joints)
        common = dict(p=cfg.dropout, heads=cfg.gat_heads,
                      fused_gcn=cfg.fused_gcn,
                      fused_precise=cfg.fused_precise,
                      fused_edge=cfg.fused_edge, dtype=dtype)
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
        """Log-mel windows (B, T, 128), or with a tower its feature windows
        (B, T, in_channels) -> pose (B, T, 104)."""
        feats = (audio if self.tower is not None
                 else self.audio_encoder(audio, time_steps))
        if self.config.num_style_speakers > 0:
            if speaker_ids is None:
                speaker_ids = torch.zeros(audio.shape[0], dtype=torch.long,
                                          device=audio.device)
            style = cast(self.style_emb(speaker_ids.long()), self.dtype)
            feats = feats + style[:, None, :]
        return self.window_stage(feats)

    def window_stage(self, feats: torch.Tensor) -> torch.Tensor:
        """Encoder features (B, T, in_channels) -> pose (B, T, 104): the
        UNet and both decoders."""
        feats = self.unet(feats)
        body = self.body_decoder(feats)
        hand = self.hand_decoder(feats)
        nb, nh = self.config.num_body_joints, self.config.num_hand_joints
        # body = [x0..x9 | y0..y9], hand = [x10..x51 | y10..y51]
        return f32(torch.cat([body[..., :nb], hand[..., :nh],
                              body[..., nb:], hand[..., nh:]], dim=-1))
