"""Motion discriminator (``a2m/models/discriminator.py:31-188``).

Motion (B, T - 1, 104) -> strided conv trunk -> channel-split body/hand dense
GAT branches -> fused logits (B, T_out).  The graph branches are dense masked
attention batched over (B, J, F), in eager PyTorch: they lie outside any
fused kernel in a2m as well.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from a2m_torch import constants
from a2m_torch.config import DiscriminatorConfig
from a2m_torch.models import losses
from a2m_torch.nn.graph import DenseGATConv
from a2m_torch.nn.layers import SelfAttention, adaptive_pool_matrix
from a2m_torch.nn.masking import MaskedBatchNorm


class _ConvBNLReLU(nn.Module):
    """Conv -> BN -> LeakyReLU(0.2) -> Dropout: D's conv unit.  The order
    differs from the generator's ``ConvNormRelu`` (dropout before BN)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 1, groups: int = 1,
                 p: float = 0.3):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride,
                              padding=padding, groups=groups)
        self.bn = MaskedBatchNorm(out_channels)
        self.dropout = nn.Dropout(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x.transpose(1, 2)).transpose(1, 2))
        return self.dropout(F.leaky_relu(x, 0.2))


class Discriminator(nn.Module):
    """``forward(motion (B, T, 104), audio=None) -> (scores (B, T_out) f32,
    aux_logits | None)``.  ``audio`` (B, T_a, audio_feats) is taken iff the
    config's ``audio_fusion`` is on."""

    def __init__(self, config: DiscriminatorConfig = DiscriminatorConfig(),
                 audio_feats: int = 128):
        super().__init__()
        cfg = self.config = config
        g = cfg.groups
        common = dict(groups=g, p=cfg.dropout)
        oc = cfg.out_channels * g
        self.conv1a = _ConvBNLReLU(cfg.in_channels, oc, 4, 2, **common)
        self.conv1b = _ConvBNLReLU(oc, oc, 4, 1, **common)
        cur = oc
        for n in range(1, cfg.n_downsampling + 1):
            mul = min(2 ** n, 16)
            setattr(self, f'conv2_{n}a',
                    _ConvBNLReLU(cur, cur * mul, 4, 2, **common))
            setattr(self, f'conv2_{n}b',
                    _ConvBNLReLU(cur * mul, cur * mul, 4, 1, **common))
            cur = cur * mul
        self.conv3a = _ConvBNLReLU(cur, cur * 2, 4, 1, **common)
        self.conv3b = _ConvBNLReLU(cur * 2, cur * 4, 4, 1, **common)
        self.conv3_attn = SelfAttention(cur * 4)
        self.conv3c = _ConvBNLReLU(cur * 4, cur * 4, 3, 1, **common)

        jf = cfg.joint_feat_dim
        nb, nh = constants.NUM_BODY_JOINTS, constants.NUM_HAND_JOINTS
        body_adj = constants.adjacency_from_edges(constants.body_edges(), nb)
        hand_adj = constants.adjacency_from_edges(constants.hand_edges(), nh)
        self.body_proj = nn.Linear(cur * 2, nb * jf)
        self.body_gat = DenseGATConv(jf, body_adj, heads=cfg.gat_heads)
        self.body_graph_out = nn.Linear(nb * jf, cur * 2)
        self.hand_proj = nn.Linear(cur * 2, nh * jf)
        self.hand_gat = DenseGATConv(jf, hand_adj, heads=cfg.gat_heads)
        self.hand_graph_out = nn.Linear(nh * jf, cur * 2)

        fused = cur * 8
        if cfg.audio_fusion:
            self.audio_fusion = nn.Linear(audio_feats, cur * 4)
            fused += cur * 4
        self.logits = nn.Conv1d(fused, cfg.out_shape * g, 3, 1, padding=1,
                                groups=g)
        if cfg.use_aux_classifier:
            self.aux_fc1 = nn.Linear(cur * 4, 512)
            self.aux_dropout = nn.Dropout(cfg.dropout)
            self.aux_fc2 = nn.Linear(512, cfg.aux_classes)

    def _graph_branch(self, x, proj, gat, out, joints: int) -> torch.Tensor:
        b = x.shape[0]
        x = proj(x.mean(dim=1)).view(b, joints, self.config.joint_feat_dim)
        return out(gat(x).reshape(b, -1))

    def forward(self, x: torch.Tensor, audio: torch.Tensor | None = None):
        cfg = self.config
        # pad T to a multiple of 4 if tiny
        if x.shape[1] < 4:
            x = F.pad(x, (0, 0, 0, 4 - x.shape[1] % 4))
        x = self.conv1b(self.conv1a(x))
        for n in range(1, cfg.n_downsampling + 1):
            x = getattr(self, f'conv2_{n}b')(getattr(self, f'conv2_{n}a')(x))
        x = self.conv3c(self.conv3_attn(self.conv3b(self.conv3a(x))))
        b, t, c = x.shape

        # dual graph branches on the channel halves, tiled over T
        x_body = self._graph_branch(x[..., :c // 2], self.body_proj,
                                    self.body_gat, self.body_graph_out,
                                    constants.NUM_BODY_JOINTS)
        x_hand = self._graph_branch(x[..., c // 2:], self.hand_proj,
                                    self.hand_gat, self.hand_graph_out,
                                    constants.NUM_HAND_JOINTS)
        x_graph = torch.cat([x_body, x_hand], dim=-1)[:, None, :].expand(
            b, t, c)
        conv_feats = x
        x = torch.cat([x, x_graph], dim=-1)

        if audio is not None:
            a = self.audio_fusion(audio)
            if a.shape[1] != t:
                w = adaptive_pool_matrix(a.shape[1], t).to(a)
                a = torch.einsum('os,bsc->boc', w, a)
            x = torch.cat([x, a], dim=-1)

        scores = self.logits(x.transpose(1, 2)).transpose(1, 2)
        if scores.shape[-1] == 1:
            scores = scores[..., 0]                     # (B, T_out)

        aux_logits = None
        if cfg.use_aux_classifier:
            aux = F.leaky_relu(self.aux_fc1(conv_feats.mean(dim=1)), 0.2)
            aux_logits = self.aux_fc2(self.aux_dropout(aux)).float()
        return scores.float(), aux_logits


def aux_cross_entropy(aux_logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """CE over gesture classes; ``mask``: optional (B,) 1/0 weights.  Labels
    lie in [0, n_classes)."""
    per_sample = F.cross_entropy(aux_logits, labels.long(), reduction='none')
    return losses.masked_mean(per_sample, mask)
