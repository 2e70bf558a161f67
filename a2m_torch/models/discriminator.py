"""Motion discriminator (``a2m/models/discriminator.py:31-188``).

Motion (B, T - 1, 104) -> strided conv trunk -> channel-split body/hand dense
GAT branches -> fused logits (B, T_out).  The graph branches are dense masked
attention batched over (B, J, F), in eager PyTorch: they lie outside any
fused kernel in a2m as well.  ``dtype`` is a2m's compute dtype
(``Discriminator(dtype=jnp.bfloat16)``; see :mod:`a2m_torch.nn.layers`);
the scores come out in f32.

Under tensor parallelism (:func:`a2m_torch.parallel.mesh.shard_module`)
``conv3b`` is column-parallel, ``conv3_attn`` and ``conv3c`` row-parallel
(a2m's ``TP_RULES``): each rank of a model group holds its slice of the
2048 channels between them, and ``conv3c``'s output is whole again before
its BatchNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from a2m_torch import constants
from a2m_torch.config import DiscriminatorConfig
from a2m_torch.models import losses
from a2m_torch.nn.graph import DenseGATConv
from a2m_torch.nn.layers import (Conv1d, Linear, SelfAttention,
                                 adaptive_pool_matrix, cast, keep_slice,
                                 sharded_mode)
from a2m_torch.nn.masking import MaskedBatchNorm
from a2m_torch.parallel import tensor as tp_ops

#: (input length, output length, device, dtype) -> the pooling matrix there
_pool_matrices: dict = {}


def _pool_matrix(in_len: int, out_len: int, like: torch.Tensor
                 ) -> torch.Tensor:
    """:func:`adaptive_pool_matrix` on ``like``'s device and in its dtype,
    built once and kept: a step then makes no host-to-device copy."""
    key = (in_len, out_len, like.device, like.dtype)
    if key not in _pool_matrices:
        _pool_matrices[key] = adaptive_pool_matrix(in_len, out_len).to(like)
    return _pool_matrices[key]


class _ConvBNLReLU(nn.Module):
    """Conv -> BN -> LeakyReLU(0.2) -> cast to ``dtype`` -> Dropout: D's
    conv unit (``a2m/models/discriminator.py:45-55``).  The order differs
    from the generator's ``ConvNormRelu`` (dropout before BN)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 1, groups: int = 1,
                 p: float = 0.3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, stride,
                           padding=padding, groups=groups, dtype=dtype)
        self.bn = MaskedBatchNorm(out_channels)
        self.dropout = nn.Dropout(p)
        self.dtype = dtype
        self.tp, self.row = None, False

    def shard_(self, shard, own: dict) -> tuple[dict, list]:
        """Column-parallel (the kernel sliced on its output channels: the
        bias, BatchNorm and dropout act on this rank's channels) or
        row-parallel (sliced on its input channels: the partial output is
        summed over the model group, then the bias, BatchNorm and dropout
        act on the whole)."""
        mode = sharded_mode(own, {'column': {'conv.weight': 0},
                            'row': {'conv.weight': 1}}, '_ConvBNLReLU')
        if self.conv.groups != 1:
            raise ValueError('_ConvBNLReLU: a grouped convolution does not '
                             'shard')
        self.row = mode == 'row'
        keep_slice(self.conv, 'weight', 1 if self.row else 0, shard)
        self.tp = shard
        if self.row:
            return {'conv.weight': 1}, []
        state, partial = self.bn.shard_(shard)
        return ({'conv.weight': 0, **{f'bn.{k}': d for k, d in state.items()}},
                ['conv.bias'] + [f'bn.{k}' for k in partial])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp, conv, dt = self.tp, self.conv, self.dtype
        if tp is None:
            x = self.bn(conv(x.transpose(1, 2)).transpose(1, 2))
            return self.dropout(cast(F.leaky_relu(x, 0.2), dt))
        if self.row:
            y = tp_ops.reduce_from_model(conv._conv_forward(
                cast(x.transpose(1, 2), dt), cast(conv.weight, dt), None), tp)
            y = cast(y + conv.bias[:, None], dt)
        else:
            x = tp_ops.copy_to_model(x, tp)
            bias = conv.bias[tp.part(conv.bias.numel())]
            y = conv._conv_forward(cast(x.transpose(1, 2), dt),
                                   cast(conv.weight, dt), cast(bias, dt))
        x = cast(F.leaky_relu(self.bn(y.transpose(1, 2)), 0.2), dt)
        if self.row:
            return self.dropout(x)
        return tp_ops.dropout(x, self.dropout.p, self.dropout.training, tp)


class Discriminator(nn.Module):
    """``forward(motion (B, T, 104), audio=None) -> (scores (B, T_out) f32,
    aux_logits | None)``.  ``audio`` (B, T_a, audio_feats) is taken iff the
    config's ``audio_fusion`` is on."""

    def __init__(self, config: DiscriminatorConfig = DiscriminatorConfig(),
                 audio_feats: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        g = cfg.groups
        self.dtype = dtype
        common = dict(groups=g, p=cfg.dropout, dtype=dtype)
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
        self.conv3_attn = SelfAttention(cur * 4, dtype=dtype)
        self.conv3c = _ConvBNLReLU(cur * 4, cur * 4, 3, 1, **common)

        jf = cfg.joint_feat_dim
        nb, nh = constants.NUM_BODY_JOINTS, constants.NUM_HAND_JOINTS
        body_adj = constants.adjacency_from_edges(constants.body_edges(), nb)
        hand_adj = constants.adjacency_from_edges(constants.hand_edges(), nh)
        dt = dict(dtype=dtype)
        self.body_proj = Linear(cur * 2, nb * jf, **dt)
        self.body_gat = DenseGATConv(jf, body_adj, heads=cfg.gat_heads, **dt)
        self.body_graph_out = Linear(nb * jf, cur * 2, **dt)
        self.hand_proj = Linear(cur * 2, nh * jf, **dt)
        self.hand_gat = DenseGATConv(jf, hand_adj, heads=cfg.gat_heads, **dt)
        self.hand_graph_out = Linear(nh * jf, cur * 2, **dt)

        fused = cur * 8
        if cfg.audio_fusion:
            self.audio_fusion = Linear(audio_feats, cur * 4, **dt)
            fused += cur * 4
        self.logits = Conv1d(fused, cfg.out_shape * g, 3, 1, padding=1,
                             groups=g, **dt)
        if cfg.use_aux_classifier:
            self.aux_fc1 = Linear(cur * 4, 512, **dt)
            self.aux_dropout = nn.Dropout(cfg.dropout)
            self.aux_fc2 = Linear(512, cfg.aux_classes, **dt)

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
                w = _pool_matrix(a.shape[1], t, a)
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
