"""A WavLM speech tower (Chen et al., arXiv:2110.13900) in front of the
generator's window stage: 16 kHz waveforms -> (S, T, C) features at pose
rate.

:class:`SpeechTower` holds, under the parameter names of
``transformers``' ``WavLMModel`` (``feat_extract_norm="layer"``,
``do_stable_layer_norm=True``):

* the waveform normalised per stream to zero mean and unit variance;
* the feature extractor: 1-D convolutions (512 channels, kernels
  10,3,3,3,3,2,2, strides 5,2,2,2,2,2,2 at WavLM-Large's widths), each
  followed by LayerNorm over channels and exact GELU: 50 frames a second;
* the feature projection: LayerNorm, Linear to the hidden size;
* the positional convolution (grouped, weight norm folded at load), its
  last frame dropped, GELU, added to the hidden state;
* pre-LN layers ``h += Attn(LN(h)); h += FFN(LN(h))`` whose attention adds
  a gated relative-position bias to the scores (K6,
  :mod:`a2m_torch.nn.rel_attention`), then a final LayerNorm;
* the join to the window stage: Linear to the UNet's input width, then a
  linear resample (``align_corners=False``) from 50 Hz to
  ``n_samples * 15 // 16000`` frames.

Precision: every matrix product and convolution runs on bf16 operands
(:meth:`SpeechTower.operand`; cuBLAS and cuDNN sum in f32 and round the
result to bf16), its result taken back to f32.  The residual stream,
LayerNorm, GELU, the gates (a 64 -> 8 product per head, kept in f32) and
the softmax stay f32.  The extractor's convolutions run as products over
strided windows in (B, T, C) layout, so that LayerNorm over channels needs
no transpose; the positional convolution is cuDNN's grouped convolution.

No checkpoint is in the repository: :func:`seeded_state` draws the weights
from a seed, in ``WavLMModel``'s layout (weight norm as its ``g`` and
``v``), and :meth:`SpeechTower.load_hf_state` loads them.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from a2m_torch.config import TowerConfig, validate_tower
from a2m_torch.nn.rel_attention import flat_distance, rel_attention

#: pose frames a second (the window stage's rate)
POSE_FPS = 15
#: the epsilon of the input normalisation (``Wav2Vec2FeatureExtractor``'s)
NORM_EPS = 1e-7
#: the extractor's LayerNorm epsilon (``nn.LayerNorm``'s default there)
CONV_LN_EPS = 1e-5
POS_G = 'encoder.pos_conv_embed.conv.parametrizations.weight.original0'
POS_V = 'encoder.pos_conv_embed.conv.parametrizations.weight.original1'


def relative_buckets(rel: torch.Tensor, num_buckets: int,
                     max_distance: int) -> torch.Tensor:
    """T5's bidirectional log buckets of the offsets ``rel`` (= s - t), as
    ``WavLMAttention._relative_positions_bucket`` computes them (the same
    f32 operations in the same order)."""
    half = num_buckets // 2
    out = (rel > 0).to(torch.long) * half
    rel = torch.abs(rel)
    max_exact = half // 2
    large = torch.log(rel.float() / max_exact)
    large = large / math.log(max_distance / max_exact)
    large = (max_exact + large * (half - max_exact)).to(torch.long)
    large = torch.minimum(large, torch.full_like(large, half - 1))
    return out + torch.where(rel < max_exact, rel, large)


@functools.lru_cache(maxsize=16)
def _bucket_row(t: int, num_buckets: int, max_distance: int,
                device: str) -> tuple[torch.Tensor, int]:
    """(2T - 1,) bucket of each offset -(T - 1) .. T - 1, computed on the
    CPU (so that every device gets the same integers) and moved, and the
    offset from which the buckets saturate (K6's ``flat``)."""
    row = relative_buckets(torch.arange(-(t - 1), t), num_buckets,
                           max_distance)
    return row.to(device), flat_distance(row)


def _spec(cfg: TowerConfig, out_channels: int) -> list:
    """(key, shape, mean, std) of every tensor of the seeded draw, in
    ``WavLMModel``'s order, the join last."""
    d, h, f = cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size
    k_pos = cfg.num_conv_pos_embeddings
    groups = cfg.num_conv_pos_embedding_groups
    out = []

    def ln(key, n):
        out.extend([(f'{key}.weight', (n,), 1.0, 0.1),
                    (f'{key}.bias', (n,), 0.0, 0.1)])

    def linear(key, n_out, n_in):
        out.extend([(f'{key}.weight', (n_out, n_in), 0.0, n_in ** -0.5),
                    (f'{key}.bias', (n_out,), 0.0, 0.02)])

    cin = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        key = f'feature_extractor.conv_layers.{i}'
        out.append((f'{key}.conv.weight', (c, cin, k), 0.0,
                    (cin * k) ** -0.5))
        if cfg.conv_bias:
            out.append((f'{key}.conv.bias', (c,), 0.0, 0.02))
        ln(f'{key}.layer_norm', c)
        cin = c
    ln('feature_projection.layer_norm', cin)
    linear('feature_projection.projection', d, cin)
    # weight norm: g * v / |v| over all but the kernel axis; g sets the
    # convolution's gain (|v| ~ sqrt(d * d / groups), its fan-in
    # sqrt(d / groups * k_pos))
    gain = math.sqrt(d * d / groups) / math.sqrt(d / groups * k_pos)
    out.extend([('encoder.pos_conv_embed.conv.bias', (d,), 0.0, 0.02),
                (POS_G, (1, 1, k_pos), gain, 0.1 * gain),
                (POS_V, (d, d // groups, k_pos), 0.0, 1.0)])
    ln('encoder.layer_norm', d)
    for i in range(cfg.num_hidden_layers):
        key = f'encoder.layers.{i}'
        out.append((f'{key}.attention.gru_rel_pos_const', (1, h, 1, 1), 1.0,
                    0.25))
        for name in ('k_proj', 'v_proj', 'q_proj', 'out_proj'):
            linear(f'{key}.attention.{name}', d, d)
        out.extend([(f'{key}.attention.gru_rel_pos_linear.weight',
                     (8, d // h), 0.0, (d // h) ** -0.5),
                    (f'{key}.attention.gru_rel_pos_linear.bias', (8,), 0.0,
                     0.1)])
        if i == 0:
            out.append((f'{key}.attention.rel_attn_embed.weight',
                        (cfg.num_buckets, h), 0.0, 2.0))
        ln(f'{key}.layer_norm', d)
        linear(f'{key}.feed_forward.intermediate_dense', f, d)
        linear(f'{key}.feed_forward.output_dense', d, f)
        ln(f'{key}.final_layer_norm', d)
    linear('join', out_channels, d)
    return out


def seeded_state(cfg: TowerConfig, seed: int, device='cpu',
                 out_channels: int = 256) -> dict[str, torch.Tensor]:
    """The tower's weights drawn from ``seed`` on ``device``, in
    ``WavLMModel``'s layout plus ``join.*``: each tensor ``mean + std *
    N(0, 1)`` from one ``torch.Generator``, in :func:`_spec`'s order.
    Products draw std 1/sqrt(fan-in), so that the scores q.k/8 spread by
    about 1; the bucket embedding draws std 2, so that the gated bias
    (gates near 1-2) spreads by 3-4 and the attention's position term moves
    the hidden state far beyond bf16's rounding."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {key: mean + std * torch.randn(shape, generator=gen,
                                          device=device)
            for key, shape, mean, std in _spec(cfg, out_channels)}


def hf_num_params(cfg: TowerConfig) -> int:
    """Parameters of ``WavLMModel`` at ``cfg``: the seeded draw's tensors
    without the join, and the (hidden,) ``masked_spec_embed`` that only
    pre-training reads."""
    return cfg.hidden_size + sum(math.prod(shape)
                                 for key, shape, _, _ in _spec(cfg, 1)
                                 if not key.startswith('join.'))


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 bias: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride, bias=bias)
        self.layer_norm = nn.LayerNorm(cout, eps=CONV_LN_EPS)


class _Extractor(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        cins = (1,) + tuple(cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            _ConvLayer(cin, c, k, s, cfg.conv_bias) for cin, c, k, s in
            zip(cins, cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride))


class _Projection(nn.Module):
    def __init__(self, cin: int, d: int, eps: float):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cin, eps=eps)
        self.projection = nn.Linear(cin, d)


class _PosConv(nn.Module):
    def __init__(self, d: int, k: int, groups: int):
        super().__init__()
        self.conv = nn.Conv1d(d, d, k, padding=k // 2, groups=groups)


class _Attention(nn.Module):
    def __init__(self, d: int, heads: int, num_buckets: int | None):
        super().__init__()
        self.heads = heads
        self.k_proj, self.v_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.q_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, heads, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(d // heads, 8)
        if num_buckets is not None:
            self.rel_attn_embed = nn.Embedding(num_buckets, heads)


class _FeedForward(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(d, f)
        self.output_dense = nn.Linear(f, d)


class _Layer(nn.Module):
    def __init__(self, cfg: TowerConfig, first: bool):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = _Attention(d, cfg.num_attention_heads,
                                    cfg.num_buckets if first else None)
        self.layer_norm = nn.LayerNorm(d, eps=eps)
        self.feed_forward = _FeedForward(d, cfg.intermediate_size)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.pos_conv_embed = _PosConv(cfg.hidden_size,
                                       cfg.num_conv_pos_embeddings,
                                       cfg.num_conv_pos_embedding_groups)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(cfg, i == 0)
                                    for i in range(cfg.num_hidden_layers))


class SpeechTower(nn.Module):
    """(S, N) 16 kHz waveforms -> (S, n_frames, out_channels) f32 features
    at pose rate; :meth:`encode` stops at the last hidden state."""

    def __init__(self, cfg: TowerConfig, out_channels: int = 256):
        super().__init__()
        validate_tower(cfg)
        self.cfg = cfg
        self.sample_rate = cfg.sample_rate
        self.feature_extractor = _Extractor(cfg)
        self.feature_projection = _Projection(cfg.conv_dim[-1],
                                              cfg.hidden_size,
                                              cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.join = nn.Linear(cfg.hidden_size, out_channels)
        self._operands: dict = {}

    # -- weights ------------------------------------------------------------

    def load_hf_state(self, state: dict) -> None:
        """Load a state in ``WavLMModel``'s layout plus ``join.*``
        (:func:`seeded_state`), folding the positional convolution's weight
        norm (``g * v / |v|``, the norm over all but the kernel axis)."""
        state = dict(state)
        g, v = state.pop(POS_G), state.pop(POS_V)
        state.pop('masked_spec_embed', None)
        norm = v.norm(dim=(0, 1), keepdim=True)
        state['encoder.pos_conv_embed.conv.weight'] = g * v / norm
        self.load_state_dict(state)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand: ``x`` rounded to bf16."""
        return x.to(torch.bfloat16)

    def _cast(self, key: str, *params: torch.Tensor) -> torch.Tensor:
        """The operand copy of ``params`` (concatenated on dim 0), kept
        while the parameters keep their storage and version.  The copy is
        detached (the tower serves; it does not train) and made outside
        inference mode, so that a call with autograd on can still use a
        copy first made under ``torch.inference_mode``."""
        tag = tuple((p.data_ptr(), p._version, p.device) for p in params)
        hit = self._operands.get(key)
        if hit is None or hit[0] != tag:
            with torch.no_grad(), torch.inference_mode(False):
                value = self.operand(torch.cat(params) if len(params) > 1
                                     else params[0])
            hit = self._operands[key] = (tag, value)
        return hit[1]

    def _linear(self, key: str, x: torch.Tensor, *mods: nn.Linear
                ) -> torch.Tensor:
        """``x`` through the Linear layers ``mods`` (outputs concatenated),
        on bf16 operands; the result in bf16."""
        w = self._cast(key + '.w', *(m.weight for m in mods))
        b = self._cast(key + '.b', *(m.bias for m in mods))
        return F.linear(self.operand(x), w, b)

    # -- forward --------------------------------------------------------------

    def num_frames(self, n_samples: int) -> int:
        """Pose frames of ``n_samples`` samples: n * 15 // sample rate."""
        return n_samples * POSE_FPS // self.sample_rate

    def _extract(self, x: torch.Tensor) -> torch.Tensor:
        """(S, N) normalised waveform -> (S, T, 512) f32, channel-last:
        each convolution is a product over the strided windows."""
        h = x[:, :, None]
        for i, layer in enumerate(self.feature_extractor.conv_layers):
            conv = layer.conv
            k, s = conv.kernel_size[0], conv.stride[0]
            win = self.operand(h).unfold(1, k, s)            # (S, T', C, k)
            w = self._cast(f'conv{i}', conv.weight.flatten(1))
            y = F.linear(win.reshape(*win.shape[:2], -1), w)
            if conv.bias is not None:
                y = y + conv.bias
            y = F.layer_norm(y.float(), (y.shape[-1],),
                             layer.layer_norm.weight, layer.layer_norm.bias,
                             layer.layer_norm.eps)
            h = F.gelu(y)
        return h

    def _attention(self, att: _Attention, u: torch.Tensor,
                   table: torch.Tensor, flat: int, key: str) -> torch.Tensor:
        b, t, d = u.shape
        heads = att.heads
        qkv = self._linear(key + '.qkv', u, att.q_proj, att.k_proj,
                           att.v_proj).view(b, t, 3, heads, d // heads)
        q, k, v = qkv.unbind(2)
        # the gate per query and head, in f32 (WavLM's gru_rel_pos)
        r = att.gru_rel_pos_linear(u.view(b, t, heads, d // heads))
        ga, gb = torch.sigmoid(r.view(b, t, heads, 2, 4).sum(-1)).unbind(-1)
        gates = ga * (gb * att.gru_rel_pos_const.view(heads) - 1.0) + 2.0
        o = rel_attention(q, k, v, gates, table, (d // heads) ** -0.5, flat)
        return self._linear(key + '.out', o.view(b, t, d), att.out_proj)

    def encode(self, waves: torch.Tensor) -> torch.Tensor:
        """(S, N) waveforms -> (S, T, hidden) f32 last hidden state."""
        x = waves.float()
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        x = (x - mean) / torch.sqrt(var + NORM_EPS)
        feats = self._extract(x)
        proj = self.feature_projection
        h = self._linear('proj', F.layer_norm(
            feats, feats.shape[-1:], proj.layer_norm.weight,
            proj.layer_norm.bias, proj.layer_norm.eps),
            proj.projection).float()
        t = h.shape[1]
        enc = self.encoder
        pc = enc.pos_conv_embed.conv
        pos = F.conv1d(self.operand(h.transpose(1, 2)),
                       self._cast('pos.w', pc.weight),
                       self._cast('pos.b', pc.bias),
                       padding=pc.padding, groups=pc.groups)[..., :t]
        h = h + F.gelu(pos.float()).transpose(1, 2)
        cfg = self.cfg
        embed = enc.layers[0].attention.rel_attn_embed.weight
        row, flat = _bucket_row(t, cfg.num_buckets, cfg.max_bucket_distance,
                                str(h.device))
        table = embed[row].t().contiguous()
        for i, layer in enumerate(enc.layers):
            key = f'layer{i}'
            h = h + self._attention(layer.attention, layer.layer_norm(h),
                                    table, flat, key).float()
            ff = layer.feed_forward
            x = F.gelu(self._linear(key + '.ff1', layer.final_layer_norm(h),
                                    ff.intermediate_dense).float())
            h = h + self._linear(key + '.ff2', x, ff.output_dense).float()
        return enc.layer_norm(h)

    def forward(self, waves: torch.Tensor,
                n_frames: int | None = None) -> torch.Tensor:
        """(S, N) waveforms -> (S, n_frames, out_channels) features;
        ``n_frames`` defaults to :meth:`num_frames` of N."""
        if n_frames is None:
            n_frames = self.num_frames(waves.shape[-1])
        y = self._linear('join', self.encode(waves), self.join).float()
        y = F.interpolate(y.transpose(1, 2), size=n_frames, mode='linear',
                          align_corners=False)
        return y.transpose(1, 2).contiguous()
