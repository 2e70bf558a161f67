"""Plain PyTorch reference of a WavLM-Large speech tower in front of the
audio-to-motion window stage, for the benchmark.

The tower follows the published WavLM (Chen et al., arXiv:2110.13900) as
``transformers``' ``WavLMModel`` computes it with
``feat_extract_norm="layer"`` and ``do_stable_layer_norm=True`` (the
configuration of huggingface.co/microsoft/wavlm-large): 1-D convolutions,
each followed by LayerNorm over channels and exact GELU; LayerNorm and a
Linear to the hidden size; a grouped positional convolution under weight
norm, its last frame dropped, GELU, added; pre-LN layers whose attention
adds to the scores the layer-0 embedding of T5's bidirectional log bucket
of s - t, scaled by a gate per query; a final LayerNorm.  The bias is
written out, (H, T, T), one stream at a time so that it fits.  The window
stage is the frozen ``audio2motion.py``'s ``Generator`` less its
``AudioEncoder``.

Everything is f32 (TF32 is the caller's switch; the drivers keep it off).
It imports only torch and numpy: no kernel, no module of the measured
program, no JAX.

Departures from the published description, each the configuration's
``assumed``:

* the weights are drawn from a seed (:func:`seeded_state`), none are
  trained: no checkpoint is in the repository;
* the waveform is normalised per stream to zero mean and unit variance
  (``Wav2Vec2FeatureExtractor``'s ``do_normalize``, eps 1e-7), outside the
  published model;
* the join to the window stage is no part of WavLM: the last hidden state,
  a Linear to the UNet's input width, and a linear resample
  (``align_corners=False``) from 50 Hz to ``n_samples * 15 // 16000``
  frames;
* inference only: no dropout, no LayerDrop, no masking of time steps, no
  padding mask (each stream is one whole sequence).

Two controls compute it lower (:class:`Tower`'s ``fp8``: every product on
operands rounded to fp8 e4m3, cast and back) or with the gated bias left
out (``drop_bias``).
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

try:                              # benchmark/ on sys.path (the drivers)
    from reference import audio2motion as motion
except ImportError:               # this file loaded by its path (the tests)
    _spec_ = importlib.util.spec_from_file_location(
        'wavlm_gen_audio2motion', Path(__file__).with_name('audio2motion.py'))
    motion = importlib.util.module_from_spec(_spec_)
    _spec_.loader.exec_module(motion)

POSE_FPS, WINDOW = 15, 64
NORM_EPS, CONV_LN_EPS = 1e-7, 1e-5
POS_G = 'encoder.pos_conv_embed.conv.parametrizations.weight.original0'
POS_V = 'encoder.pos_conv_embed.conv.parametrizations.weight.original1'


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int
           ) -> torch.Tensor:
    """T5's bidirectional bucket of each offset s - t: half the buckets per
    sign; exact below a quarter of them, then logarithmic up to
    ``max_distance``, the last bucket beyond (in f32, as published)."""
    half = num_buckets // 2
    exact = half // 2
    sign = (rel > 0).long() * half
    n = rel.abs()
    log_part = torch.log(n.float() / exact) / math.log(max_distance / exact)
    far = (exact + log_part * (half - exact)).long().clamp(max=half - 1)
    return sign + torch.where(n < exact, n, far)


def _draw_spec(tower: dict, out_channels: int) -> list:
    """(key, shape, mean, std) of each drawn tensor, in ``WavLMModel``'s
    order, the join last (the configuration's ``assumed`` draw)."""
    d, h = tower['hidden_size'], tower['num_attention_heads']
    f, k_pos = tower['intermediate_size'], tower['num_conv_pos_embeddings']
    groups = tower['num_conv_pos_embedding_groups']
    spec = []

    def norm(key, n):
        spec.extend([(f'{key}.weight', (n,), 1.0, 0.1),
                     (f'{key}.bias', (n,), 0.0, 0.1)])

    def dense(key, n_out, n_in):
        spec.extend([(f'{key}.weight', (n_out, n_in), 0.0, n_in ** -0.5),
                     (f'{key}.bias', (n_out,), 0.0, 0.02)])

    cin = 1
    for i, (c, k) in enumerate(zip(tower['conv_dim'], tower['conv_kernel'])):
        key = f'feature_extractor.conv_layers.{i}'
        spec.append((f'{key}.conv.weight', (c, cin, k), 0.0,
                     (cin * k) ** -0.5))
        if tower['conv_bias']:
            spec.append((f'{key}.conv.bias', (c,), 0.0, 0.02))
        norm(f'{key}.layer_norm', c)
        cin = c
    norm('feature_projection.layer_norm', cin)
    dense('feature_projection.projection', d, cin)
    gain = math.sqrt(d * d / groups) / math.sqrt(d / groups * k_pos)
    spec.extend([('encoder.pos_conv_embed.conv.bias', (d,), 0.0, 0.02),
                 (POS_G, (1, 1, k_pos), gain, 0.1 * gain),
                 (POS_V, (d, d // groups, k_pos), 0.0, 1.0)])
    norm('encoder.layer_norm', d)
    for i in range(tower['num_hidden_layers']):
        key = f'encoder.layers.{i}'
        spec.append((f'{key}.attention.gru_rel_pos_const', (1, h, 1, 1),
                     1.0, 0.25))
        for name in ('k_proj', 'v_proj', 'q_proj', 'out_proj'):
            dense(f'{key}.attention.{name}', d, d)
        spec.extend([(f'{key}.attention.gru_rel_pos_linear.weight',
                      (8, d // h), 0.0, (d // h) ** -0.5),
                     (f'{key}.attention.gru_rel_pos_linear.bias', (8,), 0.0,
                      0.1)])
        if i == 0:
            spec.append((f'{key}.attention.rel_attn_embed.weight',
                         (tower['num_buckets'], h), 0.0, 2.0))
        norm(f'{key}.layer_norm', d)
        dense(f'{key}.feed_forward.intermediate_dense', f, d)
        dense(f'{key}.feed_forward.output_dense', d, f)
        norm(f'{key}.final_layer_norm', d)
    dense('join', out_channels, d)
    return spec


def seeded_state(tower: dict, seed: int, device, out_channels: int = 256
                 ) -> dict:
    """Every weight ``mean + std * N(0, 1)`` from one ``torch.Generator``
    seeded with ``seed`` on ``device``, in :func:`_draw_spec`'s order."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {key: mean + std * torch.randn(shape, generator=gen,
                                          device=device)
            for key, shape, mean, std in _draw_spec(tower, out_channels)}


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).to(torch.float32)


class Tower:
    """The tower and the join at the configuration's ``tower`` block and a
    state of :func:`seeded_state`'s layout.  ``fp8``: every product's
    operands rounded to fp8 e4m3; ``drop_bias``: the gated bias left out."""

    def __init__(self, tower: dict, state: dict, fp8: bool = False,
                 drop_bias: bool = False):
        self.cfg, self.w = tower, {k: v.float() for k, v in state.items()}
        self.op = _fp8 if fp8 else (lambda x: x)
        self.drop_bias = drop_bias

    def _linear(self, x, key):
        return F.linear(self.op(x), self.op(self.w[key + '.weight']),
                        self.w[key + '.bias'])

    def _norm(self, x, key, eps):
        return F.layer_norm(x, x.shape[-1:], self.w[key + '.weight'],
                            self.w[key + '.bias'], eps)

    @torch.no_grad()
    def hidden(self, wave: torch.Tensor) -> torch.Tensor:
        """(N,) waveform -> (T, hidden) last hidden state."""
        c, w, op = self.cfg, self.w, self.op
        x = wave.float()
        x = (x - x.mean()) / torch.sqrt(x.var(unbiased=False) + NORM_EPS)
        h = x[None, None]                                      # (1, 1, N)
        for i, stride in enumerate(c['conv_stride']):
            key = f'feature_extractor.conv_layers.{i}'
            h = F.conv1d(op(h), op(w[key + '.conv.weight']),
                         w.get(key + '.conv.bias'), stride=stride)
            h = F.gelu(self._norm(h.transpose(1, 2), key + '.layer_norm',
                                  CONV_LN_EPS).transpose(1, 2))
        h = h[0].t()                                           # (T, 512)
        eps = c['layer_norm_eps']
        h = self._linear(self._norm(h, 'feature_projection.layer_norm', eps),
                         'feature_projection.projection')
        t, d = h.shape
        k_pos = c['num_conv_pos_embeddings']
        v = w[POS_V]
        weight = w[POS_G] * v / v.norm(dim=(0, 1), keepdim=True)
        pos = F.conv1d(op(h.t()[None]), op(weight),
                       w['encoder.pos_conv_embed.conv.bias'],
                       padding=k_pos // 2,
                       groups=c['num_conv_pos_embedding_groups'])
        if k_pos % 2 == 0:
            pos = pos[..., :-1]
        h = h + F.gelu(pos[0]).t()
        heads = c['num_attention_heads']
        dh = d // heads
        pos_ids = torch.arange(t, device=h.device)
        rel = pos_ids[None, :] - pos_ids[:, None]              # s - t
        bias = w['encoder.layers.0.attention.rel_attn_embed.weight'][
            bucket(rel, c['num_buckets'], c['max_bucket_distance'])
        ].permute(2, 0, 1)                                     # (H, T, T)
        for i in range(c['num_hidden_layers']):
            key = f'encoder.layers.{i}'
            a = f'{key}.attention'
            u = self._norm(h, f'{key}.layer_norm', eps)
            q, k, vv = (self._linear(u, f'{a}.{n}_proj').view(t, heads, dh)
                        .transpose(0, 1) for n in ('q', 'k', 'v'))
            r = F.linear(u.view(t, heads, dh).transpose(0, 1),
                         w[f'{a}.gru_rel_pos_linear.weight'],
                         w[f'{a}.gru_rel_pos_linear.bias'])
            ga, gb = torch.sigmoid(r.view(heads, t, 2, 4).sum(-1)).unbind(-1)
            const = w[f'{a}.gru_rel_pos_const'].view(heads, 1)
            gate = ga * (gb * const - 1.0) + 2.0               # (H, T)
            s = op(q) @ op(k).transpose(1, 2) / math.sqrt(dh)
            if not self.drop_bias:
                s = s + gate[..., None] * bias
            o = (op(torch.softmax(s, dim=-1)) @ op(vv)).transpose(0, 1)
            h = h + self._linear(o.reshape(t, d), f'{a}.out_proj')
            ff = F.gelu(self._linear(
                self._norm(h, f'{key}.final_layer_norm', eps),
                f'{key}.feed_forward.intermediate_dense'))
            h = h + self._linear(ff, f'{key}.feed_forward.output_dense')
        return self._norm(h, 'encoder.layer_norm', eps)

    @torch.no_grad()
    def features(self, wave: torch.Tensor, hidden: torch.Tensor | None = None
                 ) -> torch.Tensor:
        """(N,) waveform -> (n_frames, out_channels) features at pose rate
        (``hidden``: its last hidden state, if already computed)."""
        h = self.hidden(wave) if hidden is None else hidden
        y = self._linear(h, 'join')
        n_frames = wave.shape[-1] * POSE_FPS // self.cfg['sample_rate']
        return F.interpolate(y.t()[None], size=n_frames, mode='linear',
                             align_corners=False)[0].t()


@torch.no_grad()
def window_stage(gen, feats: torch.Tensor) -> torch.Tensor:
    """(B, 64, C) features -> (B, 64, 104) poses: ``gen``'s (the frozen
    reference ``Generator``) UNet and both decoders."""
    x = gen.unet(feats)
    body, hand = gen.body_decoder(x), gen.hand_decoder(x)
    nb, nh = gen.nb, gen.nh
    return torch.cat([body[..., :nb], hand[..., :nh], body[..., nb:],
                      hand[..., nh:]], dim=-1)


@torch.no_grad()
def stream_poses(gen, tower: Tower, wave: torch.Tensor,
                 hidden: torch.Tensor | None = None, block: int = 32
                 ) -> np.ndarray:
    """One (N,) 16 kHz stream -> (n_frames, 104) poses: the tower's
    features, every window of 64 frames at hop 32 (the last clamped to the
    end), the window stage over ``block`` windows at a time, the frozen
    crossfade blend."""
    feats = tower.features(wave, hidden)
    t = feats.shape[0]
    starts = motion.window_starts(t)
    idx = np.minimum(starts[:, None] + np.arange(WINDOW)[None, :], t - 1)
    wins = feats[torch.as_tensor(idx, device=feats.device)]
    pred = torch.cat([window_stage(gen, wins[i:i + block])
                      for i in range(0, len(wins), block)])
    return motion.blend(pred.double().cpu().numpy(), starts, t)
