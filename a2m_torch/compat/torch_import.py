"""Import reference PyTorch checkpoints into the port's models.

The port's own copy of ``a2m/compat/torch_import.py``.  The reference
trainer saves raw ``state_dict()`` files per epoch plus ``Best_Gen``
(``version5_model_train.py:509-515``).  This module maps every tensor of
``SelfAttention_G`` (``real_motion_model.py:16-129``) and
``SelfAttention_D`` (``:464-578``) onto a2m's parameter tree, converting
layouts (torch channel-first conv kernels -> flax channel-last) and module
conventions (1x1 convs -> Dense, torch_geometric GAT/GraphConv -> the dense
formulations of ``nn/graph.py``), exactly as a2m does.  The result is a flat
a2m-scope dict (``'params/body_decoder/proj_in/kernel'``, ...) overlaid on
the target model's own variables (:func:`a2m_torch.weights.to_jax_variables`)
and carried into a ``state_dict`` by
:func:`a2m_torch.weights.from_jax_variables`, so the port and a2m place
every tensor identically.  The conversion is numpy on the host: no kernel
runs, and the caller loads the ``state_dict`` onto its device.

Structural deviations handled explicitly (each recorded in the
:class:`ImportReport` instead of silently dropped):

* **Head layout permutation.**  The reference concatenates a 20-channel body
  head and an 84-channel hand head (``real_motion_model.py:265-266``) whose
  *semantic* channel meaning is imposed by its loss reshape to block layout
  ``[x0..x51 | y0..y51]`` (``:307-347``).  The port's heads are per-part
  consistent (body = joints 0-9, hand = joints 10-51;
  ``models/generator.py``, a2m's ``generator.py:160-168``), so head rows are
  re-gathered across the reference's two head convs.
* **``unet.up_attention`` size bug.**  The reference constructs
  ``SelfAttention(C*4)`` but applies it to a ``C*8`` tensor
  (``model_layers.py:372`` vs ``:359-361`` forward).  The importer accepts a
  ``C*8``-sized tensor set and otherwise leaves the ``C*8`` module at init,
  recording the keys as skipped.
* **GraphConv bias placement.**  torch_geometric puts the single bias on
  ``lin_rel``; ``DenseGraphConv`` puts it on ``lin_root`` (one additive bias
  either way).
* **Dead branches.**  ``audio_fusion`` and the ``aux_classifier`` import
  only when the target model has the branch; otherwise their keys are
  recorded as skipped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from a2m_torch.weights import from_jax_variables, to_jax_variables

# state_dict keys that carry no parameters (buffers / bookkeeping)
_IGNORED_SUFFIXES = ('num_batches_tracked',)
_IGNORED_KEYS = ('body_edge_index_template', 'hand_edge_index_template')


@dataclasses.dataclass
class ImportReport:
    """What the import did NOT place 1:1 (everything else was imported)."""
    skipped: list    # present in the checkpoint, left at init (with reason)
    unused: list     # checkpoint keys never consumed
    missing: list    # model leaves not covered by the checkpoint (at init)

    def raise_if_unexpected(self):
        if self.unused:
            raise ValueError(f'unconsumed checkpoint keys: {self.unused}')


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class _StateDict:
    """Tracks key consumption; raises with context on absent keys."""

    def __init__(self, sd: dict):
        self.sd = {k: _host(v) for k, v in sd.items()}
        self.used: set = set()

    def take(self, key: str, *aliases: str) -> np.ndarray:
        for k in (key,) + aliases:
            if k in self.sd:
                self.used.add(k)
                return self.sd[k].astype(np.float32)
        raise KeyError(f'checkpoint is missing {key!r}'
                       + (f' (aliases tried: {aliases})' if aliases else ''))

    def has(self, key: str) -> bool:
        return key in self.sd

    def mark_used(self, prefix: str) -> list:
        keys = [k for k in self.sd if k.startswith(prefix)]
        self.used.update(keys)
        return keys

    def unused(self) -> list:
        out = []
        for k in self.sd:
            if k in self.used or k in _IGNORED_KEYS:
                continue
            if any(k.endswith(s) for s in _IGNORED_SUFFIXES):
                continue
            out.append(k)
        return sorted(out)


# ---------------------------------------------------------------- converters

def _conv1d_w(w):    # torch (Co, Ci/g, k) -> flax (k, Ci/g, Co)
    return w.transpose(2, 1, 0)


def _conv2d_w(w):    # torch (Co, Ci/g, kh, kw) -> flax (kh, kw, Ci/g, Co)
    return w.transpose(2, 3, 1, 0)


def _linear_w(w):    # torch (Co, Ci) -> flax Dense (Ci, Co)
    return w.T


def _dense_from_1x1(w):   # torch Conv1d k=1 (Co, Ci, 1) -> Dense (Ci, Co)
    return w[:, :, 0].T


def _ct1d_w(w):      # torch ConvTranspose1d (Ci, Co, k) -> a2m (k, Ci, Co)
    return w.transpose(2, 0, 1)


# --------------------------------------------------------- module fragments

def _bn(sd, t, p, b, out, outb):
    """BatchNorm{1,2}d -> MaskedBatchNorm params + batch_stats."""
    out[p + ('scale',)] = sd.take(f'{t}.weight')
    out[p + ('bias',)] = sd.take(f'{t}.bias')
    outb[b + ('mean',)] = sd.take(f'{t}.running_mean')
    outb[b + ('var',)] = sd.take(f'{t}.running_var')


def _cnr(sd, t, p, out, outb, conv2d=False):
    """ConvNormRelu (model_layers.py:51-118) -> {conv, norm}."""
    w = sd.take(f'{t}.conv.weight')
    out[p + ('conv', 'kernel')] = _conv2d_w(w) if conv2d else _conv1d_w(w)
    out[p + ('conv', 'bias')] = sd.take(f'{t}.conv.bias')
    _bn(sd, f'{t}.norm', p + ('norm',), p + ('norm',), out, outb)


def _attn(sd, t, p, out):
    """SelfAttention (model_layers.py:121-146) -> {query, key, value, gamma}."""
    for torch_name, a2m_name in (('query_conv', 'query'), ('key_conv', 'key'),
                                 ('value_conv', 'value')):
        out[p + (a2m_name, 'kernel')] = _dense_from_1x1(
            sd.take(f'{t}.{torch_name}.weight'))
        out[p + (a2m_name, 'bias')] = sd.take(f'{t}.{torch_name}.bias')
    out[p + ('gamma',)] = sd.take(f'{t}.gamma').reshape(1)


def _chattn(sd, t, p, out):
    """ChannelAttention (model_layers.py:149-174): fc.0/fc.2 -> Dense_0/1."""
    out[p + ('Dense_0', 'kernel')] = _linear_w(sd.take(f'{t}.fc.0.weight'))
    out[p + ('Dense_0', 'bias')] = sd.take(f'{t}.fc.0.bias')
    out[p + ('Dense_1', 'kernel')] = _linear_w(sd.take(f'{t}.fc.2.weight'))
    out[p + ('Dense_1', 'bias')] = sd.take(f'{t}.fc.2.bias')


def _resblock(sd, t, p, out, outb):
    """ResBlock (model_layers.py:177-190)."""
    _cnr(sd, f'{t}.conv1', p + ('conv1',), out, outb)
    _cnr(sd, f'{t}.conv2', p + ('conv2',), out, outb)
    _attn(sd, f'{t}.attention', p + ('attention',), out)


def _dense(sd, t, p, out):
    """nn.Linear -> Dense."""
    out[p + ('kernel',)] = _linear_w(sd.take(f'{t}.weight'))
    out[p + ('bias',)] = sd.take(f'{t}.bias')


def _layernorm(sd, t, p, out):
    out[p + ('scale',)] = sd.take(f'{t}.weight')
    out[p + ('bias',)] = sd.take(f'{t}.bias')


def _gat(sd, t, p, out):
    """torch_geometric GATConv -> DenseGATConv.

    PyG >= 2.0 keys: ``lin.weight`` (H*F, Ci), ``att_src``/``att_dst``
    (1, H, F), ``bias`` (F,).  PyG 1.x stored ``weight`` (Ci, H*F) and a
    fused ``att`` (1, H, 2F) ordered (dst || src); both forms are accepted.
    """
    if sd.has(f'{t}.lin.weight') or sd.has(f'{t}.lin_src.weight'):
        out[p + ('lin', 'kernel')] = _linear_w(
            sd.take(f'{t}.lin.weight', f'{t}.lin_src.weight'))
        out[p + ('att_src',)] = sd.take(f'{t}.att_src')[0]
        out[p + ('att_dst',)] = sd.take(f'{t}.att_dst')[0]
    else:                                   # PyG 1.x layout
        out[p + ('lin', 'kernel')] = sd.take(f'{t}.weight')
        att = sd.take(f'{t}.att')[0]        # (H, 2F): (x_dst || x_src) order
        f = att.shape[-1] // 2
        out[p + ('att_dst',)] = att[:, :f]
        out[p + ('att_src',)] = att[:, f:]
    out[p + ('bias',)] = sd.take(f'{t}.bias')


def _graphconv(sd, t, p, out):
    """torch_geometric GraphConv -> DenseGraphConv (bias moves from lin_rel
    to lin_root; one additive bias either way)."""
    out[p + ('lin_rel', 'kernel')] = _linear_w(sd.take(f'{t}.lin_rel.weight'))
    out[p + ('lin_root', 'kernel')] = _linear_w(sd.take(f'{t}.lin_root.weight'))
    out[p + ('lin_root', 'bias')] = sd.take(f'{t}.lin_rel.bias')


# ------------------------------------------------------------ head permutes

#: semantic block-layout channel carried by each head row of the port's
#: per-part decoders; the reference's concatenated output channel c IS
#: semantic channel c (its losses reshape (B,T,2,52) directly,
#: real_motion_model.py:307-347).
_BODY_ROWS = list(range(0, 10)) + list(range(52, 62))      # x0..x9 | y0..y9
_HAND_ROWS = list(range(10, 52)) + list(range(62, 104))    # x10..51 | y10..51


def _head_logits(sd, out):
    """body_logits/hand_logits (Conv1d k=1, real_motion_model.py:93,120) ->
    per-part Dense heads, rows re-gathered into the block-split layout."""
    bw = sd.take('body_logits.weight')[:, :, 0]     # (20, C)
    hw = sd.take('hand_logits.weight')[:, :, 0]     # (84, C)
    bb = sd.take('body_logits.bias')
    hb = sd.take('hand_logits.bias')
    ref_w = np.concatenate([bw, hw], axis=0)        # (104, C) semantic rows
    ref_b = np.concatenate([bb, hb], axis=0)
    out[('body_decoder', 'logits', 'kernel')] = ref_w[_BODY_ROWS].T
    out[('body_decoder', 'logits', 'bias')] = ref_b[_BODY_ROWS]
    out[('hand_decoder', 'logits', 'kernel')] = ref_w[_HAND_ROWS].T
    out[('hand_decoder', 'logits', 'bias')] = ref_b[_HAND_ROWS]


# ------------------------------------------------------------------ models

def _part_decoder(sd, part: str, out, outb):
    """One _PartDecoder trunk (real_motion_model.py:70-120).

    Pre/post Sequential orders differ per part: body pre = [ResBlock, CNR,
    ChannelAttn(2), SelfAttn(3)], hand pre = [ResBlock, CNR, SelfAttn(2),
    ChannelAttn(3)]; body post = [ResBlock, CNR, SelfAttn(2)], hand post =
    [ResBlock, CNR, SelfAttn(2), ChannelAttn(3)].
    """
    dec = (f'{part}_decoder',)
    pre = f'{part}_decoder_pre'
    _resblock(sd, f'{pre}.0', dec + ('pre_res',), out, outb)
    _cnr(sd, f'{pre}.1', dec + ('pre_conv',), out, outb)
    if part == 'body':
        _chattn(sd, f'{pre}.2', dec + ('pre_chattn',), out)
        _attn(sd, f'{pre}.3', dec + ('pre_attn',), out)
    else:
        _attn(sd, f'{pre}.2', dec + ('pre_attn',), out)
        _chattn(sd, f'{pre}.3', dec + ('pre_chattn',), out)

    _dense(sd, f'{part}_proj_in', dec + ('proj_in',), out)
    for i in range(1, 6):
        gp = dec + ('gcn', f'gcn{i}')
        if i % 2 == 1:
            _gat(sd, f'{part}_gcn{i}', gp, out)
        else:
            _graphconv(sd, f'{part}_gcn{i}', gp, out)
        _layernorm(sd, f'{part}_layer_norms.{i - 1}',
                   dec + ('gcn', f'norm{i}'), out)
    _dense(sd, f'{part}_proj_out', dec + ('proj_out',), out)
    _layernorm(sd, f'{part}_norm', dec + ('norm',), out)

    post = f'{part}_decoder_post'
    _resblock(sd, f'{post}.0', dec + ('post_res',), out, outb)
    _cnr(sd, f'{post}.1', dec + ('post_conv',), out, outb)
    _attn(sd, f'{post}.2', dec + ('post_attn',), out)
    if part == 'hand':
        _chattn(sd, f'{post}.3', dec + ('post_chattn',), out)


def _generator_entries(sd: _StateDict):
    """All (a2m path, array) pairs for SelfAttention_G, plus skip notes."""
    out: dict = {}
    outb: dict = {}
    skipped = []

    # AudioEncoder: ModuleList conv.0..4 (model_layers.py:251-263)
    for i in range(5):
        _cnr(sd, f'audio_encoder.conv.{i}', ('audio_encoder', f'conv{i}'),
             out, outb, conv2d=True)

    # UNet1D (model_layers.py:283-374)
    for i, name in enumerate(['down0', 'down1', 'down2', 'down3']):
        _cnr(sd, f'unet.downsample_layers.{i}', ('unet', name), out, outb)
    _cnr(sd, 'unet.bottleneck', ('unet', 'bottleneck'), out, outb)
    _attn(sd, 'unet.bottleneck_attention', ('unet', 'bottleneck_attention'),
          out)
    for i, name in (('0', 'up0'), ('2', 'up2')):     # ConvTranspose1D
        t = f'unet.upsample_layers.{i}'
        out[('unet', name, 'kernel')] = _ct1d_w(
            sd.take(f'{t}.conv_transpose.weight'))
        out[('unet', name, 'bias')] = sd.take(f'{t}.conv_transpose.bias')
        _bn(sd, f'{t}.bn', ('unet', name, 'bn'), ('unet', name, 'bn'),
            out, outb)
    for i, name in (('1', 'up1'), ('3', 'up3')):     # CNR after skip-cat
        _cnr(sd, f'unet.upsample_layers.{i}', ('unet', name), out, outb)
    out[('unet', 'final_conv', 'kernel')] = _dense_from_1x1(
        sd.take('unet.final_conv.weight'))
    out[('unet', 'final_conv', 'bias')] = sd.take('unet.final_conv.bias')

    # up_attention: the reference sizes it C*4 but feeds C*8 — crashes as
    # committed (model_layers.py:372 vs :359-361).  Import only a C*8-sized
    # (user-fixed) tensor set; otherwise leave the init and record.
    q = 'unet.up_attention.query_conv.weight'
    bott = sd.sd['unet.bottleneck.conv.weight'].shape[0]     # C*8
    if sd.has(q) and sd.sd[q].shape[1] == bott:
        _attn(sd, 'unet.up_attention', ('unet', 'up_attention'), out)
    else:
        keys = sd.mark_used('unet.up_attention.')
        skipped.append((tuple(keys), 'reference up_attention is mis-sized '
                        '(SelfAttention(C*4) applied to a C*8 tensor, '
                        'model_layers.py:372); left at init'))

    _part_decoder(sd, 'body', out, outb)
    _part_decoder(sd, 'hand', out, outb)
    _head_logits(sd, out)
    return out, outb, skipped


def _discriminator_entries(sd: _StateDict, has_audio: bool, has_aux: bool):
    """All (a2m path, array) pairs for SelfAttention_D."""
    out: dict = {}
    outb: dict = {}
    skipped = []

    def conv_bn(t_conv, t_bn, p):
        out[(p, 'conv', 'kernel')] = _conv1d_w(sd.take(f'{t_conv}.weight'))
        out[(p, 'conv', 'bias')] = sd.take(f'{t_conv}.bias')
        _bn(sd, t_bn, (p, 'bn'), (p, 'bn'), out, outb)

    # conv1: Sequential [conv,bn,relu,drop,conv,bn,relu,drop]
    # (real_motion_model.py:504-513)
    conv_bn('conv1.0', 'conv1.1', 'conv1a')
    conv_bn('conv1.4', 'conv1.5', 'conv1b')
    # conv2: ModuleList of such Sequentials (:516-532)
    n = 1
    while sd.has(f'conv2.{n - 1}.0.weight'):
        conv_bn(f'conv2.{n - 1}.0', f'conv2.{n - 1}.1', f'conv2_{n}a')
        conv_bn(f'conv2.{n - 1}.4', f'conv2.{n - 1}.5', f'conv2_{n}b')
        n += 1
    # conv3: [conv,bn,relu,drop, conv,bn,relu,drop, attn(8), conv,bn,...]
    # (:535-551)
    conv_bn('conv3.0', 'conv3.1', 'conv3a')
    conv_bn('conv3.4', 'conv3.5', 'conv3b')
    _attn(sd, 'conv3.8', ('conv3_attn',), out)
    conv_bn('conv3.9', 'conv3.10', 'conv3c')

    for name in ('body_proj', 'hand_proj', 'body_graph_out',
                 'hand_graph_out'):
        _dense(sd, name, (name,), out)
    _gat(sd, 'body_gat', ('body_gat',), out)
    _gat(sd, 'hand_gat', ('hand_gat',), out)

    out[('logits', 'kernel')] = _conv1d_w(sd.take('logits.weight'))
    out[('logits', 'bias')] = sd.take('logits.bias')

    if has_audio and sd.has('audio_fusion.weight'):
        out[('audio_fusion', 'kernel')] = _dense_from_1x1(
            sd.take('audio_fusion.weight'))
        out[('audio_fusion', 'bias')] = sd.take('audio_fusion.bias')
    else:
        keys = sd.mark_used('audio_fusion.')
        if keys:
            skipped.append((tuple(keys), 'audio fusion imports only into a '
                            'D initialized with audio (the reference branch '
                            'crashes at its own logits conv, '
                            'real_motion_model.py:568,624-632)'))
    if has_aux and sd.has('aux_classifier.0.weight'):
        _dense(sd, 'aux_classifier.0', ('aux_fc1',), out)
        _dense(sd, 'aux_classifier.3', ('aux_fc2',), out)
    else:
        keys = sd.mark_used('aux_classifier.')
        if keys:
            skipped.append((tuple(keys), 'aux classifier imports only with '
                            'use_aux_classifier=True (the reference head '
                            'declares a 2048-d input but would receive the '
                            'pooled (B,) logits, real_motion_model.py:572-578,'
                            '635-640)'))
    return out, outb, skipped


# ------------------------------------------------------------------ public

def _split(flat: dict) -> tuple[dict, dict]:
    """Flat ``'params/a/b'`` / ``'batch_stats/a/b'`` keys -> two dicts keyed
    by scope tuples, as a2m's ``flatten_dict`` of each collection."""
    p, b = {}, {}
    for key, value in flat.items():
        collection, *path = key.split('/')
        (p if collection == 'params' else b)[tuple(path)] = value
    return p, b


def _merge(flat: dict, out: dict, outb: dict) -> tuple[dict, list]:
    """Overlay converted arrays onto the model's own variables (``flat``,
    :func:`to_jax_variables`), shape-checked; returns the merged flat dict
    and the leaves left at init."""
    flat_p, flat_b = _split(flat)
    missing = [('/'.join(k), 'left at init') for k in
               set(flat_p) - set(out)] + \
              [('/'.join(k) + ' [batch_stats]', 'left at init') for k in
               set(flat_b) - set(outb)]
    for src, dst, kind in ((out, flat_p, 'params'),
                           (outb, flat_b, 'batch_stats')):
        for path, val in src.items():
            if path not in dst:
                raise KeyError(f'{kind} path {"/".join(path)} not in the '
                               'model\'s variable tree (config mismatch?)')
            if dst[path].shape != val.shape:
                raise ValueError(
                    f'{kind} {"/".join(path)}: checkpoint shape {val.shape} '
                    f'!= model shape {dst[path].shape} (config mismatch?)')
            dst[path] = np.asarray(val, dst[path].dtype)
    merged = {'/'.join(('params',) + k): v for k, v in flat_p.items()}
    merged.update({'/'.join(('batch_stats',) + k): v
                   for k, v in flat_b.items()})
    return merged, sorted(missing)


def import_generator(state_dict: dict, model: nn.Module) -> tuple:
    """Map a reference ``SelfAttention_G.state_dict()`` onto the port's
    ``Generator`` ``model`` (a2m's ``import_generator``, which takes flax
    ``variables``).  Leaves the checkpoint does not cover keep ``model``'s
    values.  Returns ``(state_dict, ImportReport)``: a complete
    ``state_dict`` for ``model``, on the host; ``model`` is not changed."""
    sd = _StateDict(state_dict)
    out, outb, skipped = _generator_entries(sd)
    merged, missing = _merge(to_jax_variables(model), out, outb)
    return (from_jax_variables(merged, model),
            ImportReport(skipped=skipped, unused=sd.unused(),
                         missing=missing))


def import_discriminator(state_dict: dict, model: nn.Module) -> tuple:
    """Map a reference ``SelfAttention_D.state_dict()`` onto the port's
    ``Discriminator`` ``model``.  Audio-fusion / aux-classifier tensors
    import only when ``model`` has the branch (its config's
    ``audio_fusion`` / ``use_aux_classifier``).  Returns ``(state_dict,
    ImportReport)``."""
    sd = _StateDict(state_dict)
    flat = to_jax_variables(model)
    flat_p, _ = _split(flat)
    has_audio = any(k[0] == 'audio_fusion' for k in flat_p)
    has_aux = any(k[0] == 'aux_fc1' for k in flat_p)
    out, outb, skipped = _discriminator_entries(sd, has_audio, has_aux)
    # The reference sizes its logits conv for the no-fusion path (cur*8
    # inputs, real_motion_model.py:568) — with audio fusion its own forward
    # would crash.  An audio-enabled D has extra logits input rows
    # (cur*12); fill the leading rows from the checkpoint, keep the fusion
    # rows at init.
    lk = out[('logits', 'kernel')]
    init_lk = flat_p[('logits', 'kernel')]
    if has_audio and lk.shape != init_lk.shape and \
            lk.shape[0] == init_lk.shape[0] and \
            lk.shape[1] < init_lk.shape[1] and \
            lk.shape[2] == init_lk.shape[2]:
        merged = np.asarray(init_lk, np.float32).copy()
        merged[:, :lk.shape[1], :] = lk
        out[('logits', 'kernel')] = merged
        skipped.append((('logits.weight',),
                        'fusion-input rows of logits kept at init (the '
                        'reference logits conv is sized for the no-fusion '
                        'path, real_motion_model.py:568)'))
    merged_flat, missing = _merge(flat, out, outb)
    return (from_jax_variables(merged_flat, model),
            ImportReport(skipped=skipped, unused=sd.unused(),
                         missing=missing))


def load_torch_state_dict(path: str) -> dict:
    """Load a reference checkpoint file (``torch.save(state_dict)``)."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def load_torch_generator(path: str, config=None, strict: bool = True):
    """One-call migration: reference G checkpoint file -> ``(model,
    ImportReport)``, the port's ``Generator(config)`` (on the host, eval
    mode) holding the imported weights; leaves left at init keep the
    port's seeded initialisation (seed 0).

    ``strict`` raises on unconsumed checkpoint keys (typos / architecture
    drift); structural skips (up_attention size bug) never raise.
    """
    from a2m_torch.config import GeneratorConfig
    from a2m_torch.models.generator import Generator

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = Generator(config or GeneratorConfig())
    state, report = import_generator(load_torch_state_dict(path), model)
    if strict:
        report.raise_if_unexpected()
    model.load_state_dict(state)
    return model.eval(), report
