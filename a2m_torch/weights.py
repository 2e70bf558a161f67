"""Carrying a2m (flax) weights into the port and back.

Port attribute paths are a2m's flax scopes, so a flax leaf
``params/<scope>/<leaf>`` or ``batch_stats/<scope>/<leaf>`` maps to the port
entry ``<scope with dots>.<leaf>`` after a leaf rename (``kernel`` and
``scale`` -> ``weight``, ``mean`` -> ``running_mean``, ``var`` ->
``running_var``) and a layout transpose chosen by the port module that owns
the entry:

* ``nn.Conv2d``: flax (kh, kw, in, out) -> (out, in, kh, kw);
* ``nn.Conv1d``: (k, in, out) -> (out, in, k);
* ``ConvTranspose1D``: (k, in, out) -> (in, out, k), no flip;
* ``nn.Linear`` (flax ``Dense``): (in, out) -> (out, in);
* ``nn.Embedding`` (flax ``Embed``): the ``embedding`` leaf is the port's
  ``weight``, same layout.

A grouped ``nn.Conv1d`` follows the ``Conv1d`` rule: flax keeps
(k, in / groups, out), PyTorch (out, in / groups, k).  A leaf a module
declares itself (``EmbLin``'s ``emb``, ``SelfAttention``'s ``gamma``, the
GAT vectors) keeps its name and layout, and the i-th model of a
``Group``/``BatchGroup`` is registered as ``models_<i>``, the scope flax
gives a module held in a ``Sequence`` field, so those need no rule.
:func:`to_jax_variables` is the inverse of :func:`from_jax_variables`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from a2m_torch.nn.layers import ConvTranspose1D
from a2m_torch.nn.masking import MaskedBatchNorm

_LEAF_RENAME = {'kernel': 'weight', 'scale': 'weight', 'mean': 'running_mean',
                'var': 'running_var', 'embedding': 'weight'}


def load_generator_npz(path) -> tuple[dict[str, np.ndarray],
                                      dict[str, np.ndarray]]:
    """Packed best-generator ``.npz`` -> (flat variables, normalisation
    stats).  f16 params become f32; ``batch_stats`` are stored in f32.
    Variables keep their ``params/...`` / ``batch_stats/...`` keys; the
    stats dict holds ``mean``/``std`` when the file has them."""
    with np.load(Path(path), allow_pickle=False) as z:
        flat = {k: z[k].astype(np.float32) if z[k].dtype == np.float16
                else z[k] for k in z.files}
    stats = {k.split('/', 1)[1]: flat.pop(k) for k in list(flat)
             if k.startswith('stats/')}
    return flat, stats


def _port_layout(module: nn.Module, leaf: str, value: np.ndarray
                 ) -> np.ndarray:
    if leaf != 'kernel':
        return value
    if isinstance(module, (nn.Conv1d, nn.Conv2d)):
        return value.transpose(value.ndim - 1, value.ndim - 2,
                               *range(value.ndim - 2))
    if isinstance(module, ConvTranspose1D):
        return value.transpose(1, 2, 0)
    if isinstance(module, nn.Linear):
        return value.T
    raise ValueError(f'no layout rule for a kernel of {type(module).__name__}')


def from_jax_variables(flat: dict, model: nn.Module) -> dict:
    """Flat a2m variables -> a complete state_dict for ``model``.

    ``flat`` keys are ``'params/a/b/kernel'`` strings (the npz layout) or
    tuples ``('params', 'a', 'b', 'kernel')`` (``flatten_dict`` of a flax
    ``variables`` tree).  Raises on a key that maps to no port entry, on a
    shape mismatch, and on any port entry left unset."""
    expected = model.state_dict()
    out = {}
    for key, value in flat.items():
        parts = key.split('/') if isinstance(key, str) else list(key)
        collection, *scope, leaf = parts
        if collection not in ('params', 'batch_stats'):
            raise KeyError(f'unused a2m variable {key!r}')
        name = '.'.join(scope + [_LEAF_RENAME.get(leaf, leaf)])
        if name not in expected:
            raise KeyError(f'unused a2m variable {key!r} (no port entry '
                           f'{name!r})')
        module = model.get_submodule('.'.join(scope))
        v = np.ascontiguousarray(_port_layout(module, leaf, np.asarray(value)))
        if tuple(v.shape) != tuple(expected[name].shape):
            raise ValueError(f'{key!r}: shape {v.shape} does not fit port '
                             f'entry {name!r} {tuple(expected[name].shape)}')
        out[name] = torch.from_numpy(v.astype(np.float32))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f'port entries left unset: {missing}')
    return out


def to_jax_variables(model: nn.Module) -> dict[str, np.ndarray]:
    """A port module's state -> flat a2m variables ``{'params/a/b/kernel':
    array, 'batch_stats/a/b/mean': array}`` (f32 numpy), the inverse of
    :func:`from_jax_variables`."""
    out = {}
    for name, tensor in model.state_dict().items():
        *scope, leaf = name.split('.')
        module = model.get_submodule('.'.join(scope))
        value = tensor.detach().cpu().numpy().astype(np.float32)
        collection = 'params'
        if isinstance(module, MaskedBatchNorm):
            if leaf in ('running_mean', 'running_var'):
                collection, leaf = 'batch_stats', leaf[len('running_'):]
            elif leaf == 'weight':
                leaf = 'scale'
        elif isinstance(module, nn.LayerNorm):
            leaf = 'scale' if leaf == 'weight' else leaf
        elif isinstance(module, nn.Embedding):
            leaf = 'embedding'
        elif leaf == 'weight':
            leaf = 'kernel'
            if isinstance(module, (nn.Conv1d, nn.Conv2d)):
                value = value.transpose(*range(2, value.ndim), 1, 0)
            elif isinstance(module, ConvTranspose1D):
                value = value.transpose(2, 0, 1)
            elif isinstance(module, nn.Linear):
                value = value.T
            else:
                raise ValueError(f'no layout rule for the weight of '
                                 f'{type(module).__name__} ({name})')
        out['/'.join([collection, *scope, leaf])] = np.ascontiguousarray(
            value)
    return out
