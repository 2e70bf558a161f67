"""Carrying a2m (flax) generator weights into the port.

Port attribute paths are a2m's flax scopes, so a flax leaf
``params/<scope>/<leaf>`` or ``batch_stats/<scope>/<leaf>`` maps to the port
entry ``<scope with dots>.<leaf>`` after a leaf rename (``kernel`` and
``scale`` -> ``weight``, ``mean`` -> ``running_mean``, ``var`` ->
``running_var``) and a layout transpose chosen by the port module that owns
the entry:

* ``nn.Conv2d``: flax (kh, kw, in, out) -> (out, in, kh, kw);
* ``nn.Conv1d``: (k, in, out) -> (out, in, k);
* ``ConvTranspose1D``: (k, in, out) -> (in, out, k), no flip;
* ``nn.Linear`` (flax ``Dense``): (in, out) -> (out, in).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from a2m_torch.nn.layers import ConvTranspose1D

_LEAF_RENAME = {'kernel': 'weight', 'scale': 'weight', 'mean': 'running_mean',
                'var': 'running_var'}


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
