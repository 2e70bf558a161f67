"""Miscellaneous heads and utilities (``a2m/nn/misc.py``), channel-last.

``Group`` and ``BatchGroup`` hold their models as a2m's ``Sequence`` field
does: flax names the i-th module ``models_<i>``, and so does the port (a
``ModuleList`` would name it ``models.<i>``), so their variables carry
across :mod:`a2m_torch.weights` unchanged.  Plain callables may sit among
the models, as in a2m.  A2m passes ``train=`` down the call; a port module
keeps its mode itself (``.train()`` / ``.eval()``), so a group passes its
own mode to a model whose ``forward`` takes ``train``.
"""

from __future__ import annotations

import inspect
import math
from typing import Sequence

import torch
from torch import nn

from a2m_torch.nn.layers import cast


def _call_model(model, x, train: bool, **kwargs):
    """``model(x, **kwargs)``, with ``train=`` when the signature of the
    model's ``forward`` (of a plain callable, the callable itself) takes it
    (``a2m/nn/misc.py:14-28``).  Dispatch on the signature, so a
    ``TypeError`` raised inside the model propagates."""
    fn = model.forward if isinstance(model, nn.Module) else model
    params = inspect.signature(fn).parameters
    if 'train' in params or any(p.kind is inspect.Parameter.VAR_KEYWORD
                                for p in params.values()):
        return model(x, train=train, **kwargs)
    return model(x, **kwargs)


class Confidence(nn.Module):
    """Gaussian-entropy confidence loss (``a2m/nn/misc.py:31-54``)."""

    def __init__(self, beta: float = 0.1, epsilon: float = 1e-8):
        super().__init__()
        self.beta, self.epsilon = beta, epsilon

    def forward(self, y, y_cap, confidence):
        if isinstance(confidence, int):
            confidence = torch.ones_like(y)
        sigma = self.get_sigma(confidence)
        p = self.p_ycap_y(y, y_cap, sigma)
        return self.get_entropy(self.get_sigma(p))

    def p_ycap_y(self, y, y_cap, sigma):
        prob = torch.exp(-(y - y_cap) ** 2 / (2 * sigma ** 2))
        return prob / (2 * math.pi * sigma)

    def get_sigma(self, confidence):
        return 1.0 / (2 * math.pi * confidence.clamp_min(self.epsilon))

    def get_entropy(self, sigma):
        return 0.5 * torch.log(2 * math.pi * math.e * sigma ** 2) * self.beta


class EmbLin(nn.Module):
    """An embedding read by lookup (``mode='emb'``, ids) or as a soft linear
    mix (``mode='lin'``, weights @ the table in ``dtype``)
    (``a2m/nn/misc.py:57-70``).  The table is the bare leaf ``emb``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emb = nn.Parameter(torch.randn(num_embeddings, embedding_dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, mode: str = 'lin') -> torch.Tensor:
        if mode != 'lin':
            return self.emb[x.long()]
        table = cast(self.emb, self.dtype)
        # jnp's matmul promotes both operands to the wider dtype
        wide = torch.promote_types(x.dtype, table.dtype)
        return x.to(wide) @ table.to(wide)


class Style(nn.Module):
    """Speaker-style embedding ``style_emb`` (``a2m/nn/misc.py:73-83``)."""

    def __init__(self, num_speakers: int = 1, embedding_dim: int = 256):
        super().__init__()
        self.style_emb = nn.Embedding(num_speakers, embedding_dim)

    def forward(self, speaker_ids: torch.Tensor) -> torch.Tensor:
        return self.style_emb(speaker_ids.long())


def repeat_interleave(x: torch.Tensor, repeats: int,
                      axis: int = -1) -> torch.Tensor:
    """Each element ``repeats`` times along ``axis``."""
    return x.repeat_interleave(repeats, dim=axis)


def transpose(x: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
    """Swap the two axes ``idx``."""
    return x.transpose(idx[0], idx[1])


class Curriculum:
    """Linear scalar schedule from ``start`` to ``end`` over ``num_iters``
    steps (``a2m/nn/misc.py:98-116``): ``step()`` returns the value before
    the step and holds ``end`` after ``num_iters`` steps; ``step(False)``
    reads the value without a step."""

    def __init__(self, start: float, end: float, num_iters: int):
        self.start, self.end, self.num_iters = start, end, num_iters
        self.iters = 0
        self.diff = (end - start) / num_iters
        self.value = start

    def step(self, flag: bool = True) -> float:
        if not flag:
            return self.value
        if self.iters < self.num_iters:
            value = self.value
            self.value += self.diff
            self.iters += 1
            return value
        return self.end


def index_select_outputs(x: torch.Tensor, labels: torch.Tensor,
                         groups: int) -> torch.Tensor:
    """Soft selection over grouped outputs: x (B, T, groups * F), labels
    (B, T, groups) weights -> (B, T, F)."""
    return (x.unflatten(-1, (groups, -1)) * labels[..., None]).sum(dim=-2)


def _split(x: torch.Tensor, n: int, dim: int) -> list[torch.Tensor]:
    """``n`` equal parts along ``dim`` (``jnp.split``'s rule)."""
    if x.shape[dim] % n:
        raise ValueError(f'{x.shape[dim]} does not split into {n} parts')
    return list(x.chunk(n, dim=dim))


class _Models(nn.Module):
    """The models of a group, registered as ``models_<i>``."""

    def __init__(self, models: Sequence):
        super().__init__()
        self.models = list(models)
        for i, model in enumerate(self.models):
            if isinstance(model, nn.Module):
                self.add_module(f'models_{i}', model)

    def _run(self, x, **kwargs):
        for model in self.models:
            x = _call_model(model, x, self.training, **kwargs)
        return x


class Group(_Models):
    """Run ``models`` over group-concatenated inputs
    (``a2m/nn/misc.py:128-149``): a list ``x`` is concatenated along the
    channels (``dim=-1``) or the batch (``dim=0``); with ``labels`` the
    outputs are soft-selected per group, else split back into groups."""

    def __init__(self, models: Sequence, groups: int = 1, dim: int = -1):
        super().__init__(models)
        self.groups, self.dim = groups, dim

    def forward(self, x, labels=None, **kwargs):
        axis = 0 if self.dim == 0 else -1
        groups = len(x) if self.dim == 0 and isinstance(x, list) \
            else self.groups
        if isinstance(x, list):
            x = torch.cat(x, dim=axis)
        x = self._run(x, **kwargs)
        if labels is not None:
            return index_select_outputs(x, labels, groups)
        return _split(x, groups, axis)


class BatchGroup(_Models):
    """Run ``models`` over ``x[group][batch]`` (``a2m/nn/misc.py:152-173``):
    the batches concatenated along axis 0, the groups along the channels;
    the outputs split back the same way, or, with ``labels`` (one per
    batch), soft-selected per group into ``[[out_batch, ...]]``."""

    def __init__(self, models: Sequence, groups: int = 1):
        super().__init__(models)
        self.groups = groups

    def forward(self, x, labels=None, **kwargs):
        if not (isinstance(x, list) and isinstance(x[0], list)):
            raise TypeError('x must be a list of lists: x[group][batch]')
        groups, batches = len(x), len(x[0])
        if groups != self.groups:
            raise ValueError(f'{groups} groups, the module has '
                             f'{self.groups}')
        x = torch.cat([torch.cat(group, dim=0) for group in x], dim=-1)
        x = self._run(x, **kwargs)
        if labels is not None:
            out = index_select_outputs(x, torch.cat(labels, dim=0), groups)
            return [_split(out, batches, 0)]
        return [_split(part, batches, 0) for part in _split(x, groups, -1)]
