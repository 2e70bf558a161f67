"""Checkpoints of a training run, and the packed best-generator file.

Counterpart of ``a2m/train/checkpoint.py``.  :class:`CheckpointManager` is
the port's own: one ``torch.save`` file an epoch, ``epoch_<n>.pt``, holding
the complete training state (both models' ``state_dict``s, both Adam
``state_dict``s, the controller's ``state_dict``, the pose ``mean``/``std``,
``extra`` such as the loss history, and the epoch), so a run resumes
exactly; files are read back with ``torch.load(weights_only=True)``, so the
payload is tensors and plain containers only.  a2m keeps Orbax directories,
which the port cannot read (it imports no ``jax``).

The bridge between the two packages is the packed best-generator ``.npz``
(``checkpoint.py:164-237``): flat ``params/<scope>/<leaf>`` and
``batch_stats/<scope>/<leaf>`` keys in a2m's layout
(:func:`a2m_torch.weights.to_jax_variables`), params in f16 where their
largest magnitude is below 6e4 (else f32), ``batch_stats`` always in f32
(GAN-trained BatchNorm variances exceed f16's 65504), and the training
pose statistics as ``stats/mean`` and ``stats/std`` in f32.  Either package
reads the other's file.

In a process group every rank enters each save, rank 0 alone writes, and
all ranks meet at a barrier after it (a2m's ``loop.py:555-622``), so no rank
reads or outlives a file that is not there yet; every rank restores.  A
model sharded by tensor parallelism (:func:`a2m_torch.parallel.mesh
.shard_module`) is gathered first, its parameters, BatchNorm statistics
and Adam moments, so that every file has the one-process layout, as a2m's
orbax writes global arrays; a restore cuts each rank's slices out of it.
A run resumes with or without a model axis whatever wrote the file.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

import numpy as np
import torch
from torch import nn

from a2m_torch.parallel import launch, mesh
from a2m_torch.train.train_step import place_adam
from a2m_torch.weights import load_generator_npz, to_jax_variables

_EPOCH_FILE = re.compile(r'^epoch_(\d+)\.pt$')


class CheckpointManager:
    """Per-epoch training checkpoints under ``directory`` (made at the
    first save), the newest ``max_to_keep`` kept (all when it is None or
    0), and the best generator
    as ``directory / 'best_gen.npz'``."""

    def __init__(self, directory, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep

    def path(self, epoch: int) -> Path:
        return self.directory / f'epoch_{epoch}.pt'

    def epochs(self) -> list[int]:
        """Saved epochs, oldest first."""
        if not self.directory.is_dir():
            return []
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _EPOCH_FILE.match(name)))

    def latest_epoch(self) -> int | None:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, g_state, d_state, controller_state: dict,
             mean, std, extra: dict | None = None) -> Path:
        """Write ``epoch``'s checkpoint (``g_state``/``d_state``: the train
        steps' :class:`~a2m_torch.train.train_step.NetState`), then delete
        all but the newest ``max_to_keep``.  The file appears whole: it is
        written beside its name and renamed.  In a process group rank 0
        writes and every rank returns after it has."""
        path = self.path(epoch)
        # every rank takes part in gathering the slices of a sharded model
        states = {}
        for prefix, state in (('g', g_state), ('d', d_state)):
            states[f'{prefix}_model'] = mesh.gather_state(state.model)
            states[f'{prefix}_optimizer'] = mesh.gather_optimizer_state(
                state.optimizer, state.model)
        if mesh.process_identity()[0] == 0:
            self._write(path, epoch, states, controller_state, mean, std,
                        extra)
        launch.host_barrier(f'a2m_ckpt_epoch_{epoch}')
        return path

    def _write(self, path: Path, epoch: int, states: dict,
               controller_state: dict, mean, std, extra) -> None:
        payload = dict(
            epoch=int(epoch), **states,
            controller=controller_state,
            mean=torch.as_tensor(mean).detach().cpu(),
            std=torch.as_tensor(std).detach().cpu(),
            extra=extra or {})
        self.directory.mkdir(parents=True, exist_ok=True)
        partial = path.with_suffix('.pt.partial')
        torch.save(payload, partial)
        os.replace(partial, path)
        if self.max_to_keep:
            for old in self.epochs()[:-self.max_to_keep]:
                self.path(old).unlink()

    def restore(self, g_state=None, d_state=None,
                epoch: int | None = None) -> dict | None:
        """Load ``epoch``'s checkpoint (default: the latest; None when
        there is none) onto ``g_state``'s device (the CPU without it).
        With ``g_state``/``d_state`` the models and optimisers are loaded in
        place.  Returns the payload: ``epoch``, ``controller``, ``mean``,
        ``std``, ``extra`` and the four ``state_dict``s."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            return None
        device = ('cpu' if g_state is None
                  else next(g_state.model.parameters()).device)
        payload = torch.load(self.path(epoch), map_location=device,
                             weights_only=True)
        for state, prefix in ((g_state, 'g'), (d_state, 'd')):
            if state is not None:
                mesh.load_full_state(state.model, payload[f'{prefix}_model'])
                mesh.load_full_optimizer_state(
                    state.optimizer, state.model,
                    payload[f'{prefix}_optimizer'])
                # the file's Adam settings are its writer's device's
                place_adam(state.optimizer)
        return payload

    def save_best_generator(self, model: nn.Module, mean=None,
                            std=None) -> Path:
        """The best generator in a2m's packed format, with the pose
        statistics it was trained with (gathered from every rank; rank 0
        writes; every rank returns after it has)."""
        path = self.directory / 'best_gen.npz'
        state = mesh.gather_state(model)
        if mesh.process_identity()[0] == 0:
            save_best_generator_npz(model, path, mean, std, state=state)
        launch.host_barrier('a2m_ckpt_best_gen')
        return path


def save_best_generator_npz(model: nn.Module, out_path, mean=None,
                            std=None, state: dict | None = None) -> Path:
    """Pack a generator (and the pose ``mean``/``std`` it was trained with)
    into one ``.npz`` in a2m's layout (``save_best_generator_npz``,
    ``a2m/train/checkpoint.py:164-189``); ``state``, a whole
    ``state_dict`` of it, replaces its own (a sharded model's, gathered)."""
    flat = to_jax_variables(model, state)
    packed = {k: (v.astype(np.float16)
                  if k.startswith('params/') and v.dtype == np.float32
                  and np.abs(v).max(initial=0.0) < 6e4 else v)
              for k, v in flat.items()}
    if mean is not None and std is not None:
        packed['stats/mean'] = _f32(mean)
        packed['stats/std'] = _f32(std)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, 'wb') as f:
        np.savez(f, **packed)
    return out_path


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def load_best_generator_npz(path) -> dict:
    """A packed best-generator file -> ``dict(variables=<flat f32 a2m
    variables>[, mean, std])``; ``variables`` go through
    :func:`a2m_torch.weights.from_jax_variables` into a model."""
    flat, stats = load_generator_npz(path)
    out = dict(variables=flat)
    if 'mean' in stats:
        out['mean'], out['std'] = stats['mean'], stats['std']
    return out


def load_any_generator_ckpt(path) -> dict | None:
    """Best-G weights from a packed ``.npz`` file or from a directory that
    holds ``best_gen.npz``; None when neither exists.  An Orbax ``best_gen``
    directory (a2m's native checkpoint) raises: pack it first with a2m's
    ``a2m.train.checkpoint.pack_best_generator_npz``."""
    p = Path(path)
    if p.suffix == '.npz':
        return load_best_generator_npz(p) if p.exists() else None
    if (p / 'best_gen.npz').is_file():
        return load_best_generator_npz(p / 'best_gen.npz')
    for orbax_dir in (p / 'best_gen', p):
        if orbax_dir.name == 'best_gen' and orbax_dir.is_dir():
            raise ValueError(
                f'{orbax_dir} is an Orbax checkpoint, which the port cannot '
                f'read; pack it into an .npz with a2m\'s '
                f'a2m.train.checkpoint.pack_best_generator_npz and pass that')
    return None


def save_loss_history(path, loss_dict: dict) -> None:
    """The loss history as a2m writes it: a 0-d numpy string array of its
    JSON (``checkpoint.py:240-243``)."""
    np.save(str(path), np.asarray(json.dumps(loss_dict)))


def load_loss_history(path) -> dict:
    return json.loads(str(np.load(str(path), allow_pickle=False)))
