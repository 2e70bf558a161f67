"""Training entry point (``a2m/train/__main__.py``).

Usage, from the repository root::

    python -m a2m_torch.train [device=cuda|cpu] [key.path=value ...]

e.g. ``python -m a2m_torch.train data.path2data=./pats/data
data.speakers=oliver train.n_epochs=60 train.best_metric=val_pck``.
Overrides are a2m's (:func:`a2m_torch.config.apply_overrides`); ``device``
(default ``cuda``) is where the models train, and also where the data
loader's Audio modality runs unless ``audio.device`` is given.  The run
keeps its checkpoints, best generator and loss history under
``train.save_dir`` and resumes from it (``train.resume``).

Multi-process data-parallel training, one process per card: set
``A2M_COORDINATOR`` / ``A2M_NUM_PROCESSES`` / ``A2M_PROCESS_ID`` (or
``dist.*``) for each process, or launch with ``torchrun ... -m
a2m_torch.train dist.auto=true``; ``data.batch_size`` is per process
(:mod:`a2m_torch.parallel.launch`).  Add ``mesh.model=2 mesh.data=-1`` for
tensor parallelism over pairs of consecutive ranks (a2m's ``TP_RULES``).  :func:`bootstrap` brings the group up
first; the loader then reads this rank's slice (``data.process_count=-1``
unless the config pins one), and the ranks meet at a barrier before the
group is destroyed at exit.

Reading PATS h5 files needs ``h5py`` and ``pandas``; a caller that has its
batches in memory calls :func:`bootstrap`, then :func:`run` with a loader
of its own (``data.synthetic.synthetic_loader(process_count=-1)`` slices
an in-memory fixture as the loader would), then
:func:`a2m_torch.parallel.launch.shutdown`.
"""

from __future__ import annotations

import dataclasses
import sys

from a2m_torch.config import Config, apply_overrides, validate


def bootstrap(cfg: Config, device='cuda', log=print) -> tuple[Config, str]:
    """Bring up the process group that ``cfg.dist`` or the environment
    asks for (:func:`~a2m_torch.parallel.launch.maybe_initialize`; nothing
    in one process) and its grid of ``cfg.mesh`` (validated;
    :func:`~a2m_torch.parallel.mesh.make_mesh`), before any loader reads
    its slice.  In a group, returns ``cfg`` with ``data.process_count=-1``
    when the config pins no slice, and this rank's device (``cuda:<i>``)
    in place of ``cuda``, and logs the ``[dist]`` line with the backend,
    the rank's device and, with a model axis, its place in the grid."""
    from a2m_torch.parallel import launch, mesh
    if not launch.maybe_initialize(cfg.dist, device):
        return cfg, device
    import torch.distributed as dist
    grid = mesh.make_mesh(validate(cfg).mesh)
    if cfg.data.process_count is None and cfg.data.process_index is None:
        # -1: this rank and the world size
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, process_count=-1))
    rank_dev = launch.rank_device()
    if rank_dev.type == 'cuda':
        device = str(rank_dev)
    place = '' if grid.model == 1 else f'; {grid}'
    log(f'[dist] process {dist.get_rank()}/{dist.get_world_size()} up: '
        f'{launch.describe()}; trains on {device}{place}')
    return cfg, device


def run(cfg: Config, loader, device='cuda', seed: int = 0, log=print):
    """Build the trainer of ``cfg`` over ``loader`` (an object with
    ``.train`` and ``.dev`` iterables of dict batches) on ``device`` and
    fit ``cfg.train.n_epochs`` epochs.  Returns the trainer."""
    from a2m_torch.train.loop import Trainer
    trainer = Trainer.from_config(cfg, loader, device=device, seed=seed,
                                  log=log)
    trainer.fit()
    return trainer


def parse(argv) -> tuple[Config, str]:
    """``key.path=value`` arguments -> (Config, device).  The config is
    validated by :func:`main` once the process group is up."""
    device, overrides = 'cuda', []
    for item in argv:
        key, sep, value = item.partition('=')
        if not sep:
            raise ValueError(f'argument {item!r} is not key.path=value')
        if key.strip() == 'device':
            device = value.strip()
        else:
            overrides.append(item)
    cfg = Config()
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio,
                                                             device=device))
    return apply_overrides(cfg, overrides), device


def main(argv=None) -> None:
    from a2m_torch.data.dataset import loader_from_config
    from a2m_torch.parallel import launch
    cfg, device = parse(sys.argv[1:] if argv is None else argv)
    cfg, device = bootstrap(cfg, device)
    cfg = validate(cfg)
    run(cfg, loader_from_config(cfg.data, cfg.audio), device=device)
    launch.shutdown()


if __name__ == '__main__':
    main()
