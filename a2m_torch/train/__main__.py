"""Training entry point (``a2m/train/__main__.py``).

Usage, from the repository root::

    python -m a2m_torch.train [device=cuda|cpu] [key.path=value ...]

e.g. ``python -m a2m_torch.train data.path2data=./pats/data
data.speakers=oliver train.n_epochs=60 train.best_metric=val_pck``.
Overrides are a2m's (:func:`a2m_torch.config.apply_overrides`); ``device``
(default ``cuda``) is where the models train, and also where the data
loader's Audio modality runs unless ``audio.device`` is given.  The run
keeps its checkpoints, best generator and loss history under
``train.save_dir`` and resumes from it (``train.resume``).  Multi-process
training (a2m's ``dist.*`` bootstrap) is ROADMAP A13: ``validate`` refuses
it.  Reading PATS h5 files needs ``h5py`` and ``pandas``; a caller that
has its batches in memory calls :func:`run` with a loader of its own.
"""

from __future__ import annotations

import dataclasses
import sys

from a2m_torch.config import Config, apply_overrides, validate


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
    """``key.path=value`` arguments -> (validated Config, device)."""
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
    return validate(apply_overrides(cfg, overrides)), device


def main(argv=None) -> None:
    from a2m_torch.data.dataset import loader_from_config
    cfg, device = parse(sys.argv[1:] if argv is None else argv)
    run(cfg, loader_from_config(cfg.data, cfg.audio), device=device)


if __name__ == '__main__':
    main()
