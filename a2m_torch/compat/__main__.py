"""One-command checkpoint migration from the PyTorch reference.

    python -m a2m_torch.compat --gen ./save/Best_Gen --out ./save/migrated \\
        [--disc ./save/Best_Dis] [generator.out_channels=256 ...]

Converts reference ``state_dict`` files (``version5_model_train.py:509-515``)
into the port's files: the generator lands as ``<out>/best_gen.npz`` (a2m's
packed best-G layout, flat ``params/...`` and ``batch_stats/...`` keys, all
f32), which ``python -m a2m_torch.eval.harness --ckpt <out>``,
``a2m_torch.viz.generate_video.run`` and ``train.init_from=<out>`` read; an
optional discriminator as ``<out>/imported_disc.npz`` (the same flat a2m
keys, f32), which ``train.init_from=<out>`` loads into D.  Any trailing
``key.path=value`` arguments override the model configs (they must match
the checkpoint's architecture sizes; mismatches fail loudly with the
offending parameter path).

a2m's ``python -m a2m.compat`` writes Orbax directories (``best_gen/``,
``imported_disc/``) instead; the port reads no Orbax, so it writes
``.npz`` files.  The generator's params stay f32, as a2m's migration keeps
them (the trainer's ``best_gen.npz`` packs params to f16).  The conversion
runs on the host; no kernel runs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from a2m_torch.compat.torch_import import (import_discriminator,
                                           load_torch_state_dict)
from a2m_torch.config import Config, apply_overrides


def _print_report(name: str, report) -> None:
    print(f'{name}: imported with {len(report.skipped)} structural skip(s), '
          f'{len(report.missing)} leaf/leaves left at init, '
          f'{len(report.unused)} unused checkpoint key(s)')
    for keys, reason in report.skipped:
        head = keys[0] if keys else '?'
        print(f'  skipped {head} (+{max(len(keys) - 1, 0)} more): {reason}')
    for path, reason in report.missing:
        print(f'  at init: {path} ({reason})')
    for key in report.unused:
        print(f'  UNUSED checkpoint key: {key}')


def save_variables_npz(model, path) -> Path:
    """A model's variables as flat f32 a2m-scope keys in one ``.npz``."""
    from a2m_torch.weights import to_jax_variables
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'wb') as f:
        np.savez(f, **to_jax_variables(model))
    return path


def run(gen_path: str, out_dir: str, disc_path: str | None = None,
        overrides: list | None = None, strict: bool = True) -> dict:
    import torch

    from a2m_torch.compat import load_torch_generator
    from a2m_torch.models.discriminator import Discriminator

    cfg = apply_overrides(Config(), overrides or [])
    out = Path(out_dir)

    model, g_report = load_torch_generator(gen_path, config=cfg.generator,
                                           strict=strict)
    _print_report('generator', g_report)
    print(f'wrote {save_variables_npz(model, out / "best_gen.npz")}')

    d_report = None
    if disc_path is not None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            d_model = Discriminator(cfg.discriminator)
        state, d_report = import_discriminator(
            load_torch_state_dict(disc_path), d_model)
        if strict:
            d_report.raise_if_unexpected()
        _print_report('discriminator', d_report)
        d_model.load_state_dict(state)
        print(f'wrote {save_variables_npz(d_model, out / "imported_disc.npz")}')
    return dict(g_report=g_report, d_report=d_report)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--gen', required=True,
                    help='reference generator state_dict file (e.g. Best_Gen)')
    ap.add_argument('--disc', default=None,
                    help='optional reference discriminator state_dict file')
    ap.add_argument('--out', required=True, help='output checkpoint directory')
    ap.add_argument('--no-strict', action='store_true',
                    help='tolerate unconsumed checkpoint keys')
    ap.add_argument('overrides', nargs='*',
                    help='config overrides, e.g. generator.out_channels=256')
    args = ap.parse_args(argv)
    run(args.gen, args.out, args.disc, args.overrides,
        strict=not args.no_strict)


if __name__ == '__main__':
    main()
