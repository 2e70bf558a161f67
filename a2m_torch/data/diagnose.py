"""Dataset diagnosis: iterate the real pipeline and locate malformed intervals.

The port's own copy of ``a2m/data/diagnose.py``.  Capability parity with
``dataset_exception_error_diagnosis.py:44-80`` — the reference's closest
thing to an integration test: walk the train loader with a small batch
size, print shapes, and trap errors to the offending interval.

Usage:
    python -m a2m_torch.data.diagnose --path2data ./pats/data \\
        --speaker oliver [--device cpu]

Reading PATS h5 files needs ``h5py`` and ``pandas``; ``loader`` (an object
with ``.train``, as :func:`a2m_torch.data.synthetic.synthetic_loader`
builds in memory) takes their place.
"""

from __future__ import annotations

import argparse
import traceback


def diagnose(path2data, speakers, modalities=('pose/data',
                                              'audio/log_mel_512'),
             batch_size: int = 4, max_batches: int | None = None,
             log=print, device='cuda', loader=None) -> list[dict]:
    """Returns a list of {batch, error, meta} for failing batches.
    ``device`` is where the loader's Audio modality extracts features;
    ``loader`` replaces the ``DataLoader`` over ``path2data``."""
    if loader is None:
        from a2m_torch.data.dataset import DataLoader
        loader = DataLoader(path2data=path2data, speaker=list(speakers),
                            modalities=list(modalities),
                            fs_new=[15] * len(modalities),
                            batch_size=batch_size, window_hop=5,
                            shuffle=False, device=device)
    failures = []
    for i, batch in enumerate(loader.train):
        if max_batches is not None and i >= max_batches:
            break
        try:
            shapes = {k: v.shape for k, v in batch.items()
                      if hasattr(v, 'shape')}
            if i % 50 == 0:
                log(f'batch {i}: ' + ', '.join(
                    f'{k}={s}' for k, s in shapes.items()))
            for k in modalities:
                assert batch[k].ndim == 3, f'{k} has ndim {batch[k].ndim}'
        except Exception as e:  # noqa: BLE001 — diagnosis tool traps anything
            failures.append(dict(batch=i, error=repr(e),
                                 meta=batch.get('meta')))
            log(f'batch {i} FAILED: {e!r} meta={batch.get("meta")}')
            log(traceback.format_exc())
    log(f'diagnosis complete: {len(failures)} failing batches')
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--path2data', default='./pats/data')
    ap.add_argument('--speaker', nargs='+', default=['oliver'])
    ap.add_argument('--batch_size', type=int, default=4)
    ap.add_argument('--max_batches', type=int, default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    diagnose(args.path2data, args.speaker, batch_size=args.batch_size,
             max_batches=args.max_batches, device=args.device)


if __name__ == '__main__':
    main()
