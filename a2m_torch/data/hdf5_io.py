"""HDF5 storage layer for per-interval PATS files.

The port's own copy of ``a2m/data/hdf5_io.py``; ``h5py`` is imported by
the functions that open files, never when the module is imported, so the
rest of the data path imports where h5py is not installed.  Capability
parity with the reference's static helper class and registries
(`pats/data_loading/common.py:21-107,221-275`) and the inspection/scan tools
(`pats/data/h5_loader.py:13-104`), reimplemented as plain functions.

On-disk schema per interval (documented in reference h5_loader.py:119-195):
``processed/<speaker>/<interval_id>.h5`` containing
``audio/{log_mel_512,log_mel_400,silence}``, ``pose/{data,normalize}``
(T, 104 float64, block layout), ``text/{w2v,bert,tokens,meta}``.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Iterable

import numpy as np


def h5_open(filename, mode: str) -> h5py.File:
    """Open (creating parent dirs for write modes)."""
    import h5py
    os.makedirs(Path(filename).parent, exist_ok=True)
    return h5py.File(filename, mode)


def add_dataset(h5: h5py.File, key: str, data, exist_ok: bool = False) -> None:
    if key in h5:
        if exist_ok:
            del h5[key]
            h5.create_dataset(key, data=data)
        else:
            warnings.warn(f'dataset {key} already exists. Skipping...')
    else:
        h5.create_dataset(key, data=data)


def update_dataset(h5: h5py.File, key: str, data) -> None:
    add_dataset(h5, key, data, exist_ok=True)


def load(filename, key: str):
    """Returns (dataset, open file handle); caller closes the handle."""
    h5 = h5_open(filename, 'r')
    return h5[key], h5


def load_array(filename, key: str, dtype=np.float32) -> np.ndarray:
    """Load a dataset fully into memory as ``dtype`` (the pipeline casts
    float64 storage to float32 once at load, reference dataUtils.py:538)."""
    with h5_open(filename, 'r') as h5:
        return h5[key][()].astype(dtype)


def dataset_shape(filename, key: str) -> tuple:
    """Dataset shape from h5 metadata only — no data read (used for
    window-count estimation in multi-host interval balancing)."""
    with h5_open(filename, 'r') as h5:
        return tuple(h5[key].shape)


def is_dataset_in_file(filename, key: str) -> bool:
    with h5_open(filename, 'r') as h5:
        return key in h5


def load_norm_stats(filename, modality: str
                    ) -> tuple[np.ndarray, np.ndarray] | None:
    """Cached per-interval normalization stats for a pose modality
    (reference MiniData._load_normalization_stats, dataUtils.py:563-582):
    ``<modality with data->norm_stats>/{mean,std}`` as float32, or ``None``
    when the interval has no cached stats.  A present-but-malformed group
    raises (the reference swallows every error silently)."""
    import h5py
    key = modality.replace('data', 'norm_stats')
    if key == modality:            # e.g. 'pose/normalize' has no stats key
        return None
    with h5_open(filename, 'r') as h5:
        if key not in h5:
            return None
        grp = h5[key]
        if not isinstance(grp, h5py.Group) or not {'mean', 'std'} <= set(grp):
            raise ValueError(
                f'{filename}: {key} exists but is not a group with '
                f'mean/std datasets')
        return (grp['mean'][()].astype(np.float32),
                grp['std'][()].astype(np.float32))


def append(filename, key: str, data) -> None:
    """Create file if needed; create-or-replace ``key``."""
    with h5_open(filename, 'a') as h5:
        update_dataset(h5, key, data)


def del_dataset(h5: h5py.File, key: str) -> bool:
    if key in h5:
        del h5[key]
        return True
    warnings.warn('Key not found. Skipping...')
    return False


def add_key(base_key: str, sub_keys: Iterable[str] | str = ()) -> str:
    if isinstance(sub_keys, str):
        sub_keys = [sub_keys]
    return (Path(base_key) / Path('/'.join(sub_keys))).as_posix()


def tree(file_path) -> list[str]:
    """Pretty-printable tree walk of an .h5 file (reference
    h5_loader.py:13-41 capability); returns lines instead of printing."""
    import h5py
    lines: list[str] = []
    with h5py.File(file_path, 'r') as f:
        stack = [(f, '  ')]
        while stack:
            current, indent = stack.pop()
            lines.append(f'{indent}- {type(current).__name__}: {current.name}')
            if isinstance(current, h5py.Group):
                for key in reversed(list(current.keys())):
                    stack.append((current[key], indent + '  '))
            elif isinstance(current, h5py.Dataset):
                lines.append(f'{indent}  Shape: {current.shape}')
                lines.append(f'{indent}  Dtype: {current.dtype}')
    return lines


def interval_path(path2data, speaker: str, interval_id: str) -> str:
    """processed/<speaker>/<interval_id>.h5 (reference dataUtils.py:338-339)."""
    return (Path(path2data) / 'processed' / speaker / str(interval_id)
            ).as_posix() + '.h5'


def scan_missing_keys(path2data, speaker: str, intervals: Iterable[str],
                      required_keys=('audio/log_mel_512', 'pose/data')
                      ) -> list[str]:
    """Per-speaker disk scan for intervals lacking required datasets
    (reference h5_loader.py:66-104 `check_log_mel`).  Unreadable files are
    reported as missing rather than crashing the loader."""
    import h5py
    missing = []
    for interval in intervals:
        fp = interval_path(path2data, speaker, interval)
        try:
            with h5py.File(fp, 'r') as h5:
                if any(k not in h5 for k in required_keys):
                    missing.append(interval)
        except OSError:
            missing.append(interval)
    return missing


class MissingData:
    """Persistent set of missing interval_ids in ``missing_intervals.h5``
    (reference common.py:221-275)."""

    KEY = 'intervals'

    def __init__(self, path2data):
        self.path2file = Path(path2data) / 'missing_intervals.h5'
        if not self.path2file.exists():
            h5_open(self.path2file, 'a').close()
        self.missing_data_list: list[str] = []

    def append_interval(self, interval_id: str) -> None:
        self.missing_data_list.append(interval_id)

    def save_intervals(self, missing: Iterable[str | None]) -> None:
        """Union new ids into the persisted set."""
        import h5py
        current = self.load_intervals()
        current.update(set(missing) - {None})
        dt = h5py.special_dtype(vlen=str)
        append(self.path2file, self.KEY,
               np.array(sorted(current), dtype=dt))

    def save(self, missing: Iterable[str | None]) -> None:
        """Overwrite the persisted set (reference common.py:255-260)."""
        import h5py
        dt = h5py.special_dtype(vlen=str)
        append(self.path2file, self.KEY,
               np.array(sorted(set(missing) - {None}), dtype=dt))

    def load_intervals(self) -> set[str]:
        if is_dataset_in_file(self.path2file, self.KEY):
            with h5_open(self.path2file, 'r') as h5:
                vals = h5[self.KEY][()]
            return {v.decode() if isinstance(v, bytes) else str(v)
                    for v in vals}
        return set()


def restore_all_intervals(path2data, speaker: str,
                          key: str = 'pose/data') -> int:
    """Batch layout repair across a speaker's interval files (reference
    h5_processor.py:127-143).  Returns the number of files rewritten."""
    import h5py
    base = Path(path2data) / 'processed' / speaker
    count = 0
    for fp in sorted(base.glob('*.h5')):
        with h5py.File(fp, 'r') as h5:
            needs = key in h5 and h5[key].ndim == 3
        if needs:
            restore_interval_shape(fp, key)
            count += 1
    return count


def restore_interval_shape(path2h5, key: str = 'pose/data') -> None:
    """Rewrite a (N, 2, 52) pose dataset to the canonical flat (N, 104)
    block layout [x0..x51, y0..y51].

    Capability of the reference's repair scripts
    (`pats/data/h5_processor.py:83-143`) with the layout bug fixed: the
    reference wrote an interleaved [x0,y0,x1,y1,...] layout inconsistent
    with every consumer (SURVEY.md §2.1); block layout is authoritative.
    """
    with h5_open(path2h5, 'a') as h5:
        data = h5[key][()]
        if data.ndim == 3 and data.shape[1:] == (2, 52):
            flat = data.reshape(data.shape[0], 104)
            del h5[key]
            h5.create_dataset(key, data=flat)
