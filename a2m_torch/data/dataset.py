"""PATS dataset pipeline: intervals -> sliding windows -> fixed-shape batches.

The port's own copy of ``a2m/data/dataset.py``; ``h5py`` and ``pandas``
are imported by the functions that open files or read the master CSV.
Capability parity with `pats/data_loading/dataUtils.py` (Data_Loader,
MiniData, ConcatDatasetIndex, AlternateClassSampler, BalanceClassSampler and
the torch sampler strategies), redesigned as a host pipeline:

* batches are plain dicts of stacked float32 numpy arrays with **static
  shapes** — the final ragged batch is zero-padded to ``batch_size`` and
  carries a ``mask`` (the reference instead feeds ragged batches, whose
  shapes change at the end of every epoch);
* no torch DataLoader / worker processes — windows are views into
  memory-resident interval arrays, so "loading" a batch is a stack of
  slices;
* sampling strategies are numpy index generators seeded explicitly.
"""

from __future__ import annotations

import bisect
import dataclasses
from pathlib import Path
from typing import Sequence

import numpy as np

from a2m_torch.data import hdf5_io, modalities as mods
from a2m_torch.device import resolve_device
from a2m_torch.data.windowing import (WindowIndex, exact_window_index,
                                      window_index)

# minimal english stopword list for the filler channel (reference uses
# nltk.corpus.stopwords, dataUtils.py:88; capability-equivalent subset)
STOPWORDS = frozenset(
    'a an and are as at be by for from has he her his i in is it its of on '
    'or she so that the their them they this to was we were will with you '
    'your um uh oh like just'.split())


def read_text_meta(path2h5):
    """Per-interval word-alignment table (reference dataUtils.py:545-548:
    ``pd.read_hdf(path2h5, 'text/meta')``).

    Tries the reference's pandas-HDF (pytables) format first; this image has
    no pytables, so a plain-h5 layout ``text/meta/{start_frame, end_frame,
    Word}`` (parallel datasets, frames at pose fps) is equally supported —
    :func:`a2m_torch.data.synthetic.synth_interval` writes it.  Returns ``None``
    only when the interval has no ``text/meta`` at all; a present-but-
    unreadable group raises (the reference's blanket ``except`` would
    silently degrade to the tokens-only alignment path).
    """
    import pandas as pd
    try:
        return pd.read_hdf(path2h5, key='text/meta')
    except ImportError:
        pass                                   # no pytables in this image
    except (KeyError, ValueError, OSError, TypeError):
        pass                                   # not pandas-format; fall back
    import h5py
    with hdf5_io.h5_open(path2h5, 'r') as h5:
        if 'text/meta' not in h5:
            return None
        grp = h5['text/meta']
        required = ('start_frame', 'end_frame', 'Word')
        if isinstance(grp, h5py.Group) and all(k in grp for k in required):
            words = [w.decode() if isinstance(w, bytes) else str(w)
                     for w in grp['Word'][()]]
            return pd.DataFrame({
                'start_frame': grp['start_frame'][()].astype(np.int64),
                'end_frame': grp['end_frame'][()].astype(np.int64),
                'Word': words})
        raise ValueError(
            f'{path2h5}: text/meta exists but is neither readable '
            f'pandas-HDF (pytables unavailable?) nor a group with '
            f'datasets {required}')


def write_text_meta(path2h5, df, force_plain: bool = False) -> str:
    """Write a word-alignment table (columns ``start_frame``, ``end_frame``,
    ``Word``) as ``text/meta`` — the write-path counterpart of
    :func:`read_text_meta` (the reference dataset ships these tables
    pre-built and only reads them, dataUtils.py:544-548).

    When pytables is importable this writes the reference's exact on-disk
    format (``pd.DataFrame.to_hdf(key='text/meta', format='table')``), so
    data produced here is readable by the reference's loader unchanged.
    Without pytables (this image) it writes the equivalent plain-h5 layout
    ``text/meta/{start_frame, end_frame, Word}`` that :func:`read_text_meta`
    also accepts.  Returns the format written ('pandas' or 'plain').
    """
    import pandas as pd
    df = pd.DataFrame(df)
    if not force_plain:
        try:
            import tables  # noqa: F401 -- availability probe
            df.to_hdf(str(path2h5), key='text/meta', mode='a',
                      format='table')
            return 'pandas'
        except ImportError:
            pass
    with hdf5_io.h5_open(path2h5, 'a') as h5:
        if 'text/meta' in h5:
            del h5['text/meta']
        h5.create_dataset('text/meta/start_frame',
                          data=np.asarray(df['start_frame'], np.int64))
        h5.create_dataset('text/meta/end_frame',
                          data=np.asarray(df['end_frame'], np.int64))
        h5.create_dataset(
            'text/meta/Word',
            data=np.array([str(w) for w in df['Word']], dtype='S16'))
    return 'plain'


#: lazy-interval mode: max open read-only h5 handles (close on eviction;
#: stays under typical 1024-fd ulimits with room for the rest of the
#: process)
LAZY_OPEN_FILES = 256


class _H5HandleCache:
    """LRU of open read-only h5py.File handles.

    Lazy mode reads ONLY each window's rows straight from disk (a ~30 KB
    strided read) instead of materializing whole intervals; the dominant
    per-access cost is then the h5 open, so handles are pooled.  Accesses
    are single-threaded by construction (the Trainer's one prefetch
    thread; stats run before it starts) — h5py handles are not shared
    across concurrent threads."""

    def __init__(self, maxsize: int = LAZY_OPEN_FILES):
        import collections
        self.maxsize = maxsize
        self._files: collections.OrderedDict = collections.OrderedDict()
        self.hits = self.misses = 0

    def get(self, path: str):
        f = self._files.pop(path, None)
        if f is None:
            self.misses += 1
            if len(self._files) >= self.maxsize:
                self._files.popitem(last=False)[1].close()
            f = hdf5_io.h5_open(path, 'r')
        else:
            self.hits += 1
        self._files[path] = f
        return f

    def clear(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
        self.hits = self.misses = 0


_LAZY_H5 = _H5HandleCache()


def _lazy_window_slice(path2h5, modality: str, w, idx: int) -> np.ndarray:
    """One window's rows for ``DataLoader(lazy_intervals=True)`` — reads
    just the window extent from the h5 dataset (strided read for the
    reference's stride-resampling WindowIndex; contiguous block + gather
    for ExactWindowIndex)."""
    ds = _LAZY_H5.get(str(path2h5))[modality]
    if isinstance(w, WindowIndex):
        s = int(w.starts[idx])
        # contiguous block + numpy stride: one h5 hyperslab instead of
        # window/stride scattered blocks (measured ~2x cheaper per read)
        out = ds[s:s + w.window][::w.stride]
    else:                                  # ExactWindowIndex: gather rows
        j = w.start_frames[idx] + np.arange(w.out_len)
        rows = np.minimum(np.rint(j * (w.fs / w.fs_new)).astype(np.int64),
                          w.n_rows - 1)
        block = ds[int(rows[0]):int(rows[-1]) + 1]
        out = block[rows - rows[0]]
    return np.asarray(out, np.float32)


def _array_norm_stats(arrays: dict, modality: str):
    """:func:`hdf5_io.load_norm_stats` over an in-memory interval."""
    key = modality.replace('data', 'norm_stats')
    if key == modality or f'{key}/mean' not in arrays:
        return None
    return (np.asarray(arrays[f'{key}/mean'], np.float32),
            np.asarray(arrays[f'{key}/std'], np.float32))


class IntervalData:
    """One interval's .h5 -> float32 arrays + sliding windows
    (reference MiniData, dataUtils.py:510-729).

    The reference eagerly loads EVERY interval into RAM at startup
    (dataUtils.py:530-540) — tens of GB at real-PATS scale (84K intervals,
    dataUtils.py:111-113).  ``lazy_intervals=True`` reads only shape
    metadata here and reads each window's rows straight from the h5 file
    at access time (:func:`_lazy_window_slice`, pooled open handles)
    instead.

    ``arrays`` (``{h5 dataset name: array}``, as
    :func:`a2m_torch.data.synthetic.synth_interval_arrays` gives them)
    takes the place of the file, which is then not opened: ``path2h5``
    only names the interval.  Text modalities and lazy loading need the
    file."""

    def __init__(self, path2h5, modalities: Sequence[str],
                 fs_new: Sequence[int], time: float,
                 modality_classes: dict, window_hop: int = 0, style: int = 0,
                 repeat_text: int = 1, text_in_modalities: bool = False,
                 filler: int = 0, exact_windows: bool = False,
                 lazy_intervals: bool = False, arrays: dict | None = None,
                 **kwargs):
        if arrays is not None and (lazy_intervals or text_in_modalities):
            raise ValueError('IntervalData(arrays=...) holds no text '
                             'table and reads no file lazily')
        self.exact_windows = exact_windows
        self.lazy = lazy_intervals
        self.path2h5 = path2h5
        self.modalities = list(modalities)
        self.fs_new = list(fs_new)
        self.time = time
        self.modality_classes = modality_classes
        self.window_hop = window_hop
        self.style = style
        self.repeat_text = repeat_text
        self.text_in_modalities = text_in_modalities
        self.filler = filler

        self.data: list[np.ndarray] = []
        self.shapes: list[tuple] = []
        for modality in self.modalities:
            if self.lazy:
                self.shapes.append(
                    hdf5_io.dataset_shape(self.path2h5, modality))
            else:
                arr = (hdf5_io.load_array(self.path2h5, modality, np.float32)
                       if arrays is None
                       else np.asarray(arrays[modality]).astype(np.float32))
                self.data.append(arr)
                self.shapes.append(arr.shape)

        # cached per-interval normalization stats for pose modalities
        # (reference dataUtils.py:563-582, applied per window at :656-663)
        self.norm_stats: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for modality in self.modalities:
            if 'pose' in modality:
                stats = (hdf5_io.load_norm_stats(self.path2h5, modality)
                         if arrays is None
                         else _array_norm_stats(arrays, modality))
                if stats is not None:
                    self.norm_stats[modality] = stats

        self.text_df = None
        if self.text_in_modalities:
            self.text_df = read_text_meta(self.path2h5)

        self.windows: dict[str, WindowIndex] = {}
        self.update_idx_list(self.time, self.window_hop)

    def update_idx_list(self, time: float, window_hop: int = 0) -> None:
        index_fn = exact_window_index if self.exact_windows else window_index
        for modality, fs_new, shape in zip(self.modalities, self.fs_new,
                                           self.shapes):
            fs = self.modality_classes[modality].fs(modality)
            self.windows[modality] = index_fn(
                shape[0], fs, fs_new, time, window_hop)

    def __len__(self) -> int:
        return min(len(self.windows[m]) for m in self.modalities)

    def __getitem__(self, idx: int) -> dict:
        item: dict = {}
        start_time = 0.0
        for i, modality in enumerate(self.modalities):
            w = self.windows[modality]
            sliced = (_lazy_window_slice(self.path2h5, modality, w, idx)
                      if self.lazy else w.slice(self.data[i], idx))
            if modality in self.norm_stats:
                # cached-stat normalization, std clamped like the reference
                # (dataUtils.py:656-663)
                mean, std = self.norm_stats[modality]
                sliced = (sliced - mean) / np.where(std < 1e-7, 1.0, std)
            item[modality] = sliced
            start_time = int(w.starts[idx]) // w.stride / self.fs_new[-1]
            if 'text' in modality:
                self._attach_text_fields(item, modality, w, idx)
        duration = item[self.modalities[0]].shape[0] / self.fs_new[-1]
        item['meta'] = {'interval_id': Path(self.path2h5).stem,
                        'start': start_time,
                        'end': start_time + duration,
                        'idx': idx}
        item['style'] = np.full(item[self.modalities[0]].shape[0],
                                self.style, dtype=np.float32)
        return item

    def _attach_text_fields(self, item: dict, modality: str, w: WindowIndex,
                            idx: int) -> None:
        """Word-boundary indices, filler mask, per-word durations
        (reference dataUtils.py:660-712)."""
        vec = item[modality]
        start = int(w.starts[idx])
        end = start + w.window
        if self.text_df is None or modality == 'text/tokens':
            indices = [0]
            for t in range(1, vec.shape[0]):
                if (vec[t] - vec[indices[-1]]).sum() != 0:
                    indices.append(t)
            words = None
        else:
            tdf = self.text_df[(start <= self.text_df['end_frame'])
                               & (end > self.text_df['start_frame'])]
            starts_ = tdf['start_frame'].values - start
            if len(starts_):
                starts_[0] = 0
            indices = list(starts_.astype(np.int32))
            words = [str(word).lower() for word in tdf['Word'].values] \
                if 'Word' in tdf else None
        if not indices:
            indices = [0]
        if not self.repeat_text:
            item[modality] = vec[indices]
        if self.filler:
            filler = np.zeros((len(indices),), dtype=np.float32)
            if words is not None:
                for j, word in enumerate(words[:len(indices)]):
                    if word in STOPWORDS:
                        filler[j] = 1.0
            if self.repeat_text:
                full = np.zeros((vec.shape[0],), dtype=np.float32)
                bounds = indices[1:] + [vec.shape[0]]
                for j, (st, en) in enumerate(zip(indices, bounds)):
                    full[st:en] = filler[j]
                filler = full
            item['text/filler'] = filler
        ind = np.asarray(indices, dtype=np.int32)
        length_word = np.zeros_like(ind)
        if len(ind) > 1:
            length_word[:-1] = ind[1:] - ind[:-1]
        duration = w.window // w.stride
        length_word[-1] = duration - ind[-1]
        item['text/token_duration'] = length_word


class ConcatIntervals:
    """Concatenation of IntervalData with a global window index injected into
    each item (reference ConcatDatasetIndex, dataUtils.py:741-758)."""

    def __init__(self, datasets: Sequence[IntervalData]):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]
                                          ).tolist() if self.datasets else []

    def __len__(self) -> int:
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx: int) -> dict:
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if ds_idx == 0 else idx - self.cumulative_sizes[ds_idx - 1]
        item = self.datasets[ds_idx][sample_idx]
        item['idx'] = idx
        return item


# ---------------------------------------------------------------------------
# Samplers (numpy index generators; reference dataUtils.py:391-418, 761-804)
# ---------------------------------------------------------------------------


class RandomSampler:
    def __init__(self, n: int, num_samples: int | None = None,
                 replacement: bool = False, seed: int = 0):
        self.n, self.num_samples = n, num_samples or n
        self.replacement = replacement
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        if self.replacement:
            return iter(self.rng.integers(0, self.n, self.num_samples))
        perm = self.rng.permutation(self.n)
        return iter(perm[:self.num_samples])

    def __len__(self):
        return self.num_samples


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class SubsetRandomSampler:
    def __init__(self, indices: np.ndarray, seed: int = 0):
        self.indices = np.asarray(indices)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return iter(self.indices[self.rng.permutation(len(self.indices))])

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler:
    def __init__(self, weights: Sequence[float], num_samples: int,
                 seed: int = 0):
        w = np.asarray(weights, dtype=np.float64)
        self.p = w / w.sum()
        self.num_samples = num_samples
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return iter(self.rng.choice(len(self.p), self.num_samples, p=self.p))

    def __len__(self):
        return self.num_samples


class AlternateClassSampler:
    """Round-robin over contiguous per-speaker index blocks (reference
    dataUtils.py:761-781): each draw interleaves one random window from every
    speaker block."""

    def __init__(self, class_count: Sequence[int], num_samples: int,
                 seed: int = 0):
        self.num_samples_per_class = num_samples // len(class_count)
        self.num_samples = self.num_samples_per_class * len(class_count)
        starts = np.concatenate([[0], np.cumsum(class_count)[:-1]])
        self.starts, self.ends = starts, np.cumsum(class_count)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        cols = [self.rng.integers(s, e, self.num_samples_per_class)
                for s, e in zip(self.starts, self.ends)]
        return iter(np.stack(cols, axis=1).reshape(-1))

    def __len__(self):
        return self.num_samples


class BalanceClassSampler:
    """Equal draws from explicit per-class index lists (reference
    dataUtils.py:784-804)."""

    def __init__(self, classes: Sequence[np.ndarray], num_samples: int,
                 seed: int = 0):
        self.classes = [np.asarray(c) for c in classes if len(c) > 0]
        self.num_samples_per_class = num_samples // len(self.classes)
        self.num_samples = self.num_samples_per_class * len(self.classes)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        cols = [c[self.rng.integers(0, len(c), self.num_samples_per_class)]
                for c in self.classes]
        return iter(np.stack(cols, axis=1).reshape(-1))

    def __len__(self):
        return self.num_samples


# ---------------------------------------------------------------------------
# Batcher: fixed-shape batches
# ---------------------------------------------------------------------------


class Batcher:
    """Iterates a sampler over a ConcatIntervals, yielding dicts of stacked
    arrays padded to a static ``batch_size`` with a ``mask`` channel.

    Static shapes give every training step the same shapes (the
    reference's ragged final batches change them at the epoch's end).
    """

    def __init__(self, dataset: ConcatIntervals, batch_size: int,
                 sampler=None, drop_last: bool = False,
                 pad_to_batch: bool = True, max_batches: int | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or SequentialSampler(len(dataset))
        self.drop_last = drop_last
        self.pad_to_batch = pad_to_batch
        # multi-host step balancing: cap the epoch at the global-min batch
        # count so every host executes the same number of collective-bearing
        # steps (DataLoader.tdt_split computes the cap)
        self.max_batches = max_batches

    def __len__(self) -> int:
        n = len(self.sampler)
        n = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return n if self.max_batches is None else min(n, self.max_batches)

    def __iter__(self):
        emitted = 0
        batch_idx: list[int] = []
        for idx in self.sampler:
            if self.max_batches is not None and emitted >= self.max_batches:
                return
            batch_idx.append(int(idx))
            if len(batch_idx) == self.batch_size:
                yield self._collate(batch_idx)
                emitted += 1
                batch_idx = []
        if batch_idx and not self.drop_last and (
                self.max_batches is None or emitted < self.max_batches):
            yield self._collate(batch_idx)

    def _collate(self, indices: list[int]) -> dict:
        items = [self.dataset[i] for i in indices]
        n = len(items)
        pad = self.batch_size - n if self.pad_to_batch else 0
        # wrap-pad: the ragged final batch is filled by repeating its own
        # samples (not zeros) so BatchNorm statistics inside masked train
        # steps see only realistic rows; the mask zero-weights the repeats
        # in every loss (reference trains ragged batches natively,
        # version5_model_train.py:300)
        wrap = np.arange(pad) % n if pad else None
        out: dict = {}
        for key in items[0]:
            if key == 'meta':
                out['meta'] = {
                    k: [it['meta'][k] for it in items]
                    for k in items[0]['meta']}
            elif key == 'idx':
                arr = np.asarray([it['idx'] for it in items], dtype=np.int64)
                out['idx'] = (np.concatenate([arr, arr[wrap]]) if pad
                              else arr)
            else:
                vals = [np.asarray(it[key]) for it in items]
                if len({v.shape for v in vals}) > 1:
                    stacked, lengths = mods.pad_ragged(vals, dim=0)
                    out[key + '_len'] = (np.concatenate(
                        [lengths, lengths[wrap]]) if pad else lengths)
                else:
                    stacked = np.stack(vals)
                if pad:
                    stacked = np.concatenate([stacked, stacked[wrap]])
                out[key] = stacked
        mask = np.zeros(self.batch_size if self.pad_to_batch else n,
                        dtype=np.float32)
        mask[:n] = 1.0
        out['mask'] = mask
        return out


# ---------------------------------------------------------------------------
# DataLoader (reference Data_Loader, dataUtils.py:38-418)
# ---------------------------------------------------------------------------


class DataLoader(mods.Modality):
    """Train/dev/test windowed PATS pipeline.

    Mirrors the reference constructor surface; ``.train/.dev/.test`` are
    :class:`Batcher` iterables of fixed-shape numpy batches.  ``device``
    (a2m's ``use_pallas``) is where the Audio modality extracts features:
    ``'cuda'`` by default, which raises where CUDA is absent, or ``'cpu'``.
    """

    def __init__(self, path2data, speaker,
                 modalities=('pose/data', 'audio/log_mel_512'),
                 fs_new=(15, 15), time=4.3, split=None, batch_size=100,
                 shuffle=True, num_workers=0, window_hop=0, load_data=True,
                 style_iters=0, num_training_sample=None, sample_all_styles=0,
                 repeat_text=1, quantile_sample=None,
                 quantile_num_training_sample=None, weighted=0, filler=False,
                 num_training_iters=None, seed=0, device='cuda',
                 max_intervals=None, process_index=None, process_count=None,
                 exact_windows=False, lazy_intervals=False):
        # where the Audio modality extracts features; a CUDA device raises
        # here, before any file is read, when CUDA is absent
        self.device = resolve_device(device)
        self.path2data = path2data
        if isinstance(speaker, str):
            speaker = [speaker]
        self.speaker = list(speaker)
        self.modalities = list(modalities)
        self.fs_new = list(fs_new)
        self.time = time
        self.split = split
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.window_hop = window_hop
        self.load_data = load_data
        self.style_iters = style_iters
        self.num_training_sample = num_training_sample
        self.sample_all_styles = sample_all_styles
        self.repeat_text = repeat_text
        self.quantile_sample = quantile_sample
        self.quantile_num_training_sample = quantile_num_training_sample
        self.weighted = weighted
        self.filler = filler
        self.num_training_iters = num_training_iters
        self.seed = seed
        self.max_intervals = max_intervals
        # a2m extension (off = reference parity): drift-free windowing —
        # see windowing.ExactWindowIndex
        self.exact_windows = exact_windows
        # a2m extension: bounded-RAM interval payloads (see IntervalData)
        self.lazy_intervals = lazy_intervals
        # multi-host data feeding (SURVEY §2.5 DP row): every split is
        # split across processes so each host loads and feeds a disjoint
        # interval shard; -1 = this process's torch.distributed rank and
        # world size (0 and 1 when it is not initialised)
        self.process_index = process_index
        self.process_count = process_count
        self.text_in_modalities = any('text' in m for m in self.modalities)
        self.missing = hdf5_io.MissingData(path2data)

        self.modality_classes = mods.load_modality_classes(
            self.modalities, path2data, self.speaker, device=self.device)

        self.df = mods.read_master_csv(path2data, with_transforms=True)
        if self.speaker[0] == 'all':
            self.speaker = list(mods.SPEAKERS)
        self.df = self.get_df_subset('speaker', self.speaker)
        assert len(self.df), f'speaker `{speaker}` not found'
        self.speaker_dict = {sp: i for i, sp in enumerate(self.speaker)}
        self._speaker_of = dict(zip(self.df['interval_id'],
                                    self.df['speaker']))

        self.datasets = self.tdt_split()
        self.update_dataloaders(time, window_hop)

    # Modality base expects these attributes; we bypass its __init__ to avoid
    # re-reading the master CSV three times (reference re-reads per modality
    # class, skeleton.py:23 / audio.py:33 — a startup hot spot).
    @property
    def speakers(self):
        return list(mods.SPEAKERS)

    def get_df_subset(self, column, value):
        if isinstance(value, (list, tuple)):
            return self.df[self.df[column].isin(list(value))]
        return self.df[self.df[column] == value]

    # -- split ----------------------------------------------------------------

    def tdt_split(self):
        if not self.split:
            df_train = self.get_df_subset('dataset', 'train')
            df_dev = self.get_df_subset('dataset', 'dev')
            df_test = self.get_df_subset('dataset', 'test')
        else:
            length = self.df.shape[0]
            end_train = int(length * self.split[0])
            end_dev = int(end_train + length * self.split[1])
            df_train = self.df[:end_train]
            df_dev = self.df[end_train:end_dev]
            df_test = self.df[end_dev:]

        missing = self.missing.load_intervals()
        missing = self.get_transforms_missing_intervals(missing)

        def get_intervals(df):
            return sorted(set(df['interval_id'].unique()) - missing)

        # on-disk scan excluding intervals lacking required keys
        # (reference dataUtils.py:216-223 -> h5_loader.check_log_mel)
        required = tuple(self.modalities)
        scan_missing: set[str] = set()
        for sp in self.speaker:
            ids = self.df[self.df['speaker'] == sp]['interval_id'].unique()
            scan_missing.update(hdf5_io.scan_missing_keys(
                self.path2data, sp, ids, required_keys=required))

        train_intervals = [i for i in get_intervals(df_train)
                           if i not in scan_missing]
        dev_intervals = [i for i in get_intervals(df_dev)
                         if i not in scan_missing]
        test_intervals = [i for i in get_intervals(df_test)
                          if i not in scan_missing]

        if not self.load_data:
            train_intervals = train_intervals[:5]
            dev_intervals = dev_intervals[:5]
            test_intervals = test_intervals[:5]
        if self.max_intervals is not None:
            # configurable split truncation (generalizes the reference's
            # hard-coded 5-interval load_data=False mode, dataUtils.py:231-237)
            train_intervals = train_intervals[:self.max_intervals]
            dev_intervals = dev_intervals[:self.max_intervals]
            test_intervals = test_intervals[:self.max_intervals]

        self._host_batch_caps: dict[str, int] = {}
        if (self.process_count is not None
                or self.process_index is not None):  # multi-host sharding
            from a2m_torch.parallel.mesh import balanced_host_slices
            if self.quantile_sample is not None:
                raise ValueError(
                    'quantile_sample is data-dependent per host: hosts '
                    'would draw unequal sampler lengths and desync at the '
                    'first collective — not supported with '
                    'process_index/process_count')
            pc = None if self.process_count == -1 else self.process_count
            pi = None if self.process_index == -1 else self.process_index
            if pi is None or pc is None:
                # the data rank: the ranks of a model group read one slice
                from a2m_torch.parallel.mesh import data_identity
                rank, world = data_identity()
                pi = pi if pi is not None else rank
                pc = pc if pc is not None else world
            # balanced-by-window-count assignment + truncate-to-global-min
            # batch caps: every host runs the SAME number of collective-
            # bearing steps per epoch (plain striding leaves per-host window
            # counts unequal, which would desync a real multi-process run).
            # Weights come from h5 shape metadata only (no data read); the
            # assignment is deterministic, so all hosts agree without a
            # communication round.
            for name, intervals in (('train', train_intervals),
                                    ('dev', dev_intervals),
                                    ('test', test_intervals)):
                wmap = {i: self._interval_n_windows(i) for i in intervals}
                slices = balanced_host_slices(intervals,
                                              [wmap[i] for i in intervals],
                                              pc)
                per_host = [sum(wmap[i] for i in s) for s in slices]
                self._host_batch_caps[name] = min(
                    -(-n // self.batch_size) for n in per_host)
                if name == 'train':
                    train_intervals = slices[pi]
                elif name == 'dev':
                    dev_intervals = slices[pi]
                else:
                    test_intervals = slices[pi]

        (train_intervals, dev_intervals, test_intervals,
         self.train_intervals_dict) = self.update_intervals(
            train_intervals, dev_intervals, test_intervals)

        return {
            'train': ConcatIntervals(self.get_minidata_list(train_intervals)),
            'dev': ConcatIntervals(self.get_minidata_list(dev_intervals)),
            'test': ConcatIntervals(self.get_minidata_list(test_intervals)),
        }

    def get_transforms_missing_intervals(self, missing: set[str]) -> set[str]:
        """Propagate missing base intervals to their "evil twin" transforms
        (reference dataUtils.py:259-272)."""
        transforms = sorted({sp.split('|')[-1] for sp in self.speaker
                             if '|' in sp})
        extra = {f'{interval}|{t}' for t in transforms for interval in missing}
        return missing | extra

    def update_intervals(self, train, dev, test):
        def subsample(intervals_dict):
            temp = []
            for _, ids in intervals_dict:
                if self.sample_all_styles > 0:
                    temp.extend(ids[:self.sample_all_styles])
                elif self.sample_all_styles == -1:
                    temp.extend(ids)
            return temp

        if self.sample_all_styles != 0:
            train_dict, train = self.order_intervals(train)
            dev_dict, dev = self.order_intervals(dev)
            test_dict, test = self.order_intervals(test)
            train, dev, test = (subsample(train_dict), subsample(dev_dict),
                                subsample(test_dict))
        elif self.style_iters > 0:
            train_dict, train = self.order_intervals(train)
        else:
            train_dict = None
        return train, dev, test, train_dict

    def order_intervals(self, intervals):
        by_speaker: dict[str, list] = {sp: [] for sp in self.speaker_dict}
        for interval in intervals:
            by_speaker[self.getSpeaker(interval)].append(interval)
        intervals_dict = [(k, v) for k, v in by_speaker.items()]
        ordered = [i for _, v in intervals_dict for i in v]
        return intervals_dict, ordered

    def getSpeaker(self, interval_id: str) -> str:
        return self._speaker_of[interval_id]

    def getStyle(self, interval_id: str) -> int:
        return self.speaker_dict[self.getSpeaker(interval_id)]

    def getPath2file(self, interval_id: str) -> str:
        return hdf5_io.interval_path(self.path2data,
                                     self.getSpeaker(interval_id),
                                     interval_id)

    def _interval_n_windows(self, interval_id: str) -> int:
        """Window count of one interval from h5 SHAPE metadata only (no data
        read) — exactly :meth:`IntervalData.__len__`'s value: min over
        modalities of the sliding-window index length."""
        path = self.getPath2file(interval_id)
        index_fn = (exact_window_index if self.exact_windows
                    else window_index)
        counts = []
        for modality, fs_new in zip(self.modalities, self.fs_new):
            n = hdf5_io.dataset_shape(path, modality)[0]
            fs = self.modality_classes[modality].fs(modality)
            counts.append(len(index_fn(n, fs, fs_new, self.time,
                                       self.window_hop)))
        return min(counts)

    def get_minidata_list(self, intervals) -> list[IntervalData]:
        kwargs = dict(modalities=self.modalities, fs_new=self.fs_new,
                      time=self.time, modality_classes=self.modality_classes,
                      window_hop=self.window_hop,
                      repeat_text=self.repeat_text,
                      text_in_modalities=self.text_in_modalities,
                      filler=self.filler, exact_windows=self.exact_windows,
                      lazy_intervals=self.lazy_intervals)
        return [IntervalData(self.getPath2file(i), style=self.getStyle(i),
                             **kwargs) for i in intervals]

    # -- loaders --------------------------------------------------------------

    def update_dataloaders(self, time: float, window_hop: int) -> None:
        for key in self.datasets:
            for d in self.datasets[key].datasets:
                d.update_idx_list(time, window_hop)

        train_ds = self.datasets['train']
        sampler = self.get_train_sampler(train_ds)
        caps = getattr(self, '_host_batch_caps', {})
        # multi-host step balancing: truncate to the global-min batch count.
        # Applies to full-epoch samplers (len == window count); fixed-draw
        # samplers (style_iters / weighted / num_training_iters) already
        # yield identical lengths on every host, so no cap is needed.
        train_cap = (caps.get('train')
                     if len(sampler) == len(train_ds) else None)
        self.train = Batcher(train_ds, self.batch_size, sampler=sampler,
                             max_batches=train_cap)
        self.dev = Batcher(self.datasets['dev'], self.batch_size,
                           sampler=SequentialSampler(len(self.datasets['dev'])),
                           max_batches=caps.get('dev'))
        self.test = Batcher(self.datasets['test'], self.batch_size,
                            sampler=SequentialSampler(len(self.datasets['test'])),
                            max_batches=caps.get('test'))

    def get_train_sampler(self, dataset_train: ConcatIntervals):
        n = len(dataset_train)
        if self.style_iters > 0 and self.sample_all_styles == 0:
            class_count = self._class_counts(dataset_train)
            return AlternateClassSampler(
                class_count, self.style_iters * self.batch_size,
                seed=self.seed)
        if self.num_training_sample is not None:
            perm = np.random.default_rng(self.seed).permutation(n)
            return SubsetRandomSampler(perm[:self.num_training_sample],
                                       seed=self.seed)
        if self.quantile_sample is not None:
            subset_idx, kind = self.get_quantile_sample(
                dataset_train, self.quantile_sample)
            if kind in ('above', 'tail'):
                return SubsetRandomSampler(np.asarray(subset_idx),
                                           seed=self.seed)
            if kind == 'rebalance' and self.quantile_num_training_sample:
                return BalanceClassSampler(
                    [np.asarray(li) for li in subset_idx],
                    int(self.quantile_num_training_sample) * self.batch_size,
                    seed=self.seed)
        if self.weighted:
            return WeightedRandomSampler([1.0] * n,
                                         self.weighted * self.batch_size,
                                         seed=self.seed)
        if self.num_training_iters is not None:
            return RandomSampler(n, self.num_training_iters * self.batch_size,
                                 replacement=True, seed=self.seed)
        if self.shuffle:
            return RandomSampler(n, seed=self.seed)
        return SequentialSampler(n)

    def _class_counts(self, dataset: ConcatIntervals) -> list[int]:
        """Windows per speaker block (intervals are speaker-ordered when
        style_iters > 0; reference dataUtils.py:419-429)."""
        counts = []
        offset = 0
        for _, ids in self.train_intervals_dict:
            c = sum(len(dataset.datasets[offset + j]) for j in range(len(ids)))
            counts.append(c)
            offset += len(ids)
        return counts

    # -- quantile / velocity rebalancing (reference dataUtils.py:432-501) -----

    def get_quantile_sample(self, data: ConcatIntervals, q):
        pose_modality = next((k for k in self.modalities if 'pose' in k), None)
        assert pose_modality is not None, "can't find pose modality"
        if isinstance(q, (int, float)):
            kind = 'above' if q < 1 else 'rebalance'
            if kind == 'rebalance':
                q = int(q)
        else:
            assert len(q) == 2 and all(0 <= q_ <= 1 for q_ in q)
            kind = 'tail'

        def velocity(pose: np.ndarray) -> float:
            # (T, 104) block layout -> (T, 52, 2); mean speed of non-root joints
            p = pose.reshape(pose.shape[0], 2, -1).transpose(0, 2, 1)
            d = p[1:, 1:] - p[:-1, 1:]
            return float(np.sqrt((d ** 2).sum(-1)).mean())

        samples = np.array([velocity(data[i][pose_modality])
                            for i in range(len(data))])
        if kind == 'above':
            v0 = np.quantile(samples, q)
            subset = np.nonzero(samples > v0)[0]
            return subset, kind
        if kind == 'tail':
            lo, hi = np.quantile(samples, q[0]), np.quantile(samples, q[1])
            subset = np.nonzero((samples < lo) | (samples > hi))[0]
            return subset, kind
        # rebalance into q velocity bins
        edges = np.linspace(samples.min(), samples.max() + 1e-5, q + 1)
        bins = np.clip(np.digitize(samples, edges) - 1, 0, q - 1)
        subset = [np.nonzero(bins == b)[0] for b in range(q)]
        return subset, kind


# reference-compatible alias
Data_Loader = DataLoader


#: DataConfig field -> DataLoader kwarg.  Every DataConfig field MUST appear
#: here (loader_from_config raises otherwise, and tests/test_data.py asserts
#: the mapping is total) so new config surface can never silently not reach
#: the loader.
DATACONFIG_FIELD_MAP: dict[str, str] = {
    'path2data': 'path2data',
    'speakers': 'speaker',
    'modalities': 'modalities',
    'fs_new': 'fs_new',
    'batch_size': 'batch_size',
    'window_hop': 'window_hop',
    'window_seconds': 'time',
    'shuffle': 'shuffle',
    'seed': 'seed',
    'max_intervals_per_split': 'max_intervals',
    'style_iters': 'style_iters',
    'num_training_sample': 'num_training_sample',
    'quantile_sample': 'quantile_sample',
    'quantile_num_training_sample': 'quantile_num_training_sample',
    'weighted': 'weighted',
    'repeat_text': 'repeat_text',
    'filler': 'filler',
    'process_index': 'process_index',
    'process_count': 'process_count',
    'exact_windows': 'exact_windows',
    'lazy_intervals': 'lazy_intervals',
}


def loader_from_config(data_cfg, audio_cfg=None) -> DataLoader:
    """Construct a DataLoader from a :class:`a2m_torch.config.DataConfig`,
    mapping EVERY field through :data:`DATACONFIG_FIELD_MAP` (the reference
    constructor surface, dataUtils.py:38-57); ``audio_cfg``'s device
    reaches the Audio frontends."""
    kwargs = {}
    for f in dataclasses.fields(type(data_cfg)):
        if f.name not in DATACONFIG_FIELD_MAP:
            raise TypeError(
                f'DataConfig field {f.name!r} has no DataLoader mapping; '
                f'add it to DATACONFIG_FIELD_MAP')
        val = getattr(data_cfg, f.name)
        kwargs[DATACONFIG_FIELD_MAP[f.name]] = (
            list(val) if isinstance(val, tuple) else val)
    if audio_cfg is not None:
        kwargs['device'] = audio_cfg.device
    return DataLoader(**kwargs)
