"""Synthetic PATS fixture generator.

The port's own copy of ``a2m/data/synthetic.py``: the same seed gives the
same files.  :func:`synth_pose`, the envelopes and
:func:`synth_interval_arrays` are numpy alone; :func:`synth_interval` and
:func:`make_synthetic_pats` write h5 files and the master CSV, and import
``h5py`` and ``pandas`` when they do.  :func:`synthetic_loader` builds the
fixture of :func:`make_synthetic_pats` in memory, as the port's
``DataLoader`` would read it, for a machine without ``h5py``.

It creates a miniature on-disk PATS tree with the exact schema the loader
expects (reference h5_loader.py:119-195): the hermetic test substrate the
reference never had (SURVEY.md §4).  Pose data is generated as smooth,
bone-length-consistent joint trajectories in the canonical block layout so
normalization / bone-loss math has realistic structure.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from a2m_torch import constants
from a2m_torch.data import hdf5_io


def _rest_pose() -> np.ndarray:
    """A plausible (2, 52) rest pose built by walking the skeleton tree."""
    pos = np.zeros((52, 2))
    for j in range(1, 52):
        p = constants.PARENTS[j]
        # deterministic limb offsets with golden-angle spread; hands smaller
        scale = 12.0 if j < 10 else 4.0
        ang = (j * 2.399) % (2 * np.pi)
        pos[j] = pos[p] + scale * np.array([np.cos(ang), np.sin(ang)])
    return pos.T + np.array([[640.0], [360.0]])  # (2, 52) centered on screen


def synth_pose(n_frames: int, rng: np.random.Generator,
               drive: np.ndarray | None = None) -> np.ndarray:
    """(T, 104) float64 block-layout pose with smooth sinusoidal motion.

    With ``drive`` (T,) in [0, 1], motion amplitude is modulated by the
    signal — used to build audio-correlated fixtures a model can learn from.
    """
    rest = _rest_pose()                       # (2, 52)
    t = np.arange(n_frames)[:, None, None] / constants.POSE_FPS
    freq = rng.uniform(0.2, 1.5, (1, 2, 52))
    phase = rng.uniform(0, 2 * np.pi, (1, 2, 52))
    amp = rng.uniform(2.0, 18.0, (1, 2, 52))
    motion = amp * np.sin(2 * np.pi * freq * t + phase)   # (T, 2, 52)
    if drive is not None:
        motion = motion * drive[:, None, None]
    pose = rest[None] + motion
    return pose.reshape(n_frames, 104)


TEXT_VOCAB = ('hello', 'gesture', 'the', 'motion', 'speech', 'and', 'wave',
              'point', 'to', 'arm')          # incl. stopwords for filler masks

#: deterministic-mode pose basis: K global (2, 52) patterns, one per mel
#: band group.  Seeded constant shared by EVERY interval and speaker so the
#: audio->pose map is learnable across the whole dataset; neck (joint 0)
#: pinned so neck-rooted normalization stays centered.
_DET_BANDS = 8
#: basis amplitude and envelope sharpening exponent, chosen so the motion is
#: large relative to the PCK radius (0.2 x bbox): a mean-pose predictor
#: scores ~0.58 PCK@0.2 here (vs 0.95 at amp 8 / no sharpening — no headroom
#: for a trained model to demonstrate learning; measured in round 3)
_DET_AMP = 24.0
_DET_SHARPEN = 3


def _det_basis() -> np.ndarray:
    rng = np.random.default_rng(1234)
    basis = rng.uniform(-_DET_AMP, _DET_AMP, (_DET_BANDS, 2, 52))
    basis[:, :, 0] = 0.0
    return basis


def _smooth_envelopes(n_frames: int, rng: np.random.Generator,
                      duration_s: float) -> np.ndarray:
    """(K, T) smooth per-band envelopes in [0, 1] (~1 knot/second)."""
    n_knots = max(4, int(duration_s))
    knots = rng.uniform(0.0, 1.0, (_DET_BANDS, n_knots))
    t = np.linspace(0, n_knots - 1, n_frames)
    return np.stack([np.interp(t, np.arange(n_knots), k) for k in knots])


def synth_interval_arrays(duration_s: float, rng: np.random.Generator,
                          with_text: bool = False, correlated: bool = False,
                          with_norm_stats: bool = False,
                          deterministic: bool = False,
                          det_grid: str = 'stride') -> dict:
    """One interval's datasets, ``{h5 dataset name: array}`` in the dtypes
    :func:`synth_interval` writes, drawn from ``rng`` in its order; with
    ``with_text`` also ``'text/meta'``, the word table (``start_frame``,
    ``end_frame``, ``Word``).  numpy alone: a caller without ``h5py``
    builds the fixture in memory.  The modes are :func:`synth_interval`'s.
    """
    n_pose = int(duration_s * constants.POSE_FPS)
    fs512 = constants.AUDIO_FS_MAP['log_mel_512']
    fs400 = constants.AUDIO_FS_MAP['log_mel_400']
    n512 = int(duration_s * fs512) + 1
    n400 = int(duration_s * fs400) + 1

    if deterministic:
        # sharpened envelopes (x^3 keeps [0, 1]) concentrate motion in
        # bursts so positions deviate far from the time-mean pose — the
        # same sharpened signal drives BOTH mel and pose, so the map the
        # model must learn stays linear
        envs = _smooth_envelopes(n_pose, rng,
                                 duration_s) ** _DET_SHARPEN   # (K, T)
        basis = _det_basis()
        pose = (_rest_pose()[None]
                + np.einsum('kt,kcj->tcj', envs, basis)).reshape(n_pose, 104)

        # ALIGNMENT (LEARNING.md "fixture drift"): the loader resamples by
        # stride slicing with ratio round(fs/fs_new) (reference
        # dataUtils.py:585-620; data/windowing.py) — window k, output
        # frame i reads audio row hop*k + stride*i.  At the nominal fs the
        # stride-6 grid (89 Hz) drifts off the 15 fps pose grid by k/267 s
        # (1.3 s over 120 s), which destroys frame-diff predictability
        # (oracle linear probe: motion R^2 0.19).  The det fixture therefore
        # writes mel rows on the EXACT stride grid — row r carries the
        # envelope at pose frame r/stride — so the features the model
        # receives are frame-locked to the pose it must predict.
        # ``det_grid='nominal'`` instead writes rows on the true fs grid
        # (row r at time r/fs) — frame-locked only under the loader's
        # ``exact_windows=True`` extension; used to test that extension.
        def band_mel(fs: int, n_mels: int) -> np.ndarray:
            stride = round(fs / constants.POSE_FPS)
            if det_grid == 'stride':
                n_rows = stride * (n_pose - 1) + 1
                t = np.arange(n_rows) / stride               # pose frames
            else:
                n_rows = int(duration_s * fs) + 1
                t = np.arange(n_rows) * (constants.POSE_FPS / fs)
            env_r = np.stack([np.interp(t, np.arange(n_pose), e)
                              for e in envs])               # (K, rows)
            mel = np.repeat(env_r.T, n_mels // _DET_BANDS, axis=1)
            return 4.0 * mel - 6.0 + 0.1 * rng.standard_normal(
                (n_rows, n_mels))
        mel512 = band_mel(fs512, 128)
        mel400 = band_mel(fs400, 64)
    elif correlated:
        # smooth random envelope in [0.1, 1] at pose rate
        knots = rng.uniform(0.1, 1.0, max(4, int(duration_s)))
        env = np.interp(np.linspace(0, len(knots) - 1, n_pose),
                        np.arange(len(knots)), knots)
        pose = synth_pose(n_pose, rng, drive=env)
        env512 = np.interp(np.linspace(0, n_pose - 1, n512),
                           np.arange(n_pose), env)
        env400 = np.interp(np.linspace(0, n_pose - 1, n400),
                           np.arange(n_pose), env)
        mel512 = (rng.standard_normal((n512, 128)) * 0.3 - 6.0
                  + 4.0 * env512[:, None])
        mel400 = (rng.standard_normal((n400, 64)) * 0.3 - 6.0
                  + 4.0 * env400[:, None])
    else:
        pose = synth_pose(n_pose, rng)
        mel512 = rng.standard_normal((n512, 128)) - 6.0
        mel400 = rng.standard_normal((n400, 64)) - 6.0
    silence = rng.integers(0, 2, 2 * (n_pose - 1)).astype(np.int64)
    silence[1::2] = 0

    out = {'pose/data': pose.astype(np.float64),
           'pose/normalize': pose.astype(np.float64),
           'audio/log_mel_512': mel512.astype(np.float64),
           'audio/log_mel_400': mel400.astype(np.float64),
           'audio/silence': silence}
    if with_norm_stats:
        out['pose/norm_stats/mean'] = pose.mean(axis=0).astype(np.float64)
        out['pose/norm_stats/std'] = pose.std(axis=0).astype(np.float64)
    if with_text:
        # word-piecewise-constant features (so the tokens-only boundary
        # detection path in IntervalData also finds real word starts)
        n_words = max(2, int(duration_s))
        bounds = np.linspace(0, n_pose, n_words + 1).astype(np.int64)
        words = [TEXT_VOCAB[w % len(TEXT_VOCAB)] for w in range(n_words)]
        w2v = np.zeros((n_pose, 300))
        bert = np.zeros((n_pose, 768), np.float32)
        tokens = np.zeros(n_pose, np.int64)
        for st, en in zip(bounds[:-1], bounds[1:]):
            w2v[st:en] = rng.standard_normal(300)
            bert[st:en] = rng.standard_normal(768).astype(np.float32)
            tokens[st:en] = rng.integers(1, 30000)
        out['text/w2v'] = w2v
        out['text/bert'] = bert
        out['text/tokens'] = tokens
        out['text/meta'] = dict(start_frame=bounds[:-1],
                                end_frame=bounds[1:], Word=words)
    return out


def synth_interval(path2h5, duration_s: float, rng: np.random.Generator,
                   with_text: bool = False, correlated: bool = False,
                   with_norm_stats: bool = False,
                   deterministic: bool = False,
                   det_grid: str = 'stride') -> None:
    """Write one interval .h5 with pose/audio(/text) datasets.

    ``correlated=True`` makes the pose motion amplitude follow a smooth
    "audio energy" envelope that is also written into the mel features —
    a learnable audio->motion mapping for end-to-end training validation.
    NOTE: only motion *statistics* are predictable from audio in this mode
    (sinusoid phases are random), so a mean-pose predictor is near-optimal
    for position metrics like PCK.

    ``deterministic=True`` instead makes pose a deterministic function of
    the audio: K smooth per-band envelopes drive both the mel band groups
    and a fixed global pose basis (``pose = rest + sum_k env_k * basis_k``)
    — absolute joint positions are recoverable from the spectrogram, so a
    trained model can beat the mean-pose predictor on PCK.

    ``with_text`` writes word-piecewise-constant ``text/{w2v,bert,tokens}``
    plus the ``text/meta`` alignment table (via
    :func:`a2m_torch.data.dataset.write_text_meta`).  ``with_norm_stats``
    writes cached ``pose/norm_stats/{mean,std}`` (reference
    dataUtils.py:563-582).
    """
    arrays = synth_interval_arrays(duration_s, rng, with_text=with_text,
                                   correlated=correlated,
                                   with_norm_stats=with_norm_stats,
                                   deterministic=deterministic,
                                   det_grid=det_grid)
    meta = arrays.pop('text/meta', None)
    with hdf5_io.h5_open(path2h5, 'w') as h5:
        for name, data in arrays.items():
            h5.create_dataset(name, data=data)
    if meta is not None:
        # via the public write path (pandas-HDF when pytables exists,
        # plain-h5 here) so fixtures exercise what users write
        from a2m_torch.data.dataset import write_text_meta
        write_text_meta(path2h5, meta)


def make_synthetic_pats(root, speakers=('oliver', 'noah'),
                        intervals_per_speaker: int = 4,
                        duration_s: float = 12.0, seed: int = 0,
                        with_text: bool = False, correlated: bool = False,
                        with_norm_stats: bool = False,
                        deterministic: bool = False, det_grid: str = 'stride',
                        splits=('train', 'train', 'dev', 'test')) -> Path:
    """Build a synthetic PATS tree under ``root`` and return its path.

    Layout: cmu_intervals_df.csv + processed/<speaker>/<interval>.h5 with the
    train/dev/test assignment cycling through ``splits``.
    """
    root = Path(root)
    rng = np.random.default_rng(seed)
    rows = []
    iid = 100000
    for sp in speakers:
        for k in range(intervals_per_speaker):
            iid += 1
            dataset = splits[k % len(splits)]
            rows.append(dict(interval_id=str(iid), speaker=sp,
                             dataset=dataset, delta_time=duration_s,
                             start_time='0:00:00', end_time='0:00:12',
                             video_link='', video_fn='', yt_id=''))
            synth_interval(hdf5_io.interval_path(root, sp, str(iid)),
                           duration_s, rng, with_text=with_text,
                           correlated=correlated,
                           with_norm_stats=with_norm_stats,
                           deterministic=deterministic, det_grid=det_grid)
    import pandas as pd
    pd.DataFrame(rows).to_csv(root / 'cmu_intervals_df.csv', index=False)
    return root


class _Rates:
    """Frame rates of the two modalities, for windowing in memory (what
    the data loader's modality classes give)."""

    @staticmethod
    def fs(modality: str) -> int:
        if modality.startswith('pose'):
            return constants.POSE_FPS
        return constants.AUDIO_FS_MAP[modality.split('/')[-1]]


def synthetic_loader(speakers=('oliver', 'noah'),
                     intervals_per_speaker: int = 4, duration_s: float = 12.0,
                     seed: int = 0, deterministic: bool = False,
                     splits=('train', 'train', 'dev', 'test'),
                     batch_size: int = 128, window_hop: int = 5,
                     max_batches: dict | None = None,
                     process_index: int | None = None,
                     process_count: int | None = None,
                     style_iters: int = 0):
    """The fixture :func:`make_synthetic_pats` writes with these arguments,
    built in memory and cut into windows as ``DataLoader(speaker=speakers,
    batch_size=batch_size, window_hop=window_hop, seed=seed,
    process_index=process_index, process_count=process_count)`` reads it
    from the files (pose and ``log_mel_512`` at 15 fps, windows of 4.3 s,
    the train split shuffled): an object with ``.train``, ``.dev`` and
    ``.test`` Batchers.  ``max_batches`` caps a split's batches an epoch
    (``{'train': 4, 'dev': 1}``).  ``style_iters`` > 0 draws the train
    windows as ``DataLoader(style_iters=...)`` does: a2m's
    ``AlternateClassSampler`` over the speakers' blocks.

    With ``process_index``/``process_count`` (either -1: this rank / the
    world size of ``torch.distributed``) each split holds this process's
    share of the intervals (``parallel.mesh.balanced_host_slices`` by
    window count) and is cut to the fewest batches of any process, so that
    every rank runs as many steps (``DataLoader``, ``dataset.py:690-727``);
    ``max_batches`` then caps that."""
    from types import SimpleNamespace

    from a2m_torch.data.dataset import (AlternateClassSampler, Batcher,
                                        ConcatIntervals, IntervalData,
                                        RandomSampler, SequentialSampler)
    from a2m_torch.parallel.mesh import (balanced_host_slices,
                                         process_identity)
    modalities = ('pose/data', 'audio/log_mel_512')
    rng = np.random.default_rng(seed)
    by_split: dict[str, list] = {'train': [], 'dev': [], 'test': []}
    iid = 100000
    for style, sp in enumerate(speakers):
        for k in range(intervals_per_speaker):
            iid += 1
            arrays = synth_interval_arrays(duration_s, rng,
                                           deterministic=deterministic)
            by_split[splits[k % len(splits)]].append((str(iid), IntervalData(
                f'{sp}/{iid}.h5', modalities, (15, 15), 4.3,
                {m: _Rates for m in modalities}, window_hop=window_hop,
                style=style, arrays=arrays)))
    caps = dict(max_batches or {})
    sliced = process_index is not None or process_count is not None
    if sliced:
        rank, world = process_identity()
        pi = rank if process_index in (None, -1) else process_index
        pc = world if process_count in (None, -1) else process_count
    out = {}
    for name, intervals in by_split.items():
        # the loader takes each split's intervals in sorted id order
        data = [d for _, d in sorted(intervals, key=lambda x: x[0])]
        if sliced:
            weights = [len(d) for d in data]
            slices = balanced_host_slices(list(range(len(data))), weights,
                                          pc)
            fewest = min(-(-sum(weights[i] for i in s) // batch_size)
                         for s in slices)
            caps[name] = min(caps.get(name, fewest), fewest)
            data = [data[i] for i in slices[pi]]
        windows = ConcatIntervals(data)
        if name == 'train' and style_iters > 0:
            # windows per speaker block: the intervals are speaker-ordered
            blocks = [sum(len(d) for d in data if d.style == style)
                      for style in range(len(speakers))]
            sampler = AlternateClassSampler(
                [c for c in blocks if c], style_iters * batch_size,
                seed=seed)
        elif name == 'train':
            sampler = RandomSampler(len(windows), seed=seed)
        else:
            sampler = SequentialSampler(len(windows))
        out[name] = Batcher(windows, batch_size, sampler=sampler,
                            max_batches=caps.get(name))
    return SimpleNamespace(**out)
