"""Modality abstraction over the PATS master table.

The port's own copy of ``a2m/data/modalities.py``.  Capability parity with
`pats/data_loading/{common.py:114-215, skeleton.py, audio.py, text.py}`:
each modality knows its HDF5 group, per-method sampling rate, and
preprocessing.  Audio feature extraction runs the exact-mode frontend
(:mod:`a2m_torch.audio.frontend`) on the modality's device: the log-mel
kernel K2x on CUDA, its float64 plain version on the CPU.  ``pandas`` is
imported where the master CSV is read, never when the module is imported.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from a2m_torch import constants
from a2m_torch.audio import frontend, mel_np, vad
from a2m_torch.data import hdf5_io
from a2m_torch.device import resolve_device

#: PATS speaker registry (reference common.py:174-200); order defines ids.
SPEAKERS: tuple[str, ...] = (
    'oliver', 'jon', 'conan', 'rock', 'chemistry', 'ellen', 'almaram',
    'angelica', 'seth', 'shelly', 'colbert', 'corden', 'fallon', 'huckabee',
    'maher', 'lec_cosmic', 'lec_evol', 'lec_hist', 'lec_law', 'minhaj',
    'ytch_charisma', 'ytch_dating', 'ytch_prof', 'bee', 'noah',
)


def read_master_csv(path2data, with_transforms: bool = False) -> pd.DataFrame:
    """Master interval table; optionally appended with the "evil twins"
    transforms table (reference dataUtils.py:111-113)."""
    import pandas as pd
    df = pd.read_csv(Path(path2data) / 'cmu_intervals_df.csv', dtype=object)
    if with_transforms:
        tpath = Path(path2data) / 'cmu_intervals_df_transforms.csv'
        if tpath.exists():
            df = pd.concat([df, pd.read_csv(tpath, dtype=object)],
                           ignore_index=True)
    df.loc[:, 'delta_time'] = df['delta_time'].astype(float)
    df.loc[:, 'interval_id'] = df['interval_id'].astype(str)
    return df


class Modality:
    """Base modality: master-table access + speaker registry + key deletion
    (reference common.py:114-215)."""

    def __init__(self, path2data='../data', path2outdata=None,
                 speaker='oliver', preprocess_methods: Iterable[str] = ()):
        self.path2data = path2data
        self.path2outdata = path2outdata or path2data
        self.speaker = speaker
        self.preprocess_methods = list(preprocess_methods)
        self.df = read_master_csv(path2data)
        self.missing = hdf5_io.MissingData(path2data)

    # -- master-table helpers -------------------------------------------------

    def get_df_subset(self, column: str, value) -> pd.DataFrame:
        if isinstance(value, (list, tuple)):
            return self.df[self.df[column].isin(list(value))]
        return self.df[self.df[column] == value]

    @property
    def speakers(self) -> list[str]:
        return list(SPEAKERS)

    @property
    def inv_speakers(self) -> dict[str, int]:
        return {sp: i for i, sp in enumerate(SPEAKERS)}

    def speaker_id(self, speaker: str) -> int:
        return self.inv_speakers[speaker]

    # -- maintenance ----------------------------------------------------------

    def del_keys(self, h5_key) -> None:
        """Delete ``<h5_key>/<method>`` datasets across a speaker's interval
        files (reference common.py:139-163)."""
        speakers = [self.speaker] if self.speaker != 'all' else self.speakers
        if isinstance(h5_key, str):
            h5_key = [h5_key]
        for speaker in speakers:
            df_speaker = self.get_df_subset('speaker', speaker)
            for method in self.preprocess_methods:
                key = hdf5_io.add_key(h5_key[0], [method])
                for interval_id in df_speaker['interval_id'].unique():
                    fp = hdf5_io.interval_path(self.path2outdata, speaker,
                                               interval_id)
                    with hdf5_io.h5_open(fp, 'a') as h5:
                        if not hdf5_io.del_dataset(h5, key):
                            break

    # -- to be provided by subclasses -----------------------------------------

    def fs(self, modality: str) -> int:
        raise NotImplementedError

    @property
    def h5_key(self) -> str:
        raise NotImplementedError

    def preprocess(self):
        raise NotImplementedError


class Skeleton2D(Modality):
    """52-joint 2D skeleton modality (reference skeleton.py:16-156).
    Topology constants live in :mod:`a2m_torch.constants`.
    """

    def __init__(self, path2data='../data', path2outdata=None,
                 speaker='oliver', preprocess_methods=('data',)):
        super().__init__(path2data, path2outdata, speaker, preprocess_methods)

    @property
    def parents(self) -> list[int]:
        return list(constants.PARENTS)

    @property
    def joint_subset(self) -> np.ndarray:
        return constants.JOINT_SUBSET

    @property
    def root(self) -> int:
        return constants.ROOT_JOINT

    @property
    def joint_names(self) -> list[str]:
        return list(constants.JOINT_NAMES)

    def fs(self, modality: str) -> int:
        return constants.POSE_FPS

    @property
    def h5_key(self) -> str:
        return 'pose'


class Audio(Modality):
    """Audio modality: log-mel feature extraction + silence channel
    (reference audio.py:26-190), on the exact-mode frontend.

    ``device`` (config ``audio.device``) is where extraction runs: the
    exact log-mel kernel (K2x) on ``'cuda'``, the default, which raises
    when CUDA is absent; its float64 plain version on ``'cpu'``.  (a2m's
    ``use_pallas`` switch picked kernel or XLA; in the port the device alone
    picks kernel or plain version.)
    """

    def __init__(self, path2data='../data', path2outdata=None,
                 speaker='oliver', preprocess_methods=('log_mel_512',),
                 device='cuda'):
        self.device = resolve_device(device)
        super().__init__(path2data, path2outdata, speaker, preprocess_methods)

    # feature extractors ------------------------------------------------------

    def log_mel_512(self, y: np.ndarray, sr: int, eps: float = 1e-10
                    ) -> np.ndarray:
        y32 = torch.as_tensor(np.asarray(y, dtype=np.float32))
        return frontend.log_mel_512(y32.to(self.device), int(sr)).cpu().numpy()

    def log_mel_400(self, y: np.ndarray, sr: int, eps: float = 1e-6
                    ) -> np.ndarray:
        # kaiser_best: the reference's librosa resampler (audio.py:88)
        y16 = mel_np.resample(np.asarray(y, dtype=np.float64), int(sr),
                              16000).astype(np.float32)
        return frontend.log_mel_400(
            torch.as_tensor(y16).to(self.device)).cpu().numpy()

    def silence(self, y: np.ndarray, sr: int, eps: float = 1e-6
                ) -> np.ndarray:
        """Reference-format silence stream (audio.py:129-172), decided on
        the host by the GMM VAD (:mod:`a2m_torch.audio.vad`)."""
        y16 = mel_np.resample(np.asarray(y, dtype=np.float64), int(sr),
                              16000).astype(np.float32)
        return vad.silence_stream(y16)

    @property
    def fs_map(self) -> dict[str, int]:
        return dict(constants.AUDIO_FS_MAP)

    def fs(self, modality: str) -> int:
        return self.fs_map[modality.split('/')[-1]]

    @property
    def h5_key(self) -> str:
        return 'audio'


class Text(Modality):
    """Text modality (w2v / BERT word features at pose rate; reference
    text.py:51-77)."""

    def __init__(self, path2data='../data', path2outdata=None,
                 speaker='oliver', preprocess_methods=('w2v',),
                 text_aligned=0):
        super().__init__(path2data, path2outdata, speaker, preprocess_methods)
        self.text_aligned = text_aligned

    def fs(self, modality: str) -> int:
        return constants.POSE_FPS

    @property
    def h5_key(self) -> str:
        return 'text'


MOD_MAP = {'pose': Skeleton2D, 'audio': Audio, 'text': Text}


def load_modality_classes(modalities: Iterable[str], path2data,
                          speaker, device='cuda') -> dict[str, Modality]:
    """modality string -> instantiated modality class (reference
    dataUtils.py:159-174).  ``device`` reaches the Audio frontends (config
    ``audio.device``)."""
    out = {}
    for modality in modalities:
        mod = modality.split('/')[0]
        kwargs = {'device': device} if mod == 'audio' else {}
        out[modality] = MOD_MAP[mod](path2data=path2data, speaker=speaker,
                                     **kwargs)
    return out


def pad_ragged(arrays: list[np.ndarray], dim: int = 0
               ) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad a list of arrays to equal length along ``dim`` and stack;
    returns (stacked, lengths).  Collate helper for variable-length text
    (reference text.py:15-48)."""
    sizes = [a.shape[dim] for a in arrays]
    max_len = max(sizes)
    padded = []
    for a in arrays:
        pad_width = [(0, 0)] * a.ndim
        pad_width[dim] = (0, max_len - a.shape[dim])
        padded.append(np.pad(a, pad_width))
    return np.stack(padded), np.asarray(sizes, dtype=np.int32)
