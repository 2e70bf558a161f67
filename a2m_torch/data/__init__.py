"""The data path of the port: PATS-layout h5 intervals, windows, batches.

Own copies of ``a2m/data``'s ``hdf5_io``, ``windowing``, ``modalities``,
``normalization``, ``dataset`` and ``synthetic``.  ``h5py`` and ``pandas``
are imported only where files are opened or the master CSV is read, so the
package imports without them.
"""

from a2m_torch.data import (hdf5_io, normalization, synthetic,
                            windowing)
from a2m_torch.data.dataset import (DATACONFIG_FIELD_MAP,
                                    AlternateClassSampler,
                                    BalanceClassSampler, Batcher,
                                    ConcatIntervals, Data_Loader, DataLoader,
                                    IntervalData, RandomSampler,
                                    SequentialSampler, SubsetRandomSampler,
                                    WeightedRandomSampler, loader_from_config,
                                    read_text_meta, write_text_meta)
from a2m_torch.data.modalities import (MOD_MAP, SPEAKERS, Audio, Modality,
                                       Skeleton2D, Text,
                                       load_modality_classes, pad_ragged,
                                       read_master_csv)
from a2m_torch.data.normalization import (denormalize_pose, get_mean_std,
                                          get_mean_std_necksub,
                                          neck_subtract, normalize_pose)
from a2m_torch.data.synthetic import make_synthetic_pats
from a2m_torch.data.windowing import (WindowIndex, exact_window_index,
                                      window_index)

__all__ = [
    'hdf5_io', 'normalization', 'synthetic', 'windowing',
    'AlternateClassSampler', 'BalanceClassSampler', 'Batcher',
    'ConcatIntervals', 'DataLoader', 'Data_Loader', 'IntervalData',
    'RandomSampler', 'SequentialSampler', 'SubsetRandomSampler',
    'WeightedRandomSampler', 'MOD_MAP', 'SPEAKERS', 'Audio', 'Modality',
    'Skeleton2D', 'Text', 'load_modality_classes', 'pad_ragged',
    'read_master_csv', 'denormalize_pose', 'get_mean_std',
    'get_mean_std_necksub', 'neck_subtract', 'normalize_pose',
    'make_synthetic_pats', 'WindowIndex', 'exact_window_index',
    'window_index', 'DATACONFIG_FIELD_MAP', 'loader_from_config',
    'read_text_meta', 'write_text_meta',
]
