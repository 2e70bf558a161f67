"""The port's data path (a2m_torch/data/*, a2m_torch/parallel/mesh.py)
against a2m's, on synthetic PATS fixtures that both packages read.

The modules are numpy copies, so batches, indices and samplers must be
bit-equal; the neck-subtracted moments are float64 sums over the same
batches, held within 1e-12.
"""

import dataclasses

import h5py
import numpy as np
import pytest

from a2m import config as jconfig
from a2m.data import dataset as jdataset
from a2m.data import hdf5_io as jhdf5_io
from a2m.data import make_synthetic_pats as jmake_synthetic_pats
from a2m.data import modalities as jmods
from a2m.data import normalization as jnorm
from a2m.data import windowing as jwindowing
from a2m.parallel import mesh as jmesh
from a2m_torch import config
from a2m_torch.data import dataset, hdf5_io, modalities, normalization
from a2m_torch.data import synthetic, windowing
from a2m_torch.parallel import mesh

SPEAKERS = ('oliver', 'noah')
MODS = ['pose/data', 'audio/log_mel_512']


@pytest.fixture(scope='module')
def pats_root(tmp_path_factory):
    return jmake_synthetic_pats(tmp_path_factory.mktemp('pats'),
                                speakers=SPEAKERS, intervals_per_speaker=4,
                                duration_s=12.0)


@pytest.fixture(scope='module')
def text_root(tmp_path_factory):
    return jmake_synthetic_pats(tmp_path_factory.mktemp('pats_text'),
                                speakers=('oliver',), intervals_per_speaker=2,
                                duration_s=6.0, with_text=True,
                                with_norm_stats=True)


def _loaders(root, **kw):
    kw = dict(path2data=root, speaker=list(SPEAKERS), modalities=MODS,
              fs_new=[15, 15], batch_size=8, window_hop=5, seed=0) | kw
    return (jdataset.DataLoader(**kw),
            dataset.DataLoader(device='cpu', **kw))


def _assert_batches_equal(ref_batches, got_batches):
    ref_batches, got_batches = list(ref_batches), list(got_batches)
    assert len(ref_batches) == len(got_batches)
    for ref, got in zip(ref_batches, got_batches):
        assert ref.keys() == got.keys()
        for key in ref:
            if key == 'meta':
                assert ref[key] == got[key]
            else:
                assert ref[key].dtype == got[key].dtype, key
                np.testing.assert_array_equal(ref[key], got[key], key)


# ---- windows ----------------------------------------------------------------

@pytest.mark.parametrize('n_rows,fs,fs_new,time,hop', [
    (148, 15, 15, 4.3, 5), (849, 89, 15, 4.3, 5), (849, 89, 15, 4.3, 0),
    (1069, 103, 15, 4.3, 5), (100, 89, 15, 4.3, 5), (5344, 89, 15, 4.3, 5)])
def test_window_indices_equal_a2m(n_rows, fs, fs_new, time, hop):
    got = windowing.window_index(n_rows, fs, fs_new, time, hop)
    ref = jwindowing.window_index(n_rows, fs, fs_new, time, hop)
    np.testing.assert_array_equal(got.starts, ref.starts)
    assert (got.window, got.stride, got.out_len) == (ref.window, ref.stride,
                                                     ref.out_len)
    fs_exact = 45600 / 512 if fs == 89 else fs
    got = windowing.exact_window_index(n_rows, fs_exact, fs_new, time, hop)
    ref = jwindowing.exact_window_index(n_rows, fs_exact, fs_new, time, hop)
    np.testing.assert_array_equal(got.start_frames, ref.start_frames)
    np.testing.assert_array_equal(got.starts, ref.starts)
    data = np.arange(n_rows * 2, dtype=np.float32).reshape(n_rows, 2)
    for k in range(len(ref)):
        np.testing.assert_array_equal(got.slice(data, k), ref.slice(data, k))


# ---- loader batches ---------------------------------------------------------

@pytest.mark.parametrize('options', [
    {}, {'lazy_intervals': True}, {'exact_windows': True},
    {'shuffle': False}, {'num_training_iters': 3}, {'style_iters': 2},
    {'quantile_sample': 0.5}, {'quantile_sample': 3,
                               'quantile_num_training_sample': 2},
    {'weighted': 2}, {'num_training_sample': 20}, {'split': (0.5, 0.25)},
    {'max_intervals': 2}], ids=lambda o: '-'.join(o) or 'default')
def test_batches_equal_a2m(pats_root, options):
    """.train (shuffled by the same seed), .dev and .test: every key of
    every batch bit-equal, the wrap-padded last batch and its mask
    included."""
    ref, got = _loaders(pats_root, **options)
    for split in ('train', 'dev', 'test'):
        assert len(getattr(got, split)) > 0 or split != 'train'
        _assert_batches_equal(getattr(ref, split), getattr(got, split))
    last = list(got.train)[-1]
    assert last['mask'].shape == (8,) and last['idx'].shape == (8,)


def test_wrap_padding_repeats_the_batch(pats_root):
    _, got = _loaders(pats_root, shuffle=False)
    last = list(got.train)[-1]
    n = int(last['mask'].sum())
    assert 0 < n < 8
    np.testing.assert_array_equal(last['idx'][n:],
                                  last['idx'][:n][np.arange(8 - n) % n])
    np.testing.assert_array_equal(last['pose/data'][n:],
                                  last['pose/data'][np.arange(8 - n) % n])


def test_neck_subtracted_moments_match_a2m(pats_root):
    ref, got = _loaders(pats_root)
    for fn in ('get_mean_std_necksub', 'get_mean_std'):
        m_ref, s_ref = getattr(jnorm, fn)(ref.train)
        m_got, s_got = getattr(normalization, fn)(got.train)
        assert m_got.dtype == s_got.dtype == np.float32
        assert np.abs(m_got - m_ref).max() <= 1e-12
        assert np.abs(s_got - s_ref).max() <= 1e-12
    sums_ref = jnorm.get_moments_necksub(ref.dev)
    sums_got = normalization.get_moments_necksub(got.dev)
    for a, b in zip(sums_ref, sums_got):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-12
    pose = np.random.default_rng(1).standard_normal((3, 64, 104)) * 50
    mean, std = m_got, s_got
    np.testing.assert_array_equal(normalization.neck_subtract(pose),
                                  jnorm.neck_subtract(pose))
    np.testing.assert_allclose(normalization.normalize_pose(pose, mean, std),
                               jnorm.normalize_pose(pose, mean, std),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(
        normalization.denormalize_pose(pose, mean, std),
        jnorm.denormalize_pose(pose, mean, std))


# ---- samplers ---------------------------------------------------------------

@pytest.mark.parametrize('name,args', [
    ('RandomSampler', (50,)), ('RandomSampler', (50, 120, True, 3)),
    ('SequentialSampler', (17,)),
    ('SubsetRandomSampler', (np.arange(5, 40, 3), 2)),
    ('WeightedRandomSampler', (np.linspace(1, 2, 30), 64, 4)),
    ('AlternateClassSampler', ([10, 25, 7], 40, 5)),
    ('BalanceClassSampler', ([np.arange(5), np.arange(5, 30), []], 33, 6))])
def test_samplers_equal_a2m(name, args):
    got = getattr(dataset, name)(*args)
    ref = getattr(jdataset, name)(*args)
    assert len(got) == len(ref)
    np.testing.assert_array_equal(np.asarray(list(got)),
                                  np.asarray(list(ref)))
    # a second epoch draws again, the same way
    np.testing.assert_array_equal(np.asarray(list(got)),
                                  np.asarray(list(ref)))


def test_batcher_over_a_list_of_dicts():
    """A Batcher over any dataset of dicts (what the trainer's loader may
    be), with max_batches and drop_last."""
    rng = np.random.default_rng(2)
    items = [{'audio/log_mel_512': rng.standard_normal((4, 3)).astype(
        np.float32), 'style': np.full(4, i % 2, np.float32)}
        for i in range(11)]
    for kw in ({}, {'drop_last': True}, {'max_batches': 2},
               {'pad_to_batch': False}):
        got = dataset.Batcher(items, 4, dataset.RandomSampler(11, seed=1),
                              **kw)
        ref = jdataset.Batcher(items, 4, jdataset.RandomSampler(11, seed=1),
                               **kw)
        assert len(got) == len(ref)
        _assert_batches_equal(ref, got)


# ---- intervals, files, text -------------------------------------------------

def test_missing_intervals_are_excluded(tmp_path):
    root = jmake_synthetic_pats(tmp_path / 'pats', speakers=('oliver',),
                                intervals_per_speaker=4, duration_s=6.0,
                                splits=('train',))
    jhdf5_io.MissingData(root).save_intervals(['100002'])
    with h5py.File(jhdf5_io.interval_path(root, 'oliver', '100004'),
                   'a') as h5:
        del h5['audio/log_mel_512']              # found by the disk scan
    ref, got = _loaders(root, speaker=['oliver'])
    assert [len(d) for d in got.datasets['train'].datasets] == \
        [len(d) for d in ref.datasets['train'].datasets]
    assert [d.path2h5 for d in got.datasets['train'].datasets] == \
        [d.path2h5 for d in ref.datasets['train'].datasets]
    assert len(got.datasets['train'].datasets) == 2
    assert hdf5_io.MissingData(root).load_intervals() == {'100002'}
    assert hdf5_io.scan_missing_keys(root, 'oliver', ['100001', '100004']) \
        == ['100004']
    _assert_batches_equal(ref.train, got.train)


def test_text_meta_and_text_fields_equal_a2m(text_root):
    path = jhdf5_io.interval_path(text_root, 'oliver', '100001')
    ref, got = jdataset.read_text_meta(path), dataset.read_text_meta(path)
    assert got is not None and ref.equals(got)
    kw = dict(path2data=text_root, speaker=['oliver'],
              modalities=['pose/data', 'audio/log_mel_512', 'text/w2v'],
              fs_new=[15, 15, 15], batch_size=4, window_hop=5, seed=0,
              filler=1, split=(1.0, 0.0))
    _assert_batches_equal(jdataset.DataLoader(**kw).train,
                          dataset.DataLoader(device='cpu', **kw).train)
    # the write path: a plain-h5 table read back by both
    df = {'start_frame': [0, 7], 'end_frame': [7, 20], 'Word': ['the', 'arm']}
    dataset.write_text_meta(path, df, force_plain=True)
    assert dataset.read_text_meta(path).equals(jdataset.read_text_meta(path))
    assert list(dataset.read_text_meta(path)['Word']) == ['the', 'arm']


def test_synthetic_fixtures_equal_a2m(tmp_path):
    """The port's fixture writer gives a2m's files for the same seed."""
    kw = dict(speakers=('oliver',), intervals_per_speaker=2, duration_s=5.0,
              seed=3, with_text=True, with_norm_stats=True)
    for mode in ({}, {'correlated': True}, {'deterministic': True}):
        a = jmake_synthetic_pats(tmp_path / f'a{len(mode)}{list(mode)}',
                                 **kw, **mode)
        b = synthetic.make_synthetic_pats(tmp_path / f'b{len(mode)}'
                                          f'{list(mode)}', **kw, **mode)
        assert (a / 'cmu_intervals_df.csv').read_bytes() == \
            (b / 'cmu_intervals_df.csv').read_bytes()
        for fa in sorted((a / 'processed').rglob('*.h5')):
            fb = b / fa.relative_to(a)
            with h5py.File(fa) as ha, h5py.File(fb) as hb:
                keys_a, keys_b = [], []
                ha.visit(keys_a.append)
                hb.visit(keys_b.append)
                assert keys_a == keys_b
                for k in keys_a:
                    if isinstance(ha[k], h5py.Dataset):
                        np.testing.assert_array_equal(ha[k][()], hb[k][()])
    assert hdf5_io.tree(fb) == jhdf5_io.tree(fb)


def test_hdf5_helpers_equal_a2m(tmp_path):
    path = tmp_path / 'x' / 'i.h5'
    hdf5_io.append(path, 'pose/data', np.arange(2 * 2 * 52.0).reshape(2, 2,
                                                                      52))
    assert hdf5_io.dataset_shape(path, 'pose/data') == (2, 2, 52)
    assert hdf5_io.restore_all_intervals(tmp_path, 'x') == 0
    hdf5_io.restore_interval_shape(path)
    flat = hdf5_io.load_array(path, 'pose/data', np.float64)
    np.testing.assert_array_equal(flat, np.arange(208.0).reshape(2, 104))
    assert hdf5_io.is_dataset_in_file(path, 'pose/data')
    assert hdf5_io.load_norm_stats(path, 'pose/data') is None
    assert hdf5_io.add_key('audio', ['log_mel_512']) == \
        jhdf5_io.add_key('audio', ['log_mel_512'])
    assert hdf5_io.interval_path('r', 'oliver', 7) == \
        jhdf5_io.interval_path('r', 'oliver', 7)
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((n, 3)) for n in (2, 5, 1)]
    for a, b in zip(modalities.pad_ragged(arrays),
                    jmods.pad_ragged(arrays)):
        np.testing.assert_array_equal(a, b)


# ---- configuration, processes -----------------------------------------------

def test_loader_from_config_maps_every_field(pats_root):
    fields = {f.name for f in dataclasses.fields(config.DataConfig)}
    assert fields == set(dataset.DATACONFIG_FIELD_MAP)
    assert dataset.DATACONFIG_FIELD_MAP == jdataset.DATACONFIG_FIELD_MAP
    assert [(f.name, f.default) for f in
            dataclasses.fields(config.DataConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jconfig.DataConfig)]
    cfg = dict(path2data=str(pats_root), speakers=SPEAKERS, batch_size=8,
               seed=2)
    got = dataset.loader_from_config(config.DataConfig(**cfg),
                                     config.AudioConfig(device='cpu'))
    ref = jdataset.loader_from_config(jconfig.DataConfig(**cfg),
                                      jconfig.AudioConfig(use_pallas='off'))
    assert got.modality_classes['audio/log_mel_512'].device.type == 'cpu'
    for split in ('train', 'dev', 'test'):
        _assert_batches_equal(getattr(ref, split), getattr(got, split))

    @dataclasses.dataclass(frozen=True)
    class Extended(config.DataConfig):
        unmapped: int = 0
    with pytest.raises(TypeError, match='unmapped'):
        dataset.loader_from_config(Extended(**cfg),
                                   config.AudioConfig(device='cpu'))


@pytest.mark.parametrize('count', [1, 2, 3, 5])
def test_balanced_host_slices_equal_a2m(count):
    intervals = [str(100 + i) for i in range(11)]
    weights = list(np.random.default_rng(count).integers(1, 50, 11))
    for w in (weights, None):
        assert mesh.balanced_host_slices(intervals, w, count) == \
            jmesh.balanced_host_slices(intervals, w, count)
    assert mesh.process_identity() == (0, 1)
    assert mesh.balanced_host_slices(intervals, weights) == [intervals]


@pytest.mark.parametrize('index,count', [(0, 2), (1, 2), (2, 3)])
def test_process_sharded_loader_equals_a2m(pats_root, index, count):
    ref, got = _loaders(pats_root, process_index=index, process_count=count)
    for split in ('train', 'dev', 'test'):
        _assert_batches_equal(getattr(ref, split), getattr(got, split))
    assert got._host_batch_caps == ref._host_batch_caps
    with pytest.raises(ValueError, match='quantile_sample'):
        dataset.DataLoader(path2data=pats_root, speaker=list(SPEAKERS),
                           modalities=MODS, batch_size=8, device='cpu',
                           process_index=index, process_count=count,
                           quantile_sample=0.5)


def test_process_identity_defaults_to_one_process(pats_root):
    """``process_count=-1``: the rank and world size of torch.distributed,
    one process when no group is initialised (a2m asks jax)."""
    _, got = _loaders(pats_root, process_index=-1, process_count=-1)
    _, whole = _loaders(pats_root)
    assert [d.path2h5 for d in got.datasets['train'].datasets] == \
        [d.path2h5 for d in whole.datasets['train'].datasets]
