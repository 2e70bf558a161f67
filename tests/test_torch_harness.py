"""The port's evaluation harness (a2m_torch/eval/harness.py) against a2m's
(a2m/eval/harness.py, its XLA path on the CPU).

Both read the same a2m-written best-G ``.npz`` and the same
``make_synthetic_pats`` tree.  ``n_clips`` must be equal, PCK at alpha 0.2
and 0.1 within 1e-4 absolute (a flip of about two keypoints at this size:
the two generators' f32 outputs differ in the last bits, and a keypoint on
the PCK radius may fall either side) and L2 within 1e-5 relative.  With
the pose statistics shipped in the file the harness must not recompute
them.

``a2m_torch/testdata/harness_golden.json`` holds a2m's harness on the
flagship (``artifacts/flagship_best_gen.npz``) over the det fixture's
speaker ``oliver`` (``scripts/full_training_campaign.py:52-67``: 5
intervals of 120 s, seed 0, deterministic, splits train, train, train,
dev, test; 348 test clips), which ``chip_smoke.py`` holds the card to.  The
``slow`` test regenerates it with JAX; to rewrite the file, run
``PYTHONPATH=.:tests python tests/test_torch_harness.py``.  A tier-1 test
holds the port's in-memory build of that fixture (what the card reads,
having no h5py) to a2m's loader over the files.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from a2m.config import Config as JaxConfig
from a2m.config import GeneratorConfig as JaxGeneratorConfig
from a2m.eval import evaluate_speaker as jax_evaluate_speaker
from a2m.models import Generator as JaxGenerator
from a2m.train import checkpoint as jckpt
from a2m_torch.config import Config, GeneratorConfig
from a2m_torch.eval import harness
from a2m_torch.eval.harness import evaluate_speaker
from torch_parity import randomize, unflatten

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / 'a2m_torch' / 'testdata' / 'harness_golden.json'
TINY_G = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2)
ALPHAS = (0.2, 0.1)
#: the det fixture of scripts/full_training_campaign.py:52-67, speaker
#: oliver alone (first in the campaign, so its intervals draw the same
#: numbers), and the harness's batching
DET_RECIPE = dict(speakers=['oliver'], intervals_per_speaker=5,
                  duration_s=120.0, seed=0, deterministic=True,
                  splits=['train', 'train', 'train', 'dev', 'test'],
                  speaker='oliver', batch_size=128, window_hop=5,
                  alpha=list(ALPHAS), ckpt='artifacts/flagship_best_gen.npz')


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pats_root(tmp_path_factory):
    from a2m.data import make_synthetic_pats
    return make_synthetic_pats(tmp_path_factory.mktemp('pats_harness'),
                               speakers=('oliver', 'noah'),
                               intervals_per_speaker=4, duration_s=8.0)


@pytest.fixture(scope='module')
def npz(pats_root, tmp_path_factory):
    """a2m-written best-G files of one seeded random tiny generator: with
    the pose statistics of speaker noah's train split (not those the
    harness would compute for oliver), with those a2m's harness computes
    for oliver, and without statistics."""
    from a2m.data import DataLoader, get_mean_std_necksub
    rng = np.random.default_rng(5)
    model = JaxGenerator(JaxGeneratorConfig(**TINY_G))
    variables = jax.eval_shape(model.init, {'params': jax.random.PRNGKey(0),
                                            'dropout': jax.random.PRNGKey(0)},
                               np.zeros((1, 64, 128), np.float32))
    tree = unflatten(randomize(variables, rng))
    out = tmp_path_factory.mktemp('npz')
    best = dict(params=tree['params'], batch_stats=tree['batch_stats'])
    files = {'none': jckpt.save_best_generator_npz(best, out / 'none.npz')}
    for speaker in ('noah', 'oliver'):
        # the loader a2m's harness builds (harness.py:45-48)
        train = DataLoader(path2data=pats_root, speaker=[speaker],
                           modalities=['pose/data', 'audio/log_mel_512'],
                           fs_new=[15, 15], batch_size=8, window_hop=5,
                           shuffle=False, use_pallas=False).train
        mean, std = get_mean_std_necksub(train)
        files[speaker] = jckpt.save_best_generator_npz(
            dict(best, mean=mean, std=std), out / f'{speaker}.npz')
    return files


def _port(pats_root, path, **kw):
    return evaluate_speaker(pats_root, 'oliver', path, batch_size=8,
                            alpha=ALPHAS,
                            cfg=Config(generator=GeneratorConfig(**TINY_G)),
                            device='cpu', **kw)


def test_harness_matches_a2m(pats_root, npz, monkeypatch):
    """Statistics shipped in the file (speaker noah's): the port neither
    recomputes them nor differs from a2m beyond the stated tolerances."""
    ref = jax_evaluate_speaker(
        pats_root, 'oliver', npz['noah'], batch_size=8, alpha=ALPHAS,
        cfg=JaxConfig(generator=JaxGeneratorConfig(**TINY_G)))

    def no_recompute(*a, **k):
        raise AssertionError('the harness recomputed the statistics the '
                             'checkpoint ships')

    monkeypatch.setattr(harness, 'get_mean_std_necksub', no_recompute)
    got = _port(pats_root, npz['noah'])
    assert got['n_clips'] == ref['n_clips'] == 12
    assert got['pck_alpha'] == ref['pck_alpha'] == 0.2
    assert set(got['pck_by_alpha']) == set(ref['pck_by_alpha'])
    for a, v in ref['pck_by_alpha'].items():
        assert abs(got['pck_by_alpha'][a] - v) <= 1e-4, (a, got, ref)
    assert 0.0 < ref['pck'] < 1.0              # not a degenerate score
    assert got['pck'] == got['pck_by_alpha']['0.2']
    assert abs(got['l2'] - ref['l2']) <= 1e-5 * ref['l2'], (got, ref)


def test_harness_recomputes_the_stats_a2ms_would(pats_root, npz):
    """Without statistics in the file the port takes them from the
    loader's train split, exactly the ones a2m's harness computes: the
    scores equal those of the file that ships a2m's (which the test above
    holds to a2m)."""
    got = _port(pats_root, npz['none'])
    want = _port(pats_root, npz['oliver'])
    assert got == want
    assert got != _port(pats_root, npz['noah'])


def test_harness_takes_a_loader_and_needs_cuda_by_default(pats_root, npz,
                                                           tmp_path,
                                                           monkeypatch):
    from a2m_torch.data import DataLoader
    test = DataLoader(path2data=pats_root, speaker=['oliver'], batch_size=8,
                      window_hop=5, shuffle=False, device='cpu').test

    class NoTrain:
        def __iter__(self):
            raise AssertionError('read the train split')

    loader = SimpleNamespace(train=NoTrain(), test=test)
    cfg = Config(generator=GeneratorConfig(**TINY_G))
    got = evaluate_speaker(None, 'oliver', npz['noah'], alpha=0.1,
                           cfg=cfg, device='cpu', loader=loader,
                           max_batches=1)
    assert got['n_clips'] == 8 and list(got['pck_by_alpha']) == ['0.1']
    assert np.isfinite(got['l2'])
    # render_sample_to hands the same loader and device to the sample
    # video (drawn and held to a2m's by tests/test_torch_viz.py)
    from a2m_torch.viz import generate_video
    calls = []

    def fake_render(*args, **kwargs):
        calls.append((args, kwargs))
        return dict(video='sample.gif', pck_mean=0.5)

    monkeypatch.setattr(generate_video, 'run', fake_render)
    got = evaluate_speaker(None, 'oliver', npz['noah'], cfg=cfg,
                           device='cpu', loader=loader, max_batches=1,
                           render_sample_to=tmp_path)
    assert got['video'] == 'sample.gif'
    (args, kwargs), = calls
    assert args == (None, 'oliver', npz['noah'], tmp_path)
    assert kwargs['loader'] is loader and kwargs['device'] == 'cpu'
    assert kwargs['cfg'] is cfg
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            evaluate_speaker(None, 'oliver', npz['noah'], loader=loader)


def test_det_fixture_in_memory_is_the_goldens_tree(tmp_path):
    """The card rebuilds the golden's fixture in memory
    (``synthetic_loader``); its test batches are a2m's loader's over the
    files a2m writes, bit for bit."""
    from a2m.data import DataLoader, make_synthetic_pats
    from a2m_torch.data.synthetic import synthetic_loader
    golden = json.loads(GOLDEN.read_text())
    recipe = golden['recipe']
    assert recipe == DET_RECIPE
    fixture = {k: recipe[k] for k in ('speakers', 'intervals_per_speaker',
                                      'duration_s', 'seed', 'deterministic',
                                      'splits')}
    root = make_synthetic_pats(tmp_path, **fixture)
    ref = DataLoader(path2data=root, speaker=[recipe['speaker']],
                     batch_size=recipe['batch_size'],
                     window_hop=recipe['window_hop'], shuffle=False,
                     use_pallas=False).test
    got = synthetic_loader(**fixture, batch_size=recipe['batch_size'],
                           window_hop=recipe['window_hop']).test
    n = 0
    for g, r in zip(got, ref, strict=True):
        for key in ('audio/log_mel_512', 'pose/data', 'mask'):
            np.testing.assert_array_equal(g[key], r[key])
        n += int(g['mask'].sum())
    assert n == golden['n_clips'] == 348


def test_synthetic_loader_is_the_data_loader(tmp_path):
    """Every split of the in-memory fixture, two speakers (style ids) and
    a shuffled train split, equals the port's DataLoader over the files."""
    from a2m_torch.data import DataLoader, make_synthetic_pats
    from a2m_torch.data.synthetic import synthetic_loader
    kw = dict(speakers=('oliver', 'noah'), intervals_per_speaker=5,
              duration_s=10.0, seed=3,
              splits=('train', 'train', 'train', 'dev', 'test'))
    root = make_synthetic_pats(tmp_path, **kw)
    ref = DataLoader(path2data=root, speaker=list(kw['speakers']),
                     batch_size=8, window_hop=5, seed=3, device='cpu')
    got = synthetic_loader(**kw, batch_size=8, window_hop=5)
    for split in ('train', 'dev', 'test'):
        batches = list(zip(getattr(got, split), getattr(ref, split),
                           strict=True))
        assert len(batches) > 1
        for g, r in batches:
            assert g.keys() == r.keys()
            for key in g.keys() - {'meta'}:
                np.testing.assert_array_equal(g[key], r[key])
            assert g['meta'] == r['meta']


def make_golden(tmp_path) -> dict:
    """a2m's harness on the flagship over the det fixture, on the CPU."""
    from a2m.data import make_synthetic_pats
    fixture = {k: DET_RECIPE[k] for k in (
        'speakers', 'intervals_per_speaker', 'duration_s', 'seed',
        'deterministic', 'splits')}
    root = make_synthetic_pats(Path(tmp_path), **fixture)
    out = jax_evaluate_speaker(root, DET_RECIPE['speaker'],
                               ROOT / DET_RECIPE['ckpt'],
                               batch_size=DET_RECIPE['batch_size'],
                               alpha=ALPHAS)
    return dict(n_clips=out['n_clips'], pck_by_alpha=out['pck_by_alpha'],
                l2=out['l2'], recipe=DET_RECIPE)


@pytest.mark.slow
def test_golden_file_matches_jax(tmp_path):
    golden = json.loads(GOLDEN.read_text())
    fresh = make_golden(tmp_path)
    assert fresh['n_clips'] == golden['n_clips']
    for a, v in golden['pck_by_alpha'].items():
        assert abs(fresh['pck_by_alpha'][a] - v) <= 1e-6
    assert abs(fresh['l2'] - golden['l2']) <= 1e-6 * golden['l2']


if __name__ == '__main__':
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        GOLDEN.write_text(json.dumps(make_golden(tmp), indent=1) + '\n')
