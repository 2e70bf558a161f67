"""a2m_torch stands alone: it imports with ``jax`` blocked, loads no a2m
module, and its CUDA entry points raise when CUDA is absent; every module
also imports with ``jax``, ``h5py`` and ``pandas`` all blocked, as on a
machine with the card, which has neither of the last two."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r'''
import importlib, pkgutil, sys, tempfile
sys.modules['jax'] = None            # any "import jax" now raises
import a2m_torch
for info in pkgutil.walk_packages(a2m_torch.__path__, 'a2m_torch.'):
    importlib.import_module(info.name)
loaded = sorted(m for m in sys.modules if m == 'a2m' or m.startswith('a2m.'))
assert not loaded, loaded
from a2m_torch.pipeline import (build_pipeline, build_server, build_trainer,
                                entry)
for name in ('a2m_torch.models.discriminator', 'a2m_torch.models.losses',
             'a2m_torch.eval.metrics', 'a2m_torch.train.controller',
             'a2m_torch.train.train_step', 'a2m_torch.train.loop',
             'a2m_torch.eval.streaming', 'a2m_torch.audio.frontend',
             'a2m_torch.audio.mel_np', 'a2m_torch.nn.gcn_kernel',
             'a2m_torch.data', 'a2m_torch.data.dataset',
             'a2m_torch.data.hdf5_io', 'a2m_torch.data.modalities',
             'a2m_torch.data.normalization', 'a2m_torch.data.synthetic',
             'a2m_torch.data.windowing', 'a2m_torch.audio.io',
             'a2m_torch.audio.vad', 'a2m_torch.parallel.mesh',
             'a2m_torch.parallel.launch', 'a2m_torch.device'):
    assert name in sys.modules, name
from a2m_torch.audio import frontend
from a2m_torch.eval import streaming
for fn in ('spec_log_mel_400', 'spec_vggish', 'frame_for_wire',
           'log_mel_frames', 'num_frames'):
    assert callable(getattr(frontend, fn)), fn
for fn in ('window_starts', 'blend', 'stream_poses', 'stream_poses_multi',
           'encode_ulaw', 'decode_ulaw', 'frame_streams_for_wire',
           'stream_from_waveform', 'stream_from_waveforms'):
    assert callable(getattr(streaming, fn)), fn
from a2m_torch.audio import io
from a2m_torch.data import Audio, DataLoader
root = tempfile.mkdtemp()
for call in (build_pipeline, build_server, build_trainer, entry,
             lambda: build_trainer(path2data=root),
             lambda: io.wav_to_features(root + '/none.wav'),
             lambda: Audio(path2data=root),
             lambda: DataLoader(path2data=root, speaker='oliver')):
    try:
        call()
    except RuntimeError as e:
        assert 'CUDA is not available' in str(e), e
    else:
        raise AssertionError(f'{call} ran without CUDA')
print('isolated')
'''

# the card machine has no h5py and no pandas: every module imports without
# them (and without jax), and the numpy/torch parts of the data path run
CARD_PROBE = r'''
import importlib, pkgutil, sys
for name in ('jax', 'h5py', 'pandas'):
    sys.modules[name] = None
import a2m_torch
for info in pkgutil.walk_packages(a2m_torch.__path__, 'a2m_torch.'):
    importlib.import_module(info.name)
import numpy as np
from a2m_torch.data import Batcher, RandomSampler, get_mean_std_necksub
from a2m_torch.data.synthetic import synth_pose
from a2m_torch.data.windowing import window_index
pose = synth_pose(900, np.random.default_rng(0)).astype(np.float32)
w = window_index(len(pose), 15, 15, 4.3, window_hop=5)
items = [{'pose/data': w.slice(pose, k)} for k in range(len(w))]
mean, std = get_mean_std_necksub(Batcher(items, 16, RandomSampler(len(w))))
assert mean.shape == std.shape == (104,)
try:
    from a2m_torch.data import read_master_csv
    read_master_csv('.')
except ImportError:
    pass
else:
    raise AssertionError('pandas was blocked')
print('card-ready')
'''


def test_imports_without_jax_or_a2m_and_needs_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='',
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('isolated')


def test_imports_without_h5py_pandas_or_jax():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', CARD_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('card-ready')


def test_sources_name_neither_jax_nor_a2m():
    for path in (ROOT / 'a2m_torch').rglob('*.py'):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (['import'], ['from'])
                        and words[1].split('.')[0] in ('jax', 'a2m')), \
                f'{path}: {line}'


def test_config_declares_the_edge_form_switch():
    """No TPU kernel is out of scope: the edge-form switch exists, and the
    config's docstring does not say otherwise."""
    sys.path.insert(0, str(ROOT))
    from a2m_torch import config
    assert config.GeneratorConfig().fused_edge is False
    assert config.GeneratorConfig(fused_edge=True).fused_edge is True
    doc = ' '.join(config.__doc__.split())
    assert 'fused_edge' in doc
    assert 'edge-form switches) have no counterpart' not in doc
    assert not hasattr(config.GeneratorConfig(), 'fused_tile')


# the modules of the migration, rendering and benchmark slice import with
# jax, h5py, pandas, matplotlib and PIL all blocked (the card's machine may
# lack matplotlib and PIL); drawing then raises, nothing else needs them
VIEW_PROBE = r'''
import importlib, pkgutil, sys
for name in ('jax', 'flax', 'orbax', 'h5py', 'pandas', 'matplotlib', 'PIL'):
    sys.modules[name] = None
import a2m_torch
for info in pkgutil.walk_packages(a2m_torch.__path__, 'a2m_torch.'):
    importlib.import_module(info.name)
for name in ('a2m_torch.compat', 'a2m_torch.compat.torch_import',
             'a2m_torch.compat.__main__', 'a2m_torch.viz',
             'a2m_torch.viz.render', 'a2m_torch.viz.generate_video',
             'a2m_torch.data.pose_codec', 'a2m_torch.data.diagnose',
             'a2m_torch.eval.benchmarks'):
    importlib.import_module(name)
loaded = sorted(m for m, mod in sys.modules.items()
                if m.split('.')[0] in ('a2m', 'jax') and mod is not None)
assert not loaded, loaded
import numpy as np, torch
from a2m_torch.audio.frontend import silence_mask
from a2m_torch.data.pose_codec import SpeakerStats
from a2m_torch.eval import benchmarks
from a2m_torch.viz import render
assert silence_mask(torch.zeros(16000)).shape == (28,)
assert SpeakerStats.load_legacy().stats
assert benchmarks._can_draw() is False
try:
    render.draw_pose(np.zeros((2, 52)))
except ImportError:
    pass
else:
    raise AssertionError('matplotlib was blocked')
print('drawless')
'''


def test_new_modules_import_without_matplotlib_or_pil():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', VIEW_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('drawless')


def test_migration_viz_and_benchmarks_name_no_reference_package():
    """No line of a2m_torch/compat, a2m_torch/viz or
    a2m_torch/eval/benchmarks.py imports a2m, jax, flax or orbax, at module
    level or inside a function."""
    pkg = ROOT / 'a2m_torch'
    paths = [*(pkg / 'compat').glob('*.py'), *(pkg / 'viz').glob('*.py'),
             pkg / 'eval' / 'benchmarks.py']
    assert len(paths) == 7
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (['import'], ['from'])
                        and words[1].split('.')[0] in ('a2m', 'jax', 'flax',
                                                       'orbax')), \
                f'{path}: {line}'
