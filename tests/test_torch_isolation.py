"""a2m_torch stands alone: it imports with ``jax`` blocked, loads no a2m
module, and its CUDA entry points raise when CUDA is absent."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r'''
import importlib, pkgutil, sys
sys.modules['jax'] = None            # any "import jax" now raises
import a2m_torch
for info in pkgutil.walk_packages(a2m_torch.__path__, 'a2m_torch.'):
    importlib.import_module(info.name)
loaded = sorted(m for m in sys.modules if m == 'a2m' or m.startswith('a2m.'))
assert not loaded, loaded
from a2m_torch.pipeline import build_pipeline, build_trainer, entry
for name in ('a2m_torch.models.discriminator', 'a2m_torch.models.losses',
             'a2m_torch.eval.metrics', 'a2m_torch.train.controller',
             'a2m_torch.train.train_step', 'a2m_torch.train.loop'):
    assert name in sys.modules, name
for call in (build_pipeline, build_trainer, entry):
    try:
        call()
    except RuntimeError as e:
        assert 'CUDA is not available' in str(e), e
    else:
        raise AssertionError(f'{call.__name__}() ran without CUDA')
print('isolated')
'''


def test_imports_without_jax_or_a2m_and_needs_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='',
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('isolated')


def test_sources_name_neither_jax_nor_a2m():
    for path in (ROOT / 'a2m_torch').rglob('*.py'):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (['import'], ['from'])
                        and words[1].split('.')[0] in ('jax', 'a2m')), \
                f'{path}: {line}'
