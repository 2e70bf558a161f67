"""Tests of the benchmark harness, on the CPU at tiny sizes.

Each test that runs a cell copies ``benchmark/`` and ``BENCHMARK.json``
into a temporary tree, adds tiny configurations and cells there as files of
their own (the way a later change adds them), writes seeded tiny weights,
and runs ``run.main`` in a fresh process with the CPU as its device.  Tests
that need the card carry the ``chip`` marker and skip themselves where
there is none.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_GEN = dict(time_steps=64, in_channels=16, out_channels=16,
                out_feats=104, body_feats=20, num_body_joints=10,
                num_hand_joints=42, joint_feat_dim=8, dropout=0.2,
                gat_heads=2)
VOICE = {'f0_hz': [90.0, 260.0], 'harmonics': 4, 'syllable_hz': [3.0, 6.0],
         'noise': 0.05, 'peak': [0.2, 0.9]}


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'chip: needs a CUDA card; skips itself without one')


def tiny_cells() -> dict:
    """Tiny cells of each driver: name -> (config, workload file, the
    real cell it shrinks)."""
    base = json.loads((BENCH / 'configs' / 'flagship_gen.json').read_text())
    gen = dict(base, name='tiny_gen', generator=TINY_GEN,
               weights='tiny_gen.npz')
    gan = json.loads((BENCH / 'configs' / 'flagship_gan.json').read_text())
    gan = dict(gan, name='tiny_gan', generator=TINY_GEN,
               weights='tiny_gen.npz',
               train=dict(gan['train'], batch_size=4))
    stream = json.loads((BENCH / 'workloads' /
                         'stream_8x60.json').read_text())
    stream.update(name='tiny_stream', config='tiny_gen', trace_seconds=0.2,
                  traffic=dict(stream['traffic'], streams=2, seconds=6,
                               pool=2, compared_calls=3, voice=VOICE))
    window = json.loads((BENCH / 'workloads' /
                         'window_b128.json').read_text())
    window.update(name='tiny_window', config='tiny_gen', trace_seconds=0.2,
                  traffic=dict(window['traffic'], batch=3, pool=2,
                               compared_calls=3, voice=VOICE))
    train = json.loads((BENCH / 'workloads' /
                        'train_b128.json').read_text())
    train.update(name='tiny_train', config='tiny_gan', trace_seconds=0.2,
                 traffic=dict(train['traffic'], batch=4, batches=2,
                              voice=VOICE))
    return {'tiny_stream': (gen, stream, 'stream_8x60'),
            'tiny_window': (gen, window, 'window_b128'),
            'tiny_train': (gan, train, 'train_b128')}


def write_tiny_weights(path: Path, seed: int = 0) -> None:
    """A seeded tiny generator in a2m's packed ``.npz`` layout, with pose
    statistics (written through the program's own exporter)."""
    import numpy as np
    import torch

    from a2m_torch.config import GeneratorConfig
    from a2m_torch.models.generator import Generator
    from a2m_torch.weights import to_jax_variables
    torch.manual_seed(seed)
    flat = to_jax_variables(Generator(GeneratorConfig(**TINY_GEN)))
    rng = np.random.default_rng(seed)
    flat['stats/mean'] = rng.normal(0, 5, 104).astype(np.float32)
    flat['stats/std'] = rng.uniform(5, 20, 104).astype(np.float32)
    np.savez(path, **flat)


def build_tiny_tree(root: Path) -> Path:
    """A copy of the benchmark under ``root`` with the tiny cells added as
    new files."""
    shutil.copytree(BENCH, root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(REPO / 'BENCHMARK.json', root / 'BENCHMARK.json')
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    for name, (config, cell, real_name) in tiny_cells().items():
        (root / 'benchmark' / 'configs' / f'{config["name"]}.json'
         ).write_text(json.dumps(config))
        (root / 'benchmark' / 'workloads' / f'{name}.json'
         ).write_text(json.dumps(cell))
        real = next(w for w in spec['workloads'] if w['name'] == real_name)
        spec['workloads'].append(dict(real, name=name, traffic=name,
                                      config=config['name']))
        for kind in ('end_to_end', 'per_layer'):
            for m in spec[kind]:
                if real['name'] in m.get('workloads', ()):
                    m['workloads'].append(name)
    # a per-layer metric added as a file of its own and an entry
    (root / 'benchmark' / 'metrics' / 'traced_calls.serve.py').write_text(
        'def read(run):\n    return float(run.trace.calls)\n')
    spec['per_layer'].append(dict(
        name='traced_calls.serve', unit='calls', better='higher',
        source='program_counter', layer='window entry',
        moves='audio_s_per_s', workloads=['tiny_window']))
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    write_tiny_weights(root / 'tiny_gen.npz')
    return root


@pytest.fixture(scope='session')
def tiny_tree(tmp_path_factory) -> Path:
    return build_tiny_tree(tmp_path_factory.mktemp('bench_tree'))


#: run one cell in a fresh process, with ``PATCH`` (Python source) applied
#: to the program first: the way a test plants a fault under the timed path
RUNNER = """
import json, sys
sys.path.insert(0, 'benchmark')
{patch}
import run
run.main({argv!r}, device='cpu')
"""


def run_process(tree: Path, cell: str, seed: int = 1234567891011,
                trace: int = 0, seconds: float = 0.3, patch: str = ''
                ) -> subprocess.CompletedProcess:
    """One CPU run of ``cell`` in a fresh process, as it ended."""
    argv = ['--workload', cell, '--seed', str(seed), '--seconds',
            str(seconds), '--trace', str(trace)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='2')
    return subprocess.run(
        [sys.executable, '-c', RUNNER.format(patch=patch, argv=argv)],
        cwd=tree, env=env, capture_output=True, text=True, timeout=600)


def run_cell(tree: Path, cell: str, **kw) -> tuple[dict, str]:
    """(the result line, standard error) of one CPU run of ``cell``."""
    proc = run_process(tree, cell, **kw)
    if proc.returncode:
        raise AssertionError(f'run failed ({proc.returncode}):\n'
                             f'{proc.stderr[-4000:]}')
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr
