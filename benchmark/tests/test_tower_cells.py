"""The two cells of the speech tower and of unequal streams, on the CPU at
tiny sizes: ``wavlm_stream_8x60`` (driver ``tower_stream``) with a tower of
d = 64, 2 layers, and ``stream_mixed_16`` (driver ``stream_mixed``) with
four short streams, each added to a copy of the benchmark as files of its
own; a sound run is correct, traced runs report the new per-layer metrics,
and a fault planted in the tower makes the run incorrect."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, REPO, TINY_GEN, VOICE, build_tiny_tree, run_cell

TINY_TOWER = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=128, conv_dim=[32] * 7,
                  conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                  conv_stride=[5, 2, 2, 2, 2, 2, 2], conv_bias=False,
                  num_conv_pos_embeddings=16,
                  num_conv_pos_embedding_groups=4, num_buckets=320,
                  max_bucket_distance=800, layer_norm_eps=1e-5,
                  sample_rate=16000)


@pytest.fixture(scope='module')
def tower_tree(tmp_path_factory):
    root = build_tiny_tree(tmp_path_factory.mktemp('tower_tree'))
    base = json.loads((BENCH / 'configs' / 'wavlm_large_gen.json')
                      .read_text())
    config = dict(base, name='tiny_wavlm', generator=TINY_GEN,
                  tower=TINY_TOWER, weights='tiny_gen.npz')
    (root / 'benchmark' / 'configs' / 'tiny_wavlm.json').write_text(
        json.dumps(config))
    tower = json.loads((BENCH / 'workloads' / 'wavlm_stream_8x60.json')
                       .read_text())
    tower.update(name='tiny_tower', config='tiny_wavlm', trace_seconds=0.2,
                 traffic=dict(tower['traffic'], streams=2, seconds=5,
                              pool=2, compared_calls=3, voice=VOICE))
    mixed = json.loads((BENCH / 'workloads' / 'stream_mixed_16.json')
                       .read_text())
    mixed.update(name='tiny_mixed', config='tiny_gen', trace_seconds=0.2,
                 traffic=dict(mixed['traffic'], seconds=[5.0, 6.1, 8.1],
                              pool=2, compared_calls=3, voice=VOICE))
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    spec['configs'].append(dict(spec['configs'][0], name='tiny_wavlm',
                                file='benchmark/configs/tiny_wavlm.json'))
    for name, cell, real in (('tiny_tower', tower, 'wavlm_stream_8x60'),
                             ('tiny_mixed', mixed, 'stream_mixed_16')):
        (root / 'benchmark' / 'workloads' / f'{name}.json').write_text(
            json.dumps(cell))
        entry = next(w for w in spec['workloads'] if w['name'] == real)
        spec['workloads'].append(dict(entry, name=name, traffic=name,
                                      config=cell['config']))
        for kind in ('end_to_end', 'per_layer'):
            for m in spec[kind]:
                if real in m.get('workloads', ()):
                    m['workloads'].append(name)
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize('cell', ['tiny_tower', 'tiny_mixed'])
def test_a_sound_run_is_correct(tower_tree, cell):
    result, err = run_cell(tower_tree, cell, seconds=0.5)
    assert result['correct'], err[-2000:]
    assert {'audio_s_per_s', 'call_p95_ms', 'setup_s'} <= set(
        result['metrics'])


def test_a_traced_tower_run_reports_the_towers_metrics(tower_tree):
    result, err = run_cell(tower_tree, 'tiny_tower', trace=1, seconds=0.5)
    assert result['correct'], err[-2000:]
    metrics = result['metrics']
    assert metrics['tower_issue_ms.serve']['value'] > 0
    assert 'mfu.serve' in metrics and 'idle_share.serve' in metrics
    # on the CPU no kernel runs: K6's readers find nothing and say so
    assert 'k6_roofline.serve' not in metrics
    assert set(result['checks']) == {'rms_gap', 'feat_gap'}


FP8_TOWER = """
import torch
from a2m_torch.nn import wavlm as _w
_w.SpeechTower.operand = lambda self, x: x.to(torch.float8_e4m3fn).to(
    torch.bfloat16)
"""


def test_fp8_operands_in_the_tower_make_the_run_incorrect(tower_tree):
    result, err = run_cell(tower_tree, 'tiny_tower', patch=FP8_TOWER,
                           seconds=0.5)
    assert result['correct'] is False, err[-2000:]
    assert result['checks']['feat_gap']['value'] > \
        result['checks']['feat_gap']['limit']


RESEED = """
import json, sys
import torch
sys.path.insert(0, 'benchmark')
import harness
cell = harness.load_json('workloads', 'tiny_tower')
config = harness.load_json('configs', cell['config'])
driver = harness.load_module('drivers', cell['driver']).Driver(
    config, cell['traffic'], 11, torch.device('cpu'))
before = driver.tower.join.weight.clone()
driver.reseed(12)
driver.call()
driver.reference_tower()
after = driver.tower.join.weight
print(json.dumps(dict(changed=not torch.equal(before, after),
                      drawn=torch.equal(after, driver._state['join.weight']),
                      gaps=driver.verify())))
"""


def test_a_reseed_draws_the_tower_anew_for_program_and_reference(
        tower_tree):
    """``control_readings.py`` reseeds one driver: each seed's readings
    must come from that seed's weights, on both sides."""
    proc = subprocess.run(
        [sys.executable, '-c', RESEED], cwd=tower_tree, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='2'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    limits = json.loads((tower_tree / 'benchmark' / 'workloads' /
                         'tiny_tower.json').read_text())['limits']
    assert got['changed'] and got['drawn']
    assert all(got['gaps'][k] <= v for k, v in limits.items())
