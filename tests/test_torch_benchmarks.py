"""The port's benchmark CLI (a2m_torch/eval/benchmarks.py) on the CPU.

Each of a2m's six configs runs through the port at a small size and
reports a2m's keys: config 1's exact-mode log-mel within 1e-5 of the
float64 golden; config 2 at B = 2; config 3 at B = 2 for one timed step
with finite losses; configs 4 and 5 at a2m's tiny widths (F = 8, H = 2),
the flagship row of 5 left out (``_flagship_checkpoint`` patched to
``(None, None)``: the card runs it, ``chip_smoke.py`` phase 14); config 6
on 8 streams of 2.2 s (one window each).  Configs 1, 3 and 6 build
a2m's full-width models; here they build the tiny ones of configs 4 and
5 (``tiny_widths``), since what they check here (the log-mel's parity,
finite losses, every wire format's shapes) does not depend on the width,
and the card runs them at full width (``chip_smoke.py`` phase 14).
Config 4's in-memory fixture (``synthetic_loader(style_iters=4)``) gives
a2m's ``DataLoader(style_iters=4)`` batches over the files, bit for bit.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch

from a2m_torch.config import DiscriminatorConfig, GeneratorConfig
from a2m_torch.eval import benchmarks

PARITY_TOL = 1e-5
TINY_G = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2)
TINY_D = dict(out_channels=8, joint_feat_dim=8, gat_heads=2)


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_widths(monkeypatch):
    """``GeneratorConfig()`` and ``DiscriminatorConfig()`` in the configs
    give the tiny widths; arguments a config passes still win."""
    monkeypatch.setattr(benchmarks, 'GeneratorConfig',
                        functools.partial(GeneratorConfig, **TINY_G))
    monkeypatch.setattr(benchmarks, 'DiscriminatorConfig',
                        functools.partial(DiscriminatorConfig, **TINY_D))


def test_config1_single_clip_parity(tiny_widths):
    res = benchmarks.config1_single_clip(device='cpu')
    assert res['config'] == 'single_clip'
    assert res['logmel_max_abs_err_vs_float64'] <= PARITY_TOL
    assert res['parity_target'] == PARITY_TOL
    assert res['forward_ms'] > 0 and res['realtime_factor'] > 0


def test_config2_and_the_cli(tmp_path, monkeypatch, capsys):
    """Config 2 at B = 2 through ``main``: one JSON line a config, the
    ``--out`` file, and no kernel launch on the CPU."""
    monkeypatch.setitem(benchmarks.ALL, 2, functools.partial(
        benchmarks.config2_batched_features, batch=2))
    out = tmp_path / 'bench.json'
    results = benchmarks.main(['--configs', '2', '--device', 'cpu',
                               '--out', str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == results == [line]
    assert line['config'] == 'batched_features' and line['batch'] == 2
    assert line['kernel_realtime_factor'] > 0
    assert line['kernel_calls'] == 11
    assert set(line['launches']) == {'log_mel', 'log_mel_exact', 'gcn_stack',
                                     'gcn_stack_fwd', 'gcn_stack_bwd',
                                     'gcn_stack_edge'}
    assert not any(line['launches'].values())


def test_config3_train_step(tiny_widths):
    res = benchmarks.config3_train_step(batch=2, steps=1, device='cpu')
    assert res['g_loss_finite'] and res['d_loss_finite']
    assert res['g_step_ms'] > 0 and res['d_step_ms'] > 0
    assert (res['g_steps'], res['d_steps']) == (2, 2)
    bf16 = benchmarks.config3_train_step(batch=2, steps=1,
                                         compute_dtype='bf16', device='cpu')
    assert bf16['dtype'] == 'bf16'
    assert bf16['g_loss_finite'] and bf16['d_loss_finite']
    with pytest.raises(ValueError, match='compute_dtype'):
        benchmarks.config3_train_step(batch=2, steps=1, compute_dtype='fp16',
                                      device='cpu')


def test_config4_fixture_is_a2ms_loader(tmp_path):
    """``synthetic_loader(style_iters=4)``: a2m's alternating speaker
    sampler over its files, bit for bit (train, dev)."""
    from a2m.data import DataLoader, make_synthetic_pats
    from a2m_torch.data.synthetic import synthetic_loader
    speakers = ('oliver', 'noah', 'seth')
    root = make_synthetic_pats(tmp_path, speakers=speakers,
                               intervals_per_speaker=4, duration_s=12.0)
    ref = DataLoader(path2data=root, speaker=list(speakers),
                     modalities=['pose/data', 'audio/log_mel_512'],
                     fs_new=[15, 15], batch_size=16, window_hop=10,
                     style_iters=4, use_pallas=False)
    got = synthetic_loader(speakers=speakers, intervals_per_speaker=4,
                           duration_s=12.0, batch_size=16, window_hop=10,
                           style_iters=4)
    for split in ('train', 'dev'):
        a, b = list(getattr(got, split)), list(getattr(ref, split))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            for k in ('pose/data', 'audio/log_mel_512', 'style', 'mask'):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_config4_multi_speaker():
    res = benchmarks.config4_multi_speaker(device='cpu')
    assert res['config'] == 'multi_speaker_training'
    assert res['styles_used'] and res['speaker_stats_computed']
    assert res['n_speakers'] == 3 and np.isfinite(res['val_g'])


def test_config5_e2e_eval(monkeypatch):
    """The tiny pipeline row without its video (the harness's video is
    held by tests/test_torch_viz.py) and without the flagship row."""
    monkeypatch.setattr(benchmarks, '_flagship_checkpoint',
                        lambda: (None, None))
    monkeypatch.setattr(benchmarks, '_can_draw', lambda: False)
    res = benchmarks.config5_e2e_eval(device='cpu')
    assert res['config'] == 'e2e_eval' and res['rendered'] is False
    assert res['n_clips'] == 23 and 'video' not in res
    assert 0.0 <= res['pck'] <= 1.0 and np.isfinite(res['l2'])
    assert 'flagship' not in res


def test_config6_streaming(tiny_widths):
    res = benchmarks.config6_streaming(seconds=2.2, device='cpu')
    assert res['pose_frames'] == 33 and res['multi_streams_ok']
    assert res['compile_cached']
    assert set(res['multi_wire']) == {'f32', 'int16', 'ulaw8', 'int16_g2',
                                      'ulaw8_framed', 'ulaw8_framed_g2'}
    assert res['multi_device_pose_shape'] == [8, 33, 104]
    assert res['multi_device_aggregate_realtime'] > 0
