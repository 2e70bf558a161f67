"""The benchmark's own tests, on the CPU: its files found by name, a cell
added as files of its own, the frozen yardstick against the program's cost
functions, the plain reference against the program's eager path, the
imports of a run, the trace reduction, and ``correct`` coming out false
under each fault planted beneath the timed path."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO, TINY_GEN, run_cell, run_process

sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(REPO))

import harness  # noqa: E402
import yardstick  # noqa: E402
from reference import audio2motion as ref  # noqa: E402

SPEC = json.loads((REPO / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


# -- files found by name -----------------------------------------------------

@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_cell_files_load_by_name(cell):
    entry = next(w for w in SPEC['workloads'] if w['name'] == cell)
    workload = harness.load_json('workloads', entry['traffic'])
    assert workload['config'] == entry['config']
    assert workload['chips'] == entry['chips'] == 1
    config = harness.load_json('configs', entry['config'])
    assert config['name'] == entry['config']
    assert hasattr(harness.load_module('drivers', workload['driver']),
                   'Driver')
    for kind in ('end_to_end', 'per_layer'):
        names = [m['name'] for m in harness.cell_metrics(SPEC, cell, kind)]
        assert names, kind
        for name in names:
            assert callable(harness.load_module('metrics', name).read)


def test_spec_follows_its_contract():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in SPEC['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert (REPO / c['file']).is_file()
    e2e = {m['name'] for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e
    for m in SPEC['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in (
            'host_clock', 'device_trace')
    for m in SPEC['per_layer']:
        assert m['moves'] in e2e and 'bound' not in m
        for cell in m['workloads']:
            moved = next(x for x in SPEC['end_to_end']
                         if x['name'] == m['moves'])
            assert cell in moved.get('workloads', [cell])


def test_a_new_cell_is_found_without_an_edit(tiny_tree):
    """The tiny cells, their configurations and a per-layer metric live
    only as files (and entries) added to a copy: each is found by name, and
    no file of the copy changed."""
    for name in ('tiny_stream', 'tiny_window', 'tiny_train'):
        assert (tiny_tree / 'benchmark' / 'workloads' /
                f'{name}.json').is_file()
    for path in (BENCH).rglob('*'):
        if path.is_file() and 'tests' not in path.parts and \
                '__pycache__' not in path.parts:
            copy = tiny_tree / 'benchmark' / path.relative_to(BENCH)
            assert copy.read_bytes() == path.read_bytes(), path


# -- the yardstick ------------------------------------------------------------

SHAPES = [('stream_8x60', 216 * 64), ('window_b128', 128 * 64),
          ('train_b128', 128 * 64)]


@pytest.mark.parametrize('cell,n', SHAPES)
def test_frozen_stack_costs_equal_the_programs(cell, n):
    from a2m_torch.nn import gcn_kernel as gk
    for adj in (ref.body_adjacency(), ref.hand_adjacency()):
        j = adj.shape[0]
        assert yardstick.stack_flops(n, adj, 64, 4) == gk.stack_flops(
            n, adj, 64, 4)
        assert yardstick.stack_bytes(n, j, 64, 4) == gk.stack_bytes(
            n, j, 64, 4)
        assert yardstick.stack_edge_bytes(n, adj, 64, 4) == \
            gk.stack_edge_bytes(n, adj, 64, 4)
        assert yardstick.stack_fwd_bytes(n, j, 64, 4) == \
            gk.stack_fwd_bytes(n, j, 64, 4)
        assert yardstick.stack_bwd_bytes(n, j, 64, 4) == \
            gk.stack_bwd_bytes(n, j, 64, 4)
        # the program's count holds the forward its kernel recomputes
        assert (yardstick.stack_bwd_flops(n, adj, 64, 4)
                + yardstick.stack_bwd_recompute_flops(n, adj, 64, 4)
                == gk.stack_bwd_flops(n, adj, 64, 4))


@pytest.mark.parametrize('batch,n_samples,frames', [
    (8, 2736000, 891), (128, 196080, 64)])
def test_frozen_log_mel_costs_equal_the_programs(batch, n_samples, frames):
    import common
    from a2m_torch.audio import frontend, mel_kernel
    from a2m_torch.pipeline import pose_rate_spec
    spec = pose_rate_spec()
    nnz = len(frontend.fft_tables(spec)['mel_weights'])
    assert common.mel_nnz() == nnz
    assert yardstick.log_mel_flops(batch, frames, 2048, nnz, 128) == \
        mel_kernel.log_mel_flops(batch, frames, 2048, nnz, 128)
    args = (batch, n_samples, frames, 2048, spec.hop_length, 2048, nnz, 128)
    assert yardstick.log_mel_bytes(*args) == mel_kernel.log_mel_bytes(*args)
    assert common.k2_cost(batch, n_samples, frames) == (
        mel_kernel.log_mel_flops(batch, frames, 2048, nnz, 128),
        mel_kernel.log_mel_bytes(*args))


def test_frozen_peaks_and_categories_equal_the_programs():
    from a2m_torch.utils import mfu, profiling
    assert yardstick.PEAK_FLOPS == {d: mfu.PEAK_FLOPS[('h100', d)]
                                    for d in ('bf16', 'f32')}
    assert yardstick.CATEGORIES == profiling.CATEGORIES


# -- the reference against the program's eager path ---------------------------

@pytest.fixture(scope='module')
def tiny_npz(tmp_path_factory):
    from conftest import write_tiny_weights
    path = tmp_path_factory.mktemp('w') / 'tiny.npz'
    write_tiny_weights(path, seed=3)
    return path


def _port_generator(npz, **kw):
    from a2m_torch.config import GeneratorConfig
    from a2m_torch.pipeline import load_generator
    return load_generator(npz, GeneratorConfig(**TINY_GEN, **kw), 'cpu')


def _ref_generator(npz, mode):
    gen = ref.Generator(TINY_GEN)
    flat, _ = ref.load_npz(npz)
    gen.load_state_dict(ref.state_from_flat(flat, gen))
    gen.set_stack_mode(mode)
    return gen.eval()


@pytest.mark.parametrize('mode,kw', [
    ('f32', {}), ('dense', {'fused_gcn': True}),
    ('edge', {'fused_gcn': True, 'fused_edge': True})])
def test_reference_generator_matches_the_programs(tiny_npz, mode, kw):
    torch.manual_seed(0)
    audio = torch.randn(3, 64, 128) * 3 - 8
    with torch.no_grad():
        got = _port_generator(tiny_npz, **kw)(audio)
        want = _ref_generator(tiny_npz, mode)(audio)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-5 * float(want.abs().max()))


def test_reference_log_mel_matches_the_programs():
    from a2m_torch.audio import frontend
    from a2m_torch.pipeline import pose_rate_spec
    import traffic
    voice = dict(f0_hz=[90.0, 260.0], harmonics=4, syllable_hz=[3.0, 6.0],
                 noise=0.05, peak=[0.2, 0.9])
    waves = traffic.speech_like(5, 2, 196080, 45600, voice, 'cpu')
    got = frontend.log_mel(waves, pose_rate_spec(), exact=False,
                           n_frames=64)
    want = ref.log_mel(waves, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3)


def test_reference_discriminator_matches_the_programs():
    from a2m_torch.models.discriminator import Discriminator
    cfg = json.loads((BENCH / 'configs' / 'flagship_gan.json').read_text())
    mine = ref.Discriminator(cfg['discriminator'])
    theirs = Discriminator()
    state = ref.seeded_state(mine, 9, 'cpu')
    mine.load_state_dict(state)
    theirs.load_state_dict(state)
    motion = torch.randn(4, 63, 104)
    with torch.no_grad():
        want = mine.eval()(motion)
        got, _ = theirs.eval()(motion)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# -- what a run imports -------------------------------------------------------

IMPORTS = """
import json, sys
sys.path[:0] = [{bench!r}, {repo!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level_after(body: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, '-c', IMPORTS.format(bench=str(BENCH),
                                              repo=str(REPO), body=body)],
        capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_neither_jax_nor_the_jax_package():
    body = ('import harness, run, common, traffic, yardstick\n'
            'for k, names in (("drivers", ("stream", "window", "train")),):\n'
            '    [harness.load_module(k, n) for n in names]\n'
            'from a2m_torch import pipeline\n'
            'from a2m_torch.eval import streaming\n'
            'from a2m_torch.train import loop\n'
            'import pathlib\n'
            'for p in pathlib.Path({bench!r}, "metrics").glob("*.py"):\n'
            '    harness.load_module("metrics", p.stem)\n'
            ).format(bench=str(BENCH))
    found = _top_level_after(body)
    assert not found & {'jax', 'jaxlib', 'flax', 'a2m'}, found
    assert 'a2m_torch' in found          # the whole-name rule at work


def test_the_reference_imports_nothing_of_the_program():
    found = _top_level_after('from reference import audio2motion')
    assert not found & {'jax', 'jaxlib', 'flax', 'a2m', 'a2m_torch'}, found


LATE_IMPORT = """
import types
import common
_verify = common.ServeDriver.verify
def verify(self):
    sys.modules.setdefault('jax', types.ModuleType('jax'))
    return _verify(self)
common.ServeDriver.verify = verify
"""


def test_a_module_of_jax_loaded_by_the_comparison_ends_the_run(tiny_tree):
    """The look at ``sys.modules`` comes after the reference and the
    comparison: JAX loaded inside ``verify`` leaves no result."""
    proc = run_process(tiny_tree, 'tiny_window', patch=LATE_IMPORT)
    assert proc.returncode != 0
    assert 'correct' not in proc.stdout
    assert 'jax' in proc.stderr.strip().splitlines()[-1]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'a2m_torch_fake', object())
    assert 'a2m_torch_fake' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'a2m.fake', object())
    assert harness.forbidden_modules() == ['a2m.fake']


# -- the trace reduction ------------------------------------------------------

def test_trace_reduction_takes_the_union_of_device_intervals():
    window = SimpleNamespace(work={'calls': 2}, calls=2)
    events = [('kern_a', 0.0, 2.0), ('kern_b', 1.0, 3.0),      # overlap
              ('Memcpy HtoD (Pinned -> Device)', 5.0, 6.0),
              ('conv_fprop', 8.0, 9.0), ('late', 11.0, 12.0)]
    spans = [('bench.serve', 0.0, 4.5), ('bench.serve', 4.5, 10.0)]
    t = harness.Trace(window, events, spans, 0.0, 10.0, yardstick.category)
    assert t.busy_s == pytest.approx(5.0)        # 3 + 1 + 1, not 2 + 2 ...
    assert t.kernels == 3
    assert t.category_s['convolution'] == pytest.approx(1.0)
    gaps = dict(t.breakdown()['idle_gaps'])
    assert gaps['bench.serve'] == pytest.approx(5.0)
    ops = dict(t.breakdown()['device_ops'])
    assert ops['kern_a'] == pytest.approx(2.0)


# -- runs, and faults planted beneath the timed path --------------------------

@pytest.mark.parametrize('cell', ['tiny_stream', 'tiny_window', 'tiny_train'])
def test_a_sound_run_is_correct(tiny_tree, cell):
    result, err = run_cell(tiny_tree, cell)
    assert result['correct'], err[-2000:]
    assert result['attempted'] >= 1
    assert list(result)[-1] == 'checks'
    assert err.strip().splitlines()[-1].startswith('check ')
    assert 'setup_s' in result['metrics']


def test_a_traced_run_reports_per_layer_metrics(tiny_tree):
    result, err = run_cell(tiny_tree, 'tiny_window', trace=1)
    assert result['correct'], err[-2000:]
    assert 'mfu.serve' in result['metrics']
    # the metric the copy added as a file of its own
    assert result['metrics']['traced_calls.serve']['value'] >= 1
    assert 'window_s' in result['device']
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}


ALTER_ANSWER = """
from a2m_torch.models import generator as _g
_forward = _g.Generator.forward
def forward(self, *a, **k):
    out = _forward(self, *a, **k)
    out = out.clone(); out[0, 0, 0] += 100.0
    return out
_g.Generator.forward = forward
"""

HALF_BATCH_SERVED = """
from a2m_torch.models import generator as _g
_forward = _g.Generator.forward
def forward(self, audio, *a, **k):
    half = max(1, audio.shape[0] // 2)
    out = _forward(self, audio[:half], *a, **k)
    rest = out.mean(0, keepdim=True).expand(audio.shape[0] - half,
                                            *out.shape[1:])
    return __import__('torch').cat([out, rest])
_g.Generator.forward = forward
"""

STATE_UNCHANGED = """
import torch
from a2m_torch.train import train_step as _ts
class _Still(torch.optim.Adam):
    def step(self, closure=None):
        return None
_ts.make_optimizer = lambda params, lr: _Still(params, lr=lr)
"""

HALF_BATCH_TRAINED = """
from a2m_torch.models import losses as _l
_mean = _l.masked_mean
def masked_mean(per_sample, mask):
    half = max(1, per_sample.shape[0] // 2)
    return _mean(per_sample[:half], None if mask is None else mask[:half])
_l.masked_mean = masked_mean
"""


HALF_BATCH_D = """
from a2m_torch.train import loop as _loop
_make = _loop.make_train_steps
def make_train_steps(*a, **k):
    g_step, d_step, eval_step = _make(*a, **k)
    def d_half(*args, mask=None, **kw):
        mask = mask.clone(); mask[mask.shape[0] // 2:] = 0
        return d_step(*args, mask=mask, **kw)
    return g_step, d_half, eval_step
_loop.make_train_steps = make_train_steps
"""

ALTER_K1 = """
from a2m_torch.nn import gcn_kernel as _gk
_k1 = _gk.gcn_stack
def gcn_stack(*a, **k):
    out = _k1(*a, **k).clone()
    out.view(-1)[0] += 100.0
    return out
gcn_stack.launches = _k1.launches
_gk.gcn_stack = gcn_stack
"""


@pytest.mark.parametrize('cell,fault', [
    ('tiny_stream', ALTER_ANSWER), ('tiny_stream', HALF_BATCH_SERVED),
    ('tiny_window', ALTER_ANSWER), ('tiny_window', HALF_BATCH_SERVED),
    ('tiny_train', STATE_UNCHANGED), ('tiny_train', HALF_BATCH_TRAINED),
    ('tiny_train', HALF_BATCH_D), ('tiny_train', ALTER_K1)],
    ids=['stream-answer', 'stream-half', 'window-answer', 'window-half',
         'train-still', 'train-half', 'train-half-d', 'train-k1-fake'])
def test_a_planted_fault_makes_the_run_incorrect(tiny_tree, cell, fault):
    result, err = run_cell(tiny_tree, cell, patch=fault)
    assert result['correct'] is False, err[-2000:]


OTHER_TRAINING = """
from a2m_torch import pipeline as _p
_train_config = _p.TrainConfig
_p.TrainConfig = lambda **k: _train_config(lambda_smooth=0.2, **k)
"""


def test_a_trainer_that_departs_from_the_configuration_ends_the_run(
        tiny_tree):
    """The program's trainer is held to the configuration file's blocks:
    one setting that differs leaves no result."""
    proc = run_process(tiny_tree, 'tiny_train', patch=OTHER_TRAINING)
    assert proc.returncode != 0
    assert 'correct' not in proc.stdout
    assert 'lambda_smooth' in proc.stderr
