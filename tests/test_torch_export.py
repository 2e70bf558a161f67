"""Port export (a2m_torch/export.py) against a2m's (a2m/export.py), and
the three registered ops it traces (``a2m_torch::gcn_stack``,
``gcn_stack_edge``, ``log_mel``).

The tiny config of the other parity tests, seeded random variables carried
into both packages, random pose statistics.  Tolerances are those of
tests/test_torch_generator.py: the eager port and the fused stack's f32
(precise) operands within 1e-4 of max|ref| of a2m's HIGHEST-precision
artifact (f32 summation order through ~40 layers), bf16 operands within
1%.  An artifact and the live port model it came from run the same ops on
the same inputs: bit-equal.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from jax.lax import Precision

from a2m import export as jax_export
from a2m.config import GeneratorConfig as JaxConfig
from a2m.models import Generator as JaxGenerator
from a2m_torch import constants
from a2m_torch import export as aex
from a2m_torch.audio import frontend
from a2m_torch.config import Config, GeneratorConfig
from a2m_torch.models.generator import Generator
from a2m_torch.nn import gcn_kernel
from a2m_torch.train.checkpoint import save_best_generator_npz
from a2m_torch.weights import to_jax_variables
from torch_parity import max_rel, port_module, randomize, unflatten

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2)
SR = 45600
ROUTES = {'eager': (dict(), 1e-4),
          'fused_precise': (dict(fused_gcn=True, fused_precise=True), 1e-4),
          'fused_bf16': (dict(fused_gcn=True), 1e-2)}


@pytest.fixture(scope='module')
def tiny():
    """Seeded features (2, 64, 128), waveform (1, 4.3 s), flat random
    variables, pose statistics, and a2m's HIGHEST-precision generator."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 64, 128)).astype(np.float32)
    wave = (rng.standard_normal((1, int(SR * 4.3))) * 0.1).astype(np.float32)
    model = JaxGenerator(JaxConfig(**TINY), precision=Precision.HIGHEST)
    # a2m's variable tree, read off the port's (the weight bridge is one to
    # one), then every leaf randomised
    flat = randomize(unflatten(to_jax_variables(Generator(
        GeneratorConfig(**TINY)))), rng)
    mean = rng.standard_normal(104).astype(np.float32)
    std = (np.abs(rng.standard_normal(104)) + 0.5).astype(np.float32)
    return dict(feats=feats, wave=wave, flat=flat, mean=mean, std=std,
                model=model)


@pytest.fixture(scope='module')
def jax_pose(tiny):
    exported = jax_export.export_pose_fn(
        tiny['model'], unflatten(tiny['flat']), tiny['mean'], tiny['std'],
        batch_size=2)
    return np.asarray(exported.call(tiny['feats']))


@pytest.fixture(scope='module')
def port_pose(tiny):
    """Route -> the port's pose artifact (B = 2) from the same variables."""
    return {name: aex.export_pose_fn(
        Generator(GeneratorConfig(**TINY, **cfg)), tiny['flat'],
        tiny['mean'], tiny['std'], batch_size=2)
        for name, (cfg, _) in ROUTES.items()}


@functools.cache
def _module(exported):
    return exported.module()


def _run(exported, x):
    with torch.no_grad():
        return _module(exported)(torch.from_numpy(x))


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_pose_artifact_matches_a2m_artifact(tiny, jax_pose, port_pose,
                                            route):
    got = _run(port_pose[route], tiny['feats']).numpy()
    assert got.shape == jax_pose.shape == (2, 64, 104)
    assert max_rel(got, jax_pose) < ROUTES[route][1], max_rel(got, jax_pose)


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_pose_artifact_equals_live_model(tiny, port_pose, route):
    live = port_module(Generator(GeneratorConfig(**TINY,
                                                 **ROUTES[route][0])),
                       tiny['flat'])
    with torch.no_grad():
        want = aex._denorm(live(torch.from_numpy(tiny['feats'])),
                           torch.from_numpy(tiny['mean']),
                           torch.from_numpy(tiny['std']))
    assert torch.equal(_run(port_pose[route], tiny['feats']), want)
    # as the live model's: linear and matmul route a non-contiguous input
    # by whether the weight requires grad (the last bits differ on the card)
    assert all(p.requires_grad for p in port_pose[route].parameters())


@pytest.fixture(scope='module')
def port_audio(tiny):
    return aex.export_audio_to_pose(
        Generator(GeneratorConfig(**TINY, fused_gcn=True,
                                  fused_precise=True)),
        tiny['flat'], tiny['mean'], tiny['std'], batch_size=1)


def test_audio_artifact_matches_a2m_artifact(tiny, port_audio):
    exported = jax_export.export_audio_to_pose(
        tiny['model'], unflatten(tiny['flat']), tiny['mean'], tiny['std'],
        batch_size=1)
    ref = np.asarray(exported.call(tiny['wave']))
    got = _run(port_audio, tiny['wave']).numpy()
    assert got.shape == ref.shape == (1, 64, 104)
    assert max_rel(got, ref) < 1e-4, max_rel(got, ref)


def _count(exported, op):
    return exported.graph_module.code.count(f'a2m_torch.{op}.default')


@pytest.mark.parametrize('route,want', [
    ('eager', 0), ('fused_precise', 2), ('fused_bf16', 2)])
def test_pose_graph_holds_one_node_a_stack(port_pose, route, want):
    exported = port_pose[route]
    assert _count(exported, 'gcn_stack') == want
    assert _count(exported, 'gcn_stack_edge') == 0
    assert _count(exported, 'log_mel') == 0
    assert aex._signature(exported)['ops'] == (
        {'a2m_torch::gcn_stack': want} if want else {})


def test_audio_graph_holds_the_log_mel(port_audio):
    assert _count(port_audio, 'log_mel') == 1
    assert _count(port_audio, 'gcn_stack') == 2


def test_edge_form_generator_exports(tiny):
    cfg = GeneratorConfig(**TINY, fused_gcn=True, fused_edge=True)
    exported = aex.export_pose_fn(Generator(cfg), tiny['flat'],
                                  tiny['mean'], tiny['std'], batch_size=2)
    assert _count(exported, 'gcn_stack_edge') == 2
    assert _count(exported, 'gcn_stack') == 0
    live = port_module(Generator(cfg), tiny['flat'])
    with torch.no_grad():
        want = aex._denorm(live(torch.from_numpy(tiny['feats'])),
                           torch.from_numpy(tiny['mean']),
                           torch.from_numpy(tiny['std']))
    assert torch.equal(_run(exported, tiny['feats']), want)


# a fresh process: torch and the two kernel modules, nothing else of the
# port, no checkpoint and no .npz; argv: (artifact, input, output) pairs
LOADER = r"""
import sys
import numpy as np
import torch
import a2m_torch.audio.mel_kernel
import a2m_torch.nn.gcn_kernel
runs = [sys.argv[i:i + 3] for i in range(1, len(sys.argv), 3)]
inputs = [torch.from_numpy(np.load(x)) for _, x, _ in runs]
np.load = None                          # nothing else is read
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for (path, _, out), x in zip(runs, inputs):
    module = torch.export.load(path).module()
    with torch.inference_mode():
        np.save(out, module(x).numpy())
port = sorted(m for m in sys.modules if m.split('.')[0] == 'a2m_torch')
assert port == ['a2m_torch', 'a2m_torch.audio', 'a2m_torch.audio.mel_kernel',
                'a2m_torch.nn', 'a2m_torch.nn.gcn_kernel'], port
assert not any(m.split('.')[0] in ('a2m', 'jax') for m in sys.modules)
print('loaded')
"""


def test_saved_artifacts_run_with_the_kernel_modules_alone(
        tiny, port_pose, port_audio, tmp_path):
    cases = {'pose': (port_pose['fused_bf16'], tiny['feats']),
             'audio': (port_audio, tiny['wave'])}
    argv = []
    for name, (exported, x) in cases.items():
        path = aex.save_artifact(exported, tmp_path / f'{name}.pt2')
        meta = json.loads(Path(f'{path}.meta').read_text())
        assert meta['format'] == aex.FORMAT == 'a2m-torch-export-v1'
        assert meta['ops'] == aex._signature(exported)['ops']
        assert meta['ops']['a2m_torch::gcn_stack'] == 2
        assert meta['inputs'] == [[list(x.shape), 'torch.float32']]
        assert meta['outputs'] == [[[x.shape[0], 64, 104], 'torch.float32']]
        assert meta['device'] == 'cpu'
        assert meta['precision']['tf32_cudnn'] is False
        np.save(tmp_path / f'{name}_x.npy', x)
        argv += [str(path), str(tmp_path / f'{name}_x.npy'),
                 str(tmp_path / f'{name}_y.npy')]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', LOADER, *argv], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('loaded')
    for name, (exported, x) in cases.items():
        np.testing.assert_array_equal(np.load(tmp_path / f'{name}_y.npy'),
                                      _run(exported, x).numpy())


@pytest.mark.parametrize('flavour', ['pose', 'audio'])
def test_cli_builds_and_checks_an_artifact(tiny, tmp_path, flavour):
    """``python -m a2m_torch.export`` on the CPU: the pose flavour from a
    packed best-G ``.npz`` (its weights and pose statistics baked in), the
    audio flavour without a checkpoint (the port's seeded init, identity
    stats)."""
    cfg = GeneratorConfig(**TINY)
    out_path = tmp_path / 'cli.pt2'
    argv = ['--out', str(out_path), '--check', '--device', 'cpu',
            '--flavor', flavour]
    if flavour == 'pose':
        ckpt = save_best_generator_npz(
            port_module(Generator(cfg), tiny['flat']),
            tmp_path / 'best_gen.npz', tiny['mean'], tiny['std'])
        argv += ['--ckpt', str(ckpt), '--batch_size', '2']
    with mock.patch.object(aex, 'Config', lambda: Config(generator=cfg)):
        out = aex.main(argv)
    assert out_path.exists() and Path(f'{out_path}.meta').exists()
    assert out['bytes'] == out_path.stat().st_size > 1000
    meta = json.loads(Path(f'{out_path}.meta').read_text())
    assert meta['inputs'][0][0] == ([2, 64, 128] if flavour == 'pose'
                                    else [1, int(SR * 4.3)])
    if flavour == 'audio':
        return
    got = aex.load_artifact(out_path)(torch.from_numpy(tiny['feats']))
    # the .npz holds the params in f16: the live model loads them from it
    live = port_module(Generator(cfg), aex._build_from_checkpoint(
        ckpt, None, ['oliver'], Config(generator=cfg), 'cpu')[1])
    with torch.no_grad():
        want = aex._denorm(live(torch.from_numpy(tiny['feats'])),
                           torch.from_numpy(tiny['mean']),
                           torch.from_numpy(tiny['std']))
    assert torch.equal(got, want)
    with pytest.raises(FileNotFoundError):
        aex.main(['--ckpt', str(tmp_path / 'none.npz'), '--out',
                  str(tmp_path / 'b.pt2'), '--device', 'cpu'])


def test_export_keeps_fake_tables_out_of_the_cache():
    """Tables first built inside a ``torch.export`` trace are fake tensors:
    they are baked into the program and not cached, so eager calls after
    the export still compute."""
    spec = frontend.strided_spec(frontend.spec_log_mel_400(), 2)

    class Mel(torch.nn.Module):
        def forward(self, y):
            return frontend.log_mel(y, spec, exact=False)

    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 4000)).astype(np.float32))
    frontend._mel_tables.pop((spec, torch.device('cpu'), False), None)
    with torch.no_grad():
        exported = torch.export.export(Mel(), (y,), strict=False)
    assert (spec, torch.device('cpu'), False) not in frontend._mel_tables
    eager = frontend.log_mel(y, spec, exact=False)
    assert torch.equal(exported.module()(y), eager)
    assert frontend.mel_tables(spec, 'cpu') is frontend.mel_tables(
        spec, torch.device('cpu'))


# ---- the ops: schema, fake kernel and aliasing (torch.library.opcheck) ----

F, HEADS = 16, 2


@pytest.mark.parametrize('op', ['gcn_stack', 'gcn_stack_edge'])
@pytest.mark.parametrize('precise', [True, False], ids=['f32', 'bf16'])
@pytest.mark.parametrize('j', [10, 42])
def test_stack_ops_pass_opcheck(op, precise, j):
    rng = np.random.default_rng(j)
    edges = constants.body_edges() if j == 10 else constants.hand_edges()
    adj = torch.as_tensor(constants.adjacency_from_edges(edges, j))
    x = torch.from_numpy(rng.standard_normal((3, j, F)).astype(np.float32))
    params = torch.from_numpy(0.3 * rng.standard_normal(
        gcn_kernel.num_params(F, HEADS, 5)).astype(np.float32))
    args = (x, params, adj, HEADS, 5, precise)
    torch.library.opcheck(getattr(torch.ops.a2m_torch, op).default, args)
    plain = (gcn_kernel.gcn_stack_plain if op == 'gcn_stack'
             else gcn_kernel.gcn_stack_edge_plain)
    assert torch.equal(getattr(torch.ops.a2m_torch, op)(*args),
                       plain(*args))


@pytest.mark.parametrize('exact', [False, True], ids=['fast', 'exact'])
def test_log_mel_op_passes_opcheck(exact):
    spec = frontend.strided_spec(frontend.spec_log_mel_512(SR), 6)
    y = torch.from_numpy((np.random.default_rng(2).standard_normal(
        (2, 9000)) * 0.1).astype(np.float32))
    t = frontend.mel_tables(spec, 'cpu', exact)
    args = (y, t.window, t.twiddle, t.mel_bins, t.mel_weights,
            t.sched_weights, t.sched_index, t.mel_pieces, t.dr, t.di, t.mel,
            t.frame_len, spec.hop_length, spec.n_fft // 2, 3,
            spec.log_const, spec.power, spec.log_mode, exact)
    torch.library.opcheck(torch.ops.a2m_torch.log_mel.default, args)
    assert torch.equal(torch.ops.a2m_torch.log_mel(*args),
                       frontend.log_mel(y, spec, exact=exact, n_frames=3))
    with pytest.raises(ValueError, match='exact='):
        torch.ops.a2m_torch.log_mel(*args[:-1], not exact)
