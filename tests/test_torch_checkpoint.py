"""Checkpoints of the port (a2m_torch/train/checkpoint.py) and the trainer's
run around them (a2m_torch/train/loop.py, a2m_torch/train/__main__.py).

* ``CheckpointManager``: save then restore is bit-equal for both models,
  both Adams, the controller, mean/std, the loss history and the epoch;
  ``max_to_keep`` prunes.
* ``loss.npy`` is a2m's byte for byte, and each package reads the other's.
* The packed best-G ``.npz`` in both directions: a2m's file loads into the
  port, the port's into a2m, and the two generators' eval forwards on one
  seeded log-mel agree within 1e-4 of max|pose| (f32 summation order
  through ~40 layers, as tests/test_torch_generator.py); a BatchNorm
  variance above f16's range survives the port's file.
* The trainer: ``best_score`` and ``initial_best_score`` as a2m's for every
  metric of ``BEST_METRICS``; ``init_from`` loads G and its stats; the CLI
  runs an epoch (``fit(1)``) and writes the run's files, on which a
  resumed trainer (``resume`` taking precedence over ``init_from``) starts
  at epoch 1 and ``fit(2)`` runs epoch 1 only; ``profile_dir``'s trace and
  the MFU line.
"""

import contextlib
import io
import os
import runpy
import shutil
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from a2m.config import Config as JaxConfig
from a2m.config import GeneratorConfig as JaxGeneratorConfig
from a2m.config import TrainConfig as JaxTrainConfig
from a2m.models import Generator as JaxGenerator
from a2m.train import checkpoint as jckpt
from a2m.train.loop import Trainer as JaxTrainer
from a2m_torch.config import (BEST_METRICS, Config, DiscriminatorConfig,
                              GeneratorConfig, TrainConfig, apply_overrides)
from a2m_torch.models.discriminator import Discriminator
from a2m_torch.models.generator import Generator
from a2m_torch.train import checkpoint as tckpt
from a2m_torch.train.loop import Trainer
from a2m_torch.train.train_step import init_states
from a2m_torch.weights import from_jax_variables
from torch_parity import max_rel, randomize, unflatten

TINY_G = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2)
TINY_D = dict(joint_feat_dim=8, gat_heads=2, out_channels=16)
TINY_OVERRIDES = [f'generator.{k}={v}' for k, v in TINY_G.items()] + [
    f'discriminator.{k}={v}' for k, v in TINY_D.items()]


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    """Two intra-op threads for this module's many small torch steps, set
    and restored around the module only."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _states(seed: int):
    torch.manual_seed(seed)
    return init_states(Generator(GeneratorConfig(**TINY_G)),
                       Discriminator(DiscriminatorConfig(**TINY_D)))


def _step_adams(states, seed: int) -> None:
    """Two Adam steps on seeded gradients, so each optimiser holds moments
    and a step count."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(2):
        for state in states:
            for p in state.model.parameters():
                p.grad = torch.randn(p.shape, generator=gen)
            state.optimizer.step()


def _assert_states_equal(a, b) -> None:
    for x, y in zip(a, b):
        sx, sy = x.model.state_dict(), y.model.state_dict()
        assert sx.keys() == sy.keys()
        for k in sx:
            assert torch.equal(sx[k], sy[k]), k
        ox, oy = x.optimizer.state_dict(), y.optimizer.state_dict()
        assert ox['param_groups'] == oy['param_groups']
        assert ox['state'].keys() == oy['state'].keys()
        for i in ox['state']:
            for k, v in ox['state'][i].items():
                assert torch.equal(v, oy['state'][i][k]), (i, k)


def test_save_restore_is_bit_equal(tmp_path):
    saved = _states(0)
    _step_adams(saved, 1)
    ctrl = dict(g_lr_current=6e-4, d_lr_current=9e-4,
                d_loss_history=[0.5, 0.25], g_loss_history=[1.5, 1.25],
                d_train_freq=2, g_train_freq=4)
    mean, std = torch.linspace(-3, 3, 104), torch.full((104,), 2.5)
    history = dict(train_g=[1.0], train_d=[0.5], val_g=[0.9], val_d=[0.4],
                   best_score=[-0.25])
    mgr = tckpt.CheckpointManager(tmp_path / 'ckpt')
    assert mgr.latest_epoch() is None and mgr.restore() is None
    mgr.save(3, *saved, ctrl, mean, std, extra=dict(loss_history=history))
    fresh = _states(7)
    out = mgr.restore(*fresh)
    _assert_states_equal(saved, fresh)
    assert out['epoch'] == 3 and mgr.latest_epoch() == 3
    assert out['controller'] == ctrl
    assert torch.equal(out['mean'], mean) and torch.equal(out['std'], std)
    assert out['extra'] == dict(loss_history=history)


def test_max_to_keep_prunes_the_oldest(tmp_path):
    states = _states(0)
    mgr = tckpt.CheckpointManager(tmp_path, max_to_keep=2)
    for epoch in range(5):
        mgr.save(epoch, *states, {}, torch.zeros(104), torch.ones(104))
    assert mgr.epochs() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ['epoch_3.pt', 'epoch_4.pt']
    assert mgr.restore(epoch=3)['epoch'] == 3


def test_loss_history_is_a2ms_file(tmp_path):
    history = dict(train_g=[1.0, 0.5], train_d=[0.25], val_g=[0.125],
                   val_d=[], best_score=[-0.75])
    tckpt.save_loss_history(tmp_path / 'port.npy', history)
    jckpt.save_loss_history(tmp_path / 'a2m.npy', history)
    assert ((tmp_path / 'port.npy').read_bytes()
            == (tmp_path / 'a2m.npy').read_bytes())
    assert jckpt.load_loss_history(tmp_path / 'port.npy') == history
    assert tckpt.load_loss_history(tmp_path / 'a2m.npy') == history


@pytest.fixture(scope='module')
def bridge():
    """(a2m's jitted eval forward of the tiny generator, its seeded random
    flat variables, the f32 seeded log-mel, mean, std)."""
    rng = np.random.default_rng(3)
    model = JaxGenerator(JaxGeneratorConfig(**TINY_G))
    feats = rng.standard_normal((2, 64, 128)).astype(np.float32)
    variables = jax.eval_shape(model.init, {'params': jax.random.PRNGKey(0),
                                            'dropout': jax.random.PRNGKey(0)},
                               feats)
    flat = randomize(variables, rng)
    mean = rng.standard_normal(104).astype(np.float32)
    std = rng.uniform(1, 3, 104).astype(np.float32)
    apply = jax.jit(lambda v, a: model.apply(v, a, train=False))
    return apply, flat, feats, mean, std


def _a2m_pose(apply, variables: dict, feats) -> np.ndarray:
    return np.asarray(apply(variables, feats))


def _port_pose(best: dict, feats) -> np.ndarray:
    g = Generator(GeneratorConfig(**TINY_G))
    g.load_state_dict(from_jax_variables(best['variables'], g))
    with torch.no_grad():
        return g.eval()(torch.from_numpy(feats)).numpy()


def test_a2ms_npz_loads_into_the_port(bridge, tmp_path):
    apply, flat, feats, mean, std = bridge
    tree = unflatten(flat)
    path = jckpt.save_best_generator_npz(
        dict(params=tree['params'], batch_stats=tree['batch_stats'],
             mean=mean, std=std), tmp_path / 'a2m_best_gen.npz')
    best = tckpt.load_any_generator_ckpt(path)
    np.testing.assert_array_equal(best['mean'], mean)
    np.testing.assert_array_equal(best['std'], std)
    ref = jckpt.load_best_generator_npz(path)      # a2m's own reading
    want = _a2m_pose(apply, dict(params=ref['params'],
                                 batch_stats=ref['batch_stats']), feats)
    got = _port_pose(best, feats)
    assert max_rel(got, want) < 1e-4, max_rel(got, want)
    # the same file through a directory that holds it
    (tmp_path / 'run').mkdir()
    os.replace(path, tmp_path / 'run' / 'best_gen.npz')
    again = tckpt.load_any_generator_ckpt(tmp_path / 'run')
    for k, v in best['variables'].items():
        np.testing.assert_array_equal(again['variables'][k], v)


def test_ports_npz_loads_into_a2m(bridge, tmp_path):
    apply, flat, feats, mean, std = bridge
    g = Generator(GeneratorConfig(**TINY_G))
    g.load_state_dict(from_jax_variables(flat, g))
    # a GAN-trained BatchNorm variance beyond f16's 65504 (a2m: commit
    # 1f688a8, tests/test_train.py:661)
    g.unet.up0.bn.running_var[3] = 7.25e4
    path = tckpt.CheckpointManager(tmp_path).save_best_generator(
        g, torch.from_numpy(mean), torch.from_numpy(std))
    assert path == tmp_path / 'best_gen.npz'
    with np.load(path) as z:
        assert z['batch_stats/unet/up0/bn/var'].dtype == np.float32
        assert z['params/unet/up0/kernel'].dtype == np.float16
        assert z['stats/mean'].dtype == np.float32
    ref = jckpt.load_best_generator_npz(path)
    assert ref['batch_stats']['unet']['up0']['bn']['var'][3] == 7.25e4
    np.testing.assert_array_equal(ref['mean'], mean)
    np.testing.assert_array_equal(ref['std'], std)
    want = _a2m_pose(apply, dict(params=ref['params'],
                                 batch_stats=ref['batch_stats']), feats)
    got = _port_pose(tckpt.load_best_generator_npz(path), feats)
    assert np.isfinite(want).all()
    assert max_rel(got, want) < 1e-4, max_rel(got, want)


def test_load_any_generator_ckpt_layouts(tmp_path):
    assert tckpt.load_any_generator_ckpt(tmp_path / 'missing.npz') is None
    assert tckpt.load_any_generator_ckpt(tmp_path) is None
    (tmp_path / 'best_gen').mkdir()           # an Orbax directory
    for path in (tmp_path, tmp_path / 'best_gen'):
        with pytest.raises(ValueError, match='pack_best_generator_npz'):
            tckpt.load_any_generator_ckpt(path)


# ---- the trainer ----------------------------------------------------------

def _scripted_trainer(best_metric: str, history=None, **kw):
    def eval_step(*a, **k):
        return {}

    trainer = Trainer(torch.nn.Linear(1, 1), torch.nn.Linear(1, 1),
                      TrainConfig(best_metric=best_metric),
                      log=lambda line: None,
                      steps=(None, None, eval_step), **kw)
    if history is not None:
        trainer.loss_history = history
    return trainer


def _a2m_selector(best_metric: str, history):
    """a2m's ``best_score``/``initial_best_score`` on an instance that holds
    only what the two read (its constructor builds the JAX models)."""
    t = JaxTrainer.__new__(JaxTrainer)
    t.cfg = JaxConfig(train=JaxTrainConfig(best_metric=best_metric))
    t.loss_history = history
    return t


@pytest.mark.parametrize('metric', BEST_METRICS)
def test_best_score_as_a2m(metric):
    val = {m: 0.1 * (i + 1) for i, m in enumerate(BEST_METRICS)}
    histories = (dict(train_g=[], train_d=[], val_g=[0.5, 0.25], val_d=[]),
                 dict(train_g=[], train_d=[], val_g=[0.5], val_d=[],
                      best_score=[0.75, -0.5]),
                 dict(train_g=[], train_d=[], val_g=[], val_d=[]))
    for history in histories:
        got = _scripted_trainer(metric, dict(history))
        ref = _a2m_selector(metric, dict(history))
        assert got.best_score(val) == ref.best_score(val)
        assert got.initial_best_score() == ref.initial_best_score()
    for trainer in (_scripted_trainer(metric), _a2m_selector(metric, {})):
        with pytest.raises(KeyError, match='best_metric'):
            trainer.best_score({'other': 1.0})


def _tiny_loader(train_batches: int = 1):
    from a2m_torch.data.synthetic import synthetic_loader
    return synthetic_loader(speakers=('oliver',), intervals_per_speaker=4,
                            duration_s=8.0, seed=0, batch_size=8,
                            max_batches={'train': train_batches, 'dev': 1})


def _tiny_config(save_dir, *items) -> Config:
    return apply_overrides(Config(), TINY_OVERRIDES + [
        f'train.save_dir={save_dir}', 'train.log_every_batches=1000',
        'train.log_mfu=false', *items])


def test_init_from_loads_weights_and_stats(bridge, tmp_path):
    _, flat, _, mean, std = bridge
    tree = unflatten(flat)
    path = jckpt.save_best_generator_npz(
        dict(params=tree['params'], batch_stats=tree['batch_stats'],
             mean=mean, std=std), tmp_path / 'warm' / 'best_gen.npz')
    cfg = _tiny_config(tmp_path / 'run', f'train.init_from={path.parent}')
    trainer = Trainer.from_config(cfg, _tiny_loader(), device='cpu')
    want = from_jax_variables(tckpt.load_best_generator_npz(path)[
        'variables'], trainer.g_state.model)
    for k, v in trainer.g_state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    np.testing.assert_array_equal(trainer.mean.numpy(), mean)
    np.testing.assert_array_equal(trainer.std.numpy(), std)
    assert trainer.start_epoch == 0
    # a2m's Orbax discriminator directory: the port reads only the .npz
    (path.parent / 'imported_disc').mkdir()
    with pytest.raises(ValueError, match='Orbax'):
        Trainer.from_config(cfg, _tiny_loader(), device='cpu')


@pytest.fixture(scope='module')
def cli_run(tmp_path_factory):
    """``python -m a2m_torch.train`` as the interpreter runs it (the module
    executed as ``__main__``), in this process, for one epoch of the tiny
    config on a small PATS tree: (its save_dir, its output)."""
    from a2m.data import make_synthetic_pats
    tmp = tmp_path_factory.mktemp('cli')
    data = make_synthetic_pats(tmp / 'pats', speakers=('oliver',),
                               intervals_per_speaker=4, duration_s=8.0)
    run = tmp / 'run'
    argv = ['device=cpu', f'data.path2data={data}', 'data.speakers=oliver',
            'data.batch_size=12', 'data.max_intervals_per_split=1',
            'train.n_epochs=1', f'train.save_dir={run}', *TINY_OVERRIDES]
    saved_argv, sys.argv = sys.argv, ['a2m_torch.train', *argv]
    sys.modules.pop('a2m_torch.train.__main__', None)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            runpy.run_module('a2m_torch.train', run_name='__main__',
                             alter_sys=True)
    finally:
        sys.argv = saved_argv
    return run, out.getvalue()


def test_train_cli_runs_an_epoch(cli_run):
    run, out = cli_run
    assert '[Validation] Epoch 0/1' in out
    assert sum(line.startswith('g_step: ') for line in out.splitlines()) == 1
    for name in ('ckpt/best_gen.npz', 'ckpt/epoch_0.pt', 'loss.npy'):
        assert (run / name).is_file(), name
    assert len(tckpt.load_loss_history(run / 'loss.npy')['val_g']) == 1


def test_resume_takes_precedence_and_runs_the_remaining_epoch(
        cli_run, bridge, tmp_path):
    """A trainer on the CLI's run directory (its ``fit(1)``), also asked to
    warm-start, resumes instead: bit-equal to the checkpoint, at
    ``start_epoch`` 1, and ``fit(2)`` runs epoch 1 only."""
    _, flat, _, mean, std = bridge
    tree = unflatten(flat)
    warm = jckpt.save_best_generator_npz(
        dict(params=tree['params'], batch_stats=tree['batch_stats'],
             mean=mean, std=std), tmp_path / 'warm.npz')
    run = tmp_path / 'run'
    shutil.copytree(cli_run[0], run)
    saved = tckpt.CheckpointManager(run / 'ckpt').restore()
    lines = []
    trainer = Trainer.from_config(
        _tiny_config(run, f'train.init_from={warm}'), _tiny_loader(),
        device='cpu', seed=2, log=lines.append)
    assert trainer.start_epoch == 1
    assert 'resumed from epoch 0' in lines
    for state, prefix in ((trainer.g_state, 'g'), (trainer.d_state, 'd')):
        for k, v in state.model.state_dict().items():
            assert torch.equal(v, saved[f'{prefix}_model'][k]), k
        got = state.optimizer.state_dict()
        for i, moments in saved[f'{prefix}_optimizer']['state'].items():
            for k, v in moments.items():
                assert torch.equal(got['state'][i][k], v), (prefix, i, k)
    assert trainer.controller.state_dict() == saved['controller']
    assert torch.equal(trainer.mean, saved['mean'])
    assert trainer.loss_history == saved['extra']['loss_history']
    trainer.fit(2)
    epochs = [line for line in lines if line.startswith('[Validation]')]
    assert len(epochs) == 1 and epochs[0].startswith('[Validation] Epoch 1/2')
    assert trainer.ckpt.epochs() == [0, 1]
    assert len(trainer.loss_history['val_g']) == 2
    assert (tckpt.load_loss_history(run / 'loss.npy')
            == trainer.loss_history)


def test_entry_points_need_cuda_by_default(tmp_path):
    from a2m_torch.train.__main__ import parse
    cfg, device = parse(['train.n_epochs=1'])
    assert device == 'cuda' and cfg.audio.device == 'cuda'
    cfg, device = parse(['device=cpu', 'audio.device=cuda'])
    assert device == 'cpu' and cfg.audio.device == 'cuda'
    with pytest.raises(ValueError, match='key.path=value'):
        parse(['--help'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            Trainer.from_config(_tiny_config(tmp_path), SimpleNamespace(
                train=(), dev=()))


def test_profile_dir_traces_the_third_batch_and_the_mfu_line(tmp_path):
    """``profile_dir``: a ``torch.profiler`` trace of the first steps with
    the ``a2m.g_step`` / ``a2m.d_step`` regions (a2m's loop.py:460-503),
    and the MFU line once."""

    def g_step(g_state, d_state, *a, **k):
        return g_state, d_state, {'g_loss': torch.ones(1).sum()}

    def d_step(g_state, d_state, *a, **k):
        return d_state, g_state, {'d_loss': torch.ones(1).sum()}

    lines = []
    batches = [(torch.zeros(2, 1), torch.zeros(2, 1), None, torch.ones(2))
               for _ in range(4)]
    trainer = Trainer(torch.nn.Linear(1, 1), torch.nn.Linear(1, 1),
                      TrainConfig(profile_dir=str(tmp_path / 'trace')),
                      batches, log=lines.append,
                      steps=(g_step, d_step, None))
    trainer.train_epoch(0)
    traces = list((tmp_path / 'trace').iterdir())
    assert len(traces) == 1
    text = traces[0].read_text()
    assert 'a2m.g_step' in text and 'a2m.d_step' in text
    assert sum(line.startswith('device trace -> ') for line in lines) == 1
    assert sum(line.startswith('g_step: ') for line in lines) == 1
    assert set(trainer.mfu_report) == {'g_step', 'd_step'}


def test_mfu_counts_the_eager_step_and_reads_the_peak_table():
    from a2m_torch.utils import mfu
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    out, flops = mfu.step_flops(torch.matmul, a, b)
    assert torch.equal(out, a @ b) and flops == 2 * 64 * 32 * 16
    assert mfu.device_kind('cpu') == 'cpu'
    assert mfu.PEAK_FLOPS[('h100', 'f32')] == 67e12
    assert mfu.PEAK_FLOPS[('h100', 'bf16')] == 989e12
    assert mfu.mfu(5e10, 1.0, 'f32', 'cpu') == 0.5
    line = mfu.format_mfu_line('g_step', 5e10, 0.5, 'f32', 'cpu')
    assert line.startswith('g_step: 500.0 ms/step') and 'MFU 100.0%' in line
