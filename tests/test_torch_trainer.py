"""Port training loop (a2m_torch/train/loop.py) and controller copy
(a2m_torch/train/controller.py) against a2m's controller.

``Trainer.train_epoch`` reads each batch's losses one batch late (so that
a step never waits for the device); fed the same loss sequence it must make
the decisions of a synchronous loop around a2m's ``DynamicGANTraining``:
the same numbers of G and D steps per batch, the same skipped D, the same
learning rates and label parameters."""

import numpy as np
import pytest
import torch

from a2m.config import ControllerConfig as JaxControllerConfig
from a2m.train.controller import DynamicGANTraining as JaxController
from a2m_torch.config import ControllerConfig, TrainConfig
from a2m_torch.train.controller import DynamicGANTraining
from a2m_torch.train.loop import Trainer

N_EPOCHS, N_BATCHES = 6, 7


def _losses(epoch: int, batch: int) -> tuple[float, float]:
    """Scripted (g_loss, d_loss) that walk the controller through its
    branches: a strong D (skip-D, D frequency down, learning rates moved),
    then a weak D (frequency up), then balance."""
    if epoch in (1, 2):
        return 1.0 + 0.01 * batch, 0.05
    if epoch in (3, 4):
        return 0.2, 0.9 + 0.01 * batch
    return 0.8, 0.5


def _reference_decisions():
    """Synchronous loop around a2m's controller: batch i's losses enter the
    history right after batch i."""
    ctrl = JaxController(JaxControllerConfig())
    log = []
    for epoch in range(N_EPOCHS):
        g_freq, d_freq = ctrl.adjust_training_frequency(epoch)
        g_lr, d_lr = ctrl.adjust_learning_rates(epoch)
        real = ctrl.label_params(epoch, True)
        fake = ctrl.label_params(epoch, False)
        last_d = 0.0
        for i in range(N_BATCHES):
            g_loss, d_loss = _losses(epoch, i)
            train_d = ctrl.should_train_discriminator()
            if train_d:
                last_d = d_loss
            log.append((epoch, i, g_freq, d_freq if train_d else 0, g_lr,
                        d_lr, real.smooth_real, fake.smooth_fake,
                        real.noise_std))
            ctrl.update_loss_history(last_d, g_loss)
    return log, ctrl


class _Param(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.p = torch.nn.Parameter(torch.zeros(1))


def test_train_epoch_makes_a2ms_decisions():
    calls = []

    def g_step(g_state, d_state, audio, pose, mean, std, smooth, noise_std,
               key, style=None, mask=None):
        epoch, i = int(audio[0]), int(audio[1])
        calls.append(('g', epoch, i, g_state.optimizer.param_groups[0]['lr'],
                      d_state.optimizer.param_groups[0]['lr'], smooth,
                      noise_std))
        return g_state, d_state, {'g_loss': torch.tensor(
            _losses(epoch, i)[0], dtype=torch.float64)}

    def d_step(g_state, d_state, audio, pose, mean, std, smooth_r, smooth_f,
               noise_std, key, style=None, mask=None):
        epoch, i = int(audio[0]), int(audio[1])
        calls.append(('d', epoch, i, smooth_r, smooth_f, noise_std))
        return d_state, g_state, {'d_loss': torch.tensor(
            _losses(epoch, i)[1], dtype=torch.float64)}

    trainer = Trainer(_Param(), _Param(), TrainConfig(log_every_batches=3),
                      log=lambda line: None, steps=(g_step, d_step, None))
    got = []
    for epoch in range(N_EPOCHS):
        trainer.train_batches = [
            (torch.tensor([float(epoch), float(i)]), torch.zeros(1), None,
             torch.ones(1)) for i in range(N_BATCHES)]
        calls.clear()
        last_g, last_d = trainer.train_epoch(epoch)
        for i in range(N_BATCHES):
            g_calls = [c for c in calls if c[0] == 'g' and c[2] == i]
            d_calls = [c for c in calls if c[0] == 'd' and c[2] == i]
            _, _, _, g_lr, d_lr, smooth_real, noise = g_calls[0]
            smooth_fake = d_calls[0][4] if d_calls else None
            got.append((epoch, i, len(g_calls), len(d_calls), g_lr, d_lr,
                        smooth_real, smooth_fake, noise))
            # G steps of a batch come before its D steps
            order = [c[0] for c in calls if c[2] == i]
            assert order == sorted(order, key='gd'.index)
        assert last_g == pytest.approx(_losses(epoch, N_BATCHES - 1)[0])
    ref, ref_ctrl = _reference_decisions()
    assert len(got) == len(ref)
    skipped = 0
    for g, r in zip(got, ref):
        assert g[:4] == r[:4], (g, r)
        np.testing.assert_allclose(g[4:7], r[4:7], rtol=1e-12)
        if g[3]:
            assert g[7] == pytest.approx(r[7], rel=1e-12)
        skipped += r[3] == 0
        assert g[8] == pytest.approx(r[8], rel=1e-12)
    # the script did reach the branches
    assert skipped > 3
    assert len({r[2] for r in ref}) > 1 and len({r[3] for r in ref}) > 2
    assert len({r[4] for r in ref}) > 1
    assert trainer.controller.state_dict() == ref_ctrl.state_dict()
    assert len(trainer.loss_history['train_g']) == N_EPOCHS * (N_BATCHES // 3)


def test_controller_copy_equals_a2ms():
    rng = np.random.default_rng(41)
    kw = dict(dynamic_smooth=True, g_lr_max=1e-3, d_lr_min=2e-4)
    a, b = (DynamicGANTraining(ControllerConfig(**kw)),
            JaxController(JaxControllerConfig(**kw)))
    for epoch in range(12):
        assert (a.adjust_training_frequency(epoch)
                == b.adjust_training_frequency(epoch))
        assert a.adjust_learning_rates(epoch) == b.adjust_learning_rates(epoch)
        for is_real in (True, False):
            assert (vars(a.label_params(epoch, is_real))
                    == vars(b.label_params(epoch, is_real)))
        for _ in range(15):
            d, g = rng.uniform(0, 0.3 if epoch % 3 else 1.5), rng.uniform(0, 2)
            assert (a.should_train_discriminator()
                    == b.should_train_discriminator())
            a.update_loss_history(d, g)
            b.update_loss_history(d, g)
        assert a.get_recent_avg_loss() == b.get_recent_avg_loss()
    assert a.state_dict() == b.state_dict()
    c = DynamicGANTraining(ControllerConfig(**kw))
    c.load_state_dict(a.state_dict())
    assert c.state_dict() == b.state_dict()
    assert len(a.d_loss_history) == 100


def test_validate_and_fit_average_the_eval_metrics():
    seen = []

    def eval_step(g_state, d_state, audio, pose, mean, std, mask, style=None):
        seen.append(float(audio[0]))
        return {'val_g': audio[0] * 2, 'val_d': audio[0] + 1}

    def g_step(g_state, d_state, *a, **k):
        return g_state, d_state, {'g_loss': torch.tensor(1.0)}

    def d_step(g_state, d_state, *a, **k):
        return d_state, g_state, {'d_loss': torch.tensor(0.5)}

    batches = [(torch.tensor([float(v)]), torch.zeros(1), None, torch.ones(1))
               for v in (1, 2, 6)]
    trainer = Trainer(_Param(), _Param(), TrainConfig(), batches[:2], batches,
                      log=lambda line: None, steps=(g_step, d_step, eval_step))
    assert trainer.validate() == {'val_g': 6.0, 'val_d': 4.0}
    history = trainer.fit(2)
    assert history['val_g'] == [6.0, 6.0] and history['val_d'] == [4.0, 4.0]
    assert seen == [1, 2, 6] * 3
    empty = Trainer(_Param(), _Param(), log=lambda line: None,
                    steps=(g_step, d_step, eval_step))
    assert empty.validate() == {}


# ---- the trainer over the data loader ---------------------------------------

TINY_G = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2)


@pytest.fixture(scope='module')
def pats_root(tmp_path_factory):
    from a2m.data import make_synthetic_pats
    return make_synthetic_pats(tmp_path_factory.mktemp('pats_train'),
                               speakers=('oliver', 'noah'),
                               intervals_per_speaker=4, duration_s=8.0)


def _port_loader(root, window_hop=5):
    from a2m_torch.data import DataLoader
    return DataLoader(path2data=root, speaker=['oliver', 'noah'],
                      batch_size=8, window_hop=window_hop, seed=0,
                      device='cpu', max_intervals=1)


def _a2m_prefetcher(num_style_speakers=0, lambda_aux=0.0, depth=2,
                    aux_classes=10):
    """a2m's ``Trainer._prefetch`` and ``_style_ids`` on an instance that
    holds only what the two read (its constructor builds the JAX models)."""
    from a2m import config as jconfig
    from a2m.train.loop import Trainer as JaxTrainer
    t = JaxTrainer.__new__(JaxTrainer)
    t.cfg = jconfig.Config(
        generator=jconfig.GeneratorConfig(
            num_style_speakers=num_style_speakers),
        discriminator=jconfig.DiscriminatorConfig(aux_classes=aux_classes),
        train=jconfig.TrainConfig(lambda_aux=lambda_aux,
                                  prefetch_batches=depth))
    t.mesh = None
    return t


def _port_trainer(num_style_speakers=0, lambda_aux=0.0, depth=2,
                  aux_classes=10, loader=None, **kw):
    from a2m_torch.config import DiscriminatorConfig, GeneratorConfig
    from a2m_torch.models.discriminator import Discriminator
    from a2m_torch.models.generator import Generator
    torch.manual_seed(0)
    g = Generator(GeneratorConfig(num_style_speakers=num_style_speakers,
                                  **TINY_G))
    d = Discriminator(DiscriminatorConfig(
        joint_feat_dim=8, gat_heads=2, aux_classes=aux_classes,
        use_aux_classifier=lambda_aux > 0))
    return Trainer(g, d, TrainConfig(lambda_aux=lambda_aux,
                                     prefetch_batches=depth,
                                     log_every_batches=1000),
                   log=lambda line: None, loader=loader, **kw)


@pytest.mark.parametrize('depth', [0, 2])
@pytest.mark.parametrize('styled', [False, True], ids=['no_style', 'style'])
def test_prefetch_stages_a2ms_batches(pats_root, depth, styled):
    """The port's Trainer over the port's DataLoader stages the (audio,
    pose, style, mask) that a2m's ``_prefetch`` stages over a2m's loader."""
    from a2m.data import DataLoader as JaxLoader
    n_style = 3 if styled else 0
    ref_loader = JaxLoader(path2data=pats_root, speaker=['oliver', 'noah'],
                           batch_size=8, window_hop=5, seed=0,
                           max_intervals=1, use_pallas=False)
    ref = list(_a2m_prefetcher(n_style, depth=depth)._prefetch(
        iter(ref_loader.train)))
    trainer = _port_trainer(n_style, depth=depth)
    got = list(trainer._prefetch(_port_loader(pats_root).train))
    assert len(got) == len(ref) > 1
    for g, r in zip(got, ref):
        for gt, rt in zip(g, r):
            if rt is None:
                assert gt is None
                continue
            assert gt.device == trainer.device
            np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
            assert gt.dtype == {np.dtype('float32'): torch.float32,
                                np.dtype('int32'): torch.int32}[
                                    np.asarray(rt).dtype]
    assert (got[0][2] is not None) == styled


def test_style_ids_and_aux_range_error_match_a2m(pats_root):
    batch = next(iter(_port_loader(pats_root).train))
    for n_style, aux in ((0, 0.0), (2, 0.0), (0, 0.5)):
        got = _port_trainer(n_style, aux)._style_ids(batch)
        ref = _a2m_prefetcher(n_style, aux)._style_ids(batch)
        if ref is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    bad = dict(batch, style=np.full_like(batch['style'], 12))
    for trainer in (_port_trainer(0, 0.5, aux_classes=10),
                    _a2m_prefetcher(0, 0.5, aux_classes=10)):
        with pytest.raises(ValueError, match='aux_classes'):
            trainer._style_ids(bad)


def test_prefetch_surfaces_worker_errors_and_stops(pats_root):
    trainer = _port_trainer()

    def failing():
        yield next(iter(_port_loader(pats_root).train))
        raise OSError('interval file vanished')

    with pytest.raises(OSError, match='vanished'):
        list(trainer._prefetch(failing()))
    staged = trainer._prefetch(_port_loader(pats_root).train)
    next(staged)
    staged.close()                      # the epoch abandoned: no hang


@pytest.fixture
def two_threads():
    """Two intra-op threads for the duration of a test: a run of many small
    steps spends its time in the pool's barriers when every core is busy
    (the fit test below took 82 s with eight threads and 8 s with two on an
    8-core CPU that other processes kept busy; 4-6 s either way on an idle
    one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_fit_over_loader_matches_tuple_batches(pats_root, two_threads):
    """``fit(1)`` on the tiny config over the loader, with the moments of
    its train set, equals a run fed the same batches as tuples (a window
    hop of 20 frames: one wrap-padded batch of 6 windows a split)."""
    from a2m_torch.data.normalization import get_mean_std_necksub
    a = _port_trainer(loader=_port_loader(pats_root, window_hop=20))
    twin = _port_loader(pats_root, window_hop=20)
    assert len(twin.train) == len(twin.dev) == 1
    mean, std = get_mean_std_necksub(twin.train)     # the loader's first pass
    np.testing.assert_array_equal(a.mean.numpy(), mean)
    np.testing.assert_array_equal(a.std.numpy(), std)

    def tuples(batches):
        return [(torch.from_numpy(b['audio/log_mel_512']),
                 torch.from_numpy(b['pose/data']), None,
                 torch.from_numpy(b['mask'])) for b in batches]

    b = _port_trainer(train_batches=tuples(twin.train),
                      dev_batches=tuples(twin.dev), mean=mean, std=std)
    histories = []
    for trainer in (a, b):
        torch.manual_seed(1)
        histories.append(trainer.fit(1))
    assert histories[0] == histories[1]
    assert np.isfinite(histories[0]['val_g']).all()
    for (name, p), q in zip(a.g_state.model.named_parameters(),
                            b.g_state.model.parameters()):
        assert torch.equal(p, q), name
