"""The port's multi-process data-parallel training (a2m_torch/parallel/,
the global batch of the train steps, the rank-aware trainer) against a2m's
global-batch semantics, on the CPU with gloo.

a2m's multi-process run is one global program: BatchNorm moments, losses
and gradients over the global batch, every process holding the same
values (tests/test_distributed.py).  The port runs one process a rank with
explicit collectives; here two ranks run the bootstrap and ``run()``
through ``tests/torch_dist_worker.py`` on the in-memory fixture, each with
its own working directory, a free port and a timeout on every wait, and
are held to each other bit for bit, to the port's one-process run on the
concatenated batches, and to a2m on the CPU.  Dropout and label noise are
0 in the training run (the RNG streams of the two frameworks differ; the
label noise's rows are held on their own).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from a2m_torch.config import (Config, DistConfig, apply_overrides,
                              validate)
from a2m_torch.parallel import launch, mesh

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as worker  # noqa: E402

TINY = [
    'generator.in_channels=16', 'generator.out_channels=16',
    'generator.joint_feat_dim=8', 'generator.gat_heads=2',
    'generator.dropout=0', 'discriminator.out_channels=8',
    'discriminator.joint_feat_dim=8', 'discriminator.gat_heads=2',
    'discriminator.dropout=0', 'train.n_epochs=2',
    'train.log_every_batches=1', 'train.controller.max_noise_std=0',
    'train.controller.min_noise_std=0']
#: seconds a rank may take (about 15 s each on an idle 8-core CPU)
RANK_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# ---- one process -------------------------------------------------------------

@pytest.fixture
def no_launch_env(monkeypatch):
    for name in ('A2M_COORDINATOR', 'A2M_NUM_PROCESSES', 'A2M_PROCESS_ID',
                 'RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
                 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)


def test_maybe_initialize_noop_without_config(no_launch_env):
    import torch.distributed as dist

    from a2m.config import DistConfig as JaxDistConfig
    from a2m.parallel.launch import maybe_initialize as jax_initialize
    assert launch.maybe_initialize(DistConfig(), 'cpu') is False
    assert launch.maybe_initialize(None, 'cpu') is False
    assert not dist.is_initialized() and not launch.is_distributed()
    assert jax_initialize(JaxDistConfig()) is False
    assert mesh.process_identity() == (0, 1)


@pytest.mark.parametrize('cfg,match', [
    (DistConfig(coordinator='127.0.0.1:1'), 'num_processes'),
    (DistConfig(coordinator='127.0.0.1:1', num_processes=2), 'process_id'),
    (DistConfig(auto=True), 'RANK')], ids=['coordinator', 'no_id', 'auto'])
def test_maybe_initialize_rejects_partial_config(no_launch_env, cfg, match):
    import torch.distributed as dist

    from a2m.config import DistConfig as JaxDistConfig
    from a2m.parallel.launch import maybe_initialize as jax_initialize
    with pytest.raises(ValueError, match=match):
        launch.maybe_initialize(cfg, 'cpu')
    assert not dist.is_initialized()
    if cfg.coordinator:
        with pytest.raises(ValueError, match='num_processes'):
            jax_initialize(JaxDistConfig(**vars(cfg)))


def test_sync_global_moments_single_process_identity():
    from a2m_torch.data.normalization import (finalize_moments_necksub,
                                              get_mean_std_necksub,
                                              get_moments_necksub)
    rng = np.random.default_rng(0)
    batches = [{'pose/data': rng.standard_normal((4, 16, 104)).astype(
        np.float32)} for _ in range(3)]
    m0, s0 = get_mean_std_necksub(iter(batches))
    moments = get_moments_necksub(iter(batches))
    m1, s1 = finalize_moments_necksub(*launch.sync_global_moments(*moments))
    np.testing.assert_array_equal(m1, m0)
    np.testing.assert_array_equal(s1, s0)


@pytest.mark.parametrize('index,count', [(0, 1), (0, 2), (1, 2), (2, 3),
                                         (None, None)])
def test_host_interval_slice_equals_a2m(index, count):
    from a2m.parallel.mesh import host_interval_slice as jax_slice
    intervals = [str(100 + i) for i in range(11)]
    assert mesh.host_interval_slice(intervals, index, count) == jax_slice(
        intervals, index, count)


@pytest.mark.parametrize('hosts,cards,own_card,index,shared', [
    (['a'] * 8 + ['b'] * 8, 8, False, list(range(8)) * 2, False),
    (['a'] * 16, 8, False, list(range(8)) * 2, True),
    (['a', 'a'], 1, False, [0, 0], True),
    (['a', 'b', 'a', 'b'], 1, True, [0] * 4, False)],
    ids=['2_hosts_of_8', '16_on_8_cards', '2_on_1_card', '1_card_a_process'])
def test_ranks_learn_their_host_and_card(hosts, cards, own_card, index,
                                         shared):
    """Each rank (a thread here, all on one in-memory store) takes card
    ``local rank % cards`` of those it sees, and the ranks pick NCCL
    (nothing shared) over several hosts of ``cards`` cards, or when each
    process sees one card of its own (``own_card``: the cards' UUIDs
    differ), and gloo when ranks outnumber a host's cards."""
    import datetime
    import threading

    import torch.distributed as dist
    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=30))
    world, got = len(hosts), {}

    def rank(r):
        def card_id(i):
            return f'{hosts[r]}/card{r if own_card else i}'
        got[r] = launch._place(store, world, r, hosts[r], cards, card_id)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert [got[r][0] for r in range(world)] == index
    assert {got[r][1] for r in range(world)} == {hosts.count('a')}
    assert {got[r][2] for r in range(world)} == {shared}


def test_one_rank_group(tmp_path, two_threads, no_launch_env):
    """A group of one (gloo, in this process): the bootstrap, ``validate``
    on ``dist.*`` and ``mesh.*``, the host exchanges, and the steps over
    the global batch bit-equal to the same steps run before the group was
    up (a sum over one rank is the value itself), then ``shutdown``."""
    import torch.distributed as dist

    from a2m_torch.models.discriminator import Discriminator
    from a2m_torch.models.generator import Generator
    from a2m_torch.train import __main__ as train_main
    from a2m_torch.train.train_step import init_states, make_train_steps
    dist_args = [f'dist.coordinator=127.0.0.1:{_free_port()}',
                 'dist.num_processes=1', 'dist.process_id=0']
    cfg = apply_overrides(Config(), TINY + dist_args)
    rng = np.random.default_rng(3)
    audio = torch.from_numpy(rng.standard_normal((4, 64, 128)).astype(
        np.float32))
    pose = torch.from_numpy((rng.standard_normal((4, 64, 104)) * 10
                             + 300).astype(np.float32))
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    runs = []

    def run_steps():
        torch.manual_seed(0)
        g, d = Generator(cfg.generator), Discriminator(cfg.discriminator)
        g_state, d_state = init_states(g, d)
        g_step, d_step, eval_step = make_train_steps(g, d, cfg.train)
        args = (audio, pose, torch.zeros(104), torch.full((104,), 10.0))
        _, _, gm = g_step(g_state, d_state, *args, 0.95, 0.01,
                          torch.Generator().manual_seed(1), mask=mask)
        _, _, dm = d_step(g_state, d_state, *args, 0.95, 0.05, 0.01,
                          torch.Generator().manual_seed(2), mask=mask)
        em = eval_step(g_state, d_state, *args, mask)
        runs.append((gm, dm, em, [t.clone() for m in (g, d)
                                  for t in m.state_dict().values()]))

    run_steps()
    lines = []
    try:
        cfg, device = train_main.bootstrap(cfg, 'cpu', log=lines.append)
        assert launch.maybe_initialize(cfg.dist, 'cpu') is True   # no-op
        assert dist.get_world_size() == 1 and not launch.is_distributed()
        assert device == 'cpu' and cfg.data.process_count == -1
        assert lines == ['[dist] process 0/1 up: backend gloo, cpu; trains '
                         'on cpu']
        for item in ('mesh.data=-1', 'mesh.data=1'):
            validate(apply_overrides(cfg, [item]))
        for item, match in (('mesh.data=2', 'A13'), ('mesh.model=2', 'A13b'),
                            ('dist.num_processes=2', 'rank 0 of 1'),
                            ('dist.process_id=1', 'rank 0 of 1')):
            with pytest.raises(ValueError, match=match):
                validate(apply_overrides(cfg, [item]))
        moments = (np.arange(3.0), np.arange(3.0) ** 2, 4)
        got = launch.sync_global_moments(*moments)
        np.testing.assert_array_equal(got[0], moments[0])
        assert got[2] == 4
        launch.host_barrier('one_rank')

        run_steps()
        (gm0, dm0, em0, s0), (gm1, dm1, em1, s1) = runs
        for a, b in ((gm0, gm1), (dm0, dm1), (em0, em1)):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a), (a, b)
        assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    finally:
        launch.shutdown()
    assert not dist.is_initialized()


# ---- the loader's slices -------------------------------------------------------

@pytest.mark.parametrize('index', [0, 1])
def test_synthetic_loader_slices_equal_a2ms_loader(tmp_path, index):
    """``synthetic_loader(process_index=i, process_count=2)`` yields a2m's
    ``DataLoader(process_index=i, process_count=2)`` batches over the files
    of the same fixture, bit for bit, and as many as the other rank."""
    from a2m.data import DataLoader, make_synthetic_pats
    from a2m_torch.data.synthetic import synthetic_loader
    fx = dict(worker.FIXTURE)
    hop, batch = fx.pop('window_hop'), fx.pop('batch_size')
    root = make_synthetic_pats(tmp_path, **fx)
    ref = DataLoader(path2data=root, speaker=list(fx['speakers']),
                     batch_size=batch, window_hop=hop, seed=fx['seed'],
                     process_index=index, process_count=2, use_pallas=False)
    got = synthetic_loader(**worker.FIXTURE, process_index=index,
                           process_count=2)
    other = synthetic_loader(**worker.FIXTURE, process_index=1 - index,
                             process_count=2)
    for split in ('train', 'dev', 'test'):
        pairs = list(zip(getattr(got, split), getattr(ref, split),
                         strict=True))
        assert len(getattr(got, split)) == len(getattr(other, split))
        for g, r in pairs:
            for key in g.keys() - {'meta'}:
                np.testing.assert_array_equal(g[key], r[key])
            assert g['meta'] == r['meta']
    assert len(got.train) == 2
    masks = [b['mask'].sum() for b in got.train]
    assert masks == ([6, 6] if index == 0 else [6, 1])


# ---- two ranks -------------------------------------------------------------------

class _ZipLoader:
    """Two ranks' loaders as one: each batch the concatenation of the
    ranks' batches, as the global batch of a two-rank run."""

    def __init__(self, a, b):
        self.train = _Zip(a.train, b.train)
        self.dev = _Zip(a.dev, b.dev)


class _Zip:
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __len__(self):
        return min(len(self.a), len(self.b))

    def __iter__(self):
        for x, y in zip(self.a, self.b, strict=True):
            yield {k: np.concatenate([x[k], y[k]]) for k in x
                   if k != 'meta'}


def _one_process_run(save_dir):
    """The port's trainer in this process on the concatenated batches,
    with the two ranks' summed moments, and every step's metrics."""
    from a2m_torch.data.normalization import (finalize_moments_necksub,
                                              get_moments_necksub)
    from a2m_torch.data.synthetic import synthetic_loader
    from a2m_torch.train.loop import Trainer
    def ranks():
        return [synthetic_loader(**worker.FIXTURE, process_index=i,
                                 process_count=2) for i in range(2)]

    # each rank's moments come from its loader's first pass, as the
    # trainer takes them (the train sampler draws a new order each pass)
    moments = [get_moments_necksub(r.train) for r in ranks()]
    mean, std = finalize_moments_necksub(*(a + b for a, b in zip(*moments)))
    cfg = validate(apply_overrides(Config(), TINY + [
        f'train.save_dir={save_dir}']))
    trainer = Trainer.from_config(cfg, _ZipLoader(*ranks()), device='cpu',
                                  log=lambda line: None)
    trainer.mean, trainer.std = torch.from_numpy(mean), torch.from_numpy(std)
    initial = [{k: v.clone() for k, v in s.model.state_dict().items()}
               for s in (trainer.g_state, trainer.d_state)]
    steps, first = [], []
    plain = trainer._step

    def recording(kind, measuring, step, *args, **kwargs):
        if not first:               # (g_state, d_state, audio, pose, ...)
            first.extend([args[2].numpy(), args[3].numpy(),
                          kwargs['mask'].numpy()])
        out = plain(kind, measuring, step, *args, **kwargs)
        steps.append((kind, {k: float(v) for k, v in out[-1].items()}))
        return out

    trainer._step = recording
    trainer.fit()
    return SimpleNamespace(trainer=trainer, steps=steps, initial=initial,
                           first=first, mean=mean, std=std)


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """Both ranks' results, and the one-process run made while they ran."""
    tmp = tmp_path_factory.mktemp('two_ranks')
    out = tmp / 'out'
    out.mkdir()
    port = _free_port()
    procs = []
    for rank in range(2):
        cwd = tmp / f'rank{rank}'           # a working directory of its own
        cwd.mkdir()
        env = dict(os.environ, A2M_COORDINATOR=f'127.0.0.1:{port}',
                   A2M_NUM_PROCESSES='2', A2M_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS='2', PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / 'tests' / 'torch_dist_worker.py'),
             str(out), f'train.save_dir={tmp / "save_shared"}',
             'mesh.data=-1'] + TINY,
            env=env, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            single = _one_process_run(tmp / 'save_single')
        finally:
            torch.set_num_threads(threads)
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{log[-4000:]}'
    ranks = []
    for rank in range(2):
        with np.load(out / f'rank{rank}.npz') as z:
            arrays = {k: z[k] for k in z.files}
        ranks.append(SimpleNamespace(
            **json.loads((out / f'rank{rank}.json').read_text()),
            arrays=arrays))
    return SimpleNamespace(ranks=ranks, single=single, save=tmp / 'save_shared')


def test_two_ranks_agree_bit_for_bit(two_ranks):
    """Every metric a step returns, the controller's histories, the loss
    history, mean/std, the parameters and BatchNorm buffers: equal on both
    ranks.  Rank 0 alone logs and writes; a two-rank resume restores the
    state bit for bit."""
    r0, r1 = two_ranks.ranks
    assert (r0.rank, r1.rank, r0.world, r1.world) == (0, 1, 2, 2)
    assert r0.data == r1.data == [None, -1]
    assert r0.train_batches == r1.train_batches == 2
    assert r0.dev_batches == r1.dev_batches == 2
    assert len(r0.steps) == len(r1.steps) > 8
    assert r0.steps == r1.steps
    assert r0.g_history == r1.g_history and r0.d_history == r1.d_history
    assert r0.loss_history == r1.loss_history
    for key in r0.arrays:
        if key.startswith('state/') or key in ('mean', 'std'):
            np.testing.assert_array_equal(r0.arrays[key], r1.arrays[key],
                                          err_msg=key)
    assert r0.resumed_epoch == r1.resumed_epoch == 2
    assert r0.resumed_same and r1.resumed_same
    # rank 1 says only its [dist] line; rank 0 narrates, its MFU per rank
    assert r1.lines == ['[dist] process 1/2 up: backend gloo, cpu; trains '
                        'on cpu']
    assert r0.lines[0].startswith('[dist] process 0/2 up: backend gloo')
    assert any(line.startswith('g_step: ') and line.endswith(
        'per rank of 2') for line in r0.lines)
    assert sorted(p.name for p in (two_ranks.save / 'ckpt').iterdir()) == [
        'best_gen.npz', 'epoch_0.pt', 'epoch_1.pt']
    assert (two_ranks.save / 'loss.npy').is_file()


def test_sharded_steps_equal_one_process_steps(two_ranks, two_threads):
    """One ``g_step`` and one ``d_step`` on two ranks (rows 4 + 4, mask sums
    4 and 2, label noise on) against the port's steps in one process on
    the concatenated batch, in float64: the metrics within 1e-12, every
    gradient (the summed one each rank hands the optimiser) within 1e-9 of
    its tensor's max and of no less than 1e-3 of the largest tensor's max
    (a bias ahead of a train-mode BatchNorm has a gradient of rounding
    only), the BatchNorm buffers within 1e-12 of their max.  Measured: 3e-13 of the
    largest at worst; a lost cross-rank term of the BatchNorm moments or an
    averaged gradient is off by 1e-2 or more."""
    from torch_parity import assert_grads_close
    ref = worker.sgd_steps(slice(None))
    a0, a1 = (r.arrays for r in two_ranks.ranks)
    checked = 0
    for prefix in ('g', 'd'):
        metrics = [k for k in ref if k.startswith(f'{prefix}_metric/')]
        assert len(metrics) >= 3
        for k in metrics:
            assert a0[k] == a1[k], k
            np.testing.assert_allclose(a0[k], ref[k], rtol=1e-12, err_msg=k)
        grads = {k: v for k, v in ref.items()
                 if k.startswith(f'{prefix}_grad/')}
        for k in grads:
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
        assert_grads_close({k: a0[k] for k in grads}, grads, tol=1e-9)
        checked += len(grads)
    buffers = [k for k in ref if k.startswith('buffer/')]
    assert len(buffers) > 20 and checked > 100
    for k in buffers:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
        np.testing.assert_allclose(a0[k], ref[k], rtol=0,
                                   atol=1e-12 * np.abs(ref[k]).max(),
                                   err_msg=k)


def test_two_ranks_train_as_one_process_on_the_global_batches(two_ranks):
    """``run()`` on two ranks against the port's one-process trainer on the
    concatenated batches: the same statistics and step sequence, the first
    step's metrics within 1e-5.  After it the two differ by the last bits
    of their sums, which Adam's first update, -lr * g / (|g| + 1e-8),
    turns into +-lr on every element whose gradient is rounding, and the
    adversarial updates amplify; the controller's loss histories are held
    to the bounds a2m's own two-process test holds its run to
    (tests/test_distributed.py: G 5e-2, D 1e-1)."""
    r0 = two_ranks.ranks[0]
    single = two_ranks.single
    np.testing.assert_array_equal(r0.arrays['mean'], single.mean)
    np.testing.assert_array_equal(r0.arrays['std'], single.std)
    assert [k for k, _ in r0.steps] == [k for k, _ in single.steps]
    assert r0.steps[0][0] == 'g'
    got, ref = r0.steps[0][1], single.steps[0][1]
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    controller = single.trainer.controller
    assert len(r0.g_history) == len(controller.g_loss_history) == 4
    np.testing.assert_allclose(r0.g_history, controller.g_loss_history,
                               rtol=5e-2)
    np.testing.assert_allclose(r0.d_history, controller.d_loss_history,
                               rtol=1e-1)


def test_first_g_loss_matches_a2m(two_ranks):
    """a2m's one-process G loss (what its Trainer's first ``g_step``
    takes the gradient of: the train-mode forwards of G and D, the labels,
    the kinematic losses, assembled from ``a2m/train/train_step.py``'s own
    functions as its ``loss_fn`` is) on the first global batch, from the
    port's initial variables and the same statistics: within 1e-3 of the
    two ranks' first G loss.  (The jitted step itself, from a2m's
    ``init_states``, compiles for ~45 s here; test_torch_train_step holds
    the port's ``g_step`` to it.)"""
    import jax
    import jax.numpy as jnp

    from a2m.config import DiscriminatorConfig as JaxD
    from a2m.config import GeneratorConfig as JaxG
    from a2m.models import Discriminator, Generator
    from a2m.models import losses as JL
    from a2m.nn import masking as jmasking
    from a2m.train import train_step as jsteps
    from a2m_torch.train.controller import DynamicGANTraining
    from a2m_torch.weights import to_jax_variables
    from torch_parity import unflatten

    single = two_ranks.single
    cfg = single.trainer.cfg
    g_model = Generator(JaxG(in_channels=16, out_channels=16,
                             joint_feat_dim=8, gat_heads=2, dropout=0.0))
    d_model = Discriminator(JaxD(out_channels=8, joint_feat_dim=8,
                                 gat_heads=2, dropout=0.0))
    variables = []
    for module, initial in ((single.trainer.g_state.model, single.initial[0]),
                            (single.trainer.d_state.model, single.initial[1])):
        module.load_state_dict(initial)
        variables.append(unflatten(to_jax_variables(module)))
    smooth = DynamicGANTraining(cfg.controller).label_params(
        0, is_real=True).smooth_real
    key = jax.random.PRNGKey(0)

    @jax.jit
    def g_loss(g_vars, d_vars, audio, pose, mean, std, mask):
        real_pose = jsteps.normalize_pose_device(pose, mean, std)
        real_motion = JL.pos_to_motion(real_pose)
        with jmasking.batch_mask(mask):
            fake_pose, _ = jsteps._apply_g(
                g_model, g_vars['params'], g_vars['batch_stats'], audio, key,
                True)
            fake_motion = JL.pos_to_motion(fake_pose)
            fake_d, _, _ = jsteps._apply_d(
                d_model, d_vars['params'], d_vars['batch_stats'],
                fake_motion, key, True)
        valid = jsteps.smooth_labels(key, audio.shape[0], fake_d.shape[-1],
                                     smooth, 0.0, is_real=True)
        kin = jsteps.masked_motion_losses(real_pose, real_motion, fake_pose,
                                          fake_motion, mask)
        t = cfg
        return (kin['reg'] + t.lambda_gan * JL.masked_mean(
            (fake_d - valid) ** 2, mask) + t.lambda_smooth * kin['smooth']
            + t.lambda_jerk * kin['jerk'] + kin['bone'] + kin['angle']
            + t.lambda_pos * kin['pos'])

    audio, pose, mask = single.first
    ref = float(g_loss(*variables, audio, pose, single.mean, single.std,
                       jnp.asarray(mask)))
    np.testing.assert_allclose(two_ranks.ranks[0].steps[0][1]['g_loss'], ref,
                               rtol=1e-3)


def test_global_batchnorm_equals_a2m_on_the_concatenated_batch(two_ranks):
    """Train-mode ``MaskedBatchNorm`` on each rank's rows inside the global
    batch: outputs, input gradients, the summed parameter gradients and
    the running statistics of a2m's on the concatenated batch (1e-5)."""
    import jax
    import jax.numpy as jnp

    from a2m.nn.masking import MaskedBatchNorm
    g = worker.unit_inputs()
    bn = MaskedBatchNorm()
    stats = {'mean': jnp.zeros(worker.C), 'var': jnp.ones(worker.C)}

    def loss(x, params):
        y, new = bn.apply({'params': params, 'batch_stats': stats}, x,
                          mask=jnp.asarray(g['mask']),
                          mutable=['batch_stats'])
        return (y * g['r']).sum(), (y, new['batch_stats'])

    (_, (y, new)), (dx, dparams) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(g['x']), {'scale': jnp.asarray(g['weight']),
                                  'bias': jnp.asarray(g['bias'])})
    a0, a1 = (r.arrays for r in two_ranks.ranks)
    cat = lambda k: np.concatenate([a0[k], a1[k]])  # noqa: E731
    np.testing.assert_allclose(cat('bn_y'), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(cat('bn_dx'), np.asarray(dx), atol=1e-5)
    np.testing.assert_allclose(a0['bn_dweight'] + a1['bn_dweight'],
                               np.asarray(dparams['scale']), atol=1e-5)
    np.testing.assert_allclose(a0['bn_dbias'] + a1['bn_dbias'],
                               np.asarray(dparams['bias']), atol=1e-5)
    for name, key in (('bn_running_mean', 'mean'), ('bn_running_var', 'var')):
        np.testing.assert_array_equal(a0[name], a1[name])
        np.testing.assert_allclose(a0[name], np.asarray(new[key]), atol=1e-5)


def test_masked_mean_with_unequal_mask_sums(two_ranks):
    """Rank 0 holds 3 valid rows of 4, rank 1 one: each rank's term over the
    global mask sum adds up to a2m's ``masked_mean`` on the concatenated
    batch; averaging the ranks' own means does not."""
    import jax.numpy as jnp

    from a2m.models.losses import masked_mean
    g = worker.unit_inputs()
    ref = float(masked_mean(jnp.asarray(g['per_sample']),
                            jnp.asarray(g['mask'])))
    a0, a1 = (r.arrays for r in two_ranks.ranks)
    np.testing.assert_allclose(a0['mm_term'] + a1['mm_term'], ref, rtol=1e-6)
    assert a0['mm_global'] == a1['mm_global']
    np.testing.assert_allclose(a0['mm_global'], ref, rtol=1e-6)
    naive = (a0['mm_own'] + a1['mm_own']) / 2
    assert abs(naive - ref) > 1e-2 * abs(ref), (naive, ref)


def test_label_noise_is_rows_of_the_global_draw(two_ranks):
    from a2m_torch.train.train_step import smooth_labels
    ref = smooth_labels(torch.Generator().manual_seed(5), 2 * worker.B, 3,
                        0.9, 0.05, is_real=True).numpy()
    for r in two_ranks.ranks:
        rows = slice(r.rank * worker.B, (r.rank + 1) * worker.B)
        np.testing.assert_array_equal(r.arrays['noise'], ref[rows])


def test_dropout_is_seeded_per_rank(two_ranks):
    """The trainer seeds the default generator with ``seed + rank``: the
    ranks draw different dropout masks, each the one that seed gives."""
    a0, a1 = (r.arrays['dropout'] for r in two_ranks.ranks)
    assert not np.array_equal(a0, a1)
    for rank, got in enumerate((a0, a1)):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rank)
            ref = torch.nn.functional.dropout(torch.ones(256), 0.5).numpy()
        np.testing.assert_array_equal(got, ref)
