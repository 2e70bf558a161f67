"""The port's tensor parallelism (a2m's ``TP_RULES`` over a (data, model)
grid of ranks; a2m_torch/parallel/mesh.py, parallel/tensor.py, the sharded
layers) against a2m's unsharded step and the port's one-process run, on the
CPU with gloo.

Ranks run ``tests/torch_tp_worker.py`` through the entry points a user
calls, at the tiny widths of tests/test_parallel.py (G ``in_channels=16``,
D ``out_channels=8``, ``joint_feat_dim=8``, two heads), each with its own
working directory, a free port and a timeout on every wait: two ranks at
``mesh.model=2`` (1 x 2) and four at 2 x 2.  a2m's one global program
shards the same ten kernels; here every rank holds its slices and the
model group's collectives stand in for GSPMD's.
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

from a2m_torch.config import Config, apply_overrides, validate
from a2m_torch.parallel import mesh

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_tp_worker as worker  # noqa: E402

TINY = [
    'generator.in_channels=16', 'generator.out_channels=16',
    'generator.joint_feat_dim=8', 'generator.gat_heads=2',
    'generator.dropout=0', 'discriminator.out_channels=8',
    'discriminator.joint_feat_dim=8', 'discriminator.gat_heads=2',
    'discriminator.dropout=0', 'train.n_epochs=2',
    'train.log_every_batches=1', 'train.controller.max_noise_std=0',
    'train.controller.min_noise_std=0']
TP = ['mesh.model=2', 'mesh.data=-1']
#: the trainer runs' learning rates.  At the default ones this tiny GAN in
#: f32 is chaotic: Adam's first update, -lr * g / (|g| + 1e-8), turns the
#: last bits of a sum into +-lr on every element whose gradient is
#: rounding, and the adversarial updates amplify that; one process on 1
#: and 3 intra-op threads differs by 14% in D's sixth loss.  At 1e-6 the
#: same two runs differ by 1.8e-4 at most.
SLOW_LR = ['train.controller.g_lr=1e-6', 'train.controller.d_lr=1e-6']
#: seconds the ranks may take (about 10-20 s each on an idle 8-core CPU)
RANK_TIMEOUT_S = 240
#: the probe's tolerance: of each tensor's max, and of no less than 1e-3 of
#: the largest tensor's max of its kind (a bias ahead of a train-mode
#: BatchNorm has a gradient of rounding only)
PROBE_TOL, PROBE_FLOOR = 1e-9, 1e-3
#: Adam's eps and learning rates (init_states): its first update
#: lr * g / (|g| + eps) turns a gradient difference dg of an element near
#: 0 into up to lr * dg / eps
ADAM_EPS, LR = 1e-8, {'g': 5e-4, 'd': 1e-3}

#: a2m's leaves under TP_RULES in the tiny G and D, torch names
SHARDED = {
    'g': {'unet.bottleneck.conv.weight': 0,
          'unet.bottleneck_attention.query.weight': 1,
          'unet.bottleneck_attention.key.weight': 1,
          'unet.bottleneck_attention.value.weight': 1,
          'unet.up0.weight': 0},
    'd': {'conv3b.conv.weight': 0, 'conv3_attn.query.weight': 1,
          'conv3_attn.key.weight': 1, 'conv3_attn.value.weight': 1,
          'conv3c.conv.weight': 1}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    """Two intra-op threads for this module's own steps (the ranks set
    their own)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _start(world: int, spec: dict, tmp: Path) -> list:
    """``world`` rank processes of the worker on ``spec``; returns their
    Popen handles."""
    out = tmp / 'out'
    out.mkdir()
    (tmp / 'spec.json').write_text(json.dumps(dict(spec, out=str(out))))
    port = _free_port()
    procs = []
    for rank in range(world):
        cwd = tmp / f'rank{rank}'           # a working directory of its own
        cwd.mkdir()
        env = dict(os.environ, A2M_COORDINATOR=f'127.0.0.1:{port}',
                   A2M_NUM_PROCESSES=str(world), A2M_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS='2', PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / 'tests' / 'torch_tp_worker.py'),
             str(tmp / 'spec.json')], env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs: list, tmp: Path) -> list:
    """Wait for the ranks (each within RANK_TIMEOUT_S), kill any left, and
    load their results."""
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{log[-4000:]}'
    ranks = []
    for rank in range(len(procs)):
        with np.load(tmp / 'out' / f'rank{rank}.npz') as z:
            arrays = {k: z[k] for k in z.files}
        ranks.append(SimpleNamespace(**json.loads(
            (tmp / 'out' / f'rank{rank}.json').read_text()), arrays=arrays))
    return ranks


def _a2m_variables(tmp: Path) -> tuple:
    """a2m's tiny G and D and their states with seeded random variables,
    which are also written to ``tmp`` for the ranks."""
    import jax

    from a2m.config import DiscriminatorConfig as JaxDConfig
    from a2m.config import GeneratorConfig as JaxGConfig
    from a2m.models import Discriminator as JaxD
    from a2m.models import Generator as JaxG
    from a2m.train import train_step as jsteps
    from torch_parity import randomize, unflatten
    rng = np.random.default_rng(7)
    g_model = JaxG(JaxGConfig(**worker.TINY_G))
    d_model = JaxD(JaxDConfig(**worker.TINY_D))
    g0, d0 = jsteps.init_states(g_model, d_model, jax.random.PRNGKey(0),
                                batch_size=worker.ROWS)
    flats = {}
    for name, state in (('g', g0), ('d', d0)):
        flats[name] = randomize({'params': state.params,
                                 'batch_stats': state.batch_stats}, rng)
        np.savez(tmp / f'{name}.npz', **flats[name])
    gv, dv = unflatten(flats['g']), unflatten(flats['d'])
    g0 = g0._replace(params=gv['params'], batch_stats=gv['batch_stats'])
    d0 = d0._replace(params=dv['params'], batch_stats=dv['batch_stats'])
    return (g_model, d_model), (g0, d0), flats


def _a2m_steps(models, states) -> dict:
    """a2m's unsharded jitted ``g_step`` then ``d_step`` on the probe's
    global batch, label noise 0: the losses and the parameters after."""
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from a2m.config import TrainConfig as JaxTrainConfig
    from a2m.train import train_step as jsteps
    g0, d0 = states
    g_step, d_step, _ = jsteps.make_train_steps(
        *models, JaxTrainConfig(fused_gcn_eval=False), donate=False)
    audio, pose, mean, std = (jnp.asarray(a) for a in worker.global_batch())
    mask = jnp.asarray(worker.MASK)
    new_g, new_d_bs, gm = g_step(g0, d0, audio, pose, mean, std,
                                 worker.SMOOTH_R, 0.0, jax.random.PRNGKey(1),
                                 mask=mask)
    new_d, new_g2, dm = d_step(new_g, d0._replace(batch_stats=new_d_bs),
                               audio, pose, mean, std, worker.SMOOTH_R,
                               worker.SMOOTH_F, 0.0, jax.random.PRNGKey(2),
                               mask=mask)
    params = {}
    for name, state in (('g', new_g2), ('d', new_d)):
        params[name] = {
            'params/' + k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(state.params, sep='/').items()}
    return dict(g_loss=float(gm['g_loss']), d_loss=float(dm['d_loss']),
                params=params)


def _port_run(save_dir: Path):
    """The port's trainer in this process, one process, on the fixture:
    every step's metrics and the final state."""
    from a2m_torch.data.synthetic import synthetic_loader
    from a2m_torch.train.loop import Trainer
    cfg = validate(apply_overrides(Config(), TINY + SLOW_LR + [
        f'train.save_dir={save_dir}']))
    trainer = Trainer.from_config(cfg, synthetic_loader(**worker.FIXTURE),
                                  device='cpu', log=lambda line: None)
    steps = []
    plain = trainer._step

    def recording(kind, measuring, step, *args, **kwargs):
        out = plain(kind, measuring, step, *args, **kwargs)
        steps.append((kind, {k: float(v) for k, v in out[-1].items()}))
        return out

    trainer._step = recording
    init = {f'{net}/{k}': p.detach().numpy().copy() for net, s in
            (('g', trainer.g_state), ('d', trainer.d_state))
            for k, p in s.model.named_parameters()}
    trainer.fit()
    state = {f'{net}/{k}': v.numpy().copy() for net, s in
             (('g', trainer.g_state), ('d', trainer.d_state))
             for k, v in s.model.state_dict().items()}
    return SimpleNamespace(steps=steps, state=state, init=init, cfg=cfg,
                           g_history=list(trainer.controller.g_loss_history),
                           d_history=list(trainer.controller.d_loss_history))


def _one_process_steps(flats=None, dtype=torch.float32) -> dict:
    g, d = worker.models(dtype, flats)
    return worker.steps(g, d, slice(None), 0.0, shard=False,
                        tensor_dtype=torch.float32)


@pytest.fixture(scope='module')
def grids(tmp_path_factory):
    """Two ranks at ``mesh.model=2`` (one data rank) and four at 2 x 2, all
    six started at once, and, while they run, what they are held to: a
    one-process trainer run (the two ranks resume its checkpoint once it
    has ended), a2m's unsharded step and the port's one-process steps."""
    tmp = tmp_path_factory.mktemp('grids')
    for name in ('a2m', '1x2', '2x2'):
        (tmp / name).mkdir()
    models, states, flats = _a2m_variables(tmp / 'a2m')
    single_dir = tmp / 'save_single'
    procs = {
        '1x2': _start(2, dict(
            overrides=TINY + TP + SLOW_LR + [
                f'train.save_dir={tmp / "save_tp"}'],
            flats=str(tmp / 'a2m'), train=True, single=str(single_dir)),
            tmp / '1x2'),
        '2x2': _start(4, dict(overrides=TINY + TP), tmp / '2x2')}
    try:
        single = _port_run(single_dir)
        (single_dir / 'done').write_text('')
        a2m = _a2m_steps(models, states)
        g, d = worker.models()
        probe = worker.steps(g.double(), d.double(), slice(None), 0.01,
                             worker.CLIP, shard=False)
        f32 = _one_process_steps(flats)
        bf16 = _one_process_steps(flats, torch.bfloat16)
        dropout = worker.dropout_forwards(False)
    finally:
        ranks = {k: _finish(p, tmp / k) for k, p in procs.items()}
    return SimpleNamespace(
        grid_1x2=SimpleNamespace(
            ranks=ranks['1x2'], single=single, a2m=a2m, probe=probe,
            f32=f32, bf16=bf16, dropout=dropout, save_tp=tmp / 'save_tp'),
        grid_2x2=SimpleNamespace(ranks=ranks['2x2'], probe=probe))


@pytest.fixture(scope='module')
def grid_1x2(grids):
    return grids.grid_1x2


@pytest.fixture(scope='module')
def grid_2x2(grids):
    return grids.grid_2x2


# ---- the rules ---------------------------------------------------------------

@pytest.mark.parametrize('net', ['g', 'd'])
def test_param_spec_names_a2ms_dimension(net):
    """For every parameter of the tiny G and D the port's ``param_spec``
    names the torch dimension that a2m's ``param_spec`` names on the a2m
    path, taken through ``weights.py``'s layout transpose; ten kernels are
    sharded, the GCN stacks and every other leaf replicated."""
    from a2m.parallel.mesh import param_spec as a2m_param_spec
    from a2m_torch.weights import jax_key
    g, d = worker.models()
    model = g if net == 'g' else d
    got = {}
    for name, p in model.named_parameters():
        path, axes = jax_key(model, name)
        shape = p.shape if axes is None else tuple(p.shape[a] for a in axes)
        spec = tuple(a2m_param_spec(path.split('/', 1)[1], shape))
        want = None
        if 'model' in spec:
            a = spec.index('model')
            want = a if axes is None else axes[a]
        assert mesh.param_spec(model, name) == want, (name, spec)
        if want is not None:
            got[name] = want
    assert got == SHARDED[net]
    assert mesh.param_shardings(model) == {
        k: SHARDED[net].get(k) for k, _ in model.named_parameters()}


@pytest.mark.parametrize('overrides,world,match', [
    (TP, 1, 'in one process: .* torchrun --nproc_per_node 2'),
    (['mesh.model=4', 'mesh.data=-1'], 2, r'mesh 1x4 .* 2 ranks'),
    (['mesh.model=2', 'mesh.data=2'], 2, r'mesh 2x2 .* 2 ranks'),
    (['mesh.model=3', 'mesh.data=-1'], 3,
     'does not divide the 128 channels .* unet.bottleneck.conv.weight'),
    (['mesh.model=3', 'mesh.data=-1', 'generator.in_channels=24'], 3,
     'does not divide the 256 channels .* conv3b.conv.weight'),
    (TP + ['discriminator.groups=2'], 2,
     'conv3b: .*grouped convolution does not shard'),
], ids=['one_process', 'data_x_model', 'pinned_data', 'g_width',
        'd_width', 'd_groups'])
def test_validate_refuses_a_grid_that_does_not_fit(monkeypatch, overrides,
                                                    world, match):
    """``validate`` in a group of ``world`` ranks (a stand-in: the checks
    read only the rank and the world size) and in one process."""
    import torch.distributed as dist
    cfg = apply_overrides(Config(), [
        'generator.in_channels=16', 'discriminator.out_channels=8'])
    if world > 1:
        monkeypatch.setattr(dist, 'is_initialized', lambda: True)
        monkeypatch.setattr(dist, 'get_rank', lambda group=None: 0)
        monkeypatch.setattr(dist, 'get_world_size',
                            lambda group=None: world)
    with pytest.raises(ValueError, match=match):
        validate(apply_overrides(cfg, overrides))
    if world > 1:
        validate(apply_overrides(cfg, ['mesh.data=-1', 'mesh.model=1']))


# ---- two ranks, 1 x 2 --------------------------------------------------------

def test_each_rank_holds_its_half_of_the_ten_kernels(grid_1x2):
    """Each rank holds half of every kernel TP_RULES name and of its Adam
    moments (the column-parallel BatchNorms' running statistics too), and
    every other tensor whole."""
    full = {}
    g, d = worker.models()
    for net, model in (('g', g), ('d', d)):
        full.update({f'{net}/{k}': list(v.shape)
                     for k, v in model.state_dict().items()})
    halves = {f'{net}/{k}': dim for net, keys in SHARDED.items()
              for k, dim in keys.items()}
    halves.update({f'{net}/{layer}.{bn}.{stat}': 0 for net, layer, bn in (
        ('g', 'unet.bottleneck', 'norm'), ('d', 'conv3b', 'bn'))
        for stat in ('running_mean', 'running_var')})
    for r in grid_1x2.ranks:
        shapes = r.probe_shapes
        for key, shape in full.items():
            want = list(shape)
            if key in halves:
                want[halves[key]] //= 2
            assert shapes[key] == want, key
            net, name = key.split('/', 1)
            adam = f'{net}/adam/{name}'
            if adam in shapes:
                assert shapes[adam] == want, adam
        assert r.train_shapes['unet.bottleneck.conv.weight'][0] == \
            full['g/unet.bottleneck.conv.weight'][0] // 2


def _assert_probe(got: dict, ref: dict, got_metrics: dict,
                  ref_metrics: dict) -> None:
    """The TP probe against the one-process probe: metrics within
    PROBE_TOL; every gathered parameter, BatchNorm statistic and Adam
    moment within PROBE_TOL of its tensor's max (floored by kind), a
    parameter also within what Adam's 1/eps makes of its gradient's
    difference."""
    for k, v in ref_metrics.items():
        assert abs(got_metrics[k] - v) <= PROBE_TOL * abs(v), k
    kinds: dict = {}
    for k in ref:
        kind = k.rsplit('/', 1)[1] if '/adam/' in k else k.split('/')[1]
        kinds.setdefault((k[0], kind), []).append(k)
    for (net, kind), keys in kinds.items():
        floor = PROBE_FLOOR * max(np.abs(ref[k]).max() for k in keys)
        for k in keys:
            err = np.abs(got[k] - ref[k])
            tol = PROBE_TOL * max(np.abs(ref[k]).max(), floor)
            if kind == 'state' and f'{net}/adam/{k[8:]}/exp_avg' in ref:
                m = f'{net}/adam/{k[8:]}/exp_avg'
                dg = np.abs(got[m] - ref[m]) / 0.1     # Adam's b1 = 0.9
                tol = tol + LR[net] * dg / ADAM_EPS
            assert (err <= tol).all(), (k, err.max(), np.max(tol))


def test_two_ranks_step_as_one_process_in_float64(grid_1x2):
    """One ``g_step`` and one ``d_step`` on two model ranks (float64,
    dropout 0, label noise on, a clip that bites, a ragged mask) against
    the port's one-process steps: losses, every gathered parameter, Adam
    moment and BatchNorm statistic within 1e-9; both ranks equal."""
    r0, r1 = grid_1x2.ranks
    ref = grid_1x2.probe
    keys = [k for k in r0.arrays if k.startswith('probe/')]
    assert len(keys) == len(ref['arrays']) > 500
    for k in keys:
        np.testing.assert_array_equal(r0.arrays[k], r1.arrays[k], err_msg=k)
    assert r0.probe_metrics == r1.probe_metrics
    _assert_probe({k[6:]: r0.arrays[k] for k in keys}, ref['arrays'],
                  r0.probe_metrics, ref['metrics'])


def test_two_ranks_step_as_a2ms_unsharded_step(grid_1x2):
    """One f32 ``g_step`` + ``d_step`` on two model ranks from a2m's
    randomised variables against a2m's unsharded jitted steps, at a2m's
    own tolerances for its sharded steps (tests/test_parallel.py:144-157):
    losses within 1e-3, every parameter after the steps within 2.1e-3 and
    2e-5 on average."""
    from a2m_torch.weights import to_jax_variables
    r0 = grid_1x2.ranks[0]
    a2m = grid_1x2.a2m
    assert r0.a2m_metrics['g/g_loss'] == pytest.approx(a2m['g_loss'],
                                                       rel=1e-3)
    assert r0.a2m_metrics['d/d_loss'] == pytest.approx(a2m['d_loss'],
                                                       rel=1e-3)
    g, d = worker.models()
    diffs = []
    for net, model in (('g', g), ('d', d)):
        state = {k: torch.from_numpy(r0.arrays[f'a2m/{net}/state/{k}'])
                 for k in model.state_dict()}
        got = to_jax_variables(model, state)
        for k, want in a2m['params'][net].items():
            diffs.append(np.abs(got[k] - want))
    assert len(diffs) > 150
    assert max(x.max() for x in diffs) < 2.1e-3
    assert sum(x.sum() for x in diffs) / sum(x.size for x in diffs) < 2e-5


def test_bf16_step_in_a_group_within_the_bf16_gap(grid_1x2):
    """The bf16 step on two model ranks: its losses' gap to the port's f32
    one-process step within 2x the one-process bf16 step's gap, in mean
    and in median (ROADMAP queue C watch item 3: never the batch max)."""
    r0 = grid_1x2.ranks[0]
    f32, bf16 = grid_1x2.f32['metrics'], grid_1x2.bf16['metrics']
    keys = sorted(f32)
    assert len(keys) == 9
    got = np.array([r0.bf16_metrics[k] for k in keys])
    ref32 = np.array([f32[k] for k in keys])
    gap = np.abs(np.array([bf16[k] for k in keys]) - ref32)
    assert gap.max() > 0
    d = np.abs(got - ref32)
    assert d.mean() <= 2 * gap.mean(), (d, gap)
    assert np.median(d) <= 2 * np.median(gap), (d, gap)


def test_dropout_follows_one_process(grid_1x2):
    """With one data rank, G and D in train mode with dropout on: the two
    model ranks draw the masks one process draws, at the full width, with
    and without autograd (channel-last and channel-first outputs)."""
    for r in grid_1x2.ranks:
        for k, ref in grid_1x2.dropout.items():
            np.testing.assert_allclose(r.arrays[f'dropout/{k}'], ref,
                                       rtol=0, atol=1e-12, err_msg=k)


def test_trainer_at_model_2_runs_as_one_process(grid_1x2):
    """``run()`` at ``mesh.model=2`` over two ranks against the port's
    one-process trainer on the same batches (learning rates SLOW_LR), at
    the tolerances of a2m's mesh-vs-single trainer test
    (tests/test_train.py:624-636): the same step sequence, the first G and
    D losses within 5e-3, the loss sequences within 1e-2 (the first step's
    metrics also within 1e-5); both ranks equal; the kernels end where one
    process's do, within a tenth of how far they moved."""
    r0, r1 = grid_1x2.ranks
    single = grid_1x2.single
    assert r0.steps == r1.steps and r0.g_history == r1.g_history
    assert [k for k, _ in r0.steps] == [k for k, _ in single.steps]
    assert r0.steps[0][0] == 'g'
    got, ref = r0.steps[0][1], single.steps[0][1]
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    assert len(r0.g_history) == len(single.g_history) >= 4
    np.testing.assert_allclose(r0.g_history[0], single.g_history[0],
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(r0.d_history[0], single.d_history[0],
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(r0.g_history, single.g_history, rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(r0.d_history, single.d_history, rtol=1e-2,
                               atol=1e-3)
    assert r0.lines[0].endswith('Mesh(1x2, rank 0: data 0, model 0)')
    # the parameters the runs end with: every kernel (each leaf of two or
    # more dimensions, the ten sliced ones among them) within a tenth of
    # how far the one-process run moved it, on the mean.  A rank whose
    # Adam held other tensors than its model's slices would leave them
    # where they started: a difference equal to the movement.  (A bias
    # ahead of a train-mode BatchNorm has a gradient of rounding only,
    # which Adam turns into +-lr either way.)
    kernels = [k for k, v in single.init.items() if v.ndim >= 2]
    assert {f'{net}/{k}' for net, leaves in SHARDED.items()
            for k in leaves} <= set(kernels)
    ratio = {}
    for k in kernels:
        moved = np.abs(single.state[k] - single.init[k]).mean()
        assert moved > 0, k
        ratio[k] = np.abs(r0.arrays[f'train/{k}'] - single.state[k]).mean() \
            / moved
    worst = max(ratio, key=ratio.get)
    assert ratio[worst] < 0.1, (worst, ratio[worst])


def test_checkpoints_keep_the_one_process_layout(grid_1x2):
    """The two-rank run's checkpoint (rank 0 writes the gathered state)
    resumes in one process bit for bit, and a one-process run's resumes on
    the two ranks, each taking its slices."""
    from a2m_torch.data.synthetic import synthetic_loader
    from a2m_torch.train.loop import Trainer
    r0 = grid_1x2.ranks[0]
    cfg = apply_overrides(grid_1x2.single.cfg,
                          [f'train.save_dir={grid_1x2.save_tp}'])
    resumed = Trainer.from_config(cfg, synthetic_loader(**worker.FIXTURE),
                                  device='cpu', log=lambda line: None)
    assert resumed.start_epoch == 2
    assert sorted(p.name for p in (grid_1x2.save_tp / 'ckpt').iterdir()) == [
        'best_gen.npz', 'epoch_0.pt', 'epoch_1.pt']
    n = 0
    for net, s in (('g', resumed.g_state), ('d', resumed.d_state)):
        for k, v in s.model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(),
                                          r0.arrays[f'train/{net}/{k}'],
                                          err_msg=k)
            n += 1
    assert n > 300
    for r in grid_1x2.ranks:
        assert r.single_resumed_epoch == 2
        for key, v in grid_1x2.single.state.items():
            np.testing.assert_array_equal(r.arrays[f'from_single/{key}'], v,
                                          err_msg=key)


# ---- four ranks, 2 x 2 -------------------------------------------------------

def test_four_ranks_step_as_one_process_in_float64(grid_2x2):
    """Two data ranks of two model ranks (rows 2 + 2, mask sums 2 and 1):
    the same float64 probe within 1e-9 of one process; every rank gathers
    the same state."""
    ranks = grid_2x2.ranks
    assert [(r.data_rank, r.model_rank) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    keys = [k for k in ranks[0].arrays if k.startswith('probe/')]
    for r in ranks[1:]:
        assert r.probe_metrics == ranks[0].probe_metrics
        for k in keys:
            np.testing.assert_array_equal(r.arrays[k], ranks[0].arrays[k],
                                          err_msg=k)
    _assert_probe({k[6:]: ranks[0].arrays[k] for k in keys},
                  grid_2x2.probe['arrays'], ranks[0].probe_metrics,
                  grid_2x2.probe['metrics'])


def test_dropout_is_seeded_per_data_rank(grid_2x2):
    """The trainer seeds dropout with ``seed + data rank``: the two model
    ranks of a batch draw the same mask, the data ranks different ones."""
    masks = [np.array(r.dropout) for r in grid_2x2.ranks]
    np.testing.assert_array_equal(masks[0], masks[1])
    np.testing.assert_array_equal(masks[2], masks[3])
    assert not np.array_equal(masks[0], masks[2])
    for data_rank, got in ((0, masks[0]), (1, masks[2])):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(data_rank)
            ref = torch.nn.functional.dropout(torch.ones(256), 0.5).numpy()
        np.testing.assert_array_equal(got, ref)
