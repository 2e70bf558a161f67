"""One rank of the port's tensor-parallel CPU runs
(tests/test_torch_tensor_parallel.py).

Not a test: launched as ``python tests/torch_tp_worker.py <spec.json>``
with ``A2M_COORDINATOR`` / ``A2M_NUM_PROCESSES`` / ``A2M_PROCESS_ID`` in
the environment.  Through the entry points a user calls
(``train.__main__.bootstrap``, ``run``, ``Trainer.from_config``,
``launch.shutdown``) at ``spec['overrides']`` (``mesh.model=2`` and the
tiny widths):

* ``probe``: one ``g_step`` and one ``d_step`` of the tiny models in
  float64, dropout 0, Adam and a clip that bites, on this data rank's rows
  of a seeded global batch; the metrics, the gathered parameters, Adam
  moments and BatchNorm statistics, and the shapes this rank holds;
* ``a2m``: the same steps in f32 from a2m's randomised variables
  (``spec['flats']``), label noise 0, for a2m's unsharded step;
* ``bf16``: those steps with ``compute_dtype=bf16`` models;
* ``train``: ``run()`` on the in-memory fixture, its gathered state, a
  resume of its checkpoint and of a one-process run's (``spec['single']``);
* the dropout mask the trainer's seeding gives this rank, and with one data
  rank the train-mode forwards of G and D with dropout on.

Writes ``rank<i>.npz`` and ``rank<i>.json`` into ``spec['out']``.
"""

import faulthandler
import json
import pathlib
import signal
import sys
import time

faulthandler.register(signal.SIGUSR1)   # kill -USR1 <pid> dumps all stacks
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the tiny widths of tests/test_parallel.py, dropout 0
TINY_G = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2,
              dropout=0.0)
TINY_D = dict(out_channels=8, joint_feat_dim=8, gat_heads=2, dropout=0.0)
#: the probe's global batch: rows (tests/test_torch_train_step.py's, whose
#: a2m steps compile to the same programs), masks (unequal sums across two
#: data ranks), the clip (below the first steps' gradient norms)
ROWS = 4
MASK = np.array([1, 1, 0, 1], np.float32)
CLIP = 10.0
SMOOTH_R, SMOOTH_F = 0.93, 0.07


def global_batch():
    """The seeded global batch: audio, pose, mean, std."""
    rng = np.random.default_rng(41)
    audio = rng.standard_normal((ROWS, 64, 128)).astype(np.float32)
    pose = (rng.standard_normal((ROWS, 64, 104)) * 10 + 300).astype(
        np.float32)
    mean = (rng.standard_normal(104) * 5).astype(np.float32)
    std = rng.uniform(5, 15, 104).astype(np.float32)
    return audio, pose, mean, std


def models(dtype=torch.float32, flats=None):
    """The tiny G and D: seed 0 with every attention gate at 0.5 (at 0 it
    would hide the attention's products from the gradients), or a2m's
    variables ``flats``."""
    from a2m_torch.config import DiscriminatorConfig, GeneratorConfig
    from a2m_torch.models.discriminator import Discriminator
    from a2m_torch.models.generator import Generator
    from a2m_torch.weights import from_jax_variables
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g = Generator(GeneratorConfig(**TINY_G), dtype=dtype)
        d = Discriminator(DiscriminatorConfig(**TINY_D), dtype=dtype)
    if flats is not None:
        for name, m in (('g', g), ('d', d)):
            m.load_state_dict(from_jax_variables(flats[name], m))
        return g, d
    with torch.no_grad():
        for m in (g, d):
            for k, p in m.named_parameters():
                if k.endswith('gamma'):
                    p.fill_(0.5)
    return g, d


def steps(g, d, rows: slice, noise: float, clip: float = 0.0,
          shard: bool = True, tensor_dtype=torch.float64) -> dict:
    """One ``g_step`` then one ``d_step`` of ``g`` and ``d`` (sharded first
    when ``shard`` and a model axis is up) with Adam, on ``rows`` of the
    global batch, label noise ``noise``.  Returns the metrics by
    ``'g/<k>'`` / ``'d/<k>'``, and per net the gathered state
    (``'<net>/state/<key>'``), Adam moments (``'<net>/adam/<param>/<k>'``)
    and the shapes this rank holds (``shapes``)."""
    from a2m_torch.config import TrainConfig
    from a2m_torch.parallel import mesh
    from a2m_torch.train.train_step import init_states, make_train_steps
    if shard:
        mesh.shard_module(g)
        mesh.shard_module(d)
    states = init_states(g, d)
    g_step, d_step, _ = make_train_steps(
        g, d, TrainConfig(grad_clip_norm=clip))
    audio, pose, mean, std = global_batch()
    t = lambda a: torch.from_numpy(np.asarray(a)).to(tensor_dtype)  # noqa
    args = (t(audio[rows]), t(pose[rows]), t(mean), t(std))
    mask = t(MASK[rows])
    _, _, gm = g_step(*states, *args, SMOOTH_R, noise,
                      torch.Generator().manual_seed(1), mask=mask)
    _, _, dm = d_step(*states, *args, SMOOTH_R, SMOOTH_F, noise,
                      torch.Generator().manual_seed(2), mask=mask)
    out = {f'{p}/{k}': float(v) for p, m in (('g', gm), ('d', dm))
           for k, v in m.items()}
    arrays, shapes = {}, {}
    for net, state in zip('gd', states):
        model = state.model
        full = mesh.gather_state(model)
        arrays.update({f'{net}/state/{k}': v.double().numpy()
                       for k, v in full.items()})
        adam = mesh.gather_optimizer_state(state.optimizer, model)['state']
        names = [k for k, _ in model.named_parameters()]
        for i, entry in adam.items():
            for k, v in entry.items():
                if k != 'step':
                    arrays[f'{net}/adam/{names[i]}/{k}'] = v.double().numpy()
        shapes.update({f'{net}/{k}': list(v.shape)
                       for k, v in model.state_dict().items()})
        for i, entry in state.optimizer.state_dict()['state'].items():
            shapes[f'{net}/adam/{names[i]}'] = list(entry['exp_avg'].shape)
    return dict(metrics=out, arrays=arrays, shapes=shapes)


def dropout_forwards(shard: bool) -> dict:
    """G and D (dropout 0.2 and 0.3) in train mode on the global batch,
    from seed 5, with and without autograd (a convolution's output comes
    channel-last or channel-first): their outputs."""
    from a2m_torch.config import DiscriminatorConfig, GeneratorConfig
    from a2m_torch.models.discriminator import Discriminator
    from a2m_torch.models.generator import Generator
    from a2m_torch.parallel import mesh
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g = Generator(GeneratorConfig(**dict(TINY_G, dropout=0.2)))
        d = Discriminator(DiscriminatorConfig(**dict(TINY_D, dropout=0.3)))
    g, d = g.double().train(), d.double().train()
    if shard:
        mesh.shard_module(g)
        mesh.shard_module(d)
    audio, pose = (torch.from_numpy(a).double() for a in global_batch()[:2])
    out = {}
    for grad in (False, True):
        with torch.random.fork_rng(devices=[]), \
                torch.set_grad_enabled(grad):
            torch.manual_seed(5)
            out[f'g_{grad}'] = g(audio).detach().numpy()
            out[f'd_{grad}'] = d(pose[:, 1:] - pose[:, :-1])[0].detach(
                ).numpy()
    return out


def rows_of(grid) -> slice:
    n = ROWS // grid.data
    return slice(grid.data_rank * n, (grid.data_rank + 1) * n)


#: the trainer's fixture (tests/torch_dist_worker.py's, undivided): 3
#: train intervals and 2 dev intervals of 8 s, 6 windows a batch
FIXTURE = dict(speakers=('oliver',), intervals_per_speaker=6, duration_s=8.0,
               seed=0, splits=('train', 'train', 'train', 'dev', 'dev',
                               'test'), window_hop=8, batch_size=6)


def main() -> None:
    spec = json.loads(pathlib.Path(sys.argv[1]).read_text())
    out_dir = pathlib.Path(spec['out'])
    torch.set_num_threads(2)
    from a2m_torch.config import Config, apply_overrides
    from a2m_torch.data.synthetic import synthetic_loader
    from a2m_torch.parallel import launch, mesh
    from a2m_torch.train import __main__ as train_main
    from a2m_torch.train.loop import Trainer
    from a2m_torch.weights import load_generator_npz

    lines: list[str] = []
    cfg = apply_overrides(Config(), spec['overrides'])
    cfg, device = train_main.bootstrap(cfg, 'cpu', log=lines.append)
    grid = mesh.current_mesh()
    rank = grid.rank
    report = dict(rank=rank, data_rank=grid.data_rank,
                  model_rank=grid.model_rank, lines=lines)
    arrays = {}

    def keep(prefix: str, result: dict) -> None:
        report[f'{prefix}_metrics'] = result['metrics']
        report[f'{prefix}_shapes'] = result['shapes']
        arrays.update({f'{prefix}/{k}': v
                       for k, v in result['arrays'].items()})

    g, d = models()
    keep('probe', steps(g.double(), d.double(), rows_of(grid), 0.01, CLIP))
    # the trainer seeds dropout with seed + data rank
    Trainer(*models(), cfg.train, log=lines.append)
    report['dropout'] = torch.nn.functional.dropout(
        torch.ones(256), 0.5).tolist()
    if grid.data == 1:
        arrays.update({f'dropout/{k}': v
                       for k, v in dropout_forwards(True).items()})
    if spec.get('flats'):
        flats = {}
        for net in 'gd':
            flats[net], _ = load_generator_npz(
                pathlib.Path(spec['flats']) / f'{net}.npz')
        g, d = models(flats=flats)
        keep('a2m', steps(g, d, rows_of(grid), 0.0,
                          tensor_dtype=torch.float32))
        g, d = models(torch.bfloat16, flats)
        keep('bf16', steps(g, d, rows_of(grid), 0.0,
                           tensor_dtype=torch.float32))
    if spec.get('train'):
        metrics: list = []
        plain_step = Trainer._step

        def recording(self, kind, measuring, step, *args, **kwargs):
            out = plain_step(self, kind, measuring, step, *args, **kwargs)
            metrics.append((kind, {k: float(v) for k, v in out[-1].items()}))
            return out

        Trainer._step = recording
        loader = synthetic_loader(**FIXTURE,
                                  process_index=cfg.data.process_index,
                                  process_count=cfg.data.process_count)
        trainer = train_main.run(cfg, loader, device=device,
                                 log=lines.append)
        Trainer._step = plain_step
        report.update(steps=metrics,
                      g_history=list(trainer.controller.g_loss_history),
                      d_history=list(trainer.controller.d_loss_history),
                      train_shapes={
                          k: list(v.shape) for k, v in
                          trainer.g_state.model.state_dict().items()})
        for net, state in (('g', trainer.g_state), ('d', trainer.d_state)):
            arrays.update({f'train/{net}/{k}': v.numpy() for k, v in
                           mesh.gather_state(state.model).items()})
        # a one-process run's checkpoint, resumed here with a model axis
        # (the test writes 'done' beside it once the run has ended)
        done = pathlib.Path(spec['single']) / 'done'
        deadline = time.monotonic() + 240
        while not done.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f'no {done}')
            time.sleep(0.2)
        single = apply_overrides(cfg, [f'train.save_dir={spec["single"]}'])
        resumed = Trainer.from_config(single, loader, device=device,
                                      log=lines.append)
        report['single_resumed_epoch'] = resumed.start_epoch
        for net, state in (('g', resumed.g_state), ('d', resumed.d_state)):
            arrays.update({f'from_single/{net}/{k}': v.numpy() for k, v in
                           mesh.gather_state(state.model).items()})
    launch.shutdown()
    np.savez(out_dir / f'rank{rank}.npz', **arrays)
    (out_dir / f'rank{rank}.json').write_text(json.dumps(report))


if __name__ == '__main__':
    main()
