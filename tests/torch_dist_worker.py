"""One rank of the port's two-process CPU run (tests/test_torch_distributed.py).

Not a test: launched as ``python tests/torch_dist_worker.py <out_dir>
[key=value ...]`` with ``A2M_COORDINATOR`` / ``A2M_NUM_PROCESSES`` /
``A2M_PROCESS_ID`` in the environment.  Through the entry points a user
calls (``train.__main__.bootstrap``, ``run``, ``launch.shutdown``) on the
in-memory fixture sliced per rank (``synthetic_loader(process_count=-1)``),
after four cases of the global batch on inputs every rank makes from one
seed and slices: a train-mode ``MaskedBatchNorm``, ``masked_mean`` with
unequal mask sums, the label noise, and one ``g_step`` and ``d_step`` of
the train steps over the global batch.  Writes ``rank<i>.npz`` and
``rank<i>.json`` into ``out_dir``; the only instrumentation records every
step's metrics (``Trainer._step``).
"""

import faulthandler
import json
import pathlib
import signal
import sys

faulthandler.register(signal.SIGUSR1)   # kill -USR1 <pid> dumps all stacks
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the fixture: 3 train intervals (two ranks: 2 and 1, so 14 and 7 windows
#: at window_hop 8) and 2 dev intervals of 8 s; 6 windows a batch, so the
#: second train batch is full on rank 0 and holds 1 row (5 wrap-padded) on
#: rank 1
FIXTURE = dict(speakers=('oliver',), intervals_per_speaker=6, duration_s=8.0,
               seed=0, splits=('train', 'train', 'train', 'dev', 'dev',
                               'test'), window_hop=8, batch_size=6)
#: the unit cases: rows a rank, frames, channels; per-rank masks
B, T, C = 4, 5, 3
BN_MASK = np.array([1, 1, 1, 0, 1, 0, 0, 0], np.float32)
#: the steps' case: the tiny models, rows a rank and its masks
TINY_G = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2,
              dropout=0.0)
TINY_D = dict(out_channels=8, joint_feat_dim=8, gat_heads=2, dropout=0.0)
STEP_MASK = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)


def unit_inputs() -> dict:
    """Global inputs of the unit cases, the same on every rank."""
    rng = np.random.default_rng(13)
    return dict(x=rng.standard_normal((2 * B, T, C)).astype(np.float32) * 2
                + 1, r=rng.standard_normal((2 * B, T, C)).astype(np.float32),
                weight=(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
                bias=(0.1 * rng.standard_normal(C)).astype(np.float32),
                per_sample=rng.standard_normal((2 * B, 7)).astype(np.float32),
                mask=BN_MASK)


class _Recorder(torch.optim.SGD):
    """SGD that keeps the gradients it is stepped with."""

    def step(self, closure=None):
        self.seen = [p.grad.clone() for group in self.param_groups
                     for p in group['params']]
        return super().step(closure)


def sgd_steps(rows: slice) -> dict:
    """One ``g_step`` then one ``d_step`` of the tiny models (seed 0) on
    ``rows`` of a seeded global batch of 2 x B, in float64 (the f32
    gradients of the first layers of this deep net carry rounding of a few
    1e-4 of their largest), label noise on, with an
    optimiser that records the gradients it is given (the summed ones,
    in a group) and does not move the parameters.  Returns the metrics, the
    gradients and the BatchNorm buffers after both."""
    from a2m_torch.config import (DiscriminatorConfig, GeneratorConfig,
                                  TrainConfig)
    from a2m_torch.models.discriminator import Discriminator
    from a2m_torch.models.generator import Generator
    from a2m_torch.train.train_step import NetState, make_train_steps
    rng = np.random.default_rng(17)
    audio = rng.standard_normal((2 * B, 64, 128)).astype(np.float32)
    pose = (rng.standard_normal((2 * B, 64, 104)) * 10 + 300).astype(
        np.float32)
    args = tuple(torch.from_numpy(a).double() for a in (
        audio[rows], pose[rows], np.zeros(104), np.full(104, 10.0)))
    mask = torch.from_numpy(STEP_MASK[rows]).double()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g = Generator(GeneratorConfig(**TINY_G)).double()
        d = Discriminator(DiscriminatorConfig(**TINY_D)).double()
    g_state = NetState(g, _Recorder(g.parameters(), lr=0.0))
    d_state = NetState(d, _Recorder(d.parameters(), lr=0.0))
    g_step, d_step, _ = make_train_steps(g, d, TrainConfig())
    out = {}

    def record(prefix, state, step):
        metrics = step()[-1]
        out.update({f'{prefix}_metric/{k}': v.numpy()
                    for k, v in metrics.items()})
        out.update({f'{prefix}_grad/{k}': grad.numpy() for (k, _), grad in
                    zip(state.model.named_parameters(),
                        state.optimizer.seen, strict=True)})

    record('g', g_state, lambda: g_step(g_state, d_state, *args, 0.95, 0.01,
                                        torch.Generator().manual_seed(1),
                                        mask=mask))
    record('d', d_state, lambda: d_step(g_state, d_state, *args, 0.95, 0.05,
                                        0.01,
                                        torch.Generator().manual_seed(2),
                                        mask=mask))
    out.update({f'buffer/{p}/{k}': v.numpy() for p, m in (('g', g), ('d', d))
                for k, v in m.named_buffers() if k.endswith(('running_mean',
                                                             'running_var'))})
    return out


def unit_cases(rank: int) -> dict:
    from a2m_torch.models import losses
    from a2m_torch.nn.masking import MaskedBatchNorm, batch_mask
    from a2m_torch.parallel import mesh
    from a2m_torch.train.train_step import smooth_labels
    g = {k: torch.from_numpy(v) for k, v in unit_inputs().items()}
    rows = slice(rank * B, (rank + 1) * B)
    out = {}
    bn = MaskedBatchNorm(C).train()
    with torch.no_grad():
        bn.weight.copy_(g['weight'])
        bn.bias.copy_(g['bias'])
    x = g['x'][rows].clone().requires_grad_(True)
    with mesh.global_batch(), batch_mask(g['mask'][rows]):
        y = bn(x)
        (y * g['r'][rows]).sum().backward()
    out.update(bn_y=y.detach().numpy(), bn_dx=x.grad.numpy(),
               bn_dweight=bn.weight.grad.numpy(),
               bn_dbias=bn.bias.grad.numpy(),
               bn_running_mean=bn.running_mean.numpy(),
               bn_running_var=bn.running_var.numpy())
    per_sample, mask = g['per_sample'][rows], g['mask'][rows]
    with mesh.global_batch():
        term = losses.masked_mean(per_sample, mask)
        out['mm_term'] = term.numpy()
        out['mm_global'] = mesh.all_reduce_sum(term.clone()).numpy()
    out['mm_own'] = losses.masked_mean(per_sample, mask).numpy()
    with mesh.global_batch():
        out['noise'] = smooth_labels(torch.Generator().manual_seed(5), B, 3,
                                     0.9, 0.05, is_real=True).numpy()
    out.update(sgd_steps(rows))
    return out


def main() -> None:
    out_dir = pathlib.Path(sys.argv[1])
    torch.set_num_threads(2)
    from a2m_torch.config import Config, apply_overrides, validate
    from a2m_torch.data.synthetic import synthetic_loader
    from a2m_torch.parallel import launch
    from a2m_torch.train import __main__ as train_main
    from a2m_torch.train.loop import Trainer

    lines: list[str] = []
    cfg = apply_overrides(Config(), sys.argv[2:])
    cfg, device = train_main.bootstrap(cfg, 'cpu', log=lines.append)
    cfg = validate(cfg)
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    arrays = unit_cases(rank)

    steps: list[tuple[str, dict]] = []
    plain_step = Trainer._step

    def recording(self, kind, measuring, step, *args, **kwargs):
        out = plain_step(self, kind, measuring, step, *args, **kwargs)
        steps.append((kind, {k: float(v) for k, v in out[-1].items()}))
        return out

    Trainer._step = recording
    fixture = dict(FIXTURE)
    loader = synthetic_loader(**fixture,
                              process_index=cfg.data.process_index,
                              process_count=cfg.data.process_count)
    trainer = train_main.run(cfg, loader, device=device, log=lines.append)
    Trainer._step = plain_step
    state = {f'{p}/{k}': v.numpy() for p, s in (('g', trainer.g_state),
                                                ('d', trainer.d_state))
             for k, v in s.model.state_dict().items()}
    resumed = Trainer.from_config(cfg, loader, device=device,
                                  log=lines.append)
    dropout = torch.nn.functional.dropout(torch.ones(256), 0.5).numpy()
    same = all(torch.equal(torch.from_numpy(state[f'{p}/{k}']), v)
               for p, s in (('g', resumed.g_state), ('d', resumed.d_state))
               for k, v in s.model.state_dict().items())
    launch.shutdown()
    np.savez(out_dir / f'rank{rank}.npz', mean=trainer.mean.numpy(),
             std=trainer.std.numpy(), dropout=dropout, **arrays,
             **{f'state/{k}': v for k, v in state.items()})
    (out_dir / f'rank{rank}.json').write_text(json.dumps(dict(
        rank=rank, world=world, lines=lines,
        steps=steps, train_batches=len(loader.train),
        dev_batches=len(loader.dev),
        g_history=list(trainer.controller.g_loss_history),
        d_history=list(trainer.controller.d_loss_history),
        loss_history=trainer.loss_history,
        resumed_epoch=resumed.start_epoch, resumed_same=same,
        data=[cfg.data.process_index, cfg.data.process_count])))


if __name__ == '__main__':
    main()
