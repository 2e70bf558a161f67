"""Driver of training: ``pipeline.build_trainer()``'s ``Trainer`` running
``train_epoch`` over epochs of ``batches`` seeded batches of ``batch`` rows
held on the card, the controller on, as users run it.

Set-up builds the trainer, hands it a discriminator drawn from the seed
and the seeded batches, and drives its first epoch through its own
``train_epoch`` (where the trainer also takes its one-off MFU line).  The
first batch's steps (``g_freq`` G steps, then a D step) are observed as
they happen: their losses (D's with its real and its fake branch), the
first gradient of each net as its Adam state holds it after one step, and
each net's change over its steps.  Set-up also holds the program's trainer
to the configuration file's blocks, key by key, and fails the run where it
runs another model or another training.  A timed call
is one further epoch.  Once the window has closed, the plain reference
replays that first batch from the same weights, batch, label-noise and
dropout seeds, its D step from the state of G that the program's D step
found (copied to host memory as it began), and the two are compared leaf
by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

import common
import harness
import traffic
import yardstick
from reference import audio2motion as ref


def _host_state(model) -> dict:
    """A copy of ``model``'s parameters and buffers in host memory."""
    return {k: v.detach().to('cpu', copy=True)
            for k, v in model.state_dict().items()}


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    values = torch.stack([tensors[n].float().norm() for n in names])
    return dict(zip(names, values.cpu().tolist()))


class Driver:
    span = 'bench.train_epoch'
    #: the control (the reference one precision lower) and a planted fault
    controls = (('control_tf32', {'tf32': True}),
                ('half_batch', {'tf32': False, 'half_batch': True}),
                ('half_batch_d', {'tf32': False, 'half_batch_d': True}))

    def __init__(self, config: dict, traffic_p: dict, seed: int, device):
        self.config, self.p, self.device = config, traffic_p, device
        self.trainer = None
        self.reseed(seed)

    # -- set-up ------------------------------------------------------------

    def reseed(self, seed: int) -> None:
        """Build the program, the batches and the observation for ``seed``
        and drive the first epoch."""
        from a2m_torch import pipeline
        from a2m_torch.config import GeneratorConfig
        self.trainer = None
        common.free_device()
        watch = harness.Stopwatch()
        cfg, p, dev = self.config, self.p, self.device
        (s_data, self.s_trainer, self.s_disc,
         self.s_dropout) = traffic.sub_seeds(seed, 4)
        self.trainer = pipeline.build_trainer(
            harness.ROOT / cfg['weights'], batch=p['batch'],
            device=str(dev),
            seed=self.s_trainer, log=lambda line: None,
            config=GeneratorConfig(**cfg['generator'], fused_gcn=True))
        watch.lap('program')
        tr = self.trainer
        self._check_program(tr)
        disc = ref.Discriminator(cfg['discriminator']).to(dev)
        tr.d_state.model.load_state_dict(
            ref.seeded_state(disc, self.s_disc, dev))
        del disc
        self.batches = self._batches(s_data)
        watch.lap('traffic')
        tr.train_batches, tr.dev_batches = self.batches, []
        self._observe(tr)
        self.epoch = 0
        torch.manual_seed(self.s_dropout)
        tr.train_epoch(self.epoch)
        self.epoch += 1
        self._finish_observation()
        watch.lap('first epoch')
        self.stages = watch.laps

    def _check_program(self, tr) -> None:
        """Raise unless the trainer runs what the configuration file states:
        its generator, discriminator, controller and training blocks, the
        batch, Adam's settings and learning rates, and the precision (the
        plain reference reads the same blocks)."""
        cfg, p = self.config, self.p
        train = dict(cfg['train'])
        batch = train.pop('batch_size')
        adam = {'betas': train.pop('adam_betas'), 'eps': train.pop('adam_eps')}
        gaps = (common.config_gaps(cfg['generator'], tr.g_config)
                + common.config_gaps(cfg['discriminator'], tr.d_config)
                + common.config_gaps(cfg['controller'], tr.cfg.controller)
                + common.config_gaps(train, tr.cfg))
        if batch != p['batch']:
            gaps.append(f'batch_size: file {batch}, traffic {p["batch"]}')
        for net, lr in (('g', 'g_lr'), ('d', 'd_lr')):
            state = tr.g_state if net == 'g' else tr.d_state
            group = state.optimizer.param_groups[0]
            held = {'betas': list(group['betas']), 'eps': group['eps'],
                    'lr': group['lr']}
            want = dict(adam, lr=cfg['controller'][lr])
            gaps += [f'{net} Adam {k}: file {v!r}, program {held[k]!r}'
                     for k, v in want.items() if held[k] != v]
        prec = cfg['precision']
        operands = 'f32' if tr.g_config.fused_precise else 'bf16'
        held = {'compute': tr.cfg.compute_dtype, 'gcn_operands': operands,
                'tf32': (torch.backends.cudnn.allow_tf32
                         or torch.backends.cuda.matmul.allow_tf32)
                if self.device.type == 'cuda' else prec['tf32']}
        gaps += [f'precision {k}: file {v!r}, program {held[k]!r}'
                 for k, v in prec.items() if held[k] != v]
        if not tr.g_config.fused_gcn:
            gaps.append('the generator is not on the fused stack kernels')
        if gaps:
            raise RuntimeError('the trainer departs from the configuration: '
                               + '; '.join(gaps))

    def _batches(self, seed: int) -> list[tuple]:
        """``batches`` tuples (log-mel (B, 64, 128), pose (B, 64, 104),
        no style, mask of ones) on the card: the log-mel of seeded
        speech-like clips by the reference's frontend, and seeded skeleton
        tracks."""
        p, dev = self.p, self.device
        s_audio, s_pose = traffic.sub_seeds(seed, 2)
        b, n = p['batch'], p['batches']
        clip = int(p['sr'] * p['clip_seconds'])
        audio = []
        for i, s in enumerate(traffic.sub_seeds(s_audio, n)):
            waves = traffic.speech_like(s, b, clip, p['sr'], p['voice'], dev)
            with torch.no_grad():
                audio.append(ref.log_mel(waves, ref.WINDOW))
        pose = torch.as_tensor(traffic.pose_tracks(
            s_pose, b * n, ref.WINDOW, ref.POSE_FPS), device=dev)
        mask = torch.ones(b, device=dev)
        return [(audio[i], pose[i * b:(i + 1) * b], None, mask)
                for i in range(n)]

    def _observe(self, tr) -> None:
        """Wrap the trainer's steps: count them, count the operations of
        the first of each kind, and observe the first batch's."""
        self.steps = {'g': 0, 'd': 0}
        self.flops: dict[str, float] = {}
        self.obs: dict = {'losses': [], 'd_parts': []}
        self.g0 = {n: q.detach().clone()
                   for n, q in tr.g_state.model.named_parameters()}
        self.d0 = {n: q.detach().clone()
                   for n, q in tr.d_state.model.named_parameters()}
        g_freq = tr.controller.g_train_freq

        def wrap(kind, step, state_of, loss_key):
            def observed(*args, **kwargs):
                if kind == 'd' and self.steps == {'g': g_freq, 'd': 0}:
                    # G as the first D step finds it, in host memory
                    self.obs['g_at_d'] = _host_state(args[0].model)
                if kind in self.flops:
                    out = step(*args, **kwargs)
                else:
                    out, aten, launched = common.count_call(
                        lambda: step(*args, **kwargs))
                    self.flops[kind] = aten + self._stack_flops(kind,
                                                                launched)
                self.steps[kind] += 1
                n_g, n_d = self.steps['g'], self.steps['d']
                first_batch = (kind == 'g' and n_g <= g_freq and n_d == 0) \
                    or (kind == 'd' and n_d == 1 and n_g == g_freq)
                if first_batch:
                    self.obs['losses'].append(out[2][loss_key])
                    if kind == 'd':
                        self.obs['d_parts'] = [out[2]['d_real'],
                                               out[2]['d_fake']]
                    state = state_of(out)
                    if self.steps[kind] == 1:
                        moments = state.optimizer.state
                        self.obs[f'grad_{kind}'] = _norms({
                            n: moments[q]['exp_avg'] / 0.1
                            if 'exp_avg' in moments.get(q, {})
                            else torch.zeros_like(q)
                            for n, q in state.model.named_parameters()})
                    if (kind == 'g' and n_g == g_freq) or kind == 'd':
                        start = self.g0 if kind == 'g' else self.d0
                        self.obs[f'change_{kind}'] = _norms({
                            n: q.detach() - start[n]
                            for n, q in state.model.named_parameters()})
                return out
            return observed

        tr.g_step = wrap('g', tr.g_step, lambda out: out[0], 'g_loss')
        tr.d_step = wrap('d', tr.d_step, lambda out: out[0], 'd_loss')
        self.g_freq = g_freq

    def _stack_flops(self, kind: str, launched: dict) -> float:
        """Operations of the GCN stack launches of one step: K3 and K4 in a
        G step, K1 in a D step, one launch a stack."""
        n = self.p['batch'] * ref.WINDOW
        shapes = common.stack_shapes(self.config['generator'])
        if self.device.type != 'cuda':
            return 0.0
        want = {'g': {'k3': 2, 'k4': 2}, 'd': {'k1': 2}}[kind]
        if any(launched[k] != v for k, v in want.items()):
            raise RuntimeError(f'a {kind} step launched {launched}, '
                               f'expected {want}')
        total = 0.0
        for adj, f, h in shapes:
            if kind == 'g':
                total += yardstick.stack_flops(n, adj, f, h)
                total += yardstick.stack_bwd_flops(n, adj, f, h)
            else:
                total += yardstick.stack_flops(n, adj, f, h)
        return total

    def _finish_observation(self) -> None:
        for key in ('losses', 'd_parts'):
            self.obs[key] = [float(x) for x in self.obs[key]]
        self.g0 = self.d0 = None
        n = self.p['batch'] * ref.WINDOW
        self.bound = {'k3': 0.0, 'k4': 0.0}
        for adj, f, h in common.stack_shapes(self.config['generator']):
            j = adj.shape[0]
            self.bound['k3'] += yardstick.bound_s(
                yardstick.stack_flops(n, adj, f, h),
                yardstick.stack_fwd_bytes(n, j, f, h), 'bf16')
            self.bound['k4'] += yardstick.bound_s(
                yardstick.stack_bwd_flops(n, adj, f, h),
                yardstick.stack_bwd_bytes(n, j, f, h), 'bf16')

    # -- the window --------------------------------------------------------

    def call(self) -> dict:
        g0, d0 = self.steps['g'], self.steps['d']
        self.trainer.train_epoch(self.epoch)
        self.epoch += 1
        g, d = self.steps['g'] - g0, self.steps['d'] - d0
        b = self.p['batches']
        return {'calls': 1, 'batches': b, 'samples': b * self.p['batch'],
                'g_steps': g, 'd_steps': d,
                'flops': g * self.flops['g'] + d * self.flops['d'],
                'bound_s.k3': g * self.bound['k3'],
                'bound_s.k4': g * self.bound['k4']}

    def release(self) -> None:
        self.trainer = None
        common.free_device()

    # -- the reference -----------------------------------------------------

    def replay(self, tf32: bool = False, half_batch: bool = False,
               half_batch_d: bool = False, g_at_d: dict | None = None
               ) -> dict:
        """The reference's first batch: ``g_freq`` G steps and one D step
        from the configuration's weights, the seeded discriminator, the
        first batch and the label-noise and dropout seeds.  With
        ``half_batch`` the second half of the rows is masked out of every
        step, with ``half_batch_d`` out of the D step alone (planted faults:
        the mean taken over the rest).  ``g_at_d``, the state of G that the
        side under test held at its D step, takes the place of the
        reference's own G there: the D step is followed from it (its G
        steps are compared from the start, the D step from G as it left
        them).  The state G held at the D step is returned as ``g_at_d``."""
        cfg, dev = self.config, self.device
        common.set_tf32(tf32)
        try:
            gen = ref.Generator(cfg['generator'])
            flat, stats = ref.load_npz(harness.ROOT / cfg['weights'])
            gen.load_state_dict(ref.state_from_flat(flat, gen))
            gen.set_stack_mode('dense')
            gen = gen.to(dev)
            disc = ref.Discriminator(cfg['discriminator']).to(dev)
            disc.load_state_dict(ref.seeded_state(disc, self.s_disc, dev))
            ctrl, tcfg = cfg['controller'], cfg['train']
            g_opt = ref.adam(gen.parameters(), ctrl['g_lr'])
            d_opt = ref.adam(disc.parameters(), ctrl['d_lr'])
            mean = torch.as_tensor(stats['mean'], device=dev)
            std = torch.as_tensor(stats['std'], device=dev)
            key = torch.Generator(device=dev).manual_seed(self.s_trainer)
            audio, pose, _, mask = self.batches[0]
            halved = mask.clone()
            halved[len(mask) // 2:] = 0
            if half_batch:
                mask = halved
            smooth_r, smooth_f, noise = ref.label_params(0, ctrl)
            torch.manual_seed(self.s_dropout)
            out: dict = {'losses': []}
            g0 = {n: q.detach().clone() for n, q in gen.named_parameters()}
            for i in range(self.g_freq):
                out['losses'].append(ref.g_step(
                    gen, disc, g_opt, audio, pose, mask, mean, std,
                    smooth_r, noise, key, tcfg))
                if i == 0:
                    out['grad_g'] = _norms({n: q.grad for n, q in
                                            gen.named_parameters()})
            out['change_g'] = _norms({n: q.detach() - g0[n]
                                      for n, q in gen.named_parameters()})
            out['g_at_d'] = _host_state(gen)
            if g_at_d is not None:
                gen.load_state_dict(g_at_d)
            d0 = {n: q.detach().clone() for n, q in disc.named_parameters()}
            d_loss, *out['d_parts'] = ref.d_step(
                gen, disc, d_opt, audio, pose,
                halved if half_batch_d else mask, mean, std, smooth_r,
                smooth_f, noise, key, tcfg)
            out['losses'].append(d_loss)
            out['grad_d'] = _norms({n: q.grad for n, q in
                                    disc.named_parameters()})
            out['change_d'] = _norms({n: q.detach() - d0[n]
                                      for n, q in disc.named_parameters()})
            for k in ('losses', 'd_parts'):
                out[k] = [float(x) for x in out[k]]
            return out
        finally:
            common.set_tf32(False)

    @staticmethod
    def leaf_gaps(got: dict, want: dict, net: str) -> tuple[dict, dict]:
        """Per leaf of ``net``: the gap of gradient norms, and of change
        norms, each over the reference's norm of that leaf or the median
        leaf's, whichever is larger.  Leaves whose reference gradient is
        under a thousandth of the median leaf's move by round-off alone and
        are left out of the change."""
        grad_r, grad_p = want[f'grad_{net}'], got.get(f'grad_{net}', {})
        med = float(np.median(list(grad_r.values())))
        grad = {n: abs(grad_p.get(n, float('inf')) - v) / max(v, med)
                for n, v in grad_r.items()}
        ch_r, ch_p = want[f'change_{net}'], got.get(f'change_{net}', {})
        kept = [n for n, v in grad_r.items() if v >= 1e-3 * med]
        med_ch = float(np.median([ch_r[n] for n in kept]))
        change = {n: abs(ch_p.get(n, float('inf')) - ch_r[n])
                  / max(ch_r[n], med_ch) for n in kept}
        return grad, change

    @classmethod
    def gaps(cls, got: dict, want: dict) -> dict:
        """The first step's loss gap and the widest of all steps'
        (relative); the gaps of D's real and fake branch at its step
        (relative); per net, the worst and the median leaf's gap of
        gradient norms and of change norms (:meth:`leaf_gaps`)."""
        def rel(key):
            gaps = [abs(a - b) / max(abs(b), 1e-12)
                    for a, b in zip(got[key], want[key])]
            return gaps if len(got[key]) == len(want[key]) else [float('inf')]
        losses, d_parts = rel('losses'), rel('d_parts')
        d_real, d_fake = d_parts if len(d_parts) == 2 else d_parts * 2
        out = {'loss_gap_first': losses[0], 'loss_gap': max(losses),
               'd_real_gap': d_real, 'd_fake_gap': d_fake}
        for net in ('g', 'd'):
            for kind, gaps in zip(('grad', 'change'),
                                  cls.leaf_gaps(got, want, net)):
                values = list(gaps.values())
                out[f'{kind}_gap_{net}'] = max(values)
                out[f'{kind}_gap_median_{net}'] = float(np.median(values))
        return {k: (v if np.isfinite(v) else float('inf'))
                for k, v in out.items()}

    def worst_leaves(self, want: dict) -> dict:
        """For the record: the leaf behind each worst gap."""
        out = {}
        for net in ('g', 'd'):
            for kind, gaps in zip(('grad', 'change'),
                                  self.leaf_gaps(self.obs, want, net)):
                out[f'{kind}_{net}'] = max(gaps, key=gaps.get)
        return out

    def verify(self) -> dict:
        want = self.replay(g_at_d=self.obs['g_at_d'])
        self.worst = self.worst_leaves(want)
        return self.gaps(self.obs, want)

    def control(self, **fault) -> dict:
        """The reference replayed one precision lower (TF32 on), or with
        a planted fault (``replay``'s switches), in the program's place:
        compared as :meth:`verify` compares the program."""
        low = self.replay(**fault)
        return self.gaps(low, self.replay(g_at_d=low['g_at_d']))
