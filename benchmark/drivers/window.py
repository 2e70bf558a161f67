"""Driver of the one-window path: ``pipeline.audio_to_pose_fn`` around
``pipeline.load_generator``'s generator on the fused stack kernel (what
``pipeline.build_pipeline()``'s ``audio_to_pose`` is: K2, the generator with
K1) on batches of clips that lie on the card before the window.

A call is one ``audio_to_pose`` of ``batch`` clips of ``clip_seconds`` s
from a pool of ``pool`` seeded batches, cycled in a seeded order; it ends
with the pose on the host.  The poses of a seeded sample of the window's
calls are compared with the plain reference once the window has closed.
"""

from __future__ import annotations

import numpy as np
import torch

import common
import harness
import traffic
import yardstick
from reference import audio2motion as ref


class Driver(common.ServeDriver):
    stack_mode = 'dense'

    def __init__(self, config: dict, traffic_p: dict, seed: int, device):
        from a2m_torch import pipeline
        from a2m_torch.config import GeneratorConfig
        self.config, self.p, self.device = config, traffic_p, device
        watch = harness.Stopwatch()
        p = traffic_p
        # what ``pipeline.build_pipeline()`` wraps, at the configuration's
        # sizes; the warm-up below builds the kernels
        model = pipeline.load_generator(
            harness.ROOT / config['weights'],
            GeneratorConfig(**config['generator'], fused_gcn=True), device)
        self.program = pipeline.audio_to_pose_fn(model, device)
        watch.lap('program')
        self.n_samples = int(p['sr'] * p['clip_seconds'])
        self.reseed(seed)
        watch.lap('traffic')
        for wave in self.pool[:2]:
            self.program(wave).cpu()
        watch.lap('warm-up')
        _, aten, launched = common.count_call(
            lambda: self.program(self.pool[0]).cpu())
        self.work = self._work(aten, launched)
        watch.lap('count')
        self.stages = watch.laps

    def reseed(self, seed: int) -> None:
        """The traffic of ``seed``: the pool of batches on the card, the
        order of the calls and the compared sample."""
        p = self.p
        s_pool, s_order, s_sample = traffic.sub_seeds(seed, 3)
        waves = traffic.speech_like(s_pool, p['pool'] * p['batch'],
                                    self.n_samples, p['sr'], p['voice'],
                                    self.device)
        self.pool = list(waves.view(p['pool'], p['batch'], -1))
        self.order = np.random.default_rng(s_order).permutation(p['pool'])
        self.sample = common.Reservoir(p['compared_calls'], s_sample)
        self.i = 0

    def _work(self, aten: float, launched: dict) -> dict:
        p = self.p
        t = ref.WINDOW
        n = p['batch'] * t
        if self.device.type == 'cuda' and (launched['k1'] != 2
                                           or launched['k2'] != 1):
            raise RuntimeError(f'a call launched {launched}: K1 x2 and '
                               f'K2 x1 expected')
        k1_flops = k1_bound = 0.0
        if launched['k1']:
            for adj, f, h in common.stack_shapes(self.config['generator']):
                fl = yardstick.stack_flops(n, adj, f, h)
                k1_flops += fl
                k1_bound += yardstick.bound_s(
                    fl, yardstick.stack_bytes(n, adj.shape[0], f, h), 'bf16')
        k2_flops, k2_bytes = common.k2_cost(p['batch'], self.n_samples, t)
        k2_bound = yardstick.bound_s(k2_flops, k2_bytes, 'f32')
        return {'calls': 1, 'audio_s': p['batch'] * p['clip_seconds'],
                'flops': aten + k1_flops + k2_flops * launched['k2'],
                'bound_s.k1': k1_bound, 'bound_s.k2': k2_bound}

    def call(self) -> dict:
        k = int(self.order[self.i % len(self.order)])
        pose = self.program(self.pool[k]).cpu().numpy()
        self.sample.offer((k, pose))
        self.i += 1
        return self.work

    def reference(self, k: int, tf32: bool = False,
                  block: int = 32) -> np.ndarray:
        """(batch, 64, 104) reference poses of pool entry ``k``."""
        common.set_tf32(tf32)
        try:
            model, wave = self.reference_model(), self.pool[k]
            with torch.no_grad():
                out = [model(ref.log_mel(wave[i:i + block], ref.WINDOW))
                       for i in range(0, len(wave), block)]
                return torch.cat(out).cpu().numpy()
        finally:
            common.set_tf32(False)
