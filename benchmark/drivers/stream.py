"""Driver of the streaming server: ``eval/streaming.stream_from_waveforms``
around ``pipeline.load_generator``'s generator on the edge-form kernels
(what ``pipeline.build_server()``'s ``serve`` is), on equal-length streams
held in host memory (the fused path: upload, K2, window gather, generator
with K5, blend, download).

A call is one ``serve`` of ``streams`` streams of ``seconds`` s from a pool
of ``pool`` seeded stream sets, cycled in a seeded order; it ends with the
poses on the host.  The poses of a seeded sample of the window's calls are
compared with the plain reference once the window has closed.
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
    stack_mode = 'edge'

    def __init__(self, config: dict, traffic_p: dict, seed: int, device):
        from a2m_torch import pipeline
        from a2m_torch.config import GeneratorConfig
        from a2m_torch.eval import streaming
        self.config, self.p, self.device = config, traffic_p, device
        watch = harness.Stopwatch()
        # what ``pipeline.build_server()`` wraps, at the configuration's
        # sizes: the generator on the edge-form kernels, then the server
        model = pipeline.load_generator(
            harness.ROOT / config['weights'],
            GeneratorConfig(**config['generator'], fused_gcn=True,
                            fused_edge=True), device)

        def serve(waves, sr):
            return streaming.stream_from_waveforms(model, waves, sr)
        self.program = serve
        watch.lap('program')
        self.sr = traffic_p['sr']
        self.n_samples = int(traffic_p['seconds'] * self.sr)
        self.reseed(seed)
        watch.lap('traffic')
        # warm-up on the cell's one shape, then its operations counted
        for entry in self.pool[:2]:
            self.program(entry, self.sr)
        watch.lap('warm-up')
        _, aten, launched = common.count_call(
            lambda: self.program(self.pool[0], self.sr))
        self.work = self._work(aten, launched)
        watch.lap('count')
        self.stages = watch.laps

    def reseed(self, seed: int) -> None:
        """The traffic of ``seed``: the pool, made on the device and held
        in host memory, the order of the calls and the compared sample."""
        p = self.p
        s_pool, s_order, s_sample = traffic.sub_seeds(seed, 3)
        waves = traffic.speech_like(
            s_pool, p['pool'] * p['streams'], self.n_samples, self.sr,
            p['voice'], self.device).cpu().numpy()
        self.pool = [list(waves[i * p['streams']:(i + 1) * p['streams']])
                     for i in range(p['pool'])]
        self.order = np.random.default_rng(s_order).permutation(p['pool'])
        self.sample = common.Reservoir(p['compared_calls'], s_sample)
        self.i = 0

    def _work(self, aten: float, launched: dict) -> dict:
        """The work of one call: audio seconds, operations, and the least
        time its K2 and K5 launches could take."""
        p = self.p
        t = ref.n_frames_of(self.n_samples)
        windows = len(ref.window_starts(t)) * p['streams']
        n = windows * ref.WINDOW
        if self.device.type == 'cuda' and (launched['k5'] != 2
                                           or launched['k2'] != 1):
            raise RuntimeError(f'a call launched {launched}: K5 x2 and '
                               f'K2 x1 expected')
        k5_flops = k5_bound = 0.0
        if launched['k5']:
            for adj, f, h in common.stack_shapes(self.config['generator']):
                fl = yardstick.stack_flops(n, adj, f, h)
                k5_flops += fl
                k5_bound += yardstick.bound_s(
                    fl, yardstick.stack_edge_bytes(n, adj, f, h), 'bf16')
        k2_flops, k2_bytes = common.k2_cost(p['streams'], self.n_samples, t)
        k2_bound = yardstick.bound_s(k2_flops, k2_bytes, 'f32')
        return {'calls': 1, 'audio_s': p['streams'] * p['seconds'],
                'flops': aten + k5_flops + k2_flops * launched['k2'],
                'bound_s.k5': k5_bound, 'bound_s.k2': k2_bound}

    def call(self) -> dict:
        k = int(self.order[self.i % len(self.order)])
        poses = self.program(self.pool[k], self.sr)
        self.sample.offer((k, poses))
        self.i += 1
        return self.work

    def reference(self, k: int, tf32: bool = False) -> np.ndarray:
        """(streams, T, 104) reference poses of pool entry ``k``."""
        common.set_tf32(tf32)
        try:
            waves = torch.as_tensor(np.stack(self.pool[k]),
                                    device=self.device)
            return ref.stream_poses(self.reference_model(), waves)
        finally:
            common.set_tf32(False)
