"""Driver of the streaming server on streams of unequal length:
``eval/streaming.stream_from_waveforms`` around ``pipeline.load_generator``'s
generator on the edge-form kernels (what ``pipeline.build_server()``'s
``serve`` is) when no two streams of a call share a length.  That is its
chunked route: a batched K2 call per length group, the features to the
host, ``stream_poses_multi``'s windowing on the host, the windows back to
the card in chunks of 64 (K5 twice a chunk), the poses to the host and the
crossfade blend in NumPy.

A call is one ``serve`` of the streams of ``seconds`` (the same lengths
every call) from a pool of ``pool`` seeded sets, cycled in a seeded order;
the seed draws each set's audio and the order of its streams, never their
lengths.  It ends with the poses on the host.  The poses of a seeded
sample of the window's calls are compared with the plain reference, stream
by stream, once the window has closed.
"""

from __future__ import annotations

import numpy as np
import torch

import common
import harness
import tower_cost
import traffic
import yardstick
from reference import audio2motion as ref

#: windows a chunk of the chunked route (``stream_from_waveforms``'s
#: ``batch_size`` default)
CHUNK = 64


class Driver(common.ServeDriver):
    stack_mode = 'edge'

    def __init__(self, config: dict, traffic_p: dict, seed: int, device):
        from a2m_torch import pipeline
        from a2m_torch.config import GeneratorConfig
        from a2m_torch.eval import streaming
        self.config, self.p, self.device = config, traffic_p, device
        watch = harness.Stopwatch()
        model = pipeline.load_generator(
            harness.ROOT / config['weights'],
            GeneratorConfig(**config['generator'], fused_gcn=True,
                            fused_edge=True), device)

        def serve(waves, sr):
            return streaming.stream_from_waveforms(model, waves, sr)
        self.program = serve
        watch.lap('program')
        self.sr = traffic_p['sr']
        self.lengths = [int(s * self.sr) for s in traffic_p['seconds']]
        if len(set(self.lengths)) != len(self.lengths):
            raise ValueError('stream_mixed: the lengths must differ')
        self.reseed(seed)
        watch.lap('traffic')
        for entry in self.pool[:2]:
            self.program(entry, self.sr)
        watch.lap('warm-up')
        _, aten, launched = common.count_call(
            lambda: self.program(self.pool[0], self.sr))
        self.work = self._work(aten, launched)
        watch.lap('count')
        self.stages = watch.laps

    def reseed(self, seed: int) -> None:
        """The traffic of ``seed``: each set's streams made on the device
        (one draw of the longest length, each stream its prefix) and held
        in host memory in a seeded order, the order of the calls and the
        compared sample."""
        p = self.p
        s_pool, s_order, s_sample = traffic.sub_seeds(seed, 3)
        n = len(self.lengths)
        waves = traffic.speech_like(
            s_pool, p['pool'] * n, max(self.lengths), self.sr, p['voice'],
            self.device).cpu().numpy()
        rng = np.random.default_rng(s_order)
        self.pool = []
        for i in range(p['pool']):
            perm = rng.permutation(n)
            self.pool.append([waves[i * n + j, :self.lengths[j]].copy()
                              for j in perm])
        self.order = rng.permutation(p['pool'])
        self.sample = common.Reservoir(p['compared_calls'], s_sample)
        self.i = 0

    def _work(self, aten: float, launched: dict) -> dict:
        """The work of one call: audio seconds, operations, and the least
        time its K2 and K5 launches could take."""
        frames = [ref.n_frames_of(n) for n in self.lengths]
        windows = sum(len(ref.window_starts(t)) for t in frames)
        chunks = [min(CHUNK, windows - i) for i in range(0, windows, CHUNK)]
        if self.device.type == 'cuda' and (
                launched['k5'] != 2 * len(chunks)
                or launched['k2'] != len(self.lengths)):
            raise RuntimeError(f'a call launched {launched}: K5 x'
                               f'{2 * len(chunks)} and K2 x'
                               f'{len(self.lengths)} expected')
        k5_flops, k5_bound = tower_cost.k5_cost(
            self.config['generator'],
            [c * ref.WINDOW for c in chunks] if launched['k5'] else [])
        k2_flops = k2_bound = 0.0
        if launched['k2']:
            for n, t in zip(self.lengths, frames):
                fl, nb = common.k2_cost(1, n, t)
                k2_flops += fl
                k2_bound += yardstick.bound_s(fl, nb, 'f32')
        return {'calls': 1, 'audio_s': float(sum(self.p['seconds'])),
                'flops': aten + k5_flops + k2_flops,
                'bound_s.k5': k5_bound, 'bound_s.k2': k2_bound}

    def call(self) -> dict:
        k = int(self.order[self.i % len(self.order)])
        poses = self.program(self.pool[k], self.sr)
        self.sample.offer((k, np.concatenate(poses)))
        self.i += 1
        return self.work

    def reference(self, k: int, tf32: bool = False) -> np.ndarray:
        """(sum of T, 104) reference poses of pool entry ``k``, its
        streams one by one, concatenated."""
        common.set_tf32(tf32)
        try:
            return np.concatenate([
                ref.stream_poses(self.reference_model(),
                                 torch.as_tensor(w, device=self.device)[None]
                                 )[0] for w in self.pool[k]])
        finally:
            common.set_tf32(False)
