"""Driver of the streaming server with a WavLM speech tower in front of the
window stage: ``eval/streaming.stream_from_waveforms`` around
``pipeline.load_generator``'s tower generator on the edge-form kernels
(what ``pipeline.build_server(tower=...)``'s ``serve`` is: the tower
over each whole 16 kHz stream, K6 in each of its layers, then the
flagship's window gather, generator window stage with K5, blend) on
equal-length streams held in host memory.

A call is one ``serve`` of ``streams`` streams of ``seconds`` s from a pool
of ``pool`` seeded stream sets, cycled in a seeded order; it ends with the
poses on the host.  The tower's weights are drawn from the run's seed on
the card, for the program and the reference alike.  The poses and the
tower's last hidden state of a seeded sample of the window's calls are
compared with the plain reference (``reference/wavlm_gen.py``, f32) once
the window has closed: ``rms_gap`` of the poses as ``stream_8x60`` reads
it, ``feat_gap`` the root-mean-square gap of the hidden states over the
reference's.  The controls compute the reference with every product on
fp8 e4m3 operands (one precision below the configuration's bf16), or with
the gated bias left out.
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
from reference import wavlm_gen


def tower_config(config: dict):
    """The program's ``TowerConfig`` of the configuration's ``tower``
    block (lists as tuples)."""
    from a2m_torch.config import TowerConfig
    return TowerConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config['tower'].items()})


class Driver(harness.load_module('drivers', 'stream').Driver):
    """``stream_8x60``'s driver with the tower generator as the program:
    its pool, order and sample (:meth:`reseed`) are ``stream``'s."""
    controls = (('control_fp8', {'fp8': True}),
                ('control_no_bias', {'drop_bias': True}))

    def __init__(self, config: dict, traffic_p: dict, seed: int, device):
        from a2m_torch import pipeline
        from a2m_torch.config import GeneratorConfig
        from a2m_torch.eval import streaming
        self.config, self.p, self.device = config, traffic_p, device
        watch = harness.Stopwatch()
        self.tower_seed = self._tower_seed(seed)
        # what ``pipeline.build_server(tower=...)`` wraps, at the
        # configuration's sizes: the tower drawn from the seed on the card
        model = pipeline.load_generator(
            harness.ROOT / config['weights'],
            GeneratorConfig(**config['generator'], fused_gcn=True,
                            fused_edge=True, tower=tower_config(config)),
            device, self.tower_seed)
        self.tower = model.tower
        encode = self.tower.encode

        def keep(waves):
            # the tower's last hidden state of the call (one length group)
            self.hidden = encode(waves)
            return self.hidden
        self.tower.encode = keep

        def serve(waves, sr):
            return streaming.stream_from_waveforms(model, waves, sr)
        self.program = serve
        watch.lap('program')
        self.sr = traffic_p['sr']
        self.n_samples = int(traffic_p['seconds'] * self.sr)
        self.reseed(seed)
        watch.lap('traffic')
        for entry in self.pool[:2]:
            self.program(entry, self.sr)
        watch.lap('warm-up')
        from a2m_torch.nn.rel_attention import rel_attention
        k6_before = rel_attention.launches
        _, aten, launched = common.count_call(
            lambda: self.program(self.pool[0], self.sr))
        launched['k6'] = rel_attention.launches - k6_before
        self.work = self._work(aten, launched)
        watch.lap('count')
        self.stages = watch.laps

    @staticmethod
    def _tower_seed(seed: int) -> int:
        return traffic.sub_seeds(seed, 4)[3]

    def reseed(self, seed: int) -> None:
        """``stream``'s traffic of ``seed``, and the tower's weights drawn
        anew when the seed changes them."""
        if self._tower_seed(seed) != self.tower_seed:
            from a2m_torch.nn.wavlm import seeded_state
            self.tower_seed = self._tower_seed(seed)
            self.tower.load_hf_state(seeded_state(
                self.tower.cfg, self.tower_seed, self.device,
                self.config['generator']['in_channels']))
            self._state = None
        super().reseed(seed)

    def _work(self, aten: float, launched: dict) -> dict:
        """The work of one call: audio seconds, operations, and the least
        time its K5 and K6 launches could take."""
        p, cfg = self.p, self.config['tower']
        layers = cfg['num_hidden_layers']
        if self.device.type == 'cuda' and (
                launched['k6'] != layers or launched['k5'] != 2
                or launched['k2'] != 0):
            raise RuntimeError(f'a call launched {launched}: K6 x{layers}, '
                               f'K5 x2 and K2 x0 expected')
        t_pose = self.tower.num_frames(self.n_samples)
        n = len(ref.window_starts(t_pose)) * p['streams'] * ref.WINDOW
        k5_flops, k5_bound = tower_cost.k5_cost(
            self.config['generator'], [n] if launched['k5'] else [])
        heads = cfg['num_attention_heads']
        shape = (p['streams'], heads, self.frames(),
                 cfg['hidden_size'] // heads)
        k6_flops = tower_cost.k6_flops(*shape) * launched['k6']
        k6_bound = yardstick.bound_s(
            k6_flops, tower_cost.k6_bytes(*shape) * launched['k6'], 'bf16')
        return {'calls': 1, 'audio_s': p['streams'] * p['seconds'],
                'flops': aten + k5_flops + k6_flops,
                'bound_s.k5': k5_bound, 'bound_s.k6': k6_bound}

    def frames(self) -> int:
        """The tower's sequence length: the extractor's output frames."""
        t = self.n_samples
        for k, s in zip(self.config['tower']['conv_kernel'],
                        self.config['tower']['conv_stride']):
            t = (t - k) // s + 1
        return t

    def call(self) -> dict:
        k = int(self.order[self.i % len(self.order)])
        poses = self.program(self.pool[k], self.sr)
        self.sample.offer((k, poses, self.hidden))
        self.i += 1
        return self.work

    def release(self) -> None:
        self.tower = None
        super().release()

    # -- the comparison ---------------------------------------------------

    def reference_tower(self, fp8: bool = False, drop_bias: bool = False):
        if getattr(self, '_state', None) is None:
            self._state = wavlm_gen.seeded_state(
                self.config['tower'], self.tower_seed, self.device,
                self.config['generator']['in_channels'])
        return wavlm_gen.Tower(self.config['tower'], self._state, fp8,
                               drop_bias)

    def reference(self, k: int, **kw) -> tuple[np.ndarray, list]:
        """(streams, T, 104) reference poses of pool entry ``k`` and each
        stream's (T', hidden) last hidden state, on the card."""
        common.set_tf32(False)
        tower = self.reference_tower(**kw)
        gen = self.reference_model()
        poses, hidden = [], []
        for wave in self.pool[k]:
            w = torch.as_tensor(wave, device=self.device)
            h = tower.hidden(w)
            poses.append(wavlm_gen.stream_poses(gen, tower, w, h))
            hidden.append(h)
        return np.stack(poses), hidden

    @staticmethod
    def _gaps(poses, hidden, ref_poses, ref_hidden) -> dict:
        got = common.pose_gaps(poses, ref_poses)
        num = sum(float((a.float() - b).pow(2).sum())
                  for a, b in zip(hidden, ref_hidden))
        den = sum(float(b.pow(2).sum()) for b in ref_hidden)
        return dict(got, feat_gap=(num / den) ** 0.5)

    def verify(self) -> dict:
        """The widest gaps over the sampled calls."""
        refs = {}
        worst = dict(max_gap=0.0, rms_gap=0.0, feat_gap=0.0)
        for k, poses, hidden in self.sample.items:
            if k not in refs:
                refs[k] = self.reference(k)
            got = self._gaps(np.stack(poses), list(hidden), *refs[k])
            worst = {n: max(worst[n], got[n]) for n in worst}
        return worst

    def control(self, fp8: bool = False, drop_bias: bool = False) -> dict:
        """The gaps of the reference computed lower (``fp8``) or without
        the gated bias (``drop_bias``) from the reference, over the pool
        entries of the sampled calls."""
        worst = dict(max_gap=0.0, rms_gap=0.0, feat_gap=0.0)
        for k in sorted({item[0] for item in self.sample.items}):
            base = self.reference(k)
            low = self.reference(k, fp8=fp8, drop_bias=drop_bias)
            got = self._gaps(low[0], low[1], *base)
            worst = {n: max(worst[n], got[n]) for n in worst}
        return worst
