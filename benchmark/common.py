"""Pieces the drivers share: the program's launch counters, the operation
count of a call, a seeded sample of a window's answers, the plain
reference's models and the gaps a comparison reads."""

from __future__ import annotations

import gc
import random

import numpy as np
import torch

import yardstick
from harness import ROOT
from reference import audio2motion as ref

#: the program's launch counters: name -> (module, function, attribute)
COUNTERS = {
    'k1': ('a2m_torch.nn.gcn_kernel', 'gcn_stack', 'launches'),
    'k3': ('a2m_torch.nn.gcn_kernel', 'gcn_stack_fwd', 'launches'),
    'k4': ('a2m_torch.nn.gcn_kernel', 'gcn_stack_bwd', 'launches'),
    'k5': ('a2m_torch.nn.gcn_kernel', 'gcn_stack_edge', 'launches'),
    'k2': ('a2m_torch.audio.mel_kernel', 'log_mel', 'launches'),
}


def launches() -> dict[str, int]:
    import importlib
    return {k: getattr(getattr(importlib.import_module(m), f), a)
            for k, (m, f, a) in COUNTERS.items()}


def count_call(fn):
    """Run ``fn()`` once under ``FlopCounterMode``: (its result, the aten
    operations it dispatched, the kernel launches it made by counter).  The
    hand-written kernels launch on raw pointers, which the counter does not
    see; their operations are the caller's to add from the launches (the
    method of the program's ``utils/mfu.step_flops``)."""
    from torch.utils.flop_counter import FlopCounterMode
    before = launches()
    with FlopCounterMode(display=False) as counter:
        out = fn()
    after = launches()
    return (out, float(counter.get_total_flops()),
            {k: after[k] - before[k] for k in after})


def stack_shapes(gen_cfg: dict) -> list[tuple[np.ndarray, int, int]]:
    """(adjacency, features, heads) of the body and the hand stack."""
    f, h = gen_cfg['joint_feat_dim'], gen_cfg['gat_heads']
    return [(ref.body_adjacency(), f, h), (ref.hand_adjacency(), f, h)]


def mel_nnz() -> int:
    """Entries of the filterbank the kernel reads: each mel's bins from its
    first nonzero to its last."""
    mel = ref._mel_slaney(ref.N_MELS, ref.N_FFT, ref.SR)
    total = 0
    for row in mel:
        nz = np.flatnonzero(row)
        total += nz[-1] - nz[0] + 1 if nz.size else 0
    return int(total)


def k2_cost(batch: int, n_samples: int, n_frames: int) -> tuple:
    """(operations, bytes) of one K2 launch."""
    nnz = mel_nnz()
    return (yardstick.log_mel_flops(batch, n_frames, ref.N_FFT, nnz,
                                    ref.N_MELS),
            yardstick.log_mel_bytes(batch, n_samples, n_frames, ref.N_FFT,
                                    ref.HOP, ref.N_FFT, nnz, ref.N_MELS))


def config_gaps(values: dict, held) -> list[str]:
    """The keys of ``values`` (a block of a configuration file) whose value
    the program's ``held`` object (a config dataclass) does not hold, a
    list read as a tuple."""
    def same(a, b):
        return tuple(a) == tuple(b) if isinstance(a, list) else a == b
    return [f'{k}: file {v!r}, program {getattr(held, k, None)!r}'
            for k, v in values.items()
            if not same(v, getattr(held, k, None))]


class Reservoir:
    """A uniform sample of at most ``k`` items from a stream of unknown
    length, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = random.Random(seed)

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def reference_generator(config: dict, device, mode: str):
    """The plain reference generator with the configuration's weights, in
    eval mode, its GCN stacks rounding as ``mode`` says."""
    gen = ref.Generator(config['generator'])
    flat, _ = ref.load_npz(ROOT / config['weights'])
    gen.load_state_dict(ref.state_from_flat(flat, gen))
    gen.set_stack_mode(mode)
    return gen.to(device).eval()


class ServeDriver:
    """What the two serving drivers share: a seeded sample of the window's
    answers, each with the pool entry it answered, compared with the
    reference's answer to that entry (``self.reference(k, tf32)``)."""

    #: the control (the reference one precision lower) and, for
    #: information, the reference with f32 GCN operands
    controls = (('control_tf32', {'tf32': True}),
                ('f32_stacks', {'tf32': False, 'mode': 'f32'}))
    span = 'bench.serve'

    def release(self) -> None:
        """Drop the program's state; the sampled answers stay."""
        self.program = None
        free_device()

    def reference_model(self):
        if getattr(self, '_ref', None) is None:
            self._ref = reference_generator(self.config, self.device,
                                            self.stack_mode)
        return self._ref

    def verify(self) -> dict:
        """The widest gaps over the sampled calls."""
        refs, worst = {}, dict(max_gap=0.0, rms_gap=0.0)
        for k, answer in self.sample.items:
            if k not in refs:
                refs[k] = self.reference(k)
            got = pose_gaps(answer, refs[k])
            worst = {n: max(worst[n], got[n]) for n in worst}
        return worst

    def control(self, tf32: bool = True, mode: str | None = None) -> dict:
        """The gaps of the reference computed lower (TF32 on, or its GCN
        stacks rounded as ``mode`` says) from the reference, over the pool
        entries of the sampled calls."""
        worst = dict(max_gap=0.0, rms_gap=0.0)
        for k in sorted({k for k, _ in self.sample.items}):
            base = self.reference(k)
            if mode is not None:
                self.reference_model().set_stack_mode(mode)
            try:
                low = self.reference(k, tf32=tf32)
            finally:
                self.reference_model().set_stack_mode(self.stack_mode)
            got = pose_gaps(low, base)
            worst = {n: max(worst[n], got[n]) for n in worst}
        return worst


def pose_gaps(prog: np.ndarray, refp: np.ndarray) -> dict[str, float]:
    """The widest gap of a pose, over the reference's largest magnitude,
    and the root-mean-square gap over the reference's."""
    prog = np.asarray(prog, np.float64)
    refp = np.asarray(refp, np.float64)
    if prog.shape != refp.shape or not np.isfinite(prog).all():
        return dict(max_gap=float('inf'), rms_gap=float('inf'))
    diff = prog - refp
    return dict(max_gap=float(np.abs(diff).max() / np.abs(refp).max()),
                rms_gap=float(np.sqrt((diff ** 2).mean()
                                      / (refp ** 2).mean())))
