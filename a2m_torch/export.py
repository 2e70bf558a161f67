"""Serialised inference artifacts via ``torch.export`` (``.pt2``).

Counterpart of ``a2m/export.py``.  The trained generator exports to a
self-contained program: weights, normalisation statistics and log-mel
tables are baked in as its constants, and the fused GCN stacks and the
log-mel are single nodes of the registered ops ``a2m_torch::gcn_stack``
(or ``a2m_torch::gcn_stack_edge``) and ``a2m_torch::log_mel``.  a2m's
StableHLO carries its Pallas kernels inside the module; a ``.pt2`` names
its ops instead, so a process that loads one needs ``torch`` and the two
modules that register them, :mod:`a2m_torch.nn.gcn_kernel` and
:mod:`a2m_torch.audio.mel_kernel`, which build the CUDA kernels from
``a2m_torch/csrc/`` at first use.  No model code and no checkpoint.

Two artifact flavours:

* :func:`export_pose_fn` — (B, T, 128) log-mel features -> (B, T, 104)
  denormalised block-layout poses;
* :func:`export_audio_to_pose` — raw (B, N) waveform -> poses, with the
  pose-rate log-mel (K2 on the card) in the same program.

Precision is part of the artifact: its f32 matmuls and convolutions are
meant to run without TF32, as the live model runs on the card
(``a2m_torch.device.resolve_device``).  :func:`load_artifact`'s callable
turns TF32 off for matmuls and cuDNN around each call and restores both
flags; a caller of ``torch.export.load`` does the same (the ``.meta``
sidecar records it).

CLI::

    python -m a2m_torch.export --ckpt ./save/multi_speaker/ckpt \\
        --path2data ./pats/data --out ./artifacts/a2m_pose.pt2 --check \\
        [--flavor audio] [--batch_size 128] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

# importing the kernel modules registers the ops an artifact holds
from a2m_torch.audio import mel_kernel  # noqa: F401
from a2m_torch.config import Config
from a2m_torch.nn import gcn_kernel  # noqa: F401

#: artifact calling convention version (stored in the sidecar)
FORMAT = 'a2m-torch-export-v1'


def _denorm(pose, mean, std):
    return pose * std + mean


class _Serve(nn.Module):
    """Features (or, with ``spec``, a waveform) -> denormalised pose."""

    def __init__(self, generator: nn.Module, mean, std, spec=None,
                 n_frames: int | None = None):
        super().__init__()
        dev = next(generator.parameters()).device
        self.generator = generator
        self.spec, self.n_frames = spec, n_frames
        for name, value in (('mean', mean), ('std', std)):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(value, np.float32), device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec is not None:
            from a2m_torch.audio import frontend
            x = frontend.log_mel(x, self.spec, exact=False,
                                 n_frames=self.n_frames)
        return _denorm(self.generator(x), self.mean, self.std)


def _frozen(generator: nn.Module, variables) -> nn.Module:
    """A copy of ``generator`` in eval mode, a2m's flat ``variables``
    loaded where given, and each fused stack packed.  Its parameters keep
    ``requires_grad`` as the live model's do, and so do the program's: its
    ``aten.linear`` and ``aten.matmul`` nodes fold a 3-D input that is not
    contiguous into one ``mm``, or run a ``bmm``, by whether the weight
    requires grad, when they run, and the two differ in the last bit (up
    to 7.7e-4 in the pose with bf16 GCN operands, on the card at B = 2).  The
    trace runs under ``torch.no_grad``, so that the fused stacks take their
    gradient-free ops; the program runs under ``torch.inference_mode``
    (:func:`load_artifact`)."""
    from a2m_torch.nn.graph import GCNStack
    from a2m_torch.weights import from_jax_variables
    model = copy.deepcopy(generator)
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables, model))
    model.eval()
    for m in model.modules():
        if isinstance(m, GCNStack) and m.fused:
            m.packed_params()
    return model


def _export(module: nn.Module, example: torch.Tensor):
    with torch.no_grad():
        exported = torch.export.export(module, (example,), strict=False)
    # the example (zeros) is no part of the program, and would add its
    # bytes (100 MB for 128 clips of audio) to the artifact
    exported.example_inputs = None
    return exported


def export_pose_fn(generator, variables, mean, std, batch_size: int = 1,
                   time_steps: int = 64, in_feats: int = 128):
    """Export features -> poses with weights and stats baked in.

    ``generator`` is a port ``Generator``; its config picks the route of
    its GCN stacks (eager, or the ``gcn_stack`` / ``gcn_stack_edge`` op in
    f32 or bf16 operands) and the device its parameters lie on is the
    artifact's.  ``variables`` are a2m's flat variables (``{'params/...':
    array}``, the packed ``.npz`` layout), carried into a copy of the
    generator by ``weights.from_jax_variables``; None keeps the
    generator's own weights.  The copy runs in eval mode, on a fixed input
    of (``batch_size``, ``time_steps``, ``in_feats``) f32, and its output
    is denormalised to absolute block-layout keypoints.  Returns a
    ``torch.export.ExportedProgram``."""
    model = _Serve(_frozen(generator, variables), mean, std)
    return _export(model, torch.zeros(batch_size, time_steps, in_feats,
                                      device=model.mean.device))


def export_audio_to_pose(generator, variables, mean, std, sr: int = 45600,
                         seconds: float = 4.3, batch_size: int = 1):
    """Export waveform -> poses with the log-mel frontend in the program:
    ``log_mel_512`` at ``sr`` with the pose-rate stride folded into the hop
    (``frontend.strided_spec``, fast mode), only the pose-rate frames
    computed.  Takes ``generator`` and ``variables`` as
    :func:`export_pose_fn` does; the input is (``batch_size``,
    ``int(sr * seconds)``) f32."""
    from a2m_torch.audio import frontend
    from a2m_torch.constants import AUDIO_FS_MAP
    fs = AUDIO_FS_MAP['log_mel_512']
    window, stride = int(seconds * fs), round(fs / 15)
    spec = frontend.strided_spec(frontend.spec_log_mel_512(sr), stride)
    model = _Serve(_frozen(generator, variables), mean, std, spec,
                   len(range(0, window, stride)))
    dev = model.mean.device
    # built before the trace, the tables are constants on the device
    frontend.mel_tables(spec, dev)
    return _export(model, torch.zeros(batch_size, int(sr * seconds),
                                      device=dev))


def _signature(exported) -> dict:
    """Device, input and output shapes and types, and the ``a2m_torch``
    ops of an exported program (op name -> nodes)."""
    sig = exported.graph_signature
    nodes = {n.name: n for n in exported.graph.nodes}
    output = next(n for n in exported.graph.nodes if n.op == 'output')
    ins = [nodes[name].meta['val'] for name in sig.user_inputs]
    outs = [a.meta['val'] for a in output.args[0]
            if a.name in sig.user_outputs]
    ops = collections.Counter(
        n.target.name() for n in exported.graph.nodes
        if n.op == 'call_function'
        and getattr(n.target, 'namespace', None) == 'a2m_torch')
    return dict(device=str(ins[0].device),
                inputs=[[list(v.shape), str(v.dtype)] for v in ins],
                outputs=[[list(v.shape), str(v.dtype)] for v in outs],
                ops=dict(sorted(ops.items())))


def save_artifact(exported, path) -> Path:
    """``torch.export.save`` to ``path``, plus a ``path + '.meta'``
    sidecar (JSON): the format, the device it was exported for, input and
    output shapes and types, the ``a2m_torch`` ops of the graph, the torch
    version and the precision it runs at."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, path)
    meta = dict(format=FORMAT, **_signature(exported),
                torch=torch.__version__,
                precision=dict(
                    tf32_matmul=False, tf32_cudnn=False,
                    note='f32 throughout: run with '
                         'torch.backends.cuda.matmul.allow_tf32 and '
                         'torch.backends.cudnn.allow_tf32 False '
                         '(load_artifact does)'),
                needs=['torch', 'a2m_torch.nn.gcn_kernel',
                       'a2m_torch.audio.mel_kernel'])
    Path(f'{path}.meta').write_text(json.dumps(meta) + '\n')
    return path


@contextlib.contextmanager
def _without_tf32():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def load_artifact(path):
    """Load an artifact; returns a callable that runs it under
    ``torch.inference_mode`` with TF32 off.  Needs only ``torch`` and the
    two kernel modules (imported by this module), no model code."""
    module = torch.export.load(str(path)).module()

    def call(x: torch.Tensor) -> torch.Tensor:
        with _without_tf32(), torch.inference_mode():
            return module(x)

    return call


def _build_from_checkpoint(ckpt_dir, path2data, speakers, cfg: Config,
                           device='cuda'):
    """(generator on ``device``, a2m flat variables or None, mean, std)
    from a checkpoint (a packed best-G ``.npz`` or a directory holding
    ``best_gen.npz``) and the pose statistics it carries; without them,
    those of ``path2data``'s train split, else the identity.  On CUDA the
    GCN stacks run on the dense kernel (``fused_gcn``, not
    ``fused_edge``; bf16 operands unless ``cfg.generator.fused_precise``),
    as the harness runs them; on the CPU ``cfg.generator`` stands."""
    from a2m_torch.device import resolve_device
    from a2m_torch.models.generator import Generator
    from a2m_torch.train.checkpoint import load_any_generator_ckpt
    dev = resolve_device(device)
    g_cfg = cfg.generator
    if dev.type == 'cuda':
        g_cfg = dataclasses.replace(g_cfg, fused_gcn=True, fused_edge=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        generator = Generator(g_cfg)
    variables = mean = std = None
    if ckpt_dir is not None:
        best = load_any_generator_ckpt(ckpt_dir)
        if best is None:
            raise FileNotFoundError(f'no best_gen checkpoint at {ckpt_dir}')
        variables = best['variables']
        # the stats shipped with the checkpoint define the model's output
        # space: bake those, not whatever a loader would derive
        if 'mean' in best:
            mean, std = best['mean'], best['std']
    if mean is None:
        if path2data is not None:
            from a2m_torch.data.dataset import DataLoader
            from a2m_torch.data.normalization import get_mean_std_necksub
            dl = DataLoader(path2data=path2data, speaker=list(speakers),
                            modalities=['pose/data', 'audio/log_mel_512'],
                            fs_new=[15, 15], batch_size=64, window_hop=5,
                            device=str(dev))
            mean, std = get_mean_std_necksub(dl.train)
        else:
            mean, std = np.zeros(104, np.float32), np.ones(104, np.float32)
    return generator.to(dev), variables, mean, std


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ckpt', default=None)
    ap.add_argument('--path2data', default=None,
                    help='PATS tree for normalization stats (else identity)')
    ap.add_argument('--speaker', nargs='+', default=['oliver'])
    ap.add_argument('--out', default='./artifacts/a2m_pose.pt2')
    ap.add_argument('--batch_size', type=int, default=1)
    ap.add_argument('--flavor', choices=['pose', 'audio'], default='pose')
    ap.add_argument('--check', action='store_true',
                    help='load the artifact and run it on zeros')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    generator, variables, mean, std = _build_from_checkpoint(
        args.ckpt, args.path2data, args.speaker, Config(), args.device)
    export = (export_pose_fn if args.flavor == 'pose'
              else export_audio_to_pose)
    exported = export(generator, variables, mean, std,
                      batch_size=args.batch_size)
    path = save_artifact(exported, args.out)
    size = path.stat().st_size
    sig = _signature(exported)
    print(f'{FORMAT}: {path} ({size / 1e6:.1f} MB, device {sig["device"]}, '
          f'ops {sig["ops"]})')
    if args.check:
        shape = sig['inputs'][0][0]
        out = load_artifact(path)(torch.zeros(shape, device=sig['device']))
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError('artifact produced non-finite output')
        print(f'check OK: {tuple(shape)} -> {tuple(out.shape)}')
    return dict(path=str(path), bytes=size)


if __name__ == '__main__':
    main()
