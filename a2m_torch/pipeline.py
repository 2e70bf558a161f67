"""The audio->pose paths of the port, its streaming server and its trainer.

:func:`build_pipeline` is the twin of ``bench.py:31-73``: raw waveform at
45.6 kHz -> pose-rate log-mel (``spec_log_mel_512`` strided by
``round(89 / 15) = 6``, hop 3072, 64 frames) -> ``Generator`` (eval) ->
pose (B, 64, 104).  :func:`entry` is the twin of
``__graft_entry__.py:18-31``.

:func:`build_server` is the serving entry point: the flagship generator
with both GCN stacks on the edge-form kernel, behind
:func:`a2m_torch.eval.streaming.stream_from_waveforms` (any number of
streams of any length, f32 / int16 / mu-law / client-framed wires).

:func:`build_trainer` is the training entry point: the flagship generator
with its GCN stacks on the fused kernels and a default discriminator under
:class:`a2m_torch.train.loop.Trainer`, fed by a data loader (``loader`` or
``path2data``) or by batches the caller sets.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; they raise when CUDA is absent.  Building a pipeline on CUDA turns
TF32 off for the whole process (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32``): cuDNN would otherwise run the
f32 convolutions in TF32, about three decimal digits.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from a2m_torch.audio import frontend
from a2m_torch.config import (AudioConfig, DataConfig, DiscriminatorConfig,
                              GeneratorConfig, TrainConfig, torch_dtype)
from a2m_torch.constants import AUDIO_FS_MAP, FRAMES_PER_WINDOW
from a2m_torch.device import resolve_device
from a2m_torch.models.discriminator import Discriminator
from a2m_torch.models.generator import Generator
from a2m_torch.utils.profiling import trace_annotation
from a2m_torch.weights import from_jax_variables, load_generator_npz

SR = 45600            # nominal PATS sample rate
CLIP_SECONDS = 4.3
FLAGSHIP_NPZ = Path(__file__).resolve().parents[1] / 'artifacts' / \
    'flagship_best_gen.npz'


def pose_rate_spec() -> frontend.MelSpec:
    """log_mel_512 at 45.6 kHz with the 89 Hz -> 15 fps stride folded into
    the hop."""
    stride = round(AUDIO_FS_MAP['log_mel_512'] / 15)
    return frontend.strided_spec(frontend.spec_log_mel_512(SR), stride)


def load_generator(npz=None, config: GeneratorConfig = GeneratorConfig(),
                   device='cuda') -> Generator:
    """Generator in eval mode with a2m weights from a packed ``.npz``
    (default: the committed flagship)."""
    dev = resolve_device(device)
    model = Generator(config)
    flat, _ = load_generator_npz(FLAGSHIP_NPZ if npz is None else npz)
    model.load_state_dict(from_jax_variables(flat, model))
    return model.to(dev).eval()


def audio_to_pose_fn(model: Generator, device):
    """``audio_to_pose(waveform (B, N)) -> pose (B, 64, 104)`` around an
    eval-mode generator that lies on ``device``.  A call is the span
    ``a2m.window``, with ``a2m.window.frontend`` (the move to the device
    and the log-mel) and ``a2m.window.generator`` below it."""
    dev = torch.device(device)
    spec = pose_rate_spec()

    @trace_annotation('a2m.window')
    def audio_to_pose(waveform) -> torch.Tensor:
        with torch.inference_mode():
            with trace_annotation('a2m.window.frontend'):
                y = torch.as_tensor(waveform).to(dev)
                feats = frontend.log_mel(y, spec, exact=False,
                                         n_frames=FRAMES_PER_WINDOW)
            with trace_annotation('a2m.window.generator'):
                return model(feats)

    return audio_to_pose


def build_pipeline(npz=None, batch: int = 128, fused_gcn: bool = True,
                   device='cuda'):
    """The flagship audio->pose path.  ``fused_gcn`` routes both GCN stacks
    through the fused stack kernel with bf16 operands (a2m's
    ``fused_gcn=True, fused_rolled=True`` of ``bench.py:86``).  ``batch``
    sizes one warm-up call on silence that builds the kernels and lets cuDNN
    pick its algorithms; 0 skips it."""
    dev = resolve_device(device)
    config = GeneratorConfig(fused_gcn=fused_gcn)
    audio_to_pose = audio_to_pose_fn(load_generator(npz, config, dev), dev)
    if batch:
        audio_to_pose(torch.zeros(batch, int(SR * CLIP_SECONDS),
                                  device=dev))
    return audio_to_pose


def build_server(npz=None, device='cuda', fused_edge: bool = True,
                 fused_precise: bool = False):
    """``serve(waveforms, sr=SR, **kw) -> list of (T_s, 104) float32
    poses``: :func:`a2m_torch.eval.streaming.stream_from_waveforms` around
    the flagship generator (weights from a packed ``.npz``, default the
    committed flagship) with its GCN stacks on the fused kernels:
    ``fused_edge`` takes the edge-form kernel, else the dense one; bf16
    operands unless ``fused_precise``.  ``kw`` are the streaming options
    (``method``, ``hop``, ``batch_size``, ``fused``, ``encoding``,
    ``pipeline_groups``, ``framed_n_samples``).  On CUDA the kernels are
    built here, before the first request; ``serve.generator`` is the
    model."""
    from a2m_torch.eval import streaming
    dev = resolve_device(device)
    config = GeneratorConfig(fused_gcn=True, fused_edge=fused_edge,
                             fused_precise=fused_precise)
    generator = load_generator(npz, config, dev)
    if dev.type == 'cuda':
        from a2m_torch import _build
        _build.build(('log_mel',
                      'gcn_stack_edge' if fused_edge else 'gcn_stack'))

    def serve(waveforms, sr: int = SR, **kw):
        return streaming.stream_from_waveforms(generator, waveforms, sr, **kw)

    serve.generator = generator
    return serve


def build_trainer(npz=None, batch: int = 128, device='cuda', seed: int = 0,
                  config: GeneratorConfig = GeneratorConfig(fused_gcn=True),
                  log=print, loader=None, path2data=None,
                  speaker='oliver', data: DataConfig = DataConfig(),
                  compute_dtype: str = 'f32'):
    """A :class:`~a2m_torch.train.loop.Trainer` around the flagship
    generator (weights from a packed ``.npz``, default the committed
    flagship; GCN stacks on the fused kernels: the stash-forward and
    backward kernels in ``g_step``, the forward kernel in ``d_step`` and
    ``eval_step``) and a default discriminator initialised from ``seed``,
    under the default ``TrainConfig``.

    The data: ``loader``, any object with ``.train`` and ``.dev`` iterables
    of a2m's dict batches (the port's ``DataLoader``, or a ``Batcher`` over
    any dataset of dicts); or ``path2data``, a PATS-layout tree read by the
    port's ``DataLoader`` (``loader_from_config`` on ``data`` with
    ``speaker``; needs ``h5py`` and ``pandas``).  Either way the trainer
    takes the loader's batches and normalises poses by the neck-subtracted
    moments of its train set.  ``compute_dtype`` ('f32' or 'bf16') is the
    ``train.compute_dtype`` of both models.  With neither, the caller sets
    ``trainer.train_batches`` and ``trainer.dev_batches``, and the
    ``.npz``'s pose statistics normalise.  ``batch`` sizes one warm-up
    ``eval_step`` on zeros after the CUDA kernels are built; 0 skips it."""
    from a2m_torch.train.loop import Trainer
    dev = resolve_device(device)
    if path2data is not None:
        from a2m_torch.data.dataset import loader_from_config
        speakers = (speaker,) if isinstance(speaker, str) else tuple(speaker)
        loader = loader_from_config(
            dataclasses.replace(data, path2data=str(path2data),
                                speakers=speakers),
            AudioConfig(device=str(dev)))
    dtype = torch_dtype(compute_dtype)
    g_model = Generator(config, dtype=dtype)
    flat, stats = load_generator_npz(FLAGSHIP_NPZ if npz is None else npz)
    g_model.load_state_dict(from_jax_variables(flat, g_model))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        d_model = Discriminator(DiscriminatorConfig(), dtype=dtype)
    mean, std = ((None, None) if loader is not None
                 else (stats.get('mean'), stats.get('std')))
    trainer = Trainer(g_model.to(dev), d_model.to(dev),
                      TrainConfig(compute_dtype=compute_dtype),
                      mean=mean, std=std, seed=seed, log=log, loader=loader)
    if dev.type == 'cuda':
        from a2m_torch import _build
        _build.build(('gcn_stack', 'gcn_stack_bwd'))
    if batch:
        trainer.eval_step(
            trainer.g_state, trainer.d_state,
            torch.zeros(batch, FRAMES_PER_WINDOW, 128, device=dev),
            torch.zeros(batch, FRAMES_PER_WINDOW, 104, device=dev),
            trainer.mean, trainer.std, torch.ones(batch, device=dev))
    return trainer


def entry(device='cuda'):
    """(fn, example_args): the flagship generator forward on a random
    log-mel window (4, 64, 128) -> pose (4, 64, 104), random weights from
    seed 0."""
    dev = resolve_device(device)
    torch.manual_seed(0)
    model = Generator().to(dev).eval()
    audio = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (4, FRAMES_PER_WINDOW, 128)), dtype=torch.float32, device=dev)

    def fn(audio):
        with torch.inference_mode():
            return model(audio)

    return fn, (audio,)
