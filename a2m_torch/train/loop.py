"""Training loop: the controller-driven GAN schedule
(``a2m/train/loop.py:424-528``), validation (``:569-585``), the style ids
(``:353-371``), the background prefetch (``:373-422``), checkpoints,
resume, warm start and best-G selection (``:203-269``, ``:538-624``), and
the MFU line and trace of the first steps (``:323-351``, ``:460-522``).

:class:`Trainer` runs over any iterable of batches, either a2m's dicts (as
the data loader's ``Batcher`` gives them: ``audio/log_mel_512``,
``pose/data``, ``style``, ``mask``) or ``(audio, pose, style, mask)``
tuples: ``audio`` (B, T, 128) log-mel, ``pose`` (B, T, 104) raw keypoints in
block layout, ``style`` (B,) speaker ids or None, ``mask`` (B,) 1/0 weights
of wrap-padded rows.  Each batch is staged on the trainer's device when it
is consumed or, with ``prefetch_batches`` > 0, that many ahead of the step
by a worker thread (pinned host buffers, non-blocking copies on a copy
stream of its own, which the step's stream waits for).  Given a loader (an
object with ``.train`` and ``.dev``), the trainer takes its batches and,
when no ``mean``/``std`` are given, the neck-subtracted moments of
``.train``.

In a process group (:mod:`a2m_torch.parallel.launch`) the trainer is one
rank of a data-parallel run, as a2m's trainer is one process of its mesh
(``loop.py:41-63``, ``:92-198``, ``:555-622``): its steps run over the
global batch (``parallel.mesh.global_batch``: gradients summed over the
ranks, global metrics), so every rank's controller sees the same
losses and takes the same branches; ``mean``/``std`` come from the ranks'
summed moments (``launch.sync_global_moments``); parameters, buffers and
statistics are broadcast from rank 0 once built or warm-started; the
default generator is seeded with ``seed + data rank`` (dropout differs
across data ranks and is the same in the ranks of a model group, the label
noise is the same everywhere); only rank 0 logs (``A2M_DIST_DEBUG``
prefixes every rank's lines instead); every rank enters each save, rank 0
writes, and all meet at a barrier after.  With a model axis
(``mesh.model > 1``, :func:`a2m_torch.parallel.mesh.make_mesh`) the models
are sharded under ``TP_RULES`` once broadcast, the optimisers are built
over the slices, checkpoints are gathered to the one-process layout before
rank 0 writes them, and a restore slices them again.

Given a ``save_dir``, the trainer keeps its run there as a2m does:
``ckpt/epoch_<n>.pt`` every ``save_every_epochs`` epochs
(:class:`~a2m_torch.train.checkpoint.CheckpointManager`),
``ckpt/best_gen.npz`` whenever ``best_metric`` improves, and ``loss.npy``;
with ``resume`` it continues from the latest checkpoint there.
:meth:`Trainer.from_config` builds the models and the trainer from a
:class:`~a2m_torch.config.Config`, with its ``save_dir``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from a2m_torch.config import (Config, DiscriminatorConfig, GeneratorConfig,
                              TrainConfig, validate)
from a2m_torch.data.normalization import (finalize_moments_necksub,
                                          get_moments_necksub)
from a2m_torch.parallel import launch, mesh
from a2m_torch.train import checkpoint as ckpt_lib
from a2m_torch.train.controller import DynamicGANTraining
from a2m_torch.train.train_step import (init_states, make_train_steps,
                                        set_lr)
from a2m_torch.utils import mfu as mfu_lib
from a2m_torch.utils import profiling


class Trainer:
    """``train_epoch(epoch)``, ``validate()`` and ``fit(n_epochs)`` around
    ``g_step``/``d_step``/``eval_step``.

    ``mean``/``std`` (104,) normalise the pose inside the steps.  ``steps``
    replaces the ``(g_step, d_step, eval_step)`` of
    :func:`make_train_steps` (tests script the losses with it).  ``loader``
    (``.train``, ``.dev`` iterables of dict batches) replaces
    ``train_batches`` and ``dev_batches``, and gives ``mean``/``std`` from
    its train set's neck-subtracted moments when none are given (a2m's
    ``get_mean_std_necksub(dataloader.train)``, ``loop.py:196-198``).

    ``save_dir`` keeps the run's checkpoints, best G and loss history
    there, and with ``cfg.resume`` restores the latest checkpoint (models,
    optimisers, controller, ``mean``/``std``, loss history; ``start_epoch``
    follows it); without it nothing is written and no best G is selected.
    ``cfg.init_from`` warm-starts G, the pose statistics when the file
    carries them, and D when ``imported_disc.npz`` lies beside
    ``best_gen.npz``, before a restore, which takes precedence."""

    def __init__(self, g_model, d_model, cfg: TrainConfig = TrainConfig(),
                 train_batches=(), dev_batches=(), mean=None, std=None,
                 seed: int = 0, log=print, steps=None, loader=None,
                 save_dir=None):
        self.cfg = cfg
        self.device = next(g_model.parameters()).device
        import torch.distributed as dist
        self.rank, self.world = mesh.process_identity()
        self.log = _rank_log(log, self.rank, self.world)
        if dist.is_initialized():
            # dropout: per data rank, in step within a model group
            torch.manual_seed(seed + mesh.data_identity()[0])
        #: what the style ids depend on (modules without a ``config`` get
        #: the defaults)
        self.g_config = getattr(g_model, 'config', GeneratorConfig())
        self.d_config = getattr(d_model, 'config', DiscriminatorConfig())
        self.controller = DynamicGANTraining(cfg.controller)
        self.g_step, self.d_step, self.eval_step = (
            steps or make_train_steps(g_model, d_model, cfg))
        if loader is not None:
            train_batches, dev_batches = loader.train, loader.dev
            if mean is None and std is None:
                # each rank's slice; summed to the global statistics
                mean, std = finalize_moments_necksub(
                    *launch.sync_global_moments(
                        *get_moments_necksub(loader.train)))
        self.train_batches, self.dev_batches = train_batches, dev_batches
        self.mean = self._put(torch.zeros(104) if mean is None else mean)
        self.std = self._put(torch.ones(104) if std is None else std)
        #: label noise (the same stream on every rank); dropout draws from
        #: the device's default generator
        self.key = torch.Generator(device=self.device).manual_seed(seed)
        self.loss_history: dict[str, list] = {
            'train_g': [], 'train_d': [], 'val_g': [], 'val_d': []}
        self.save_dir = None if save_dir is None else Path(save_dir)
        self.ckpt = (None if save_dir is None
                     else ckpt_lib.CheckpointManager(self.save_dir / 'ckpt'))
        self.start_epoch = 0
        self._mfu_done = not cfg.log_mfu
        self._mfu_times: dict[str, list] = {'g': [], 'd': []}
        self._mfu_flops: dict[str, float] = {}
        #: the MFU line's numbers once logged: ms, flops and mfu by step
        self.mfu_report: dict[str, dict] = {}
        if cfg.init_from:
            self._init_from(cfg.init_from, g_model, d_model)
        # built or warm-started alike on every rank; rank 0's values are
        # the run's.  Then each rank keeps its slices (tensor parallelism),
        # and the optimisers hold what the rank holds.
        mesh.broadcast_state([*g_model.state_dict().values(),
                              *d_model.state_dict().values()])
        mesh.shard_module(g_model)
        mesh.shard_module(d_model)
        self.g_state, self.d_state = init_states(
            g_model, d_model, cfg.controller.g_lr, cfg.controller.d_lr)
        if cfg.resume and self.ckpt is not None:
            # every rank reads the same file, each its own slices
            restored = self.ckpt.restore(self.g_state, self.d_state)
            if restored is not None:
                self.controller.load_state_dict(restored['controller'])
                self.mean = self._put(restored['mean'])
                self.std = self._put(restored['std'])
                self.start_epoch = restored['epoch'] + 1
                self.loss_history = restored['extra'].get(
                    'loss_history', self.loss_history)
                self.log(f'resumed from epoch {restored["epoch"]}')
        mesh.broadcast_state([self.mean, self.std])

    @classmethod
    def from_config(cls, cfg: Config, loader, device='cuda', seed: int = 0,
                    log=print) -> 'Trainer':
        """The trainer of a :class:`~a2m_torch.config.Config` (validated):
        a generator and a discriminator built from ``cfg.generator`` and
        ``cfg.discriminator``, initialised from ``seed``, on ``device``, fed
        by ``loader`` (``.train``, ``.dev``), keeping its run in
        ``cfg.train.save_dir``.  On CUDA the generator's GCN stacks always
        take the fused kernels (the stash-forward and backward kernels under
        autograd, the forward kernel without), as ``build_trainer`` builds
        them; a2m keeps them opt-in for its TPU compiler's minutes per
        kernel, which the port does not pay.  On the CPU the config's
        ``fused_gcn`` stands.  Both models compute in
        ``cfg.train.compute_dtype`` (a2m's ``loop.py:65-70``)."""
        from a2m_torch.config import torch_dtype
        from a2m_torch.device import resolve_device
        from a2m_torch.models.discriminator import Discriminator
        from a2m_torch.models.generator import Generator
        cfg = validate(cfg)
        mesh.make_mesh(cfg.mesh)            # None in one process
        dtype = torch_dtype(cfg.train.compute_dtype)
        dev = resolve_device(device)
        g_cfg = cfg.generator
        if dev.type == 'cuda':
            g_cfg = dataclasses.replace(g_cfg, fused_gcn=True)
            # every rank builds (or finds) the libraries itself: each
            # compile writes a file of its own and renames it into place
            from a2m_torch import _build
            _build.build(('gcn_stack', 'gcn_stack_bwd'))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            g_model = Generator(g_cfg, dtype=dtype)
            d_model = Discriminator(cfg.discriminator, dtype=dtype)
        return cls(g_model.to(dev), d_model.to(dev), cfg.train, seed=seed,
                   log=log, loader=loader, save_dir=cfg.train.save_dir)

    def _init_from(self, path, model, d_model) -> None:
        """Warm-start from a packed best-G ``.npz`` or a directory that
        holds ``best_gen.npz`` and, optionally, ``imported_disc.npz`` (the
        layout ``python -m a2m_torch.compat`` writes; a2m's
        ``loop.py:235-270``): G's weights, its pose statistics when the file
        carries them (the model's outputs live in that normalisation), and
        D's params and BatchNorm statistics.  Optimisers start fresh (the
        reference never persisted them, ``version5_model_train.py:509-515``).
        a2m's Orbax ``imported_disc/`` directory raises."""
        from a2m_torch.weights import from_jax_variables, load_generator_npz
        p = Path(path)
        if (p / 'imported_disc').is_dir():
            raise ValueError(
                f'train.init_from: {p / "imported_disc"} is an Orbax '
                f'checkpoint, which the port cannot read; migrate the '
                f'reference discriminator with python -m a2m_torch.compat '
                f'--disc ..., which writes imported_disc.npz')
        best = ckpt_lib.load_any_generator_ckpt(p)
        if best is None:
            raise FileNotFoundError(
                f'train.init_from: no best_gen.npz under {p}')
        model.load_state_dict(from_jax_variables(best['variables'], model))
        loaded = 'G'
        if 'mean' in best:
            self.mean = self._put(best['mean'])
            self.std = self._put(best['std'])
            loaded += '+stats'
        d_file = p / 'imported_disc.npz'
        if d_file.is_file():
            flat, _ = load_generator_npz(d_file)
            d_model.load_state_dict(from_jax_variables(flat, d_model))
            loaded += '+D'
        self.log(f'initialized {loaded} from {p}')

    def _put(self, t):
        if t is None:
            return None
        return torch.as_tensor(t).to(self.device)

    def _style_ids(self, batch):
        """(B,) int32 speaker ids of a dict batch when style conditioning or
        the aux CE is on, else None."""
        if (self.g_config.num_style_speakers <= 0
                and self.cfg.lambda_aux <= 0):
            return None
        style = np.asarray(batch['style'])
        if style.ndim > 1:
            style = style[:, 0]
        if self.cfg.lambda_aux > 0:
            # an out-of-range label would be a zero one-hot row, and the
            # aux CE would silently give those samples nothing
            n = self.d_config.aux_classes
            if style.max(initial=0) >= n:
                raise ValueError(
                    f'aux CE: speaker id {int(style.max())} >= '
                    f'discriminator.aux_classes={n}; raise aux_classes to '
                    f'cover every speaker style id')
        return torch.from_numpy(style.astype(np.int32))

    def _stage(self, batch) -> tuple:
        """One batch (dict or tuple) -> (audio, pose, style, mask) on the
        trainer's device; host arrays go through pinned memory with
        non-blocking copies."""
        if isinstance(batch, dict):
            batch = (batch['audio/log_mel_512'], batch['pose/data'],
                     self._style_ids(batch), batch['mask'])
        pin = self.device.type == 'cuda'

        def put(x, dtype=None):
            if x is None:
                return None
            t = torch.as_tensor(x)
            if dtype is not None:
                t = t.to(dtype)
            if pin and t.device.type == 'cpu':
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        audio, pose, style, mask = batch
        return (put(audio, torch.float32), put(pose, torch.float32),
                put(style), put(mask))

    def _prefetch(self, iterator):
        """Stage batches on the device ahead of consumption: a worker thread
        stages batch i + 1 (and on, ``cfg.prefetch_batches`` deep) while
        batch i computes; 0 stages each batch when it is consumed.  On CUDA
        the worker copies on a stream of its own, so the copies overlap the
        running steps; the consumer's stream waits for each batch's copies
        and the batch's memory is marked as used there.  A failure in the
        worker is raised here, and the worker ends when the consumer
        abandons the epoch."""
        depth = self.cfg.prefetch_batches
        if depth <= 0:
            for batch in iterator:
                yield self._stage(batch)
            return
        copy_stream = (torch.cuda.Stream(self.device)
                       if self.device.type == 'cuda' else None)
        q: queue.Queue = queue.Queue(maxsize=depth)
        done = object()
        stop = threading.Event()   # consumer abandoned the epoch: unblock

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def stage(batch):
            values = batch.values() if isinstance(batch, dict) else batch
            if copy_stream is None or any(
                    isinstance(v, torch.Tensor) and v.is_cuda
                    for v in values):
                # nothing to upload, and a cast of a device tensor must
                # follow the stream that made it
                return self._stage(batch), None
            with torch.cuda.stream(copy_stream):
                staged = self._stage(batch)
                return staged, copy_stream.record_event()

        def worker():
            try:
                for batch in iterator:
                    if not put(stage(batch)):
                        return         # consumer gone: release h5 handles
            except BaseException as e:          # surface in the main thread
                put(e)
                return
            put(done)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while (item := q.get()) is not done:
                if isinstance(item, BaseException):
                    raise item
                staged, copied = item
                if copied is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(copied)
                    for t in staged:
                        if t is not None:
                            t.record_stream(current)
                yield staged
        finally:
            stop.set()             # end the worker if we exit early

    def train_epoch(self, epoch: int) -> tuple[float, float]:
        """One pass over ``train_batches``.  Per epoch the controller sets
        the G/D frequencies, the learning rates and the label parameters;
        per batch ``g_freq`` G steps, then ``d_freq`` D steps unless the
        controller skips D.  Returns the last (g_loss, d_loss)."""
        ctrl = self.controller
        g_freq, d_freq = ctrl.adjust_training_frequency(epoch)
        g_lr, d_lr = ctrl.adjust_learning_rates(epoch)
        set_lr(self.g_state.optimizer, g_lr)
        set_lr(self.d_state.optimizer, d_lr)
        real_lp = ctrl.label_params(epoch, is_real=True)
        fake_lp = ctrl.label_params(epoch, is_real=False)
        last_g = last_d = 0.0
        # Deferred metric drain: reading a loss waits for the device, and
        # the controller's per-batch decision only needs the history through
        # the previous batch (a synchronous loop also appends batch i's
        # losses after batch i).  So batch i - 1's metrics are read while
        # batch i's G updates are in flight, and the controller sees the
        # same loss sequence as a synchronous loop.  The read is the span
        # ``a2m.train.drain``: the one place in a batch where the host
        # waits for the card.
        pending = None                  # previous batch's (gm, dm | None)

        @profiling.trace_annotation('a2m.train.drain')
        def drain(p) -> None:
            nonlocal last_g, last_d
            gm_p, dm_p = p
            last_g = float(gm_p['g_loss'])
            if dm_p is not None:
                last_d = float(dm_p['d_loss'])
            ctrl.update_loss_history(last_d, last_g)

        log_every = self.cfg.log_every_batches
        profile_dir = self.cfg.profile_dir
        n_batches = 0
        for i, (audio, pose, style, mask) in enumerate(
                self._prefetch(self.train_batches)):
            measuring = not self._mfu_done
            tracing = measuring and bool(profile_dir) and i == 2
            with (profiling.device_trace(profile_dir) if tracing
                  else contextlib.nullcontext()) as trace:
                for _ in range(g_freq):
                    with profiling.trace_annotation('a2m.g_step'):
                        self.g_state, self.d_state, gm = self._step(
                            'g', measuring, self.g_step, self.g_state,
                            self.d_state, audio, pose, self.mean, self.std,
                            real_lp.smooth_real, real_lp.noise_std,
                            self.key, style=style, mask=mask)
                if pending is not None:
                    drain(pending)
                dm = None
                if ctrl.should_train_discriminator():
                    for _ in range(d_freq):
                        with profiling.trace_annotation('a2m.d_step'):
                            self.d_state, self.g_state, dm = self._step(
                                'd', measuring, self.d_step, self.g_state,
                                self.d_state, audio, pose, self.mean,
                                self.std, real_lp.smooth_real,
                                fake_lp.smooth_fake, real_lp.noise_std,
                                self.key, style=style, mask=mask)
                # else dm stays None: the drain reuses the last d_loss
                pending = (gm, dm)
            if tracing:
                self.log(f'device trace -> {trace[0]}')
            if (measuring and i >= (2 if profile_dir else 1)
                    and len(self._mfu_times['g']) >= 2):
                self._mfu_report(audio.shape[0])
            n_batches += 1
            if i % log_every == log_every - 1:
                # last_g/last_d lag one batch behind the display
                rd, rg = ctrl.get_recent_avg_loss()
                self.log(f'[Epoch {epoch}] [Batch {i + 1}] '
                         f'[D {last_d:.4f}] [G {last_g:.4f}] '
                         f'[recent D {rd:.4f} G {rg:.4f}] '
                         f'[freq G{g_freq}/D{d_freq}]')
                self.loss_history['train_g'].append(last_g)
                self.loss_history['train_d'].append(last_d)
        if pending is not None:
            drain(pending)              # the final batch completes the history
        if not self._mfu_done and self._mfu_times['g'] and n_batches:
            # an epoch shorter than the report's threshold would otherwise
            # keep measuring (and synchronising every step) for ever
            self._mfu_report(audio.shape[0])
        return last_g, last_d

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _step(self, kind: str, measuring: bool, step, *args, **kwargs):
        """``step(*args, **kwargs)``; while the MFU is measured, timed on
        the host clock between two synchronisations, and its first call of
        each kind counted by :func:`a2m_torch.utils.mfu.step_flops` (that
        sample, which also holds the warm-up, is dropped from the time)."""
        if not measuring:
            return step(*args, **kwargs)
        self._sync()
        t0 = time.perf_counter()
        if kind in self._mfu_flops:
            out = step(*args, **kwargs)
        else:
            out, self._mfu_flops[kind] = mfu_lib.step_flops(
                step, *args, **kwargs)
        self._sync()
        self._mfu_times[kind].append(time.perf_counter() - t0)
        return out

    def _mfu_report(self, batch: int) -> None:
        """Log the MFU of ``g_step`` (and ``d_step`` when it ran) once, from
        the median time of the measured steps after the first."""
        self._mfu_done = True
        dtype = self.cfg.compute_dtype
        line = []
        for kind, name in (('g', 'g_step'), ('d', 'd_step')):
            times = self._mfu_times[kind]
            if not times:
                continue
            secs = float(np.median(times[1:] or times))
            flops = self._mfu_flops[kind]
            self.mfu_report[name] = dict(
                ms=secs * 1e3, flops=flops, samples=len(times[1:] or times),
                mfu=mfu_lib.mfu(flops, secs, dtype, self.device))
            self.log(mfu_lib.format_mfu_line(name, flops, secs, dtype,
                                             self.device, self.world))
            line.append(f'{batch / secs:.0f} samples/s ({kind})')
        self.log('throughput: ' + ', '.join(line))

    def validate(self) -> dict[str, float]:
        """Mean of ``eval_step``'s metrics over ``dev_batches`` (in a
        process group each batch's metrics are the global batch's, and
        every rank runs as many batches)."""
        sums: dict[str, float] = {}
        steps = 0
        for batch in self.dev_batches:
            audio, pose, style, mask = self._stage(batch)
            metrics = self.eval_step(self.g_state, self.d_state, audio, pose,
                                     self.mean, self.std, mask, style=style)
            # one transfer for the whole metric dict
            values = torch.stack([v.float() for v in metrics.values()]).cpu()
            for k, v in zip(metrics, values.tolist()):
                sums[k] = sums.get(k, 0.0) + v
            steps += 1
        return {k: v / max(steps, 1) for k, v in sums.items()}

    def best_score(self, val: dict[str, float]) -> float:
        """Scalar to minimise for best-G selection, per ``best_metric``
        ('val_pck' is a quality metric: negated, so higher PCK wins)."""
        m = self.cfg.best_metric
        if m not in val:
            raise KeyError(f'train.best_metric={m!r} not in validation '
                           f'metrics {sorted(val)}')
        return -val[m] if m == 'val_pck' else val[m]

    def initial_best_score(self) -> float:
        """The 'best' a resumed run starts from."""
        hist = self.loss_history.get('best_score')
        if hist:
            return min(hist)
        if self.cfg.best_metric == 'val_g':
            # runs from before best_metric tracked the best by val_g
            return min(self.loss_history['val_g'], default=float('inf'))
        return float('inf')

    def save_best(self, epoch: int, val: dict[str, float]) -> None:
        self.loss_history.setdefault('best_score', []).append(
            self.best_score(val))
        self.ckpt.save_best_generator(self.g_state.model, self.mean,
                                      self.std)
        m = self.cfg.best_metric
        self.log(f'new best G at epoch {epoch} ({m} {val[m]:.4f})')

    def fit(self, n_epochs: int | None = None) -> dict:
        """Epochs ``start_epoch`` to ``n_epochs - 1`` of ``train_epoch`` +
        ``validate``; with a ``save_dir``, best-G selection after each and a
        checkpoint and ``loss.npy`` every ``save_every_epochs``.  Returns
        the loss history."""
        n_epochs = self.cfg.n_epochs if n_epochs is None else n_epochs
        best_val = self.initial_best_score()
        for epoch in range(self.start_epoch, n_epochs):
            t0 = time.perf_counter()
            self.train_epoch(epoch)
            val = self.validate()
            self.loss_history['val_g'].append(val.get('val_g', 0.0))
            self.loss_history['val_d'].append(val.get('val_d', 0.0))
            self.log(f'[Validation] Epoch {epoch}/{n_epochs} | '
                     f'G {val.get("val_g", 0):.4f} '
                     f'D {val.get("val_d", 0):.4f} | '
                     f'bone {val.get("bone", 0):.4f} '
                     f'angle {val.get("angle", 0):.4f} '
                     f'smooth {val.get("smooth", 0):.4f} '
                     f'jerk {val.get("jerk", 0):.4f} | '
                     f'{time.perf_counter() - t0:.1f}s')
            if self.ckpt is None:
                continue
            # an empty dev split gives no metrics to select on: a legitimate
            # tiny-fixture configuration, not a mistyped metric name
            if val:
                score = self.best_score(val)
                if score < best_val:
                    best_val = score
                    self.save_best(epoch, val)
            if epoch % self.cfg.save_every_epochs == 0:
                # every rank enters; rank 0 writes (CheckpointManager)
                self.ckpt.save(epoch, self.g_state, self.d_state,
                               self.controller.state_dict(), self.mean,
                               self.std,
                               extra=dict(loss_history=self.loss_history))
                if self.rank == 0:
                    ckpt_lib.save_loss_history(self.save_dir / 'loss.npy',
                                               self.loss_history)
        return self.loss_history


def _rank_log(log, rank: int, world: int):
    """``log`` for rank 0 of a group (and one process); nothing for the
    other ranks, whose lines would repeat rank 0's.  With ``A2M_DIST_DEBUG``
    set every rank logs, each line prefixed with its rank and the seconds
    since the trainer was built."""
    if world > 1 and os.environ.get('A2M_DIST_DEBUG'):
        t0 = time.time()
        return lambda line: log(f'[p{rank} +{time.time() - t0:.1f}s] {line}')
    return log if rank == 0 else (lambda line: None)
