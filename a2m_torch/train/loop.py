"""Training loop: the controller-driven GAN schedule
(``a2m/train/loop.py:424-528``), validation (``:569-585``), the style ids
(``:353-371``) and the background prefetch (``:373-422``).

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
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from a2m_torch.config import (DiscriminatorConfig, GeneratorConfig,
                              TrainConfig)
from a2m_torch.data.normalization import get_mean_std_necksub
from a2m_torch.train.controller import DynamicGANTraining
from a2m_torch.train.train_step import (init_states, make_train_steps,
                                        set_lr)


class Trainer:
    """``train_epoch(epoch)``, ``validate()`` and ``fit(n_epochs)`` around
    ``g_step``/``d_step``/``eval_step``.

    ``mean``/``std`` (104,) normalise the pose inside the steps.  ``steps``
    replaces the ``(g_step, d_step, eval_step)`` of
    :func:`make_train_steps` (tests script the losses with it).  ``loader``
    (``.train``, ``.dev`` iterables of dict batches) replaces
    ``train_batches`` and ``dev_batches``, and gives ``mean``/``std`` from
    its train set's neck-subtracted moments when none are given (a2m's
    ``get_mean_std_necksub(dataloader.train)``, ``loop.py:196-198``)."""

    def __init__(self, g_model, d_model, cfg: TrainConfig = TrainConfig(),
                 train_batches=(), dev_batches=(), mean=None, std=None,
                 seed: int = 0, log=print, steps=None, loader=None):
        self.cfg = cfg
        self.device = next(g_model.parameters()).device
        #: what the style ids depend on (modules without a ``config`` get
        #: the defaults)
        self.g_config = getattr(g_model, 'config', GeneratorConfig())
        self.d_config = getattr(d_model, 'config', DiscriminatorConfig())
        self.controller = DynamicGANTraining(cfg.controller)
        self.g_state, self.d_state = init_states(
            g_model, d_model, cfg.controller.g_lr, cfg.controller.d_lr)
        self.g_step, self.d_step, self.eval_step = (
            steps or make_train_steps(g_model, d_model, cfg))
        if loader is not None:
            train_batches, dev_batches = loader.train, loader.dev
            if mean is None and std is None:
                mean, std = get_mean_std_necksub(loader.train)
        self.train_batches, self.dev_batches = train_batches, dev_batches
        self.mean = self._put(torch.zeros(104) if mean is None else mean)
        self.std = self._put(torch.ones(104) if std is None else std)
        #: label noise; dropout draws from the device's default generator
        self.key = torch.Generator(device=self.device).manual_seed(seed)
        self.log = log
        self.loss_history: dict[str, list] = {
            'train_g': [], 'train_d': [], 'val_g': [], 'val_d': []}

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
        # same loss sequence as a synchronous loop.
        pending = None                  # previous batch's (gm, dm | None)

        def drain(p) -> None:
            nonlocal last_g, last_d
            gm_p, dm_p = p
            last_g = float(gm_p['g_loss'])
            if dm_p is not None:
                last_d = float(dm_p['d_loss'])
            ctrl.update_loss_history(last_d, last_g)

        log_every = self.cfg.log_every_batches
        for i, (audio, pose, style, mask) in enumerate(
                self._prefetch(self.train_batches)):
            for _ in range(g_freq):
                self.g_state, self.d_state, gm = self.g_step(
                    self.g_state, self.d_state, audio, pose, self.mean,
                    self.std, real_lp.smooth_real, real_lp.noise_std,
                    self.key, style=style, mask=mask)
            if pending is not None:
                drain(pending)
            dm = None
            if ctrl.should_train_discriminator():
                for _ in range(d_freq):
                    self.d_state, self.g_state, dm = self.d_step(
                        self.g_state, self.d_state, audio, pose, self.mean,
                        self.std, real_lp.smooth_real, fake_lp.smooth_fake,
                        real_lp.noise_std, self.key, style=style, mask=mask)
            # else dm stays None: the drain reuses the last d_loss
            pending = (gm, dm)
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
        return last_g, last_d

    def validate(self) -> dict[str, float]:
        """Mean of ``eval_step``'s metrics over ``dev_batches``."""
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

    def fit(self, n_epochs: int | None = None) -> dict:
        """``n_epochs`` of ``train_epoch`` + ``validate``; returns the loss
        history."""
        n_epochs = self.cfg.n_epochs if n_epochs is None else n_epochs
        for epoch in range(n_epochs):
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
        return self.loss_history
