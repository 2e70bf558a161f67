"""Long-audio streaming inference: arbitrary-length audio -> pose sequence.

Counterpart of ``a2m/eval/streaming.py``, with its names and arguments; the
functions take an eval-mode :class:`~a2m_torch.models.generator.Generator`
where a2m takes ``(generator, variables)``, run on the device the
generator lies on, and return what a2m returns: float32 numpy arrays of
(T, 104).

The feature stream is cut into overlapping 64-frame windows along the time
axis, the whole window batch runs through the generator as one batch, and
overlapping predictions are blended with a linear crossfade.  The serving
path is :func:`stream_from_waveforms`: equal-length streams go through
:func:`_fused_pipeline`, which keeps frontend, windowing, generator and
blend on the device between one upload and one download.

PyTorch runs eagerly, so a2m's jit cache (``_cached_apply``) has no
counterpart, and the window chunks of the chunked route are not padded to a
fixed batch size (rows of an eval-mode batch do not see each other).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from a2m_torch import constants
from a2m_torch.audio import frontend
from a2m_torch.utils.profiling import trace_annotation


def _device_of(generator: torch.nn.Module) -> torch.device:
    return next(generator.parameters()).device


def window_starts(n_frames: int, window: int, hop: int) -> np.ndarray:
    """Window start indices covering [0, n_frames) (last window clamped)."""
    if n_frames <= window:
        return np.array([0])
    starts = np.arange(0, n_frames - window + 1, hop)
    if starts[-1] + window < n_frames:
        starts = np.append(starts, n_frames - window)
    return starts


def blend(pred: np.ndarray, starts: np.ndarray, n_frames: int,
          window: int) -> np.ndarray:
    """Host-side overlap-add with triangular crossfade weights.

    pred: (W, window, F) window predictions; returns (n_frames, F).
    """
    feats = pred.shape[-1]
    out = np.zeros((n_frames, feats), np.float64)
    acc = np.zeros((n_frames, 1), np.float64)
    w = np.minimum(np.arange(1, window + 1),
                   np.arange(window, 0, -1)).astype(np.float64)[:, None]
    for s, p in zip(starts, pred):
        n = min(window, n_frames - int(s))  # clips shorter than one window
        out[s:s + n] += w[:n] * p[:n]
        acc[s:s + n] += w[:n]
    return (out / np.maximum(acc, 1e-9)).astype(np.float32)


def _window_index(n_frames: int, window: int, hop: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """((W, window) frame index of every window, clamped to the last
    frame; starts)."""
    starts = window_starts(n_frames, window, hop)
    idx = starts[:, None] + np.arange(window)[None, :]
    return np.minimum(idx, n_frames - 1), starts


def _stream_windows(features: np.ndarray, window: int, hop: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(T, F) -> ((W, window, F) window stack, starts)."""
    idx, starts = _window_index(features.shape[0], window, hop)
    return features[idx], starts


def _batched_forward(generator, windows: np.ndarray,
                     batch_size: int) -> np.ndarray:
    """Run a (W, window, F) window stack through the generator in chunks
    of at most ``batch_size`` windows.  All chunks are enqueued before any
    device->host transfer, so the host waits once, not per chunk."""
    dev = _device_of(generator)
    with torch.inference_mode():
        staged = torch.as_tensor(windows, dtype=torch.float32).to(dev)
        outs = [generator(staged[i:i + batch_size])
                for i in range(0, len(staged), batch_size)]
        return torch.cat(outs).cpu().numpy()


def stream_poses(generator, features: np.ndarray,
                 window: int = constants.FRAMES_PER_WINDOW,
                 hop: int = 32, batch_size: int = 64) -> np.ndarray:
    """features: (T, n_mels) log-mel at pose rate -> (T, 104) pose.

    Windows are batched through the generator; arbitrary duration is
    handled by chunking the window batch.
    """
    features = np.asarray(features)
    windows, starts = _stream_windows(features, window, hop)
    pred = _batched_forward(generator, windows, batch_size)
    return blend(pred, starts, features.shape[0], window)


def stream_poses_multi(generator, features_list,
                       window: int = constants.FRAMES_PER_WINDOW,
                       hop: int = 32, batch_size: int = 64
                       ) -> list[np.ndarray]:
    """S concurrent feature streams -> S pose streams, sharing one window
    batch.

    Every stream's windows are concatenated on the batch axis, so S
    concurrent streams cost roughly one batched forward over their combined
    windows instead of S sequential one-window-deep passes.  Streams may
    have different lengths; each gets its own crossfaded (T_s, 104) output.
    """
    features_list = [np.asarray(f) for f in features_list]
    stacks, starts_list = zip(*(_stream_windows(f, window, hop)
                                for f in features_list))
    pred = _batched_forward(generator, np.concatenate(stacks, axis=0),
                            batch_size)
    out, off = [], 0
    for f, stack, starts in zip(features_list, stacks, starts_list):
        out.append(blend(pred[off:off + len(stack)], starts, f.shape[0],
                         window))
        off += len(stack)
    return out


def _pose_rate_spec(sr: int, method: str = 'log_mel_512'):
    """Pose-rate (15 fps) mel spec for any frontend family.

    The stride that the training loader applies by slicing
    (``round(feature_fs / POSE_FPS)``) is folded into the hop so only kept
    frames are computed.  The 400 family (log_mel_400 / VGGish) is defined
    on 16 kHz input: callers with other rates resample on the host first.
    """
    if method == 'log_mel_512':
        fs = constants.AUDIO_FS_MAP['log_mel_512']
        spec = frontend.spec_log_mel_512(sr)
    elif method in ('log_mel_400', 'vggish'):
        spec = (frontend.spec_log_mel_400() if method == 'log_mel_400'
                else frontend.spec_vggish())
        if sr != spec.sr:
            raise ValueError(
                f'{method} streaming expects {spec.sr} Hz input; got '
                f'sr={sr}. Resample on the host to {spec.sr} Hz first.')
        fs = constants.AUDIO_FS_MAP['log_mel_400']
    else:
        raise ValueError(f'unknown streaming method {method!r} (have: '
                         f'log_mel_512, log_mel_400, vggish)')
    stride = round(fs / constants.POSE_FPS)
    return frontend.strided_spec(spec, stride)


def _as_tensor(wave) -> torch.Tensor:
    return wave if isinstance(wave, torch.Tensor) else torch.as_tensor(
        np.asarray(wave))


def _waveform_features(waveform, sr: int, method: str = 'log_mel_512',
                       device='cuda') -> np.ndarray:
    """One waveform (N,) -> (T, n_mels) pose-rate log-mel, computed on
    ``device``."""
    with torch.inference_mode():
        y = _as_tensor(waveform).to(device)
        return frontend.log_mel(y, _pose_rate_spec(sr, method),
                                exact=False).cpu().numpy()


def _waveform_features_grouped(waveforms, sr: int,
                               method: str = 'log_mel_512',
                               device='cuda') -> list:
    """Feature extraction for S streams with as few device calls as
    possible: streams of equal sample count share one batched log_mel call
    (equal-length grouping keeps the centred reflect padding exact:
    zero-padding unequal streams to a common length would perturb their
    last window)."""
    spec = _pose_rate_spec(sr, method)
    groups: dict[int, list[int]] = {}
    for i, w in enumerate(waveforms):
        groups.setdefault(int(np.shape(w)[-1]), []).append(i)
    feats: list = [None] * len(waveforms)
    with torch.inference_mode():
        outs = [(idxs, frontend.log_mel(
            torch.stack([_as_tensor(waveforms[i]) for i in idxs]).to(device),
            spec, exact=False)) for idxs in groups.values()]
        for idxs, out in outs:               # d2h after all launches
            out = out.cpu().numpy()
            for j, i in enumerate(idxs):
                feats[i] = out[j]
    return feats


# -- serving wire formats ---------------------------------------------------
#
# The host->device link can bound multi-stream serving (8 x 60 s of f32
# samples are 87.6 MB), so the wire format is a serving knob: int16 PCM
# halves the bytes (log_mel scales integer input on the device), and 8-bit
# mu-law (the G.711 companding curve, continuous form) quarters them with
# speech-grade fidelity; both decode on the device inside the fused
# pipeline.

ULAW_MU = 255.0


def encode_ulaw(x: np.ndarray) -> np.ndarray:
    """float samples in [-1, 1] -> uint8 mu-law codes (host-side, client)."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(ULAW_MU * np.abs(x)) / np.log1p(ULAW_MU)
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


def decode_ulaw(codes: torch.Tensor) -> torch.Tensor:
    """uint8 mu-law codes -> float32 samples (device-side, in-pipeline)."""
    y = codes.float() / 127.5 - 1.0
    return torch.sign(y) * (torch.expm1(torch.abs(y) * float(
        np.float32(np.log1p(ULAW_MU)))) / ULAW_MU)


def _decode_wire(waves: torch.Tensor, encoding: str) -> torch.Tensor:
    """Wire decode on the device: mu-law uint8 -> f32 here; integer PCM
    passes through (log_mel scales it); float passes through."""
    if encoding == 'ulaw':
        if waves.dtype != torch.uint8:
            raise ValueError(f'ulaw wire format is uint8, got {waves.dtype}')
        return decode_ulaw(waves)
    if encoding != 'linear':
        raise ValueError(f"unknown wire encoding {encoding!r} "
                         f"(have: 'linear', 'ulaw')")
    return waves


def _blend_matrix(starts: np.ndarray, n_frames: int,
                  window: int) -> np.ndarray:
    """The host-side :func:`blend` overlap-add as one static (T, W*window)
    matrix: ``out = M @ pred.reshape(W*window, F)``.  Triangular crossfade
    weights with the per-frame normalisation folded in, so the whole blend
    becomes a single matmul inside the fused pipeline."""
    w = np.minimum(np.arange(1, window + 1),
                   np.arange(window, 0, -1)).astype(np.float64)
    m = np.zeros((n_frames, len(starts) * window))
    for wi, s in enumerate(starts):
        n = min(window, n_frames - int(s))
        rows = np.arange(s, s + n)
        m[rows, wi * window + np.arange(n)] = w[:n]
    m /= np.maximum(m.sum(axis=1, keepdims=True), 1e-9)
    return m.astype(np.float32)


def frame_streams_for_wire(waveforms, sr: int, method: str = 'log_mel_512',
                           encoding: str = 'linear') -> list[np.ndarray]:
    """Client-side prep for the framed wire format.

    At pose rate the strided STFT hop (3072 samples) exceeds the frame
    length (2048), so a third of every waveform is never read by the
    frontend.  This helper cuts each stream into exactly the (T, frame_len)
    sample frames the device consumes
    (:func:`a2m_torch.audio.frontend.frame_for_wire`: same centred reflect
    padding and hop grid, bit-identical features), dropping the unread
    bytes before they reach the wire: 1.5x fewer host->device bytes on top
    of the sample encoding (f32/int16 pass through; ``'ulaw'``
    mu-law-encodes the frames to uint8).  Feed the result to
    :func:`stream_from_waveforms` with ``framed_n_samples=<original
    per-stream sample count>``.
    """
    spec = _pose_rate_spec(sr, method)
    out = []
    for w in waveforms:
        w = np.asarray(w)
        if encoding == 'ulaw':
            # encode-then-frame: mu-law is elementwise, so it commutes with
            # the reflect padding and the gather; 128 is the closest code
            # to a zero sample (decodes to 8.6e-5) for any zero tail
            out.append(frontend.frame_for_wire(encode_ulaw(w), spec,
                                               tail_value=128))
        elif encoding == 'linear':
            out.append(frontend.frame_for_wire(w, spec))
        else:
            raise ValueError(f'unknown wire encoding {encoding!r}')
    return out


@functools.lru_cache(maxsize=8)
def _fused_pipeline(generator, sr: int, method: str, n_samples: int,
                    window: int, hop: int, encoding: str = 'linear',
                    framed: bool = False):
    """``run(waves)``: (S, n_samples) waveforms, or (S, T, frame_len)
    framed ones, on the generator's device -> (S, T, 104) poses there.

    Frontend, static-index windowing, generator forward (batch S*W) and
    the crossfade blend (as a precomputed matmul, :func:`_blend_matrix`)
    all run on the device under ``torch.inference_mode()``, with no host
    round trip in between; the window index and the blend matrix are built
    once per (generator, length, wire format) and stay on the device.
    """
    spec = _pose_rate_spec(sr, method)
    dev = _device_of(generator)
    t = frontend.num_frames(spec, n_samples)
    idx, starts = _window_index(t, window, hop)
    blend_m = torch.from_numpy(_blend_matrix(starts, t, window)).to(dev)
    idx = torch.from_numpy(idx).to(dev)

    def run(waves: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            with trace_annotation('a2m.serve.frontend'):
                waves = _decode_wire(waves, encoding)
                if framed:   # (S, T, frame_len) pre-framed wire
                    if waves.shape[-2] != t:
                        raise ValueError(
                            f'framed wire: {waves.shape[-2]} frames per '
                            f'stream, but {n_samples} samples give {t} '
                            f'(framed_n_samples must be the original '
                            f'per-stream sample count)')
                    feats = frontend.log_mel_frames(waves, spec, exact=False)
                else:
                    feats = frontend.log_mel(waves, spec, exact=False)
            with trace_annotation('a2m.serve.gather'):
                wins = feats[:, idx]                 # (S, W, window, n_mels)
                s, w_n = wins.shape[:2]
                wins = wins.reshape(s * w_n, window, feats.shape[-1])
            with trace_annotation('a2m.serve.generator'):
                pred = generator(wins)
            with trace_annotation('a2m.serve.blend'):
                flat = pred.reshape(s, w_n * window, pred.shape[-1])
                return torch.matmul(blend_m, flat)       # (S, T, 104)

    return run


def stream_from_waveform(generator, waveform, sr: int,
                         method: str = 'log_mel_512', hop: int = 32,
                         batch_size: int = 64,
                         fused: bool = False) -> np.ndarray:
    """Raw audio of any length -> (T_pose, 104) pose via the frontend and
    the windowed generator.

    ``fused=False`` (default) chunks the windows through the generator and
    blends on the host; ``fused=True`` runs the whole pipeline on the
    device in one call (see :func:`_fused_pipeline`)."""
    if fused:
        return stream_from_waveforms(generator, [waveform], sr, method, hop,
                                     batch_size, fused=True)[0]
    feats = _waveform_features(waveform, sr, method, _device_of(generator))
    return stream_poses(generator, feats, hop=hop, batch_size=batch_size)


@functools.lru_cache(maxsize=None)
def _copy_stream(dev: torch.device):
    """The device's one side stream for uploads that overlap compute."""
    return torch.cuda.Stream(dev)


def _upload(stack, dev: torch.device, overlap: bool = False):
    """One group's streams -> (one tensor on ``dev``, event or None).  Host
    arrays are stacked straight into pinned memory, so that the copy to the
    card does not block the host.  With ``overlap`` the copy runs on the
    device's side stream and the event marks its end: the consumer's stream
    waits for it before the first use.  (The tensor itself belongs to the
    consumer's stream, so its memory is reused like any other's.)  The
    stacking, with the host buffer's allocation, is the span
    ``a2m.serve.stage``; issuing the copy, ``a2m.serve.upload``."""
    first = stack[0]
    pinned = dev.type == 'cuda'
    with trace_annotation('a2m.serve.stage'):
        if isinstance(first, torch.Tensor) and first.device.type != 'cpu':
            return torch.stack(list(stack)).to(dev), None
        if isinstance(first, torch.Tensor):
            host = torch.empty((len(stack), *first.shape), dtype=first.dtype,
                               pin_memory=pinned)
            torch.stack(list(stack), out=host)
        else:
            arrays = [np.asarray(w) for w in stack]
            host = torch.empty((len(arrays), *arrays[0].shape),
                               dtype=torch.from_numpy(arrays[0][:0]).dtype,
                               pin_memory=pinned)
            np.stack(arrays, out=host.numpy())
    with trace_annotation('a2m.serve.upload'):
        if not pinned:
            return host.to(dev), None
        if not overlap:
            return host.to(dev, non_blocking=True), None
        side = _copy_stream(dev)
        out = torch.empty(host.shape, dtype=host.dtype, device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready


@trace_annotation('a2m.serve')
def stream_from_waveforms(generator, waveforms, sr: int,
                          method: str = 'log_mel_512', hop: int = 32,
                          batch_size: int = 64,
                          fused: str | bool = 'auto',
                          encoding: str = 'linear',
                          pipeline_groups: int = 1,
                          framed_n_samples: int | None = None
                          ) -> list[np.ndarray]:
    """S raw audio streams -> S pose streams.

    ``fused='auto'`` (default): when every stream has the same sample
    count, the common serving shape, the whole batch runs through
    :func:`_fused_pipeline` (frontend + windows + forward + blend on the
    device); otherwise streams group into per-length batched frontend
    calls and share one chunked window batch (:func:`stream_poses_multi`).

    Wire format: waveforms may be f32, int16/int32 PCM (scaled on the
    device: half the host->device bytes), or uint8 mu-law with
    ``encoding='ulaw'`` (a quarter of the bytes); numpy arrays, or torch
    tensors that may already lie on the device.

    ``pipeline_groups=G`` (fused path) splits the stream batch into G equal
    groups and overlaps group i+1's host->device upload with group i's
    compute: every upload is issued up front (asynchronous, from pinned
    memory), the compute follows, and results drain in order.

    ``framed_n_samples=N``: the streams are pre-framed (T, frame_len) wire
    arrays from :func:`frame_streams_for_wire` for original N-sample
    streams: 1.5x fewer host->device bytes, same features.  A stack whose T
    is not the frame count of N samples raises ``ValueError``.

    The call is the span ``a2m.serve``.  On the fused path its stages are
    spans below it, one level deep: ``a2m.serve.stage`` and
    ``a2m.serve.upload`` per group, then per group ``.frontend``,
    ``.gather``, ``.generator`` and ``.blend``, and ``.download`` (where
    the host waits for the card).  The chunked route has the root only."""
    window = constants.FRAMES_PER_WINDOW
    dev = _device_of(generator)
    if framed_n_samples is not None:
        spec = _pose_rate_spec(sr, method)
        frame_len = frontend.dft_matrices(spec)['frame_len']
        n_frames = frontend.num_frames(spec, framed_n_samples)
        shapes = {tuple(np.shape(w)[-2:]) for w in waveforms}
        if len(shapes) != 1 or next(iter(shapes))[-1] != frame_len:
            raise ValueError(
                f'framed wire expects equal (T, {frame_len}) frame stacks '
                f'(frame_streams_for_wire); got shapes {sorted(shapes)}')
        if next(iter(shapes))[0] != n_frames:
            raise ValueError(
                f'framed wire: stacks of {next(iter(shapes))[0]} frames, '
                f'but framed_n_samples={framed_n_samples} gives {n_frames}')
        run = _fused_pipeline(generator, sr, method, framed_n_samples,
                              window, hop, encoding, framed=True)
        lens = {framed_n_samples}
        fused = True
    else:
        lens = {int(np.shape(w)[-1]) for w in waveforms}
    if fused is True or (fused == 'auto' and len(lens) == 1):
        if len(lens) != 1:
            raise ValueError('fused=True needs equal-length streams; got '
                             f'lengths {sorted(lens)}')
        if framed_n_samples is None:
            run = _fused_pipeline(generator, sr, method, lens.pop(), window,
                                  hop, encoding)
        s = len(waveforms)
        g = max(1, min(pipeline_groups, s))
        if s % g:
            raise ValueError(f'pipeline_groups={g} must divide the '
                             f'{s}-stream batch')
        per = s // g
        # all uploads issued before any compute, on a stream of their own
        # when there are several: the copy engine moves group k+1's bytes
        # while group k computes
        staged = [_upload(waveforms[i * per:(i + 1) * per], dev, g > 1)
                  for i in range(g)]
        outs = []
        for st, ready in staged:
            if ready is not None:
                torch.cuda.current_stream(dev).wait_event(ready)
            outs.append(run(st))
        with trace_annotation('a2m.serve.download'):
            return [p for o in outs for p in o.cpu().numpy()]
    if encoding != 'linear':
        raise ValueError('non-linear wire encodings are decoded in the '
                         'fused pipeline; equal-length streams required')
    feats = _waveform_features_grouped(waveforms, sr, method, dev)
    return stream_poses_multi(generator, feats, hop=hop,
                              batch_size=batch_size)
