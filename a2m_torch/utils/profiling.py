"""Device-time breakdown of the port's paths with ``torch.profiler``.

Counterpart of ``a2m/utils/profiling.py``'s device trace.  Run on the card,
from the repository root::

    python -m a2m_torch.utils.profiling [--path serve] [--batch 128]
                                        [--iters 5]

``--path serve`` builds the flagship audio->pose pipeline; ``stream``
builds the streaming server (``pipeline.build_server``) and profiles one
fused call of ``--batch`` streams (8 when left at its default) of 60 s at
45.6 kHz, uploaded from host memory, or already on the card with
``--on-card``; ``g_step``, ``d_step`` and ``eval_step`` build the flagship
trainer (``pipeline.build_trainer``) and profile that step on one seeded
batch.  It
profiles ``iters`` calls after a warm-up and prints one JSON object: the
wall time per call (host clock around a synchronised window), the summed
kernel time per call, the device's idle share of the window (from the
union of its kernels' and copies' intervals, so that work that overlaps is
counted once), the idle time per call by the innermost ``a2m.*`` span
around it, the kernel time per category (the port's kernels, convolutions,
GEMMs, everything else) and the largest kernels.

:func:`trace_annotation` names a region in a trace
(``torch.profiler.record_function``; a2m's ``profiling.py:18-53``): the
program's spans, all named ``a2m.*``, sit at the boundaries of its layers
(``a2m.serve`` and its stages in ``eval/streaming.py``, ``a2m.window`` in
``pipeline.audio_to_pose_fn``, ``a2m.serve.tower`` and ``a2m.window.tower``
around a speech tower's call where one stands in for the log-mel, flat
under their roots, ``a2m.g_step`` / ``a2m.d_step`` and their
forward, backward and optimizer in the train steps, ``a2m.train.drain``).
:func:`device_trace` writes a ``torch.profiler`` trace of the code it
wraps.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from pathlib import Path

import torch

#: kernel-name substrings -> category, first match wins
CATEGORIES = (
    ('gcn_stack_bwd', ('gcn_stack_bwd_kernel', 'gcn_stack_bwd_tc_kernel',
                       'transpose_weights_kernel', 'reduce_partials_kernel')),
    ('gcn_stack_fwd', ('gcn_stack_kernel<true>',
                       'gcn_stack_tc_kernel<true>')),
    ('gcn_stack_edge', ('gcn_stack_edge_kernel',
                        'gcn_stack_edge_tc_kernel')),
    ('gcn_stack', ('gcn_stack_kernel', 'gcn_stack_tc_kernel')),
    ('log_mel_exact', ('log_mel_exact_kernel',)),
    ('log_mel', ('log_mel_fft_kernel',)),
    ('convolution', ('conv', 'cudnn', 'implicit_gemm', 'fprop', 'dgrad',
                     'wgrad', 'winograd', 'fft')),
    ('gemm', ('gemm', 'cutlass', 'cublas')),
    ('copy', ('memcpy',)),
)


#: the innermost span's name for idle time that no ``a2m.*`` span covers
OUTSIDE_SPANS = 'outside spans'
#: the region around :func:`kernel_breakdown`'s profiled calls
WINDOW = 'profiling.window'


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region visible in a ``torch.profiler`` trace.  With no
    profiler running it reads one flag and enters nothing (a
    ``record_function`` costs ~13 us even then)."""
    if not torch.autograd.profiler._is_profiler_enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_trace(logdir):
    """Trace the wrapped code with ``torch.profiler`` (the host and, where
    there is one, the card) into a Chrome trace under ``logdir``; returns
    the trace's path through the context's value, a list filled on exit."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    written: list[Path] = []
    with profile(activities=activities) as prof:
        yield written
    Path(logdir).mkdir(parents=True, exist_ok=True)
    path = Path(logdir) / f'trace_{os.getpid()}_{time.time_ns()}.json'
    prof.export_chrome_trace(str(path))
    written.append(path)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return 'other'


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_by_span(device, spans, start: float, end: float
                 ) -> tuple[float, dict[str, float]]:
    """(busy seconds, idle seconds by span) of the window ``[start, end]``:
    ``device`` the card's (start, end) intervals, taken as a union;
    ``spans`` the host's (name, start, end) spans.  Each idle gap goes to
    the innermost span around its middle, or to :data:`OUTSIDE_SPANS`."""
    busy = union((max(a, start), min(b, end)) for a, b in device
                 if b > start and a < end)
    gaps, t = [], start
    for a, b in busy + [(end, end)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        around = [(s1 - s0, name) for name, s0, s1 in spans
                  if s0 <= mid <= s1]
        inner = min(around)[1] if around else OUTSIDE_SPANS
        idle[inner] = idle.get(inner, 0.0) + b - a
    return sum(b - a for a, b in busy), idle


def kernel_breakdown(fn, iters: int) -> dict:
    """Profile ``iters`` calls of ``fn`` (already warm) on the card."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / iters * 1e3
    device, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, a, b = e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a span also shows on the card's timeline: no device work
            annotation = getattr(e, 'is_user_annotation', lambda: False)()
            if not (annotation or name.startswith(('a2m.', WINDOW))):
                device.append((a, b))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith('a2m.'):
            spans.append((name, a, b))
    busy_s, idle = idle_by_span(device, spans, *window)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith(('a2m.', WINDOW))]
    per_call = sorted(((e.key, e.self_device_time_total / 1e3 / iters,
                        e.count / iters) for e in kernels),
                      key=lambda r: -r[1])
    cats: dict[str, float] = {}
    for name, ms, _ in per_call:
        cats[category(name)] = cats.get(category(name), 0.0) + ms
    return dict(wall_ms=wall, kernel_ms=sum(ms for _, ms, _ in per_call),
                busy_ms=busy_s * 1e3 / iters,
                idle_share=1.0 - busy_s / (window[1] - window[0]),
                idle_ms_by_span={k: v * 1e3 / iters for k, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])},
                categories_ms=cats,
                top=[dict(name=n[:96], ms=ms, launches=c)
                     for n, ms, c in per_call[:15]])


def step_fn(path: str, batch: int, on_card: bool = False):
    """The profiled callable of ``path``: one serving call, one fused
    streaming call, or one train or eval step of the flagship trainer on a
    seeded batch."""
    gen = torch.Generator().manual_seed(0)
    if path == 'stream':
        from a2m_torch.pipeline import SR, build_server
        serve = build_server()
        waves = [(torch.randn(SR * 60, generator=gen) * 0.1).numpy()
                 for _ in range(batch)]
        if on_card:
            waves = [torch.from_numpy(w).cuda() for w in waves]
        return lambda: serve(waves)
    if path == 'serve':
        from a2m_torch.pipeline import CLIP_SECONDS, SR, build_pipeline
        audio_to_pose = build_pipeline(batch=batch)
        wave = (torch.randn(batch, int(SR * CLIP_SECONDS), generator=gen)
                * 0.1).cuda()
        return lambda: audio_to_pose(wave)
    from a2m_torch.pipeline import build_trainer
    tr = build_trainer(batch=batch, log=lambda line: None)
    audio = torch.randn(batch, 64, 128, generator=gen).cuda()
    pose = (torch.randn(batch, 64, 104, generator=gen) * 10 + 300).cuda()
    mask = torch.ones(batch, device='cuda')
    real = tr.controller.label_params(0, is_real=True)
    fake = tr.controller.label_params(0, is_real=False)
    common = (tr.g_state, tr.d_state, audio, pose, tr.mean, tr.std)
    if path == 'g_step':
        return lambda: tr.g_step(*common, real.smooth_real, real.noise_std,
                                 tr.key, mask=mask)
    if path == 'd_step':
        return lambda: tr.d_step(*common, real.smooth_real, fake.smooth_fake,
                                 real.noise_std, tr.key, mask=mask)
    return lambda: tr.eval_step(*common, mask)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--path', default='serve',
                    choices=('serve', 'stream', 'g_step', 'd_step',
                             'eval_step'))
    ap.add_argument('--batch', type=int, default=None)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--on-card', action='store_true')
    args = ap.parse_args()
    if args.batch is None:
        args.batch = 8 if args.path == 'stream' else 128
    fn = step_fn(args.path, args.batch, args.on_card)
    for _ in range(3):
        fn()
    out = kernel_breakdown(fn, args.iters)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(device=smi, path=args.path, batch=args.batch,
                          on_card=args.on_card, **out), indent=1))


if __name__ == '__main__':
    main()
