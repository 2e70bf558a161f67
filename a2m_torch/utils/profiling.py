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
kernel time per call, the device's idle share of the window, the kernel
time per category (the port's kernels, convolutions, GEMMs, everything
else) and the largest kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

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


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return 'other'


def kernel_breakdown(fn, iters: int) -> dict:
    """Profile ``iters`` calls of ``fn`` (already warm) on the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    per_call = sorted(((e.key, e.self_device_time_total / 1e3 / iters,
                        e.count / iters) for e in kernels),
                      key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in per_call)
    cats: dict[str, float] = {}
    for name, ms, _ in per_call:
        cats[category(name)] = cats.get(category(name), 0.0) + ms
    return dict(wall_ms=wall, kernel_ms=busy,
                idle_share=max(0.0, 1.0 - busy / wall),
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
