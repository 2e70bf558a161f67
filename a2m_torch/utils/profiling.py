"""Device-time breakdown of the audio->pose path with ``torch.profiler``.

Counterpart of ``a2m/utils/profiling.py``'s device trace.  Run on the card,
from the repository root::

    python -m a2m_torch.utils.profiling [--batch 128] [--iters 5]

It builds the flagship pipeline, profiles ``iters`` calls after a warm-up,
and prints one JSON object: the wall time per call (host clock around a
synchronised window), the summed kernel time per call, the device's idle
share of the window, the kernel time per category (the port's two
kernels, convolutions, GEMMs, everything else) and the largest kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

#: kernel-name substrings -> category, first match wins
CATEGORIES = (
    ('gcn_stack', ('gcn_stack_kernel',)),
    ('log_mel', ('log_mel_kernel', 'log_mel_finish')),
    ('convolution', ('conv', 'cudnn', 'implicit_gemm', 'fprop', 'dgrad',
                     'winograd', 'fft')),
    ('gemm', ('gemm', 'cutlass', 'cublas')),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
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


def main() -> None:
    from a2m_torch.pipeline import CLIP_SECONDS, SR, build_pipeline
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=128)
    ap.add_argument('--iters', type=int, default=5)
    args = ap.parse_args()
    audio_to_pose = build_pipeline(batch=args.batch)
    gen = torch.Generator().manual_seed(0)
    wave = (torch.randn(args.batch, int(SR * CLIP_SECONDS), generator=gen)
            * 0.1).cuda()
    for _ in range(3):
        audio_to_pose(wave)
    out = kernel_breakdown(lambda: audio_to_pose(wave), args.iters)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(device=smi, batch=args.batch, **out), indent=1))


if __name__ == '__main__':
    main()
