#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``a2m_torch``) on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` (PATH, ``$CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``, and imports neither JAX nor the ``a2m`` package.  Phases,
each fatal on failure:

1. the card's name and power limit;
2. build every kernel of the port from ``a2m_torch/csrc/`` (one ``nvcc``
   per source, in parallel);
3. ``gcn_stack`` (K1) against its plain PyTorch version on the card at the
   main-path shapes (N = 8192 graphs, J in {10, 42}, F = 64, H = 4) and at
   a ragged N, f32 operands (2e-5) and bf16 operands (1% of max|ref|, and a
   mean error under 1% of the plain version's mean bf16-vs-f32 gap), timed
   with CUDA events beside its bound;
4. ``log_mel`` (K2) against its plain version at B = 128 on the pose-rate
   strided spec (1e-4), timed beside ``torch.stft`` and the function's
   bound, which counts an FFT (the kernel runs the direct DFT);
5. the main path: ``build_pipeline()`` with the committed flagship weights
   at B = 128, driven once with the launch counts set to 0 (1 log-mel and
   2 GCN-stack launches expected), then its realtime factor and p50
   single-clip latency; the port is then held against a2m's JAX output in
   ``a2m_torch/testdata/flagship_golden.npz``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a card it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
PEAK_BF16 = 989e12                # dense tensor-core bf16 FLOP/s
PEAK_FP32 = 67e12                 # fp32 outside the tensor cores
# bf16-operand K1: mean |kernel - plain bf16| as a share of the mean
# bf16-vs-f32 gap of the plain version
BF16_MEAN_SHARE = 0.01


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f'chip_smoke: {what}')


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``iters``
    launches after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least time in ms and what sets it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def device_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f'nvidia-smi failed: {out.stderr}')
    return out.stdout.strip()


def random_stack_params(f: int, heads: int, gen):
    """Seeded stack parameters at the scale of trained ones."""
    import torch
    from a2m_torch.nn import gcn_kernel

    def t(*shape, scale=1.0, offset=0.0):
        return torch.randn(*shape, generator=gen) * scale + offset

    layers = []
    for i in range(5):
        norm = (t(f, scale=0.1, offset=1.0), t(f, scale=0.1))
        if i % 2 == 0:
            layers.append((t(f, heads * f, scale=f ** -0.5),
                           t(heads, f, scale=f ** -0.5),
                           t(heads, f, scale=f ** -0.5), t(f, scale=0.1))
                          + norm)
        else:
            layers.append((t(f, f, scale=f ** -0.5), t(f, f, scale=f ** -0.5),
                           t(f, scale=0.1)) + norm)
    return gcn_kernel.pack_params(layers)


def gcn_phase() -> dict:
    import torch
    from a2m_torch import constants
    from a2m_torch.nn import gcn_kernel

    f, heads, n_main = 64, 4, 128 * 64
    gen = torch.Generator().manual_seed(0)
    adj = {10: constants.adjacency_from_edges(constants.body_edges(), 10),
           42: constants.adjacency_from_edges(constants.hand_edges(), 42)}
    entry = dict(ms=0.0, plain_ms=0.0, flops=0, bytes=0, max_abs_err=0.0)
    for j in (10, 42):
        params = random_stack_params(f, heads, gen).cuda()
        a = torch.as_tensor(adj[j]).cuda()
        for n in (n_main, 1001):
            x = torch.randn(n, j, f, generator=gen).cuda()
            ref32 = gcn_kernel.gcn_stack_plain(x, params, a, heads,
                                               precise=True)
            for precise in (True, False):
                got = gcn_kernel.gcn_stack(x, params, a, heads,
                                           precise=precise)
                ref = gcn_kernel.gcn_stack_plain(x, params, a, heads,
                                                 precise=precise)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                tol = 2e-5 if precise else 0.01 * scale
                print(f'gcn_stack J={j} N={n} precise={precise}: '
                      f'max_abs_err={err:.3e} (max|ref| {scale:.3f}, '
                      f'tol {tol:.3e})', flush=True)
                require(bool(torch.isfinite(got).all()), 'gcn_stack: '
                        'non-finite output')
                require(err <= tol, f'gcn_stack J={j} N={n} precise='
                        f'{precise}: {err} > {tol}')
                if precise:
                    continue
                # The max tolerance alone is of the order of the whole
                # bf16-vs-f32 gap: hold the kernel's mean error far below
                # the mean gap, so bf16 rounding in the wrong place fails.
                mean_err = (got - ref).abs().mean().item()
                gap = (ref - ref32).abs().mean().item()
                print(f'gcn_stack J={j} N={n} bf16: mean|kernel - plain '
                      f'bf16| {mean_err:.3e}, mean|plain bf16 - plain f32| '
                      f'{gap:.3e} (tol {BF16_MEAN_SHARE} of it)', flush=True)
                require(mean_err <= BF16_MEAN_SHARE * gap,
                        f'gcn_stack J={j} N={n} bf16: mean error {mean_err} '
                        f'not below {BF16_MEAN_SHARE} x the gap {gap}')
                if n == n_main:
                    entry['max_abs_err'] = max(entry['max_abs_err'], err)
        # the main path's mode: bf16 operands, N = B * T graphs
        x = torch.randn(n_main, j, f, generator=gen).cuda()
        ms = cuda_ms(lambda: gcn_kernel.gcn_stack(x, params, a, heads))
        plain = cuda_ms(lambda: gcn_kernel.gcn_stack_plain(x, params, a,
                                                           heads))
        ms_f32 = cuda_ms(lambda: gcn_kernel.gcn_stack(x, params, a, heads,
                                                      precise=True))
        flops = gcn_kernel.stack_flops(n_main, adj[j], f, heads)
        nbytes = gcn_kernel.stack_bytes(n_main, j, f, heads)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
        print(f'gcn_stack J={j} N={n_main}: kernel_ms={ms:.4f} '
              f'(f32 operands {ms_f32:.4f}) plain_ms={plain:.4f} '
              f'bound_ms={b_ms:.4f} ({b_by}; {flops / 1e9:.2f} GFLOP, '
              f'{nbytes / 1e6:.1f} MB)', flush=True)
        entry['ms'] += ms
        entry['plain_ms'] += plain
        entry['flops'] += flops
        entry['bytes'] += nbytes
    entry['bound_ms'], entry['bound_by'] = bound(entry.pop('flops'),
                                                 entry.pop('bytes'),
                                                 PEAK_BF16)
    return entry


def log_mel_phase() -> dict:
    import torch
    from a2m_torch.audio import frontend, mel_kernel
    from a2m_torch.pipeline import CLIP_SECONDS, SR, pose_rate_spec

    spec = pose_rate_spec()
    batch, n_frames = 128, 64
    gen = torch.Generator().manual_seed(1)
    y = (torch.randn(batch, int(SR * CLIP_SECONDS), generator=gen)
         * 0.1).cuda()
    m = frontend.dft_matrices(spec)
    dr, di, mel = (torch.from_numpy(m[k]).cuda() for k in ('dr', 'di',
                                                          'mel'))
    pad = spec.n_fft // 2
    args = (dr, di, mel, spec.hop_length, pad, n_frames, spec.log_const)
    got = mel_kernel.log_mel(y, *args)
    ref = mel_kernel.log_mel_plain(y, *args)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    print(f'log_mel B={batch} T={n_frames}: max_abs_err={err:.3e} '
          f'(tol 1e-4)', flush=True)
    require(bool(torch.isfinite(got).all()), 'log_mel: non-finite output')
    require(err <= 1e-4, f'log_mel: {err} > 1e-4')

    window = torch.hann_window(spec.n_fft, periodic=True, device='cuda')

    def library():
        s = torch.stft(y, spec.n_fft, hop_length=spec.hop_length,
                       window=window, center=True, pad_mode='reflect',
                       return_complex=True)
        p = (s.real ** 2 + s.imag ** 2).transpose(1, 2)
        return torch.log(torch.clamp_min(p @ mel, spec.log_const))

    lib_err = (library() - ref).abs().max().item()
    ms = cuda_ms(lambda: mel_kernel.log_mel(y, *args))
    plain = cuda_ms(lambda: mel_kernel.log_mel_plain(y, *args))
    lib_ms = cuda_ms(library)
    # the function's bound counts an FFT; the kernel's direct DFT is a note
    flops = mel_kernel.log_mel_flops(batch, n_frames, spec.n_fft, m['K'])
    dft = mel_kernel.direct_dft_flops(batch, n_frames, m['frame_len'],
                                      m['K'])
    nbytes = mel_kernel.log_mel_bytes(batch, y.shape[1], n_frames,
                                      m['frame_len'], spec.hop_length,
                                      m['K'])
    b_ms, b_by = bound(flops, nbytes, PEAK_FP32)
    groups = mel_kernel.bin_groups(batch, n_frames, m['K'], y.device)
    print(f'log_mel: kernel_ms={ms:.4f} plain_ms={plain:.4f} '
          f'library_ms={lib_ms:.4f} (torch.stft route, max_abs_err vs plain '
          f'{lib_err:.3e}) bound_ms={b_ms:.4f} ({b_by}; '
          f'{flops / 1e9:.3f} GFLOP by FFT, {nbytes / 1e6:.1f} MB); the '
          f'direct DFT the kernel runs is {dft / 1e9:.2f} GFLOP, '
          f'{dft / PEAK_FP32 * 1e3:.4f} ms at the fp32 rate; bin groups '
          f'{groups}, so one launch is {1 + (groups > 1)} device kernel(s)',
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def slice_phase() -> dict:
    import numpy as np
    import torch
    from a2m_torch.audio import frontend, mel_kernel
    from a2m_torch.config import GeneratorConfig
    from a2m_torch.nn import gcn_kernel
    from a2m_torch.pipeline import (CLIP_SECONDS, SR, audio_to_pose_fn,
                                    build_pipeline, load_generator,
                                    pose_rate_spec)

    batch = 128
    t0 = time.perf_counter()
    audio_to_pose = build_pipeline(batch=batch)
    print(f'slice: build_pipeline {time.perf_counter() - t0:.2f} s',
          flush=True)
    gen = torch.Generator().manual_seed(2)
    wave = (torch.randn(batch, int(SR * CLIP_SECONDS), generator=gen)
            * 0.1).cuda()

    gcn_kernel.gcn_stack.launches = 0
    mel_kernel.log_mel.launches = 0
    pose = audio_to_pose(wave)
    torch.cuda.synchronize()
    launches = {'gcn_stack': gcn_kernel.gcn_stack.launches,
                'log_mel': mel_kernel.log_mel.launches}
    print(f'slice: launches in one call {launches}', flush=True)
    require(launches == {'gcn_stack': 2, 'log_mel': 1},
            f'main path launches {launches}, expected gcn_stack 2, log_mel 1')
    require(tuple(pose.shape) == (batch, 64, 104), f'pose {pose.shape}')
    require(bool(torch.isfinite(pose).all()), 'pose: non-finite values')

    iters = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        audio_to_pose(wave)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    rt = batch * CLIP_SECONDS / dt
    lats = []
    for i in range(21):
        t0 = time.perf_counter()
        audio_to_pose(wave[i:i + 1])
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
    p50 = float(np.median(lats[1:]) * 1e3)
    print(f'slice: B={batch} {dt * 1e3:.3f} ms/call, realtime factor '
          f'{rt:.1f}x, p50 single-clip latency {p50:.3f} ms', flush=True)

    with np.load(ROOT / 'a2m_torch' / 'testdata' / 'flagship_golden.npz') \
            as z:
        golden = {k: z[k] for k in z.files}
    rng = np.random.default_rng(int(golden['seed']))
    wave2 = torch.as_tensor((rng.standard_normal((2, int(SR * CLIP_SECONDS)))
                             * 0.1).astype(np.float32)).cuda()
    mel = frontend.log_mel(wave2, pose_rate_spec(), n_frames=64)
    mel_err = float(np.abs(mel.cpu().numpy() - golden['log_mel']).max())
    scale = float(np.abs(golden['pose']).max())
    precise = load_generator(config=GeneratorConfig(
        fused_gcn=True, fused_precise=True), device='cuda')
    errs = {}
    for name, fn in (('precise', audio_to_pose_fn(precise, 'cuda')),
                     ('bf16', audio_to_pose)):
        got = fn(wave2).cpu().numpy()
        errs[name] = float(np.abs(got - golden['pose']).max()) / scale
    print(f'slice vs JAX golden: log_mel max_abs_err={mel_err:.3e} (tol '
          f'1e-4); pose max_err/max|pose| precise={errs["precise"]:.3e} '
          f'(tol 1e-4) bf16={errs["bf16"]:.3e} (tol 1e-2)', flush=True)
    require(mel_err <= 1e-4, f'golden log_mel {mel_err}')
    require(errs['precise'] <= 1e-4, f'golden pose (precise) {errs}')
    require(errs['bf16'] <= 1e-2, f'golden pose (bf16) {errs}')
    return dict(launches=launches, realtime_factor=rt, p50_ms=p50,
                ms_per_call=dt * 1e3, batch=batch, golden_log_mel_err=mel_err,
                golden_pose_rel_err=errs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    if not (ROOT / 'a2m_torch' / 'csrc').is_dir():
        print(f'chip_smoke: no a2m_torch package beside {__file__}',
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from a2m_torch import _build

    smi = device_line()
    print(smi, flush=True)
    secs, logs = _build.build_all()
    print(f'build: {secs:.1f} s', flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')

    gcn = gcn_phase()
    mel = log_mel_phase()
    sl = slice_phase()
    print(json.dumps({'slice': sl, 'device': smi}))
    kernels = [
        dict(name='gcn_stack', route='cuda',
             source='a2m_torch/csrc/gcn_stack.cu',
             replaces='a2m/nn/pallas_gcn.py:228',
             launches=sl['launches']['gcn_stack'],
             max_abs_err=gcn['max_abs_err'], ms=gcn['ms'],
             plain_ms=gcn['plain_ms'], bound_ms=gcn['bound_ms'],
             bound_by=gcn['bound_by'], library_ms=None),
        dict(name='log_mel', route='cuda',
             source='a2m_torch/csrc/log_mel.cu',
             replaces='a2m/audio/pallas_mel.py:68',
             launches=sl['launches']['log_mel'], **mel),
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
