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
4. ``gcn_stack_fwd`` (K3, the forward with stash) and ``gcn_stack_bwd`` (K4,
   the backward) at the same shapes and modes: K3's ``y`` equals K1's, ``y``
   and ``xs`` match the plain version; K4's ``dx`` (2e-4 of max|ref| in f32)
   and every parameter gradient (5e-4 of max(max|ref|, 1e-3)) match the
   plain version on graphs away from LeakyReLU's kink, 1% and the mean rule
   with bf16 operands; two K4 runs on the same input are bit-equal; both
   timed beside their bounds;
5. ``log_mel`` (K2) against its plain version at B = 128 on the pose-rate
   strided spec (1e-4), timed beside ``torch.stft`` and the function's
   bound, which counts an FFT (the kernel runs the direct DFT);
6. the serving path: ``build_pipeline()`` with the committed flagship
   weights at B = 128, driven once with the launch counts set to 0 (1
   log-mel and 2 GCN-stack launches expected), then its realtime factor and
   p50 single-clip latency; the port is then held against a2m's JAX output
   in ``a2m_torch/testdata/flagship_golden.npz``;
7. the training path: ``build_trainer()`` (flagship generator with fused
   stacks, default discriminator) at B = 128 on seeded batches: one
   ``g_step`` (2 K3 and 2 K4 launches expected), one ``d_step`` and one
   ``eval_step`` (2 K1 launches each) with the counts set to 0 before each,
   what each step may and may not move, ``Trainer.train_epoch(0)`` over 4
   batches and ``validate()`` with finite metrics, one ``g_step``'s
   gradients with f32 kernel operands against the same step on the eager
   stacks, and the ms per step, fused beside unfused ``g_step``;
8. ``gcn_stack_edge`` (K5, the forward in edge form) against its plain
   version at the serving shapes (N = 13,824 graphs) and at a ragged N, J in
   {10, 42}: f32 operands within 2e-5 of the plain version and of K1, bf16
   operands within 1% of max|ref| and the mean rule of phase 3, two runs
   bit-equal, timed beside its bound and beside K1 at the same N; and the
   log-mel modes that serving adds to K2 against its plain version (1e-4):
   ``log_mel_512`` at B = 8, T = 891 and B = 1, ``log_mel_400`` and VGGish
   on 16 kHz (magnitude, 64 mels, uncentred frames of 512 and 400, htk
   mels, offset log), and the framed entry bit-equal to the waveform entry;
9. the streaming server: ``build_server()`` (flagship generator, both GCN
   stacks on K5) on 8 seeded streams of 60 s at 45.6 kHz, driven once with
   the launch counts set to 0 (1 log-mel and 2 edge-form launches, no K1
   launch expected); the int16, mu-law, framed and framed mu-law wires and
   ``pipeline_groups=2``; the chunked route, the dense kernel (K1) and f32
   operands against the fused call; a2m's JAX output in
   ``a2m_torch/testdata/streaming_golden.npz``; wall per call and realtime
   factor for 8 streams and for one, with the upload and with the input
   already on the card.

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
# K4 against its plain version: graphs whose LayerNorm outputs all keep this
# far from 0 (the kernels' y agree within ~3e-6)
KINK_MARGIN = 2e-5
# ... and with bf16 operands, the share of graphs whose dx may exceed the 1%
# bound because a rounding tie carried one element across the kink
BF16_KINK_SHARE = 2e-3
# fused vs eager g_step gradients: the least max|grad| a tensor is held to,
# as a share of the largest max|grad| of any tensor
GRAD_FLOOR = 1e-4
GRAD_STACK_TOL = 1e-1
GRAD_TENSOR_TOL = 1e-1
GRAD_L2_TOL = 1e-2
# the serving configuration: concurrent streams, their length, and the
# windows each gives at 15 pose frames per second (hop 32, window 64)
SERVE_STREAMS, SERVE_SECONDS, SERVE_WINDOWS = 8, 60, 27


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


def rel_err(got, ref) -> tuple[float, float]:
    """max |got - ref| and max |ref|."""
    return (got - ref).abs().max().item(), ref.abs().max().item()


def split_params(flat, f: int, heads: int):
    """The flat parameter (or gradient) buffer as named tensors."""
    from a2m_torch.nn import gcn_kernel
    names_gat = ('W', 'att_src', 'att_dst', 'bias', 'ln_scale', 'ln_bias')
    names_conv = ('W_rel', 'W_root', 'bias', 'ln_scale', 'ln_bias')
    out = {}
    for i, layer in enumerate(gcn_kernel._unpack(flat, f, heads, 5)):
        for name, t in zip(names_gat if i % 2 == 0 else names_conv, layer):
            out[f'layer{i + 1}.{name}'] = t
    return out


def away_from_kink(x, params, adjacency, heads: int):
    """``x`` with every graph that brings a LayerNorm output within
    KINK_MARGIN of LeakyReLU's kink replaced by one that does not (see
    ``gcn_kernel.kink_margin``): there the backward kernel and its plain
    version, whose recomputed y differ in the last bits, may rightly take
    different slopes, and no tolerance holds."""
    import torch
    from a2m_torch.nn import gcn_kernel as gk
    ok = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for precise in (True, False):
        ok &= gk.kink_margin(x, params, adjacency, heads,
                             precise=precise) > KINK_MARGIN
    good = ok.nonzero()[:, 0]
    require(len(good) > 0, 'no graph away from the kink')
    bad = (~ok).nonzero()[:, 0]
    x = x.clone()
    x[bad] = x[good[torch.arange(len(bad), device=x.device) % len(good)]]
    print(f'  {len(bad)} of {x.shape[0]} graphs within {KINK_MARGIN} of the '
          f'LeakyReLU kink replaced', flush=True)
    return x


def gcn_train_phase() -> tuple[dict, dict]:
    """K3 (forward with stash) and K4 (backward) against their plain
    versions; returns their entries of the kernels line."""
    import torch
    from a2m_torch import constants
    from a2m_torch.nn import gcn_kernel as gk

    f, heads, n_main = 64, 4, 128 * 64
    gen = torch.Generator().manual_seed(3)
    adj = {10: constants.adjacency_from_edges(constants.body_edges(), 10),
           42: constants.adjacency_from_edges(constants.hand_edges(), 42)}
    fwd = dict(ms=0.0, plain_ms=0.0, flops=0, bytes=0, max_abs_err=0.0)
    bwd = dict(ms=0.0, plain_ms=0.0, flops=0, bytes=0, max_abs_err=0.0)
    for j in (10, 42):
        params = random_stack_params(f, heads, gen).cuda()
        a = torch.as_tensor(adj[j]).cuda()
        for n in (n_main, 1001):
            x = away_from_kink(torch.randn(n, j, f, generator=gen).cuda(),
                               params, a, heads)
            g = torch.randn(n, j, f, generator=gen).cuda()
            ref32 = {}
            for precise in (True, False):
                tag = f'J={j} N={n} precise={precise}'
                # ---- K3: y equals K1's, y and xs match the plain version
                y, xs = gk.gcn_stack_fwd(x, params, a, heads, precise=precise)
                y1 = gk.gcn_stack(x, params, a, heads, precise=precise)
                y_ref, xs_ref = gk.gcn_stack_fwd_plain(x, params, a, heads,
                                                       precise=precise)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(y).all()
                             and torch.isfinite(xs).all()),
                        f'gcn_stack_fwd {tag}: non-finite output')
                same = (y - y1).abs().max().item()
                require(same <= 1e-6, f'gcn_stack_fwd {tag}: y differs from '
                        f'gcn_stack by {same}')
                err_y, scale_y = rel_err(y, y_ref)
                err_xs, scale_xs = rel_err(xs, xs_ref)
                tol_y = 2e-5 if precise else 0.01 * scale_y
                tol_xs = 2e-5 if precise else 0.01 * scale_xs
                print(f'gcn_stack_fwd {tag}: |y - K1| {same:.1e}; '
                      f'max_abs_err y {err_y:.3e} (tol {tol_y:.3e}), xs '
                      f'{err_xs:.3e} (tol {tol_xs:.3e})', flush=True)
                require(err_y <= tol_y and err_xs <= tol_xs,
                        f'gcn_stack_fwd {tag}: y {err_y} xs {err_xs}')
                # ---- K4 on the plain version's stash, so that only the
                # backward's own arithmetic is compared
                dx, dp = gk.gcn_stack_bwd(x, xs_ref, g, params, a, heads,
                                          precise=precise)
                dx2, dp2 = gk.gcn_stack_bwd(x, xs_ref, g, params, a, heads,
                                            precise=precise)
                dx_ref, dp_ref = gk.gcn_stack_bwd_plain(
                    x, xs_ref, g, params, a, heads, precise=precise)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(dx).all()
                             and torch.isfinite(dp).all()),
                        f'gcn_stack_bwd {tag}: non-finite output')
                require(bool(torch.equal(dx, dx2) and torch.equal(dp, dp2)),
                        f'gcn_stack_bwd {tag}: two runs on the same input '
                        f'differ')
                err_dx, scale_dx = rel_err(dx, dx_ref)
                tol_dx = (2e-4 if precise else 0.01) * scale_dx
                worst, worst_name = 0.0, ''
                got_p, ref_p = split_params(dp, f, heads), split_params(
                    dp_ref, f, heads)
                for name in got_p:
                    err, scale = rel_err(got_p[name], ref_p[name])
                    tol = (5e-4 * max(scale, 1e-3) if precise
                           else 0.01 * scale)
                    if err / tol > worst:
                        worst, worst_name = err / tol, name
                    require(err <= tol, f'gcn_stack_bwd {tag}: d{name} '
                            f'{err} > {tol} (max|ref| {scale})')
                print(f'gcn_stack_bwd {tag}: bit-equal over two runs; dx '
                      f'max_abs_err {err_dx:.3e} (max|ref| {scale_dx:.3f}, '
                      f'tol {tol_dx:.3e}); parameter gradients: worst '
                      f'{worst_name} at {worst:.3f} of its tolerance',
                      flush=True)
                if precise:
                    require(err_dx <= tol_dx, f'gcn_stack_bwd {tag}: dx '
                            f'{err_dx} > {tol_dx}')
                else:
                    # With bf16 operands a sum that lands near a rounding
                    # tie moves y by up to ~1e-2, far more than any margin
                    # can keep from the kink, so a few graphs rightly take
                    # the other LeakyReLU slope on one element; the bound
                    # holds for all graphs but a share of BF16_KINK_SHARE.
                    over = ((dx - dx_ref).abs().amax((1, 2)) > tol_dx).sum()
                    print(f'  dx bf16: {int(over)} of {n} graphs above the '
                          f'tolerance (allowed {BF16_KINK_SHARE} of them)',
                          flush=True)
                    require(int(over) <= BF16_KINK_SHARE * n,
                            f'gcn_stack_bwd {tag}: dx above {tol_dx} on '
                            f'{int(over)} graphs')
                if precise:
                    ref32 = dict(y=y_ref, dx=dx_ref, dp=dp_ref)
                    continue
                # bf16: the mean error far below the plain version's mean
                # bf16-vs-f32 gap, as gcn_stack is held
                for what, got, ref, r32 in (('y', y, y_ref, ref32['y']),
                                            ('dx', dx, dx_ref, ref32['dx']),
                                            ('dparams', dp, dp_ref,
                                             ref32['dp'])):
                    mean_err = (got - ref).abs().mean().item()
                    gap = (ref - r32).abs().mean().item()
                    print(f'  {what} bf16: mean|kernel - plain bf16| '
                          f'{mean_err:.3e}, mean|plain bf16 - plain f32| '
                          f'{gap:.3e} (tol {BF16_MEAN_SHARE} of it)',
                          flush=True)
                    require(mean_err <= BF16_MEAN_SHARE * gap,
                            f'{what} {tag}: mean error {mean_err} not below '
                            f'{BF16_MEAN_SHARE} x the gap {gap}')
                if n == n_main:
                    fwd['max_abs_err'] = max(fwd['max_abs_err'], err_y,
                                             err_xs)
                    bwd['max_abs_err'] = max(
                        bwd['max_abs_err'], err_dx,
                        (dp - dp_ref).abs().max().item())
        # the main path's mode: bf16 operands, N = B * T graphs
        x = torch.randn(n_main, j, f, generator=gen).cuda()
        g = torch.randn(n_main, j, f, generator=gen).cuda()
        _, xs = gk.gcn_stack_fwd(x, params, a, heads)
        times = dict(
            k3=cuda_ms(lambda: gk.gcn_stack_fwd(x, params, a, heads), 5),
            k3_plain=cuda_ms(lambda: gk.gcn_stack_fwd_plain(x, params, a,
                                                            heads), 3, 1),
            k3_f32=cuda_ms(lambda: gk.gcn_stack_fwd(x, params, a, heads,
                                                    precise=True), 5),
            k4=cuda_ms(lambda: gk.gcn_stack_bwd(x, xs, g, params, a, heads),
                       5),
            k4_plain=cuda_ms(lambda: gk.gcn_stack_bwd_plain(
                x, xs, g, params, a, heads), 3, 1),
            k4_f32=cuda_ms(lambda: gk.gcn_stack_bwd(x, xs, g, params, a,
                                                    heads, precise=True), 5))
        cost = dict(k3=(gk.stack_flops(n_main, adj[j], f, heads),
                        gk.stack_fwd_bytes(n_main, j, f, heads)),
                    k4=(gk.stack_bwd_flops(n_main, adj[j], f, heads),
                        gk.stack_bwd_bytes(n_main, j, f, heads)))
        for k, name, entry in (('k3', 'gcn_stack_fwd', fwd),
                               ('k4', 'gcn_stack_bwd', bwd)):
            flops, nbytes = cost[k]
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
            print(f'{name} J={j} N={n_main}: kernel_ms={times[k]:.4f} (f32 '
                  f'operands {times[k + "_f32"]:.4f}) plain_ms='
                  f'{times[k + "_plain"]:.4f} bound_ms={b_ms:.4f} ({b_by}; '
                  f'{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)',
                  flush=True)
            entry['ms'] += times[k]
            entry['plain_ms'] += times[k + '_plain']
            entry['flops'] += flops
            entry['bytes'] += nbytes
    for entry in (fwd, bwd):
        entry['bound_ms'], entry['bound_by'] = bound(
            entry.pop('flops'), entry.pop('bytes'), PEAK_BF16)
    return fwd, bwd


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


def stack_launches() -> dict:
    from a2m_torch.nn import gcn_kernel as gk
    return {'gcn_stack': gk.gcn_stack.launches,
            'gcn_stack_fwd': gk.gcn_stack_fwd.launches,
            'gcn_stack_bwd': gk.gcn_stack_bwd.launches,
            'gcn_stack_edge': gk.gcn_stack_edge.launches}


def reset_stack_launches() -> None:
    from a2m_torch.nn import gcn_kernel as gk
    gk.gcn_stack.launches = 0
    gk.gcn_stack_fwd.launches = 0
    gk.gcn_stack_bwd.launches = 0
    gk.gcn_stack_edge.launches = 0


def host_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean host-clock time of ``fn()`` in ms over ``iters`` synchronised
    calls after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def train_phase() -> dict:
    """The training path: ``build_trainer()`` at B = 128 and full width,
    single steps with their launch counts and invariants, one epoch over 4
    batches plus a validation, the fused step's gradients against the eager
    stacks', and the step times."""
    import torch
    from a2m_torch.config import (DiscriminatorConfig, GeneratorConfig,
                                  TrainConfig)
    from a2m_torch.models.discriminator import Discriminator
    from a2m_torch.pipeline import build_trainer, load_generator
    from a2m_torch.train.train_step import init_states, make_train_steps

    batch = 128
    t0 = time.perf_counter()
    trainer = build_trainer(batch=batch, log=lambda line: print(
        f'train: {line}', flush=True))
    print(f'train: build_trainer {time.perf_counter() - t0:.2f} s',
          flush=True)
    gen = torch.Generator(device='cuda').manual_seed(4)

    def make_batch():
        return (torch.randn(batch, 64, 128, generator=gen, device='cuda'),
                torch.randn(batch, 64, 104, generator=gen, device='cuda')
                * 10 + 300, None, torch.ones(batch, device='cuda'))

    batches = [make_batch() for _ in range(4)]
    audio, pose, style, mask = batches[0]
    g_state, d_state = trainer.g_state, trainer.d_state
    lp_r = trainer.controller.label_params(0, is_real=True)
    lp_f = trainer.controller.label_params(0, is_real=False)

    def snapshot(model):
        return ({k: v.clone() for k, v in model.named_parameters()},
                {k: v.clone() for k, v in model.named_buffers()})

    def same(before: dict, model_items) -> bool:
        return all(torch.equal(before[k], v) for k, v in model_items)

    def g_step():
        return trainer.g_step(g_state, d_state, audio, pose, trainer.mean,
                              trainer.std, lp_r.smooth_real, lp_r.noise_std,
                              trainer.key, style=style, mask=mask)[2]

    def d_step():
        return trainer.d_step(g_state, d_state, audio, pose, trainer.mean,
                              trainer.std, lp_r.smooth_real,
                              lp_f.smooth_fake, lp_r.noise_std, trainer.key,
                              style=style, mask=mask)[2]

    def eval_step():
        return trainer.eval_step(g_state, d_state, audio, pose, trainer.mean,
                                 trainer.std, mask, style=style)

    # ---- single steps: launches and what each step may move ------------
    launches = {}
    g_before, d_before = snapshot(g_state.model), snapshot(d_state.model)
    for name, step, expected in (
            ('g_step', g_step, {'gcn_stack': 0, 'gcn_stack_fwd': 2,
                                'gcn_stack_bwd': 2, 'gcn_stack_edge': 0}),
            ('d_step', d_step, {'gcn_stack': 2, 'gcn_stack_fwd': 0,
                                'gcn_stack_bwd': 0, 'gcn_stack_edge': 0}),
            ('eval_step', eval_step, {'gcn_stack': 2, 'gcn_stack_fwd': 0,
                                      'gcn_stack_bwd': 0,
                                      'gcn_stack_edge': 0})):
        reset_stack_launches()
        metrics = step()
        torch.cuda.synchronize()
        launches[name] = stack_launches()
        values = {k: float(v) for k, v in metrics.items()}
        print(f'train: {name} launches {launches[name]} metrics '
              + ' '.join(f'{k}={v:.4f}' for k, v in values.items()),
              flush=True)
        require(launches[name] == expected,
                f'{name} launches {launches[name]}, expected {expected}')
        require(all(v == v and abs(v) != float('inf')
                    for v in values.values()), f'{name}: non-finite metric')
        if name == 'g_step':
            require(not same(g_before[0], g_state.model.named_parameters()),
                    'g_step did not move the generator')
            require(same(d_before[0], d_state.model.named_parameters()),
                    'g_step moved the discriminator\'s parameters')
            require(not same(d_before[1], d_state.model.named_buffers()),
                    'g_step did not move the discriminator\'s BatchNorm '
                    'statistics')
            g_before = snapshot(g_state.model)
        if name == 'd_step':
            require(same(g_before[0], g_state.model.named_parameters()),
                    'd_step moved the generator\'s parameters')
            require(not same(g_before[1], g_state.model.named_buffers()),
                    'd_step did not move the generator\'s BatchNorm '
                    'statistics')
            require(not same(d_before[0], d_state.model.named_parameters()),
                    'd_step did not move the discriminator')

    # ---- one epoch over 4 batches, one validation ----------------------
    trainer.train_batches, trainer.dev_batches = batches, batches[:1]
    g_before = snapshot(g_state.model)
    reset_stack_launches()
    t0 = time.perf_counter()
    last_g, last_d = trainer.train_epoch(0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_launches = stack_launches()
    val = trainer.validate()
    print(f'train: train_epoch(0) over {len(batches)} batches {epoch_s:.2f} '
          f's, launches {epoch_launches}, last g_loss {last_g:.4f} d_loss '
          f'{last_d:.4f}; validate ' + ' '.join(
              f'{k}={v:.4f}' for k, v in val.items()), flush=True)
    g_steps = epoch_launches['gcn_stack_fwd'] // 2
    require(g_steps == 3 * len(batches)
            and epoch_launches['gcn_stack_bwd'] == 2 * g_steps,
            f'epoch launches {epoch_launches}: expected 12 G steps')
    require(0 < epoch_launches['gcn_stack'] <= 2 * len(batches),
            f'epoch launches {epoch_launches}: expected 1-4 D steps')
    for v in (last_g, last_d, *val.values()):
        require(v == v and abs(v) != float('inf'), 'epoch: non-finite metric')
    require(not same(g_before[0], g_state.model.named_parameters()),
            'train_epoch did not move the generator')
    for model in (g_state.model, d_state.model):
        require(all(bool(torch.isfinite(t).all())
                    for t in model.state_dict().values()),
                'non-finite parameter or buffer after the epoch')

    # ---- gradients: fused kernels (f32 operands) against eager stacks ---
    d0 = Discriminator(DiscriminatorConfig(dropout=0.0)).cuda()
    d0.load_state_dict(d_state.model.state_dict())
    grads = {}
    for fused in (True, False):
        g0 = load_generator(config=GeneratorConfig(
            dropout=0.0, fused_gcn=fused, fused_precise=True))
        states = init_states(g0, d0)
        step = make_train_steps(g0, d0, TrainConfig())[0]
        key = torch.Generator(device='cuda').manual_seed(5)
        step(*states, audio, pose, trainer.mean, trainer.std, 0.93, 0.0, key,
             mask=mask)
        grads[fused] = {k: p.grad.clone() for k, p in g0.named_parameters()}
    # The kernels are held tightly in phase 4 and the autograd plumbing in
    # the CPU tests; this check is for the two together at full width, where
    # a wrong transpose or a lost dx shows as an error of order 1.  The ideal
    # bound, 1e-3 of each tensor's max|grad|, does not hold between two
    # correct implementations here, for two reasons.  (1) The LeakyReLU kink
    # (see gcn_kernel.kink_margin): of the 136 M LayerNorm outputs of one
    # step some hundred lie within the ~3e-6 by which the kernel's y and the
    # eager y differ, and each takes the other slope (which ones changes from
    # run to run with cuBLAS's summation order); that reaches the stacks'
    # own parameters and everything before them.  (2) The flagship is
    # trained, so the gradient of a scalar gate (SelfAttention.gamma) is a
    # sum of 2 M products that nearly cancel.  So: the stacks' own tensors,
    # which the autograd function delivers, within GRAD_STACK_TOL of their
    # max|grad|; every other tensor of more than one element within
    # GRAD_TENSOR_TOL; all tensors together within GRAD_L2_TOL in relative
    # L2.  A bias that feeds a train-mode BatchNorm has a zero gradient up
    # to rounding; a tensor is held to no less than GRAD_FLOOR of the
    # largest max|grad| of any tensor.
    floor = GRAD_FLOOR * max(ref.abs().max().item()
                             for ref in grads[False].values())
    worst = {'stack': (0.0, ''), 'other': (0.0, ''), 'scalar': (0.0, '')}
    num = den = 0.0
    for k, ref in grads[False].items():
        err, scale = rel_err(grads[True][k], ref)
        group = ('stack' if '.gcn.' in k
                 else 'scalar' if ref.numel() == 1 else 'other')
        if err / max(scale, floor) > worst[group][0]:
            worst[group] = (err / max(scale, floor), k)
        num += (grads[True][k] - ref).double().pow(2).sum().item()
        den += ref.double().pow(2).sum().item()
    l2 = (num / den) ** 0.5
    print(f'train: g_step gradients, fused (f32 operands) vs eager stacks: '
          f'stack tensors worst {worst["stack"][1]} {worst["stack"][0]:.3e} '
          f'of its max|grad| (tol {GRAD_STACK_TOL}); other tensors worst '
          f'{worst["other"][1]} {worst["other"][0]:.3e} (tol '
          f'{GRAD_TENSOR_TOL}); scalar gates worst {worst["scalar"][1]} '
          f'{worst["scalar"][0]:.3e} (not held); all tensors relative L2 '
          f'{l2:.3e} (tol {GRAD_L2_TOL}); floor {floor:.3e}', flush=True)
    for group, tol in (('stack', GRAD_STACK_TOL), ('other', GRAD_TENSOR_TOL)):
        require(worst[group][0] <= tol, f'fused vs eager gradient of '
                f'{worst[group][1]}: {worst[group][0]}')
    require(l2 <= GRAD_L2_TOL, f'fused vs eager gradients: relative L2 {l2}')
    worst = {k: v[0] for k, v in worst.items()} | {'l2': l2}
    del grads, g0, d0, states

    # ---- step times -----------------------------------------------------
    times = dict(g_step_ms=host_ms(g_step), d_step_ms=host_ms(d_step),
                 eval_step_ms=host_ms(eval_step))
    unfused = build_trainer(batch=0, config=GeneratorConfig(fused_gcn=False))
    us = (unfused.g_state, unfused.d_state)
    times['g_step_unfused_ms'] = host_ms(lambda: unfused.g_step(
        *us, audio, pose, unfused.mean, unfused.std, lp_r.smooth_real,
        lp_r.noise_std, unfused.key, mask=mask))
    times['g_step_ms_again'] = host_ms(g_step)
    print('train: B=128 ms per step (host clock, synchronised, after '
          'warm-up): ' + ' '.join(f'{k}={v:.2f}' for k, v in times.items()),
          flush=True)
    return dict(launches=launches, epoch_launches=epoch_launches,
                epoch_seconds=epoch_s, validate=val,
                fused_vs_eager_grad=worst, batch=batch, **times)


def edge_phase() -> dict:
    """K5 against its plain version and against K1; returns its entry of
    the kernels line."""
    import torch
    from a2m_torch import constants
    from a2m_torch.nn import gcn_kernel as gk

    f, heads, n_main = 64, 4, SERVE_STREAMS * SERVE_WINDOWS * 64
    gen = torch.Generator().manual_seed(6)
    adj = {10: constants.adjacency_from_edges(constants.body_edges(), 10),
           42: constants.adjacency_from_edges(constants.hand_edges(), 42)}
    entry = dict(ms=0.0, plain_ms=0.0, flops=0, bytes=0, max_abs_err=0.0)
    k1_ms = 0.0
    for j in (10, 42):
        params = random_stack_params(f, heads, gen).cuda()
        a = torch.as_tensor(adj[j]).cuda()
        print(f'gcn_stack_edge J={j}: {gk.edge_tile(a, f)} graphs per block, '
              f'{gk.edge_routing(a)["edges"]} edges', flush=True)
        for n in (n_main, 1001):
            x = torch.randn(n, j, f, generator=gen).cuda()
            ref32 = gk.gcn_stack_edge_plain(x, params, a, heads, precise=True)
            for precise in (True, False):
                tag = f'gcn_stack_edge J={j} N={n} precise={precise}'
                got = gk.gcn_stack_edge(x, params, a, heads, precise=precise)
                again = gk.gcn_stack_edge(x, params, a, heads,
                                          precise=precise)
                ref = gk.gcn_stack_edge_plain(x, params, a, heads,
                                              precise=precise)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(got).all()),
                        f'{tag}: non-finite output')
                require(bool(torch.equal(got, again)),
                        f'{tag}: two runs on the same input differ')
                err, scale = rel_err(got, ref)
                tol = 2e-5 if precise else 0.01 * scale
                print(f'{tag}: bit-equal over two runs; max_abs_err='
                      f'{err:.3e} (max|ref| {scale:.3f}, tol {tol:.3e})',
                      flush=True)
                require(err <= tol, f'{tag}: {err} > {tol}')
                if precise:
                    # with f32 operands the edge form and the dense kernel
                    # compute one function up to summation order
                    dense = gk.gcn_stack(x, params, a, heads, precise=True)
                    err_k1 = (got - dense).abs().max().item()
                    print(f'{tag}: max|K5 - K1|={err_k1:.3e} (tol 2e-5)',
                          flush=True)
                    require(err_k1 <= 2e-5, f'{tag}: differs from gcn_stack '
                            f'by {err_k1}')
                    continue
                mean_err = (got - ref).abs().mean().item()
                gap = (ref - ref32).abs().mean().item()
                print(f'{tag}: mean|kernel - plain bf16| {mean_err:.3e}, '
                      f'mean|plain bf16 - plain f32| {gap:.3e} (tol '
                      f'{BF16_MEAN_SHARE} of it)', flush=True)
                require(mean_err <= BF16_MEAN_SHARE * gap,
                        f'{tag}: mean error {mean_err} not below '
                        f'{BF16_MEAN_SHARE} x the gap {gap}')
                if n == n_main:
                    entry['max_abs_err'] = max(entry['max_abs_err'], err)
        # the serving path's mode: bf16 operands, N = streams x windows x T
        x = torch.randn(n_main, j, f, generator=gen).cuda()
        ms = cuda_ms(lambda: gk.gcn_stack_edge(x, params, a, heads))
        dense = cuda_ms(lambda: gk.gcn_stack(x, params, a, heads))
        plain = cuda_ms(lambda: gk.gcn_stack_edge_plain(x, params, a, heads),
                        3, 1)
        ms_f32 = cuda_ms(lambda: gk.gcn_stack_edge(x, params, a, heads,
                                                   precise=True))
        ms_again = cuda_ms(lambda: gk.gcn_stack_edge(x, params, a, heads))
        flops = gk.stack_flops(n_main, adj[j], f, heads)
        nbytes = gk.stack_edge_bytes(n_main, adj[j], f, heads)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
        print(f'gcn_stack_edge J={j} N={n_main}: kernel_ms={ms:.4f} (again '
              f'{ms_again:.4f}; f32 operands {ms_f32:.4f}) gcn_stack (K1) at '
              f'the same N {dense:.4f} plain_ms={plain:.4f} bound_ms='
              f'{b_ms:.4f} ({b_by}; {flops / 1e9:.2f} GFLOP, '
              f'{nbytes / 1e6:.1f} MB)', flush=True)
        entry['ms'] += ms
        entry['plain_ms'] += plain
        entry['flops'] += flops
        entry['bytes'] += nbytes
        k1_ms += dense
    entry['bound_ms'], entry['bound_by'] = bound(entry.pop('flops'),
                                                 entry.pop('bytes'),
                                                 PEAK_BF16)
    print(f'gcn_stack_edge both stacks N={n_main}: kernel_ms='
          f'{entry["ms"]:.4f}, gcn_stack (K1) {k1_ms:.4f}, bound_ms='
          f'{entry["bound_ms"]:.4f}', flush=True)
    return entry


def log_mel_modes_phase() -> dict:
    """The log-mel modes of the serving path against the plain version:
    every frontend family at pose rate, small batches with many frames, and
    the framed entry."""
    import torch
    from a2m_torch.audio import frontend, mel_kernel
    from a2m_torch.eval import streaming
    from a2m_torch.pipeline import SR

    gen = torch.Generator().manual_seed(7)
    out = {}
    cases = [('log_mel_512', SR, SERVE_STREAMS, SERVE_SECONDS, True),
             ('log_mel_512', SR, 1, SERVE_SECONDS, True),
             ('log_mel_400', 16000, SERVE_STREAMS, SERVE_SECONDS, True),
             ('vggish', 16000, SERVE_STREAMS, SERVE_SECONDS, True),
             ('log_mel_400', 16000, 2, 2, False),   # hop 160 < frame_len
             ('vggish', 16000, 2, 2, False)]
    for method, sr, batch, seconds, pose_rate in cases:
        spec = (streaming._pose_rate_spec(sr, method) if pose_rate
                else {'log_mel_400': frontend.spec_log_mel_400,
                      'vggish': frontend.spec_vggish}[method]())
        y = (torch.randn(batch, sr * seconds, generator=gen) * 0.1).cuda()
        m = frontend.dft_matrices(spec)
        dr, di, mel = (torch.from_numpy(m[k]).cuda()
                       for k in ('dr', 'di', 'mel'))
        t = frontend.num_frames(spec, y.shape[1])
        pad = spec.n_fft // 2 if spec.center else 0
        args = (dr, di, mel, spec.hop_length, pad, t, spec.log_const,
                spec.power, spec.log_mode)
        got = frontend.log_mel(y, spec)
        ref = mel_kernel.log_mel_plain(y, *args)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        groups = mel_kernel.bin_groups(batch, t, m['K'], y.device)
        tag = (f'log_mel {method} sr={sr} hop={spec.hop_length} frame_len='
               f'{m["frame_len"]} B={batch} T={t} mels={spec.n_mels}')
        print(f'{tag}: max_abs_err={err:.3e} (tol 1e-4), bin groups '
              f'{groups}', flush=True)
        require(tuple(got.shape) == (batch, t, spec.n_mels)
                and bool(torch.isfinite(got).all()),
                f'{tag}: shape {tuple(got.shape)} or non-finite values')
        require(err <= 1e-4, f'{tag}: {err} > 1e-4')
        if not pose_rate:
            continue
        # the framed entry: the client's frames, the same kernel
        framed = torch.from_numpy(frontend.frame_for_wire(
            y.cpu().numpy(), spec)).cuda()
        require(tuple(framed.shape) == (batch, t, m['frame_len']),
                f'{tag}: framed {tuple(framed.shape)}')
        same = torch.equal(frontend.log_mel_frames(framed, spec), got)
        print(f'{tag}: framed entry bit-equal to the waveform entry: {same}',
              flush=True)
        require(same, f'{tag}: framed entry differs from the waveform entry')
        if method == 'log_mel_512' and batch == SERVE_STREAMS:
            ms = cuda_ms(lambda: mel_kernel.log_mel(y, *args))
            plain = cuda_ms(lambda: mel_kernel.log_mel_plain(y, *args))
            window = torch.hann_window(spec.n_fft, periodic=True,
                                       device='cuda')

            def library():
                s = torch.stft(y, spec.n_fft, hop_length=spec.hop_length,
                               window=window, center=True,
                               pad_mode='reflect', return_complex=True)
                p = (s.real ** 2 + s.imag ** 2).transpose(1, 2)
                return torch.log(torch.clamp_min(p @ mel, spec.log_const))

            lib_err = (library() - ref).abs().max().item()
            lib_ms = cuda_ms(library)
            flops = mel_kernel.log_mel_flops(batch, t, spec.n_fft, m['K'])
            nbytes = mel_kernel.log_mel_bytes(batch, y.shape[1], t,
                                              m['frame_len'],
                                              spec.hop_length, m['K'])
            b_ms, b_by = bound(flops, nbytes, PEAK_FP32)
            print(f'{tag}: kernel_ms={ms:.4f} plain_ms={plain:.4f} '
                  f'library_ms={lib_ms:.4f} (torch.stft route, max_abs_err '
                  f'vs plain {lib_err:.3e}) bound_ms={b_ms:.4f} ({b_by}; '
                  f'{flops / 1e9:.3f} GFLOP by FFT, {nbytes / 1e6:.1f} MB)',
                  flush=True)
            out = dict(batch=batch, n_frames=t, ms=ms, plain_ms=plain,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=err)
    return out


def serve_phase(smi: str) -> dict:
    """The streaming server at full width: 8 streams of 60 s through one
    fused call, its wires and routes against each other, and a2m's JAX
    output."""
    import numpy as np
    import torch
    from a2m_torch.audio import mel_kernel
    from a2m_torch.eval import streaming
    from a2m_torch.pipeline import SR, build_server

    t0 = time.perf_counter()
    serve = build_server()
    print(f'serve: build_server {time.perf_counter() - t0:.2f} s', flush=True)
    gen = torch.Generator().manual_seed(8)
    n = SR * SERVE_SECONDS
    waves = [(torch.randn(n, generator=gen) * 0.1).numpy()
             for _ in range(SERVE_STREAMS)]
    serve(waves)                      # warm-up: kernels load, cuDNN picks

    reset_stack_launches()
    mel_kernel.log_mel.launches = 0
    poses = serve(waves)
    launches = {'log_mel': mel_kernel.log_mel.launches, **stack_launches()}
    print(f'serve: launches in one fused call of {SERVE_STREAMS} x '
          f'{SERVE_SECONDS} s {launches}', flush=True)
    require(launches == {'log_mel': 1, 'gcn_stack_edge': 2, 'gcn_stack': 0,
                         'gcn_stack_fwd': 0, 'gcn_stack_bwd': 0},
            f'serving launches {launches}, expected log_mel 1, '
            f'gcn_stack_edge 2 and no other')
    t_pose = 1 + n // 3072
    require(len(poses) == SERVE_STREAMS and all(
        p.shape == (t_pose, 104) and p.dtype == np.float32
        and np.isfinite(p).all() for p in poses),
        f'serving poses {[p.shape for p in poses]}')
    fused = np.stack(poses)
    scale = float(np.abs(fused).max())

    def rel(got) -> float:
        got = np.stack(got)
        require(got.shape == fused.shape and bool(np.isfinite(got).all()),
                f'serving poses {got.shape} or non-finite values')
        return float(np.abs(got - fused).max()) / scale

    # (a) the wires
    errs = {}
    errs['int16'] = rel(serve([(w * 32767).astype(np.int16) for w in waves]))
    wire_u = [streaming.encode_ulaw(w) for w in waves]
    ulaw = serve(wire_u, encoding='ulaw')
    errs['ulaw'] = rel(ulaw)
    errs['framed'] = rel(serve(streaming.frame_streams_for_wire(waves, SR),
                               framed_n_samples=n))
    framed_u = streaming.frame_streams_for_wire(waves, SR, encoding='ulaw')
    errs['framed_ulaw_vs_ulaw'] = float(np.abs(np.stack(serve(
        framed_u, encoding='ulaw', framed_n_samples=n))
        - np.stack(ulaw)).max()) / scale
    # two batches of 4 streams: the same function, but cuDNN and cuBLAS may
    # pick other algorithms for the other batch size, and a last-bit
    # difference ahead of a stack flips bf16 rounding ties inside it; with
    # f32 operands only the summation order is left
    errs['pipeline_groups_2'] = rel(serve(waves, pipeline_groups=2))
    # (b) the chunked route, blended on the host
    errs['chunked'] = rel(serve(waves, fused=False, batch_size=64))
    # (c) the dense kernel in place of the edge form
    errs['k1_bf16'] = rel(build_server(fused_edge=False)(waves))
    serve_f32 = build_server(fused_precise=True)
    f32 = np.stack(serve_f32(waves))
    errs['k5_f32_vs_bf16'] = rel(f32)
    errs['pipeline_groups_2_f32'] = float(np.abs(np.stack(serve_f32(
        waves, pipeline_groups=2)) - f32).max()) / scale
    errs['k1_f32_vs_k5_f32'] = float(np.abs(np.stack(build_server(
        fused_edge=False, fused_precise=True)(waves)) - f32).max()) / scale
    print('serve: max|pose - fused call|/max|pose|: '
          + ' '.join(f'{k}={v:.3e}' for k, v in errs.items())
          + f' (max|pose| {scale:.2f}; tol framed and framed_ulaw_vs_ulaw '
          f'1e-5, pipeline_groups_2 and chunked 1e-3, pipeline_groups_2_f32 '
          f'1e-5, k1_bf16 1e-2, k1_f32_vs_k5_f32 1e-4; int16 and ulaw are '
          f'other inputs)',
          flush=True)
    for key, tol in (('framed', 1e-5), ('framed_ulaw_vs_ulaw', 1e-5),
                     ('pipeline_groups_2', 1e-3),
                     ('pipeline_groups_2_f32', 1e-5), ('chunked', 1e-3),
                     ('k1_bf16', 1e-2), ('k5_f32_vs_bf16', 1e-2),
                     ('k1_f32_vs_k5_f32', 1e-4), ('int16', 1e-2),
                     ('ulaw', 0.5)):
        require(errs[key] <= tol, f'serving {key}: {errs[key]} > {tol}')

    # (d) a2m's JAX output on 2 streams of 10 s
    with np.load(ROOT / 'a2m_torch' / 'testdata' / 'streaming_golden.npz') \
            as z:
        golden = {k: z[k] for k in z.files}
    rng = np.random.default_rng(int(golden['seed']))
    g_waves = [(rng.standard_normal(SR * 10) * 0.1).astype(np.float32)
               for _ in range(2)]
    g_framed = streaming.frame_streams_for_wire(g_waves, SR, encoding='ulaw')
    g_errs = {}
    for name, fn, tol in (('precise', serve_f32, 1e-4), ('bf16', serve, 1e-2)):
        for wire, got in (
                ('linear', fn(g_waves)),
                ('framed_ulaw', fn(g_framed, encoding='ulaw',
                                   framed_n_samples=SR * 10))):
            err = float(np.abs(np.stack(got) - golden[wire]).max()
                        / np.abs(golden[wire]).max())
            g_errs[f'{name}_{wire}'] = err
            require(err <= tol, f'golden {name} {wire}: {err} > {tol}')
    print('serve vs JAX golden (2 x 10 s, T=149), max_err/max|pose|: '
          + ' '.join(f'{k}={v:.3e}' for k, v in g_errs.items())
          + ' (tol precise 1e-4, bf16 1e-2)', flush=True)

    # wall per call: the host clock around calls that end in the download
    on_card = [torch.from_numpy(w).cuda() for w in waves]
    times = dict(
        s8_upload_ms=host_ms(lambda: serve(waves)),
        s8_on_card_ms=host_ms(lambda: serve(on_card)),
        s8_upload_groups2_ms=host_ms(lambda: serve(waves,
                                                   pipeline_groups=2)),
        s8_framed_ulaw_upload_ms=host_ms(lambda: serve(
            framed_u, encoding='ulaw', framed_n_samples=n)),
        s1_upload_ms=host_ms(lambda: serve(waves[:1])),
        s1_on_card_ms=host_ms(lambda: serve(on_card[:1])))
    k1 = build_server(fused_edge=False)
    times['s8_k1_on_card_ms'] = host_ms(lambda: k1(on_card))
    times['s8_on_card_ms_again'] = host_ms(lambda: serve(on_card))
    rt = {k.replace('_ms', '_realtime'):
          (1 if k.startswith('s1') else SERVE_STREAMS) * SERVE_SECONDS
          / (v / 1e3) for k, v in times.items()}
    print(f'serve [{smi}]: wall per fused call, host clock, download '
          f'included: ' + ' '.join(f'{k}={v:.2f}' for k, v in times.items()),
          flush=True)
    print(f'serve [{smi}]: realtime factor (audio seconds per wall second): '
          + ' '.join(f'{k}={v:.1f}' for k, v in rt.items()), flush=True)
    return dict(launches=launches, streams=SERVE_STREAMS,
                seconds=SERVE_SECONDS, pose_frames=t_pose, errors=errs,
                golden_rel_err=g_errs, **times, **rt)


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
    fwd, bwd = gcn_train_phase()
    mel = log_mel_phase()
    sl = slice_phase()
    print(json.dumps({'slice': sl, 'device': smi}))
    tr = train_phase()
    print(json.dumps({'train': tr, 'device': smi}))
    edge = edge_phase()
    mel_serving = log_mel_modes_phase()
    print(json.dumps({'log_mel_serving': mel_serving, 'device': smi}))
    sv = serve_phase(smi)
    print(json.dumps({'serve': sv, 'device': smi}))
    stack = dict(route='cuda', library_ms=None)
    kernels = [
        dict(name='gcn_stack', source='a2m_torch/csrc/gcn_stack.cu',
             replaces='a2m/nn/pallas_gcn.py:228',
             launches=sl['launches']['gcn_stack'], **stack, **gcn),
        dict(name='log_mel', route='cuda',
             source='a2m_torch/csrc/log_mel.cu',
             replaces='a2m/audio/pallas_mel.py:68',
             launches=sl['launches']['log_mel'], **mel),
        dict(name='gcn_stack_fwd', source='a2m_torch/csrc/gcn_stack.cu',
             replaces='a2m/nn/pallas_gcn.py:529',
             launches=tr['launches']['g_step']['gcn_stack_fwd'], **stack,
             **fwd),
        dict(name='gcn_stack_bwd', source='a2m_torch/csrc/gcn_stack_bwd.cu',
             replaces='a2m/nn/pallas_gcn.py:557',
             launches=tr['launches']['g_step']['gcn_stack_bwd'], **stack,
             **bwd),
        dict(name='gcn_stack_edge',
             source='a2m_torch/csrc/gcn_stack_edge.cu',
             replaces='a2m/nn/pallas_gcn.py:879',
             launches=sv['launches']['gcn_stack_edge'], **stack, **edge),
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
