#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``a2m_torch``) on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` (PATH, ``$CUDA_HOME`` or ``/usr/local/cuda``) and
``nvidia-smi``, and imports neither JAX nor the ``a2m`` package.  Phases,
each fatal on failure:

1. the card's name and power limit;
2. build every kernel of the port from ``a2m_torch/csrc/`` (one ``nvcc``
   per source, in parallel);
3. ``gcn_stack`` (K1; bf16 operands on the tensor cores, f32 on the CUDA
   cores): the HGMMA instructions in its library's SASS (``cuobjdump
   -sass``, more than 0), its launch plan (graphs a tile, rows, shared
   bytes, blocks an SM, registers, spills, also of the stash kernel K3),
   then against its plain PyTorch version at the main-path shapes (N = 8192
   graphs, J in {10, 42}, F = 64, H = 4), at N = 1001 and at N in {1,
   T - 1, T + 1} (T graphs a tile), the smaller inputs being the first
   graphs of the largest: f32 operands within 2e-5, bf16 operands within 1%
   of max|ref| and, at N >= 1001, a mean error under 1% of the plain
   version's mean bf16-vs-f32 gap (the mean rule), two runs bit-equal,
   every smaller call bit-equal to the first graphs of the N = 8192 call;
   timed with CUDA events beside its bound;
4. ``gcn_stack_fwd`` (K3, the forward with stash) and ``gcn_stack_bwd`` (K4,
   the backward; bf16 operands on the tensor cores, f32 on the CUDA cores)
   at the same shapes and modes: the HGMMA instructions in K4's library
   (more than 0), its launch plan (graphs a tile, rows, shared bytes,
   blocks an SM, registers, spills); K3's ``y`` equals K1's, ``y`` and
   ``xs`` match the plain version; K4's ``dx`` (2e-4 of max|ref| in f32)
   and every parameter gradient (5e-4 of max(max|ref|, 1e-3)) match the
   plain version on graphs away from LeakyReLU's kink at N = 8192 and
   1001, 1% and the mean rule with bf16 operands; two K4 runs on the same
   input are bit-equal; at N in {1, T - 1, T + 1} (T graphs a tile, the
   first graphs of the N = 8192 input) K4's ``dx`` is bit-equal to the
   first rows of the N = 8192 call and over two runs, in both modes; both
   timed beside their bounds, K4 in both modes;
5. ``log_mel`` (K2, an FFT) against its plain version (the direct DFT) on
   the pose-rate strided spec at B = 128 and B = 1, 64 frames (1e-4; a
   second launch bit-equal to the first), timed at B = 128 beside the
   ``torch.stft`` route and the function's bound (a real FFT and the mel
   over the filterbank's nonzeros: bytes-bound);
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
8. ``gcn_stack_edge`` (K5, the forward in edge form; bf16 operands on the
   tensor cores, f32 on the CUDA cores): the HGMMA instructions in its
   library's SASS (``cuobjdump -sass``, more than 0), its launch plan
   (graphs a tile, rows, shared bytes, blocks an SM, registers, spills),
   then against its plain version at the serving shapes (N = 13,824
   graphs), at N = 1001 and at N in {1, T - 1, T + 1} (T graphs a tile), J
   in {10, 42}, the smaller inputs being the first graphs of the largest:
   f32 operands within 2e-5 of the plain version and of K1, bf16 operands
   within 1% of max|ref| and, at N >= 1001, the mean rule of phase 3 (a
   mean over fewer graphs is printed: one graph decides it), two runs
   bit-equal, every smaller call bit-equal to the first graphs of the
   N = 13,824 call, timed beside its bound and beside K1 at the same N; and the
   log-mel modes that serving adds to K2 against its plain version (1e-4):
   ``log_mel_512`` at B = 8, T = 891 and B = 1, ``log_mel_400`` and VGGish
   on 16 kHz (magnitude, 64 mels, uncentred frames of 512 and 400, htk
   mels, offset log), each also bit-equal on a second launch, and the
   framed entry bit-equal to the waveform entry; K2 timed at B = 8,
   T = 891 as in phase 5;
9. the streaming server: ``build_server()`` (flagship generator, both GCN
   stacks on K5) on 8 seeded streams of 60 s at 45.6 kHz, driven once with
   the launch counts set to 0 (1 log-mel and 2 edge-form launches, no K1
   launch expected); the int16, mu-law, framed and framed mu-law wires and
   ``pipeline_groups=2``; the chunked route, the dense kernel (K1) and f32
   operands against the fused call; a2m's JAX output in
   ``a2m_torch/testdata/streaming_golden.npz``; wall per call and realtime
   factor for 8 streams and for one, with the upload and with the input
   already on the card;
10. the data path: K2x (the exact-mode log-mel, ``log_mel_exact.cu``): its
   launch plan (frames and threads a block, shared bytes, blocks an SM,
   registers, spills), then against its plain version evaluated in float64
   (1e-5) on one and 32 intervals of 60 s at 45.6 kHz (``log_mel_512``),
   row 0 of the one bit-equal to row 0 of the 32, 60 s at 16 kHz
   (``log_mel_400``, and VGGish with its framed entry bit-equal to the
   waveform's) and waveforms of 1, 2, 500 and 1,024 samples (K2 on these
   too, at 1e-4), each with a bit-equal rerun, the distance to the port's
   float64 ``mel_np`` golden printed beside it, and K2x timed at 32
   intervals beside its bound (fp64 operations at the tensor cores' rate
   against bytes), the floor of the fp64 pipes an FFT runs on and the
   float64 ``torch.stft`` route; then 16 seeded intervals of 60 s written as
   wav files and read back through ``audio.io.wav_to_features`` (log-mel 512
   on all, log-mel 400 with the kaiser_best resample on two), driven with
   the counts set to 0 (K2x once per file, K2 never) and held to the plain
   version; then those features, paired with ``synthetic.synth_pose``
   tracks and cut by ``windowing.window_index``, as a ``Batcher`` of B = 128
   (14 intervals to train, 2 to validate) into ``build_trainer(loader=...)``:
   one ``train_epoch`` of 4 batches and ``validate`` on 2 (K3/K4 x2 per G
   step, K1 x2 per D and eval step, K2/K2x x0), and ms per batch with
   ``prefetch_batches`` 0 and 2.  Phases 6 and 9 also assert K2x x0;
11. train, checkpoint, resume and evaluate, as a user runs them: the det
   fixture of ``scripts/full_training_campaign.py:52-67`` (speaker oliver,
   5 intervals of 120 s, seed 0, deterministic; the recipe of
   ``a2m_torch/testdata/harness_golden.json``) built in memory
   (``data.synthetic.synthetic_loader``, window 64, hop 5, B = 128; 348
   test clips); ``train.__main__.run`` on a Config from
   ``apply_overrides`` (2 epochs of 4 batches and 1 dev batch,
   ``best_metric=val_pck``, ``lambda_pos=1.0``) with the counts set to 0
   (K3 and K4 x2 per G step, K1 x2 per D step and per dev batch, K2, K2x
   and K5 x0), its per-epoch checkpoints, ``best_gen.npz`` and
   ``loss.npy``, and its MFU line (finite); a second trainer on the same
   directory resumes at epoch 2 with every parameter, BatchNorm buffer and
   Adam moment bit-equal and the controller equal, and runs one more
   epoch; the checkpoint's write and restore timed; then
   ``eval.harness.evaluate_speaker`` on the 348 test clips with the
   committed flagship, f32 GCN operands (PCK at alpha 0.2 and 0.1 within
   2e-3 of the golden, L2 within 1e-3 relative) and bf16 (PCK within 1e-2),
   K1 x2 per batch, and on the short run's ``best_gen.npz`` (finite, 348
   clips);
12. export: the committed flagship at full width through
   ``a2m_torch.export`` (the CLI's route: ``_build_from_checkpoint`` with
   the ``.npz``'s own pose statistics) into four ``.pt2`` artifacts in a
   temporary directory, each export's seconds and bytes printed: the pose
   flavour at B = 1, at B = 2 with bf16 and with f32 GCN operands, and the
   audio flavour at B = 128; one fresh process that imports ``torch``,
   ``a2m_torch.nn.gcn_kernel`` and ``a2m_torch.audio.mel_kernel`` and
   nothing else of the port (asserted there, and every plain version
   replaced by one that raises) loads and runs each, counts its launches
   per call (K1 x2, and K2 x1 for the audio flavour) and times it; each
   output bit-equal to the live model's (``load_generator`` or
   ``build_pipeline``, then the denormalisation), the B = 2 artifacts
   against ``flagship_golden.npz`` (1e-4 of max|pose| with f32 operands,
   1% with bf16), and the artifact's call against the live call in one
   process (host clock, synchronised, median of 20 after warm-up) at
   B = 1 pose and B = 128 audio;
13. multi-process data-parallel training (``a2m_torch/parallel/``): the
   det fixture of phase 11 with its dev and test intervals both to
   validate (each rank needs one of each split), phase 11's overrides with
   dropout 0 (each rank draws its own dropout masks), 2 epochs of 4
   batches and 1 dev batch.  One process in this script at B = 128 on
   both ranks' batches concatenated, with cuDNN's deterministic
   algorithms; (a) one rank over NCCL in a child process of this script
   (``--rank-worker``) on the same batches, through
   ``train.__main__.bootstrap`` and ``run()``: every step's metrics, the
   loss histories, every parameter, buffer and Adam moment bit-equal to
   the one process; (b) two ranks over gloo on the one card, B = 64 each,
   on ``synthetic_loader(process_count=-1)``: a float64 gradient probe
   first (one sharded ``g_step`` and ``d_step`` at full width against one
   process on the concatenated 32 rows, 1e-9), then ``run()`` with each
   rank's own launch counts asserted (K3 and K4 x2 per G step, K1 x2 per D
   step and per dev batch), the ranks bit-equal (metrics, histories,
   parameters, buffers, Adam moments), the first G loss within 1e-3 of
   the one process, rank 0's checkpoints, and a two-rank resume bit-equal
   to the saved state followed by one more epoch, ranks still bit-equal;
   per rank the ms per ``g_step`` and ``d_step``, the ms in collectives
   and in the gradient all-reduce (on every other step, each collective
   between two synchronisations), and the checkpoint saves.  A rank that
   fails or outlives 600 s fails the phase;
14. a reference checkpoint migrated, evaluated, rendered, fine-tuned, and
   a2m's benchmark CLI: (a) seeded reference-schema ``state_dict`` files of
   ``GeneratorConfig()`` and ``DiscriminatorConfig()`` (the schema of
   ``tests/test_compat.py``, copied here; weights at a trained network's
   scale) through ``python -m a2m_torch.compat`` in a process of its own
   (its seconds; both ``.npz`` all f32); the head-permutation markers at
   full width (zero weights, head biases the semantic channel) through K1
   with f32 and bf16 operands, every output channel exactly its index; the
   migrated generator on the card (K1 x2) against the same weights on the
   CPU's plain path at B = 8, 1e-4 of max|pose| with f32 operands and 1%
   with bf16; ``train.__main__.run`` with ``train.init_from`` the
   migration on phase 11's det fixture (1 epoch of 2 batches and 1 dev
   batch, B = 128): the log line ``initialized G+D``, G and D bit-equal to
   the files and the optimisers empty when ``fit`` starts, K3 and K4 x2 a
   G step, G moved; (b) whether matplotlib, PIL and ffmpeg are installed
   (printed), then ``evaluate_speaker`` on the migrated G over the 348 test
   clips with ``render_sample_to`` where matplotlib and PIL are (the video
   written), else without it and ``generate_video.sample_keypoints`` (K1 x2,
   finite keypoints); (c) ``python -m a2m_torch.eval.benchmarks --configs
   1,2,3,4,5,6`` in a process of its own, each config's line printed and
   its launches asserted (1: K2x x1 and K1 x2 a forward; 2: K2 a call; 3:
   K3 and K4 x2 a ``g_step``, K1 x2 a ``d_step``; 4: K3, K4 and K1 at F = 8,
   H = 2; 5: K1; 6: K2 and K5; nothing else), config 1's log-mel within
   1e-5 of float64, config 5's flagship PCK within 1e-2 of
   ``harness_golden.json`` (bf16 operands).  The phase's seconds and the
   whole script's are printed;
15. bf16 training (``train.compute_dtype='bf16'``: G and D compute in
   bf16 as a2m's ``Generator(dtype=jnp.bfloat16)``, parameters and all
   state f32, K1/K3/K4 fed f32 as a2m feeds its Pallas kernels) and the
   A14b encoders: (a) the committed flagship as ``Generator(dtype=bf16)``
   (K1 x2, bf16 operands) and as the f32 generator (K1 x2, f32 operands)
   at B = 128 on ``a2m_torch/testdata/bf16_golden.json``'s seeded input:
   the pose f32 as a2m's, and the gap between the two within 2x of a2m's
   own bf16-vs-f32 gap on the same weights and input (the golden, held by
   ``tests/test_torch_bf16.py``) in mean and in the median over the rows
   of each row's max, the max printed beside a2m's; (b) one bf16
   ``g_step`` and ``d_step`` at full width (the flagship G, a seeded D
   with its attention gates at 0.5; dropout 0, label noise 0, B = 8, the
   last row wrap-padded) on the card (K3 and K4 x2, K1 x2) against the
   same steps on the CPU's plain path: the losses as one vector and each
   parameter's gradient (tensors under 1024 elements pooled per model) by
   relative L2 within 2x of the CPU's own bf16-vs-f32 gap, gradients
   that are zero on the CPU in both dtypes (a saturated attention) zero
   on the card; (c) phase 11's det fixture through ``train.__main__.run``
   with ``train.compute_dtype=bf16``, 1 epoch of 4 batches and 1 dev
   batch: K3 and K4 x2 a G step, K1 x2 a D step and dev batch, no K2, K2x
   or K5, finite losses, the MFU line at the bf16 peak, the checkpoint's
   parameters, buffers and Adam moments f32, a resume bit-equal, and the
   harness on its best G (K1 x2 a batch, 348 clips); (d) ``build_trainer``
   in bf16 and in f32 at B = 128, both in one process: blocks of 10
   synchronised ``g_step``s and ``d_step``s after warm-up in turns (f32,
   bf16, bf16, f32), the median ms by dtype (host clock), and a profiled
   breakdown of three (kernel ms by category, idle share), then
   ``config3_train_step(compute_dtype='bf16')``'s line with its launches;
   (e) each A14b encoder at a2m's default widths (B = 8, T = 64) on the
   card against the CPU in f32, 1e-4 of max|y|.  The phase's seconds, per
   part, are printed.

The line before the last is ``{"kernels": [...]}`` (each kernel's
``phase14_launches`` by part of phase 14 and ``phase15_launches`` by
part of phase 15); the last line is ``{"ok": true, "device": {...}}``.
Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
PEAK_BF16 = 989e12                # dense tensor-core bf16 FLOP/s
PEAK_FP32 = 67e12                 # fp32 outside the tensor cores
PEAK_FP64 = 67e12                 # fp64 on the tensor cores (DMMA)
FP64_PIPES = 34e12                # fp64 outside them, where an FFT runs
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
# the data path: intervals of feature extraction and their length; K2x's
# tolerance against its float64 plain version (a2m's exact-mode bound
# against the float64 golden, tests/test_audio_frontend.py:16)
DATA_INTERVALS, DATA_SECONDS, EXACT_TOL = 16, 60, 1e-5
# the harness against a2m's on the flagship (harness_golden.json): PCK and
# L2 with f32 GCN operands, PCK with bf16 operands
HARNESS_PCK_TOL, HARNESS_L2_RTOL, HARNESS_BF16_PCK_TOL = 2e-3, 1e-3, 1e-2


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f'chip_smoke: {what}')


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``iters``
    launches after ``warmup``.  A spin kernel of ~20 ms is queued ahead of
    the first event, so the host has queued the launches before the card
    reaches them: a kernel shorter than its launch's host work is timed
    back to back, not at the host's pace."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
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


def gcn_phase() -> dict:
    """K1 against its plain version; returns its entry of the kernels
    line."""
    import torch
    from a2m_torch import constants
    from a2m_torch.nn import gcn_kernel as gk
    from a2m_torch.utils.edge_probe import stack_params

    f, heads, n_main = 64, 4, 128 * 64
    gen = torch.Generator().manual_seed(0)
    adj = {10: constants.adjacency_from_edges(constants.body_edges(), 10),
           42: constants.adjacency_from_edges(constants.hand_edges(), 42)}
    entry = dict(ms=0.0, plain_ms=0.0, flops=0, bytes=0, max_abs_err=0.0)
    hgmma = hgmma_count('gcn_stack')
    print(f'gcn_stack: {hgmma} HGMMA instructions in the built library\'s '
          f'SASS', flush=True)
    require(hgmma > 0, 'gcn_stack: no HGMMA in the built library')
    for j in (10, 42):
        params = stack_params(f, heads, gen).cuda()
        a = torch.as_tensor(adj[j]).cuda()
        plan = gk.dense_tc_plan(j, f, heads, gk.edge_routing(a)['slots'])
        info, stash = (gk.dense_tc_info(plan['smem_bytes'], s)
                       for s in (False, True))
        print(f'gcn_stack J={j}: bf16 mode (tensor cores): {plan["graphs"]} '
              f'graphs a tile, {plan["rows"]} rows padded to '
              f'{plan["padded_rows"]}, {plan["slots"]} slots a row, '
              f'{plan["smem_bytes"]} B shared, {info["blocks_per_sm"]} block '
              f'an SM of {info["threads"]} threads, {info["registers"]} '
              f'registers, {info["local_bytes"]} B local (spills); with the '
              f'stash (K3) {stash["registers"]} registers, '
              f'{stash["local_bytes"]} B local', flush=True)
        # N = 1001 and N in {1, T - 1, T + 1}: the first graphs of N = 8192
        x_main = torch.randn(n_main, j, f, generator=gen).cuda()
        small = sorted({1, plan['graphs'] - 1, plan['graphs'] + 1} - {0})
        hold_to_plain('gcn_stack', gk.gcn_stack, gk.gcn_stack_plain, x_main,
                      params, a, heads, (n_main, 1001, *small), entry)
        # the main path's mode: bf16 operands, N = B * T graphs
        x = torch.randn(n_main, j, f, generator=gen).cuda()
        ms = cuda_ms(lambda: gk.gcn_stack(x, params, a, heads))
        plain = cuda_ms(lambda: gk.gcn_stack_plain(x, params, a, heads))
        ms_f32 = cuda_ms(lambda: gk.gcn_stack(x, params, a, heads,
                                              precise=True))
        ms_again = cuda_ms(lambda: gk.gcn_stack(x, params, a, heads))
        flops = gk.stack_flops(n_main, adj[j], f, heads)
        nbytes = gk.stack_bytes(n_main, j, f, heads)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
        print(f'gcn_stack J={j} N={n_main}: kernel_ms={ms:.4f} (again '
              f'{ms_again:.4f}; f32 operands {ms_f32:.4f}) plain_ms='
              f'{plain:.4f} bound_ms={b_ms:.4f} ({b_by}; {flops / 1e9:.2f} '
              f'GFLOP, {nbytes / 1e6:.1f} MB)', flush=True)
        entry['ms'] += ms
        entry['plain_ms'] += plain
        entry['flops'] += flops
        entry['bytes'] += nbytes
    entry['bound_ms'], entry['bound_by'] = bound(entry.pop('flops'),
                                                 entry.pop('bytes'),
                                                 PEAK_BF16)
    print(f'gcn_stack both stacks N={n_main}: kernel_ms={entry["ms"]:.4f}, '
          f'bound_ms={entry["bound_ms"]:.4f}', flush=True)
    return entry


def rel_err(got, ref) -> tuple[float, float]:
    """max |got - ref| and max |ref|."""
    return (got - ref).abs().max().item(), ref.abs().max().item()


def hold_to_plain(name: str, fn, plain, x_main, params, a, heads: int,
                  sizes, entry: dict, also=None) -> None:
    """Phases 3 and 8: a GCN stack kernel ``fn`` against its plain version
    ``plain`` at every N of ``sizes``, the largest first (the others are its
    first graphs, so their outputs are its first rows, bit for bit: a row
    depends on its own graph, not on the tile or N), f32 operands then bf16:
    finite, two runs bit-equal, within 2e-5 (f32) or 1% of max|ref| and, at
    N >= 1001, the mean rule (bf16).  ``also(tag, x, got)`` adds a check of
    the f32 mode; the largest bf16 error of the largest N goes to
    ``entry``."""
    import torch
    n_main, j = sizes[0], x_main.shape[1]
    full = {}
    for n in sizes:
        x = x_main[:n]
        ref32 = plain(x, params, a, heads, precise=True)
        for precise in (True, False):
            tag = f'{name} J={j} N={n} precise={precise}'
            got = fn(x, params, a, heads, precise=precise)
            again = fn(x, params, a, heads, precise=precise)
            ref = plain(x, params, a, heads, precise=precise)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()),
                    f'{tag}: non-finite output')
            require(bool(torch.equal(got, again)),
                    f'{tag}: two runs on the same input differ')
            if n == n_main:
                full[precise] = got
            else:
                require(bool(torch.equal(got, full[precise][:n])),
                        f'{tag}: differs from the first {n} graphs of the '
                        f'N={n_main} call')
            err, scale = rel_err(got, ref)
            tol = 2e-5 if precise else 0.01 * scale
            print(f'{tag}: bit-equal over two runs'
                  + ('' if n == n_main else f' and to the first {n} graphs '
                     f'of N={n_main}')
                  + f'; max_abs_err={err:.3e} (max|ref| {scale:.3f}, tol '
                  f'{tol:.3e})', flush=True)
            require(err <= tol, f'{tag}: {err} > {tol}')
            if precise:
                if also is not None:
                    also(tag, x, got)
                continue
            # The max tolerance alone is of the order of the whole
            # bf16-vs-f32 gap: hold the kernel's mean error far below the
            # mean gap, so bf16 rounding in the wrong place fails.  The rule
            # holds a population of graphs: below ~1,000 one graph whose
            # roundings tie differently (f32 summation order) decides it
            # alone; the small calls are the first rows of the largest, bit
            # for bit (above), which the rule holds.
            mean_err = (got - ref).abs().mean().item()
            gap = (ref - ref32).abs().mean().item()
            gated = n >= 1001
            print(f'{tag}: mean|kernel - plain bf16| {mean_err:.3e}, '
                  f'mean|plain bf16 - plain f32| {gap:.3e} (share '
                  f'{mean_err / gap:.4f}; '
                  + (f'tol {BF16_MEAN_SHARE})' if gated else
                     f'{n} graphs: printed, the N={n_main} call holds '
                     f'them)'), flush=True)
            if gated:
                require(mean_err <= BF16_MEAN_SHARE * gap,
                        f'{tag}: mean error {mean_err} not below '
                        f'{BF16_MEAN_SHARE} x the gap {gap}')
            if n == n_main:
                entry['max_abs_err'] = max(entry['max_abs_err'], err)


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
    from a2m_torch.utils.edge_probe import stack_params

    f, heads, n_main = 64, 4, 128 * 64
    gen = torch.Generator().manual_seed(3)
    adj = {10: constants.adjacency_from_edges(constants.body_edges(), 10),
           42: constants.adjacency_from_edges(constants.hand_edges(), 42)}
    fwd = dict(ms=0.0, plain_ms=0.0, flops=0, bytes=0, max_abs_err=0.0)
    bwd = dict(ms=0.0, plain_ms=0.0, flops=0, bytes=0, max_abs_err=0.0)
    hgmma = hgmma_count('gcn_stack_bwd')
    print(f'gcn_stack_bwd: {hgmma} HGMMA instructions in the built '
          f'library\'s SASS', flush=True)
    require(hgmma > 0, 'gcn_stack_bwd: no HGMMA in the built library')
    for j in (10, 42):
        params = stack_params(f, heads, gen).cuda()
        a = torch.as_tensor(adj[j]).cuda()
        routing = gk.edge_routing(a)
        plan = gk.dense_bwd_tc_plan(j, f, heads, routing['slots'],
                                    routing['out_slots'])
        info = gk.dense_bwd_tc_info(plan['smem_bytes'])
        print(f'gcn_stack_bwd J={j}: bf16 mode (tensor cores): '
              f'{plan["graphs"]} graphs a tile, {plan["rows"]} rows padded '
              f'to {plan["padded_rows"]}, {plan["slots"]} slots a row, '
              f'{plan["smem_bytes"]} B shared, {info["blocks_per_sm"]} block '
              f'an SM of {info["threads"]} threads, {info["registers"]} '
              f'registers, {info["local_bytes"]} B local (spills)',
              flush=True)
        main = {}                          # the N = 8192 call, both modes
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
                if n == n_main:
                    main[precise] = (x, xs_ref, g, dx)
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
        # K4 at N in {1, T - 1, T + 1}: the first graphs of the N = 8192
        # input, their dx its first rows bit for bit (a graph's rows depend
        # on its graph alone); their parameter gradients are printed (the
        # N = 8192 call holds these graphs to the tolerances)
        for k in sorted({1, plan['graphs'] - 1, plan['graphs'] + 1} - {0}):
            for precise in (True, False):
                tag = f'J={j} N={k} precise={precise}'
                x, xs_ref, g, dx_main = main[precise]
                args = (x[:k], xs_ref[:, :k], g[:k], params, a, heads)
                dx, dp = gk.gcn_stack_bwd(*args, precise=precise)
                dx2, dp2 = gk.gcn_stack_bwd(*args, precise=precise)
                dp_ref = gk.gcn_stack_bwd_plain(*args, precise=precise)[1]
                torch.cuda.synchronize()
                require(bool(torch.isfinite(dx).all()
                             and torch.isfinite(dp).all()),
                        f'gcn_stack_bwd {tag}: non-finite output')
                require(bool(torch.equal(dx, dx2) and torch.equal(dp, dp2)),
                        f'gcn_stack_bwd {tag}: two runs on the same input '
                        f'differ')
                require(bool(torch.equal(dx, dx_main[:k])),
                        f'gcn_stack_bwd {tag}: dx differs from the first {k} '
                        f'graphs of the N={n_main} call')
                err, scale = rel_err(dp, dp_ref)
                print(f'gcn_stack_bwd {tag}: bit-equal over two runs and dx '
                      f'to the first {k} graphs of N={n_main}; parameter '
                      f'gradients max_abs_err {err:.3e} (max|ref| '
                      f'{scale:.3f}; printed)', flush=True)
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


def mel_plain_args(spec, n_frames: int, exact: bool = False) -> tuple:
    """The plain version's arguments after the waveform, on the card: the
    window-folded DFT matrices and the dense mel matrix, f32 or (exact)
    float64."""
    import torch
    from a2m_torch.audio import frontend
    m = frontend.dft_matrices(spec, exact)
    dr, di, mel = (torch.from_numpy(m[k]).cuda() for k in ('dr', 'di',
                                                          'mel'))
    pad = spec.n_fft // 2 if spec.center else 0
    return (dr, di, mel, spec.hop_length, pad, n_frames, spec.log_const,
            spec.power, spec.log_mode)


def check_mel(tag: str, y, spec, n_frames: int, got):
    """K2's output against its plain version (1e-4), its shape, finite
    values, and a second launch on the same input bit-equal to it; returns
    (max_abs_err, plain output in f32).

    The plain version is evaluated in float64 on the same f32 samples and
    tables for the gate: the kernel (an FFT) and the plain version in f32
    (a direct DFT through cuBLAS) are two f32 algorithms, and on a frame
    whose mel power lies far below the rest each one's rounding alone can
    come near 1e-4.  The f32 plain version's own distance from the float64
    one and the kernel's from it are printed beside the gate."""
    import torch
    from a2m_torch.audio import frontend, mel_kernel
    args = mel_plain_args(spec, n_frames)
    ref = mel_kernel.log_mel_plain(y, *args)
    ref64 = mel_kernel.log_mel_plain(
        y.double(), *(a.double() if torch.is_tensor(a) else a for a in args))
    again = frontend.log_mel(y, spec, False, n_frames)
    torch.cuda.synchronize()
    err = (got.double() - ref64).abs().max().item()
    err32 = (got - ref).abs().max().item()
    plain_err = (ref.double() - ref64).abs().max().item()
    same = torch.equal(got, again)
    print(f'{tag}: max_abs_err={err:.3e} (tol 1e-4, vs the plain version '
          f'in float64; vs it in f32 {err32:.3e}, which is itself '
          f'{plain_err:.3e} from float64), rerun bit-equal: {same}',
          flush=True)
    require(tuple(got.shape) == (y.shape[0], n_frames, spec.n_mels)
            and bool(torch.isfinite(got).all()),
            f'{tag}: shape {tuple(got.shape)} or non-finite values')
    require(err <= 1e-4, f'{tag}: {err} > 1e-4')
    require(same, f'{tag}: two launches on one input differ')
    return err, ref


def time_mel(tag: str, y, spec, n_frames: int, ref) -> dict:
    """K2, its plain version and the ``torch.stft`` route (the yardstick,
    never called by the port) timed on one input, beside the function's
    bound (log_mel_512 specs: a full-frame window, power, eps log)."""
    import torch
    from a2m_torch.audio import frontend, mel_kernel
    args = mel_plain_args(spec, n_frames)
    tables = frontend.mel_tables(spec, y.device)
    window = torch.hann_window(spec.n_fft, periodic=True, device='cuda')
    mel = args[2]

    def library():
        s = torch.stft(y, spec.n_fft, hop_length=spec.hop_length,
                       window=window, center=True, pad_mode='reflect',
                       return_complex=True)
        p = (s.real ** 2 + s.imag ** 2).transpose(1, 2)[:, :n_frames]
        return torch.log(torch.clamp_min(p @ mel, spec.log_const))

    lib_err = (library() - ref).abs().max().item()
    ms = cuda_ms(lambda: frontend.log_mel(y, spec, False, n_frames),
                 iters=50)
    plain = cuda_ms(lambda: mel_kernel.log_mel_plain(y, *args), iters=20)
    lib_ms = cuda_ms(library, iters=50)
    batch, n_fft = y.shape[0], spec.n_fft
    nnz = tables.mel_weights.numel()
    flops = mel_kernel.log_mel_flops(batch, n_frames, n_fft, nnz,
                                     spec.n_mels)
    run = mel_kernel.fft_kernel_flops(batch, n_frames, n_fft, nnz,
                                      spec.n_mels)
    nbytes = mel_kernel.log_mel_bytes(batch, y.shape[1], n_frames,
                                      tables.frame_len, spec.hop_length,
                                      n_fft, nnz, spec.n_mels)
    b_ms, b_by = bound(flops, nbytes, PEAK_FP32)
    print(f'{tag}: kernel_ms={ms:.4f} plain_ms={plain:.4f} '
          f'library_ms={lib_ms:.4f} (torch.stft route, max_abs_err vs plain '
          f'{lib_err:.3e}) bound_ms={b_ms:.4f} ({b_by}; {flops / 1e9:.3f} '
          f'GFLOP by real FFT and the mel over its {nnz} nonzeros, '
          f'{nbytes / 1e6:.1f} MB); the kernel runs {run / 1e9:.3f} GFLOP '
          f'(complex FFT of n_fft/2 points and the split)', flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def log_mel_phase() -> dict:
    """K2 at the one-window shapes: B = 128 and B = 1, 64 frames each."""
    import torch
    from a2m_torch.audio import frontend
    from a2m_torch.pipeline import CLIP_SECONDS, SR, pose_rate_spec

    spec = pose_rate_spec()
    n_frames = 64
    gen = torch.Generator().manual_seed(1)
    y = (torch.randn(128, int(SR * CLIP_SECONDS), generator=gen)
         * 0.1).cuda()
    out = {}
    for batch in (128, 1):
        tag = f'log_mel B={batch} T={n_frames}'
        got = frontend.log_mel(y[:batch], spec, False, n_frames)
        err, ref = check_mel(tag, y[:batch], spec, n_frames, got)
        if batch == 128:
            out = dict(max_abs_err=err,
                       **time_mel(tag, y, spec, n_frames, ref))
    return out


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


def hgmma_count(name: str) -> int:
    """HGMMA (wgmma) instructions in the SASS of a built kernel library."""
    from a2m_torch import _build
    tool = Path(_build._nvcc()).with_name('cuobjdump')
    out = subprocess.run([str(tool), '-sass', str(_build.library_path(name))],
                         capture_output=True, text=True, timeout=300)
    require(out.returncode == 0, f'cuobjdump failed: {out.stderr[-2000:]}')
    return sum('HGMMA' in line for line in out.stdout.splitlines())


def edge_phase() -> dict:
    """K5 against its plain version and against K1; returns its entry of
    the kernels line."""
    import torch
    from a2m_torch import constants
    from a2m_torch.nn import gcn_kernel as gk
    from a2m_torch.utils.edge_probe import stack_params

    f, heads, n_main = 64, 4, SERVE_STREAMS * SERVE_WINDOWS * 64
    gen = torch.Generator().manual_seed(6)
    adj = {10: constants.adjacency_from_edges(constants.body_edges(), 10),
           42: constants.adjacency_from_edges(constants.hand_edges(), 42)}
    entry = dict(ms=0.0, plain_ms=0.0, flops=0, bytes=0, max_abs_err=0.0)
    k1_ms = 0.0
    hgmma = hgmma_count('gcn_stack_edge')
    print(f'gcn_stack_edge: {hgmma} HGMMA instructions in the built '
          f'library\'s SASS', flush=True)
    require(hgmma > 0, 'gcn_stack_edge: no HGMMA in the built library')
    for j in (10, 42):
        params = stack_params(f, heads, gen).cuda()
        a = torch.as_tensor(adj[j]).cuda()
        routing = gk.edge_routing(a)
        plan = gk.edge_tc_plan(j, f, heads, routing['edges'],
                               routing['conv_edges'])
        info = gk.edge_tc_info(plan['smem_bytes'])
        print(f'gcn_stack_edge J={j}: {routing["edges"]} edges; bf16 mode '
              f'(tensor cores): {plan["graphs"]} graphs a tile, '
              f'{plan["rows"]} rows padded to {plan["padded_rows"]}, '
              f'{plan["smem_bytes"]} B shared, {info["blocks_per_sm"]} '
              f'block an SM of {info["threads"]} threads, '
              f'{info["registers"]} registers, {info["local_bytes"]} B local '
              f'(spills); f32 mode (CUDA cores): {gk.edge_tile(a, f)} graphs '
              f'a block', flush=True)
        # N = 1001 and N in {1, T - 1, T + 1}: the first graphs of N = 13,824
        x_main = torch.randn(n_main, j, f, generator=gen).cuda()
        small = sorted({1, plan['graphs'] - 1, plan['graphs'] + 1} - {0})

        def against_k1(tag, x, got):
            # with f32 operands the edge form and the dense kernel compute
            # one function up to summation order
            err_k1 = (got - gk.gcn_stack(x, params, a, heads,
                                         precise=True)).abs().max().item()
            print(f'{tag}: max|K5 - K1|={err_k1:.3e} (tol 2e-5)', flush=True)
            require(err_k1 <= 2e-5, f'{tag}: differs from gcn_stack by '
                    f'{err_k1}')

        hold_to_plain('gcn_stack_edge', gk.gcn_stack_edge,
                      gk.gcn_stack_edge_plain, x_main, params, a, heads,
                      (n_main, 1001, *small), entry, also=against_k1)
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
    from a2m_torch.audio import frontend
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
        frame_len = frontend.dft_matrices(spec)['frame_len']
        t = frontend.num_frames(spec, y.shape[1])
        tag = (f'log_mel {method} sr={sr} hop={spec.hop_length} frame_len='
               f'{frame_len} B={batch} T={t} mels={spec.n_mels}')
        got = frontend.log_mel(y, spec, exact=False)
        err, ref = check_mel(tag, y, spec, t, got)
        if not pose_rate:
            continue
        # the framed entry: the client's frames, the same kernel
        framed = torch.from_numpy(frontend.frame_for_wire(
            y.cpu().numpy(), spec)).cuda()
        require(tuple(framed.shape) == (batch, t, frame_len),
                f'{tag}: framed {tuple(framed.shape)}')
        same = torch.equal(
            frontend.log_mel_frames(framed, spec, exact=False), got)
        print(f'{tag}: framed entry bit-equal to the waveform entry: {same}',
              flush=True)
        require(same, f'{tag}: framed entry differs from the waveform entry')
        if method == 'log_mel_512' and batch == SERVE_STREAMS:
            out = dict(batch=batch, n_frames=t, max_abs_err=err,
                       **time_mel(tag, y, spec, t, ref))
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
    mel_kernel.log_mel.exact_launches = 0
    poses = serve(waves)
    launches = {'log_mel': mel_kernel.log_mel.launches,
                'log_mel_exact': mel_kernel.log_mel.exact_launches,
                **stack_launches()}
    print(f'serve: launches in one fused call of {SERVE_STREAMS} x '
          f'{SERVE_SECONDS} s {launches}', flush=True)
    require(launches == {'log_mel': 1, 'log_mel_exact': 0,
                         'gcn_stack_edge': 2, 'gcn_stack': 0,
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
    mel_kernel.log_mel.exact_launches = 0
    pose = audio_to_pose(wave)
    torch.cuda.synchronize()
    launches = {'gcn_stack': gcn_kernel.gcn_stack.launches,
                'log_mel': mel_kernel.log_mel.launches,
                'log_mel_exact': mel_kernel.log_mel.exact_launches}
    print(f'slice: launches in one call {launches}', flush=True)
    require(launches == {'gcn_stack': 2, 'log_mel': 1, 'log_mel_exact': 0},
            f'main path launches {launches}, expected gcn_stack 2, log_mel '
            f'1, log_mel_exact 0')
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
    mel = frontend.log_mel(wave2, pose_rate_spec(), exact=False,
                           n_frames=64)
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


def check_exact(tag: str, y, spec, got, golden=None) -> float:
    """K2x's output against its plain version evaluated in float64
    (EXACT_TOL), its shape, finite values and a second launch bit-equal to
    it; ``golden(y0)`` (the float64 ``mel_np`` reference of row 0, as
    (T, n_mels)) is printed beside the gate.  Returns the max abs error."""
    import numpy as np
    import torch
    from a2m_torch.audio import frontend, mel_kernel
    t = got.shape[1]
    ref = mel_kernel.log_mel_plain(y.double(),
                                   *mel_plain_args(spec, t, exact=True))
    again = frontend.log_mel(y, spec, True, t)
    torch.cuda.synchronize()
    err = (got.double() - ref).abs().max().item()
    same = torch.equal(got, again)
    gold = ''
    if golden is not None:
        # within 120 dB of the peak mel, as a2m's tonal test holds it
        # (tests/test_audio_frontend.py:129-140): below that the golden's
        # log of a power that only rounding left (not clamped unless it is
        # exactly 0) has no meaning
        g = golden(y[0].double().cpu().numpy())
        live = np.exp(g) > 1e-6 * np.exp(g).max()
        gold = (f', row 0 vs the float64 mel_np golden '
                f'{abs(got[0].double().cpu().numpy() - g)[live].max():.3e} '
                f'over the {live.mean():.1%} of its mels within 120 dB of '
                f'the peak')
    print(f'{tag}: K2x max_abs_err={err:.3e} (tol {EXACT_TOL:g}, vs the '
          f'plain version in float64){gold}, rerun bit-equal: {same}',
          flush=True)
    require(tuple(got.shape) == (y.shape[0], t, spec.n_mels)
            and got.dtype == torch.float32
            and bool(torch.isfinite(got).all()),
            f'{tag}: shape {tuple(got.shape)} or non-finite values')
    require(err <= EXACT_TOL, f'{tag}: K2x {err} > {EXACT_TOL}')
    require(same, f'{tag}: two K2x launches on one input differ')
    return err


def time_mel_exact(tag: str, y, spec) -> dict:
    """K2x, its plain version (the direct DFT in float64) and the float64
    ``torch.stft`` route (the yardstick, never called by the port) timed on
    one input, beside the function's bound at the fp64 rate."""
    import torch
    from a2m_torch.audio import frontend, mel_kernel
    t = frontend.num_frames(spec, y.shape[1])
    args = mel_plain_args(spec, t, exact=True)
    tables = frontend.mel_tables(spec, y.device, True)
    window = torch.hann_window(spec.n_fft, periodic=True,
                               dtype=torch.float64, device='cuda')
    mel = args[2]

    def library():
        s = torch.stft(y.double(), spec.n_fft, hop_length=spec.hop_length,
                       window=window, center=True, pad_mode='reflect',
                       return_complex=True)
        p = (s.real ** 2 + s.imag ** 2).transpose(1, 2)[:, :t]
        return torch.log(torch.clamp_min(p @ mel, spec.log_const)).float()

    got = frontend.log_mel(y, spec, True, t)
    lib_err = (library() - got).abs().max().item()
    ms = cuda_ms(lambda: frontend.log_mel(y, spec, True, t), iters=10)
    plain = cuda_ms(lambda: mel_kernel.log_mel_plain(y.double(), *args),
                    iters=3, warmup=1)
    lib_ms = cuda_ms(library, iters=5, warmup=1)
    batch, n_fft = y.shape[0], spec.n_fft
    nnz = tables.mel_weights.numel()
    flops = mel_kernel.log_mel_flops(batch, t, n_fft, nnz, spec.n_mels)
    nbytes = mel_kernel.log_mel_bytes(batch, y.shape[1], t,
                                      tables.frame_len, spec.hop_length,
                                      n_fft, nnz, spec.n_mels, table_bytes=8)
    b_ms, b_by = bound(flops, nbytes, PEAK_FP64)
    floor_ms = flops / FP64_PIPES * 1e3
    print(f'{tag}: K2x kernel_ms={ms:.4f} plain_ms={plain:.4f} '
          f'library_ms={lib_ms:.4f} (float64 torch.stft route, max_abs_err '
          f'vs K2x {lib_err:.3e}) bound_ms={b_ms:.4f} ({b_by}; '
          f'{flops / 1e9:.3f} GFLOP by real FFT and the mel over its {nnz} '
          f'nonzeros at fp64 {PEAK_FP64 / 1e12:g} TFLOP/s, '
          f'{nbytes / 1e6:.1f} MB); at the {FP64_PIPES / 1e12:g} TFLOP/s of '
          f'the fp64 pipes an FFT runs on: {floor_ms:.4f} ms; '
          f'{ms / b_ms:.1f}x the bound', flush=True)
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, fp64_pipes_floor_ms=floor_ms, batch=batch,
                n_frames=t)


def k2x_plan(spec) -> dict:
    """K2x's launch plan at ``spec``, from the kernel's own entry."""
    from a2m_torch.audio import frontend, mel_kernel
    t = frontend.fft_tables(spec, exact=True)
    plan = mel_kernel.exact_launch(spec.n_fft, spec.n_mels,
                                   t['sched_weights'].shape[0],
                                   t['frame_len'], spec.hop_length)
    require(plan['blocks_per_sm'] >= 1 and plan['frames_a_block'] >= 1,
            f'K2x plan {plan}')
    return plan


def exact_kernel_cases() -> dict:
    """K2x against its plain version at the data path's shapes and on a
    tonal clip (K2's distance there beside it), and K2 and K2x on waveforms
    shorter than the centred pad."""
    import torch
    from a2m_torch.audio import frontend, mel_kernel, mel_np
    from a2m_torch.pipeline import SR, pose_rate_spec

    gen = torch.Generator().manual_seed(9)
    spec512, spec400 = frontend.spec_log_mel_512(SR), \
        frontend.spec_log_mel_400()
    golden512 = lambda y0: mel_np.log_mel_512(y0, SR)  # noqa: E731
    golden400 = lambda y0: mel_np.log_mel_400(y0, 16000)  # noqa: E731
    plans = {name: k2x_plan(spec) for name, spec in (
        ('log_mel_512', spec512), ('log_mel_400', spec400))}
    for name, plan in plans.items():
        print(f'K2x plan at {name}: ' + ' '.join(
            f'{k}={v}' for k, v in plan.items()), flush=True)
    errs = []
    y = (torch.randn(32, SR * DATA_SECONDS, generator=gen) * 0.1).cuda()
    tag = f'log_mel_512 B=1 {DATA_SECONDS} s'
    one = frontend.log_mel(y[:1], spec512, True)
    errs.append(check_exact(tag, y[:1], spec512, one, golden512))
    tag = f'log_mel_512 B=32 {DATA_SECONDS} s'
    got = frontend.log_mel(y, spec512, True)
    errs.append(check_exact(tag, y, spec512, got, golden512))
    same = torch.equal(one[0], got[0])
    print(f'{tag}: row 0 bit-equal to the B=1 call: {same}', flush=True)
    require(same, 'K2x: row 0 of B=32 differs from B=1')
    timed = time_mel_exact(tag, y, spec512)
    del y, got, one
    # a2m's tonal clip (tests/test_audio_frontend.py:129-140) at four
    # pitches: most of its mels lie far below the peak, where an f32 FFT
    # misses 1e-5, so K2's distance on the same input shows that the gate
    # tells K2x from an f32 kernel
    t = torch.arange(SR * DATA_SECONDS, dtype=torch.float64) / SR
    env = 1 + 0.5 * torch.sin(2 * torch.pi * 3 * t)
    tones = torch.stack([0.3 * torch.sin(2 * torch.pi * f * t) * env
                         for f in (220, 440, 880, 1760)]).float().cuda()
    tag = f'log_mel_512 tonal B=4 {DATA_SECONDS} s'
    got = frontend.log_mel(tones, spec512, True)
    errs.append(check_exact(tag, tones, spec512, got, golden512))
    ref = mel_kernel.log_mel_plain(
        tones.double(), *mel_plain_args(spec512, got.shape[1], exact=True))
    fast = frontend.log_mel(tones, spec512, False)
    tonal_k2 = (fast.double() - ref).abs().max().item()
    print(f'{tag}: K2 (f32) on the same input max_abs_err={tonal_k2:.3e} '
          f'vs the same float64 plain version (K2x {errs[-1]:.3e}, tol '
          f'{EXACT_TOL:g})', flush=True)
    del tones, got, ref, fast
    y16 = (torch.randn(1, 16000 * DATA_SECONDS, generator=gen) * 0.1).cuda()
    got = frontend.log_mel(y16, spec400, True)
    errs.append(check_exact(f'log_mel_400 B=1 {DATA_SECONDS} s', y16,
                            spec400, got, golden400))
    # VGGish: frames of 400 in 512, htk mels, offset log; its framed entry
    # gives the waveform's bits
    vggish = frontend.spec_vggish()
    tag = f'vggish B=1 {DATA_SECONDS} s'
    got = frontend.log_mel(y16, vggish, True)
    errs.append(check_exact(
        tag, y16, vggish, got,
        lambda y0: mel_np.vggish_log_mel(y0, 16000)))
    framed = torch.from_numpy(frontend.frame_for_wire(
        y16.cpu().numpy(), vggish)).cuda()
    same = torch.equal(frontend.log_mel_frames(framed, vggish, True), got)
    print(f'{tag}: framed entry bit-equal to the waveform: {same}',
          flush=True)
    require(same, 'K2x: VGGish framed entry differs from the waveform')
    # shorter than the centred pad (1024 samples): the reflection folds
    short_fast = []
    for n in (1, 2, 500, 1024):
        y = (torch.randn(2, n, generator=gen) * 0.1).cuda()
        for name, spec in (('log_mel_512', spec512),
                           ('pose-rate', pose_rate_spec())):
            stride = spec.hop_length // 512
            tag = f'{name} n={n}'
            got = frontend.log_mel(y, spec, True)
            errs.append(check_exact(
                tag, y, spec, got,
                lambda y0: mel_np.log_mel_512(y0, SR)[::stride]))
            got = frontend.log_mel(y, spec, False)
            short_fast.append(check_mel(f'{tag} K2', y, spec, got.shape[1],
                                        got)[0])
    return dict(max_abs_err=max(errs), short_k2_max_abs_err=max(short_fast),
                tonal_k2_max_abs_err=tonal_k2, plans=plans, **timed)


def extraction_phase() -> tuple[list, dict]:
    """``wav_to_features`` on DATA_INTERVALS seeded wav files of
    DATA_SECONDS at 45.6 kHz (log-mel 512) and on two of them (log-mel 400,
    kaiser_best resample to 16 kHz), with the counts set to 0: K2x once per
    call, K2 never; each result against the plain version in float64."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from a2m_torch.audio import frontend, mel_kernel
    from a2m_torch.audio import io as audio_io
    from a2m_torch.pipeline import SR

    rng = np.random.default_rng(10)
    n = SR * DATA_SECONDS
    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp, \
            ThreadPoolExecutor(2) as pool:
        paths = [Path(tmp) / f'interval{i:02d}.wav'
                 for i in range(DATA_INTERVALS)]
        for path in paths:
            audio_io.save_wav(path, rng.standard_normal(n) * 0.1, SR)

        def at_16k(path):                  # the log-mel 400 check's input
            y, sr = audio_io.load_wav(path)
            return audio_io.resample(y, sr, 16000).astype(np.float32)

        y16_jobs = [pool.submit(at_16k, path) for path in paths[:2]]
        mel_kernel.log_mel.launches = 0
        mel_kernel.log_mel.exact_launches = 0
        t0 = time.perf_counter()
        feats = [audio_io.wav_to_features(path, 'log_mel_512',
                                          device='cuda') for path in paths]
        s512 = time.perf_counter() - t0
        t0 = time.perf_counter()
        feats400 = [audio_io.wav_to_features(path, 'log_mel_400',
                                             device='cuda')
                    for path in paths[:2]]
        s400 = time.perf_counter() - t0
        launches = {'log_mel': mel_kernel.log_mel.launches,
                    'log_mel_exact': mel_kernel.log_mel.exact_launches}
        print(f'data: wav_to_features launches {launches}; log_mel_512 '
              f'{s512 / DATA_INTERVALS * 1e3:.1f} ms per {DATA_SECONDS} s '
              f'file, log_mel_400 {s400 / 2 * 1e3:.1f} ms (kaiser_best '
              f'resample on the host included), host clock', flush=True)
        require(launches == {'log_mel': 0,
                             'log_mel_exact': DATA_INTERVALS + 2},
                f'extraction launches {launches}, expected log_mel_exact '
                f'{DATA_INTERVALS + 2} and log_mel 0')
        errs = []
        for spec, got, ys in (
                (frontend.spec_log_mel_512(SR), feats,
                 [audio_io.load_wav(p)[0].astype(np.float32)
                  for p in paths]),
                (frontend.spec_log_mel_400(), feats400,
                 [job.result() for job in y16_jobs])):
            for f, y in zip(got, ys):
                t = frontend.num_frames(spec, y.shape[-1])
                ref = mel_kernel.log_mel_plain(
                    torch.from_numpy(y)[None].cuda().double(),
                    *mel_plain_args(spec, t, exact=True))[0].cpu().numpy()
                require(f.shape == ref.shape and f.dtype == np.float32
                        and np.isfinite(f).all(),
                        f'features {f.shape} {f.dtype} or non-finite')
                errs.append(float(np.abs(f - ref).max()))
    print(f'data: features vs the plain version in float64: max_abs_err '
          f'{max(errs):.3e} over {len(errs)} files (tol {EXACT_TOL:g})',
          flush=True)
    require(max(errs) <= EXACT_TOL, f'extracted features {max(errs)}')
    return feats, dict(launches=launches, max_abs_err=max(errs),
                       ms_per_file_512=s512 / DATA_INTERVALS * 1e3,
                       ms_per_file_400=s400 / 2 * 1e3)


def data_train_phase(feats: list) -> dict:
    """The extracted features, paired with synthetic pose tracks and cut
    into windows as the data loader cuts them, as a ``Batcher`` into
    ``build_trainer(loader=...)``: one epoch of 4 batches, a validation on
    2, the launch counts, and ms per batch with and without prefetch."""
    import dataclasses
    from types import SimpleNamespace

    import numpy as np
    import torch
    from a2m_torch.audio import mel_kernel
    from a2m_torch.constants import AUDIO_FS_MAP, POSE_FPS
    from a2m_torch.data.dataset import Batcher, RandomSampler
    from a2m_torch.data.synthetic import synth_pose
    from a2m_torch.data.windowing import window_index
    from a2m_torch.pipeline import build_trainer

    rng = np.random.default_rng(11)
    fs = AUDIO_FS_MAP['log_mel_512']
    items = []
    for f in feats:
        pose = synth_pose(POSE_FPS * DATA_SECONDS, rng).astype(np.float32)
        wa = window_index(len(f), fs, 15, 4.3, window_hop=5)
        wp = window_index(len(pose), POSE_FPS, 15, 4.3, window_hop=5)
        items.append([{'audio/log_mel_512': wa.slice(f, k),
                       'pose/data': wp.slice(pose, k),
                       'style': np.zeros(wp.out_len, np.float32)}
                      for k in range(min(len(wa), len(wp)))])
    train = [it for interval in items[:-2] for it in interval]
    dev = [it for interval in items[-2:] for it in interval]
    loader = SimpleNamespace(
        train=Batcher(train, 128, sampler=RandomSampler(len(train), seed=0),
                      max_batches=4),
        dev=Batcher(dev, 128, max_batches=2))
    t0 = time.perf_counter()
    trainer = build_trainer(batch=128, loader=loader, log=lambda line: print(
        f'data: {line}', flush=True))
    print(f'data: build_trainer(loader=...) over {len(train)} train and '
          f'{len(dev)} dev windows {time.perf_counter() - t0:.2f} s '
          f'(moments of the train set included)', flush=True)
    require(trainer._style_ids(next(iter(loader.dev))) is None,
            'style ids under the flagship config')
    require(bool(torch.isfinite(trainer.mean).all()
                 and (trainer.std > 0).all()), 'pose moments')

    def run(epoch: int, depth: int) -> tuple[dict, float, tuple]:
        trainer.cfg = dataclasses.replace(trainer.cfg,
                                          prefetch_batches=depth)
        reset_stack_launches()
        mel_kernel.log_mel.launches = 0
        mel_kernel.log_mel.exact_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = trainer.train_epoch(epoch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / len(loader.train) * 1e3
        counts = {'log_mel': mel_kernel.log_mel.launches,
                  'log_mel_exact': mel_kernel.log_mel.exact_launches,
                  **stack_launches()}
        return counts, ms, losses

    counts, ms2, (last_g, last_d) = run(0, 2)
    reset_stack_launches()
    val = trainer.validate()
    val_counts = stack_launches()
    g_steps = counts['gcn_stack_fwd'] // 2
    print(f'data: train_epoch(0) over {len(loader.train)} batches, launches '
          f'{counts}, last g_loss {last_g:.4f} d_loss {last_d:.4f}; '
          f'validate launches {val_counts} ' + ' '.join(
              f'{k}={v:.4f}' for k, v in val.items()), flush=True)
    require(g_steps == 3 * len(loader.train)
            and counts['gcn_stack_bwd'] == counts['gcn_stack_fwd'],
            f'epoch launches {counts}: expected K3 and K4 x2 per G step, 3 '
            f'G steps a batch')
    require(0 < counts['gcn_stack'] <= 2 * len(loader.train)
            and counts['gcn_stack'] % 2 == 0,
            f'epoch launches {counts}: expected K1 x2 per D step')
    require(counts['log_mel'] == counts['log_mel_exact'] == 0
            and counts['gcn_stack_edge'] == 0,
            f'epoch launches {counts}: no log-mel or K5 launch expected')
    require(val_counts['gcn_stack'] == 2 * len(loader.dev)
            and val_counts['gcn_stack_fwd'] == 0,
            f'validate launches {val_counts}: expected K1 x2 per batch')
    for v in (last_g, last_d, *val.values()):
        require(v == v and abs(v) != float('inf'), 'data: non-finite loss')
    ms_per_batch = {}
    for epoch, depth in ((1, 0), (2, 2), (3, 0), (4, 2)):
        c, ms, _ = run(epoch, depth)
        ms_per_batch[f'epoch{epoch}_prefetch{depth}'] = ms
        ms_per_batch[f'epoch{epoch}_g_steps'] = c['gcn_stack_fwd'] // 2
        ms_per_batch[f'epoch{epoch}_d_steps'] = c['gcn_stack'] // 2
    # what the prefetch can hide at most: drawing a batch from the Batcher
    # and staging it on the card, alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in loader.train:
        trainer._stage(batch)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) / len(loader.train) * 1e3
    print('data: ms per batch (host clock, synchronised at the epoch\'s '
          'ends) prefetch 2: ' f'{ms2:.2f} (epoch 0), then ' + ' '.join(
              f'{k}={v:.2f}' if isinstance(v, float) else f'{k}={v}'
              for k, v in ms_per_batch.items())
          + f'; drawing and staging one batch alone {stage_ms:.2f} ms',
          flush=True)
    return dict(launches=counts, validate_launches=val_counts,
                train_windows=len(train), dev_windows=len(dev),
                ms_per_batch_epoch0_prefetch2=ms2, **ms_per_batch,
                stage_ms_per_batch=stage_ms, validate=val)


def data_phase() -> dict:
    """Phase 10: K2x's cases, extraction through the entry points, training
    over the extracted features."""
    k2x = exact_kernel_cases()
    feats, extraction = extraction_phase()
    train = data_train_phase(feats)
    return dict(k2x=k2x, extraction=extraction, train=train)


def kernel_launches() -> dict:
    """Every kernel's launch count."""
    from a2m_torch.audio import mel_kernel
    return {'log_mel': mel_kernel.log_mel.launches,
            'log_mel_exact': mel_kernel.log_mel.exact_launches,
            **stack_launches()}


def reset_kernel_launches() -> None:
    from a2m_torch.audio import mel_kernel
    reset_stack_launches()
    mel_kernel.log_mel.launches = 0
    mel_kernel.log_mel.exact_launches = 0


def same_state(a, b) -> bool:
    """Two trainers' models (parameters and buffers) and Adam states
    bit-equal, wherever each keeps them (Adam's ``step`` counter lies on
    the CPU until a restore maps it to the card)."""
    import torch
    for x, y in ((a.g_state, b.g_state), (a.d_state, b.d_state)):
        sx, sy = x.model.state_dict(), y.model.state_dict()
        if sx.keys() != sy.keys() or not all(
                torch.equal(sx[k], sy[k]) for k in sx):
            return False
        ox, oy = x.optimizer.state_dict(), y.optimizer.state_dict()
        if ox['param_groups'] != oy['param_groups'] or not all(
                torch.equal(v.cpu(), oy['state'][i][k].cpu())
                for i in ox['state'] for k, v in ox['state'][i].items()):
            return False
    return True


def train_eval_phase() -> dict:
    """Phase 11: train, checkpoint, resume and evaluate through the user's
    entry points on the det fixture built in memory."""
    import tempfile

    import numpy as np
    import torch
    from a2m_torch.config import Config, GeneratorConfig, apply_overrides
    from a2m_torch.data.synthetic import synthetic_loader
    from a2m_torch.eval.harness import evaluate_speaker
    from a2m_torch.train import checkpoint as ckpt_lib
    from a2m_torch.train.__main__ import run
    from a2m_torch.train.loop import Trainer

    golden = json.loads((ROOT / 'a2m_torch' / 'testdata'
                         / 'harness_golden.json').read_text())
    recipe = golden['recipe']
    manifest = json.loads((ROOT / 'artifacts'
                           / 'flagship_manifest.json').read_text())
    flagship = ROOT / recipe['ckpt']
    n_train, n_dev, epochs = 4, 1, 2
    t0 = time.perf_counter()
    loader = synthetic_loader(
        **{k: recipe[k] for k in ('speakers', 'intervals_per_speaker',
                                  'duration_s', 'seed', 'deterministic',
                                  'splits')},
        batch_size=recipe['batch_size'], window_hop=recipe['window_hop'],
        max_batches={'train': n_train, 'dev': n_dev})
    n_test = sum(int(b['mask'].sum()) for b in loader.test)
    test_batches = len(loader.test)
    print(f'train_eval: det fixture in memory {time.perf_counter() - t0:.2f}'
          f' s: {len(loader.train.dataset)} train, {len(loader.dev.dataset)}'
          f' dev, {n_test} test windows ({test_batches} batches)', flush=True)
    require(n_test == golden['n_clips'] == 348, f'{n_test} test clips')

    stamps: list[tuple[float, str]] = []

    def log(line: str) -> None:
        stamps.append((time.perf_counter(), line))
        print(f'train_eval: {line}', flush=True)

    (ROOT / 'build').mkdir(exist_ok=True)
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:
        save_dir = Path(tmp) / 'run'
        cfg = apply_overrides(Config(), [
            f'train.save_dir={save_dir}', f'train.n_epochs={epochs}',
            'train.best_metric=val_pck', 'train.lambda_pos=1.0'])
        # ---- train --------------------------------------------------------
        reset_kernel_launches()
        t0 = time.perf_counter()
        trainer = run(cfg, loader, log=log)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = kernel_launches()
        g_steps = launches['gcn_stack_fwd'] // 2
        d_steps = launches['gcn_stack'] // 2 - n_dev * epochs
        print(f'train_eval: run() {run_s:.2f} s over {epochs} epochs of '
              f'{n_train} batches, launches {launches}: {g_steps} G steps, '
              f'{d_steps} D steps, {n_dev * epochs} dev batches', flush=True)
        require(g_steps == 3 * n_train * epochs
                and launches['gcn_stack_fwd'] == launches['gcn_stack_bwd']
                == 2 * g_steps, f'train launches {launches}: expected K3 and '
                f'K4 x2 per G step, 3 G steps a batch')
        require(launches['gcn_stack'] % 2 == 0
                and 0 < d_steps <= n_train * epochs,
                f'train launches {launches}: expected K1 x2 per D step and '
                f'per dev batch')
        require(launches['log_mel'] == launches['log_mel_exact']
                == launches['gcn_stack_edge'] == 0,
                f'train launches {launches}: no K2, K2x or K5 launch')
        ckpt = save_dir / 'ckpt'
        for name in ('best_gen.npz', 'epoch_0.pt', 'epoch_1.pt'):
            require((ckpt / name).is_file(), f'{name} not written')
        require((save_dir / 'loss.npy').is_file(), 'loss.npy not written')
        history = ckpt_lib.load_loss_history(save_dir / 'loss.npy')
        require(history == trainer.loss_history, 'loss.npy')
        mfu = trainer.mfu_report
        require(any('MFU' in line for _, line in stamps), 'no MFU line')
        for name in ('g_step', 'd_step'):
            m = mfu.get(name, {}).get('mfu')
            require(m is not None and 0 < m < 1 and m == m,
                    f'{name} MFU {mfu.get(name)}')
        val_t = [t for t, line in stamps if line.startswith('[Validation]')]
        require(len(val_t) == epochs, f'{len(val_t)} validations')
        # ---- checkpoint write and restore, timed --------------------------
        timing = ckpt_lib.CheckpointManager(Path(tmp) / 'timing',
                                            max_to_keep=1)
        write_ms, restore_ms = [], []
        for epoch in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = timing.save(epoch, trainer.g_state, trainer.d_state,
                               trainer.controller.state_dict(), trainer.mean,
                               trainer.std, extra=dict(
                                   loss_history=trainer.loss_history))
            write_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            timing.restore(trainer.g_state, trainer.d_state)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        best = timing.save_best_generator(trainer.g_state.model,
                                          trainer.mean, trainer.std)
        best_ms = (time.perf_counter() - t0) * 1e3
        ckpt_mb = path.stat().st_size / 1e6
        print(f'train_eval: checkpoint {ckpt_mb:.1f} MB write ms '
              f'{[round(v, 1) for v in write_ms]}, restore ms '
              f'{[round(v, 1) for v in restore_ms]}; best_gen.npz '
              f'{best.stat().st_size / 1e6:.1f} MB {best_ms:.1f} ms '
              f'(host clock)', flush=True)
        # ---- resume ---------------------------------------------------------
        resumed = Trainer.from_config(cfg, loader, log=log)
        require(resumed.start_epoch == epochs,
                f'resumed at epoch {resumed.start_epoch}')
        require(same_state(trainer, resumed),
                'resumed state not bit-equal to the saved one')
        require(resumed.controller.state_dict()
                == trainer.controller.state_dict(), 'resumed controller')
        require(torch.equal(resumed.mean, trainer.mean)
                and torch.equal(resumed.std, trainer.std), 'resumed stats')
        del trainer
        reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed.fit(epochs + 1)
        torch.cuda.synchronize()
        resumed_ms = (time.perf_counter() - t0) * 1e3
        resumed_launches = kernel_launches()
        require(resumed.ckpt.epochs() == [0, 1, 2],
                f'checkpoints {resumed.ckpt.epochs()}')
        require(len(resumed.loss_history['val_g']) == epochs + 1,
                'resumed history')
        require(resumed_launches['gcn_stack_fwd']
                == resumed_launches['gcn_stack_bwd'] > 0,
                f'resumed epoch launches {resumed_launches}')
        epoch_ms = [(val_t[1] - val_t[0]) * 1e3, resumed_ms]
        print(f'train_eval: resumed at epoch {epochs}, bit-equal; one epoch '
              f'{resumed_ms:.1f} ms, launches {resumed_launches}', flush=True)
        del resumed
        # ---- evaluate -------------------------------------------------------
        evals = {}
        for tag, path, precise in (('flagship_f32', flagship, True),
                                   ('flagship_bf16', flagship, False),
                                   ('flagship_bf16_again', flagship, False),
                                   ('short_run', ckpt / 'best_gen.npz',
                                    False)):
            cfg_e = Config(generator=GeneratorConfig(fused_precise=precise))
            reset_kernel_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = evaluate_speaker(None, recipe['speaker'], path,
                                   batch_size=recipe['batch_size'],
                                   alpha=tuple(recipe['alpha']), cfg=cfg_e,
                                   device='cuda', loader=loader)
            torch.cuda.synchronize()
            res['wall_ms'] = (time.perf_counter() - t0) * 1e3
            res['launches'] = kernel_launches()
            evals[tag] = res
            print(f'train_eval: evaluate_speaker {tag}: n_clips '
                  f'{res["n_clips"]} pck {res["pck_by_alpha"]} l2 '
                  f'{res["l2"]:.6f}; {res["wall_ms"]:.1f} ms (host clock, '
                  f'model build and weight load included); launches '
                  f'{res["launches"]}', flush=True)
            require(res['launches'] == {
                'log_mel': 0, 'log_mel_exact': 0,
                'gcn_stack': 2 * test_batches, 'gcn_stack_fwd': 0,
                'gcn_stack_bwd': 0, 'gcn_stack_edge': 0},
                f'{tag} launches {res["launches"]}: expected K1 x2 a batch')
            require(res['n_clips'] == 348, f'{tag}: {res["n_clips"]} clips')
            require(all(np.isfinite(v) for v in res['pck_by_alpha'].values())
                    and np.isfinite(res['l2']), f'{tag}: non-finite')
    errs = {}
    for tag, tol in (('flagship_f32', HARNESS_PCK_TOL),
                     ('flagship_bf16', HARNESS_BF16_PCK_TOL)):
        res = evals[tag]
        errs[tag] = {a: abs(res['pck_by_alpha'][a] - v)
                     for a, v in golden['pck_by_alpha'].items()}
        errs[tag]['l2_rel'] = abs(res['l2'] - golden['l2']) / golden['l2']
        print(f'train_eval: {tag} vs the JAX golden: pck {res["pck_by_alpha"]}'
              f' vs {golden["pck_by_alpha"]} (tol {tol:g}), l2 '
              f'{res["l2"]:.6f} vs {golden["l2"]:.6f} (rel '
              f'{errs[tag]["l2_rel"]:.2e}); manifest npz_pck '
              f'{manifest["npz_pck"]}', flush=True)
        require(all(errs[tag][a] <= tol for a in golden['pck_by_alpha']),
                f'{tag} PCK {res["pck_by_alpha"]} against the golden '
                f'{golden["pck_by_alpha"]}')
    require(errs['flagship_f32']['l2_rel'] <= HARNESS_L2_RTOL,
            f'f32 L2 {evals["flagship_f32"]["l2"]} against {golden["l2"]}')
    out.update(
        train=dict(run_s=run_s, launches=launches, g_steps=g_steps,
                   d_steps=d_steps, epoch_ms=epoch_ms, mfu=mfu,
                   best_score=history.get('best_score')),
        checkpoint=dict(mb=ckpt_mb, write_ms=write_ms, restore_ms=restore_ms,
                        best_gen_ms=best_ms),
        resume=dict(start_epoch=epochs, bit_equal=True,
                    launches=resumed_launches, epoch_ms=resumed_ms),
        evaluate={tag: {k: r[k] for k in ('n_clips', 'pck_by_alpha', 'l2',
                                          'wall_ms', 'launches')}
                  for tag, r in evals.items()},
        golden={k: golden[k] for k in ('n_clips', 'pck_by_alpha', 'l2')},
        golden_err=errs, manifest_npz_pck=manifest['npz_pck'])
    return out


# Phase 12's fresh process: argv[1] a JSON list of {path, x, y}; loads and
# runs each artifact with torch and the two kernel modules alone, and
# prints one JSON line: per artifact its launches in one call and the
# median ms of 20 synchronised calls, and the port's modules it imported
ARTIFACT_RUNNER = r"""
import json, statistics, sys, time
import numpy as np
import torch
from a2m_torch.audio import mel_kernel
from a2m_torch.nn import gcn_kernel


def plain(*args, **kw):
    raise AssertionError('a plain version ran')


gcn_kernel.gcn_stack_plain = gcn_kernel.gcn_stack_edge_plain = plain
mel_kernel.log_mel_plain = plain
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {}
for run in json.loads(sys.argv[1]):
    x = torch.from_numpy(np.load(run['x'])).cuda()
    module = torch.export.load(run['path']).module()
    with torch.inference_mode():
        module(x)
        torch.cuda.synchronize()
        gcn_kernel.gcn_stack.launches = gcn_kernel.gcn_stack_edge.launches = 0
        mel_kernel.log_mel.launches = mel_kernel.log_mel.exact_launches = 0
        y = module(x)
        torch.cuda.synchronize()
        launches = dict(gcn_stack=gcn_kernel.gcn_stack.launches,
                        gcn_stack_edge=gcn_kernel.gcn_stack_edge.launches,
                        log_mel=mel_kernel.log_mel.launches,
                        log_mel_exact=mel_kernel.log_mel.exact_launches)
        np.save(run['y'], y.cpu().numpy())
        ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            module(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    out[run['name']] = dict(launches=launches, ms=statistics.median(ms))
    del module
print(json.dumps(dict(runs=out, modules=sorted(
    m for m in sys.modules
    if m.split('.')[0] in ('a2m_torch', 'a2m', 'jax')))))
"""


def median_call_ms(fn, x, iters: int = 20) -> tuple[float, float]:
    """Median host-clock ms of ``fn(x)`` over ``iters`` synchronised
    calls after two warm-ups, and the median ms until the call returned
    (the host's work of issuing it, before the synchronisation)."""
    import statistics

    import torch
    times, issued = [], []
    for i in range(iters + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
            issued.append((t1 - t0) * 1e3)
    return statistics.median(times), statistics.median(issued)


def device_profile(fn, x, calls: int = 5) -> tuple[float, float]:
    """Device operations (kernels, copies) and device ms per call of
    ``fn(x)``, by ``torch.profiler`` over ``calls`` calls after one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(x)
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(ops) / calls,
            sum(e.device_time_total for e in ops) / calls / 1e3)


def export_phase(smi: str) -> dict:
    """Phase 12: the flagship exported at full width, each artifact run in
    a fresh process with the kernel modules alone, held bit-equal to the
    live model and to the JAX golden, and its call timed against the live
    call."""
    import tempfile

    import numpy as np
    import torch
    from a2m_torch import export as aex
    from a2m_torch.config import Config, GeneratorConfig
    from a2m_torch.pipeline import (CLIP_SECONDS, FLAGSHIP_NPZ, SR,
                                    build_pipeline, load_generator)
    from a2m_torch.weights import load_generator_npz

    t_phase = time.perf_counter()
    with np.load(ROOT / 'a2m_torch' / 'testdata' / 'flagship_golden.npz') \
            as z:
        golden = {k: z[k] for k in z.files}
    _, stats = load_generator_npz(FLAGSHIP_NPZ)
    mean, std = stats['mean'], stats['std']
    rng = np.random.default_rng(12)
    n_samples = int(SR * CLIP_SECONDS)
    inputs = {
        'pose_b1': rng.standard_normal((1, 64, 128)).astype(np.float32),
        'pose_b2_bf16': golden['log_mel'], 'pose_b2_f32': golden['log_mel'],
        'audio_b128': (rng.standard_normal((128, n_samples))
                       * 0.1).astype(np.float32)}
    # name -> (flavour, batch, f32 GCN operands)
    plan = {'pose_b1': ('pose', 1, False), 'pose_b2_bf16': ('pose', 2, False),
            'pose_b2_f32': ('pose', 2, True),
            'audio_b128': ('audio', 128, False)}
    out: dict = dict(artifacts={})
    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:
        runs = []
        for name, (flavour, batch, precise) in plan.items():
            cfg = Config(generator=GeneratorConfig(fused_precise=precise))
            t0 = time.perf_counter()
            generator, variables, *ckpt_stats = aex._build_from_checkpoint(
                FLAGSHIP_NPZ, None, ['oliver'], cfg, 'cuda')
            require(all(np.array_equal(a, b) for a, b in zip(
                ckpt_stats, (mean, std))), 'the checkpoint\'s stats')
            export = (aex.export_pose_fn if flavour == 'pose'
                      else aex.export_audio_to_pose)
            exported = export(generator, variables, mean, std,
                              batch_size=batch)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            path = aex.save_artifact(exported, Path(tmp) / f'{name}.pt2')
            save_s = time.perf_counter() - t0
            meta = json.loads(Path(f'{path}.meta').read_text())
            nbytes = path.stat().st_size
            print(f'export: {name} exported in {export_s:.2f} s, saved in '
                  f'{save_s:.2f} s, {nbytes} bytes; ops {meta["ops"]}, '
                  f'inputs {meta["inputs"]}, device {meta["device"]}',
                  flush=True)
            want_ops = {'a2m_torch::gcn_stack': 2}
            if flavour == 'audio':
                want_ops['a2m_torch::log_mel'] = 1
            require(meta['ops'] == want_ops, f'{name}: ops {meta["ops"]}')
            np.save(Path(tmp) / f'{name}_x.npy', inputs[name])
            runs.append(dict(name=name, path=str(path),
                             x=str(Path(tmp) / f'{name}_x.npy'),
                             y=str(Path(tmp) / f'{name}_y.npy')))
            out['artifacts'][name] = dict(export_s=export_s, save_s=save_s,
                                          bytes=nbytes, ops=meta['ops'])
            del generator, exported
        # ---- a fresh process: torch and the kernel modules alone ---------
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-c', ARTIFACT_RUNNER, json.dumps(runs)],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
            capture_output=True, text=True, timeout=600)
        fresh_s = time.perf_counter() - t0
        require(proc.returncode == 0,
                f'artifact process failed:\n{proc.stderr[-4000:]}')
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        allowed = {'a2m_torch', 'a2m_torch._build', 'a2m_torch.audio',
                   'a2m_torch.audio.mel_kernel', 'a2m_torch.nn',
                   'a2m_torch.nn.gcn_kernel'}
        print(f'export: fresh process {fresh_s:.2f} s (four loads and runs);'
              f' modules {fresh["modules"]}', flush=True)
        require(set(fresh['modules']) <= allowed,
                f'the artifact process imported {fresh["modules"]}')
        # ---- each artifact against the live model ------------------------
        mean_t, std_t = (torch.as_tensor(v, device='cuda')
                         for v in (mean, std))
        live = {}
        for precise in (False, True):
            model = load_generator(config=GeneratorConfig(
                fused_gcn=True, fused_precise=precise), device='cuda')
            live[precise] = (
                lambda x, m=model: aex._denorm(m(x), mean_t, std_t))
        audio_to_pose = build_pipeline(batch=0)
        live['audio'] = lambda x: aex._denorm(audio_to_pose(x), mean_t,
                                              std_t)
        scale = float(np.abs(golden['pose']).max())
        for name, (flavour, batch, precise) in plan.items():
            run = fresh['runs'][name]
            want = {'gcn_stack': 2, 'gcn_stack_edge': 0,
                    'log_mel': int(flavour == 'audio'), 'log_mel_exact': 0}
            got = np.load(Path(tmp) / f'{name}_y.npy')
            fn = live['audio' if flavour == 'audio' else precise]
            with torch.inference_mode():
                ref = fn(torch.from_numpy(inputs[name]).cuda()).cpu().numpy()
            err = float(np.abs(got - ref).max())
            rec = out['artifacts'][name]
            rec.update(launches=run['launches'], fresh_ms=run['ms'],
                       bit_equal=bool(np.array_equal(got, ref)),
                       max_abs_err_vs_live=err)
            line = (f'export: {name} in the fresh process: launches per call '
                    f'{run["launches"]}, {run["ms"]:.3f} ms a call (median '
                    f'of 20); vs the live model: bit-equal '
                    f'{rec["bit_equal"]}, max_abs_err {err:.3e}')
            if name.startswith('pose_b2'):
                norm = (got - mean) / std
                rec['golden_rel_err'] = float(
                    np.abs(norm - golden['pose']).max()) / scale
                tol = 1e-4 if precise else 1e-2
                line += (f'; vs the JAX golden {rec["golden_rel_err"]:.3e} '
                         f'of max|pose| (tol {tol:g})')
                require(rec['golden_rel_err'] <= tol,
                        f'{name} against the golden: {rec["golden_rel_err"]}')
            print(line, flush=True)
            require(run['launches'] == want,
                    f'{name}: launches {run["launches"]}, expected {want}')
            require(tuple(got.shape) == (batch, 64, 104)
                    and bool(np.isfinite(got).all()), f'{name}: output')
            require(rec['bit_equal'], f'{name}: artifact differs from the '
                    f'live model by {err}')
        # ---- the artifact's call against the live call, in one process ---
        timing = {}
        for name, fn in (('pose_b1', live[False]),
                         ('audio_b128', live['audio'])):
            artifact = aex.load_artifact(Path(tmp) / f'{name}.pt2')
            x = torch.from_numpy(inputs[name]).cuda()
            with torch.inference_mode():
                ms, issued = zip(*(median_call_ms(f, x) for f in (
                    fn, artifact, artifact, fn)))
                device = [device_profile(f, x) for f in (fn, artifact)]
            nodes = sum(n.op == 'call_function' for n in torch.export.load(
                Path(tmp) / f'{name}.pt2').graph.nodes)
            timing[name] = dict(live_ms=[ms[0], ms[3]],
                                artifact_ms=[ms[1], ms[2]],
                                live_issue_ms=[issued[0], issued[3]],
                                artifact_issue_ms=[issued[1], issued[2]],
                                graph_ops=nodes,
                                live_device=dict(zip(('ops', 'ms'),
                                                     device[0])),
                                artifact_device=dict(zip(('ops', 'ms'),
                                                         device[1])))
            print(f'export: {name} live {ms[0]:.3f} / {ms[3]:.3f} ms, '
                  f'artifact {ms[1]:.3f} / {ms[2]:.3f} ms a call (host '
                  f'clock, median of 20, live-artifact-artifact-live); '
                  f'the host issues a call in {issued[0]:.3f} / '
                  f'{issued[3]:.3f} ms live, {issued[1]:.3f} / '
                  f'{issued[2]:.3f} ms the artifact ({nodes} ops in its '
                  f'graph); device operations and ms a call (profiler) '
                  f'live {device[0][0]:g}, {device[0][1]:.3f}, artifact '
                  f'{device[1][0]:g}, {device[1][1]:.3f}; {smi}',
                  flush=True)
            del artifact
    out.update(timing=timing, fresh_process_s=fresh_s,
               total_s=time.perf_counter() - t_phase)
    print(f'export: phase {out["total_s"]:.1f} s', flush=True)
    return out



# ---- phase 13: multi-process data-parallel training -------------------------

#: phase 13's run: the det fixture with its dev interval and its test
#: interval both to validate (a rank needs an interval of each split),
#: B = 64 a rank, 2 epochs of 4 batches and 1 dev batch
DIST_BATCH, DIST_EPOCHS = 64, 2
DIST_CAPS = {'train': 4, 'dev': 1}
DIST_SPLITS = ('train', 'train', 'train', 'dev', 'dev')
#: phase 11's run with dropout 0 (a rank draws its own dropout masks, which
#: a one-process run cannot reproduce)
DIST_OVERRIDES = ['train.best_metric=val_pck', 'train.lambda_pos=1.0',
                  f'train.n_epochs={DIST_EPOCHS}', 'generator.dropout=0',
                  'discriminator.dropout=0']
#: seconds a rank process may take, its start and kernel loads included
RANK_TIMEOUT_S = 600


def dist_fixture(process_index=None, process_count=None):
    """The det fixture of phase 11 in memory, DIST_SPLITS, a rank's slice
    (or the whole, without process arguments)."""
    from a2m_torch.data.synthetic import synthetic_loader
    recipe = json.loads((ROOT / 'a2m_torch' / 'testdata'
                         / 'harness_golden.json').read_text())['recipe']
    return synthetic_loader(
        **{k: recipe[k] for k in ('speakers', 'intervals_per_speaker',
                                  'duration_s', 'seed', 'deterministic')},
        splits=DIST_SPLITS, batch_size=DIST_BATCH,
        window_hop=recipe['window_hop'], max_batches=DIST_CAPS,
        process_index=process_index, process_count=process_count)


class ZipLoader:
    """Both ranks' slices as one loader: each batch the concatenation of
    rank 0's and rank 1's, the global batch of the two-rank run."""

    def __init__(self):
        self.ranks = [dist_fixture(i, 2) for i in range(2)]
        self.train = _Zip([r.train for r in self.ranks])
        self.dev = _Zip([r.dev for r in self.ranks])


class _Zip:
    def __init__(self, parts):
        self.parts = parts

    def __len__(self):
        return min(len(p) for p in self.parts)

    def __iter__(self):
        import numpy as np
        for batches in zip(*self.parts, strict=True):
            yield {k: np.concatenate([b[k] for b in batches])
                   for k in batches[0] if k != 'meta'}


def state_digest(trainer) -> dict:
    """sha1 of every parameter, buffer and Adam moment of both nets."""
    import hashlib
    out = {}
    for prefix, state in (('g', trainer.g_state), ('d', trainer.d_state)):
        for k, v in state.model.state_dict().items():
            out[f'{prefix}/{k}'] = hashlib.sha1(
                v.detach().cpu().numpy().tobytes()).hexdigest()
        for i, moments in state.optimizer.state_dict()['state'].items():
            for k, v in moments.items():
                out[f'{prefix}/adam/{i}/{k}'] = hashlib.sha1(
                    v.detach().cpu().numpy().tobytes()).hexdigest()
    return out


def instrumented_run(cfg, loader, device, log):
    """``train.__main__.run`` with every step timed (synchronised host
    clock), its metrics kept, and the time each step spends in collectives
    (all of them, and the gradients' all-reduce alone) summed; returns
    (trainer, steps)."""
    import torch
    import torch.distributed as dist
    from a2m_torch.parallel import mesh
    from a2m_torch.train.__main__ import run
    from a2m_torch.train.loop import Trainer
    steps: list[dict] = []
    current: dict = {}
    plain_step, plain_reduce, plain_grads = (Trainer._step, dist.all_reduce,
                                             mesh.all_reduce_grads)

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            if not current.get('timing'):
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            current[key] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    def step(self, kind, measuring, fn, *args, **kwargs):
        # every other step of a kind times its collectives, each between
        # two synchronisations; the others run undisturbed
        timing = sum(s['kind'] == kind for s in steps) % 2 == 1
        current.clear()
        current.update(collective_ms=0.0, grad_reduce_ms=0.0, timing=timing)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_step(self, kind, measuring, fn, *args, **kwargs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append(dict(kind=kind, ms=ms, first=measuring, **current,
                          metrics={k: float(v) for k, v in out[-1].items()}))
        current.clear()
        return out

    Trainer._step = step
    dist.all_reduce = timed(plain_reduce, 'collective_ms')
    mesh.all_reduce_grads = timed(plain_grads, 'grad_reduce_ms')
    try:
        trainer = run(cfg, loader, device=device, log=log)
    finally:
        Trainer._step = plain_step
        dist.all_reduce, mesh.all_reduce_grads = plain_reduce, plain_grads
    return trainer, steps


#: the gradient probe's rows a rank, and its tolerance: of each tensor's
#: max|grad|, of no less than PROBE_FLOOR of the largest tensor's (a bias
#: ahead of a train-mode BatchNorm has a gradient of rounding only)
PROBE_BATCH, PROBE_TOL, PROBE_FLOOR = 16, 1e-9, 1e-3


def probe_steps(rows: slice, device) -> tuple[dict, dict]:
    """One ``g_step`` and one ``d_step`` of the full-width models (seed 0,
    dropout 0) in float64, so the eager GCN layers (the kernels take f32),
    on ``rows`` of a seeded global batch of 2 x PROBE_BATCH (the last row
    of each half wrap-padded), with optimisers that keep the gradients
    they are given and do not move the parameters.  Returns (metrics,
    gradients) by name.  In f32 the rounding of this randomly initialised
    net's BatchNorms alone moves its gradients by ~1e-2 in relative L2
    when the batch is summed in another order (the tiny config on the
    CPU); in float64 by ~1e-13."""
    import numpy as np
    import torch
    from a2m_torch.config import DiscriminatorConfig, GeneratorConfig
    from a2m_torch.config import TrainConfig
    from a2m_torch.models.discriminator import Discriminator
    from a2m_torch.models.generator import Generator
    from a2m_torch.train.train_step import NetState, make_train_steps

    class Recorder(torch.optim.SGD):
        def step(self, closure=None):
            self.seen = [p.grad.clone() for group in self.param_groups
                         for p in group['params']]

    rng = np.random.default_rng(13)
    n = 2 * PROBE_BATCH
    audio = rng.standard_normal((n, 64, 128)).astype(np.float32)
    pose = (rng.standard_normal((n, 64, 104)) * 10 + 300).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[PROBE_BATCH - 1::PROBE_BATCH] = 0
    f64 = dict(device=device, dtype=torch.float64)
    put = lambda a: torch.from_numpy(a[rows]).to(**f64)  # noqa: E731
    args = (put(audio), put(pose), torch.zeros(104, **f64),
            torch.full((104,), 10.0, **f64))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g = Generator(GeneratorConfig(dropout=0.0)).to(**f64)
        d = Discriminator(DiscriminatorConfig(dropout=0.0)).to(**f64)
    states = [NetState(m, Recorder(m.parameters(), lr=0.0)) for m in (g, d)]
    # the eager GCN layers in d_step too: the kernels take f32
    g_step, d_step, _ = make_train_steps(g, d,
                                         TrainConfig(fused_gcn_eval=False))
    key = torch.Generator(device=device)
    _, _, gm = g_step(*states, *args, 0.95, 0.01, key.manual_seed(1),
                      mask=put(mask))
    _, _, dm = d_step(*states, *args, 0.95, 0.05, 0.01, key.manual_seed(2),
                      mask=put(mask))
    metrics = {f'{k}': float(v) for k, v in {**gm, **dm}.items()}
    grads = {f'{prefix}/{k}': grad for prefix, state in zip('gd', states)
             for (k, _), grad in zip(state.model.named_parameters(),
                                     state.optimizer.seen, strict=True)}
    return metrics, grads


def grad_probe(rank: int, device, reference) -> dict | None:
    """Every rank runs the train steps on its rows, over the global batch
    (their BatchNorm moments, losses and gradients through gloo's
    all-reduce of CUDA tensors); rank 0 compares them with ``reference``,
    the one-process steps on all rows (:func:`probe_steps` before the group
    was up): every gradient within PROBE_TOL, all together in relative L2
    and every metric within it too.  A lost cross-rank term or an averaged
    gradient is off by 1e-2 or more."""
    import torch
    from a2m_torch.parallel import launch
    rows = slice(rank * PROBE_BATCH, (rank + 1) * PROBE_BATCH)
    metrics, grads = probe_steps(rows, device)
    out = None
    if rank == 0:
        ref_metrics, ref = reference
        floor = PROBE_FLOOR * max(float(v.abs().max())
                                  for v in ref.values())
        worst, name = 0.0, ''
        num = den = 0.0
        for k, r in ref.items():
            err, scale = rel_err(grads[k], r)
            if err / max(scale, floor) > worst:
                worst, name = err / max(scale, floor), k
            num += (grads[k] - r).pow(2).sum().item()
            den += r.pow(2).sum().item()
        metric_rel = max(abs(metrics[k] - v) / abs(v)
                         for k, v in ref_metrics.items())
        out = dict(worst_tensor=worst, worst_name=name,
                   rel_l2=(num / den) ** 0.5, metric_rel=metric_rel,
                   tensors=len(ref))
    del grads
    torch.cuda.empty_cache()
    launch.host_barrier('a2m_grad_probe')
    return out


def rank_worker(spec: dict) -> int:
    """One rank of phase 13, started by :func:`dist_phase` with
    ``A2M_COORDINATOR`` / ``A2M_NUM_PROCESSES`` / ``A2M_PROCESS_ID`` set:
    the bootstrap, ``run()`` on its slice of the fixture (``spec['loader']``
    'rank') or on the concatenated batches ('zip'), the launch counts of
    its own kernels, and with ``spec['resume']`` a resume on the same
    directory, bit-equal, and one more epoch.  Writes its results to
    ``spec['out']`` as JSON."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from a2m_torch.config import Config, apply_overrides, validate
    from a2m_torch.parallel import launch
    from a2m_torch.train import __main__ as train_main
    from a2m_torch.train import checkpoint as ckpt_lib
    from a2m_torch.train.loop import Trainer

    lines: list[str] = []

    def log(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    t_start = time.perf_counter()
    if spec.get('deterministic'):
        set_deterministic(True)
    # the probe's one-process reference, on rank 0 before the group is up
    # (the others wait for it at the rendezvous)
    reference = (probe_steps(slice(None), 'cuda')
                 if spec.get('probe') and os.environ['A2M_PROCESS_ID'] == '0'
                 else None)
    cfg = apply_overrides(Config(), spec['overrides'])
    cfg, device = train_main.bootstrap(cfg, 'cuda', log=log)
    cfg = validate(cfg)
    rank, world = dist.get_rank(), dist.get_world_size()
    loader = (ZipLoader() if spec['loader'] == 'zip'
              else dist_fixture(cfg.data.process_index,
                                cfg.data.process_count))
    probe = (grad_probe(rank, device, reference) if spec.get('probe')
             else None)
    del reference
    if probe is not None:
        log(f'rank {rank}: gradient probe {probe}')
        require(max(probe['worst_tensor'], probe['rel_l2'],
                    probe['metric_rel']) <= PROBE_TOL,
                f'the sharded steps\' gradients against one process: '
                f'{probe}')
    saves: list[float] = []
    plain_save = ckpt_lib.CheckpointManager.save

    def save(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_save(self, *args, **kwargs)
        saves.append((time.perf_counter() - t0) * 1e3)
        return out

    ckpt_lib.CheckpointManager.save = save
    reset_kernel_launches()
    t0 = time.perf_counter()
    trainer, steps = instrumented_run(cfg, loader, device, log)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernel_launches()
    g_steps = sum(s['kind'] == 'g' for s in steps)
    d_steps = sum(s['kind'] == 'd' for s in steps)
    dev = len(loader.dev) * DIST_EPOCHS
    log(f'rank {rank}: run() {run_s:.2f} s, {g_steps} G steps, {d_steps} '
        f'D steps, {dev} dev batches, launches {launches}')
    require(g_steps > 0 and d_steps > 0 and len(loader.dev) == 1,
            f'rank {rank}: {g_steps} G, {d_steps} D steps, '
            f'{len(loader.dev)} dev batches')
    require(launches == {'log_mel': 0, 'log_mel_exact': 0,
                         'gcn_stack': 2 * (d_steps + dev),
                         'gcn_stack_fwd': 2 * g_steps,
                         'gcn_stack_bwd': 2 * g_steps, 'gcn_stack_edge': 0},
            f'rank {rank}: launches {launches}: expected K3 and K4 x2 per G '
            f'step, K1 x2 per D step and dev batch')
    out = dict(rank=rank, world=world, backend=dist.get_backend(),
               probe=probe,
               device=str(trainer.device), lines=lines, run_s=run_s,
               steps=steps, launches=launches, saves_ms=saves,
               g_history=list(trainer.controller.g_loss_history),
               d_history=list(trainer.controller.d_loss_history),
               loss_history=trainer.loss_history,
               mean=trainer.mean.cpu().tolist(),
               digest=state_digest(trainer), mfu=trainer.mfu_report,
               ckpt=sorted(os.listdir(Path(cfg.train.save_dir) / 'ckpt')))
    if spec.get('resume'):
        resumed = Trainer.from_config(cfg, loader, device=device, log=log)
        same = state_digest(resumed) == out['digest']
        require(resumed.start_epoch == DIST_EPOCHS and same,
                f'rank {rank}: resumed at epoch {resumed.start_epoch}, '
                f'bit-equal {same}')
        del trainer
        reset_kernel_launches()
        t0 = time.perf_counter()
        resumed.fit(DIST_EPOCHS + 1)
        torch.cuda.synchronize()
        out.update(resumed_epoch_s=time.perf_counter() - t0,
                   resumed_launches=kernel_launches(),
                   resumed_digest=state_digest(resumed),
                   resumed_history=resumed.loss_history)
        require(out['resumed_launches']['gcn_stack_fwd'] > 0,
                f'rank {rank}: resumed launches {out["resumed_launches"]}')
    out['total_s'] = time.perf_counter() - t_start
    launch.shutdown()
    Path(spec['out']).write_text(json.dumps(out))
    return 0


def start_ranks(world: int, spec: dict, tmp: Path) -> list[dict]:
    """``world`` rank processes of this script, each running
    :func:`rank_worker`; fails unless every one ends with 0 within
    RANK_TIMEOUT_S.  Returns their results."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        out = tmp / f'rank{rank}_of_{world}.json'
        env = dict(os.environ, A2M_COORDINATOR=f'127.0.0.1:{port}',
                   A2M_NUM_PROCESSES=str(world), A2M_PROCESS_ID=str(rank),
                   PYTHONPATH=str(ROOT))
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), '--rank-worker',
             json.dumps(dict(spec, out=str(out)))],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    logs = []
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for proc, _ in procs:
            logs.append(proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, ((proc, out), log) in enumerate(zip(procs, logs)):
        for line in log.splitlines():
            if line.startswith(('[dist]', 'rank ', 'g_step:', 'd_step:',
                                'throughput:', '[Validation]', 'resumed')):
                print(f'dist: rank {rank}/{world}: {line}', flush=True)
        require(proc.returncode == 0 and out.is_file(),
                f'rank {rank} of {world} failed (exit {proc.returncode}):\n'
                f'{log[-4000:]}')
    return [json.loads(out.read_text()) for _, out in procs]


def step_summary(steps: list[dict]) -> dict:
    """Per kind of step, past the steps the MFU line measures: the median
    ms of the steps that ran undisturbed, and of those that timed their
    collectives, the median ms in all collectives and in the gradients'
    all-reduce."""
    import statistics
    out = {}
    for kind in ('g', 'd'):
        rows = [s for s in steps if s['kind'] == kind and not s['first']]
        plain = [s['ms'] for s in rows if not s['timing']]
        timed = [s for s in rows if s['timing']]
        if plain and timed:
            out[f'{kind}_step'] = dict(
                ms=statistics.median(plain), n=len(plain),
                timed_ms=statistics.median(s['ms'] for s in timed),
                collective_ms=statistics.median(
                    s['collective_ms'] for s in timed),
                grad_reduce_ms=statistics.median(
                    s['grad_reduce_ms'] for s in timed), n_timed=len(timed))
    return out


def run_difference(a: dict, b: dict) -> dict:
    """Where two runs' records part: the first step whose metrics differ
    (and by how much, relative), and how many state tensors differ."""
    first = next((i for i, (x, y) in enumerate(zip(a['steps'], b['steps']))
                  if x['metrics'] != y['metrics']), None)
    rel = None
    if first is not None:
        x, y = a['steps'][first]['metrics'], b['steps'][first]['metrics']
        rel = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30) for k in y)
    return dict(first_step=first, rel=rel, steps=len(a['steps']),
                tensors=sum(a['digest'][k] != b['digest'].get(k)
                            for k in a['digest']), of=len(a['digest']))


def set_deterministic(on: bool) -> None:
    """cuDNN's deterministic algorithms and torch's deterministic mode
    (warning, not raising, where an operation has none)."""
    import torch
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)


def one_process(cfg, tmp: Path, tag: str) -> dict:
    """``run()`` in this process on the concatenated batches; its record."""
    import torch
    from a2m_torch.config import apply_overrides
    cfg = apply_overrides(cfg, [f'train.save_dir={tmp / tag}'])
    reset_kernel_launches()
    trainer, steps = instrumented_run(cfg, ZipLoader(), 'cuda',
                                      lambda line: None)
    out = dict(steps=steps, digest=state_digest(trainer),
               launches=kernel_launches(),
               g_history=list(trainer.controller.g_loss_history),
               d_history=list(trainer.controller.d_loss_history))
    del trainer
    torch.cuda.empty_cache()
    return out


def dist_phase(smi: str) -> dict:
    """Phase 13: data-parallel training across processes on the card."""
    import tempfile

    import torch
    from a2m_torch.config import Config, apply_overrides, validate

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    (ROOT / 'build').mkdir(exist_ok=True)
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:
        tmp = Path(tmp)
        cfg = validate(apply_overrides(Config(), DIST_OVERRIDES))
        # ---- one process on the concatenated batches -----------------------
        # cuDNN picks backward algorithms that add with atomics: two runs of
        # the same training differ from the second step on (on an H100);
        # its deterministic algorithms make them bit-equal
        set_deterministic(True)
        try:
            single = one_process(cfg, tmp, 'single')
        finally:
            set_deterministic(False)
        single_g = single['steps'][0]['metrics']['g_loss']
        print(f'dist: one process, B = {2 * DIST_BATCH}, deterministic '
              f'algorithms: launches {single["launches"]}; '
              f'{step_summary(single["steps"])} ms (host clock); {smi}',
              flush=True)
        # ---- (a) NCCL, one rank, the same batches ---------------------------
        common = DIST_OVERRIDES + ['mesh.data=-1']
        (nccl,) = start_ranks(1, dict(
            loader='zip', deterministic=True, overrides=common + [
                f'train.save_dir={tmp / "nccl"}']), tmp)
        differ = run_difference(nccl, single)
        require(nccl['backend'] == 'nccl', f'backend {nccl["backend"]}')
        print(f'dist: (a) NCCL, 1 rank on {nccl["device"]}, deterministic '
              f'algorithms: against one process {differ}; '
              f'{step_summary(nccl["steps"])} ms; {smi}', flush=True)
        require(differ['first_step'] is None and differ['tensors'] == 0
                and (nccl['g_history'], nccl['d_history'])
                == (single['g_history'], single['d_history']),
                f'(a) the one-rank NCCL run differs from one process: '
                f'{differ}')
        # ---- (b) gloo, two ranks on the one card ---------------------------
        ranks = start_ranks(2, dict(
            loader='rank', resume=True, probe=True, overrides=common + [
                f'train.save_dir={tmp / "gloo"}']), tmp)
        r0, r1 = ranks
        require(r0['backend'] == r1['backend'] == 'gloo',
                f'backends {r0["backend"]}, {r1["backend"]}')
        for key in ('steps', 'g_history', 'd_history', 'loss_history',
                    'mean', 'digest', 'resumed_digest', 'resumed_history',
                    'ckpt'):
            a, b = r0[key], r1[key]
            if key == 'steps':
                a, b = ([s['metrics'] for s in x] for x in (a, b))
            require(a == b, f'(b) ranks differ in {key}')
        require(r0['ckpt'] == ['best_gen.npz', 'epoch_0.pt', 'epoch_1.pt'],
                f'(b) checkpoints {r0["ckpt"]}')
        first = r0['steps'][0]['metrics']['g_loss']
        rel = abs(first - single_g) / abs(single_g)
        require(rel <= 1e-3, f'(b) first G loss {first} vs one process '
                f'{single_g}')
        summary = [step_summary(r['steps']) for r in ranks]
        for r, s in zip(ranks, summary):
            parts = [f'{k} {v["ms"]:.1f} ms (median of {v["n"]}); of '
                     f'{v["n_timed"]} that timed their collectives '
                     f'({v["timed_ms"]:.1f} ms): all collectives '
                     f'{v["collective_ms"]:.1f} ms, the gradient '
                     f'all-reduce {v["grad_reduce_ms"]:.1f} ms'
                     for k, v in s.items()]
            print(f'dist: (b) gloo rank {r["rank"]}/2 on {r["device"]}: '
                  f'run() {r["run_s"]:.2f} s; ' + '; '.join(parts)
                  + f'; checkpoint saves {[round(v, 1) for v in r["saves_ms"]]}'
                  f' ms; resumed epoch {r["resumed_epoch_s"]:.2f} s (host '
                  f'clock, synchronised); {smi}', flush=True)
        print(f'dist: (b) ranks bit-equal (metrics, histories, parameters, '
              f'buffers, Adam moments, resumed state); first G loss '
              f'{first:.7f} vs one process {single_g:.7f} (rel {rel:.2e}, '
              f'tol 1e-3); G history {r0["g_history"]} vs one process '
              f'{single["g_history"]}; gradient probe {r0["probe"]}; {smi}',
              flush=True)
        out.update(
            single=dict(steps=step_summary(single['steps']), g_loss=single_g,
                        launches=single['launches']),
            nccl=dict(bit_equal=True, steps=step_summary(nccl['steps']),
                      launches=nccl['launches'], run_s=nccl['run_s']),
            gloo=dict(first_g_rel=rel, probe=r0['probe'], ranks=[dict(
                rank=r['rank'], device=r['device'], run_s=r['run_s'],
                launches=r['launches'], saves_ms=r['saves_ms'],
                resumed_epoch_s=r['resumed_epoch_s'],
                resumed_launches=r['resumed_launches'], mfu=r['mfu'],
                steps=s) for r, s in zip(ranks, summary)]))
    out['total_s'] = time.perf_counter() - t_phase
    print(f'dist: phase {out["total_s"]:.1f} s', flush=True)
    return out


# ---- phase 14: migration, evaluation, rendering, fine-tuning, benchmarks ---

#: the migrated generator on the card against the same weights on the CPU's
#: plain path, as a share of max|pose|: f32 and bf16 GCN operands
MIGRATED_F32_TOL, MIGRATED_BF16_TOL = 1e-4, 1e-2
#: config 1's exact-mode log-mel against float64 (a2m's parity target) and
#: config 5's flagship PCK against harness_golden.json with bf16 operands
BENCH_PARITY_TOL, BENCH_FLAGSHIP_PCK_TOL = 1e-5, 1e-2
#: the fine-tune from the migration: batches of the det fixture
MIGRATE_CAPS = {'train': 2, 'dev': 1}


def _bn_keys(prefix: str, c: int) -> dict:
    return {f'{prefix}.weight': (c,), f'{prefix}.bias': (c,),
            f'{prefix}.running_mean': (c,), f'{prefix}.running_var': (c,),
            f'{prefix}.num_batches_tracked': ()}


def _cnr_keys(prefix: str, ci: int, co: int, k) -> dict:
    """ConvNormRelu keys (model_layers.py:94-105): conv + BatchNorm; ``k``
    an int (1-D conv) or a (kh, kw) pair (2-D conv)."""
    kernel = (k,) if isinstance(k, int) else tuple(k)
    return {f'{prefix}.conv.weight': (co, ci, *kernel),
            f'{prefix}.conv.bias': (co,), **_bn_keys(f'{prefix}.norm', co)}


def _attn_keys(prefix: str, c: int) -> dict:
    """SelfAttention (model_layers.py:127-131)."""
    return {f'{prefix}.query_conv.weight': (c // 8, c, 1),
            f'{prefix}.query_conv.bias': (c // 8,),
            f'{prefix}.key_conv.weight': (c // 8, c, 1),
            f'{prefix}.key_conv.bias': (c // 8,),
            f'{prefix}.value_conv.weight': (c, c, 1),
            f'{prefix}.value_conv.bias': (c,), f'{prefix}.gamma': (1,)}


def _linear_keys(prefix: str, ci: int, co: int) -> dict:
    return {f'{prefix}.weight': (co, ci), f'{prefix}.bias': (co,)}


def _gat_keys(prefix: str, f: int, h: int) -> dict:
    """torch_geometric >= 2.0 GATConv keys."""
    return {f'{prefix}.lin.weight': (h * f, f),
            f'{prefix}.att_src': (1, h, f), f'{prefix}.att_dst': (1, h, f),
            f'{prefix}.bias': (f,)}


def reference_generator_keys(cfg) -> dict:
    """The reference ``SelfAttention_G`` state_dict schema (key -> shape) at
    ``cfg``'s sizes (``real_motion_model.py:16-129``,
    ``model_layers.py:51-374``), the schema ``tests/test_compat.py`` builds;
    ``up_attention`` sized C*8, as a checkpoint of the fixed model has it."""
    c, b, u = cfg.out_channels, cfg.in_channels // 4, cfg.in_channels
    jf, h = cfg.joint_feat_dim, cfg.gat_heads
    s: dict = {}
    for i, (ci, co, k) in enumerate([(1, b, (4, 4)), (b, 2 * b, (4, 4)),
                                     (2 * b, 4 * b, (4, 4)),
                                     (4 * b, 8 * b, (3, 3)),
                                     (8 * b, 4 * b, (3, 8))]):
        s.update(_cnr_keys(f'audio_encoder.conv.{i}', ci, co, k))
    for i, (ci, co, k) in enumerate([(u, 2 * u, 3), (2 * u, 2 * u, 4),
                                     (2 * u, 4 * u, 3), (4 * u, 4 * u, 4)]):
        s.update(_cnr_keys(f'unet.downsample_layers.{i}', ci, co, k))
    s.update(_cnr_keys('unet.bottleneck', 4 * u, 8 * u, 3))
    s.update(_attn_keys('unet.bottleneck_attention', 8 * u))
    for i, (ci, co) in ((0, (8 * u, 4 * u)), (2, (4 * u, 2 * u))):
        s.update({f'unet.upsample_layers.{i}.conv_transpose.weight':
                  (ci, co, 3),
                  f'unet.upsample_layers.{i}.conv_transpose.bias': (co,),
                  **_bn_keys(f'unet.upsample_layers.{i}.bn', co)})
    s.update(_cnr_keys('unet.upsample_layers.1', 8 * u, 4 * u, 3))
    s.update(_cnr_keys('unet.upsample_layers.3', 4 * u, 2 * u, 3))
    s.update({'unet.final_conv.weight': (c, 2 * u, 1),
              'unet.final_conv.bias': (c,)})
    s.update(_attn_keys('unet.up_attention', 8 * u))
    for part, j in (('body', 10), ('hand', 42)):
        for stage in ('pre', 'post'):
            t = f'{part}_decoder_{stage}'
            s.update(_cnr_keys(f'{t}.0.conv1', c, c, 3))
            s.update(_cnr_keys(f'{t}.0.conv2', c, c, 3))
            s.update(_attn_keys(f'{t}.0.attention', c))
            s.update(_cnr_keys(f'{t}.1', c, c, 3))
        chattn = [f'{part}_decoder_pre.{2 if part == "body" else 3}']
        attn = [f'{part}_decoder_pre.{3 if part == "body" else 2}',
                f'{part}_decoder_post.2']
        if part == 'hand':
            chattn.append('hand_decoder_post.3')
        for t in chattn:
            s.update({f'{t}.fc.0.weight': (c // 8, c),
                      f'{t}.fc.0.bias': (c // 8,),
                      f'{t}.fc.2.weight': (c, c // 8), f'{t}.fc.2.bias': (c,)})
        for t in attn:
            s.update(_attn_keys(t, c))
        s.update(_linear_keys(f'{part}_proj_in', c, j * jf))
        for i in (1, 3, 5):
            s.update(_gat_keys(f'{part}_gcn{i}', jf, h))
        for i in (2, 4):
            s.update({f'{part}_gcn{i}.lin_rel.weight': (jf, jf),
                      f'{part}_gcn{i}.lin_rel.bias': (jf,),
                      f'{part}_gcn{i}.lin_root.weight': (jf, jf)})
        for i in range(5):
            s.update({f'{part}_layer_norms.{i}.weight': (jf,),
                      f'{part}_layer_norms.{i}.bias': (jf,)})
        s.update(_linear_keys(f'{part}_proj_out', j * jf, c))
        s.update({f'{part}_norm.weight': (c,), f'{part}_norm.bias': (c,)})
    s.update({'body_logits.weight': (20, c, 1), 'body_logits.bias': (20,),
              'hand_logits.weight': (84, c, 1), 'hand_logits.bias': (84,)})
    return s


def reference_discriminator_keys(cfg) -> dict:
    """The reference ``SelfAttention_D`` schema (real_motion_model.py:
    504-578) at ``cfg``'s sizes, audio-fusion and aux tensors included."""
    oc, jf, h = cfg.out_channels, cfg.joint_feat_dim, cfg.gat_heads
    s: dict = {}

    def conv_bn(conv: str, bn: str, ci: int, co: int, k: int) -> None:
        s.update({f'{conv}.weight': (co, ci, k), f'{conv}.bias': (co,),
                  **_bn_keys(bn, co)})

    conv_bn('conv1.0', 'conv1.1', 104, oc, 4)
    conv_bn('conv1.4', 'conv1.5', oc, oc, 4)
    cur = oc
    for n in range(1, cfg.n_downsampling + 1):
        mul = min(2 ** n, 16)
        conv_bn(f'conv2.{n - 1}.0', f'conv2.{n - 1}.1', cur, cur * mul, 4)
        conv_bn(f'conv2.{n - 1}.4', f'conv2.{n - 1}.5', cur * mul, cur * mul,
                4)
        cur *= mul
    conv_bn('conv3.0', 'conv3.1', cur, cur * 2, 4)
    conv_bn('conv3.4', 'conv3.5', cur * 2, cur * 4, 4)
    s.update(_attn_keys('conv3.8', cur * 4))
    conv_bn('conv3.9', 'conv3.10', cur * 4, cur * 4, 3)
    s.update(_linear_keys('body_proj', cur * 2, 10 * jf))
    s.update(_linear_keys('hand_proj', cur * 2, 42 * jf))
    s.update(_gat_keys('body_gat', jf, h))
    s.update(_gat_keys('hand_gat', jf, h))
    s.update(_linear_keys('body_graph_out', 10 * jf, cur * 2))
    s.update(_linear_keys('hand_graph_out', 42 * jf, cur * 2))
    s.update({'audio_fusion.weight': (cur * 4, 256, 1),
              'audio_fusion.bias': (cur * 4,),
              'logits.weight': (1, cur * 8, 3), 'logits.bias': (1,)})
    s.update(_linear_keys('aux_classifier.0', cur * 4, 512))
    s.update(_linear_keys('aux_classifier.3', 512, 10))
    return s


def seeded_state_dict(shapes: dict, rng) -> dict:
    """Reference tensors of a trained network's scale from ``rng``: weights
    ~ N(0, 1/fan_in), GAT attention ~ N(0, 1/F), norm scales ~ 1 + 0.1 N,
    attention gates ~ 0.5 + 0.1 N, running variances ~ U(0.5, 1.5), the
    rest ~ 0.1 N; ``num_batches_tracked`` an int64 count."""
    import numpy as np
    import torch
    out = {}
    for key, shape in shapes.items():
        leaf = key.rsplit('.', 1)[1]
        if leaf == 'num_batches_tracked':
            out[key] = torch.tensor(1000, dtype=torch.int64)
            continue
        if leaf == 'weight' and len(shape) >= 2:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif leaf in ('att_src', 'att_dst'):
            v = rng.standard_normal(shape) / np.sqrt(shape[-1])
        elif leaf == 'weight':
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == 'gamma':
            v = 0.5 + 0.1 * rng.standard_normal(shape)
        elif leaf == 'running_var':
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


def _have(module: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(module) is not None


def migration_check(tmp: Path, g_cfg, d_cfg) -> tuple[Path, dict]:
    """Phase 14 (a): seeded reference files through ``python -m
    a2m_torch.compat`` at full width, the head markers through K1, and the
    migrated generator on the card against the CPU's plain path."""
    import numpy as np
    import torch
    from a2m_torch.compat import import_generator
    from a2m_torch.models.generator import Generator
    from a2m_torch.weights import from_jax_variables, load_generator_npz

    out: dict = {}
    rng = np.random.default_rng(14)
    g_keys = reference_generator_keys(g_cfg)
    d_keys = reference_discriminator_keys(d_cfg)
    gen_path, disc_path = tmp / 'Best_Gen', tmp / 'Best_Dis'
    torch.save(seeded_state_dict(g_keys, rng), gen_path)
    torch.save(seeded_state_dict(d_keys, rng), disc_path)
    migrated = tmp / 'migrated'
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'a2m_torch.compat', '--gen', str(gen_path),
         '--disc', str(disc_path), '--out', str(migrated)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=600)
    out['compat_cli_s'] = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f'migrate: compat: {line}', flush=True)
    require(proc.returncode == 0, f'python -m a2m_torch.compat failed:\n'
            f'{proc.stderr[-4000:]}')
    for name in ('best_gen.npz', 'imported_disc.npz'):
        with np.load(migrated / name) as z:
            dtypes = {str(z[k].dtype) for k in z.files}
        require(dtypes == {'float32'}, f'{name} holds {dtypes}')
        out[f'{name}_mb'] = (migrated / name).stat().st_size / 1e6
    require('generator: imported with 0 structural skip(s), 0 leaf/leaves '
            'left at init, 0 unused' in proc.stdout, 'generator report')
    print(f'migrate: python -m a2m_torch.compat {out["compat_cli_s"]:.2f} s '
          f'(host clock, process start included), best_gen.npz '
          f'{out["best_gen.npz_mb"]:.1f} MB, imported_disc.npz '
          f'{out["imported_disc.npz_mb"]:.1f} MB, all f32', flush=True)

    # ---- head-permutation markers through K1 at full width -----------------
    zero = {k: torch.zeros(s, dtype=torch.float32) if s else torch.tensor(0)
            for k, s in g_keys.items()}
    for k, s in g_keys.items():
        if k.endswith('running_var'):
            zero[k] = torch.ones(s)
    zero['body_logits.bias'] = torch.arange(0, 20, dtype=torch.float32)
    zero['hand_logits.bias'] = torch.arange(20, 104, dtype=torch.float32)
    markers = {}
    for tag, precise in (('f32', True), ('bf16', False)):
        g = Generator(dataclasses.replace(g_cfg, fused_gcn=True,
                                          fused_precise=precise))
        state, report = import_generator(zero, g)
        require(not report.unused and not report.missing,
                f'markers import {report}')
        g.load_state_dict(state)
        g = g.to('cuda').eval()
        reset_kernel_launches()
        with torch.inference_mode():
            y = g(torch.zeros(2, 64, 128, device='cuda')).cpu()
        markers[tag] = kernel_launches()
        require(markers[tag]['gcn_stack'] == 2, f'markers launches '
                f'{markers[tag]}: expected K1 x2')
        require(torch.equal(y, torch.arange(104, dtype=torch.float32)
                            .expand(2, 64, 104)),
                f'{tag} head markers: channel s != s (max error '
                f'{(y - torch.arange(104.0)).abs().max():.3g})')
        del g
    out['markers'] = dict(exact=True, launches=markers)
    print(f'migrate: head markers at full width exact (every channel its '
          f'own index, f32 and bf16 operands), launches {markers}',
          flush=True)

    # ---- the migrated generator on the card against the CPU ----------------
    flat, stats = load_generator_npz(migrated / 'best_gen.npz')
    require(stats == {}, 'the migration ships no pose statistics')
    audio = torch.from_numpy(
        np.random.default_rng(140).standard_normal((8, 64, 128))
        .astype(np.float32))
    cpu = Generator(g_cfg)
    cpu.load_state_dict(from_jax_variables(flat, cpu))
    with torch.inference_mode():
        ref = cpu.eval()(audio)
    del cpu
    require(bool(torch.isfinite(ref).all()), 'CPU forward not finite')
    held = {}
    for tag, precise, tol in (('f32', True, MIGRATED_F32_TOL),
                              ('bf16', False, MIGRATED_BF16_TOL)):
        g = Generator(dataclasses.replace(g_cfg, fused_gcn=True,
                                          fused_precise=precise))
        g.load_state_dict(from_jax_variables(flat, g))
        g = g.to('cuda').eval()
        reset_kernel_launches()
        with torch.inference_mode():
            y = g(audio.cuda()).cpu()
        launches = kernel_launches()
        require(launches['gcn_stack'] == 2, f'migrated G {tag} launches '
                f'{launches}: expected K1 x2')
        err = float((y - ref).abs().max() / ref.abs().max())
        held[tag] = dict(rel_err=err, tol=tol, launches=launches)
        print(f'migrate: migrated G on the card ({tag} GCN operands, K1 x2) '
              f'vs the CPU plain path, B = 8: max err {err:.3e} of '
              f'max|pose| {float(ref.abs().max()):.4f} (tol {tol:g})',
              flush=True)
        require(err <= tol, f'migrated G {tag}: {err:.3e} > {tol:g}')
        del g
    out['card_vs_cpu'] = held
    return migrated, out


def fine_tune_check(tmp: Path, migrated: Path, loader) -> dict:
    """Phase 14 (a), last part: ``run()`` with ``train.init_from`` the
    migration; G and D bit-equal to the imported files before the first
    step, K3/K4 x2 a ``g_step``."""
    import torch
    from a2m_torch.config import Config, apply_overrides
    from a2m_torch.train import loop
    from a2m_torch.train.__main__ import run
    from a2m_torch.weights import from_jax_variables, load_generator_npz

    cfg = apply_overrides(Config(), [
        f'train.save_dir={tmp / "finetune"}', 'train.n_epochs=1',
        f'train.init_from={migrated}'])
    lines: list[str] = []
    before: dict = {}
    original_fit = loop.Trainer.fit

    def checked_fit(trainer, *args, **kwargs):
        """The state the first step starts from, against the files."""
        for name, model in (('best_gen.npz', trainer.g_state.model),
                            ('imported_disc.npz', trainer.d_state.model)):
            flat, _ = load_generator_npz(migrated / name)
            want = from_jax_variables(flat, model)
            before[name] = all(torch.equal(v.cpu(), want[k])
                               for k, v in model.state_dict().items())
            before[f'{name}_optimizer_fresh'] = (
                trainer.g_state if name == 'best_gen.npz'
                else trainer.d_state).optimizer.state_dict()['state'] == {}
        before['g_params'] = [p.detach().clone() for p in
                              trainer.g_state.model.parameters()]
        return original_fit(trainer, *args, **kwargs)

    loop.Trainer.fit = checked_fit
    try:
        reset_kernel_launches()
        t0 = time.perf_counter()
        trainer = run(cfg, loader, log=lambda line: (
            lines.append(line), print(f'migrate: fine-tune: {line}',
                                      flush=True)))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        loop.Trainer.fit = original_fit
    launches = kernel_launches()
    require(f'initialized G+D from {migrated}' in lines,
            'no "initialized G+D" line')
    flags = {k: v for k, v in before.items() if k != 'g_params'}
    require(before.get('best_gen.npz') and before.get('imported_disc.npz'),
            f'G/D not bit-equal to the import before the first step: '
            f'{flags}')
    require(before['best_gen.npz_optimizer_fresh']
            and before['imported_disc.npz_optimizer_fresh'],
            'optimisers did not start fresh')
    moved = any(not torch.equal(a, b) for a, b in zip(
        before['g_params'], trainer.g_state.model.parameters()))
    require(moved, 'the fine-tune did not move G')
    g_steps = launches['gcn_stack_fwd'] // 2
    require(g_steps > 0 and launches['gcn_stack_fwd']
            == launches['gcn_stack_bwd'] == 2 * g_steps,
            f'fine-tune launches {launches}: expected K3 and K4 x2 a G step')
    require(launches['gcn_stack'] > 0 and launches['gcn_stack'] % 2 == 0,
            f'fine-tune launches {launches}: expected K1 x2 a D step and '
            f'dev batch')
    hist = trainer.loss_history
    require(all(v == v for v in hist['val_g'] + hist['train_g']),
            f'fine-tune losses {hist}')
    print(f'migrate: fine-tune run() {run_s:.2f} s (1 epoch of '
          f'{MIGRATE_CAPS["train"]} batches, B = 128; host clock, build '
          f'included): G and D bit-equal to the import before the first '
          f'step, optimisers fresh, launches {launches} ({g_steps} G steps)',
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    return dict(run_s=run_s, launches=launches, g_steps=g_steps,
                bit_equal_before_first_step=True, val_g=hist['val_g'])


def render_check(tmp: Path, migrated: Path, loader, recipe: dict) -> dict:
    """Phase 14 (b): the harness with ``render_sample_to`` on the migrated
    generator where matplotlib and PIL are installed; else the harness and
    the sample's keypoints (``generate_video.sample_keypoints``) without
    drawing."""
    import shutil

    import numpy as np
    import torch
    from a2m_torch.eval.harness import evaluate_speaker
    from a2m_torch.viz import generate_video

    have = {m: _have(m) for m in ('matplotlib', 'PIL')}
    have['ffmpeg'] = shutil.which('ffmpeg') is not None
    draw = have['matplotlib'] and have['PIL']
    print(f'migrate: on this machine matplotlib {have["matplotlib"]}, PIL '
          f'{have["PIL"]}, ffmpeg {have["ffmpeg"]}: '
          f'{"drawing the sample video" if draw else "no drawing"}',
          flush=True)
    test_batches = len(loader.test)
    reset_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate_speaker(None, recipe['speaker'], migrated,
                           batch_size=recipe['batch_size'], device='cuda',
                           loader=loader,
                           render_sample_to=tmp / 'video' if draw else None)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = kernel_launches()
    # the harness: K1 x2 a batch; the sample video: one more forward
    calls = test_batches + (1 if draw else 0)
    require(launches['gcn_stack'] == 2 * calls
            and launches['gcn_stack_fwd'] == 0,
            f'harness launches {launches}: expected K1 x2 on {calls} calls')
    require(res['n_clips'] == 348 and np.isfinite(res['l2']),
            f'harness on the migrated G: {res}')
    out = dict(have=have, drew=draw, wall_ms=wall_ms, launches=launches,
               n_clips=res['n_clips'], pck=res['pck'], l2=res['l2'])
    if draw:
        video = Path(res['video'])
        require(video.is_file() and video.stat().st_size > 0,
                f'no sample video at {video}')
        out['video'] = dict(name=video.name, kb=video.stat().st_size / 1e3)
    else:
        reset_kernel_launches()
        s = generate_video.sample_keypoints(
            None, recipe['speaker'], migrated,
            batch_size=recipe['batch_size'], device='cuda', loader=loader)
        sample_launches = kernel_launches()
        require(sample_launches['gcn_stack'] == 2,
                f'sample launches {sample_launches}')
        require(s['gp_disp'].shape == s['rp_disp'].shape == (64, 2, 52)
                and np.isfinite(s['gp_disp']).all(),
                'sample keypoints not finite')
        out['sample'] = dict(pck_mean=s['pck_mean'],
                             launches=sample_launches)
    print(f'migrate: harness on the migrated G: {res["n_clips"]} clips, '
          f'PCK {res["pck"]:.4f}, L2 {res["l2"]:.4f}, {wall_ms:.1f} ms (host '
          f'clock, build and load included), launches {launches}; '
          f'{out.get("video") or out.get("sample")}', flush=True)
    return out


def benchmarks_check(tmp: Path, golden: dict) -> dict:
    """Phase 14 (c): ``python -m a2m_torch.eval.benchmarks`` on all six
    configs in a process of its own, launches asserted per config."""
    out_file = tmp / 'bench.json'
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'a2m_torch.eval.benchmarks', '--configs',
         '1,2,3,4,5,6', '--out', str(out_file)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f'benchmarks: {line}', flush=True)
    require(proc.returncode == 0, f'python -m a2m_torch.eval.benchmarks '
            f'failed:\n{proc.stderr[-4000:]}')
    rows = {r['config']: r for r in json.loads(out_file.read_text())}
    require(list(rows) == ['single_clip', 'batched_features', 'train_step',
                           'multi_speaker_training', 'e2e_eval',
                           'streaming'], f'configs {list(rows)}')
    none = dict(log_mel=0, log_mel_exact=0, gcn_stack=0, gcn_stack_fwd=0,
                gcn_stack_bwd=0, gcn_stack_edge=0)
    c1, c2, c3 = rows['single_clip'], rows['batched_features'], \
        rows['train_step']
    expected = {
        'single_clip': dict(none, log_mel_exact=1,
                            gcn_stack=2 * c1['forward_calls']),
        'batched_features': dict(none, log_mel=c2['kernel_calls']),
        'train_step': dict(none, gcn_stack=2 * c3['d_steps'],
                           gcn_stack_fwd=2 * c3['g_steps'],
                           gcn_stack_bwd=2 * c3['g_steps'])}
    for name, want in expected.items():
        require(rows[name]['launches'] == want,
                f'{name} launches {rows[name]["launches"]}, expected {want}')
    for name in ('multi_speaker_training', 'e2e_eval', 'streaming'):
        got = rows[name]['launches']
        used = {'multi_speaker_training': ('gcn_stack', 'gcn_stack_fwd',
                                           'gcn_stack_bwd'),
                'e2e_eval': ('gcn_stack',),
                'streaming': ('log_mel', 'gcn_stack_edge')}[name]
        require(all(got[k] > 0 for k in used)
                and all(got[k] == 0 for k in got if k not in used)
                and all(got[k] % 2 == 0 for k in used if k != 'log_mel'),
                f'{name} launches {got}: expected {used} only')
    c4 = rows['multi_speaker_training']['launches']
    require(c4['gcn_stack_fwd'] == c4['gcn_stack_bwd'],
            f'multi_speaker_training launches {c4}')
    require(c1['logmel_max_abs_err_vs_float64'] <= BENCH_PARITY_TOL,
            f'config 1 parity {c1["logmel_max_abs_err_vs_float64"]}')
    require(c3['g_loss_finite'] and c3['d_loss_finite'], 'config 3 losses')
    flagship = rows['e2e_eval'].get('flagship')
    require(flagship is not None, 'config 5 found no flagship checkpoint')
    pck_err = {a: abs(flagship['pck_by_alpha'][a] - v)
               for a, v in golden['pck_by_alpha'].items()}
    require(flagship['n_clips'] == golden['n_clips']
            and max(pck_err.values()) <= BENCH_FLAGSHIP_PCK_TOL,
            f'config 5 flagship {flagship} against the golden '
            f'{golden["pck_by_alpha"]}')
    require(rows['streaming']['multi_streams_ok']
            and rows['streaming']['compile_cached'], 'config 6')
    print(f'benchmarks: all six configs in {cli_s:.1f} s of one process '
          f'(host clock); launches as expected; config 1 parity '
          f'{c1["logmel_max_abs_err_vs_float64"]:.3e}; config 5 flagship '
          f'PCK {flagship["pck_by_alpha"]} vs the golden '
          f'{golden["pck_by_alpha"]} (tol {BENCH_FLAGSHIP_PCK_TOL:g})',
          flush=True)
    return dict(cli_s=cli_s, rows=rows, flagship_pck_err=pck_err)


def migrate_phase(smi: str) -> dict:
    """Phase 14: a reference checkpoint migrated, evaluated, rendered and
    fine-tuned, then a2m's six benchmark configs, on the card."""
    import tempfile

    from a2m_torch.config import DiscriminatorConfig, GeneratorConfig
    from a2m_torch.data.synthetic import synthetic_loader
    from a2m_torch.device import resolve_device

    t_phase = time.perf_counter()
    resolve_device('cuda')              # TF32 off, as every entry point
    golden = json.loads((ROOT / 'a2m_torch' / 'testdata'
                         / 'harness_golden.json').read_text())
    recipe = golden['recipe']
    loader = synthetic_loader(
        **{k: recipe[k] for k in ('speakers', 'intervals_per_speaker',
                                  'duration_s', 'seed', 'deterministic',
                                  'splits')},
        batch_size=recipe['batch_size'], window_hop=recipe['window_hop'],
        max_batches=MIGRATE_CAPS)
    (ROOT / 'build').mkdir(exist_ok=True)
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        migrated, out['migration'] = migration_check(
            tmp, GeneratorConfig(), DiscriminatorConfig())
        out['migration']['s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out['fine_tune'] = fine_tune_check(tmp, migrated, loader)
        out['fine_tune']['s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out['render'] = render_check(tmp, migrated, loader, recipe)
        out['render']['s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out['benchmarks'] = benchmarks_check(tmp, golden)
        out['benchmarks']['s'] = time.perf_counter() - t0
    out['total_s'] = time.perf_counter() - t_phase
    print(f'migrate: phase {out["total_s"]:.1f} s (migration '
          f'{out["migration"]["s"]:.1f}, fine-tune {out["fine_tune"]["s"]:.1f}'
          f', harness and render {out["render"]["s"]:.1f}, benchmark CLI '
          f'{out["benchmarks"]["s"]:.1f}); {smi}', flush=True)
    return out


def phase14_launches(migrate: dict) -> dict:
    """Per kernel, its launches in each part of phase 14 that ran it."""
    parts = {
        'markers': [migrate['migration']['markers']['launches'][t]
                    for t in ('f32', 'bf16')],
        'migrated_vs_cpu': [migrate['migration']['card_vs_cpu'][t]
                            ['launches'] for t in ('f32', 'bf16')],
        'fine_tune': [migrate['fine_tune']['launches']],
        'harness': [migrate['render']['launches']]
        + ([migrate['render']['sample']['launches']]
           if 'sample' in migrate['render'] else []),
        **{f'benchmarks_{row["config"]}': [row['launches']]
           for row in migrate['benchmarks']['rows'].values()}}
    names = ('gcn_stack', 'log_mel', 'gcn_stack_fwd', 'gcn_stack_bwd',
             'gcn_stack_edge', 'log_mel_exact')
    out = {}
    for name in names:
        counts = {part: sum(c[name] for c in cs) for part, cs in parts.items()}
        out[name] = {part: n for part, n in counts.items() if n}
    return out


# ---- phase 15: bf16 training ------------------------------------------------
#: a2m's flagship bf16-vs-f32 gap on seeded features (written and held by
#: tests/test_torch_bf16.py)
BF16_GOLDEN = ROOT / 'a2m_torch' / 'testdata' / 'bf16_golden.json'
#: the port's bf16 results within this factor of a2m's bf16 gap (15 (a)),
#: or of the port's own CPU bf16-vs-f32 gap (15 (b)): a2m's rule, and on
#: the CPU the port's gap lies within 1.5x of a2m's at the tiny widths
#: (tests/test_torch_train_step.py)
BF16_GAP_FACTOR = 2.0
#: 15 (b): the full-width step's batch; parameter tensors of fewer
#: elements are held pooled per model (a relative L2 needs a sample: a
#: conv bias ahead of a BatchNorm has a gradient of rounding noise only)
BF16_STEP_BATCH, BF16_POOL_BELOW = 8, 1024
#: 15 (c): batches of the bf16 trainer's epoch; (d): timed steps
BF16_CAPS = {'train': 4, 'dev': 1}
BF16_SPEED_STEPS = 10
#: 15 (e): the A14b encoders on the card against the CPU, f32
ENCODER_TOL = 1e-4


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over flattened tensors, in float64."""
    import torch
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def bf16_forward_check() -> dict:
    """15 (a): the flagship in bf16 (K1 x2, bf16 operands) and in f32 (K1
    x2, f32 operands) on the golden's input, B = 128: the pose f32 as
    a2m's; the gap between the two, in mean and in the median over the
    rows of each row's max, within BF16_GAP_FACTOR of a2m's.  The batch's
    max is printed beside a2m's, not gated: where two keys of the
    flagship's saturated bottleneck attention nearly tie, a bf16 rounding
    moves one sample's attended frame (on the CPU the port's forward does
    so for one of the 128 rows, doubling the max; its mean 1.03x a2m's);
    a2m's own run on another summation order would flip others."""
    import numpy as np
    import torch
    from a2m_torch.config import GeneratorConfig
    from a2m_torch.models.generator import Generator
    from a2m_torch.weights import from_jax_variables, load_generator_npz

    golden = json.loads(BF16_GOLDEN.read_text())
    recipe = golden['recipe']
    x = torch.from_numpy(np.random.default_rng(recipe['seed'])
                         .standard_normal(recipe['shape'])
                         .astype(np.float32)).cuda()
    flat, _ = load_generator_npz(ROOT / recipe['npz'])
    poses, launches, ms = {}, {}, {}
    for tag, dtype, precise in (('bf16', torch.bfloat16, False),
                                ('f32', torch.float32, True)):
        model = Generator(GeneratorConfig(fused_gcn=True,
                                          fused_precise=precise),
                          dtype=dtype)
        model.load_state_dict(from_jax_variables(flat, model))
        model = model.cuda().eval()
        with torch.inference_mode():
            model(x)
            reset_kernel_launches()
            poses[tag] = model(x)
            torch.cuda.synchronize()
            launches[tag] = kernel_launches()
            ms[tag] = host_ms(lambda: model(x))
        require(launches[tag] == {**{k: 0 for k in launches[tag]},
                                  'gcn_stack': 2},
                f'bf16 forward {tag} launches {launches[tag]}: expected K1 '
                f'x2')
    require(str(poses['bf16'].dtype).replace('torch.', '')
            == golden['out_dtype'],
            f'bf16 pose dtype {poses["bf16"].dtype}, a2m\'s '
            f'{golden["out_dtype"]}')
    diff = (poses['bf16'].double() - poses['f32'].double()).abs()
    gap = dict(max=float(diff.max()), mean=float(diff.mean()),
               row_max_median=float(diff.amax(dim=(1, 2)).median()))
    finite = bool(torch.isfinite(poses['bf16']).all())
    print(f'bf16: forward B = {recipe["shape"][0]}: bf16 vs f32 on the '
          f'card {gap}, a2m\'s (JAX, CPU) {golden["gap"]} (bound '
          f'{BF16_GAP_FACTOR}x on mean and row_max_median), '
          f'max|pose| {float(poses["f32"].abs().max()):.4f} '
          f'({golden["max_abs_pose"]:.4f} a2m); ms per call bf16 '
          f'{ms["bf16"]:.2f} f32 {ms["f32"]:.2f} (host clock); launches '
          f'{launches}', flush=True)
    require(finite, 'bf16 pose not finite')
    for stat in ('mean', 'row_max_median'):
        require(gap[stat] <= BF16_GAP_FACTOR * golden['gap'][stat],
                f'bf16 forward gap {stat} {gap[stat]:.4e} above '
                f'{BF16_GAP_FACTOR} x a2m\'s {golden["gap"][stat]:.4e}')
    return dict(gap=gap, a2m_gap=golden['gap'], launches=launches,
                ms=ms, max_abs_pose=float(poses['f32'].abs().max()))


def bf16_step(device, dtype, precise: bool):
    """One ``g_step`` and one ``d_step`` of the full-width models (the
    flagship G; D from seed 0 with every attention gate at 0.5, so that no
    layer is hidden behind a zero gate; dropout 0, label noise 0, learning
    rate 0) from the same state on a seeded batch of BF16_STEP_BATCH (the
    last row wrap-padded), GCN stacks on the kernels (their plain versions
    on the CPU) in both steps.  Returns (metrics, gradients by name,
    launches by step)."""
    import numpy as np
    import torch
    from a2m_torch.config import (DiscriminatorConfig, GeneratorConfig,
                                  TrainConfig)
    from a2m_torch.models.discriminator import Discriminator
    from a2m_torch.models.generator import Generator
    from a2m_torch.train.train_step import init_states, make_train_steps
    from a2m_torch.weights import from_jax_variables, load_generator_npz

    g = Generator(GeneratorConfig(dropout=0.0, fused_gcn=True,
                                  fused_precise=precise), dtype=dtype)
    g.load_state_dict(from_jax_variables(
        load_generator_npz(ROOT / 'artifacts' / 'flagship_best_gen.npz')[0],
        g))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        d = Discriminator(DiscriminatorConfig(dropout=0.0), dtype=dtype)
    with torch.no_grad():
        for name, p in d.named_parameters():
            if name.endswith('gamma'):
                p.fill_(0.5)
    g, d = g.to(device), d.to(device)
    states = init_states(g, d, g_lr=0.0, d_lr=0.0)
    g_step, d_step, _ = make_train_steps(g, d,
                                         TrainConfig(fused_gcn_eval=True))
    rng = np.random.default_rng(15)
    n = BF16_STEP_BATCH
    mask = np.ones(n, np.float32)
    mask[-1] = 0
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    args = (put(rng.standard_normal((n, 64, 128)).astype(np.float32)),
            put((rng.standard_normal((n, 64, 104)) * 10
                 + 300).astype(np.float32)),
            torch.zeros(104, device=device), torch.full((104,), 10.0,
                                                        device=device))
    snapshot = [{k: v.clone() for k, v in m.state_dict().items()}
                for m in (g, d)]
    key = torch.Generator(device=device)
    grads, launches = {}, {}
    reset_kernel_launches()
    _, _, gm = g_step(*states, *args, 0.95, 0.0, key.manual_seed(1),
                      mask=put(mask))
    launches['g_step'] = kernel_launches()
    grads.update({f'g/{k}': p.grad.detach().float().cpu()
                  for k, p in g.named_parameters()})
    for m, state in zip((g, d), snapshot):
        m.load_state_dict(state)
    reset_kernel_launches()
    _, _, dm = d_step(*states, *args, 0.95, 0.05, 0.0, key.manual_seed(2),
                      mask=put(mask))
    launches['d_step'] = kernel_launches()
    grads.update({f'd/{k}': p.grad.detach().float().cpu()
                  for k, p in d.named_parameters()})
    metrics = {k: float(v) for k, v in {**gm, **dm}.items()}
    del g, d, states
    return metrics, grads, launches


def bf16_step_check() -> dict:
    """15 (b): one bf16 ``g_step`` and ``d_step`` at full width on the
    card against the same steps on the CPU's plain path: the losses
    (one vector) and each parameter's gradient (tensors of fewer than
    BF16_POOL_BELOW elements pooled per model) by relative L2 within
    BF16_GAP_FACTOR of the CPU's own bf16-vs-f32 gap (f32 operands in the
    stacks' plain versions)."""
    import torch
    t0 = time.perf_counter()
    card = bf16_step('cuda', torch.bfloat16, False)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    require(card[2]['g_step']['gcn_stack_fwd'] == 2
            and card[2]['g_step']['gcn_stack_bwd'] == 2
            and card[2]['d_step']['gcn_stack'] == 2
            and card[2]['d_step']['gcn_stack_fwd'] == 0,
            f'bf16 step launches {card[2]}: expected K3/K4 x2 a g_step, K1 '
            f'x2 a d_step')
    t0 = time.perf_counter()
    cpu16 = bf16_step('cpu', torch.bfloat16, False)
    cpu32 = bf16_step('cpu', torch.float32, True)
    cpu_s = time.perf_counter() - t0
    keys = sorted(cpu32[0])
    vec = [torch.tensor([r[0][k] for k in keys]) for r in (card, cpu16,
                                                            cpu32)]
    loss = dict(card=rel_l2(vec[0], vec[1]), gap=rel_l2(vec[1], vec[2]))
    require(all(v == v and abs(v) < float('inf') for v in card[0].values()),
            f'bf16 step losses {card[0]}')
    rows, pooled = [], {'g': [[], [], []], 'd': [[], [], []]}
    # a saturated attention softmax (the flagship's bottleneck) gives its
    # query and key an exact-zero gradient in bf16 and in f32: held to
    # zero on the card (1e-6 of the largest gradient), out of the ratios
    largest = max(float(t.abs().max()) for t in cpu32[1].values())
    zero = [k for k in sorted(cpu32[1])
            if not cpu32[1][k].any() and not cpu16[1][k].any()]
    for k in zero:
        require(float(card[1][k].abs().max()) <= 1e-6 * largest,
                f'bf16 step gradient {k}: zero on the CPU, '
                f'{float(card[1][k].abs().max()):.3e} on the card')
    for k in sorted(set(cpu32[1]) - set(zero)):
        trio = [r[1][k] for r in (card, cpu16, cpu32)]
        if trio[2].numel() < BF16_POOL_BELOW:
            for acc, t in zip(pooled[k[0]], trio):
                acc.append(t.flatten())
            continue
        rows.append((k, rel_l2(trio[0], trio[1]), rel_l2(trio[1], trio[2])))
    for m, acc in pooled.items():
        trio = [torch.cat(a) for a in acc]
        rows.append((f'{m}/<{BF16_POOL_BELOW} elements, {len(acc[0])} '
                     f'tensors>', rel_l2(trio[0], trio[1]),
                     rel_l2(trio[1], trio[2])))
    ratios = sorted(r[1] / r[2] for r in rows if r[2] > 0)
    worst = max(rows, key=lambda r: r[1] / max(r[2], 1e-300))
    print(f'bf16: full-width step B = {BF16_STEP_BATCH}, card against the '
          f'CPU plain path ({card_s:.1f} s card, {cpu_s:.1f} s CPU): losses '
          f'rel L2 {loss["card"]:.3e} (CPU bf16-vs-f32 {loss["gap"]:.3e}); '
          f'gradients of {len(rows)} tensors / pools ({len(zero)} zero '
          f'on the CPU and on the card): worst {worst[0]} '
          f'{worst[1]:.3e} (gap {worst[2]:.3e}); ratio to the gap median '
          f'{ratios[len(ratios) // 2]:.2f}, max {ratios[-1]:.2f}; '
          f'launches {card[2]}', flush=True)
    require(loss['card'] <= BF16_GAP_FACTOR * loss['gap'],
            f'bf16 step losses {card[0]} against the CPU {cpu16[0]} (f32 '
            f'{cpu32[0]})')
    for name, got, gap in rows:
        require(got <= BF16_GAP_FACTOR * gap,
                f'bf16 step gradient {name}: rel L2 {got:.3e} above '
                f'{BF16_GAP_FACTOR} x the CPU gap {gap:.3e}')
    require(all(r[2] > 0 for r in rows),
            f'bf16 step: a gradient equal in bf16 and f32: '
            f'{[r[0] for r in rows if r[2] == 0]}')
    return dict(losses=card[0], loss_rel_l2=loss, tensors=len(rows),
                zero_gradients=zero,
                worst=dict(name=worst[0], rel_l2=worst[1], gap=worst[2]),
                ratio_median=ratios[len(ratios) // 2],
                ratio_max=ratios[-1],
                launches=card[2], card_s=card_s, cpu_s=cpu_s)


def bf16_trainer_check(tmp: Path, loader, recipe: dict) -> dict:
    """15 (c): ``train.__main__.run`` with ``train.compute_dtype=bf16`` on
    phase 11's det fixture (1 epoch of 4 batches, 1 dev batch): launches,
    finite losses, the MFU line at the bf16 peak, an f32 checkpoint, a
    bit-equal resume, and the harness on its best G."""
    import torch
    from a2m_torch.config import Config, GeneratorConfig, apply_overrides
    from a2m_torch.eval.harness import evaluate_speaker
    from a2m_torch.train import checkpoint as ckpt_lib
    from a2m_torch.train.__main__ import run
    from a2m_torch.train.loop import Trainer

    save_dir = tmp / 'bf16_run'
    cfg = apply_overrides(Config(), [
        f'train.save_dir={save_dir}', 'train.n_epochs=1',
        'train.compute_dtype=bf16'])
    lines: list[str] = []

    def log(line: str) -> None:
        lines.append(line)
        print(f'bf16: trainer: {line}', flush=True)

    reset_kernel_launches()
    t0 = time.perf_counter()
    trainer = run(cfg, loader, log=log)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernel_launches()
    g_steps = launches['gcn_stack_fwd'] // 2
    d_steps = launches['gcn_stack'] // 2 - BF16_CAPS['dev']
    require(trainer.g_state.model.dtype == trainer.d_state.model.dtype
            == torch.bfloat16, 'the trainer\'s models are not bf16')
    require(g_steps > 0 and launches['gcn_stack_fwd']
            == launches['gcn_stack_bwd'] == 2 * g_steps,
            f'bf16 trainer launches {launches}: expected K3 and K4 x2 a G '
            f'step')
    require(launches['gcn_stack'] % 2 == 0
            and 0 < d_steps <= BF16_CAPS['train'],
            f'bf16 trainer launches {launches}: expected K1 x2 a D step and '
            f'dev batch')
    require(launches['log_mel'] == launches['log_mel_exact']
            == launches['gcn_stack_edge'] == 0,
            f'bf16 trainer launches {launches}: no K2, K2x or K5 launch')
    hist = trainer.loss_history
    require(hist['val_g'] and all(v == v and abs(v) < float('inf')
                                  for vs in hist.values() for v in vs),
            f'bf16 trainer losses {hist}')
    mfu = trainer.mfu_report
    mfu_lines = [line for line in lines if 'MFU' in line]
    require(mfu_lines and all(0 < mfu.get(k, {}).get('mfu', 0) < 1
                              for k in ('g_step', 'd_step')),
            f'bf16 MFU {mfu}')
    saved = ckpt_lib.CheckpointManager(save_dir / 'ckpt').restore()
    dtypes = {str(v.dtype) for prefix in 'gd'
              for v in saved[f'{prefix}_model'].values()}
    dtypes |= {str(v.dtype) for prefix in 'gd'
               for moments in saved[f'{prefix}_optimizer']['state'].values()
               for k, v in moments.items() if k != 'step'}
    require(dtypes == {'torch.float32'},
            f'bf16 checkpoint dtypes {dtypes}')
    resumed = Trainer.from_config(cfg, loader, log=log)
    require(resumed.start_epoch == 1 and same_state(trainer, resumed),
            'bf16 resume not bit-equal to the saved state')
    del trainer, resumed
    reset_kernel_launches()
    res = evaluate_speaker(None, recipe['speaker'],
                           save_dir / 'ckpt' / 'best_gen.npz',
                           batch_size=recipe['batch_size'],
                           alpha=tuple(recipe['alpha']),
                           cfg=Config(generator=GeneratorConfig()),
                           device='cuda', loader=loader)
    harness_launches = kernel_launches()
    test_batches = len(loader.test)
    require(harness_launches['gcn_stack'] == 2 * test_batches
            and res['n_clips'] == 348 and res['l2'] == res['l2'],
            f'harness on the bf16 best G: {res["n_clips"]} clips, launches '
            f'{harness_launches}')
    print(f'bf16: trainer run() {run_s:.2f} s (1 epoch of '
          f'{BF16_CAPS["train"]} batches, B = 128, build included): '
          f'{g_steps} G steps, {d_steps} D steps, launches {launches}; '
          f'checkpoint all f32, resume bit-equal; {mfu_lines[0]}; harness '
          f'on its best G: pck {res["pck_by_alpha"]} l2 {res["l2"]:.4f}, '
          f'launches {harness_launches}', flush=True)
    return dict(run_s=run_s, launches=launches, g_steps=g_steps,
                d_steps=d_steps, mfu=mfu, history=hist,
                harness=dict(pck=res['pck_by_alpha'], l2=res['l2'],
                             launches=harness_launches))


def bf16_speed_check(smi: str) -> dict:
    """15 (d): ``build_trainer`` in bf16 and in f32 at B = 128 (flagship G,
    seeded D and batch), both alive in one process: per step, blocks of
    BF16_SPEED_STEPS synchronised steps after two of warm-up in turns
    (f32, bf16, bf16, f32), their median host-clock ms by dtype; a
    profiled breakdown of three (kernel ms, categories, idle share); then
    ``config3_train_step(compute_dtype='bf16')``'s line."""
    import statistics

    import torch
    from a2m_torch.eval import benchmarks
    from a2m_torch.pipeline import build_trainer
    from a2m_torch.utils.profiling import kernel_breakdown

    gen = torch.Generator().manual_seed(0)
    audio = torch.randn(128, 64, 128, generator=gen).cuda()
    pose = (torch.randn(128, 64, 104, generator=gen) * 10 + 300).cuda()
    mask = torch.ones(128, device='cuda')
    steps: dict = {}
    for dtype in ('bf16', 'f32'):
        tr = build_trainer(batch=128, compute_dtype=dtype,
                           log=lambda line: None)
        real = tr.controller.label_params(0, is_real=True)
        fake = tr.controller.label_params(0, is_real=False)
        common = (tr.g_state, tr.d_state, audio, pose, tr.mean, tr.std)
        steps[dtype] = {
            'g_step': lambda tr=tr, c=common: tr.g_step(
                *c, real.smooth_real, real.noise_std, tr.key, mask=mask),
            'd_step': lambda tr=tr, c=common: tr.d_step(
                *c, real.smooth_real, fake.smooth_fake, real.noise_std,
                tr.key, mask=mask)}
    out: dict = {'launches': {}}
    for name in ('g_step', 'd_step'):
        times: dict = {'bf16': [], 'f32': []}
        for dtype in ('f32', 'bf16', 'bf16', 'f32'):
            fn = steps[dtype][name]
            for _ in range(2):
                fn()
            reset_kernel_launches()
            for _ in range(BF16_SPEED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[dtype].append((time.perf_counter() - t0) * 1e3)
            block = kernel_launches()
            total = out['launches'].setdefault(f'{dtype}_{name}',
                                               dict.fromkeys(block, 0))
            for k, n in block.items():
                total[k] += n
        n = 2 * 2 * BF16_SPEED_STEPS        # two launches a step, 2 blocks
        for dtype in ('bf16', 'f32'):
            got = out['launches'][f'{dtype}_{name}']
            want = ({'gcn_stack_fwd': n, 'gcn_stack_bwd': n}
                    if name == 'g_step' else {'gcn_stack': n})
            require(got == {**dict.fromkeys(got, 0), **want},
                    f'{dtype} {name} launches {got}: expected {want}')
            prof = kernel_breakdown(steps[dtype][name], 3)
            out[f'{dtype}_{name}'] = dict(
                median_ms=statistics.median(times[dtype]),
                min_ms=min(times[dtype]), max_ms=max(times[dtype]),
                **{k: prof[k] for k in ('wall_ms', 'kernel_ms', 'idle_share',
                                        'categories_ms')})
        b, f = out[f'bf16_{name}'], out[f'f32_{name}']
        conv = {k: v['categories_ms'].get('convolution', 0.0)
                for k, v in (('bf16', b), ('f32', f))}
        print(f'bf16: {name} B = 128 median {b["median_ms"]:.2f} ms bf16 '
              f'against {f["median_ms"]:.2f} f32 (host clock, 2 x '
              f'{BF16_SPEED_STEPS} synchronised steps each, in turns); '
              f'profiled: kernels {b["kernel_ms"]:.2f} against '
              f'{f["kernel_ms"]:.2f} ms, convolution {conv["bf16"]:.2f} '
              f'against {conv["f32"]:.2f} ms, idle {b["idle_share"]:.0%} '
              f'against {f["idle_share"]:.0%}; categories bf16 '
              f'{ {k: round(v, 2) for k, v in b["categories_ms"].items()} }'
              f', f32 { {k: round(v, 2) for k, v in f["categories_ms"].items()} }'
              f'; {smi}', flush=True)
    del steps
    torch.cuda.empty_cache()
    reset_kernel_launches()
    row = benchmarks.config3_train_step(compute_dtype='bf16')
    row['launches'] = kernel_launches()
    require(row['g_loss_finite'] and row['d_loss_finite']
            and row['launches']['gcn_stack_fwd']
            == row['launches']['gcn_stack_bwd'] == 2 * row['g_steps']
            and row['launches']['gcn_stack'] == 2 * row['d_steps'],
            f'config3 bf16 {row}')
    print(f'bf16: config3_train_step(compute_dtype=bf16): '
          f'{json.dumps(row)}', flush=True)
    out['config3'] = row
    return out


def encoders_card_check() -> dict:
    """15 (e): each A14b encoder at a2m's default widths (the required
    ones at the generator's 256), eval mode, seeded, B = 8, T = 64, on the
    card against the CPU in f32 (TF32 off): within ENCODER_TOL of
    max|y|."""
    import torch
    from a2m_torch.nn import encoders as enc
    cases = {
        'UNet1DFirstVersion': (lambda: enc.UNet1DFirstVersion(256, 256), 256),
        'PoseEncoder': (enc.PoseEncoder, 96),
        'PoseStyleEncoder': (enc.PoseStyleEncoder, 96),
        'TextEncoder1D': (enc.TextEncoder1D, 300),
        'AudioEncoder1D': (enc.AudioEncoder1D, 128),
        'PoseDecoder': (enc.PoseDecoder, (256 + 10) * 8),
        'StyleDecoder': (enc.StyleDecoder, 256 * 10),
        'LatentEncoder': (lambda: enc.LatentEncoder(256, 256), 256),
        'ClusterClassify': (enc.ClusterClassify, 256),
    }
    out = {}
    gen = torch.Generator().manual_seed(0)
    for name, (make, width) in cases.items():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = make().eval()
        x = torch.randn(8, 64, width, generator=gen)
        with torch.inference_mode():
            ref = model(x)
            got = model.cuda()(x.cuda()).cpu()
        err = float((got - ref).abs().max() / ref.abs().max())
        out[name] = dict(shape=list(got.shape), rel_err=err)
        require(got.shape == ref.shape and err <= ENCODER_TOL,
                f'{name} on the card: {err:.2e} of max|y| (shape '
                f'{tuple(got.shape)})')
    print(f'bf16: A14b encoders card vs CPU (f32, of max|y|): '
          f'{ {k: f"{v["rel_err"]:.1e}" for k, v in out.items()} }',
          flush=True)
    return out


def bf16_phase(smi: str) -> dict:
    """Phase 15: bf16 training through G, D, the steps and the trainer,
    and the A14b encoders, on the card."""
    import tempfile

    from a2m_torch.data.synthetic import synthetic_loader
    from a2m_torch.device import resolve_device

    t_phase = time.perf_counter()
    resolve_device('cuda')              # TF32 off, as every entry point
    golden = json.loads((ROOT / 'a2m_torch' / 'testdata'
                         / 'harness_golden.json').read_text())
    recipe = golden['recipe']
    out: dict = {}
    # the parts on the card alone first, then (b) with its CPU steps
    for part, fn in (('forward', bf16_forward_check),
                     ('speed', lambda: bf16_speed_check(smi)),
                     ('step', bf16_step_check)):
        t0 = time.perf_counter()
        out[part] = fn()
        out[part]['s'] = time.perf_counter() - t0
    loader = synthetic_loader(
        **{k: recipe[k] for k in ('speakers', 'intervals_per_speaker',
                                  'duration_s', 'seed', 'deterministic',
                                  'splits')},
        batch_size=recipe['batch_size'], window_hop=recipe['window_hop'],
        max_batches=BF16_CAPS)
    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:
        t0 = time.perf_counter()
        out['trainer'] = bf16_trainer_check(Path(tmp), loader, recipe)
        out['trainer']['s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['encoders'] = encoders_card_check()
    out['encoders']['s'] = time.perf_counter() - t0
    out['total_s'] = time.perf_counter() - t_phase
    print(f'bf16: phase {out["total_s"]:.1f} s (forward '
          f'{out["forward"]["s"]:.1f}, step {out["step"]["s"]:.1f}, trainer '
          f'{out["trainer"]["s"]:.1f}, speed {out["speed"]["s"]:.1f}, '
          f'encoders {out["encoders"]["s"]:.1f}); {smi}', flush=True)
    return out


def phase15_launches(bf16: dict) -> dict:
    """Per kernel, its launches in each part of phase 15 that ran it."""
    parts = {
        'forward': list(bf16['forward']['launches'].values()),
        'step': list(bf16['step']['launches'].values()),
        'trainer': [bf16['trainer']['launches']],
        'harness': [bf16['trainer']['harness']['launches']],
        'speed': list(bf16['speed']['launches'].values()),
        'config3_bf16': [bf16['speed']['config3']['launches']]}
    names = ('gcn_stack', 'log_mel', 'gcn_stack_fwd', 'gcn_stack_bwd',
             'gcn_stack_edge', 'log_mel_exact')
    out = {}
    for name in names:
        counts = {part: sum(c[name] for c in cs) for part, cs in parts.items()}
        out[name] = {part: n for part, n in counts.items() if n}
    return out


def main() -> int:
    t_script = time.perf_counter()
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
    data = data_phase()
    print(json.dumps({'data': data, 'device': smi}))
    train_eval = train_eval_phase()
    print(json.dumps({'train_eval': train_eval, 'device': smi}))
    exp = export_phase(smi)
    print(json.dumps({'export': exp, 'device': smi}))
    multi = dist_phase(smi)
    print(json.dumps({'dist': multi, 'device': smi}))
    migrate = migrate_phase(smi)
    print(json.dumps({'migrate': migrate, 'device': smi}))
    p14 = phase14_launches(migrate)
    bf16 = bf16_phase(smi)
    print(json.dumps({'bf16': bf16, 'device': smi}))
    p15 = phase15_launches(bf16)
    artifact_launches = {name: a['launches']
                         for name, a in exp['artifacts'].items()}
    stack = dict(route='cuda', library_ms=None)
    kernels = [
        dict(name='gcn_stack', source='a2m_torch/csrc/gcn_stack.cu',
             replaces='a2m/nn/pallas_gcn.py:228',
             launches=sl['launches']['gcn_stack'], **stack, **gcn,
             artifact_launches={k: v['gcn_stack']
                                for k, v in artifact_launches.items()}),
        dict(name='log_mel', route='cuda',
             source='a2m_torch/csrc/log_mel.cu',
             replaces='a2m/audio/pallas_mel.py:68',
             launches=sl['launches']['log_mel'], **mel,
             artifact_launches={k: v['log_mel']
                                for k, v in artifact_launches.items()}),
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
        dict(name='log_mel_exact', route='cuda',
             source='a2m_torch/csrc/log_mel_exact.cu',
             replaces='a2m/audio/pallas_mel.py:96',
             launches=data['extraction']['launches']['log_mel_exact'],
             max_abs_err=data['k2x']['max_abs_err'],
             **{k: data['k2x'][k] for k in ('ms', 'plain_ms', 'bound_ms',
                                            'bound_by', 'library_ms')}),
    ]
    for k in kernels:
        k['phase14_launches'] = p14[k['name']]
        k['phase15_launches'] = p15[k['name']]
    print(f'chip_smoke: phase 14 {migrate["total_s"]:.1f} s, phase 15 '
          f'{bf16["total_s"]:.1f} s, the whole script '
          f'{time.perf_counter() - t_script:.1f} s', flush=True)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--rank-worker']:
        sys.exit(rank_worker(json.loads(sys.argv[2])))
    sys.exit(main())
