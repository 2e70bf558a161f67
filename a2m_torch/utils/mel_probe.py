"""Where K2x, the exact-mode log-mel kernel (``csrc/log_mel_exact.cu``),
spends its cycles.

Run on the card, from the repository root::

    python -m a2m_torch.utils.mel_probe

It builds the kernel's source twice beside the port's own library
(``build/a2m_torch/probe/``), as the port builds it and with
``-DA2M_MEL_PROFILE``, whose thread 0 of every block adds the clock cycles
between consecutive points of its frame loop to a counter per phase (see
``PHASES``).  On 32 seeded intervals of 60 s at 45.6 kHz (``log_mel_512``:
171,008 frames of 2048, the data path's shapes) it prints the kernel's ms
(CUDA events, 10 calls after 2) as built and as profiled, the compiler's
registers, spills and shared memory of both builds, and the cycles of each
phase per block (mean over the first 132 blocks) and per frame of the
profiled thread, and the launch plan (frames and threads a block, shared
bytes, blocks an SM, registers and spills).  The last line is one JSON
object.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from a2m_torch import _build
from a2m_torch.audio import frontend, mel_kernel
from a2m_torch.utils.conv1d_probe import cuda_ms

SOURCE = 'log_mel_exact'
ENTRY = 'a2m_log_mel_exact'
#: phases of a frame in the loop: the copy's wait and the group barrier,
#: the next frame's copy issued and this one's gather, pass 1 and the first
#: exchange, pass 2 and the second, pass 3, the split, the mel's partial
#: sums, the mels' sums, log and store
PHASES = ('wait', 'gather', 'pass1', 'pass2', 'pass3', 'split', 'mel',
          'log_store')
SR, SECONDS, BATCH = 45600, 60, 32


def build_variants() -> tuple[dict, dict]:
    """The port's and the profiled build of SOURCE, compiled in parallel,
    bound like the port's; and each one's compiler lines."""
    out_dir = _build.BUILD_DIR / 'probe'
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / f'{SOURCE}.cu'
    variants = {'port': [], 'profiled': ['-DA2M_MEL_PROFILE']}
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, '-o',
         str(out_dir / f'lib{SOURCE}_{name}.so'), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in variants.items()}
    libs, logs = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for the {name} variant:\n{log}')
        logs[name] = [line.strip() for line in log.splitlines()
                      if re.search('registers|spill|smem', line)]
        lib = ctypes.CDLL(str(out_dir / f'lib{SOURCE}_{name}.so'))
        for fn, argtypes in _build.SIGNATURES[SOURCE].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.a2m_error_string.argtypes = [ctypes.c_int]
        lib.a2m_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, logs


def main() -> None:
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    libs, logs = build_variants()
    for name, lines in logs.items():
        for line in lines:
            print(f'{name}: {line}', flush=True)
    prof = libs['profiled']
    read_profile = getattr(prof, f'{ENTRY}_profile')
    reset_profile = getattr(prof, f'{ENTRY}_profile_reset')
    read_profile.argtypes = [ctypes.c_void_p]
    spec = frontend.spec_log_mel_512(SR)
    gen = torch.Generator().manual_seed(9)
    y = (torch.randn(BATCH, SR * SECONDS, generator=gen) * 0.1).cuda()
    n_frames = frontend.num_frames(spec, y.shape[1])

    def call():
        return frontend.log_mel(y, spec, True, n_frames)

    row = {}
    port = _build._loaded.get(SOURCE)
    t = frontend.fft_tables(spec, exact=True)
    try:
        _build._loaded[SOURCE] = libs['port']   # the port's source and flags
        info = mel_kernel.exact_launch(spec.n_fft, spec.n_mels,
                                       t['sched_weights'].shape[0],
                                       t['frame_len'], spec.hop_length)
        for name, lib in libs.items():
            _build._loaded[SOURCE] = lib
            row[f'{name}_ms'] = cuda_ms(call, 10)
        _build._loaded[SOURCE] = prof
        _build.check(prof, reset_profile(), 'mel_probe')
        call()
        torch.cuda.synchronize()
    finally:
        if port is None:
            _build._loaded.pop(SOURCE, None)
        else:
            _build._loaded[SOURCE] = port
    counters = np.zeros((1024, 8), np.uint64)
    _build.check(prof, read_profile(counters.ctypes.data), 'mel_probe')
    sms = info['sms']
    cycles = counters[:sms].astype(np.float64).mean(0)
    # the profiled thread is lane 0 of its block's first group
    frames = BATCH * n_frames / (info['frames_a_block'] * sms)
    row['plan'] = info
    row['frames_per_profiled_thread'] = frames
    row['cycles_per_block'] = {p: float(c) for p, c in zip(PHASES, cycles)}
    row['cycles_per_frame'] = {p: float(c) / frames
                               for p, c in zip(PHASES, cycles)}
    print(f'K2x log_mel_512 B={BATCH} {SECONDS} s ({BATCH * n_frames} '
          f'frames): ' + ' '.join(f'{k}={v:.4f}' for k, v in row.items()
                                  if isinstance(v, float))
          + '; cycles per frame: ' + ' '.join(
              f'{p}={c:.0f}' for p, c in row['cycles_per_frame'].items())
          + f' (total {sum(row["cycles_per_frame"].values()):.0f}); plan '
          + ' '.join(f'{k}={v}' for k, v in info.items()), flush=True)
    print(json.dumps({'mel_probe': row, 'source': SOURCE,
                      'compiler': logs, 'device': smi}))


if __name__ == '__main__':
    main()
