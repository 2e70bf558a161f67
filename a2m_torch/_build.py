"""Builds the port's CUDA sources at first use and binds them with ctypes.

Each ``a2m_torch/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, under ``build/a2m_torch/``
at the repository root (ignored by git).  The file name carries a hash of
the source, the shared headers and the flags, so an edited source rebuilds
and a built one loads at once.  Sources that are not built yet compile in parallel, one ``nvcc`` each.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'build' / 'a2m_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_P, _I, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_double)
#: C entry points of each source: name -> argtypes (all return an int error
#: code, 0 on success; ``a2m_error_string`` names it)
SIGNATURES = {
    'gcn_stack': {
        'a2m_gcn_stack': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        'a2m_gcn_stack_fwd': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        'a2m_gcn_stack_tc': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _P],
        'a2m_gcn_stack_fwd_tc': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
        'a2m_gcn_stack_tc_info': [_I, _I, _P],
    },
    'gcn_stack_bwd': {
        'a2m_gcn_stack_bwd': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _P],
        'a2m_gcn_stack_bwd_blocks': [_I, _I, _I, _I, _I],
        'a2m_gcn_stack_bwd_tc': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P],
        'a2m_gcn_stack_bwd_tc_info': [_I, _P],
    },
    'gcn_stack_edge': {
        'a2m_gcn_stack_edge': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _P],
        'a2m_gcn_stack_edge_tile': [_I, _I, _I, _I],
        'a2m_gcn_stack_edge_tc': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        'a2m_gcn_stack_edge_tc_info': [_I, _P],
    },
    'log_mel': {
        'a2m_log_mel': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _F, _P],
    },
    'log_mel_exact': {
        'a2m_log_mel_exact': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _D, _P],
        'a2m_log_mel_exact_info': [_I, _I, _I, _I, _I, _P],
    },
    'rel_attention': {
        'a2m_rel_attention': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                              _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and (Path(root) / 'bin' / 'nvcc').exists():
            return str(Path(root) / 'bin' / 'nvcc')
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): '
                       'the CUDA kernels of a2m_torch cannot be built')


def library_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    for header in sorted(CSRC.glob('*.cuh')):
        src += header.read_bytes()
    digest = hashlib.sha1(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{digest[:12]}.so'


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together.  Returns each compiled source's compiler
    output (register and shared-memory use from ``-Xptxas -v``); raises on
    the first failed compile, after all of them have ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed for ' + ', '.join(failed) + ':\n'
                           + '\n'.join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.a2m_error_string.argtypes = [ctypes.c_int]
    lib.a2m_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code:
        raise RuntimeError(f'{what}: CUDA error {code} '
                           f'({lib.a2m_error_string(code).decode()})')


def build_all() -> tuple[float, dict[str, str]]:
    """Build every kernel of the port; returns (seconds, compiler logs)."""
    t0 = time.perf_counter()
    logs = build()
    for name in SIGNATURES:
        load(name)
    return time.perf_counter() - t0, logs
