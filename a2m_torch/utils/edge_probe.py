"""Where the tensor-core edge-form kernel (K5's bf16 mode,
``csrc/gcn_stack_edge.cu``) spends its cycles, and what its near-tie
recomputation does to its distance from the plain version.

Run on the card, from the repository root::

    python -m a2m_torch.utils.edge_probe

It builds two more variants of the source beside the port's own library
(``build/a2m_torch/probe/``): one with ``-DA2M_TC_PROFILE``, whose thread 0
of every block adds the clock cycles between consecutive barriers to a
counter per phase (tile load, GAT products, softmax statistics, value path
and LayerNorm, neighbour sums, GraphConv products and LayerNorm, store),
and one with ``-DA2M_TC_TIE_ULPS=-1``, which never recomputes a near-tie
element in k order.  For J in {10, 42} at the serving shapes (N = 13,824
graphs, F = 64, H = 4, seeded parameters at the scale of trained ones) it
prints the cycles per block of each phase (mean over the first 132
blocks), the kernel's ms (CUDA events, 10 calls after 2) as built and as
profiled, and for the port's library and the variant without recomputation
the mean rule's share: mean|kernel - plain bf16| over mean|plain bf16 -
plain f32|, and for the port's library how that share spreads over single
graphs (the share of graphs whose own share exceeds 0.01 and 0.04, and
the largest): a call of a few graphs is held to the rule by those alone.
The last line is one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from a2m_torch import _build, constants
from a2m_torch.nn import gcn_kernel as gk
from a2m_torch.utils.conv1d_probe import cuda_ms

PHASES = ('load', 'gat_products', 'gat_statistics', 'gat_value_norm',
          'conv_neighbours', 'conv_products_norm', 'store')
VARIANTS = {'profiled': ['-DA2M_TC_PROFILE'],
            'no_recompute': ['-DA2M_TC_TIE_ULPS=-1']}


def stack_params(f: int, heads: int, gen: torch.Generator) -> torch.Tensor:
    """Seeded stack parameters at the scale of trained ones (also
    ``chip_smoke.py``'s)."""
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
    return gk.pack_params(layers)


def build_variants() -> dict:
    """The variant libraries, compiled in parallel, bound like the port's."""
    out_dir = _build.BUILD_DIR / 'probe'
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / 'gcn_stack_edge.cu'
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, '-o',
         str(out_dir / f'libgcn_stack_edge_{name}.so'), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for the {name} variant:\n{log}')
        lib = ctypes.CDLL(str(out_dir / f'libgcn_stack_edge_{name}.so'))
        for fn, argtypes in _build.SIGNATURES['gcn_stack_edge'].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.a2m_error_string.argtypes = [ctypes.c_int]
        lib.a2m_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> None:
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    libs = {'port': _build.load('gcn_stack_edge'), **build_variants()}
    prof = libs['profiled']
    prof.a2m_gcn_stack_edge_tc_profile.argtypes = [ctypes.c_void_p]
    f, heads, n = 64, 4, 13824
    gen = torch.Generator().manual_seed(11)
    skeletons = {10: constants.body_edges(), 42: constants.hand_edges()}
    result = {}
    try:
        for j, edges in skeletons.items():
            params = stack_params(f, heads, gen).cuda()
            a = torch.as_tensor(constants.adjacency_from_edges(edges,
                                                               j)).cuda()
            x = torch.randn(n, j, f, generator=gen).cuda()
            ref = gk.gcn_stack_edge_plain(x, params, a, heads)
            gap = (ref - gk.gcn_stack_edge_plain(
                x, params, a, heads, precise=True)).abs().mean().item()
            row = {}
            for name, lib in libs.items():
                _build._loaded['gcn_stack_edge'] = lib
                got = gk.gcn_stack_edge(x, params, a, heads)
                row[f'{name}_ms'] = cuda_ms(
                    lambda: gk.gcn_stack_edge(x, params, a, heads), 10)
                if name != 'profiled':
                    row[f'{name}_mean_share'] = \
                        (got - ref).abs().mean().item() / gap
                if name == 'port':
                    graph = (got - ref).abs().reshape(n, -1).mean(1) / gap
                    row['graphs_above_0.01'] = (graph > 0.01).float(
                    ).mean().item()
                    row['graphs_above_0.04'] = (graph > 0.04).float(
                    ).mean().item()
                    row['largest_graph_share'] = graph.max().item()
            _build._loaded['gcn_stack_edge'] = prof
            prof.a2m_gcn_stack_edge_tc_profile_reset()
            gk.gcn_stack_edge(x, params, a, heads)
            torch.cuda.synchronize()
            counters = np.zeros((1024, 8), np.uint64)
            _build.check(prof, prof.a2m_gcn_stack_edge_tc_profile(
                counters.ctypes.data), 'edge_probe')
            cycles = counters[:132].astype(np.float64).mean(0)
            row['cycles_per_block'] = {p: float(c) for p, c in
                                       zip(PHASES, cycles)}
            result[f'J={j}'] = row
            cycles = ' '.join(f'{p}={c:.0f}' for p, c in
                              row['cycles_per_block'].items())
            print(f'J={j} N={n}: ' + ' '.join(
                f'{k}={v:.4f}' for k, v in row.items()
                if not isinstance(v, dict)) + f'; cycles per block: {cycles}',
                flush=True)
    finally:
        _build._loaded['gcn_stack_edge'] = libs['port']
    print(json.dumps({'edge_probe': result, 'device': smi}))


if __name__ == '__main__':
    main()
