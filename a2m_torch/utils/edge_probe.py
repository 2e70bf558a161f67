"""Where a tensor-core GCN stack kernel spends its cycles, and what its
near-tie recomputation does to its distance from the plain version: K5's
bf16 mode (the edge form, ``csrc/gcn_stack_edge.cu``) or, with
``--dense``, K1's (``csrc/gcn_stack.cu``), or with ``--bwd`` K4's (the
backward, ``csrc/gcn_stack_bwd.cu``).

Run on the card, from the repository root::

    python -m a2m_torch.utils.edge_probe [--dense | --bwd]

It builds two more variants of the source beside the port's own library
(``build/a2m_torch/probe/``): one with ``-DA2M_TC_PROFILE``, whose thread 0
of every block adds the clock cycles between consecutive points to a
counter per phase (K5, barrier to barrier: tile load, GAT products,
softmax statistics, value path and LayerNorm, neighbour sums, GraphConv
products and LayerNorm, store; K1: tile load, GAT products, the barrier
after them, attention, its apply, LayerNorm, the barrier and operand
store after it, neighbour sums, GraphConv products, LayerNorm, the
barrier and operand store after it, store; K4: tile and layer loads, the recompute, LayerNorm and its
backward, the attention backward, the backward products into d_XW_h,
d_neigh and g, the weight gradients' products and their adds into the
block's partial row, the store; a phase that ends at no
barrier is warp 0's own), and one with ``-DA2M_TC_TIE_ULPS=-1``, which
never recomputes a near-tie element in k order.  For J in {10, 42} at the
path's shapes (K5: the serving call's N = 13,824 graphs; K1 and K4: the
one-window call's and the g_step's N = 8192; F = 64, H = 4, seeded
parameters at the scale of trained ones; K4 on the plain bf16 forward's
stash and a seeded cotangent, graphs near LeakyReLU's kink replaced as
``chip_smoke.py`` phase 4 replaces them) it prints the cycles per block of
each phase (mean over the first 132 blocks), the kernel's ms (CUDA events,
10 calls after 2) as built and as profiled, and for the port's library and
the variant without recomputation the mean rule's share: mean|kernel -
plain bf16| over mean|plain bf16 - plain f32| (K4: of dx and of the
parameter gradients), and for the port's library how that share spreads
over single graphs (the share of graphs whose own share exceeds 0.01 and
0.04, and the largest; K4: of dx): a call of a few graphs is held to the
rule by those alone.  The last line is one JSON object.
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

#: per kernel: source, its tensor-core entry, wrapper, plain version,
#: graphs, profiled phases and the counters a block
KERNELS = {
    'edge': dict(source='gcn_stack_edge', entry='a2m_gcn_stack_edge_tc',
                 fn=gk.gcn_stack_edge, plain=gk.gcn_stack_edge_plain,
                 n=13824,
                 phases=('load', 'gat_products', 'gat_statistics',
                         'gat_value_norm', 'conv_neighbours',
                         'conv_products_norm', 'store'), counters=8),
    'dense': dict(source='gcn_stack', entry='a2m_gcn_stack_tc',
                  fn=gk.gcn_stack, plain=gk.gcn_stack_plain, n=8192,
                  phases=('load', 'gat_products', 'gat_barrier',
                          'gat_attention', 'gat_apply', 'gat_norm',
                          'gat_barrier_store', 'conv_neighbours',
                          'conv_products', 'conv_norm', 'conv_barrier_store',
                          'store'), counters=16),
    'bwd': dict(source='gcn_stack_bwd', entry='a2m_gcn_stack_bwd_tc',
                fn=gk.gcn_stack_bwd, plain=gk.gcn_stack_bwd_plain, n=8192,
                phases=('load', 'recompute', 'norm_backward',
                        'attention_backward', 'dxw_dneigh', 'g_updates',
                        'barrier_fetch', 'weight_products',
                        'weight_adds', 'att_sums', 'barrier', 'store',
                        'dxw_steps', 'dxw_epilogue'),
                counters=16),
}
#: K4's inputs keep this far from LeakyReLU's kink (chip_smoke.KINK_MARGIN)
KINK_MARGIN = 2e-5
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


def probe_inputs(kind: str, n: int, j: int, f: int, heads: int, params,
                 a, gen: torch.Generator) -> tuple:
    """The wrapper's arguments: (x, params, a, heads) for a forward; for
    the backward (x, xs, g, params, a, heads), x's graphs within
    KINK_MARGIN of the kink (either mode) replaced by others."""
    x = torch.randn(n, j, f, generator=gen).cuda()
    if kind != 'bwd':
        return x, params, a, heads
    ok = torch.ones(n, dtype=torch.bool, device=x.device)
    for precise in (True, False):
        ok &= gk.kink_margin(x, params, a, heads,
                             precise=precise) > KINK_MARGIN
    good, bad = ok.nonzero()[:, 0], (~ok).nonzero()[:, 0]
    x[bad] = x[good[torch.arange(len(bad), device=x.device) % len(good)]]
    _, xs = gk.gcn_stack_fwd_plain(x, params, a, heads)
    g = torch.randn(n, j, f, generator=gen).cuda()
    return x, xs, g, params, a, heads


def build_variants(source: str) -> dict:
    """The variant libraries, compiled in parallel, bound like the port's."""
    out_dir = _build.BUILD_DIR / 'probe'
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / f'{source}.cu'
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, '-o',
         str(out_dir / f'lib{source}_{name}.so'), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for the {name} variant:\n{log}')
        lib = ctypes.CDLL(str(out_dir / f'lib{source}_{name}.so'))
        for fn, argtypes in _build.SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.a2m_error_string.argtypes = [ctypes.c_int]
        lib.a2m_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    which = ap.add_mutually_exclusive_group()
    which.add_argument('--dense', action='store_true',
                       help="K1's tensor-core kernel in place of K5's")
    which.add_argument('--bwd', action='store_true',
                       help="K4's tensor-core kernel in place of K5's")
    args = ap.parse_args()
    kind = 'dense' if args.dense else 'bwd' if args.bwd else 'edge'
    kernel = KERNELS[kind]
    source, fn, plain = kernel['source'], kernel['fn'], kernel['plain']
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    libs = {'port': _build.load(source), **build_variants(source)}
    prof = libs['profiled']
    read_profile = getattr(prof, f'{kernel["entry"]}_profile')
    reset_profile = getattr(prof, f'{kernel["entry"]}_profile_reset')
    read_profile.argtypes = [ctypes.c_void_p]
    f, heads, n = 64, 4, kernel['n']
    gen = torch.Generator().manual_seed(11)
    skeletons = {10: constants.body_edges(), 42: constants.hand_edges()}
    result = {}
    try:
        for j, edges in skeletons.items():
            params = stack_params(f, heads, gen).cuda()
            a = torch.as_tensor(constants.adjacency_from_edges(edges,
                                                               j)).cuda()
            call = probe_inputs(kind, n, j, f, heads, params, a, gen)
            # outputs: y; or dx and the parameter gradients
            names = ('dx_', 'dparams_') if kind == 'bwd' else ('',)
            ref = plain(*call)
            ref32 = plain(*call, precise=True)
            if kind != 'bwd':
                ref, ref32 = (ref,), (ref32,)
            gaps = [(r - r32).abs().mean().item()
                    for r, r32 in zip(ref, ref32)]
            row = {}
            for name, lib in libs.items():
                _build._loaded[source] = lib
                got = fn(*call)
                got = got if kind == 'bwd' else (got,)
                row[f'{name}_ms'] = cuda_ms(lambda: fn(*call), 10)
                if name != 'profiled':
                    for out, o, r, gap in zip(names, got, ref, gaps):
                        row[f'{name}_{out}mean_share'] = \
                            (o - r).abs().mean().item() / gap
                if name == 'port':
                    graph = (got[0] - ref[0]).abs().reshape(
                        n, -1).mean(1) / gaps[0]
                    row['graphs_above_0.01'] = (graph > 0.01).float(
                    ).mean().item()
                    row['graphs_above_0.04'] = (graph > 0.04).float(
                    ).mean().item()
                    row['largest_graph_share'] = graph.max().item()
            _build._loaded[source] = prof
            reset_profile()
            fn(*call)
            torch.cuda.synchronize()
            counters = np.zeros((1024, kernel['counters']), np.uint64)
            _build.check(prof, read_profile(counters.ctypes.data),
                         'edge_probe')
            cycles = counters[:132].astype(np.float64).mean(0)
            row['cycles_per_block'] = {p: float(c) for p, c in
                                       zip(kernel['phases'], cycles)}
            result[f'J={j}'] = row
            cycles = ' '.join(f'{p}={c:.0f}' for p, c in
                              row['cycles_per_block'].items())
            print(f'J={j} N={n}: ' + ' '.join(
                f'{k}={v:.4f}' for k, v in row.items()
                if not isinstance(v, dict)) + f'; cycles per block: {cycles}',
                flush=True)
    finally:
        _build._loaded[source] = libs['port']
    print(json.dumps({'edge_probe': result, 'kernel': kind, 'n': n,
                      'device': smi}))


if __name__ == '__main__':
    main()
