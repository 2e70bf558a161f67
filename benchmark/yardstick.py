"""The benchmark's yardstick: the card's published peaks, the operations and
bytes each hand-written kernel's function needs, and the kernel-name
categories of the device trace.

These are frozen copies, so that a change to the measured program cannot
change how it is measured: the stack cost functions of
``a2m_torch/nn/gcn_kernel.py`` (``stack_flops``, ``stack_bytes``,
``stack_edge_bytes``, ``stack_fwd_bytes``, ``stack_bwd_flops``,
``stack_bwd_bytes``), the log-mel's of ``a2m_torch/audio/mel_kernel.py``
(``log_mel_flops``, ``log_mel_bytes``), the peaks of
``a2m_torch/utils/mfu.py`` and the categories of
``a2m_torch/utils/profiling.py``.  One departure: :func:`stack_bwd_flops`
counts the work the backward needs, without the forward that today's
kernel recomputes (:func:`stack_bwd_recompute_flops` is that term).
"""

from __future__ import annotations

import math

import numpy as np

#: published dense peaks of one NVIDIA H100 SXM (data sheet), FLOP/s, by
#: the operands' precision; f32 is the rate outside the tensor cores
PEAK_FLOPS = {'bf16': 989e12, 'f32': 67e12}
#: HBM3 bandwidth of one H100 SXM, bytes/s
PEAK_BYTES = 3.35e12

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


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations at
    the precision's peak and the bytes at the memory's."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)


def num_params(f: int, heads: int, num_layers: int) -> int:
    gat = f * heads * f + 2 * heads * f + 3 * f
    conv = 2 * f * f + 3 * f
    return sum(gat if i % 2 == 0 else conv for i in range(num_layers))


def stack_flops(n: int, adjacency, f: int, heads: int,
                num_layers: int = 5) -> int:
    """Operations of the GCN stack on N graphs: the dense products, and the
    attention and A @ X over the edges only."""
    adj = np.asarray(adjacency)
    j = adj.shape[0]
    edges = int((adj != 0).sum())
    attended = int((np.maximum(adj, np.eye(j)) > 0).sum())
    total = 0
    for i in range(num_layers):
        if i % 2 == 0:
            total += 2 * n * j * f * heads * f
            total += 2 * 2 * n * j * heads * f
            total += 5 * n * heads * attended
            total += 2 * n * heads * attended * f
        else:
            total += 2 * n * edges * f
            total += 2 * 2 * n * j * f * f
        total += 8 * n * j * f
    return total


def stack_bytes(n: int, j: int, f: int, heads: int,
                num_layers: int = 5) -> int:
    """x read once, y written once, params and adjacency read once."""
    return 4 * (2 * n * j * f + num_params(f, heads, num_layers) + j * j)


def stack_edge_bytes(n: int, adjacency, f: int, heads: int,
                     num_layers: int = 5) -> int:
    """The edge form: x read once, y written once, params read once, and
    the routing constants in place of the dense adjacency."""
    adj = np.asarray(adjacency)
    j = adj.shape[0]
    edges = int((np.maximum(adj, np.eye(j)) > 0).sum())
    conv_edges = int((adj != 0).sum())
    return 4 * (2 * n * j * f + num_params(f, heads, num_layers)
                + 2 * edges + 2 * conv_edges + 2 * (j + 1))


def stack_fwd_bytes(n: int, j: int, f: int, heads: int,
                    num_layers: int = 5) -> int:
    """The forward that keeps its layer inputs for the backward: x read, y
    and the L - 1 stored inputs written, params and adjacency read."""
    return 4 * ((1 + num_layers) * n * j * f
                + num_params(f, heads, num_layers) + j * j)


def stack_bwd_flops(n: int, adjacency, f: int, heads: int,
                    num_layers: int = 5) -> int:
    """Operations the backward needs: two products per forward product (the
    gradient of each operand), over the edges where the forward runs over
    the edges.  The forward that today's kernel recomputes is not counted
    (:func:`stack_bwd_recompute_flops`)."""
    adj = np.asarray(adjacency)
    j = adj.shape[0]
    edges = int((adj != 0).sum())
    attended = int((np.maximum(adj, np.eye(j)) > 0).sum())
    total = 0
    for i in range(num_layers):
        if i % 2 == 0:
            total += 2 * 2 * n * j * f * heads * f
            total += 2 * 2 * n * heads * attended * f
            total += 8 * n * heads * attended
            total += 2 * 4 * n * j * heads * f
        else:
            total += 4 * 2 * n * j * f * f
            total += 2 * n * edges * f
        total += 16 * n * j * f
    return total


def stack_bwd_recompute_flops(n: int, adjacency, f: int, heads: int,
                              num_layers: int = 5) -> int:
    """The term the program's own count adds to :func:`stack_bwd_flops`:
    the forward its kernel recomputes."""
    return stack_flops(n, adjacency, f, heads, num_layers)


def stack_bwd_bytes(n: int, j: int, f: int, heads: int,
                    num_layers: int = 5) -> int:
    """x0, the L - 1 stored inputs and g read, dx written; params and
    adjacency read, the parameter gradients written."""
    return 4 * ((num_layers + 2) * n * j * f
                + 2 * num_params(f, heads, num_layers) + j * j)


def log_mel_flops(batch: int, n_frames: int, n_fft: int, nnz: int,
                  n_mels: int) -> int:
    """Operations the log-mel needs by its cheapest algorithm: window, a
    real FFT (2.5 n log2 n), power, the mel over the filterbank's nonzeros,
    log."""
    fft = round(2.5 * n_fft * math.log2(n_fft))
    k = n_fft // 2 + 1
    return batch * n_frames * (n_fft + fft + 3 * k + 2 * nnz + n_mels)


def log_mel_bytes(batch: int, n_samples: int, n_frames: int, frame_len: int,
                  hop: int, n_fft: int, nnz: int, n_mels: int,
                  table_bytes: int = 4) -> int:
    """The f32 samples the frames cover, the window, the filterbank's
    nonzeros and its per-mel index triples read once, the output written
    once."""
    covered = min(n_frames * min(frame_len, hop) + max(frame_len - hop, 0),
                  n_samples)
    return (4 * (batch * covered + 3 * n_mels + batch * n_frames * n_mels)
            + table_bytes * (n_fft + nnz))
