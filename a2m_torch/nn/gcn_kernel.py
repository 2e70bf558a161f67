"""Fused GCN stack: CUDA kernel wrapper, its plain version, its cost model.

The kernel (``a2m_torch/csrc/gcn_stack.cu``) replaces the Pallas TPU kernel
``a2m/nn/pallas_gcn.py::_kernel`` (called by ``fused_gcn_stack``,
``:228-334``): the eval forward of the 5-layer GAT/GraphConv stack with
LayerNorm, LeakyReLU and residual, for (..., J, F) graph features.

:func:`gcn_stack` launches the kernel for CUDA tensors and runs
:func:`gcn_stack_plain` for CPU tensors, and for nothing else.  The plain
version follows the Pallas kernel step by step (dense masked attention,
where the CUDA kernel loops over the graph's edges: the same function),
with the same bf16 rounding of matmul operands when ``precise`` is false.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
SLOPE = 0.2


def pack_params(layers) -> torch.Tensor:
    """Per-layer tensors in kernel order -> one flat f32 buffer.

    ``layers[i]`` for a GAT layer (even i): ``(W (F, H*F), att_src (H, F),
    att_dst (H, F), bias, ln_scale, ln_bias)``; for a GraphConv layer:
    ``(W_rel (F, F), W_root (F, F), bias, ln_scale, ln_bias)``.  Weights are
    in a2m's (in, out) layout."""
    return torch.cat([t.reshape(-1).float() for layer in layers
                      for t in layer]).contiguous()


def num_params(f: int, heads: int, num_layers: int) -> int:
    gat = f * heads * f + 2 * heads * f + 3 * f
    conv = 2 * f * f + 3 * f
    return sum(gat if i % 2 == 0 else conv for i in range(num_layers))


def _unpack(params: torch.Tensor, f: int, heads: int, num_layers: int):
    shapes_gat = [(f, heads * f), (heads, f), (heads, f), (f,), (f,), (f,)]
    shapes_conv = [(f, f), (f, f), (f,), (f,), (f,)]
    out, p = [], 0
    for i in range(num_layers):
        layer = []
        for shape in (shapes_gat if i % 2 == 0 else shapes_conv):
            size = 1
            for d in shape:
                size *= d
            layer.append(params[p:p + size].view(shape))
            p += size
        out.append(layer)
    return out


def _op(t: torch.Tensor, precise: bool) -> torch.Tensor:
    """A matmul operand as the kernel sees it: f32, or rounded to bf16."""
    return t if precise else t.to(torch.bfloat16).float()


def gcn_stack_plain(x: torch.Tensor, params: torch.Tensor,
                    adjacency: torch.Tensor, heads: int, num_layers: int = 5,
                    precise: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel on (N, J, F) f32."""
    n, j, f = x.shape
    eye = torch.eye(j, dtype=torch.bool, device=x.device)
    mask = (adjacency > 0) | eye
    x = x.float()
    for i, layer in enumerate(_unpack(params, f, heads, num_layers)):
        residual = x
        if i % 2 == 0:
            w, att_src, att_dst, bias, ln_scale, ln_bias = layer
            xw = (_op(x, precise).reshape(n * j, f) @ _op(w, precise))
            xw = xw.view(n, j, heads, f)
            a_src = (xw * att_src).sum(-1)                  # (N, J, H)
            a_dst = (xw * att_dst).sum(-1)
            e = F.leaky_relu(a_dst[:, :, None, :] + a_src[:, None, :, :],
                             SLOPE)                         # (N, Jd, Js, H)
            e = e.masked_fill(~mask[None, :, :, None], float('-inf'))
            alpha = torch.softmax(e, dim=2)
            out = torch.einsum('nijh,njhf->nif', _op(alpha, precise),
                               _op(xw, precise)) / heads
        else:
            w_rel, w_root, bias, ln_scale, ln_bias = layer
            neigh = torch.einsum('ij,njf->nif', adjacency, _op(x, precise))
            out = (_op(neigh, precise).reshape(n * j, f) @ _op(w_rel, precise)
                   + _op(x, precise).reshape(n * j, f) @ _op(w_root, precise)
                   ).view(n, j, f)
        out = out + bias
        mean = out.mean(-1, keepdim=True)
        var = ((out - mean) ** 2).mean(-1, keepdim=True)
        out = (out - mean) * torch.rsqrt(var + LN_EPS) * ln_scale + ln_bias
        x = F.leaky_relu(out, SLOPE) + residual
    return x


def gcn_stack(x: torch.Tensor, params: torch.Tensor,
              adjacency: torch.Tensor, heads: int, num_layers: int = 5,
              precise: bool = False) -> torch.Tensor:
    """Fused stack on (..., J, F) f32; returns the same shape.

    ``params`` from :func:`pack_params`; ``adjacency`` (J, J) f32, A[dst,
    src] without self-loops.  CUDA tensors launch the kernel, CPU tensors
    run :func:`gcn_stack_plain`."""
    j, f = x.shape[-2:]
    if x.dtype != torch.float32 or params.dtype != torch.float32 \
            or adjacency.dtype != torch.float32:
        raise TypeError('gcn_stack: x, params and adjacency must be float32')
    if adjacency.shape != (j, j):
        raise ValueError(f'gcn_stack: adjacency {tuple(adjacency.shape)} '
                         f'does not match J={j}')
    if params.shape != (num_params(f, heads, num_layers),):
        raise ValueError(f'gcn_stack: params {tuple(params.shape)} do not '
                         f'match F={f}, heads={heads}, layers={num_layers}')
    if not (x.device == params.device == adjacency.device):
        raise ValueError('gcn_stack: tensors on different devices')
    xf = x.reshape(-1, j, f)
    if x.device.type == 'cpu':
        return gcn_stack_plain(xf, params, adjacency, heads, num_layers,
                               precise).reshape(x.shape)
    if x.device.type != 'cuda':
        raise ValueError(f'gcn_stack: no kernel for device {x.device}')
    if f % 4 or f > 64 or params.data_ptr() % 16:
        raise ValueError('gcn_stack: the kernel needs F % 4 == 0, F <= 64 '
                         'and params aligned to 16 bytes')
    from a2m_torch import _build
    xf = xf.contiguous()
    params, adjacency = params.contiguous(), adjacency.contiguous()
    out = torch.empty_like(xf)
    lib = _build.load('gcn_stack')
    code = lib.a2m_gcn_stack(
        xf.data_ptr(), out.data_ptr(), params.data_ptr(),
        adjacency.data_ptr(), xf.shape[0], j, f, heads, num_layers,
        int(precise), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, 'gcn_stack')
    gcn_stack.launches += 1
    return out.reshape(x.shape)


#: kernel launches since the count was last set to 0
gcn_stack.launches = 0


def stack_flops(n: int, adjacency, f: int, heads: int,
                num_layers: int = 5) -> int:
    """Operations the stack needs on N graphs of this adjacency: the dense
    matmuls, and the attention and A @ X over the edges only (the masked
    entries contribute exact zeros), as the kernel computes them."""
    adj = np.asarray(adjacency)
    j = adj.shape[0]
    edges = int((adj != 0).sum())                       # A @ X terms
    attended = int((np.maximum(adj, np.eye(j)) > 0).sum())   # GAT terms
    total = 0
    for i in range(num_layers):
        if i % 2 == 0:
            total += 2 * n * j * f * heads * f          # X @ W
            total += 2 * 2 * n * j * heads * f          # a_src, a_dst
            total += 5 * n * heads * attended           # leaky, softmax
            total += 2 * n * heads * attended * f       # alpha @ XW
        else:
            total += 2 * n * edges * f                  # A @ X
            total += 2 * 2 * n * j * f * f              # @ W_rel, @ W_root
        total += 8 * n * j * f                          # LN, leaky, residual
    return total


def stack_bytes(n: int, j: int, f: int, heads: int,
                num_layers: int = 5) -> int:
    """x read once, y written once, params and adjacency read once."""
    return 4 * (2 * n * j * f + num_params(f, heads, num_layers) + j * j)
