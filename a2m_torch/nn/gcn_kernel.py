"""Fused GCN stack: CUDA kernel wrappers, their plain versions, cost models.

Four kernels replace the Pallas TPU kernels of ``a2m/nn/pallas_gcn.py`` for
the 5-layer GAT/GraphConv stack with LayerNorm, LeakyReLU and residual on
(..., J, F) graph features:

* :func:`gcn_stack` (``csrc/gcn_stack.cu``) replaces ``_kernel`` (called by
  ``fused_gcn_stack``, ``:228-334``): the gradient-free forward;
* :func:`gcn_stack_fwd` (same source, own entry point) replaces
  ``_fwd_kernel`` (``:529``, called by ``_fwd_with_residuals``): the forward
  that also stores the input of layers 2..L;
* :func:`gcn_stack_bwd` (``csrc/gcn_stack_bwd.cu``) replaces ``_bwd_kernel``
  (``:557``, called by ``_bwd_call``): the reverse walk that recomputes each
  layer from its stored input and returns ``dx`` and every parameter
  gradient;
* :func:`gcn_stack_edge` (``csrc/gcn_stack_edge.cu``) replaces
  ``_kernel_edge`` (``:879``, called by ``_fused_impl_edge``): the
  gradient-free forward in edge form, a tile of graphs in joint-major
  order with the routing over the constant edge lists of
  :func:`edge_matrices`, and a2m's rounding points for that kernel, which
  are not ``_kernel``'s.

:func:`gcn_stack_trainable` joins them as one ``torch.autograd.Function``,
the twin of ``_make_trainable`` (``:722-780``).

Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors, and for nothing else.  The plain versions follow the
Pallas kernels step by step (dense masked attention, where the CUDA kernels
loop over the graph's edges: the same function), with the same bf16
rounding of matmul operands when ``precise`` is false.  With ``precise``
all forward kernels compute one function up to f32 summation order.
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


def _edge_mask(adjacency: torch.Tensor) -> torch.Tensor:
    j = adjacency.shape[0]
    return (adjacency > 0) | torch.eye(j, dtype=torch.bool,
                                       device=adjacency.device)


def _attention(xw, att_src, att_dst, mask):
    """(alpha, e) of a GAT layer from the projected features (N, J, H, F):
    ``e`` the raw logits (N, Jd, Js, H), ``alpha`` their masked softmax
    over the source axis after LeakyReLU."""
    a_src = (xw * att_src).sum(-1)                      # (N, J, H)
    a_dst = (xw * att_dst).sum(-1)
    e = a_dst[:, :, None, :] + a_src[:, None, :, :]     # (N, Jd, Js, H)
    em = F.leaky_relu(e, SLOPE).masked_fill(~mask[None, :, :, None],
                                            float('-inf'))
    return torch.softmax(em, dim=2), e


def _pre_norm(i: int, x, layer, adjacency, mask, heads: int, precise: bool):
    """Layer ``i``'s output before LayerNorm, bias included."""
    n, j, f = x.shape
    if i % 2 == 0:
        w, att_src, att_dst, bias = layer[:4]
        xw = (_op(x, precise).reshape(n * j, f) @ _op(w, precise))
        xw = xw.view(n, j, heads, f)
        alpha, _ = _attention(xw, att_src, att_dst, mask)
        out = torch.einsum('nijh,njhf->nif', _op(alpha, precise),
                           _op(xw, precise)) / heads
    else:
        w_rel, w_root, bias = layer[:3]
        neigh = torch.einsum('ij,njf->nif', adjacency, _op(x, precise))
        out = (_op(neigh, precise).reshape(n * j, f) @ _op(w_rel, precise)
               + _op(x, precise).reshape(n * j, f) @ _op(w_root, precise)
               ).view(n, j, f)
    return out + bias


def _ln_stats(h):
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + LN_EPS)
    return (h - mean) * inv, inv


def gcn_stack_fwd_plain(x: torch.Tensor, params: torch.Tensor,
                        adjacency: torch.Tensor, heads: int,
                        num_layers: int = 5, precise: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the stash forward on (N, J, F) f32:
    ``(y, xs)`` with ``xs[k]`` the input of layer ``k + 2``,
    (L - 1, N, J, F)."""
    mask = _edge_mask(adjacency)
    x = x.float()
    xs = []
    for i, layer in enumerate(_unpack(params, x.shape[-1], heads,
                                      num_layers)):
        if i > 0:
            xs.append(x)
        xhat, _ = _ln_stats(_pre_norm(i, x, layer, adjacency, mask, heads,
                                      precise))
        x = F.leaky_relu(xhat * layer[-2] + layer[-1], SLOPE) + x
    stash = torch.stack(xs) if xs else x.new_empty((0,) + tuple(x.shape))
    return x, stash


def gcn_stack_plain(x: torch.Tensor, params: torch.Tensor,
                    adjacency: torch.Tensor, heads: int, num_layers: int = 5,
                    precise: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel on (N, J, F) f32."""
    return gcn_stack_fwd_plain(x, params, adjacency, heads, num_layers,
                               precise)[0]


def edge_matrices(adjacency: np.ndarray) -> tuple:
    """(S, D, D.T): the constant 0/1 incidence matrices (E, J), (E, J),
    (J, E) of the E edges of A + I, from A[dst, src] without self-loops
    (they are added here, as the GAT mask adds them).  Row e of S has its 1
    at the edge's source, row e of D at its destination; edges are sorted
    by destination, then source."""
    j = adjacency.shape[0]
    mask = np.maximum(np.asarray(adjacency, np.float32),
                      np.eye(j, dtype=np.float32)) > 0
    dst, src = np.nonzero(mask)
    e = len(dst)
    s_mat = np.zeros((e, j), np.float32)
    d_mat = np.zeros((e, j), np.float32)
    s_mat[np.arange(e), src] = 1.0
    d_mat[np.arange(e), dst] = 1.0
    return s_mat, d_mat, np.ascontiguousarray(d_mat.T)


#: adjacency tensor -> its routing constants on the tensor's device
_routing: dict = {}


def edge_routing(adjacency: torch.Tensor) -> dict:
    """The edge form's constants of one adjacency tensor, built once (one
    read of the adjacency from its device) and kept on that device:
    ``src``/``dst`` (E,) int64, the index lists read off S and D;
    ``dt_mat`` (J, E), D.T; and the kernel's buffers ``route`` int32 [src,
    dst, ptr (J + 1), conv_src, conv_ptr (J + 1)] and ``conv_w`` f32, with
    ``ptr`` the per-destination ranges of the E edges and ``conv_*`` the
    same for the Ec nonzero entries of A itself (GraphConv's A @ X)."""
    key = (adjacency.data_ptr(), adjacency._version, adjacency.device)
    if key not in _routing:
        adj = adjacency.detach().cpu().numpy()
        j = adj.shape[0]
        s_mat, d_mat, dt_mat = edge_matrices(adj)
        src, dst = s_mat.argmax(1), d_mat.argmax(1)
        cdst, csrc = np.nonzero(adj)

        def ranges(sorted_dst):
            return np.searchsorted(sorted_dst, np.arange(j + 1))

        route = np.concatenate([src, dst, ranges(dst), csrc, ranges(cdst)])
        dev = adjacency.device
        _routing[key] = dict(
            src=torch.as_tensor(src, device=dev),
            dst=torch.as_tensor(dst, device=dev),
            dt_mat=torch.as_tensor(dt_mat, device=dev),
            route=torch.as_tensor(route.astype(np.int32), device=dev),
            conv_w=torch.as_tensor(adj[cdst, csrc].astype(np.float32),
                                   device=dev),
            edges=len(src), conv_edges=len(csrc))
    return _routing[key]


def gcn_stack_edge_plain(x: torch.Tensor, params: torch.Tensor,
                         adjacency: torch.Tensor, heads: int,
                         num_layers: int = 5, precise: bool = False
                         ) -> torch.Tensor:
    """Plain PyTorch version of the edge-form kernel on (N, J, F) f32.

    Written after ``_kernel_edge`` step by step in its (J, N, F) layout,
    with its rounding points: ``XW`` from rounded x and W, kept f32 for
    ``a_src``/``a_dst``; the softmax statistics ``m`` and ``denom`` densely
    per destination; per edge ``alpha = exp(logit - m[dst]) / denom[dst]``
    in f32, never rounded; the gathered rounded ``XW_h[src]`` times alpha in
    f32, the product rounded again on its way into the sum over each
    destination's edges (``D.T @ z``); GraphConv as ``A @ x`` once, its
    sums rounded for ``@ W_rel``."""
    n, j, f = x.shape
    routing = edge_routing(adjacency)
    src, dst, dt_mat = routing['src'], routing['dst'], routing['dt_mat']
    mask = _edge_mask(adjacency)[:, :, None]
    x = x.float().permute(1, 0, 2)                      # (J, N, F)
    for i, layer in enumerate(_unpack(params, f, heads, num_layers)):
        residual = x
        if i % 2 == 0:
            w, att_src, att_dst, bias = layer[:4]
            xw = (_op(x, precise).reshape(j * n, f) @ _op(w, precise)
                  ).view(j, n, heads, f)
            out = torch.zeros_like(x)
            for h in range(heads):
                xwh = xw[:, :, h]                       # (J, N, F)
                a_src = (xwh * att_src[h]).sum(-1)      # (J, N)
                a_dst = (xwh * att_dst[h]).sum(-1)
                e = F.leaky_relu(a_dst[:, None] + a_src[None], SLOPE)
                e = torch.where(mask, e, e.new_tensor(-1e30))  # (Jd, Js, N)
                m = e.amax(1)
                denom = torch.where(mask, torch.exp(e - m[:, None]),
                                    e.new_zeros(())).sum(1)
                logit = F.leaky_relu(a_src[src] + a_dst[dst], SLOPE)
                alpha = torch.exp(logit - m[dst]) / denom[dst]   # (E, N)
                z = _op(xwh, precise)[src] * alpha[:, :, None]
                out = out + (dt_mat @ _op(z, precise).reshape(len(src), -1)
                             ).view(j, n, f)
            x = out / heads + bias
        else:
            w_rel, w_root, bias = layer[:3]
            neigh = (_op(adjacency, precise)
                     @ _op(x, precise).reshape(j, n * f)).view(j, n, f)
            x = (_op(neigh, precise) @ _op(w_rel, precise)
                 + _op(x, precise) @ _op(w_root, precise)) + bias
        xhat, _ = _ln_stats(x)
        x = F.leaky_relu(xhat * layer[-2] + layer[-1], SLOPE) + residual
    return x.permute(1, 0, 2).contiguous()


def gcn_stack_bwd_plain(x0: torch.Tensor, xs: torch.Tensor, g: torch.Tensor,
                        params: torch.Tensor, adjacency: torch.Tensor,
                        heads: int, num_layers: int = 5,
                        precise: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: ``(dx, dparams)`` from
    the stack input ``x0`` (N, J, F), the stored layer inputs ``xs``
    (L - 1, N, J, F) and the cotangent ``g`` of the output.  ``dparams`` is
    flat, in :func:`pack_params` order.

    Written after ``_bwd_kernel`` step by step: each layer is recomputed from
    its stored input, and every matrix product rounds both operands to bf16
    where the Pallas kernel's ``_mm`` and ``dot_general`` do (``d_h / H``,
    XW, alpha, ``d_xw``, the weights, x, the neighbour sums); the logits,
    the softmax, LayerNorm and the ``att_src``/``att_dst`` sums stay f32."""
    n, j, f = x0.shape
    mask = _edge_mask(adjacency)
    layers = _unpack(params, f, heads, num_layers)
    grads = [None] * num_layers
    g = g.float()
    for i in reversed(range(num_layers)):
        x = (x0 if i == 0 else xs[i - 1]).float()
        layer = layers[i]
        ln_scale, ln_bias = layer[-2:]
        xhat, inv = _ln_stats(_pre_norm(i, x, layer, adjacency, mask, heads,
                                        precise))
        y = xhat * ln_scale + ln_bias
        d_y = g * torch.where(y >= 0, 1.0, SLOPE)
        d_ln = ((d_y * xhat).sum((0, 1)), d_y.sum((0, 1)))
        d_xhat = d_y * ln_scale
        m1 = d_xhat.mean(-1, keepdim=True)
        m2 = (d_xhat * xhat).mean(-1, keepdim=True)
        d_h = inv * (d_xhat - m1 - xhat * m2)
        xo = _op(x, precise).reshape(n * j, f)
        if i % 2 == 0:
            w, att_src, att_dst, _ = layer[:4]
            xw = (xo @ _op(w, precise)).view(n, j, heads, f)
            alpha, e = _attention(xw, att_src, att_dst, mask)
            d_outh = _op(d_h / heads, precise)
            d_alpha = torch.einsum('nif,nshf->nish', d_outh,
                                   _op(xw, precise))
            d_xw = torch.einsum('nish,nif->nshf', _op(alpha, precise),
                                d_outh)
            s = (alpha * d_alpha).sum(2, keepdim=True)
            d_e = alpha * (d_alpha - s) * torch.where(e >= 0, 1.0, SLOPE)
            d_a_dst, d_a_src = d_e.sum(2), d_e.sum(1)   # (N, J, H) each
            d_xw = (d_xw + d_a_src[..., None] * att_src
                    + d_a_dst[..., None] * att_dst)
            d_xw = _op(d_xw, precise).reshape(n * j, heads * f)
            d_x = (d_xw @ _op(w, precise).t()).view(n, j, f)
            grads[i] = (xo.t() @ d_xw,
                        (xw * d_a_src[..., None]).sum((0, 1)),
                        (xw * d_a_dst[..., None]).sum((0, 1)),
                        d_h.sum((0, 1))) + d_ln
        else:
            w_rel, w_root, _ = layer[:3]
            neigh = torch.einsum('ij,njf->nif', adjacency,
                                 xo.view(n, j, f))
            d_flat = _op(d_h, precise).reshape(n * j, f)
            d_neigh = (d_flat @ _op(w_rel, precise).t()).view(n, j, f)
            d_x = (torch.einsum('ji,njf->nif', adjacency,
                                _op(d_neigh, precise))
                   + (d_flat @ _op(w_root, precise).t()).view(n, j, f))
            grads[i] = (_op(neigh, precise).reshape(n * j, f).t() @ d_flat,
                        xo.t() @ d_flat, d_h.sum((0, 1))) + d_ln
        g = g + d_x
    return g, pack_params(grads)


def kink_margin(x: torch.Tensor, params: torch.Tensor,
                adjacency: torch.Tensor, heads: int, num_layers: int = 5,
                precise: bool = False) -> torch.Tensor:
    """Per graph, the least |y| over every layer's LayerNorm output
    (N, J, F) -> (N,), by the plain version.  LeakyReLU's derivative jumps
    from 0.2 to 1 at y = 0, so two correct backward implementations whose
    recomputed y differ in the last bits disagree by 0.8 g on an element
    that lies that close to 0; a comparison of backward passes at a
    tolerance keeps to graphs whose margin is well above those bits."""
    mask = _edge_mask(adjacency)
    x = x.float()
    margin = x.new_full((x.shape[0],), float('inf'))
    for i, layer in enumerate(_unpack(params, x.shape[-1], heads,
                                      num_layers)):
        xhat, _ = _ln_stats(_pre_norm(i, x, layer, adjacency, mask, heads,
                                      precise))
        y = xhat * layer[-2] + layer[-1]
        margin = torch.minimum(margin, y.abs().amin((1, 2)))
        x = F.leaky_relu(y, SLOPE) + x
    return margin


def _check_stack_args(what: str, x, params, adjacency, heads: int,
                      num_layers: int) -> None:
    j, f = x.shape[-2:]
    if x.dtype != torch.float32 or params.dtype != torch.float32 \
            or adjacency.dtype != torch.float32:
        raise TypeError(f'{what}: x, params and adjacency must be float32')
    if adjacency.shape != (j, j):
        raise ValueError(f'{what}: adjacency {tuple(adjacency.shape)} '
                         f'does not match J={j}')
    if params.shape != (num_params(f, heads, num_layers),):
        raise ValueError(f'{what}: params {tuple(params.shape)} do not '
                         f'match F={f}, heads={heads}, layers={num_layers}')
    if not (x.device == params.device == adjacency.device):
        raise ValueError(f'{what}: tensors on different devices')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{what}: no kernel for device {x.device}')
    if x.device.type == 'cuda' and (f % 4 or f > 64
                                    or params.data_ptr() % 16):
        raise ValueError(f'{what}: the kernel needs F % 4 == 0, F <= 64 '
                         'and params aligned to 16 bytes')


def gcn_stack(x: torch.Tensor, params: torch.Tensor,
              adjacency: torch.Tensor, heads: int, num_layers: int = 5,
              precise: bool = False) -> torch.Tensor:
    """Fused stack on (..., J, F) f32; returns the same shape.

    ``params`` from :func:`pack_params`; ``adjacency`` (J, J) f32, A[dst,
    src] without self-loops.  CUDA tensors launch the kernel, CPU tensors
    run :func:`gcn_stack_plain`."""
    j, f = x.shape[-2:]
    _check_stack_args('gcn_stack', x, params, adjacency, heads, num_layers)
    xf = x.reshape(-1, j, f)
    if x.device.type == 'cpu':
        return gcn_stack_plain(xf, params, adjacency, heads, num_layers,
                               precise).reshape(x.shape)
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


def gcn_stack_edge(x: torch.Tensor, params: torch.Tensor,
                   adjacency: torch.Tensor, heads: int, num_layers: int = 5,
                   precise: bool = False) -> torch.Tensor:
    """The fused stack in edge form on (..., J, F) f32; takes and returns
    what :func:`gcn_stack` does.  CUDA tensors launch the edge-form kernel
    (deterministic: the same inputs give bit-equal outputs), CPU tensors
    run :func:`gcn_stack_edge_plain`."""
    j, f = x.shape[-2:]
    _check_stack_args('gcn_stack_edge', x, params, adjacency, heads,
                      num_layers)
    xf = x.reshape(-1, j, f)
    if x.device.type == 'cpu':
        return gcn_stack_edge_plain(xf, params, adjacency, heads, num_layers,
                                    precise).reshape(x.shape)
    from a2m_torch import _build
    xf = xf.contiguous()
    if xf.data_ptr() % 16:                  # the kernel loads float4
        xf = xf.clone()
    params = params.contiguous()
    routing = edge_routing(adjacency)
    out = torch.empty_like(xf)
    lib = _build.load('gcn_stack_edge')
    code = lib.a2m_gcn_stack_edge(
        xf.data_ptr(), out.data_ptr(), params.data_ptr(),
        routing['route'].data_ptr(), routing['conv_w'].data_ptr(),
        xf.shape[0], j, f, heads, num_layers, routing['edges'],
        routing['conv_edges'], int(precise),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, 'gcn_stack_edge')
    gcn_stack_edge.launches += 1
    return out.reshape(x.shape)


gcn_stack_edge.launches = 0


def edge_tile(adjacency: torch.Tensor, f: int) -> int:
    """Graphs per block the edge-form kernel takes for this skeleton (its
    own choice from the shared-memory budget; results do not depend on
    it)."""
    from a2m_torch import _build
    routing = edge_routing(adjacency)
    return _build.load('gcn_stack_edge').a2m_gcn_stack_edge_tile(
        adjacency.shape[0], f, routing['edges'], routing['conv_edges'])


def gcn_stack_fwd(x: torch.Tensor, params: torch.Tensor,
                  adjacency: torch.Tensor, heads: int, num_layers: int = 5,
                  precise: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward with stash on (N, J, F) f32: ``(y, xs)``, ``xs``
    (L - 1, N, J, F) the inputs of layers 2..L.  CUDA tensors launch the
    stash kernel, CPU tensors run :func:`gcn_stack_fwd_plain`."""
    _check_stack_args('gcn_stack_fwd', x, params, adjacency, heads,
                      num_layers)
    if x.dim() != 3:
        raise ValueError('gcn_stack_fwd: x must be (N, J, F)')
    if x.device.type == 'cpu':
        return gcn_stack_fwd_plain(x, params, adjacency, heads, num_layers,
                                   precise)
    from a2m_torch import _build
    n, j, f = x.shape
    x, params, adjacency = (x.contiguous(), params.contiguous(),
                            adjacency.contiguous())
    y = torch.empty_like(x)
    xs = torch.empty((num_layers - 1, n, j, f), dtype=x.dtype,
                     device=x.device)
    lib = _build.load('gcn_stack')
    code = lib.a2m_gcn_stack_fwd(
        x.data_ptr(), y.data_ptr(), xs.data_ptr(), params.data_ptr(),
        adjacency.data_ptr(), n, j, f, heads, num_layers, int(precise),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, 'gcn_stack_fwd')
    gcn_stack_fwd.launches += 1
    return y, xs


gcn_stack_fwd.launches = 0

#: adjacency tensor -> widest edge list of its graph, self-loop included
_max_degree: dict = {}


def max_degree(adjacency: torch.Tensor) -> int:
    """The most entries any row or column of ``adjacency`` + I holds: the
    stride of the backward kernel's per-node edge lists.  Read from the
    device once per adjacency tensor."""
    key = (adjacency.data_ptr(), adjacency._version, adjacency.device)
    if key not in _max_degree:
        j = adjacency.shape[0]
        m = (adjacency != 0) | torch.eye(j, dtype=torch.bool,
                                         device=adjacency.device)
        _max_degree[key] = int(torch.maximum(m.sum(0).max(), m.sum(1).max()))
    return _max_degree[key]


def gcn_stack_bwd(x0: torch.Tensor, xs: torch.Tensor, g: torch.Tensor,
                  params: torch.Tensor, adjacency: torch.Tensor, heads: int,
                  num_layers: int = 5, precise: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward of the stack: ``(dx (N, J, F), dparams)`` with ``dparams``
    flat in :func:`pack_params` order.  CUDA tensors launch the backward
    kernel (deterministic: the same inputs give bit-equal outputs), CPU
    tensors run :func:`gcn_stack_bwd_plain`."""
    _check_stack_args('gcn_stack_bwd', x0, params, adjacency, heads,
                      num_layers)
    n, j, f = x0.shape
    if g.shape != x0.shape or xs.shape != (num_layers - 1, n, j, f):
        raise ValueError(f'gcn_stack_bwd: g {tuple(g.shape)} or xs '
                         f'{tuple(xs.shape)} do not match x0 '
                         f'{tuple(x0.shape)}')
    if g.dtype != torch.float32 or xs.dtype != torch.float32:
        raise TypeError('gcn_stack_bwd: g and xs must be float32')
    if not (g.device == xs.device == x0.device):
        raise ValueError('gcn_stack_bwd: tensors on different devices')
    if x0.device.type == 'cpu':
        return gcn_stack_bwd_plain(x0, xs, g, params, adjacency, heads,
                                   num_layers, precise)
    from a2m_torch import _build
    x0, xs, g = x0.contiguous(), xs.contiguous(), g.contiguous()
    params, adjacency = params.contiguous(), adjacency.contiguous()
    lib = _build.load('gcn_stack_bwd')
    degree = max_degree(adjacency)
    blocks = lib.a2m_gcn_stack_bwd_blocks(n, j, f, heads, degree,
                                          int(precise))
    if blocks <= 0:
        raise RuntimeError(f'gcn_stack_bwd: no launch shape for J={j}, '
                           f'F={f}, heads={heads} (shared memory)')
    p = params.numel()
    dx = torch.empty_like(x0)
    dparams = torch.empty_like(params)
    # per-block partial parameter gradients, and the transposed weights
    scratch = torch.empty((blocks + 1, p), dtype=torch.float32,
                          device=x0.device)
    code = lib.a2m_gcn_stack_bwd(
        x0.data_ptr(), xs.data_ptr(), g.data_ptr(), params.data_ptr(),
        adjacency.data_ptr(), dx.data_ptr(), dparams.data_ptr(),
        scratch.data_ptr(), n, j, f, heads, num_layers, degree, blocks,
        int(precise), torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(lib, code, 'gcn_stack_bwd')
    gcn_stack_bwd.launches += 1
    return dx, dparams


gcn_stack_bwd.launches = 0


class _TrainableStack(torch.autograd.Function):
    """Forward = the stash kernel, backward = the backward kernel.  The
    parameter gradient comes back flat and is unpacked to ``sources``'
    tensors: the inverse of :func:`pack_params`, with the transpose of the
    entries that were packed transposed."""

    @staticmethod
    def forward(ctx, x, packed, adjacency, heads, num_layers, precise,
                transposed, *sources):
        shape = x.shape
        y, xs = gcn_stack_fwd(x.reshape(-1, *shape[-2:]), packed, adjacency,
                              heads, num_layers, precise)
        ctx.save_for_backward(x, xs, packed, adjacency)
        ctx.meta = (heads, num_layers, precise, transposed,
                    [tuple(t.shape) for t in sources])
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x, xs, packed, adjacency = ctx.saved_tensors
        heads, num_layers, precise, transposed, shapes = ctx.meta
        dx, dflat = gcn_stack_bwd(
            x.reshape(-1, *x.shape[-2:]), xs,
            g.float().reshape(-1, *x.shape[-2:]), packed, adjacency, heads,
            num_layers, precise)
        grads, p = [], 0
        for shape, t in zip(shapes, transposed):
            size = 1
            for d in shape:
                size *= d
            piece = dflat[p:p + size]
            grads.append(piece.view(shape[::-1]).t() if t
                         else piece.view(shape))
            p += size
        return (dx.reshape(x.shape), None, None, None, None, None, None,
                *grads)


def gcn_stack_trainable(x: torch.Tensor, packed: torch.Tensor,
                        adjacency: torch.Tensor, heads: int,
                        num_layers: int, precise: bool, sources,
                        transposed) -> torch.Tensor:
    """Differentiable fused stack on (..., J, F) f32.  ``packed`` is the
    flat parameter buffer, ``sources`` the tensors it was packed from, in
    order, and ``transposed[i]`` says that ``sources[i]`` went in as its
    transpose.  Gradients reach ``x`` and ``sources``; ``packed`` itself
    carries none."""
    return _TrainableStack.apply(x, packed, adjacency, heads, num_layers,
                                 precise, tuple(transposed), *sources)


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


def stack_edge_bytes(n: int, adjacency, f: int, heads: int,
                     num_layers: int = 5) -> int:
    """The edge form: x read once, y written once, params read once, and
    the routing constants (five index lists and the values of A) in place
    of the dense adjacency."""
    adj = np.asarray(adjacency)
    j = adj.shape[0]
    edges = int((np.maximum(adj, np.eye(j)) > 0).sum())
    conv_edges = int((adj != 0).sum())
    return 4 * (2 * n * j * f + num_params(f, heads, num_layers)
                + 2 * edges + 2 * conv_edges + 2 * (j + 1))


def stack_fwd_bytes(n: int, j: int, f: int, heads: int,
                    num_layers: int = 5) -> int:
    """The stash forward: x read, y and the L - 1 stored inputs written,
    params and adjacency read."""
    return 4 * ((1 + num_layers) * n * j * f
                + num_params(f, heads, num_layers) + j * j)


def stack_bwd_flops(n: int, adjacency, f: int, heads: int,
                    num_layers: int = 5) -> int:
    """Operations of the backward: every layer's forward again, then two
    products per forward product (the gradient of each operand), over the
    edges where the forward runs over the edges."""
    adj = np.asarray(adjacency)
    j = adj.shape[0]
    edges = int((adj != 0).sum())
    attended = int((np.maximum(adj, np.eye(j)) > 0).sum())
    total = stack_flops(n, adjacency, f, heads, num_layers)
    for i in range(num_layers):
        if i % 2 == 0:
            total += 2 * 2 * n * j * f * heads * f      # d_x, d_W
            total += 2 * 2 * n * heads * attended * f   # d_alpha, d_xw
            total += 8 * n * heads * attended           # softmax, leaky
            total += 2 * 4 * n * j * heads * f          # att terms, d_att
        else:
            total += 4 * 2 * n * j * f * f      # d_W_rel/root, d_neigh, d_x
            total += 2 * n * edges * f                  # A^T @ d_neigh
        total += 16 * n * j * f                         # LN, leaky, sums
    return total


def stack_bwd_bytes(n: int, j: int, f: int, heads: int,
                    num_layers: int = 5) -> int:
    """x0, the L - 1 stored inputs and g read, dx written; params and
    adjacency read, the parameter gradients written."""
    return 4 * ((num_layers + 2) * n * j * f
                + 2 * num_params(f, heads, num_layers) + j * j)
