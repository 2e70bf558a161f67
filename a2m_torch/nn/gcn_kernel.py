"""Fused GCN stack: CUDA kernel wrappers, their plain versions, cost models.

Four kernels replace the Pallas TPU kernels of ``a2m/nn/pallas_gcn.py`` for
the 5-layer GAT/GraphConv stack with LayerNorm, LeakyReLU and residual on
(..., J, F) graph features:

* :func:`gcn_stack` (``csrc/gcn_stack.cu``) replaces ``_kernel`` (called by
  ``fused_gcn_stack``, ``:228-334``): the gradient-free forward;
* :func:`gcn_stack_fwd` (same source, own entry points) replaces
  ``_fwd_kernel`` (``:529``, called by ``_fwd_with_residuals``): the forward
  that also stores the input of layers 2..L.  With bf16 operands both run
  on the tensor cores, on the launch plan of :func:`dense_tc_plan` and the
  weights of :func:`edge_tc_weights`; with f32 operands on the CUDA cores;
* :func:`gcn_stack_bwd` (``csrc/gcn_stack_bwd.cu``) replaces ``_bwd_kernel``
  (``:557``, called by ``_bwd_call``): the reverse walk that recomputes each
  layer from its stored input and returns ``dx`` and every parameter
  gradient.  With bf16 operands on the tensor cores, on the launch plan of
  :func:`dense_bwd_tc_plan` (the forward's tiles) and the weights of
  :func:`edge_tc_weights`; with f32 operands on the CUDA cores;
* :func:`gcn_stack_edge` (``csrc/gcn_stack_edge.cu``) replaces
  ``_kernel_edge`` (``:879``, called by ``_fused_impl_edge``): the
  gradient-free forward in edge form, a tile of graphs in joint-major
  order with the routing over the constant edge lists of
  :func:`edge_matrices`, and a2m's rounding points for that kernel, which
  are not ``_kernel``'s.  With bf16 operands its products run on the
  tensor cores, on the launch plan of :func:`edge_tc_plan` and the weights
  of :func:`edge_tc_weights`; with f32 operands on the CUDA cores.

:func:`gcn_stack_trainable` joins them as one ``torch.autograd.Function``,
the twin of ``_make_trainable`` (``:722-780``).

Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors, and for nothing else.  The two gradient-free forwards are
registered torch ops, ``a2m_torch::gcn_stack`` and
``a2m_torch::gcn_stack_edge``: the plain version is the op's CPU kernel,
the launch its CUDA kernel, and a fake kernel gives the output's shape, so
``torch.export`` traces either one as a single node that runs the CUDA
kernel in the exported program.  The plain versions follow the
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
    same for the Ec nonzero entries of A itself (GraphConv's A @ X);
    ``slots`` the most edges of A + I that end at one node, ``out_slots``
    the most that start at one."""
    key = (adjacency.data_ptr(), adjacency._version, adjacency.device)
    if key not in _routing or _routing[key]['adjacency'] is not adjacency:
        adj = adjacency.detach().cpu().numpy()
        j = adj.shape[0]
        s_mat, d_mat, dt_mat = edge_matrices(adj)
        src, dst = s_mat.argmax(1), d_mat.argmax(1)
        cdst, csrc = np.nonzero(adj)

        def ranges(sorted_dst):
            return np.searchsorted(sorted_dst, np.arange(j + 1))

        ptr = ranges(dst)
        route = np.concatenate([src, dst, ptr, csrc, ranges(cdst)])
        dev = adjacency.device
        _routing[key] = dict(
            src=torch.as_tensor(src, device=dev),
            dst=torch.as_tensor(dst, device=dev),
            dt_mat=torch.as_tensor(dt_mat, device=dev),
            route=torch.as_tensor(route.astype(np.int32), device=dev),
            conv_w=torch.as_tensor(adj[cdst, csrc].astype(np.float32),
                                   device=dev),
            edges=len(src), conv_edges=len(csrc),
            slots=int(np.diff(ptr).max()),
            out_slots=int(np.bincount(src, minlength=j).max()),
            # held, so that no other tensor takes this key's address
            adjacency=adjacency)
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
    if x.device.type == 'cuda' and (f % 4 or f > 64):
        raise ValueError(f'{what}: the kernel needs F % 4 == 0 and F <= 64')


def _check_aligned(what: str, params: torch.Tensor) -> None:
    """The kernels load params as float4: raise unless 16-byte aligned.
    (Reads the address: called by the CUDA kernels, never under a
    tracer.)"""
    if params.data_ptr() % 16:
        raise ValueError(f'{what}: params must be aligned to 16 bytes')


@torch.library.custom_op('a2m_torch::gcn_stack', mutates_args=(),
                         device_types='cpu')
def _gcn_stack_op(x: torch.Tensor, params: torch.Tensor,
                  adjacency: torch.Tensor, heads: int, num_layers: int,
                  precise: bool) -> torch.Tensor:
    """The op's CPU kernel: :func:`gcn_stack_plain`."""
    j, f = x.shape[-2:]
    _check_stack_args('gcn_stack', x, params, adjacency, heads, num_layers)
    return gcn_stack_plain(x.reshape(-1, j, f), params, adjacency, heads,
                           num_layers, precise).reshape(x.shape)


@_gcn_stack_op.register_fake
def _gcn_stack_fake(x, params, adjacency, heads, num_layers, precise):
    _check_stack_args('gcn_stack', x, params, adjacency, heads, num_layers)
    return x.new_empty(x.shape)


def gcn_stack(x: torch.Tensor, params: torch.Tensor,
              adjacency: torch.Tensor, heads: int, num_layers: int = 5,
              precise: bool = False) -> torch.Tensor:
    """Fused stack on (..., J, F) f32; returns the same shape.

    ``params`` from :func:`pack_params`; ``adjacency`` (J, J) f32, A[dst,
    src] without self-loops.  CUDA tensors launch the kernel, on the tensor
    cores with bf16 operands and on the CUDA cores with ``precise`` (both
    deterministic: the same inputs give bit-equal outputs); CPU tensors run
    :func:`gcn_stack_plain`.  Calls the op ``a2m_torch::gcn_stack``."""
    return torch.ops.a2m_torch.gcn_stack(x, params, adjacency, heads,
                                         num_layers, precise)


@_gcn_stack_op.register_kernel('cuda')
def _gcn_stack_cuda(x, params, adjacency, heads, num_layers, precise):
    """The op's CUDA kernel: K1's launch."""
    j, f = x.shape[-2:]
    _check_stack_args('gcn_stack', x, params, adjacency, heads, num_layers)
    _check_aligned('gcn_stack', params)
    from a2m_torch import _build
    xf = _aligned(x.reshape(-1, j, f))
    params, adjacency = params.contiguous(), adjacency.contiguous()
    out = torch.empty_like(xf)
    lib = _build.load('gcn_stack')
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if precise:
        code = lib.a2m_gcn_stack(
            xf.data_ptr(), out.data_ptr(), params.data_ptr(),
            adjacency.data_ptr(), xf.shape[0], j, f, heads, num_layers,
            stream)
    else:
        code = lib.a2m_gcn_stack_tc(
            xf.data_ptr(), out.data_ptr(),
            *_dense_tc_args(xf, params, adjacency, heads, num_layers),
            stream)
    _build.check(lib, code, 'gcn_stack')
    gcn_stack.launches += 1
    return out.reshape(x.shape)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned (the kernels load float4)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _dense_tc_args(x: torch.Tensor, params: torch.Tensor,
                   adjacency: torch.Tensor, heads: int,
                   num_layers: int) -> tuple:
    """The dense tensor-core entries' arguments after x, y (and xs): params,
    packed weights, routing, shapes, plan and grid."""
    n, j, f = x.shape
    routing = edge_routing(adjacency)
    plan = dense_tc_plan(j, f, heads, routing['slots'], num_layers)
    weights = edge_tc_weights(params, f, heads, num_layers)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return (params.data_ptr(), weights['blocks'].data_ptr(),
            weights['att'].data_ptr(), routing['route'].data_ptr(),
            routing['conv_w'].data_ptr(), n, j, f, heads, num_layers,
            routing['edges'], routing['conv_edges'], plan['graphs'],
            plan['slots'], plan['smem_bytes'],
            min(-(-n // plan['graphs']), sms))


#: kernel launches since the count was last set to 0
gcn_stack.launches = 0


#: the tensor-core kernels' fixed shapes (csrc/gcn_stack_edge.cu; threads,
#: features and weight blocks also csrc/gcn_stack.cu): threads a block, most
#: rows a tile, features a row after zero-padding, f32 row stride of x in
#: shared memory, bytes of one 64 x 64 bf16 weight block
TC_THREADS, TC_MAX_ROWS, TC_FEATURES, TC_X_STRIDE = 256, 128, 64, 72
TC_BLOCK = TC_FEATURES * TC_FEATURES * 2
#: shared memory one block may take on the H100
TC_SMEM_LIMIT = 232_448


def _tc_smem_bytes(j: int, heads: int, num_layers: int, edges: int,
                   conv_edges: int, graphs: int, padded: int,
                   chunk: int) -> int:
    """Shared bytes of the tensor-core kernel's layout (``tc_layout`` in the
    source, which refuses a plan whose bytes differ): the GAT layers'
    weights, x's bf16 operand tile, one chunk's bf16 XW (rows padded by 16
    bytes) or the neigh tile and one GraphConv layer's two weight blocks, x
    in f32, a_src/a_dst/alpha of a chunk, the routing lists, and 1 KB to
    align the base to the 128-byte swizzle's period."""
    rows = j * graphs
    weights = (num_layers + 1) // 2 * heads * TC_BLOCK
    return (weights + padded * TC_FEATURES * 2
            + max(padded * (chunk * TC_FEATURES + 8) * 2,
                  padded * TC_FEATURES * 2 + 2 * TC_BLOCK)
            + rows * TC_X_STRIDE * 4 + 2 * rows * chunk * 4
            + edges * graphs * chunk * 4 + conv_edges * 4
            + (2 * edges + conv_edges + 2 * (j + 1)) * 4 + 1024)


def edge_tc_plan(j: int, f: int, heads: int, edges: int, conv_edges: int,
                 num_layers: int = 5) -> dict:
    """Launch plan of the tensor-core edge kernel for one skeleton: the most
    whole graphs a tile (``graphs``) whose joint-major rows, padded to a
    multiple of 64 (``padded_rows``, at most 128), fit the block's shared
    memory (``smem_bytes``) beside the GAT layers' weights, with GAT heads
    in chunks of the most heads (4, 2 or 1, a divisor of H) that then fit
    (``head_chunk``).  Raises where no tile fits.  The grid is one
    persistent block an SM, at most one a tile."""
    if f % 4 or not 0 < f <= TC_FEATURES:
        raise ValueError(f'gcn_stack_edge: the tensor-core kernel takes '
                         f'F % 4 == 0 and F <= {TC_FEATURES}, not F={f}')
    plan = None
    for graphs in range(1, TC_MAX_ROWS // j + 1):
        padded = -(-j * graphs // 64) * 64
        fits = [(chunk, nbytes) for chunk in (4, 2, 1) if heads % chunk == 0
                for nbytes in [_tc_smem_bytes(j, heads, num_layers, edges,
                                              conv_edges, graphs, padded,
                                              chunk)]
                if nbytes <= TC_SMEM_LIMIT]
        if not fits:
            break
        chunk, nbytes = fits[0]
        plan = dict(graphs=graphs, rows=j * graphs, padded_rows=padded,
                    head_chunk=chunk, smem_bytes=nbytes, threads=TC_THREADS)
    if plan is None:
        raise ValueError(f'gcn_stack_edge: no tile of J={j}, F={f}, '
                         f'heads={heads}, layers={num_layers} fits the '
                         f'tensor-core kernel ({TC_MAX_ROWS} rows, '
                         f'{TC_SMEM_LIMIT} bytes of shared memory)')
    return plan


#: the dense tensor-core kernel (csrc/gcn_stack.cu): rows a tile, heads the
#: apply holds in registers, most edges of A + I into one node
DENSE_TC_ROWS, DENSE_TC_MAX_HEADS, DENSE_TC_MAX_SLOTS = 128, 4, 8


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def _dense_tc_smem_bytes(j: int, heads: int, num_layers: int,
                         slots: int) -> int:
    """Shared bytes of the dense tensor-core kernel's layout
    (``dense_layout`` in the source, which refuses a plan whose bytes
    differ): the GAT layers' weight blocks, x's bf16 operand tile, one bf16
    XW_h tile a head (128 rows of 64 features; at least 3, the room a
    GraphConv layer takes for its rounded neighbour sums and each
    warpgroup's copy of W_rel and W_root), the GAT layers' W_h att (float64),
    every layer's bias, ln_scale and ln_bias (64 f32 each), a_src and a_dst
    (128 x 4 f32), the bf16 alpha of each row's ``slots`` edges for 4
    heads, and the skeleton's tables: A (J x J bf16), the slot of each
    (dst, src) pair, the source of each of a node's 8 slots and its count
    (bytes); and 1 KB to align the base to the 128-byte swizzle's
    period."""
    tile = DENSE_TC_ROWS * TC_FEATURES * 2
    gat = (num_layers + 1) // 2
    return (gat * heads * TC_BLOCK + tile + max(heads, 3) * tile
            + gat * heads * 2 * TC_FEATURES * 8
            + num_layers * 3 * TC_FEATURES * 4
            + 2 * DENSE_TC_ROWS * DENSE_TC_MAX_HEADS * 4
            + DENSE_TC_ROWS * slots * DENSE_TC_MAX_HEADS * 2
            + _round16(2 * j * j) + _round16(j * j)
            + DENSE_TC_MAX_SLOTS * j + _round16(j) + 1024)


def dense_tc_plan(j: int, f: int, heads: int, slots: int,
                  num_layers: int = 5) -> dict:
    """Launch plan of the dense tensor-core kernel (bf16 mode of
    :func:`gcn_stack` and :func:`gcn_stack_fwd`) for one skeleton: a tile is
    the most whole graphs whose graph-major rows fit 128 (``graphs``,
    ``rows``), zero-padded to 128 rows (``padded_rows``, two 64-row M
    tiles) and to 64 features; ``slots`` is the most edges of A + I that end
    at one node (:func:`edge_routing`), ``smem_bytes`` the block's shared
    memory with the GAT layers' weights resident.  Raises where that does not
    fit, or for F, H or J the kernel does not take.  The grid is one
    persistent block an SM, at most one a tile."""
    return _dense_plan('gcn_stack', j, f, heads, slots, num_layers,
                       _dense_tc_smem_bytes(j, heads, num_layers, slots))


def _dense_plan(what: str, j: int, f: int, heads: int, slots: int,
                num_layers: int, nbytes: int) -> dict:
    """The dense tensor-core kernels' tile (whole graphs in 128 graph-major
    rows) for ``slots`` edges a node and ``nbytes`` of shared memory, or
    ValueError where the kernel does not take the shapes."""
    if f % 4 or not 0 < f <= TC_FEATURES:
        raise ValueError(f'{what}: the tensor-core kernel takes '
                         f'F % 4 == 0 and F <= {TC_FEATURES}, not F={f}')
    if not 0 < heads <= DENSE_TC_MAX_HEADS:
        raise ValueError(f'{what}: the tensor-core kernel takes at most '
                         f'{DENSE_TC_MAX_HEADS} heads, not {heads}')
    if not 0 < j <= DENSE_TC_ROWS or not 0 < slots <= min(
            j, DENSE_TC_MAX_SLOTS):
        raise ValueError(f'{what}: the tensor-core kernel takes graphs of at '
                         f'most {DENSE_TC_ROWS} nodes with at most '
                         f'{DENSE_TC_MAX_SLOTS} edges into (and out of) a '
                         f'node, self-loop included, not J={j} with {slots}')
    if nbytes > TC_SMEM_LIMIT:
        raise ValueError(f'{what}: J={j}, heads={heads}, layers='
                         f'{num_layers}, slots={slots} need {nbytes} bytes '
                         f'of shared memory, over {TC_SMEM_LIMIT}')
    graphs = DENSE_TC_ROWS // j
    return dict(graphs=graphs, rows=j * graphs, padded_rows=DENSE_TC_ROWS,
                slots=slots, smem_bytes=nbytes, threads=TC_THREADS)


def _dense_bwd_tc_smem_bytes(j: int, heads: int, num_layers: int,
                             slots: int) -> int:
    """Shared bytes of the dense tensor-core backward's layout
    (``bwd_layout`` in ``csrc/gcn_stack_bwd.cu``, which refuses a plan whose
    bytes differ): one layer's weight blocks (H, at least 2), x's bf16
    operand tile, one bf16 tile a head (XW_h, then d_XW_h; at least 2, for
    GraphConv's neigh and d_neigh), the d_outh / d_h tile, the cotangent
    (128 x 64 f32), one GAT layer's W_h att (float64), every GAT layer's
    att_src, att_dst (f32), every layer's bias, ln_scale and ln_bias,
    a_src, a_dst, d_a_src and d_a_dst (128 x 4 f32 each), the bf16 alpha
    and the f32 d_e of each row's ``slots`` edges
    for 4 heads, the block's sums X^T d_a (64 x 2 f32 a GAT head), the
    column sums of 8 warps (3 x 64 f32 each), the skeleton's tables (A in
    bf16, the slot of each (dst, src) pair, a node's sources and its
    destinations with its slot in their lists, their counts) and 1 KB to
    align the base to the 128-byte swizzle's period."""
    tile = DENSE_TC_ROWS * TC_FEATURES * 2
    gat = (num_layers + 1) // 2
    rows = DENSE_TC_ROWS * DENSE_TC_MAX_HEADS
    return (max(heads, 2) * (TC_BLOCK + tile) + 2 * tile
            + DENSE_TC_ROWS * TC_FEATURES * 4 + heads * 2 * TC_FEATURES * 8
            + gat * heads * 2 * TC_FEATURES * 4
            + num_layers * 3 * TC_FEATURES * 4 + 4 * rows * 4
            + rows * slots * (2 + 4) + gat * heads * TC_FEATURES * 2 * 4
            + TC_THREADS // 32 * 3 * TC_FEATURES * 4
            + _round16(2 * j * j) + _round16(j * j)
            + 3 * DENSE_TC_MAX_SLOTS * j + 2 * _round16(j) + 1024)


def dense_bwd_tc_plan(j: int, f: int, heads: int, slots: int,
                      out_slots: int, num_layers: int = 5) -> dict:
    """Launch plan of the dense tensor-core backward (bf16 mode of
    :func:`gcn_stack_bwd`) for one skeleton: the forward's tile
    (:func:`dense_tc_plan`: the most whole graphs that fit 128 graph-major
    rows, zero-padded to 128 rows and 64 features); ``slots`` and
    ``out_slots`` the most edges of A + I that end and that start at one
    node (:func:`edge_routing`), ``smem_bytes`` the block's shared memory
    with one layer's weights resident.  Raises where that does not fit, or
    for F, H or J the kernel does not take.  The grid is one persistent
    block an SM, at most one a tile."""
    plan = _dense_plan('gcn_stack_bwd', j, f, heads,
                       max(slots, out_slots), num_layers,
                       _dense_bwd_tc_smem_bytes(j, heads, num_layers, slots))
    return dict(plan, slots=slots)


def swizzle_block(block: torch.Tensor) -> torch.Tensor:
    """A (64, 64) operand block in wgmma's 128-byte swizzle: row n's 16-byte
    chunk c (8 bf16 values) moves to chunk c ^ (n % 8).  Its own inverse."""
    n = torch.arange(TC_FEATURES, device=block.device)[:, None]
    c = torch.arange(8, device=block.device)[None, :]
    return block.reshape(TC_FEATURES, 8, 8)[n, c ^ (n % 8)].reshape(
        TC_FEATURES, TC_FEATURES)


#: (params tensor, its version, device, shapes) -> (params, weights)
_tc_weights: dict = {}


def edge_tc_weights(params: torch.Tensor, f: int, heads: int,
                    num_layers: int = 5) -> dict:
    """The tensor-core kernel's weights, built once per params tensor and
    version, on its device.  ``blocks`` (n, 64, 64) bf16: per GAT layer one
    block per head, W[:, h]^T; per GraphConv layer W_rel^T and W_root^T;
    each rounded to bf16 as a2m's ``_mm`` rounds W (once, here),
    zero-padded to 64 x 64 and swizzled (:func:`swizzle_block`).  ``att``
    (GAT layers, heads, 2, 64) float64: W_h att_src and W_h att_dst of the
    rounded W_h, zero-padded, from which the kernel takes a_src = x . (W_h
    att_src), the logit of the unrounded XW_h, in float64."""
    key = (params.data_ptr(), params._version, params.device, f, heads,
           num_layers)
    hit = _tc_weights.get(key)
    if hit is not None and hit[0] is params:
        return hit[1]
    blocks, att = [], []
    for i, layer in enumerate(_unpack(params.detach(), f, heads,
                                      num_layers)):
        mats = ([layer[0][:, h * f:(h + 1) * f] for h in range(heads)]
                if i % 2 == 0 else layer[:2])
        for w in mats:
            block = torch.zeros((TC_FEATURES, TC_FEATURES),
                                dtype=torch.bfloat16, device=params.device)
            block[:f, :f] = w.t().to(torch.bfloat16)
            blocks.append(swizzle_block(block))
        if i % 2 == 0:
            for h, w in enumerate(mats):
                wd = _op(w, False).double()
                pair = torch.zeros((2, TC_FEATURES), dtype=torch.float64,
                                   device=params.device)
                pair[0, :f] = wd @ layer[1][h].double()
                pair[1, :f] = wd @ layer[2][h].double()
                att.append(pair)
    packed = dict(blocks=torch.stack(blocks).contiguous(),
                  att=torch.stack(att).view(-1, heads, 2, TC_FEATURES))
    if len(_tc_weights) >= 16:
        _tc_weights.pop(next(iter(_tc_weights)))
    # the params tensor is held, so that no other tensor takes its address
    _tc_weights[key] = (params, packed)
    return packed


@torch.library.custom_op('a2m_torch::gcn_stack_edge', mutates_args=(),
                         device_types='cpu')
def _gcn_stack_edge_op(x: torch.Tensor, params: torch.Tensor,
                       adjacency: torch.Tensor, heads: int, num_layers: int,
                       precise: bool) -> torch.Tensor:
    """The op's CPU kernel: :func:`gcn_stack_edge_plain`."""
    j, f = x.shape[-2:]
    _check_stack_args('gcn_stack_edge', x, params, adjacency, heads,
                      num_layers)
    return gcn_stack_edge_plain(x.reshape(-1, j, f), params, adjacency,
                                heads, num_layers, precise).reshape(x.shape)


@_gcn_stack_edge_op.register_fake
def _gcn_stack_edge_fake(x, params, adjacency, heads, num_layers, precise):
    _check_stack_args('gcn_stack_edge', x, params, adjacency, heads,
                      num_layers)
    return x.new_empty(x.shape)


def gcn_stack_edge(x: torch.Tensor, params: torch.Tensor,
                   adjacency: torch.Tensor, heads: int, num_layers: int = 5,
                   precise: bool = False) -> torch.Tensor:
    """The fused stack in edge form on (..., J, F) f32; takes and returns
    what :func:`gcn_stack` does.  CUDA tensors launch the edge-form kernel,
    on the tensor cores with bf16 operands and on the CUDA cores with
    ``precise`` (deterministic: the same inputs give bit-equal outputs);
    CPU tensors run :func:`gcn_stack_edge_plain`.  Calls the op
    ``a2m_torch::gcn_stack_edge``."""
    return torch.ops.a2m_torch.gcn_stack_edge(x, params, adjacency, heads,
                                              num_layers, precise)


@_gcn_stack_edge_op.register_kernel('cuda')
def _gcn_stack_edge_cuda(x, params, adjacency, heads, num_layers, precise):
    """The op's CUDA kernel: K5's launch."""
    j, f = x.shape[-2:]
    _check_stack_args('gcn_stack_edge', x, params, adjacency, heads,
                      num_layers)
    _check_aligned('gcn_stack_edge', params)
    from a2m_torch import _build
    xf = _aligned(x.reshape(-1, j, f))
    params = params.contiguous()
    routing = edge_routing(adjacency)
    n, edges, conv_edges = xf.shape[0], routing['edges'], routing[
        'conv_edges']
    out = torch.empty_like(xf)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.load('gcn_stack_edge')
    if precise:
        code = lib.a2m_gcn_stack_edge(
            xf.data_ptr(), out.data_ptr(), params.data_ptr(),
            routing['route'].data_ptr(), routing['conv_w'].data_ptr(), n, j,
            f, heads, num_layers, edges, conv_edges, stream)
    else:
        plan = edge_tc_plan(j, f, heads, edges, conv_edges, num_layers)
        weights = edge_tc_weights(params, f, heads, num_layers)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        grid = min(-(-n // plan['graphs']), sms)
        code = lib.a2m_gcn_stack_edge_tc(
            xf.data_ptr(), out.data_ptr(), params.data_ptr(),
            weights['blocks'].data_ptr(), weights['att'].data_ptr(),
            routing['route'].data_ptr(),
            routing['conv_w'].data_ptr(), n, j, f, heads, num_layers, edges,
            conv_edges, plan['graphs'], plan['padded_rows'],
            plan['head_chunk'], plan['smem_bytes'], grid, stream)
    _build.check(lib, code, 'gcn_stack_edge')
    gcn_stack_edge.launches += 1
    return out.reshape(x.shape)


gcn_stack_edge.launches = 0


def edge_tile(adjacency: torch.Tensor, f: int) -> int:
    """Graphs per block the f32 mode's CUDA-core kernel takes for this
    skeleton (its own choice from the shared-memory budget; results do not
    depend on it)."""
    from a2m_torch import _build
    routing = edge_routing(adjacency)
    return _build.load('gcn_stack_edge').a2m_gcn_stack_edge_tile(
        adjacency.shape[0], f, routing['edges'], routing['conv_edges'])


def edge_tc_info(smem_bytes: int) -> dict:
    """The tensor-core kernel as built, on the card: registers and local
    (spill) bytes a thread, blocks an SM at ``smem_bytes``, threads a
    block."""
    import ctypes

    from a2m_torch import _build
    lib = _build.load('gcn_stack_edge')
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.a2m_gcn_stack_edge_tc_info(smem_bytes, out),
                 'gcn_stack_edge_tc_info')
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                threads=out[3])


def dense_tc_info(smem_bytes: int, stash: bool = False) -> dict:
    """The dense tensor-core kernel as built (the forward, or the forward
    with stash), on the card: registers and local (spill) bytes a thread,
    blocks an SM at ``smem_bytes``, threads a block."""
    import ctypes

    from a2m_torch import _build
    lib = _build.load('gcn_stack')
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.a2m_gcn_stack_tc_info(int(stash), smem_bytes, out),
                 'gcn_stack_tc_info')
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                threads=out[3])


def dense_bwd_tc_info(smem_bytes: int) -> dict:
    """The dense tensor-core backward as built, on the card: registers and
    local (spill) bytes a thread, blocks an SM at ``smem_bytes``, threads a
    block."""
    import ctypes

    from a2m_torch import _build
    lib = _build.load('gcn_stack_bwd')
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.a2m_gcn_stack_bwd_tc_info(smem_bytes, out),
                 'gcn_stack_bwd_tc_info')
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                threads=out[3])


def gcn_stack_fwd(x: torch.Tensor, params: torch.Tensor,
                  adjacency: torch.Tensor, heads: int, num_layers: int = 5,
                  precise: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward with stash on (N, J, F) f32: ``(y, xs)``, ``xs``
    (L - 1, N, J, F) the inputs of layers 2..L.  CUDA tensors launch the
    stash kernel (:func:`gcn_stack`'s with the stores: the same ``y``, bit
    for bit), CPU tensors run :func:`gcn_stack_fwd_plain`."""
    _check_stack_args('gcn_stack_fwd', x, params, adjacency, heads,
                      num_layers)
    if x.dim() != 3:
        raise ValueError('gcn_stack_fwd: x must be (N, J, F)')
    if x.device.type == 'cpu':
        return gcn_stack_fwd_plain(x, params, adjacency, heads, num_layers,
                                   precise)
    _check_aligned('gcn_stack_fwd', params)
    from a2m_torch import _build
    n, j, f = x.shape
    x, params, adjacency = (_aligned(x), params.contiguous(),
                            adjacency.contiguous())
    y = torch.empty_like(x)
    xs = torch.empty((num_layers - 1, n, j, f), dtype=x.dtype,
                     device=x.device)
    lib = _build.load('gcn_stack')
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if precise:
        code = lib.a2m_gcn_stack_fwd(
            x.data_ptr(), y.data_ptr(), xs.data_ptr(), params.data_ptr(),
            adjacency.data_ptr(), n, j, f, heads, num_layers, stream)
    else:
        code = lib.a2m_gcn_stack_fwd_tc(
            x.data_ptr(), y.data_ptr(), xs.data_ptr(),
            *_dense_tc_args(x, params, adjacency, heads, num_layers), stream)
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
    kernel, on the tensor cores with bf16 operands and on the CUDA cores
    with ``precise`` (both deterministic: the same inputs give bit-equal
    outputs); CPU tensors run :func:`gcn_stack_bwd_plain`."""
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
    _check_aligned('gcn_stack_bwd', params)
    from a2m_torch import _build
    x0, xs, g = _aligned(x0), _aligned(xs), _aligned(g)
    params, adjacency = params.contiguous(), adjacency.contiguous()
    lib = _build.load('gcn_stack_bwd')
    p = params.numel()
    dx = torch.empty_like(x0)
    dparams = torch.empty_like(params)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    if precise:
        degree = max_degree(adjacency)
        blocks = lib.a2m_gcn_stack_bwd_blocks(n, j, f, heads, degree)
        if blocks <= 0:
            raise RuntimeError(f'gcn_stack_bwd: no launch shape for J={j}, '
                               f'F={f}, heads={heads} (shared memory)')
        # per-block partial parameter gradients, and the transposed weights
        scratch = torch.empty((blocks + 1, p), dtype=torch.float32,
                              device=x0.device)
        code = lib.a2m_gcn_stack_bwd(
            x0.data_ptr(), xs.data_ptr(), g.data_ptr(), params.data_ptr(),
            adjacency.data_ptr(), dx.data_ptr(), dparams.data_ptr(),
            scratch.data_ptr(), n, j, f, heads, num_layers, degree, blocks,
            stream)
    else:
        routing = edge_routing(adjacency)
        plan = dense_bwd_tc_plan(j, f, heads, routing['slots'],
                                 routing['out_slots'], num_layers)
        weights = edge_tc_weights(params, f, heads, num_layers)
        sms = torch.cuda.get_device_properties(
            x0.device).multi_processor_count
        grid = max(1, min(-(-n // plan['graphs']), sms))
        # per-block partial parameter gradients, added in block order
        scratch = torch.empty((grid, p), dtype=torch.float32,
                              device=x0.device)
        code = lib.a2m_gcn_stack_bwd_tc(
            x0.data_ptr(), xs.data_ptr(), g.data_ptr(), params.data_ptr(),
            weights['blocks'].data_ptr(), weights['att'].data_ptr(),
            routing['route'].data_ptr(), routing['conv_w'].data_ptr(),
            dx.data_ptr(), dparams.data_ptr(), scratch.data_ptr(), n, j, f,
            heads, num_layers, routing['edges'], routing['conv_edges'],
            plan['graphs'], plan['slots'], plan['smem_bytes'], grid, stream)
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
