"""Dense graph convolutions over small fixed skeleton graphs.

Counterparts of ``a2m/nn/graph.py`` (``:31-167``).  Inputs are (..., J, F)
with a constant adjacency A[dst, src] (no self-loops).  The eager
:class:`GCNStack` is the in-package oracle of the fused stack kernel
(:mod:`a2m_torch.nn.gcn_kernel`), which ``fused=True`` selects.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from a2m_torch.nn import gcn_kernel


class DenseGraphConv(nn.Module):
    """torch_geometric ``GraphConv`` (add aggregation):
    ``(A @ X) @ W_rel + X @ W_root + b``."""

    def __init__(self, features: int, adjacency: np.ndarray):
        super().__init__()
        self.register_buffer('adjacency', torch.as_tensor(adjacency),
                             persistent=False)
        self.lin_rel = nn.Linear(features, features, bias=False)
        self.lin_root = nn.Linear(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        neigh = torch.einsum('ij,...jf->...if', self.adjacency, x)
        return self.lin_rel(neigh) + self.lin_root(x)


class DenseGATConv(nn.Module):
    """torch_geometric ``GATConv`` with concat=False in dense form: self-loops
    added, logits ``LeakyReLU_0.2(a_dst[i] + a_src[j])`` masked to the
    edges with -inf, softmax over the source j, head mean, + bias."""

    def __init__(self, features: int, adjacency: np.ndarray, heads: int = 4,
                 negative_slope: float = 0.2):
        super().__init__()
        j = adjacency.shape[0]
        mask = np.maximum(adjacency, np.eye(j, dtype=np.float32)) > 0
        self.register_buffer('mask', torch.as_tensor(mask), persistent=False)
        self.heads, self.features = heads, features
        self.negative_slope = negative_slope
        self.lin = nn.Linear(features, heads * features, bias=False)
        self.att_src = nn.Parameter(torch.empty(heads, features))
        self.att_dst = nn.Parameter(torch.empty(heads, features))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.xavier_uniform_(self.att_src)
        nn.init.xavier_uniform_(self.att_dst)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xw = self.lin(x).unflatten(-1, (self.heads, self.features))
        a_src = (xw * self.att_src).sum(-1)             # (..., J, H)
        a_dst = (xw * self.att_dst).sum(-1)
        e = a_dst[..., :, None, :] + a_src[..., None, :, :]   # (.., Jd, Js, H)
        e = F.leaky_relu(e, self.negative_slope)
        e = e.masked_fill(~self.mask[..., None], float('-inf'))
        alpha = torch.softmax(e, dim=-2)                # over the source
        out = torch.einsum('...ijh,...jhf->...ihf', alpha, xw)
        return out.mean(dim=-2) + self.bias


class GCNStack(nn.Module):
    """Alternating GAT/GraphConv layers, each followed by LayerNorm (flax's
    eps 1e-6), LeakyReLU 0.2 and the residual, then one dropout
    (``a2m/nn/graph.py:118-167``).  ``fused`` runs all layers through the
    fused stack kernels, with bf16 matmul operands unless ``precise``: a
    forward kernel when nothing needs a gradient (the edge-form one with
    ``fused_edge``, a2m's ``edge_form``, else the dense one), and otherwise
    one ``torch.autograd.Function`` around the stash-forward and backward
    kernels (``gcn_kernel.gcn_stack_trainable``), whatever ``fused_edge``
    says.  ``fused_edge`` without ``fused`` changes nothing.  A CUDA tensor
    on the fused path never reaches the eager layers."""

    def __init__(self, features: int, adjacency: np.ndarray,
                 num_layers: int = 5, heads: int = 4, dropout: float = 0.0,
                 fused: bool = False, precise: bool = False,
                 fused_edge: bool = False):
        super().__init__()
        self.num_layers, self.heads = num_layers, heads
        self.fused, self.precise = fused, precise
        self.fused_edge = fused_edge
        self.dropout = nn.Dropout(dropout)
        self.register_buffer('adjacency',
                             torch.as_tensor(adjacency, dtype=torch.float32),
                             persistent=False)
        for i in range(1, num_layers + 1):
            layer = (DenseGATConv(features, adjacency, heads=heads)
                     if i % 2 else DenseGraphConv(features, adjacency))
            setattr(self, f'gcn{i}', layer)
            setattr(self, f'norm{i}', nn.LayerNorm(features, eps=1e-6))
        self._packed = None         # (parameter key, flat buffer)

    def packed_params(self) -> torch.Tensor:
        """This stack's parameters as the kernel's flat buffer, packed once
        and again only after a parameter moved or was written in place
        (``load_state_dict``, ``.to``, an optimiser step).

        Under ``torch.export`` the parameters have no address to key on:
        the last eager pack is traced as a constant of the exported
        program (``a2m_torch.export`` packs each stack just before it
        traces), or, where none was made, :func:`gcn_kernel.pack_params`
        itself."""
        if torch.compiler.is_exporting():
            return self._pack() if self._packed is None else self._packed[1]
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._packed is None or self._packed[0] != key:
            # a plain tensor even when first packed under inference_mode
            with torch.inference_mode(False), torch.no_grad():
                self._packed = (key, self._pack())
        return self._packed[1]

    def pack_sources(self) -> list[tuple[torch.Tensor, bool]]:
        """The kernel buffer's entries in order: (tensor, packed as its
        transpose).  ``nn.Linear`` keeps (out, in), the kernel (in, out)."""
        out = []
        for i in range(1, self.num_layers + 1):
            g, n = getattr(self, f'gcn{i}'), getattr(self, f'norm{i}')
            if i % 2:
                out += [(g.lin.weight, True), (g.att_src, False),
                        (g.att_dst, False), (g.bias, False)]
            else:
                out += [(g.lin_rel.weight, True), (g.lin_root.weight, True),
                        (g.lin_root.bias, False)]
            out += [(n.weight, False), (n.bias, False)]
        return out

    def _pack(self) -> torch.Tensor:
        return gcn_kernel.pack_params(
            [[t.t() if transposed else t
              for t, transposed in self.pack_sources()]])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            sources = self.pack_sources()
            if torch.is_grad_enabled() and (
                    x.requires_grad
                    or any(t.requires_grad for t, _ in sources)):
                x = gcn_kernel.gcn_stack_trainable(
                    x.float(), self.packed_params(), self.adjacency,
                    self.heads, self.num_layers, self.precise,
                    [t for t, _ in sources], [tr for _, tr in sources])
            else:
                forward = (gcn_kernel.gcn_stack_edge if self.fused_edge
                           else gcn_kernel.gcn_stack)
                x = forward(x.float(), self.packed_params(), self.adjacency,
                            self.heads, self.num_layers, self.precise)
            return self.dropout(x)
        for i in range(1, self.num_layers + 1):
            residual = x
            x = getattr(self, f'norm{i}')(getattr(self, f'gcn{i}')(x))
            x = F.leaky_relu(x, 0.2) + residual
        return self.dropout(x)
