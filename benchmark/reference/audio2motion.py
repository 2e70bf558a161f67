"""Plain PyTorch reference of the audio-to-motion model, for the benchmark.

A frozen, self-contained copy of what the measured program computes, written
from the published model (Xukai-UoA/Audio-to-Motion-Generation,
``real_motion_model.py``: ``SelfAttention_G`` and ``SelfAttention_D``) as the
port lays it out: the pose-rate log-mel, the generator and the discriminator,
the kinematic losses and the GAN steps with Adam, the streaming window
gather and crossfade blend.  It imports only torch and numpy: no kernel, no
module of the measured program, no JAX.  Module and parameter names follow
a2m's flax scopes, so a packed ``.npz`` of weights loads by a rename
(:func:`load_npz_state`), and the program and this reference read the same
file.

Precision is the configuration's: every convolution and product in f32
(TF32 is the caller's switch), and the GCN stacks' matrix products on
operands rounded to bf16 where the configured kernel rounds them
(``stack_mode``): ``'dense'`` as the dense stack kernel (one-window path and
training), ``'edge'`` as the edge-form kernel (streaming), ``'f32'`` for no
rounding.  Everything else (softmax, LayerNorm, BatchNorm) stays f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Skeleton
# ---------------------------------------------------------------------------

PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 7, 6,
           10, 11, 12, 13, 10, 15, 16, 17, 10, 19, 20, 21, 10, 23, 24, 25,
           10, 27, 28, 29, 3,
           31, 32, 33, 34, 31, 36, 37, 38, 31, 40, 41, 42, 31, 44, 45, 46,
           31, 48, 49, 50)
NUM_JOINTS, NUM_BODY, NUM_HAND = 52, 10, 42
JOINT_SUBSET = np.r_[range(7), range(10, NUM_JOINTS)]
POSE_FPS, WINDOW = 15, 64


def _body_parents():
    return [p if p < NUM_BODY else -1 for p in PARENTS[:NUM_BODY]]


def _hand_parents():
    return [p - 10 if p >= 10 else -1 for p in PARENTS[10:10 + NUM_HAND]]


def adjacency(parents) -> np.ndarray:
    """A[dst, src] = 1 for each child<->parent edge, no self-loops."""
    n = len(parents)
    adj = np.zeros((n, n), np.float32)
    for i, p in enumerate(parents):
        if p != -1:
            adj[i, p] = adj[p, i] = 1.0
    return adj


def body_adjacency() -> np.ndarray:
    return adjacency(_body_parents())


def hand_adjacency() -> np.ndarray:
    return adjacency(_hand_parents())


def _triples(parents) -> np.ndarray:
    out = []
    for i, p in enumerate(parents):
        if p == -1:
            continue
        for j in range(i + 1, len(parents)):
            if parents[j] == i:
                out.append((p, i, j))
                break
    return np.asarray(out, np.int64).reshape(-1, 3)


def _subset_parents() -> np.ndarray:
    pos = {j: k for k, j in enumerate(JOINT_SUBSET)}
    return np.asarray([pos.get(PARENTS[j], -1) if PARENTS[j] != -1 else -1
                       for j in JOINT_SUBSET], np.int64)


def rest_pose() -> np.ndarray:
    """(2, 52) rest pose walked along the skeleton tree."""
    pos = np.zeros((NUM_JOINTS, 2))
    for j in range(1, NUM_JOINTS):
        scale = 12.0 if j < 10 else 4.0
        ang = (j * 2.399) % (2 * np.pi)
        pos[j] = pos[PARENTS[j]] + scale * np.array([np.cos(ang),
                                                     np.sin(ang)])
    return pos.T + np.array([[640.0], [360.0]])


# ---------------------------------------------------------------------------
# Log-mel at pose rate (librosa's log_mel_512 at 45.6 kHz, every 6th frame)
# ---------------------------------------------------------------------------

SR = 45600
N_FFT, HOP, N_MELS = 2048, 512 * 6, 128


def _mel_slaney(n_mels: int, n_fft: int, sr: float) -> np.ndarray:
    """librosa's Slaney filterbank (n_mels, 1 + n_fft // 2), float64."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3.0)
        log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (
            np.log(6.4) / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0,
                        1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        (200.0 / 3.0) * m)

    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0),
                                  n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    return weights * (2.0 / (mel_f[2:] - mel_f[:n_mels]))[:, None]


_MEL_CACHE: dict = {}


def _mel_consts(device):
    key = str(device)
    if key not in _MEL_CACHE:
        n = np.arange(N_FFT)
        window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / N_FFT)
        _MEL_CACHE[key] = (
            torch.as_tensor(window, dtype=torch.float32, device=device),
            torch.as_tensor(_mel_slaney(N_MELS, N_FFT, SR).T,
                            dtype=torch.float32, device=device))
    return _MEL_CACHE[key]


def n_frames_of(n_samples: int) -> int:
    return 1 + n_samples // HOP


def log_mel(y: torch.Tensor, n_frames: int | None = None) -> torch.Tensor:
    """(B, N) f32 waveform -> (B, T, 128): centred reflect pad, periodic
    Hann frames of 2048, power spectrum, Slaney mel, ``log(max(., 1e-10))``.
    Frames past the padded signal read zeros."""
    window, mel = _mel_consts(y.device)
    if n_frames is None:
        n_frames = n_frames_of(y.shape[-1])
    pad = N_FFT // 2
    yp = F.pad(y[:, None, :], (pad, pad), mode='reflect')[:, 0]
    need = (n_frames - 1) * HOP + N_FFT
    if yp.shape[-1] < need:
        yp = F.pad(yp, (0, need - yp.shape[-1]))
    frames = yp.unfold(-1, N_FFT, HOP)[:, :n_frames] * window
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.log(torch.clamp_min(power @ mel, 1e-10))


# ---------------------------------------------------------------------------
# Layers (channel-last at every boundary)
# ---------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """Channel-last BatchNorm, eps 1e-5, momentum 0.9 on the old statistic,
    biased batch variance; train-mode moments weighted by the row mask."""

    mask: torch.Tensor | None = None     # set around a masked forward

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            mask = BatchNorm.mask
            if mask is None:
                mean = x.mean(axes)
                var = ((x - mean) ** 2).mean(axes)
            else:
                w = mask.to(x.dtype).reshape((x.shape[0],)
                                             + (1,) * (x.dim() - 1))
                spatial = x[0].numel() // x.shape[-1]
                sums = torch.cat([(x * w).sum(axes),
                                  (w.sum() * spatial).reshape(1)])
                mean = sums[:-1] / sums[-1]
                var = (((x - mean) ** 2) * w).sum(axes) / sums[-1]
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(mean.detach(), alpha=0.1)
                self.running_var.mul_(0.9).add_(var.detach(), alpha=0.1)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


def _conv1d_matmul(x, weight, bias, stride: int, padding: int):
    """conv1d over channel-last (B, T, C) as one matrix product."""
    out_ch, in_ch, k = weight.shape
    xp = F.pad(x, (0, 0, padding, padding))
    t_out = (x.shape[1] + 2 * padding - k) // stride + 1
    span = (t_out - 1) * stride + 1
    cols = torch.cat([xp[:, i:i + span:stride, :] for i in range(k)], dim=-1)
    return cols @ weight.permute(2, 1, 0).reshape(k * in_ch, out_ch) + bias


class ConvNormRelu(nn.Module):
    """Conv -> Dropout -> BatchNorm -> LeakyReLU 0.2 (k4/s2 downsampling or
    k3/s1; padding ``int((k - s) / 2)``)."""

    def __init__(self, cin: int, cout: int, two_d: bool = False,
                 downsample: bool = False, kernel=None, stride=None,
                 p: float = 0.0):
        super().__init__()
        nd = 2 if two_d else 1
        k, s = (kernel, stride) if kernel is not None else (
            (4, 2) if downsample else (3, 1))
        k = (k,) * nd if isinstance(k, int) else tuple(k)
        s = (s,) * nd if isinstance(s, int) else tuple(s)
        pad = tuple(int((a - b) / 2) for a, b in zip(k, s))
        self.conv = (nn.Conv2d if two_d else nn.Conv1d)(cin, cout, k, s,
                                                        padding=pad)
        self.dropout = nn.Dropout(p)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        conv = self.conv
        if (isinstance(conv, nn.Conv1d) and torch.is_grad_enabled()
                and (x.requires_grad or conv.weight.requires_grad)):
            x = _conv1d_matmul(x, conv.weight, conv.bias, conv.stride[0],
                               conv.padding[0])
        else:
            x = conv(x.movedim(-1, 1)).movedim(1, -1)
        return F.leaky_relu(self.norm(self.dropout(x)), 0.2)


class SelfAttention(nn.Module):
    """Unscaled self-attention over time with a learnable gate."""

    def __init__(self, c: int):
        super().__init__()
        self.query = nn.Linear(c, c // 8)
        self.key = nn.Linear(c, c // 8)
        self.value = nn.Linear(c, c)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        attn = torch.softmax(self.query(x) @ self.key(x).transpose(1, 2),
                             dim=-1)
        return self.gamma * (attn @ self.value(x)) + x


class ChannelAttention(nn.Module):
    def __init__(self, c: int, reduction: int = 8):
        super().__init__()
        self.Dense_0 = nn.Linear(c, c // reduction)
        self.Dense_1 = nn.Linear(c // reduction, c)

    def forward(self, x):
        def mlp(v):
            return self.Dense_1(F.relu(self.Dense_0(v)))
        return x * torch.sigmoid(mlp(x.mean(1)) + mlp(x.amax(1)))[:, None]


class ResBlock(nn.Module):
    def __init__(self, c: int, p: float):
        super().__init__()
        self.conv1 = ConvNormRelu(c, c, p=p)
        self.conv2 = ConvNormRelu(c, c, p=p)
        self.attention = SelfAttention(c)

    def forward(self, x):
        return self.attention(self.conv2(self.conv1(x))) + x


class ConvTranspose1D(nn.Module):
    """Transposed conv k3 s2 p1 op1 (doubles T) + bias + BatchNorm + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, None,
                               stride=2, padding=1, output_padding=1)
        return F.relu(self.bn(y.transpose(1, 2) + self.bias))


# ---------------------------------------------------------------------------
# Graph layers and the GCN stack
# ---------------------------------------------------------------------------


def _gat_mask(adj: torch.Tensor) -> torch.Tensor:
    return (adj > 0) | torch.eye(adj.shape[0], dtype=torch.bool,
                                 device=adj.device)


class GATConv(nn.Module):
    """Dense GATConv, concat=False: self-loops, LeakyReLU 0.2 logits masked
    to the edges, softmax over the source, mean over heads, + bias."""

    def __init__(self, f: int, adj: np.ndarray, heads: int = 4):
        super().__init__()
        self.register_buffer('mask', _gat_mask(torch.as_tensor(adj)),
                             persistent=False)
        self.heads, self.f = heads, f
        self.lin = nn.Linear(f, heads * f, bias=False)
        self.att_src = nn.Parameter(torch.empty(heads, f))
        self.att_dst = nn.Parameter(torch.empty(heads, f))
        self.bias = nn.Parameter(torch.zeros(f))
        nn.init.xavier_uniform_(self.att_src)
        nn.init.xavier_uniform_(self.att_dst)

    def forward(self, x):
        xw = self.lin(x).unflatten(-1, (self.heads, self.f))
        a_src = (xw * self.att_src).sum(-1)
        a_dst = (xw * self.att_dst).sum(-1)
        e = F.leaky_relu(a_dst[..., :, None, :] + a_src[..., None, :, :], 0.2)
        e = e.masked_fill(~self.mask[..., None], float('-inf'))
        alpha = torch.softmax(e, dim=-2)
        out = torch.einsum('...ijh,...jhf->...ihf', alpha, xw)
        return out.mean(dim=-2) + self.bias


class GraphConv(nn.Module):
    """(A @ X) @ W_rel + X @ W_root + b."""

    def __init__(self, f: int, adj: np.ndarray):
        super().__init__()
        self.lin_rel = nn.Linear(f, f, bias=False)
        self.lin_root = nn.Linear(f, f)


def _bf16(t):
    """A matrix operand rounded to bf16 and computed on in f32."""
    return t.to(torch.bfloat16).float()


class GCNStack(nn.Module):
    """Five alternating GAT / GraphConv layers, each followed by LayerNorm
    (eps 1e-6), LeakyReLU 0.2 and the residual; one dropout at the end.
    ``mode`` (set by the caller) is where the matrix operands are rounded:
    ``'dense'``, ``'edge'`` or ``'f32'``."""

    def __init__(self, f: int, adj: np.ndarray, heads: int = 4,
                 layers: int = 5, p: float = 0.0):
        super().__init__()
        self.heads, self.layers, self.mode = heads, layers, 'f32'
        self.dropout = nn.Dropout(p)
        a = torch.as_tensor(adj)
        self.register_buffer('adjacency', a, persistent=False)
        self.register_buffer('gmask', _gat_mask(a), persistent=False)
        mask = _gat_mask(a).numpy()
        dst, src = np.nonzero(mask)
        self.register_buffer('src', torch.as_tensor(src), persistent=False)
        self.register_buffer('dst', torch.as_tensor(dst), persistent=False)
        dt = np.zeros((a.shape[0], len(dst)), np.float32)
        dt[dst, np.arange(len(dst))] = 1.0
        self.register_buffer('dt_mat', torch.as_tensor(dt), persistent=False)
        for i in range(1, layers + 1):
            setattr(self, f'gcn{i}', GATConv(f, adj, heads) if i % 2
                    else GraphConv(f, adj))
            setattr(self, f'norm{i}', nn.LayerNorm(f, eps=1e-6))

    def _op(self, t):
        return t if self.mode == 'f32' else _bf16(t)

    def _dense_layer(self, i, x):
        """Layer i before LayerNorm, rounded as the dense kernel rounds."""
        n, j, f = x.shape
        op, g = self._op, getattr(self, f'gcn{i}')
        if i % 2:
            xw = (op(x).reshape(n * j, f) @ op(g.lin.weight.t())
                  ).view(n, j, self.heads, f)
            a_src = (xw * g.att_src).sum(-1)
            a_dst = (xw * g.att_dst).sum(-1)
            e = F.leaky_relu(a_dst[:, :, None, :] + a_src[:, None, :, :], 0.2)
            e = e.masked_fill(~self.gmask[None, :, :, None], float('-inf'))
            alpha = torch.softmax(e, dim=2)
            out = torch.einsum('nijh,njhf->nif', op(alpha), op(xw)) \
                / self.heads
            return out + g.bias
        neigh = torch.einsum('ij,njf->nif', self.adjacency, op(x))
        return (op(neigh).reshape(n * j, f) @ op(g.lin_rel.weight.t())
                + op(x).reshape(n * j, f) @ op(g.lin_root.weight.t())
                ).view(n, j, f) + g.lin_root.bias

    def _edge_layer(self, i, x):
        """Layer i before LayerNorm on (J, N, F), rounded as the edge-form
        kernel rounds: per-edge softmax weights in f32, each gathered
        rounded XW row times its weight rounded again into the sum."""
        j, n, f = x.shape
        op, g = self._op, getattr(self, f'gcn{i}')
        if i % 2:
            xw = (op(x).reshape(j * n, f) @ op(g.lin.weight.t())
                  ).view(j, n, self.heads, f)
            mask = self.gmask[:, :, None]
            out = torch.zeros_like(x)
            for h in range(self.heads):
                xwh = xw[:, :, h]
                a_src = (xwh * g.att_src[h]).sum(-1)
                a_dst = (xwh * g.att_dst[h]).sum(-1)
                e = F.leaky_relu(a_dst[:, None] + a_src[None], 0.2)
                e = torch.where(mask, e, e.new_tensor(-1e30))
                m = e.amax(1)
                denom = torch.where(mask, torch.exp(e - m[:, None]),
                                    e.new_zeros(())).sum(1)
                logit = F.leaky_relu(a_src[self.src] + a_dst[self.dst], 0.2)
                alpha = torch.exp(logit - m[self.dst]) / denom[self.dst]
                z = op(xwh)[self.src] * alpha[:, :, None]
                out = out + (self.dt_mat @ op(z).reshape(len(self.src), -1)
                             ).view(j, n, f)
            return out / self.heads + g.bias
        neigh = (op(self.adjacency) @ op(x).reshape(j, n * f)).view(j, n, f)
        return (op(neigh) @ op(g.lin_rel.weight.t())
                + op(x) @ op(g.lin_root.weight.t())) + g.lin_root.bias

    def layer_params(self) -> list:
        """Per layer, in (in, out) layout: a GAT layer's (W, att_src,
        att_dst, bias, ln_scale, ln_bias); a GraphConv's (W_rel, W_root,
        bias, ln_scale, ln_bias)."""
        out = []
        for i in range(1, self.layers + 1):
            g, n = getattr(self, f'gcn{i}'), getattr(self, f'norm{i}')
            if i % 2:
                out.append([g.lin.weight.t(), g.att_src, g.att_dst, g.bias,
                            n.weight, n.bias])
            else:
                out.append([g.lin_rel.weight.t(), g.lin_root.weight.t(),
                            g.lin_root.bias, n.weight, n.bias])
        return out

    def forward(self, x):
        shape = x.shape
        x = x.reshape(-1, *shape[-2:])
        if self.mode == 'dense' and torch.is_grad_enabled() and (
                x.requires_grad or any(q.requires_grad
                                       for q in self.parameters())):
            params = [q for layer in self.layer_params() for q in layer]
            y = _DenseStack.apply(x, self, *params)
            return self.dropout(y.reshape(shape))
        edge = self.mode == 'edge'
        if edge:
            x = x.permute(1, 0, 2)
        for i in range(1, self.layers + 1):
            h = self._edge_layer(i, x) if edge else self._dense_layer(i, x)
            norm = getattr(self, f'norm{i}')
            x = F.leaky_relu(_ln(h)[0] * norm.weight + norm.bias, 0.2) + x
        if edge:
            x = x.permute(1, 0, 2).contiguous()
        return self.dropout(x.reshape(shape))


def _ln(h):
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + 1e-6)
    return (h - mean) * inv, inv


class _DenseStack(torch.autograd.Function):
    """The dense stack under autograd with bf16 operands as the trainable
    kernels round them: the forward keeps each layer's input; the backward
    recomputes each layer from it and rounds both operands of every matrix
    product (``d_h / H``, XW, alpha, ``d_xw``, the weights, x, the
    neighbour sums), the logits, softmax, LayerNorm and the attention sums
    in f32."""

    @staticmethod
    def forward(ctx, x, stack, *params):
        layers, at = [], 0
        for i in range(stack.layers):
            k = 6 if i % 2 == 0 else 5
            layers.append(list(params[at:at + k]))
            at += k
        xs = []
        with torch.no_grad():
            for i in range(1, stack.layers + 1):
                xs.append(x)
                h = stack._dense_layer(i, x)
                xhat, _ = _ln(h)
                lp = layers[i - 1]
                x = F.leaky_relu(xhat * lp[-2] + lp[-1], 0.2) + x
        ctx.stack, ctx.layers = stack, layers
        ctx.save_for_backward(*xs)
        return x

    @staticmethod
    def backward(ctx, g):
        stack, layers = ctx.stack, ctx.layers
        xs = ctx.saved_tensors
        op, heads = stack._op, stack.heads
        adj, mask = stack.adjacency, stack.gmask
        n, j, f = xs[0].shape
        grads = [None] * stack.layers
        g = g.float()
        for i in reversed(range(stack.layers)):
            x, layer = xs[i], layers[i]
            ln_scale = layer[-2]
            with torch.no_grad():
                xhat, inv = _ln(stack._dense_layer(i + 1, x))
                y = xhat * ln_scale + layer[-1]
                d_y = g * torch.where(y >= 0, 1.0, 0.2)
                d_ln = ((d_y * xhat).sum((0, 1)), d_y.sum((0, 1)))
                d_xhat = d_y * ln_scale
                m1 = d_xhat.mean(-1, keepdim=True)
                m2 = (d_xhat * xhat).mean(-1, keepdim=True)
                d_h = inv * (d_xhat - m1 - xhat * m2)
                xo = op(x).reshape(n * j, f)
                if i % 2 == 0:
                    w, att_src, att_dst = layer[:3]
                    xw = (xo @ op(w)).view(n, j, heads, f)
                    a_src = (xw * att_src).sum(-1)
                    a_dst = (xw * att_dst).sum(-1)
                    e = a_dst[:, :, None, :] + a_src[:, None, :, :]
                    em = F.leaky_relu(e, 0.2).masked_fill(
                        ~mask[None, :, :, None], float('-inf'))
                    alpha = torch.softmax(em, dim=2)
                    d_outh = op(d_h / heads)
                    d_alpha = torch.einsum('nif,nshf->nish', d_outh, op(xw))
                    d_xw = torch.einsum('nish,nif->nshf', op(alpha), d_outh)
                    s = (alpha * d_alpha).sum(2, keepdim=True)
                    d_e = alpha * (d_alpha - s) * torch.where(e >= 0, 1.0,
                                                              0.2)
                    d_a_dst, d_a_src = d_e.sum(2), d_e.sum(1)
                    d_xw = (d_xw + d_a_src[..., None] * att_src
                            + d_a_dst[..., None] * att_dst)
                    d_xw = op(d_xw).reshape(n * j, heads * f)
                    d_x = (d_xw @ op(w).t()).view(n, j, f)
                    grads[i] = (xo.t() @ d_xw,
                                (xw * d_a_src[..., None]).sum((0, 1)),
                                (xw * d_a_dst[..., None]).sum((0, 1)),
                                d_h.sum((0, 1))) + d_ln
                else:
                    w_rel, w_root = layer[:2]
                    neigh = torch.einsum('ij,njf->nif', adj,
                                         xo.view(n, j, f))
                    d_flat = op(d_h).reshape(n * j, f)
                    d_neigh = (d_flat @ op(w_rel).t()).view(n, j, f)
                    d_x = (torch.einsum('ji,njf->nif', adj, op(d_neigh))
                           + (d_flat @ op(w_root).t()).view(n, j, f))
                    grads[i] = (op(neigh).reshape(n * j, f).t() @ d_flat,
                                xo.t() @ d_flat, d_h.sum((0, 1))) + d_ln
                g = g + d_x
        flat = [t for layer in grads for t in layer]
        return (g, None, *flat)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------


class AudioEncoder(nn.Module):
    def __init__(self, b: int, p: float):
        super().__init__()
        kw = dict(two_d=True, p=p)
        self.conv0 = ConvNormRelu(1, b, downsample=True, **kw)
        self.conv1 = ConvNormRelu(b, 2 * b, downsample=True, **kw)
        self.conv2 = ConvNormRelu(2 * b, 4 * b, downsample=True, **kw)
        self.conv3 = ConvNormRelu(4 * b, 8 * b, **kw)
        self.conv4 = ConvNormRelu(8 * b, 4 * b, kernel=(3, 8), stride=1, **kw)

    def forward(self, x):
        t = x.shape[1]
        x = x[..., None]
        for conv in (self.conv0, self.conv1, self.conv2, self.conv3,
                     self.conv4):
            x = conv(x)
        y = F.interpolate(x.movedim(-1, 1), size=(t, 1), mode='bilinear',
                          align_corners=False)
        return y.movedim(1, -1)[:, :, 0, :]


class UNet1D(nn.Module):
    def __init__(self, c: int, cout: int, p: float):
        super().__init__()
        self.down0 = ConvNormRelu(c, 2 * c, p=p)
        self.down1 = ConvNormRelu(2 * c, 2 * c, downsample=True, p=p)
        self.down2 = ConvNormRelu(2 * c, 4 * c, p=p)
        self.down3 = ConvNormRelu(4 * c, 4 * c, downsample=True, p=p)
        self.bottleneck = ConvNormRelu(4 * c, 8 * c, p=p)
        self.bottleneck_attention = SelfAttention(8 * c)
        self.up0 = ConvTranspose1D(8 * c, 4 * c)
        self.up_attention = SelfAttention(8 * c)
        self.up1 = ConvNormRelu(8 * c, 4 * c, p=p)
        self.up2 = ConvTranspose1D(4 * c, 2 * c)
        self.up3 = ConvNormRelu(4 * c, 2 * c, p=p)
        self.final_conv = nn.Linear(2 * c, cout)

    def forward(self, x):
        skip1 = x = self.down0(x)
        skip2 = x = self.down2(self.down1(x))
        x = self.bottleneck_attention(self.bottleneck(self.down3(x)))
        x = self.up_attention(torch.cat([self.up0(x), skip2], dim=-1))
        x = self.up2(self.up1(x))
        return self.final_conv(self.up3(torch.cat([x, skip1], dim=-1)))


class PartDecoder(nn.Module):
    def __init__(self, c: int, joints: int, f: int, adj, out: int, p: float,
                 heads: int, attention_first: bool, extra_chattn: bool):
        super().__init__()
        self.joints, self.f, self.attention_first = joints, f, attention_first
        self.pre_res = ResBlock(c, p)
        self.pre_conv = ConvNormRelu(c, c, p=p)
        self.pre_chattn = ChannelAttention(c)
        self.pre_attn = SelfAttention(c)
        self.proj_in = nn.Linear(c, joints * f)
        self.gcn = GCNStack(f, adj, heads=heads, p=p)
        self.proj_out = nn.Linear(joints * f, c)
        self.norm = nn.LayerNorm(c, eps=1e-6)
        self.post_res = ResBlock(c, p)
        self.post_conv = ConvNormRelu(c, c, p=p)
        self.post_attn = SelfAttention(c)
        self.post_chattn = ChannelAttention(c) if extra_chattn else None
        self.logits = nn.Linear(c, out)

    def forward(self, x):
        x = self.pre_conv(self.pre_res(x))
        x = (self.pre_attn(self.pre_chattn(x)) if self.attention_first
             else self.pre_chattn(self.pre_attn(x)))
        b, t, _ = x.shape
        x = self.gcn(self.proj_in(x).view(b, t, self.joints, self.f))
        x = self.norm(self.proj_out(x.reshape(b, t, -1)))
        x = self.post_attn(self.post_conv(self.post_res(x)))
        if self.post_chattn is not None:
            x = self.post_chattn(x)
        return self.logits(x)


class Generator(nn.Module):
    """Log-mel (B, T, 128) -> pose (B, T, 104), block layout
    ``[x0..x51, y0..y51]``."""

    def __init__(self, cfg: dict):
        super().__init__()
        c, p = cfg['in_channels'], cfg['dropout']
        self.nb, self.nh = cfg['num_body_joints'], cfg['num_hand_joints']
        f, heads = cfg['joint_feat_dim'], cfg['gat_heads']
        self.audio_encoder = AudioEncoder(c // 4, p)
        self.unet = UNet1D(c, cfg['out_channels'], p)
        co = cfg['out_channels']
        self.body_decoder = PartDecoder(co, self.nb, f, body_adjacency(),
                                        cfg['body_feats'], p, heads, True,
                                        False)
        self.hand_decoder = PartDecoder(co, self.nh, f, hand_adjacency(),
                                        cfg['out_feats'] - cfg['body_feats'],
                                        p, heads, False, True)

    def set_stack_mode(self, mode: str) -> None:
        for m in self.modules():
            if isinstance(m, GCNStack):
                m.mode = mode

    def forward(self, audio):
        feats = self.unet(self.audio_encoder(audio))
        body, hand = self.body_decoder(feats), self.hand_decoder(feats)
        nb, nh = self.nb, self.nh
        return torch.cat([body[..., :nb], hand[..., :nh], body[..., nb:],
                          hand[..., nh:]], dim=-1)


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------


class ConvBNLReLU(nn.Module):
    """Conv -> BatchNorm -> LeakyReLU 0.2 -> Dropout."""

    def __init__(self, cin: int, cout: int, k: int, s: int, p: float):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, s, padding=1)
        self.bn = BatchNorm(cout)
        self.dropout = nn.Dropout(p)

    def forward(self, x):
        x = self.bn(self.conv(x.transpose(1, 2)).transpose(1, 2))
        return self.dropout(F.leaky_relu(x, 0.2))


class Discriminator(nn.Module):
    """Motion (B, T, 104) -> scores (B, T_out)."""

    def __init__(self, cfg: dict):
        super().__init__()
        p, oc = cfg['dropout'], cfg['out_channels']
        self.jf = cfg['joint_feat_dim']
        self.n_down = cfg['n_downsampling']
        self.conv1a = ConvBNLReLU(cfg['in_channels'], oc, 4, 2, p)
        self.conv1b = ConvBNLReLU(oc, oc, 4, 1, p)
        cur = oc
        for n in range(1, self.n_down + 1):
            mul = min(2 ** n, 16)
            setattr(self, f'conv2_{n}a', ConvBNLReLU(cur, cur * mul, 4, 2, p))
            setattr(self, f'conv2_{n}b',
                    ConvBNLReLU(cur * mul, cur * mul, 4, 1, p))
            cur *= mul
        self.conv3a = ConvBNLReLU(cur, cur * 2, 4, 1, p)
        self.conv3b = ConvBNLReLU(cur * 2, cur * 4, 4, 1, p)
        self.conv3_attn = SelfAttention(cur * 4)
        self.conv3c = ConvBNLReLU(cur * 4, cur * 4, 3, 1, p)
        heads = cfg['gat_heads']
        self.body_proj = nn.Linear(cur * 2, NUM_BODY * self.jf)
        self.body_gat = GATConv(self.jf, body_adjacency(), heads)
        self.body_graph_out = nn.Linear(NUM_BODY * self.jf, cur * 2)
        self.hand_proj = nn.Linear(cur * 2, NUM_HAND * self.jf)
        self.hand_gat = GATConv(self.jf, hand_adjacency(), heads)
        self.hand_graph_out = nn.Linear(NUM_HAND * self.jf, cur * 2)
        self.logits = nn.Conv1d(cur * 8, cfg['out_shape'], 3, 1, padding=1)

    def _branch(self, x, proj, gat, out, joints):
        b = x.shape[0]
        return out(gat(proj(x.mean(1)).view(b, joints, self.jf))
                   .reshape(b, -1))

    def forward(self, x):
        if x.shape[1] < 4:
            x = F.pad(x, (0, 0, 0, 4 - x.shape[1] % 4))
        x = self.conv1b(self.conv1a(x))
        for n in range(1, self.n_down + 1):
            x = getattr(self, f'conv2_{n}b')(getattr(self, f'conv2_{n}a')(x))
        x = self.conv3c(self.conv3_attn(self.conv3b(self.conv3a(x))))
        b, t, c = x.shape
        xb = self._branch(x[..., :c // 2], self.body_proj, self.body_gat,
                          self.body_graph_out, NUM_BODY)
        xh = self._branch(x[..., c // 2:], self.hand_proj, self.hand_gat,
                          self.hand_graph_out, NUM_HAND)
        graph = torch.cat([xb, xh], -1)[:, None, :].expand(b, t, c)
        scores = self.logits(torch.cat([x, graph], -1).transpose(1, 2))
        scores = scores.transpose(1, 2)
        return scores[..., 0] if scores.shape[-1] == 1 else scores


# ---------------------------------------------------------------------------
# Weights from a packed a2m ``.npz`` (flax scopes)
# ---------------------------------------------------------------------------

_RENAME = {'kernel': 'weight', 'scale': 'weight', 'mean': 'running_mean',
           'var': 'running_var'}


def load_npz(path) -> tuple[dict, dict]:
    """(flat variables as f32 arrays, normalisation stats ``mean``/``std``)
    of a packed best-generator ``.npz``."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    stats = {k.split('/', 1)[1]: flat.pop(k) for k in list(flat)
             if k.startswith('stats/')}
    return flat, stats


def state_from_flat(flat: dict, model: nn.Module) -> dict:
    """Flat ``params/...`` / ``batch_stats/...`` arrays -> a complete
    state dict of ``model``, kernels transposed to the owning module's
    layout."""
    modules = dict(model.named_modules())
    expected = model.state_dict()
    out = {}
    for key, value in flat.items():
        _, *scope, leaf = key.split('/')
        owner = modules['.'.join(scope)]
        if leaf == 'kernel':
            if isinstance(owner, (nn.Conv1d, nn.Conv2d)):
                value = value.transpose(value.ndim - 1, value.ndim - 2,
                                        *range(value.ndim - 2))
            elif isinstance(owner, ConvTranspose1D):
                value = value.transpose(1, 2, 0)
            elif isinstance(owner, nn.Linear):
                value = value.T
        name = '.'.join(scope + [_RENAME.get(leaf, leaf)])
        if name not in expected or tuple(expected[name].shape) != \
                value.shape:
            raise KeyError(f'{key} -> {name} {value.shape}')
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    missing = set(expected) - set(out)
    if missing:
        raise KeyError(f'not in the file: {sorted(missing)[:5]}')
    return out


def seeded_state(model: nn.Module, seed: int, device) -> dict:
    """A fresh state dict for ``model`` drawn from ``seed`` on ``device``
    in one call: weights and biases of a layer uniform in +-1/sqrt(fan_in),
    attention vectors by Xavier's bound, norm scales 1, shifts and gates 0,
    running statistics 0 and 1."""
    state = model.state_dict()
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(t.numel() for t in state.values())
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    modules = dict(model.named_modules())
    out, at = {}, 0
    for name, t in state.items():
        piece = u[at:at + t.numel()].view(t.shape)
        at += t.numel()
        owner_name, leaf = name.rsplit('.', 1)
        owner = modules[owner_name]
        if isinstance(owner, (BatchNorm, nn.LayerNorm)):
            fill = {'weight': 1.0, 'bias': 0.0, 'running_mean': 0.0,
                    'running_var': 1.0}[leaf]
            out[name] = torch.full_like(piece, fill)
        elif leaf in ('att_src', 'att_dst'):
            out[name] = piece * math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
        elif leaf == 'gamma' or (isinstance(owner, GATConv)
                                 and leaf == 'bias'):
            out[name] = torch.zeros_like(piece)
        else:
            w = getattr(owner, 'weight', None)
            fan_in = (w.shape[1] * int(np.prod(w.shape[2:]))
                      if not isinstance(owner, ConvTranspose1D)
                      else w.shape[1] * w.shape[2])
            out[name] = piece / math.sqrt(fan_in)
    return out


# ---------------------------------------------------------------------------
# Streaming: windows and the crossfade blend
# ---------------------------------------------------------------------------


def window_starts(n_frames: int, window: int = WINDOW, hop: int = 32):
    if n_frames <= window:
        return np.array([0])
    starts = np.arange(0, n_frames - window + 1, hop)
    if starts[-1] + window < n_frames:
        starts = np.append(starts, n_frames - window)
    return starts


def blend(pred: np.ndarray, starts: np.ndarray, n_frames: int,
          window: int = WINDOW) -> np.ndarray:
    """Overlap-add of (W, window, F) window predictions with triangular
    crossfade weights, normalised per frame, in float64."""
    out = np.zeros((n_frames, pred.shape[-1]))
    acc = np.zeros((n_frames, 1))
    w = np.minimum(np.arange(1, window + 1),
                   np.arange(window, 0, -1)).astype(np.float64)[:, None]
    for s, p in zip(starts, pred):
        n = min(window, n_frames - int(s))
        out[s:s + n] += w[:n] * p[:n]
        acc[s:s + n] += w[:n]
    return out / np.maximum(acc, 1e-9)


@torch.no_grad()
def stream_poses(gen: Generator, waves: torch.Tensor, block: int = 32
                 ) -> np.ndarray:
    """(S, N) equal-length streams on the model's device -> (S, T, 104)
    poses: log-mel, every window of 64 frames at hop 32 (the last one
    clamped to the end), the generator over ``block`` windows at a time,
    the crossfade blend."""
    feats = log_mel(waves)
    t = feats.shape[1]
    starts = window_starts(t)
    out = []
    for s in range(feats.shape[0]):
        wins = torch.stack([feats[s, a:a + WINDOW] for a in starts])
        pred = torch.cat([gen(wins[i:i + block])
                          for i in range(0, len(wins), block)])
        out.append(blend(pred.double().cpu().numpy(), starts, t))
    return np.stack(out)


# ---------------------------------------------------------------------------
# Losses and the GAN steps
# ---------------------------------------------------------------------------


def pos_to_motion(pose):
    return pose[:, 1:] - pose[:, :-1]


def safe_norm(x):
    sq = (x * x).sum(-1)
    zero = sq == 0
    return torch.where(zero, torch.zeros_like(sq),
                       torch.sqrt(torch.where(zero, torch.ones_like(sq), sq)))


def to_joints(pose):
    return pose.reshape(*pose.shape[:-1], 2, NUM_JOINTS).transpose(-1, -2)


def _idx(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def bone_lengths(pose):
    parents = _subset_parents()
    child = np.nonzero(parents != -1)[0]
    dev = pose.device
    joints = to_joints(pose)[..., _idx(JOINT_SUBSET, dev), :]
    vec = joints[..., _idx(child, dev), :] - \
        joints[..., _idx(parents[child], dev), :]
    return safe_norm(vec).mean(1)


def _angles(joints, triples):
    dev = joints.device
    p, j, c = (_idx(triples[:, k], dev) for k in range(3))
    a = joints[..., j, :] - joints[..., p, :]
    b = joints[..., c, :] - joints[..., j, :]
    dot = (a * b).sum(-1)
    cross = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    degen = (dot == 0) & (cross == 0)
    ang = torch.atan2(cross, torch.where(degen, torch.ones_like(dot), dot))
    return torch.where(degen, torch.zeros_like(ang), ang)


def _angle_penalty(pose, hand: bool):
    if hand:
        joints, triples, lo = (to_joints(pose)[..., 10:52, :],
                               _triples(_hand_parents()), 0.0)
    else:
        joints, triples, lo = (to_joints(pose)[..., :10, :],
                               _triples(_body_parents()), -math.pi / 2)
    ang = _angles(joints, triples)
    pen = F.relu(lo - ang) + F.relu(ang - math.pi)
    return pen.reshape(pose.shape[0], -1).mean(1)


def masked_mean(x, mask):
    flat = x.reshape(x.shape[0], -1).mean(1)
    return (flat * mask).sum() / mask.sum().clamp_min(1e-8)


def normalize_pose(pose, mean, std):
    b, t, f = pose.shape
    p = pose.reshape(b, t, 2, -1)
    return ((p - p[..., 0:1]).reshape(b, t, f) - mean) / std


def label_params(epoch: int, ctrl: dict) -> tuple[float, float, float]:
    """(smooth real, smooth fake, noise std) of an epoch, annealed."""
    a0, a1 = ctrl['anneal_start_epoch'], ctrl['anneal_end_epoch']
    if epoch < a0:
        progress, noise = 0.0, ctrl['max_noise_std']
    elif epoch > a1:
        progress, noise = 1.0, ctrl['min_noise_std']
    else:
        progress = (epoch - a0) / (a1 - a0)
        noise = ctrl['max_noise_std'] - progress * (
            ctrl['max_noise_std'] - ctrl['min_noise_std'])
    offset = ctrl['max_smooth_offset'] * (1 - progress)
    return (ctrl['real_label_smooth'] - offset,
            ctrl['fake_label_smooth'] + offset, noise)


def smooth_labels(key, b, width, smooth, noise_std, real: bool, device):
    noisy = smooth + noise_std * torch.randn(b, width, generator=key,
                                             device=device)
    return noisy.clamp(0.85, 1.0) if real else noisy.clamp(0.0, 0.15)


def g_step(gen, disc, opt, audio, pose, mask, mean, std, smooth, noise,
           key, train_cfg) -> torch.Tensor:
    """One generator update (D frozen, both in train mode); the total
    loss."""
    gen.train(), disc.train()
    real = normalize_pose(pose, mean, std)
    real_motion = pos_to_motion(real)
    opt.zero_grad(set_to_none=True)
    for p in disc.parameters():
        p.requires_grad_(False)
    BatchNorm.mask = mask
    try:
        fake = gen(audio)
        fake_motion = pos_to_motion(fake)
        fake_d = disc(fake_motion)
    finally:
        BatchNorm.mask = None
        for p in disc.parameters():
            p.requires_grad_(True)
    valid = smooth_labels(key, audio.shape[0], fake_d.shape[-1], smooth,
                          noise, True, audio.device)
    accel = fake_motion[:, 1:] - fake_motion[:, :-1]
    jerk = accel[:, 1:] - accel[:, :-1]
    bone = masked_mean((bone_lengths(fake) - bone_lengths(real)) ** 2, mask)
    angle = masked_mean(0.7 * _angle_penalty(fake, True)
                        + 0.3 * _angle_penalty(fake, False), mask)
    gan = (masked_mean((real_motion - fake_motion).abs(), mask)
           + train_cfg['lambda_gan'] * masked_mean((fake_d - valid) ** 2,
                                                   mask))
    total = (gan + train_cfg['lambda_smooth'] * masked_mean(safe_norm(accel),
                                                            mask)
             + train_cfg['lambda_jerk'] * masked_mean(safe_norm(jerk), mask)
             + bone + angle + train_cfg['lambda_pos']
             * masked_mean((real - fake).abs(), mask))
    total.backward()
    opt.step()
    return total.detach()


def d_step(gen, disc, opt, audio, pose, mask, mean, std, smooth_r, smooth_f,
           noise, key, train_cfg) -> tuple[torch.Tensor, ...]:
    """One discriminator update (G's forward without a gradient, in train
    mode); the total loss, then its real and its fake branch."""
    gen.train(), disc.train()
    real_motion = pos_to_motion(normalize_pose(pose, mean, std))
    BatchNorm.mask = mask
    try:
        with torch.no_grad():
            fake_motion = pos_to_motion(gen(audio))
        opt.zero_grad(set_to_none=True)
        fake_d = disc(fake_motion)
        real_d = disc(real_motion)
    finally:
        BatchNorm.mask = None
    dev = audio.device
    valid = smooth_labels(key, audio.shape[0], real_d.shape[-1], smooth_r,
                          noise, True, dev)
    fake = smooth_labels(key, audio.shape[0], fake_d.shape[-1], smooth_f,
                         noise, False, dev)
    real_loss = masked_mean((real_d - valid) ** 2, mask)
    fake_loss = masked_mean((fake_d - fake) ** 2, mask)
    total = real_loss + train_cfg['lambda_d'] * fake_loss
    total.backward()
    opt.step()
    return total.detach(), real_loss.detach(), fake_loss.detach()


def adam(params, lr: float):
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
