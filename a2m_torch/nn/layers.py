"""Core building blocks, channel-last at every module boundary.

Counterparts of ``a2m/nn/layers.py`` (``:30-222``).  Each module takes and
returns a2m's channel-last layout, ``(B, T, C)`` or ``(B, H, W, C)``; the
convolutions permute to PyTorch's channel-first views internally (for 2-D
the permuted view is channels_last memory, which cuDNN runs without a copy).
Attribute names follow a2m's flax scopes so that weights carry across by a
rename (see :mod:`a2m_torch.weights`).

**Compute dtype.**  Every module takes a2m's ``dtype``: ``torch.bfloat16``
runs each convolution and matrix product in bf16 as flax does with
``dtype=jnp.bfloat16`` (input, weight and bias cast at each use by
:class:`Linear`, :class:`Conv1d`, :class:`Conv2d`; the parameters stay f32,
flax's ``param_dtype``), and keeps a2m's casts site by site: BatchNorm,
LayerNorm and softmax in f32, a module output cast back to ``dtype`` where
a2m casts it and promoted to f32 where a2m adds an f32 parameter.  The
default ``torch.float32`` casts nothing, so a model moved to float64 (a
test's reference) computes in float64.

**Tensor parallelism.**  ``ConvNormRelu`` (column-parallel),
``SelfAttention`` and ``ConvTranspose1D`` (row-parallel) have sharded modes
that :func:`a2m_torch.parallel.mesh.shard_module` switches on (``shard_``)
for the layers ``TP_RULES`` name; without it they change nothing.  A
column-parallel layer keeps its slice of the output channels and runs its
bias, dropout and BatchNorm on them; a row-parallel one its slice of the
input channels, whose partial products the model group sums
(:mod:`a2m_torch.parallel.tensor`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from a2m_torch.nn.masking import MaskedBatchNorm
from a2m_torch.parallel import tensor as tp_ops


def cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    """``t`` in the compute dtype: a half type casts, ``torch.float32`` (the
    default) leaves ``t`` as it is."""
    return t if t is None or dtype == torch.float32 else t.to(dtype)


def f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least f32 (a bf16 tensor to f32, a float64 one kept):
    where a2m computes in f32 whatever the module's dtype."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class _InDtype:
    """Mixin of a layer that computes in ``dtype`` (flax's ``dtype=``):
    its forward casts input, weight and bias at each use."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype


class Linear(_InDtype, nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``Dense(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(cast(x, dt), cast(self.weight, dt),
                        cast(self.bias, dt))


class _ConvInDtype(_InDtype):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return self._conv_forward(cast(x, dt), cast(self.weight, dt),
                                  cast(self.bias, dt))


class Conv1d(_ConvInDtype, nn.Conv1d):
    """``nn.Conv1d`` computing in ``dtype`` (flax ``Conv(dtype=...)``)."""


class Conv2d(_ConvInDtype, nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (flax ``Conv(dtype=...)``)."""


def keep_slice(module: nn.Module, name: str, dim: int, shard) -> None:
    """Replace parameter ``name`` of ``module`` by this rank's slice of it
    along ``dim``."""
    full = getattr(module, name).detach()
    part = shard.part(full.shape[dim])
    setattr(module, name, nn.Parameter(
        full.narrow(dim, part.start, part.stop - part.start).clone()))


def sharded_mode(own: dict, modes: dict, layer: str) -> str:
    """The sharded mode (``modes``: mode -> its parameters' dimensions) that
    the sliced parameters ``own`` of ``layer`` ask for."""
    for mode, dims in modes.items():
        if own == dims:
            return mode
    raise ValueError(f'{layer}: no sharded mode slices {own}')


def torch_pad(kernel_size, stride):
    """Reference padding rule ``int((k - s) / 2)`` per spatial axis
    (``a2m/nn/layers.py:30-43``)."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,)
    if isinstance(stride, int):
        stride = (stride,) * len(kernel_size)
    return tuple(int((k - s) / 2) for k, s in zip(kernel_size, stride))


def conv1d_as_matmul(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None, stride: int, padding: int
                     ) -> torch.Tensor:
    """``conv1d`` over channel-last ``x`` (B, T, C) with ``weight``
    (O, C, k) as one matrix product: the k shifted copies of ``x`` side by
    side, (B, T_out, k * C) @ (k * C, O).  The same sums as the convolution
    in another order."""
    out_ch, in_ch, k = weight.shape
    xp = F.pad(x, (0, 0, padding, padding))
    t_out = (x.shape[1] + 2 * padding - k) // stride + 1
    span = (t_out - 1) * stride + 1
    cols = torch.cat([xp[:, i:i + span:stride, :] for i in range(k)], dim=-1)
    y = cols @ weight.permute(2, 1, 0).reshape(k * in_ch, out_ch)
    return y if bias is None else y + bias


class ConvNormRelu(nn.Module):
    """Conv -> Dropout -> BatchNorm -> (Leaky)ReLU -> cast to ``dtype``
    (``a2m/nn/layers.py:46-94``).  ``downsample`` selects k4/s2, else k3/s1,
    unless ``kernel_size``/``stride`` are given; ``padding`` (an int or one
    int an axis, both sides) replaces the rule ``int((k - s) / 2)``.
    ``groups`` multiplies both channel counts (the reference's grouped-conv
    convention): the convolution maps ``in_channels * groups`` channels to
    ``out_channels * groups`` in ``groups`` groups.  The convolution runs in
    ``dtype``, the BatchNorm in f32.

    Under autograd an ungrouped 1-D convolution runs as
    :func:`conv1d_as_matmul` (cuBLAS): with TF32 off, cuDNN's f32 backward
    of these short sequences takes FFT algorithms that cost 30.6 ms forward
    + backward for (128, 64, 256) -> 256 channels, k 3, against 1.3 ms for
    the matrix product, and 199.6 against 2.2 ms at 1024 -> 512 channels
    (NVIDIA H100 80GB HBM3, 700 W; ``cudnn.benchmark`` and a contiguous or
    channels-last input change nothing).  Gradient-free forwards and
    grouped convolutions keep the cuDNN convolution."""

    def __init__(self, in_channels: int, out_channels: int, type: str = '1d',
                 leaky: bool = False, downsample: bool = False,
                 kernel_size=None, stride=None, padding=None, p: float = 0.0,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        ndim = 1 if type == '1d' else 2
        k, s = kernel_size, stride
        if k is None and s is None:
            k, s = (4, 2) if downsample else (3, 1)
        if isinstance(k, int):
            k = (k,) * ndim
        if isinstance(s, int):
            s = (s,) * ndim
        if padding is None:
            padding = torch_pad(tuple(k), tuple(s))
        elif isinstance(padding, int):
            padding = (padding,) * ndim
        conv = Conv1d if ndim == 1 else Conv2d
        self.conv = conv(in_channels * groups, out_channels * groups,
                         tuple(k), tuple(s), padding=tuple(padding),
                         groups=groups, dtype=dtype)
        self.dropout = nn.Dropout(p)
        self.norm = MaskedBatchNorm(out_channels * groups)
        self.leaky, self.dtype = leaky, dtype
        self.tp = None

    def shard_(self, shard, own: dict) -> tuple[dict, list]:
        """Column-parallel (an ungrouped 1-D convolution sliced on its
        output channels): the input's gradient is summed over the model
        group; the bias (replicated) and the BatchNorm act on this rank's
        channels."""
        sharded_mode(own, {'column': {'conv.weight': 0}}, 'ConvNormRelu')
        if not isinstance(self.conv, nn.Conv1d) or self.conv.groups != 1:
            raise ValueError('ConvNormRelu: only an ungrouped 1-D '
                             'convolution shards')
        keep_slice(self.conv, 'weight', 0, shard)
        state, partial = self.norm.shard_(shard)
        self.tp = shard
        return ({'conv.weight': 0, **{f'norm.{k}': d
                                      for k, d in state.items()}},
                ['conv.bias'] + [f'norm.{k}' for k in partial])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, dt, tp = self.conv, self.dtype, self.tp
        bias = conv.bias
        if tp is not None:
            x = tp_ops.copy_to_model(x, tp)
            bias = bias[tp.part(bias.numel())]
        if (isinstance(conv, nn.Conv1d) and conv.groups == 1
                and torch.is_grad_enabled()
                and (x.requires_grad or conv.weight.requires_grad)):
            x = conv1d_as_matmul(cast(x, dt), cast(conv.weight, dt),
                                 cast(bias, dt), conv.stride[0],
                                 conv.padding[0])
        else:
            x = conv._conv_forward(cast(x.movedim(-1, 1), dt),
                                   cast(conv.weight, dt),
                                   cast(bias, dt)).movedim(1, -1)
        if tp is None:
            x = self.dropout(x)
        else:
            x = tp_ops.dropout(x, self.dropout.p, self.dropout.training, tp)
        x = self.norm(x)
        return cast(F.leaky_relu(x, 0.2) if self.leaky else F.relu(x), dt)


class SelfAttention(nn.Module):
    """SAGAN-style self-attention, UNSCALED logits (no 1/sqrt(d)), with a
    learnable scalar gate (``a2m/nn/layers.py:97-113``).  Input (B, T, C).
    The products run in ``dtype``, the softmax in f32; the f32 gate
    promotes the output ``gamma * out + x`` to f32."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.query = Linear(in_channels, in_channels // 8, dtype=dtype)
        self.key = Linear(in_channels, in_channels // 8, dtype=dtype)
        self.value = Linear(in_channels, in_channels, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.tp = None

    def shard_(self, shard, own: dict) -> tuple[dict, list]:
        """Row-parallel (query, key and value sliced on their input
        channels; the input is this rank's channels): the partial query and
        key are summed over the model group, the partial value
        reduce-scattered to this rank's channels, and ``gamma * attn @ v +
        x`` stays on them."""
        rows = {f'{n}.weight': 1 for n in ('query', 'key', 'value')}
        sharded_mode(own, {'row': rows}, 'SelfAttention')
        for name in ('query', 'key', 'value'):
            keep_slice(getattr(self, name), 'weight', 1, shard)
        self.tp = shard
        return rows, ['value.bias', 'gamma']

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            q, k, v = self.query(x), self.key(x), self.value(x)
        else:
            q, k, v = self._sharded_qkv(x)
        attn = torch.softmax(f32(q @ k.transpose(1, 2)), dim=-1)  # (B, T, T)
        if self.tp is not None:
            # each rank applies the attention to its channels only
            attn = tp_ops.copy_to_model(attn, self.tp)
        return self.gamma * (attn.to(v.dtype) @ v) + x

    def _sharded_qkv(self, x: torch.Tensor) -> tuple:
        tp, dt = self.tp, self.query.dtype

        def part(lin):          # this rank's term of x @ W.T
            return F.linear(cast(x, dt), cast(lin.weight, dt))

        q = tp_ops.reduce_from_model(part(self.query), tp) + self.query.bias
        k = tp_ops.reduce_from_model(part(self.key), tp) + self.key.bias
        bias = self.value.bias
        v = (tp_ops.reduce_scatter_channels(part(self.value), tp)
             + bias[tp.part(bias.numel())])
        return cast(q, dt), cast(k, dt), cast(v, dt)


class ChannelAttention(nn.Module):
    """SE-style channel gate with a shared MLP over mean and max pools
    (``a2m/nn/layers.py:116-133``).  Input (B, T, C).  The MLP layers keep
    flax's auto names ``Dense_0`` / ``Dense_1``; the gate comes out in
    ``dtype`` and ``x * gate`` takes the wider of the two."""

    def __init__(self, channel: int, reduction: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Linear(channel, channel // reduction, dtype=dtype)
        self.Dense_1 = Linear(channel // reduction, channel, dtype=dtype)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self._mlp(x.mean(dim=1))
                             + self._mlp(x.amax(dim=1)))
        return x * gate[:, None, :]


class ResBlock(nn.Module):
    """2x ConvNormRelu + SelfAttention + residual
    (``a2m/nn/layers.py:136-154``)."""

    def __init__(self, channels: int, type: str = '1d', p: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        common = dict(type=type, leaky=True, p=p, dtype=dtype)
        self.conv1 = ConvNormRelu(channels, channels, **common)
        self.conv2 = ConvNormRelu(channels, channels, **common)
        self.attention = SelfAttention(channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention(self.conv2(self.conv1(x))) + x


class ConvTranspose1D(nn.Module):
    """Transposed conv (k3, s2, p1, op1: exactly doubles T) + BN + ReLU
    (``a2m/nn/layers.py:157-194``).

    a2m flips its ``(k, in, out)`` kernel and runs an lhs-dilated
    correlation; that is ``conv_transpose1d`` with
    ``weight[i, o, k] = kernel[k, i, o]`` and NO flip (held by
    ``tests/test_torch_layers.py``).  The convolution runs in ``dtype``;
    the f32 bias is added after it (promoting to f32), then the BatchNorm,
    and the output is cast to ``dtype``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 2, padding: int = 1,
                 output_padding: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.stride, self.padding = stride, padding
        self.output_padding, self.dtype = output_padding, dtype
        self.bn = MaskedBatchNorm(out_channels)
        self.tp = None

    def shard_(self, shard, own: dict) -> tuple[dict, list]:
        """Row-parallel (the kernel sliced on its input channels; the input
        is this rank's channels): the partial output is summed over the
        model group before the bias and the BatchNorm, which stay whole."""
        sharded_mode(own, {'row': {'weight': 0}}, 'ConvTranspose1D')
        keep_slice(self, 'weight', 0, shard)
        self.tp = shard
        return {'weight': 0}, []

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv_transpose1d(cast(x, dt).transpose(1, 2),
                               cast(self.weight, dt), None,
                               stride=self.stride, padding=self.padding,
                               output_padding=self.output_padding)
        if self.tp is not None:
            y = cast(tp_ops.reduce_from_model(y, self.tp), dt)
        return cast(F.relu(self.bn(y.transpose(1, 2) + self.bias)), dt)


def adaptive_pool_matrix(in_len: int, out_len: int) -> torch.Tensor:
    """(out_len, in_len) averaging matrix with ``adaptive_avg_pool1d``
    semantics (``a2m/nn/layers.py:197-213``): output bin ``i`` is the mean
    of input rows ``[floor(i * L / out), ceil((i + 1) * L / out))``, for any
    pair of lengths."""
    w = torch.zeros(out_len, in_len)
    for i in range(out_len):
        s = (i * in_len) // out_len
        e = -(-((i + 1) * in_len) // out_len)
        w[i, s:e] = 1.0 / (e - s)
    return w


def interpolate_bilinear(x: torch.Tensor, size: tuple[int, int]
                         ) -> torch.Tensor:
    """``F.interpolate(bilinear, align_corners=False)`` on channel-last
    (B, H, W, C); equals a2m's ``jax.image.resize(bilinear,
    antialias=False)`` (``a2m/nn/layers.py:216-222``) at the
    (8, 15) -> (64, 1) resize of the audio encoder."""
    y = F.interpolate(x.movedim(-1, 1), size=size, mode='bilinear',
                      align_corners=False)
    return y.movedim(1, -1)
