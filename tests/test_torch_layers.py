"""Port building blocks (a2m_torch/nn/layers.py, masking.py) against their
flax twins in a2m/nn, on tiny shapes with seeded random weights.

Tolerance: both sides run f32 on the CPU (a2m at Precision.HIGHEST); they
differ only in summation order, so outputs agree to 1e-5 of max|ref|.
"""

import jax
import numpy as np
import pytest
import torch
from jax.lax import Precision

from a2m.nn import layers as jl
from a2m.nn.masking import MaskedBatchNorm as JaxBN
from a2m_torch.nn import layers as tl
from a2m_torch.nn.masking import MaskedBatchNorm
from torch_parity import max_rel, port_module, randomize, unflatten

TOL = 1e-5

CASES = {
    'cnr1d': (lambda: jl.ConvNormRelu(16, 24, type='1d', leaky=True,
                                      precision=Precision.HIGHEST),
              lambda: tl.ConvNormRelu(16, 24, type='1d', leaky=True),
              (2, 12, 16), dict(train=False)),
    'cnr1d_down': (lambda: jl.ConvNormRelu(16, 16, type='1d',
                                           downsample=True,
                                           precision=Precision.HIGHEST),
                   lambda: tl.ConvNormRelu(16, 16, type='1d',
                                           downsample=True),
                   (2, 12, 16), dict(train=False)),
    'cnr2d_down': (lambda: jl.ConvNormRelu(3, 8, type='2d', leaky=True,
                                           downsample=True,
                                           precision=Precision.HIGHEST),
                   lambda: tl.ConvNormRelu(3, 8, type='2d', leaky=True,
                                           downsample=True),
                   (2, 16, 20, 3), dict(train=False)),
    'cnr2d_k3x8': (lambda: jl.ConvNormRelu(8, 6, type='2d', leaky=True,
                                           kernel_size=(3, 8), stride=1,
                                           precision=Precision.HIGHEST),
                   lambda: tl.ConvNormRelu(8, 6, type='2d', leaky=True,
                                           kernel_size=(3, 8), stride=1),
                   (2, 8, 16, 8), dict(train=False)),
    'self_attention': (lambda: jl.SelfAttention(16),
                       lambda: tl.SelfAttention(16), (2, 10, 16), {}),
    'channel_attention': (lambda: jl.ChannelAttention(16),
                          lambda: tl.ChannelAttention(16), (2, 10, 16), {}),
    'resblock': (lambda: jl.ResBlock(16), lambda: tl.ResBlock(16),
                 (2, 10, 16), dict(train=False)),
    'conv_transpose1d': (lambda: jl.ConvTranspose1D(
                             16, 8, precision=Precision.HIGHEST),
                         lambda: tl.ConvTranspose1D(16, 8), (2, 7, 16),
                         dict(train=False)),
    'batchnorm_eval': (lambda: JaxBN(use_running_average=True),
                       lambda: MaskedBatchNorm(16), (2, 10, 16), {}),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_block_matches_flax(name):
    make_jax, make_port, shape, kwargs = CASES[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = make_jax()
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), x)
    flat = randomize(variables, rng)
    ref = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, **kwargs))(
        unflatten(flat), x))
    port = port_module(make_port(), flat)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert max_rel(got, ref) < TOL, max_rel(got, ref)


@pytest.mark.parametrize('size', [(64, 1), (16, 4)])
def test_bilinear_matches_jax_resize(size):
    """The audio encoder's (8, 15) -> (64, 1) resize: the half-pixel edges of
    jax.image.resize(antialias=False) and F.interpolate(align_corners=False)
    coincide, so the two agree to f32 rounding."""
    x = np.random.default_rng(1).standard_normal((2, 8, 15, 6)).astype(
        np.float32)
    ref = np.asarray(jl.interpolate_bilinear(x, size))
    got = tl.interpolate_bilinear(torch.from_numpy(x), size).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_conv_transpose_weight_is_unflipped():
    """a2m's flipped-kernel dilated correlation equals conv_transpose1d with
    weight[i, o, k] = kernel[k, i, o]; the flipped layout does not."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 5, 4)).astype(np.float32)
    jmod = jl.ConvTranspose1D(4, 3, precision=Precision.HIGHEST)
    v = jax.jit(jmod.init)(jax.random.PRNGKey(0), x)
    flat = randomize(v, rng)
    ref = np.asarray(jmod.apply(unflatten(flat), x, train=False))
    port = port_module(tl.ConvTranspose1D(4, 3), flat)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        port.weight.copy_(port.weight.flip(-1))
        flipped = port(torch.from_numpy(x)).numpy()
    assert max_rel(got, ref) < TOL
    assert max_rel(flipped, ref) > 1e-2


@pytest.mark.parametrize('k,stride,t', [(3, 1, 16), (4, 2, 16), (4, 2, 15),
                                        (3, 1, 5)])
def test_conv1d_as_matmul_equals_conv1d(k, stride, t):
    """The matrix-product form ConvNormRelu takes under autograd is the same
    convolution, forward and backward (f32 summation order apart)."""
    rng = np.random.default_rng(k * 10 + stride)
    pad = tl.torch_pad(k, stride)[0]
    x = torch.from_numpy(rng.standard_normal((3, t, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 6, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    grads = []
    for form in ('matmul', 'conv'):
        xs, ws, bs = (v.clone().requires_grad_() for v in (x, w, b))
        if form == 'matmul':
            y = tl.conv1d_as_matmul(xs, ws, bs, stride, pad)
        else:
            y = torch.nn.functional.conv1d(xs.transpose(1, 2), ws, bs, stride,
                                           pad).transpose(1, 2)
        (y * y).sum().backward()
        grads.append((y.detach(), xs.grad, ws.grad, bs.grad))
    for got, ref in zip(*grads):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_conv_norm_relu_takes_the_matmul_form_only_under_autograd():
    block = tl.ConvNormRelu(6, 5, type='1d', leaky=True).eval()
    x = torch.randn(2, 16, 6)
    with torch.no_grad():
        ref = block(x)
    got = block(x)                       # parameters require a gradient
    assert got.requires_grad and not ref.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.parametrize('in_len,out_len', [(64, 4), (64, 7), (5, 8),
                                            (6, 6)])
def test_adaptive_pool_matrix_matches_a2m_and_torch(in_len, out_len):
    w = tl.adaptive_pool_matrix(in_len, out_len)
    np.testing.assert_allclose(
        w.numpy(), np.asarray(jl.adaptive_pool_matrix(in_len, out_len)),
        atol=1e-7)
    x = torch.randn(2, 3, in_len)
    np.testing.assert_allclose(
        torch.einsum('os,bcs->bco', w, x).numpy(),
        torch.nn.functional.adaptive_avg_pool1d(x, out_len).numpy(),
        atol=1e-6)
