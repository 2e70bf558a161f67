"""Train-mode MaskedBatchNorm of the port (a2m_torch/nn/masking.py) against
a2m's (a2m/nn/masking.py): output within 1e-5, new running mean and
(biased) variance within 1e-6, with and without a batch mask; a corrupted
masked row changes nothing for the other rows.  Eval mode is held by
tests/test_torch_layers.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a2m.nn import masking as jmasking
from a2m_torch.nn import masking
from torch_parity import port_module

SHAPES = {'1d': (4, 6, 5), '2d': (4, 3, 6, 5)}


def _variables(rng, c):
    return {'params/scale': (1 + 0.1 * rng.standard_normal(c)),
            'params/bias': 0.1 * rng.standard_normal(c),
            'batch_stats/mean': 0.1 * rng.standard_normal(c),
            'batch_stats/var': rng.uniform(0.5, 1.5, c)}


def _jax_train(flat, x, mask):
    bn = jmasking.MaskedBatchNorm(use_running_average=False)
    variables = {'params': {'scale': jnp.asarray(flat['params/scale'],
                                                 jnp.float32),
                            'bias': jnp.asarray(flat['params/bias'],
                                                jnp.float32)},
                 'batch_stats': {'mean': jnp.asarray(flat['batch_stats/mean'],
                                                     jnp.float32),
                                 'var': jnp.asarray(flat['batch_stats/var'],
                                                    jnp.float32)}}
    with jmasking.batch_mask(None if mask is None else jnp.asarray(mask)):
        y, mutated = bn.apply(variables, jnp.asarray(x),
                              mutable=['batch_stats'])
    return (np.asarray(y), np.asarray(mutated['batch_stats']['mean']),
            np.asarray(mutated['batch_stats']['var']))


def _port_train(flat, x, mask):
    bn = port_module(masking.MaskedBatchNorm(x.shape[-1]), flat).train()
    with masking.batch_mask(None if mask is None else torch.as_tensor(mask)):
        y = bn(torch.from_numpy(x))
    return (y.detach().numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy())


@pytest.mark.parametrize('kind', ['1d', '2d'])
@pytest.mark.parametrize('masked', [False, True], ids=['nomask', 'mask'])
def test_train_mode_matches_a2m(kind, masked):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(SHAPES[kind]) * 2 + 1).astype(np.float32)
    flat = _variables(rng, x.shape[-1])
    mask = np.array([1, 1, 0, 1], np.float32) if masked else None
    got, ref = _port_train(flat, x, mask), _jax_train(flat, x, mask)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-6)
    # the running variance moved towards the biased batch variance
    m = x if mask is None else x[mask > 0]
    biased = m.reshape(-1, x.shape[-1]).var(axis=0)
    np.testing.assert_allclose(
        got[2], 0.9 * flat['batch_stats/var'] + 0.1 * biased, atol=1e-5)


def test_masked_row_is_inert():
    rng = np.random.default_rng(8)
    x = rng.standard_normal(SHAPES['1d']).astype(np.float32)
    flat = _variables(rng, x.shape[-1])
    mask = np.array([1, 0, 1, 1], np.float32)
    a = _port_train(flat, x, mask)
    x2 = x.copy()
    x2[1] = 1e3 * rng.standard_normal(x[1].shape)
    b = _port_train(flat, x2, mask)
    keep = mask > 0
    np.testing.assert_array_equal(a[0][keep], b[0][keep])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def test_all_ones_mask_equals_no_mask_and_eval_ignores_the_mask():
    rng = np.random.default_rng(9)
    x = rng.standard_normal(SHAPES['1d']).astype(np.float32)
    flat = _variables(rng, x.shape[-1])
    a = _port_train(flat, x, None)
    b = _port_train(flat, x, np.ones(4, np.float32))
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, v, atol=1e-6)
    bn = port_module(masking.MaskedBatchNorm(x.shape[-1]), flat)   # eval
    with masking.batch_mask(torch.tensor([1., 0., 1., 1.])):
        y = bn(torch.from_numpy(x))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  bn(torch.from_numpy(x)).detach().numpy())
    np.testing.assert_allclose(bn.running_var.numpy(),
                               flat['batch_stats/var'], atol=1e-7)
