"""Port GCN stack (a2m_torch/nn/graph.py, gcn_kernel.py) against a2m's
GCNStack and its fused Pallas kernel (interpret mode on the CPU).

Tolerances, as tests/test_pallas_gcn.py holds the Pallas kernel:
* f32 (precise) paths within 2e-5 absolute of the HIGHEST-precision stack;
* bf16-operand paths within 1% of max|ref| of an f32 reference.  Against
  the Pallas kernel's own bf16 mode the port rounds the same operands at
  the same places, so the two agree to f32 summation order (1e-4 of
  max|ref|: a rounding tie of one operand can flip either way).
"""

import jax
import numpy as np
import pytest
import torch
from jax.lax import Precision

from a2m import constants
from a2m.nn import pallas_gcn
from a2m.nn.graph import GCNStack as JaxStack
from a2m_torch.nn import gcn_kernel
from a2m_torch.nn.graph import GCNStack
from torch_parity import port_module, randomize, unflatten

ADJ = {10: constants.adjacency_from_edges(constants.body_edges(), 10),
       42: constants.adjacency_from_edges(constants.hand_edges(), 42)}
F, HEADS, SHAPE = 16, 2, (2, 3)     # N = 6 graphs: ragged for any tile


@pytest.fixture(scope='module', params=[10, 42], ids=['body', 'hand'])
def stack(request):
    """(J, seeded x, random flat variables, HIGHEST-precision a2m output)."""
    j = request.param
    rng = np.random.default_rng(j)
    x = rng.standard_normal((*SHAPE, j, F)).astype(np.float32)
    jstack = JaxStack(F, ADJ[j], num_layers=5, heads=HEADS,
                      precision=Precision.HIGHEST)
    flat = randomize(jax.jit(jstack.init)(jax.random.PRNGKey(0), x), rng)
    ref = np.asarray(jax.jit(lambda v, a: jstack.apply(v, a))(
        unflatten(flat), x))
    return j, x, flat, ref


def _port(j, flat, **kw):
    return port_module(GCNStack(F, ADJ[j], num_layers=5, heads=HEADS, **kw),
                       flat)


def _run(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


def test_eager_stack_matches_a2m(stack):
    j, x, flat, ref = stack
    np.testing.assert_allclose(_run(_port(j, flat), x), ref, atol=2e-5)


def test_kernel_plain_precise_matches_a2m_and_pallas(stack):
    j, x, flat, ref = stack
    got = _run(_port(j, flat, fused=True, precise=True), x)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    params = pallas_gcn.extract_stack_params(unflatten(flat)['params'])
    pallas = np.asarray(pallas_gcn.fused_gcn_stack(
        x, params, ADJ[j], heads=HEADS, precise=True, rolled=True))
    np.testing.assert_allclose(got, pallas, atol=2e-5)


def test_kernel_plain_bf16_matches_pallas_bf16(stack):
    j, x, flat, ref = stack
    got = _run(_port(j, flat, fused=True), x)
    params = pallas_gcn.extract_stack_params(unflatten(flat)['params'])
    pallas = np.asarray(pallas_gcn.fused_gcn_stack(
        x, params, ADJ[j], heads=HEADS, precise=False))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 0.01 * scale
    assert np.abs(got - pallas).max() < 1e-4 * scale


def test_fused_stack_packs_once_and_repacks_after_load(stack):
    j, x, flat, ref = stack
    fused = _port(j, flat, fused=True, precise=True)
    with torch.inference_mode():
        packed = fused.packed_params()
    assert fused.packed_params() is packed
    assert not packed.is_inference()
    other = GCNStack(F, ADJ[j], num_layers=5, heads=HEADS)
    fused.load_state_dict(other.state_dict())
    assert fused.packed_params() is not packed
    np.testing.assert_allclose(_run(fused, x), _run(other, x), atol=2e-5)


def test_wrapper_checks_params_and_keeps_leading_shape():
    x = torch.zeros(2, 3, 10, F)
    adj = torch.as_tensor(ADJ[10])
    params = torch.zeros(gcn_kernel.num_params(F, HEADS, 5))
    assert gcn_kernel.gcn_stack(x, params, adj, HEADS).shape == x.shape
    with pytest.raises(ValueError):
        gcn_kernel.gcn_stack(x, params[1:], adj, HEADS)
    with pytest.raises(ValueError):
        gcn_kernel.gcn_stack(x, params, torch.as_tensor(ADJ[42]), HEADS)
