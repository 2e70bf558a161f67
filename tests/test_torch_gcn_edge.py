"""Port edge-form GCN stack (``gcn_kernel.gcn_stack_edge`` and its plain
version, ``GCNStack(fused, fused_edge)``, ``GeneratorConfig.fused_edge``)
against a2m's edge-form Pallas kernel (``fused_gcn_stack(edge_form=True,
tile=8)``, interpret mode on the CPU) and a2m's XLA stack.

Tolerances, as tests/test_pallas_gcn.py and tests/test_torch_gcn.py hold
the kernels:
* f32 (precise) paths within 2e-5 absolute of the HIGHEST-precision stack
  and of the Pallas kernel;
* bf16 operands within 1% of max|ref| of the f32 reference; against the
  Pallas edge kernel's own bf16 mode the plain version rounds the same
  operands at the same places, so the two agree to f32 summation order
  (1e-4 of max|ref|) on every graph but at most one, where a product on a
  bf16 rounding tie may flip;
* the tiny generator within 2% of max|ref| of the unfused one, as a2m's
  ``test_generator_fused_edge_flag_matches_unfused``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.lax import Precision

from a2m import constants
from a2m.config import GeneratorConfig as JaxConfig
from a2m.models import Generator as JaxGenerator
from a2m.nn import pallas_gcn
from a2m.nn.graph import GCNStack as JaxStack
from a2m_torch.config import GeneratorConfig
from a2m_torch.models.generator import Generator
from a2m_torch.nn import gcn_kernel
from a2m_torch.nn.graph import GCNStack
from torch_parity import max_rel, port_module, randomize, unflatten

ADJ = {10: constants.adjacency_from_edges(constants.body_edges(), 10),
       42: constants.adjacency_from_edges(constants.hand_edges(), 42)}
F, HEADS, SHAPE = 16, 2, (2, 3)     # N = 6 graphs: ragged for tile 8
TINY = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2)


@pytest.fixture(scope='module', params=[10, 42], ids=['body', 'hand'])
def stack(request):
    """(J, seeded x, random flat variables, HIGHEST-precision a2m output,
    a2m's kernel-order parameter tuple)."""
    j = request.param
    rng = np.random.default_rng(100 + j)
    x = rng.standard_normal((*SHAPE, j, F)).astype(np.float32)
    jstack = JaxStack(F, ADJ[j], num_layers=5, heads=HEADS,
                      precision=Precision.HIGHEST)
    flat = randomize(jax.jit(jstack.init)(jax.random.PRNGKey(0), x), rng)
    ref = np.asarray(jax.jit(lambda v, a: jstack.apply(v, a))(
        unflatten(flat), x))
    params = pallas_gcn.extract_stack_params(unflatten(flat)['params'])
    return j, x, flat, ref, params


def _port(j, flat, **kw):
    return port_module(GCNStack(F, ADJ[j], num_layers=5, heads=HEADS, **kw),
                       flat)


def _run(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize('j', [10, 42], ids=['body', 'hand'])
def test_edge_matrices_equal_a2m(j):
    got = gcn_kernel.edge_matrices(ADJ[j])
    ref = pallas_gcn.edge_matrices(ADJ[j])
    assert got[0].shape == ((28, 10) if j == 10 else (122, 42))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize('j', [10, 42], ids=['body', 'hand'])
def test_edge_routing_lists_read_off_the_matrices(j):
    """The kernel's index buffer: src/dst of S and D, the per-destination
    ranges, and the nonzero entries of A for GraphConv."""
    adj = torch.as_tensor(ADJ[j])
    routing = gcn_kernel.edge_routing(adj)
    s_mat, d_mat, dt_mat = gcn_kernel.edge_matrices(ADJ[j])
    e, ec = routing['edges'], routing['conv_edges']
    assert e == len(s_mat) and ec == int((ADJ[j] != 0).sum())
    route = routing['route'].numpy()
    src, dst, ptr = route[:e], route[e:2 * e], route[2 * e:2 * e + j + 1]
    csrc = route[2 * e + j + 1:2 * e + j + 1 + ec]
    cptr = route[2 * e + j + 1 + ec:]
    assert len(cptr) == j + 1 and ptr[0] == cptr[0] == 0
    np.testing.assert_array_equal(s_mat[np.arange(e), src], 1)
    np.testing.assert_array_equal(d_mat[np.arange(e), dst], 1)
    rebuilt = np.zeros_like(ADJ[j])
    for node in range(j):
        assert (dst[ptr[node]:ptr[node + 1]] == node).all()
        rebuilt[node, csrc[cptr[node]:cptr[node + 1]]] = \
            routing['conv_w'].numpy()[cptr[node]:cptr[node + 1]]
    np.testing.assert_array_equal(rebuilt, ADJ[j])
    assert gcn_kernel.edge_routing(adj) is routing      # built once


def test_edge_plain_precise_matches_a2m_and_pallas_edge(stack):
    j, x, flat, ref, params = stack
    got = _run(_port(j, flat, fused=True, precise=True, fused_edge=True), x)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    pallas = np.asarray(pallas_gcn.fused_gcn_stack(
        x, params, ADJ[j], heads=HEADS, precise=True, edge_form=True,
        tile=8))
    np.testing.assert_allclose(got, pallas, atol=2e-5)


def test_edge_plain_bf16_matches_pallas_edge_bf16(stack):
    j, x, flat, ref, params = stack
    got = _run(_port(j, flat, fused=True, fused_edge=True), x)
    pallas = np.asarray(pallas_gcn.fused_gcn_stack(
        x, params, ADJ[j], heads=HEADS, precise=False, edge_form=True,
        tile=8))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 0.01 * scale
    # The edge form rounds the product XW_h[src] * alpha, and alpha comes
    # from exp, which the two frameworks round differently in the last
    # bit: a product that lies on a bf16 rounding tie then flips, in that
    # one graph (graphs are independent).  So: every graph but at most one
    # within 1e-4, that one within the bf16 bound.  Rounding at the dense
    # kernel's places instead fails this on every graph (see
    # test_edge_rounds_elsewhere_than_the_dense_kernel).
    per_graph = np.abs(got - pallas).reshape(-1, j * F).max(1)
    assert (per_graph >= 1e-4 * scale).sum() <= 1, per_graph / scale
    assert per_graph.max() < 0.01 * scale


def test_edge_plain_matches_eager_stack_and_dense_plain(stack):
    j, x, flat, ref, _ = stack
    edge = _run(_port(j, flat, fused=True, precise=True, fused_edge=True), x)
    np.testing.assert_allclose(edge, _run(_port(j, flat), x), atol=2e-5)
    dense = _run(_port(j, flat, fused=True, precise=True), x)
    np.testing.assert_allclose(edge, dense, atol=2e-5)


def test_edge_rounds_elsewhere_than_the_dense_kernel(stack):
    """With bf16 operands the edge form is not the dense kernel's function:
    alpha stays f32 and the weighted value is rounded instead."""
    j, x, flat, ref, _ = stack
    edge = _run(_port(j, flat, fused=True, fused_edge=True), x)
    dense = _run(_port(j, flat, fused=True), x)
    per_graph = np.abs(edge - dense).reshape(-1, j * F).max(1)
    assert (per_graph > 1e-4 * np.abs(ref).max()).all()


def test_fused_edge_without_fused_changes_nothing(stack):
    j, x, flat, _, _ = stack
    np.testing.assert_array_equal(_run(_port(j, flat, fused_edge=True), x),
                                  _run(_port(j, flat), x))


def test_autograd_takes_the_trainable_route(stack, monkeypatch):
    """Under autograd ``fused_edge`` is not consulted: the stack runs the
    stash-forward and backward route and gives the gradients of
    ``fused_edge=False``."""
    j, x, flat, _, _ = stack

    def no_edge(*args, **kw):
        raise AssertionError('edge form reached under autograd')

    monkeypatch.setattr(gcn_kernel, 'gcn_stack_edge', no_edge)
    grads = {}
    for edge in (True, False):
        module = _port(j, flat, fused=True, precise=True, fused_edge=edge)
        xt = torch.from_numpy(x).requires_grad_()
        y = module(xt)
        assert 'TrainableStack' in type(y.grad_fn).__name__
        (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum().backward()
        grads[edge] = [xt.grad] + [p.grad for p in module.parameters()]
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_checks_params_and_keeps_leading_shape():
    x = torch.zeros(2, 3, 10, F)
    adj = torch.as_tensor(ADJ[10])
    params = torch.zeros(gcn_kernel.num_params(F, HEADS, 5))
    assert gcn_kernel.gcn_stack_edge(x, params, adj, HEADS).shape == x.shape
    with pytest.raises(ValueError):
        gcn_kernel.gcn_stack_edge(x, params[1:], adj, HEADS)
    with pytest.raises(ValueError):
        gcn_kernel.gcn_stack_edge(x, params, torch.as_tensor(ADJ[42]), HEADS)
    with pytest.raises(TypeError):
        gcn_kernel.gcn_stack_edge(x.double(), params, adj, HEADS)


def test_edge_cost_model_counts_the_routing_lists():
    n = 13824
    dense = gcn_kernel.stack_bytes(n, 42, 64, 4)
    edge = gcn_kernel.stack_edge_bytes(n, ADJ[42], 64, 4)
    # the dense (J, J) adjacency out, 2 E + 2 Ec + 2 (J + 1) indices in
    assert edge - dense == 4 * (2 * 122 + 2 * 80 + 2 * 43 - 42 * 42)
    assert gcn_kernel.stack_flops(n, ADJ[42], 64, 4) > 0


@pytest.fixture(scope='module')
def tiny():
    """(seeded log-mel (2, 64, 128), flat random variables, a2m's unfused
    pose at HIGHEST precision, a2m's fused_edge pose)."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 64, 128)).astype(np.float32)
    cfg = JaxConfig(**TINY)
    model = JaxGenerator(cfg, precision=Precision.HIGHEST)
    key = jax.random.PRNGKey(0)
    v = jax.jit(model.init)({'params': key, 'dropout': key}, feats)
    flat = randomize(v, rng)
    ref = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        unflatten(flat), feats))
    edge = JaxGenerator(dataclasses.replace(cfg, fused_gcn=True,
                                            fused_edge=True, fused_tile=8))
    edge_ref = np.asarray(edge.apply(unflatten(flat), feats, train=False))
    return feats, flat, ref, edge_ref


@pytest.mark.parametrize('precise,tol,edge_tol', [
    (True, 1e-4, 0.02), (False, 0.02, 1e-3)], ids=['precise', 'bf16'])
def test_generator_fused_edge_matches_a2m(tiny, precise, tol, edge_tol):
    """Against a2m's unfused generator (2% with bf16 operands, as a2m's own
    test; 1e-4 with f32 operands), and against a2m's generator on its
    edge-form kernel with bf16 operands, whose rounding the port's bf16
    mode repeats (1e-3: f32 order through the rest of the network)."""
    feats, flat, ref, edge_ref = tiny
    cfg = GeneratorConfig(**TINY, fused_gcn=True, fused_edge=True,
                          fused_precise=precise)
    port = port_module(Generator(cfg), flat)
    assert port.hand_decoder.gcn.fused_edge and port.body_decoder.gcn.fused
    with torch.no_grad():
        got = port(torch.from_numpy(feats)).numpy()
    assert got.shape == ref.shape == (2, 64, 104)
    assert max_rel(got, ref) < tol, max_rel(got, ref)
    assert max_rel(got, edge_ref) < edge_tol, max_rel(got, edge_ref)
