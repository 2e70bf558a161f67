"""Trainable fused GCN stack of the port (a2m_torch/nn/gcn_kernel.py:
gcn_stack_fwd, gcn_stack_bwd, gcn_stack_trainable) against a2m's
``fused_gcn_stack_trainable`` (Pallas forward-with-stash and backward
kernels, interpret mode on the CPU) and against ``torch.autograd`` through
the port's eager stack.  On the CPU the port runs the plain versions.

Tolerances, as tests/test_pallas_gcn.py holds a2m's own backward:
* f32 operands: y 2e-5 absolute, dx 2e-4 of max|dx_ref|, each parameter
  gradient 5e-4 of max(max|ref|, 1e-3);
* bf16 operands against a2m's bf16 backward: 1% of max|ref| per tensor (both
  round the same operands; a sum near a rounding tie can flip one).
"""

import jax
import jax.numpy as jnp
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
def case(request):
    """J, seeded x and cotangent w, random flat variables, and a2m's fused
    (y, dx, dparams) in both operand modes."""
    j = request.param
    rng = np.random.default_rng(100 + j)
    x = rng.standard_normal((*SHAPE, j, F)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jstack = JaxStack(F, ADJ[j], num_layers=5, heads=HEADS,
                      precision=Precision.HIGHEST)
    flat = randomize(jax.jit(jstack.init)(jax.random.PRNGKey(0), x), rng)
    params = pallas_gcn.extract_stack_params(unflatten(flat)['params'])
    ref = {}
    for precise in (True, False):
        def loss(x_, params_):
            y = pallas_gcn.fused_gcn_stack_trainable(
                x_, params_, ADJ[j], heads=HEADS, precise=precise)
            return (y * w).sum(), y
        (_, y), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(jnp.asarray(x),
                                                            params)
        ref[precise] = (np.asarray(y), np.asarray(gx),
                        [np.asarray(g) for g in gp])
    return j, x, w, flat, ref


def _port(j, flat, **kw):
    return port_module(GCNStack(F, ADJ[j], num_layers=5, heads=HEADS, **kw),
                       flat)


def _plain(j, x, w, flat, precise):
    """(y, dx, per-tensor parameter gradients) of the plain versions."""
    stack = _port(j, flat)
    adj = torch.as_tensor(ADJ[j])
    xf = torch.from_numpy(x).reshape(-1, j, F)
    packed = stack.packed_params()
    y, xs = gcn_kernel.gcn_stack_fwd(xf, packed, adj, HEADS, precise=precise)
    dx, dflat = gcn_kernel.gcn_stack_bwd(
        xf, xs, torch.from_numpy(w).reshape(-1, j, F), packed, adj, HEADS,
        precise=precise)
    grads = [g.numpy() for layer in gcn_kernel._unpack(dflat, F, HEADS, 5)
             for g in layer]
    return (y.numpy().reshape(x.shape), dx.numpy().reshape(x.shape), grads)


def _assert_grads(got, ref, dx_tol, p_tol, floor=1e-3):
    (y, dx, gp), (y_r, dx_r, gp_r) = got, ref
    scale = np.abs(dx_r).max()
    np.testing.assert_allclose(dx, dx_r, atol=dx_tol * scale)
    assert len(gp) == len(gp_r)
    for i, (a, b) in enumerate(zip(gp, gp_r)):
        s = max(np.abs(b).max(), floor)
        np.testing.assert_allclose(a, b.reshape(a.shape), atol=p_tol * s,
                                   err_msg=f'param {i}')


def test_plain_precise_matches_a2m_fused_backward(case):
    j, x, w, flat, ref = case
    got = _plain(j, x, w, flat, precise=True)
    np.testing.assert_allclose(got[0], ref[True][0], atol=2e-5)
    _assert_grads(got, ref[True], 2e-4, 5e-4)


def test_plain_bf16_matches_a2m_bf16_backward(case):
    j, x, w, flat, ref = case
    got = _plain(j, x, w, flat, precise=False)
    scale = np.abs(ref[False][0]).max()
    assert np.abs(got[0] - ref[False][0]).max() < 1e-4 * scale
    _assert_grads(got, ref[False], 0.01, 0.01, floor=0.0)


def _eager_grads(j, x, w, flat):
    """x.grad and the kernel-order parameter gradients by torch.autograd
    through the eager stack."""
    stack = _port(j, flat)
    xt = torch.from_numpy(x).requires_grad_()
    (stack(xt) * torch.from_numpy(w)).sum().backward()
    return stack, xt.grad.numpy(), [
        (p.grad.t() if transposed else p.grad).numpy()
        for p, transposed in stack.pack_sources()]


def test_plain_precise_matches_torch_autograd(case):
    j, x, w, flat, _ = case
    _, dx_r, gp_r = _eager_grads(j, x, w, flat)
    got = _plain(j, x, w, flat, precise=True)
    _assert_grads(got, (None, dx_r, gp_r), 2e-4, 5e-4)


def test_autograd_function_delivers_module_gradients(case, monkeypatch):
    """The fused stack under autograd goes through the stash forward and the
    backward, and every module parameter (the transposed linears too) gets
    the eager stack's gradient; without a gradient it takes the forward
    kernel's path."""
    j, x, w, flat, _ = case
    eager, dx_r, _ = _eager_grads(j, x, w, flat)
    calls = []
    for name in ('gcn_stack', 'gcn_stack_fwd', 'gcn_stack_bwd'):
        fn = getattr(gcn_kernel, name)
        monkeypatch.setattr(
            gcn_kernel, name,
            lambda *a, _fn=fn, _name=name, **k: (calls.append(_name),
                                                 _fn(*a, **k))[1])
    fused = _port(j, flat, fused=True, precise=True)
    xt = torch.from_numpy(x).requires_grad_()
    (fused(xt) * torch.from_numpy(w)).sum().backward()
    assert calls == ['gcn_stack_fwd', 'gcn_stack_bwd']
    scale = np.abs(dx_r).max()
    np.testing.assert_allclose(xt.grad.numpy(), dx_r, atol=2e-4 * scale)
    for (name, p), (_, q) in zip(fused.named_parameters(),
                                 eager.named_parameters()):
        assert p.grad is not None and p.grad.shape == p.shape, name
        s = max(q.grad.abs().max().item(), 1e-3)
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                   atol=5e-4 * s, err_msg=name)
    calls.clear()
    with torch.no_grad():
        fused(torch.from_numpy(x))
    fused.eval()
    for p in fused.parameters():
        p.requires_grad_(False)
    fused(torch.from_numpy(x))          # grad mode on, nothing to train
    assert calls == ['gcn_stack', 'gcn_stack']


def test_packed_params_repack_after_optimizer_step(case):
    """A stale pack would train on old weights: an optimiser step writes
    the parameters in place, which must invalidate the cached buffer."""
    j, x, w, flat, _ = case
    fused = _port(j, flat, fused=True, precise=True).train()
    opt = torch.optim.Adam(fused.parameters(), lr=1e-2)
    before = fused.packed_params().clone()
    xt = torch.from_numpy(x)
    (fused(xt) * torch.from_numpy(w)).sum().backward()
    assert fused.packed_params() is fused.packed_params()    # cached
    opt.step()
    after = fused.packed_params()
    assert not torch.equal(before, after)
    assert torch.equal(after, fused._pack())
    y_fused = fused(xt).detach()
    fused.fused = False
    np.testing.assert_allclose(y_fused.numpy(), fused(xt).detach().numpy(),
                               atol=2e-5)


def test_kink_margin_and_cost_functions(case):
    j, x, _, flat, _ = case
    stack = _port(j, flat)
    xf = torch.from_numpy(x).reshape(-1, j, F)
    margin = gcn_kernel.kink_margin(xf, stack.packed_params(),
                                    torch.as_tensor(ADJ[j]), HEADS,
                                    precise=True)
    assert margin.shape == (xf.shape[0],) and bool((margin >= 0).all())
    n = 8192
    assert gcn_kernel.stack_fwd_bytes(n, j, 64, 4) == 4 * (
        6 * n * j * 64 + gcn_kernel.num_params(64, 4, 5) + j * j)
    assert gcn_kernel.stack_bwd_bytes(n, j, 64, 4) == 4 * (
        7 * n * j * 64 + 2 * gcn_kernel.num_params(64, 4, 5) + j * j)
    assert gcn_kernel.stack_bwd_flops(n, ADJ[j], 64, 4) > 2.5 * \
        gcn_kernel.stack_flops(n, ADJ[j], 64, 4)
    assert gcn_kernel.max_degree(torch.as_tensor(ADJ[j])) == {10: 4,
                                                              42: 6}[j]
