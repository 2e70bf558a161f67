"""Shared helpers of the port-vs-a2m parity tests (tests/test_torch_*.py).

Flax init gives degenerate parameters (SelfAttention ``gamma`` 0, batch
stats 0/1), which would hide whole layers from a comparison, so every
parity test first replaces all params and batch stats with seeded random
values, then carries them into the port with ``from_jax_variables``.
"""

from __future__ import annotations

import numpy as np
from flax import traverse_util


def randomize(variables, rng: np.random.Generator) -> dict:
    """Flat ``{'params/a/b/kernel': array}`` with every leaf of a flax
    ``variables`` tree replaced by seeded values of a sane scale:
    kernels ~ N(0, 1/fan_in), biases ~ 0.1 N, norm scales ~ 1 + 0.1 N,
    gates ~ 0.5 + 0.1 N, running means ~ 0.1 N, running vars ~ U(0.5, 1.5)."""
    flat = traverse_util.flatten_dict(
        {k: v for k, v in variables.items()}, sep='/')
    out = {}
    for key, value in flat.items():
        shape, leaf = np.shape(value), key.rsplit('/', 1)[1]
        if leaf == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif leaf in ('att_src', 'att_dst'):
            v = rng.standard_normal(shape) / np.sqrt(shape[-1])
        elif leaf == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == 'gamma':
            v = 0.5 + 0.1 * rng.standard_normal(shape)
        elif leaf == 'var':
            v = rng.uniform(0.5, 1.5, shape)
        else:                               # bias, running mean
            v = 0.1 * rng.standard_normal(shape)
        out[key] = v.astype(np.float32)
    return out


def unflatten(flat: dict) -> dict:
    """Flat ``'a/b/c'`` keys -> nested flax ``variables`` tree."""
    return traverse_util.unflatten_dict(flat, sep='/')


def port_module(module, flat: dict):
    """Load ``flat`` a2m variables into a port module (eval mode)."""
    from a2m_torch.weights import from_jax_variables
    module.load_state_dict(from_jax_variables(flat, module))
    return module.eval()


def max_rel(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| relative to max |ref|."""
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def port_grads_as_jax(model) -> dict:
    """The ``.grad`` of every parameter of a port module under a2m's names
    and layouts (``'params/a/b/kernel'``), through ``to_jax_variables`` on a
    copy whose parameters hold the gradients."""
    import copy

    import torch
    from a2m_torch.weights import to_jax_variables
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(twin.parameters(), model.parameters()):
            p.copy_(torch.zeros_like(q) if q.grad is None else q.grad)
    return {k: v for k, v in to_jax_variables(twin).items()
            if k.startswith('params/')}


def assert_grads_close(got: dict, ref: dict, tol: float = 1e-3,
                       floor_share: float = 1e-3) -> None:
    """Every tensor within ``tol`` of its own max|ref|, and of no less than
    ``floor_share`` of the largest max|ref| of any tensor: a bias that feeds
    a train-mode BatchNorm has a zero gradient up to rounding, so its own
    scale is noise."""
    assert set(got) == set(ref), set(got) ^ set(ref)
    floor = floor_share * max(np.abs(v).max() for v in ref.values())
    for key, r in ref.items():
        scale = max(np.abs(r).max(), floor)
        np.testing.assert_allclose(got[key], np.asarray(r), rtol=0,
                                   atol=tol * scale, err_msg=key)


#: the port's bf16 result against a2m's bf16-vs-f32 gap (tests of
#: ``compute_dtype='bf16'``)
BF16_GAP_FACTOR = 2.0


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at each |v| (8 significant bits)."""
    v = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(v)) - 7)


def assert_within_bf16_gap(got, ref32, ref16, what: str = '',
                           bf16_out: bool = False):
    """a2m's bf16 yardstick: |got - a2m f32| and |got - a2m bf16| within
    BF16_GAP_FACTOR x |a2m bf16 - a2m f32|, in max and in mean.

    ``bf16_out``: both results are bf16 numbers (the output is rounded to
    bf16 last).  Two such roundings of f32 sums taken in another order
    differ by one bf16 ulp wherever they straddle a rounding boundary,
    while the gap's max over a small tensor may lie below half an ulp of
    its largest elements; so against a2m's bf16 result the max rule reads
    each element's distance less one ulp (the mean rule stays as it is)."""
    got, ref32, ref16 = (np.asarray(a, np.float64).ravel()
                         for a in (got, ref32, ref16))
    gap = np.abs(ref16 - ref32)
    assert gap.max() > 0, f'{what}: a2m bf16 equals f32'
    for name, other in (('a2m f32', ref32), ('a2m bf16', ref16)):
        d = np.abs(got - other)
        flips = (np.maximum(d - bf16_ulp(ref16), 0)
                 if bf16_out and other is ref16 else d)
        assert flips.max() <= BF16_GAP_FACTOR * gap.max(), (
            what, name, 'max', d.max(), gap.max())
        assert d.mean() <= BF16_GAP_FACTOR * gap.mean(), (
            what, name, 'mean', d.mean(), gap.mean())
