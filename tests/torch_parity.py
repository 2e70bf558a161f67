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
