"""Port discriminator (a2m_torch/models/discriminator.py) against a2m's at
the tiny configuration, dropout 0: eval and train-mode forward within 1e-4
of max|ref|, the train-mode BatchNorm updates within 1e-5, and the gradient
of sum(scores * w) (+ the aux logits) with respect to every parameter
against ``jax.grad`` within 1e-3 of each tensor's max|grad|.  One case is
the default (no audio, no aux head); the other has ``audio_fusion`` with
T_audio = 64 pooled onto a non-dividing t, and ``use_aux_classifier``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a2m.config import DiscriminatorConfig as JaxConfig
from a2m.models.discriminator import Discriminator as JaxD
from a2m.models.discriminator import aux_cross_entropy as jax_aux_ce
from a2m_torch.config import DiscriminatorConfig
from a2m_torch.models.discriminator import Discriminator, aux_cross_entropy
from torch_parity import (assert_grads_close, max_rel, port_grads_as_jax,
                          port_module, randomize, unflatten)

TINY = dict(out_channels=8, joint_feat_dim=8, gat_heads=2, dropout=0.0)
CASES = {'plain': {}, 'audio_aux': dict(audio_fusion=True,
                                        use_aux_classifier=True)}
B, T = 4, 63


@pytest.fixture(scope='module', params=list(CASES))
def case(request):
    extra = CASES[request.param]
    rng = np.random.default_rng(21)
    motion = rng.standard_normal((B, T, 104)).astype(np.float32)
    audio = (rng.standard_normal((B, 64, 128)).astype(np.float32)
             if extra else None)
    jmodel = JaxD(JaxConfig(**TINY, **extra))
    jaudio = None if audio is None else jnp.asarray(audio)
    flat = randomize(jax.jit(lambda k, m: jmodel.init(
        {'params': k, 'dropout': k}, m, audio=jaudio))(
            jax.random.PRNGKey(0), jnp.asarray(motion)), rng)
    variables = unflatten(flat)
    port = port_module(Discriminator(DiscriminatorConfig(**TINY, **extra)),
                       flat)
    return extra, motion, audio, jmodel, variables, flat, port, rng


def _port_forward(port, motion, audio):
    return port(torch.from_numpy(motion),
                None if audio is None else torch.from_numpy(audio))


def test_eval_forward_matches_a2m(case):
    extra, motion, audio, jmodel, variables, _, port, _ = case
    jaudio = None if audio is None else jnp.asarray(audio)
    ref, ref_aux = jmodel.apply(variables, jnp.asarray(motion), audio=jaudio)
    with torch.no_grad():
        got, got_aux = _port_forward(port.eval(), motion, audio)
    assert got.shape == tuple(ref.shape) and got.dtype == torch.float32
    assert max_rel(got.numpy(), np.asarray(ref)) < 1e-4
    if extra:
        assert max_rel(got_aux.numpy(), np.asarray(ref_aux)) < 1e-4
    else:
        assert got_aux is None and ref_aux is None


def test_train_forward_bn_updates_and_gradients_match_a2m(case):
    extra, motion, audio, jmodel, variables, flat, port, rng = case
    jaudio = None if audio is None else jnp.asarray(audio)
    scores0, _ = jmodel.apply(variables, jnp.asarray(motion), audio=jaudio)
    w = rng.standard_normal(scores0.shape).astype(np.float32)
    w_aux = rng.standard_normal((B, 10)).astype(np.float32)

    def loss(params):
        (scores, aux), mutated = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(motion), audio=jaudio, train=True,
            rngs={'dropout': jax.random.PRNGKey(1)}, mutable=['batch_stats'])
        total = (scores * w).sum()
        if aux is not None:
            total = total + (aux * w_aux).sum()
        return total, (scores, aux, mutated['batch_stats'])

    (_, (ref, ref_aux, new_bs)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables['params'])

    port = port_module(port, flat).train()
    for p in port.parameters():
        p.grad = None
    got, got_aux = _port_forward(port, motion, audio)
    total = (got * torch.from_numpy(w)).sum()
    if extra:
        total = total + (got_aux * torch.from_numpy(w_aux)).sum()
    total.backward()
    assert max_rel(got.detach().numpy(), np.asarray(ref)) < 1e-4
    if extra:
        assert max_rel(got_aux.detach().numpy(), np.asarray(ref_aux)) < 1e-4

    from flax import traverse_util
    ref_bs = traverse_util.flatten_dict(new_bs, sep='/')
    state = port.state_dict()
    for key, value in ref_bs.items():
        *scope, leaf = key.split('/')
        name = '.'.join(scope + ['running_' + leaf])
        np.testing.assert_allclose(state[name].numpy(), np.asarray(value),
                                   atol=1e-5, err_msg=key)
        assert not np.allclose(np.asarray(value),
                               flat['batch_stats/' + key]), key

    ref_grads = {'params/' + k: np.asarray(v) for k, v in
                 traverse_util.flatten_dict(grads, sep='/').items()}
    assert_grads_close(port_grads_as_jax(port), ref_grads, tol=1e-3)


def test_aux_cross_entropy_matches_a2m():
    rng = np.random.default_rng(22)
    logits = rng.standard_normal((B, 10)).astype(np.float32)
    labels = np.array([3, 0, 9, 5])
    mask = np.array([1, 1, 0, 1], np.float32)
    for m in (None, mask):
        got = aux_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if m is None else torch.from_numpy(m))
        ref = jax_aux_ce(jnp.asarray(logits), jnp.asarray(labels),
                         None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
