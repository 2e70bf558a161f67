"""Port train and eval steps (a2m_torch/train/train_step.py) against a2m's
at the tiny configuration, from identical states, dropout 0 and label noise
0 (the labels are then deterministic; the RNG streams of the two frameworks
differ by design).

* ``g_step``, ``d_step``, ``eval_step`` metrics within 1e-4 relative, with a
  full and with a ragged (masked) batch; new BatchNorm statistics of both
  nets within 1e-5.
* Updated parameters are compared only where the port's |g| exceeds 1e-4 of
  its tensor's max|g|: Adam's first step is -lr * g / (|g| + 1e-8), so where
  |g| is near zero a rounding difference flips the update by 2 * lr.  The
  gradients themselves are held at module level (the generator here, the
  discriminator in test_torch_discriminator.py), and Adam apart.
* With dropout on, only statistics are checked.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from a2m.config import DiscriminatorConfig as JaxDConfig
from a2m.config import GeneratorConfig as JaxGConfig
from a2m.config import TrainConfig as JaxTrainConfig
from a2m.models import Discriminator as JaxD
from a2m.models import Generator as JaxG
from a2m.train import train_step as jsteps
from a2m_torch.config import (DiscriminatorConfig, GeneratorConfig,
                              TrainConfig)
from a2m_torch.models.discriminator import Discriminator
from a2m_torch.models.generator import Generator
from a2m_torch.nn.graph import GCNStack
from a2m_torch.train import train_step as steps
from a2m_torch.weights import from_jax_variables, to_jax_variables
from torch_parity import port_grads_as_jax, randomize, unflatten

TINY_G = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2,
              dropout=0.0)
TINY_D = dict(out_channels=8, joint_feat_dim=8, gat_heads=2, dropout=0.0)
B = 4
SMOOTH_R, SMOOTH_F = 0.93, 0.07
MASKS = {'full': np.ones(B, np.float32),
         'ragged': np.array([1, 1, 1, 0], np.float32)}


@pytest.fixture(scope='module')
def world():
    """a2m's jitted steps (compiled once for the module), randomised states,
    a seeded batch, and a factory of fresh port states from the same
    variables."""
    rng = np.random.default_rng(31)
    audio = rng.standard_normal((B, 64, 128)).astype(np.float32)
    pose = (rng.standard_normal((B, 64, 104)) * 10 + 300).astype(np.float32)
    mean = (rng.standard_normal(104) * 5).astype(np.float32)
    std = rng.uniform(5, 15, 104).astype(np.float32)
    g_model, d_model = JaxG(JaxGConfig(**TINY_G)), JaxD(JaxDConfig(**TINY_D))
    g_state, d_state = jsteps.init_states(g_model, d_model,
                                          jax.random.PRNGKey(0), batch_size=B)
    flats = {}
    for name, state in (('g', g_state), ('d', d_state)):
        flats[name] = randomize({'params': state.params,
                                 'batch_stats': state.batch_stats}, rng)
    g_vars, d_vars = unflatten(flats['g']), unflatten(flats['d'])
    g_state = g_state._replace(params=g_vars['params'],
                               batch_stats=g_vars['batch_stats'])
    d_state = d_state._replace(params=d_vars['params'],
                               batch_stats=d_vars['batch_stats'])
    cfg = JaxTrainConfig(fused_gcn_eval=False)
    jitted = jsteps.make_train_steps(g_model, d_model, cfg, donate=False)

    def port_states():
        g = Generator(GeneratorConfig(**TINY_G))
        d = Discriminator(DiscriminatorConfig(**TINY_D))
        g.load_state_dict(from_jax_variables(flats['g'], g))
        d.load_state_dict(from_jax_variables(flats['d'], d))
        states = steps.init_states(g, d)
        return states, steps.make_train_steps(g, d, TrainConfig())

    return dict(audio=audio, pose=pose, mean=mean, std=std, flats=flats,
                g_state=g_state, d_state=d_state, jitted=jitted,
                g_model=g_model, port_states=port_states)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _assert_metrics(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _assert_batch_stats(model, ref_bs, before: dict, moved: bool = True):
    state = to_jax_variables(model)
    for key, value in traverse_util.flatten_dict(ref_bs, sep='/').items():
        key = 'batch_stats/' + key
        np.testing.assert_allclose(state[key], np.asarray(value), atol=1e-5,
                                   err_msg=key)
        assert np.allclose(state[key], before[key]) != moved, key


def _assert_updates(model, new_params, before: dict):
    """Parameter updates where the port's gradient is well away from 0."""
    state = to_jax_variables(model)
    grads = port_grads_as_jax(model)
    lr, checked = None, 0
    # a bias that feeds a train-mode BatchNorm has a gradient of rounding
    # noise only: also keep to |g| above 1e-4 of the largest of any tensor.
    # The f32 gradients of the first layers of this deep tiny net carry a
    # rounding error of up to a few percent of their tensor's max (see
    # test_generator_train_mode_gradients_match_a2m), so of the elements
    # kept, one per tensor or 2 in 100 may still take the other sign.
    largest = max(np.abs(g).max() for g in grads.values())
    for key, value in traverse_util.flatten_dict(new_params, sep='/').items():
        key = 'params/' + key
        g = np.abs(grads[key])
        sure = (g > 1e-4 * g.max()) & (g > 1e-4 * largest)
        if not sure.any():
            continue
        ref_update = np.asarray(value) - before[key]
        lr = np.abs(ref_update).max() if lr is None else lr
        close = np.abs((state[key] - before[key])[sure]
                       - ref_update[sure]) <= 1e-3 * lr
        assert (~close).sum() <= max(1, 0.02 * close.size), (
            key, (~close).sum(), close.size)
        checked += int(sure.sum())
    assert checked > 1000


@pytest.mark.parametrize('mask_name', list(MASKS))
def test_g_step_matches_a2m(world, mask_name):
    w, mask = world, MASKS[mask_name]
    new_g, new_d_bs, ref = w['jitted'][0](
        w['g_state'], w['d_state'], w['audio'], w['pose'], w['mean'],
        w['std'], SMOOTH_R, 0.0, jax.random.PRNGKey(1),
        mask=jnp.asarray(mask))
    (g_state, d_state), (g_step, _, _) = w['port_states']()
    d_before = {k: v.clone() for k, v in d_state.model.state_dict().items()}
    _, _, got = g_step(g_state, d_state, *_t(w['audio'], w['pose'], w['mean'],
                                             w['std']), SMOOTH_R, 0.0,
                       torch.Generator().manual_seed(1), mask=_t(mask)[0])
    _assert_metrics(got, ref)
    _assert_batch_stats(g_state.model, new_g.batch_stats, w['flats']['g'])
    _assert_batch_stats(d_state.model, new_d_bs, w['flats']['d'])
    _assert_updates(g_state.model, new_g.params, w['flats']['g'])
    # D's parameters neither moved nor got a gradient
    for k, p in d_state.model.named_parameters():
        assert torch.equal(p, d_before[k]) and p.grad is None, k
        assert p.requires_grad, k


@pytest.mark.parametrize('mask_name', list(MASKS))
def test_d_step_matches_a2m(world, mask_name):
    w, mask = world, MASKS[mask_name]
    new_d, new_g, ref = w['jitted'][1](
        w['g_state'], w['d_state'], w['audio'], w['pose'], w['mean'],
        w['std'], SMOOTH_R, SMOOTH_F, 0.0, jax.random.PRNGKey(2),
        mask=jnp.asarray(mask))
    (g_state, d_state), (_, d_step, _) = w['port_states']()
    g_before = {k: v.clone() for k, v in g_state.model.named_parameters()}
    _, _, got = d_step(g_state, d_state, *_t(w['audio'], w['pose'], w['mean'],
                                             w['std']), SMOOTH_R, SMOOTH_F,
                       0.0, torch.Generator().manual_seed(2),
                       mask=_t(mask)[0])
    _assert_metrics(got, ref)
    _assert_batch_stats(d_state.model, new_d.batch_stats, w['flats']['d'])
    _assert_batch_stats(g_state.model, new_g.batch_stats, w['flats']['g'])
    _assert_updates(d_state.model, new_d.params, w['flats']['d'])
    for k, p in g_state.model.named_parameters():
        assert torch.equal(p, g_before[k]) and p.grad is None, k


@pytest.mark.parametrize('mask_name', list(MASKS))
def test_eval_step_matches_a2m(world, mask_name):
    w, mask = world, MASKS[mask_name]
    ref = w['jitted'][2](w['g_state'], w['d_state'], w['audio'], w['pose'],
                         w['mean'], w['std'], jnp.asarray(mask))
    (g_state, d_state), (_, _, eval_step) = w['port_states']()
    got = eval_step(g_state, d_state, *_t(w['audio'], w['pose'], w['mean'],
                                          w['std'], mask))
    _assert_metrics(got, ref)
    # eval mode: no statistic moves
    for model, flat in ((g_state.model, w['flats']['g']),
                        (d_state.model, w['flats']['d'])):
        state = to_jax_variables(model)
        for key in flat:
            np.testing.assert_array_equal(state[key], flat[key], err_msg=key)


def test_generator_train_mode_gradients_match_a2m(world):
    """d sum(pose * w) / d params through the train-mode generator (batch
    BatchNorm moments, dropout 0) against jax.grad, and its new BatchNorm
    statistics."""
    w = world
    rng = np.random.default_rng(32)
    cot = rng.standard_normal((B, 64, 104)).astype(np.float32)
    g_vars = unflatten(w['flats']['g'])

    def loss(params):
        out, mutated = w['g_model'].apply(
            {'params': params, 'batch_stats': g_vars['batch_stats']},
            jnp.asarray(w['audio']), train=True,
            rngs={'dropout': jax.random.PRNGKey(3)}, mutable=['batch_stats'])
        return (out * cot).sum(), mutated['batch_stats']

    grads, new_bs = jax.jit(jax.grad(loss, has_aux=True))(g_vars['params'])
    (g_state, _), _ = w['port_states']()
    model = g_state.model.train()
    twin = copy.deepcopy(model).double()
    (model(torch.from_numpy(w['audio'])) * torch.from_numpy(cot)
     ).sum().backward()
    (twin(torch.from_numpy(w['audio']).double())
     * torch.from_numpy(cot).double()).sum().backward()
    ref = {'params/' + k: np.asarray(v) for k, v in
           traverse_util.flatten_dict(grads, sep='/').items()}
    got, exact = port_grads_as_jax(model), port_grads_as_jax(twin)
    # The bound is 1e-3 of each tensor's max|grad| plus the f32 gradient's
    # own rounding error, which the same module in float64 measures: through
    # ~25 train-mode BatchNorms at B = 4 it reaches several percent for the
    # first layers.  Both frameworks carry it, hence 4 x.
    floor = 1e-3 * max(np.abs(v).max() for v in ref.values())
    assert set(got) == set(ref)
    tight = 0
    for key, r in ref.items():
        scale = max(np.abs(r).max(), floor)
        noise = np.abs(got[key] - exact[key]).max()
        np.testing.assert_allclose(got[key], r, rtol=0,
                                   atol=1e-3 * scale + 4 * noise,
                                   err_msg=key)
        tight += noise < 1e-3 * scale
        assert noise < 0.2 * scale, key
    assert tight > len(ref) // 2        # most tensors are held to ~1e-3
    _assert_batch_stats(model, new_bs, w['flats']['g'])


def test_adam_matches_optax():
    """The same three gradient arrays through optax.adam and the port's
    optimiser, a learning-rate change in between: parameters within 1e-6."""
    rng = np.random.default_rng(33)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal(p0.shape).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    tx = jsteps.make_optimizer(5e-4)
    params, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = steps.make_optimizer([p], 5e-4)
    for i, g in enumerate(grads):
        if i == 2:
            opt_state = jsteps.set_lr(opt_state, 1e-3)
            steps.set_lr(opt, 1e-3)
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                                   atol=1e-6)


def test_clip_by_global_norm_follows_optax():
    rng = np.random.default_rng(34)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(a) for a in arrays], optax.EmptyState())
        params = [torch.nn.Parameter(torch.zeros(a.shape)) for a in arrays]
        for p, a in zip(params, arrays):
            p.grad = torch.from_numpy(a.copy())
        steps.clip_by_global_norm(params, max_norm)
        for p, r in zip(params, ref):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(r),
                                       rtol=1e-6)


def test_dropout_statistics_of_the_stack_and_fused_eval_switch():
    """Train mode: the stack's trailing dropout zeroes a share p of its
    output and scales the rest by 1 / (1 - p).  ``_fused_stacks`` routes a
    generator's stacks through the fused path inside the context only."""
    from a2m_torch import constants
    adj = constants.adjacency_from_edges(constants.hand_edges(), 42)
    torch.manual_seed(0)
    stack = GCNStack(8, adj, heads=2, dropout=0.25)
    x = torch.randn(64, 42, 8)
    with torch.no_grad():
        kept = stack.eval()(x)
        dropped = stack.train()(x)
    zeros = (dropped == 0)
    assert abs(zeros.float().mean().item() - 0.25) < 0.02
    np.testing.assert_allclose(dropped[~zeros].numpy(),
                               (kept[~zeros] / 0.75).numpy(), rtol=1e-5)
    g = Generator(GeneratorConfig(**TINY_G))
    stacks = [m for m in g.modules() if isinstance(m, GCNStack)]
    assert len(stacks) == 2 and not any(m.fused for m in stacks)
    with steps._fused_stacks(g, True):
        assert all(m.fused for m in stacks)
    assert not any(m.fused for m in stacks)
    with steps._fused_stacks(g, False):
        assert not any(m.fused for m in stacks)


def test_lambda_aux_needs_the_aux_head():
    g = Generator(GeneratorConfig(**TINY_G))
    d = Discriminator(DiscriminatorConfig(**TINY_D))
    with pytest.raises(ValueError, match='use_aux_classifier'):
        steps.make_train_steps(g, d, TrainConfig(lambda_aux=0.1))
