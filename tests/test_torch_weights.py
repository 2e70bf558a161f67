"""Weight carrying (a2m_torch/weights.py) on the committed flagship npz's
key set: every a2m variable is used, every port entry is set, and a
missing or extra key raises."""

from pathlib import Path

import numpy as np
import pytest
import torch
from flax import traverse_util

from a2m_torch.config import DiscriminatorConfig, GeneratorConfig
from a2m_torch.models.discriminator import Discriminator
from a2m_torch.models.generator import Generator
from a2m_torch.weights import (from_jax_variables, load_generator_npz,
                               to_jax_variables)

NPZ = Path(__file__).resolve().parents[1] / 'artifacts' / \
    'flagship_best_gen.npz'


@pytest.fixture(scope='module')
def flagship():
    flat, stats = load_generator_npz(NPZ)
    return Generator(), flat, stats


def test_flagship_keys_fill_every_port_entry(flagship):
    model, flat, stats = flagship
    sd = from_jax_variables(flat, model)
    assert set(sd) == set(model.state_dict())
    assert len(sd) == len(flat) == 312
    assert set(stats) == {'mean', 'std'} and stats['mean'].shape == (104,)
    assert all(v.dtype == torch.float32 for v in sd.values())
    model.load_state_dict(sd)           # strict: shapes and names agree


def test_layouts(flagship):
    model, flat, _ = flagship
    sd = from_jax_variables(flat, model)
    k = flat['params/audio_encoder/conv4/conv/kernel']          # (3, 8, i, o)
    np.testing.assert_array_equal(
        sd['audio_encoder.conv4.conv.weight'].numpy(), k.transpose(3, 2, 0, 1))
    k = flat['params/unet/up0/kernel']                          # (k, i, o)
    np.testing.assert_array_equal(sd['unet.up0.weight'].numpy(),
                                  k.transpose(1, 2, 0))
    k = flat['params/unet/down1/conv/kernel']
    np.testing.assert_array_equal(sd['unet.down1.conv.weight'].numpy(),
                                  k.transpose(2, 1, 0))
    k = flat['params/hand_decoder/gcn/gcn1/lin/kernel']         # Dense
    np.testing.assert_array_equal(
        sd['hand_decoder.gcn.gcn1.lin.weight'].numpy(), k.T)
    np.testing.assert_array_equal(
        sd['unet.up0.bn.running_var'].numpy(),
        flat['batch_stats/unet/up0/bn/var'])


def test_tuple_keys_of_a_flattened_variables_tree(flagship):
    model, flat, _ = flagship
    tree = traverse_util.unflatten_dict(flat, sep='/')
    sd = from_jax_variables(traverse_util.flatten_dict(tree), model)
    assert set(sd) == set(model.state_dict())


@pytest.mark.parametrize('change', ['missing', 'extra', 'stats'])
def test_raises_on_missing_or_extra_key(flagship, change):
    model, flat, stats = flagship
    flat = dict(flat)
    if change == 'missing':
        del flat['params/body_decoder/gcn/gcn3/att_src']
    elif change == 'extra':
        flat['params/body_decoder/gcn/gcn6/bias'] = np.zeros(64, np.float32)
    else:
        flat['stats/mean'] = stats['mean']
    with pytest.raises(KeyError):
        from_jax_variables(flat, model)


def test_flagship_round_trip_is_the_identity(flagship):
    model, flat, _ = flagship
    model.load_state_dict(from_jax_variables(flat, model))
    back = to_jax_variables(model)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.fixture(scope='module')
def a2m_discriminator():
    """Flat random variables of a2m's discriminator with grouped convs, the
    audio branch and the aux head."""
    import jax
    import jax.numpy as jnp
    from a2m.config import DiscriminatorConfig as JaxConfig
    from a2m.models.discriminator import Discriminator as JaxD
    from torch_parity import randomize
    kw = dict(out_channels=8, joint_feat_dim=8, gat_heads=2, groups=2,
              audio_fusion=True, use_aux_classifier=True)
    jmodel = JaxD(JaxConfig(**kw))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: jmodel.init(
        {'params': k, 'dropout': k}, jnp.zeros((2, 63, 104)),
        audio=jnp.zeros((2, 64, 128))))(key)
    return kw, randomize(variables, np.random.default_rng(5))


def test_discriminator_round_trip_is_the_identity(a2m_discriminator):
    kw, flat = a2m_discriminator
    model = Discriminator(DiscriminatorConfig(**kw))
    sd = from_jax_variables(flat, model)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    k = flat['params/conv2_1a/conv/kernel']         # grouped: (k, in/g, out)
    assert k.shape == (4, 8, 32)
    np.testing.assert_array_equal(model.conv2_1a.conv.weight.detach().numpy(),
                                  k.transpose(2, 1, 0))
    back = to_jax_variables(model)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_discriminator_unused_and_unset_keys_raise(a2m_discriminator):
    kw, flat = a2m_discriminator
    plain = Discriminator(DiscriminatorConfig(**{
        **kw, 'audio_fusion': False, 'use_aux_classifier': False}))
    with pytest.raises(KeyError, match='unused a2m variable'):
        from_jax_variables(flat, plain)
    full = Discriminator(DiscriminatorConfig(**kw))
    fewer = {k: v for k, v in flat.items() if 'aux_fc2' not in k}
    with pytest.raises(KeyError, match='left unset'):
        from_jax_variables(fewer, full)


def test_style_embedding_carries_across():
    model = Generator(GeneratorConfig(in_channels=16, out_channels=16,
                                      joint_feat_dim=8, gat_heads=2,
                                      num_style_speakers=3))
    back = to_jax_variables(model)
    key = 'params/style_emb/embedding'
    assert back[key].shape == (3, 16)
    value = np.arange(48, dtype=np.float32).reshape(3, 16)
    sd = from_jax_variables({**back, key: value}, model)
    np.testing.assert_array_equal(sd['style_emb.weight'].numpy(), value)
