"""Weight carrying (a2m_torch/weights.py) on the committed flagship npz's
key set: every a2m variable is used, every port entry is set, and a
missing or extra key raises."""

from pathlib import Path

import numpy as np
import pytest
import torch
from flax import traverse_util

from a2m_torch.models.generator import Generator
from a2m_torch.weights import from_jax_variables, load_generator_npz

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
