"""Port encoders and misc heads (a2m_torch/nn/encoders.py ``UNet1DFirstVersion``
through ``ClusterClassify``, a2m_torch/nn/misc.py) against a2m's: every
case of tests/test_encoders_misc.py as parity, plus ``UNet1DFirstVersion``.

* Each encoder in eval mode on seeded randomised variables: the same
  variables through ``weights.from_jax_variables`` (and back through
  ``to_jax_variables`` bit-equal; their names and shapes are a2m's, from
  ``jax.eval_shape`` of its init), f32 within 1e-5 of max|y|; in bf16 the
  output dtype is a2m's and the values lie within 2x of a2m's own
  bf16-vs-f32 gap (``torch_parity.assert_within_bf16_gap``).
* The misc heads and functions: within 1e-6 of a2m's (exactly where the
  arithmetic is a copy), the groups' models under a2m's ``models_<i>``
  names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util
from torch import nn

from a2m.nn import encoders as jenc
from a2m.nn import misc as jmisc
from a2m_torch.nn import encoders, misc
from a2m_torch.weights import from_jax_variables, to_jax_variables
from torch_parity import (assert_within_bf16_gap, port_module, randomize,
                          unflatten)

KEY = jax.random.PRNGKey(0)
F32_TOL = 1e-5
BF16 = torch.bfloat16


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# encoders / decoders
# ---------------------------------------------------------------------------

ENCODERS = {
    # name: (a2m module of dtype, port module of dtype, input, output shape)
    'pose_encoder': (
        lambda dt: jenc.PoseEncoder(input_channels=96, dtype=dt),
        lambda dt: encoders.PoseEncoder(input_channels=96, dtype=dt),
        (2, 16, 96), (2, 16, 256)),
    # six stride-2 downsamples: T = 64 -> 1 before the mean pool
    'pose_style_encoder': (
        lambda dt: jenc.PoseStyleEncoder(input_channels=96, num_speakers=4,
                                         dtype=dt),
        lambda dt: encoders.PoseStyleEncoder(input_channels=96,
                                             num_speakers=4, dtype=dt),
        (2, 64, 96), (2, 4)),
    'text_encoder_1d': (
        lambda dt: jenc.TextEncoder1D(input_channels=300, dtype=dt),
        lambda dt: encoders.TextEncoder1D(input_channels=300, dtype=dt),
        (2, 12, 300), (2, 12, 256)),
    'audio_encoder_1d': (
        lambda dt: jenc.AudioEncoder1D(input_channels=128, dtype=dt),
        lambda dt: encoders.AudioEncoder1D(input_channels=128, dtype=dt),
        (2, 12, 128), (2, 12, 256)),
    # input channels (input_channels / groups + style_dim) * groups
    'pose_decoder_grouped_style_reconcat': (
        lambda dt: jenc.PoseDecoder(input_channels=16, style_dim=4,
                                    num_clusters=2, out_feats=8, dtype=dt),
        lambda dt: encoders.PoseDecoder(input_channels=16, style_dim=4,
                                        num_clusters=2, out_feats=8,
                                        dtype=dt, in_features=24),
        (2, 12, 24), (2, 12, 16)),
    'style_decoder': (
        lambda dt: jenc.StyleDecoder(input_channels=16, num_clusters=2,
                                     out_feats=8, dtype=dt),
        lambda dt: encoders.StyleDecoder(input_channels=16, num_clusters=2,
                                         out_feats=8, dtype=dt,
                                         in_features=16),
        (2, 12, 16), (2, 12, 16)),
    'latent_encoder_bottleneck': (
        lambda dt: jenc.LatentEncoder(in_channels=24, hidden_channels=16,
                                      out_channels=2, dtype=dt),
        lambda dt: encoders.LatentEncoder(in_channels=24, hidden_channels=16,
                                          out_channels=2, dtype=dt),
        (2, 12, 24), (2, 12, 2)),
    'cluster_classify_per_frame_logits': (
        lambda dt: jenc.ClusterClassify(num_clusters=8, input_channels=32,
                                        dtype=dt),
        lambda dt: encoders.ClusterClassify(num_clusters=8,
                                            input_channels=32, dtype=dt),
        (2, 12, 32), (2, 12, 8)),
    'cluster_classify_grouped': (
        lambda dt: jenc.ClusterClassify(num_clusters=4, input_channels=32,
                                        groups=2, dtype=dt),
        lambda dt: encoders.ClusterClassify(num_clusters=4,
                                            input_channels=32, groups=2,
                                            dtype=dt),
        (2, 12, 64), (2, 12, 8)),
    'unet1d_first_version': (
        lambda dt: jenc.UNet1DFirstVersion(8, 8, max_depth=3, dtype=dt),
        lambda dt: encoders.UNet1DFirstVersion(8, 8, max_depth=3, dtype=dt),
        (2, 16, 8), (2, 16, 8)),
}


@pytest.fixture(scope='module', params=list(ENCODERS))
def encoder(request):
    """(case, seeded input, randomised flat variables, a2m's f32 and bf16
    outputs).  The variables are the port module's, checked against the
    tree of a2m's init (``jax.eval_shape``: names and shapes, no compile)
    and randomised."""
    name = request.param
    make_jax, make_port, shape, _ = ENCODERS[name]
    rng = np.random.default_rng(list(ENCODERS).index(name))
    x = rng.standard_normal(shape).astype(np.float32)
    tree = jax.eval_shape(make_jax(jnp.float32).init,
                          {'params': KEY, 'dropout': KEY}, x)
    want = {k: v.shape for k, v in
            traverse_util.flatten_dict(tree, sep='/').items()}
    port_vars = to_jax_variables(make_port(torch.float32))
    assert {k: v.shape for k, v in port_vars.items()} == want
    flat = randomize(unflatten(port_vars), rng)
    variables = unflatten(flat)
    refs = {dt: jax.jit(lambda v, a, m=make_jax(dt): m.apply(v, a))(
        variables, x) for dt in (jnp.float32, jnp.bfloat16)}
    return name, x, flat, refs


def _run(module, x, *args, **kwargs):
    with torch.no_grad():
        return module(torch.from_numpy(x), *args, **kwargs)


def test_encoder_matches_a2m(encoder):
    name, x, flat, refs = encoder
    _, make_port, _, out_shape = ENCODERS[name]
    model = port_module(make_port(torch.float32), flat)
    back = to_jax_variables(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    got = _run(model, x).numpy()
    ref = np.asarray(refs[jnp.float32])
    assert got.shape == ref.shape == out_shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=F32_TOL * np.abs(ref).max())


def test_encoder_bf16_matches_a2m(encoder):
    name, x, flat, refs = encoder
    got = _run(port_module(ENCODERS[name][1](BF16), flat), x)
    ref32, ref16 = refs[jnp.float32], refs[jnp.bfloat16]
    assert str(got.dtype).replace('torch.', '') == str(ref16.dtype)
    assert_within_bf16_gap(got.float().numpy(), np.asarray(ref32, np.float32),
                           np.asarray(ref16, np.float32), name,
                           bf16_out=got.dtype == BF16)


def test_unet1d_first_version_bottleneck_and_length_check():
    torch.manual_seed(0)
    m = encoders.UNet1DFirstVersion(8, 8, max_depth=3).eval()
    out, bottleneck = _run(m, np.zeros((1, 16, 8), np.float32),
                           return_bottleneck=True)
    assert out.shape == (1, 16, 8) and bottleneck.shape == (1, 2, 8)
    with pytest.raises(ValueError, match='multiple of 2'):
        _run(m, np.zeros((1, 12, 8), np.float32))


# ---------------------------------------------------------------------------
# misc heads and functions
# ---------------------------------------------------------------------------

def test_confidence_entropy_matches_a2m(rng):
    y, y_cap = (rng.standard_normal((2, 8)).astype(np.float32)
                for _ in range(2))
    conf = rng.uniform(0.1, 1.0, (2, 8)).astype(np.float32)
    ref, port = jmisc.Confidence(beta=0.1), misc.Confidence(beta=0.1)
    for c in (conf, 1):        # an int confidence reads as ones_like(y)
        jc, tc = (c, c) if isinstance(c, int) else (c, torch.from_numpy(c))
        got = port(torch.from_numpy(y), torch.from_numpy(y_cap), tc).numpy()
        want = np.asarray(ref(y, y_cap, jc))
        assert got.shape == (2, 8) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('dtype', [torch.float32, BF16], ids=['f32', 'bf16'])
def test_emblin_lookup_equals_onehot_mix(rng, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jmisc.EmbLin(num_embeddings=5, embedding_dim=7, dtype=jdt)
    ids = np.array([0, 3, 4])
    variables = ref.init(KEY, jnp.asarray(ids), mode='emb')
    port = port_module(misc.EmbLin(5, 7, dtype=dtype),
                       {'params/emb': np.asarray(variables['params']['emb'])})
    assert set(to_jax_variables(port)) == {'params/emb'}
    onehot = np.eye(5, dtype=np.float32)[ids]
    looked = _run(port, ids, mode='emb')
    mixed = _run(port, onehot, mode='lin')
    want = np.asarray(ref.apply(variables, jnp.asarray(onehot), mode='lin'))
    assert str(mixed.dtype).replace('torch.', '') == str(want.dtype)
    np.testing.assert_array_equal(
        looked.numpy(), np.asarray(ref.apply(variables, jnp.asarray(ids),
                                             mode='emb')))
    np.testing.assert_allclose(mixed.float().numpy(), want, atol=1e-6)
    if dtype == torch.float32:
        np.testing.assert_allclose(looked.numpy(), mixed.numpy(), atol=1e-6)


def test_style_embedding_matches_a2m():
    ref = jmisc.Style(num_speakers=4, embedding_dim=16)
    ids = np.array([0, 2, 3])
    variables = ref.init(KEY, jnp.asarray(ids))
    flat = randomize(variables, np.random.default_rng(1))
    port = port_module(misc.Style(4, 16), flat)
    got = _run(port, ids)
    assert got.shape == (3, 16)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.apply(unflatten(flat), jnp.asarray(ids))))


def test_repeat_interleave_and_transpose_match_a2m(rng):
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    got = misc.repeat_interleave(torch.from_numpy(x), 3, axis=1).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jmisc.repeat_interleave(jnp.asarray(x), 3, axis=1)))
    np.testing.assert_array_equal(got, np.repeat(x, 3, axis=1))
    got = misc.transpose(torch.from_numpy(x), (1, 2)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jmisc.transpose(jnp.asarray(x), (1, 2))))


def test_curriculum_linear_schedule():
    port = misc.Curriculum(start=0.0, end=1.0, num_iters=4)
    ref = jmisc.Curriculum(start=0.0, end=1.0, num_iters=4)
    values = [port.step() for _ in range(6)]
    assert values == [ref.step() for _ in range(6)]
    np.testing.assert_allclose(values, [0.0, 0.25, 0.5, 0.75, 1.0, 1.0])
    assert port.step(flag=False) == port.value == ref.step(flag=False)


def test_index_select_outputs_golden(rng):
    x = rng.standard_normal((2, 3, 2 * 4)).astype(np.float32)   # groups=2
    labels = rng.uniform(0, 1, (2, 3, 2)).astype(np.float32)
    got = misc.index_select_outputs(torch.from_numpy(x),
                                    torch.from_numpy(labels), 2).numpy()
    np.testing.assert_allclose(got, np.asarray(jmisc.index_select_outputs(
        jnp.asarray(x), jnp.asarray(labels), 2)), atol=1e-6)
    golden = (x.reshape(2, 3, 2, 4) * labels[..., None]).sum(axis=2)
    np.testing.assert_allclose(got, golden, atol=1e-6)


class _JaxTrainAware(fnn.Module):
    feats: int = 6

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Dense(self.feats)(x)


class _JaxNoTrainFlag(fnn.Module):
    feats: int = 6

    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(self.feats)(x)


class _TrainAware(nn.Module):
    """The port's twin of ``_JaxTrainAware`` (its Dense as ``Dense_0``)."""

    def __init__(self, in_feats: int, feats: int = 6):
        super().__init__()
        self.Dense_0 = nn.Linear(in_feats, feats)
        self.seen_train = None

    def forward(self, x, train: bool = False):
        self.seen_train = train
        return self.Dense_0(x)


class _NoTrainFlag(_TrainAware):
    def forward(self, x):
        return self.Dense_0(x)


def _group_pair(jax_group, port_group, *args, **kwargs):
    """a2m's group initialised on ``args``, its variables in the port's;
    (a2m variables, port group in eval mode)."""
    variables = jax_group.init(KEY, *args, **kwargs)
    flat = randomize(variables, np.random.default_rng(2))
    return unflatten(flat), port_module(port_group, flat)


def _t(tree):
    """numpy leaves of (lists of) arrays -> torch."""
    if isinstance(tree, list):
        return [_t(a) for a in tree]
    return torch.from_numpy(np.asarray(tree))


def _assert_tree_close(got, ref):
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_tree_close(g, r)
        return
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-6)


def test_group_channel_concat_and_split(rng):
    parts = [rng.standard_normal((2, 5, 3)).astype(np.float32)
             for _ in range(2)]
    variables, port = _group_pair(
        jmisc.Group(models=[_JaxTrainAware(feats=8)], groups=2),
        misc.Group([_TrainAware(6, 8)], groups=2), parts)
    assert set(to_jax_variables(port)) == {'params/models_0/Dense_0/kernel',
                                           'params/models_0/Dense_0/bias'}
    ref = jmisc.Group(models=[_JaxTrainAware(feats=8)], groups=2).apply(
        variables, parts)
    got = port(_t(parts))
    assert len(got) == 2 and got[0].shape == (2, 5, 4)
    _assert_tree_close(got, ref)


def test_group_soft_label_selection(rng):
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    labels = rng.uniform(0, 1, (2, 5, 2)).astype(np.float32)
    jgroup = jmisc.Group(models=[_JaxTrainAware(feats=8)], groups=2)
    variables, port = _group_pair(jgroup,
                                  misc.Group([_TrainAware(6, 8)], groups=2),
                                  x, labels=labels)
    got = port(_t(x), labels=_t(labels))
    assert got.shape == (2, 5, 4)
    _assert_tree_close(got, jgroup.apply(variables, x, labels=labels))


def test_group_dispatches_on_signature(rng):
    """A model whose forward takes no ``train`` is called without it; one
    that does gets the group's mode."""
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    jgroup = jmisc.Group(models=[_JaxNoTrainFlag(feats=4)], groups=1)
    variables, port = _group_pair(jgroup,
                                  misc.Group([_NoTrainFlag(3, 4)]), x)
    got = port.train()(_t(x))
    assert got[0].shape == (2, 5, 4)
    _assert_tree_close(got, jgroup.apply(variables, x, train=True))
    aware = _TrainAware(3, 4)
    misc.Group([aware]).train()(_t(x))
    assert aware.seen_train is True
    misc.Group([aware]).eval()(_t(x))
    assert aware.seen_train is False


def test_group_does_not_swallow_internal_type_errors():
    def bad_model(x, train=False):
        raise TypeError('inner bug')
    for group in (jmisc.Group(models=[bad_model], groups=1),
                  misc.Group([bad_model])):
        with pytest.raises(TypeError, match='inner bug'):
            if isinstance(group, misc.Group):
                group(torch.zeros(1, 2, 3))
            else:
                group.init(KEY, jnp.zeros((1, 2, 3)))


def test_batch_group_roundtrip_shapes(rng):
    x = [[rng.standard_normal((2, 5, 3)).astype(np.float32)
          for _ in range(3)] for _ in range(2)]     # x[group][batch]
    jgroup = jmisc.BatchGroup(models=[_JaxTrainAware(feats=8)], groups=2)
    variables, port = _group_pair(
        jgroup, misc.BatchGroup([_TrainAware(6, 8)], groups=2), x)
    got = port(_t(x))
    assert len(got) == 2 and len(got[0]) == 3
    assert got[0][0].shape == (2, 5, 4)
    _assert_tree_close(got, jgroup.apply(variables, x))


def test_batch_group_label_selection(rng):
    x = [[rng.standard_normal((2, 5, 3)).astype(np.float32)
          for _ in range(3)] for _ in range(2)]
    labels = [rng.uniform(0, 1, (2, 5, 2)).astype(np.float32)
              for _ in range(3)]
    jgroup = jmisc.BatchGroup(models=[_JaxTrainAware(feats=8)], groups=2)
    variables, port = _group_pair(
        jgroup, misc.BatchGroup([_TrainAware(6, 8)], groups=2), x,
        labels=labels)
    got = port(_t(x), labels=_t(labels))
    assert len(got) == 1 and len(got[0]) == 3
    assert got[0][0].shape == (2, 5, 4)
    _assert_tree_close(got, jgroup.apply(variables, x, labels=labels))
    with pytest.raises(ValueError, match='groups'):
        port([x[0]])


def test_group_variables_cross_weights_both_ways(rng):
    """Two models in a group: a2m's ``models_0`` / ``models_1`` scopes
    into the port and back, bit-equal."""
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    jgroup = jmisc.Group(models=[_JaxTrainAware(feats=6),
                                 _JaxTrainAware(feats=8)], groups=2)
    flat = randomize(jgroup.init(KEY, x), np.random.default_rng(3))
    port = misc.Group([_TrainAware(6, 6), _TrainAware(6, 8)], groups=2)
    port.load_state_dict(from_jax_variables(flat, port))
    back = to_jax_variables(port)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    _assert_tree_close(port.eval()(_t(x)), jgroup.apply(unflatten(flat), x))
